"""Discrete HMM as a `scan` program: likelihood weighting of the whole
unfold, with the exact marginal beside it.

The model is `inference.exact_testbed.build_hmm_chain_model`: `T` steps of
`z_t ~ categorical(transition[z_{t-1}])`, `x_t ~ categorical(observation[z_t])`.
`run_hmm_importance` generates the unfold for K particles with every
`"x"` constrained (one run of the kernel per step for all particles) and
reduces the K weights once.
"""

import dataclasses

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.distributions.discrete_hmm import DiscreteHMMConfiguration, forward_filter
from genjax_tpu_torch.inference.exact_testbed import build_hmm_chain_model
from genjax_tpu_torch.inference.smc import ParticleCollection


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """The HMM unfold of `chip_smoke.py` and `profiling.py`: 64 states,
    50 steps, a million particles; transitions and observations within 2
    of the diagonal of the circulant grid."""

    n_states: int = 64
    T: int = 50
    n_particles: int = 1_000_000
    adjacency: int = 2
    sigma_trans: float = 0.5
    sigma_obs: float = 0.5
    data_seed: int = 5

    def hmm(self) -> DiscreteHMMConfiguration:
        return DiscreteHMMConfiguration(self.n_states, self.adjacency, self.adjacency, self.sigma_trans, self.sigma_obs)

    def initial_state(self) -> int:
        return self.n_states // 2

    def data(self, device: torch.device | str, T: int | None = None) -> torch.Tensor:
        """The observations `(T,)`: one run of the model on the CPU from
        `data_seed`, then moved to `device`, so that every device sees the
        same data."""
        model = build_hmm_chain_model(self.hmm(), self.T if T is None else T, "cpu")
        tr = model.simulate(torch.Generator().manual_seed(self.data_seed), (self.initial_state(), None))
        return tr.get_choices()["x"].to(device)


def run_hmm_importance(rng: torch.Generator, model, observations: torch.Tensor, initial_state, n_particles: int):
    """Likelihood weighting of the whole unfold: `model` (a
    `build_hmm_chain_model` on the generator's device) generated for
    `n_particles` particles with every `"x"` constrained to
    `observations`. Returns the `ParticleCollection`: its trace holds
    `"z"` as `(K, T)`, and its log marginal likelihood estimate is one
    reduction of the K weights."""
    traces, log_weights = model.importance(rng, ChoiceMap.kw(x=observations), (initial_state, None), n=n_particles)
    return ParticleCollection(traces, log_weights)


def exact_log_marginal(config: DiscreteHMMConfiguration, observations: torch.Tensor, initial_state: int) -> torch.Tensor:
    """log p(x_{1:T}) of the scan model started in `initial_state`: the
    forward algorithm with the first state drawn from that state's
    transition row."""
    trans = config.transition_log_probs(observations.device)
    return forward_filter(trans[initial_state], trans, config.observation_log_probs(observations.device), observations)[1]
