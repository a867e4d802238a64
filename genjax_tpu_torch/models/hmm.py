"""Discrete HMM: likelihood weighting of the whole unfold, the bootstrap
filter and the step-wise SMC driver, with the exact marginal beside them.

The model is `inference.exact_testbed.build_hmm_chain_model`: `T` steps of
`z_t ~ categorical(transition[z_{t-1}])`, `x_t ~ categorical(observation[z_t])`.
`run_hmm_importance` generates the unfold for K particles with every
`"x"` constrained (one run of the kernel per step for all particles) and
reduces the K weights once. `hmm_filter` is BASELINE config 3 ("HMM -
SMC with systematic resampling, 10k particles") as a `BootstrapFilter`
over one step at a time; `run_hmm_smc` runs the same HMM as the `scan`
program under `SMCDriver`, extending it by one observation per step.
"""

import dataclasses
import functools
import operator

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.requests import Regenerate
from genjax_tpu_torch.distributions.discrete_hmm import DiscreteHMMConfiguration, forward_filter
from genjax_tpu_torch.distributions.library import categorical
from genjax_tpu_torch.inference.exact_testbed import build_hmm_chain_model
from genjax_tpu_torch.inference.particle_filter import BootstrapFilter
from genjax_tpu_torch.inference.smc import ParticleCollection, SMCDriver
from genjax_tpu_torch.inference.sp import Target
from genjax_tpu_torch.lang.static import gen


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """The HMM of `chip_smoke.py` and `profiling.py`: 64 states, 50 steps;
    transitions and observations within 2 of the diagonal of the
    circulant grid. The unfold runs a million particles, the filter and
    the SMC driver `smc_particles` (BASELINE config 3's 10k)."""

    n_states: int = 64
    T: int = 50
    n_particles: int = 1_000_000
    smc_particles: int = 10_000
    rejuvenate_every: int = 10
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


def hmm_filter(
    config: DiscreteHMMConfiguration,
    initial_state: int,
    n_particles: int,
    resampling: str = "systematic",
    device: torch.device | str = "cuda",
) -> BootstrapFilter:
    """The bootstrap filter of `tests/inference/test_pf_vs_exact.py` on
    `config`'s tables (made once, on `device`), observing `"y"`. Its init
    model is the first step from `initial_state`, where `build_hmm_chain_model`
    and `exact_log_marginal` start too (not the table's prior)."""
    trans = config.transition_log_probs(device)
    obs = config.observation_log_probs(device)

    @gen
    def init_model():
        z = categorical(logits=trans[initial_state]) @ "z"
        _ = categorical(logits=obs[z]) @ "y"
        return z

    @gen
    def step_model(z_prev, _t):
        z = categorical(logits=trans[z_prev]) @ "z"
        _ = categorical(logits=obs[z]) @ "y"
        return z

    return BootstrapFilter(step_model, init_model, n_particles, obs_addr="y", resampling=resampling)


def future_steps(t: int, T: int) -> Selection:
    """Every address of the steps after `t` of a `T`-step unfold."""
    return functools.reduce(operator.or_, [Selection.at[s] for s in range(t + 1, T)])


def run_hmm_smc(
    rng: torch.Generator,
    model,
    observations: torch.Tensor,
    initial_state,
    driver: SMCDriver,
    rejuvenate_every: int = 10,
) -> ParticleCollection:
    """The HMM `scan` program under `SMCDriver`: `init` with step 0's
    observation constrained, then for every later step `t` an `extend`
    with `C[t, "x"]` and `maybe_resample`, and every `rejuvenate_every`
    steps an MH move that regenerates `z_t` (the latents are discrete, so
    a regenerate, not a drift). `extend` re-scans the whole unfold through
    `Scan`'s dense `Update`: O(T^2) step edits per run. Returns the final
    collection, whose LML estimates log p(x_{1:T}).

    The program's trace holds every step from the start, the later ones
    drawn from the prior at `init`; after a resample the copies of a
    particle would share that one future, so the particles would never
    diversify and the LML would degenerate as T grows (without the move
    below, -219.2 against the exact -206.5 at K=10k, T=50 on an H100).
    So each resample that fires is followed by an exact Gibbs move: the
    steps after `t` regenerated from their prior, which under the target
    of step `t` is their conditional given `z_t` (the MH move accepts it
    always). That is the bootstrap filter's fresh draw of the next state."""
    T = observations.shape[0]
    target = Target(model, (initial_state, None), ChoiceMap.d({(0, "x"): observations[0]}))
    col = driver.init(rng, target)
    for t in range(1, T):
        col = driver.extend(rng, col, ChoiceMap.d({(t, "x"): observations[t]}))
        resampled = driver.maybe_resample(rng, col)
        if resampled is not col and t < T - 1:
            resampled = driver.rejuvenate(rng, resampled, Regenerate(future_steps(t, T)))
        col = resampled
        if rejuvenate_every and t % rejuvenate_every == 0:
            col = driver.rejuvenate(rng, col, Regenerate(Selection.at[t, "z"]))
    return col
