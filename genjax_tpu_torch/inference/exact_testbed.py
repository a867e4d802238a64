"""Exact-inference testbed: HMM inference problems with exact log
posteriors and data marginals as ground truth for approximate inference.

Counterpart of `genjax_tpu/inference/exact_testbed.py`.
"""

import torch

from genjax_tpu_torch.combinators.scan import scan
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.distributions.discrete_hmm import DiscreteHMM, DiscreteHMMConfiguration
from genjax_tpu_torch.distributions.library import categorical
from genjax_tpu_torch.lang.static import gen


@Pytree.dataclass
class DiscreteHMMInferenceProblem(Pytree):
    initial_state: torch.Tensor
    log_posterior: torch.Tensor
    log_data_marginal: torch.Tensor
    latent_sequence: torch.Tensor
    observation_sequence: torch.Tensor


def build_hmm_chain_model(config: DiscreteHMMConfiguration, max_length: int, device: torch.device | str = "cuda"):
    """The generative HMM as a `@gen` scan program (addresses "z", "x" per
    step), called with `(initial_state, None)`. The two tables are made
    once, on `device`; the state may be one integer or one per particle."""
    transition = config.transition_log_probs(device)
    observation = config.observation_log_probs(device)

    @scan(n=max_length)
    @gen
    def markov_chain(state, _x):
        z = categorical(logits=transition[state]) @ "z"
        _ = categorical(logits=observation[z]) @ "x"
        return z, None

    return markov_chain


def build_test_against_exact_inference(
    max_length: int,
    state_space_size: int,
    transition_distance_truncation: int,
    observation_distance_truncation: int,
    transition_variance: float,
    observation_variance: float,
    device: torch.device | str = "cuda",
):
    """A generator of `DiscreteHMMInferenceProblem`s: simulated latent and
    observation sequences with their exact posterior density and data
    marginal. Call it with a `torch.Generator` on `device`; it returns
    `(problem, config)`."""
    config = DiscreteHMMConfiguration(
        state_space_size,
        transition_distance_truncation,
        observation_distance_truncation,
        transition_variance,
        observation_variance,
    )
    markov_chain = build_hmm_chain_model(config, max_length, device)

    def inference_test_generator(rng: torch.Generator):
        u = torch.rand(config.linear_grid_dim, generator=rng, device=rng.device)
        initial_state = torch.argmax(u)
        tr = markov_chain.simulate(rng, (initial_state, None))
        chm = tr.get_choices()
        # Scan traces store per-step addresses stacked: the bare "z" and
        # "x" addresses expose the whole sequence.
        latents, observations = chm["z"], chm["x"]
        log_data_marginal = DiscreteHMM.data_logpdf(config, observations)
        log_posterior = DiscreteHMM.estimate_logpdf(rng, latents, config, observations)
        problem = DiscreteHMMInferenceProblem(initial_state, log_posterior, log_data_marginal, latents, observations)
        return problem, config

    return inference_test_generator
