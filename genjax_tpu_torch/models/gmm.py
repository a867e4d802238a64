"""Dirichlet-categorical Gaussian mixture model and its conjugate Gibbs
sampler.

Counterpart of `genjax_tpu/models/gmm.py` (the reference cookbook's
Dirichlet-mixture application): cluster means with a normal prior,
mixture weights with a Dirichlet prior, a categorical assignment per
datapoint and Gaussian observations. The Gibbs sweep's three blocks are
exact conjugate updates (accept probability 1), each applied with one
dense `Update`, so the trace's joint score stays exact throughout.

JAX's sweep loop is a `lax.scan`; here it is a Python loop whose sweeps
read nothing on the host: the assignment block is a Gumbel-argmax over the
`(N, K)` log joint, the sufficient statistics are `index_add_` into
`zeros(K)` (`torch.bincount` would read the largest index to size its
output), and the Dirichlet and normal draws come from the generator.

The entry points run on the CUDA card unless the caller passes
`device="cpu"`; `rng` is a generator on that device or an int seed.
"""

import dataclasses
import math

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.pytree import Const
from genjax_tpu_torch.core.typing import as_generator
from genjax_tpu_torch.distributions.library import categorical, dirichlet, normal
from genjax_tpu_torch.inference.particle_gibbs import categorical_draw
from genjax_tpu_torch.lang.static import gen

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def make_gmm(
    k: int,
    n: int,
    alpha: float = 1.0,
    mu0: float = 0.0,
    sigma0: float = 10.0,
    obs_sigma: float = 0.5,
    device: torch.device | str = "cuda",
):
    """The mixture model, a generative function of no arguments, with its
    Dirichlet concentration on `device`.

    Addresses: `"means"` (K,), `"probs"` (K,), `"idx"` (N,), `"obs"` (N,).
    """
    alphas = torch.full((k,), alpha, device=device)

    @gen
    def gmm():
        means = normal(mu0, sigma0, sample_shape=Const((k,))) @ "means"
        probs = dirichlet(alphas) @ "probs"
        idx = categorical(logits=torch.log(probs), sample_shape=Const((n,))) @ "idx"
        _ = normal(means[idx], obs_sigma) @ "obs"
        return means

    return gmm


def _normal_lp(v, mu, sigma):
    return -0.5 * ((v - mu) / sigma) ** 2 - math.log(sigma) - _HALF_LOG_2PI


def assignment_logits(observations: torch.Tensor, means: torch.Tensor, probs: torch.Tensor, obs_sigma: float = 0.5):
    """The `(N, K)` unnormalized log posterior of each point's cluster
    given the means and weights: the assignment block's conditional."""
    return torch.log(probs)[None, :] + _normal_lp(observations[:, None], means[None, :], obs_sigma)


def gibbs_sweep(
    rng: torch.Generator,
    trace,
    observations: torch.Tensor,
    k: int,
    alpha: float = 1.0,
    mu0: float = 0.0,
    sigma0: float = 10.0,
    obs_sigma: float = 0.5,
):
    """One sweep of the three exact blocks over a trace of `make_gmm`:
    `(new trace, the (K,) cluster counts of its assignments)`. Reads
    nothing on the host."""
    chm = trace.get_choices()
    means, probs = chm["means"], chm["probs"]

    # Assignments: the exact categorical posterior of every point.
    new_idx = categorical_draw(rng, assignment_logits(observations, means, probs, obs_sigma))
    trace = trace.update(rng, ChoiceMap.kw(idx=new_idx))[0]

    # Weights: Dirichlet-categorical conjugacy.
    counts = torch.zeros(k, device=observations.device).index_add_(0, new_idx, torch.ones_like(observations))
    g = torch._standard_gamma(alpha + counts, generator=rng)
    trace = trace.update(rng, ChoiceMap.kw(probs=g / g.sum()))[0]

    # Means: normal-normal conjugacy per cluster.
    sums = torch.zeros(k, device=observations.device).index_add_(0, new_idx, observations)
    prec = 1.0 / sigma0**2 + counts / obs_sigma**2
    post_mean = (mu0 / sigma0**2 + sums / obs_sigma**2) / prec
    new_means = post_mean + torch.rsqrt(prec) * torch.randn(k, generator=rng, device=rng.device)
    return trace.update(rng, ChoiceMap.kw(means=new_means))[0], counts


def init_gibbs(
    rng: torch.Generator | int,
    observations: torch.Tensor,
    k: int,
    alpha: float = 1.0,
    mu0: float = 0.0,
    sigma0: float = 10.0,
    obs_sigma: float = 0.5,
    device: torch.device | str = "cuda",
):
    """The chain's start: a trace of the model with the observations
    constrained and every other address drawn from the prior."""
    rng = as_generator(rng, device)
    observations = observations.to(device)
    model = make_gmm(k, observations.shape[0], alpha, mu0, sigma0, obs_sigma, device)
    return model.importance(rng, ChoiceMap.kw(obs=observations), ())[0]


def run_gibbs(
    rng: torch.Generator | int,
    observations: torch.Tensor,
    k: int,
    n_sweeps: int = 100,
    alpha: float = 1.0,
    mu0: float = 0.0,
    sigma0: float = 10.0,
    obs_sigma: float = 0.5,
    device: torch.device | str = "cuda",
):
    """Exact conjugate Gibbs over (idx | rest), (probs | rest) and
    (means | rest); returns the final trace.

    Each block samples its exact full conditional and applies it with one
    `Update`; because the conditional is exact, the move is always
    accepted and the chain's stationary distribution is the posterior.
    No sweep reads the device from the host."""
    rng = as_generator(rng, device)
    observations = observations.to(device)
    trace = init_gibbs(rng, observations, k, alpha, mu0, sigma0, obs_sigma, device)
    for _ in range(n_sweeps):
        trace = gibbs_sweep(rng, trace, observations, k, alpha, mu0, sigma0, obs_sigma)[0]
    return trace


def simulate_gmm_data(
    rng: torch.Generator | int,
    n: int,
    true_means,
    true_probs,
    obs_sigma: float = 0.5,
    device: torch.device | str = "cuda",
):
    """`n` observations from a known mixture: `(idx, obs)` on `device`."""
    rng = as_generator(rng, device)
    true_means = torch.as_tensor(true_means, dtype=torch.float32).to(device)
    true_probs = torch.as_tensor(true_probs, dtype=torch.float32).to(device)
    idx = categorical_draw(rng, torch.log(true_probs).expand(n, -1))
    obs = true_means[idx] + obs_sigma * torch.randn(n, generator=rng, device=rng.device)
    return idx, obs


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """The cookbook's mixture (`docs/cookbook/15_dirichlet_mixture.py`):
    three clusters at (-5, 0, 5) with weights (0.25, 0.5, 0.25). G0 is the
    cookbook's run (N=300, 100 sweeps); G1 the width run, a million points
    and 50 sweeps: a width test of `sample_shape`, `categorical` and the
    dense `Update` at a million sites, not traffic a user sends."""

    true_means: tuple = (-5.0, 0.0, 5.0)
    true_probs: tuple = (0.25, 0.5, 0.25)
    k: int = 3
    small_n: int = 300
    small_sweeps: int = 100
    wide_n: int = 1_000_000
    wide_sweeps: int = 50
