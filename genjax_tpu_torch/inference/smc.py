"""Sequential Monte Carlo: particle collections, systematic resampling,
effective sample size and `ImportanceK` SIR.

Counterpart of part of `genjax_tpu/inference/smc.py`: `ess`,
`systematic_cum_counts`, `systematic_resample`, `ParticleCollection` and
`ImportanceK` without a custom proposal. The other resamplers, proposals,
`ChangeTarget` and `SMCDriver` come later.

A `ParticleCollection` holds traces with a leading particle axis of
length K on every per-particle leaf; model arguments and observations are
stored once and shared. Which leaves are which is the trace's record
(`Trace.batched_leaves`), which resampling and `get_particle` read. Every reduction over the K log weights goes
through `ops.logsumexp` or `ops.logsumexp_ess`, which run the CUDA kernel
on the device, and each is taken once: a caller that already holds
`logsumexp(log_weights)` hands it to the resampler.
"""

import math
from typing import Generic, TypeVar

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.concepts import Score
from genjax_tpu_torch.core.gather import take_row, take_rows
from genjax_tpu_torch.core.gfi import Trace
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import FloatArray
from genjax_tpu_torch.inference.sp import Algorithm, Target
from genjax_tpu_torch.ops import logsumexp, logsumexp_ess

R = TypeVar("R")


def ess(log_weights: torch.Tensor) -> torch.Tensor:
    """Effective sample size `(sum w)^2 / sum w^2`, from the same read as
    `logsumexp(log_weights)` (`ops.logsumexp_ess`).

    >>> import torch
    >>> from genjax_tpu_torch.inference.smc import ess
    >>> round(float(ess(torch.zeros(8))), 1), round(float(ess(torch.tensor([0.0, -1e9, -1e9]))), 1)
    (8.0, 1.0)
    """
    return logsumexp_ess(log_weights)[1]


def systematic_cum_counts(
    u0: FloatArray, log_weights: torch.Tensor, n: int, lse: FloatArray | None = None
) -> torch.Tensor:
    """The cumulative block counts `N_i` of systematic resampling: output
    slots `[N_{i-1}, N_i)` copy particle i. `u0` is the resampler's one
    uniform draw in [0, 1); `lse` is `logsumexp(log_weights)` where the
    caller holds it already. The weights are `exp(log_weights - lse)`,
    the softmax that JAX's `jax.nn.softmax` computes."""
    if lse is None:
        lse = logsumexp(log_weights)
    cdf = torch.cumsum(torch.exp(log_weights - lse), 0)
    # The weights sum to 1 only up to the rounding of `lse`, an error that
    # would move every count near a floor tie the same way; dividing by
    # their own total, as the softmax divides by its sum, cancels it.
    cdf = cdf / cdf[-1]
    return torch.clamp(torch.floor(n * cdf - u0).to(torch.int64) + 1, 0, n)


def cum_counts_to_ancestors(cum: torch.Tensor, n: int) -> torch.Tensor:
    """The ancestor of each output slot: the particle whose block holds it.
    Slots past the last block end (an f32 cdf that ends below 1) go to the
    last particle that owns a block, as in the JAX scatter-and-cummax."""
    slots = torch.arange(n, device=cum.device, dtype=cum.dtype)
    return torch.searchsorted(cum, torch.minimum(slots, cum[-1] - 1), right=True)


def systematic_resample(
    rng: torch.Generator, log_weights: torch.Tensor, n: int, lse: FloatArray | None = None
) -> torch.Tensor:
    """Systematic (low-variance) resampling: `n` ancestor indices. `lse`
    as in `systematic_cum_counts`."""
    u0 = torch.rand((), generator=rng, device=rng.device)
    return cum_counts_to_ancestors(systematic_cum_counts(u0, log_weights, n, lse), n)


@Pytree.dataclass
class ParticleCollection(Generic[R], Pytree):
    """A weighted collection of particles (traces with a leading particle
    axis) plus their log importance weights."""

    particles: Trace[R]
    log_weights: torch.Tensor

    def get_particles(self) -> Trace[R]:
        return self.particles

    def get_particle(self, idx: int | torch.Tensor) -> Trace[R]:
        """The trace of particle `idx` (a Python int or a 0-d index tensor,
        which stays on the device). Shared leaves belong to every particle."""
        idx = torch.as_tensor(idx, device=self.log_weights.device)
        return take_row(self.particles, idx)

    def get_log_weights(self) -> torch.Tensor:
        return self.log_weights

    def get_log_marginal_likelihood_estimate(self) -> torch.Tensor:
        n = self.log_weights.shape[0]
        return logsumexp(self.log_weights) - math.log(n)

    def get_ess(self) -> torch.Tensor:
        return ess(self.log_weights)

    def sample_particle(self, rng: torch.Generator) -> Trace[R]:
        """One particle drawn in proportion to its weight (Gumbel-max over
        the normalized log weights, as `jax.random.categorical` draws)."""
        logits = self.log_weights - logsumexp(self.log_weights)
        u = torch.rand(logits.shape, generator=rng, device=rng.device)
        idx = torch.argmax(logits - torch.log(-torch.log(u)))
        return self.get_particle(idx)

    def resample(self, rng: torch.Generator) -> "ParticleCollection[R]":
        """Systematic resampling to equal weights, each the mean weight (so
        LML accumulation telescopes)."""
        n = self.log_weights.shape[0]
        lse = logsumexp(self.log_weights)
        anc = systematic_resample(rng, self.log_weights, n, lse)
        avg_lw = lse - math.log(n)
        return ParticleCollection(
            take_rows(self.particles, anc),
            avg_lw.expand(n).contiguous(),
        )


@Pytree.dataclass
class ImportanceK(Generic[R], Algorithm[R]):
    """K-particle sampling importance resampling (SIR) from `target`,
    proposing from the model's own prior.

    >>> import math, torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.gen
    ... def model():
    ...     x = gx.normal(0.0, 1.0) @ "x"
    ...     _ = gx.normal(x, 1.0) @ "y"
    >>> target = gx.Target(model, (), gx.ChoiceMap.kw(y=1.0))
    >>> alg = gx.ImportanceK(target, k_particles=4000)
    >>> lml = alg.log_marginal_likelihood_estimate(torch.Generator().manual_seed(0))
    >>> exact = -0.25 - 0.5 * math.log(2 * math.pi * 2.0)  # log N(1; 0, sqrt 2)
    >>> abs(float(lml) - exact) < 0.1
    True
    """

    target: Target[R]
    k_particles: int = Pytree.static(default=2)

    def run_smc(self, rng: torch.Generator) -> ParticleCollection[R]:
        trs, log_weights = self.target.importance(rng, ChoiceMap.empty(), n=self.k_particles)
        return ParticleCollection(trs, log_weights)

    def _check_target(self, target: Target[R] | None) -> None:
        if target is not None and target is not self.target:
            raise NotImplementedError(
                "ImportanceK runs on its own target; reweighting to another "
                "target (ChangeTarget) is not ported yet."
            )

    def log_marginal_likelihood_estimate(
        self, rng: torch.Generator, target: Target[R] | None = None
    ) -> torch.Tensor:
        self._check_target(target)
        return self.run_smc(rng).get_log_marginal_likelihood_estimate()

    def random_weighted(self, rng: torch.Generator, *args, n=None) -> tuple[Score, ChoiceMap]:
        """One approximate posterior draw of the target's latents, and the
        estimate `log p(particle) - log Z-hat`."""
        target: Target[R] = args[0]
        self._check_target(target)
        collection = self.run_smc(rng)
        particle = collection.sample_particle(rng)
        log_density_estimate = (
            particle.get_score() - collection.get_log_marginal_likelihood_estimate()
        )
        return log_density_estimate, target.filter_to_unconstrained(particle.get_choices())


__all__ = [
    "ImportanceK",
    "ParticleCollection",
    "cum_counts_to_ancestors",
    "ess",
    "systematic_cum_counts",
    "systematic_resample",
]
