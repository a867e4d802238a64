"""Sequential Monte Carlo: particle collections, SIR (`Importance` /
`ImportanceK`), target changes, the four resamplers (multinomial,
systematic, stratified, residual), the effective sample size, and the
step-wise `SMCDriver` with rejuvenation.

Counterpart of `genjax_tpu/inference/smc.py`. `share_constrained_values`
is not ported: a trace made with a particle count stores the observations
once already.

A `ParticleCollection` holds traces with a leading particle axis of
length K on every per-particle leaf; model arguments and observations are
stored once and shared. Which leaves are which is the trace's record
(`Trace.batched_leaves`), which resampling and `get_particle` read. Where
JAX `vmap`s a method over K keys, the port runs it once over the particle
axis. Every reduction over the K log weights goes through `ops.logsumexp`
or `ops.logsumexp_ess`, which run the CUDA kernel on the device, and each
is taken once: a caller that already holds `logsumexp(log_weights)` hands
it to the resampler.

Each resampler is a random part (its uniforms, drawn from the generator)
and a deterministic part that maps given uniforms to ancestors
(`systematic_cum_counts`, `multinomial_ancestors`, `stratified_ancestors`,
`residual_ancestors`). The ancestors of sorted queries come from
`torch.searchsorted`: JAX's merge sort is a TPU workaround, not the
algorithm.
"""

import math
from typing import Any, Callable, Generic, TypeVar

import torch

from genjax_tpu_torch.core.choice_map import Choice, ChoiceMap
from genjax_tpu_torch.core.concepts import Score, Weight
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gather import take_row, take_rows
from genjax_tpu_torch.core.gfi import Trace
from genjax_tpu_torch.core.mask import Mask
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import FloatArray
from genjax_tpu_torch.inference.sp import Algorithm, SampleDistribution, Target, stack_runs
from genjax_tpu_torch.ops import logsumexp, logsumexp_ess

R = TypeVar("R")


######################
# Particle utilities #
######################


def ess(log_weights: torch.Tensor) -> torch.Tensor:
    """Effective sample size `(sum w)^2 / sum w^2`, from the same read as
    `logsumexp(log_weights)` (`ops.logsumexp_ess`).

    >>> import torch
    >>> from genjax_tpu_torch.inference.smc import ess
    >>> round(float(ess(torch.zeros(8))), 1), round(float(ess(torch.tensor([0.0, -1e9, -1e9]))), 1)
    (8.0, 1.0)
    """
    return logsumexp_ess(log_weights)[1]


def prefix_cdf(weights: torch.Tensor) -> torch.Tensor:
    """The cumulative sums of nonnegative `weights` along the last axis,
    divided by their total, in float64: the one place that sets the cdf's
    precision for every resampler.

    A particle of zero weight must repeat its predecessor's cdf, so that it
    owns no slot and no query lands on it. A sequential sum repeats it
    exactly, but the card's parallel scan adds a tile's total to the next
    tile's prefix in another order, and in float32 the cdf then steps up by
    an ulp (about 6e-8) often enough that at a million particles such
    particles take slots, about `n` ulps' worth of queries per step
    (ABC-SMC's survivors drew particles outside the tolerance). In float64
    a step is about 1e-16, which makes the fault negligible at any
    particle count the card holds (about 2e-10 picks per stepped particle
    at a million), not impossible."""
    cdf = torch.cumsum(weights, -1, dtype=torch.float64)
    return cdf / torch.clamp(cdf[..., -1:], min=1e-300)


def _per_row(v: FloatArray) -> FloatArray:
    """A scalar as it is (a Python number stays on the host: copying it to
    the card would wait for it); one value per row `(R,)` as a column
    `(R, 1)` that broadcasts against the rows."""
    return v.unsqueeze(-1) if isinstance(v, torch.Tensor) and v.dim() else v


def normalized_cdf(log_weights: torch.Tensor, lse: FloatArray | None = None) -> torch.Tensor:
    """The cumulative normalized weights along the last axis, in float64
    (`prefix_cdf`): `cumsum(exp(log_weights - lse))` (the softmax that
    JAX's `jax.nn.softmax` computes), divided by its own total. `lse` is
    `logsumexp(log_weights)` over the last axis where the caller holds it
    (one per row for a batch of rows); dividing by the total, as the
    softmax divides by its sum, cancels the rounding of `lse`, an error
    that would move every comparison near a tie the same way."""
    if lse is None:
        lse = logsumexp(log_weights)
    return prefix_cdf(torch.exp(log_weights - _per_row(lse)))


def systematic_cum_counts(
    u0: FloatArray, log_weights: torch.Tensor, n: int, lse: FloatArray | None = None
) -> torch.Tensor:
    """The cumulative block counts `N_i` of systematic resampling: output
    slots `[N_{i-1}, N_i)` copy particle i. `u0` is the resampler's one
    uniform draw in [0, 1); `lse` as in `normalized_cdf`. Over a batch of
    rows `(R, n)`, `u0` and `lse` hold one value per row."""
    cdf = normalized_cdf(log_weights, lse)
    return torch.clamp(torch.floor(n * cdf - _per_row(u0)).to(torch.int64) + 1, 0, n)


def cum_counts_to_ancestors(cum: torch.Tensor, n: int) -> torch.Tensor:
    """The ancestor of each output slot: the particle whose block holds it.
    Slots past the last block end (an f32 cdf that ends below 1) go to the
    last particle that owns a block, as in the JAX scatter-and-cummax.
    Over a batch of rows, each row's indices into its own particles."""
    slots = torch.arange(n, device=cum.device, dtype=cum.dtype)
    return torch.searchsorted(cum, torch.minimum(slots, cum[..., -1:] - 1), right=True)


def systematic_resample(
    rng: torch.Generator, log_weights: torch.Tensor, n: int, lse: FloatArray | None = None
) -> torch.Tensor:
    """Systematic (low-variance) resampling: `n` ancestor indices. `lse`
    as in `normalized_cdf`."""
    u0 = torch.rand((), generator=rng, device=rng.device)
    return cum_counts_to_ancestors(systematic_cum_counts(u0, log_weights, n, lse), n)


def sorted_queries_ancestors(cdf: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """`searchsorted(cdf, us, side='right')`, clipped into range: the
    ancestor of each query (JAX's `_sorted_queries_ancestors`). The queries
    are compared at the cdf's precision (float64, `prefix_cdf`). A query at
    or past the cdf's end (a float32 query that rounds to 1) goes to the
    last particle of positive weight, where JAX's clip gives the last
    particle whatever its weight."""
    last = torch.searchsorted(cdf, cdf[-1:], right=False)
    return torch.minimum(torch.searchsorted(cdf, us.to(cdf.dtype), right=True), last)


def sorted_uniforms(rng: torch.Generator, n: int, dtype=torch.float32) -> torch.Tensor:
    """`n` sorted uniforms in O(n), from exponential spacings: the order
    statistics of `n` independent uniforms."""
    cums = torch.cumsum(torch.empty(n + 1, device=rng.device, dtype=dtype).exponential_(generator=rng), 0)
    return cums[:n] / cums[n]


def multinomial_ancestors(
    us: torch.Tensor, perm: torch.Tensor, log_weights: torch.Tensor, lse: FloatArray | None = None
) -> torch.Tensor:
    """Multinomial ancestors from `us`, sorted uniforms (one per output
    slot), and `perm`, a permutation of the slots: the sorted queries'
    ancestors, permuted (which restores the i.i.d. sequence in
    distribution)."""
    return sorted_queries_ancestors(normalized_cdf(log_weights, lse), us)[perm]


def multinomial_resample(
    rng: torch.Generator, log_weights: torch.Tensor, n: int, lse: FloatArray | None = None
) -> torch.Tensor:
    """Multinomial ancestor sampling via sorted uniform spacings: O(n), no
    (n, K) categorical matrix. The ancestor multiset is exactly
    multinomial; the order is exchangeable."""
    us = sorted_uniforms(rng, n, log_weights.dtype)
    perm = torch.randperm(n, generator=rng, device=rng.device)
    return multinomial_ancestors(us, perm, log_weights, lse)


def stratified_ancestors(u: torch.Tensor, log_weights: torch.Tensor, lse: FloatArray | None = None) -> torch.Tensor:
    """Stratified ancestors from `u`, one uniform per stratum: the queries
    `(u_s + s) / n` are sorted by construction."""
    n = u.shape[0]
    us = (u + torch.arange(n, device=u.device, dtype=u.dtype)) / n
    return sorted_queries_ancestors(normalized_cdf(log_weights, lse), us)


def stratified_resample(
    rng: torch.Generator, log_weights: torch.Tensor, n: int, lse: FloatArray | None = None
) -> torch.Tensor:
    """Stratified resampling: one uniform per stratum."""
    u = torch.rand(n, generator=rng, device=rng.device, dtype=log_weights.dtype)
    return stratified_ancestors(u, log_weights, lse)


def residual_ancestors(
    us: torch.Tensor, perm: torch.Tensor, log_weights: torch.Tensor, lse: FloatArray | None = None
) -> torch.Tensor:
    """Residual ancestors: particle i fills `floor(n w_i)` slots by blocks,
    and the slots left over take multinomial ancestors over the residual
    weights, from `us` and `perm` as in `multinomial_ancestors`. Dense: no
    shape depends on the weights."""
    n = us.shape[0]
    if lse is None:
        lse = logsumexp(log_weights)
    scaled = n * torch.exp(log_weights - lse)
    floors = torch.floor(scaled)
    residual = scaled - floors
    floors = floors.to(torch.int64)
    cum = torch.cumsum(floors, 0)
    det_anc = cum_counts_to_ancestors(cum, n)
    rem_anc = sorted_queries_ancestors(prefix_cdf(residual), us)[perm]
    slots = torch.arange(n, device=us.device)
    return torch.where(slots < cum[-1], det_anc, rem_anc).clamp_(0, log_weights.shape[0] - 1)


def residual_resample(
    rng: torch.Generator, log_weights: torch.Tensor, n: int, lse: FloatArray | None = None
) -> torch.Tensor:
    """Residual resampling: deterministic floor counts plus a multinomial
    remainder."""
    us = sorted_uniforms(rng, n, log_weights.dtype)
    perm = torch.randperm(n, generator=rng, device=rng.device)
    return residual_ancestors(us, perm, log_weights, lse)


RESAMPLERS: dict[str, Callable[..., torch.Tensor]] = {
    "multinomial": multinomial_resample,
    "systematic": systematic_resample,
    "stratified": stratified_resample,
    "residual": residual_resample,
}
"""`name -> resampler(rng, log_weights, n, lse=None)`, each returning `n`
ancestor indices."""


@Pytree.dataclass
class ParticleCollection(Generic[R], Pytree):
    """A weighted collection of particles (traces with a leading particle
    axis) plus their log importance weights."""

    particles: Trace[R]
    log_weights: torch.Tensor
    is_valid: Any = True

    def get_particles(self) -> Trace[R]:
        return self.particles

    def get_particle(self, idx: int | torch.Tensor) -> Trace[R]:
        """The trace of particle `idx` (a Python int or a 0-d index tensor,
        which stays on the device), read from the trace's record: shared
        leaves belong to every particle."""
        idx = torch.as_tensor(idx, device=self.log_weights.device)
        return take_row(self.particles, idx)

    def get_log_weights(self) -> torch.Tensor:
        return self.log_weights

    def get_log_marginal_likelihood_estimate(self) -> torch.Tensor:
        n = self.log_weights.shape[0]
        return logsumexp(self.log_weights) - math.log(n)

    def get_ess(self) -> torch.Tensor:
        return ess(self.log_weights)

    def __getitem__(self, idx):
        return self.get_particle(idx), self.log_weights[idx]

    def sample_particle(self, rng: torch.Generator) -> Trace[R]:
        """One particle drawn in proportion to its weight (Gumbel-max over
        the normalized log weights, as `jax.random.categorical` draws)."""
        logits = self.log_weights - logsumexp(self.log_weights)
        u = torch.rand(logits.shape, generator=rng, device=rng.device)
        idx = torch.argmax(logits - torch.log(-torch.log(u)))
        return self.get_particle(idx)

    def resample(
        self, rng: torch.Generator, method: str = "systematic", lse: FloatArray | None = None
    ) -> "ParticleCollection[R]":
        """Resample to equal weights, each the mean weight (so that LML
        accumulation telescopes). `lse` is `logsumexp(log_weights)` where
        the caller holds it (one reduction fewer)."""
        n = self.log_weights.shape[0]
        if lse is None:
            lse = logsumexp(self.log_weights)
        anc = RESAMPLERS[method](rng, self.log_weights, n, lse)
        avg_lw = torch.as_tensor(lse, device=self.log_weights.device) - math.log(n)
        return ParticleCollection(take_rows(self.particles, anc), avg_lw.expand(n).contiguous(), self.is_valid)


def _retain_last(retained: ChoiceMap, k: int, device) -> ChoiceMap:
    """`retained` (one particle's choices) as a constraint on the last of
    `k` particles only: a `Mask` whose flag holds at row `k - 1`, so one
    batched `importance` draws the other rows afresh."""
    last = torch.arange(k, device=device) == k - 1

    def one(c: Choice) -> ChoiceMap:
        v = torch.as_tensor(c.v, device=device)
        return Choice.build(Mask(v.expand(k, *v.shape), last, (1,), 1))

    return retained.map_choices(one)


#############
# Algorithm #
#############


class SMCAlgorithm(Generic[R], Algorithm[R]):
    """Abstract base of SMC algorithms (proper weighting over targets)."""

    def get_num_particles(self) -> int:
        raise NotImplementedError

    def get_final_target(self) -> Target[R]:
        raise NotImplementedError

    def run_smc(self, rng: torch.Generator) -> ParticleCollection[R]:
        raise NotImplementedError

    def run_csmc(self, rng: torch.Generator, retained: ChoiceMap) -> ParticleCollection[R]:
        raise NotImplementedError

    def _retarget(self, target: Target[R] | None) -> "SMCAlgorithm[R]":
        """`ChangeTarget(self, target)`; the algorithm itself where the
        target is its own (the reweight would be the identity)."""
        if target is None or target is self.get_final_target():
            return self
        return ChangeTarget(self, target)

    def log_marginal_likelihood_estimate(
        self, rng: torch.Generator, target: Target[R] | None = None
    ) -> torch.Tensor:
        return self._retarget(target).run_smc(rng).get_log_marginal_likelihood_estimate()

    def random_weighted(self, rng: torch.Generator, *args, n=None) -> tuple[Score, ChoiceMap]:
        """One approximate posterior draw of the target's latents, and the
        estimate `log p(particle) - log Z-hat`. With `n`, `n` independent
        runs (one after the other), stacked along a particle axis."""
        target: Target[R] = args[0]
        if n is not None:
            runs = [self.random_weighted(rng, target) for _ in range(n)]
            return stack_runs([w for w, _ in runs]), stack_runs([c for _, c in runs])
        collection = self._retarget(target).run_smc(rng)
        particle = collection.sample_particle(rng)
        log_density_estimate = particle.get_score() - collection.get_log_marginal_likelihood_estimate()
        return log_density_estimate, target.filter_to_unconstrained(particle.get_choices())

    def estimate_logpdf(self, rng: torch.Generator, v: ChoiceMap, *args) -> Score:
        """Unbiased posterior-density estimate at `v` by conditional SMC:
        `log p-hat(v) = score(retained) - LML-hat`, with the retained
        particle (which `run_csmc` puts at index K-1)."""
        target: Target[R] = args[0]
        collection = ChangeTarget(self, target).run_csmc(rng, v)
        particle = collection.get_particle(self.get_num_particles() - 1)
        return particle.get_score() - collection.get_log_marginal_likelihood_estimate()

    def estimate_normalizing_constant(self, rng: torch.Generator, target: Target[R]) -> FloatArray:
        return ChangeTarget(self, target).run_smc(rng).get_log_marginal_likelihood_estimate()

    def estimate_reciprocal_normalizing_constant(
        self, rng: torch.Generator, target: Target[R], latent_choices: ChoiceMap, w: Weight
    ) -> FloatArray:
        return ChangeTarget(self, target).run_csmc_for_normalizing_constant(rng, latent_choices, w)


@Pytree.dataclass
class Importance(Generic[R], SMCAlgorithm[R]):
    """One-particle importance sampling from `target`, optionally through a
    custom proposal `q` (a `SampleDistribution` over a subset of the
    unconstrained addresses). The collection holds one particle."""

    target: Target[R]
    q: SampleDistribution | None = None

    def get_num_particles(self) -> int:
        return 1

    def get_final_target(self) -> Target[R]:
        return self.target

    def run_smc(self, rng: torch.Generator) -> ParticleCollection[R]:
        if self.q is not None:
            log_weight, choice = self.q.random_weighted(rng, self.target, n=1)
            tr, target_score = self.target.importance(rng, choice, n=1)
        else:
            log_weight = 0.0
            tr, target_score = self.target.importance(rng, ChoiceMap.empty(), n=1)
        return ParticleCollection(tr, (target_score - log_weight).reshape(1))

    def run_csmc(self, rng: torch.Generator, retained: ChoiceMap) -> ParticleCollection[R]:
        q_score = 0.0 if self.q is None else self.q.estimate_logpdf(rng, retained, self.target)
        tr, target_score = self.target.importance(rng, _retain_last(retained, 1, rng.device), n=1)
        return ParticleCollection(tr, (target_score - q_score).reshape(1))


@Pytree.dataclass
class ImportanceK(Generic[R], SMCAlgorithm[R]):
    """K-particle sampling importance resampling (SIR) from `target`,
    proposing from the model's own prior or from a custom proposal `q`.

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
    >>> _, latents = alg.random_weighted(torch.Generator().manual_seed(1), target)
    >>> "x" in latents
    True
    """

    target: Target[R]
    q: SampleDistribution | None = None
    k_particles: int = Pytree.static(default=2)

    def get_num_particles(self) -> int:
        return self.k_particles

    def get_final_target(self) -> Target[R]:
        return self.target

    def run_smc(self, rng: torch.Generator) -> ParticleCollection[R]:
        k = self.k_particles
        if self.q is None:
            trs, log_weights = self.target.importance(rng, ChoiceMap.empty(), n=k)
            return ParticleCollection(trs, log_weights)
        proposal_scores, choices = self.q.random_weighted(rng, self.target, n=k)
        trs, target_scores = self.target.importance(rng, choices, n=k)
        return ParticleCollection(trs, target_scores - proposal_scores)

    def run_csmc(self, rng: torch.Generator, retained: ChoiceMap) -> ParticleCollection[R]:
        """K-1 fresh particles and the retained one, at index K-1."""
        k = self.k_particles
        if self.q is None:
            # One batched importance: the last row is held to the retained
            # choices (its weight is their joint density), the others drawn.
            trs, target_scores = self.target.importance(rng, _retain_last(retained, k, rng.device), n=k)
            return ParticleCollection(trs, target_scores)
        # K proposals, the last of them replaced by the retained choices.
        proposal_scores, choices = self.q.random_weighted(rng, self.target, n=k)
        retained_score = self.q.estimate_logpdf(rng, retained, self.target)
        last = torch.arange(k, device=proposal_scores.device) == k - 1
        proposal_scores = torch.where(last, retained_score, proposal_scores)
        trs, target_scores = self.target.importance(rng, _retain_last(retained, k, rng.device) | choices, n=k)
        return ParticleCollection(trs, target_scores - proposal_scores)


@Pytree.dataclass
class ChangeTarget(Generic[R], SMCAlgorithm[R]):
    """Reweight an existing collection to a new target (shared latents):
    one batched `importance` of the new target over the particle axis."""

    prev: SMCAlgorithm[R]
    target: Target[R]

    def get_num_particles(self) -> int:
        return self.prev.get_num_particles()

    def get_final_target(self) -> Target[R]:
        return self.target

    def _reweighted(self, rng: torch.Generator, collection: ParticleCollection[R]):
        """(the particles under the new target, their new weights)."""
        particles = collection.get_particles()
        latents = self.prev.get_final_target().filter_to_unconstrained(particles.get_choices())
        new_particles, new_weights = self.target.importance(rng, latents, n=self.get_num_particles())
        return new_particles, new_weights - particles.get_score() + collection.get_log_weights()

    def run_smc(self, rng: torch.Generator) -> ParticleCollection[R]:
        return ParticleCollection(*self._reweighted(rng, self.prev.run_smc(rng)))

    def run_csmc(self, rng: torch.Generator, retained: ChoiceMap) -> ParticleCollection[R]:
        return ParticleCollection(*self._reweighted(rng, self.prev.run_csmc(rng, retained)))

    def run_csmc_for_normalizing_constant(self, rng: torch.Generator, latent_choices: ChoiceMap, w: Weight) -> Weight:
        """Low-variance reciprocal normalizing-constant estimate for
        variational objectives: `w` against the log mean of the
        conditional collection's reweighted weights."""
        _, new_weights = self._reweighted(rng, self.prev.run_csmc(rng, latent_choices))
        return w - (logsumexp(new_weights) - math.log(self.get_num_particles()))


##################################################
# Step-wise SMC driver with resampling           #
##################################################


@Pytree.dataclass
class SMCDriver(Generic[R], Pytree):
    """A step-wise SMC loop: initialize from a target, then advance through
    a sequence of targets with resampling (adaptive by ESS threshold) and
    rejuvenation moves.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.smc import SMCDriver
    >>> @gx.gen
    ... def model():
    ...     x = gx.normal(0.0, 1.0) @ "x"
    ...     _ = gx.normal(x, 1.0) @ "y"
    >>> driver = SMCDriver(n_particles=256)
    >>> rng = torch.Generator().manual_seed(0)
    >>> coll = driver.init(rng, gx.Target(model, (), gx.ChoiceMap.kw(y=1.0)))
    >>> coll = driver.maybe_resample(rng, coll)
    >>> coll = driver.rejuvenate(rng, coll, gx.Regenerate(gx.Selection.at["x"]))
    >>> bool(coll.get_ess() > 0)
    True
    """

    n_particles: int = Pytree.static()
    resampling: str = Pytree.static(default="systematic")
    ess_threshold: float = Pytree.static(default=0.5)

    def init(self, rng: torch.Generator, target: Target[R]) -> ParticleCollection[R]:
        """Importance-sample the target over the particle axis."""
        trs, ws = target.importance(rng, ChoiceMap.empty(), n=self.n_particles)
        return ParticleCollection(trs, ws)

    def maybe_resample(self, rng: torch.Generator, collection: ParticleCollection[R]) -> ParticleCollection[R]:
        """Resample if the ESS is below `ess_threshold * n_particles`.

        JAX's `lax.cond` is a host branch here: reading the comparison
        waits for the device, one synchronisation per call. The ESS and
        `logsumexp(log_weights)` come from one reduction, which the
        resampler reuses."""
        lse, ess_value = logsumexp_ess(collection.get_log_weights())
        if ess_value < self.ess_threshold * self.n_particles:
            return collection.resample(rng, self.resampling, lse)
        return collection

    def extend(
        self,
        rng: torch.Generator,
        collection: ParticleCollection[R],
        constraint: ChoiceMap,
        argdiffs: tuple | None = None,
    ) -> ParticleCollection[R]:
        """Advance every particle by constraining new observations with the
        `Update` edit; the weights gain the incremental importance weights.

        The weight of observing an address that was latent is `p(obs |
        rest)`: `update` gives the ratio `p(new) / p(old)`, so the old
        score of the constrained addresses (`project` on the constraint's
        selection) is added back."""
        particles = collection.get_particles()
        argdiffs = Diff.no_change(particles.get_args()) if argdiffs is None else argdiffs
        discarded_score = particles.project(rng, constraint.get_selection())
        new_particles, w, _, _ = particles.get_gen_fn().update(rng, particles, constraint, argdiffs)
        return ParticleCollection(new_particles, collection.get_log_weights() + w + discarded_score, collection.is_valid)

    def rejuvenate(self, rng: torch.Generator, collection: ParticleCollection[R], request) -> ParticleCollection[R]:
        """An MH move with `request` on every particle (accept or reject
        each on its own); the weights are kept."""
        from genjax_tpu_torch.inference.mcmc import mh

        new_particles, _ = mh(rng, collection.get_particles(), request)
        return ParticleCollection(new_particles, collection.get_log_weights(), collection.is_valid)


__all__ = [
    "RESAMPLERS",
    "ChangeTarget",
    "Importance",
    "ImportanceK",
    "ParticleCollection",
    "SMCAlgorithm",
    "SMCDriver",
    "cum_counts_to_ancestors",
    "ess",
    "multinomial_ancestors",
    "multinomial_resample",
    "normalized_cdf",
    "prefix_cdf",
    "residual_ancestors",
    "residual_resample",
    "sorted_queries_ancestors",
    "sorted_uniforms",
    "stratified_ancestors",
    "stratified_resample",
    "systematic_cum_counts",
    "systematic_resample",
]
