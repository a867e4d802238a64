"""Tempered SMC (SMC samplers; Del Moral, Doucet & Jasra 2006): anneal a
particle population from the prior to the posterior along a likelihood
temperature ladder.

Counterpart of `genjax_tpu/inference/tempered.py`. The bridge densities
are `p(z) p(y | z)^beta`: the per-particle log-likelihood is `project` on
the observed addresses, the incremental weight of a temperature step is
`(beta' - beta) loglik`, and the rejuvenation kernel is any edit request
whose acceptance ratio is re-tempered from the full joint to the bridge.

JAX's `lax.scan` over temperatures is a Python loop here, each step dense
over the particle axis: one reduction of the reweighted weights (which is
also their normalizer), one `logsumexp_ess`, a systematic resample kept or
dropped by a select on the device (as JAX selects), and the tempered-MH
sweeps. No step reads the device on the host. The adaptive ladder's
bisection (JAX's `lax.fori_loop`) is a loop with a fixed trip count.
"""

import math
from typing import Generic, TypeVar

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.concepts import EditRequest
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gather import take_rows
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.requests import Regenerate
from genjax_tpu_torch.core.staging import where_tree
from genjax_tpu_torch.core.typing import FloatArray
from genjax_tpu_torch.inference.smc import ParticleCollection, systematic_resample
from genjax_tpu_torch.inference.sp import Target
from genjax_tpu_torch.ops import logsumexp, logsumexp_ess

R = TypeVar("R")

BISECTION_STEPS = 24


def _loglik(rng: torch.Generator, particles, obs_selection: Selection) -> FloatArray:
    """log p(observations | latents): the observed addresses' part of the
    score."""
    return particles.project(rng, obs_selection)


def retempered_log_alpha(
    rng: torch.Generator, trace, proposed, w, request: EditRequest, beta, obs_selection: Selection, loglik
):
    """The MH log acceptance ratio of an edit (`proposed` and its weight
    `w` from `request.edit` of `trace`) re-tempered to the bridge
    `p(z) p(y|z)^beta`, and the proposal's log-likelihood:
    `(alpha, new_loglik)`.

    `w` is the full-joint ratio; taking off the untempered change of the
    likelihood and adding it back scaled by `beta` re-tempers it exactly.
    For `Regenerate(sel)` the weight is the change of the joint, and the
    prior proposal terms come off first (as `mcmc._log_accept_ratio` takes
    them off), so alpha = beta * delta-loglik; the general form covers
    requests whose weight already is an acceptance ratio. `beta` is a
    number or one per particle; `loglik` is `trace`'s log-likelihood."""
    new_loglik = _loglik(rng, proposed, obs_selection)
    delta_ll = new_loglik - loglik
    if isinstance(request, Regenerate):
        sel = request.selection
        proposal_term = proposed.project(rng, sel) - trace.project(rng, sel)
        return (w - delta_ll) - proposal_term + beta * delta_ll, new_loglik
    return (w - delta_ll) + beta * delta_ll, new_loglik


def tempered_mh(
    rng: torch.Generator,
    trace,
    request: EditRequest,
    beta: FloatArray,
    obs_selection: Selection,
    loglik: FloatArray | None = None,
):
    """One MH step targeting the bridge `p(z) p(y | z)^beta`, on every
    chain of `trace` (`beta` a number, or one per chain).

    Works with any edit request: the full-joint acceptance ratio is
    re-tempered by `retempered_log_alpha` (for `Regenerate` the
    prior-proposal terms come off first). Passing the current `loglik`
    saves the projection on the observed addresses.

    Returns `(new_trace, new_loglik, accepted)`. JAX's lives in
    `parallel_tempering`, which re-exports this one."""
    if loglik is None:
        loglik = trace.project(rng, obs_selection)
    proposed, w, _, _ = request.edit(rng, trace, Diff.no_change(trace.get_args()))
    alpha, new_loglik = retempered_log_alpha(rng, trace, proposed, w, request, beta, obs_selection, loglik)
    accepted = torch.log(torch.rand(alpha.shape, generator=rng, device=rng.device)) < alpha
    return where_tree(accepted, proposed, trace), torch.where(accepted, new_loglik, loglik), accepted


@Pytree.dataclass
class TemperedSMC(Generic[R], Pytree):
    """Anneal K particles from the prior (beta = 0) to the posterior
    (beta = 1) along `betas`, with ESS-gated systematic resampling and
    `n_moves` tempered-MH rejuvenation sweeps per temperature.

    The log normalizing constant estimate
    `sum_t logmeanexp((beta_{t+1} - beta_t) loglik)` (weighted by the
    carried weights) is unbiased for Z in density space.

    >>> import math, torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.tempered import TemperedSMC
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "y"
    >>> target = gx.Target(model, (), gx.ChoiceMap.kw(y=1.0))
    >>> smc = TemperedSMC(n_particles=512, betas=torch.linspace(0.0, 1.0, 6),
    ...                   request=gx.Regenerate(gx.Selection.at["mu"]))
    >>> coll, log_z = smc.run(torch.Generator().manual_seed(0), target)
    >>> exact = -0.25 - 0.5 * math.log(2 * math.pi * 2.0)
    >>> abs(float(log_z) - exact) < 0.2
    True
    """

    n_particles: int = Pytree.static()
    betas: torch.Tensor = None
    request: EditRequest | None = None
    n_moves: int = Pytree.static(default=1)
    ess_threshold: float = Pytree.static(default=0.5)

    def _tempered_mh_sweep(self, rng, particles, logliks, beta, obs_selection: Selection, request: EditRequest):
        """One MH sweep over the particle axis targeting `p(z) p(y|z)^beta`."""
        particles, logliks, _ = tempered_mh(rng, particles, request, beta, obs_selection, logliks)
        return particles, logliks

    def _init(self, rng: torch.Generator, target: Target[R]):
        """Prior particles with the observations in the trace (beta = 0:
        every weight starts equal), and their log-likelihoods."""
        obs_selection = target.constraint.get_selection()
        trs, _ = target.importance(rng, ChoiceMap.empty(), n=self.n_particles)
        return trs, _loglik(rng, trs, obs_selection), obs_selection

    def _step(self, rng, particles, logliks, lw, log_z, dbeta, beta_next, obs_selection, threshold, gate=None):
        """Reweight by `dbeta * loglik`, resample where the ESS falls below
        `threshold` (and `gate`, where given, holds), then rejuvenate at
        `beta_next`. `lw` is carried normalized (`logsumexp(lw) = 0`), so
        the log-evidence increment is the log weighted mean of the
        tempering ratios, and that reduction normalizes the new weights."""
        k = self.n_particles
        step_lse = logsumexp(lw + dbeta * logliks)
        log_z = log_z + step_lse
        lw = lw + dbeta * logliks - step_lse
        lse, ess = logsumexp_ess(lw)
        do = ess < threshold * k
        if gate is not None:
            do = do & gate
        anc = systematic_resample(rng, lw, k, lse)
        particles = where_tree(do, take_rows(particles, anc), particles)
        logliks = torch.where(do, logliks.index_select(0, anc), logliks)
        lw = torch.where(do, torch.full_like(lw, -math.log(k)), lw)
        if self.request is not None:
            for _ in range(self.n_moves):
                particles, logliks = self._tempered_mh_sweep(
                    rng, particles, logliks, beta_next, obs_selection, self.request
                )
        return particles, logliks, lw, log_z

    def _collection(self, particles, lw, log_z) -> ParticleCollection[R]:
        # The evidence rides in the weights (lw is normalized, so shifting
        # by log_z + log K makes logsumexp(w) - log K equal log_z): the
        # collection's own LML accessor then agrees with log_z.
        return ParticleCollection(particles, lw + log_z + math.log(self.n_particles))

    def run(self, rng: torch.Generator, target: Target[R]) -> tuple[ParticleCollection[R], FloatArray]:
        """Run the ladder; returns (posterior collection, log Z estimate)."""
        particles, logliks, obs_selection = self._init(rng, target)
        k = self.n_particles
        betas = torch.as_tensor(self.betas, device=logliks.device, dtype=logliks.dtype)
        lw = torch.full((k,), -math.log(k), device=logliks.device)
        log_z = torch.zeros((), device=logliks.device)
        for i in range(betas.shape[0] - 1):
            particles, logliks, lw, log_z = self._step(
                rng, particles, logliks, lw, log_z, betas[i + 1] - betas[i], betas[i + 1], obs_selection,
                self.ess_threshold,
            )
        return self._collection(particles, lw, log_z), log_z

    def run_adaptive(
        self, rng: torch.Generator, target: Target[R], n_steps: int = 20, target_ess: float = 0.5
    ) -> tuple[ParticleCollection[R], FloatArray, FloatArray]:
        """Adaptive ladder: each step takes the largest temperature
        increment whose reweighted ESS stays at `target_ess * K`, found by
        bisection with a fixed number of iterations (once beta reaches 1
        the remaining steps change nothing). The last step jumps to beta =
        1 whatever the ESS. Returns `(collection, log_z, betas_visited)`;
        `self.betas` is not read. Every choice is a select on the device.

        >>> import torch
        >>> import genjax_tpu_torch as gx
        >>> from genjax_tpu_torch.inference.tempered import TemperedSMC
        >>> @gx.gen
        ... def model():
        ...     mu = gx.normal(0.0, 1.0) @ "mu"
        ...     _ = gx.normal(mu, 0.5) @ "y"
        >>> target = gx.Target(model, (), gx.ChoiceMap.kw(y=1.5))
        >>> smc = TemperedSMC(n_particles=256, request=gx.Regenerate(gx.Selection.at["mu"]))
        >>> _, log_z, betas = smc.run_adaptive(torch.Generator().manual_seed(0), target, n_steps=8)
        >>> bool(torch.isclose(betas[-1], torch.tensor(1.0))), bool(torch.isfinite(log_z))
        (True, True)
        """
        particles, logliks, obs_selection = self._init(rng, target)
        k = self.n_particles
        dev = logliks.device
        ess_goal = target_ess * k
        lw = torch.full((k,), -math.log(k), device=dev)
        log_z = torch.zeros((), device=dev)
        beta = torch.zeros((), device=dev)

        def ess_at(db):
            return logsumexp_ess(lw + db * logliks)[1]  # the ESS is scale-free: no normalizing

        betas = []
        for step in range(n_steps):
            hi0 = 1.0 - beta
            if step == n_steps - 1:
                # The last budgeted step lands on beta = 1 whatever the
                # ESS, so the population is never left tempered.
                dbeta = hi0
            else:
                lo, hi = torch.zeros((), device=dev), hi0
                for _ in range(BISECTION_STEPS):
                    mid = 0.5 * (lo + hi)
                    ok = ess_at(mid) >= ess_goal
                    lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
                # If even the whole remaining jump keeps the ESS, take it.
                dbeta = torch.where(ess_at(hi0) >= ess_goal, hi0, lo)
            beta = beta + dbeta
            # The increment was chosen to land at the target ESS, so
            # resample after every positive one (the fixed ladder's gate
            # would leave the ESS at the target and stall dbeta at 0); skip
            # steps that change nothing and near-full-ESS jumps.
            particles, logliks, lw, log_z = self._step(
                rng, particles, logliks, lw, log_z, dbeta, beta, obs_selection, 0.99, gate=dbeta > 0.0
            )
            betas.append(beta)
        return self._collection(particles, lw, log_z), log_z, torch.stack(betas)


__all__ = ["TemperedSMC", "retempered_log_alpha", "tempered_mh"]
