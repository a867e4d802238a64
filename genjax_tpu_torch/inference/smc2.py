"""SMC-squared: sequential inference over state-space-model parameters.

Counterpart of `genjax_tpu/inference/smc2.py::SMC2`. SMC² (Chopin, Jacob
& Papaspiliopoulos 2013) keeps a population of parameter particles, each
carrying its own bootstrap particle filter over the latent states;
parameter weights are updated with the filters' incremental-evidence
estimates, and when the parameter ESS degenerates the population is
resampled and rejuvenated with PMMH moves (a fresh filter over the
observations seen so far).

JAX nests `vmap` over parameter particles, `vmap` over state particles
and `lax.scan` over time. Here the `n_theta` filters of `n_x` state
particles each are one batch of `n_theta * n_x` particles, row-major
(parameter row first): each step is one batched `importance` of the step
model, its parameter argument every row's theta repeated `n_x` times,
and the weights are read as an `(n_theta, n_x)` matrix. The inner
adaptive resample runs for every row and is kept by a per-row `where`, as
JAX selects under its `vmap`, so it reads nothing on the host; its
row-wise reductions are `torch.logsumexp(dim=-1)` (XLA's in JAX). The
parameter weights are reduced by `ops.logsumexp_ess` (one launch per time
step, which gives the gate, the evidence increment and the resampler's
normalizer) and by one `ops.logsumexp` at the end. The parameter-ESS
gate (JAX's scalar `lax.cond`) is a host `if`: one synchronisation per
time step. The time-masked rejuvenation filter (JAX scans the whole
sequence with the steps past `t` as identities) is a loop up to `t`.
"""

import math
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.gfi import GenerativeFunction
from genjax_tpu_torch.core.pytree import Pytree, tree_map
from genjax_tpu_torch.core.typing import per_particle, plain
from genjax_tpu_torch.inference.pmmh import _broadcast_scales, _select, _walk
from genjax_tpu_torch.inference.smc import cum_counts_to_ancestors, systematic_cum_counts, systematic_resample
from genjax_tpu_torch.ops import logsumexp, logsumexp_ess

__all__ = ["SMC2"]


def _n_rows(thetas) -> int:
    return pytree.tree_leaves(thetas)[0].shape[0]


def _at(tree, t: int):
    return tree_map(lambda v: v[t], tree)


@Pytree.dataclass
class SMC2(Pytree):
    """SMC² over the parameters of a state-space model.

    Model contract (as `inference.pmmh.PMMH`): `init_model(theta)` traces
    the initial latent state (returned) and the first observation at
    `obs_addr`; `step_model(z_prev, t, theta)` traces the transition and
    the observation at time `t`; both run on a batch of particles, `theta`
    one value per particle. `prior_sample(rng, n) -> thetas` draws `n`
    parameter particles from the prior (each leaf with the particle axis
    in front: JAX draws one per key under `vmap`) and `log_prior(thetas)`
    scores each of them.

    `n_theta` parameter particles each carry `n_x` state particles. When
    the parameter ESS drops below `theta_ess_threshold * n_theta`, the
    parameter population is resampled and each particle gets `n_rejuv`
    PMMH moves (random-walk scale `step_scales`), whose likelihood
    estimates come from a fresh filter over the observations processed so
    far.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.smc2 import SMC2
    >>> @gx.gen
    ... def init_model(theta):
    ...     z = gx.normal(0.0, 1.0) @ "z"
    ...     _ = gx.normal(z, 0.4) @ "y"
    ...     return z
    >>> @gx.gen
    ... def step_model(z_prev, t, theta):
    ...     z = gx.normal(theta * z_prev, 0.5) @ "z"
    ...     _ = gx.normal(z, 0.4) @ "y"
    ...     return z
    >>> alg = SMC2(step_model, init_model,
    ...            prior_sample=lambda rng, n: torch.randn(n, generator=rng, device=rng.device),
    ...            log_prior=lambda a: gx.normal.logpdf(a, 0.0, 1.0),
    ...            n_theta=32, n_x=64, step_scales=0.3)
    >>> ys = torch.tensor([0.3, 1.0, 0.5, -0.2, 0.8])
    >>> out = alg.run(torch.Generator().manual_seed(0), ys)
    >>> out["thetas"].shape, bool(torch.isfinite(out["lml"]))
    (torch.Size([32]), True)
    """

    step_model: GenerativeFunction[Any]
    init_model: GenerativeFunction[Any]
    prior_sample: Callable[[torch.Generator, int], Any] = Pytree.static()
    log_prior: Callable[[Any], Any] = Pytree.static()
    n_theta: int = Pytree.static()
    n_x: int = Pytree.static()
    step_scales: Any = 0.25
    obs_addr: str = Pytree.static(default="y")
    theta_ess_threshold: float = Pytree.static(default=0.5)
    inner_ess_threshold: float = Pytree.static(default=0.5)
    n_rejuv: int = Pytree.static(default=2)

    # -- the inner filters, all parameter rows at once ----------------------

    def _thetas_per_particle(self, thetas):
        """Every row's theta repeated for its `n_x` state particles, marked
        as one value per particle."""
        return tree_map(lambda v: per_particle(plain(v).repeat_interleave(self.n_x, dim=0)), thetas)

    def _init_all(self, rng: torch.Generator, thetas, obs0):
        """Start one inner filter per parameter row: `(z, lw_x (R, n_x),
        incremental loglik (R,))`."""
        rows = _n_rows(thetas)
        trs, ws = self.init_model.importance(
            rng, ChoiceMap.kw(**{self.obs_addr: obs0}), (self._thetas_per_particle(thetas),), rows * self.n_x
        )
        lw = ws.reshape(rows, self.n_x)
        return tree_map(plain, trs.get_retval()), lw, torch.logsumexp(lw, -1) - math.log(self.n_x)

    def _advance_all(self, rng: torch.Generator, thetas, z, lw, obs_t, t: int, u0: torch.Tensor | None = None):
        """One step of every inner filter: `(z', lw', incremental log
        evidence (R,))`. The increment telescopes over carried weights,
        `lse(lw + w) - lse(lw)`. The systematic resample runs for every row
        (one uniform each, `u0` where given) and is kept where the row's
        ESS falls below `inner_ess_threshold * n_x`."""
        rows = _n_rows(thetas)
        trs, ws = self.step_model.importance(
            rng,
            ChoiceMap.kw(**{self.obs_addr: obs_t}),
            (tree_map(per_particle, z), t, self._thetas_per_particle(thetas)),
            rows * self.n_x,
        )
        z2 = tree_map(plain, trs.get_retval())
        lw2 = lw + ws.reshape(rows, self.n_x)
        lse2 = torch.logsumexp(lw2, -1)
        incr = lse2 - torch.logsumexp(lw, -1)
        if u0 is None:
            u0 = torch.rand(rows, generator=rng, device=rng.device)
        anc = cum_counts_to_ancestors(systematic_cum_counts(u0, lw2, self.n_x, lse2), self.n_x)
        ess = torch.exp(-torch.logsumexp(2.0 * (lw2 - lse2[:, None]), -1))
        need = ess < self.inner_ess_threshold * self.n_x
        flat = (anc + self.n_x * torch.arange(rows, device=anc.device)[:, None]).reshape(-1)
        keep = need.repeat_interleave(self.n_x)
        z_out = tree_map(
            lambda a: torch.where(keep.reshape(keep.shape + (1,) * (a.dim() - 1)), a.index_select(0, flat), a), z2
        )
        lw_out = torch.where(need[:, None], torch.zeros_like(lw2), lw2)
        return z_out, lw_out, incr

    def _masked_loglik(self, rng: torch.Generator, thetas, observations, t_upto: int):
        """A fresh filter per parameter row over `y[0 : t_upto]` (inclusive):
        `(loglik (R,), z, lw_x)` at time `t_upto`. JAX scans the whole
        sequence with the steps past `t_upto` as identities; they change
        nothing, so the loop stops at `t_upto`."""
        z, lw, loglik = self._init_all(rng, thetas, _at(observations, 0))
        for i in range(1, int(t_upto) + 1):
            z, lw, incr = self._advance_all(rng, thetas, z, lw, _at(observations, i), i)
            loglik = loglik + incr
        return loglik, z, lw

    def _take_thetas(self, anc: torch.Tensor, thetas, z, lw_x, loglik):
        """The rows `anc` of the parameter particles and of their filters."""
        n_th = anc.shape[0]

        def blocks(v):
            return v.reshape(n_th, self.n_x, *v.shape[1:]).index_select(0, anc).reshape(v.shape)

        return (
            tree_map(lambda v: plain(v).index_select(0, anc), thetas),
            tree_map(blocks, z),
            lw_x.index_select(0, anc),
            loglik.index_select(0, anc),
        )

    def _pmmh_move(self, rng: torch.Generator, thetas, z, lw_x, loglik, observations, t: int, scales):
        """One PMMH move of every parameter particle, with a fresh filter
        over `y[0 : t]` at the proposed parameters."""
        th_p = _walk(rng, thetas, scales)
        ll_p, z_p, lw_p = self._masked_loglik(rng, th_p, observations, t)
        log_a = self.log_prior(th_p) + ll_p - self.log_prior(thetas) - loglik
        acc = torch.log(torch.rand(log_a.shape, generator=rng, device=rng.device)) < log_a
        keep = acc.repeat_interleave(self.n_x)
        z = tree_map(lambda a, b: torch.where(keep.reshape(keep.shape + (1,) * (a.dim() - 1)), a, b), z_p, z)
        return (
            _select(acc, th_p, thetas),
            z,
            torch.where(acc[:, None], lw_p, lw_x),
            torch.where(acc, ll_p, loglik),
            acc,
        )

    # -- driver -------------------------------------------------------------

    def run(
        self,
        rng: torch.Generator,
        observations: Any,
        collect: Callable[[Any, Any], Any] | None = None,
    ) -> dict:
        """Run SMC² over the observation sequence (leaves with a leading
        time axis, on the generator's device).

        Returns a dict: `thetas` (parameter particles), `log_weights` (their
        final log weights), `loglik` (each particle's own running log
        p_hat(y_1:T | theta)), `lml` (the model-evidence estimate
        log p_hat(y_1:T)), `n_rejuvenations` (a Python int: the gate is
        read on the host), `accept_rate` (mean PMMH acceptance over all
        moves), and with `collect(thetas, log_weights)`, `collected`: its
        per-time-index stack with T rows (row 0 after assimilating y_0, as
        `BootstrapFilter.run`)."""
        n_th = self.n_theta
        thetas = self.prior_sample(rng, n_th)
        scales = _broadcast_scales(self.step_scales, thetas)
        z, lw_x, incr0 = self._init_all(rng, thetas, _at(observations, 0))
        loglik, lw_th = incr0, incr0
        lml = torch.zeros((), device=lw_th.device)
        acc_sum = torch.zeros((), device=lw_th.device)
        n_rej = 0
        outs = [] if collect is None else [collect(thetas, incr0)]
        T = pytree.tree_leaves(observations)[0].shape[0]
        for t in range(1, T):
            z, lw_x, incr = self._advance_all(rng, thetas, z, lw_x, _at(observations, t), t)
            loglik = loglik + incr
            lw_th = lw_th + incr
            lse, ess = logsumexp_ess(lw_th)
            # The parameter-ESS gate is a host branch: one synchronisation
            # per time step.
            if ess < self.theta_ess_threshold * n_th:
                lml = lml + lse - math.log(n_th)
                anc = systematic_resample(rng, lw_th, n_th, lse)
                thetas, z, lw_x, loglik = self._take_thetas(anc, thetas, z, lw_x, loglik)
                lw_th = torch.zeros_like(lw_th)
                for _ in range(self.n_rejuv):
                    thetas, z, lw_x, loglik, acc = self._pmmh_move(rng, thetas, z, lw_x, loglik, observations, t, scales)
                    acc_sum = acc_sum + acc.to(torch.float32).mean()
                n_rej += 1
            if collect is not None:
                outs.append(collect(thetas, lw_th))
        lml = lml + logsumexp(lw_th) - math.log(n_th)
        total_moves = n_rej * self.n_rejuv
        result = {
            "thetas": thetas,
            "log_weights": lw_th,
            "loglik": loglik,
            "lml": lml,
            "n_rejuvenations": n_rej,
            "accept_rate": acc_sum / total_moves if total_moves else torch.zeros((), device=lml.device),
        }
        if collect is not None:
            result["collected"] = pytree.tree_map(lambda *xs: torch.stack(xs), *outs)
        return result
