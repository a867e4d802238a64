"""ADEV gradient-estimation strategies.

Counterpart of `genjax_tpu/adev/primitives.py`: REINFORCE, flip
enumeration (one after the other, and the "parallel" forms), the flip
measure-valued derivative, categorical enumeration, normal, pushforward
and multivariate-normal reparameterization, uniform, implicit
reparameterization for beta, gamma and dirichlet draws, baselines and
`add_cost`, each with its batched form.

Each strategy returns an estimate whose autograd gradient is its tangent
(`adev/core.py`): `stopgrad` is `.detach()`, and where the JAX strategy
builds `Dual(value, tangent)` by hand, the port builds a tensor with that
value whose gradient is that tangent.

A batch of sites is a site drawn with `n` (a guide inside
`ImportanceK(n=K)`, or `prim(*args, n=3)`); as in JAX under `vmap`:

* `REINFORCE` batches exactly: one continuation, the score term summing
  every lane's `(L - b_i) * d log p_i`.
* Enumeration (`FlipEnum`, `FlipEnumParallel`, `CategoricalEnumParallel`)
  is Rao-Blackwellized per site: each lane is enumerated with the others
  held at their sampled values, n * |support| continuation calls (each a
  re-execution of the loss: use a batched enumeration at small n only).
  Unbiased; exact enumeration at n = 1.
* `FlipMVD`: one dual continuation and n pure ones, one lane flipped each.
* `Baseline` over REINFORCE feeds per-lane baselines to the score term;
  over any other strategy the baseline cancels and is dropped.

The "parallel" strategies run their branches one after the other, as the
port has no `vmap` over a continuation; like JAX's, they give each branch
randomness of its own below the site (JAX splits the key per branch).

The implicit strategies draw through `torch._standard_gamma`, whose
backward is Figurnov et al.'s implicit derivative, exact where the JAX
`BetaIMPLICIT` takes central differences of `betainc` (torch has no
`betainc`).
"""

from typing import Any, Callable

import torch

from genjax_tpu_torch.adev.core import ADEVPrimitive, TailCallADEVPrimitive
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import batch_dims, depth_of, mark, plain, sample_shape
from genjax_tpu_torch.distributions.library import (
    _dirichlet_sample,
    _flip_logpdf,
    _flip_sample,
    _gamma_sample,
    _geometric_logpdf,
    _geometric_sample,
    _normal_logpdf,
    _normal_sample,
    _standard_gamma,
)


def _detached(x):
    """`x` cut from the autograd graph, its batch mark kept."""
    return mark(x.detach(), depth_of(x)) if isinstance(x, torch.Tensor) else x


def _lanes(x, n, device) -> torch.Tensor:
    """A site's argument with one row per lane: shape `(*batch_dims(n),
    *event)`, broadcast where it carries fewer batch axes (its mark says how
    many it carries, counted from the innermost)."""
    dims = batch_dims(n)
    d = depth_of(x)
    t = torch.as_tensor(plain(x), device=device)
    t = t.reshape((1,) * (len(dims) - d) + tuple(t.shape))
    return t.expand(*dims, *t.shape[len(dims) :])


def _lane_sums(x: torch.Tensor, n) -> torch.Tensor:
    """`x` (batch axes in front) summed over its event axes, flattened to
    one entry per lane."""
    nd = len(batch_dims(n))
    if x.dim() > nd:
        x = x.sum(dim=tuple(range(nd, x.dim())))
    return x.expand(batch_dims(n)).reshape(-1)


def _bool(v: bool, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.bool, device=device)


#############
# REINFORCE #
#############


@Pytree.dataclass
class REINFORCE(ADEVPrimitive):
    """Score-function estimator: the draw carries no gradient; the estimate
    gains `stopgrad(L) * (log p(v; theta) - stopgrad(...))`, whose gradient
    is `L * d log p(v; theta)` (plus the continuation's own)."""

    sample_function: Callable[..., Any] = Pytree.static()
    differentiable_logpdf: Callable[..., Any] = Pytree.static()

    def sample(self, rng, *args, n=None):
        return self.sample_function(rng, *args, n=n)

    def continue_with(self, rng, args, n=None):
        v = self.sample_function(rng, *(_detached(a) for a in args), n=n)
        v = v.detach() if isinstance(v, torch.Tensor) else v
        score = torch.as_tensor(self.differentiable_logpdf(v, *args)).sum()

        def finish(loss):
            return loss + loss.detach() * (score - score.detach())

        return v, finish

    def get_batched_prim(self, n) -> ADEVPrimitive:
        return BatchedREINFORCE(self, False, n)


def reinforce(sample_func, logpdf_func) -> REINFORCE:
    """A REINFORCE strategy from `sample_func(rng, *args, n=None)` and a
    differentiable `logpdf_func(v, *args)`."""
    return REINFORCE(sample_func, logpdf_func)


@Pytree.dataclass
class BatchedREINFORCE(ADEVPrimitive):
    """`REINFORCE` over a batch of sites: one continuation for the whole
    batch; the score term is `sum_i (L - b_i) * d log p(v_i)` (the baseline
    `b_i` is the first argument with `with_baseline`, else 0)."""

    original: REINFORCE
    with_baseline: bool = Pytree.static(default=False)
    n: Any = Pytree.static(default=None)

    def sample(self, rng, *args, n=None):
        if self.with_baseline:
            args = args[1:]
        return self.original.sample_function(rng, *args, n=self.n)

    def continue_with(self, rng, args, n=None):
        b = None
        if self.with_baseline:
            b, args = args[0], args[1:]
        v = self.original.sample_function(rng, *(_detached(a) for a in args), n=self.n)
        v = v.detach()
        site_lps = _lane_sums(self.original.differentiable_logpdf(v, *args), self.n)
        if b is not None:
            b = _lanes(b, self.n, v.device).reshape(-1)

        def finish(loss):
            centered = loss.detach() if b is None else loss.detach() - b.detach()
            return loss + (centered * (site_lps - site_lps.detach())).sum()

        return v, finish


###############
# Enumeration #
###############


@Pytree.dataclass
class FlipEnum(ADEVPrimitive):
    """Exact enumeration over both outcomes of a Bernoulli draw: the
    continuation runs once per outcome, both with the same randomness
    below; the estimate `p * L_T + (1 - p) * L_F` differentiates to
    `dp (L_T - L_F) + p dL_T + (1 - p) dL_F`."""

    def sample(self, rng, p, n=None):
        return _flip_sample(rng, p, n)

    def branch_stream(self, i: int) -> int:
        return 0

    def jvp_estimate(self, rng, args, konts, n=None):
        (p,) = args
        _, kdual = konts
        l_t = kdual(_bool(True, rng.device), self.branch_stream(0))
        l_f = kdual(_bool(False, rng.device), self.branch_stream(1))
        return p * l_t + (1.0 - p) * l_f

    def get_batched_prim(self, n) -> ADEVPrimitive:
        return BatchedFlipEnum(self, n)


flip_enum = FlipEnum()


@Pytree.dataclass
class FlipEnumParallel(FlipEnum):
    """`FlipEnum` with the two branches on streams of their own, as JAX's
    splits the key between its two vmapped branches."""

    def branch_stream(self, i: int) -> int:
        return i + 1


flip_enum_parallel = FlipEnumParallel()


@Pytree.dataclass
class BatchedFlipEnum(ADEVPrimitive):
    """Per-site Rao-Blackwellized enumeration over a batch of Bernoulli
    sites (2n continuation calls, each lane enumerated with the others at
    their sampled values):

        value   = mean_i [p_i L_T,i + (1 - p_i) L_F,i]
        tangent = mean_i [p_i dL_T,i + (1 - p_i) dL_F,i] + sum_i dp_i (L_T,i - L_F,i)
    """

    original: ADEVPrimitive
    n: Any = Pytree.static()

    def sample(self, rng, *args, n=None):
        return self.original.sample(rng, *args, n=self.n)

    def jvp_estimate(self, rng, args, konts, n=None):
        (p,) = args
        _, kdual = konts
        dims = batch_dims(self.n)
        p = _lanes(p, self.n, rng.device).reshape(-1)
        b = torch.rand(p.shape, generator=rng, device=rng.device) < p.detach()
        lanes = torch.arange(p.shape[0], device=rng.device)
        l_t, l_f = [], []
        for i in range(p.shape[0]):
            site = lanes == i
            l_t.append(kdual(torch.where(site, True, b).reshape(dims)))
            l_f.append(kdual(torch.where(site, False, b).reshape(dims)))
        l_t, l_f = torch.stack(l_t), torch.stack(l_f)
        sp = p.detach()
        passed = (sp * l_t + (1.0 - sp) * l_f).mean()
        return passed + ((p - sp) * (l_t - l_f).detach()).sum()


@Pytree.dataclass
class FlipMVD(ADEVPrimitive):
    """Measure-valued derivative for a Bernoulli draw: one dual run at the
    sampled outcome and one pure run at the other (same randomness below);
    `dE/dp` is estimated by `L(True) - L(False)`."""

    def sample(self, rng, p, n=None):
        return _flip_sample(rng, p, n)

    def jvp_estimate(self, rng, args, konts, n=None):
        (p,) = args
        kpure, kdual = konts
        b = torch.rand((), generator=rng, device=rng.device) < torch.as_tensor(p).detach()
        loss = kdual(b)
        flipped = kpure(~b)
        d_dp = torch.where(b, loss.detach() - flipped, flipped - loss.detach())
        p = torch.as_tensor(p, device=rng.device)
        return loss + (p - p.detach()) * d_dp

    def get_batched_prim(self, n) -> ADEVPrimitive:
        return BatchedFlipMVD(self, n)


flip_mvd = FlipMVD()


@Pytree.dataclass
class BatchedFlipMVD(ADEVPrimitive):
    """Per-site MVD over a batch of Bernoulli sites with the shared-sample
    coupling: one dual run at the sampled batch and n pure runs, one lane
    flipped each."""

    original: ADEVPrimitive
    n: Any = Pytree.static()

    def sample(self, rng, *args, n=None):
        return self.original.sample(rng, *args, n=self.n)

    def jvp_estimate(self, rng, args, konts, n=None):
        (p,) = args
        kpure, kdual = konts
        dims = batch_dims(self.n)
        p = _lanes(p, self.n, rng.device).reshape(-1)
        b = torch.rand(p.shape, generator=rng, device=rng.device) < p.detach()
        loss = kdual(b.reshape(dims))
        lanes = torch.arange(p.shape[0], device=rng.device)
        others = torch.stack([kpure(torch.where(lanes == i, ~b, b).reshape(dims)) for i in range(p.shape[0])])
        est = torch.where(b, loss.detach() - others, others - loss.detach())
        return loss + ((p - p.detach()) * est).sum()


@Pytree.dataclass
class CategoricalEnumParallel(ADEVPrimitive):
    """Exact enumeration over the categories of a categorical draw with
    (unnormalized) probabilities `probs`, each category's continuation on a
    stream of its own: the estimate `sum_c pi_c L_c` with `pi = probs /
    sum(probs)`, whose gradient carries the normalization's."""

    def sample(self, rng, probs, n=None):
        logits = torch.log(torch.as_tensor(probs))
        e = torch.empty(sample_shape(n, logits), device=rng.device).exponential_(generator=rng)
        return torch.argmax(logits - torch.log(e), dim=-1)

    def jvp_estimate(self, rng, args, konts, n=None):
        (probs,) = args
        _, kdual = konts
        n_cat = probs.shape[-1]
        losses = torch.stack(
            [kdual(torch.full((), c, dtype=torch.int64, device=rng.device), c + 1) for c in range(n_cat)]
        )
        pi = probs / probs.sum()
        return (pi * losses).sum()

    def get_batched_prim(self, n) -> ADEVPrimitive:
        return BatchedCategoricalEnum(self, n)


categorical_enum_parallel = CategoricalEnumParallel()


@Pytree.dataclass
class BatchedCategoricalEnum(ADEVPrimitive):
    """Per-site Rao-Blackwellized enumeration over a batch of categorical
    sites (n sites x C categories: n * C continuation calls, the others at
    their sampled values). See `BatchedFlipEnum`; here the per-site weights
    are the normalized rows and the probability term differentiates the
    normalization: `sum_i sum_c dpi_ic L_ic`."""

    original: ADEVPrimitive
    n: Any = Pytree.static()

    def sample(self, rng, *args, n=None):
        return self.original.sample(rng, *args, n=self.n)

    def jvp_estimate(self, rng, args, konts, n=None):
        (probs,) = args
        _, kdual = konts
        dims = batch_dims(self.n)
        c = probs.shape[-1]
        probs = _lanes(probs, self.n, rng.device).reshape(-1, c)
        v = self.original.sample(rng, probs.detach(), n=None)
        lanes = torch.arange(probs.shape[0], device=rng.device)
        losses = torch.stack(
            [
                torch.stack([kdual(torch.where(lanes == i, cat, v).reshape(dims)) for cat in range(c)])
                for i in range(probs.shape[0])
            ]
        )
        pi = probs / probs.sum(-1, keepdim=True)
        sp = pi.detach()
        passed = (sp * losses).sum(-1).mean()
        return passed + ((pi - sp) * losses.detach()).sum()


flip_reinforce = reinforce(
    lambda rng, p, n=None: _flip_sample(rng, p, n),
    lambda v, p: _flip_logpdf(v, p),
)

geometric_reinforce = reinforce(
    lambda rng, p, n=None: _geometric_sample(rng, p, n),
    lambda v, p: _geometric_logpdf(v, p),
)

normal_reinforce = reinforce(
    lambda rng, loc, scale, n=None: _normal_sample(rng, loc, scale, n),
    lambda v, loc, scale: _normal_logpdf(v, loc, scale),
)


#######################
# Reparameterization  #
#######################


@Pytree.dataclass
class NormalREPARAM(TailCallADEVPrimitive):
    """`v = mu + sigma * eps`, `eps ~ N(0, 1)`: the derivative flows through
    the draw (`v' = mu' + sigma' * eps`)."""

    def sample(self, rng, loc, scale, n=None):
        return _normal_sample(rng, loc, scale, n)


normal_reparam = NormalREPARAM()


@Pytree.dataclass
class PushforwardREPARAM(TailCallADEVPrimitive):
    """`v = transform(eps, *args)` with `eps ~ N(0, I)` of shape
    `eps_shape` (behind the batch axes, under a batch) held fixed: the
    pathwise derivative of an arbitrary differentiable push-forward."""

    transform: Callable[..., Any] = Pytree.static()
    eps_shape: tuple = Pytree.static(default=())

    def sample(self, rng, *args, n=None):
        eps = torch.randn((*batch_dims(n), *self.eps_shape), generator=rng, device=rng.device)
        return self.transform(eps, *args)


def pushforward_reparam(transform, eps_shape=()) -> PushforwardREPARAM:
    """Pathwise-gradient primitive for `v = transform(eps, *args)`, `eps ~
    N(0, I)` of shape `eps_shape`."""
    return PushforwardREPARAM(transform, tuple(eps_shape))


@Pytree.dataclass
class MvNormalDiagREPARAM(TailCallADEVPrimitive):
    """Componentwise `loc + scale_diag * eps`."""

    def sample(self, rng, loc, scale_diag, n=None):
        return _normal_sample(rng, loc, scale_diag, n)


mv_normal_diag_reparam = MvNormalDiagREPARAM()


@Pytree.dataclass
class MvNormalREPARAM(TailCallADEVPrimitive):
    """Full covariance: `mu + cholesky(cov) @ eps`, differentiated through
    the Cholesky factor."""

    def sample(self, rng, mu, cov, n=None):
        eps = torch.randn(sample_shape(n, mu), generator=rng, device=rng.device)
        chol = torch.linalg.cholesky(torch.as_tensor(plain(cov)))
        return mu + (chol @ eps.unsqueeze(-1)).squeeze(-1)


mv_normal_reparam = MvNormalREPARAM()


@Pytree.dataclass
class Uniform(TailCallADEVPrimitive):
    """A U(0, 1) draw, with zero tangent."""

    def sample(self, rng, *_args, n=None):
        return torch.rand(sample_shape(n), generator=rng, device=rng.device)


uniform = Uniform()


@Pytree.dataclass
class BetaIMPLICIT(TailCallADEVPrimitive):
    """Implicit reparameterization of a Beta(alpha, beta) draw as
    `G1 / (G1 + G2)`, each gamma's derivative implicit (exact)."""

    def sample(self, rng, alpha, beta, n=None):
        shape = sample_shape(n, alpha, beta)
        g1, g0 = _standard_gamma(rng, alpha, shape), _standard_gamma(rng, beta, shape)
        return g1 / (g1 + g0)


beta_implicit = BetaIMPLICIT()


@Pytree.dataclass
class GammaIMPLICIT(TailCallADEVPrimitive):
    """Implicit reparameterization of a Gamma(concentration, rate) draw:
    the standard gamma's implicit derivative, scaled by `1 / rate`."""

    def sample(self, rng, concentration, rate, n=None):
        return _gamma_sample(rng, concentration, rate, n)


gamma_implicit = GammaIMPLICIT()


@Pytree.dataclass
class DirichletIMPLICIT(TailCallADEVPrimitive):
    """Implicit reparameterization of a Dirichlet(alpha) draw through its
    normalized gammas."""

    def sample(self, rng, alpha, n=None):
        return _dirichlet_sample(rng, alpha, n)


dirichlet_implicit = DirichletIMPLICIT()


#############
# Baselines #
#############


@Pytree.dataclass
class Baseline(ADEVPrimitive):
    """Variance reduction: the wrapped strategy sees `L - b` and the
    estimate gets `b` back (the first argument is the baseline `b`)."""

    prim: ADEVPrimitive

    def sample(self, rng, *args, n=None):
        return self.prim.sample(rng, *args[1:], n=n)

    def continue_with(self, rng, args, n=None):
        b = args[0]
        once = self.prim.continue_with(rng, args[1:], n)
        if once is None:
            return None
        v, inner = once
        if inner is None:
            return v, None  # a pathwise strategy: L - b + b is L
        return v, lambda loss: inner(loss - b) + b

    def jvp_estimate(self, rng, args, konts, n=None):
        b = args[0]
        kpure, kdual = konts
        centered = (lambda v, s=0: kpure(v, s) - b, lambda v, s=0: kdual(v, s) - b)
        return self.prim.jvp_estimate(rng, args[1:], centered, n) + b

    def get_batched_prim(self, n) -> ADEVPrimitive:
        if isinstance(self.prim, REINFORCE):
            # Per-lane baselines enter the batched score term.
            return BatchedREINFORCE(self.prim, True, n)
        # Over enumeration, MVD or a pathwise strategy the shift cancels
        # (their probability terms are differences of branches or weights
        # that sum to zero): drop the baseline argument.
        return _BaselineDropped(self.prim.get_batched_prim(n))


def baseline(prim: ADEVPrimitive) -> Baseline:
    return Baseline(prim)


@Pytree.dataclass
class _BaselineDropped(ADEVPrimitive):
    """A batched strategy that ignores the (inert) leading baseline."""

    inner: ADEVPrimitive

    def sample(self, rng, *args, n=None):
        return self.inner.sample(rng, *args[1:], n=n)

    def continue_with(self, rng, args, n=None):
        return self.inner.continue_with(rng, args[1:], n)

    def jvp_estimate(self, rng, args, konts, n=None):
        return self.inner.jvp_estimate(rng, args[1:], konts, n)


########
# Cost #
########


@Pytree.dataclass
class AddCost(ADEVPrimitive):
    """Add a differentiable cost `w` to the objective."""

    def sample(self, rng, w, n=None):
        return w

    def continue_with(self, rng, args, n=None):
        (w,) = args
        return w, lambda loss: loss + w

    def get_batched_prim(self, n) -> ADEVPrimitive:
        return BatchedAddCost(n)


@Pytree.dataclass
class BatchedAddCost(ADEVPrimitive):
    """`add_cost` over a batch: every lane's cost is added once."""

    n: Any = Pytree.static()

    def sample(self, rng, w, n=None):
        return _lanes(w, self.n, rng.device)

    def continue_with(self, rng, args, n=None):
        (w,) = args
        lanes = _lanes(w, self.n, rng.device)
        return lanes, lambda loss: loss + lanes.sum()


def add_cost(w, n=None) -> None:
    """Add `w` to the enclosing expectation (with `n`, one cost per lane)."""
    AddCost()(w, n=n)


__all__ = [
    "AddCost",
    "Baseline",
    "BatchedAddCost",
    "BatchedCategoricalEnum",
    "BatchedFlipEnum",
    "BatchedFlipMVD",
    "BatchedREINFORCE",
    "BetaIMPLICIT",
    "CategoricalEnumParallel",
    "DirichletIMPLICIT",
    "FlipEnum",
    "FlipEnumParallel",
    "FlipMVD",
    "GammaIMPLICIT",
    "MvNormalDiagREPARAM",
    "MvNormalREPARAM",
    "NormalREPARAM",
    "PushforwardREPARAM",
    "REINFORCE",
    "Uniform",
    "add_cost",
    "baseline",
    "beta_implicit",
    "categorical_enum_parallel",
    "dirichlet_implicit",
    "flip_enum",
    "flip_enum_parallel",
    "flip_mvd",
    "flip_reinforce",
    "gamma_implicit",
    "geometric_reinforce",
    "mv_normal_diag_reparam",
    "mv_normal_reparam",
    "normal_reinforce",
    "normal_reparam",
    "pushforward_reparam",
    "reinforce",
    "uniform",
]
