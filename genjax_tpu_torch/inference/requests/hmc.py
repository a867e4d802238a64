"""Hamiltonian Monte Carlo and MALA as SMCP3 edit requests.

Counterpart of `genjax_tpu/inference/requests/hmc.py`:
`make_selection_grad_fn`, `selection_gradient`, `sample_momenta`,
`assess_momenta`, `HMC`, `SafeHMC` and `MALA`. `SafeHMC` is `HMC` whose
retdiff must be `NoChange`: the incremental edit's site-graph analysis
(`lang/analysis.py`) proves that the selected addresses cannot reach the
model's return value, or the move raises.

JAX differentiates one chain's `assess` and `vmap`s the move over chains.
Here the move runs once over the batch: the gradient is
`torch.autograd.grad(scores.sum(), values)` of the batched `assess`,
which is exact because chains do not interact (row c of the gradient is
chain c's own). The position and momentum updates run under
`torch.no_grad()`, and the values are made fresh leaves at every
leapfrog step, so no autograd graph spans two steps. The momenta, the
Langevin noise and the step-size jitter are batched draws from the
request's generator; each request also has a deterministic core
(`HMC.edit_with`, `MALA.edit_with`) that takes them as tensors.
"""

import math
from typing import Any

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.concepts import Argdiffs, EditRequest
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gather import batched_mask
from genjax_tpu_torch.core.gfi import Trace, Update
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import FloatArray
from genjax_tpu_torch.distributions.mathx import log

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _is_float(v) -> bool:
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def _particle_sum(x: torch.Tensor, batched: bool) -> torch.Tensor:
    """Sum over every axis of one particle's value."""
    if x.dim() == 0:
        return x
    if batched:
        return x.sum(dim=tuple(range(1, x.dim()))) if x.dim() > 1 else x
    return x.sum()


def _per_leaf(step, leaf: torch.Tensor, batched: bool):
    """A step size of one per particle (shape `(n,)`) shaped to broadcast
    against a per-particle leaf; a scalar step as it is."""
    if isinstance(step, torch.Tensor) and step.dim() == 1 and batched:
        return step.reshape(step.shape + (1,) * (leaf.dim() - 1))
    return step


def make_selection_grad_fn(selection: Selection, trace: Trace[Any], argdiffs: Argdiffs):
    """A reusable `values -> (log density, gradient)` closure over the
    selected addresses of `trace`, every other choice held fixed. One call
    is one batched forward and backward density pass; the gradient is a
    choice map of the values' structure and record, with zeros for leaves
    that are not floating point."""
    complement = trace.get_choices().filter(~selection)
    gen_fn = trace.get_gen_fn()
    args = Diff.tree_primal(argdiffs)
    n = trace.particle_count()

    def fn(values: ChoiceMap):
        leaves, spec = pytree.tree_flatten(values)
        leaves = [v.detach().requires_grad_() if _is_float(v) else v for v in leaves]
        wrt = [v for v in leaves if _is_float(v)]
        with torch.enable_grad():
            score, _ = gen_fn.assess(pytree.tree_unflatten(leaves, spec) | complement, args, n)
            grads = iter(torch.autograd.grad(score.sum(), wrt, allow_unused=True) if wrt else ())
        gradient = []
        for v in leaves:
            g = next(grads) if _is_float(v) else None
            gradient.append(torch.zeros_like(v) if g is None else g)
        return score.detach(), pytree.tree_unflatten(gradient, spec)

    return fn


def grad_tree_unzip(tree):
    """Split a tree into its differentiable (floating-point) leaves and the
    rest: `(grad_tree, nongrad_tree)`, each with `None` where the other
    holds the leaf (JAX's `grad_tree_unzip`)."""
    grad_tree = pytree.tree_map(lambda v: v if _is_float(v) else None, tree)
    nongrad_tree = pytree.tree_map(lambda v: None if _is_float(v) else v, tree)
    return grad_tree, nongrad_tree


def selection_gradient(
    selection: Selection, trace: Trace[Any], argdiffs: Argdiffs
) -> tuple[ChoiceMap, ChoiceMap]:
    """(selected values, gradient of the model's log density with respect
    to them), every other choice held fixed."""
    values = trace.get_choices().filter(selection)
    _, gradient = make_selection_grad_fn(selection, trace, argdiffs)(values)
    return values, gradient


def _mass_leaves(inv_mass, leaves: list) -> list:
    """The diagonal of M^-1 for each value leaf: None is unit mass, a
    scalar is the same for every leaf, a tree matching the values gives
    one (broadcastable) leaf each."""
    if inv_mass is None:
        return [1.0] * len(leaves)
    if isinstance(inv_mass, (int, float)) or (isinstance(inv_mass, torch.Tensor) and inv_mass.dim() == 0):
        return [inv_mass] * len(leaves)
    return pytree.tree_leaves(inv_mass)


def assess_momenta(momenta, mul=1.0, inv_mass=None) -> torch.Tensor:
    """Log density of the momenta under N(0, M), M = 1/inv_mass diagonal,
    per particle: -1/2 p^T M^-1 p - d/2 log 2pi + 1/2 sum log inv_mass."""
    leaves, _, bits = batched_mask(momenta)
    total = None
    for p, im, b in zip(leaves, _mass_leaves(inv_mass, leaves), bits):
        s = -0.5 * im * torch.square(mul * p) - _HALF_LOG_2PI + 0.5 * log(im)
        s = _particle_sum(s, b)
        total = s if total is None else total + s
    return total


def sample_momenta(rng: torch.Generator, like, inv_mass=None):
    """Draw p ~ N(0, M) in the shape (and particle-axis record) of `like`,
    one batched draw per leaf; returns (momenta, their log density)."""
    leaves, spec = pytree.tree_flatten(like)
    momenta = pytree.tree_unflatten(
        [
            torch.randn(v.shape, generator=rng, device=rng.device) / _sqrt(im)
            for v, im in zip(leaves, _mass_leaves(inv_mass, leaves))
        ],
        spec,
    )
    return momenta, assess_momenta(momenta, inv_mass=inv_mass)


@Pytree.dataclass
class HMC(EditRequest):
    """Leapfrog HMC over the selected addresses; the weight is the HMC
    log accept ratio (new model score + new momenta score) - (old model
    score + old momenta score), one per chain. Accept/reject is the
    caller's (`inference.mcmc.mh`).

    `inv_mass` (None, a scalar, or a tree matching the selected choices)
    is the diagonal of M^-1: momenta are drawn from N(0, M) and positions
    move by `eps * inv_mass * p`. `jitter` draws each chain's step size
    uniformly from `eps * [1 - jitter, 1 + jitter]`.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> rng = torch.Generator().manual_seed(0)
    >>> tr, _ = model.importance(rng, gx.ChoiceMap.kw(obs=1.0), (), n=8)
    >>> new, alpha, _, _ = gx.HMC(gx.Selection.at["mu"], 0.1, L=5).edit(rng, tr, gx.Diff.no_change(()))
    >>> alpha.shape, bool(torch.isfinite(alpha).all())
    (torch.Size([8]), True)
    """

    selection: Selection
    eps: FloatArray
    L: int = Pytree.static(default=10)
    inv_mass: Any = None
    jitter: float = Pytree.static(default=0.0)

    def edit(self, rng: torch.Generator, tr: Trace[Any], argdiffs: Argdiffs):
        values = tr.get_choices().filter(self.selection)
        momenta, _ = sample_momenta(rng, values, inv_mass=self.inv_mass)
        eps = self.eps
        if self.jitter:
            # Per-trajectory step-size jitter (Neal 2011, 3.2), one draw
            # per chain, made before the trajectory sees the state.
            n = tr.particle_count()
            u = torch.rand(() if n is None else (n,), generator=rng, device=rng.device)
            eps = eps * (1.0 + self.jitter * (2.0 * u - 1.0))
        return self.edit_with(rng, tr, momenta, eps, argdiffs)

    def edit_with(self, rng: torch.Generator, tr: Trace[Any], momenta, eps=None, argdiffs=None):
        """The deterministic core: `L` leapfrog steps from `momenta` (a
        choice map like the selected values) with step `eps` (a scalar, or
        one per chain), then one `Update` to the final values. Draws
        nothing from `rng`."""
        argdiffs = Diff.no_change(tr.get_args()) if argdiffs is None else argdiffs
        if not Diff.static_check_no_change(argdiffs):
            raise ValueError("HMC moves a trace under its own arguments")
        eps = self.eps if eps is None else eps
        grad_fn = make_selection_grad_fn(self.selection, tr, argdiffs)
        values = tr.get_choices().filter(self.selection)
        v, spec, bits = batched_mask(values)
        m = pytree.tree_leaves(momenta)
        im = _mass_leaves(self.inv_mass, v)
        h = [_per_leaf(eps, x, b) for x, b in zip(v, bits)]
        with torch.no_grad():
            original_momenta_score = assess_momenta(momenta, inv_mass=self.inv_mass)
            _, gradient = grad_fn(values)
            g = pytree.tree_leaves(gradient)
            # One forward and backward density pass per leapfrog step; the
            # trace is rebuilt once at the end, with one Update.
            for _ in range(self.L):
                m = [mi + (hi / 2) * gi for mi, gi, hi in zip(m, g, h)]
                v = [vi + hi * imi * mi for vi, mi, hi, imi in zip(v, m, h, im)]
                _, gradient = grad_fn(pytree.tree_unflatten(v, spec))
                g = pytree.tree_leaves(gradient)
                m = [mi + (hi / 2) * gi for mi, gi, hi in zip(m, g, h)]
            final_trace, _, retdiff, _ = Update(pytree.tree_unflatten(v, spec)).edit(rng, tr, argdiffs)
            final_momenta_score = assess_momenta(pytree.tree_unflatten(m, spec), mul=-1.0, inv_mass=self.inv_mass)
            alpha = (
                final_trace.get_score() - tr.get_score() + final_momenta_score - original_momenta_score
            )
        return final_trace, alpha, retdiff, HMC(self.selection, self.eps, self.L, self.inv_mass, self.jitter)


def SafeHMC(selection: Selection, eps: FloatArray, L: int = 10):
    """HMC with the assertion that its move leaves the model's return value
    unchanged, as the static analysis proves it (`HMC(...).map`; the
    reference's `hmc.py:214-225`). A move whose selected addresses may
    reach the return value raises `AssertionError`.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.requests import SafeHMC
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     return gx.normal(mu, 1.0) @ "obs"
    >>> tr, _ = model.importance(torch.Generator().manual_seed(0), gx.ChoiceMap.kw(obs=1.0), (), n=8)
    >>> _, _, rd, _ = SafeHMC(gx.Selection.at["mu"], 0.1, L=2).edit(torch.Generator(), tr, gx.Diff.no_change(()))
    >>> gx.Diff.static_check_no_change(rd)
    True
    """

    def retdiff_assertion(retdiff):
        assert Diff.static_check_no_change(retdiff), (
            "SafeHMC: the selected addresses may change the model's return value; use HMC directly if this is "
            "intended."
        )
        return retdiff

    return HMC(selection, eps, L).map(retdiff_assertion)


@Pytree.dataclass
class MALA(EditRequest):
    """Metropolis-adjusted Langevin: one gradient step plus noise on the
    selected addresses; the weight is the MALA log accept ratio, one per
    chain. `inv_mass` scales the proposal per dimension (S = inv_mass):
    `v' = v + eps*S*g + sqrt(2*eps*S)*xi`, the reverse kernel under the
    same S."""

    selection: Selection
    eps: FloatArray
    inv_mass: Any = None

    def edit(self, rng: torch.Generator, tr: Trace[Any], argdiffs: Argdiffs):
        values = tr.get_choices().filter(self.selection)
        noise = pytree.tree_map(lambda v: torch.randn(v.shape, generator=rng, device=rng.device), values)
        return self.edit_with(rng, tr, noise, argdiffs)

    def edit_with(self, rng: torch.Generator, tr: Trace[Any], noise, argdiffs=None):
        """The deterministic core: the Langevin proposal from the standard
        normal `noise` (a choice map like the selected values), one
        `Update`, and the accept ratio. Draws nothing from `rng`."""
        argdiffs = Diff.no_change(tr.get_args()) if argdiffs is None else argdiffs
        if not Diff.static_check_no_change(argdiffs):
            raise ValueError("MALA moves a trace under its own arguments")
        eps = self.eps
        grad_fn = make_selection_grad_fn(self.selection, tr, argdiffs)
        values = tr.get_choices().filter(self.selection)
        v, spec, bits = batched_mask(values)
        s = _mass_leaves(self.inv_mass, v)

        def q_score(to_vals, from_vals, from_grads):
            # log q(to | from), up to the normalizer shared by both
            # directions.
            total = None
            for t, f, g, si, b in zip(to_vals, from_vals, from_grads, s, bits):
                q = -_particle_sum(torch.square(t - f - eps * si * g) / (4.0 * eps * si), b)
                total = q if total is None else total + q
            return total

        with torch.no_grad():
            _, grads = grad_fn(values)
            g = pytree.tree_leaves(grads)
            xi = pytree.tree_leaves(noise)
            proposed = [
                vi + eps * si * gi + _sqrt(2.0 * eps * si) * xii for vi, gi, xii, si in zip(v, g, xi, s)
            ]
            fwd_q = q_score(proposed, v, g)
            new_tr, w, retdiff, _ = Update(pytree.tree_unflatten(proposed, spec)).edit(rng, tr, argdiffs)
            new_values = new_tr.get_choices().filter(self.selection)
            _, new_grads = grad_fn(new_values)
            bwd_q = q_score(v, pytree.tree_leaves(new_values), pytree.tree_leaves(new_grads))
            alpha = w + bwd_q - fwd_q
        return new_tr, alpha, retdiff, MALA(self.selection, self.eps, self.inv_mass)


__all__ = [
    "HMC",
    "MALA",
    "assess_momenta",
    "grad_tree_unzip",
    "make_selection_grad_fn",
    "sample_momenta",
    "selection_gradient",
]
