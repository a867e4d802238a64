"""Elliptical slice sampling as an edit request.

Counterpart of `genjax_tpu/inference/requests/elliptical.py`:
`EllipticalSlice` and `elliptical_slice` (Murray, Adams & MacKay 2010), the
tuning-free move for sites with Gaussian priors (latent GPs, random
effects). Every move is accepted and there is no step size; the auxiliary
prior draw `nu ~ p(theta | rest)` comes from `Regenerate` of the selected
sites, the likelihood of a point on the ellipse from `Update` and
`Trace.project`.

Validity contract, as in JAX: each selected site has a (multivariate)
normal prior whose parameters do not depend on other selected sites; its
mean is given as `mean` (a number, or a tree matching the selected
choices).

The bracket-shrinking loop runs over the chain batch at once, masking the
chains that have accepted (as JAX's `vmap`ped `while_loop` does), up to
`max_shrink` trips. The host reads "every chain accepted" every
`ELLIPTICAL_CHECK_EVERY` trips (at trips 0, 4, 8, ...), so a move that
ends after `t` trips makes `t / ELLIPTICAL_CHECK_EVERY + 1` device
synchronisations; `elliptical_stats` counts the moves, trips and reads.
"""

from typing import Any

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import Selection
from genjax_tpu_torch.core.concepts import Argdiffs, EditRequest
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gather import batched_mask
from genjax_tpu_torch.core.gfi import Trace, Update
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.requests import Regenerate
from genjax_tpu_torch.core.staging import where_tree

__all__ = ["EllipticalSlice", "elliptical_slice"]

_TWO_PI = 6.283185307179586
_TINY = torch.finfo(torch.float32).tiny

ELLIPTICAL_CHECK_EVERY = 4  # trips between the host's reads of "every chain accepted"

# Summed over every move so far (a caller takes differences): the moves,
# their shrink trips, their host reads, and the moves that stopped at
# `max_shrink` before every chain had accepted.
elliptical_stats: dict = {"moves": 0, "trips": 0, "syncs": 0, "capped": 0}


def _per_chain(x: torch.Tensor, like: torch.Tensor, batched: bool) -> torch.Tensor:
    """A per-chain `(C,)` quantity shaped to broadcast against a leaf."""
    if not batched or x.dim() == 0:
        return x
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def _on_ellipse(theta, nu, mean, angle, bits):
    """The point at `angle` on the ellipse through `theta` (angle 0) and
    the auxiliary draw `nu` (angle pi/2), centred at the prior mean; a
    leaf list. `angle` is `()` or one per chain."""
    c, s = torch.cos(angle), torch.sin(angle)
    if isinstance(mean, (int, float)) or (isinstance(mean, torch.Tensor) and mean.dim() == 0):
        means = [mean] * len(theta)
    else:
        means = pytree.tree_leaves(mean)
    return [
        m + (t - m) * _per_chain(c, t, b) + (v - m) * _per_chain(s, t, b)
        for t, v, m, b in zip(theta, nu, means, bits)
    ]


def _loglik(rng: torch.Generator, trace: Trace[Any], selection: Selection):
    """log p(everything else | selected sites): the joint score less the
    selected sites' own (prior) score, the slice function."""
    return trace.get_score() - trace.project(rng, selection)


@Pytree.dataclass
class EllipticalSlice(EditRequest):
    """One elliptical slice sampling move over the selected addresses, on
    every chain of the trace.

    The weight is 0: the move leaves the posterior invariant, so an `mh`
    driver around it always accepts. `mean` is the selected sites' prior
    mean; `max_shrink` bounds the bracket-shrinking loop (a chain that has
    not accepted by then keeps its state, which is also invariant).

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.requests import EllipticalSlice
    >>> @gx.gen
    ... def model():
    ...     f = gx.normal(0.0, 1.0) @ "f"
    ...     _ = gx.normal(f, 0.5) @ "obs"
    >>> rng = torch.Generator().manual_seed(0)
    >>> tr, _ = model.importance(rng, gx.ChoiceMap.kw(obs=1.0), ())
    >>> new_tr, w, _, _ = EllipticalSlice(gx.Selection.at["f"]).edit(rng, tr, gx.Diff.no_change(()))
    >>> float(w)
    0.0
    """

    selection: Selection
    mean: Any = 0.0
    max_shrink: int = Pytree.static(default=32)

    def edit(self, rng: torch.Generator, tr: Trace[Any], argdiffs: Argdiffs):
        if not Diff.static_check_no_change(argdiffs):
            raise ValueError("EllipticalSlice moves a trace under its own arguments")
        sel = self.selection
        score = tr.get_score()
        dev = score.device
        shape = score.shape  # () or (C,)

        theta_map = tr.get_choices().filter(sel)
        theta, spec, bits = batched_mask(theta_map)
        # Regenerate's proposal at a site is its prior conditional, so the
        # regenerated values are nu ~ p(. | unselected sites).
        nu_tr, _, _, _ = Regenerate(sel).edit(rng, tr, argdiffs)
        nu = pytree.tree_leaves(nu_tr.get_choices().filter(sel))

        u = torch.rand(shape, generator=rng, device=dev)
        log_y = _loglik(rng, tr, sel) + torch.log(torch.clamp(u, min=_TINY))
        angle = _TWO_PI * torch.rand(shape, generator=rng, device=dev)

        def propose(angle):
            values = pytree.tree_unflatten(_on_ellipse(theta, nu, self.mean, angle, bits), spec)
            cand, _, _, _ = Update(values).edit(rng, tr, argdiffs)
            return cand, _loglik(rng, cand, sel)

        cand, ll = propose(angle)
        accepted = ll > log_y
        lo, hi = angle - _TWO_PI, angle
        trips, syncs, done = 0, 0, False
        while trips < self.max_shrink:
            if trips % ELLIPTICAL_CHECK_EVERY == 0:
                syncs += 1
                done = bool(accepted.all())
                if done:
                    break
            # Shrink the bracket toward angle 0 (the current state) and draw
            # again (Murray et al. 2010, steps 8-10); chains that have
            # accepted keep what they hold.
            active = ~accepted
            lo = torch.where(active & (angle < 0.0), angle, lo)
            hi = torch.where(active & (angle >= 0.0), angle, hi)
            draw = lo + (hi - lo) * torch.rand(shape, generator=rng, device=dev)
            angle = torch.where(active, draw, angle)
            new_cand, new_ll = propose(angle)
            cand = where_tree(active, new_cand, cand)
            accepted = accepted | (active & (new_ll > log_y))
            trips += 1
        elliptical_stats["moves"] += 1
        elliptical_stats["trips"] += trips
        elliptical_stats["syncs"] += syncs
        elliptical_stats["capped"] += not done

        new_tr = where_tree(accepted, cand, tr)
        return (
            new_tr,
            torch.zeros(shape, device=dev),
            Diff.unknown_change(new_tr.get_retval()),
            EllipticalSlice(sel, self.mean, self.max_shrink),
        )


def elliptical_slice(
    rng: torch.Generator, trace: Trace[Any], selection: Selection, mean: Any = 0.0, max_shrink: int = 32
) -> Trace[Any]:
    """Functional form: one always-accepted elliptical slice move."""
    new_tr, _, _, _ = EllipticalSlice(selection, mean, max_shrink).edit(rng, trace, Diff.no_change(trace.get_args()))
    return new_tr

