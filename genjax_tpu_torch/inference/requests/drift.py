"""`GaussianDrift`: a symmetric Gaussian random-walk proposal as an edit
request.

Counterpart of `genjax_tpu/inference/requests/drift.py`. The proposal
perturbs the selected continuous addresses with elementwise Gaussian
noise and lets `Update` reweight the joint; as it is symmetric, the
`Update` weight (the change of the joint score) is the MH log acceptance
ratio, so the request composes with `inference.mcmc.mh` and with
`TemperedSMC`'s rejuvenation. Over a batch of particles the noise is one
draw per leaf for all of them, and every value keeps its record.
"""

from typing import Any, TypeVar

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import Choice, ChoiceMap, Selection
from genjax_tpu_torch.core.concepts import Argdiffs, EditRequest, Retdiff, Weight
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import Trace, Update
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import is_per_particle, plain

R = TypeVar("R")

__all__ = ["GaussianDrift"]


def _scale_leaves(scale: Any, like: ChoiceMap) -> list:
    """A scale spec (a number, a 0-d tensor, a `per_particle` tensor, or a choice map with one
    standard deviation per address of `like`) as one standard deviation
    per leaf of `like`, in its leaf order. The two maps are lined up by
    address, whatever the record of their values."""
    if isinstance(scale, (int, float)) or (isinstance(scale, torch.Tensor) and scale.dim() == 0):
        return [scale] * len(pytree.tree_leaves(like))
    if is_per_particle(scale):
        # One standard deviation per particle (a ladder of temperatures in
        # `parallel_tempering`), shaped to broadcast against each leaf.
        s = plain(scale)
        return [s.reshape(s.shape + (1,) * (v.dim() - 1)) for v in pytree.tree_leaves(like)]
    unrecorded = like.map_choices(lambda c: Choice(c.v, 0))
    return pytree.tree_leaves(pytree.tree_map(lambda _, s: s, unrecorded, scale))


@Pytree.dataclass
class GaussianDrift(EditRequest):
    """Propose `v' = v + scale * xi`, `xi ~ N(0, I)`, at every selected
    address; the weight is the exact MH log acceptance ratio.

    `scale` is a number, a choice map with one standard deviation per
    selected address, or a `per_particle` tensor with one per particle. The selected addresses must hold
    continuous values: a discrete site would be proposed off its support
    and scored `-inf` (always rejected), sound but useless.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.requests import GaussianDrift
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "y"
    >>> rng = torch.Generator().manual_seed(0)
    >>> tr, _ = model.importance(rng, gx.ChoiceMap.kw(y=1.0), (), n=8)
    >>> new, accepted = gx.mh(rng, tr, GaussianDrift(gx.Selection.at["mu"], 0.5))
    >>> accepted.shape
    torch.Size([8])
    """

    selection: Selection
    scale: Any = 0.25

    def edit(self, rng: torch.Generator, tr: Trace[Any], argdiffs: Argdiffs) -> tuple[Trace[Any], Weight, Retdiff, EditRequest]:
        if not Diff.static_check_no_change(argdiffs):
            raise ValueError("GaussianDrift moves the choices under unchanged arguments")
        values = tr.get_choices().filter(self.selection)
        leaves, spec = pytree.tree_flatten(values)
        # The same structure keeps the choice map's record of which values
        # carry the particle axis.
        proposed = pytree.tree_unflatten(
            [
                v + s * torch.randn(v.shape, generator=rng, device=v.device, dtype=v.dtype)
                for v, s in zip(leaves, _scale_leaves(self.scale, values))
            ],
            spec,
        )
        new_tr, w, retdiff, _ = Update(proposed).edit(rng, tr, argdiffs)
        return new_tr, w, retdiff, GaussianDrift(self.selection, self.scale)
