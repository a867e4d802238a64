"""Row gather over pytrees: the particle copy of resampling, and the row
of one particle.

Counterpart of `genjax_tpu/core/gather.py::take_rows`. The JAX version
packs leaves per dtype because per-leaf gathers are slow on a TPU; on a
GPU one `index_select` per leaf is a plain row copy, so no packing.

Which leaves carry the particle axis is read from the tree's own record
(`batched_leaves`, which traces and choice maps keep), never from a
leaf's size.
"""

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.gfi import Trace


def batched_mask(tree) -> tuple[list, pytree.TreeSpec, list[bool]]:
    """(leaves, treespec, per-leaf record) of a trace or a choice map."""
    if not hasattr(tree, "batched_leaves"):
        raise TypeError(
            f"{type(tree).__name__} keeps no particle-axis record; pass a trace or a choice map"
        )
    leaves, spec = pytree.tree_flatten(tree)
    return leaves, spec, tree.batched_leaves()


def take_rows(tree, idx: torch.Tensor):
    """`tree_map(lambda v: v[idx], tree)` over the leaves that carry the
    particle axis; shared leaves pass through untouched.

    >>> import torch
    >>> from genjax_tpu_torch.core.choice_map import ChoiceMap
    >>> from genjax_tpu_torch.core.gather import take_rows
    >>> from genjax_tpu_torch.core.typing import per_particle
    >>> X = torch.zeros(4, 3)
    >>> chm = ChoiceMap.kw(a=per_particle(torch.arange(4.0)), X=X)
    >>> out = take_rows(chm, torch.tensor([1, 1, 0, 2]))
    >>> out["a"].tolist(), out["X"] is X
    ([1.0, 1.0, 0.0, 2.0], True)
    """
    leaves, spec, bits = batched_mask(tree)
    out = [v.index_select(0, idx) if b else v for v, b in zip(leaves, bits)]
    return pytree.tree_unflatten(out, spec)


def take_row(tree, idx: torch.Tensor):
    """One particle's row of every leaf that carries the particle axis
    (`idx` a 0-d index tensor, which stays on the device). A trace comes
    back as the trace of one particle (`Trace.as_single`)."""
    leaves, spec, bits = batched_mask(tree)
    row = idx.reshape(1)
    out = pytree.tree_unflatten(
        [v.index_select(0, row).squeeze(0) if b else v for v, b in zip(leaves, bits)], spec
    )
    return out.as_single() if isinstance(out, Trace) else out
