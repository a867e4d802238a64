"""Per-particle selection between two traces.

Counterpart of `genjax_tpu/core/staging.py::where_tree`.
"""

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.gather import batched_mask


def where_tree(flag: torch.Tensor, on_true, on_false):
    """Leaf-wise `torch.where(flag, a, b)` over two same-structure traces
    or choice maps, with `flag` of shape `(n,)` (one per particle) or `()`.

    A leaf that is the same object on both sides (a shared argument, an
    observation, a value the edit left alone) passes through with no
    select and no copy. A per-particle leaf (the record of `on_false`, as
    in `core.gather.take_rows`) is selected row by row. A shared leaf is
    the same for every particle, so with a per-particle flag the two
    sides hold the same value and `on_true`'s is kept.

    >>> import torch
    >>> from genjax_tpu_torch.core.choice_map import ChoiceMap
    >>> from genjax_tpu_torch.core.staging import where_tree
    >>> from genjax_tpu_torch.core.typing import per_particle
    >>> shared = torch.arange(3.0)
    >>> new = ChoiceMap.kw(w=per_particle(torch.ones(2, 3)), X=shared)
    >>> old = ChoiceMap.kw(w=per_particle(torch.zeros(2, 3)), X=shared)
    >>> out = where_tree(torch.tensor([True, False]), new, old)
    >>> out["w"].tolist(), out["X"] is shared
    ([[1.0, 1.0, 1.0], [0.0, 0.0, 0.0]], True)
    """
    a_leaves = pytree.tree_leaves(on_true)
    b_leaves, spec, bits = batched_mask(on_false)
    if len(a_leaves) != len(b_leaves):
        raise ValueError("where_tree: the two trees differ in structure")
    per_particle = flag.dim() > 0

    def select(a, b, batched_leaf):
        if a is b:
            return a
        if not isinstance(a, torch.Tensor):
            return a
        if batched_leaf or not per_particle:
            f = flag.reshape(flag.shape + (1,) * (a.dim() - flag.dim())) if per_particle else flag
            return torch.where(f, a, b)
        return a

    return pytree.tree_unflatten([select(a, b, t) for a, b, t in zip(a_leaves, b_leaves, bits)], spec)
