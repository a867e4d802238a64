"""Row gather over pytrees: the particle copy of resampling.

Counterpart of `genjax_tpu/core/gather.py::take_rows`. The JAX version
packs leaves per dtype because per-leaf gathers are slow on a TPU; on a
GPU one `index_select` per leaf is a plain row copy, so no packing.
"""

import torch

from genjax_tpu_torch.core.pytree import tree_map


def take_rows(tree, idx: torch.Tensor, n_rows: int | None = None):
    """`tree_map(lambda v: v[idx], tree)` over the leading axis.

    With `n_rows` given, a leaf whose leading dimension is not `n_rows`
    is shared by every row (a model argument, an observation) and passes
    through untouched. Python numbers and 0-d tensors always pass through.

    >>> import torch
    >>> from genjax_tpu_torch.core.gather import take_rows
    >>> tree = {"a": torch.arange(4.0), "X": torch.zeros(7, 3), "c": 2.0}
    >>> out = take_rows(tree, torch.tensor([1, 1, 0, 2]), n_rows=4)
    >>> out["a"].tolist(), out["X"].shape, out["c"]
    ([1.0, 1.0, 0.0, 2.0], torch.Size([7, 3]), 2.0)
    """

    def take(leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            return leaf
        if n_rows is not None and leaf.shape[0] != n_rows:
            return leaf
        return leaf.index_select(0, idx)

    return tree_map(take, tree)
