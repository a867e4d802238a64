"""Flags and selections between pytrees: `FlagOp`, `tree_choose`,
`multi_switch` and `where_tree`; `empty_trace`.

Counterpart of part of `genjax_tpu/core/staging.py`. JAX's `lax.switch`
runs one branch into zero templates of the others; under a batch of
particles every particle may take another branch, so here a tensor index
runs every branch on every row and the results are selected leaf by leaf
(`torch.where`, no host read). A Python int index (or a 0-d CPU tensor,
which the host reads for free) runs one branch.
"""

from typing import Any, Callable, Iterable, Sequence

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.gather import batched_mask
from genjax_tpu_torch.core.mask import _and, _not, _or, select
from genjax_tpu_torch.core.typing import host_scalar


class FlagOp:
    """Boolean algebra over flags (Python bools or boolean tensors), with
    concrete bools decided at once. A flag and the scores it gates carry
    batch axes only, aligned alike, so `where` broadcasts them as they are
    (a value with event axes is selected by `core.mask.select`)."""

    and_ = staticmethod(_and)
    or_ = staticmethod(_or)
    not_ = staticmethod(_not)

    @staticmethod
    def where(f, tf, ff):
        """`tf` where the flag holds, else `ff`; a concrete flag picks one
        side with no operation. A `-inf` on the side not taken stays out
        (a select, never `f * tf`)."""
        if f is True:
            return tf
        if f is False:
            return ff
        return torch.where(f, tf, ff)


def static_index(idx: Any) -> int | None:
    """The index as a Python int where the host knows it for free (an int,
    or a 0-d integer CPU tensor); None for an index on a device or with a
    batch axis."""
    if isinstance(idx, bool):
        return int(idx)
    if isinstance(idx, int):
        return idx
    if isinstance(idx, torch.Tensor) and idx.dim() == 0 and idx.device.type == "cpu" and not idx.is_floating_point():
        return int(host_scalar(idx.to(torch.int64)))
    return None


def clamp_index(idx: Any, n: int) -> Any:
    """The branch index clamped into `[0, n)` once, where it enters: a
    Python int stays one, a tensor becomes an int64 tensor."""
    if isinstance(idx, bool) or isinstance(idx, int):
        return min(max(int(idx), 0), n - 1)
    return idx.to(torch.int64).clamp(0, n - 1)


def tree_choose(idx: Any, pytrees: Sequence[Any], idx_depth: int = 0, records: Sequence[list] | None = None) -> Any:
    """One pytree out of `pytrees` by index: `pytrees[idx]` for an int; for
    an index tensor (already clamped) a `where` chain per leaf, which
    needs every tree in one structure. `records` gives each tree's depth
    per leaf (default 0), `idx_depth` the index's; the result's leaves
    carry the deepest of them.

    >>> import torch
    >>> from genjax_tpu_torch.core.staging import tree_choose
    >>> tree_choose(torch.tensor([1, 0, 1]), [(1.0, 10.0), (2.0, 20.0)], 1)[0].tolist()
    [2.0, 1.0, 2.0]
    >>> tree_choose(1, [(1.0, 10.0), (2.0, 20.0)])
    (2.0, 20.0)
    """
    if isinstance(idx, int):
        return pytrees[idx]
    return choose_leaves(idx, pytrees, idx_depth, records)[0]


def choose_leaves(idx: torch.Tensor, pytrees: Sequence[Any], idx_depth: int, records=None) -> tuple[Any, list[int]]:
    """`tree_choose` over an index tensor, with the depth of each leaf of
    the result."""
    flat = [pytree.tree_flatten(t) for t in pytrees]
    spec = flat[0][1]
    if any(s != spec for _, s in flat[1:]):
        raise ValueError("tree_choose: the branches' results differ in structure")
    records = records or [[0] * len(flat[0][0])] * len(flat)
    out, depths = [], []
    for i in range(len(flat[0][0])):
        column = [leaves[i] for leaves, _ in flat]
        cdepths = [r[i] for r in records]
        if all(v is column[0] for v in column[1:]):
            out.append(column[0])
            depths.append(cdepths[0])
            continue
        v, d = column[-1], cdepths[-1]
        for k in range(len(column) - 2, -1, -1):
            v, d = select(idx == k, idx_depth, column[k], cdepths[k], v, d)
        out.append(v)
        depths.append(d)
    return pytree.tree_unflatten(out, spec), depths


def multi_switch(idx: Any, branches: Iterable[Callable[..., Any]], arg_tuples: Iterable[tuple]) -> list:
    """Run the branches for an index: with an int only branch `idx` (the
    others give None), with an index tensor every branch. The caller
    selects (`tree_choose`)."""
    pairs = list(zip(branches, arg_tuples))
    if isinstance(idx, int):
        return [f(*args) if i == idx else None for i, (f, args) in enumerate(pairs)]
    return [f(*args) for f, args in pairs]


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


def empty_trace(gen_fn, args: tuple):
    """A trace of `gen_fn(*args)` with every tensor leaf zero
    (`GenerativeFunction.get_zero_trace`)."""
    return gen_fn.get_zero_trace(*args)
