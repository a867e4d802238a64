"""Flags and selections between pytrees: `FlagOp`, `tree_choose`,
`multi_switch` and `where_tree`; shape-only calls (`to_shape_fn`) and
`empty_trace`.

Counterpart of `genjax_tpu/core/staging.py` but for its jaxpr staging
(`stage`, `get_shaped_aval`). JAX's `lax.switch`
runs one branch into zero templates of the others; under a batch of
particles every particle may take another branch, so here a tensor index
runs every branch on every row and the results are selected leaf by leaf
(`torch.where`, no host read). A Python int index (or a 0-d CPU tensor,
which the host reads for free) runs one branch.
"""

import functools
from typing import Any, Callable, Iterable, Sequence

import torch
import torch.utils._pytree as pytree
from torch.overrides import TorchFunctionMode

from genjax_tpu_torch.core.gather import batched_mask
from genjax_tpu_torch.core.mask import _and, _not, _or, select
from genjax_tpu_torch.core.typing import depth_of, device_of, host_scalar, mark


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


META = torch.device("meta")


class _MetaGenerator(torch.Generator):
    """The generator of a shape-only call: it says it lives on the meta
    device, so a sampler's draw `torch.rand(shape, generator=rng,
    device=rng.device)` makes a meta tensor. `_ShapeOnly` takes it out of
    every call: a meta kernel draws nothing."""

    @property
    def device(self) -> torch.device:
        return META


SHAPE_RNG = _MetaGenerator()


_NO_META_KERNEL = frozenset({torch.binomial, torch.poisson, torch._standard_gamma, torch._sample_dirichlet})


class _ShapeOnly(TorchFunctionMode):
    """The mode of a shape-only call. A meta tensor holds no value, so a
    lane loop's host read "has every lane finished?" (`bool(done.all())`,
    the masked rejection samplers') answers yes: the loop runs once, and
    its result has the shape of every other trip's."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "generator" in kwargs:
            kwargs = {k: v for k, v in kwargs.items() if k != "generator"}
        if func is torch.Tensor.__bool__ and args[0].is_meta:
            return True
        # Samplers that some PyTorch versions give no meta kernel: a draw
        # has its operand's shape and dtype (`binomial`'s, the broadcast).
        if func in _NO_META_KERNEL and args[0].is_meta:
            if func is torch.binomial:
                return torch.empty(torch.broadcast_shapes(args[0].shape, args[1].shape), dtype=args[0].dtype, device=META)
            return torch.empty_like(args[0])
        return func(*args, **kwargs)


def to_meta(x: Any) -> Any:
    """A tensor's meta twin (its shape, dtype and batch mark; no data, no
    device work), and for a generator the shape-only one; anything else
    passes through."""
    if isinstance(x, torch.Generator):
        return SHAPE_RNG
    if not isinstance(x, torch.Tensor) or (x.is_meta and type(x) is torch.Tensor):
        return x
    return mark(torch.empty(x.shape, dtype=x.dtype, device=META), depth_of(x))


def to_shape_fn(callable: Callable[..., Any], fill_fn: Callable[..., Any] | None = None) -> Callable[..., Any]:
    """`callable` as a shape-only function (JAX's `to_shape_fn`, which
    runs `jax.eval_shape`): the arguments' tensors become meta tensors of
    their shapes and dtypes, a generator among them the shape-only one,
    the call runs on them (a draw makes a meta tensor and reads nothing),
    and the output comes back as meta tensors, or filled by
    `fill_fn(shape, dtype=dtype)`.

    >>> import torch
    >>> from genjax_tpu_torch.core.staging import to_shape_fn
    >>> out = to_shape_fn(lambda x: (x.sum(-1), x > 0))(torch.zeros(3, 4))
    >>> [(tuple(t.shape), t.dtype, t.device.type) for t in out]
    [((3,), torch.float32, 'meta'), ((3, 4), torch.bool, 'meta')]
    >>> to_shape_fn(lambda x: x @ x.mT, torch.zeros)(torch.ones(2, 5))
    tensor([[0., 0.],
            [0., 0.]])
    """

    def wrapped(*args, **kwargs):
        args, kwargs = pytree.tree_map(to_meta, (args, kwargs))
        with _ShapeOnly():
            out = callable(*args, **kwargs)
        if fill_fn is None:
            return out
        return pytree.tree_map(lambda x: fill_fn(x.shape, dtype=x.dtype) if isinstance(x, torch.Tensor) else x, out)

    return wrapped


def zeros_on(args: Any) -> Callable[..., torch.Tensor]:
    """The fill of an abstract call: zeros on the device of the first
    tensor among `args` (meta, inside the site-graph analysis)."""
    return functools.partial(torch.zeros, device=device_of(*pytree.tree_leaves(args)))


def empty_trace(gen_fn, args: tuple):
    """A trace of `gen_fn(*args)` with every tensor leaf zero
    (`GenerativeFunction.get_zero_trace`)."""
    return gen_fn.get_zero_trace(*args)
