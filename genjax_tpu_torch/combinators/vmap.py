"""`Vmap` combinator: lift a generative function over a batch axis.

Counterpart of `genjax_tpu/combinators/vmap.py`. JAX `vmap`s the kernel's
methods; here the kernel runs once for every lane (and every particle):
the lane axis becomes one more batch axis behind those the `Vmap` itself
runs under (`core/typing.py`), and the kernel's sites keep one score per
lane. So a kernel body follows the rule of every model body (batch axes in
front, event axes counted from the end: `distributions/distribution.py`),
and nothing here loops over lanes.

On entry the arguments are aligned to the kernel's batch stack: a mapped
argument's axis (`in_axes`, counted within one particle's value, as under
`jax.vmap`) is moved behind its batch axes and becomes the lane axis; an
unmapped per-particle `(K, *e)` becomes `(K, 1, *e)`; an unmapped shared
argument stays as it is. The trace stores the kernel's trace under that
stack (`inner`: per-lane scores, `(K, N)`), and shows the outside the
stacked view: `chm["x"]` is `(K, N, *e)`, `chm[i, "x"]` lane `i`.
"""

from typing import Any, Generic, TypeVar

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import (
    Choice,
    ChoiceMap,
    Indexed,
    NoneSel,
    Or,
    Selection,
    Static,
    Switch,
    statically_unmatchable_at_index_level,
)
from genjax_tpu_torch.core.concepts import EditRequest, IndexRequest, NotSupportedEditRequest, Score, Weight
from genjax_tpu_torch.core.diff import Diff, rediff
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu_torch.core.mask import Mask
from genjax_tpu_torch.core.pytree import Pytree, n_leaves
from genjax_tpu_torch.core.requests import EmptyRequest, Regenerate
from genjax_tpu_torch.core.typing import batch_dims, depth_of, device_of, mark, plain
from genjax_tpu_torch.distributions.distribution import _drop

R = TypeVar("R")


def _check_indexable(selection: Selection, where: str) -> None:
    """Raise on a selection that can never address into an indexed (lane
    or step) address space: a silent no-op there is a biased
    always-accept MH move waiting to happen."""
    if not isinstance(selection, NoneSel) and statically_unmatchable_at_index_level(selection):
        raise ValueError(
            f"{where}: selection {selection} cannot match the integer-indexed address space "
            'of this combinator\'s trace. Address lanes or steps explicitly: `Selection.at[..., "x"]` '
            'for every index, `Selection.at[i, "x"]` for one.'
        )


def _axes_per_leaf(in_axes: Any, tree: Any) -> list:
    """`in_axes` (an int or None for everything, or a pytree prefix of the
    arguments: a tuple, list, dict or `Pytree` dataclass that follows their
    structure as far as it goes) spread to one axis per leaf of `tree`. A
    dataclass's fields are taken in the order of its flatten."""
    if in_axes is None or isinstance(in_axes, int):
        return [in_axes] * n_leaves(tree)
    if isinstance(in_axes, (tuple, list)):
        if not isinstance(tree, (tuple, list)) or len(tree) != len(in_axes):
            raise ValueError(f"vmap: in_axes {in_axes!r} does not match the structure of the arguments")
        return [ax for a, t in zip(in_axes, tree) for ax in _axes_per_leaf(a, t)]
    if isinstance(in_axes, dict):
        return [ax for k, t in tree.items() for ax in _axes_per_leaf(in_axes[k], t)]
    if isinstance(in_axes, Pytree):
        axes = pytree._broadcast_to_and_flatten(in_axes, pytree.tree_structure(tree))
        if axes is None:
            raise ValueError(f"vmap: in_axes {in_axes!r} does not match the structure of the arguments")
        return axes
    raise TypeError(f"vmap: in_axes holds {in_axes!r}")


def _sum_lanes(x: Any, n: int) -> Any:
    """The total over the lanes of a per-lane score or weight (the lane
    axis is the last); one that is the same in every lane counts `n`
    times."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x * n
    if x.shape[-1] != n:
        return x.squeeze(-1) * n
    return x.sum(-1)


def _leave(v: Any, depth: int, n: int, gap: int = 0) -> tuple[Any, int]:
    """A value of the kernel's, seen from outside the lane level: the
    lane axis (made real where it had length 1, or was absent) becomes its
    first axis past the batch axes (and past the `gap` step axes of a
    trace that a `Scan` holds stacked)."""
    if not isinstance(v, torch.Tensor):
        return v, 0
    if depth == 0:
        return v.unsqueeze(gap).expand(*v.shape[:gap], n, *v.shape[gap:]), 0
    axis = depth - 1 + gap
    if v.shape[axis] != n:
        shape = list(v.shape)
        shape[axis] = n
        v = v.expand(shape)
    return v, depth - 1


def _leave_tree(tree: Any, record: list, n: int) -> tuple[Any, tuple]:
    leaves, spec = pytree.tree_flatten(tree)
    out = [_leave(v, d, n) for v, d in zip(leaves, record)]
    return pytree.tree_unflatten([v for v, _ in out], spec), tuple(d for _, d in out)


def _leave_choice(c: Choice, n: int, gap: int) -> Choice:
    if not isinstance(c.v, Mask):
        return Choice(*_leave(c.v, c.batched, n, gap))
    # A value that holds in some lanes only stays masked: the lane axis
    # of its flag becomes the flag's first axis past its batch axes, as
    # it becomes the value's.
    v, depth = _leave(c.v.value, c.batched, n, gap)
    flag, flag_depth = _leave(c.v.flag, c.v.flag_depth, n, gap)
    return Choice.build(Mask(v, flag, (depth,), flag_depth))


def _leave_choices(chm: ChoiceMap, n: int, gap: int = 0) -> ChoiceMap:
    """The kernel's choices as the stacked map the outside sees. A choice
    that holds in some lanes only (the discard of a lane-wise `Update`)
    comes out as a `Mask` over the lanes, as JAX's `vmap` of the kernel's
    discard gives it."""
    return chm.map_choices(lambda c: _leave_choice(c, n, gap))


@Pytree.dataclass
class VmapTrace(Generic[R], Trace[R]):
    """`inner` is the kernel's trace under the batch stack with the lane
    axis added: its score is per lane. `args`, `retval` and `score` are
    the outside view."""

    gen_fn: "Vmap[R]"
    inner: Trace[R]
    args: tuple
    retval: Any
    score: Any
    dim_length: int = Pytree.static(default=0)
    batch: tuple = Pytree.static(default=())  # the stack this Vmap ran under
    args_batched: tuple = Pytree.static(default=())
    retval_batched: tuple = Pytree.static(default=())
    gap: int = Pytree.static(default=0)  # step axes before the lane axis, in a trace that a Scan holds stacked
    score_batched: int = Pytree.static(default=0)

    @staticmethod
    def build(gen_fn: "Vmap[R]", tr: Trace[R], args: tuple, args_batched: tuple, n: int, batch: tuple) -> "VmapTrace[R]":
        retval, retval_batched = _leave_tree(tr.get_retval(), tr.retval_record(), n)
        score = _sum_lanes(tr.get_score(), n)
        depth = score.dim() if isinstance(score, torch.Tensor) else 0
        return VmapTrace(gen_fn, tr, args, retval, score, n, batch, args_batched, retval_batched, 0, depth)

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.retval

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self) -> ChoiceMap:
        if self.dim_length == 0:
            return ChoiceMap.empty()
        return _leave_choices(self.inner.add_gap(self.gap).get_choices(), self.dim_length, self.gap)

    def add_gap(self, k: int = 1) -> "VmapTrace[R]":
        if not k:
            return self
        return VmapTrace(
            self.gen_fn, self.inner, self.args, self.retval, self.score, self.dim_length, self.batch,
            self.args_batched, self.retval_batched, self.gap + k, self.score_batched,
        )

    def get_score(self) -> Score:
        return self.score

    def get_inner_trace(self, address):
        return self.inner.get_inner_trace(address)

    def args_record(self) -> list[int]:
        return list(self.args_batched) or [0] * n_leaves(self.args)

    def retval_record(self) -> list[int]:
        return list(self.retval_batched) or [0] * n_leaves(self.retval)

    def batched_leaves(self) -> list[int]:
        # From outside, the lane axis of a kernel's leaf is an event axis.
        return (
            [0] * n_leaves(self.gen_fn)
            + [max(d - 1, 0) for d in self.inner.batched_leaves()]
            + self.args_record()
            + self.retval_record()
            + [self.score_batched]
        )

    def drop_level(self, r: int = 0) -> "VmapTrace[R]":
        batch = self.batch[: len(self.batch) - 1 - r] + self.batch[len(self.batch) - r :]
        return VmapTrace(
            self.gen_fn,
            self.inner.drop_level(r + 1),
            self.args,
            self.retval,
            self.score,
            self.dim_length,
            batch,
            tuple(_drop(d, r) for d in self.args_batched),
            tuple(_drop(d, r) for d in self.retval_batched),
            self.gap,
            _drop(self.score_batched, r),
        )


def _at_lanes(chm: ChoiceMap, n: int, device) -> ChoiceMap:
    """`chm` asked about all `n` lanes at once; an empty map costs no launch."""
    return chm if chm.static_is_empty() else chm.at_lanes(torch.arange(n, device=device))


def _has_index_entries(chm: ChoiceMap) -> bool:
    """Whether `chm` nests a value under an index (a value for some lanes,
    not the stacked value of every lane)."""
    if isinstance(chm, Indexed):
        return True
    if isinstance(chm, Static):
        return any(_has_index_entries(c) for c in chm.children.values())
    if isinstance(chm, Or):
        return _has_index_entries(chm.c1) or _has_index_entries(chm.c2)
    if isinstance(chm, Switch):
        return any(_has_index_entries(c) for c in chm.chms)
    return False


def _lane_axis(v: Any, depth: int, n: int) -> int | None:
    """The position of the lane axis in a kernel's leaf, None where the
    leaf is the same in every lane."""
    if not isinstance(v, torch.Tensor) or depth == 0:
        return None
    return None if v.shape[depth - 1] != n else depth - 1


def _take_lane(inner: Trace, idx, n: int) -> Trace:
    """Lane `idx` of the kernel's trace, as a trace of the kernel under
    the batch stack without the lane level."""
    leaves = pytree.tree_leaves(inner)
    _, spec = pytree.tree_flatten(inner.drop_level(0))
    at = torch.as_tensor(idx).reshape(1) if not isinstance(idx, int) else None
    out = []
    for v, d in zip(leaves, inner.batched_leaves()):
        axis = _lane_axis(v, d, n)
        if axis is None:
            out.append(v.squeeze(d - 1) if isinstance(v, torch.Tensor) and d else v)
        elif at is None:
            out.append(v.select(axis, idx))
        else:
            out.append(v.index_select(axis, at.to(v.device)).squeeze(axis))
    return pytree.tree_unflatten(out, spec)


def _put_lane(inner: Trace, new_slice: Trace, idx, n: int) -> Trace:
    """`inner` with lane `idx` replaced by `new_slice`. A leaf that is the
    same in every lane stays."""
    leaves, spec = pytree.tree_flatten(inner)
    at = torch.as_tensor(idx).reshape(1)
    out = []
    for v, s, d in zip(leaves, pytree.tree_leaves(new_slice), inner.batched_leaves()):
        axis = _lane_axis(v, d, n)
        out.append(v if axis is None else v.index_copy(axis, at.to(v.device), s.unsqueeze(axis).to(v.dtype)))
    return pytree.tree_unflatten(out, spec)


@Pytree.dataclass
class Vmap(Generic[R], GenerativeFunction[R]):
    """Vectorize `gen_fn` over a batch axis configured by `in_axes` (a
    `jax.vmap`-style spec over the argument tuple: an int or None for all,
    or one per argument). `axis_size` gives the number of lanes where no
    argument is mapped (`repeat`), as `jax.vmap`'s does.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.vmap(in_axes=(0, None))
    ... @gx.gen
    ... def datum(x, w):
    ...     return gx.normal(x * w, 1.0) @ "y"
    >>> obs = gx.ChoiceMap.d({(1, "y"): 0.5})           # lane 1 alone
    >>> tr, w = datum.generate(torch.Generator().manual_seed(0), obs, (torch.arange(3.0), 2.0), n=4)
    >>> tr.get_choices()["y"][:, 1].tolist(), w.shape, tr.inner.get_score().shape
    ([0.5, 0.5, 0.5, 0.5], torch.Size([4]), torch.Size([4, 3]))
    """

    gen_fn: GenerativeFunction[R]
    in_axes: Any = Pytree.static(default=0)
    axis_size: int | None = Pytree.static(default=None)

    # -- the lane level --------------------------------------------------------

    def _enter(self, args: tuple, record: list | None, marks: bool) -> tuple[tuple, tuple, tuple, int]:
        """(the kernel's arguments, the outside arguments unmarked, their
        record, the number of lanes). The record is read from the
        arguments' marks, or given. With `marks` the kernel's arguments
        carry the marks of their depths."""
        leaves, spec = pytree.tree_flatten(args)
        if record is None:
            record = [depth_of(v) for v in leaves]
        leaves = [plain(v) for v in leaves]
        axes = _axes_per_leaf(self.in_axes, args)
        n = self.axis_size
        inner = []
        for v, d, ax in zip(leaves, record, axes):
            if not isinstance(v, torch.Tensor):
                inner.append(v)
                continue
            if ax is None:
                # Unmapped: shared stays as it is, batched gets a lane axis of length 1.
                if d:
                    v = v.unsqueeze(d)
                    v = mark(v, d + 1) if marks else v
                inner.append(v)
                continue
            if ax >= v.dim() - d or ax < d - v.dim():
                raise ValueError(f"vmap: in_axes asks for axis {ax} of an argument of shape {tuple(v.shape[d:])}")
            ax = d + ax if ax >= 0 else v.dim() + ax
            v = v.movedim(ax, d) if ax != d else v
            if n is None:
                n = v.shape[d]
            elif v.shape[d] != n:
                raise ValueError(f"vmap: the mapped arguments disagree on the axis length ({n} and {v.shape[d]})")
            inner.append(mark(v, d + 1) if marks else v)
        if n is None:
            raise ValueError("vmap: no argument is mapped and no axis_size is given, so the number of lanes is unknown")
        return pytree.tree_unflatten(inner, spec), pytree.tree_unflatten(leaves, spec), tuple(record), n

    # -- GFI -------------------------------------------------------------------

    def simulate(self, rng, args: tuple, n=None) -> VmapTrace[R]:
        batch = batch_dims(n)
        inner_args, args, record, lanes = self._enter(args, None, True)
        tr = self.gen_fn.simulate(rng, inner_args, batch + (lanes,))
        return VmapTrace.build(self, tr, args, record, lanes, batch)

    def generate(self, rng, constraint: ChoiceMap, args: tuple, n=None, like=None) -> tuple[VmapTrace[R], Weight]:
        batch = batch_dims(n)
        inner_args, args, record, lanes = self._enter(args, None if like is None else like.args_record(), like is None)
        sub = _at_lanes(constraint, lanes, rng.device)
        tr, w = self.gen_fn.generate(rng, sub, inner_args, batch + (lanes,), None if like is None else like.inner)
        return VmapTrace.build(self, tr, args, record, lanes, batch), _sum_lanes(w, lanes)

    def assess(self, sample: ChoiceMap, args: tuple, n=None, marked: bool = False) -> tuple[Score, R]:
        if _has_index_entries(sample):
            raise ValueError("Vmap.assess: the sample holds a value in some lanes only; assess every lane (stacked)")
        batch = batch_dims(n)
        inner_args, args, _, lanes = self._enter(args, None, True)
        device = device_of(*pytree.tree_leaves((sample, args)))  # the lane flags go where the sample's values are
        sub = _at_lanes(sample, lanes, device)
        score, ret = self.gen_fn.assess(sub, inner_args, batch + (lanes,), True)
        leaves, spec = pytree.tree_flatten(ret)
        out = [_leave(plain(v), depth_of(v), lanes) for v in leaves]
        retval = pytree.tree_unflatten([mark(v, d) if marked else v for v, d in out], spec)
        return _sum_lanes(score, lanes), retval

    def project(self, rng, trace: VmapTrace[R], selection: Selection) -> Weight:
        _check_indexable(selection, "Vmap.project")
        lanes = trace.dim_length
        w = trace.inner.project(rng, selection.at_lanes(torch.arange(lanes, device=rng.device)))
        return _sum_lanes(w, lanes)

    # -- edit ------------------------------------------------------------------

    def _edited(self, rng, trace: VmapTrace[R], request: EditRequest, argdiffs, n):
        """One edit of the kernel's trace for all lanes at once."""
        batch = trace.batch if n is None else batch_dims(n)
        inner_args, args, record, lanes = self._enter(Diff.tree_primal(argdiffs), trace.args_record(), False)
        if lanes != trace.dim_length:
            raise ValueError("Vmap.edit: the mapped arguments' axis length changed")
        # The kernel's arguments keep the caller's tangents leaf for leaf
        # (they are the same for every lane), so an edit under NoChange
        # arguments recurses the kernel's plan instead of re-scoring every
        # site that reads them.
        inner_argdiffs = rediff(inner_args, argdiffs)
        new_inner, w, _, bwd = self.gen_fn.edit(rng, trace.inner, request, inner_argdiffs, batch + (lanes,))
        new = VmapTrace.build(self, new_inner, args, record, lanes, batch)
        return new, _sum_lanes(w, lanes), Diff.unknown_change(new.retval), bwd

    def edit_update(self, rng, trace: VmapTrace[R], constraint: ChoiceMap, argdiffs, n=None):
        lanes = trace.dim_length
        new, w, retdiff, bwd = self._edited(rng, trace, Update(_at_lanes(constraint, lanes, rng.device)), argdiffs, n)
        return new, w, retdiff, Update(_leave_choices(bwd.constraint, lanes))

    def edit_regenerate(self, rng, trace: VmapTrace[R], selection: Selection, argdiffs, n=None):
        _check_indexable(selection, "Vmap.edit_regenerate")
        # A `VmapTrace`'s addresses nest under the lane index, so `S[i, "x"]`
        # targets lane i only and `S[..., "x"]` every lane.
        sub = selection.at_lanes(torch.arange(trace.dim_length, device=rng.device))
        new, w, retdiff, _ = self._edited(rng, trace, Regenerate(sub), argdiffs, n)
        return new, w, retdiff, Regenerate(selection)

    def edit_index(self, rng, trace: VmapTrace[R], idx, request: EditRequest, argdiffs):
        """Edit one lane: take the lane out of every leaf of the kernel's
        trace that carries the lane axis, edit that trace, and copy the
        result back into a copy of the leaves."""
        if not Diff.static_check_no_change(argdiffs):
            raise ValueError("Vmap.edit_index edits a lane under unchanged arguments")
        lanes = trace.dim_length
        lane = _take_lane(trace.inner, idx, lanes)
        new_lane, w, _, bwd = request.edit(rng, lane, Diff.no_change(lane.get_args()))
        new_inner = _put_lane(trace.inner, new_lane, idx, lanes)
        new = VmapTrace.build(self, new_inner, trace.args, trace.args_batched, lanes, trace.batch)
        return new, w, Diff.unknown_change(new.retval), IndexRequest(idx, bwd)

    def edit(self, rng, trace: VmapTrace[R], edit_request: EditRequest, argdiffs, n=None):
        match edit_request:
            case Update(constraint):
                return self.edit_update(rng, trace, constraint, argdiffs, n)
            case Regenerate(selection):
                return self.edit_regenerate(rng, trace, selection, argdiffs, n)
            case IndexRequest(idx, request):
                return self.edit_index(rng, trace, idx, request, argdiffs)
            case EmptyRequest():
                return edit_request.edit(rng, trace, argdiffs)
            case _:
                raise NotSupportedEditRequest(edit_request)


def vmap(*, in_axes: Any = 0, axis_size: int | None = None):
    """Decorator: `genjax_tpu_torch.vmap(in_axes=...)(gen_fn)`."""

    def decorator(gen_fn: GenerativeFunction[R]) -> Vmap[R]:
        return Vmap(gen_fn, in_axes, axis_size)

    return decorator
