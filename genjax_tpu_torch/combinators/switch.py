"""`Switch` combinator: a branch chosen at run time among N generative
functions.

Counterpart of `genjax_tpu/combinators/switch.py`. JAX runs the chosen
branch under `lax.switch` into zero templates of the others and selects
with `tree_choose`. Under a batch every particle may take another branch,
so an index tensor runs every branch on every row and selects leaf by
leaf (`core.staging.tree_choose`): the trace keeps every branch's subtrace
for every row, so a trace has one structure whatever its index and an MH
step can select between two of them (`where_tree`). A Python int index, or
a 0-d CPU tensor that the host reads for free, runs the one branch; the
others keep a zeroed template of their trace, for the same structure.

The index is clamped into `[0, N)` once, where it enters, and that index
serves both the run and the select: JAX's docstring promises the clamp,
but its `multi_switch` clamps (`lax.switch`) while its `tree_choose`
wraps (`jnp.choose(mode="wrap")`), so an index out of range runs one
branch and reports another's zero template (ROADMAP, R7).
"""

from typing import Any, Generic, TypeVar

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.concepts import NotSupportedEditRequest, Score, Weight
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu_torch.core.mask import select
from genjax_tpu_torch.core.pytree import Pytree, n_leaves
from genjax_tpu_torch.core.requests import Regenerate, UnsupportedBackwardRequest
from genjax_tpu_torch.core.staging import choose_leaves, clamp_index, multi_switch, static_index, tree_choose, where_tree
from genjax_tpu_torch.core.typing import batch_dims, depth_of, plain
from genjax_tpu_torch.distributions.distribution import _drop
from genjax_tpu_torch.lang.static import _recorded, marked_like

R = TypeVar("R")


def _rank(x: Any) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else 0


def _zeroed(tree: Any) -> Any:
    """A template of `tree`: its structure, every tensor zero."""
    return pytree.tree_map(lambda v: torch.zeros_like(v) if isinstance(v, torch.Tensor) else v, tree)


def _scratch(rng: torch.Generator) -> torch.Generator:
    """A generator for the runs that only give a template's structure, so
    that they take no draws from the caller's stream."""
    return torch.Generator(device=rng.device).manual_seed(0)


def _choose_scores(idx: Any, idx_depth: int, scores: list) -> Any:
    """The score (or weight) of the branch that `idx` names; a score
    carries batch axes only, so its depth is its rank."""
    return tree_choose(idx, scores, idx_depth, [[_rank(s)] for s in scores])


def _key(idx: Any) -> Any:
    """The index as `multi_switch` takes it: a Python int where the host
    knows it for free, else the (clamped) index tensor."""
    known = static_index(idx)
    return idx if known is None else known


@Pytree.dataclass
class SwitchTrace(Generic[R], Trace[R]):
    """`args[0]` is the clamped index; `subtraces` holds one trace per
    branch."""

    gen_fn: "Switch[R]"
    args: tuple
    subtraces: list
    retval: R
    score: Any
    args_batched: tuple = Pytree.static(default=())
    retval_batched: tuple = Pytree.static(default=())
    score_batched: int = Pytree.static(default=0)
    batch: tuple = Pytree.static(default=())  # the stack the switch ran under

    def get_idx(self) -> Any:
        return self.args[0]

    def idx_depth(self) -> int:
        return self.args_record()[0]

    def get_args(self) -> tuple:
        return self.args

    def get_choices(self) -> ChoiceMap:
        return ChoiceMap.switch(_key(self.get_idx()), [tr.get_choices() for tr in self.subtraces], self.idx_depth())

    def get_gen_fn(self):
        return self.gen_fn

    def get_retval(self) -> R:
        return self.retval

    def get_score(self) -> Score:
        return self.score

    def get_inner_trace(self, address):
        """The subtrace at `address` of the branch the index names. A 0-d
        index tensor on the CPU is read directly; one on a device costs one
        read of that device (a synchronisation), which is no matter off the
        hot path. An index with a batch axis names a branch per row, so no
        one subtrace: read such a trace through `get_choices()`, whose
        `Switch` node selects per row."""
        idx = self.get_idx()
        known = static_index(idx)
        if known is None and isinstance(idx, torch.Tensor) and idx.dim() == 0:
            known = int(idx)
        if known is None:
            raise NotImplementedError(
                "a Switch trace whose index has a batch axis names no one subtrace; read its choices through "
                "get_choices(), whose Switch node selects each row's branch"
            )
        return self.subtraces[known].get_inner_trace(address)

    def args_record(self) -> list[int]:
        return list(self.args_batched) or [0] * n_leaves(self.args)

    def retval_record(self) -> list[int]:
        return list(self.retval_batched) or [0] * n_leaves(self.retval)

    def batched_leaves(self) -> list[int]:
        bits = [0] * n_leaves(self.gen_fn) + self.args_record()
        for tr in self.subtraces:
            bits += tr.batched_leaves()
        return bits + self.retval_record() + [self.score_batched]

    def drop_level(self, r: int = 0) -> "SwitchTrace[R]":
        batch = self.batch[: len(self.batch) - 1 - r] + self.batch[len(self.batch) - r :] if self.batch else ()
        return SwitchTrace(
            self.gen_fn, self.args, [tr.drop_level(r) for tr in self.subtraces], self.retval, self.score,
            tuple(_drop(d, r) for d in self.args_batched), tuple(_drop(d, r) for d in self.retval_batched),
            _drop(self.score_batched, r), batch,
        )

    def add_gap(self, k: int = 1) -> "SwitchTrace[R]":
        subtraces = [tr.add_gap(k) for tr in self.subtraces]
        if all(new is old for new, old in zip(subtraces, self.subtraces)):
            return self
        return SwitchTrace(
            self.gen_fn, self.args, subtraces, self.retval, self.score, self.args_batched, self.retval_batched,
            self.score_batched, self.batch,
        )


@Pytree.dataclass
class Switch(Generic[R], GenerativeFunction[R]):
    """Takes `n` branches; the result takes `(idx, args_0, ..., args_{n-1})`
    and runs branch `idx` (clamped into range) with its argument tuple.
    Branches may trace different addresses. An index tensor with the
    particle axis (a per-particle draw) runs every branch for every
    particle and keeps, per particle, the one it names.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.gen
    ... def lo():
    ...     return gx.normal(-10.0, 0.1) @ "v"
    >>> @gx.gen
    ... def hi():
    ...     return gx.normal(10.0, 0.1) @ "v"
    >>> sw = lo.switch(hi)
    >>> bool(sw.simulate(torch.Generator().manual_seed(0), (1, (), ())).get_retval() > 0)
    True
    >>> idx = gx.per_particle(torch.tensor([0, 1, 1, 0]))
    >>> (sw.simulate(torch.Generator().manual_seed(0), (idx, (), ()), n=4).get_retval() > 0).tolist()
    [False, True, True, False]
    """

    branches: tuple

    def _check_args(self, branch_args) -> None:
        if len(branch_args) != len(self.branches):
            raise ValueError(f"Switch: {len(self.branches)} branches, {len(branch_args)} argument tuples")

    def _enter(self, args: tuple, record: tuple | None = None):
        """(clamped index, its depth, the branches' argument tuples, the
        arguments to store unmarked, their record)."""
        self._check_args(args[1:])
        stored, rec = _recorded(args)
        if record is not None:
            rec = tuple(record)
        idx = clamp_index(stored[0], len(self.branches))
        return idx, rec[0], args[1:], (idx, *stored[1:]), rec

    def _build(self, args, record, subtraces, idx, idx_depth, batch) -> SwitchTrace[R]:
        known = static_index(idx)
        if known is not None:
            tr = subtraces[known]
            retval, retval_record, score = tr.get_retval(), tr.retval_record(), tr.get_score()
        else:
            retval, retval_record = choose_leaves(
                idx, [tr.get_retval() for tr in subtraces], idx_depth, [tr.retval_record() for tr in subtraces]
            )
            score = _choose_scores(idx, idx_depth, [tr.get_score() for tr in subtraces])
        return SwitchTrace(
            self, args, list(subtraces), retval, score, tuple(record), tuple(retval_record), _rank(score), batch
        )

    # -- GFI -------------------------------------------------------------------

    def simulate(self, rng, args: tuple, n=None) -> SwitchTrace[R]:
        idx, depth, branch_args, stored, record = self._enter(args)
        runs = multi_switch(_key(idx), [f.simulate for f in self.branches], [(rng, a, n) for a in branch_args])
        subtraces = [
            _zeroed(f.simulate(_scratch(rng), a, n)) if tr is None else tr
            for tr, f, a in zip(runs, self.branches, branch_args)
        ]
        return self._build(stored, record, subtraces, idx, depth, batch_dims(n))

    def generate(self, rng, constraint: ChoiceMap, args: tuple, n=None, like=None) -> tuple[SwitchTrace[R], Weight]:
        idx, depth, branch_args, stored, record = self._enter(args, None if like is None else like.args_record())
        likes = [None] * len(self.branches) if like is None else like.subtraces
        key = _key(idx)
        pairs = multi_switch(
            key, [f.generate for f in self.branches], [(rng, constraint, a, n, lk) for a, lk in zip(branch_args, likes)]
        )
        subtraces = [
            _zeroed(f.generate(_scratch(rng), constraint, a, n, lk)[0]) if pair is None else pair[0]
            for pair, f, a, lk in zip(pairs, self.branches, branch_args, likes)
        ]
        trace = self._build(stored, record, subtraces, idx, depth, batch_dims(n))
        if isinstance(key, int):
            return trace, pairs[key][1]
        return trace, _choose_scores(idx, depth, [w for _, w in pairs])

    def assess(self, sample: ChoiceMap, args: tuple, n=None, marked: bool = False) -> tuple[Score, R]:
        """Every branch scores the sample where the index is a tensor (the
        sample then holds each branch's addresses, as a `Switch` trace's
        choices do)."""
        self._check_args(args[1:])
        depth = depth_of(args[0])
        idx = clamp_index(plain(args[0]), len(self.branches))
        key = _key(idx)
        if isinstance(key, int):
            return self.branches[key].assess(sample, args[1 + key], n, marked)
        # The branches' return values come back marked, so that the select
        # knows each leaf's depth.
        results = multi_switch(key, [f.assess for f in self.branches], [(sample, a, n, True) for a in args[1:]])
        score = _choose_scores(idx, depth, [s for s, _ in results])
        flat = [pytree.tree_flatten(r) for _, r in results]
        records = [[depth_of(v) for v in leaves] for leaves, _ in flat]
        plain_rets = [pytree.tree_unflatten([plain(v) for v in leaves], spec) for leaves, spec in flat]
        retval, depths = choose_leaves(idx, plain_rets, depth, records)
        if marked:
            retval = marked_like(retval, depths)
        return score, retval

    def project(self, rng, trace: SwitchTrace[R], selection: Selection) -> Weight:
        key = _key(trace.get_idx())
        weights = multi_switch(key, [tr.project for tr in trace.subtraces], [(rng, selection)] * len(trace.subtraces))
        return weights[key] if isinstance(key, int) else _choose_scores(key, trace.idx_depth(), weights)

    # -- edit ------------------------------------------------------------------

    def _fresh_edit(self, rng, f, args, record, request, batch, n):
        """The fresh path of a branch that the index moved to: simulate it
        (the arguments marked as the trace records them), then edit it."""
        n_fresh = None if not batch else batch[0] if len(batch) == 1 else batch
        fresh = f.simulate(rng, marked_like(args, record), n_fresh)
        return f.edit(rng, fresh, request, Diff.no_change(args), n)

    def _bwd_same(self, idx, depth: int, bwds: list):
        if all(isinstance(b, Update) for b in bwds):
            return Update(ChoiceMap.switch(idx, [b.constraint for b in bwds], depth))
        if all(type(b) is type(bwds[0]) and not pytree.tree_leaves(b) for b in bwds) and all(
            pytree.tree_structure(b) == pytree.tree_structure(bwds[0]) for b in bwds
        ):
            return bwds[0]
        if all(pytree.tree_structure(b) == pytree.tree_structure(bwds[0]) for b in bwds):
            # One layout (the branches' `StaticRequest`s of a `Regenerate`):
            # each leaf selected by the index, as JAX's `tree_choose` does.
            return tree_choose(idx, bwds, depth, [_request_depths(b) for b in bwds])
        return UnsupportedBackwardRequest(
            "Switch branches produced structurally different backward requests; reverse this move by "
            "re-simulating or constraining the old choices explicitly."
        )

    def edit(self, rng, trace: SwitchTrace[R], edit_request, argdiffs, n=None):
        if not isinstance(edit_request, (Update, Regenerate)):
            raise NotSupportedEditRequest(edit_request)
        idx_diff, branch_argdiffs = argdiffs[0], argdiffs[1:]
        self._check_args(branch_argdiffs)
        primals = Diff.tree_primal(argdiffs)
        record = trace.args_record()
        depth = record[0]
        new_idx = clamp_index(plain(primals[0]), len(self.branches))
        old_idx = trace.get_idx()
        stored = (new_idx, *primals[1:])
        branch_records = self._branch_records(primals[1:], record[1:])
        batch = trace.batch
        new_known, old_known = static_index(new_idx), static_index(old_idx)

        if new_known is not None and old_known is not None:
            return self._edit_static(rng, trace, edit_request, branch_argdiffs, stored, record, new_known,
                                     old_known, branch_records, n)

        # Every branch's same-branch edit, whatever the index (the rows that
        # kept their branch keep its edited subtrace).
        same = [
            f.edit(rng, tr, edit_request, ad, n)
            for f, tr, ad in zip(self.branches, trace.subtraces, branch_argdiffs)
        ]
        bwd_same = self._bwd_same(new_idx, depth, [b for *_, b in same])
        if Diff.static_check_no_change(idx_diff):
            # The index is known unchanged: the same-branch edit alone.
            new = self._build(stored, record, [tr for tr, *_ in same], new_idx, depth, batch)
            weight = _choose_scores(new_idx, depth, [w for _, w, _, _ in same])
            return new, weight, Diff.unknown_change(new.retval), bwd_same

        # The index may have changed: run the same-branch edit (right where
        # it did not) and the fresh path (right where it did), and select
        # per row. Where it moved, the weight is the change of the score;
        # the fresh edit's own weight is not added.
        moved = torch.as_tensor(new_idx != old_idx)
        moved_depth = depth if moved.dim() else 0
        fresh = [
            self._fresh_edit(rng, f, a, rec, edit_request, batch, n)
            for f, a, rec in zip(self.branches, primals[1:], branch_records)
        ]
        subtraces = [where_tree(moved, f[0], s[0]) for s, f in zip(same, fresh)]
        new = self._build(stored, record, subtraces, new_idx, depth, batch)
        w_same = _choose_scores(new_idx, depth, [w for _, w, _, _ in same])
        weight, _ = select(moved, moved_depth, new.score - trace.score, _rank(new.score), w_same, _rank(w_same))
        if isinstance(bwd_same, Update):
            back = ChoiceMap.switch(moved.to(torch.int64), [bwd_same.constraint, trace.get_choices()], moved_depth)
        else:
            back = trace.get_choices()  # coarser than the discard, and a valid reverse either way
        return new, weight, Diff.unknown_change(new.retval), Update(back)

    def _branch_records(self, branch_args: tuple, record: tuple) -> list:
        out, at = [], 0
        for a in branch_args:
            k = n_leaves(a)
            out.append(list(record[at : at + k]))
            at += k
        return out

    def _edit_static(self, rng, trace, request, branch_argdiffs, stored, record, new, old, branch_records, n):
        """Both indices known on the host: edit the one branch, in place
        when it stayed, by the fresh path when it moved."""
        f = self.branches[new]
        subtraces = list(trace.subtraces)
        if new == old:
            tr, w, _, bwd = f.edit(rng, trace.subtraces[new], request, branch_argdiffs[new], n)
            subtraces[new] = tr
            trace_new = self._build(stored, record, subtraces, new, 0, trace.batch)
            return trace_new, w, Diff.unknown_change(trace_new.retval), bwd
        args = Diff.tree_primal(branch_argdiffs[new])
        tr, _, _, _ = self._fresh_edit(rng, f, args, branch_records[new], request, trace.batch, n)
        subtraces[new] = tr
        trace_new = self._build(stored, record, subtraces, new, 0, trace.batch)
        weight = trace_new.score - trace.score
        return trace_new, weight, Diff.unknown_change(trace_new.retval), Update(trace.get_choices())


def _request_depths(request) -> list[int]:
    """The depth of each leaf of an edit request, in `tree_leaves` order:
    a choice map's from its record, any other leaf's from its mark."""
    out: list[int] = []
    for node in pytree.tree_leaves(request, is_leaf=lambda x: isinstance(x, ChoiceMap)):
        out += node.batched_leaves() if isinstance(node, ChoiceMap) else [depth_of(node)]
    return out


def switch(*gen_fns: GenerativeFunction[R]) -> Switch[R]:
    """A `Switch` over the given branches."""
    return Switch(tuple(gen_fns))


__all__ = ["Switch", "SwitchTrace", "switch"]
