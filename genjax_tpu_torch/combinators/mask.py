"""`MaskCombinator`: existence decided at run time.

Counterpart of `genjax_tpu/combinators/mask.py`, with the four-case
(old flag x new flag) weight lattice of `edit`. The flag gates the score
through a select, never a product with the flag: a masked-off subtree may
hold a `-inf` score (an out-of-support value) and `0 * -inf` is NaN where
the masked score must be 0. A flag with the particle axis masks particle
by particle; the wrapped function runs for every particle either way.
"""

from typing import Any, Generic, Sequence, TypeVar

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.concepts import NotSupportedEditRequest, Score, Weight
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu_torch.core.mask import Mask
from genjax_tpu_torch.core.pytree import Pytree, n_leaves
from genjax_tpu_torch.core.requests import Regenerate
from genjax_tpu_torch.core.staging import FlagOp
from genjax_tpu_torch.core.typing import depth_of, mark, plain
from genjax_tpu_torch.distributions.distribution import _drop
from genjax_tpu_torch.lang.static import _recorded

R = TypeVar("R")


def _rank(x: Any) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else 0


def _gate(check: Any, score: torch.Tensor) -> torch.Tensor:
    """`score` where `check` holds, else 0."""
    return FlagOp.where(check, score, torch.zeros_like(score) if check is False else 0.0)


@Pytree.dataclass
class MaskTrace(Generic[R], Trace[Any]):
    """`args[0]` is the flag; `inner` the wrapped function's trace. The
    choices are the inner ones masked by the flag, the return value a
    `Mask` of the inner one."""

    mask_combinator: "MaskCombinator[R]"
    inner: Trace[R]
    args: tuple
    score: Score
    args_batched: tuple = Pytree.static(default=())
    score_batched: int = Pytree.static(default=0)

    @staticmethod
    def build(gen_fn, inner: Trace[R], check, args: tuple, args_batched: Sequence[int]) -> "MaskTrace[R]":
        score = _gate(check, inner.get_score())
        return MaskTrace(gen_fn, inner, args, score, tuple(args_batched), _rank(score))

    @property
    def check(self) -> Any:
        return self.args[0]

    def check_depth(self) -> int:
        return self.args_record()[0]

    def get_args(self) -> tuple:
        return self.args

    def get_gen_fn(self):
        return self.mask_combinator

    def get_choices(self) -> ChoiceMap:
        return self.inner.get_choices().mask(self.check, self.check_depth())

    def get_retval(self) -> Mask:
        return Mask(self.inner.get_retval(), self.check, tuple(self.inner.retval_record()), self.check_depth())

    def get_score(self) -> Score:
        return self.score

    def get_inner_trace(self, address):
        return self.inner.get_inner_trace(address)

    def args_record(self) -> list[int]:
        return list(self.args_batched) or [0] * n_leaves(self.args)

    def retval_record(self) -> list[int]:
        return self.inner.retval_record() + [self.check_depth()]

    def batched_leaves(self) -> list[int]:
        return [0] * n_leaves(self.mask_combinator) + self.inner.batched_leaves() + self.args_record() + [self.score_batched]

    def drop_level(self, r: int = 0) -> "MaskTrace[R]":
        return MaskTrace(
            self.mask_combinator, self.inner.drop_level(r), self.args, self.score,
            tuple(_drop(d, r) for d in self.args_batched), _drop(self.score_batched, r),
        )

    def add_gap(self, k: int = 1) -> "MaskTrace[R]":
        inner = self.inner.add_gap(k)
        if inner is self.inner:
            return self
        return MaskTrace(self.mask_combinator, inner, self.args, self.score, self.args_batched, self.score_batched)


@Pytree.dataclass
class MaskCombinator(Generic[R], GenerativeFunction[Any]):
    """Adds a boolean first argument that gates the wrapped function's
    score; the return value is a `Mask`.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.gen
    ... def m():
    ...     return gx.normal(0.0, 1.0) @ "x"
    >>> tr = m.mask().simulate(torch.Generator().manual_seed(0), (torch.tensor(False),))
    >>> float(tr.get_score()), bool(tr.get_retval().flag)
    (0.0, False)
    """

    gen_fn: GenerativeFunction[R]

    def _split(self, args: tuple, record=None):
        stored, rec = _recorded(args)
        if record is not None:
            rec = tuple(record)
        return stored, rec, args[1:]

    def simulate(self, rng, args: tuple, n=None) -> MaskTrace[R]:
        stored, rec, inner_args = self._split(args)
        tr = self.gen_fn.simulate(rng, inner_args, n)
        return MaskTrace.build(self, tr, stored[0], stored, rec)

    def generate(self, rng, constraint: ChoiceMap, args: tuple, n=None, like=None) -> tuple[MaskTrace[R], Weight]:
        stored, rec, inner_args = self._split(args, None if like is None else like.args_record())
        tr, w = self.gen_fn.generate(rng, constraint, inner_args, n, None if like is None else like.inner)
        return MaskTrace.build(self, tr, stored[0], stored, rec), _gate(stored[0], w)

    def assess(self, sample: ChoiceMap, args: tuple, n=None, marked: bool = False) -> tuple[Score, Any]:
        check, depth = plain(args[0]), depth_of(args[0])
        score, retval = self.gen_fn.assess(sample, args[1:], n, marked)
        if marked:
            # The caller's body sees the value and the flag with their marks.
            record = tuple(depth_of(v) for v in pytree.tree_leaves(retval))
            return _gate(check, score), Mask(retval, mark(check, depth), record, depth)
        return _gate(check, score), Mask(retval, check, None, depth)

    def project(self, rng, trace: MaskTrace[R], selection: Selection) -> Weight:
        return _gate(trace.check, trace.inner.project(rng, selection))

    def edit(self, rng, trace: MaskTrace[R], edit_request, argdiffs, n=None):
        if not isinstance(edit_request, (Update, Regenerate)):
            raise NotSupportedEditRequest(edit_request)
        primals = Diff.tree_primal(argdiffs)
        record = trace.args_record()
        depth = record[0]
        post, pre = plain(primals[0]), trace.check
        original = trace.inner
        new_inner, weight, retdiff, bwd = self.gen_fn.edit(rng, original, edit_request, argdiffs[1:], n)

        # The lattice over (old flag, new flag), as a select chain: the four
        # cases are exclusive, and a select stays NaN-free where a leg is
        # +-inf.
        #   T->T: the inner weight; T->F: minus the old score;
        #   F->T: the new score;    F->F: zero.
        t_to_t = FlagOp.and_(pre, post)
        t_to_f = FlagOp.and_(pre, FlagOp.not_(post))
        f_to_t = FlagOp.and_(FlagOp.not_(pre), post)
        gained = _gate(post, new_inner.get_score())
        lost = -original.get_score()
        w = FlagOp.where(t_to_t, weight, FlagOp.where(t_to_f, lost, FlagOp.where(f_to_t, gained, torch.zeros_like(lost))))

        if isinstance(bwd, Update):
            bwd = Update(bwd.constraint.mask(post, depth))
        new = MaskTrace.build(self, new_inner, post, (post, *primals[1:]), record)
        return new, w, Diff.unknown_change(new.get_retval()), bwd


def mask(f: GenerativeFunction[R]) -> MaskCombinator[R]:
    """Wrap `f` with a boolean first argument that decides its existence."""
    return MaskCombinator(f)


__all__ = ["MaskCombinator", "MaskTrace", "mask"]
