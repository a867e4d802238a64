"""`Dimap` combinator: pre/post transformation of arguments and return
values. `map` and `contramap` are the one-sided specializations.

Counterpart of `genjax_tpu/combinators/dimap.py`. The two mappings are
plain Python over tensors and run once for the whole batch, so they follow
the rule of a model body: batch axes in front, negative axes, `...`.
"""

from typing import Any, Callable, Generic, TypeVar

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.concepts import Score, Weight
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace
from genjax_tpu_torch.core.pytree import Pytree, n_leaves
from genjax_tpu_torch.distributions.distribution import _drop
from genjax_tpu_torch.lang.static import _recorded, marked_like

R = TypeVar("R")
S = TypeVar("S")


@Pytree.dataclass
class DimapTrace(Generic[R, S], Trace[S]):
    gen_fn: "Dimap[R, S]"
    inner: Trace[R]
    args: tuple
    retval: S
    args_batched: tuple = Pytree.static(default=())
    retval_batched: tuple = Pytree.static(default=())

    def get_args(self) -> tuple:
        return self.args

    def get_gen_fn(self) -> GenerativeFunction[S]:
        return self.gen_fn

    def get_choices(self) -> ChoiceMap:
        return self.inner.get_choices()

    def get_retval(self) -> S:
        return self.retval

    def get_score(self) -> Score:
        return self.inner.get_score()

    def get_inner_trace(self, address) -> Trace:
        return self.inner.get_inner_trace(address)

    def args_record(self) -> list[int]:
        return list(self.args_batched) or [0] * n_leaves(self.args)

    def retval_record(self) -> list[int]:
        return list(self.retval_batched) or [0] * n_leaves(self.retval)

    def batched_leaves(self) -> list[int]:
        return [0] * n_leaves(self.gen_fn) + self.inner.batched_leaves() + self.args_record() + self.retval_record()

    def add_gap(self, k: int = 1) -> "DimapTrace[R, S]":
        inner = self.inner.add_gap(k)
        if inner is self.inner:
            return self
        return DimapTrace(self.gen_fn, inner, self.args, self.retval, self.args_batched, self.retval_batched)

    def drop_level(self, r: int = 0) -> "DimapTrace[R, S]":
        return DimapTrace(
            self.gen_fn,
            self.inner.drop_level(r),
            self.args,
            self.retval,
            tuple(_drop(d, r) for d in self.args_batched),
            tuple(_drop(d, r) for d in self.retval_batched),
        )


@Pytree.dataclass
class Dimap(Generic[R, S], GenerativeFunction[S]):
    """Transform arguments with `argument_mapping` before the inner
    function runs, and the return value with `retval_mapping(args,
    inner_args, inner_retval)` afterward. Choices and scores pass through
    unchanged.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.gen
    ... def f(x):
    ...     return gx.normal(x, 1.0) @ "y"
    >>> g = f.dimap(pre=lambda x: (x + 10.0,), post=lambda args, xformed, ret: ret * 0.0 + xformed[0])
    >>> float(g.simulate(torch.Generator().manual_seed(0), (1.0,)).get_retval())
    11.0
    """

    inner: GenerativeFunction[R]
    argument_mapping: Callable[..., tuple] = Pytree.static()
    retval_mapping: Callable[..., S] = Pytree.static()
    info: str | None = Pytree.static(default=None)

    def _learned(self, tr: Trace[R], args: tuple, inner_args: tuple) -> DimapTrace[R, S]:
        """The trace of a run that learns its record from marks: the inner
        return value is handed to the mapping marked as `tr` records it."""
        inner_ret = marked_like(tr.get_retval(), tr.retval_record())
        retval, retval_batched = _recorded(self.retval_mapping(args, inner_args, inner_ret))
        args, args_batched = _recorded(args)
        return DimapTrace(self, tr, args, retval, args_batched, retval_batched)

    def _like(self, tr: Trace[R], args: tuple, inner_args: tuple, like: DimapTrace) -> DimapTrace[R, S]:
        """The trace of a run on plain tensors with `like`'s record. The
        return value's mapping still sees marked values (views), so that
        it can tell batch axes from event axes."""
        if any(like.args_batched):
            marked = marked_like(args, like.args_batched)
            marked_inner = self.argument_mapping(*marked)
        else:
            marked, marked_inner = args, inner_args
        inner_ret = marked_like(tr.get_retval(), tr.retval_record())
        retval = _recorded(self.retval_mapping(marked, marked_inner, inner_ret))[0]
        return DimapTrace(self, tr, args, retval, like.args_batched, like.retval_batched)

    def simulate(self, rng, args: tuple, n=None) -> DimapTrace[R, S]:
        inner_args = self.argument_mapping(*args)
        tr = self.inner.simulate(rng, inner_args, n)
        return self._learned(tr, args, inner_args)

    def generate(self, rng, constraint: ChoiceMap, args: tuple, n=None, like=None) -> tuple[DimapTrace[R, S], Weight]:
        if like is not None:
            args = _recorded(args)[0]
        inner_args = self.argument_mapping(*args)
        tr, weight = self.inner.generate(rng, constraint, inner_args, n, None if like is None else like.inner)
        if like is not None:
            return self._like(tr, args, inner_args, like), weight
        return self._learned(tr, args, inner_args), weight

    def assess(self, sample: ChoiceMap, args: tuple, n=None, marked: bool = False) -> tuple[Score, S]:
        """The return value's mapping sees marked values under a batch, as
        in every other method, so that it can tell batch axes from event
        axes."""
        inner_args = self.argument_mapping(*args)
        score, inner_retval = self.inner.assess(sample, inner_args, n, n is not None)
        retval = self.retval_mapping(args, inner_args, inner_retval)
        return score, retval if marked or n is None else _recorded(retval)[0]

    def project(self, rng, trace: DimapTrace, selection: Selection) -> Weight:
        return trace.inner.project(rng, selection)

    def edit(self, rng, trace: DimapTrace, edit_request, argdiffs, n=None):
        primals = Diff.tree_primal(argdiffs)
        inner_args = self.argument_mapping(*primals)
        inner_argdiffs = (
            Diff.no_change(inner_args) if Diff.static_check_no_change(argdiffs) else Diff.unknown_change(inner_args)
        )
        tr, w, inner_retdiff, bwd = self.inner.edit(rng, trace.inner, edit_request, inner_argdiffs, n)
        new = self._like(tr, primals, inner_args, trace)
        retdiff = (
            Diff.no_change(new.retval)
            if Diff.static_check_no_change(inner_retdiff)
            else Diff.unknown_change(new.retval)
        )
        return new, w, retdiff, bwd


def dimap(
    *,
    pre: Callable[..., Any] = lambda *args: args,
    post: Callable[..., Any] = lambda args, xformed, retval: retval,
    info: str | None = None,
):
    """Decorator: transform both arguments and return values."""

    def decorator(f: GenerativeFunction[R]) -> Dimap[R, Any]:
        return Dimap(f, pre, post, info)

    return decorator


def map(f: Callable[..., Any], *, info: str | None = None):
    """Decorator: transform the return value only."""

    def decorator(gen_fn: GenerativeFunction[R]):
        return Dimap(gen_fn, lambda *args: args, lambda _args, _xformed, ret: f(ret), info or "map")

    return decorator


def contramap(f: Callable[..., Any], *, info: str | None = None):
    """Decorator: transform the arguments only."""

    def decorator(gen_fn: GenerativeFunction[R]):
        return Dimap(gen_fn, f, lambda _args, _xformed, ret: ret, info or "contramap")

    return decorator
