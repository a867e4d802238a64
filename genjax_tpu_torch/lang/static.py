"""The `@gen` static modeling language.

Counterpart of `genjax_tpu/lang/static.py`: `gen`,
`StaticGenerativeFunction`, `StaticTrace`, `AddressReuse`,
`MissingAddress`, and the simulate / assess / generate / update /
regenerate handlers, with `project` and `edit`.

Every GFI method runs the model source directly, once, with a handler
installed (see `lang/interop.py`). The sites draw from the method's
`torch.Generator` in program order (JAX folds a per-site counter into its
key instead). With a particle count `n`, the body runs once on tensors
with a leading particle axis: no loop over particles (and under a `Vmap`,
once for every particle and lane: `n` is then the stack of batch axes, and
each record below is a depth, `core/typing.py`). `simulate` and
`generate` hand the body every per-particle value as a `PerParticle`
tensor, so that each site knows which of its parameters carry the axis,
and record which leaves of the arguments and the return value carry it.
The edits keep the old trace's record and hand the body plain tensors.
So does `generate` given `like=`, a trace of an earlier call with the same
record: a filter's step model, like the body of JAX's `scan`, is traced
with the marks once and then reuses that record at every later step.

The source is a `Closure`, as in JAX: `partial_apply` fixes leading
arguments, which become leaves of the generative function (shared by every
particle: a trace records its generative function's leaves as carrying no
batch axis), and a `@gen` method binds its instance so (`__get__`).
`handle_kwargs` gives the function that takes `((args...), {kwargs...})`.

The edits are dense: every site is visited and re-scored. The site-graph
analysis that makes them incremental (`_EditPlan` in JAX) comes later.
"""

from typing import Any, Callable, Generic, TypeVar

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core import checked
from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.concepts import Argdiffs, EditRequest, NotSupportedEditRequest, Score, Weight
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu_torch.core.pytree import Closure, Pytree, _Fn, n_leaves
from genjax_tpu_torch.core.requests import EmptyRequest, Regenerate
from genjax_tpu_torch.core.typing import batch_dims, depth_of, device_of, mark, plain
from genjax_tpu_torch.distributions.distribution import Distribution, DistributionTrace, _drop
from genjax_tpu_torch.lang.interop import TraceHandler, handler_context

R = TypeVar("R")


class AddressReuse(Exception):
    """Attempt to re-write an address in a trace. Each address may only be
    traced once per program execution."""


class MissingAddress(Exception):
    """Attempt to assess a model without supplying values for all sampled
    addresses."""


def _flat(args: tuple) -> bool:
    """Whether every element of `args` is a pytree leaf."""
    return all(a is None or isinstance(a, (torch.Tensor, float, int)) for a in args)


def marked_like(tree, record):
    """`tree` with each leaf marked at the depth that `record` gives it."""
    if not any(record):
        return tree
    leaves, spec = pytree.tree_flatten(tree)
    return pytree.tree_unflatten([mark(x, d) for x, d in zip(leaves, record)], spec)


def _recorded(tree) -> tuple[Any, tuple]:
    """`tree` with its batch marks taken off, and the depth that each of
    its leaves was marked with."""
    if isinstance(tree, torch.Tensor):
        return plain(tree), (depth_of(tree),)
    if isinstance(tree, tuple) and _flat(tree):
        record = tuple(depth_of(leaf) for leaf in tree)
        return (tuple(plain(leaf) for leaf in tree) if any(record) else tree), record
    leaves, spec = pytree.tree_flatten(tree)
    record = tuple(depth_of(leaf) for leaf in leaves)
    if any(record):
        tree = pytree.tree_unflatten([plain(leaf) for leaf in leaves], spec)
    return tree, record


@Pytree.dataclass
class StaticTrace(Generic[R], Trace[R]):
    """Trace of a `@gen` program: a dict of per-address subtraces, and the
    record of which leaves of the arguments and of the return value carry
    the particle axis."""

    gen_fn: "StaticGenerativeFunction[R]"
    args: tuple
    retval: R
    subtraces: dict
    args_batched: tuple = Pytree.static(default=())
    retval_batched: tuple = Pytree.static(default=())

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self) -> R:
        return self.retval

    def get_gen_fn(self) -> GenerativeFunction[R]:
        return self.gen_fn

    def get_choices(self) -> ChoiceMap:
        return ChoiceMap.d({a: tr.get_choices() for a, tr in self.subtraces.items()})

    def get_score(self) -> Score:
        scores = [tr.get_score() for tr in self.subtraces.values()]
        if not scores:
            return torch.zeros((), device=device_of(*pytree.tree_leaves((self.args, self.retval))))
        total = scores[0]
        for s in scores[1:]:
            total = total + s
        return total

    def args_record(self) -> list[int]:
        return list(self.args_batched) or [0] * n_leaves(self.args)

    def retval_record(self) -> list[int]:
        return list(self.retval_batched) or [0] * n_leaves(self.retval)

    def get_inner_trace(self, address):
        return self.subtraces[address]

    def drop_level(self, r: int = 0) -> "StaticTrace[R]":
        return StaticTrace(
            self.gen_fn,
            self.args,
            self.retval,
            {a: tr.drop_level(r) for a, tr in self.subtraces.items()},
            tuple(_drop(d, r) for d in self.args_batched),
            tuple(_drop(d, r) for d in self.retval_batched),
        )

    def add_gap(self, k: int = 1) -> "StaticTrace[R]":
        subtraces = {a: tr.add_gap(k) for a, tr in self.subtraces.items()}
        if all(new is old for new, old in zip(subtraces.values(), self.subtraces.values())):
            return self
        return StaticTrace(self.gen_fn, self.args, self.retval, subtraces, self.args_batched, self.retval_batched)

    def batched_leaves(self) -> list[int]:
        bits = [0] * n_leaves(self.gen_fn) + self.args_record() + self.retval_record()
        for tr in self.subtraces.values():
            bits += tr.batched_leaves()
        return bits

    def as_single(self) -> "StaticTrace[R]":
        return StaticTrace(
            self.gen_fn,
            self.args,
            self.retval,
            {a: tr.as_single() for a, tr in self.subtraces.items()},
        )


############
# Handlers #
############


class StaticLangHandler(TraceHandler):
    """Base handler: records subtraces and rejects address reuse. With
    `mark`, a per-particle return value of a site reaches the body as a
    `PerParticle` tensor."""

    def __init__(self, rng: torch.Generator | None, n: int | None, mark: bool = False):
        self.rng = rng
        self.n = n
        self.mark = mark and n is not None
        self.subtraces: dict = {}

    def record(self, addr, subtrace) -> None:
        if addr in self.subtraces:
            raise AddressReuse(addr)
        self.subtraces[addr] = subtrace

    def handed(self, tr: Trace) -> Any:
        """What the body sees of a site: its return value, marked where
        the record says it carries the particle axis."""
        v = tr.get_retval()
        if not self.mark:
            return v
        if isinstance(tr, DistributionTrace):
            return mark(v, tr.batched)
        return marked_like(v, tr.retval_record())


class SimulateHandler(StaticLangHandler):
    def __init__(self, rng, n):
        super().__init__(rng, n, mark=True)

    def handle_trace(self, addr, gen_fn, args):
        tr = gen_fn.simulate(self.rng, args, self.n)
        self.record(addr, tr)
        return self.handed(tr)


class AssessHandler(StaticLangHandler):
    """With a batch, the body sees each value with the mark of its depth
    (as the choice map records it), so that a `Vmap` further down knows
    which of its arguments carry which batch axes."""

    def __init__(self, sample: ChoiceMap, n: int | None):
        super().__init__(None, n, mark=True)
        self.sample = sample
        self.score = None

    def handle_trace(self, addr, gen_fn, args):
        submap = self.sample(addr)
        if submap.static_is_empty() and isinstance(gen_fn, Distribution):
            raise MissingAddress(addr)
        score, v = gen_fn.assess(submap, args, self.n, self.mark)
        self.score = score if self.score is None else self.score + score
        return v


class GenerateHandler(StaticLangHandler):
    """With `like`, the body sees plain tensors, and each site generates
    like the same site of `like`."""

    def __init__(self, rng: torch.Generator, constraint: ChoiceMap, n: int | None, like=None):
        super().__init__(rng, n, mark=like is None)
        self.constraint = constraint
        self.like = like
        # With a particle axis the weight is (n,) even where every site's
        # weight is shared (unbatched) or zero.
        self.weight = torch.zeros(batch_dims(n), device=rng.device)

    def handle_trace(self, addr, gen_fn, args):
        like = None
        if self.like is not None:
            if addr not in self.like.subtraces:
                raise MissingAddress(f"{addr!r}: a site that the trace given as `like` does not hold")
            like = self.like.subtraces[addr]
        tr, w = gen_fn.generate(self.rng, self.constraint(addr), args, self.n, like)
        self.weight = self.weight + w
        self.record(addr, tr)
        return self.handed(tr)


class EditHandler(StaticLangHandler):
    """Base of the dense edit handlers: each site of the previous trace is
    edited with the site's part of the request and re-scored; the weights
    add up, and the discarded choices make the backward `Update`."""

    def __init__(self, rng: torch.Generator, previous: StaticTrace, n: int | None):
        super().__init__(rng, n)
        self.previous = previous
        self.weight = torch.zeros((), device=rng.device)
        self.discards: dict = {}

    def site_request(self, addr):
        raise NotImplementedError

    def handle_trace(self, addr, gen_fn, args):
        if addr not in self.previous.subtraces:
            raise MissingAddress(addr)
        tr, w, _, bwd = gen_fn.edit(
            self.rng, self.previous.subtraces[addr], self.site_request(addr), Diff.unknown_change(args), self.n
        )
        self.weight = self.weight + w
        # A callee that answers with another request than an `Update` (a
        # combinator's `Regenerate`) is undone by its old choices whole.
        self.discards[addr] = bwd.constraint if isinstance(bwd, Update) else self.previous.subtraces[addr].get_choices()
        self.record(addr, tr)
        return tr.get_retval()


class UpdateHandler(EditHandler):
    def __init__(self, rng, previous, constraint: ChoiceMap):
        super().__init__(rng, previous, None)
        self.constraint = constraint

    def site_request(self, addr):
        return Update(self.constraint(addr))


class RegenerateHandler(EditHandler):
    def __init__(self, rng, previous, selection: Selection, n: int | None):
        super().__init__(rng, previous, n)
        self.selection = selection

    def site_request(self, addr):
        return Regenerate(self.selection(addr))


#######################
# Generative function #
#######################


@Pytree.dataclass
class StaticGenerativeFunction(Generic[R], GenerativeFunction[R]):
    """A generative function whose source is a Python program over tensors
    using `dist(args) @ "addr"` addressing syntax.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.gen
    ... def model(mu, scale=1.0):
    ...     return gx.normal(mu, scale) @ "x"
    >>> fixed = model.partial_apply(torch.tensor(2.0))
    >>> tr = fixed.simulate(torch.Generator().manual_seed(0), ())
    >>> tr.get_args(), fixed.partial_args()
    ((), (tensor(2.),))
    >>> kw = model.handle_kwargs()
    >>> score, _ = kw.assess(gx.ChoiceMap.kw(x=0.0), ((0.0,), {"scale": 2.0}))
    >>> round(float(score), 4)
    -1.6121
    """

    source: Closure

    # The node: the source's arguments are its children and the source's
    # function its context, so a function with no partial arguments is a
    # node without children, as cheap to flatten as a static source.
    @staticmethod
    def _flatten(gen_fn: "StaticGenerativeFunction"):
        return list(gen_fn.source.dyn_args), _Fn(gen_fn.source.fn)

    @staticmethod
    def _unflatten(children, context: _Fn) -> "StaticGenerativeFunction":
        obj = object.__new__(StaticGenerativeFunction)
        object.__setattr__(obj, "source", Closure(tuple(children), context.fn))
        return obj

    def _n_leaves(self) -> int:
        dyn = self.source.dyn_args
        return sum(n_leaves(a) for a in dyn) if dyn else 0

    def __get__(self, instance, _klass) -> "StaticGenerativeFunction[R]":
        return self.partial_apply(instance) if instance else self

    def __post_init__(self):
        wrapped = self.source.fn
        for k in ("__module__", "__name__", "__qualname__", "__doc__"):
            v = getattr(wrapped, k, None)
            if v is not None:
                object.__setattr__(self, k, v)
        object.__setattr__(self, "__wrapped__", wrapped)

    def handle_kwargs(self) -> "StaticGenerativeFunction[R]":
        """The same program taking `((args...), {kwargs...})`."""

        @Pytree.partial()
        def kwarged_source(args, kwargs):
            return self.source(*args, **kwargs)

        return StaticGenerativeFunction(kwarged_source)

    def partial_args(self) -> tuple:
        return self.source.dyn_args

    def partial_apply(self, *args) -> "StaticGenerativeFunction[R]":
        """The same program with `args` applied first."""
        return gen(Closure(self.source.dyn_args + args, self.source.fn))

    def _trace(self, args, retval, subtraces) -> StaticTrace[R]:
        args, args_batched = _recorded(args)
        retval, retval_batched = _recorded(retval)
        return StaticTrace(self, args, retval, subtraces, args_batched, retval_batched)

    def simulate(self, rng: torch.Generator, args: tuple, n: "int | tuple | None" = None) -> StaticTrace[R]:
        if checked.is_checked():
            checked.check_key(rng, "simulate")
            checked.check_args(args, "simulate")
        handler = SimulateHandler(rng, n)
        with handler_context(handler):
            retval = self.source(*args)
        return self._trace(args, retval, handler.subtraces)

    def assess(
        self, sample: ChoiceMap, args: tuple, n: "int | tuple | None" = None, marked: bool = False
    ) -> tuple[Score, R]:
        """With `marked` (a call from an enclosing body), the arguments may
        carry batch marks and the return value keeps its own."""
        if checked.is_checked():
            checked.check_choice_map(sample, "assess", "sample")
            checked.check_args(args, "assess")
        handler = AssessHandler(sample, n)
        with handler_context(handler):
            retval = self.source(*args)
        score = handler.score
        if score is None:
            score = torch.zeros((), device=device_of(*pytree.tree_leaves(args)))
        if n is not None and score.dim() < len(batch_dims(n)):
            score = score.expand(batch_dims(n))
        return score, retval if marked or n is None else _recorded(retval)[0]

    def generate(
        self,
        rng: torch.Generator,
        constraint: ChoiceMap,
        args: tuple,
        n: "int | tuple | None" = None,
        like: "StaticTrace | None" = None,
    ) -> tuple[StaticTrace[R], Weight]:
        """With `like`, the body runs on plain tensors (marks on `args` are
        taken off) and each site generates like `like`'s."""
        if checked.is_checked():
            checked.check_key(rng, "generate")
            checked.check_choice_map(constraint, "generate")
            checked.check_args(args, "generate")
        if like is not None:
            args = _recorded(args)[0]
        handler = GenerateHandler(rng, constraint, n, like)
        with handler_context(handler):
            retval = self.source(*args)
        if like is None:
            return self._trace(args, retval, handler.subtraces), handler.weight
        new = StaticTrace(self, args, retval, handler.subtraces, like.args_batched, like.retval_batched)
        return new, handler.weight

    def project(self, rng: torch.Generator, trace: StaticTrace[R], selection: Selection) -> Weight:
        weight = torch.zeros((), device=rng.device)
        for addr, subtrace in trace.subtraces.items():
            weight = weight + subtrace.project(rng, selection(addr))
        return weight

    # -- edits -------------------------------------------------------------------

    def _edited(self, trace: StaticTrace[R], args, handler: EditHandler):
        with handler_context(handler):
            retval = self.source(*args)
        # An edit keeps the particle-axis record of the trace it edits.
        new = StaticTrace(
            self, args, _recorded(retval)[0], handler.subtraces, trace.args_batched, trace.retval_batched
        )
        bwd = Update(ChoiceMap.d(handler.discards))
        return new, handler.weight, Diff.unknown_change(new.retval), bwd

    def edit_update(self, rng, trace, constraint: ChoiceMap, argdiffs):
        if constraint.static_is_empty() and Diff.static_check_no_change(argdiffs):
            weight = torch.zeros((), device=rng.device)
            return trace, weight, Diff.no_change(trace.get_retval()), Update(ChoiceMap.empty())
        handler = UpdateHandler(rng, trace, constraint)
        return self._edited(trace, Diff.tree_primal(argdiffs), handler)

    def edit_regenerate(self, rng, trace, selection: Selection, argdiffs, n=None):
        handler = RegenerateHandler(rng, trace, selection, trace.particle_count() if n is None else n)
        return self._edited(trace, Diff.tree_primal(argdiffs), handler)

    def edit(
        self,
        rng: torch.Generator,
        trace: StaticTrace[R],
        edit_request: EditRequest,
        argdiffs: Argdiffs,
        n: "int | tuple | None" = None,
    ):
        """`n` is the batch of an enclosing trace; without it, the particle
        count is read from this trace's own record."""
        if checked.is_checked():
            checked.check_key(rng, "edit")
            checked.check_request(edit_request, "edit")
            checked.check_args(argdiffs, "edit (argdiffs)")
        match edit_request:
            case Update(constraint):
                return self.edit_update(rng, trace, constraint, argdiffs)
            case Regenerate(selection):
                return self.edit_regenerate(rng, trace, selection, argdiffs, n)
            case EmptyRequest():
                return edit_request.edit(rng, trace, argdiffs)
            case _:
                raise NotSupportedEditRequest(edit_request)



def gen(f: Callable[..., Any]) -> StaticGenerativeFunction[Any]:
    """Decorator turning a Python function that uses `dist(args) @ "addr"`
    into a `StaticGenerativeFunction`."""
    if isinstance(f, Closure):
        return StaticGenerativeFunction(f)
    return gen(Closure((), f))


__all__ = [
    "AddressReuse",
    "MissingAddress",
    "StaticGenerativeFunction",
    "StaticTrace",
    "gen",
]
