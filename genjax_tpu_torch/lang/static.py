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

The edits are incremental, as JAX's are: a site-graph analysis
(`lang/analysis.py`), run once per specialization and cached, gives each
edit a plan (`_EditPlan`). A site that the edit cannot reach keeps its
subtrace as it was, at zero weight and with an empty backward request
(no density, no launch); a site whose arguments provably did not change
gets `NoChange` argdiffs (per leaf, so a nested `@gen` callee recurses
the plan and a `Switch` keeps its same-branch path); a site whose
callee's own leaves (a closure capture) changed is recomputed densely
under the callee built afresh; and the retdiff is `NoChange` where no
changed value reaches the return value. Where the analysis cannot see
the dataflow, or the request is not known without running anything, the
fallback plan recomputes every site, which is always correct, and
`analysis.stats()` counts it with its reason. `StaticRequest` edits
address by address; `Regenerate`'s backward request is one.
"""

from dataclasses import dataclass
from typing import Any, Callable, Generic, TypeVar

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core import checked
from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.concepts import (
    Argdiffs,
    EditRequest,
    NotSupportedEditRequest,
    PrimitiveEditRequest,
    Score,
    Weight,
)
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu_torch.core.pytree import Closure, Pytree, _Fn, n_leaves
from genjax_tpu_torch.core.requests import EmptyRequest, Regenerate
from genjax_tpu_torch.core.staging import to_shape_fn, zeros_on
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


#####################################
# Static (per-address) edit request #
#####################################


@Pytree.dataclass
class StaticRequest(PrimitiveEditRequest):
    """A dict of per-address edit sub-requests; an address it does not
    name gets an `EmptyRequest`."""

    addressed: dict


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


class AbstractHandler(StaticLangHandler):
    """Hands the body each site's return value as zeros of its shape on
    the arguments' device, with no draw (a shape-only call)."""

    def __init__(self):
        super().__init__(None, None)

    def handle_trace(self, addr, gen_fn, args):
        return gen_fn.__abstract_call__(*args)


class EditHandler(StaticLangHandler):
    """Base of the edit handlers: each site of the previous trace is kept
    (where the plan reuses it), recomputed densely under its callee built
    afresh (where its closure captures changed), or edited with the site's
    part of the request under the plan's argdiffs. The weights add up."""

    def __init__(self, rng: torch.Generator, previous: StaticTrace, n: "int | tuple | None", plan: "_EditPlan"):
        super().__init__(rng, n)
        self.previous = previous
        self.plan = plan
        self.weight = torch.zeros((), device=rng.device)
        self.bwds: dict = {}

    def site_request(self, addr) -> EditRequest:
        raise NotImplementedError

    def kept(self, addr) -> Any:
        """The backward part of a site that the plan keeps."""
        raise NotImplementedError

    def dense(self, addr, gen_fn, args, subtrace) -> tuple[Trace, Any]:
        """`(new subtrace, backward part)` of a site recomputed densely."""
        raise NotImplementedError

    def backward(self, addr, bwd: EditRequest) -> Any:
        return bwd

    def handle_trace(self, addr, gen_fn, args):
        if addr not in self.previous.subtraces:
            raise MissingAddress(addr)
        subtrace = self.previous.subtraces[addr]
        if addr in self.plan.reuse:
            # Out of the edit's reach: the subtrace as it was, zero weight.
            self.bwds[addr] = self.kept(addr)
            self.record(addr, subtrace)
            return subtrace.get_retval()
        if self.plan.needs_dense(addr, gen_fn, subtrace):
            # The callee's own leaves (a closure capture built in the body)
            # changed, which argdiffs cannot say: the callee's edit would
            # see its captures as they were. Recompute under the callee
            # built afresh, the old values kept where the request keeps
            # them; the weight is the change of the score.
            tr, bwd = self.dense(addr, gen_fn, args, subtrace)
            self.weight = self.weight + (tr.get_score() - subtrace.get_score())
            self.bwds[addr] = bwd
            self.record(addr, tr)
            return tr.get_retval()
        # Through the callee built afresh (leaf for leaf the stored one,
        # under an analyzed plan), with the plan's per-leaf argdiffs.
        argdiffs = self.plan.site_argdiffs(addr, args)
        request = self.site_request(addr)
        if isinstance(request, PrimitiveEditRequest):
            tr, w, retdiff, bwd = gen_fn.edit(self.rng, subtrace, request, argdiffs, self.n)
        else:
            tr, w, retdiff, bwd = request.edit(self.rng, subtrace, argdiffs)
        self.weight = self.weight + w
        self.bwds[addr] = self.backward(addr, bwd)
        self.record(addr, tr)
        return Diff.tree_primal(retdiff)


class UpdateHandler(EditHandler):
    def __init__(self, rng, previous, constraint: ChoiceMap, plan: "_EditPlan"):
        super().__init__(rng, previous, None, plan)
        self.constraint = constraint

    def site_request(self, addr):
        return Update(self.constraint(addr))

    def kept(self, addr):
        return ChoiceMap.empty()

    def dense(self, addr, gen_fn, args, subtrace):
        return _dense_update(self.rng, gen_fn, self.constraint(addr), args, self.n, subtrace)

    def backward(self, addr, bwd):
        # A callee that answers with another request than an `Update` (a
        # combinator's) is undone by its old choices whole: coarser than
        # its discard, and a valid reverse all the same.
        return bwd.constraint if isinstance(bwd, Update) else self.previous.subtraces[addr].get_choices()


class RegenerateHandler(EditHandler):
    def __init__(self, rng, previous, selection: Selection, n: "int | tuple | None", plan: "_EditPlan"):
        super().__init__(rng, previous, n, plan)
        self.selection = selection

    def site_request(self, addr):
        return Regenerate(self.selection(addr))

    def kept(self, addr):
        return EmptyRequest()

    def dense(self, addr, gen_fn, args, subtrace):
        sub = self.selection(addr)
        return _dense_regenerate(self.rng, gen_fn, sub, args, self.n, subtrace), Regenerate(sub)


class StaticRequestHandler(EditHandler):
    """Each address gets its own sub-request (an `EmptyRequest` where the
    request names none) under unknown argdiffs, as in JAX: the fallback
    plan, whose comparison of each callee's leaves with the stored one's
    catches a closure capture that a sibling's edit changed (argdiffs
    cannot: a callee without arguments would see NoChange)."""

    def __init__(self, rng, previous, addressed: dict, n: "int | tuple | None"):
        super().__init__(rng, previous, n, _FALLBACK_PLAN)
        self.addressed = addressed

    def site_request(self, addr):
        return self.addressed.get(addr, EmptyRequest())

    def dense(self, addr, gen_fn, args, subtrace):
        request = self.site_request(addr)
        if isinstance(request, (EmptyRequest, Update)):
            sub = request.constraint if isinstance(request, Update) else ChoiceMap.empty()
            tr, discard = _dense_update(self.rng, gen_fn, sub, args, self.n, subtrace)
            return tr, Update(discard)
        if isinstance(request, Regenerate):
            return _dense_regenerate(self.rng, gen_fn, request.selection, args, self.n, subtrace), request
        raise NotSupportedEditRequest(
            f"StaticRequest at {addr!r}: the callee's closure captures changed under this edit, and "
            f"{type(request).__name__} cannot be composed with a dense recompute. Split the edit: "
            "first Update the upstream value, then apply the request."
        )


def _dense_update(rng, gen_fn, constraint: ChoiceMap, args, n, subtrace) -> tuple[Trace, ChoiceMap]:
    """A site recomputed under `gen_fn` with its old values where the
    constraint leaves them: the new subtrace and the discard."""
    old = subtrace.get_choices()
    tr, _ = gen_fn.generate(rng, constraint | old, args, n, subtrace)
    return tr, old.filter(constraint.get_selection())


def _dense_regenerate(rng, gen_fn, selection: Selection, args, n, subtrace) -> Trace:
    """A site recomputed under `gen_fn`: the selected values drawn afresh,
    the others kept and re-scored."""
    tr, _ = gen_fn.generate(rng, subtrace.get_choices().filter(~selection), args, n, subtrace)
    return tr


#############
# Edit plan #
#############


@dataclass(frozen=True)
class _EditPlan:
    """The reuse and argdiff plan of one edit (`lang/analysis.py`). The
    fallback plan (empty, not analyzed) is always correct: it recomputes
    every site under unknown argdiffs and compares each callee's leaves
    with the stored callee's when the program runs."""

    reuse: frozenset = frozenset()  # sites kept as they were
    args_unchanged: frozenset = frozenset()  # edited sites whose arguments did not change
    retval_static: bool = False  # the model's return value did not change
    # addr -> a tree of bools over the site's arguments: which leaves may
    # have changed, so that a `Switch` whose data alone changed keeps its
    # same-branch edit.
    argdiff_masks: dict | None = None
    # Sites whose callee's own leaves (closure captures) this edit reaches:
    # recomputed densely under the callee built afresh.
    callee_changed: frozenset = frozenset()
    analyzed: bool = False

    def site_argdiffs(self, addr, args):
        if addr in self.args_unchanged:
            return Diff.no_change(args)
        mask = (self.argdiff_masks or {}).get(addr)
        if mask is None:
            return Diff.unknown_change(args)
        try:
            return pytree.tree_map(
                lambda leaf, m: Diff.unknown_change(leaf) if m else Diff.no_change(leaf), args, mask
            )
        except Exception:  # noqa: BLE001 - the structure drifted: coarse is always correct
            return Diff.unknown_change(args)

    def needs_dense(self, addr, gen_fn, subtrace) -> bool:
        """Whether `addr` must be recomputed densely under the callee built
        afresh: the analyzed set, or without analysis a comparison of the
        callee's leaves with the stored callee's."""
        if self.analyzed:
            return addr in self.callee_changed
        return not _callee_leaves_match(gen_fn, subtrace.get_gen_fn())


_FALLBACK_PLAN = _EditPlan()


def _callee_leaves_match(new_gf, old_gf) -> bool:
    """Whether two callees hold the same leaves: one structure, and each
    leaf the same object or an equal value that the host holds (a number,
    a CPU tensor). Two distinct device tensors count as different (a
    comparison would read the device): dense, which is always correct."""
    if new_gf is old_gf:
        return True
    try:
        new_leaves, new_spec = pytree.tree_flatten(new_gf)
        old_leaves, old_spec = pytree.tree_flatten(old_gf)
    except Exception:  # noqa: BLE001
        return False
    if new_spec != old_spec or len(new_leaves) != len(old_leaves):
        return False
    for a, b in zip(new_leaves, old_leaves):
        if a is b:
            continue
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            if not (
                isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.device.type == "cpu" and b.device.type == "cpu"
                and a.shape == b.shape and a.dtype == b.dtype and torch.equal(plain(a), plain(b))
            ):
                return False
            continue
        try:
            if a != b:
                return False
        except Exception:  # noqa: BLE001
            return False
    return True


def _site_addresses(touched: frozenset, order: tuple) -> frozenset:
    """The sites that a request touching the top-level keys `touched`
    reaches: a site whose address is a path counts where its first key is
    touched."""
    return frozenset(a for a in order if (a[0] if isinstance(a, tuple) else a) in touched)


def _static_edit_plan(
    source,
    primals,
    trace: StaticTrace,
    constraint: ChoiceMap | None = None,
    selection: Selection | None = None,
    args_changed: bool = True,
) -> _EditPlan:
    """The plan of one edit: the sites kept as they were, the per-site
    argdiffs, and whether the return value is unchanged. Any failure of the
    analysis gives the fallback plan (counted in `analysis.stats()`):
    reuse is an optimisation, never needed for correctness."""
    from genjax_tpu_torch.lang import analysis

    try:
        graph = analysis.site_graph(source, primals)
    except Exception as e:  # noqa: BLE001
        analysis.note_fallback(str(e) or type(e).__name__)
        return _FALLBACK_PLAN
    if constraint is not None:
        touched = analysis.static_touched_addresses(constraint)
    else:
        touched = analysis.static_selected_addresses(selection, graph.order)
    if touched is None:
        analysis.note_fallback("the request's addresses are not known without running it")
        return _FALLBACK_PLAN
    # Only trust the plan where the analysis saw exactly the addresses that
    # the trace holds (against structure that the run decides).
    if set(graph.order) != set(trace.subtraces):
        analysis.note_fallback("the analysis saw other addresses than the trace holds")
        return _FALLBACK_PLAN
    key = (touched, args_changed)
    plan = graph.plans.get(key)
    if plan is None:
        plan = graph.plans[key] = _plan_of(graph, _site_addresses(touched, graph.order), args_changed)
    return plan


def _plan_of(graph, touched: frozenset, args_changed: bool) -> _EditPlan:
    w_set = graph.weight_set(touched, args_changed)
    # Sites edited only because the request names them: their arguments
    # did not change, so a nested callee gets NoChange and recurses.
    args_unchanged = frozenset(
        a for a in w_set if not (graph.deps[a] & touched) and not (args_changed and a in graph.args_reach)
    )
    argdiff_masks, callee_changed = {}, set()
    for a in w_set - args_unchanged:
        mask, changed = graph.site_edit_info(a, touched, args_changed)
        if changed:
            callee_changed.add(a)
        elif mask is not None:
            argdiff_masks[a] = mask
    return _EditPlan(
        reuse=frozenset(graph.order) - w_set,
        args_unchanged=args_unchanged,
        retval_static=graph.retval_unchanged(touched, args_changed),
        argdiff_masks=argdiff_masks,
        callee_changed=frozenset(callee_changed),
        analyzed=True,
    )


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

    def __abstract_call__(self, *args) -> Any:
        """The return value of a call as zeros of its shape, on the
        arguments' device (`to_shape_fn` of the source: no draw, no device
        work)."""

        def abstract(*a):
            with handler_context(AbstractHandler()):
                return self.source(*a)

        return to_shape_fn(abstract, zeros_on(args))(*args)

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
        retdiff = Diff.no_change(new.retval) if handler.plan.retval_static else Diff.unknown_change(new.retval)
        return new, handler.weight, retdiff

    def edit_update(self, rng, trace, constraint: ChoiceMap, argdiffs):
        if constraint.static_is_empty() and Diff.static_check_no_change(argdiffs):
            weight = torch.zeros((), device=rng.device)
            return trace, weight, Diff.no_change(trace.get_retval()), Update(ChoiceMap.empty())
        primals = Diff.tree_primal(argdiffs)
        args_changed = not Diff.static_check_no_change(argdiffs)
        plan = _static_edit_plan(self.source, primals, trace, constraint=constraint, args_changed=args_changed)
        handler = UpdateHandler(rng, trace, constraint, plan)
        new, weight, retdiff = self._edited(trace, primals, handler)
        return new, weight, retdiff, Update(ChoiceMap.d(handler.bwds))

    def edit_regenerate(self, rng, trace, selection: Selection, argdiffs, n=None):
        from genjax_tpu_torch.core.choice_map import NoneSel

        if isinstance(selection, NoneSel) and Diff.static_check_no_change(argdiffs):
            weight = torch.zeros((), device=rng.device)
            return trace, weight, Diff.no_change(trace.get_retval()), Regenerate(selection)
        primals = Diff.tree_primal(argdiffs)
        args_changed = not Diff.static_check_no_change(argdiffs)
        plan = _static_edit_plan(self.source, primals, trace, selection=selection, args_changed=args_changed)
        handler = RegenerateHandler(rng, trace, selection, trace.particle_count() if n is None else n, plan)
        new, weight, retdiff = self._edited(trace, primals, handler)
        return new, weight, retdiff, StaticRequest(handler.bwds)

    def edit_static_request(self, rng, trace, addressed: dict, argdiffs, n=None):
        primals = Diff.tree_primal(argdiffs)
        handler = StaticRequestHandler(rng, trace, addressed, trace.particle_count() if n is None else n)
        new, weight, _ = self._edited(trace, primals, handler)
        return new, weight, Diff.unknown_change(new.retval), StaticRequest(handler.bwds)

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
            case StaticRequest(addressed):
                return self.edit_static_request(rng, trace, addressed, argdiffs, n)
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
    "StaticRequest",
    "StaticTrace",
    "gen",
]
