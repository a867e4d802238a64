"""Static dependency analysis for incremental edits: the site graph.

Counterpart of `genjax_tpu/lang/analysis.py`. JAX stages the model's
source once into a jaxpr, each site an opaque equation, and walks the
equations. The port has no jaxpr: it runs the source once on
placeholders instead, with `_StageHandler` installed. A placeholder is a
meta tensor (a shape and a dtype, no data, no device work) of the class
`_Tracked`, which carries two things through every operation
(`__torch_function__`, the route by which `core/typing.py::PerParticle`
is carried): the set of sites whose values reach it, and whether the
model's arguments do. From that run:

1. for each address, the sites whose values reach its arguments (`deps`),
   whether the model's arguments reach them (`args_reach`), and the same
   per leaf of the callee and its arguments (`site_args`);
2. the sites and whether the arguments reach the return value.

At edit time the plan (`lang/static.py::_static_edit_plan`) closes the
touched set over the graph: the sites whose values change are the
constrained or regenerated ones; the sites whose densities must be
recomputed are those plus every site that reads one of them (or the
model's arguments, when they changed); every other site keeps its
subtrace as it was and costs nothing, on the host or the device. The
return value is unchanged (`NoChange`) when no changed value, and no
changed argument, reaches it.

The taint rules are JAX's: a site whose callee returns its sampled value
(`retval_is_value`, every distribution) puts out its own address alone,
since an edit that leaves the site alone keeps its value even when its
arguments change; a composite callee's return value also carries its
arguments' taint.

Where the run cannot see the dataflow, the analysis ends and the edit
falls back to the dense plan, which is always correct. Each end is
counted with its reason (`stats()`): a value that reaches Python
(`bool`, `item`, `int`, ... on a placeholder: the data-dependent control
flow that JAX cannot stage either), any in-place write or `out=` that a
placeholder takes part in (JAX has no such writes; a view shares its
base's storage, so a write through one would reach tensors that the run
cannot name), and any error of the run. Python numbers among the
arguments are staged as 0-d placeholders, as JAX traces them.
"""

import types
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.utils._pytree as pytree
from torch._C import DisableTorchFunctionSubclass
from torch.utils._python_dispatch import _disable_current_modes

from genjax_tpu_torch.core.pytree import _Fn
from genjax_tpu_torch.core.staging import META
from genjax_tpu_torch.lang.interop import TraceHandler, handler_context

__all__ = ["SiteGraph", "site_graph", "static_selected_addresses", "static_touched_addresses", "stats"]


class AnalysisEnded(Exception):
    """The analysis run cannot follow the model's dataflow from here."""


# Tensor methods through which a placeholder's value would reach Python.
_ESCAPES = frozenset({
    "__bool__", "__index__", "__int__", "__float__", "__complex__", "__contains__", "__array__",
    "item", "tolist", "numpy",
})
# Device moves keep the placeholder on meta (the dtype part of `to` holds).
_DEVICE_MOVES = frozenset({"to", "cuda", "cpu"})
_INPLACE_DUNDERS = frozenset({
    "__setitem__", "__set__", "__iadd__", "__isub__", "__imul__", "__itruediv__", "__ifloordiv__", "__imod__",
    "__ipow__", "__imatmul__", "__iand__", "__ior__", "__ixor__", "__ilshift__", "__irshift__",
})
_NO_TAINT = (frozenset(), False)


class _Tracked(torch.Tensor):
    """A meta placeholder with the sites whose values reach it (`_taint`)
    and whether the model's arguments do (`_reads`)."""

    _taint: frozenset = frozenset()
    _reads: bool = False

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _ESCAPES:
            raise AnalysisEnded(f"a placeholder's value reached Python ({name})")
        if _writes(name, kwargs):
            raise AnalysisEnded(f"{name} writes into a tensor in place, which the analysis does not track")
        taint, reads = _taint_of_tree((args, kwargs))
        if name in _DEVICE_MOVES:
            args, kwargs = _without_devices(name, args, kwargs)
        args, kwargs = pytree.tree_map(_meta_operand, (args, kwargs))
        with DisableTorchFunctionSubclass():
            out = func(*args, **kwargs)
        return _wrap(out, taint, reads)


def _track(x: torch.Tensor, taint: frozenset, reads: bool) -> _Tracked:
    with DisableTorchFunctionSubclass():
        t = x.as_subclass(_Tracked)
    t._taint, t._reads = taint, reads
    return t


def _taint_of(x: Any) -> tuple[frozenset, bool]:
    return (x._taint, x._reads) if isinstance(x, _Tracked) else _NO_TAINT


def _taint_of_tree(tree: Any) -> tuple[frozenset, bool]:
    taint, reads = frozenset(), False
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, _Tracked):
            taint, reads = taint | leaf._taint, reads or leaf._reads
    return taint, reads


def _writes(name: str, kwargs: dict) -> bool:
    """Whether an operation writes into a tensor: in place, or through
    `out=`."""
    return (
        kwargs.get("out") is not None
        or name in _INPLACE_DUNDERS
        or (name.endswith("_") and not name.startswith("__"))
    )


def _without_devices(name: str, args: tuple, kwargs: dict) -> tuple[tuple, dict]:
    """`x.to(...)`, `x.cuda()`, `x.cpu()` on a placeholder: the device part
    goes, the dtype part stays."""
    if name != "to":
        return args[:1], {}
    dtype = kwargs.get("dtype")
    for a in args[1:]:
        if isinstance(a, torch.dtype):
            dtype = a
        elif isinstance(a, torch.Tensor):
            dtype = a.dtype
    return (args[0],) if dtype is None else (args[0], dtype), {}


def _meta_operand(x: Any) -> Any:
    """A tensor that the analysis does not track (a constant of the body,
    a closure's data) as a meta operand: its shape and dtype only."""
    if isinstance(x, torch.Tensor) and not isinstance(x, _Tracked) and not x.is_meta:
        with DisableTorchFunctionSubclass():
            return torch.empty(x.shape, dtype=x.dtype, device=META)
    return x


def _wrap(out: Any, taint: frozenset, reads: bool) -> Any:
    if isinstance(out, torch.Tensor):
        return _track(out, taint, reads)
    if isinstance(out, (tuple, list)):
        items = [_wrap(o, taint, reads) for o in out]
        if type(out) in (tuple, list):
            return type(out)(items)
        return type(out)(*items) if hasattr(out, "_fields") else type(out)(items)
    return out


def _untrack(x: Any) -> Any:
    if isinstance(x, _Tracked):
        with DisableTorchFunctionSubclass():
            return x.as_subclass(torch.Tensor)
    return x


def _placeholder(x: Any) -> Any:
    """An argument leaf as a placeholder that the model's arguments reach:
    a tensor by its shape and dtype, a Python number as a 0-d tensor."""
    if isinstance(x, torch.Tensor):
        with DisableTorchFunctionSubclass():
            return _track(torch.empty(x.shape, dtype=x.dtype, device=META), frozenset(), True)
    if isinstance(x, (bool, int, float)):
        dtype = torch.bool if isinstance(x, bool) else torch.int64 if isinstance(x, int) else torch.float32
        return _track(torch.empty((), dtype=dtype, device=META), frozenset(), True)
    return x


class _StageHandler(TraceHandler):
    """Records each site's dependencies and hands the body a placeholder of
    the site's return value (`__abstract_call__` on meta operands)."""

    def __init__(self):
        self.deps: dict = {}
        self.args_reach: set = set()
        self.site_args: dict = {}

    def handle_trace(self, addr, gen_fn, args):
        fn_leaves, fn_spec = pytree.tree_flatten(gen_fn)
        arg_leaves, arg_spec = pytree.tree_flatten(args)
        leaf_info = tuple(_taint_of(x) for x in fn_leaves + arg_leaves)
        merged = frozenset().union(*(t for t, _ in leaf_info))
        reads = any(a for _, a in leaf_info)
        if addr not in self.deps:  # a site appears once; the first write wins
            self.deps[addr] = merged
            if reads:
                self.args_reach.add(addr)
            # The callee by its number of leaves alone: its structure holds
            # its functions, and their closures the data they capture.
            self.site_args[addr] = (len(fn_leaves), arg_spec, leaf_info)
        fn = pytree.tree_unflatten([_untrack(x) for x in fn_leaves], fn_spec)
        plain_args = pytree.tree_unflatten([_untrack(x) for x in arg_leaves], arg_spec)
        value = fn.__abstract_call__(*plain_args)
        if getattr(gen_fn, "retval_is_value", False):
            out_taint, out_reads = frozenset([addr]), False
        else:
            out_taint, out_reads = merged | frozenset([addr]), reads
        return pytree.tree_map(
            lambda v: _track(_meta_operand(v), out_taint, out_reads) if isinstance(v, torch.Tensor) else v, value
        )


@dataclass(frozen=True, eq=False)
class SiteGraph:
    """The dataflow of one model specialization between its sites."""

    order: tuple  # addresses in program order
    deps: dict  # addr -> frozenset of the sites whose values reach its arguments
    args_reach: frozenset  # sites whose arguments read the model's arguments
    retval_deps: frozenset  # sites whose values reach the return value
    retval_reads_args: bool  # the model's arguments reach the return value
    # addr -> (the callee's number of leaves, the spec of its arguments,
    # ((taint, reads_args), ...) per leaf of the callee, then of the arguments)
    site_args: dict
    # (touched, args_changed) -> the edit plan (`lang/static.py`), made once.
    plans: dict = field(default_factory=dict)

    def weight_set(self, value_changed: frozenset, args_changed: bool) -> frozenset:
        """The addresses whose densities this edit must recompute."""
        w = set(value_changed)
        for addr in self.order:
            if addr in w:
                continue
            if args_changed and addr in self.args_reach:
                w.add(addr)
            elif self.deps[addr] & value_changed:
                w.add(addr)
        return frozenset(w)

    def retval_unchanged(self, value_changed: frozenset, args_changed: bool) -> bool:
        if args_changed and self.retval_reads_args:
            return False
        return not (self.retval_deps & value_changed)

    def site_edit_info(self, addr, value_changed: frozenset, args_changed: bool):
        """`(argdiff_mask, callee_changed)` for an edited site: a tree of
        bools over the site's arguments (a leaf is True where it may have
        changed), or None where the analysis holds no such detail; and
        whether the callee's own leaves (closure captures) may have
        changed, which argdiffs cannot say, so the site must be recomputed
        densely under the callee built afresh. A failure reports
        `(None, True)`: dense is always correct."""
        info = self.site_args.get(addr)
        if info is None:
            return None, True
        n_callee, spec, leaf_info = info
        changed = [bool(taint & value_changed) or (args_changed and reads) for taint, reads in leaf_info]
        if any(changed[:n_callee]):
            return None, True
        try:
            return pytree.tree_unflatten(changed[n_callee:], spec), False
        except Exception:
            return None, True

    def argdiff_mask(self, addr, value_changed: frozenset, args_changed: bool):
        """The per-leaf change mask over `addr`'s arguments, or None."""
        mask, _ = self.site_edit_info(addr, value_changed, args_changed)
        return mask


def _analyze(source, args) -> SiteGraph:
    handler = _StageHandler()
    # The run is the port's staging, not part of the program: a dispatch
    # mode of the caller's (an operation log, a counter) does not see its
    # meta operations, as a jaxpr's staging is not part of its execution.
    with _disable_current_modes(), handler_context(handler):
        retval = source(*pytree.tree_map(_placeholder, args))
    ret_taint, ret_reads = _taint_of_tree(retval)
    return SiteGraph(
        order=tuple(handler.deps),
        deps=handler.deps,
        args_reach=frozenset(handler.args_reach),
        retval_deps=ret_taint,
        retval_reads_args=ret_reads,
        site_args=handler.site_args,
    )


#########
# Cache #
#########

# A concrete value that the source reads (a closure's argument, a tensor
# or a flag that its function captures or has as a default) can steer
# Python control flow while the source runs (`if flag: ... @ "a"`), so its
# value is part of the key. A small CPU tensor keeps its bytes in the key;
# any other tensor is keyed by the object and its `_version`, which every
# in-place write bumps: the same object at the same version holds the same
# values, and nothing is read from a CUDA device. The key holds such an
# object by a weak reference: the cache keeps no data alive, and the entry
# of an object that is gone matches nothing again.
_VALUE_INLINE_MAX_ELEMS = 128
# Loops over distinct closure arguments would grow the cache without bound;
# past this, the oldest entry goes.
_CACHE_MAX_ENTRIES = 512
# How far the key follows functions and containers into what a function
# captures; deeper, an object is keyed by identity.
_KEY_DEPTH = 8

_CACHE: dict = {}
_STATS: dict = {"analyses": 0, "hits": 0, "misses": 0, "fallbacks": Counter()}

_PLAIN = (bool, int, float, complex, str, bytes, type, types.CodeType, torch.dtype, torch.device)


class _Ref:
    """A key part that compares by identity. It holds its object by a weak
    reference where the object takes one (strongly otherwise), so a dead
    object matches nothing, not even a new one at its old `id`."""

    __slots__ = ("ref", "hash")

    def __init__(self, obj):
        try:
            self.ref = weakref.ref(obj)
        except TypeError:
            self.ref = lambda: obj
        self.hash = id(obj)

    def __eq__(self, other) -> bool:
        if not isinstance(other, _Ref):
            return False
        obj = self.ref()
        return obj is not None and obj is other.ref()

    def __hash__(self) -> int:
        return self.hash


def _value_key(x: Any, depth: int = _KEY_DEPTH) -> Any:
    """The key of a value that the source reads: a tensor as above,
    numbers and strings by value, functions by their code and what they
    capture, containers and pytrees by their parts, anything else by
    identity."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cpu" and 0 < x.numel() <= _VALUE_INLINE_MAX_ELEMS:
            with DisableTorchFunctionSubclass():
                raw = x.detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes()
            return (tuple(x.shape), x.dtype, raw)
        return (tuple(x.shape), x.dtype, _Ref(x), x._version)
    if x is None or isinstance(x, _PLAIN):
        return (type(x), x)
    if depth <= 0:
        return (type(x), _Ref(x))
    if isinstance(x, _Fn):
        x = x.fn
    if isinstance(x, types.FunctionType):
        return _fn_key(x, depth - 1)
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_value_key(v, depth - 1) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((_value_key(k, depth - 1), _value_key(v, depth - 1)) for k, v in x.items()))
    node = pytree.SUPPORTED_NODES.get(type(x))
    if node is not None:  # one level of the node: its context and children
        children, context = node.flatten_fn(x)
        return (type(x), _value_key(context, depth - 1), tuple(_value_key(v, depth - 1) for v in children))
    return (type(x), _Ref(x))


def _fn_key(f: types.FunctionType, depth: int) -> tuple:
    """A function as a trace's structure compares it (`core/pytree.py::_Fn`:
    the same code and globals, equal defaults and closure cells), with the
    tensors among its defaults and cells keyed by value as above: a model
    that builds its callee in its body (`mix(f, g)` at a site) makes a new
    function object at every run, which JAX stages once per trace and the
    port would otherwise analyze at every edit."""
    cells = []
    for c in f.__closure__ or ():
        try:
            v = c.cell_contents
        except ValueError:  # an empty cell
            cells.append(("empty",))
            continue
        # A function that captures itself (a recursive helper) by its code.
        cells.append(("self", f.__code__) if v is f else _value_key(v, depth))
    return (
        types.FunctionType, f.__code__, _Ref(f.__globals__),
        _value_key(f.__defaults__, depth), _value_key(f.__kwdefaults__, depth), tuple(cells),
    )


def _aval_key(x: Any) -> Any:
    """The key of the call's arguments: their structure, with each tensor
    by its shape and dtype and any other leaf by its type."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_aval_key(v) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((_value_key(k), _aval_key(v)) for k, v in x.items()))
    node = pytree.SUPPORTED_NODES.get(type(x))
    if node is not None:
        children, context = node.flatten_fn(x)
        return (type(x), _value_key(context), tuple(_aval_key(v) for v in children))
    return type(x)


def cache_key(source, args) -> tuple:
    """The specialization identity of `(source, args)`, as JAX's
    `site_graph` keys it: the source's function, the structure, shapes,
    dtypes and values of its applied arguments (`_value_key`), and the
    structure, shapes and dtypes of the call's arguments (`_aval_key`)."""
    fn = source.fn
    return (
        _fn_key(fn, _KEY_DEPTH) if isinstance(fn, types.FunctionType) else _value_key(fn),
        _value_key(tuple(source.dyn_args)),
        _aval_key(args),
    )


def note_fallback(reason: str) -> None:
    """Count an edit that took the dense plan, with why."""
    _STATS["fallbacks"][reason] += 1


def stats() -> dict:
    """The analysis's record since import (or `reset_stats`): `analyses`
    (runs of the source on placeholders), cache `hits` and `misses`, and
    `fallbacks`, the edits that took the dense plan, by reason."""
    return {**_STATS, "fallbacks": dict(_STATS["fallbacks"])}


def reset_stats() -> None:
    _STATS.update(analyses=0, hits=0, misses=0, fallbacks=Counter())


def site_graph(source, args) -> SiteGraph:
    """The cached site graph of `source` called with `args` (a `Closure`
    and an argument tuple). Raises `AnalysisEnded` (or the run's own
    error) where the analysis cannot follow the source; the failure is
    cached too, since it depends on nothing the key leaves out."""
    key = cache_key(source, args)
    hit = _CACHE.get(key)
    if hit is None:
        _STATS["misses"] += 1
        _STATS["analyses"] += 1
        # A failure is kept as its message: an exception's traceback would
        # hold the frames of the run, and with them the caller's data.
        try:
            hit = _analyze(source, args)
        except AnalysisEnded as e:
            hit = str(e)
        except Exception as e:  # noqa: BLE001 - any failure of the run means "dense"
            hit = f"{type(e).__name__}: {(str(e).splitlines() or [''])[0][:160]}"
        while len(_CACHE) >= _CACHE_MAX_ENTRIES:
            _CACHE.pop(next(iter(_CACHE)))
        _CACHE[key] = hit
    else:
        _STATS["hits"] += 1
    if isinstance(hit, str):
        raise AnalysisEnded(hit)
    return hit


def static_touched_addresses(constraint) -> frozenset | None:
    """The top-level addresses that a constraint touches, where that is
    known without running anything (None: unknown, treat every site as
    touched)."""
    from genjax_tpu_torch.core.choice_map import Or, Static

    match constraint:
        case Static(children):
            return frozenset(children.keys())
        case Or(c1, c2):
            a = static_touched_addresses(c1)
            b = static_touched_addresses(c2)
            if a is None or b is None:
                return None
            return a | b
        case _:
            if constraint.static_is_empty():
                return frozenset()
            return None


def static_selected_addresses(selection, site_order) -> frozenset | None:
    """Which of `site_order`'s addresses a selection selects, where that is
    known without running anything (None: unknown)."""
    from genjax_tpu_torch.core.choice_map import (
        AllSel,
        AndSel,
        ComplementSel,
        LeafSel,
        NoneSel,
        OrSel,
        StaticSel,
    )

    def is_static(sel) -> bool:
        match sel:
            case AllSel() | NoneSel() | LeafSel():
                return True
            case StaticSel(s, _):
                return is_static(s)
            case OrSel(s1, s2) | AndSel(s1, s2):
                return is_static(s1) and is_static(s2)
            case ComplementSel(s):
                return is_static(s)
            case _:
                return False

    if not is_static(selection):
        return None
    # An address is touched unless its subselection is statically none.
    return frozenset(addr for addr in site_order if not isinstance(selection(addr), NoneSel))
