"""Whole-API runtime type checks, on by default.

Counterpart of `genjax_tpu/core/typecheck.py`. `instrument(module)` wraps
the public API that a facade module exports (the package root calls it
last, as JAX's does), so that a malformed argument raises a `TypeError`
naming the method and the parameter: a dict where a `ChoiceMap` belongs, a
`ChoiceMap` where a `Selection` belongs, arguments not packed in a tuple,
a raw int seed where a `torch.Generator` belongs. Only annotations whose
violation is a real mistake are enforced, with JAX's predicates:

- framework classes (`ChoiceMap`, `Selection`, `Trace`, `EditRequest`,
  `GenerativeFunction`, `Mask`, `Diff`, ...);
- `tuple` (model `args` not packed in a tuple);
- a parameter named `rng` annotated `torch.Generator` (JAX's `key`);
- `Callable`;
- unions of these (and `None`).

Tensors, numbers and anything else are left to torch's own errors: a
tensor annotation accepts tensors (functorch's wrapped tensors under
`torch.func` transforms included), numpy values and Python numbers.

In eager PyTorch a wrapper runs at every call, not once per trace as in
JAX, so each one is a short loop over a list precomputed from the
signature, with no `inspect.Signature.bind` per call. `do_typecheck(False)`
takes the wrappers off the classes and the package root (the original
functions go back in place); `checked_mode()` puts them back while it is
active. `entries()` counts the calls that went through a wrapper.

>>> import torch
>>> import genjax_tpu_torch as gx
>>> @gx.gen
... def m():
...     return gx.normal(0.0, 1.0) @ "x"
>>> try:
...     m.simulate(42, ())
... except TypeError as e:
...     print(str(e).split(";")[0])
StaticGenerativeFunction.simulate: parameter `rng` expected a torch.Generator (torch.Generator(device=...).manual_seed(seed))
"""

import collections.abc
import functools
import inspect
import types
import typing
from typing import Any, Callable, Union

import numpy as np
import torch

from genjax_tpu_torch.core import checked
from genjax_tpu_torch.core.typing import nobeartype

_MARK = "__gx_typechecked__"

# On by default, as in JAX. `do_typecheck(False)` turns it off.
_ENABLED = True
# Whether the wrappers are in place now: `_ENABLED or checked.is_checked()`.
_ACTIVE = True
# (id(owner), name) -> (owner, name, original attribute, wrapped attribute).
_INSTALLED: dict = {}
_ENTRIES = 0


@nobeartype  # the switch stays out of the wrappers it switches
def do_typecheck(enable: bool = True) -> None:
    """Globally enable/disable the always-on public-API argument checks
    (independent of the deeper opt-in `checked_mode()` validation, which
    forces them on while active)."""
    global _ENABLED
    _ENABLED = enable
    sync()


def is_typechecked() -> bool:
    return _ENABLED or checked.is_checked()


def sync() -> None:
    """Put the wrappers in place, or the original functions back, as
    `is_typechecked()` says."""
    global _ACTIVE
    active = is_typechecked()
    if active == _ACTIVE:
        return
    _ACTIVE = active
    for owner, name, original, wrapped in _INSTALLED.values():
        setattr(owner, name, wrapped if active else original)


def entries() -> int:
    """How many calls have gone through a wrapper since import."""
    return _ENTRIES


# Accepted wherever a tensor or a number is annotated: a Python number
# where a tensor is annotated is legitimate (torch promotes it).
_ARRAYLIKE = (torch.Tensor, np.ndarray, np.generic, bool, int, float)


def _is_framework_class(ann: Any) -> bool:
    return inspect.isclass(ann) and getattr(ann, "__module__", "").startswith("genjax_tpu_torch")


def _predicate(ann: Any, param_name: str):
    """Map an annotation to `(types, description)`, where a value passes
    when `isinstance(value, types)`, or to None when the annotation cannot
    be enforced without false positives."""
    if ann is inspect.Parameter.empty or ann is Any:
        return None
    origin = typing.get_origin(ann)
    if origin in (Union, types.UnionType):
        parts = [
            ((type(None),), "None") if a is type(None) else _predicate(a, param_name) for a in typing.get_args(ann)
        ]
        if any(p is None for p in parts):
            return None  # a single arm that cannot be enforced makes the union moot
        return (tuple(t for ts, _ in parts for t in ts), " | ".join(d for _, d in parts))
    if origin is not None:
        # A generic alias: enforce its origin only (Trace[R] -> Trace,
        # tuple[...] -> tuple); a Callable alias checks callability.
        if origin is collections.abc.Callable:
            return ((collections.abc.Callable,), "a callable")
        if _is_framework_class(origin) or origin is tuple:
            return ((origin,), origin.__name__)
        return None
    if ann is tuple:
        if param_name == "argdiffs":
            # A tuple of (possibly Diff-wrapped) values, or a Diff of the
            # whole argument tuple: `Diff.tree_primal` takes both.
            from genjax_tpu_torch.core.diff import Diff

            return ((tuple, Diff), "tuple of argdiffs (or a Diff of the argument tuple)")
        return ((tuple,), "tuple")
    if ann is torch.Generator and param_name == "rng":
        return ((torch.Generator,), "a torch.Generator (torch.Generator(device=...).manual_seed(seed))")
    if ann is torch.Tensor:
        return (_ARRAYLIKE, "a tensor or scalar")
    if ann in (bool, int, float):
        return (_ARRAYLIKE, f"{ann.__name__} (or a tensor)")
    if _is_framework_class(ann):
        return ((ann,), ann.__name__)
    return None


def _hint(desc: str, value: Any) -> str:
    """A fix for the classic mistakes (as `core/checked.py`'s messages)."""
    if desc == "tuple":
        return ". Model arguments must be the argument TUPLE: use `(x,)` for a single argument, `()` for none."
    if "ChoiceMap" in desc and isinstance(value, dict):
        return ". Build one with `ChoiceMap.kw(addr=value)` or `ChoiceMap.d`."
    if "Selection" in desc:
        return ". Build one with `Selection.at[addr]` / `Selection.all()`."
    return ""


def _wrap(fn: Callable, qualname: str) -> Callable:
    """`fn` wrapped with its checks, or `fn` itself when nothing on its
    signature can be enforced."""
    if getattr(fn, _MARK, False):
        return fn
    try:
        hints = typing.get_type_hints(fn)
        sig = inspect.signature(fn)
    except Exception:
        return fn
    # (positional index or None, name, accepted types, description), so
    # that a call is a short loop of `isinstance` tests.
    checks = []
    pos = 0
    for name, param in sig.parameters.items():
        if param.kind is param.VAR_POSITIONAL:
            pos = None  # everything after *args is keyword-only
            continue
        if param.kind is param.VAR_KEYWORD:
            continue
        idx = None
        if param.kind in (param.POSITIONAL_ONLY, param.POSITIONAL_OR_KEYWORD):
            idx = pos
            if pos is not None:
                pos += 1
        pred = _predicate(hints.get(name, param.annotation), name)
        if pred is not None:
            checks.append((idx, name, pred[0], pred[1]))
    if not checks:
        return fn

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global _ENTRIES
        _ENTRIES += 1
        if _ACTIVE:
            n = len(args)
            for idx, name, types_, desc in checks:
                if idx is not None and idx < n:
                    v = args[idx]
                elif kwargs and name in kwargs:
                    v = kwargs[name]
                else:
                    continue  # defaulted: nothing to check
                if not isinstance(v, types_):
                    raise TypeError(
                        f"{qualname}: parameter `{name}` expected {desc}; got {type(v).__name__}: {v!r}"
                        f"{_hint(desc, v)}"
                    )
        return fn(*args, **kwargs)

    setattr(wrapper, _MARK, True)
    return wrapper


def _install(owner: Any, name: str, original: Any, wrapped: Any) -> None:
    _INSTALLED[(id(owner), name)] = (owner, name, original, wrapped)
    setattr(owner, name, wrapped if _ACTIVE else original)


def _instrument_class(cls: type) -> int:
    """Wrap the public methods a class itself defines; inherited ones are
    wrapped on the class that defines them. Returns how many."""
    n = 0
    for name, member in list(vars(cls).items()):
        if name.startswith("_") or (id(cls), name) in _INSTALLED:
            continue
        qual = f"{cls.__name__}.{name}"
        if isinstance(member, (staticmethod, classmethod)):
            wrapped = _wrap(member.__func__, qual)
            if wrapped is not member.__func__:
                _install(cls, name, member, type(member)(wrapped))
                n += 1
        elif inspect.isfunction(member):
            wrapped = _wrap(member, qual)
            if wrapped is not member:
                _install(cls, name, member, wrapped)
                n += 1
    return n


def instrument(module) -> int:
    """Instrument a facade module's exported API in place.

    Walks `module.__all__`: exported framework classes get their public
    methods wrapped (on the class, so every alias sees the checks), and so
    does every framework subclass defined by then; exported plain
    functions are wrapped and rebound on the module. Idempotent. Returns
    the number of callables wrapped."""
    n = 0
    seen: set[int] = set()
    done_classes: set[int] = set()
    for name in getattr(module, "__all__", []):
        obj = getattr(module, name, None)
        if obj is None or id(obj) in seen:
            continue
        seen.add(id(obj))
        if inspect.isclass(obj) and _is_framework_class(obj):
            stack = [obj]
            while stack:
                cls = stack.pop()
                if id(cls) in done_classes:
                    continue
                done_classes.add(id(cls))
                n += _instrument_class(cls)
                stack.extend(c for c in cls.__subclasses__() if _is_framework_class(c))
        elif inspect.isfunction(obj) and (id(module), name) not in _INSTALLED:
            wrapped = _wrap(obj, name)
            if wrapped is not obj:
                _install(module, name, obj, wrapped)
                n += 1
    return n
