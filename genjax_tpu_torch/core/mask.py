"""`Mask`: a value paired with a boolean validity flag.

Counterpart of `genjax_tpu/core/mask.py`: `build`, `maybe_mask`,
indexing, `flatten`, `unmask`, `primal_flag`, and the `|` / `^` / `~`
algebra with `or_n` / `xor_n`.

A flag is a Python bool (known when the mask is built) or a boolean
tensor. Both halves keep the batch-axis record of `core/typing.py`: each
leaf of the value has a depth (how many leading batch axes it carries,
counted from the innermost), and so has the flag. The axes of the flag
past its batch axes, where it has any, are a prefix of the value's axes
past its own: a stacked `Scan` step axis, or a `Vmap`'s lane axis seen
from outside. So a flag lines up with a value leaf by its batch axes from
the right and by the rest from the left, and every operation here is one
`where` per leaf. With nothing batched (every depth 0) this is JAX's rule:
the flag's shape is a prefix of every leaf's.

A caller that builds a `Mask` from tensors marked with `per_particle` (or
the deeper marks) gets their depths read from the marks; the port's own
code passes the record explicitly.
"""

from typing import Any, Generic, TypeVar

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.checkify import should_check
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import depth_of, plain

R = TypeVar("R")


def _rank(x: Any) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else 0


def flag_on(flag: Any, flag_depth: int, leaf: Any, depth: int) -> Any:
    """`flag` shaped to select whole entries of `leaf` (which carries
    `depth` batch axes): trailing unit axes for the leaf's axes that the
    flag does not cover. A bool passes through."""
    if not isinstance(flag, torch.Tensor):
        return flag
    pad = (_rank(leaf) - depth) - (flag.dim() - flag_depth)
    if pad < 0:
        raise ValueError(
            f"a flag of shape {tuple(flag.shape)} (depth {flag_depth}) covers more axes than a value of "
            f"shape {tuple(getattr(leaf, 'shape', ()))} (depth {depth})"
        )
    return flag.reshape(flag.shape + (1,) * pad) if pad else flag


def combine_flags(op, f1: Any, d1: int, f2: Any, d2: int) -> tuple[Any, int]:
    """`op(f1, f2)` of two flags with their depths, lined up as `flag_on`
    lines a flag up with a value; concrete bools short-circuit."""
    if isinstance(f1, bool) and isinstance(f2, bool):
        return op(f1, f2), 0
    d1 = d1 if isinstance(f1, torch.Tensor) else 0
    d2 = d2 if isinstance(f2, torch.Tensor) else 0
    e1, e2 = _rank(f1) - d1, _rank(f2) - d2
    e = max(e1, e2)
    if isinstance(f1, torch.Tensor) and e1 < e:
        f1 = f1.reshape(f1.shape + (1,) * (e - e1))
    if isinstance(f2, torch.Tensor) and e2 < e:
        f2 = f2.reshape(f2.shape + (1,) * (e - e2))
    return op(f1, f2), max(d1, d2)


def _and(a, b):
    if a is False or b is False:
        return False
    if a is True:
        return b
    return a if b is True else a & b


def _or(a, b):
    if a is True or b is True:
        return True
    if a is False:
        return b
    return a if b is False else a | b


def _xor(a, b):
    if isinstance(a, bool) and isinstance(b, bool):
        return a ^ b
    if a is False:
        return b
    if b is False:
        return a
    if a is True:
        return ~b
    if b is True:
        return ~a
    return a ^ b


def _not(a):
    return (not a) if isinstance(a, bool) else ~a


def select(flag: Any, flag_depth: int, a: Any, da: int, b: Any, db: int) -> tuple[Any, int]:
    """`a` where `flag` holds, else `b` (two leaves of the same event
    shape, with their depths); the result and its depth. No arithmetic on
    the values, so a `-inf` or NaN on the side not taken stays out."""
    if flag is True:
        return a, da
    if flag is False:
        return b, db
    deep = a if _rank(a) - da >= _rank(b) - db else b
    f = flag_on(flag, flag_depth, deep, da if deep is a else db)
    # A Python number stays one (`torch.where` takes it as a scalar), so
    # that no value is copied from the host to the flag's device.
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.dtype != b.dtype:
        dtype = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dtype), b.to(dtype)
    return torch.where(f, a, b), max(da, db, flag_depth)


@Pytree.dataclass
class Mask(Generic[R], Pytree):
    """A value with a boolean validity flag. A `False` flag marks data that
    must not take part in inference; a tensor flag masks entry by entry.

    >>> import torch
    >>> from genjax_tpu_torch.core.mask import Mask
    >>> m = Mask(3.0, torch.tensor(True))
    >>> float(m.unmask())
    3.0
    >>> invalid = Mask(9.0, torch.tensor(False))
    >>> float(invalid.unmask(default=-1.0))
    -1.0
    >>> merged = invalid | m
    >>> float(merged.unmask()), bool(merged.primal_flag())
    (3.0, True)
    >>> Mask(torch.arange(3.0), torch.tensor([True, False, True])).unmask(default=0.0).tolist()
    [0.0, 0.0, 2.0]
    """

    value: Any
    flag: Any
    record: tuple = Pytree.static(default=())  # the depth of each leaf of `value`
    flag_depth: int = Pytree.static(default=0)

    def __init__(self, value: Any, flag: Any = True, record: tuple | None = None, flag_depth: int | None = None):
        if isinstance(value, Mask):
            raise AssertionError("Refusing to nest a Mask directly inside a Mask; compose flags with Mask.build instead.")
        if record is None:
            leaves, spec = pytree.tree_flatten(value)
            record = tuple(depth_of(v) for v in leaves)
            if any(record):
                value = pytree.tree_unflatten([plain(v) for v in leaves], spec)
        if flag_depth is None:
            flag_depth = depth_of(flag)
            flag = plain(flag)
        if isinstance(flag, torch.Tensor) and flag.dtype != torch.bool:
            flag = flag.to(torch.bool)
        object.__setattr__(self, "value", value)
        object.__setattr__(self, "flag", flag)
        object.__setattr__(self, "record", tuple(record))
        object.__setattr__(self, "flag_depth", int(flag_depth) if isinstance(flag, torch.Tensor) else 0)
        self._check_flag_covers()

    def _check_flag_covers(self) -> None:
        """The flag's axes past its batch axes must lead every leaf's axes
        past the leaf's own batch axes."""
        f = self.flag
        if not isinstance(f, torch.Tensor) or f.dim() == self.flag_depth:
            return
        events = tuple(f.shape[self.flag_depth :])
        bad = [
            tuple(v.shape)
            for v, d in zip(pytree.tree_leaves(self.value), self.record)
            if tuple(getattr(v, "shape", ())[d : d + len(events)]) != events
        ]
        if bad:
            raise ValueError(
                f"A mask flag of shape {tuple(f.shape)} does not cover the leading axes of every value leaf "
                f"(offending leaf shapes: {bad})."
            )

    # -- the record ----------------------------------------------------------

    @property
    def depth(self) -> int:
        """The depth of the value (the deepest of its leaves)."""
        return max(self.record, default=0)

    def batched_leaves(self) -> list[int]:
        return list(self.record) + [self.flag_depth]

    # -- constructors --------------------------------------------------------

    @staticmethod
    def build(v: Any, f: Any = True, flag_depth: int | None = None, record: tuple | None = None) -> "Mask":
        """A mask of `v` by `f`; where `v` is a mask already, the flags
        combine by AND."""
        if flag_depth is None:
            flag_depth = depth_of(f)
            f = plain(f)
        if not isinstance(v, Mask):
            return Mask(v, f, record, flag_depth)
        flag, depth = combine_flags(_and, f, flag_depth, v.flag, v.flag_depth)
        return Mask(v.value, flag, v.record, depth)

    @staticmethod
    def maybe_mask(v: Any, f: Any) -> Any:
        """Like `build`, but the raw value where the flag is a concrete
        True and None where it is a concrete False."""
        return Mask.build(v, f).flatten()

    # -- accessors -----------------------------------------------------------

    def __getitem__(self, path) -> "Mask":
        """Index the axes past the batch axes: the flag's own such axes
        take the leading part of `path`, each leaf the whole `path`."""
        path = path if isinstance(path, tuple) else (path,)
        flag, fd = self.flag, self.flag_depth
        if isinstance(flag, torch.Tensor) and flag.dim() > fd:
            k = min(len(path), flag.dim() - fd)
            flag = flag[(slice(None),) * fd + path[:k]]
        leaves, spec = pytree.tree_flatten(self.value)
        out = [v[(slice(None),) * d + path] if _rank(v) > d else v for v, d in zip(leaves, self.record)]
        return Mask.build(pytree.tree_unflatten(out, spec), flag, fd, self.record)

    def flatten(self) -> Any:
        if self.flag is False:
            return None
        if self.flag is True:
            return self.value
        return self

    def unmask(self, default: Any = None) -> Any:
        """The value; with `default`, the default where the flag does not
        hold. Without one, the flag is not read (the caller vouches for it,
        as JAX's unchecked `unmask` does) except inside `do_checkify()`,
        where a flag that does not hold everywhere raises."""
        if default is None:
            if should_check() and not bool(torch.all(torch.as_tensor(self.flag))):
                raise ValueError(
                    "Mask.unmask() without a default, but the flag (or some entry of a batched flag) "
                    "is False: the extracted value is not meaningful."
                )
            return self.value
        leaves, spec = pytree.tree_flatten(self.value)
        defaults = pytree.tree_leaves(default) if pytree.tree_structure(default) == spec else [default] * len(leaves)
        out = [select(self.flag, self.flag_depth, v, d, dv, 0)[0] for v, d, dv in zip(leaves, self.record, defaults)]
        return pytree.tree_unflatten(out, spec)

    def primal_flag(self) -> Any:
        return self.flag

    # -- combinators ---------------------------------------------------------

    def _check_combinable(self, other: "Mask") -> None:
        a_leaves, a_spec = pytree.tree_flatten(self.value)
        b_leaves, b_spec = pytree.tree_flatten(other.value)
        if a_spec != b_spec:
            raise ValueError("Mask combination requires operands with identical pytree structure.")
        bad = []
        for a, da, b, db in zip(a_leaves, self.record, b_leaves, other.record):
            ea, eb = tuple(getattr(a, "shape", ())[da:]), tuple(getattr(b, "shape", ())[db:])
            if ea != eb:
                bad.append((ea, eb))
        if bad:
            raise ValueError(f"Mask combination requires matching leaf shapes; found mismatches {bad}.")

    def _selected(self, other: "Mask", flag: Any, flag_depth: int) -> "Mask":
        """Self's value where `self.flag` holds, else other's, flagged by
        `flag`."""
        a_leaves, spec = pytree.tree_flatten(self.value)
        b_leaves = pytree.tree_leaves(other.value)
        picked = [
            select(self.flag, self.flag_depth, a, da, b, db)
            for a, da, b, db in zip(a_leaves, self.record, b_leaves, other.record)
        ]
        return Mask(pytree.tree_unflatten([v for v, _ in picked], spec), flag, tuple(d for _, d in picked), flag_depth)

    def __or__(self, other: "Mask") -> "Mask":
        """Left-biased union: self where valid, else other."""
        self._check_combinable(other)
        if self.flag is True:
            return self
        if self.flag is False:
            return other
        flag, depth = combine_flags(_or, self.flag, self.flag_depth, other.flag, other.flag_depth)
        return self._selected(other, flag, depth)

    def __xor__(self, other: "Mask") -> "Mask":
        """Exclusive union: valid where exactly one operand is; keeps that one."""
        self._check_combinable(other)
        f1, f2 = self.flag, other.flag
        if f1 is True and f2 is False:
            return self
        if f1 is False and f2 is True:
            return other
        if isinstance(f1, bool) and isinstance(f2, bool):
            return Mask.build(self, False)
        flag, depth = combine_flags(_xor, f1, self.flag_depth, f2, other.flag_depth)
        return self._selected(other, flag, depth)

    def __invert__(self) -> "Mask":
        return Mask(self.value, _not(self.flag), self.record, self.flag_depth)

    @staticmethod
    def or_n(mask: "Mask", *masks: "Mask") -> "Mask":
        acc = mask
        for m in masks:
            acc = acc | m
        return acc

    @staticmethod
    def xor_n(mask: "Mask", *masks: "Mask") -> "Mask":
        acc = mask
        for m in masks:
            acc = acc ^ m
        return acc


__all__ = ["Mask", "combine_flags", "flag_on", "select"]
