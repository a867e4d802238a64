"""Addressed sample storage: `ChoiceMap` and `Selection`, with static and
indexed addresses.

Counterpart of `genjax_tpu/core/choice_map.py`. A choice map is a trie:
`Static` nodes map string components to sub-maps, `Choice` leaves hold
values, `Indexed` nests a map under an integer index (a Python int, a 0-d
integer tensor, or a 1-d tensor pairing each leading row of the sub-map's
leaves with an index), `Or` is a left-priority union. The trie's keys live
in the pytree context, so resolving a string address costs nothing on the
device.

A `Choice` records its depth: how many leading batch axes its value
carries (0: shared by every particle; 1: the particle axis; more under a
`Vmap`, see `core/typing.py`). The record is set where the value is made
(a trace's draw, or a value marked with `core.typing.per_particle`), never
read off its size.

The choices of a `Vmap` or `Scan` trace are stored stacked: `chm["x"]` is
the whole array, with the lane or step axis right after the batch axes,
and an index component addresses that axis: `chm[i, "x"]`, `chm(i)`.
`S[i, "x"]` selects one lane or step, `S[..., "x"]` every one.

A value that holds only where a flag does is a `Mask` (`core/mask.py`)
at a `Choice`; a selection that holds only where a flag does is a
`MaskedSel`. Both arise where a question has a different answer per
particle or per lane: a combinator that runs every lane at once asks
about all of them in one call (`at_lanes`), and "which lanes hold a
value" or "which lanes are selected" is then a boolean tensor over the
lanes; `ChoiceMap.mask(flag)` and the `Switch` node (one sub-map per
branch, each masked by `idx == i`) carry the flags of the `mask` and
`switch` combinators. The builder `ChoiceMap.builder` /
`ChoiceMapBuilder` nests a value at an address: `C["x", "y"].set(v)`.
"""

from types import EllipsisType
from typing import Any, Iterable

import torch

from genjax_tpu_torch.core import checked
from genjax_tpu_torch.core.mask import Mask, _and, _not, _or
from genjax_tpu_torch.core.pytree import Pytree, n_leaves
from genjax_tpu_torch.core.typing import Flag, depth_of, plain

StaticAddressComponent = str
DynamicAddressComponent = int | slice | torch.Tensor
AddressComponent = DynamicAddressComponent | StaticAddressComponent
Address = tuple[AddressComponent, ...] | AddressComponent
StaticAddress = tuple[StaticAddressComponent, ...] | StaticAddressComponent
ExtendedAddressComponent = EllipsisType | AddressComponent

_full_slice = slice(None)


def _tuplize(addr) -> tuple:
    return addr if isinstance(addr, tuple) else (addr,)


def _is_index_tensor(comp) -> bool:
    return isinstance(comp, torch.Tensor) and not comp.is_floating_point() and comp.dtype != torch.bool


def _is_scalar_component(comp) -> bool:
    if isinstance(comp, bool):
        return False
    return isinstance(comp, int) or (_is_index_tensor(comp) and comp.dim() == 0)


def _is_full_slice(comp) -> bool:
    return isinstance(comp, slice) and comp == _full_slice


def _validate_addr(addr: tuple, allow_partial_slice: bool = False) -> tuple:
    """Check the shape grammar of an address's index components.

    String components are transparent. The index components must be, in
    order: a run of scalars (ints, 0-d integer tensors); at most one
    fan-out component (a 1-d index tensor, or a partial slice when
    `allow_partial_slice`); then only full slices. Anything else cannot be
    resolved against dense leaf storage in one gather."""
    in_scalar_prefix = True
    for comp in addr:
        if isinstance(comp, str) or comp is ...:
            continue
        if not (isinstance(comp, (int, slice)) and not isinstance(comp, bool)) and not _is_index_tensor(comp):
            raise TypeError(
                f"Address components are strings, ints, integer tensors, slices or `...`; "
                f"got {comp!r} of type {type(comp).__name__}."
            )
        if in_scalar_prefix:
            if _is_scalar_component(comp):
                continue
            in_scalar_prefix = False
            if isinstance(comp, torch.Tensor):
                if comp.dim() != 1:
                    raise ValueError(f"An index tensor in an address is 0-d or 1-d; got shape {tuple(comp.shape)}.")
                continue
            if allow_partial_slice and not _is_full_slice(comp):
                continue
        if not _is_full_slice(comp):
            grammar = (
                "scalars, then at most one index tensor or partial slice, then full slices"
                if allow_partial_slice
                else "scalars, then at most one index tensor, then full slices"
            )
            raise ValueError(
                f"Unresolvable address {addr!r}: expected {grammar}; component {comp!r} breaks the grammar."
            )
    return addr


def _host_int(comp) -> int | None:
    """An index component as a Python int where the host can read it for
    free (an int, or a 0-d CPU tensor); None for a tensor on a device."""
    if isinstance(comp, int):
        return comp
    if isinstance(comp, torch.Tensor) and comp.dim() == 0 and comp.device.type == "cpu":
        return int(comp)
    return None


# Flags are Python bools where the answer is known when the map or the
# selection is built, and boolean tensors otherwise. A selection's flag
# carries batch axes only, aligned to the innermost (its depth is its
# rank).


def _deeper(flag):
    """A flag over the lanes of the enclosing levels, seen from one lane
    level further in: flags stay aligned to the innermost batch axis."""
    return flag.unsqueeze(-1) if isinstance(flag, torch.Tensor) else flag


##############
# Selections #
##############


class _SelectionBuilder:
    def __getitem__(self, addr) -> "Selection":
        # Subtree semantics: S[p] selects p and everything beneath it;
        # S[()] selects this node only.
        path = _tuplize(addr)
        if not path:
            return Selection.leaf()
        return Selection.all().extend(*path)


class Selection(Pytree):
    """An address-set algebra: `sel(addr)` is the sub-selection at `addr`,
    `sel[addr]` / `addr in sel` whether `addr` is selected, `~sel` the
    complement, `|` and `&` union and intersection. The wildcard `...`
    matches zero or one address components, so `S[..., "z"]` addresses
    both a stacked trie's flat `"z"` and the `(step, "z")` space of
    `Scan` and `Vmap` edits.

    >>> from genjax_tpu_torch.core.choice_map import Selection
    >>> sel = Selection.at["x"] | Selection.at[2, "y"]
    >>> "x" in sel, "y" in sel, "y" in ~sel, (2, "y") in sel, (1, "y") in sel
    (True, False, True, True, False)
    >>> (3, "z") in Selection.at[..., "z"], "z" in Selection.at[..., "z"]
    (True, True)
    """

    at = _SelectionBuilder()

    @staticmethod
    def all() -> "Selection":
        return AllSel()

    @staticmethod
    def none() -> "Selection":
        return NoneSel()

    @staticmethod
    def leaf() -> "Selection":
        return LeafSel()

    def __invert__(self) -> "Selection":
        return ComplementSel.build(self)

    def __or__(self, other: "Selection") -> "Selection":
        if checked.is_checked():
            checked.check_selection(other, "Selection.__or__")
        return OrSel.build(self, other)

    def __and__(self, other: "Selection") -> "Selection":
        if checked.is_checked():
            checked.check_selection(other, "Selection.__and__")
        return AndSel.build(self, other)

    def filter(self, sample: "ChoiceMap") -> "ChoiceMap":
        """The part of `sample` that this selection selects."""
        if checked.is_checked():
            checked.check_choice_map(sample, "Selection.filter", what="sample")
        return sample.filter(self)

    def extend(self, *addrs: ExtendedAddressComponent) -> "Selection":
        nested = self
        for comp in reversed(addrs):
            if not (isinstance(comp, str) or comp is ... or _is_scalar_component(comp)):
                raise TypeError(
                    f"A selection's address components are strings, ints, 0-d integer tensors "
                    f"or `...`; got {comp!r} of type {type(comp).__name__}."
                )
            nested = nested if isinstance(nested, NoneSel) else StaticSel(nested, comp)
        return nested

    def __call__(self, addr) -> "Selection":
        sub = self
        for comp in _tuplize(addr):
            sub = sub.get_subselection(comp)
        return sub

    def __getitem__(self, addr) -> bool:
        return self(addr).check()

    def __contains__(self, addr) -> bool:
        return self[addr]

    def check(self):
        """Whether this node is selected: a bool, or a boolean tensor over
        the lanes after `at_lanes`."""
        raise NotImplementedError

    def get_subselection(self, addr) -> "Selection":
        raise NotImplementedError

    def at_lanes(self, lanes: torch.Tensor) -> "Selection":
        """The sub-selection at every index of `lanes` (a 1-d tensor,
        `arange(N)` on the device) at once: `check()` of what comes back
        is a boolean tensor over the lanes where the answer differs from
        lane to lane."""
        return self.get_subselection(lanes)


@Pytree.dataclass
class AllSel(Selection):
    def check(self) -> bool:
        return True

    def get_subselection(self, addr) -> Selection:
        return self


@Pytree.dataclass
class NoneSel(Selection):
    def check(self) -> bool:
        return False

    def get_subselection(self, addr) -> Selection:
        return self


@Pytree.dataclass
class LeafSel(Selection):
    def check(self) -> bool:
        return True

    def get_subselection(self, addr) -> Selection:
        return NoneSel()


@Pytree.dataclass
class ComplementSel(Selection):
    s: Selection

    @staticmethod
    def build(s: Selection) -> Selection:
        if isinstance(s, AllSel):
            return NoneSel()
        if isinstance(s, NoneSel):
            return AllSel()
        if isinstance(s, ComplementSel):
            return s.s
        return ComplementSel(s)

    def check(self):
        return _not(self.s.check())

    def get_subselection(self, addr) -> Selection:
        return ~self.s(addr)


@Pytree.dataclass
class StaticSel(Selection):
    s: Selection
    addr: Any = Pytree.static()

    def check(self):
        # `...` matches zero or one levels, so a wildcard selection is
        # checked against its inner selection.
        return self.s.check() if self.addr is ... else False

    def get_subselection(self, addr) -> Selection:
        if self.addr is ...:
            # Zero levels (a stacked trie stores "z" flat) or one (an edit
            # addresses `(idx, "z")`): both at once.
            return OrSel.build(self.s, self.s(addr))
        if addr is ...:
            return self.s
        if isinstance(self.addr, str) or isinstance(addr, str):
            return self.s if isinstance(addr, str) and addr == self.addr else NoneSel()
        if isinstance(addr, torch.Tensor) and addr.dim() == 1:
            return MaskedSel.build(self.s, addr == self.addr)
        mine, theirs = _host_int(self.addr), _host_int(addr)
        if mine is not None and theirs is not None:
            return self.s if mine == theirs else NoneSel()
        return MaskedSel.build(self.s, torch.as_tensor(addr == self.addr))


@Pytree.dataclass
class MaskedSel(Selection):
    """A selection gated by a flag: it holds where `flag` is true.
    `S[i, "x"]` asked about every lane at once holds in lane `i`; asked
    with an index on the device, where the index is `i`. The flag is a
    boolean tensor over the batch axes, aligned to the innermost."""

    s: Selection
    flag: Any

    @staticmethod
    def build(s: Selection, flag) -> Selection:
        if flag is True:
            return s
        if flag is False or isinstance(s, NoneSel):
            return NoneSel()
        return MaskedSel(s, flag)

    def check(self):
        return _and(self.flag, self.s.check())

    def get_subselection(self, addr) -> Selection:
        lanes = isinstance(addr, torch.Tensor) and addr.dim() == 1
        return MaskedSel.build(self.s(addr), _deeper(self.flag) if lanes else self.flag)


@Pytree.dataclass
class AndSel(Selection):
    s1: Selection
    s2: Selection

    @staticmethod
    def build(a: Selection, b: Selection) -> Selection:
        if isinstance(a, AllSel) or isinstance(b, NoneSel):
            return b
        if isinstance(b, AllSel) or isinstance(a, NoneSel):
            return a
        return AndSel(a, b)

    def check(self):
        return _and(self.s1.check(), self.s2.check())

    def get_subselection(self, addr) -> Selection:
        return self.s1(addr) & self.s2(addr)


@Pytree.dataclass
class OrSel(Selection):
    s1: Selection
    s2: Selection

    @staticmethod
    def build(a: Selection, b: Selection) -> Selection:
        if isinstance(a, AllSel) or isinstance(b, NoneSel):
            return a
        if isinstance(b, AllSel) or isinstance(a, NoneSel):
            return b
        return OrSel(a, b)

    def check(self):
        return _or(self.s1.check(), self.s2.check())

    def get_subselection(self, addr) -> Selection:
        return self.s1(addr) | self.s2(addr)


@Pytree.dataclass
class ChmSel(Selection):
    """The addresses at which a choice map holds a value."""

    c: "ChoiceMap"

    def check(self):
        v = self.c.get_value()
        if v is None:
            return False
        return v.flag if isinstance(v, Mask) else True

    def get_subselection(self, addr) -> Selection:
        if isinstance(addr, torch.Tensor) and addr.dim() == 1:
            return ChmSel(self.c.at_lanes(addr))
        return ChmSel(self.c.get_inner_map(addr))


def statically_unmatchable_at_index_level(sel: Selection) -> bool:
    """True when `sel(i)` is `NoneSel` for every integer index `i`: the
    selection cannot address into a `Scan`'s steps or a `Vmap`'s lanes.
    The combinators raise on such a selection instead of regenerating or
    projecting nothing; use `Selection.at[..., "addr"]` or
    `Selection.at[i, "addr"]` there."""
    match sel:
        case NoneSel():
            return True
        case AllSel() | LeafSel():
            return False
        case StaticSel(_, addr):
            return isinstance(addr, str)
        case OrSel(s1, s2):
            return statically_unmatchable_at_index_level(s1) and statically_unmatchable_at_index_level(s2)
        case AndSel(s1, s2):
            return statically_unmatchable_at_index_level(s1) or statically_unmatchable_at_index_level(s2)
        case MaskedSel(s, _):
            return statically_unmatchable_at_index_level(s)
        case _:
            return False


###############
# Choice maps #
###############


class ChoiceMapNoValueAtAddress(Exception):
    pass


class _ChoiceMapBuilder:
    """The address path behind `C["x", "y"].set(v)`: each `[...]` appends
    components, and the terminal methods nest a map at the path. A builder
    reached from a map (`chm.at[...]`) merges the new entry over it, the
    new entry first.

    >>> from genjax_tpu_torch.core.choice_map import ChoiceMap, ChoiceMapBuilder as C
    >>> c = C["a", "b"].set(3.0) | C["a", "b"].set(4.0)
    >>> c["a", "b"], C["k"].switch(1, [ChoiceMap.kw(mu=0.5), ChoiceMap.kw(mu1=1.5)])["k", "mu1"]
    (3.0, 1.5)
    >>> ChoiceMap.kw(x=1.0).at["y"].set(2.0)["x"]
    1.0
    """

    def __init__(self, base: "ChoiceMap | None", path: tuple = ()):
        self.base = base
        self.path = path

    def __getitem__(self, addr) -> "_ChoiceMapBuilder":
        return _ChoiceMapBuilder(self.base, self.path + _tuplize(addr))

    def set(self, v) -> "ChoiceMap":
        entry = ChoiceMap.entry(v, *_validate_addr(self.path))
        return entry if self.base is None else entry | self.base

    def update(self, f) -> "ChoiceMap":
        """Apply `f` to what the path holds (its value, else its sub-map)
        and store the result there."""
        if self.base is None:
            current = _empty
        else:
            sub = self.base(self.path)
            held = sub.get_value()
            current = sub if held is None else held
        return self.set(f(current))

    def n(self) -> "ChoiceMap":
        return _empty

    def v(self, v) -> "ChoiceMap":
        return self.set(ChoiceMap.choice(v))

    def from_mapping(self, pairs) -> "ChoiceMap":
        return self.set(ChoiceMap.from_mapping(pairs))

    def d(self, entries: dict) -> "ChoiceMap":
        return self.set(ChoiceMap.d(entries))

    def kw(self, **entries) -> "ChoiceMap":
        return self.set(ChoiceMap.kw(**entries))

    def switch(self, idx, branches) -> "ChoiceMap":
        return self.set(ChoiceMap.switch(idx, branches))


class ChoiceMap(Pytree):
    """A functional trie of addressed random choices.

    >>> import torch
    >>> from genjax_tpu_torch.core.choice_map import ChoiceMap
    >>> chm = ChoiceMap.kw(x=1.0) | ChoiceMap.d({("sub", "y"): 2.0})
    >>> chm["x"], chm["sub", "y"], ("sub", "y") in chm
    (1.0, 2.0, True)
    >>> steps = ChoiceMap.kw(z=torch.tensor([3, 1, 4]))  # a Scan's choices, stacked
    >>> int(steps[2, "z"]), (1, "z") in steps, (0, "q") in ChoiceMap.d({(0, "q"): 1.0})
    (4, True, True)
    >>> held = ChoiceMap.kw(x=torch.tensor(1.0)).mask(torch.tensor(False))["x"]  # a Mask
    >>> float(held.value), bool(held.flag)
    (1.0, False)
    """

    builder = None  # a rootless `_ChoiceMapBuilder`, set below

    # -- abstract interface ------------------------------------------------

    def filter(self, selection: "Selection | Flag") -> "ChoiceMap":
        """The part of the map that `selection` selects; a flag instead of
        a selection masks the whole map (`mask`)."""
        raise NotImplementedError

    def get_value(self) -> Any:
        """The value at the root: a tensor or number, a `Mask` where it
        holds under a flag only, or None."""
        raise NotImplementedError

    def get_inner_map(self, addr: AddressComponent) -> "ChoiceMap":
        raise NotImplementedError

    def at_lanes(self, lanes: torch.Tensor) -> "ChoiceMap":
        """The sub-maps at every index of `lanes` (`arange(N)` on the
        values' device) at once, as one map whose values carry the lane
        axis as one more batch axis: a stacked value is taken whole, a
        value nested under an index becomes a `Mask` that holds in that
        lane alone."""
        raise NotImplementedError

    def static_is_empty(self) -> bool:
        return False

    def value_is_batched(self) -> int:
        """The depth of the value at the root: how many batch axes it
        carries (0 where it is shared)."""
        return 0

    def batched_leaves(self) -> list[int]:
        """The depth of each leaf, in `tree_leaves` order."""
        raise NotImplementedError

    def map_choices(self, f) -> "ChoiceMap":
        """The same map with each `Choice` node `c` replaced by `f(c)`."""
        raise NotImplementedError

    # -- derived interface -------------------------------------------------

    def get_submap(self, *addresses: Address) -> "ChoiceMap":
        if len(addresses) == 1 and isinstance(addresses[0], str):
            return self.get_inner_map(addresses[0])  # the common case, with no grammar to check
        flat: list = []
        for a in addresses:
            flat.extend(a) if isinstance(a, tuple) else flat.append(a)
        chm = self
        for comp in _validate_addr(tuple(flat), allow_partial_slice=True):
            chm = chm.get_inner_map(comp)
        return chm

    def has_value(self) -> bool:
        return self.get_value() is not None

    def get_selection(self) -> Selection:
        return NoneSel() if self.static_is_empty() else ChmSel(self)

    def extend(self, *addrs: AddressComponent) -> "ChoiceMap":
        nested = self
        for comp in reversed(_validate_addr(addrs)):
            nested = Static.build({comp: nested}) if isinstance(comp, str) else Indexed.build(nested, comp)
        return nested

    def mask(self, flag: Flag, depth: int | None = None) -> "ChoiceMap":
        """The same map, holding only where `flag` is true. `depth` is the
        number of batch axes the flag carries (read from its mark where
        not given)."""
        if depth is None:
            depth = depth_of(flag)
            flag = plain(flag)
        if flag is True:
            return self
        if flag is False:
            return _empty
        return self.map_choices(lambda c: c.mask(flag, depth))

    # -- constructors ------------------------------------------------------

    @staticmethod
    def empty() -> "ChoiceMap":
        return _empty

    @staticmethod
    def choice(v: Any, batched: int = 0) -> "ChoiceMap":
        """A map holding `v` at the root. A value marked with
        `per_particle` (or `batched=True`) carries the particle axis; a
        `Mask` keeps its own record."""
        if isinstance(v, Mask):
            return Choice.build(v)
        if isinstance(v, torch.Tensor):
            if v.dim() == 1 and v.shape[0] == 0:
                return _empty  # a zero-length batch carries no choices
            depth = depth_of(v)
            if depth:
                return Choice(plain(v), max(int(batched), depth))
        return Choice(v, int(batched))

    value = choice

    @staticmethod
    def entry(v: Any, *addrs: AddressComponent) -> "ChoiceMap":
        """Nest `v` (a value, dict, or existing map) under an address path."""
        if isinstance(v, dict):
            v = ChoiceMap.d(v)
        chm = v if isinstance(v, ChoiceMap) else ChoiceMap.choice(v)
        return chm.extend(*addrs)

    @staticmethod
    def from_mapping(pairs: Iterable[tuple[Address, Any]]) -> "ChoiceMap":
        acc = ChoiceMap.empty()
        for addr, v in pairs:
            acc = acc | ChoiceMap.entry(v, *_tuplize(addr))
        return acc

    @staticmethod
    def d(entries: dict) -> "ChoiceMap":
        return ChoiceMap.from_mapping(entries.items())

    @staticmethod
    def kw(**kwargs) -> "ChoiceMap":
        return ChoiceMap.d(kwargs)

    @staticmethod
    def switch(idx, chms: Iterable["ChoiceMap"], depth: int | None = None) -> "ChoiceMap":
        """Branch `i` of `chms` where `idx == i`: a Python int picks one
        branch when the map is built; an index tensor masks each branch
        (`depth`: the batch axes the index carries, read from its mark
        where not given)."""
        return Switch.build(idx, chms, depth)

    # -- dunders -----------------------------------------------------------

    def __or__(self, other: "ChoiceMap") -> "ChoiceMap":
        if checked.is_checked():
            checked.check_choice_map(other, "ChoiceMap.__or__", what="other")
        return Or.build(self, other)

    def merge(self, other: "ChoiceMap") -> "ChoiceMap":
        """The union of two maps; `self` wins where both hold a value."""
        return self | other

    def __call__(self, *addresses: Address) -> "ChoiceMap":
        return self.get_submap(*addresses)

    def __getitem__(self, addr: Address):
        v = self.get_submap(addr).get_value()
        if v is None:
            raise ChoiceMapNoValueAtAddress(addr)
        return v

    def __contains__(self, addr: Address) -> bool:
        return self.get_submap(addr).has_value()

    @property
    def at(self) -> _ChoiceMapBuilder:
        return _ChoiceMapBuilder(self)


def _index_value(v: Any, depth: int, idx) -> Any:
    """`v` at `idx` along its first axis past the batch axes; a value with
    no such axis is shared across the indexed axis and passes through."""
    if not isinstance(v, torch.Tensor) or v.dim() <= depth:
        return v
    if isinstance(idx, int):
        return v.select(depth, idx)
    if isinstance(idx, slice):
        return v[(_full_slice,) * depth + (idx,)]
    picked = v.index_select(depth, idx.reshape(-1))
    return picked.squeeze(depth) if idx.dim() == 0 else picked


def _as_lanes(v: Any, depth: int, n: int, what: str) -> tuple[Any, int]:
    """A stacked value seen from inside the lane level: its first axis
    past the batch axes is the lane axis, one more batch axis. A value
    with no such axis is the same in every lane: a shared one stays as it
    is, a batched one gets a lane axis of length 1."""
    if not isinstance(v, torch.Tensor):
        return v, depth
    if v.dim() > depth:
        if v.shape[depth] != n:
            raise ValueError(f"{what}: {v.shape[depth]} rows along the indexed axis for {n} lanes")
        return v, depth + 1
    return (v, 0) if depth == 0 else (v.unsqueeze(depth), depth + 1)


def _one_lane(v: Any, depth: int) -> tuple[Any, int]:
    """One lane's value seen from inside the lane level: the same in every
    lane (a `Mask` then says in which lane it holds)."""
    if not isinstance(v, torch.Tensor) or depth == 0:
        return v, 0
    return v.unsqueeze(depth), depth + 1


def _flag_as_lanes(flag: Any, depth: int, n: int) -> tuple[Any, int]:
    """A stacked value's flag seen from inside the lane level: its first
    axis past the batch axes, where it has one, is the lane axis; a flag
    without one is the same in every lane."""
    if isinstance(flag, torch.Tensor) and flag.dim() > depth:
        if flag.shape[depth] != n:
            raise ValueError(f"a stacked mask: {flag.shape[depth]} flags along the indexed axis for {n} lanes")
        return flag, depth + 1
    return _one_lane(flag, depth)


@Pytree.dataclass
class Choice(ChoiceMap):
    """A choice map holding a single value at the root, with the record of
    how many batch axes it carries. The value is a `Mask` where it holds
    under a flag only (the mask keeps the record of its flag)."""

    v: Any
    batched: int = Pytree.static(default=0)

    @staticmethod
    def build(v: Any, batched: int = 0) -> ChoiceMap:
        """A choice of `v`; a mask whose flag is a concrete bool collapses
        to its value or to the empty map."""
        if not isinstance(v, Mask):
            return Choice(v, batched)
        held = v.flatten()
        if held is None:
            return _empty
        return Choice(held, v.depth)

    def as_mask(self) -> Mask:
        """The value as a `Mask` (with a True flag where it is plain)."""
        if isinstance(self.v, Mask):
            return self.v
        return Mask(self.v, True, (self.batched,) * n_leaves(self.v), 0)

    def filter(self, selection: "Selection | Flag") -> ChoiceMap:
        if not isinstance(selection, Selection):
            return self.mask(selection)
        chosen = selection.check()
        if isinstance(chosen, bool):
            return self if chosen else _empty
        return self.mask(chosen, chosen.dim())

    def mask(self, flag: Flag, depth: int | None = None) -> ChoiceMap:
        if depth is None:
            depth = depth_of(flag)
            flag = plain(flag)
        if flag is True:
            return self
        if flag is False:
            return _empty
        return Choice.build(Mask.build(self.as_mask(), flag, depth))

    def get_value(self) -> Any:
        return self.v

    def value_is_batched(self) -> int:
        return self.batched

    def batched_leaves(self) -> list[int]:
        if isinstance(self.v, Mask):
            return self.v.batched_leaves()
        return [self.batched] * n_leaves(self.v)

    def map_choices(self, f) -> ChoiceMap:
        return f(self)

    def get_inner_map(self, addr) -> ChoiceMap:
        if isinstance(addr, str):
            return _empty
        if not isinstance(self.v, Mask):
            return Choice(_index_value(self.v, self.batched, addr), self.batched)
        m = self.v
        flag = m.flag
        if isinstance(flag, torch.Tensor) and flag.dim() > m.flag_depth:
            flag = _index_value(flag, m.flag_depth, addr)
        return Choice.build(Mask(_index_value(m.value, self.batched, addr), flag, m.record, m.flag_depth))

    def at_lanes(self, lanes: torch.Tensor) -> ChoiceMap:
        n = lanes.shape[0]
        if not isinstance(self.v, Mask):
            return Choice(*_as_lanes(self.v, self.batched, n, "a stacked choice"))
        v, depth = _as_lanes(self.v.value, self.batched, n, "a stacked choice")
        flag, flag_depth = _flag_as_lanes(self.v.flag, self.v.flag_depth, n)
        return Choice(Mask(v, flag, (depth,), flag_depth), depth)

    def one_lane(self) -> "Choice":
        """This choice as the value of one lane, seen from inside the lane
        level (the same in every lane)."""
        if not isinstance(self.v, Mask):
            return Choice(*_one_lane(self.v, self.batched))
        v, depth = _one_lane(self.v.value, self.batched)
        flag, flag_depth = _one_lane(self.v.flag, self.v.flag_depth)
        return Choice(Mask(v, flag, (depth,), flag_depth), depth)

    def pick_row(self, row: torch.Tensor, found) -> ChoiceMap:
        """The row `row` (a 0-d index tensor) of the axis past the batch
        axes, holding where `found` (a 0-d boolean tensor) is true."""
        m = self.as_mask()
        flag = m.flag
        if isinstance(flag, torch.Tensor) and flag.dim() > m.flag_depth:
            flag = _index_value(flag, m.flag_depth, row)
        picked = Mask(_index_value(m.value, self.batched, row), flag, m.record, m.flag_depth)
        return Choice.build(Mask.build(picked, found, 0))


@Pytree.dataclass
class Indexed(ChoiceMap):
    """A choice map nested under an index: a scalar (the sub-map lives at
    that one index) or a 1-d tensor pairing each row of the sub-map's
    leaves (along their first axis past the batch axes) with an index."""

    c: ChoiceMap
    addr: Any

    @staticmethod
    def build(chm: ChoiceMap, addr) -> ChoiceMap:
        if isinstance(addr, slice):
            if addr != _full_slice:
                raise ValueError(f"Only the full slice [:] may address an Indexed node; got {addr!r}.")
            return chm
        if chm.static_is_empty() or (isinstance(addr, torch.Tensor) and addr.shape == (0,)):
            return _empty
        return Indexed(chm, addr)

    def _fans_out(self) -> bool:
        return isinstance(self.addr, torch.Tensor) and self.addr.dim() == 1

    def filter(self, selection: "Selection | Flag") -> ChoiceMap:
        return self.c.filter(selection).extend(self.addr)

    def get_value(self) -> Any:
        return None

    def batched_leaves(self) -> list[int]:
        return self.c.batched_leaves() + [0]

    def map_choices(self, f) -> ChoiceMap:
        return Indexed.build(self.c.map_choices(f), self.addr)

    def get_inner_map(self, addr) -> ChoiceMap:
        if isinstance(addr, str):
            return _empty
        if isinstance(addr, slice) or (isinstance(addr, torch.Tensor) and addr.dim() > 0):
            raise ValueError(f"An Indexed node answers scalar lookups only; got {addr!r}.")
        if not self._fans_out():
            mine, theirs = _host_int(self.addr), _host_int(addr)
            if mine is not None and theirs is not None:
                return self.c if mine == theirs else _empty
            return self.c.mask(torch.as_tensor(self.addr == addr), 0)
        # First hit among the stored indices: compare, take the winning
        # row, and hold only if there was one. No host read.
        hits = self.addr == addr
        row = torch.argmax(hits.to(torch.int8))
        found = hits.any()
        return self.c.map_choices(lambda c: c.pick_row(row, found))

    def at_lanes(self, lanes: torch.Tensor) -> ChoiceMap:
        n = lanes.shape[0]
        if not self._fans_out():
            return self.c.map_choices(lambda c: c.one_lane()).mask(lanes == self.addr, 1)
        idx = self.addr.to(lanes.device)
        held = torch.zeros(n, dtype=torch.bool, device=lanes.device).index_fill_(0, idx, True)

        def spread(v, d):
            """The rows of `v` (along its first axis past `d` batch axes)
            put in the lanes they are indexed by; zeros in the others."""
            return v.new_zeros(v.shape[:d] + (n,) + v.shape[d + 1 :]).index_copy_(d, idx, v)

        def scatter(c):
            if not isinstance(c.v, Mask):
                v, d = c.v, c.batched
                return Choice(Mask(spread(v, d), held, (d + 1,), 1), d + 1)
            # A row that holds under its own flag: the lane holds where it
            # is indexed AND that row's flag holds (JAX's `Mask.build` of
            # the indexed row with the found flag).
            m, d = c.v, c.batched
            flag, fd = m.flag, m.flag_depth
            if flag.dim() > fd:
                lanes_flag = spread(flag, fd)  # one flag per row; false where nothing is indexed
            else:
                lanes_flag = flag.unsqueeze(fd) & held  # one flag for every row
            return Choice(Mask(spread(m.value, d), lanes_flag, (d + 1,), fd + 1), d + 1)

        return self.c.map_choices(scatter)


@Pytree.dataclass
class Static(ChoiceMap):
    """A trie node mapping string components to sub-maps."""

    children: dict

    @staticmethod
    def build(children: dict) -> "Static":
        return Static({k: sub for k, sub in children.items() if not sub.static_is_empty()})

    def filter(self, selection: "Selection | Flag") -> ChoiceMap:
        if not isinstance(selection, Selection):
            return self.mask(selection)
        return Static.build({k: sub.filter(selection(k)) for k, sub in self.children.items()})

    def get_value(self) -> Any:
        return None

    def get_inner_map(self, addr) -> ChoiceMap:
        if isinstance(addr, str):
            return self.children.get(addr, _empty)
        return Static.build({k: sub.get_inner_map(addr) for k, sub in self.children.items()})

    def at_lanes(self, lanes: torch.Tensor) -> ChoiceMap:
        return Static.build({k: sub.at_lanes(lanes) for k, sub in self.children.items()})

    def static_is_empty(self) -> bool:
        return not self.children

    def batched_leaves(self) -> list[int]:
        return [b for sub in self.children.values() for b in sub.batched_leaves()]

    def map_choices(self, f) -> ChoiceMap:
        return Static.build({k: sub.map_choices(f) for k, sub in self.children.items()})


def _as_mask(v: Any, depth: int) -> Mask:
    return v if isinstance(v, Mask) else Mask(v, True, (depth,) * n_leaves(v), 0)


@Pytree.dataclass
class Switch(ChoiceMap):
    """Branch `i` of `chms` masked by `idx == i`: the choices of a `Switch`
    trace whose index is a tensor (one branch per particle). `depth` is the
    number of batch axes the index carries."""

    idx: Any
    chms: list
    depth: int = Pytree.static(default=0)

    @staticmethod
    def build(idx, chm_iter: Iterable[ChoiceMap], depth: int | None = None) -> ChoiceMap:
        branches = list(chm_iter)
        if depth is None:
            depth = depth_of(idx)
            idx = plain(idx)
        if isinstance(idx, int) and not isinstance(idx, bool):
            return branches[idx]  # known when the map is built: no masks
        return Switch._rebuild(idx, [b.mask(idx == i, depth) for i, b in enumerate(branches)], depth)

    @staticmethod
    def _rebuild(idx, branches: list, depth: int) -> ChoiceMap:
        # A Switch whose every branch is empty holds no choices: collapse
        # it, so that a filtered constraint does not read as non-empty.
        if all(b.static_is_empty() for b in branches):
            return _empty
        return Switch(idx, branches, depth)

    def filter(self, selection: "Selection | Flag") -> ChoiceMap:
        return Switch._rebuild(self.idx, [b.filter(selection) for b in self.chms], self.depth)

    def static_is_empty(self) -> bool:
        return all(b.static_is_empty() for b in self.chms)

    def get_value(self) -> Any:
        live = [_as_mask(v, b.value_is_batched()) for b in self.chms if (v := b.get_value()) is not None]
        return Mask.or_n(*live) if live else None

    def value_is_batched(self) -> int:
        v = self.get_value()
        return v.depth if isinstance(v, Mask) else 0

    def get_inner_map(self, addr) -> ChoiceMap:
        return Switch._rebuild(self.idx, [b.get_inner_map(addr) for b in self.chms], self.depth)

    def at_lanes(self, lanes: torch.Tensor) -> ChoiceMap:
        idx, depth = _one_lane(self.idx, self.depth)
        return Switch._rebuild(idx, [b.at_lanes(lanes) for b in self.chms], depth)

    def batched_leaves(self) -> list[int]:
        return [self.depth] + [d for b in self.chms for d in b.batched_leaves()]

    def map_choices(self, f) -> ChoiceMap:
        return Switch._rebuild(self.idx, [b.map_choices(f) for b in self.chms], self.depth)


@Pytree.dataclass
class Or(ChoiceMap):
    """Left-priority union of two choice maps."""

    c1: ChoiceMap
    c2: ChoiceMap

    @staticmethod
    def build(c1: ChoiceMap, c2: ChoiceMap) -> ChoiceMap:
        if c1.static_is_empty():
            return c2
        if c2.static_is_empty():
            return c1
        if isinstance(c1, Static) and isinstance(c2, Static):
            merged = dict(c1.children)
            for k, sub in c2.children.items():
                merged[k] = merged[k] | sub if k in merged else sub
            return Static.build(merged)
        if isinstance(c1, Choice) and isinstance(c2, Choice):
            if not isinstance(c1.v, Mask):
                return c1
            # The left value where it holds, else the right one; the union
            # holds where either does.
            return Choice.build(c1.as_mask() | c2.as_mask())
        if isinstance(c1, Switch) and not isinstance(c2, Switch):
            # Into each branch, so that the switch keeps its structure.
            return Switch.build(c1.idx, [b | c2 for b in c1.chms], c1.depth)
        if isinstance(c2, Switch) and not isinstance(c1, Switch):
            return Switch.build(c2.idx, [c1 | b for b in c2.chms], c2.depth)
        return Or(c1, c2)

    def filter(self, selection: "Selection | Flag") -> ChoiceMap:
        return self.c1.filter(selection) | self.c2.filter(selection)

    def _value(self) -> tuple[Any, int]:
        left, right = self.c1.get_value(), self.c2.get_value()
        if right is None:
            return left, self.c1.value_is_batched()
        if left is None:
            return right, self.c2.value_is_batched()
        union = _as_mask(left, self.c1.value_is_batched()) | _as_mask(right, self.c2.value_is_batched())
        return (union.value if union.flag is True else union), union.depth

    def get_value(self) -> Any:
        return self._value()[0]

    def value_is_batched(self) -> int:
        return self._value()[1]

    def batched_leaves(self) -> list[int]:
        return self.c1.batched_leaves() + self.c2.batched_leaves()

    def map_choices(self, f) -> ChoiceMap:
        return Or.build(self.c1.map_choices(f), self.c2.map_choices(f))

    def get_inner_map(self, addr) -> ChoiceMap:
        return self.c1.get_inner_map(addr) | self.c2.get_inner_map(addr)

    def at_lanes(self, lanes: torch.Tensor) -> ChoiceMap:
        return self.c1.at_lanes(lanes) | self.c2.at_lanes(lanes)


_empty = Static({})
ChoiceMap.builder = _ChoiceMapBuilder(None)
ChoiceMapBuilder = _ChoiceMapBuilder(_empty)
SelectionBuilder = Selection.at
