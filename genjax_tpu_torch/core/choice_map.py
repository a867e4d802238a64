"""Addressed sample storage: `ChoiceMap` and `Selection`, static addresses.

Counterpart of `genjax_tpu/core/choice_map.py`, restricted to string
addresses (and tuples of them). A choice map is a trie: `Static` nodes
map address components to sub-maps, `Choice` leaves hold values, `Or`
is a left-priority union. The trie's keys live in the pytree context, so
resolving an address costs nothing on the device. A `Choice` records
whether its value carries a leading particle axis (`batched`); a value
without one (an observation) is shared by every particle. The record is
set where the value is made (a trace's draw, or a value marked with
`core.typing.per_particle`), never read off its size.

Dynamic (integer-array) addresses, masks and switch nodes come with the
combinators.
"""

from typing import Any, Iterable

from genjax_tpu_torch.core.pytree import Pytree, n_leaves
from genjax_tpu_torch.core.typing import is_per_particle, plain

Address = str | tuple[str, ...]


def _tuplize(addr) -> tuple:
    return addr if isinstance(addr, tuple) else (addr,)


def _check_component(comp) -> None:
    if not isinstance(comp, str):
        raise TypeError(
            f"Address components must be strings; got {comp!r} of type "
            f"{type(comp).__name__}. Dynamic addresses are not supported yet."
        )


##############
# Selections #
##############


class _SelectionBuilder:
    def __getitem__(self, addr: Address) -> "Selection":
        # Subtree semantics: S[p] selects p and everything beneath it.
        return Selection.all().extend(*_tuplize(addr))


class Selection(Pytree):
    """An address-set algebra: `sel(addr)` is the sub-selection at `addr`,
    `sel[addr]` / `addr in sel` whether `addr` is selected, `~sel` the
    complement.

    >>> from genjax_tpu_torch.core.choice_map import Selection
    >>> sel = Selection.at["x"]
    >>> "x" in sel, "y" in sel, "y" in ~sel
    (True, False, True)
    """

    at = _SelectionBuilder()

    @staticmethod
    def all() -> "Selection":
        return AllSel()

    @staticmethod
    def none() -> "Selection":
        return NoneSel()

    def __invert__(self) -> "Selection":
        return ComplementSel.build(self)

    def extend(self, *addrs: str) -> "Selection":
        nested = self
        for comp in reversed(addrs):
            _check_component(comp)
            nested = nested if isinstance(nested, NoneSel) else StaticSel(nested, comp)
        return nested

    def __call__(self, addr: Address) -> "Selection":
        sub = self
        for comp in _tuplize(addr):
            sub = sub.get_subselection(comp)
        return sub

    def __getitem__(self, addr: Address) -> bool:
        return self(addr).check()

    def __contains__(self, addr: Address) -> bool:
        return self[addr]

    def check(self) -> bool:
        raise NotImplementedError

    def get_subselection(self, addr: str) -> "Selection":
        raise NotImplementedError


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

    def check(self) -> bool:
        return not self.s.check()

    def get_subselection(self, addr) -> Selection:
        return ~self.s(addr)


@Pytree.dataclass
class StaticSel(Selection):
    s: Selection
    addr: str = Pytree.static()

    def check(self) -> bool:
        return False

    def get_subselection(self, addr) -> Selection:
        return self.s if addr == self.addr else NoneSel()


@Pytree.dataclass
class ChmSel(Selection):
    """The addresses at which a choice map holds a value."""

    c: "ChoiceMap"

    def check(self) -> bool:
        return self.c.has_value()

    def get_subselection(self, addr) -> Selection:
        return ChmSel(self.c.get_inner_map(addr))


###############
# Choice maps #
###############


class ChoiceMapNoValueAtAddress(Exception):
    pass


class ChoiceMap(Pytree):
    """A functional trie of addressed random choices.

    >>> from genjax_tpu_torch.core.choice_map import ChoiceMap
    >>> chm = ChoiceMap.kw(x=1.0) | ChoiceMap.d({("sub", "y"): 2.0})
    >>> chm["x"], chm["sub", "y"], ("sub", "y") in chm
    (1.0, 2.0, True)
    """

    # -- abstract interface ------------------------------------------------

    def filter(self, selection: Selection) -> "ChoiceMap":
        raise NotImplementedError

    def get_value(self) -> Any:
        raise NotImplementedError

    def get_inner_map(self, addr: str) -> "ChoiceMap":
        raise NotImplementedError

    def static_is_empty(self) -> bool:
        return False

    def value_is_batched(self) -> bool:
        """Whether the value at the root carries the particle axis."""
        return False

    def batched_leaves(self) -> list[bool]:
        """The particle-axis record of each leaf, in `tree_leaves` order."""
        raise NotImplementedError

    # -- derived interface -------------------------------------------------

    def get_submap(self, *addresses: Address) -> "ChoiceMap":
        chm = self
        for a in addresses:
            for comp in _tuplize(a):
                chm = chm.get_inner_map(comp)
        return chm

    def has_value(self) -> bool:
        return self.get_value() is not None

    def get_selection(self) -> Selection:
        return ChmSel(self)

    def extend(self, *addrs: str) -> "ChoiceMap":
        nested = self
        for comp in reversed(addrs):
            _check_component(comp)
            nested = Static.build({comp: nested})
        return nested

    # -- constructors ------------------------------------------------------

    @staticmethod
    def empty() -> "ChoiceMap":
        return _empty

    @staticmethod
    def choice(v: Any, batched: bool = False) -> "ChoiceMap":
        """A map holding `v` at the root. A value marked with
        `per_particle` (or `batched=True`) carries the particle axis."""
        return Choice(plain(v), batched or is_per_particle(v))

    @staticmethod
    def entry(v: Any, *addrs: str) -> "ChoiceMap":
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

    # -- dunders -----------------------------------------------------------

    def __or__(self, other: "ChoiceMap") -> "ChoiceMap":
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


@Pytree.dataclass
class Choice(ChoiceMap):
    """A choice map holding a single value at the root, with the record of
    whether it carries the particle axis."""

    v: Any
    batched: bool = Pytree.static(default=False)

    def filter(self, selection: Selection) -> ChoiceMap:
        return self if selection.check() else _empty

    def get_value(self) -> Any:
        return self.v

    def value_is_batched(self) -> bool:
        return self.batched

    def batched_leaves(self) -> list[bool]:
        return [self.batched] * n_leaves(self.v)

    def get_inner_map(self, addr: str) -> ChoiceMap:
        return _empty


@Pytree.dataclass
class Static(ChoiceMap):
    """A trie node mapping string components to sub-maps."""

    children: dict

    @staticmethod
    def build(children: dict) -> "Static":
        return Static({k: sub for k, sub in children.items() if not sub.static_is_empty()})

    def filter(self, selection: Selection) -> ChoiceMap:
        return Static.build({k: sub.filter(selection(k)) for k, sub in self.children.items()})

    def get_value(self) -> Any:
        return None

    def get_inner_map(self, addr: str) -> ChoiceMap:
        return self.children.get(addr, _empty)

    def static_is_empty(self) -> bool:
        return not self.children

    def batched_leaves(self) -> list[bool]:
        return [b for sub in self.children.values() for b in sub.batched_leaves()]


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
            return c1
        return Or(c1, c2)

    def filter(self, selection: Selection) -> ChoiceMap:
        return self.c1.filter(selection) | self.c2.filter(selection)

    def get_value(self) -> Any:
        left = self.c1.get_value()
        return self.c2.get_value() if left is None else left

    def value_is_batched(self) -> bool:
        return (self.c1 if self.c1.has_value() else self.c2).value_is_batched()

    def batched_leaves(self) -> list[bool]:
        return self.c1.batched_leaves() + self.c2.batched_leaves()

    def get_inner_map(self, addr: str) -> ChoiceMap:
        return self.c1.get_inner_map(addr) | self.c2.get_inner_map(addr)


_empty = Static({})
