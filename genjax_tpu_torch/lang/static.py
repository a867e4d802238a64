"""The `@gen` static modeling language.

Counterpart of `genjax_tpu/lang/static.py`: `gen`,
`StaticGenerativeFunction`, `StaticTrace`, `AddressReuse`,
`MissingAddress`, and the simulate / assess / generate handlers.

Every GFI method runs the model source directly, once, with a handler
installed (see `lang/interop.py`). The sites draw from the method's
`torch.Generator` in program order (JAX folds a per-site counter into its
key instead). With a particle count `n`, the body runs once on tensors
with a leading particle axis: no loop over particles.

Edits, and the site-graph analysis that makes them incremental, come
later.
"""

from typing import Any, Callable, Generic, TypeVar

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.concepts import Score, Weight
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.lang.interop import TraceHandler, handler_context

R = TypeVar("R")


class AddressReuse(Exception):
    """Attempt to re-write an address in a trace. Each address may only be
    traced once per program execution."""


class MissingAddress(Exception):
    """Attempt to assess a model without supplying values for all sampled
    addresses."""


@Pytree.dataclass
class StaticTrace(Generic[R], Trace[R]):
    """Trace of a `@gen` program: a dict of per-address subtraces."""

    gen_fn: "StaticGenerativeFunction[R]"
    args: tuple
    retval: R
    subtraces: dict

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
            return torch.zeros(())
        total = scores[0]
        for s in scores[1:]:
            total = total + s
        return total


############
# Handlers #
############


class StaticLangHandler(TraceHandler):
    """Base handler: records subtraces and rejects address reuse."""

    def __init__(self, rng: torch.Generator | None, n: int | None):
        self.rng = rng
        self.n = n
        self.subtraces: dict = {}

    def record(self, addr, subtrace) -> None:
        if addr in self.subtraces:
            raise AddressReuse(addr)
        self.subtraces[addr] = subtrace


class SimulateHandler(StaticLangHandler):
    def handle_trace(self, addr, gen_fn, args):
        tr = gen_fn.simulate(self.rng, args, self.n)
        self.record(addr, tr)
        return tr.get_retval()


class AssessHandler(StaticLangHandler):
    def __init__(self, sample: ChoiceMap):
        super().__init__(None, None)
        self.sample = sample
        self.score = None

    def handle_trace(self, addr, gen_fn, args):
        submap = self.sample(addr)
        if submap.static_is_empty():
            raise MissingAddress(addr)
        score, v = gen_fn.assess(submap, args)
        self.score = score if self.score is None else self.score + score
        return v


class GenerateHandler(StaticLangHandler):
    def __init__(self, rng: torch.Generator, constraint: ChoiceMap, n: int | None):
        super().__init__(rng, n)
        self.constraint = constraint
        # With a particle axis the weight is (n,) even where every site's
        # weight is shared (unbatched) or zero.
        self.weight = torch.zeros(() if n is None else (n,), device=rng.device)

    def handle_trace(self, addr, gen_fn, args):
        tr, w = gen_fn.generate(self.rng, self.constraint(addr), args, self.n)
        self.weight = self.weight + w
        self.record(addr, tr)
        return tr.get_retval()


#######################
# Generative function #
#######################


@Pytree.dataclass
class StaticGenerativeFunction(Generic[R], GenerativeFunction[R]):
    """A generative function whose source is a Python program over tensors
    using `dist(args) @ "addr"` addressing syntax."""

    source: Callable[..., Any] = Pytree.static()

    def simulate(self, rng, args, n=None) -> StaticTrace[R]:
        handler = SimulateHandler(rng, n)
        with handler_context(handler):
            retval = self.source(*args)
        return StaticTrace(self, args, retval, handler.subtraces)

    def assess(self, sample, args) -> tuple[Score, R]:
        handler = AssessHandler(sample)
        with handler_context(handler):
            retval = self.source(*args)
        score = torch.zeros(()) if handler.score is None else handler.score
        return score, retval

    def generate(self, rng, constraint, args, n=None) -> tuple[StaticTrace[R], Weight]:
        handler = GenerateHandler(rng, constraint, n)
        with handler_context(handler):
            retval = self.source(*args)
        return StaticTrace(self, args, retval, handler.subtraces), handler.weight


def gen(f: Callable[..., Any]) -> StaticGenerativeFunction[Any]:
    """Decorator turning a Python function that uses `dist(args) @ "addr"`
    into a `StaticGenerativeFunction`."""
    return StaticGenerativeFunction(f)


__all__ = [
    "AddressReuse",
    "MissingAddress",
    "StaticGenerativeFunction",
    "StaticTrace",
    "gen",
]
