"""`Trace` and `GenerativeFunction`: the generative function interface.

Counterpart of `genjax_tpu/core/gfi.py`: `simulate`, `assess`, `generate`
and `importance`. Edits (update, regenerate, project) and the postfix
combinators come later.

Where JAX takes a PRNG key, these methods take a `torch.Generator` (on
the CPU or on a CUDA device); the sites of a model draw from it in
program order. Where JAX `vmap`s a method over K keys, these methods take
an optional particle count `n`: the model body runs once, on tensors with
a leading particle axis of length `n`, while the model's arguments and
constrained values are stored once, unbatched.
"""

from typing import Generic, TypeVar

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.concepts import Arguments, Score, Weight
from genjax_tpu_torch.core.pytree import Pytree

R = TypeVar("R")


class Trace(Generic[R], Pytree):
    """An execution record of a generative function: arguments, return
    value, addressed random choices, and the score (log density of the
    sample). With a particle axis, the score has shape `(n,)`."""

    def get_args(self) -> Arguments:
        raise NotImplementedError

    def get_retval(self) -> R:
        raise NotImplementedError

    def get_score(self) -> Score:
        raise NotImplementedError

    def get_choices(self) -> ChoiceMap:
        raise NotImplementedError

    def get_gen_fn(self) -> "GenerativeFunction[R]":
        raise NotImplementedError


class GenerativeFunction(Generic[R], Pytree):
    """Probabilistic programs exposing `simulate`, `assess` and
    `generate` (alias `importance`).

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.gen
    ... def model():
    ...     x = gx.normal(0.0, 1.0) @ "x"
    ...     return gx.normal(x, 1.0) @ "y"
    >>> rng = torch.Generator().manual_seed(0)
    >>> tr, w = model.importance(rng, gx.ChoiceMap.kw(y=1.0), (), n=8)
    >>> tr.get_choices()["x"].shape, w.shape
    (torch.Size([8]), torch.Size([8]))
    """

    def __call__(self, *args) -> "GenerativeFunctionClosure[R]":
        return GenerativeFunctionClosure(self, args)

    def simulate(
        self, rng: torch.Generator, args: Arguments, n: int | None = None
    ) -> Trace[R]:
        """Sample a trace; with `n`, a batch of `n` traces."""
        raise NotImplementedError

    def assess(self, sample: ChoiceMap, args: Arguments) -> tuple[Score, R]:
        """The log density of a fully constraining sample (batched values
        give one score per particle)."""
        raise NotImplementedError

    def generate(
        self,
        rng: torch.Generator,
        constraint: ChoiceMap,
        args: Arguments,
        n: int | None = None,
    ) -> tuple[Trace[R], Weight]:
        """Importance-sample a trace consistent with `constraint`; the weight
        is `log P(t)/Q(t; constraint)`. With `n`, the weight has shape `(n,)`."""
        raise NotImplementedError

    def importance(
        self,
        rng: torch.Generator,
        constraint: ChoiceMap,
        args: Arguments,
        n: int | None = None,
    ) -> tuple[Trace[R], Weight]:
        """Alias for `generate` (Gen's traditional name)."""
        return self.generate(rng, constraint, args, n)


@Pytree.dataclass
class GenerativeFunctionClosure(Generic[R], Pytree):
    """The value of `gen_fn(*args)`: addressable via `@ "addr"` inside a
    generative program."""

    gen_fn: GenerativeFunction[R]
    args: tuple

    def __matmul__(self, addr) -> R:
        from genjax_tpu_torch.lang.interop import trace

        return trace(addr, self.gen_fn, self.args)
