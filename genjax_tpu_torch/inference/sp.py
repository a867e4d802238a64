"""`Target` and `Algorithm`: the stochastic probability interfaces of
inference.

Counterpart of `genjax_tpu/inference/sp.py`. `Marginal` comes later.
"""

from typing import Generic, TypeVar

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.concepts import Score, Weight
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.distributions.distribution import Distribution

R = TypeVar("R")


@Pytree.dataclass
class Target(Generic[R], Pytree):
    """An unnormalized posterior: a generative function `p`, its arguments,
    and a constraint choice map fixing the observed addresses.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.gen
    ... def model():
    ...     x = gx.normal(0.0, 1.0) @ "x"
    ...     _ = gx.normal(x, 1.0) @ "y"
    >>> target = gx.Target(model, (), gx.ChoiceMap.kw(y=1.0))
    >>> tr, w = target.importance(torch.Generator().manual_seed(0), gx.ChoiceMap.empty())
    >>> float(tr.get_choices()["y"])
    1.0
    >>> latents = target.filter_to_unconstrained(tr.get_choices())
    >>> "x" in latents, "y" in latents
    (True, False)
    """

    p: GenerativeFunction[R]
    args: tuple
    constraint: ChoiceMap

    def latent_selection(self) -> Selection:
        """The addresses the constraint does NOT pin."""
        return ~self.constraint.get_selection()

    def importance(
        self, rng: torch.Generator, constraint: ChoiceMap, n: int | None = None
    ) -> tuple[Trace[R], Weight]:
        """A trace of `p` consistent with the target's observations and the
        caller's extra `constraint` (observations win on overlap)."""
        return self.p.importance(rng, self.constraint | constraint, self.args, n)

    def filter_to_unconstrained(self, choice_map: ChoiceMap) -> ChoiceMap:
        return choice_map.filter(self.latent_selection())


SampleDistribution = Distribution[ChoiceMap]
"""Distributions whose return value is a `ChoiceMap`."""


class Algorithm(Generic[R], SampleDistribution):
    """Inference algorithms: unbiased density samplers / estimators over the
    latents of a `Target`."""

    def random_weighted(self, rng: torch.Generator, *args, n=None) -> tuple[Score, ChoiceMap]:
        """Approximate posterior latents, with an unbiased reciprocal
        density estimate."""
        raise NotImplementedError

    def estimate_logpdf(self, rng: torch.Generator, v: ChoiceMap, *args) -> Score:
        raise NotImplementedError
