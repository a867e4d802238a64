"""`Distribution` and `ExactDensity`: primitive generative functions.

Counterpart of `genjax_tpu/distributions/distribution.py`: the stochastic
probability interface (`random_weighted` / `estimate_logpdf`) with
`simulate`, `assess` and `generate` on top, `ExactDensity` (`sample` +
`logpdf`) and the `exact_density` factory.

A site's value is a scalar per particle: with a particle axis, its value
and score have shape `(n,)`, and the score is never summed over that
axis. Vector-valued sites come with the vmap combinator.
"""

from typing import Any, Callable, Generic, TypeVar

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.concepts import Score, Weight
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import as_value, device_of

R = TypeVar("R")


@Pytree.dataclass
class DistributionTrace(Generic[R], Trace[R]):
    gen_fn: GenerativeFunction[R]
    args: tuple
    value: R
    score: Score

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self) -> R:
        return self.value

    def get_gen_fn(self) -> GenerativeFunction[R]:
        return self.gen_fn

    def get_score(self) -> Score:
        return self.score

    def get_choices(self) -> ChoiceMap:
        return ChoiceMap.choice(self.value)


class Distribution(Generic[R], GenerativeFunction[R]):
    """Generative functions over a single (unaddressed) choice, specified by
    the stochastic probability interface."""

    def random_weighted(
        self, rng: torch.Generator, *args, n: int | None = None
    ) -> tuple[Score, R]:
        """Sample a value and return (score estimate, value)."""
        raise NotImplementedError

    def estimate_logpdf(self, rng: torch.Generator | None, v: R, *args) -> Score:
        """An unbiased density (estimate) of `v`, in log space."""
        raise NotImplementedError

    def simulate(self, rng, args, n=None) -> Trace[R]:
        w, v = self.random_weighted(rng, *args, n=n)
        return DistributionTrace(self, args, v, w)

    def generate(self, rng, constraint, args, n=None) -> tuple[Trace[R], Weight]:
        held = constraint.get_value()
        if held is None:
            # Unconstrained: fresh draw, importance weight 1.
            return self.simulate(rng, args, n), torch.zeros((), device=rng.device)
        # Fully constrained: the value is the constraint, stored once (not
        # per particle); the weight is its density, which broadcasts
        # against batched arguments.
        held = as_value(held, rng.device)
        density = self.estimate_logpdf(rng, held, *args)
        return DistributionTrace(self, args, held, density), density

    def assess(self, sample: ChoiceMap, args: tuple) -> tuple[Score, R]:
        held = sample.get_value()
        if held is None:
            raise ValueError(f"assess of {type(self).__name__}: the sample holds no value.")
        held = as_value(held, device_of(*args))
        return self.estimate_logpdf(None, held, *args), held


class ExactDensity(Generic[R], Distribution[R]):
    """Distributions with exact `sample` / `logpdf` implementations."""

    def sample(self, rng: torch.Generator, *args, n: int | None = None) -> R:
        raise NotImplementedError

    def logpdf(self, v: R, *args) -> Score:
        raise NotImplementedError

    def random_weighted(self, rng, *args, n=None) -> tuple[Score, R]:
        v = self.sample(rng, *args, n=n)
        return self.logpdf(v, *args), v

    def estimate_logpdf(self, rng, v, *args) -> Weight:
        return self.logpdf(v, *args)


def exact_density(
    sample: Callable[..., Any], logpdf: Callable[..., Score], name: str
) -> ExactDensity[Any]:
    """A singleton `ExactDensity` from `sample(rng, *args, n=None)` and
    `logpdf(v, *args)` callables.

    >>> import math, torch
    >>> from genjax_tpu_torch.distributions.distribution import exact_density
    >>> expo = exact_density(
    ...     lambda rng, rate, n=None: torch.empty(() if n is None else (n,)).exponential_(generator=rng) / rate,
    ...     lambda v, rate: torch.where(v >= 0, math.log(rate) - rate * v, -math.inf),
    ...     "expo",
    ... )
    >>> tr = expo.simulate(torch.Generator().manual_seed(0), (2.0,), n=4)
    >>> tr.get_retval().shape, bool((tr.get_score() <= math.log(2.0)).all())
    (torch.Size([4]), True)
    """

    class _Density(ExactDensity):
        def sample(self, rng, *args, n=None):
            return sample(rng, *args, n=n)

        def logpdf(self, v, *args):
            return logpdf(as_value(v, device_of(*args)), *args)

    label = "genjax_tpu_torch." + name
    _Density.__name__ = label
    _Density.__qualname__ = label
    return Pytree.dataclass(_Density)()
