"""`Distribution` and `ExactDensity`: primitive generative functions.

Counterpart of `genjax_tpu/distributions/distribution.py`: the stochastic
probability interface (`random_weighted` / `estimate_logpdf`) with
`simulate`, `assess`, `generate`, `project` and the `Update` /
`Regenerate` edits on top, `ExactDensity` (`sample` + `logpdf`) and the
`exact_density` factory.

A site's value may be a scalar or a tensor per particle. Its score is,
per particle, the JAX score: the logpdf summed over every axis of that
particle's value (`site_score`). With a particle axis, the value's record
(`DistributionTrace.batched`) says whether it carries the axis; which of
the parameters carry it follows from rank: a parameter with more axes
than one particle's value does. So a model body keeps the particle axis
in front and writes a per-particle parameter with as many axes as the
site's value (`loc[:, None]` for a per-particle scalar against a vector
site), which plain broadcasting needs anyway.
"""

from typing import Any, Callable, Generic, TypeVar

import torch
from torch._C import DisableTorchFunctionSubclass

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.concepts import NotSupportedEditRequest, Score, Weight
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu_torch.core.pytree import Pytree, n_leaves
from genjax_tpu_torch.core.requests import EmptyRequest, Regenerate
from genjax_tpu_torch.core.typing import as_value, device_of, per_particle, plain

R = TypeVar("R")


def _rank(x: Any) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else 0


def params_batched(args: tuple, event_rank: int) -> list[bool]:
    """For each of a site's parameters (a flat tuple of tensors, numbers
    or None: each one leaf), whether it carries the particle axis: a
    tensor with more axes than one particle's value."""
    return [_rank(p) > event_rank for p in args]


def site_score(density: Any, value: Any, batched: bool, args: tuple) -> Score:
    """A site's score from its elementwise log density: summed over every
    axis but the particle axis, which the density carries when the value
    or a parameter does."""
    if _rank(density) == 0:
        return density
    keep = 1 if batched else int(any(params_batched(args, _rank(value))))
    if density.dim() == keep:
        return density
    return density.sum(dim=tuple(range(keep, density.dim())))


@Pytree.dataclass
class DistributionTrace(Generic[R], Trace[R]):
    gen_fn: GenerativeFunction[R]
    args: tuple
    value: R
    score: Score
    batched: bool = Pytree.static(default=False)  # the value carries the particle axis

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self) -> R:
        return self.value

    def get_gen_fn(self) -> GenerativeFunction[R]:
        return self.gen_fn

    def get_score(self) -> Score:
        return self.score

    def get_choices(self) -> ChoiceMap:
        return ChoiceMap.choice(self.value, self.batched)

    def args_record(self) -> list[bool]:
        return params_batched(self.args, _rank(self.value) - self.batched)

    def batched_leaves(self) -> list[bool]:
        args = self.args_record()
        score = self.batched or any(args)
        return (
            [False] * n_leaves(self.gen_fn)
            + args
            + [self.batched] * n_leaves(self.value)
            + [score] * n_leaves(self.score)
        )

    def as_single(self) -> "DistributionTrace[R]":
        return DistributionTrace(self.gen_fn, self.args, self.value, self.score)


class Distribution(Generic[R], GenerativeFunction[R]):
    """Generative functions over a single (unaddressed) choice, specified by
    the stochastic probability interface."""

    def random_weighted(
        self, rng: torch.Generator, *args, n: int | None = None
    ) -> tuple[Score, R]:
        """Sample a value and return (elementwise density estimate, value)."""
        raise NotImplementedError

    def estimate_logpdf(self, rng: torch.Generator | None, v: R, *args) -> Score:
        """An unbiased density (estimate) of `v`, in log space, elementwise."""
        raise NotImplementedError

    # The `PerParticle` marks of the parameters set a draw's shape
    # (`core.typing.sample_shape`); the arithmetic itself runs with the
    # subclass's dispatch off, on plain tensors, so the marks cost nothing
    # per operation here.

    def _draw(self, rng, args: tuple, n: int | None):
        with DisableTorchFunctionSubclass():
            return self.random_weighted(rng, *args, n=n)

    def _density(self, rng, v, args: tuple):
        with DisableTorchFunctionSubclass():
            return self.estimate_logpdf(rng, v, *args)

    def _trace(self, args: tuple, value, density, batched: bool) -> DistributionTrace[R]:
        """The trace of a site: `value` and `density` are plain tensors
        (`_draw`, `_density`); the parameters lose their marks."""
        score = site_score(density, value, batched, args)
        return DistributionTrace(self, tuple(plain(a) for a in args), value, score, batched)

    def simulate(self, rng, args, n=None) -> Trace[R]:
        w, v = self._draw(rng, args, n)
        return self._trace(args, v, w, n is not None)

    def generate(self, rng, constraint, args, n=None, like=None) -> tuple[Trace[R], Weight]:
        """With `like`, the parameters that carry the particle axis are those
        of `like`'s (plain tensors here are marked for the draw)."""
        held = constraint.get_value()
        if held is None:
            # Unconstrained: fresh draw, importance weight 1.
            if like is None:
                return self.simulate(rng, args, n), torch.zeros((), device=rng.device)
            marked = tuple(per_particle(a) if b else a for a, b in zip(args, like.args_record()))
            w, v = self._draw(rng, marked, n)
            return self._trace(args, v, w, n is not None), torch.zeros((), device=rng.device)
        # Constrained: the value is the constraint, stored as given (shared
        # unless it was marked per particle); the weight is its density.
        held = as_value(held, rng.device)
        tr = self._trace(args, held, self._density(rng, held, args), constraint.value_is_batched())
        return tr, tr.score

    def assess(self, sample: ChoiceMap, args: tuple, n=None) -> tuple[Score, R]:
        held = sample.get_value()
        if held is None:
            raise ValueError(f"assess of {type(self).__name__}: the sample holds no value.")
        held = as_value(held, device_of(*args))
        score = site_score(self._density(None, held, args), held, sample.value_is_batched(), args)
        return score, held

    def project(self, rng, trace, selection: Selection) -> Weight:
        if selection.check():
            return trace.get_score()
        return torch.zeros((), device=device_of(trace.get_score()))

    # -- edits -------------------------------------------------------------------

    def edit(self, rng, trace, edit_request, argdiffs, n: int | None = None):
        """`n` is the particle count of the trace that holds this site."""
        match edit_request:
            case Update(constraint):
                return self.edit_update(rng, trace, constraint, argdiffs)
            case Regenerate(selection):
                return self.edit_regenerate(rng, trace, selection, argdiffs, n)
            case EmptyRequest():
                return edit_request.edit(rng, trace, argdiffs)
            case _:
                raise NotSupportedEditRequest(edit_request)

    def edit_update(self, rng, trace: DistributionTrace[R], constraint: ChoiceMap, argdiffs):
        """Re-score the winning value (the constraint's, else the old one)
        under the new arguments; the weight is the new score minus the old.
        A shared constraint on a per-particle site gives every particle
        that value."""
        new_args = Diff.tree_primal(argdiffs)
        proposed = constraint.get_value()
        if proposed is None:
            winner, batched = trace.value, trace.batched
            discard, retdiff = ChoiceMap.empty(), Diff.no_change(winner)
        else:
            winner = as_value(proposed, device_of(trace.value, trace.score))
            batched = constraint.value_is_batched()
            if batched and not trace.batched:
                raise ValueError(
                    "Update: a per-particle value for a site that every particle shares; "
                    "an edit keeps the trace's particle-axis record."
                )
            if trace.batched and not batched:
                winner, batched = winner.expand(trace.value.shape[0], *winner.shape), True
            discard, retdiff = trace.get_choices(), Diff.unknown_change(winner)
        new = self._trace(new_args, winner, self._density(rng, winner, new_args), batched)
        return new, new.score - trace.score, retdiff, Update(discard)

    def edit_regenerate(self, rng, trace: DistributionTrace[R], selection: Selection, argdiffs, n=None):
        """Selected: a fresh draw from the prior under the new arguments, in
        the old value's shape; the weight is the change of the score (the
        proposal terms are `mcmc.mh`'s to subtract). Unselected: the value
        is kept and re-scored."""
        new_args = Diff.tree_primal(argdiffs)
        held = trace.value
        if not selection.check():
            new = self._trace(new_args, held, self._density(rng, held, new_args), trace.batched)
            return new, new.score - trace.score, Diff.no_change(held), Update(ChoiceMap.empty())
        if trace.batched:
            # The record of the old value says which parameters carry the
            # particle axis; marking them draws one value per particle.
            event_rank = _rank(held) - 1
            marked = tuple(per_particle(a) if _rank(a) > event_rank else a for a in new_args)
            w, v = self._draw(rng, marked, held.shape[0])
        elif n is not None:
            raise NotImplementedError(
                "Regenerate of a value that every particle shares (an observation) "
                "would give each particle its own value."
            )
        else:
            w, v = self._draw(rng, new_args, None)
        new = self._trace(new_args, v, w, trace.batched)
        return new, new.score - trace.score, Diff.unknown_change(new.value), Update(trace.get_choices())


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
