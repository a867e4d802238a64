"""`Distribution` and `ExactDensity`: primitive generative functions.

Counterpart of `genjax_tpu/distributions/distribution.py`: the stochastic
probability interface (`random_weighted` / `estimate_logpdf`) with
`simulate`, `assess`, `generate`, `project` and the `Update` /
`Regenerate` edits on top, `ExactDensity` (`sample` + `logpdf`) and the
`exact_density` factory.

A site's value may be a scalar or a tensor per particle. Its score is,
per particle, the JAX score: the logpdf summed over every axis of that
particle's value (`site_score`). With batch axes (the particle axis, and
under a `Vmap` one lane axis per level: `core/typing.py`), the value's
record (`DistributionTrace.batched`) is its depth, the number of batch
axes it carries; the depth of a parameter follows from rank: the axes it
has beyond those of one particle's value (plus `param_event_extra`, for a
parameter like `categorical`'s logits that has an axis the value lacks).
The score keeps every batch axis, so under a `Vmap` there is one score per
lane. So a model body keeps the batch axes in front, writes a batched
parameter with as many event axes as the site's value (`loc[:, None]` for
a per-particle scalar against a vector site), which plain broadcasting
needs anyway, and reduces with negative axes (`x.sum(-1)`, `w @ X.mT`),
never with `dim=0` or a bare `.sum()`: then the same body runs for one
particle, for K, and as a `Vmap` kernel for K particles times N lanes.
"""

import inspect
from typing import Any, Callable, Generic, TypeVar

import torch
from torch._C import DisableTorchFunctionSubclass

from genjax_tpu_torch.core import checked
from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.concepts import NotSupportedEditRequest, Score, Weight
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import GenerativeFunction, GenerativeFunctionClosure, Trace, Update
from genjax_tpu_torch.core.mask import Mask, flag_on
from genjax_tpu_torch.core.pytree import Const, Pytree, n_leaves
from genjax_tpu_torch.core.requests import EmptyRequest, Regenerate
from genjax_tpu_torch.core.staging import SHAPE_RNG
from genjax_tpu_torch.core.typing import PerParticle, as_value, batch_dims, device_of, mark, nobeartype, plain

R = TypeVar("R")


def _rank(x: Any) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else 0


def _drop(depth: int, r: int) -> int:
    """A leaf's depth once the batch level with `r` levels to its right is
    gone: leaves that carried it lose one."""
    return depth - 1 if depth > r else depth


def params_batched(args: tuple, event_rank: int, extra: Any = 0) -> list[int]:
    """For each of a site's parameters (a flat tuple of tensors, numbers
    or None: each one leaf), its depth: how many batch axes it carries,
    which is the number of axes it has beyond those of one particle's
    value (`event_rank`, plus `extra` for that parameter)."""
    if isinstance(extra, int):
        base = event_rank + extra
        return [p.dim() - base if isinstance(p, torch.Tensor) and p.dim() > base else 0 for p in args]
    return [max(_rank(p) - event_rank - e, 0) for p, e in zip(args, extra)]


def site_score(density: Any, value: Any, batched: int, args: tuple, extra: Any = 0) -> Score:
    """A site's score from its elementwise log density: summed over the
    event axes only. The density carries as many batch axes as the deepest
    of the value and the parameters."""
    if _rank(density) <= batched:
        return density  # a scalar, or nothing but the value's own batch axes
    keep = max(int(batched), *params_batched(args, _rank(value) - batched, extra), 0)
    if density.dim() <= keep:
        return density
    return density.sum(dim=tuple(range(keep, density.dim())))


def _on_value(flag: torch.Tensor, value: torch.Tensor, depth: int) -> torch.Tensor:
    """A flag over the batch axes (aligned to the innermost) shaped to
    select whole events of `value`, which carries `depth` batch axes."""
    return flag.reshape(flag.shape + (1,) * (value.dim() - depth))


def _site_flag(held: Mask) -> torch.Tensor:
    """The flag of a masked value at a site: over batch axes only (one
    answer per particle and lane, as a site's score has)."""
    if held.flag.dim() > held.flag_depth:
        raise ValueError(
            f"a site's masked value has a flag over more than its batch axes (shape {tuple(held.flag.shape)}, "
            f"depth {held.flag_depth})"
        )
    return held.flag


@Pytree.dataclass
class DistributionTrace(Generic[R], Trace[R]):
    gen_fn: GenerativeFunction[R]
    args: tuple
    value: R
    score: Score
    batched: int = Pytree.static(default=0)  # the value's depth: how many batch axes it carries

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

    def args_record(self) -> list[int]:
        return params_batched(self.args, _rank(self.value) - self.batched, self.gen_fn.param_event_extra)

    def retval_record(self) -> list[int]:
        return [self.batched] * n_leaves(self.value)

    def batched_leaves(self) -> list[int]:
        args = self.args_record()
        # The score carries every batch axis that the value or a parameter does.
        score = min(max(self.batched, *args, 0), _rank(self.score))
        return (
            [0] * n_leaves(self.gen_fn)
            + args
            + [self.batched] * n_leaves(self.value)
            + [score] * n_leaves(self.score)
        )

    def as_single(self) -> "DistributionTrace[R]":
        return DistributionTrace(self.gen_fn, self.args, self.value, self.score)

    def drop_level(self, r: int = 0) -> "DistributionTrace[R]":
        return DistributionTrace(self.gen_fn, self.args, self.value, self.score, _drop(self.batched, r))


class Distribution(Generic[R], GenerativeFunction[R]):
    """Generative functions over a single (unaddressed) choice, specified by
    the stochastic probability interface."""

    # How many axes a parameter has that one particle's value lacks: 0, or
    # one number per parameter (`categorical`: the axis over categories).
    param_event_extra: Any = 0

    # The return value IS the sampled value: a site that an edit leaves
    # alone keeps its value even when its arguments change, so no change
    # flows through it (`lang/analysis.py`'s taint rules).
    retval_is_value = True

    def __call__(self, *args, sample_shape=(), **kwargs) -> GenerativeFunctionClosure[R]:
        """The site `self(*args)`, parameters by position or keyword
        (`bind`); `sample_shape=` (a tuple or a `Const` of one) makes it
        `prod(sample_shape)` independent draws (`SampleShaped`)."""
        return self.closure(self.bind(args, kwargs), sample_shape)

    # `bind` and `closure` serve `__call__`, whose `*args` and `**kwargs`
    # are a tuple and a dict whatever the caller passed: the public API's
    # checks (`core/typecheck.py`) would cost every site and catch nothing.
    @nobeartype
    def bind(self, args: tuple, kwargs: dict) -> tuple:
        """The parameters as the flat positional tuple a trace stores."""
        if kwargs:
            raise TypeError(f"{type(self).__name__} takes its parameters by position")
        return args

    @nobeartype
    def closure(self, args: tuple, sample_shape: Any = ()) -> GenerativeFunctionClosure[R]:
        shape = Const.unwrap_value(sample_shape)
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        return GenerativeFunctionClosure(SampleShaped(self, shape) if shape else self, args)

    def random_weighted(
        self, rng: torch.Generator, *args, n: "int | tuple | None" = None
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

    def _density(self, rng, v, args: tuple, depth: int = 0):
        """The elementwise density of `v`, which carries `depth` batch axes."""
        with DisableTorchFunctionSubclass():
            return self.estimate_logpdf(rng, v, *args)

    def _trace(self, args: tuple, value, density, batched: int) -> DistributionTrace[R]:
        """The trace of a site: `value` and `density` are plain tensors
        (`_draw`, `_density`); the parameters lose their marks."""
        score = site_score(density, value, batched, args, self.param_event_extra)
        if any(isinstance(a, PerParticle) for a in args):
            args = tuple(plain(a) for a in args)
        return DistributionTrace(self, args, value, score, int(batched))

    def simulate(self, rng: torch.Generator, args: tuple, n: "int | tuple | None" = None) -> Trace[R]:
        if checked.is_checked():
            checked.check_key(rng, f"{type(self).__name__}.simulate")
            checked.check_args(args, f"{type(self).__name__}.simulate")
        w, v = self._draw(rng, args, n)
        return self._trace(args, v, w, len(n) if isinstance(n, tuple) else n is not None)

    def _fresh(self, rng, args, n, like):
        """A fresh draw `(density, value)`; with `like`, the parameters
        carry the batch axes that `like`'s do."""
        if like is not None:
            args = tuple(mark(a, b) if b else a for a, b in zip(args, like.args_record()))
        return self._draw(rng, args, n)

    def generate(
        self,
        rng: torch.Generator,
        constraint: ChoiceMap,
        args: tuple,
        n: "int | tuple | None" = None,
        like: "DistributionTrace | None" = None,
    ) -> tuple[Trace[R], Weight]:
        """With `like`, the parameters that carry the particle axis are those
        of `like`'s (plain tensors here are marked for the draw)."""
        if checked.is_checked():
            checked.check_key(rng, f"{type(self).__name__}.generate")
            checked.check_choice_map(constraint, f"{type(self).__name__}.generate")
            checked.check_args(args, f"{type(self).__name__}.generate")
        held = constraint.get_value()
        depth = len(n) if isinstance(n, tuple) else n is not None
        if held is None:
            # Unconstrained: fresh draw, importance weight 1.
            w, v = self._fresh(rng, args, n, like)
            return self._trace(args, v, w, depth), torch.zeros((), device=rng.device)
        if isinstance(held, Mask):
            # Constrained where the flag holds only (some lanes, some
            # particles): those hold the constraint and weigh its density,
            # the others a fresh draw and weigh nothing.
            flag = _site_flag(held)
            _, fresh = self._fresh(rng, args, n, like)
            value = as_value(held.value, rng.device).to(fresh.dtype)
            v = torch.where(flag_on(flag, held.flag_depth, fresh, depth), value, fresh)
            tr = self._trace(args, v, self._density(rng, v, args, depth), depth)
            return tr, torch.where(flag, tr.score, 0.0)
        held = as_value(held, rng.device)
        # Constrained: the value is the constraint, stored as given (shared
        # unless it was marked per particle); the weight is its density.
        depth = constraint.value_is_batched()
        tr = self._trace(args, held, self._density(rng, held, args, depth), depth)
        return tr, tr.score

    def assess(self, sample: ChoiceMap, args: tuple, n=None, marked: bool = False) -> tuple[Score, R]:
        """With `marked`, the value comes back with the mark of its depth
        (for a body that hands it on to a `Vmap`). A masked value is scored
        whatever its flag (JAX's unchecked `unmask`): a `Switch` scores
        every branch and keeps the one its index names."""
        held = sample.get_value()
        if held is None:
            raise ValueError(f"assess of {type(self).__name__}: the sample holds no value.")
        if isinstance(held, Mask):
            held = held.value
        held = as_value(held, device_of(*args))
        batched = sample.value_is_batched()
        score = site_score(self._density(None, held, args, batched), held, batched, args, self.param_event_extra)
        return score, mark(held, batched) if marked else held

    def project(self, rng, trace, selection: Selection) -> Weight:
        chosen = selection.check()
        if chosen is True:
            return trace.get_score()
        if chosen is False:
            return torch.zeros((), device=device_of(trace.get_score()))
        return torch.where(chosen, trace.get_score(), 0.0)

    # -- edits -------------------------------------------------------------------

    def edit(self, rng, trace, edit_request, argdiffs, n: "int | tuple | None" = None):
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
        new_args = _stored_args(trace, argdiffs)
        proposed = constraint.get_value()
        if proposed is None:
            winner, batched = trace.value, trace.batched
            discard, retdiff = ChoiceMap.empty(), Diff.no_change(winner)
        else:
            masked = isinstance(proposed, Mask)
            winner = as_value(proposed.value if masked else proposed, device_of(trace.value, trace.score))
            if isinstance(trace.value, torch.Tensor):
                winner = winner.to(trace.value.dtype)  # a Python 2 for an integer site stays an index
            batched = constraint.value_is_batched()
            if batched > trace.batched:
                raise ValueError(
                    "Update: a per-particle value for a site that every particle shares; "
                    "an edit keeps the trace's particle-axis record."
                )
            if masked:
                # Where the flag holds the constraint's value wins; the
                # discard holds the old value there only.
                flag = _site_flag(proposed)
                if proposed.flag_depth > trace.batched:
                    raise ValueError("Update: a value for some lanes of a site that every lane shares")
                winner = torch.where(flag_on(flag, proposed.flag_depth, trace.value, trace.batched), winner, trace.value)
                batched = trace.batched
                discard = trace.get_choices().mask(flag, proposed.flag_depth)
            else:
                if trace.batched > batched:
                    lead = trace.value.shape[: trace.batched - batched]
                    winner, batched = winner.expand(*lead, *winner.shape), trace.batched
                discard = trace.get_choices()
            retdiff = Diff.unknown_change(winner)
        new = self._trace(new_args, winner, self._density(rng, winner, new_args, batched), batched)
        return new, new.score - trace.score, retdiff, Update(discard)

    def edit_regenerate(self, rng, trace: DistributionTrace[R], selection: Selection, argdiffs, n=None):
        """Selected: a fresh draw from the prior under the new arguments, in
        the old value's shape; the weight is the change of the score (the
        proposal terms are `mcmc.mh`'s to subtract). Unselected: the value
        is kept and re-scored, unless the arguments did not change: then the
        trace itself comes back at zero weight, with no density call."""
        new_args = _stored_args(trace, argdiffs)
        held = trace.value
        chosen = selection.check()
        if chosen is False:
            if new_args is trace.args:
                return trace, torch.zeros((), device=rng.device), Diff.no_change(held), Update(ChoiceMap.empty())
            new = self._trace(new_args, held, self._density(rng, held, new_args, trace.batched), trace.batched)
            return new, new.score - trace.score, Diff.no_change(held), Update(ChoiceMap.empty())
        if trace.batched:
            # The record of the old value says which parameters carry the
            # batch axes; marking them draws one value per particle and lane.
            depths = params_batched(new_args, _rank(held) - trace.batched, self.param_event_extra)
            marked = tuple(mark(a, d) for a, d in zip(new_args, depths))
            dims = tuple(held.shape[: trace.batched])
            w, v = self._draw(rng, marked, dims[0] if len(dims) == 1 else dims)
        elif n is not None:
            raise NotImplementedError(
                "Regenerate of a value that every particle shares (an observation) "
                "would give each particle its own value."
            )
        else:
            w, v = self._draw(rng, new_args, None)
        if chosen is not True:
            # Selected in some lanes only: the others keep their value.
            v = torch.where(_on_value(chosen, v, trace.batched), v, held)
            w = self._density(rng, v, new_args, trace.batched)
        new = self._trace(new_args, v, w, trace.batched)
        return new, new.score - trace.score, Diff.unknown_change(new.value), Update(trace.get_choices())


def _stored_args(trace: DistributionTrace, argdiffs) -> tuple:
    """The arguments an edited site stores: the trace's own where the
    argdiffs say nothing changed (as JAX keeps them), else the new ones."""
    if isinstance(trace, DistributionTrace) and Diff.static_check_no_change(argdiffs):
        return trace.args
    return Diff.tree_primal(argdiffs)


class ExactDensity(Generic[R], Distribution[R]):
    """Distributions with exact `sample` / `logpdf` implementations."""

    def sample(self, rng: torch.Generator, *args, n: "int | tuple | None" = None) -> R:
        raise NotImplementedError

    def logpdf(self, v: R, *args) -> Score:
        raise NotImplementedError

    def random_weighted(self, rng, *args, n=None) -> tuple[Score, R]:
        v = self.sample(rng, *args, n=n)
        if rng is SHAPE_RNG:
            # A shape-only call wants the value: the density is a placeholder
            # that `site_score` sums over the event axes like any other.
            return torch.empty(v.shape, device=v.device), v
        return self.logpdf(v, *args), v

    def estimate_logpdf(self, rng, v, *args) -> Weight:
        return self.logpdf(v, *args)


def _signature(fn: Callable[..., Any], skip: int) -> inspect.Signature | None:
    """The parameters of `fn` after its first `skip`, without `n`: the
    names a call may give by keyword (None where `fn` takes `*args`)."""
    try:
        params = list(inspect.signature(fn).parameters.values())[skip:]
    except (TypeError, ValueError):
        return None
    params = [p for p in params if p.name != "n"]
    if any(p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) for p in params):
        return None
    return inspect.Signature(params)


def exact_density(
    sample: Callable[..., Any],
    logpdf: Callable[..., Score],
    name: str,
    param_event_extra: Any = 0,
    signature: inspect.Signature | None = None,
) -> ExactDensity[Any]:
    """A singleton `ExactDensity` from `sample(rng, *params, n=None)` and
    `logpdf(v, *params)` callables (JAX's `native_distribution`). A call
    takes the parameters by position or by the names of `sample`'s
    signature (or `signature`), its defaults filled in, and
    `sample_shape=` (`Distribution.__call__`). `param_event_extra` is the
    number of axes each parameter has that one draw lacks.

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
    >>> expo(rate=2.0).args
    (2.0,)
    """
    sig = signature if signature is not None else _signature(sample, 1)

    class _Density(ExactDensity):
        @nobeartype
        def bind(self, args: tuple, kwargs: dict) -> tuple:
            if not kwargs:
                return args
            if sig is None:
                raise TypeError(f"{name} takes its parameters by position")
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            return tuple(bound.args)

        def sample(self, rng, *args, n=None, **kwargs):
            return sample(rng, *self.bind(args, kwargs), n=n)

        def logpdf(self, v, *args, **kwargs):
            args = self.bind(args, kwargs)
            return logpdf(as_value(v, device_of(*args)), *args)

    _Density.param_event_extra = param_event_extra
    label = "genjax_tpu_torch." + name
    _Density.__name__ = label
    _Density.__qualname__ = label
    return Pytree.dataclass(_Density)()


@Pytree.dataclass
class SampleShaped(Distribution):
    """The site `base(*params, sample_shape=shape)`: `prod(shape)`
    independent draws of `base`, the value `(*batch, *shape, *per-draw
    shape)` (the batch axes of the particles, and of the lanes under a
    `Vmap`, in front), its score the sum over `shape`'s axes only. The
    parameters are those of one draw: a per-particle parameter `(n, K)`
    of a site with `shape=(N,)` gives `(n, N)` values. Internally the
    draws and densities run with `shape`'s axes in front of the batch
    axes, where the parameters broadcast as they are, and the value is
    moved behind them."""

    base: Distribution = Pytree.static()
    shape: tuple = Pytree.static()

    @property
    def param_event_extra(self) -> Any:
        extra, s = self.base.param_event_extra, len(self.shape)
        return extra - s if isinstance(extra, int) else tuple(e - s for e in extra)

    def _front(self, v, depth: int):
        s = len(self.shape)
        return v.movedim(tuple(range(depth, depth + s)), tuple(range(s))) if depth else v

    def _sum(self, density):
        s = len(self.shape)
        return density.sum(dim=tuple(range(s))) if s else density

    def random_weighted(self, rng, *args, n=None):
        dims = batch_dims(n)
        w, v = self.base.random_weighted(rng, *args, n=(*self.shape, *dims))
        s = len(self.shape)
        behind = v.movedim(tuple(range(s)), tuple(range(len(dims), len(dims) + s))) if dims else v
        return self._sum(w), behind.contiguous()

    def _density(self, rng, v, args: tuple, depth: int = 0):
        if not isinstance(v, torch.Tensor) or v.dim() < depth + len(self.shape):
            return super()._density(rng, v, args, depth)
        with DisableTorchFunctionSubclass():
            return self._sum(self.base.estimate_logpdf(rng, self._front(plain(v), depth), *args))

    def estimate_logpdf(self, rng, v, *args):
        """The density of a value without batch axes: summed over `shape`."""
        return self._sum(self.base.estimate_logpdf(rng, v, *args))
