"""`Target`, `Algorithm` and `Marginal`: the stochastic probability
interfaces of inference.

Counterpart of `genjax_tpu/inference/sp.py`. A `Target` is an unnormalized
posterior; an `Algorithm` is a sample distribution over its latents with
unbiased density estimates; `Marginal` closes a generative function over a
selection of kept addresses. Where JAX `vmap`s `random_weighted` over K
keys, these take a particle count `n`.
"""

import dataclasses
from typing import Any, Callable, Generic, TypeVar

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core import checked
from genjax_tpu_torch.core.choice_map import Choice, ChoiceMap, Selection
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
    >>> float(tr.get_choices()["y"]), float(target["y"])
    (1.0, 1.0)
    >>> latents = target.filter_to_unconstrained(tr.get_choices())
    >>> "x" in latents, "y" in latents
    (True, False)
    """

    p: GenerativeFunction[R]
    args: tuple
    constraint: ChoiceMap

    def __post_init__(self):
        if checked.is_checked():
            checked.check_args(self.args, "Target")
            checked.check_choice_map(self.constraint, "Target", what="constraint")
        if isinstance(self.p, Marginal):
            raise TypeError(
                "A Target's model may not itself be a Marginal; marginalize inside the model instead."
            )

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

    def __getitem__(self, addr):
        return self.constraint[addr]


def stack_runs(values: list) -> Any:
    """Per-run results (a score, or a choice map of one particle each) as
    one batch with a leading particle axis, recorded so."""
    stacked = pytree.tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]), *values)
    if isinstance(stacked, ChoiceMap):
        return stacked.map_choices(lambda c: Choice(c.v, c.batched + 1))
    return stacked


SampleDistribution = Distribution[ChoiceMap]
"""Distributions whose return value is a `ChoiceMap` (algorithms,
marginals, custom proposals)."""


class Algorithm(Generic[R], SampleDistribution):
    """Inference algorithms: unbiased density samplers / estimators over the
    latents of a `Target`, plus the normalizing-constant hooks that
    variational objectives use."""

    def random_weighted(self, rng: torch.Generator, *args, n=None) -> tuple[Score, ChoiceMap]:
        """Approximate posterior latents, with an unbiased reciprocal
        density estimate (Defn 3.2, Lew et al 2023)."""
        raise NotImplementedError

    def estimate_logpdf(self, rng: torch.Generator, v: ChoiceMap, *args) -> Score:
        """An unbiased density estimate at `v` (Defn 3.1, Lew et al 2023)."""
        raise NotImplementedError

    def estimate_normalizing_constant(self, rng: torch.Generator, target: "Target[R]") -> Weight:
        raise NotImplementedError

    def estimate_reciprocal_normalizing_constant(
        self, rng: torch.Generator, target: "Target[R]", latent_choices: ChoiceMap, w: Weight
    ) -> Weight:
        raise NotImplementedError


@Pytree.dataclass
class Marginal(Generic[R], SampleDistribution):
    """The marginal distribution of `gen_fn` over the addresses that
    `selection` picks out, optionally with an `Algorithm` that estimates
    the density of the marginalized addresses.

    With `n`, `random_weighted` draws `n` samples: the estimates have
    shape `(n,)` and the kept choices carry the particle axis. Without an
    algorithm the `n` draws are one batched `simulate`; with one, each
    draw runs the algorithm on its own target (its kept choices), one
    after the other, as JAX's `vmap` gives each key its own run.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.marginal(selection=gx.Selection.at["x"])
    ... @gx.gen
    ... def q():
    ...     x = gx.normal(0.0, 1.0) @ "x"
    ...     _ = gx.normal(x, 1.0) @ "aux"
    >>> w, chm = q.random_weighted(torch.Generator().manual_seed(0), n=4)
    >>> w.shape, "x" in chm, "aux" in chm
    (torch.Size([4]), True, False)
    """

    gen_fn: GenerativeFunction[R]
    selection: Selection = dataclasses.field(default_factory=Selection.all)
    algorithm: Any = None

    def random_weighted(self, rng: torch.Generator, *args, n=None) -> tuple[Score, ChoiceMap]:
        if n is not None and self.algorithm is not None:
            runs = [self.random_weighted(rng, *args) for _ in range(n)]
            return stack_runs([w for w, _ in runs]), stack_runs([c for _, c in runs])
        dropped = ~self.selection
        tr = self.gen_fn.simulate(rng, args, n)
        kept_choices = tr.get_choices().filter(self.selection)
        # The naive estimate at the kept choices: the joint score with the
        # dropped addresses' internal-proposal density divided out. With
        # `selection` all, the trace's score itself (what lets an ELBO
        # guide carry its entropy term).
        naive = tr.get_score() - tr.project(rng, dropped)
        if self.algorithm is None:
            return naive, kept_choices
        # With an algorithm: a lower-variance reciprocal estimate of the
        # normalizing constant of p(dropped | kept).
        sub_target = Target(self.gen_fn, args, kept_choices)
        dropped_choices = tr.get_choices().filter(dropped)
        est = self.algorithm.estimate_reciprocal_normalizing_constant(rng, sub_target, dropped_choices, naive)
        return est, kept_choices

    def estimate_logpdf(self, rng: torch.Generator, v: ChoiceMap, *args) -> Score:
        if self.algorithm is not None:
            return self.algorithm.estimate_normalizing_constant(rng, Target(self.gen_fn, args, v))
        # A single-sample importance estimate of the marginal density.
        _, w = self.gen_fn.importance(rng, v, args)
        return w


def marginal(
    *, selection: Selection | None = None, algorithm: Any = None
) -> Callable[[GenerativeFunction[R]], Marginal[R]]:
    """Decorator: a generative function as a `Marginal` sample distribution
    over the selected addresses."""
    sel = Selection.all() if selection is None else selection

    def decorator(gen_fn: GenerativeFunction[R]) -> Marginal[R]:
        return Marginal(gen_fn, sel, algorithm)

    return decorator
