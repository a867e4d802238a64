"""`Trace` and `GenerativeFunction`: the generative function interface.

Counterpart of `genjax_tpu/core/gfi.py`: `simulate`, `assess`, `generate`
and `importance`; `project`, `edit` and `update` with the `Update` edit
request (`Regenerate` and `EmptyRequest` are in `core/requests.py`), and
the postfix combinators (`gen_fn.vmap(in_axes=...)`, `.scan(n=...)`,
`.repeat(n=...)`, `.map(f)`, `.switch(...)`, `.mask()`, ...).

Where JAX takes a PRNG key, these methods take a `torch.Generator` (on
the CPU or on a CUDA device); the sites of a model draw from it in
program order. Where JAX `vmap`s a method over K keys, these methods take
an optional particle count `n`: the model body runs once, on tensors with
a leading particle axis of length `n`, while the model's arguments and
constrained values are stored once, unbatched. Each trace records which
of its leaves carry the particle axis (`Trace.batched_leaves`); an edit
reads the particle count from that record and keeps it. Under a `Vmap`
the kernel's methods get the whole stack of batch axes as `n` (a tuple),
and the record of a leaf is its depth (`core/typing.py`).
"""

from typing import Generic, TypeVar

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.concepts import (
    Argdiffs,
    Arguments,
    EditRequest,
    PrimitiveEditRequest,
    Retdiff,
    Score,
    Weight,
)
from genjax_tpu_torch.core.diff import Diff
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

    # -- the particle-axis record ---------------------------------------------

    def batched_leaves(self) -> list[bool]:
        """For each leaf of the trace (in `tree_leaves` order), whether it
        carries the leading particle axis."""
        raise NotImplementedError

    def args_record(self) -> list[bool]:
        """For each leaf of the arguments, whether it carries the particle
        axis."""
        raise NotImplementedError

    def retval_record(self) -> list[int]:
        """For each leaf of the return value, its depth."""
        raise NotImplementedError

    def drop_level(self, r: int = 0) -> "Trace[R]":
        """The same trace with the record of what it becomes once one
        index has been taken along a batch level from every leaf that
        carries it: the level with `r` levels to its right (0: the
        innermost)."""
        raise NotImplementedError

    def add_gap(self, k: int = 1) -> "Trace[R]":
        """The same trace as a `Scan` holds it stacked: `k` more step axes
        sit between each leaf's batch axes and the rest, which only a
        `VmapTrace` (whose lane axes come right after) has to know."""
        return self

    def as_single(self) -> "Trace[R]":
        """The same trace with a record that says no leaf carries the
        particle axis: what a trace becomes once one particle's row has
        been taken from every per-particle leaf."""
        return self.drop_level(0)

    def get_subtrace(self, *addresses) -> "Trace":
        tr = self
        for addr in addresses:
            tr = tr.get_inner_trace(addr)
        return tr

    def get_inner_trace(self, address) -> "Trace":
        raise NotImplementedError("This type of Trace object does not possess subtraces.")

    def particle_count(self) -> int | None:
        """The length of the particle axis, read from the record; None for
        a trace of one particle."""
        for leaf, batched in zip(pytree.tree_leaves(self), self.batched_leaves()):
            if batched:
                return leaf.shape[0]
        return None

    # -- edits ------------------------------------------------------------------

    def edit(
        self, rng: torch.Generator, request: EditRequest, argdiffs: Argdiffs | None = None
    ) -> tuple["Trace[R]", Weight, Retdiff, EditRequest]:
        return request.edit(rng, self, Diff.no_change(self.get_args()) if argdiffs is None else argdiffs)

    def update(
        self, rng: torch.Generator, constraint: ChoiceMap, argdiffs: Argdiffs | None = None
    ) -> tuple["Trace[R]", Weight, Retdiff, ChoiceMap]:
        return self.get_gen_fn().update(
            rng, self, constraint, Diff.no_change(self.get_args()) if argdiffs is None else argdiffs
        )

    def project(self, rng: torch.Generator, selection: Selection) -> Weight:
        return self.get_gen_fn().project(rng, self, selection)


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

    def __call__(self, *args, **kwargs) -> "GenerativeFunctionClosure[R]":
        return GenerativeFunctionClosure(self, args, kwargs)

    def __abstract_call__(self, *args) -> R:
        """The return value of a call, with every tensor leaf zero, on the
        arguments' device: a shape-only `simulate` (`to_shape_fn`), which
        draws nothing and does no device work."""
        from genjax_tpu_torch.core.staging import SHAPE_RNG, to_shape_fn, zeros_on

        return to_shape_fn(lambda *a: self.simulate(SHAPE_RNG, a).get_retval(), zeros_on(args))(*args)

    def handle_kwargs(self) -> "GenerativeFunction[R]":
        """The function that takes `((args...), {kwargs...})`: here the
        keyword arguments are dropped (`IgnoreKwargs`); `@gen` functions
        pass them to their source."""
        return IgnoreKwargs(self)

    def get_zero_trace(self, *args, **_kwargs) -> Trace[R]:
        """A trace of `self(*args)` with every tensor leaf zero, in the
        shapes and dtypes a call gives: JAX's `empty_trace`, which takes
        them from `eval_shape`. Here one call runs (on the arguments'
        device, from a fixed generator) and its leaves are zeroed."""
        from genjax_tpu_torch.core.typing import device_of

        rng = torch.Generator(device=device_of(*pytree.tree_leaves(args))).manual_seed(0)
        tr = self.simulate(rng, args)
        return pytree.tree_map(lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor) else x, tr)

    def simulate(
        self, rng: torch.Generator, args: Arguments, n: "int | tuple | None" = None
    ) -> Trace[R]:
        """Sample a trace; with `n`, a batch of `n` traces."""
        raise NotImplementedError

    def assess(
        self, sample: ChoiceMap, args: Arguments, n: "int | tuple | None" = None
    ) -> tuple[Score, R]:
        """The log density of a fully constraining sample. Values recorded
        as per particle give one score per particle; with `n`, the score
        has shape `(n,)` even where every value is shared."""
        raise NotImplementedError

    def generate(
        self,
        rng: torch.Generator,
        constraint: ChoiceMap,
        args: Arguments,
        n: "int | tuple | None" = None,
        like: Trace[R] | None = None,
    ) -> tuple[Trace[R], Weight]:
        """Importance-sample a trace consistent with `constraint`; the weight
        is `log P(t)/Q(t; constraint)`. With `n`, the weight has shape `(n,)`.

        `like` is a trace of this function from an earlier call with the
        same particle-axis record (its arguments, constraint and sites
        carry the axis where this call's do): the record is read from it,
        not learned from `PerParticle` marks, so the arguments may come
        plain. The caller vouches for the match, as the body of JAX's
        `scan` is traced once for every step."""
        raise NotImplementedError

    def importance(
        self,
        rng: torch.Generator,
        constraint: ChoiceMap,
        args: Arguments,
        n: "int | tuple | None" = None,
        like: Trace[R] | None = None,
    ) -> tuple[Trace[R], Weight]:
        """Alias for `generate` (Gen's traditional name)."""
        return self.generate(rng, constraint, args, n, like)

    def propose(
        self, rng: torch.Generator, args: Arguments, n: "int | tuple | None" = None
    ) -> tuple[ChoiceMap, Score, R]:
        """Sample and return `(choices, score, retval)`: the shape a
        proposal distribution takes. With `n`, `n` proposals at once.

        >>> import torch
        >>> import genjax_tpu_torch as gx
        >>> chm, score, v = gx.normal.propose(torch.Generator().manual_seed(0), (0.0, 1.0))
        >>> bool(chm.get_value() == v)
        True
        """
        tr = self.simulate(rng, args, n)
        return tr.get_choices(), tr.get_score(), tr.get_retval()

    def project(self, rng: torch.Generator, trace: Trace[R], selection: Selection) -> Weight:
        """The part of the trace's score that the selected addresses
        contribute."""
        raise NotImplementedError

    def edit(
        self,
        rng: torch.Generator,
        trace: Trace[R],
        edit_request: EditRequest,
        argdiffs: Argdiffs,
        n: "int | tuple | None" = None,
    ) -> tuple[Trace[R], Weight, Retdiff, EditRequest]:
        """Respond to an SMCP3 edit request: the new trace, the incremental
        weight, the retdiff and the backward request. The new trace keeps
        the old one's particle-axis record. `n` is the batch of the
        enclosing trace, where there is one."""
        raise NotImplementedError

    def update(
        self,
        rng: torch.Generator,
        trace: Trace[R],
        constraint: ChoiceMap,
        argdiffs: Argdiffs,
    ) -> tuple[Trace[R], Weight, Retdiff, ChoiceMap]:
        """Constrain the addresses of `constraint` and reweight: returns
        `(new_trace, weight, retdiff, discarded_choices)`, where `weight`
        is the new score minus the old when the arguments are unchanged.

        >>> import torch
        >>> import genjax_tpu_torch as gx
        >>> @gx.gen
        ... def m():
        ...     return gx.normal(0.0, 1.0) @ "x"
        >>> tr = m.simulate(torch.Generator().manual_seed(0), (), n=4)
        >>> new, w, _, discard = m.update(
        ...     torch.Generator(), tr, gx.ChoiceMap.kw(x=0.0), gx.Diff.no_change(())
        ... )
        >>> bool(torch.allclose(w, new.get_score() - tr.get_score()))
        True
        >>> bool(torch.equal(discard["x"], tr.get_choices()["x"]))
        True
        """
        tr, w, rd, bwd = Update(constraint).edit(rng, trace, argdiffs)
        return tr, w, rd, bwd.constraint

    # -- postfix combinators ----------------------------------------------------

    def vmap(self, /, *, in_axes=0) -> "GenerativeFunction":
        """`genjax_tpu_torch.vmap(in_axes=in_axes)(self)`: one run of this
        function for every index of the mapped arguments' axis.

        >>> import torch
        >>> import genjax_tpu_torch as gx
        >>> @gx.gen
        ... def datum(x, w):
        ...     return gx.normal(x * w, 1.0) @ "y"
        >>> batched = datum.vmap(in_axes=(0, None))
        >>> tr = batched.simulate(torch.Generator().manual_seed(0), (torch.arange(3.0), 2.0), n=5)
        >>> tr.get_choices()["y"].shape, tr.get_choices()[1, "y"].shape, tr.get_score().shape
        (torch.Size([5, 3]), torch.Size([5]), torch.Size([5]))
        """
        from genjax_tpu_torch.combinators.vmap import Vmap

        return Vmap(self, in_axes)

    def repeat(self, /, *, n: int) -> "GenerativeFunction":
        """`a -> b` becomes `a -> [b]`: `n` independent runs."""
        from genjax_tpu_torch.combinators.compose import RepeatCombinator

        return RepeatCombinator(self, n=n)

    def scan(self, /, *, n: int | None = None) -> "GenerativeFunction":
        """`(c, a) -> (c, b)` becomes `(c, [a]) -> (c, [b])`.

        >>> import torch
        >>> import genjax_tpu_torch as gx
        >>> @gx.gen
        ... def step(x, _):
        ...     y = gx.normal(x, 1.0) @ "x"
        ...     return y, y
        >>> tr = step.scan(n=4).simulate(torch.Generator().manual_seed(0), (0.0, None), n=6)
        >>> tr.get_choices()["x"].shape, tr.get_choices()[3, "x"].shape, tr.get_retval()[1].shape
        (torch.Size([6, 4]), torch.Size([6]), torch.Size([6, 4]))
        """
        from genjax_tpu_torch.combinators.scan import Scan

        return Scan(self, n)

    def accumulate(self) -> "GenerativeFunction":
        from genjax_tpu_torch.combinators.scan import accumulate

        return accumulate()(self)

    def reduce(self) -> "GenerativeFunction":
        from genjax_tpu_torch.combinators.scan import reduce

        return reduce()(self)

    def iterate(self, /, *, n: int) -> "GenerativeFunction":
        from genjax_tpu_torch.combinators.scan import iterate

        return iterate(n=n)(self)

    def iterate_final(self, /, *, n: int) -> "GenerativeFunction":
        from genjax_tpu_torch.combinators.scan import iterate_final

        return iterate_final(n=n)(self)

    def masked_iterate(self) -> "GenerativeFunction":
        """Variable-length `iterate`: per-step boolean flags gate each
        step's score (a masked-out step adds nothing)."""
        from genjax_tpu_torch.combinators.scan import masked_iterate

        return masked_iterate()(self)

    def masked_iterate_final(self) -> "GenerativeFunction":
        """Variable-length `iterate_final` (see `masked_iterate`)."""
        from genjax_tpu_torch.combinators.scan import masked_iterate_final

        return masked_iterate_final()(self)

    def mask(self) -> "GenerativeFunction":
        """Prepend a boolean argument that decides existence: where it is
        false the score is 0 and the return value a `Mask` whose flag is
        false."""
        from genjax_tpu_torch.combinators.mask import mask

        return mask(self)

    def or_else(self, gen_fn: "GenerativeFunction") -> "GenerativeFunction":
        """A boolean branch: `(flag, self_args, else_args)` runs this
        function where the flag holds, `gen_fn` otherwise."""
        from genjax_tpu_torch.combinators.compose import or_else

        return or_else(self, gen_fn)

    def switch(self, *branches: "GenerativeFunction") -> "GenerativeFunction":
        """A branch chosen at run time: `(idx, args_0, ..., args_n)` runs
        branch `idx` (this function is branch 0)."""
        from genjax_tpu_torch.combinators.switch import switch

        return switch(self, *branches)

    def mix(self, *fns: "GenerativeFunction") -> "GenerativeFunction":
        """A mixture: the first argument is the component logits; traces
        `"mixture_component"` and `"component_sample"`."""
        from genjax_tpu_torch.combinators.compose import mix

        return mix(self, *fns)

    def dimap(self, /, *, pre=lambda *args: args, post=lambda args, xformed, retval: retval, info=None):
        from genjax_tpu_torch.combinators.dimap import Dimap

        return Dimap(self, pre, post, info)

    def map(self, f, *, info=None) -> "GenerativeFunction":
        from genjax_tpu_torch.combinators.dimap import map as _map

        return _map(f, info=info)(self)

    def contramap(self, f, *, info=None) -> "GenerativeFunction":
        from genjax_tpu_torch.combinators.dimap import contramap

        return contramap(f, info=info)(self)


##########################################
# Kwargs support / addressable closures  #
##########################################


@Pytree.dataclass
class IgnoreKwargs(GenerativeFunction[R]):
    """Adapter: the GFI methods take `((args...), {kwargs...})` argument
    tuples and call the wrapped function with the positional ones."""

    wrapped: GenerativeFunction[R]

    def handle_kwargs(self) -> GenerativeFunction[R]:
        raise NotImplementedError

    def __abstract_call__(self, *args):
        (args_tuple, _kwargs) = args
        return self.wrapped.__abstract_call__(*args_tuple)

    def simulate(self, rng: torch.Generator, args: Arguments, *rest):
        (args_tuple, _kwargs) = args
        return self.wrapped.simulate(rng, args_tuple, *rest)

    def assess(self, sample: ChoiceMap, args: Arguments, *rest):
        (args_tuple, _kwargs) = args
        return self.wrapped.assess(sample, args_tuple, *rest)

    def generate(self, rng: torch.Generator, constraint: ChoiceMap, args: Arguments, *rest):
        (args_tuple, _kwargs) = args
        return self.wrapped.generate(rng, constraint, args_tuple, *rest)

    def project(self, rng: torch.Generator, trace: Trace[R], selection: Selection) -> Weight:
        return self.wrapped.project(rng, trace, selection)

    def edit(self, rng: torch.Generator, trace: Trace[R], edit_request: EditRequest, argdiffs: Argdiffs, *rest):
        (argdiffs_tuple, _kwargs) = argdiffs
        return self.wrapped.edit(rng, trace, edit_request, argdiffs_tuple, *rest)


@Pytree.dataclass
class GenerativeFunctionClosure(Generic[R], Pytree):
    """The value of `gen_fn(*args, **kwargs)`: addressable via `@ "addr"`
    inside a generative program, and callable with a generator as a
    sampler of the return value.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.gen
    ... def model(mu, scale=1.0):
    ...     return gx.normal(mu, scale) @ "x"
    >>> v = model(0.0, scale=0.001)(torch.Generator().manual_seed(0))
    >>> abs(float(v)) < 0.01
    True
    """

    gen_fn: GenerativeFunction[R]
    args: tuple
    kwargs: dict = Pytree.field(default_factory=dict)

    def get_gen_fn_with_args(self) -> tuple[GenerativeFunction[R], tuple]:
        if self.kwargs:
            return self.gen_fn.handle_kwargs(), (self.args, self.kwargs)
        return self.gen_fn, self.args

    def __matmul__(self, addr) -> R:
        from genjax_tpu_torch.lang.interop import trace

        if not self.kwargs:
            return trace(addr, self.gen_fn, self.args)
        return trace(addr, self.gen_fn.handle_kwargs(), (self.args, self.kwargs))

    def __call__(self, rng: torch.Generator, *args) -> R:
        full_args = (*self.args, *args)
        if self.kwargs:
            return self.gen_fn.handle_kwargs().simulate(rng, (full_args, self.kwargs)).get_retval()
        return self.gen_fn.simulate(rng, full_args).get_retval()

    def __abstract_call__(self, *args) -> R:
        return self.gen_fn.__abstract_call__(*self.args, *args)


@Pytree.dataclass
class Update(PrimitiveEditRequest):
    """Request: constrain the addresses of `constraint`, reweight the rest.
    The backward request is an `Update` holding the discarded choices."""

    constraint: ChoiceMap
