"""Composed combinators: `mix`, `or_else`, `repeat`.

Counterpart of `genjax_tpu/combinators/compose.py`.
"""

from typing import TypeVar

import torch

from genjax_tpu_torch.combinators.vmap import Vmap
from genjax_tpu_torch.core.gfi import GenerativeFunction

R = TypeVar("R")


def mix(*gen_fns: GenerativeFunction[R]) -> GenerativeFunction[R]:
    """A mixture over component generative functions. The result takes
    `(mixture_logits, args_0, ..., args_{n-1})`, draws a component index at
    `"mixture_component"` (a categorical over the logits) and the
    component's value at `"component_sample"` (a `Switch`: with a particle
    axis, every particle its own component).

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.gen
    ... def lo():
    ...     return gx.normal(-5.0, 1.0) @ "v"
    >>> @gx.gen
    ... def hi():
    ...     return gx.normal(5.0, 1.0) @ "v"
    >>> tr = gx.mix(lo, hi).simulate(torch.Generator().manual_seed(0), (torch.zeros(2), (), ()), n=6)
    >>> c = tr.get_choices()["mixture_component"]
    >>> bool(((tr.get_retval() > 0) == (c == 1)).all())
    True
    """
    from genjax_tpu_torch.combinators.switch import switch
    from genjax_tpu_torch.distributions.library import categorical
    from genjax_tpu_torch.lang.static import gen

    branch_switch = switch(*gen_fns)

    def mixture_model(logits, *args):
        component = categorical(logits=logits) @ "mixture_component"
        return branch_switch(component, *args) @ "component_sample"

    return gen(mixture_model)


def or_else(if_gen_fn: GenerativeFunction[R], else_gen_fn: GenerativeFunction[R]) -> GenerativeFunction[R]:
    """A boolean branch: `(flag, if_args, else_args)` runs `if_gen_fn`
    where the flag holds, else `else_gen_fn` (a `Switch` under a
    `contramap`; branch 0 is the `if`)."""

    def argument_mapping(flag, if_args: tuple, else_args: tuple):
        branch = (0 if flag else 1) if isinstance(flag, bool) else torch.where(flag, 0, 1)
        return (branch, if_args, else_args)

    return if_gen_fn.switch(else_gen_fn).contramap(argument_mapping)


def RepeatCombinator(gen_fn: GenerativeFunction[R], /, *, n: int):
    """`a -> b` becomes `a -> [b]`: `n` independent runs, a `Vmap` that
    maps no argument and takes its `n` lanes from `axis_size`. (JAX maps a
    dummy index array and drops it again; a dummy tensor would pin a
    device into the function.)

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> tr = gx.normal.repeat(n=3).simulate(torch.Generator().manual_seed(0), (0.0, 1.0), n=5)
    >>> tr.get_retval().shape, tr.get_score().shape
    (torch.Size([5, 3]), torch.Size([5]))
    """
    return Vmap(gen_fn, None, n)


def repeat(*, n: int):
    """Decorator form of `RepeatCombinator`."""

    def decorator(gen_fn: GenerativeFunction[R]) -> GenerativeFunction[R]:
        return RepeatCombinator(gen_fn, n=n)

    return decorator
