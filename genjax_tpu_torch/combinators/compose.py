"""Composed combinators: `repeat`. `mix` and `or_else` come with `switch`.

Counterpart of part of `genjax_tpu/combinators/compose.py`.
"""

from typing import TypeVar

from genjax_tpu_torch.combinators.vmap import Vmap
from genjax_tpu_torch.core.gfi import GenerativeFunction

R = TypeVar("R")


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
