"""Carry state from the JAX package into the port.

The JAX side turns its values into numpy (`np.asarray`); these functions
turn those into the port's objects: tensors, choice maps, static traces
and particle collections. Traces are rebuilt by the port's own fully
constrained `generate`, so their scores are the port's densities of the
carried values. Everything lands on the CUDA card unless the caller passes
`device="cpu"`. This module imports no JAX.
"""

from typing import Any

import numpy as np
import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.gfi import GenerativeFunction
from genjax_tpu_torch.inference.smc import ParticleCollection
from genjax_tpu_torch.lang.static import StaticTrace


def tensor(x: Any, device: torch.device | str = "cuda") -> torch.Tensor:
    """A numpy array (or scalar) as a tensor on `device`, dtype kept."""
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def choice_map(entries: dict, device: torch.device | str = "cuda") -> ChoiceMap:
    """`{address: array}` (an address is a string or a tuple of strings) as
    a choice map of tensors."""
    return ChoiceMap.d({addr: tensor(v, device) for addr, v in entries.items()})


def static_trace(
    gen_fn: GenerativeFunction,
    args: tuple,
    choices: dict,
    n: int | None = None,
    device: torch.device | str = "cuda",
) -> StaticTrace:
    """The port's trace of `gen_fn(*args)` holding exactly `choices`
    (`{address: array}`, with a leading particle axis of length `n` where
    given). Every address of the model must be in `choices`: a missing one
    raises `MissingAddress` instead of being drawn afresh."""
    chm = choice_map(choices, device)
    gen_fn.assess(chm, args)  # raises MissingAddress for an absent address
    trace, _ = gen_fn.generate(torch.Generator(device=device), chm, args, n)
    return trace


def particle_collection(
    gen_fn: GenerativeFunction,
    args: tuple,
    choices: dict,
    log_weights: np.ndarray,
    device: torch.device | str = "cuda",
) -> ParticleCollection:
    """A `ParticleCollection` of the particles `choices` (K rows per
    per-particle address, shared values unbatched) with `log_weights`."""
    lw = tensor(log_weights, device)
    particles = static_trace(gen_fn, args, choices, n=lw.shape[0], device=device)
    return ParticleCollection(particles, lw)
