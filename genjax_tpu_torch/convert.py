"""Carry state from the JAX package into the port.

The JAX side turns its values into numpy (`np.asarray`); these functions
turn those into the port's objects: tensors, choice maps, static traces,
chain batches and particle collections. Traces are rebuilt by the port's own fully
constrained `generate`, so their scores are the port's densities of the
carried values. Everything lands on the CUDA card unless the caller passes
`device="cpu"`. This module imports no JAX.
"""

from typing import Any

import numpy as np
import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.gfi import GenerativeFunction
from genjax_tpu_torch.core.typing import per_particle
from genjax_tpu_torch.inference.smc import ParticleCollection
from genjax_tpu_torch.lang.static import StaticTrace


def tensor(x: Any, device: torch.device | str = "cuda") -> torch.Tensor:
    """A numpy array (or scalar) as a tensor on `device`, dtype kept."""
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def choice_map(entries: dict, device: torch.device | str = "cuda") -> ChoiceMap:
    """`{address: array}` (an address is a string or a tuple of strings) as
    a choice map of tensors."""
    return ChoiceMap.d({addr: tensor(v, device) for addr, v in entries.items()})


def _args(args: tuple, device) -> tuple:
    return tuple(tensor(a, device) if isinstance(a, np.ndarray) else a for a in args)


def static_trace(
    gen_fn: GenerativeFunction,
    args: tuple,
    choices: dict,
    n: int | None = None,
    device: torch.device | str = "cuda",
    observations: dict | None = None,
) -> StaticTrace:
    """The port's trace of `gen_fn(*args)` holding exactly `choices` and
    `observations` (`{address: array}`). With `n`, every array of
    `choices` carries a leading particle axis of length `n` and is recorded
    so; the arrays of `observations` are shared by every particle. Numpy
    arguments become tensors. Every address of the model must be given: a
    missing one raises `MissingAddress` instead of being drawn afresh."""
    mark = per_particle if n is not None else (lambda v: v)
    chm = ChoiceMap.d({addr: mark(tensor(v, device)) for addr, v in choices.items()})
    chm = chm | choice_map(observations or {}, device)
    args = _args(args, device)
    gen_fn.assess(chm, args, n)  # raises MissingAddress for an absent address
    trace, _ = gen_fn.generate(torch.Generator(device=device), chm, args, n)
    return trace


def chain_batch(
    gen_fn: GenerativeFunction,
    args: tuple,
    per_chain: dict,
    shared: dict | None = None,
    device: torch.device | str = "cuda",
) -> StaticTrace:
    """A JAX chain batch carried across: the arrays of `per_chain` hold
    one row per chain (C rows each, as JAX's `vmap`-built batch holds
    them), those of `shared` (the observations) one copy for every chain.
    For logistic regression: `chain_batch(logistic_regression, (X,),
    {"w": w}, {"ys": ys})`. The scores are the port's own densities."""
    counts = {np.shape(v)[0] for v in per_chain.values()}
    if len(counts) != 1:
        raise ValueError(f"chain_batch: the per-chain arrays disagree on the chain count: {counts}")
    return static_trace(gen_fn, args, per_chain, counts.pop(), device, shared)


def particle_collection(
    gen_fn: GenerativeFunction,
    args: tuple,
    choices: dict,
    log_weights: np.ndarray,
    device: torch.device | str = "cuda",
    observations: dict | None = None,
) -> ParticleCollection:
    """A `ParticleCollection` of the particles `choices` (K rows per
    address) and the shared `observations`, with `log_weights`."""
    lw = tensor(log_weights, device)
    particles = static_trace(gen_fn, args, choices, lw.shape[0], device, observations)
    return ParticleCollection(particles, lw)
