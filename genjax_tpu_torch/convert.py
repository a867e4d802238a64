"""Carry state from the JAX package into the port.

The JAX side turns its values into numpy (`np.asarray`); these functions
turn those into the port's objects: tensors, choice maps (string and
integer address components), traces of `@gen` functions and of the
combinators, chain batches, particle collections and variational
parameters. Traces are rebuilt by the port's own fully
constrained `generate`, so their scores are the port's densities of the
carried values. Everything lands on the CUDA card unless the caller passes
`device="cpu"`. This module imports no JAX.
"""

from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace
from genjax_tpu_torch.core.typing import per_particle
from genjax_tpu_torch.inference.smc import ParticleCollection


def tensor(x: Any, device: torch.device | str = "cuda") -> torch.Tensor:
    """A numpy array (or scalar) as a tensor on `device`, dtype kept."""
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def choice_map(entries: dict, device: torch.device | str = "cuda", n: int | None = None) -> ChoiceMap:
    """`{address: array}` as a choice map of tensors. An address is a
    string or a tuple of strings and integers: `("data", 3, "y")` nests
    under an index as JAX's `Indexed` does, `("data", "y")` holds a
    `Vmap`'s or `Scan`'s choices stacked, as their traces store them. With
    `n`, every array carries a leading particle axis of that length (in
    front of a stacked array's lane or step axis) and is recorded so."""
    mark = per_particle if n is not None else (lambda v: v)
    return ChoiceMap.d({addr: mark(tensor(v, device)) for addr, v in entries.items()})


def _args(args: tuple, device) -> tuple:
    return tuple(tensor(a, device) if isinstance(a, np.ndarray) else a for a in args)


def trace(
    gen_fn: GenerativeFunction,
    args: tuple,
    choices: dict,
    n: int | None = None,
    device: torch.device | str = "cuda",
    observations: dict | None = None,
    kind: type | None = None,
) -> Trace:
    """The port's trace of `gen_fn(*args)` holding exactly `choices` and
    `observations` (`{address: array}`): of a `@gen` function, or of a
    combinator (a JAX `VmapTrace`, `ScanTrace` or `DimapTrace` carried
    across; a `Vmap`'s and a `Scan`'s choices are given stacked, as
    `np.asarray(tr.get_choices()["y"])` holds them). With `n`, every array
    of `choices` carries a leading particle axis of length `n`, in front of
    a lane or step axis (where JAX's `vmap` of the method puts it too), and
    is recorded so; the arrays of `observations` are shared by every
    particle. Numpy arguments become shared tensors; a per-particle
    argument is given as a tensor marked with `per_particle`. Every address
    of the model must be given: a missing one raises `MissingAddress`
    instead of being drawn afresh. The trace is rebuilt by the port's own
    `generate`, so the batch record is set and the per-lane and per-step
    scores are the port's. `kind` names the trace class the caller expects
    (`ScanTrace`, ...): another raises `TypeError`."""
    chm = choice_map(choices, device, n) | choice_map(observations or {}, device)
    args = _args(args, device)
    gen_fn.assess(chm, args, n)  # raises MissingAddress for an absent address
    built, _ = gen_fn.generate(torch.Generator(device=device), chm, args, n)
    if kind is not None and not isinstance(built, kind):
        raise TypeError(f"convert: {type(built).__name__} where a {kind.__name__} was asked for")
    return built


static_trace = trace  # the name from before the combinators


def chain_batch(
    gen_fn: GenerativeFunction,
    args: tuple,
    per_chain: dict,
    shared: dict | None = None,
    device: torch.device | str = "cuda",
) -> Trace:
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
    is_valid: Any = True,
    kind: type | None = None,
) -> ParticleCollection:
    """A JAX `ParticleCollection` carried across: the particles `choices`
    (K rows per address, stacked per step or lane for a combinator, as
    `np.asarray(col.get_particles().get_choices()[addr])` holds them), the
    shared `observations`, `log_weights` and `is_valid` (a numpy bool or a
    Python one). The traces are rebuilt through `trace` (`kind` as there)."""
    lw = tensor(log_weights, device)
    particles = trace(gen_fn, args, choices, lw.shape[0], device, observations, kind)
    valid = is_valid if isinstance(is_valid, bool) else tensor(is_valid, device)
    return ParticleCollection(particles, lw, valid)


def variational_params(params: Any, device: torch.device | str = "cuda") -> Any:
    """Variational parameters trained in JAX (a tuple, list or dict of
    numpy arrays or Python numbers, nested as the objective takes them) as
    float32 tensors on `device`, in the same structure: with them, a guide
    of the port computes the densities that the JAX guide does with the
    JAX parameters.

    >>> import numpy as np
    >>> from genjax_tpu_torch import convert
    >>> p = convert.variational_params((np.float32(1.6), {"log_sigma": np.zeros(2)}), device="cpu")
    >>> p[0].dtype, p[1]["log_sigma"].shape
    (torch.float32, torch.Size([2]))
    """
    return pytree.tree_map(lambda x: tensor(np.asarray(x, dtype=np.float32), device), params)
