"""Type aliases, the default dtype, and device helpers.

Counterpart of `genjax_tpu/core/typing.py`. float32 is the default real
type, as in JAX without x64. Python numbers stay Python numbers where a
torch operation accepts them (no host-to-device copy per site); values
that must be tensors are made on an explicit device.
"""

from typing import Any, TypeAlias

import torch

FloatArray: TypeAlias = float | torch.Tensor

DEFAULT_DTYPE = torch.float32


def device_of(*xs: Any, default: torch.device | str | None = None) -> torch.device:
    """The device of the first tensor among `xs`, else `default` (else CPU)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device(default if default is not None else "cpu")


def as_value(v: Any, device: torch.device | str) -> torch.Tensor:
    """A constrained or assessed value as a tensor: tensors pass through
    untouched, Python bools become bool tensors and other Python numbers
    float32 tensors on `device`."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, bool):
        return torch.tensor(v, device=device)
    return torch.tensor(v, dtype=DEFAULT_DTYPE, device=device)


def host_scalar(v: Any) -> float | None:
    """The value of `v` as a Python float when the host can read it for
    free: a Python number, or a 0-d CPU tensor. None otherwise, and never
    a read of a CUDA tensor (that would synchronise with the device)."""
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, torch.Tensor) and v.device.type == "cpu" and v.dim() == 0:
        if v.dtype == torch.bool:
            return None
        return float(v)
    return None


def sample_shape(n: int | None, *params: Any) -> torch.Size:
    """The shape of one site's draw: the broadcast of its parameters'
    shapes, widened by a leading particle axis of length `n` when given.
    A scalar parameter and an `(n,)` particle column both broadcast."""
    shapes = [p.shape for p in params if isinstance(p, torch.Tensor)]
    base = torch.broadcast_shapes(*shapes) if shapes else torch.Size()
    if n is None:
        return base
    return torch.broadcast_shapes((n,), base)
