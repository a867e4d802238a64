"""Logsumexp of a 1-D vector: the CUDA kernel, its plain twin, and the
dispatch between them.

Counterpart of `genjax_tpu/ops/logsumexp.py::fused_logsumexp` (the Pallas
TPU kernel) and of `ops/__init__.py::maybe_fused_logsumexp`. The kernel
is `csrc/logsumexp.cu`; its header says how it is laid out and what bounds
it. Both versions follow `jax.scipy.special.logsumexp`: all `-inf` gives
`-inf`, any `+inf` gives `+inf`, any NaN gives NaN, an empty vector `-inf`.

`logsumexp(x)` runs the plain version for a CPU tensor and the kernel for
a CUDA tensor, always: there is no size threshold, no opt-in switch and
no fallback from the kernel to the plain version.
"""

import ctypes
import functools
import math

import torch

from genjax_tpu_torch.ops import _build

_THREADS = 256  # kThreads in csrc/logsumexp.cu
_VALUES_PER_THREAD = 16
_MAX_BLOCKS = 1024  # the finishing pass merges one partial per thread of one block


def _check_vector(x: torch.Tensor) -> None:
    if x.dim() != 1:
        raise ValueError(f"logsumexp takes a 1-D vector; got shape {tuple(x.shape)}.")


def logsumexp_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a float32 0-d tensor on `x`'s device."""
    _check_vector(x)
    if x.numel() == 0:
        return torch.full((), -math.inf, dtype=torch.float32, device=x.device)
    return torch.logsumexp(x.float(), 0)


@functools.cache
def _kernel():
    fn = _build.load_library("logsumexp").genjax_logsumexp_f32
    fn.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def fused_logsumexp(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a contiguous 1-D CUDA tensor; a float32
    0-d tensor on the same device, without a host synchronisation. Other
    real dtypes are cast to float32 first. Raises on anything else, and if
    the kernel cannot be built or launched."""
    _check_vector(x)
    if not x.is_contiguous():
        raise ValueError("logsumexp kernel: the vector must be contiguous.")
    if x.device.type != "cuda":
        raise ValueError(
            f"logsumexp kernel: the vector must be on a CUDA device, not {x.device}."
        )
    if x.dtype != torch.float32:
        x = x.float()
    fn = _kernel()
    n = x.numel()
    blocks = max(1, min(_MAX_BLOCKS, -(-n // (_THREADS * _VALUES_PER_THREAD))))
    partials = torch.empty(2 * blocks, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), partials.data_ptr(), out.data_ptr(), n, blocks, stream)
    if err != 0:
        raise RuntimeError(f"logsumexp kernel launch failed: CUDA error {err}.")
    fused_logsumexp.launches += 1
    return out


# Kernel launches since the count was last set to 0.
fused_logsumexp.launches = 0


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """`log(sum(exp(x)))` of a 1-D vector, as a float32 0-d tensor: the
    plain version on the CPU, the CUDA kernel on a CUDA device."""
    if x.device.type == "cpu":
        return logsumexp_plain(x)
    return fused_logsumexp(x)
