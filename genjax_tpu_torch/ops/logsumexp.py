"""Logsumexp of a 1-D vector, alone or with the effective sample size of
the vector as log weights: the CUDA kernel, its plain twins, and the
dispatch between them.

Counterpart of `genjax_tpu/ops/logsumexp.py::fused_logsumexp` (the Pallas
TPU kernel) and of `ops/__init__.py::maybe_fused_logsumexp`, and, for the
pair, of `genjax_tpu/inference/smc.py::ess`. The kernel is
`csrc/logsumexp.cu`; its header says how it is laid out and what bounds
it. The log-sum-exp follows `jax.scipy.special.logsumexp`: all `-inf`
gives `-inf`, any `+inf` gives `+inf`, any NaN gives NaN, an empty vector
`-inf`. The ESS follows JAX's `ess`: empty gives `+inf`, all `-inf` NaN,
any `+inf` NaN, any NaN NaN.

`logsumexp(x)` and `logsumexp_ess(x)` run the plain version for a CPU
tensor and the kernel for a CUDA tensor, always: there is no size
threshold, no opt-in switch and no fallback from the kernel to the plain
version. Each call is one kernel launch. Its scratch (one partial per
block and the counter that picks the block that merges them) is allocated
and zeroed once per (device, stream) and kept.

The kernel's log-sum-exp is differentiable: where `x` requires a gradient
(and autograd records), the launch runs inside a `torch.autograd.Function`
whose backward is `g * exp(x - lse)` in plain torch ops, the gradient of
`torch.logsumexp`. The ESS of `logsumexp_ess` has no gradient. The JAX
package has no backward kernel to port: it differentiates XLA's
`logsumexp`, its fused kernel being opt-in.
"""

import ctypes
import functools
import time

import torch
from torch.autograd.function import once_differentiable

from genjax_tpu_torch.ops import _build
from genjax_tpu_torch.utils.profiling import annotate, record_setup, span

_THREADS = 256  # kThreads in csrc/logsumexp.cu
_VEC = 4  # kVec: 16-byte loads per thread per step
_BLOCKS_PER_SM = 4  # kBlocksPerSm: the kernel's launch bound
_BLOCK_STEP = _THREADS * _VEC * 4  # float32 values one block reads per step


def launch_geometry(n: int, sm_count: int) -> tuple[int, int]:
    """(blocks, workspace blocks) of a launch over `n` values on a card with
    `sm_count` SMs: one block per step of 4096 values, at least one, and at
    most one resident wave (`sm_count * 4`), which is also how many
    partials the workspace holds. The kernel's grid-stride loop covers
    whatever one wave does not.

    >>> launch_geometry(1_000_000, 132), launch_geometry(16_777_216, 132)
    ((245, 528), (528, 528))
    """
    cap = sm_count * _BLOCKS_PER_SM
    return max(1, min(-(-n // _BLOCK_STEP), cap)), cap


def _check_vector(x: torch.Tensor) -> None:
    if x.dim() != 1:
        raise ValueError(f"logsumexp takes a 1-D vector; got shape {tuple(x.shape)}.")


def logsumexp_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a float32 0-d tensor on `x`'s device."""
    _check_vector(x)
    if x.numel() == 0:
        return torch.full((), -torch.inf, dtype=torch.float32, device=x.device)
    return torch.logsumexp(x.float(), 0)


def logsumexp_ess_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the pair: `(logsumexp(x), ess)`, with
    the ESS computed as `genjax_tpu/inference/smc.py::ess` computes it,
    `exp(-logsumexp(2 (x - logsumexp(x))))`."""
    lse = logsumexp_plain(x)
    return lse, torch.exp(-logsumexp_plain(2.0 * (x.float() - lse)))


@functools.cache
def _kernel():
    start = time.perf_counter_ns()
    nvcc = not _build.library_path("logsumexp").exists()
    with span("setup.k1_load"):
        fn = _build.load_library("logsumexp").genjax_logsumexp_f32
    record_setup("setup.k1_load", start, nvcc=nvcc)
    fn.argtypes = [
        ctypes.c_void_p,  # x
        ctypes.c_int64,  # n
        ctypes.c_void_p,  # partials
        ctypes.c_void_p,  # counter
        ctypes.c_void_p,  # out
        ctypes.c_int64,  # blocks
        ctypes.c_int,  # ess
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


# (device index, stream handle) -> (workspace, partials pointer, counter
# pointer, SM count). The workspace is never freed: a launch may still be
# queued on its stream.
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, int, int, int]] = {}


def _workspace(device: torch.device, stream: int) -> tuple[torch.Tensor, int, int, int]:
    ws = _workspaces.get((device.index, stream))
    if ws is None:
        sm_count = torch.cuda.get_device_properties(device).multi_processor_count
        _, cap = launch_geometry(0, sm_count)
        # `cap` float4 partials, then the uint32 counter; zeroed on `stream`,
        # the current stream, ahead of the first launch.
        buf = torch.zeros(4 * cap + 4, dtype=torch.float32, device=device)
        ws = _workspaces[(device.index, stream)] = (buf, buf.data_ptr(), buf.data_ptr() + 16 * cap, sm_count)
    return ws


def _checked(x: torch.Tensor) -> torch.Tensor:
    _check_vector(x)
    if not x.is_contiguous():
        raise ValueError("logsumexp kernel: the vector must be contiguous.")
    if x.device.type != "cuda":
        raise ValueError(f"logsumexp kernel: the vector must be on a CUDA device, not {x.device}.")
    return x if x.dtype == torch.float32 else x.float()


def _launch(x: torch.Tensor, out: torch.Tensor, ess: bool) -> None:
    index = x.device.index
    # The raw handle of the current stream: `torch.cuda.current_stream()`
    # builds a Stream object, several microseconds per call on the host.
    stream = torch._C._cuda_getCurrentRawStream(index)
    _, partials, counter, sm_count = _workspace(x.device, stream)
    blocks, _ = launch_geometry(x.numel(), sm_count)
    args = (x.data_ptr(), x.numel(), partials, counter, out.data_ptr(), blocks, ess, stream)
    # The launch goes to the current device: switch only when x is elsewhere.
    if index == torch.cuda.current_device():
        err = _kernel()(*args)
    else:
        with torch.cuda.device(index):
            err = _kernel()(*args)
    if err != 0:
        raise RuntimeError(f"logsumexp kernel launch failed: CUDA error {err}.")


def _forward(x: torch.Tensor, ess: bool) -> torch.Tensor:
    """One launch: the log-sum-exp (0-d), or the pair (2 elements)."""
    out = torch.empty(2 if ess else (), dtype=torch.float32, device=x.device)
    _launch(x, out, ess)
    return out


def lse_backward(g: torch.Tensor, x: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The gradient of `logsumexp` with respect to `x`: `g * exp(x - lse)`
    (the softmax of `x` scaled by the incoming gradient `g`)."""
    return g * torch.exp(x - lse)


class _Differentiable(torch.autograd.Function):
    """The kernel's forward with the log-sum-exp's gradient: one launch
    forward, plain torch ops backward. With `ess`, the second output (the
    ESS) is marked non-differentiable."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, ess: bool):
        out = _forward(x, ess)
        if not ess:
            ctx.save_for_backward(x, out)
            return out
        lse, ess_value = out.unbind()
        ctx.save_for_backward(x, lse)
        ctx.mark_non_differentiable(ess_value)
        return lse, ess_value

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor, *_ess_grad):
        x, lse = ctx.saved_tensors
        return lse_backward(g, x, lse), None


def _recording(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


@annotate("k1.logsumexp")
def fused_logsumexp(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a contiguous 1-D CUDA tensor; a float32
    0-d tensor on the same device, without a host synchronisation. Other
    real dtypes are cast to float32 first. Raises on anything else, and if
    the kernel cannot be built or launched. Differentiable where `x`
    requires a gradient."""
    x = _checked(x)
    out = _Differentiable.apply(x, False) if _recording(x) else _forward(x, False)
    fused_logsumexp.launches += 1
    return out


@annotate("k1.logsumexp_ess")
def fused_logsumexp_ess(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`(logsumexp(x), ess)` from one launch of the CUDA kernel, as two
    float32 0-d views of one 2-element tensor on `x`'s device, without a
    host synchronisation. Takes and refuses what `fused_logsumexp` does.
    The log-sum-exp is differentiable where `x` requires a gradient; the
    ESS is not."""
    x = _checked(x)
    out = _Differentiable.apply(x, True) if _recording(x) else _forward(x, True).unbind()
    fused_logsumexp_ess.launches += 1
    return out


# Kernel launches since the count was last set to 0.
fused_logsumexp.launches = 0
fused_logsumexp_ess.launches = 0


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """`log(sum(exp(x)))` of a 1-D vector, as a float32 0-d tensor: the
    plain version on the CPU, the CUDA kernel on a CUDA device."""
    if x.device.type == "cpu":
        return logsumexp_plain(x)
    return fused_logsumexp(x)


def logsumexp_ess(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`(logsumexp(x), ess(x))` of a 1-D vector of log weights, as float32
    0-d tensors: the plain version on the CPU, one launch of the CUDA
    kernel on a CUDA device."""
    if x.device.type == "cpu":
        return logsumexp_ess_plain(x)
    return fused_logsumexp_ess(x)
