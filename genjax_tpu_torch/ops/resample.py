"""K2: the ancestors of systematic resampling on the card, from the log
weights, in one call of two launches.

Counterpart of `genjax_tpu/inference/smc.py::systematic_cum_counts` with
`_blocks_to_ancestors`, and of `genjax_tpu/ops/expand.py::expand_cols`.
The kernel is `csrc/resample.cu`; its header says what bounds it and how
it is laid out. Its plain twin is
`inference/smc.py::systematic_ancestors_plain`, the composition of
`systematic_cum_counts` and `cum_counts_to_ancestors`, which the kernel
reproduces: the same float32 weights, the float64 prefix sums, the same
counts but where a particle's `n * cdf - u0` lies within float64 rounding
of an integer, and two rules the twin keeps only almost surely (a zero
weight owns no slot; the counts never decrease).

`inference/smc.py::systematic_resample` calls the twin for a CPU tensor
and `fused_systematic_ancestors` for a CUDA tensor, always, with no
fallback. The kernel's workspace (about 517 doubles a tile of 4096
particles and one a chunk of 8192 slots) is allocated and zeroed once per
(device, stream), and again, larger, for a larger K or n. The wrapper
opens no span: its host time counts in its caller's.
"""

import ctypes
import functools
import numbers
import time

import torch

from genjax_tpu_torch.ops import _build
from genjax_tpu_torch.ops.logsumexp import logsumexp
from genjax_tpu_torch.utils.profiling import record_setup, span

_THREADS = 256  # kThreads in csrc/resample.cu
_TILE = _THREADS * 16  # kTile: particles a block takes
_CHUNK = 8192  # kChunk: slots a block writes at a time
_MAX = 2**31 - 1  # particles and slots the kernel indexes with 32 bits


def tiles(k: int) -> int:
    """The tiles of `k` particles, one block each in both launches.

    >>> tiles(4096), tiles(4097), tiles(4_194_304)
    (1, 2, 1024)
    """
    return -(-k // _TILE)


def chunks(n: int) -> int:
    """The chunks of `n` output slots, one more block each in the second
    launch (it writes a chunk's slots of the tiles that own many).

    >>> chunks(8192), chunks(4_194_304)
    (1, 512)
    """
    return -(-n // _CHUNK)


@functools.cache
def _library():
    start = time.perf_counter_ns()
    nvcc = not _build.library_path("resample").exists()
    with span("setup.k2_load"):
        lib = _build.load_library("resample")
    record_setup("setup.k2_load", start, nvcc=nvcc)
    lib.genjax_k2_systematic.argtypes = [
        ctypes.c_void_p,  # lw
        ctypes.c_int64,  # K
        ctypes.c_void_p,  # lse_ptr
        ctypes.c_float,  # lse
        ctypes.c_void_p,  # u0_ptr
        ctypes.c_float,  # u0
        ctypes.c_int64,  # n
        ctypes.c_void_p,  # workspace
        ctypes.c_int64,  # cap
        ctypes.c_int64,  # chunk_cap
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # stream
    ]
    lib.genjax_k2_systematic.restype = ctypes.c_int
    lib.genjax_k2_workspace_doubles.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.genjax_k2_workspace_doubles.restype = ctypes.c_int64
    return lib


# (device index, stream handle) -> (workspace, its tiles, its chunks). A
# workspace outgrown is dropped: the caching allocator hands its memory only
# to work queued after the launches on the same stream that used it.
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, int, int]] = {}


def _workspace(device: torch.device, stream: int, k: int, n: int) -> tuple[torch.Tensor, int, int]:
    ws = _workspaces.get((device.index, stream))
    if ws is None or ws[1] < tiles(k) or ws[2] < chunks(n):
        cap, chunk_cap = max(tiles(k), 1024, ws[1] if ws else 0), max(chunks(n), 512, ws[2] if ws else 0)
        doubles = _library().genjax_k2_workspace_doubles(cap, chunk_cap)
        buf = torch.zeros(doubles, dtype=torch.float64, device=device)
        ws = _workspaces[(device.index, stream)] = (buf, cap, chunk_cap)
    return ws


def _scalar(v, what: str, device: torch.device) -> tuple[torch.Tensor | None, float]:
    """(tensor, value) of a scalar argument: a 0-d tensor on the card as a
    float32 tensor (the twin computes with it in float32), a CPU tensor or
    a number as a value (never copied to the card)."""
    if isinstance(v, torch.Tensor):
        if v.dim() != 0:
            raise ValueError(f"K2: {what} must be a 0-d tensor or a number; got shape {tuple(v.shape)}.")
        if v.device.type == "cpu":
            return None, float(v)
        if v.device != device:
            raise ValueError(f"K2: {what} is on {v.device}, the log weights on {device}.")
        return (v if v.dtype == torch.float32 else v.float()), 0.0
    if isinstance(v, numbers.Real):
        return None, float(v)
    raise TypeError(f"K2: {what} must be a 0-d tensor or a number, not {type(v).__name__}.")


def fused_systematic_ancestors(u0, log_weights: torch.Tensor, n: int, lse=None) -> torch.Tensor:
    """The `n` ancestors (int64, on the weights' device) that systematic
    resampling with the uniform `u0` in [0, 1) gives float32 log weights
    `log_weights` (1-D, on a CUDA device), from one call of K2 without a
    host synchronisation. `lse` is `logsumexp(log_weights)`: a 0-d tensor on
    the card, a number, or None (then K1 computes it first). Raises for
    anything the kernel does not take, and if it cannot be built or
    launched."""
    if log_weights.dim() != 1:
        raise ValueError(f"K2 takes a 1-D vector of log weights; got shape {tuple(log_weights.shape)}.")
    if log_weights.dtype != torch.float32:
        raise ValueError(f"K2 takes float32 log weights, not {log_weights.dtype}.")
    if log_weights.device.type != "cuda":
        raise ValueError(f"K2: the log weights must be on a CUDA device, not {log_weights.device}.")
    k, device = log_weights.numel(), log_weights.device
    if not 0 < k <= _MAX or not 0 <= n <= _MAX:
        raise ValueError(f"K2 takes 1 to 2^31 - 1 particles and at most 2^31 - 1 slots; got {k} and {n}.")
    out = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out
    lw = log_weights.contiguous()
    if lse is None:
        lse = logsumexp(lw)
    lse_t, lse_value = _scalar(lse, "lse", device)
    u0_t, u0_value = _scalar(u0, "u0", device)
    index = device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    buf, cap, chunk_cap = _workspace(device, stream, k, n)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (lw.data_ptr(), k, ptr(lse_t), lse_value, ptr(u0_t), u0_value, n, buf.data_ptr(), cap, chunk_cap,
            out.data_ptr(), stream)
    lib = _library()
    if index == torch.cuda.current_device():
        err = lib.genjax_k2_systematic(*args)
    else:
        with torch.cuda.device(index):
            err = lib.genjax_k2_systematic(*args)
    if err != 0:
        raise RuntimeError(f"K2 (systematic resampling) launch failed: CUDA error {err}.")
    fused_systematic_ancestors.launches += 1
    return out


# Calls that launched the kernel since the count was last set to 0.
fused_systematic_ancestors.launches = 0
