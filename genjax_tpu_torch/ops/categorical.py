"""K4: the categorical's draw and score over rows of float32 logits on the
card, one launch and one read of the rows each, with their plain twins.

Counterpart of `genjax_tpu/distributions/library.py::_categorical_sample`
and `_categorical_logpdf` (`jax.random.categorical` and a log-softmax,
which XLA fuses; the JAX package has no kernel of its own for them). The
kernel is `csrc/categorical.cu`; its header says what bounds it and how it
is laid out. The twins `categorical_draw_plain` and
`categorical_score_plain` compute the same in torch: the draw by inverse
CDF from the same uniforms (float32 masses `exp(x - max)`, their prefix
sums in float64, the first column of positive mass whose sum exceeds `u`
times the total, else the last column of positive mass, else 0), the
score as `logits[v] - torch.logsumexp(logits)`, `-inf` outside `0..C-1`.

`distributions/library.py::Categorical` routes a draw or a score here
when `takes` holds for its logits; everything else (the CPU, float64,
rows wider than 64, recorded gradients) keeps the Gumbel-max draw and the
eager score. Each wrapper counts its launches (`k4_draw.launches`,
`k4_score.launches`), and opens no span: its host time counts in its
caller's (`dist.draw`, `dist.density`). The library is built or loaded at
the first launch, never at import.
"""

import ctypes
import functools
import time

import torch

from genjax_tpu_torch.ops import _build
from genjax_tpu_torch.utils.profiling import record_setup, span

MAX_CATEGORIES = 64  # kMaxC in csrc/categorical.cu


def takes(logits) -> bool:
    """Whether K4 takes a draw or score over `logits`: a CUDA float32
    tensor with 2 to `MAX_CATEGORIES` categories on its last axis, that
    axis contiguous, and no gradient recorded (the kernel has no backward).
    Reads only the tensor's attributes."""
    return (
        logits.is_cuda
        and logits.dtype == torch.float32
        and 2 <= logits.shape[-1] <= MAX_CATEGORIES
        and logits.stride(-1) == 1
        and not (logits.requires_grad and torch.is_grad_enabled())
    )


@functools.cache
def _library():
    start = time.perf_counter_ns()
    nvcc = not _build.library_path("categorical").exists()
    with span("setup.k4_load"):
        lib = _build.load_library("categorical")
    record_setup("setup.k4_load", start, nvcc=nvcc)
    lib.genjax_k4_draw.argtypes = [
        ctypes.c_void_p,  # logits
        ctypes.c_int64,  # rows
        ctypes.c_int64,  # C
        ctypes.c_int64,  # row stride
        ctypes.c_void_p,  # u
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # stream
    ]
    lib.genjax_k4_draw.restype = ctypes.c_int
    lib.genjax_k4_score.argtypes = [
        ctypes.c_void_p,  # logits
        ctypes.c_int64,  # rows
        ctypes.c_int64,  # C
        ctypes.c_int64,  # row stride
        ctypes.c_void_p,  # values
        ctypes.c_int64,  # value stride
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # stream
    ]
    lib.genjax_k4_score.restype = ctypes.c_int
    return lib


def _check_rows(logits_rows: torch.Tensor) -> None:
    if logits_rows.dim() != 2:
        raise ValueError(f"K4 takes 2-D (rows, C) logits; got shape {tuple(logits_rows.shape)}.")
    if not takes(logits_rows):
        raise ValueError(
            f"K4 takes CUDA float32 logits with 2 to {MAX_CATEGORIES} categories on a contiguous last axis and no "
            f"gradient recorded; got {logits_rows.dtype} on {logits_rows.device}, shape {tuple(logits_rows.shape)}, "
            f"strides {logits_rows.stride()}."
        )


def _launch(fn, device: torch.device, *args) -> None:
    index = device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"K4 (the categorical) launch failed: CUDA error {err}.")


def k4_draw(logits_rows: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One int64 category per row of `logits_rows` ((rows, C) on the card;
    a row stride of 0 shares one row), drawn by inverse CDF with the
    uniform `u[r]` in [0, 1) (float32, (rows,)). Raises for what the kernel
    does not take."""
    _check_rows(logits_rows)
    rows, c = logits_rows.shape
    if u.shape != (rows,) or u.dtype != torch.float32 or u.device != logits_rows.device:
        raise ValueError(f"K4's draw takes one float32 uniform a row on the logits' device; got {u.dtype} {tuple(u.shape)}.")
    out = torch.empty(rows, dtype=torch.int64, device=logits_rows.device)
    if rows:
        u = u.contiguous()
        _launch(_library().genjax_k4_draw, logits_rows.device, logits_rows.data_ptr(), rows, c,
                logits_rows.stride(0), u.data_ptr(), out.data_ptr())
        k4_draw.launches += 1
    return out


def k4_score(logits_rows: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The float32 log probability of `values[r]` under row `r` of
    `logits_rows` ((rows, C) on the card), `-inf` where the value is not in
    `0..C-1`. `values` is (rows,) int64 on the same device; a stride of 0
    shares one value. Raises for what the kernel does not take."""
    _check_rows(logits_rows)
    rows, c = logits_rows.shape
    if values.shape != (rows,) or values.dtype != torch.int64 or values.device != logits_rows.device:
        raise ValueError(
            f"K4's score takes one int64 value a row on the logits' device; got {values.dtype} "
            f"{tuple(values.shape)} on {values.device}."
        )
    out = torch.empty(rows, dtype=torch.float32, device=logits_rows.device)
    if rows:
        _launch(_library().genjax_k4_score, logits_rows.device, logits_rows.data_ptr(), rows, c,
                logits_rows.stride(0), values.data_ptr(), values.stride(0), out.data_ptr())
        k4_score.launches += 1
    return out


# Launches since the count was last set to 0.
k4_draw.launches = 0
k4_score.launches = 0


def categorical_draw_plain(logits_rows: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K4's draw in torch, on any device: the value of each row of
    `logits_rows` (rows, C) for the uniform `u[r]`, by the kernel's rule.

    >>> rows = torch.log(torch.tensor([[0.5, 0.0, 0.5], [0.2, 0.3, 0.5]]))
    >>> categorical_draw_plain(rows, torch.tensor([0.6, 0.4])).tolist()
    [2, 1]
    """
    e = torch.exp(logits_rows - logits_rows.amax(-1, keepdim=True))
    s = torch.cumsum(e.double(), -1)
    mass = e > 0
    hit = (s > u.double().unsqueeze(-1) * s[..., -1:]) & mass
    first = torch.argmax(hit.to(torch.uint8), -1)
    last = logits_rows.shape[-1] - 1 - torch.argmax(mass.flip(-1).to(torch.uint8), -1)
    return torch.where(hit.any(-1), first, torch.where(mass.any(-1), last, 0))


def categorical_score_plain(logits_rows: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """K4's score in torch, on any device: `logits[v] - logsumexp(logits)`
    a row for int64 values `v`, `-inf` where `v` is not in `0..C-1`.

    >>> categorical_score_plain(torch.zeros(3, 4), torch.tensor([0, -1, 4])).tolist()
    [-1.3862943649291992, -inf, -inf]
    """
    in_support = (values >= 0) & (values < logits_rows.shape[-1])
    picked = torch.gather(logits_rows, -1, torch.where(in_support, values, 0).unsqueeze(-1)).squeeze(-1)
    return torch.where(in_support, picked - torch.logsumexp(logits_rows, -1), -torch.inf)
