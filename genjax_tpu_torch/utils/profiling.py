"""Profiling helpers: named spans, trace capture, device memory and
operation counts.

Counterpart of `genjax_tpu/utils/profiling.py`, on `torch.profiler`:
`annotate` puts a function's calls in a labelled span
(`torch.profiler.record_function`, JAX's `named_scope`), `profile_trace`
captures a Chrome trace of the CPU and, where there is one, the CUDA
device, `device_memory_stats` reads the CUDA allocator's counters, and
`cost_summary` counts the work of one call of a function.

(The card's measurement script of the port is `genjax_tpu_torch/profiling.py`,
a different module.)
"""

import contextlib
import functools
import os
import tempfile
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def annotate(name: str) -> Callable:
    """Decorator: each call of the function is a span named `name` in
    profiler traces.

    >>> from genjax_tpu_torch.utils.profiling import annotate
    >>> annotate("double")(lambda x: x * 2)(2.0)
    4.0
    """

    def decorator(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return decorator


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """Profile the block (CPU, and CUDA where available) and write a Chrome
    trace, `trace.json`, into `log_dir` (by default a directory under the
    temporary directory); yields `log_dir`."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "genjax_tpu_torch_profile")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device=None) -> dict:
    """The CUDA allocator's counters (bytes) under JAX's keys:
    `bytes_in_use`, `peak_bytes_in_use`, `bytes_limit` (the device's total
    memory). `{}` on the CPU, as JAX's CPU backend reports nothing."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_limit": torch.cuda.mem_get_info(device)[1],
    }


_MATMULS = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot", "vdot"}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum", "cumprod", "logsumexp",
    "norm", "linalg_vector_norm", "var", "std", "any", "all", "argmax", "argmin",
}  # fmt: skip
# XLA's transcendental operations (hlo_cost_analysis): one per output element.
_TRANSCENDENTALS = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sigmoid", "pow", "rsqrt", "sqrt",
    "sin", "cos", "tan", "tanh", "erf", "erfc", "erfinv", "atan2", "lgamma", "digamma",
}  # fmt: skip
_FREE = {"detach", "lift_fresh", "empty", "empty_like", "empty_strided", "_local_scalar_dense"}


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if func.is_view or name in _FREE:
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        n_out = sum(_numel(t) for t in outs)
        if name in _MATMULS:
            # (..., m, k) @ (..., k, n): 2 m k n per batch entry.
            a, b = (ins[-2], ins[-1]) if len(ins) >= 2 else (ins[0], ins[0])
            k = a.shape[-1] if a.dim() else 1
            self.flops += 2 * n_out * k
        elif name in _REDUCTIONS:
            self.flops += max(_numel(ins[0]) if ins else 0, n_out)
        else:
            self.flops += n_out
        if name in _TRANSCENDENTALS:
            self.transcendentals += n_out
        elif name in ("logsumexp", "softmax", "_softmax", "log_softmax", "_log_softmax"):
            self.transcendentals += _numel(ins[0]) + n_out
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return out


def cost_summary(fn, *args, **kwargs) -> dict:
    """The work of one call `fn(*args, **kwargs)`, counted per aten
    operation as it runs: `flops` (2 m n k for a matmul, one per output
    element for an elementwise operation, one per input element for a
    reduction), `bytes accessed` (every operation's input and output
    bytes), `transcendentals` (output elements of exp, log, sin, pow,
    sqrt and the others XLA counts), and `memory_bytes` (on CUDA the rise
    of the allocator's peak during the call, which resets its peak
    statistic; 0 on the CPU).

    XLA counts after fusion, where an intermediate never reaches memory;
    here every operation reads and writes its tensors, so where XLA fuses
    (an elementwise chain) `bytes accessed` is larger than JAX's, and the
    flops of operations that XLA folds away are counted. Kernels launched
    outside PyTorch's dispatcher (K1, `ops.logsumexp` on a CUDA tensor)
    are not seen.

    >>> import torch
    >>> from genjax_tpu_torch.utils.profiling import cost_summary
    >>> s = cost_summary(lambda x: (x @ x.T).sum(), torch.ones(64, 64))
    >>> s["flops"] >= 2 * 64 * 64 * 64, s["transcendentals"]
    (True, 0.0)
    """
    cuda = torch.cuda.is_available() and any(
        isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves((args, kwargs))
    )
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    counter = _Counter()
    with counter:
        fn(*args, **kwargs)
    memory = 0
    if cuda:
        torch.cuda.synchronize()
        memory = torch.cuda.max_memory_allocated() - base
    return {
        "flops": float(counter.flops),
        "bytes accessed": float(counter.bytes),
        "transcendentals": float(counter.transcendentals),
        "memory_bytes": float(memory),
    }
