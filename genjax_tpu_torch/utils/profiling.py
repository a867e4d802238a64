"""Profiling helpers: the program's spans, trace capture, device memory
and operation counts.

Counterpart of `genjax_tpu/utils/profiling.py`, on `torch.profiler`:

- `span(name)` marks a block as a span of the program (JAX's
  `named_scope`). It records only while a `torch.profiler` is running:
  then the block is an event of the profiler's trace, on the same clock as
  the device's intervals, and a `SpanRecord` in a bounded in-memory buffer
  of the newest `SPAN_BUFFER` records (`spans()`, `reset_spans()`). With
  no profiler running, it reads one flag and returns a shared no-op
  context. `annotate(name)` is its decorator form.
- `record_setup` keeps the duration of a set-up step that runs once per
  process (importing the package, building or loading K1), whether or
  not a profiler runs; `setup_spans()` reads them.
- `profile_trace` captures a Chrome trace of the CPU and, where there is
  one, the CUDA device; `device_memory_stats` reads the CUDA allocator's
  counters, and `cost_summary` counts the work of one call of a function.

The spans of the particle path, by module:

- `inference/smc.py`: `smc.importance` (`ImportanceK.run_smc`), `smc.lml`
  and `smc.sample_particle` (`ParticleCollection`'s
  `get_log_marginal_likelihood_estimate` and `sample_particle`);
- `inference/particle_filter.py::BootstrapFilter.run`: `filter.run`, then
  per step after the first `filter.step`, holding `filter.gate` (the ESS
  gate) with `filter.gate_read` inside it (the host's read of the gate's
  comparison, a device synchronisation), and where the gate fires
  `filter.resample` (the ancestors) and `filter.take_rows` (the row copy),
  as the final resample does too;
- `lang/static.py`: `gen.generate` (`StaticGenerativeFunction.generate`);
- `distributions/distribution.py`: `dist.draw` and `dist.density`
  (`Distribution._fresh`, a site's fresh draw, and `._density`, the
  density of a value held to a constraint, as `generate` takes them);
- `ops/logsumexp.py`: `k1.logsumexp` and `k1.logsumexp_ess`, the host's
  enqueue of K1 (`fused_logsumexp`, `fused_logsumexp_ess`);
- set-up, by `record_setup`: `setup.package_import`
  (`genjax_tpu_torch/__init__.py`), `setup.k1_load` (K1's build or load,
  `ops/logsumexp.py::_kernel`), `setup.k2_load` (K2's,
  `ops/resample.py::_library`, at the first systematic resample on the
  card) and `setup.k4_load` (K4's, `ops/categorical.py::_library`, at the
  first categorical draw or score K4 takes).

The particle path's counters, kept always (plain dicts and attributes,
counted from shapes on the host): `inference/particle_filter.py`'s
`filter_stats` (the steps after each filter's first, and the gate's
resamples); `distributions/library.py`'s `categorical_stats` (the rows
`categorical` drew and scored, the logits `entries` those rows span, and
the `k4_rows` of them that K4 took);
`inference/smc.py`'s `systematic_resample.calls` and the kernels'
`launches` (`ops.fused_logsumexp`, `ops.fused_logsumexp_ess`,
`ops.fused_systematic_ancestors`, `ops.categorical.k4_draw` and
`.k4_score`).

(The card's measurement script of the port is `genjax_tpu_torch/profiling.py`,
a different module.)
"""

import contextlib
import functools
import itertools
import os
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

SPAN_BUFFER = 65536  # records kept: the newest


@dataclass(slots=True)
class SpanRecord:
    """One span: its sequence number `seq`, `name`, the `seq` of the span it
    ran inside (`parent`, None for a root), the `seq` of its root (`root`,
    shared by every span under one root), and the host's
    `time.perf_counter_ns()` at its start and end (`end_ns` is None while
    it runs)."""

    seq: int
    name: str
    parent: int | None
    root: int
    start_ns: int
    end_ns: int | None = None


_records: deque = deque(maxlen=SPAN_BUFFER)
_seq = itertools.count()
_open = threading.local()  # each thread's stack of open spans
_setup: dict = {}


# A span's event in the profiler's trace: a host event of the `FUNCTION`
# scope, as an aten operation's. `torch.profiler.record_function` (the
# `USER_SCOPE`) would also put a `gpu_user_annotation` interval on the
# device's timeline over the kernels each span launches, which a reading of
# the device's busy time or idle gaps would count as device work.
_TraceEvent = torch._C._profiler._RecordFunctionFast


class _Span:
    __slots__ = ("name", "_event", "_record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self._event = _TraceEvent(self.name)
        self._event.__enter__()
        seq = next(_seq)
        parent, root = (stack[-1].seq, stack[-1].root) if stack else (None, seq)
        rec = self._record = SpanRecord(seq, self.name, parent, root, time.perf_counter_ns())
        stack.append(rec)
        _records.append(rec)
        return self

    def __exit__(self, *exc):
        self._record.end_ns = time.perf_counter_ns()
        _open.stack.pop()
        self._event.__exit__(*exc)
        return False


class _Off:
    """A span while no profiler runs: nothing (`contextlib.nullcontext`,
    less its stored result)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager: the block is a span named `name` while a
    `torch.profiler` runs (an event in its trace and a record in
    `spans()`); otherwise the shared no-op context, after one read of the
    profiler's flag.

    >>> from genjax_tpu_torch.utils.profiling import span, spans
    >>> with span("outside"):
    ...     pass
    >>> [r.name for r in spans() if r.name == "outside"]
    []
    """
    return _Span(name) if _autograd_profiler._is_profiler_enabled else _OFF


def annotate(name: str) -> Callable:
    """Decorator: each call of the function is `span(name)`, recorded only
    while a `torch.profiler` runs (with none running, a call costs one read
    of the profiler's flag).

    >>> from genjax_tpu_torch.utils.profiling import annotate
    >>> annotate("double")(lambda x: x * 2)(2.0)
    4.0
    """

    def decorator(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return wrapped

    return decorator


def spans() -> list:
    """The buffer's `SpanRecord`s (the newest `SPAN_BUFFER`), in the order
    the spans started."""
    return list(_records)


def reset_spans() -> None:
    """Empty the span buffer."""
    _records.clear()


def record_setup(name: str, start_ns: int, **facts) -> None:
    """Keep the set-up step `name` that started at `start_ns`
    (`time.perf_counter_ns()`) and ends now, with `facts` about it."""
    _setup[name] = {"seconds": (time.perf_counter_ns() - start_ns) / 1e9, **facts}


def setup_spans() -> dict:
    """The set-up steps of this process: name -> `{"seconds": ..., **facts}`
    (`setup.package_import`; `setup.k1_load` with `nvcc`, whether K1 was
    built by this process, once K1 has been loaded)."""
    return {name: dict(facts) for name, facts in _setup.items()}


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
