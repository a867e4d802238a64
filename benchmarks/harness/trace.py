"""The traced segment of a `--trace 1` run and its reduction.

After the measured window, a fixed number of calls of the same program run
under `torch.profiler` (CUPTI device intervals and the host's CUDA API
calls). From the trace:

- busy: the length of the union of the device intervals; the window is
  the host-clock length of the traced calls, ending in a synchronisation;
- launches: the host's kernel-launch API calls (`*LaunchKernel*` events),
  with K1's launches added from its wrappers' counters when a probe shows
  that the trace does not list launches made through `ctypes`;
- K1: each of its device kernels with its duration, beside the launches
  its wrappers counted in the same calls;
- the breakdown: the device operations that took most time, and the
  longest idle gaps by the host operation running at each gap's middle.

The profiler has dropped device intervals on this card before, so a trace
whose K1 kernels do not match K1's counted launches, or that has no device
interval, is taken again (at most `ATTEMPTS` times); if it still does not
match, the trace is marked incomplete and the readers that need every
interval report nothing.

`busy_us` and the retake loop are copies of `genjax_tpu_torch/profiling.py`'s.
"""

import bisect
import math
import time
from collections import defaultdict

import torch

from harness import k1

ATTEMPTS = 3
TOP = 10
NAME_CHARS = 160


def busy_us(intervals) -> float:
    """The length of the union of `(start, end)` intervals.

    >>> busy_us([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)])
    4.0
    """
    total, reached = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end > reached:
            total += end - max(start, reached)
            reached = end
    return total


def merged(intervals) -> list:
    """The union of `(start, end)` intervals as disjoint sorted intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _activities():
    return [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def _is_launch(name: str) -> bool:
    return "LaunchKernel" in name


def k1_launches_visible(device) -> bool:
    """Whether the trace lists K1's launches among the host's launch calls:
    one K1 call traced alone."""
    x = torch.zeros(4096, device=device)
    k1.reduce(x)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=_activities()) as prof:
        k1.reduce(x)
        torch.cuda.synchronize()
    return any(_is_launch(e.name) for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU)


def profile_calls(program, first_index: int, calls: int, device) -> dict:
    """Trace `calls` calls of `program` and reduce the trace (see the module
    docstring). The indices continue the window's."""
    visible = k1_launches_visible(device)
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    for attempt in range(1, ATTEMPTS + 1):
        torch.cuda.synchronize()
        before = k1.launches()
        with torch.profiler.profile(activities=_activities()) as prof:
            t0 = time.perf_counter()
            for j in range(calls):
                program.call(first_index + j)
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        launched = k1.launches() - before
        events = prof.events()
        device_items = [(e.name, e.time_range.start, e.time_range.end) for e in events if e.device_type == cuda]
        k1_items = [(n, s, e) for n, s, e in device_items if k1.KERNEL in n]
        if device_items and len(k1_items) == launched:
            break
    host_ops = [(e.time_range.start, e.time_range.end, e.name) for e in events if e.device_type == cpu]
    launch_calls = sum(1 for _, _, n in host_ops if _is_launch(n))
    if not visible:
        launch_calls += launched
    busy_s = busy_us((s, e) for _, s, e in device_items) / 1e6
    return {
        "calls": calls,
        "attempts": attempt,
        "complete": bool(device_items) and len(k1_items) == launched,
        "window_s": window_s,
        "busy_s": busy_s,
        "device_items": len(device_items),
        "launch_calls": launch_calls,
        "k1_launches_in_trace": visible,
        "k1_launched": launched,
        "k1_kernels": [(n, (e - s) / 1e6) for n, s, e in k1_items],
        "device_by_name": _by_name(device_items),
        "idle_gaps": _idle_gaps(device_items, host_ops),
    }


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[: NAME_CHARS - 3] + "..."


def _by_name(device_items) -> list:
    """`[name, count, seconds]` of every device operation, most time first."""
    acc = defaultdict(lambda: [0, 0.0])
    for name, start, end in device_items:
        acc[name][0] += 1
        acc[name][1] += (end - start) / 1e6
    return sorted(([_short(n), c, s] for n, (c, s) in acc.items()), key=lambda r: -r[2])


def _idle_gaps(device_items, host_ops) -> list:
    """`[host operation, seconds]` of the gaps between device intervals,
    summed by the innermost `aten::` operation (else any operation) the host
    was in at each gap's middle, longest first."""
    spans = merged((s, e) for _, s, e in device_items)
    ops = sorted(host_ops)
    starts = [s for s, _, _ in ops]
    acc = defaultdict(float)
    for (_, end), (start, _) in zip(spans, spans[1:]):
        mid = 0.5 * (end + start)
        acc[_host_at(ops, starts, mid)] += (start - end) / 1e6
    return sorted(([_short(n), s] for n, s in acc.items()), key=lambda r: -r[1])


def _host_at(ops, starts, t, lookback: int = 400) -> str:
    best, best_aten = None, None
    i = bisect.bisect_right(starts, t) - 1
    for s, e, name in reversed(ops[max(0, i - lookback) : i + 1]):
        if e >= t:
            if best is None or e - s < best[0]:
                best = (e - s, name)
            if name.startswith("aten::") and (best_aten is None or e - s < best_aten[0]):
                best_aten = (e - s, name)
    chosen = best_aten or best
    return chosen[1] if chosen else "host outside any traced operation"


def breakdown(reading: dict) -> dict:
    """The result line's `breakdown`: at most `TOP` entries each."""
    return {
        "device_ops": [[n, s] for n, _, s in reading["device_by_name"][:TOP]],
        "idle_gaps": reading["idle_gaps"][:TOP],
    }
