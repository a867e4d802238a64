"""One run of one cell: set-up, the measured window, the traced segment,
the judge, and the result.

`run_cell` is what `run.py` calls on the card. The tests call it on the
CPU at small sizes (`device="cpu"`, `overrides`), and with `control=True`
the reference's control takes the program's place.
"""

import gc
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

from harness import clock, k1, spec
from harness import trace as tracing
from harness.seeds import derive
from harness.window import run_window

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "genjax_tpu")


@dataclass
class Context:
    """What a metric's reader reads."""

    cell: spec.Cell
    traffic: dict
    setup_s: float
    window: object
    work: dict
    facts: dict
    trace: dict | None = None


@dataclass
class Outcome:
    result: dict
    lines: list  # earlier lines of standard output
    checks: list  # (name, value, limit, passed)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


def power_limit_w() -> float | None:
    """The card's power limit by `nvidia-smi`, or None where it cannot be
    read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30,
        )
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _read_metrics(metrics: list, ctx: Context) -> dict:
    out = {}
    for m in metrics:
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False, overrides: dict | None = None) -> Outcome:
    """One run of `cell`: the program (or, with `control`, the reference's
    control in its place) on `device`, with `overrides` of the traffic's
    parameters (the tests' small sizes)."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    traffic = {**cell.traffic, **(overrides or {})}
    config = cell.config
    ref = spec.reference_module(cell)
    program_factory = ref.Control if control else spec.program_module(cell).Program
    lines = []

    marks = [("imports", clock.process_age_s())]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        built = k1.library_built()
        marks.append(("CUDA context", clock.process_age_s()))
    inputs = ref.make_inputs(config, traffic, derive(seed, "inputs"), dev)
    program = program_factory(config, traffic, inputs, derive(seed, "program"), dev)
    marks.append(("inputs and program", clock.process_age_s()))
    for i in range(traffic["warmup_calls"]):
        program.call(i)
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    setup_s = clock.process_age_s()
    marks.append(("warm-up", setup_s))

    window = run_window(program, seconds, traffic["keep"], derive(seed, "keep"))
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
    reading = None
    if trace:
        if not on_card:
            raise RuntimeError("a traced run needs the card")
        reading = tracing.profile_calls(program, window.calls, traffic["trace_calls"], dev)

    # The judge runs once the window has closed, the peak has been read and
    # the program's state is freed, but for the outputs it judges.
    calls = window.smalls
    records = [program.record(out) for out in window.kept]
    window.smalls, window.kept = None, None
    del program
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks, facts = ref.judge(config, traffic, inputs, calls, records, derive(seed, "reference"), dev)
    judge_s = time.perf_counter() - t_judge
    del records, calls

    ctx = Context(cell=cell, traffic=traffic, setup_s=setup_s, window=window,
                  work=ref.work(config, traffic, facts), facts=facts, trace=reading)
    end_to_end = _read_metrics(cell.end_to_end, ctx)
    metrics = _read_metrics(cell.per_layer, ctx) if trace else end_to_end

    judged = [(c["name"], c["value"], c["limit"], c["value"] <= c["limit"]) for c in checks]
    correct = window.failed == 0 and window.calls > 0 and all(ok for *_, ok in judged)

    dev_info = {"platform": "gpu" if on_card else dev.type, "kind": "", "count": 1, "memory_peak_bytes": 0}
    if on_card:
        limit = power_limit_w()
        dev_info.update(kind=torch.cuda.get_device_name(dev), memory_peak_bytes=peak, power_limit_w=limit)
        lines.append(f"card: {dev_info['kind']}, power limit {limit} W, {torch.cuda.device_count()} visible")
        lines.append(f"peak device memory: {peak} bytes (max_memory_allocated)")
        lines.append(f"K1 library {'found in the checkout' if built else 'built in this run'}")
    if reading is not None:
        dev_info.update(busy_s=reading["busy_s"], window_s=reading["window_s"])
        lines.append(
            f"trace: {reading['calls']} calls in {reading['window_s']} s, busy {reading['busy_s']} s, "
            f"{reading['device_items']} device items, {reading['launch_calls']} launch calls, "
            f"K1 kernels {len(reading['k1_kernels'])} of {reading['k1_launched']} launched, "
            f"K1 launches listed in the trace: {reading['k1_launches_in_trace']}, attempts {reading['attempts']}"
            + ("" if reading["complete"] else "; INCOMPLETE: the profiler dropped device intervals")
        )
        lines.append("device operations per call (count, seconds): " + "; ".join(
            f"{n} x{c / reading['calls']} {s / reading['calls']}" for n, c, s in reading["device_by_name"][:tracing.TOP]))
    lines.append("setup, seconds since the process started, after: " + ", ".join(f"{k} {v}" for k, v in marks))
    lines.append(f"window: {window.calls} calls in {window.seconds} s, {window.failed} failed; setup {setup_s} s; "
                 f"judge {judge_s} s")
    if len(window.latencies_s) >= 2:
        q = statistics.quantiles(window.latencies_s, n=100, method="inclusive")
        lines.append(f"call latency ms: p50 {1e3 * q[49]}, p90 {1e3 * q[89]}, p95 {1e3 * q[94]}, "
                     f"p99 {1e3 * q[98]}, max {1e3 * max(window.latencies_s)}, first {1e3 * window.latencies_s[0]}")
    lines.append("end-to-end: " + ", ".join(f"{k} {v['value']} {v['unit']}" for k, v in end_to_end.items()))
    lines.append("facts: " + ", ".join(f"{k} {v}" for k, v in facts.items()))

    result = {
        "correct": correct,
        "attempted": window.calls,
        "failed": window.failed,
        "metrics": metrics,
        "device": dev_info,
    }
    if reading is not None:
        result["breakdown"] = tracing.breakdown(reading)
    result["checks"] = {name: {"value": _json_number(value), "limit": limit} for name, value, limit, _ in judged}
    return Outcome(result=result, lines=lines, checks=judged)


def _json_number(x):
    """A number as it is, or its name where JSON has none (`inf`, `nan`)."""
    return x if math.isfinite(x) else str(x)
