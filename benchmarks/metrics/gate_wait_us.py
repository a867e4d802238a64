"""The host's wait on the device at the filter's ESS gate, in us per filter
step: the time of the program's `filter.gate_read` spans (the host's read
of the gate's comparison, one device synchronisation a step) in the traced
segment's last attempt."""

from pathlib import Path

from harness.spec import load_module

spans = load_module(Path(__file__).with_name("_spans.py"), "bench_metric_spans")


def read(ctx):
    return spans.self_us_per_unit(ctx, ("filter.gate_read",))
