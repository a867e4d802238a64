"""Host time of K1's enqueue, in us per SIR trial or per filter step: the
self time of the program's `k1.logsumexp` and `k1.logsumexp_ess` spans
(`ops/logsumexp.py`'s kernel wrappers: the checks and the launch through
`ctypes`) in the traced segment's last attempt."""

from pathlib import Path

from harness.spec import load_module

spans = load_module(Path(__file__).with_name("_spans.py"), "bench_metric_spans")


def read(ctx):
    return spans.self_us_per_unit(ctx, ("k1.logsumexp", "k1.logsumexp_ess"))
