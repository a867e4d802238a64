"""Host time of the filter's resampler, in us per filter step: the self time
of the program's `filter.resample` (the ancestors' draw) and
`filter.take_rows` (the row copy) spans, the gate's firings and the final
resample, in the traced segment's last attempt."""

from pathlib import Path

from harness.spec import load_module

spans = load_module(Path(__file__).with_name("_spans.py"), "bench_metric_spans")


def read(ctx):
    return spans.self_us_per_unit(ctx, ("filter.resample", "filter.take_rows"))
