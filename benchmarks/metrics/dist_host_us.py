"""Host time of the distributions layer, in us per SIR trial or per filter
step: the self time of the program's `dist.draw` and `dist.density` spans
(`distributions/distribution.py`: a site's fresh draw and its constrained
density) in the traced segment's last attempt."""

from pathlib import Path

from harness.spec import load_module

spans = load_module(Path(__file__).with_name("_spans.py"), "bench_metric_spans")


def read(ctx):
    return spans.self_us_per_unit(ctx, ("dist.draw", "dist.density"))
