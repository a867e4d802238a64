"""Host time of the generative-function layer, in us per SIR trial or per
filter step: the self time of the program's `gen.generate` spans
(`lang/static.py`: the `@gen` body and its handler, less the sites'
distributions below it) in the traced segment's last attempt."""

from pathlib import Path

from harness.spec import load_module

spans = load_module(Path(__file__).with_name("_spans.py"), "bench_metric_spans")


def read(ctx):
    return spans.self_us_per_unit(ctx, ("gen.generate",))
