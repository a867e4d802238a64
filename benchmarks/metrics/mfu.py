"""The whole call's share of the chip's peak, in %: the least time of the
work the reference counts for one call (`work()`: the larger of its
float32 operations over 67 TFLOP/s and its bytes over 3.35 TB/s) over the
measured time per call of the untraced window."""

from harness import peaks


def read(ctx):
    w = ctx.work
    if "flops_per_call" not in w or ctx.window.calls == 0:
        return None
    least = peaks.least_seconds(w["flops_per_call"], w["bytes_per_call"])
    return 100.0 * least / (ctx.window.seconds / ctx.window.calls)
