"""K1's share of its roofline, in %: the least time of K1's launches in the
traced segment (each launch's bytes, K float32 values read and its output
written, over the HBM bandwidth; the operations bound none of them) over
their device time in the trace, by the kernel's name. Nothing where the
trace holds no K1 kernel or misses some of those launched."""

from harness import peaks


def read(ctx):
    t = ctx.trace
    if t is None or not t["k1_kernels"] or len(t["k1_kernels"]) != t["k1_launched"]:
        return None
    sizes = ctx.work["k1_bytes"]
    least = sum(sizes["lse_ess" if "<true>" in name else "lse"] for name, _ in t["k1_kernels"]) / peaks.HBM_BYTES_PER_S
    spent = sum(seconds for _, seconds in t["k1_kernels"])
    return 100.0 * least / spent
