"""The device's idle share of the traced segment, in %: one less the union
of the device intervals over the segment's host-clock length. Nothing
where the trace is incomplete (a shortened union would read too idle)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["complete"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
