"""Host kernel-launch API calls per filter step of the traced segment: the
launch calls (as `launches_per_call` counts them) over the calls times the
steps of each (`traffic["steps"]`, the observations filtered)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace["launch_calls"] / (ctx.trace["calls"] * ctx.traffic["steps"])
