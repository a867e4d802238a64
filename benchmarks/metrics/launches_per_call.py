"""Host kernel-launch API calls per call of the traced segment (the
`*LaunchKernel*` events of `torch.profiler`, with K1's launches through
`ctypes` added from its wrappers' counters where the trace does not list
them)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace["launch_calls"] / ctx.trace["calls"]
