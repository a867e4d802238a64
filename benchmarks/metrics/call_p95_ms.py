"""The 95th percentile of the latency of every call in the window, in ms:
each call from its start to the host holding its LML (host clock).
Linear interpolation between order statistics, as
`statistics.quantiles(method="inclusive")`."""

import statistics


def read(ctx):
    lat = ctx.window.latencies_s
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
