"""The share of filter steps whose ESS gate fired, in %: the program's
counters `particle_filter.filter_stats` (`resamples` over `steps`, the
steps after each filter's first) over every filter the run made. Nothing
where the program keeps no such counter."""


def read(ctx):
    from genjax_tpu_torch.inference import particle_filter

    stats = getattr(particle_filter, "filter_stats", None)
    if not stats or not stats.get("steps"):
        return None
    return 100.0 * stats["resamples"] / stats["steps"]
