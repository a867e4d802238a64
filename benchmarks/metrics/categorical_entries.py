"""Logits entries the categorical read per particle-step, over every filter
the run made: the program's counter `entries` of
`distributions.library.categorical_stats` (each row drawn or scored
counts its categories) over the particle-steps, K x T a filter, the
filters counted by `particle_filter.filter_stats["steps"]` over T - 1
(the steps after each filter's first). A step that draws one state from
a row of 64 and scores it and its observation reads 3 x 64 = 192.
Nothing where the program keeps no such counter."""


def read(ctx):
    from genjax_tpu_torch.distributions import library
    from genjax_tpu_torch.inference import particle_filter

    counted = getattr(library, "categorical_stats", None)
    stats = getattr(particle_filter, "filter_stats", None)
    steps = ctx.traffic.get("steps", 0)
    if not counted or not stats or not stats.get("steps") or steps < 2:
        return None
    filters = stats["steps"] / (steps - 1)
    return counted["entries"] / (ctx.traffic["particles"] * steps * filters)
