"""The share of the run's systematic resamples that launched K2, in %: the
program's counters `launches` of `ops.fused_systematic_ancestors` (K2, the
systematic resampler's kernel) over `calls` of
`inference.smc.systematic_resample`, over every call the run made (all on
the card in a cell). Nothing where the program keeps no such counter, or
made no such call."""


def read(ctx):
    from genjax_tpu_torch import ops
    from genjax_tpu_torch.inference import smc

    launches = getattr(getattr(ops, "fused_systematic_ancestors", None), "launches", None)
    calls = getattr(smc.systematic_resample, "calls", None)
    if launches is None or not calls:
        return None
    return 100.0 * launches / calls
