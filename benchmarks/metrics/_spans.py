"""What the readers of the program's spans share (`genjax_tpu_torch/utils/
profiling.py`: `spans()`, each record with its name, parent, root and host
`perf_counter_ns` start and end).

A traced segment may be taken more than once (`harness/trace.py`), so only
its last attempt counts: the spans of its last `ctx.trace["calls"]` calls,
a call starting at its first root span (`CALL_ROOTS`). A span's self time
is its duration less the part of it that its child spans cover. A reading
is per call (SIR) or per filter step (`traffic["steps"]` a call), and
nothing where the run was not traced or the program recorded no spans, as
a program without spans records none.
"""

from collections import defaultdict

from harness.trace import busy_us

CALL_ROOTS = ("smc.importance", "filter.run")


def program_spans() -> list:
    """The program's span records, or [] where it keeps none."""
    from genjax_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


def last_attempt(ctx) -> list | None:
    """The finished spans of the traced segment's last attempt, in the
    order they started; None where there is none to read."""
    if ctx.trace is None:
        return None
    records = program_spans()
    starts = [i for i, r in enumerate(records) if r.parent is None and r.name in CALL_ROOTS]
    calls = ctx.trace["calls"]
    if calls < 1 or len(starts) < calls:
        return None
    return [r for r in records[starts[-calls]:] if r.end_ns is not None]


def self_ns(records: list, names: tuple) -> int:
    """The summed self time, in ns, of the spans named in `names`."""
    children = defaultdict(list)
    for r in records:
        if r.parent is not None:
            children[r.parent].append((r.start_ns, r.end_ns))
    return sum(r.end_ns - r.start_ns - busy_us(children[r.seq]) for r in records if r.name in names)


def self_us_per_unit(ctx, names: tuple) -> float | None:
    """The self time of the spans named in `names`, in us, per call of the
    last attempt, or per filter step where the traffic has `steps`."""
    records = last_attempt(ctx)
    if records is None:
        return None
    units = ctx.trace["calls"] * ctx.traffic.get("steps", 1)
    return self_ns(records, names) / 1e3 / units
