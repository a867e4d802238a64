"""The measured window: one caller making one call after another (a closed
loop), for at least the given seconds.

Every call is timed from its start to its return, which is when the host
holds the call's LML (each call ends in one device synchronisation). The
window runs from the first call's start to the last call's end. A call
that raises, or whose LML is not finite, counts as failed.

The judge gets every call's LML with what the program's `small` keeps of
the call, and the whole outputs of a sample of calls drawn from the seed
(a reservoir sample, uniform over all the window's calls), kept on the
device until the window has closed.
"""

import math
import random
import sys
import time
import traceback
from dataclasses import dataclass, field


@dataclass
class Window:
    calls: int = 0
    failed: int = 0
    seconds: float = 0.0
    latencies_s: list = field(default_factory=list)
    smalls: list = field(default_factory=list)  # (program.small(out), lml) per call that returned
    kept: list = field(default_factory=list)  # whole outputs of the sampled calls


def run_window(program, seconds: float, keep: int, keep_seed: int) -> Window:
    w = Window()
    pick = random.Random(keep_seed)
    clock = time.perf_counter
    start = clock()
    i = 0
    while True:
        t0 = clock()
        try:
            out, lml = program.call(i)
        except Exception:  # a failed call is counted; the window goes on
            traceback.print_exc(file=sys.stderr)
            out, lml = None, math.nan
        t1 = clock()
        w.latencies_s.append(t1 - t0)
        if out is None or not math.isfinite(lml):
            w.failed += 1
        if out is not None:
            w.smalls.append((program.small(out), lml))
            if len(w.kept) < keep:
                w.kept.append(out)
            else:
                j = pick.randrange(i + 1)
                if j < keep:
                    w.kept[j] = out
        i += 1
        if t1 - start >= seconds:
            break
    w.calls = i
    w.seconds = t1 - start
    return w
