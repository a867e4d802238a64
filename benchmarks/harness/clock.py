"""The age of this process, for `setup_s`: from the process's start as the
kernel records it (`/proc/self/stat`), so that the interpreter's own
start-up counts too."""

import os
import time

_IMPORTED = time.monotonic()


def process_age_s() -> float:
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")  # field 22: start time since boot
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _IMPORTED
