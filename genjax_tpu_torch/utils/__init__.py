"""Auxiliary subsystems: debugging, rendering, profiling, checkpointing
(counterpart of `genjax_tpu/utils/`)."""

from genjax_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from genjax_tpu_torch.utils.pretty import pretty
from genjax_tpu_torch.utils.profiling import annotate, cost_summary, device_memory_stats, profile_trace
from genjax_tpu_torch.utils.time_travel import TimeTravelingDebugger, rec, tag, time_machine

__all__ = [
    "TimeTravelingDebugger",
    "annotate",
    "cost_summary",
    "device_memory_stats",
    "pretty",
    "profile_trace",
    "rec",
    "restore_checkpoint",
    "save_checkpoint",
    "tag",
    "time_machine",
]
