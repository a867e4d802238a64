"""Time-travel debugger facade (counterpart of `genjax_tpu.time_travel`)."""

from genjax_tpu_torch.utils.time_travel import TimeTravelingDebugger, rec, tag, time_machine

__all__ = ["TimeTravelingDebugger", "rec", "tag", "time_machine"]
