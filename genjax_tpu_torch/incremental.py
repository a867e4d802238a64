"""Incremental computation facade (counterpart of `genjax_tpu.incremental`):
the change tangents and `incremental`."""

from genjax_tpu_torch.core.diff import ChangeTangent, Diff, NoChange, UnknownChange, incremental

__all__ = ["ChangeTangent", "Diff", "NoChange", "UnknownChange", "incremental"]
