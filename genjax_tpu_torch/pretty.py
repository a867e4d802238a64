"""Rendering facade (counterpart of `genjax_tpu.pretty`)."""

from genjax_tpu_torch.utils.pretty import pretty

__all__ = ["pretty"]
