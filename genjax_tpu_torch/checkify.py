"""The runtime-check gate (counterpart of `genjax_tpu.checkify`)."""

from genjax_tpu_torch.core.checkify import do_checkify, optional_check, should_check

__all__ = ["do_checkify", "optional_check", "should_check"]
