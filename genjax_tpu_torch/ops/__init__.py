"""Hand-written CUDA kernels for the inference hot loops, each with its
plain PyTorch twin. Kernels are built from `csrc/` at first use."""

from genjax_tpu_torch.ops.logsumexp import (
    fused_logsumexp,
    fused_logsumexp_ess,
    launch_geometry,
    logsumexp,
    logsumexp_ess,
    logsumexp_ess_plain,
    logsumexp_plain,
)

__all__ = [
    "fused_logsumexp",
    "fused_logsumexp_ess",
    "launch_geometry",
    "logsumexp",
    "logsumexp_ess",
    "logsumexp_ess_plain",
    "logsumexp_plain",
]
