"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the denominators of every roofline
and `mfu` share."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the float32 peak and the bytes over the HBM bandwidth."""
    return max(flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
