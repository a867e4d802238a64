"""What the benchmark reads of the program's one hand-written kernel, K1
(the log-sum-exp reduction): its kernel name in a device trace, the launch
counters of its wrappers, and whether its build is already in the
checkout."""

KERNEL = "genjax_lse"  # csrc/logsumexp.cu's kernel; the `<true>` instance also returns the ESS


def launches() -> int:
    from genjax_tpu_torch.ops import fused_logsumexp, fused_logsumexp_ess

    return fused_logsumexp.launches + fused_logsumexp_ess.launches


def library_built() -> bool:
    from genjax_tpu_torch.ops import _build

    return _build.library_path("logsumexp").exists()


def reduce(x):
    from genjax_tpu_torch.ops import logsumexp

    return logsumexp(x)
