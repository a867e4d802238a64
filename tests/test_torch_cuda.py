"""The CUDA logsumexp kernel against its plain PyTorch version, on the card.

These tests need a CUDA device (the kernel has no CPU mode) and skip
without one. On a machine with the card and without JAX, run them with
`python -m pytest --noconftest -m gpu tests/test_torch_cuda.py`.
"""

import math

import pytest
import torch

from genjax_tpu_torch.ops import fused_logsumexp, logsumexp, logsumexp_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the logsumexp kernel has no CPU mode")
    return torch.device("cuda")


def _close(got: torch.Tensor, ref: torch.Tensor) -> None:
    # 1e-5 * max(1, |ref|): the kernel sums in another order than torch.
    got, ref = float(got), float(ref)
    assert got == ref or abs(got - ref) <= 1e-5 * max(1.0, abs(ref)), (got, ref)


@pytest.mark.parametrize("n", [1, 127, 4_096, 10_000, 65_541, 262_144, 1_000_000])
def test_kernel_matches_plain_version(cuda, n):
    rng = torch.Generator(device=cuda).manual_seed(n)
    x = 3.0 * torch.randn(n, generator=rng, device=cuda)
    _close(fused_logsumexp(x), logsumexp_plain(x))
    _close(fused_logsumexp(x[1:]), logsumexp_plain(x[1:]))  # unaligned start


@pytest.mark.parametrize(
    "values",
    [
        [-math.inf] * 70_000 + [0.0] * 1_000,
        [-math.inf] * 1_000,
        [0.0, math.inf, -math.inf, 3.0],
        [0.0, math.nan, 1.0],
        [],
    ],
    ids=["leading_neg_inf_block", "all_neg_inf", "pos_inf", "nan", "empty"],
)
def test_kernel_special_cases_match_plain_version_exactly(cuda, values):
    x = torch.tensor(values, dtype=torch.float32, device=cuda)
    got, ref = fused_logsumexp(x).cpu(), logsumexp_plain(x).cpu()
    assert torch.equal(got, ref) or (got.isnan() and ref.isnan())


def test_dispatch_launches_the_kernel_and_counts(cuda):
    x = torch.randn(4096, device=cuda, dtype=torch.float64)
    before = fused_logsumexp.launches
    out = logsumexp(x)
    assert fused_logsumexp.launches == before + 1
    assert out.device.type == "cuda" and out.dtype == torch.float32
    with pytest.raises(ValueError, match="contiguous"):
        fused_logsumexp(torch.zeros(8, 2, device=cuda)[:, 0])
