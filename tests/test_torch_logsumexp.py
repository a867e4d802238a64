"""The port's logsumexp (`genjax_tpu_torch.ops`) against the JAX package's.

On the CPU the public `logsumexp` and `logsumexp_ess` run their plain
PyTorch versions; the CUDA kernel's own checks are in
`tests/test_torch_cuda.py` (card only). Inputs are made with numpy and
handed to both packages. The kernel's launch arithmetic is plain Python
and is checked here.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp as jax_logsumexp

from genjax_tpu.inference.smc import ess as jax_ess
from genjax_tpu.ops import fused_logsumexp as pallas_logsumexp
from genjax_tpu_torch.ops import (
    _build,
    fused_logsumexp,
    fused_logsumexp_ess,
    launch_geometry,
    logsumexp,
    logsumexp_ess,
    logsumexp_ess_plain,
    logsumexp_plain,
)

torch.set_num_threads(1)

INF = np.inf


@pytest.mark.parametrize("n", [1, 100, 65_536, 100_001])
def test_plain_matches_pallas_kernel_on_finite_inputs(n):
    # Tolerance 1e-5 * max(1, |ref|): both sum n float32 terms, in
    # different orders (tiles of 128 lanes against torch's reduction).
    x = (3.0 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    ref = float(pallas_logsumexp(jnp.asarray(x), interpret=True))
    got = float(logsumexp(torch.from_numpy(x)))
    assert abs(got - ref) <= 1e-5 * max(1.0, abs(ref))


SPECIAL_CASES = {
    # 70,000 -inf then 1,000 zeros: the Pallas kernel returns NaN here
    # (its first tile is all -inf); XLA and the port give log(1000).
    "leading_neg_inf_block": np.concatenate(
        [np.full(70_000, -INF), np.zeros(1_000)]
    ).astype(np.float32),
    "all_neg_inf": np.full(1_000, -INF, dtype=np.float32),
    "pos_inf": np.array([0.0, INF, -INF, 3.0], dtype=np.float32),
    "two_pos_inf": np.array([INF, INF], dtype=np.float32),
    "nan": np.array([0.0, np.nan, 1.0], dtype=np.float32),
    "nan_and_inf": np.array([INF, np.nan], dtype=np.float32),
    "empty": np.zeros(0, dtype=np.float32),
}


@pytest.mark.parametrize("case", sorted(SPECIAL_CASES))
def test_special_cases_match_xla_logsumexp_exactly(case):
    x = SPECIAL_CASES[case]
    ref = np.asarray(jax_logsumexp(jnp.asarray(x)))
    got = logsumexp(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == ()
    np.testing.assert_array_equal(got, ref)


def test_pallas_kernel_still_has_the_leading_neg_inf_fault():
    # Records the open fault of the JAX kernel that the port does not
    # inherit: NaN where XLA (and the port) give log(1000).
    x = SPECIAL_CASES["leading_neg_inf_block"]
    assert np.isnan(float(pallas_logsumexp(jnp.asarray(x), interpret=True)))
    assert float(logsumexp(torch.from_numpy(x))) == pytest.approx(np.log(1000.0), abs=1e-6)


def test_plain_version_casts_to_float32_and_takes_only_vectors():
    x = np.random.default_rng(0).standard_normal(257)
    got = logsumexp_plain(torch.from_numpy(x))  # float64 in, float32 out
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(jax_logsumexp(jnp.asarray(x, jnp.float32))), abs=1e-5)
    with pytest.raises(ValueError, match="1-D"):
        logsumexp(torch.zeros(2, 3))


@pytest.mark.parametrize("kernel", [fused_logsumexp, fused_logsumexp_ess], ids=["lse", "lse_ess"])
def test_kernel_launcher_never_returns_the_plain_result_off_the_card(kernel):
    # The branch a CUDA tensor takes refuses a CPU tensor outright ...
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA device"):
        kernel(torch.zeros(8))
    with pytest.raises(ValueError, match="contiguous"):
        kernel(torch.zeros(8, 2)[:, 0])
    assert kernel.launches == before


def _ess_close(got: float, ref: float) -> bool:
    # ESS tolerance 1e-5 * max(1, |ref|), as for the log-sum-exp: JAX's
    # formula exp(-logsumexp(2 (x - lse))) carries the first reduction's
    # rounding twice into the second (measured against float64 up to 16M
    # values: relative errors under 1.4e-6), and the port's twin repeats
    # that formula in another summation order.
    return (np.isnan(got) and np.isnan(ref)) or got == ref or abs(got - ref) <= 1e-5 * max(1.0, abs(ref))


@pytest.mark.parametrize("n", [1, 100, 8192, 100_001])
def test_ess_plain_matches_jax_ess_and_logsumexp(n):
    x = (3.0 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    lse, ess = logsumexp_ess_plain(torch.from_numpy(x))
    ref_lse, ref_ess = float(jax_logsumexp(jnp.asarray(x))), float(jax_ess(jnp.asarray(x)))
    assert abs(float(lse) - ref_lse) <= 1e-5 * max(1.0, abs(ref_lse))
    assert _ess_close(float(ess), ref_ess), (float(ess), ref_ess)
    assert lse.dtype == ess.dtype == torch.float32 and lse.shape == ess.shape == ()


# The ESS of JAX's `ess` on each special case: empty +inf, all -inf NaN
# (fault R2, kept until both packages change), any +inf NaN, NaN NaN.
ESS_OF_SPECIAL_CASES = {
    "leading_neg_inf_block": 1000.0,
    "all_neg_inf": np.nan,
    "pos_inf": np.nan,
    "two_pos_inf": np.nan,
    "nan": np.nan,
    "nan_and_inf": np.nan,
    "empty": np.inf,
}


@pytest.mark.parametrize("case", sorted(SPECIAL_CASES))
def test_ess_special_cases_match_jax(case):
    x = SPECIAL_CASES[case]
    lse, ess = logsumexp_ess(torch.from_numpy(x))
    np.testing.assert_array_equal(lse.numpy(), np.asarray(jax_logsumexp(jnp.asarray(x))))
    ref = float(jax_ess(jnp.asarray(x)))
    assert _ess_close(float(ess), ref), (float(ess), ref)
    assert _ess_close(ref, ESS_OF_SPECIAL_CASES[case])


N_VALUES = sorted({0, 1, 3, 4095, 4096, 4097, 10_000, 65_541, 1_000_000, 2_162_688, 16_777_216}
                  | {int(v) for v in np.random.default_rng(0).integers(0, 16_777_217, 40)})


@pytest.mark.parametrize("sm_count", [1, 132])
def test_launch_geometry_covers_n_within_one_resident_wave(sm_count):
    cap = sm_count * 4  # resident blocks per SM, the kernel's launch bound
    for n in N_VALUES:
        blocks, workspace = launch_geometry(n, sm_count)
        assert workspace == cap and 1 <= blocks <= cap  # every block has a partial slot
        # One step of the grid reads blocks * 4096 values: one step covers
        # n unless the wave is full (then the grid-stride loop takes more),
        # and every block has values to read in the first step.
        assert blocks * 4096 >= n or blocks == cap
        assert (blocks - 1) * 4096 < max(n, 1)


def test_kernel_build_without_nvcc_raises_a_clear_error(monkeypatch):
    # ... and, without the CUDA toolkit, the build itself raises.
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    _build.load_library.cache_clear()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load_library("logsumexp")


def test_importing_the_kernel_module_needs_no_nvcc_or_gpu():
    code = (
        "import torch\n"
        "import genjax_tpu_torch.ops as ops\n"
        "print(float(ops.logsumexp(torch.zeros(4))))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        env={"PATH": "", "CUDA_VISIBLE_DEVICES": ""},
        cwd=Path(__file__).resolve().parent.parent,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert float(out.stdout) == pytest.approx(np.log(4.0))


def _stand_in_launch(x, out, ess):
    """The kernel's contract, computed by the plain twins on the CPU: what
    `_launch` writes into `out`."""
    with torch.no_grad():
        if ess:
            out.copy_(torch.stack(logsumexp_ess_plain(x)))
        else:
            out.copy_(logsumexp_plain(x))


def test_the_kernel_wrappers_gradient_is_the_softmax(monkeypatch):
    # The autograd wiring of the kernel's wrappers, with the launch replaced
    # by its plain twins (the kernel itself runs on the card only:
    # `tests/test_torch_cuda.py`): one launch forward, `g * exp(x - lse)`
    # backward, the ESS without a gradient.
    module = sys.modules["genjax_tpu_torch.ops.logsumexp"]
    monkeypatch.setattr(module, "_launch", _stand_in_launch)
    x = torch.from_numpy((3.0 * np.random.default_rng(7).standard_normal(1000)).astype(np.float32)).requires_grad_()
    (ref,) = torch.autograd.grad(torch.logsumexp(x, 0) * 2.5, x)
    out = module._Differentiable.apply(x, False)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out * 2.5, x)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    lse, ess = module._Differentiable.apply(x, True)
    assert lse.grad_fn is not None and not ess.requires_grad
    (got,) = torch.autograd.grad(lse * 2.5, x)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(module.lse_backward(torch.tensor(2.5), x.detach(), torch.logsumexp(x.detach(), 0)), ref)


def test_the_cpu_path_stays_the_plain_twin_with_a_gradient():
    x = torch.randn(50, generator=torch.Generator().manual_seed(3), requires_grad=True)
    (got,) = torch.autograd.grad(logsumexp(x), x)
    (lse_got,) = torch.autograd.grad(logsumexp_ess(x)[0], x)
    (ref,) = torch.autograd.grad(torch.logsumexp(x, 0), x)
    torch.testing.assert_close(got, ref)
    torch.testing.assert_close(lse_got, ref)
