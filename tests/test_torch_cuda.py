"""The CUDA logsumexp kernel (both entry points) against its plain PyTorch
versions, on the card; and the MCMC path on the card: `run_chains` with no
device synchronisation, and HMC's result against the CPU's.

These tests need a CUDA device (the kernel has no CPU mode) and skip
without one. On a machine with the card and without JAX, run them with
`python -m pytest --noconftest -m gpu tests/test_torch_cuda.py`.
"""

import math

import pytest
import torch

from genjax_tpu_torch.ops import (
    fused_logsumexp,
    fused_logsumexp_ess,
    logsumexp,
    logsumexp_ess,
    logsumexp_ess_plain,
    logsumexp_plain,
)

pytestmark = pytest.mark.gpu

SIZES = [1, 127, 4_096, 10_000, 65_541, 262_144, 1_000_000]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the logsumexp kernel has no CPU mode")
    return torch.device("cuda")


def _close(got: torch.Tensor, ref: torch.Tensor) -> None:
    # 1e-5 * max(1, |ref|): the kernel sums in another order than torch.
    # Special values (NaN, +-inf) must match exactly.
    got, ref = float(got), float(ref)
    assert (math.isnan(got) and math.isnan(ref)) or got == ref or abs(got - ref) <= 1e-5 * max(1.0, abs(ref)), (
        got,
        ref,
    )


def _pair_close(got, ref) -> None:
    _close(got[0], ref[0])
    _close(got[1], ref[1])


@pytest.mark.parametrize("n", SIZES)
def test_kernel_matches_plain_version(cuda, n):
    rng = torch.Generator(device=cuda).manual_seed(n)
    x = 3.0 * torch.randn(n + 3, generator=rng, device=cuda)
    for v in (x[:n], x[1 : n + 1], x[3 : n + 3]):  # aligned, and unaligned starts
        _close(fused_logsumexp(v), logsumexp_plain(v))


@pytest.mark.parametrize("n", SIZES)
def test_ess_kernel_matches_plain_version(cuda, n):
    rng = torch.Generator(device=cuda).manual_seed(n)
    x = 3.0 * torch.randn(n + 3, generator=rng, device=cuda)
    for v in (x[:n], x[1 : n + 1], x[3 : n + 3]):
        _pair_close(fused_logsumexp_ess(v), logsumexp_ess_plain(v))


SPECIALS = {
    "leading_neg_inf_block": [-math.inf] * 70_000 + [0.0] * 1_000,
    "all_neg_inf": [-math.inf] * 1_000,
    "pos_inf": [0.0, math.inf, -math.inf, 3.0],
    "nan": [0.0, math.nan, 1.0],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(SPECIALS))
def test_kernel_special_cases_match_plain_version_exactly(cuda, case):
    x = torch.tensor(SPECIALS[case], dtype=torch.float32, device=cuda)
    got, ref = fused_logsumexp(x).cpu(), logsumexp_plain(x).cpu()
    assert torch.equal(got, ref) or (got.isnan() and ref.isnan())


@pytest.mark.parametrize("case", sorted(SPECIALS))
def test_ess_kernel_special_cases_match_plain_version(cuda, case):
    # Special values exactly; the one finite ESS (1000 equal weights)
    # within 1e-5 relative, since the plain formula rounds log(1000).
    x = torch.tensor(SPECIALS[case], dtype=torch.float32, device=cuda)
    got, ref = fused_logsumexp_ess(x), logsumexp_ess_plain(x)
    assert torch.equal(got[0].cpu(), ref[0].cpu()) or (got[0].isnan() and ref[0].isnan())
    _close(got[1], ref[1])


def test_back_to_back_calls_without_a_sync_all_come_out_right(cuda):
    # 1000 calls of mixed sizes, starts and entry points queued with no
    # synchronisation: each finds the ticket counter reset by the last.
    rng = torch.Generator(device=cuda).manual_seed(0)
    base = 3.0 * torch.randn(1_100_000, generator=rng, device=cuda)
    calls = []
    for i in range(1000):
        n, start = SIZES[i % len(SIZES)], (7 * i) % 97
        v = base[start : start + n]
        calls.append((v, fused_logsumexp_ess(v) if i % 2 else fused_logsumexp(v)))
    torch.cuda.synchronize()
    for i, (v, got) in enumerate(calls):
        if i % 2:
            _pair_close(got, logsumexp_ess_plain(v))
        else:
            _close(got, logsumexp_plain(v))


def test_calls_on_two_streams_at_once(cuda):
    rng = torch.Generator(device=cuda).manual_seed(1)
    xs = [3.0 * torch.randn(1_000_000 + i, generator=rng, device=cuda) for i in range(4)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    results = []
    for i in range(200):
        s = streams[i % 2]
        with torch.cuda.stream(s):
            x = xs[i % 4]
            results.append((x, fused_logsumexp_ess(x) if i % 3 else fused_logsumexp(x)))
    torch.cuda.synchronize()
    for i, (x, got) in enumerate(results):
        if i % 3:
            _pair_close(got, logsumexp_ess_plain(x))
        else:
            _close(got, logsumexp_plain(x))


def test_calls_replay_in_a_cuda_graph(cuda):
    # The workspace outlives the calls, so a captured launch replays with
    # the counter the previous replay reset; the stream's workspace is made
    # by an eager call before the capture.
    x = torch.randn(1_000_000, device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fused_logsumexp(x), fused_logsumexp_ess(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        lse = fused_logsumexp(x)
        pair = fused_logsumexp_ess(x)
    rng = torch.Generator(device=cuda).manual_seed(2)
    for scale in (1.0, 3.0, 10.0):
        x.copy_(scale * torch.randn(x.shape, generator=rng, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        _close(lse, logsumexp_plain(x))
        _pair_close(pair, logsumexp_ess_plain(x))


def test_one_launch_per_call(cuda):
    x = torch.randn(1_000_000, device=cuda)
    fused_logsumexp(x), fused_logsumexp_ess(x)  # the stream's workspace exists from here on
    torch.cuda.synchronize()
    for fn in (fused_logsumexp, fused_logsumexp_ess):
        before = fn.launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn(x)
            torch.cuda.synchronize()
        assert fn.launches == before + 1
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and "genjax_lse" in kernels[0].name, [e.name for e in kernels]


def test_dispatch_launches_the_kernel_and_counts(cuda):
    x = torch.randn(4096, device=cuda, dtype=torch.float64)
    before = fused_logsumexp.launches
    out = logsumexp(x)
    assert fused_logsumexp.launches == before + 1
    assert out.device.type == "cuda" and out.dtype == torch.float32
    before = fused_logsumexp_ess.launches
    lse, ess = logsumexp_ess(x)
    assert fused_logsumexp_ess.launches == before + 1
    assert lse.device.type == ess.device.type == "cuda" and lse.shape == ess.shape == ()
    with pytest.raises(ValueError, match="contiguous"):
        fused_logsumexp(torch.zeros(8, 2, device=cuda)[:, 0])


def _logreg_chains(device, n_chains: int, seed: int = 0):
    """Logistic-regression chains at the bench's data size (N=256, D=16),
    the data made on the CPU so that every device sees the same."""
    from genjax_tpu_torch.models.logreg import init_chains, simulate_logreg_data

    X, ys, _ = simulate_logreg_data(torch.Generator().manual_seed(3), 256, 16)
    rng = torch.Generator(device=device).manual_seed(seed)
    return rng, init_chains(rng, X.to(device), ys.to(device), n_chains)


def test_run_chains_makes_no_device_sync(cuda):
    import genjax_tpu_torch as gx

    rng, chains = _logreg_chains(cuda, 1024)
    for request in (gx.HMC(gx.Selection.at["w"], 0.02, L=5, jitter=0.2), gx.MALA(gx.Selection.at["w"], 0.01)):
        gx.run_chains(rng, chains, request, 2)  # warm up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a synchronising call raises
        try:
            final, accepted = gx.run_chains(rng, chains, request, 10)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert accepted.shape == (1024, 10) and final.get_choices()["w"].device.type == "cuda"


def test_hmc_on_the_card_matches_the_cpu(cuda):
    # Chains from the prior, 10 HMC steps at the bench's step size on both
    # devices: the per-dimension means of the final w agree within 5
    # combined standard errors (chains are independent draws).
    import genjax_tpu_torch as gx

    ws = []
    for device in (cuda, torch.device("cpu")):
        rng, chains = _logreg_chains(device, 4096, seed=1 if device.type == "cpu" else 2)
        final, accepted = gx.run_chains(rng, chains, gx.HMC(gx.Selection.at["w"], 0.02, L=5), 10)
        assert 0.0 < float(accepted.float().mean()) <= 1.0
        ws.append(final.get_choices()["w"].double().cpu())
    a, b = ws
    se = (a.var(0) / a.shape[0] + b.var(0) / b.shape[0]).sqrt()
    assert bool(((a.mean(0) - b.mean(0)).abs() < 5 * se).all()), (a.mean(0), b.mean(0), se)
