"""The CUDA logsumexp kernel (both entry points) against its plain PyTorch
versions, on the card; the MCMC path on the card (`run_chains` with no
device synchronisation, and HMC's result against the CPU's); the
combinator and branching paths; and the SMC path (the resamplers' maps,
the filter with each resampler, `SMCDriver`, the SIR algorithms, PMMH,
particle Gibbs, FFBS and tempered SMC), every leaf on the card and K1
counted; and K1's gradient (the kernel forward, `g * exp(x - lse)`
backward, against `torch.logsumexp`'s) with the VI path on the card; and
the library path: every distribution at a million draws, the rejection
samplers, the Dirichlet mixture and stochastic volatility; and the
adaptive samplers: NUTS with no synchronisation at 8192 chains, ChEES with
exactly one per step, the elliptical slice loop's host reads against its
trips, each held against the CPU; and the incremental edits' plan: no
synchronisation per Gibbs sweep and one analysis, a CUDA closure argument
keyed without a host read, and one sweep's weights under the plan equal
to the dense fallback plan's on the same generator state; and the parallel
layer on a one-rank group: the sharded reductions, the collectives'
record, the warmups over the chain axis against the stitched dense ones
(and their synchronisations), and data-sharded logistic regression
against the dense model.

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


def test_hmm_scan_on_the_card_is_exact(cuda):
    # The scan model's assess of exact posterior paths equals the closed-form
    # joint (1e-4 relative) and the CPU's; the unfold makes no device sync,
    # launches K1 once for its LML, and its LML is within 5 SE of the exact
    # marginal (16 states, T=6, K=65,536).
    import statistics

    import genjax_tpu_torch as gx
    from genjax_tpu_torch.distributions.discrete_hmm import forward_filtering_backward_sampling, path_joint_logpdf
    from genjax_tpu_torch.inference.exact_testbed import build_hmm_chain_model
    from genjax_tpu_torch.models.hmm import BenchConfig, exact_log_marginal, run_hmm_importance

    cfg = BenchConfig(n_states=16, T=6, n_particles=65_536)
    obs, init = cfg.data(cuda), cfg.initial_state()
    model = build_hmm_chain_model(cfg.hmm(), cfg.T, cuda)
    rng = torch.Generator(device=cuda).manual_seed(0)
    paths, _ = forward_filtering_backward_sampling(rng, cfg.hmm(), obs, 512)
    score, _ = model.assess(gx.ChoiceMap.kw(z=gx.per_particle(paths), x=obs), (init, None), n=512)
    _, trans, emit = cfg.hmm().tables(cuda)
    ref = path_joint_logpdf(trans[init], trans, emit, paths, obs)
    assert bool(((score - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0)).all())
    cpu_model = build_hmm_chain_model(cfg.hmm(), cfg.T, "cpu")
    cpu_score, _ = cpu_model.assess(gx.ChoiceMap.kw(z=gx.per_particle(paths.cpu()), x=obs.cpu()), (init, None), n=512)
    assert bool(((score.cpu() - cpu_score).abs() <= 1e-4 * cpu_score.abs().clamp(min=1.0)).all())

    run_hmm_importance(rng, model, obs, init, cfg.n_particles)  # warm up
    torch.cuda.synchronize()
    before = fused_logsumexp.launches
    torch.cuda.set_sync_debug_mode("error")  # a synchronising call raises
    try:
        col = run_hmm_importance(rng, model, obs, init, cfg.n_particles)
        lml = col.get_log_marginal_likelihood_estimate()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fused_logsumexp.launches == before + 1
    trace = col.get_particles()
    assert trace.get_choices()["z"].shape == (cfg.n_particles, cfg.T)
    assert trace.inner.get_score().shape == (cfg.n_particles, cfg.T)
    exact = float(exact_log_marginal(cfg.hmm(), obs, init))
    lmls = [float(lml)] + [
        float(run_hmm_importance(rng, model, obs, init, cfg.n_particles).get_log_marginal_likelihood_estimate())
        for _ in range(9)
    ]
    se = statistics.stdev(lmls) / math.sqrt(len(lmls))
    assert abs(statistics.fmean(lmls) - exact) < 5 * se, (lmls, exact)

    # The single-step edit equals the dense re-scan for the same draws.
    S = gx.Selection.at
    chains = run_hmm_importance(rng, model, obs, init, 1024).get_particles()
    for t in (0, 3, cfg.T - 1):
        one, w_one, _, _ = chains.edit(torch.Generator(device=cuda).manual_seed(t), gx.IndexRequest(t, gx.Regenerate(S["z"])))
        dense, w_dense, _, _ = chains.edit(torch.Generator(device=cuda).manual_seed(t), gx.Regenerate(S[t, "z"]))
        assert torch.equal(one.get_choices()["z"], dense.get_choices()["z"])
        assert bool(((w_one - w_dense).abs() <= 1e-4 * w_dense.abs().clamp(min=1.0)).all())


def test_logreg_through_vmap_on_the_card(cuda):
    # assess through the vmapped likelihood equals the vector-site model's
    # (1e-4 relative), and HMC through it makes no device sync.
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.models.logreg import (
        VMAP_YS, init_chains, logistic_regression, logistic_regression_vmap, simulate_logreg_data,
    )

    X, ys, _ = simulate_logreg_data(torch.Generator().manual_seed(3), 256, 16)
    X, ys = X.to(cuda), ys.to(cuda)
    rng = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn(1024, 16, generator=rng, device=cuda)
    vector, _ = logistic_regression.assess(gx.ChoiceMap.kw(w=gx.per_particle(w), ys=ys), (X,), n=1024)
    lanes, _ = logistic_regression_vmap.assess(gx.ChoiceMap.d({"w": gx.per_particle(w), ("data", "y"): ys}), (X,), n=1024)
    assert bool(((lanes - vector).abs() <= 1e-4 * vector.abs().clamp(min=1.0)).all())
    chains = init_chains(rng, X, ys, 1024, logistic_regression_vmap, VMAP_YS)
    assert chains.get_subtrace("data").inner.get_score().shape == (1024, 256)
    request = gx.HMC(gx.Selection.at["w"], 0.02, L=5)
    gx.run_chains(rng, chains, request, 2)  # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        final, accepted = gx.run_chains(rng, chains, request, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert accepted.shape == (1024, 5) and bool(torch.isfinite(final.get_choices()["w"]).all())


def test_shared_per_lane_argument_of_length_k_survives_resample(cuda):
    # K particles and K lanes: the mapped design matrix and the stacked
    # observations have the particle count as their leading length, and are
    # shared. Resampling must leave them alone (the record says so, not the
    # size) while it gathers the per-particle `w` and the (K, K) scores.
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.models.logreg import logistic_regression_vmap

    k = 64
    rng = torch.Generator(device=cuda).manual_seed(0)
    X = torch.randn(k, 3, generator=rng, device=cuda)
    ys = (torch.rand(k, generator=rng, device=cuda) < 0.5).to(torch.int32)
    trs, lw = logistic_regression_vmap.importance(rng, gx.ChoiceMap.d({("data", "y"): ys}), (X,), n=k)
    col = gx.ParticleCollection(trs, lw).resample(rng)
    picked = col.get_particles()
    data = picked.get_subtrace("data")
    assert picked.get_args()[0] is X and data.get_args()[0] is X
    assert data.inner.get_args()[0] is trs.get_subtrace("data").inner.get_args()[0]  # the lanes' x, shared
    assert picked.get_choices()["data", "y"].shape == (k,) and torch.equal(picked.get_choices()["data", "y"], ys)
    assert data.inner.get_score().shape == (k, k)
    score, _ = logistic_regression_vmap.assess(picked.get_choices(), (X,), n=k)
    assert bool(((score - picked.get_score()).abs() <= 1e-4 * score.abs().clamp(min=1.0)).all())


def _normal_logpdf(x, mu, sigma):
    return -0.5 * ((x - mu) / sigma) ** 2 - math.log(sigma) - 0.5 * math.log(2.0 * math.pi)


def test_repeat_on_the_card(cuda):
    # `repeat` takes its lane count from a static int, so nothing of its
    # trace lives on the CPU: generate with one lane constrained, assess of
    # the stacked array (and the refusal of an `(i, "x")` sample of one lane),
    # `project` of one lane and of all, and an `IndexRequest` edit of one
    # lane, each against the closed-form normal density (1e-5 per unit of
    # magnitude).
    import torch.utils._pytree as pytree

    import genjax_tpu_torch as gx

    @gx.gen
    def draw(mu, sigma):
        return gx.normal(mu, sigma) @ "x"

    k, lanes, sigma = 256, 8, 0.7
    model = draw.repeat(n=lanes)
    rng = torch.Generator(device=cuda).manual_seed(0)
    mu = torch.randn(k, generator=rng, device=cuda)
    args = (gx.per_particle(mu), sigma)

    def close(got, ref):
        assert got.device.type == cuda.type and got.shape == ref.shape
        assert bool(((got - ref).abs() <= 1e-5 * ref.abs().clamp(min=1.0)).all())

    seen = torch.tensor(0.5, device=cuda)
    tr, w = model.generate(rng, gx.ChoiceMap.d({(2, "x"): seen}), args, n=k)
    assert all(v.device.type == cuda.type for v in pytree.tree_leaves(tr) if isinstance(v, torch.Tensor))
    xs = tr.get_choices()["x"]
    assert xs.shape == (k, lanes) and bool((xs[:, 2] == seen).all())
    close(w, _normal_logpdf(seen, mu, sigma))
    close(tr.inner.get_score(), _normal_logpdf(xs, mu[:, None], sigma))

    total = _normal_logpdf(xs, mu[:, None], sigma).sum(-1)
    close(model.assess(gx.ChoiceMap.kw(x=gx.per_particle(xs)), args, n=k)[0], total)
    with pytest.raises(ValueError, match="some lanes only"):  # assess wants every lane: the stacked array
        model.assess(gx.ChoiceMap.d({(3, "x"): gx.per_particle(xs[:, 3])}), args, n=k)
    close(tr.project(rng, gx.Selection.at[3, "x"]), _normal_logpdf(xs[:, 3], mu, sigma))
    close(tr.project(rng, gx.Selection.at[..., "x"]), total)

    moved = torch.tensor(-0.5, device=cuda)
    new, w_edit, _, bwd = tr.edit(rng, gx.IndexRequest(3, gx.Update(gx.ChoiceMap.kw(x=moved))))
    close(w_edit, _normal_logpdf(moved, mu, sigma) - _normal_logpdf(xs[:, 3], mu, sigma))
    assert isinstance(bwd, gx.IndexRequest) and bwd.idx == 3
    close(bwd.request.constraint["x"], xs[:, 3])
    after = new.get_choices()["x"]
    assert bool((after[:, 3] == moved).all()) and torch.equal(after[:, :3], xs[:, :3]) and torch.equal(after[:, 4:], xs[:, 4:])
    assert all(v.device.type == cuda.type for v in pytree.tree_leaves(new) if isinstance(v, torch.Tensor))


def test_branching_path_on_the_card(cuda):
    # Mixture SIR through `mix` (K=65,536): every leaf of the trace on the
    # card, one K1 launch for the LML and one for the draw; then block-move
    # MH through `Switch`, a reversible jump between its branches and
    # `enumerative_gibbs` at C=1024 with PyTorch's sync debug mode set to
    # raise: none of them synchronises.
    import torch.utils._pytree as pytree

    import genjax_tpu_torch as gx

    C, B, S = gx.ChoiceMap, gx.ChoiceMapBuilder, gx.Selection.at
    logits = torch.tensor([0.3, -0.2], device=cuda)

    @gx.gen
    def narrow():
        return gx.normal(0.0, 1.0) @ "v"

    @gx.gen
    def wide():
        return gx.normal(5.0, 2.0) @ "v"

    @gx.gen
    def mixture():
        v = gx.mix(narrow, wide)(logits, (), ()) @ "m"
        return gx.normal(v, 0.5) @ "y"

    rng = torch.Generator(device=cuda).manual_seed(0)
    col = gx.ImportanceK(gx.Target(mixture, (), C.kw(y=2.5)), k_particles=65_536).run_smc(rng)
    tr = col.get_particles()
    assert all(v.device.type == cuda.type for v in pytree.tree_leaves(tr) if isinstance(v, torch.Tensor))
    before = fused_logsumexp.launches
    lml = col.get_log_marginal_likelihood_estimate()
    assert fused_logsumexp.launches == before + 1 and math.isfinite(float(lml))
    before = fused_logsumexp.launches
    drawn = col.sample_particle(rng).get_choices()["m", "mixture_component"]
    assert fused_logsumexp.launches == before + 1 and int(drawn) in (0, 1)

    @gx.gen
    def shared():
        mu = gx.normal(0.0, 1.0) @ "mu"
        return (mu, mu)

    @gx.gen
    def apart():
        return (gx.normal(0.0, 1.0) @ "mu1", gx.normal(0.0, 1.0) @ "mu2")

    ys = torch.tensor([0.4, 0.1, 0.6, 0.3], device=cuda)

    @gx.gen
    def two_blocks(ys1, ys2):
        m = gx.flip(0.5) @ "m"
        means = gx.switch(shared, apart)(m.to(torch.int64), (), ()) @ "k"
        _ = gx.normal(means[0][..., None] * torch.ones(4, device=cuda), 0.5) @ "y1"
        _ = gx.normal(means[1][..., None] * torch.ones(4, device=cuda), 0.5) @ "y2"

    @gx.gen
    def aux_up():
        _ = gx.normal(0.0, 0.7) @ "u"

    @gx.gen
    def aux_down():
        return 0.0

    up = gx.JumpProposal(
        read=lambda chm: chm["k", "mu"].unmask(0.0), aux=aux_up,
        involution=lambda mu, u: ((mu + u["u"], mu - u["u"]), C.empty()),
        constraint=lambda p: B["m"].set(True) | B["k", "mu1"].set(p[0]) | B["k", "mu2"].set(p[1]),
    )
    down = gx.JumpProposal(
        read=lambda chm: (chm["k", "mu1"].unmask(0.0), chm["k", "mu2"].unmask(0.0)), aux=aux_down,
        involution=lambda p, u: ((p[0] + p[1]) / 2.0, C.kw(u=(p[0] - p[1]) / 2.0)),
        constraint=lambda mu: B["m"].set(False) | B["k", "mu"].set(mu),
    )

    @gx.gen
    def indicator():
        z = gx.categorical(torch.zeros(2, device=cuda)) @ "z"
        _ = gx.normal(torch.where(z == 0, -1.0, 1.0), 1.0) @ "y"

    block = gx.Regenerate(S["m", "mixture_component"] | S["m", "component_sample", ...])
    mix_chains, _ = mixture.importance(rng, C.kw(y=2.5), (), n=1024)
    rj_chains, _ = two_blocks.importance(rng, C.kw(y1=ys, y2=-ys), (ys, -ys), n=1024)
    gibbs_chains, _ = indicator.importance(rng, C.kw(y=0.9), (), n=1024)
    values = torch.arange(2, device=cuda)

    def moves():
        a = gx.run_chains(rng, mix_chains, block, 3)[0]
        b = gx.reversible_jump(rng, rj_chains, up, down, lambda chm: ~chm["m"])[0]
        c = gx.enumerative_gibbs(rng, gibbs_chains, "z", values)
        return a, b, c

    moves()  # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a synchronising call raises
    try:
        a, b, c = moves()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert a.get_choices()["m", "mixture_component"].shape == (1024,)
    assert b.get_choices()["m"].device.type == cuda.type and c.get_choices()["z"].device.type == cuda.type


def _on_card(tree, cuda) -> bool:
    import torch.utils._pytree as pytree

    return all(v.device.type == cuda.type for v in pytree.tree_leaves(tree) if isinstance(v, torch.Tensor))


@pytest.mark.parametrize("method", ["multinomial", "systematic", "stratified", "residual"])
def test_resampler_maps_on_the_card_match_the_cpu(cuda, method):
    # Each resampler's deterministic part, fed the same uniforms on the card
    # and on the CPU, gives the same ancestors (but for float32 ties, at most
    # 1 slot in 1000).
    from genjax_tpu_torch.inference import smc

    g = torch.Generator().manual_seed(0)
    n = 10_000
    lw = 3.0 * torch.randn(n, generator=g)
    us = smc.sorted_uniforms(g, n)
    perm = torch.randperm(n, generator=g)
    u = torch.rand(n, generator=g)

    def ancestors(dev):
        lw_d, us_d, perm_d, u_d = (x.to(dev) for x in (lw, us, perm, u))
        if method == "multinomial":
            return smc.multinomial_ancestors(us_d, perm_d, lw_d)
        if method == "stratified":
            return smc.stratified_ancestors(u_d, lw_d)
        if method == "residual":
            return smc.residual_ancestors(us_d, perm_d, lw_d)
        return smc.cum_counts_to_ancestors(smc.systematic_cum_counts(u_d[0], lw_d, n), n)

    card, cpu = ancestors(cuda), ancestors("cpu")
    assert card.device.type == cuda.type and card.shape == (n,)
    assert int((card.cpu() != cpu).sum()) <= n // 1000


@pytest.mark.parametrize("method", ["multinomial", "systematic", "stratified", "residual"])
def test_filter_with_each_resampler_on_the_card(cuda, method):
    # BASELINE config 3's filter (the 64-state HMM, here T=12, K=4096): one
    # logsumexp_ess launch per step and none else, `collect=` stacked over T
    # on the card, and the LML within 5 SE of the forward algorithm over 10
    # runs.
    import statistics

    from genjax_tpu_torch.models import hmm

    cfg = hmm.BenchConfig(T=12)
    obs, init = cfg.data(cuda), cfg.initial_state()
    pf = hmm.hmm_filter(cfg.hmm(), init, 4096, method, cuda)
    rng = torch.Generator(device=cuda).manual_seed(1)
    before = (fused_logsumexp.launches, fused_logsumexp_ess.launches)
    lml, z, lws = pf.run(rng, obs, collect=lambda z, lw: lw)
    assert (fused_logsumexp.launches, fused_logsumexp_ess.launches) == (before[0], before[1] + cfg.T - 1)
    assert lws.shape == (cfg.T, 4096) and _on_card((lml, z, lws), cuda)
    lmls = [float(lml)] + [float(pf.run(rng, obs)[0]) for _ in range(9)]
    exact = float(hmm.exact_log_marginal(cfg.hmm(), obs, init))
    assert abs(statistics.fmean(lmls) - exact) < 5 * statistics.stdev(lmls) / math.sqrt(10), (lmls, exact)


def test_smc_driver_on_the_card(cuda):
    # The HMM scan program under SMCDriver (16 states, T=6, K=4096): every
    # leaf on the card, one logsumexp_ess per gate and one logsumexp for the
    # LML; then the dense round of the 1M-particle bench at K=65,536: 1
    # logsumexp and 2 logsumexp_ess, the resampled ESS equal to K.
    import statistics

    from genjax_tpu_torch.inference.exact_testbed import build_hmm_chain_model
    from genjax_tpu_torch.models import conjugate, hmm

    cfg = hmm.BenchConfig(n_states=16, T=6)
    obs, init = cfg.data(cuda), cfg.initial_state()
    model = build_hmm_chain_model(cfg.hmm(), cfg.T, cuda)
    driver = __import__("genjax_tpu_torch").smc.SMCDriver(n_particles=4096)
    rng = torch.Generator(device=cuda).manual_seed(2)
    before = (fused_logsumexp.launches, fused_logsumexp_ess.launches)
    col = hmm.run_hmm_smc(rng, model, obs, init, driver, rejuvenate_every=2)
    lml = col.get_log_marginal_likelihood_estimate()
    assert (fused_logsumexp.launches, fused_logsumexp_ess.launches) == (before[0] + 1, before[1] + cfg.T - 1)
    assert _on_card(col, cuda) and col.get_particles().get_choices()["z"].shape == (4096, cfg.T)
    lmls = [float(lml)] + [
        float(hmm.run_hmm_smc(rng, model, obs, init, driver, 2).get_log_marginal_likelihood_estimate()) for _ in range(7)
    ]
    exact = float(hmm.exact_log_marginal(cfg.hmm(), obs, init))
    assert abs(statistics.fmean(lmls) - exact) < 5 * statistics.stdev(lmls) / math.sqrt(8), (lmls, exact)

    c = conjugate.BenchConfig(n_particles=65_536)
    before = (fused_logsumexp.launches, fused_logsumexp_ess.launches)
    lml, ess0, mean_x, resampled = conjugate.smc_round(rng, c.driver(), c.target())
    assert (fused_logsumexp.launches, fused_logsumexp_ess.launches) == (before[0] + 1, before[1] + 2)
    assert _on_card((lml, ess0, mean_x, resampled), cuda)
    assert abs(float(resampled.get_ess()) - c.n_particles) <= 1e-3 * c.n_particles
    assert abs(float(lml) - c.exact_lml()) < 0.02 and abs(float(mean_x) - c.posterior_mean()) < 0.05


def test_sir_algorithms_on_the_card(cuda):
    # Importance(q=), ImportanceK(q=), ChangeTarget and CSMC's
    # estimate_logpdf on the conjugate normal model: every leaf on the card,
    # each estimate near its closed form (K=65,536 makes the error small).
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.inference.smc import ChangeTarget, Importance, ImportanceK

    @gx.gen
    def model(s):
        x = gx.normal(0.0, s) @ "x"
        _ = gx.normal(x, 1.0) @ "y"

    @gx.marginal()
    @gx.gen
    def q_wide(target):
        _ = gx.normal(0.0, 1.5) @ "x"

    def lml(s):
        return -0.5 / (s * s + 1) - 0.5 * math.log(2 * math.pi * (s * s + 1))

    t1, t2 = gx.Target(model, (1.0,), gx.ChoiceMap.kw(y=1.0)), gx.Target(model, (2.0,), gx.ChoiceMap.kw(y=1.0))
    rng = torch.Generator(device=cuda).manual_seed(3)
    one = Importance(t1, q_wide).run_smc(rng)
    assert _on_card(one, cuda) and one.get_log_weights().shape == (1,)
    col = ImportanceK(t1, q_wide, k_particles=65_536).run_smc(rng)
    assert _on_card(col, cuda) and abs(float(col.get_log_marginal_likelihood_estimate()) - lml(1.0)) < 0.02
    moved = ChangeTarget(ImportanceK(t1, k_particles=65_536), t2).run_smc(rng)
    assert _on_card(moved, cuda) and abs(float(moved.get_log_marginal_likelihood_estimate()) - lml(2.0)) < 0.03
    retained = gx.ChoiceMap.kw(x=torch.tensor(0.2, device=cuda))
    csmc = ImportanceK(t1, k_particles=65_536).run_csmc(rng, retained)
    assert _on_card(csmc, cuda) and float(csmc.get_particle(65_535).get_choices()["x"]) == pytest.approx(0.2)
    est = ImportanceK(t1, k_particles=65_536).estimate_logpdf(rng, retained, t1)
    assert abs(float(est) - (-0.5 * 0.09 / 0.5 - 0.5 * math.log(math.pi))) < 0.02


def test_particle_mcmc_smoothing_and_tempering_on_the_card(cuda):
    # PMMH, a PGAS sweep, FFBS and tempered SMC on the linear-Gaussian SSM
    # and the conjugate model: every output on the card and finite, with the
    # shapes of their contracts; K1 runs in each filter.
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.inference.particle_gibbs import ParticleGibbs
    from genjax_tpu_torch.inference.pmmh import PMMH
    from genjax_tpu_torch.inference.requests import GaussianDrift
    from genjax_tpu_torch.inference.smoothing import ffbs_sample, smoothing_clouds
    from genjax_tpu_torch.inference.tempered import TemperedSMC

    @gx.gen
    def init(a):
        z = gx.normal(0.0, 1.0) @ "z"
        _ = gx.normal(z, 0.4) @ "y"
        return z

    @gx.gen
    def step(z_prev, t, a):
        z = gx.normal(a * z_prev, 0.5) @ "z"
        _ = gx.normal(z, 0.4) @ "y"
        return z

    rng = torch.Generator(device=cuda).manual_seed(4)
    ys = torch.tensor([0.3, 1.0, 0.5, -0.2, 0.8, 0.1, 0.4, 0.9], device=cuda)
    a = torch.tensor(0.7, device=cuda)
    pf = gx.BootstrapFilter(step, init, 512, obs_addr="y")
    prior = lambda th: gx.normal.logpdf(th, 0.0, 1.0)  # noqa: E731
    before = fused_logsumexp_ess.launches
    theta, (thetas, lmls, accepts) = PMMH(pf, log_prior=prior, step_scales=0.2).run(rng, a, ys, 20)
    assert fused_logsumexp_ess.launches == before + 21 * (len(ys) - 1)
    assert _on_card((theta, thetas, lmls, accepts), cuda) and bool(torch.isfinite(lmls).all())
    theta, path, (thetas, accs) = ParticleGibbs(pf, log_prior=prior, step_scales=0.2).run(rng, a, ys, 5)
    assert _on_card((theta, path, thetas, accs), cuda) and path.shape == ys.shape
    _, clouds, lws = smoothing_clouds(pf, rng, ys, (a,))
    paths = ffbs_sample(rng, pf, clouds, lws, 256, ys, (a,))
    assert _on_card((clouds, lws, paths), cuda) and paths.shape == (256, len(ys)) and bool(torch.isfinite(paths).all())

    @gx.gen
    def conj():
        mu = gx.normal(0.0, 1.0) @ "mu"
        _ = gx.normal(mu, 1.0) @ "y"

    target = gx.Target(conj, (), gx.ChoiceMap.kw(y=1.0))
    for request in (GaussianDrift(gx.Selection.at["mu"], 0.6), gx.MALA(gx.Selection.at["mu"], 0.25)):
        smc = TemperedSMC(n_particles=4096, betas=torch.linspace(0.0, 1.0, 8, device=cuda), request=request, n_moves=2)
        col, log_z = smc.run(rng, target)
        assert _on_card((col, log_z), cuda) and abs(float(log_z) - (-0.25 - 0.5 * math.log(4 * math.pi))) < 0.1
    col, log_z, betas = smc.run_adaptive(rng, target)
    assert _on_card((col, log_z), cuda) and math.isfinite(float(log_z))


GRAD_SIZES = [1, 4_096, 1_000_000]


@pytest.mark.parametrize("n", GRAD_SIZES)
def test_kernel_gradient_matches_the_plain_twin(cuda, n):
    # The forward launches the kernel once and records a gradient; the
    # backward equals torch.logsumexp's within 1e-6 of max(1, |ref|) per
    # element, aligned and not.
    rng = torch.Generator(device=cuda).manual_seed(n)
    base = 3.0 * torch.randn(n + 3, generator=rng, device=cuda)
    for s in (0, 1, 3):
        x = base[s : s + n].detach().requires_grad_()
        before = fused_logsumexp.launches
        out = logsumexp(x)
        assert fused_logsumexp.launches == before + 1 and out.grad_fn is not None
        (got,) = torch.autograd.grad(out, x)
        (ref,) = torch.autograd.grad(torch.logsumexp(x, 0), x)
        assert float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()) <= 1e-6
        _close(out.detach(), logsumexp_plain(x.detach()))


def test_ess_has_no_gradient_and_its_logsumexp_has_one(cuda):
    x = torch.randn(10_000, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1)).requires_grad_()
    before = fused_logsumexp_ess.launches
    lse, ess = logsumexp_ess(x)
    assert fused_logsumexp_ess.launches == before + 1
    assert lse.grad_fn is not None and not ess.requires_grad
    (got,) = torch.autograd.grad(2.0 * lse, x)
    (ref,) = torch.autograd.grad(2.0 * torch.logsumexp(x, 0), x)
    assert float((got - ref).abs().max()) <= 1e-6
    _pair_close((lse.detach(), ess), logsumexp_ess_plain(x.detach()))


def test_without_a_gradient_the_kernel_path_is_unchanged(cuda):
    x = torch.randn(4096, device=cuda)
    with torch.no_grad():
        out = logsumexp(x.requires_grad_())
    assert out.grad_fn is None
    _close(out, logsumexp_plain(x.detach()))


def test_an_elbo_step_on_the_card_gives_a_finite_gradient(cuda):
    # The RAVI model's ELBO gradient at (0, 0): its one-particle LML goes
    # through the kernel, forward and backward; the mean of 64 estimates
    # lies within 5 SE of the closed form (-8, 4).
    from genjax_tpu_torch.inference import vi
    from genjax_tpu_torch.models import ravi

    step = vi.ELBO(ravi.guide, ravi.make_target)
    rng = torch.Generator(device=cuda).manual_seed(0)
    before = fused_logsumexp.launches
    grads = torch.stack([torch.stack(step(rng, (0.0, 0.0))) for _ in range(64)]).double()
    assert fused_logsumexp.launches >= before + 64
    assert grads.device.type == "cuda" and bool(torch.isfinite(grads).all())
    se = grads.std(0) / 8.0
    assert bool(((grads.mean(0) - torch.tensor([-8.0, 4.0], device=cuda, dtype=torch.float64)).abs() < 5 * se).all())


def test_vi_entry_points_on_the_card(cuda):
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.inference.nested import NestedSampler
    from genjax_tpu_torch.models import ravi

    params = ravi.train_guide(0, n_steps=150)
    assert all(p.device.type == "cuda" for p in params)
    assert abs(float(params[0]) - 1.6) < 0.25
    lml = ravi.nested_smc_lml(1, params, 100_000)
    assert lml.device.type == "cuda" and abs(float(lml) - ravi.exact_lml()) < 0.01

    @gx.gen
    def model():
        x = gx.normal(0.0, 1.0) @ "x"
        _ = gx.normal(x, 0.5) @ "y"

    ns = NestedSampler(model, (), gx.ChoiceMap.kw(y=1.0), gx.Selection.at["x"], n_live=100, n_iters=300, n_mcmc=5)
    before = fused_logsumexp.launches
    out = ns.run(torch.Generator(device=cuda).manual_seed(2))
    assert fused_logsumexp.launches == before + 2  # the evidence and its live remainder
    assert out["lml"].device.type == "cuda" and math.isfinite(float(out["lml"]))


def test_elbo_training_and_fit_make_no_device_sync(cuda):
    from genjax_tpu_torch.inference import vi
    from genjax_tpu_torch.models import ravi

    rng = torch.Generator(device=cuda).manual_seed(5)
    step = vi.ELBO(ravi.guide, ravi.make_target)
    ravi.train_guide(rng, n_steps=2)  # warm up
    vi.fit(rng, step, (0.0, 0.0), n_steps=2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a synchronising call raises
    try:
        params = ravi.train_guide(rng, n_steps=10)
        fitted, norms = vi.fit(rng, step, (0.0, 0.0), n_steps=10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert params[0].device.type == "cuda" and norms.shape == (10,) and fitted[0].device.type == "cuda"


# -- the library path -----------------------------------------------------------


def _library_case_names():
    from genjax_tpu_torch.distributions.library_checks import cases

    return sorted(cases())


@pytest.mark.parametrize("name", _library_case_names())
def test_every_distribution_at_a_million_draws_on_the_card(cuda, name):
    # Draws in the support, moments (or a median, or a probability) within
    # 5 SE of the closed form, the log density of 4096 draws against the
    # float64 reference (`distributions/library_checks.py`).
    from genjax_tpu_torch.distributions import library_checks

    out = library_checks.check(name, library_checks.cases()[name], torch.Generator(device=cuda).manual_seed(7), 1_000_000)
    assert out["shape"][0] == 1_000_000


@pytest.mark.parametrize("concentration", [0.01, 1.0, 100.0])
def test_rejection_samplers_accept_every_lane_on_the_card(cuda, concentration):
    from genjax_tpu_torch.distributions import library as lib

    rng = torch.Generator(device=cuda).manual_seed(3)
    mu = torch.tensor([0.0, 0.6, 0.8], device=cuda)
    for name, draw in (
        ("von_mises", lambda: lib.von_mises.sample(rng, 0.0, concentration, n=1_000_000)),
        ("von_mises_fisher", lambda: lib.von_mises_fisher.sample(rng, mu, concentration, n=1_000_000)),
        ("zipf", lambda: lib.zipf.sample(rng, 1.0 + concentration, n=1_000_000)),
    ):
        x = draw()
        stats = lib.rejection_stats[name]
        assert stats["accepted"] and x.device.type == "cuda", (name, stats)
        assert stats["syncs"] == math.ceil(stats["trips"] / lib.REJECTION_CHECK_EVERY)


def test_gmm_cookbook_recovery_and_no_sync_per_sweep_on_the_card(cuda):
    from genjax_tpu_torch.models import gmm

    g = gmm.BenchConfig()
    rng = torch.Generator(device=cuda).manual_seed(1)
    true_idx, obs = gmm.simulate_gmm_data(rng, g.small_n, g.true_means, g.true_probs)
    trace, counts = gmm.init_gibbs(rng, obs, g.k), []
    for _ in range(g.small_sweeps):
        trace, c = gmm.gibbs_sweep(rng, trace, obs, g.k)
        counts.append(c)
    counts = torch.stack(counts)
    chm = trace.get_choices()
    score, _ = gmm.make_gmm(g.k, g.small_n).assess(chm, ())
    assert math.isclose(float(trace.get_score()), float(score), abs_tol=1e-2, rel_tol=1e-5)
    means = torch.sort(chm["means"]).values.cpu()
    assert bool(((means - torch.tensor(g.true_means)).abs() < 0.3).all()), means
    order = torch.argsort(chm["means"])
    assert bool(((chm["probs"][order].cpu() - torch.tensor(g.true_probs)).abs() < 0.12).all())
    assert float((torch.argsort(order)[chm["idx"]] == true_idx).float().mean()) > 0.95
    assert bool((chm["obs"] == obs).all()) and bool((counts.sum(-1) == g.small_n).all())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a synchronising call raises
    try:
        for _ in range(3):
            trace, _ = gmm.gibbs_sweep(rng, trace, obs, g.k)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_sv_pmmh_recovers_the_parameters_on_the_card(cuda):
    # The JAX test's recovery (`tests/inference/test_stochvol.py`): 256
    # particles, 400 PMMH steps, T=200, its tolerances; one logsumexp_ess
    # launch per filter step.
    import numpy as np

    from genjax_tpu_torch.models import stochvol as sv

    _, ys = sv.simulate_sv_data(0, 200, sv.true_theta())
    before = fused_logsumexp_ess.launches
    _, thetas, lmls, accs = sv.run_sv_pmmh(1, ys, n_particles=256, n_steps=400)
    assert fused_logsumexp_ess.launches - before == 401 * 199
    assert bool(torch.isfinite(lmls).all()) and 0.1 < float(accs.float().mean()) < 0.95
    phis = np.tanh(thetas["phi"][150:].cpu().numpy())
    sigmas = np.exp(thetas["log_sigma"][150:].cpu().numpy())
    betas = np.exp(thetas["log_beta"][150:].cpu().numpy())
    assert abs(phis.mean() - 0.9) < 0.17, phis.mean()
    assert abs(sigmas.mean() - 0.3) < 0.25, sigmas.mean()
    assert abs(betas.mean() - 0.8) < 0.30, betas.mean()


def test_particle_gibbs_on_sv_on_the_card(cuda):
    import numpy as np

    from genjax_tpu_torch.inference.particle_gibbs import ParticleGibbs
    from genjax_tpu_torch.models import stochvol as sv

    _, ys = sv.simulate_sv_data(2, 120, sv.true_theta())
    pg = ParticleGibbs(sv.make_sv_filter(128), log_prior=sv.sv_log_prior, step_scales=0.08, theta_steps=3)
    theta, path, (thetas, accs) = pg.run(torch.Generator(device=cuda).manual_seed(3), sv.sv_theta(1.0, -1.0, 0.0), ys, n_sweeps=200)
    assert path.shape == (120,) and path.device.type == "cuda"
    assert bool(torch.isfinite(thetas["phi"]).all())
    assert 0.05 < float(accs.float().mean()) < 0.98
    phis = np.tanh(thetas["phi"][80:].cpu().numpy())
    assert abs(phis.mean() - 0.9) < 0.3, phis.mean()


def _count_syncs(fn) -> tuple[int, object]:
    """(device synchronisations PyTorch's sync debug mode reports while
    `fn` runs, its result)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught), out


def _within_combined_se(a: torch.Tensor, b: torch.Tensor, n_se: float = 5.0) -> None:
    a, b = a.double().cpu().reshape(a.shape[0], -1), b.double().cpu().reshape(b.shape[0], -1)
    se = (a.var(0) / a.shape[0] + b.var(0) / b.shape[0]).sqrt()
    assert bool(((a.mean(0) - b.mean(0)).abs() < n_se * se).all()), (a.mean(0), b.mean(0), se)


def test_nuts_makes_no_sync_at_8192_chains_and_matches_the_cpu(cuda):
    # Two NUTS draws at max_depth 6 over 8192 logistic-regression chains:
    # 0 synchronisations, and the final w against 1024 chains on the CPU.
    import genjax_tpu_torch as gx

    request = gx.NUTS(gx.Selection.at["w"], 0.02, max_depth=6)
    rng, chains = _logreg_chains(cuda, 8192)
    gx.run_chains(rng, chains, request, 1)  # warm up
    syncs, (final, accepted) = _count_syncs(lambda: gx.run_chains(rng, chains, request, 2))
    assert syncs == 0 and bool(accepted.all())
    cpu_rng, cpu_chains = _logreg_chains(torch.device("cpu"), 1024, seed=5)
    cpu_final, _ = gx.run_chains(cpu_rng, cpu_chains, request, 2)
    _within_combined_se(final.get_choices()["w"], cpu_final.get_choices()["w"])


def test_chees_makes_one_sync_per_step_and_matches_the_cpu(cuda):
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.inference import chees
    from genjax_tpu_torch.inference.sample import sample_posterior
    from genjax_tpu_torch.models import hierarchical

    y, sigma = hierarchical.EIGHT_SCHOOLS_Y.to(cuda), hierarchical.EIGHT_SCHOOLS_SIGMA.to(cuda)
    rng = torch.Generator(device=cuda).manual_seed(0)
    traces, _ = hierarchical.eight_schools.importance(rng, gx.ChoiceMap.kw(ys=y), (sigma,), n=64)
    sel = ~gx.ChoiceMap.kw(ys=y).get_selection()
    syncs, (warmed, tuned) = _count_syncs(lambda: chees.chees_warmup(rng, traces, sel, n_steps=12))
    assert syncs == 12
    syncs, _ = _count_syncs(lambda: chees.run_chees_chains(rng, warmed, sel, tuned, 8))
    assert syncs == 8

    @gx.gen
    def conjugate():
        mu = gx.normal(0.0, 1.0) @ "mu"
        _ = gx.normal(mu, 1.0) @ "obs"

    draws = []
    for device in (cuda, torch.device("cpu")):
        out = sample_posterior(torch.Generator(device=device).manual_seed(1), conjugate, gx.ChoiceMap.kw(obs=1.0),
                               n_chains=256, n_warmup=60, n_samples=40)
        draws.append(out.samples["mu"][:, -1])
    _within_combined_se(*draws)


def test_elliptical_loop_reads_match_its_trips_and_the_cpu(cuda):
    # A scalar normal model (no Cholesky): the loop's host reads are the
    # move's only synchronisations, one every ELLIPTICAL_CHECK_EVERY trips.
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.inference.requests import elliptical

    @gx.gen
    def model():
        mu = gx.normal(1.0, 2.0) @ "mu"
        _ = gx.normal(mu, 1.0) @ "obs"

    req = gx.EllipticalSlice(gx.Selection.at["mu"], mean=1.0)
    finals = []
    for device in (cuda, torch.device("cpu")):
        rng = torch.Generator(device=device).manual_seed(2)
        tr, _ = model.importance(rng, gx.ChoiceMap.kw(obs=3.0), (), n=2048)
        for _ in range(6):
            if device.type == "cuda":
                before = dict(elliptical.elliptical_stats)
                syncs, (tr, _) = _count_syncs(lambda: gx.mh(rng, tr, req))
                moved = {k: v - before[k] for k, v in elliptical.elliptical_stats.items()}
                assert moved["moves"] == 1 and moved["capped"] == 0 and syncs == moved["syncs"]
                assert moved["syncs"] == moved["trips"] // elliptical.ELLIPTICAL_CHECK_EVERY + 1
            else:
                tr, _ = gx.mh(rng, tr, req)
        finals.append(tr.get_choices()["mu"])
    _within_combined_se(*finals)


def _algorithm_models(device):
    import chip_smoke
    import genjax_tpu_torch as gx

    return chip_smoke.algorithm_models(gx, str(device))


def test_svgd_steps_make_no_sync_and_the_stein_direction_matches_float64(cuda):
    # SVGD at bench.py's width (4096 particles, logreg D=16): 0 syncs over
    # a run; the Stein direction at the start within 1e-4 (f32) and 5e-2
    # (bf16 operands, f32 accumulation) of max |phi| of float64 on the CPU.
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.inference import svgd as sv
    from genjax_tpu_torch.models.logreg import logistic_regression, simulate_logreg_data

    rng = torch.Generator(device=cuda).manual_seed(5)
    X, ys, _ = simulate_logreg_data(rng, 256, 16)
    args = (logistic_regression, (X,), gx.ChoiceMap.kw(ys=ys), gx.Selection.at["w"])
    for kd in (None, torch.bfloat16):
        syncs, (traces, phi) = _count_syncs(lambda: sv.svgd(rng, *args, n_particles=4096, n_steps=4, kernel_dtype=kd))
        assert syncs == 0 and _on_card((traces, phi), cuda) and phi.shape == (4,)
    traces, x0, unravel = sv._prepare_particles(rng, *args, 4096)
    g0 = sv._grad_batch(args[3], traces, (X,), unravel)(x0)
    _, h = sv.stein_direction(x0, g0)
    ref = sv.stein_phi_block(*(v.double().cpu() for v in (x0, x0, g0, h)), 4096)
    for kd, tol in ((None, 1e-4), (torch.bfloat16, 5e-2)):
        got = sv.stein_phi_block(x0, x0, g0, h, 4096, kd)
        assert float((got.double().cpu() - ref).abs().max()) < tol * float(ref.abs().max())


def test_bf16_contractions_accumulate_in_f32_on_the_card(cuda):
    from genjax_tpu_torch.inference.svgd import _mm_f32

    rng = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(512, 64, generator=rng, device=cuda).to(torch.bfloat16)
    got = _mm_f32(a, a.T)
    ref = a.double().cpu() @ a.double().cpu().T
    assert got.dtype == torch.float32 and float((got.double().cpu() - ref).abs().max()) < 1e-4 * float(ref.abs().max())
    assert not torch.backends.cuda.matmul.allow_tf32


def test_smc2_reads_the_gate_once_per_step_and_reduces_through_k1(cuda):
    import chip_smoke
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.inference.smc2 import SMC2

    m = _algorithm_models(cuda)
    ys = torch.tensor(chip_smoke.lg_data(12, 3), device=cuda)
    alg = SMC2(m.lg_step, m.lg_init, prior_sample=lambda g, k: torch.randn(k, generator=g, device=g.device),
               log_prior=lambda a: gx.normal.logpdf(a, 0.0, 1.0), n_theta=128, n_x=128, step_scales=0.25)
    rng = torch.Generator(device=cuda).manual_seed(1)
    alg.run(rng, ys)
    before = (fused_logsumexp.launches, fused_logsumexp_ess.launches)
    syncs, out = _count_syncs(lambda: alg.run(rng, ys))
    assert syncs == 11 and (fused_logsumexp.launches - before[0], fused_logsumexp_ess.launches - before[1]) == (1, 11)
    assert _on_card((out["thetas"], out["lml"], out["loglik"]), cuda) and math.isfinite(float(out["lml"]))


def test_rbpf_one_sync_per_step_and_the_linear_case_exact_on_the_card(cuda):
    import chip_smoke
    from genjax_tpu_torch.inference.rbpf import RaoBlackwellFilter

    m = _algorithm_models(cuda)
    ys_list = chip_smoke.rbpf_data(20, 2)
    ys = torch.tensor(ys_list, device=cuda)[:, None]
    rng = torch.Generator(device=cuda).manual_seed(2)
    lml, _ = RaoBlackwellFilter(m.z_step, m.z_init, lambda z: m.linear, 100_000).run(rng, ys)
    exact = chip_smoke.scalar_kalman_lml(chip_smoke.RB_A_X, chip_smoke.RB_Q_X, chip_smoke.RB_R0, ys_list)
    assert abs(float(lml) - exact) < 1e-5 * max(1.0, abs(exact))
    rb = RaoBlackwellFilter(m.z_step, m.z_init, m.lgss_of_z, 100_000)
    before = fused_logsumexp_ess.launches
    syncs, (lml, (z, mu, P)) = _count_syncs(lambda: rb.run(rng, ys))
    assert syncs == 19 and fused_logsumexp_ess.launches - before == 19
    assert _on_card((lml, z, mu, P), cuda) and math.isfinite(float(lml))


def test_systematic_resampling_never_picks_a_zero_weight_particle_at_a_million(cuda):
    # Half the weights -inf, as ABC-SMC's survivors: the card's parallel
    # cumsum must not hand any of them a slot or a query, in any of the
    # resamplers (the float64 prefix sum of `smc.prefix_cdf`).
    from genjax_tpu_torch.inference.smc import RESAMPLERS

    rng = torch.Generator(device=cuda).manual_seed(6)
    for name, resample in sorted(RESAMPLERS.items()):
        for _ in range(10):
            d = torch.rand(1_000_000, generator=rng, device=cuda)
            lw = torch.where(d <= torch.quantile(d, 0.5), 0.0, -torch.inf)
            anc = resample(rng, lw, 1_000_000)
            assert bool(torch.isfinite(lw[anc]).all()), name


def test_abc_smc_launches_k1_once_per_generation_and_never_syncs(cuda):
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.inference.abc import ABCSMC

    m = _algorithm_models(cuda)
    alg = ABCSMC(m.abc_model, (), gx.Selection.at["theta"], summary_fn=lambda tr: tr.get_choices()["y"],
                 observed_summary=1.0, n_particles=200_000, n_generations=6, n_moves=3)
    rng = torch.Generator(device=cuda).manual_seed(3)
    before = fused_logsumexp.launches
    syncs, out = _count_syncs(lambda: alg.run(rng))
    assert syncs == 0 and fused_logsumexp.launches - before == 6
    th = out["traces"].get_choices()["theta"]
    assert _on_card((th, out["epsilons"]), cuda) and abs(float(th.mean()) - 0.8) < 0.05
    assert bool((out["distances"] <= out["epsilons"][-1]).all())


def test_involutive_mh_and_parallel_tempering_never_sync_on_the_card(cuda):
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.inference.involutive import involutive_mh
    from genjax_tpu_torch.inference.parallel_tempering import ParallelTempering
    from genjax_tpu_torch.inference.requests import GaussianDrift

    m = _algorithm_models(cuda)
    rng = torch.Generator(device=cuda).manual_seed(4)
    tr, _ = m.lognormal.importance(rng, gx.ChoiceMap.kw(y=2.0), (), n=8192)

    def chain():
        t = tr
        for _ in range(5):
            t, acc = involutive_mh(rng, t, gx.Selection.at["x"], m.aux_scale, m.scale_move)
        return t, acc

    syncs, (t, acc) = _count_syncs(chain)
    assert syncs == 0 and _on_card((t, acc), cuda)
    pt = ParallelTempering(betas=torch.tensor([1.0, 0.5, 0.25, 0.1, 0.02], device=cuda),
                           request=GaussianDrift(gx.Selection.at["mu"], 0.5), n_moves=2)
    target = gx.Target(m.bimodal, (), gx.ChoiceMap.kw(y=4.0))
    syncs, out = _count_syncs(lambda: pt.run(rng, target, 20, collect=lambda t: t.get_choices()["mu"],
                                             init_constraint=gx.ChoiceMap.kw(mu=2.0)))
    assert syncs == 0 and _on_card((out.collected, out.perm, out.swap_rates), cuda) and out.collected.shape == (20,)


# -- incremental edits: the plan on the card -------------------------------------------------------


def _schools_chains(cuda, n_chains: int, centered: bool = False):
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.models import hierarchical as h

    rng = torch.Generator(device=cuda).manual_seed(3)
    y, sigma = h.EIGHT_SCHOOLS_Y.to(cuda), h.EIGHT_SCHOOLS_SIGMA.to(cuda)
    model = h.eight_schools_centered if centered else h.eight_schools
    tr, _ = model.importance(rng, gx.ChoiceMap.kw(ys=y), (sigma,), n=n_chains)
    latent = "theta" if centered else "z"
    return rng, tr, [gx.Selection.at[a] for a in ("mu", "log_tau", latent)]


def test_the_edit_plan_adds_no_sync_on_the_card(cuda):
    """Gibbs sweeps of incremental `Regenerate` MH moves: the analysis is
    cached after the first sweep, and no sweep reads the device."""
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.lang import analysis

    for centered in (False, True):
        rng, tr, sels = _schools_chains(cuda, 1024, centered)
        tr = gx.gibbs_sweep(rng, tr, sels)  # the analysis runs here, once
        before = analysis.stats()
        syncs, (tr, _) = _count_syncs(lambda: gx.gibbs_chain(rng, tr, sels, 5))
        after = analysis.stats()
        assert syncs == 0 and after["misses"] == before["misses"] and after["fallbacks"] == before["fallbacks"]
        assert after["hits"] - before["hits"] == 15 and tr.get_choices()["mu"].device.type == "cuda"


def test_the_cache_keys_a_cuda_closure_leaf_without_a_host_copy(cuda):
    """A closure's CUDA tensor is keyed by the object and its version: the
    key reads nothing from the device, and an in-place write is a new key."""
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.lang import analysis

    @gx.gen
    def model(loc, scale):
        return gx.normal(loc, scale) @ "x"

    loc = torch.zeros(4096, device=cuda)
    source = model.partial_apply(loc).source
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a synchronising call raises
    try:
        k1 = analysis.cache_key(source, (torch.ones((), device=cuda),))
        k2 = analysis.cache_key(source, (torch.ones((), device=cuda),))
        loc.add_(1.0)
        k3 = analysis.cache_key(source, (torch.ones((), device=cuda),))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert k1 == k2 and k1 != k3


def test_the_cache_holds_no_cuda_data_alive(cuda):
    """A CUDA tensor that a model captures, and one that a closure applies,
    are keyed with no read of the device (an in-place write is a new key)
    and held by weak references: once the caller drops them and the
    edited traces, their device memory is free again."""
    import gc

    import genjax_tpu_torch as gx
    from genjax_tpu_torch.lang import analysis

    def run():
        captured, applied = torch.zeros(1 << 20, device=cuda), torch.zeros(1 << 20, device=cuda)

        @gx.gen
        def model(data, mu):
            x = gx.normal(mu + captured[0], 1.0) @ "x"
            return gx.normal(x + data[0], 1.0) @ "y"

        source = model.partial_apply(applied).source
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a synchronising call raises
        try:
            k1 = analysis.cache_key(source, (torch.zeros((), device=cuda),))
            k2 = analysis.cache_key(source, (torch.zeros((), device=cuda),))
            captured.add_(1.0)
            k3 = analysis.cache_key(source, (torch.zeros((), device=cuda),))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert k1 == k2 and k1 != k3
        rng = torch.Generator(device=cuda).manual_seed(0)
        tr = model.partial_apply(applied).simulate(rng, (torch.zeros((), device=cuda),), n=64)
        before = analysis.stats()["misses"]
        gx.mh(rng, tr, gx.Regenerate(gx.Selection.at["x"]))
        assert analysis.stats()["misses"] == before + 1

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    run()
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) - base < (1 << 20)


@pytest.mark.parametrize("centered", [False, True], ids=["non_centered", "centered"])
def test_plan_weights_equal_dense_weights_on_the_card(cuda, centered, monkeypatch):
    """One sweep's `Regenerate` weights under the plan equal the dense
    (fallback-plan) weights on the same state and generator, within
    float32, and so do the proposed traces."""
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.lang import static

    rng, tr, sels = _schools_chains(cuda, 8192, centered)
    for sel in sels:
        state = rng.get_state()
        new, w, _, _ = gx.Regenerate(sel).edit(rng, tr, gx.Diff.no_change(tr.get_args()))
        rng.set_state(state)
        with monkeypatch.context() as m:
            m.setattr(static, "_static_edit_plan", lambda *a, **k: static._FALLBACK_PLAN)
            dense, w_dense, _, _ = gx.Regenerate(sel).edit(rng, tr, gx.Diff.no_change(tr.get_args()))
        scale = torch.clamp(w_dense.abs(), min=1.0)
        assert bool(((w - w_dense).abs() <= 1e-5 * scale).all())
        for a, b in zip(torch.utils._pytree.tree_leaves(new.get_choices()),
                        torch.utils._pytree.tree_leaves(dense.get_choices())):
            assert torch.equal(a, b)
        tr, _ = gx.mh(rng, tr, gx.Regenerate(sel))


@pytest.fixture
def one_rank_group(cuda, tmp_path, request):
    """A one-rank process group (NCCL, or the backend the test names) for
    the parallel layer, taken down after the test."""
    import torch.distributed as dist

    dist.init_process_group(getattr(request, "param", "nccl"), init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_sharded_reductions_on_a_one_rank_nccl_group_equal_the_dense_k1(cuda, one_rank_group):
    """`sharded_lml`/`sharded_ess` over a one-rank NCCL group: the LML is
    the K1 pair's `lse - log K` to the bit (the shifted sum is exactly 1),
    the ESS within 1e-6 of the pair's (a float64 ratio of its two sums)."""
    from genjax_tpu_torch.parallel import particle_mesh, sharded_ess, sharded_lml

    mesh = particle_mesh(device_type="cuda")
    x = 3.0 * torch.randn(1_000_000, generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    lse, ess = fused_logsumexp_ess(x)
    before = fused_logsumexp_ess.launches
    lml, est = sharded_lml(x, mesh), sharded_ess(x, mesh)
    assert fused_logsumexp_ess.launches - before == 2  # one K1 launch per call
    assert lml.device.type == "cuda" and float(lml) == float(lse - math.log(x.numel()))
    assert abs(float(est) - float(ess)) <= 1e-6 * float(ess)


def test_the_collectives_record_counts_the_bytes_of_cuda_tensors(cuda, one_rank_group):
    """On NCCL nothing is staged; each call's bytes are the tensor's."""
    from genjax_tpu_torch.parallel import collectives as C
    from genjax_tpu_torch.parallel import particle_mesh

    mesh = particle_mesh(device_type="cuda")
    C.reset_stats()
    C.all_reduce(torch.ones(3, device=cuda), mesh, "particles", "max")
    gathered = C.all_gather(torch.ones(5, 2, device=cuda), mesh, "particles")
    C.broadcast(torch.zeros(4, dtype=torch.int64, device=cuda), mesh, "particles")
    assert gathered.shape == (5, 2) and gathered.is_cuda
    stats = C.stats()["particles"]
    assert stats["all_reduce"] == {"calls": 1, "bytes": 12}
    assert stats["all_gather"] == {"calls": 1, "bytes": 40}
    assert stats["broadcast"] == {"calls": 1, "bytes": 32}
    assert stats["staged"] == {"calls": 0, "bytes": 0} and stats["exchange"]["calls"] == 0


@pytest.mark.parametrize("one_rank_group", ["gloo"], indirect=True)
def test_a_gloo_group_takes_cuda_tensors_in_its_collectives_unstaged(cuda, one_rank_group):
    """gloo's all-reduce, all-gather and broadcast take CUDA tensors as they
    are (only its point-to-point sends abort on one, and only the exchange
    stages); the results stay on the card."""
    from genjax_tpu_torch.parallel import collectives as C
    from genjax_tpu_torch.parallel import particle_mesh

    mesh = particle_mesh(device_type="cuda")
    C.reset_stats()
    out = C.all_reduce(torch.full((8,), 2.0, device=cuda), mesh, "particles")
    gathered = C.all_gather(torch.arange(3.0, device=cuda), mesh, "particles")
    sent = C.broadcast(torch.ones(2, device=cuda), mesh, "particles")
    assert out.is_cuda and bool((out == 2.0).all())
    assert gathered.is_cuda and torch.equal(gathered.cpu(), torch.arange(3.0))
    assert sent.is_cuda and C.stats()["particles"]["staged"] == {"calls": 0, "bytes": 0}


def test_sharded_warmups_on_a_one_rank_nccl_group_equal_the_stitched_ones(cuda, one_rank_group):
    """`warmup_chains`, `nuts_warmup` and `chees_warmup` over the chain axis
    of a one-rank NCCL mesh: equal to the stitched dense warmup from
    `fork(rng, 1)[0]` bit for bit (one block: the float64 sums in one
    order), the float64 statistics all-reduced on "chains", and still one
    synchronisation per ChEES step (the leapfrog count) and none per
    `warmup_chains` step."""
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.inference.adaptation import warmup_chains
    from genjax_tpu_torch.inference.chees import chees_warmup
    from genjax_tpu_torch.inference.requests.nuts import nuts_warmup
    from genjax_tpu_torch.parallel import certify, particle_mesh
    from genjax_tpu_torch.parallel import collectives as C

    mesh = particle_mesh(axis_name="chains", device_type="cuda")
    _, chains = _logreg_chains(cuda, 1024)
    sel = gx.Selection.at["w"]
    cases = {
        "warmup": (lambda g, m: warmup_chains(g, chains, sel, n_steps=20, L=3, mesh=m),
                   lambda g: certify.stitched_warmup(g, [chains], sel, 20, L=3)),
        "nuts": (lambda g, m: nuts_warmup(g, chains, sel, n_steps=6, max_depth=3, mesh=m),
                 lambda g: certify.stitched_nuts(g, [chains], sel, 6, max_depth=3)),
        "chees": (lambda g, m: chees_warmup(g, chains, sel, n_steps=12, max_leapfrog=32, mesh=m),
                  lambda g: certify.stitched_chees(g, [chains], sel, 12, max_leapfrog=32)),
    }
    for name, (sharded, stitched) in cases.items():
        C.reset_stats()
        syncs, (warmed, res) = _count_syncs(lambda: sharded(torch.Generator(device=cuda).manual_seed(9), mesh))
        assert syncs == {"warmup": 0, "nuts": 0, "chees": 12}[name], (name, syncs)
        assert set(C.stats()) == {"chains"} and C.stats()["chains"]["all_reduce"]["calls"] > 0
        blocks, ref = stitched(torch.Generator(device=cuda).manual_seed(9))
        assert certify.warmup_equal(certify.warmup_numbers(res), certify.warmup_numbers(ref)), name
        assert torch.equal(warmed.get_choices()["w"], blocks[0].get_choices()["w"]), name


def test_data_sharded_logreg_on_a_one_rank_nccl_group_equals_the_dense_model(cuda, one_rank_group):
    """Logistic regression with its data on a one-rank "data" axis: HMC from
    the same generator equal to the dense run bit for bit with no
    synchronisation (one all-reduce of a score per density pass and of a
    gradient per backward), and importance at 100k particles with its LML
    through K1 equal to the dense one."""
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.inference.mcmc import share_chain_args
    from genjax_tpu_torch.inference.requests import HMC
    from genjax_tpu_torch.models import logreg
    from genjax_tpu_torch.parallel import particle_mesh
    from genjax_tpu_torch.parallel import collectives as C
    from genjax_tpu_torch.parallel.data import data_sharded

    mesh = particle_mesh(axis_name="data", device_type="cuda")
    X, ys, _ = logreg.simulate_logreg_data(torch.Generator(device=cuda).manual_seed(1), 256, 16)
    model = data_sharded(logreg.logistic_regression, mesh, ["ys"], data_args=(0,))
    start = share_chain_args(
        model.importance(torch.Generator(device=cuda).manual_seed(2), gx.ChoiceMap.kw(ys=ys), (X,), n=1024)[0], (X,))
    dense = logreg.init_chains(torch.Generator(device=cuda).manual_seed(2), X, ys, 1024)
    req = HMC(gx.Selection.at["w"], 0.02, L=4)
    gx.run_chains(torch.Generator(device=cuda), start, req, 1)  # warm up
    C.reset_stats()
    syncs, (finals, accs) = _count_syncs(
        lambda: gx.run_chains(torch.Generator(device=cuda).manual_seed(3), start, req, 3))
    ref, ref_accs = gx.run_chains(torch.Generator(device=cuda).manual_seed(3), dense, req, 3)
    assert syncs == 0
    assert torch.equal(finals.get_choices()["w"], ref.get_choices()["w"]) and torch.equal(accs, ref_accs)
    stats = C.stats()["data"]
    assert stats["all_reduce"]["calls"] == 3 * (2 * 5 + 1) and stats["all_gather"]["calls"] == 0

    before = fused_logsumexp.launches
    _, lw = model.importance(torch.Generator(device=cuda).manual_seed(4), gx.ChoiceMap.kw(ys=ys), (X,), n=100_000)
    lml = logsumexp(lw)
    assert fused_logsumexp.launches - before == 1
    _, ref_lw = logreg.logistic_regression.importance(torch.Generator(device=cuda).manual_seed(4),
                                                      gx.ChoiceMap.kw(ys=ys), (X,), n=100_000)
    assert torch.equal(lw, ref_lw) and float(lml) == float(logsumexp(ref_lw))
