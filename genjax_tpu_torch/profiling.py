"""Where the time goes on the particle, MCMC, combinator, branching, SMC,
VI, library, adaptive samplers' and last six algorithms' paths, on one
CUDA card.

Traces each configuration that `chip_smoke.py` runs with `torch.profiler`
(CUPTI device intervals) and prints, for each:

- wall: the median host-clock time of unprofiled runs, each between two
  device synchronisations;
- device busy: the union of the traced device intervals (kernels, copies,
  fills) of one profiled run;
- idle share: `1 - busy / wall`;
- peak memory: the most device memory the unprofiled runs took above what
  was allocated before them;
- device items and host kernel-launch calls per step (per trial for SIR
  and mixture SIR, per filter step for the filters, per leapfrog step for
  HMC, per MALA sweep for polyreg, per scan step for the HMM unfold, per
  MH step, jump sweep or Gibbs sweep on the branching path, per filter
  step or `extend` on the SMC path, per round for the dense SMC round,
  per estimate or gradient on the VI path, per Gibbs sweep (G1) or filter
  step (SV1) on the library path, per leapfrog step (a NUTS leaf, N1; a
  ChEES leapfrog step, H1) on the samplers' path, per SVGD step, SMC² time
  step or rejuvenation, or RBPF step on the last six algorithms' path),
  and the largest device items;
- K1: the device kernels of the logsumexp kernel in the trace beside the
  launches its wrappers counted in the same run (one kernel per launch),
  and how many device items come from `torch.softmax`.

Run from the repository root, with one CUDA card visible:

    python3 -m genjax_tpu_torch.profiling

The last line of standard output is one JSON object with every number.
"""

import json
import math
import statistics
import subprocess
import time
from collections import defaultdict

import torch

WALL_RUNS = 5
PROFILE_ATTEMPTS = 3
SIR_PARTICLES = 1_000_000
BIG_FILTER_PARTICLES = 1_000_000
BIG_FILTER_STEPS = 50


def busy_us(intervals) -> float:
    """The length of the union of `(start, end)` intervals.

    >>> busy_us([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)])
    4.0
    """
    total, reached = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end > reached:
            total += end - max(start, reached)
            reached = end
    return total


K1_KERNEL = "genjax_lse"  # the name of the logsumexp kernel in csrc/logsumexp.cu


def summarize(
    device_items, launch_calls: int, wall_ms: float, steps: int, top: int = 3, k1_launches: int = 0
) -> dict:
    """The numbers of one trace. `device_items` holds a `(name, start_us,
    end_us)` triple per device interval; `launch_calls` counts the host's
    kernel-launch API calls, `k1_launches` the launches that K1's wrappers
    counted in the traced run."""
    by_name = defaultdict(lambda: [0, 0.0])
    for name, start, end in device_items:
        by_name[name][0] += 1
        by_name[name][1] += end - start
    busy_ms = busy_us((start, end) for _, start, end in device_items) / 1e3
    largest = sorted(by_name.items(), key=lambda item: -item[1][1])[:top]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "device_items_per_step": len(device_items) / steps,
        "launch_calls_per_step": launch_calls / steps,
        "k1_launches": k1_launches,
        "k1_device_kernels": sum(K1_KERNEL in name for name, _, _ in device_items),
        "softmax_items": sum("softmax" in name.lower() for name, _, _ in device_items),
        "largest": [
            {"name": name, "count": count, "ms": us / 1e3, "share_of_busy": us / 1e3 / busy_ms}
            for name, (count, us) in largest
        ],
    }


def k1_launches() -> int:
    from genjax_tpu_torch.ops import fused_logsumexp, fused_logsumexp_ess

    return fused_logsumexp.launches + fused_logsumexp_ess.launches


def device_and_host(fn, x: torch.Tensor, calls: int) -> tuple[float, float]:
    """(device ms, host us) per call of `fn(x)`: a sleep kernel holds the
    stream while the host enqueues all `calls`, so CUDA events time the
    device alone and the host clock times the enqueueing alone."""
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # about 25 ms at 1.98 GHz
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(x)
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls, 1e6 * host_s / calls


def trace(fn, steps: int) -> dict:
    """Wall time of unprofiled runs of `fn`, the device memory they take at
    their peak above what was allocated before them, then one profiled
    run."""
    fn()
    torch.cuda.synchronize()
    walls = []
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WALL_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() - base
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    # On the card the profiler has come back with no device interval at all
    # for a run that launched kernels (one trace of 21 over three runs of
    # the smoke's phases, NVIDIA H100 80GB HBM3, torch 2.11): such a trace
    # is taken again.
    for _ in range(PROFILE_ATTEMPTS):
        before = k1_launches()
        with torch.profiler.profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        launched = k1_launches() - before
        events = prof.events()
        device = [(e.name, e.time_range.start, e.time_range.end) for e in events if e.device_type == cuda]
        if device:
            break
    else:
        raise RuntimeError(
            f"the profiler saw no device interval in {PROFILE_ATTEMPTS} traces; time with CUDA events instead"
        )
    launches = sum(1 for e in events if e.device_type == cpu and "LaunchKernel" in e.name)
    return {**summarize(device, launches, statistics.median(walls), steps, k1_launches=launched), "peak_mib": peak / 2**20}


def smc_configurations(rng: torch.Generator, dev: str = "cuda") -> list:
    """(label, steps, fn) of each configuration of the SMC path: S1 one
    config-3 filter (systematic), S2 one run of the HMM scan program under
    `SMCDriver`, S3 one dense round."""
    from genjax_tpu_torch.inference.exact_testbed import build_hmm_chain_model
    from genjax_tpu_torch.inference.smc import SMCDriver
    from genjax_tpu_torch.models import conjugate, hmm

    cfg, c = hmm.BenchConfig(), conjugate.BenchConfig()
    obs = cfg.data(dev)
    pf = hmm.hmm_filter(cfg.hmm(), cfg.initial_state(), cfg.smc_particles, "systematic", dev)
    model = build_hmm_chain_model(cfg.hmm(), cfg.T, dev)
    driver, round_driver, target = SMCDriver(n_particles=cfg.smc_particles), c.driver(), c.target()
    return [
        (f"S1 config-3 filter K={cfg.smc_particles} T={cfg.T} (systematic); steps are filter steps", cfg.T,
         lambda: pf.run(rng, obs)),
        (f"S2 HMM scan program under SMCDriver K={cfg.smc_particles} T={cfg.T}; steps are extend steps", cfg.T,
         lambda: hmm.run_hmm_smc(rng, model, obs, cfg.initial_state(), driver, cfg.rejuvenate_every)),
        (f"S3 dense SMC round K={c.n_particles} (init, LML, ESS, resample, rejuvenate, mean)", 1,
         lambda: conjugate.smc_round(rng, round_driver, target)[:3]),
    ]


def vi_configurations(rng: torch.Generator, dev: str = "cuda") -> list:
    """(label, steps, fn) of each configuration of the VI path (BASELINE
    config 5, `models/ravi.py::BenchConfig`): one guided LML estimate at
    K=1M with the guide trained for `n_train` ELBO steps, and one IWELBO
    value and gradient at N=1M from (0, 0) (the logsumexp kernel forward and
    backward)."""
    from genjax_tpu_torch.adev import expectation
    from genjax_tpu_torch.inference.smc import ImportanceK
    from genjax_tpu_torch.models import ravi

    cfg = ravi.BenchConfig()
    params = ravi.train_guide(rng, n_steps=cfg.n_train, lr=cfg.lr, obs=cfg.obs, device=dev)

    @expectation
    def negated_iwelbo(vmu, vls):
        target = ravi.make_target(vmu, vls, cfg.obs)
        return -ImportanceK(target, ravi.guide, k_particles=cfg.iwelbo_particles).estimate_normalizing_constant(rng, target)

    origin = (torch.zeros((), device=dev), torch.zeros((), device=dev))
    return [
        (f"V1 guided LML (config 5) K={cfg.k_particles}, guide trained {cfg.n_train} ELBO steps; one estimate", 1,
         lambda: ravi.nested_smc_lml(rng, params, cfg.k_particles, cfg.obs, dev)),
        (f"V2 IWELBO value and gradient N={cfg.iwelbo_particles} at (0, 0); one estimate", 1,
         lambda: negated_iwelbo.value_and_grad_estimate(rng, origin)),
    ]


def library_configurations(rng: torch.Generator, dev: str = "cuda") -> list:
    """(label, steps, fn) of the library path's configurations: G1 one
    Gibbs sweep of the Dirichlet mixture at a million points
    (`models/gmm.py::BenchConfig`), SV1 one stochastic-volatility bootstrap
    filter at the model's default width (`models/stochvol.py::BenchConfig`)."""
    from genjax_tpu_torch.models import gmm, stochvol

    g, s = gmm.BenchConfig(), stochvol.BenchConfig()
    _, obs = gmm.simulate_gmm_data(rng, g.wide_n, g.true_means, g.true_probs, device=dev)
    trace = gmm.init_gibbs(rng, obs, g.k, device=dev)
    ys, theta, pf = s.data(dev), stochvol.true_theta(dev), stochvol.make_sv_filter(s.n_particles)
    return [
        (f"G1 GMM Gibbs sweep N={g.wide_n} K={g.k} (assignments, weights, means: three dense Updates); one sweep", 1,
         lambda: gmm.gibbs_sweep(rng, trace, obs, g.k)),
        (f"SV1 stochastic-volatility bootstrap filter K={s.n_particles} T={s.T}; steps are filter steps", s.T,
         lambda: pf.run(rng, ys, (theta,))),
    ]


H1_PROFILE_STEPS = 20  # ChEES sampling steps of one profiled H1 run


def sampler_configurations(rng: torch.Generator, dev: str = "cuda") -> list:
    """(label, steps, fn) of the adaptive samplers' configurations: N1 one
    logistic-regression NUTS run at BASELINE config 4's width
    (`models/logreg.py::BenchConfig`: C=8192, S=10 draws at max_depth 6;
    the steps are leapfrog steps, `S * (2**6 - 1)` leaves), and H1
    `H1_PROFILE_STEPS` ChEES sampling steps on eight schools at
    `run_eight_schools`'s width (64 chains) after its 300-step warmup,
    from a generator seeded afresh in each run, so every run takes the
    same leapfrog counts (the steps are those leapfrog steps)."""
    from genjax_tpu_torch.core.choice_map import ChoiceMap
    from genjax_tpu_torch.core.typing import per_particle
    from genjax_tpu_torch.inference import chees
    from genjax_tpu_torch.models import hierarchical, logreg

    cfg = logreg.BenchConfig()
    X, ys = cfg.data(dev)
    md = cfg.nuts_max_depth
    y, sigma = hierarchical.EIGHT_SCHOOLS_Y.to(dev), hierarchical.EIGHT_SCHOOLS_SIGMA.to(dev)
    n_chains = 64
    start = ChoiceMap.kw(ys=y, log_tau=per_particle(4.0 * torch.rand(n_chains, generator=rng, device=dev) - 2.0))
    traces, _ = hierarchical.eight_schools.importance(rng, start, (sigma,), n=n_chains)
    sel = ~ChoiceMap.kw(ys=y).get_selection()
    warmed, tuned = chees.chees_warmup(rng, traces, sel, n_steps=300)
    fixed = torch.Generator(device=dev)

    def chees_steps():
        fixed.manual_seed(7)
        return chees.run_chees_chains(fixed, warmed, sel, tuned, H1_PROFILE_STEPS)

    before = chees.chees_stats["leapfrog_total"]
    chees_steps()
    leapfrogs = chees.chees_stats["leapfrog_total"] - before
    return [
        (f"N1 logreg NUTS C={cfg.n_chains} N={cfg.n_data} D={cfg.dim} eps={cfg.eps} S={cfg.n_steps} "
         f"max_depth={md}, one run (chain init, S draws); steps are leapfrog steps (leaves)",
         cfg.n_steps * (2**md - 1),
         lambda: logreg.run_nuts_chains(rng, X, ys, n_chains=cfg.n_chains, n_steps=cfg.n_steps, eps=cfg.eps,
                                        max_depth=md)),
        (f"H1 eight schools ChEES, {n_chains} chains, {H1_PROFILE_STEPS} sampling steps after the 300-step "
         f"warmup ({leapfrogs} leapfrog steps); steps are leapfrog steps",
         leapfrogs, chees_steps),
    ]


def algorithm_configurations(rng: torch.Generator, dev: str = "cuda") -> list:
    """(label, steps, fn) of the last six algorithms' configurations, at
    `chip_smoke.py`'s widths (its `SVGD_CFG`, `SMC2_CFG`, `RBPF_CFG` and
    `algorithm_models`): SV1 and SV2 one SVGD step at N=4096, D=16 (the
    per-particle gradient, the Stein direction, the update) in f32 and in
    bf16; M1 one SMC² time step at 1024 x 1024 without a rejuvenation (every
    inner filter's advance, the parameter weights' reduction and the
    gate's read), M1r one rejuvenation at t=12 (the resample and two PMMH
    moves, each re-running the filters up to t); R1 one RBPF step at K=1M
    (gate, z-kernel, Kalman update). The state each step starts from is
    made once, here."""
    import chip_smoke
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.inference import svgd as sv
    from genjax_tpu_torch.inference.pmmh import _broadcast_scales
    from genjax_tpu_torch.inference.rbpf import RaoBlackwellFilter
    from genjax_tpu_torch.inference.smc import systematic_resample
    from genjax_tpu_torch.inference.smc2 import SMC2
    from genjax_tpu_torch.models.logreg import logistic_regression, simulate_logreg_data
    from genjax_tpu_torch.ops import logsumexp_ess

    m = chip_smoke.algorithm_models(gx, dev)
    c, s, r = chip_smoke.SVGD_CFG, chip_smoke.SMC2_CFG, chip_smoke.RBPF_CFG
    X, ys, _ = simulate_logreg_data(torch.Generator(device=dev).manual_seed(5), c["n_data"], c["dim"])
    traces, x0, unravel = sv._prepare_particles(
        rng, logistic_regression, (X,), gx.ChoiceMap.kw(ys=ys), gx.Selection.at["w"], c["n_particles"]
    )
    grad = sv._grad_batch(gx.Selection.at["w"], traces, (X,), unravel)

    def svgd_step(kernel_dtype):
        phi, _ = sv.stein_direction(x0, grad(x0), None, kernel_dtype)
        return x0 + c["step_size"] * phi

    t_mid = s["T"] // 2
    obs = torch.tensor(chip_smoke.lg_data(s["T"], s["seed"]), device=dev)
    alg = SMC2(m.lg_step, m.lg_init, prior_sample=lambda g, k: torch.randn(k, generator=g, device=g.device),
               log_prior=lambda a: gx.normal.logpdf(a, 0.0, 1.0), n_theta=s["n_theta"], n_x=s["n_x"], step_scales=0.25)
    thetas = alg.prior_sample(rng, s["n_theta"])
    scales = _broadcast_scales(alg.step_scales, thetas)
    loglik, z, lw_x = alg._masked_loglik(rng, thetas, obs, t_mid - 1)

    def smc2_step():
        _, _, incr = alg._advance_all(rng, thetas, z, lw_x, obs[t_mid], t_mid)
        _, ess = logsumexp_ess(loglik + incr)
        return bool(ess < alg.theta_ess_threshold * s["n_theta"])

    def smc2_rejuvenation():
        lse, _ = logsumexp_ess(loglik)
        state = alg._take_thetas(systematic_resample(rng, loglik, s["n_theta"], lse), thetas, z, lw_x, loglik)
        for _ in range(alg.n_rejuv):
            state = alg._pmmh_move(rng, *state, obs, t_mid, scales)[:4]
        return state

    rb = RaoBlackwellFilter(m.z_step, m.z_init, m.lgss_of_z, r["n_particles"])
    ys_rb = torch.tensor(chip_smoke.rbpf_data(r["T"], r["data_seed"]), device=dev)[:, None]
    state = rb.init(rng, ys_rb[0])
    return [
        (f"SV1 SVGD step logreg N={c['n_data']} D={c['dim']} f32, {c['n_particles']} particles; one step", 1,
         lambda: svgd_step(None)),
        (f"SV2 SVGD step logreg N={c['n_data']} D={c['dim']} bf16, {c['n_particles']} particles; one step", 1,
         lambda: svgd_step(torch.bfloat16)),
        (f"M1 SMC2 time step {s['n_theta']} x {s['n_x']} at t={t_mid}, no rejuvenation; one step", 1, smc2_step),
        (f"M1r SMC2 rejuvenation {s['n_theta']} x {s['n_x']} at t={t_mid} ({alg.n_rejuv} PMMH moves); one "
         "rejuvenation", 1, smc2_rejuvenation),
        (f"R1 RBPF step K={r['n_particles']}; one step", 1, lambda: rb.step(rng, *state, ys_rb[1], 1)),
    ]


def configurations():
    """(label, steps, fn) of each configuration, on the card."""
    import genjax_tpu_torch as gx
    from genjax_tpu_torch.entry import N_PARTICLES, N_STEPS, entry
    from genjax_tpu_torch.models.beta_bernoulli import beta_bernoulli
    from genjax_tpu_torch.models.ssm import run_bootstrap_filter, simulate_ssm_data

    rng = torch.Generator(device="cuda").manual_seed(0)
    target = gx.Target(beta_bernoulli, (2.0, 2.0), gx.ChoiceMap.d({"v": True}))
    alg = gx.ImportanceK(target, k_particles=SIR_PARTICLES)

    def sir_trial():
        col = alg.run_smc(rng)
        return col.get_log_marginal_likelihood_estimate(), col.sample_particle(rng)

    from genjax_tpu_torch.inference.exact_testbed import build_hmm_chain_model
    from genjax_tpu_torch.models import hmm, logreg, polyreg

    small_filter, _ = entry("cuda")
    _, ys = simulate_ssm_data(torch.Generator().manual_seed(1), BIG_FILTER_STEPS)
    ys = ys.to("cuda")
    hmc, pr = logreg.BenchConfig(), polyreg.BenchConfig()
    X, yl = hmc.data("cuda")
    xs, yp = pr.data("cuda")
    hm = hmm.BenchConfig()
    chain_model = build_hmm_chain_model(hm.hmm(), hm.T, "cuda")
    xh = hm.data("cuda")

    def unfold():
        col = hmm.run_hmm_importance(rng, chain_model, xh, hm.initial_state(), hm.n_particles)
        return col.get_log_marginal_likelihood_estimate()

    # The branching path's models are defined in `chip_smoke.py`, as the
    # cookbook defines its own (this module runs from the repository root).
    import chip_smoke

    branching = chip_smoke.branching_configurations(gx, rng)

    return [
        (f"SIR beta-bernoulli K={SIR_PARTICLES}, one trial (importance, LML, one draw)", 1, sir_trial),
        (f"filter K={N_PARTICLES} T={N_STEPS}", N_STEPS, lambda: small_filter(rng)),
        (
            f"filter K={BIG_FILTER_PARTICLES} T={BIG_FILTER_STEPS}",
            BIG_FILTER_STEPS,
            lambda: run_bootstrap_filter(rng, ys, n_particles=BIG_FILTER_PARTICLES),
        ),
        (
            f"logreg HMC C={hmc.n_chains} N={hmc.n_data} D={hmc.dim} L={hmc.L} S={hmc.n_steps}, one run "
            "(chain init, S MH steps); steps are leapfrog steps",
            hmc.n_steps * hmc.L,
            lambda: logreg.run_hmc_chains(rng, X, yl, n_chains=hmc.n_chains, n_steps=hmc.n_steps, eps=hmc.eps, L=hmc.L),
        ),
        (
            f"polyreg IS K={pr.n_particles} + MALA x{pr.n_sweeps}, one run; steps are sweeps",
            pr.n_sweeps,
            lambda: polyreg.run_is_mh(
                rng, xs, yp, pr.n_particles, pr.n_sweeps, obs_noise=pr.obs_noise, step_size=pr.step_size
            ),
        ),
        (
            f"HMM unfold (scan) K={hm.n_particles} T={hm.T}, {hm.n_states} states, every x constrained, and "
            "the LML; steps are scan steps",
            hm.T,
            unfold,
        ),
        (
            f"logreg HMC through Vmap C={hmc.n_chains} N={hmc.n_data} D={hmc.dim} L={hmc.L} S={hmc.n_steps}, one run; "
            "steps are leapfrog steps",
            hmc.n_steps * hmc.L,
            lambda: logreg.run_hmc_chains(
                rng, X, yl, n_chains=hmc.n_chains, n_steps=hmc.n_steps, eps=hmc.eps, L=hmc.L,
                model=logreg.logistic_regression_vmap, ys_address=logreg.VMAP_YS,
            ),
        ),
        *branching,
        *smc_configurations(rng),
        *vi_configurations(rng),
        *library_configurations(rng),
        *sampler_configurations(rng),
        *algorithm_configurations(rng),
    ]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device (torch.cuda.is_available() is False)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    results = {}
    for label, steps, fn in configurations():
        r = trace(fn, steps)
        results[label] = r
        largest = "; ".join(
            f"{item['name'][:80]} x{item['count']} {item['ms']:.3f} ms ({100 * item['share_of_busy']:.1f}%)"
            for item in r["largest"]
        )
        print(
            f"[{card}] {label}: wall {r['wall_ms']:.3f} ms (median of {WALL_RUNS}), device busy "
            f"{r['device_busy_ms']:.3f} ms, idle {100 * r['idle_share']:.1f}%, "
            f"{r['device_items_per_step']:.1f} device items and {r['launch_calls_per_step']:.1f} "
            f"launch calls per step; peak device memory {r['peak_mib']:.1f} MiB; K1: {r['k1_device_kernels']} device kernels for {r['k1_launches']} "
            f"launches; torch.softmax items: {r['softmax_items']}; largest: {largest}"
        )
    print(json.dumps({"card": card, "configurations": results}))


if __name__ == "__main__":
    main()
