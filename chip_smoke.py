"""Smoke run of genjax_tpu_torch on one CUDA card.

Builds the package's CUDA kernels from `genjax_tpu_torch/csrc/`, holds
each against its plain PyTorch version, then drives the particle path
through the package's own entry points: beta-bernoulli SIR at K=1,000,000
and the SSM bootstrap filter (the `entry()` sweep at K=4096, T=20, and
K=1,000,000, T=50). Every phase raises on failure; nothing is caught.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

The last two lines of standard output are one JSON object with the
kernels' launch counts, errors and times, and one with the device.
"""

import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

SIR_PARTICLES = 1_000_000
SIR_TRIALS = 20
FILTER_SEEDS = 8
BIG_FILTER_PARTICLES = 1_000_000
BIG_FILTER_STEPS = 50
BIG_FILTER_RUNS = 3
# 4096 is entry()'s K, 10,000 the first planned filter cell's, 1M the SIR's.
KERNEL_SIZES = (1, 127, 4_096, 10_000, 65_541, 262_144, 1_000_000, 16_777_216)
TIMED_CALLS = 50


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def within_se(values: list[float], exact: float, what: str, n_se: float = 5.0) -> str:
    mean = statistics.fmean(values)
    se = statistics.stdev(values) / math.sqrt(len(values))
    check(all(math.isfinite(v) for v in values), f"{what}: non-finite values {values}")
    check(abs(mean - exact) < n_se * se, f"{what}: mean {mean} is not within {n_se} SE ({se}) of {exact}")
    return f"{what} {mean:.6f} (exact {exact:.6f}, SE {se:.2e}, {abs(mean - exact) / se:.2f} SE off)"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def per_call_ms(fn, x: torch.Tensor, calls: int) -> list[float]:
    """Event time of each call on its own: the device time plus whatever
    the host's enqueueing leaves the device idle, as the caller sees it."""
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def device_ms(fn, x: torch.Tensor, calls: int) -> float:
    """Device time per call: a sleep kernel holds the stream while the
    host enqueues all `calls`, so the events time the device alone."""
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # about 25 ms at 1.98 GHz
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def same_special_value(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = float(a), float(b)
    return (math.isnan(a) and math.isnan(b)) or a == b


def phase_kernel(ops, card: str) -> dict:
    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for n in KERNEL_SIZES:
        x = 3.0 * torch.randn(n, generator=rng, device=dev)
        cases = [(f"N={n}", x)] + ([(f"N={n - 1} (unaligned start)", x[1:])] if n > 1 else [])
        for label, v in cases:
            got, ref = ops.fused_logsumexp(v), ops.logsumexp_plain(v)
            err = abs(float(got) - float(ref))
            tol = 1e-5 * max(1.0, abs(float(ref)))
            check(math.isfinite(float(got)) and err <= tol, f"logsumexp {label}: {float(got)} vs {float(ref)}")
            max_err = max(max_err, err)
            print(f"logsumexp kernel == plain at {label}: |err| {err:.3e} (tolerance {tol:.3e})")
    specials = {
        "70,000 -inf then 1,000 zeros": [-math.inf] * 70_000 + [0.0] * 1_000,
        "all -inf": [-math.inf] * 1_000,
        "+inf": [0.0, math.inf, -math.inf, 3.0],
        "NaN": [0.0, math.nan, 1.0],
        "empty": [],
    }
    for label, values in specials.items():
        x = torch.tensor(values, dtype=torch.float32, device=dev)
        got, ref = ops.fused_logsumexp(x), ops.logsumexp_plain(x)
        check(same_special_value(got, ref), f"logsumexp special case {label}: {float(got)} vs {float(ref)}")
        print(f"logsumexp kernel == plain on {label}: {float(got)}")

    timings = {}
    plain = lambda v: torch.logsumexp(v, 0)  # noqa: E731
    for n in (1_000_000, 16_777_216):
        x = 3.0 * torch.randn(n, generator=rng, device=dev)
        per_call = {plain: [], ops.fused_logsumexp: []}
        device = {plain: [], ops.fused_logsumexp: []}
        for fn in (plain, ops.fused_logsumexp):
            per_call_ms(fn, x, 5)  # warm up
        # Alternate plain, kernel, kernel, plain so drift hits both alike.
        for fn in (plain, ops.fused_logsumexp, ops.fused_logsumexp, plain):
            per_call[fn] += per_call_ms(fn, x, TIMED_CALLS // 2)
            device[fn].append(device_ms(fn, x, TIMED_CALLS // 2))
        kernel_dev, plain_dev = statistics.fmean(device[ops.fused_logsumexp]), statistics.fmean(device[plain])
        timings[n] = (kernel_dev, plain_dev)
        print(
            f"[{card}] logsumexp N={n}, device time per call ({TIMED_CALLS} calls behind a sleep kernel, "
            f"CUDA events): kernel {kernel_dev:.4f} ms ({4 * n / (kernel_dev * 1e-3) / 1e9:.1f} GB/s), "
            f"torch.logsumexp {plain_dev:.4f} ms"
        )
        print(
            f"[{card}] logsumexp N={n}, event time of single calls (median of {TIMED_CALLS}, host "
            f"enqueue included): kernel {statistics.median(per_call[ops.fused_logsumexp]):.4f} ms, "
            f"torch.logsumexp {statistics.median(per_call[plain]):.4f} ms"
        )
    return {"max_abs_err": max_err, "ms": timings[1_000_000][0], "plain_ms": timings[1_000_000][1]}


def phase_sir(gx, ops, card: str) -> None:
    from genjax_tpu_torch.models.beta_bernoulli import beta_bernoulli

    rng = torch.Generator(device="cuda").manual_seed(0)
    target = gx.Target(beta_bernoulli, (2.0, 2.0), gx.ChoiceMap.d({"v": True}))
    alg = gx.ImportanceK(target, k_particles=SIR_PARTICLES)

    def trial():
        """One SIR trial: importance over K, the LML, one categorical draw.
        Also returns how many kernel launches the LML and the draw made."""
        col = alg.run_smc(rng)
        before_lml = ops.fused_logsumexp.launches
        lml = col.get_log_marginal_likelihood_estimate()
        before_draw = ops.fused_logsumexp.launches
        draw = col.sample_particle(rng).get_choices()["p"]
        launches = (before_draw - before_lml, ops.fused_logsumexp.launches - before_draw)
        return col, lml, draw, launches

    trial()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trials = [trial() for _ in range(SIR_TRIALS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(
        all(lml_n > 0 and draw_n > 0 for *_, (lml_n, draw_n) in trials),
        "the SIR LML or categorical draw launched no logsumexp kernel",
    )

    # Checks outside the timed trials. The weighted mean goes through
    # torch.softmax, not the kernel, so it adds no launch to the count.
    rows = []
    for col, lml, draw, _ in trials:
        p = col.get_particles().get_choices()["p"].double()
        weighted_mean = torch.softmax(col.get_log_weights().double(), 0) @ p
        rows.append(torch.stack([lml.double(), weighted_mean, draw.double(), col.get_ess().double()]))
    lml, mean, draw, ess = torch.stack(rows).cpu().T.tolist()
    print("SIR " + within_se(lml, math.log(0.5), "LML"))
    print("SIR " + within_se(mean, 0.6, "posterior mean of p (self-normalized)"))
    se_draw = math.sqrt(3 * 2 / (5**2 * 6)) / math.sqrt(SIR_TRIALS)
    check(abs(statistics.fmean(draw) - 0.6) < 5 * se_draw, f"SIR resampled p mean {statistics.fmean(draw)}")
    ms = 1e3 * seconds / SIR_TRIALS
    print(
        f"[{card}] SIR beta-bernoulli K={SIR_PARTICLES}: {ms:.3f} ms/trial, "
        f"{SIR_PARTICLES / (ms * 1e-3):.4g} particles/s, ESS {statistics.fmean(ess):.0f}/trial = "
        f"{statistics.fmean(ess) / (ms * 1e-3):.4g} ESS/s ({SIR_TRIALS} trials, host clock after a sync; "
        f"the ESS is computed after the timed trials)"
    )


def phase_filter(card: str) -> None:
    from genjax_tpu_torch.entry import N_PARTICLES, N_STEPS, entry
    from genjax_tpu_torch.models.ssm import run_bootstrap_filter, simulate_ssm_data

    fn_gpu, _ = entry("cuda")
    fn_cpu, _ = entry("cpu")
    fn_gpu(torch.Generator(device="cuda").manual_seed(100))
    gpu_lml, gpu_ms = [], []
    for seed in range(FILTER_SEEDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lml, z_mean = fn_gpu(torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        gpu_ms.append(1e3 * (time.perf_counter() - t0))
        check(math.isfinite(float(z_mean)), "entry(): non-finite final mean")
        gpu_lml.append(float(lml))
    # The CPU runs come after the timed CUDA runs, so that CPU worker
    # threads do not compete with the host thread that drives the card.
    cpu_lml = [float(fn_cpu(torch.Generator().manual_seed(seed))[0]) for seed in range(FILTER_SEEDS)]
    se = math.sqrt(statistics.variance(gpu_lml) / FILTER_SEEDS + statistics.variance(cpu_lml) / FILTER_SEEDS)
    diff = statistics.fmean(gpu_lml) - statistics.fmean(cpu_lml)
    check(all(map(math.isfinite, gpu_lml + cpu_lml)), "filter LML not finite")
    check(abs(diff) < 5 * se, f"filter LML on CUDA {statistics.fmean(gpu_lml)} vs CPU {statistics.fmean(cpu_lml)}")
    print(
        f"filter entry() K={N_PARTICLES} T={N_STEPS}: mean LML CUDA {statistics.fmean(gpu_lml):.5f}, "
        f"CPU plain path {statistics.fmean(cpu_lml):.5f} ({abs(diff) / se:.2f} combined SE apart)"
    )
    ms = statistics.median(gpu_ms)
    print(
        f"[{card}] filter K={N_PARTICLES} T={N_STEPS}: {ms:.3f} ms/filter (median of {FILTER_SEEDS}), "
        f"{N_PARTICLES * N_STEPS / (ms * 1e-3):.4g} particle-steps/s"
    )

    # Device synchronisations per step, as PyTorch's sync debug mode
    # reports them over one filter.
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn_gpu(torch.Generator(device="cuda").manual_seed(200))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    print(f"filter K={N_PARTICLES} T={N_STEPS}: {syncs} device synchronisations ({syncs / (N_STEPS - 1):.2f} per step)")

    _, ys = simulate_ssm_data(torch.Generator().manual_seed(1), BIG_FILTER_STEPS)
    ys = ys.to("cuda")
    big_ms, big_lml = [], []
    # Count only what the filters add to what earlier phases left allocated.
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for seed in range(BIG_FILTER_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lml, z = run_bootstrap_filter(
            torch.Generator(device="cuda").manual_seed(seed), ys, n_particles=BIG_FILTER_PARTICLES
        )
        torch.cuda.synchronize()
        big_ms.append(1e3 * (time.perf_counter() - t0))
        big_lml.append(float(lml))
        check(math.isfinite(big_lml[-1]) and z.shape == (BIG_FILTER_PARTICLES,), "K=1M filter LML not finite")
    ms = statistics.median(big_ms)
    print(
        f"[{card}] filter K={BIG_FILTER_PARTICLES} T={BIG_FILTER_STEPS}: LML {statistics.fmean(big_lml):.4f}, "
        f"{ms:.2f} ms/filter (median of {BIG_FILTER_RUNS} runs: {', '.join(f'{t:.2f}' for t in big_ms)}), "
        f"{BIG_FILTER_PARTICLES * BIG_FILTER_STEPS / (ms * 1e-3):.4g} particle-steps/s, "
        f"peak device memory {(torch.cuda.max_memory_allocated() - base_bytes) / 2**20:.1f} MiB "
        f"(over {base_bytes / 2**20:.1f} MiB left allocated by earlier phases)"
    )


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import genjax_tpu_torch as gx
    from genjax_tpu_torch import ops
    from genjax_tpu_torch.ops import _build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.library_path("logsumexp")
    _build.load_library("logsumexp")
    print(f"built {lib.name} from genjax_tpu_torch/csrc/logsumexp.cu in {time.perf_counter() - t0:.2f} s")

    kernel = phase_kernel(ops, card)

    ops.fused_logsumexp.launches = 0
    phase_sir(gx, ops, card)
    sir_launches = ops.fused_logsumexp.launches
    check(sir_launches > 0, "the SIR phase launched no logsumexp kernel")
    phase_filter(card)
    launches = ops.fused_logsumexp.launches
    check(launches > sir_launches, "the filter phase launched no logsumexp kernel")
    print(f"logsumexp kernel launches on the main path: SIR {sir_launches}, filter {launches - sir_launches}")

    print(json.dumps({"kernels": [{
        "name": "logsumexp",
        "route": "cuda",
        "source": "genjax_tpu_torch/csrc/logsumexp.cu",
        "replaces": "genjax_tpu/ops/logsumexp.py:21",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
