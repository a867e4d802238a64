"""Smoke run of genjax_tpu_torch on one CUDA card.

Builds the package's CUDA kernels from `genjax_tpu_torch/csrc/`, holds
each entry point (`logsumexp`, `logsumexp_ess`) against its plain PyTorch
version at the main path's sizes, aligned and not, on the special values,
back to back and on two streams, and times both beside their bound and
`torch.logsumexp`. Then it drives the particle path through the package's
own entry points: beta-bernoulli SIR at K=1,000,000 and the SSM bootstrap
filter (the `entry()` sweep at K=4096, T=20, and K=1,000,000, T=50),
checking that each filter step reduces its weights with one launch. Then
the MCMC path: logistic-regression HMC at C=8192 chains, N=256, D=16,
eps=0.02, L=5, S=10 (timed, held against the CPU plain path, checked for
device synchronisations, and timed beside a hand-written PyTorch HMC of
the same math), MALA at C=8192 (timed), and polynomial-regression IS +
MALA at K=8192 particles over 64 points with 20 sweeps, whose LML and
resample each launch the logsumexp kernel once (the kernel also held
against its plain twin on that run's log weights). Then the combinator
path: the 64-state HMM as a `scan` program, unfolded over T=50 steps for
K=1,000,000 particles with every observation constrained (timed, profiled,
0 device synchronisations per step, 1 kernel launch for the LML, the
kernel held against its plain twin on the run's own weights), its `assess`
of 4,096 exact posterior paths held against the closed-form joint and the
CPU, its LML at T=8 held against the forward algorithm, and a single-step
`IndexRequest` edit at C=8192 chains held against the dense re-scan for
the same draws; and logistic-regression HMC at C=8192 with the likelihood
as a `vmap` over the 256 data points, held against the vector-site model
(same scores, same final `w` within error, 0 synchronisations per MH step,
timed side by side); and `repeat` at K=8192, whose trace must lie on the
card whole and whose one-lane weights are held against the closed form.
Then the branching path (`branching_models`): mixture SIR through `mix`
at K=1,000,000, every particle on its own component (the `Switch` runs
both branches for every row), its LML and P(c=1 | y) against the closed
forms, 2 kernel launches per trial, the kernel held against its plain
twin on the run's own weights; block-move MH through `Switch` at C=8192
chains, reversible jump between the branches of the two-block model and
`enumerative_gibbs` at the same width, each against its exact posterior
and with 0 device synchronisations per step; each of the four timed and
profiled. Then the SMC path (`phase_smc`): S1 BASELINE config 3, the
64-state HMM's bootstrap filter at K=10,000, T=50 with each of the four
resamplers, its LML over 20 runs against the forward algorithm, one
`logsumexp_ess` launch and one synchronisation per step; S2 the same HMM
as a `scan` program under `SMCDriver` (extend, resample, rejuvenate),
its LML over 5 runs against the forward algorithm; S3 the dense SMC
round of `bench.py:477-531` at K=1,000,000 (LML, posterior mean and the
resampled ESS against their closed forms, 1 `logsumexp` and 2
`logsumexp_ess` launches per round); K1 held against its plain twin on
S1's and S3's own weights; S4 `Importance(q=)`, `ImportanceK(q=)`,
`ChangeTarget`, CSMC's `estimate_logpdf`, PMMH, particle Gibbs, FFBS and
tempered SMC at their JAX tests' sizes against closed forms. Then the VI
path (`phase_vi`), BASELINE config 5 at the width of `bench.py::_ravi`:
150 ELBO steps of `train_guide` against the posterior N(1.6, 0.2) (0
syncs and 1 kernel launch per step), the ELBO gradient at (0, 0) over 256
estimates against its closed form (-8, 4), 8 IWELBO values and gradients
at N=1M (the kernel forward and backward at full width; its backward held
against `torch.logsumexp`'s on the run's own weights within 1e-6), 20
guided LML estimates at K=1M against the exact LML, and the nested
sampler at its JAX test's size against the exact evidence. K1's gradient
is also held against the plain twin's at every kernel size and its
backward timed beside `torch.logsumexp`'s. Then the library path
(`phase_library`): each of the 48 distributions drawn at a million values
through `simulate`, held against its closed-form moments (a median or a
probability for the heavy tails) and its float64 SciPy density, and
timed; the three rejection samplers at concentrations 0.01, 1 and 100,
every lane accepted, their trips and host reads counted; the Dirichlet
mixture at the cookbook's size with the JAX test's five assertions and at
N=1,000,000 over 50 sweeps (score against a fresh `assess`, every sweep's
counts adding to N, 0 synchronisations per sweep, time, peak memory);
stochastic volatility at K=1024, T=200: 20 filters against the CPU plain
path with one `logsumexp_ess` launch per step and K1 held against its
plain twin on the steps' own weights, 100 PMMH steps, and particle Gibbs
at its JAX test's size. Then the adaptive samplers' path
(`phase_samplers`: NUTS, ChEES, `sample_posterior`, elliptical slice,
Kalman and STS). Then the last six algorithms (`phase_algorithms`): SVGD
on logistic regression at `bench.py`'s width (4096 particles; 2000 steps
in f32 and bf16, 500 at D=128 and packed 8 x D=16), timed beside its TFLOP count
and traffic bound, with 0 syncs, every score equal to a fresh `assess`,
the Stein direction against float64 on the CPU and the conjugate model
against its closed form; SMC² at 1024 x 1024 and the Rao-Blackwellized
filter at K=1,000,000 against their Kalman oracles and the CPU, with one
sync and one `logsumexp_ess` launch per step and K1 held against its
plain twin on their own weights; ABC-SMC at 1,000,000 particles (one K1
launch per generation) and rejection ABC against the conjugate posterior;
involutive MH at 8192 chains and the five-replica tempering ladder, 0
syncs per step or sweep. Then the auxiliary layer (`phase_aux`) and the
incremental edits (`phase_incremental`): MH-within-Gibbs on eight schools
at 8192 chains under the edit plan (the analysis run once per model, 0
fallbacks, 0 syncs per sweep, the weights equal to the dense plan's)
against the quadrature oracle, timed against the dense fallback plan;
resample-move at a million particles with the LML through K1; `SafeHMC`.
Then the parallel layer (`phase_parallel`) at one rank over NCCL in this
process, each driver against the stitched dense run from the same
generators: `ShardedSMC` at K=1,000,000 (20 rounds, every round
resampling; the sharded LML and ESS through K1) timed beside the dense
round, `GridSMC` at 8 x 131,072, sharded logreg HMC at C=8192 beside the
dense run, `sharded_pt_run` on T1's ladder, `sharded_svgd` at SV1's width,
the warmups over the chain axis (W1 `warmup_chains` on logreg at C=8192,
W2 `chees_warmup` on eight schools at 64 chains) against the stitched
dense warmups and the plain dense ones, and the data-sharded likelihoods
(D1 logreg HMC at C=8192 against the dense run, D2 importance at
K=1,000,000 with its LML through K1); then `entry.dryrun_multichip` on 1
rank (NCCL) and on 2 ranks sharing the card (gloo; the neighbour exchange
and the all-gather fallback at K=65,536, the warmup and data-sharded
sections), with each section's collectives. Every phase raises on
failure; nothing is caught.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

The last two lines of standard output are one JSON object with the
kernels' launch counts, errors and times, and one with the device.
"""

import contextlib
import dataclasses
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
# 4096 is entry()'s K, 8192 polyreg's (a grid of two blocks), 10,000 the
# first planned filter cell's, 1M the SIR's.
KERNEL_SIZES = (1, 127, 4_096, 8_192, 10_000, 65_541, 262_144, 1_000_000, 16_777_216)
TIMED_SIZES = (4_096, 10_000, 1_000_000, 16_777_216)
MAIN_PATH_N = 1_000_000  # the size of the kernels' line: SIR and the large filter
TIMED_CALLS = 50
BACK_TO_BACK_CALLS = 1000
# The least time of a call: its bytes over the H100's HBM rate, or its
# float32 operations over the rate outside the tensor cores, whichever is
# larger (published peaks of the SXM part at 700 W). Operations per value:
# max, subtract, exp and add; the ESS adds a multiply-add for exp(x - m)^2.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_VALUE = {"logsumexp": 4, "logsumexp_ess": 6}
OUTPUTS = {"logsumexp": 1, "logsumexp_ess": 2}
# Timed runs of the MCMC configurations (`models/logreg.py::BenchConfig`,
# `models/polyreg.py::BenchConfig`).
HMC_RUNS = 7
MALA_RUNS = 5
POLYREG_RUNS = 8
# The combinator path (`models/hmm.py::BenchConfig`, `models/logreg.py::BenchConfig`).
HMM_RUNS = 5
HMM_PATHS = 4_096
HMM_ORACLE_STEPS = 8
HMM_ORACLE_RUNS = 10
HMM_EDIT_CHAINS = 8_192
VMAP_HMC_RUNS = 5
# The branching path: the mixture of `docs/cookbook/08_mixture_mh.py` (SIR
# at the SIR headline's width, block-move MH at the MCMC path's chain
# count), reversible jump on the model of `tests/inference/test_rjmcmc.py`
# and `enumerative_gibbs` on its docstring model, at the same chain count.
MIX_PARTICLES = 1_000_000
MIX_TRIALS = 20
MIX_LOGITS = (0.3, -0.2)
MIX_MU, MIX_SIG, MIX_OBS_SD, MIX_Y = (0.0, 5.0), (1.0, 2.0), 0.5, 2.5
BRANCH_CHAINS = 8_192
BLOCK_MH_STEPS = 80
RJ_N, RJ_SIG, RJ_TAU = 4, 0.5, 0.7
RJ_SWEEPS = 100
GIBBS_Y = 0.9
GIBBS_SWEEPS = 10
PROFILE_SWEEPS = 10  # the MH steps or sweeps of one profiled run
BRANCH_RUNS = 3
# The SMC path (`models/hmm.py::BenchConfig`, `models/conjugate.py::BenchConfig`):
# S1 BASELINE config 3's filter with each resampler, S2 the HMM scan program
# under SMCDriver, S3 the dense round of `bench.py:477-531`, S4 the other
# drivers at their JAX tests' configurations.
RESAMPLING = ("systematic", "multinomial", "stratified", "residual")
SMC_FILTER_RUNS = 20
SMC_DRIVER_RUNS = 5  # cut from 10: the whole smoke passed 600 s on a slow host (PERF.md §4)
LG_Q, LG_R, LG_A = 0.5, 0.4, 0.8  # the linear-Gaussian SSM of the PMMH, PG and FFBS tests
# The VI path (`models/ravi.py::BenchConfig`, BASELINE config 5 at the width
# of `bench.py::_ravi`): ELBO gradients held at the origin, IWELBO
# estimates at N=1M, and the nested sampler at the size of
# `tests/inference/test_nested.py:35`.
ELBO_GRAD_ESTIMATES = 256
IWELBO_ESTIMATES = 8
SYNC_STEPS = 10  # the ELBO steps over which syncs are counted
NESTED_Y = (1.0, -0.5, 2.0)
NESTED = dict(n_live=400, n_iters=2400, n_mcmc=20, step_scale=0.4)
# K1's backward, `g * exp(x - lse)`: x read, the gradient written.
# The library path (`phase_library`): every distribution at a million draws,
# the rejection samplers at three concentrations, the Dirichlet mixture
# (`models/gmm.py::BenchConfig`) and stochastic volatility
# (`models/stochvol.py::BenchConfig`; particle Gibbs at its JAX test's size).
LIBRARY_DRAWS = 1_000_000
LIBRARY_LOGPDF = 4_096
REJECTION_CONCENTRATIONS = (0.01, 1.0, 100.0)
GMM_SYNC_SWEEPS = 5
PG_SV = dict(n_particles=128, T=120, n_sweeps=20, theta_steps=3)
BACKWARD_BYTES_PER_VALUE = 8
GRAD_TOLERANCE = 1e-6  # per element, relative to max(1, |ref|)
# The adaptive samplers' path (`phase_samplers`): N1 logistic-regression
# NUTS at BASELINE config 4's width (`models/logreg.py::BenchConfig`,
# `bench.py:714-750`), H1 eight schools under ChEES at `run_eight_schools`'s
# defaults, H2 the other four algorithms of `sample_posterior` at the size
# of `tests/inference/test_sample_api.py`, E1 `run_gp_ess` at its defaults
# on the data of `tests/distributions/test_gp.py`, K1s Kalman and STS at
# their tests' sizes against the CPU.
NUTS_RUNS = 3
NUTS_CPU_CHAINS = 1_024
NUTS_INFO_DRAWS = 2
SCHOOLS_SYNC_STEPS = 10
SAMPLE_API = dict(n_chains=64, n_warmup=100, n_samples=200, thin_burn=50, L=5, max_depth=4)
GP_BURN = 500
KALMAN_TOLERANCE = 1e-4  # relative to the largest |value|, as the CPU parity tests hold it
# The last six inference algorithms (`phase_algorithms`): SV1-SV4 SVGD at
# the width of `bench.py:766-768` (logistic regression, 256 data points,
# 4096 particles, step 0.05; SV3 D=128 at `bench.py:836-856`, SV4 the
# packed 8 x D=16 of `bench.py:883-910`), M1 SMC² at 1024 x 1024 on the
# AR(1) of `tests/inference/test_smc2.py`, R1 the RBPF at K=1M on the
# switching model of `tests/inference/test_rbpf.py`, A1 ABC-SMC at 1M
# particles on the conjugate model of `tests/inference/test_abc.py`, I1
# involutive MH at 8192 chains (the scaling move of
# `tests/inference/test_involutive.py`), T1 the bimodal ladder of
# `tests/inference/test_parallel_tempering.py:154-188`.
SVGD_CFG = dict(n_particles=4_096, n_data=256, dim=16, wide_dim=128, n_steps=2_000, wide_steps=500, packed_problems=8,
                packed_steps=500, step_size=0.05, cpu_particles=1_024, sync_steps=5, conjugate_steps=400)
SVGD_PEAK_OPS = {"f32": 67e12, "bf16": 989e12}  # H100 SXM: f32 without tensor cores; bf16 dense tensor cores
SVGD_SEEDS = {"SV1": 50, "SV2": 50, "SV3": 51, "SV4": 52}  # the timed runs' generators: SV1 and SV2 share one
SVGD_BF16_MEAN_TOLERANCE = 1.0  # SV2's final means from SV1's, in SV1's standard errors of the mean
STEIN_F32_TOLERANCE = 1e-4  # of max |phi|, against float64 on the CPU
STEIN_BF16_TOLERANCE = 5e-2  # of max |phi|; bf16 operands, f32 accumulation
K3_CALLS = 10  # queued behind `device_and_host`'s 25 ms sleep: their enqueueing (about 1.5 ms each) must fit in it
SMC2_CFG = dict(n_theta=1_024, n_x=1_024, T=25, small=256, seed=3)
RBPF_CFG = dict(n_particles=1_000_000, T=50, runs=10, cpu_particles=4_096, data_seed=2)
RB_A_X, RB_Q_X, RB_R0, RB_A_Z, RB_Q_Z = 0.9, 0.5, 0.4, 0.9, 0.3  # `tests/inference/test_rbpf.py`
ABC_CFG = dict(n_particles=1_000_000, n_generations=8, n_moves=5, runs=5, rejection_tolerance=0.1)
INVOLUTIVE_CFG = dict(n_chains=8_192, n_steps=300, sync_steps=10)
PT_CFG = dict(n_sweeps=4_000, burn=500, sync_sweeps=10)

# The auxiliary layer (`phase_aux`): C1 checkpoint and resume of the
# conjugate model of `tests/utils/test_checkpoint_profiling.py:19-23` under
# `SMCDriver` at 1M particles (its LML is log N(1; 0, 2)); C2 the entry()
# filter at K=4096, T=20 and the filter at K=1M, T=50 with the default
# checks, under `checked_mode()` and with `do_typecheck(False)`, and the
# checks' cost on the three host-bound paths (the K=4096 filter, logreg
# HMC at C=8192, block-move MH at C=8192), on and off in alternating
# runs; C3 a profile of one SIR trial at K=1M and its operation counts;
# C4 time travel over the SIR log weights.
AUX_CFG = dict(n_particles=1_000_000, filter_pairs=15, big_filter_pairs=5, hmc_pairs=15, block_steps=10, block_pairs=15,
               wrapper_calls=100_000)
CONJUGATE_LML = -0.5 * math.log(4 * math.pi) - 0.25  # log N(1; 0, 2)
# The incremental edits' path (`phase_incremental`): I1 MH-within-Gibbs on
# eight schools (`models/hierarchical.py`) at 8192 chains, prior-proposal
# `Regenerate` moves through `inference/mcmc.py::gibbs_chain` under the
# edit plan (burn-in and collected sweeps; the plan against the dense
# fallback plan in alternating timed runs); I2 resample-move at a million
# particles (ImportanceK, the LML through K1, a systematic resample, one
# Gibbs sweep), 10 runs; I3 `SafeHMC` on the centered model.
INCREMENTAL_CFG = dict(chains=8_192, burn=100, sweeps=100, sync_sweeps=5, timed_pairs=4, timed_sweeps=20,
                       particles=1_000_000, rm_runs=10, hmc_eps=0.01, hmc_L=5, hmc_steps=10, p2_pairs=8,
                       # I1's floors on each site's moved share, about a quarter of what a
                       # CPU run at 2048 chains reads, and the centered chains' bounds on the
                       # correlation of their start with their last draw (0.17 and 0.46 there).
                       moved_floor={"non-centered": {"mu": 0.1, "log_tau": 0.15, "theta": 0.2},
                                    "centered": {"mu": 0.05, "log_tau": 0.05, "theta": 0.15}},
                       start_corr_max={"mu": 0.5, "log_tau": 0.8})

# The parallel layer (`phase_parallel`), at world size 1 over NCCL in this
# process: PS1 `ShardedSMC` on the conjugate model at K=1M, 20 rounds, every
# round resampling (ess_threshold 2, as `dryrun_multichip` runs it), timed
# beside S3's dense round, whole and piece by piece (`piece_pairs`
# alternating pairs), and profiled; PG1 `GridSMC` at C=8 x K=131072, every
# chain resampling; K1 against its plain twin on PS1's shard weights, each
# PG1 row and the pooled vector of chain LMLs; PC1
# `sharded_mh_chains` with logreg HMC at config 4's width, timed beside the
# dense `run_chains`; PT1 `sharded_pt_run` on T1's bimodal ladder; PV1
# `sharded_svgd` at SV1's width, 500 steps with an explicit bandwidth,
# timed beside the dense `svgd`. Then `entry.dryrun_multichip` on 1 rank
# (NCCL) and on 2 ranks sharing the card (gloo; K=65536: the neighbour
# exchange, the all-gather fallback, the host staging).
# W1 `warmup_chains` (HMC, L=5, 200 steps) on logreg at config 4's width
# and W2 `chees_warmup` on eight schools at H1's width and cap (64 chains,
# 300 steps, at most 1024 leapfrog steps per step), each over the chain
# axis against the stitched dense warmup (rtol 1e-5) and the plain dense
# warmup at JAX's test tolerances: W1 one run of each, timed sharded,
# dense, dense, sharded; W2 the means over `chees_pairs` independent
# pairs on `chees_pair_ranks` gloo ranks sharing the card (one 64-chain
# ChEES warmup spreads wider than the tolerances); D1 data-sharded logreg HMC at config 4's
# width against the dense `run_chains`; D2 data-sharded importance of
# logreg from the prior at K=1M, N=256, its LML through K1.
PARALLEL_CFG = dict(rounds=20, grid_chains=8, grid_particles=131_072, timed_pairs=3, piece_pairs=5, pt_sweeps=1_500,
                    pt_burn=500, pt_check_sweeps=20, sv_steps=500, sv_bandwidth=1.0, dryrun_ranks=(1, 2),
                    warmup_steps=200, warmup_L=5, chees_chains=64, chees_steps=300, chees_pairs=32,
                    chees_pair_ranks=8, data_pairs=3, data_particles=1_000_000)
# JAX's tolerances for a sharded warmup against the dense one
# (`tests/parallel/test_sharded_warmup.py`).
WARMUP_TOLERANCE = {"log eps": 0.3, "log inv_mass": 0.3, "accept": 0.08, "log T": 0.5}


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


def bound(name: str, n: int) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take for one
    call over n float32 values, each read once, the outputs written once."""
    bytes_ms = 1e3 * 4 * (n + OUTPUTS[name]) / HBM_BYTES_PER_S
    ops_ms = 1e3 * OPS_PER_VALUE[name] * n / F32_OPS_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


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


def close(got: torch.Tensor, ref: torch.Tensor) -> tuple[bool, float]:
    """(agrees, |error|): special values (NaN, +-inf) exactly, finite ones
    within 1e-5 * max(1, |ref|), as the kernel sums in another order."""
    got, ref = float(got), float(ref)
    if math.isnan(got) or math.isnan(ref) or math.isinf(got) or math.isinf(ref):
        return (math.isnan(got) and math.isnan(ref)) or got == ref, 0.0
    err = abs(got - ref)
    return err <= 1e-5 * max(1.0, abs(ref)), err


def phase_kernel(ops, card: str) -> dict:
    """Both entry points against their plain twins, back to back and on two
    streams; then their times. Returns one record per kernel for the
    kernels' line."""
    from genjax_tpu_torch.profiling import device_and_host

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(0)
    kernels = {"logsumexp": (ops.fused_logsumexp, ops.logsumexp_plain),
               "logsumexp_ess": (ops.fused_logsumexp_ess, ops.logsumexp_ess_plain)}
    max_err = dict.fromkeys(kernels, 0.0)

    def compare(name: str, got, v: torch.Tensor, label: str) -> float:
        """Check a kernel's result on v against its plain twin's; the
        largest |error|."""
        ref = kernels[name][1](v)
        pairs = zip(got, ref) if name == "logsumexp_ess" else [(got, ref)]
        worst = 0.0
        for what, (g, r) in zip(("lse", "ess"), pairs):
            ok, err = close(g, r)
            check(ok, f"{name} {label}: {what} {float(g)} vs plain {float(r)}")
            worst = max(worst, err)
        max_err[name] = max(max_err[name], worst)
        return worst

    def hold(name: str, v: torch.Tensor, label: str) -> float:
        return compare(name, kernels[name][0](v), v, label)

    for n in KERNEL_SIZES:
        x = 3.0 * torch.randn(n + 3, generator=rng, device=dev)
        errs = {name: max(hold(name, x[s : s + n], f"N={n} at offset {s}") for s in (0, 1, 3)) for name in kernels}
        print(f"kernels == plain at N={n}, offsets 0, 1 and 3 (aligned, unaligned): max |err| "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " (tolerance 1e-5 * max(1, |ref|))")
    specials = {
        "70,000 -inf then 1,000 zeros": [-math.inf] * 70_000 + [0.0] * 1_000,
        "all -inf": [-math.inf] * 1_000,
        "+inf": [0.0, math.inf, -math.inf, 3.0],
        "NaN": [0.0, math.nan, 1.0],
        "empty": [],
    }
    for label, values in specials.items():
        x = torch.tensor(values, dtype=torch.float32, device=dev)
        for name in kernels:
            hold(name, x, label)
        lse, ess = ops.fused_logsumexp_ess(x)
        print(f"kernels == plain on {label}: logsumexp {float(ops.fused_logsumexp(x))}, "
              f"logsumexp_ess ({float(lse)}, {float(ess)})")

    # Back to back with no sync: each launch must find the ticket counter
    # reset by the one before it.
    base = 3.0 * torch.randn(1_100_000, generator=rng, device=dev)
    sizes = KERNEL_SIZES[:-1]
    queued = []
    for i in range(BACK_TO_BACK_CALLS):
        n, start = sizes[i % len(sizes)], (7 * i) % 97
        name = ("logsumexp", "logsumexp_ess")[i % 2]
        v = base[start : start + n]
        queued.append((name, v, kernels[name][0](v)))
    torch.cuda.synchronize()
    for i, (name, v, got) in enumerate(queued):
        compare(name, got, v, f"back-to-back call {i} (N={v.numel()})")
    print(f"{BACK_TO_BACK_CALLS} back-to-back calls (sizes 1 to 1M, offsets 0-96, both entry points, "
          f"no sync): all equal their plain twins")

    # Two streams at once, each with its own workspace.
    xs = [3.0 * torch.randn(1_000_000 + i, generator=rng, device=dev) for i in range(4)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    queued = []
    for i in range(200):
        with torch.cuda.stream(streams[i % 2]):
            name = ("logsumexp", "logsumexp_ess")[i % 2]
            queued.append((name, xs[i % 4], kernels[name][0](xs[i % 4])))
    torch.cuda.synchronize()
    for i, (name, v, got) in enumerate(queued):
        compare(name, got, v, f"two-stream call {i}")
    print("200 calls on two streams at once (1M values each): all equal their plain twins")

    library = lambda v: torch.logsumexp(v, 0)  # noqa: E731
    timed = {"logsumexp": ops.fused_logsumexp, "logsumexp_ess": ops.fused_logsumexp_ess,
             "logsumexp plain": ops.logsumexp_plain, "logsumexp_ess plain": ops.logsumexp_ess_plain,
             "torch.logsumexp": library}
    records = {}
    for n in TIMED_SIZES:
        x = 3.0 * torch.randn(n, generator=rng, device=dev)
        device, host = {k: [] for k in timed}, {k: [] for k in timed}
        for fn in timed.values():
            device_and_host(fn, x, 5)  # warm up
        # In turns, forwards then backwards, so drift hits every version alike.
        for label in [*timed, *reversed(timed)]:
            d, h = device_and_host(timed[label], x, TIMED_CALLS // 2)
            device[label].append(d)
            host[label].append(h)
        dev_ms = {k: statistics.fmean(v) for k, v in device.items()}
        host_us = {k: statistics.fmean(v) for k, v in host.items()}
        for name in kernels:
            b_ms, b_by = bound(name, n)
            records.setdefault(name, {})[n] = {
                "ms": dev_ms[name], "plain_ms": dev_ms[f"{name} plain"], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": dev_ms["torch.logsumexp"] if name == "logsumexp" else None,
            }
            print(
                f"[{card}] {name} N={n}: device {dev_ms[name]:.4f} ms per call ({TIMED_CALLS} calls behind a "
                f"sleep kernel, CUDA events), bound {b_ms:.4g} ms ({b_by}), {100 * b_ms / dev_ms[name]:.1f}% of "
                f"bound; plain twin {dev_ms[name + ' plain']:.4f} ms; torch.logsumexp "
                f"{dev_ms['torch.logsumexp']:.4f} ms; host enqueue {host_us[name]:.2f} us per call "
                f"(plain twin {host_us[name + ' plain']:.2f}, torch.logsumexp {host_us['torch.logsumexp']:.2f})"
            )
        if n == MAIN_PATH_N:
            single = {k: statistics.median(per_call_ms(timed[k], x, TIMED_CALLS)) for k in
                      ("logsumexp", "logsumexp_ess", "torch.logsumexp")}
            print(f"[{card}] N={n}, event time of single calls (median of {TIMED_CALLS}, host enqueue "
                  f"included): " + ", ".join(f"{k} {v:.4f} ms" for k, v in single.items()))
    return {name: {"max_abs_err": max_err[name], **records[name][MAIN_PATH_N]} for name in kernels}


def grad_error(ops, x: torch.Tensor) -> float:
    """K1's gradient on `x` against the plain twin's,
    `torch.autograd.grad(torch.logsumexp(x, 0), x)`: the largest |error|
    per element over max(1, |ref|), held within GRAD_TOLERANCE. The
    comparison launch leaves the count alone."""
    before = ops.fused_logsumexp.launches
    leaf = x.detach().requires_grad_()
    (got,) = torch.autograd.grad(ops.fused_logsumexp(leaf), leaf)
    ops.fused_logsumexp.launches = before
    (ref,) = torch.autograd.grad(torch.logsumexp(leaf, 0), leaf)
    err = float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()) if x.numel() else 0.0
    check(err <= GRAD_TOLERANCE, f"K1's gradient at N={x.numel()}: max |err| / max(1, |ref|) {err} > {GRAD_TOLERANCE}")
    return err


def phase_kernel_backward(ops, card: str) -> dict:
    """K1's gradient against the plain twin's at every kernel size, aligned
    and not; then the backward's device time through `torch.autograd.grad`
    beside `torch.logsumexp`'s backward and beside the bare formula, at the
    timed sizes. Returns the numbers for K1's record in the kernels' line."""
    from genjax_tpu_torch.profiling import device_and_host

    logsumexp_module = sys.modules["genjax_tpu_torch.ops.logsumexp"]
    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for n in KERNEL_SIZES[:-1]:
        x = 3.0 * torch.randn(n + 3, generator=rng, device=dev)
        worst = max(worst, *(grad_error(ops, x[s : s + n]) for s in (0, 1, 3)))
    print(f"K1's gradient == torch.logsumexp's at N={', '.join(map(str, KERNEL_SIZES[:-1]))}, offsets 0, 1 and 3: max "
          f"|err| / max(1, |ref|) {worst:.3e} (tolerance {GRAD_TOLERANCE:g} per element)")
    before = ops.fused_logsumexp.launches
    record = {}
    for n in (4_096, MAIN_PATH_N, 16_777_216):
        leaf = (3.0 * torch.randn(n, generator=rng, device=dev)).requires_grad_()
        k1_out, lib_out = ops.fused_logsumexp(leaf), torch.logsumexp(leaf, 0)
        g, x, lse = torch.ones((), device=dev), leaf.detach(), k1_out.detach()
        timed = {
            "K1 backward": lambda _: torch.autograd.grad(k1_out, leaf, retain_graph=True),
            "torch.logsumexp backward": lambda _: torch.autograd.grad(lib_out, leaf, retain_graph=True),
            "g * exp(x - lse) alone": lambda _: logsumexp_module.lse_backward(g, x, lse),
        }
        for fn in timed.values():
            device_and_host(fn, None, 5)
        device, host = {k: [] for k in timed}, {k: [] for k in timed}
        for label in [*timed, *reversed(timed)]:
            d, h = device_and_host(timed[label], None, TIMED_CALLS // 2)
            device[label].append(d)
            host[label].append(h)
        dev_ms = {k: statistics.fmean(v) for k, v in device.items()}
        host_us = {k: statistics.fmean(v) for k, v in host.items()}
        bound_ms = 1e3 * BACKWARD_BYTES_PER_VALUE * n / HBM_BYTES_PER_S
        print(f"[{card}] K1 backward N={n}: device {dev_ms['K1 backward']:.4f} ms per call (torch.autograd.grad, "
              f"{TIMED_CALLS} calls behind a sleep kernel, CUDA events), bound {bound_ms:.4g} ms (bytes: 8N), "
              f"{100 * bound_ms / dev_ms['K1 backward']:.1f}% of bound; torch.logsumexp's backward "
              f"{dev_ms['torch.logsumexp backward']:.4f} ms; the formula alone {dev_ms['g * exp(x - lse) alone']:.4f} "
              f"ms; host {host_us['K1 backward']:.2f} us per call (torch.logsumexp's "
              f"{host_us['torch.logsumexp backward']:.2f}, the formula's {host_us['g * exp(x - lse) alone']:.2f})")
        if n == MAIN_PATH_N:
            record = {"backward_ms": dev_ms["K1 backward"], "backward_library_ms": dev_ms["torch.logsumexp backward"],
                      "backward_bound_ms": bound_ms}
        del leaf, k1_out, lib_out, x
    ops.fused_logsumexp.launches = before  # timing launches: not on a main path
    return {"grad_max_abs_err": worst, **record}


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
        all(counts == (1, 1) for *_, counts in trials),
        f"the SIR LML and categorical draw should launch the logsumexp kernel once each: {[t[-1] for t in trials]}",
    )
    print(f"K1 launches per SIR trial: 1 for the LML, 1 for the draw (each of {SIR_TRIALS} trials)")

    # Checks outside the timed trials. The weighted mean goes through
    # torch.softmax, not the kernel, so it adds no launch to the count;
    # each ESS is one launch of logsumexp_ess.
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


def phase_filter(ops, card: str) -> None:
    from genjax_tpu_torch.entry import N_PARTICLES, N_STEPS, entry
    from genjax_tpu_torch.models.ssm import run_bootstrap_filter, simulate_ssm_data

    def k1_launches() -> tuple[int, int]:
        return ops.fused_logsumexp_ess.launches, ops.fused_logsumexp.launches

    def check_one_reduction_per_step(before: tuple[int, int], steps: int, what: str) -> None:
        """Each step of a filter of `steps` steps launches logsumexp_ess
        once (the step's T - 1 weight updates), and nothing else launches
        K1: neither the resample branch nor the final resample reduces."""
        ess_n, lse_n = (a - b for a, b in zip(k1_launches(), before))
        check((ess_n, lse_n) == (steps - 1, 0),
              f"{what}: {ess_n} logsumexp_ess and {lse_n} logsumexp launches, not {steps - 1} and 0")

    fn_gpu, _ = entry("cuda")
    fn_cpu, _ = entry("cpu")
    fn_gpu(torch.Generator(device="cuda").manual_seed(100))
    gpu_lml, gpu_ms = [], []
    for seed in range(FILTER_SEEDS):
        torch.cuda.synchronize()
        before = k1_launches()
        t0 = time.perf_counter()
        lml, z_mean = fn_gpu(torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        gpu_ms.append(1e3 * (time.perf_counter() - t0))
        check_one_reduction_per_step(before, N_STEPS, f"filter K={N_PARTICLES} T={N_STEPS}")
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
        before = k1_launches()
        t0 = time.perf_counter()
        lml, z = run_bootstrap_filter(
            torch.Generator(device="cuda").manual_seed(seed), ys, n_particles=BIG_FILTER_PARTICLES
        )
        torch.cuda.synchronize()
        big_ms.append(1e3 * (time.perf_counter() - t0))
        check_one_reduction_per_step(before, BIG_FILTER_STEPS, f"filter K={BIG_FILTER_PARTICLES} T={BIG_FILTER_STEPS}")
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
    print(f"K1 launches per filter step: 1 (logsumexp_ess); per filter: {N_STEPS - 1} at T={N_STEPS}, "
          f"{BIG_FILTER_STEPS - 1} at T={BIG_FILTER_STEPS}; none in the resample branch or the final resample")


def timed_runs(fn, runs: int, warm: bool = True) -> tuple[list[float], list]:
    """Host-clock ms of `runs` calls of `fn`, each between two device
    synchronisations, after one untimed call (unless the caller has just
    made one: `warm=False`); and the calls' results."""
    if warm:
        fn()
    times, results = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(fn())
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times, results


def within_combined_se(a: torch.Tensor, b: torch.Tensor, what: str, n_se: float = 5.0) -> float:
    """Per-column means of two independent samples (rows are draws) agree
    within `n_se` combined standard errors; the largest distance in SE."""
    a, b = a.double().cpu(), b.double().cpu()
    se = (a.var(0) / a.shape[0] + b.var(0) / b.shape[0]).sqrt()
    dist = ((a.mean(0) - b.mean(0)).abs() / se).max().item()
    check(math.isfinite(dist) and dist < n_se, f"{what}: means {a.mean(0).tolist()} vs {b.mean(0).tolist()} "
          f"are {dist:.2f} combined SE apart")
    return dist


def handwritten_hmc(rng: torch.Generator, X: torch.Tensor, ys: torch.Tensor, w0: torch.Tensor, cfg) -> torch.Tensor:
    """The same leapfrog and accept math as the port's HMC on the same
    density, written directly in PyTorch: S steps of L leapfrog steps, one
    forward and backward pass each, plus one at each step's start and a
    forward-only pass at its end (the counterpart of `bench.py:646-703`)."""
    yf = ys.to(torch.float32)
    eps = cfg.eps

    def logdensity(w):
        logits = w @ X.mT
        ll = yf * torch.nn.functional.logsigmoid(logits) + (1.0 - yf) * torch.nn.functional.logsigmoid(-logits)
        return ll.sum(-1) - 0.5 * (w * w).sum(-1)

    def value_and_grad(w):
        w = w.detach().requires_grad_()
        with torch.enable_grad():
            lp = logdensity(w)
            (g,) = torch.autograd.grad(lp.sum(), w)
        return lp.detach(), g

    w = w0
    with torch.no_grad():
        for _ in range(cfg.n_steps):
            p0 = torch.randn(w.shape, generator=rng, device=w.device)
            lp0, g = value_and_grad(w)
            wi, pi = w, p0
            for _ in range(cfg.L):
                pi = pi + 0.5 * eps * g
                wi = wi + eps * pi
                _, g = value_and_grad(wi)
                pi = pi + 0.5 * eps * g
            alpha = logdensity(wi) - lp0 - 0.5 * (pi * pi).sum(-1) + 0.5 * (p0 * p0).sum(-1)
            accept = torch.log(torch.rand(alpha.shape, generator=rng, device=w.device)) < alpha
            w = torch.where(accept[:, None], wi, w)
    return w


def count_syncs(fn) -> int:
    """Device synchronisations that PyTorch's sync debug mode reports
    while `fn` runs."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_hmc(gx, card: str) -> None:
    """Logistic-regression HMC at the bench's configuration, then MALA at
    the same width, through the port's entry points."""
    from genjax_tpu_torch.models.logreg import BenchConfig, init_chains, run_hmc_chains, run_mala_chains

    cfg = BenchConfig()
    X_cpu, ys_cpu = cfg.data("cpu")
    X, ys = cfg.data("cuda")
    rng = torch.Generator(device="cuda").manual_seed(4)

    def run():
        return run_hmc_chains(rng, X, ys, n_chains=cfg.n_chains, n_steps=cfg.n_steps, eps=cfg.eps, L=cfg.L)

    times, results = timed_runs(run, HMC_RUNS)
    ms = statistics.median(times)
    w, accs = results[-1]
    check(w.shape == (cfg.n_chains, cfg.dim) and accs.shape == (cfg.n_chains, cfg.n_steps), "HMC output shapes")
    rate = accs.float().mean().item()
    check(math.isfinite(rate) and 0.0 < rate <= 1.0, f"HMC accept rate {rate}")
    check(bool(torch.isfinite(w).all()), "HMC final w not finite")
    w_cpu, _ = run_hmc_chains(
        torch.Generator().manual_seed(5), X_cpu, ys_cpu, n_chains=cfg.n_chains, n_steps=cfg.n_steps, eps=cfg.eps,
        L=cfg.L,
    )
    dist = within_combined_se(w, w_cpu, "HMC final w, CUDA against the CPU plain path")
    print(f"HMC C={cfg.n_chains} N={cfg.n_data} D={cfg.dim} eps={cfg.eps} L={cfg.L} S={cfg.n_steps}: accept rate "
          f"{rate:.4f}; final w mean per dimension within {dist:.2f} combined SE of the CPU plain path's (limit 5)")

    # Device synchronisations over S MH steps, the chains made beforehand.
    chains = init_chains(rng, X, ys, cfg.n_chains)
    request = gx.HMC(gx.Selection.at["w"], cfg.eps, L=cfg.L)
    syncs = count_syncs(lambda: gx.run_chains(rng, chains, request, cfg.n_steps))
    check(syncs == 0, f"run_chains made {syncs} device synchronisations over {cfg.n_steps} MH steps")
    print(f"HMC run_chains: {syncs} device synchronisations over {cfg.n_steps} MH steps (0 per step)")

    w0 = 0.1 * torch.randn(cfg.n_chains, cfg.dim, generator=rng, device="cuda")
    hw_times, _ = timed_runs(lambda: handwritten_hmc(rng, X, ys, w0, cfg), HMC_RUNS)
    hw_ms = statistics.median(hw_times)
    steps = cfg.n_chains * cfg.n_steps
    print(
        f"[{card}] HMC C={cfg.n_chains} S={cfg.n_steps} L={cfg.L} (N={cfg.n_data}, D={cfg.dim}): {ms:.3f} ms/run "
        f"(median of {HMC_RUNS}: {', '.join(f'{t:.2f}' for t in times)}), {steps / (ms * 1e-3):.4g} chain-steps/s; "
        f"hand-written PyTorch HMC, same math and config: {hw_ms:.3f} ms/run (median of {HMC_RUNS}); "
        f"port / hand-written = {ms / hw_ms:.3f} (host clock between syncs, chain init included in the port's run)"
    )

    mala_times, mala_results = timed_runs(
        lambda: run_mala_chains(rng, X, ys, n_chains=cfg.n_chains, n_steps=cfg.n_steps, eps=cfg.mala_eps), MALA_RUNS
    )
    rates = []
    for w, accs in mala_results:
        rates.append(accs.float().mean().item())
        check(bool(torch.isfinite(w).all()) and rates[-1] > 0.0,
              f"MALA: finite {bool(torch.isfinite(w).all())}, accept {rates[-1]}")
    print(f"[{card}] MALA C={cfg.n_chains} S={cfg.n_steps} eps={cfg.mala_eps}: accept rate "
          f"{statistics.fmean(rates):.4f}, {statistics.median(mala_times):.3f} ms/run (median of {MALA_RUNS}: "
          f"{', '.join(f'{t:.2f}' for t in mala_times)})")


def phase_polyreg(gx, ops, card: str) -> None:
    """Polynomial-regression IS + MALA at the bench's configuration: K1 held
    against its plain twin on the run's own log weights, the LML held
    against the CPU plain path, the K1 launches of each run against the
    two the code makes (the LML and the resample)."""
    from genjax_tpu_torch.models.polyreg import BenchConfig, polynomial_regression, run_is_mh

    cfg = BenchConfig()
    xs_cpu, ys_cpu = cfg.data("cpu")
    xs, ys = cfg.data("cuda")

    def launches() -> tuple[int, int]:
        return ops.fused_logsumexp.launches, ops.fused_logsumexp_ess.launches

    def run(rng: torch.Generator):
        return run_is_mh(rng, xs, ys, cfg.n_particles, cfg.n_sweeps, obs_noise=cfg.obs_noise, step_size=cfg.step_size)

    # The log weights that a run reduces twice (its first draws, from the
    # same seed), through the kernel and its plain twin. This launch is a
    # comparison, not one of the main path's, so it leaves the count alone.
    target = gx.Target(polynomial_regression, (xs, cfg.obs_noise), gx.ChoiceMap.kw(ys=ys))
    _, lw = target.importance(torch.Generator(device="cuda").manual_seed(100), gx.ChoiceMap.empty(), n=cfg.n_particles)
    counted = ops.fused_logsumexp.launches
    got = ops.fused_logsumexp(lw)
    ops.fused_logsumexp.launches = counted
    ok, err = close(got, ops.logsumexp_plain(lw))
    check(ok, f"logsumexp on the polyreg log weights (K={cfg.n_particles}): {float(got)} vs plain "
              f"{float(ops.logsumexp_plain(lw))}")
    print(f"logsumexp == plain on the polyreg log weights (K={cfg.n_particles}): |err| {err:.3e} "
          f"(tolerance 1e-5 * max(1, |ref|))")

    def counted_run(seed: int):
        before = launches()
        lml, coeffs = run(torch.Generator(device="cuda").manual_seed(seed))
        counts = tuple(a - b for a, b in zip(launches(), before))
        check(counts == (2, 0), f"polyreg run: {counts} (logsumexp, logsumexp_ess) launches, not (2, 0)")
        return lml, coeffs

    seeds = iter(range(100, 200))
    times, results = timed_runs(lambda: counted_run(next(seeds)), POLYREG_RUNS)
    gpu_lml = torch.stack([lml for lml, _ in results]).double().cpu()
    check(all(bool(torch.isfinite(c).all()) for _, c in results), "polyreg coefficients not finite")
    cpu_lml = torch.stack([
        run_is_mh(torch.Generator().manual_seed(seed), xs_cpu, ys_cpu, cfg.n_particles, cfg.n_sweeps,
                  obs_noise=cfg.obs_noise, step_size=cfg.step_size)[0]
        for seed in range(POLYREG_RUNS)
    ]).double()
    dist = within_combined_se(gpu_lml[:, None], cpu_lml[:, None], "polyreg LML, CUDA against the CPU plain path")
    ms = statistics.median(times)
    moves = cfg.n_particles * cfg.n_sweeps
    print(f"polyreg K={cfg.n_particles} over {cfg.n_points} points, {cfg.n_sweeps} MALA sweeps: mean LML "
          f"CUDA {gpu_lml.mean():.4f}, CPU plain path {cpu_lml.mean():.4f} ({dist:.2f} combined SE apart, limit 5); "
          f"K1 launches per run: 2 logsumexp (the LML and the resample), 0 logsumexp_ess")
    print(f"[{card}] polyreg IS({cfg.n_particles}) + MALA x{cfg.n_sweeps}: {ms:.3f} ms/run (median of "
          f"{POLYREG_RUNS}: {', '.join(f'{t:.2f}' for t in times)}), {moves / (ms * 1e-3):.4g} rejuvenation moves/s")


def relative_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |got - ref| / max(1, |ref|)."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()


def phase_hmm_scan(gx, ops, card: str) -> None:
    """The HMM as a `scan` program: the unfold at K=1M, exactness against
    the closed form, the CPU and the forward algorithm, K1 on the run's
    weights, and the single-step edit against the dense re-scan."""
    from genjax_tpu_torch import profiling
    from genjax_tpu_torch.distributions.discrete_hmm import forward_filtering_backward_sampling, path_joint_logpdf
    from genjax_tpu_torch.inference.exact_testbed import build_hmm_chain_model
    from genjax_tpu_torch.models.hmm import BenchConfig, exact_log_marginal, run_hmm_importance

    cfg = BenchConfig()
    K, T, init = cfg.n_particles, cfg.T, cfg.initial_state()
    obs = cfg.data("cuda")
    model = build_hmm_chain_model(cfg.hmm(), T, "cuda")
    rng = torch.Generator(device="cuda").manual_seed(6)
    S = gx.Selection.at

    def launches() -> tuple[int, int]:
        return ops.fused_logsumexp.launches, ops.fused_logsumexp_ess.launches

    def unfold():
        """One unfold and its LML; only small values leave, so the 27 GB of
        a run's trace go back to the allocator."""
        before = launches()
        col = run_hmm_importance(rng, model, obs, init, K)
        lml = col.get_log_marginal_likelihood_estimate()
        counts = tuple(a - b for a, b in zip(launches(), before))
        return lml, tuple(col.get_particles().get_choices()["z"].shape), counts

    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, results = timed_runs(unfold, HMM_RUNS)
    peak = torch.cuda.max_memory_allocated() - base_bytes
    for lml, z_shape, counts in results:
        check(math.isfinite(float(lml)), "HMM unfold: LML not finite")
        check(z_shape == (K, T), f"HMM unfold: z is {z_shape}, not {(K, T)}")
        check(counts == (1, 0), f"HMM unfold: {counts} (logsumexp, logsumexp_ess) launches per LML, not (1, 0)")
    syncs = count_syncs(unfold)
    check(syncs == 0, f"the HMM unfold made {syncs} device synchronisations over {T} scan steps")
    ms = statistics.median(times)
    print(f"[{card}] HMM unfold K={K} T={T} ({cfg.n_states} states, every x constrained): {ms:.3f} ms/unfold "
          f"(median of {HMM_RUNS}: {', '.join(f'{t:.2f}' for t in times)}; host clock between syncs), "
          f"{K * T / (ms * 1e-3):.4g} particle-steps/s; z is {results[-1][1]}; "
          f"K1 launches per LML: 1; device synchronisations per scan step: 0 ({syncs} per unfold); "
          f"peak device memory {peak / 2**30:.2f} GiB over {base_bytes / 2**20:.1f} MiB")
    prof = profiling.trace(unfold, T)
    print(f"[{card}] HMM unfold profile: wall {prof['wall_ms']:.3f} ms, device busy {prof['device_busy_ms']:.3f} ms, "
          f"idle {100 * prof['idle_share']:.1f}%, {prof['device_items_per_step']:.1f} device items and "
          f"{prof['launch_calls_per_step']:.1f} launch calls per scan step; largest: "
          + "; ".join(f"{i['name'][:60]} x{i['count']} {i['ms']:.2f} ms" for i in prof["largest"]))

    # K1 on this run's own weights against its plain twin (a comparison,
    # so it leaves the count alone), and the T=50 ESS.
    col = run_hmm_importance(rng, model, obs, init, K)
    lw = col.get_log_weights()
    per_step = col.get_particles().inner.get_score()
    check(per_step.shape == (K, T), f"HMM unfold: per-step scores {tuple(per_step.shape)}, not {(K, T)}")
    check(relative_error(per_step.sum(-1), col.get_particles().get_score()) <= 1e-5, "HMM unfold: the per-step scores do not add up")
    del per_step
    counted = launches()
    got, (got_lse, got_ess) = ops.fused_logsumexp(lw), ops.fused_logsumexp_ess(lw)
    ops.fused_logsumexp.launches, ops.fused_logsumexp_ess.launches = counted
    ok, err = close(got, ops.logsumexp_plain(lw))
    check(ok, f"logsumexp on the HMM log weights (K={K}): {float(got)} vs plain {float(ops.logsumexp_plain(lw))}")
    ok_e, err_e = close(got_lse, ops.logsumexp_ess_plain(lw)[0])
    check(ok_e, "logsumexp_ess on the HMM log weights")
    print(f"logsumexp == plain on the HMM unfold's log weights (K={K}): |err| {err:.3e}, logsumexp_ess {err_e:.3e} "
          f"(tolerance 1e-5 * max(1, |ref|)); ESS at T={T}: {float(got_ess):.1f} of {K} (likelihood weighting "
          f"is degenerate at this length, hence the oracle check at T={HMM_ORACLE_STEPS})")
    del col, lw

    # Exactness: `assess` of exact posterior paths equals the closed form,
    # on the card and on the CPU.
    paths, _ = forward_filtering_backward_sampling(rng, cfg.hmm(), obs, HMM_PATHS)
    sample = gx.ChoiceMap.kw(z=gx.per_particle(paths), x=obs)
    score, _ = model.assess(sample, (init, None), n=HMM_PATHS)
    prior, trans, emit = cfg.hmm().tables("cuda")
    ref = path_joint_logpdf(trans[init], trans, emit, paths, obs)
    err_form = relative_error(score, ref)
    check(score.shape == (HMM_PATHS,) and bool(torch.isfinite(score).all()), "HMM assess: shape or non-finite")
    check(err_form <= 1e-4, f"HMM assess of {HMM_PATHS} FFBS paths vs path_joint_logpdf: relative error {err_form}")
    cpu_model = build_hmm_chain_model(cfg.hmm(), T, "cpu")
    cpu_sample = gx.ChoiceMap.kw(z=gx.per_particle(paths.cpu()), x=obs.cpu())
    cpu_score, _ = cpu_model.assess(cpu_sample, (init, None), n=HMM_PATHS)
    err_cpu = relative_error(score, cpu_score)
    check(err_cpu <= 1e-4, f"HMM assess on the card vs the CPU: relative error {err_cpu}")
    print(f"HMM assess of {HMM_PATHS} FFBS paths (T={T}): relative error {err_form:.3e} against path_joint_logpdf, "
          f"{err_cpu:.3e} against the CPU (limit 1e-4)")

    # Against the oracle: the likelihood-weighting LML at T=8.
    short = build_hmm_chain_model(cfg.hmm(), HMM_ORACLE_STEPS, "cuda")
    obs_short = cfg.data("cuda", HMM_ORACLE_STEPS)
    exact = float(exact_log_marginal(cfg.hmm(), obs_short, init))
    lmls = [float(run_hmm_importance(rng, short, obs_short, init, K).get_log_marginal_likelihood_estimate())
            for _ in range(HMM_ORACLE_RUNS)]
    print(f"HMM T={HMM_ORACLE_STEPS} K={K} " + within_se(lmls, exact, "LML against forward_filter's exact marginal"))

    # The single-step edit against the dense re-scan, same draws.
    chains = run_hmm_importance(rng, model, obs, init, HMM_EDIT_CHAINS).get_particles()
    worst = 0.0
    for t in range(T):
        one, w_one, _, _ = chains.edit(
            torch.Generator(device="cuda").manual_seed(1000 + t), gx.IndexRequest(t, gx.Regenerate(S["z"])))
        dense, w_dense, _, _ = chains.edit(
            torch.Generator(device="cuda").manual_seed(1000 + t), gx.Regenerate(S[t, "z"]))
        check(bool(torch.equal(one.get_choices()["z"], dense.get_choices()["z"])),
              f"IndexRequest({t}) and the dense Regenerate drew different z")
        check(bool(torch.isfinite(w_one).all()), f"IndexRequest({t}) weight not finite")
        worst = max(worst, relative_error(w_one, w_dense), relative_error(one.get_score(), dense.get_score()))
    check(worst <= 1e-4, f"IndexRequest weight vs the dense re-scan's: relative error {worst}")

    def moves(request_at):
        tr = chains
        for t in range(T):
            tr, _ = gx.mh(rng, tr, request_at(t))
        return tr.get_score()

    one_times, _ = timed_runs(lambda: moves(lambda t: gx.IndexRequest(t, gx.Regenerate(S["z"]))), 3)
    dense_times, _ = timed_runs(lambda: moves(lambda t: gx.Regenerate(S[t, "z"])), 3)
    one_ms, dense_ms = statistics.median(one_times) / T, statistics.median(dense_times) / T
    print(f"[{card}] Scan.edit_index at C={HMM_EDIT_CHAINS} T={T}: weight and z equal the dense Regenerate re-scan's "
          f"for the same draws at every t (relative error {worst:.3e}, limit 1e-4); one MH move "
          f"{one_ms:.3f} ms by IndexRequest, {dense_ms:.3f} ms by the dense re-scan ({dense_ms / one_ms:.1f}x; "
          f"median of 3 sweeps over t, host clock between syncs)")


def phase_logreg_vmap(gx, card: str) -> None:
    """Logistic-regression HMC with the likelihood as a `vmap` over the
    data points, against the vector-site model of the MCMC path."""
    from genjax_tpu_torch import profiling
    from genjax_tpu_torch.models.logreg import (
        VMAP_YS, BenchConfig, init_chains, logistic_regression, logistic_regression_vmap, run_hmc_chains,
    )

    cfg = BenchConfig()
    X, ys = cfg.data("cuda")
    rng = torch.Generator(device="cuda").manual_seed(8)
    w = torch.randn(cfg.n_chains, cfg.dim, generator=rng, device="cuda")
    vector, _ = logistic_regression.assess(gx.ChoiceMap.kw(w=gx.per_particle(w), ys=ys), (X,), n=cfg.n_chains)
    lanes, logits = logistic_regression_vmap.assess(
        gx.ChoiceMap.d({"w": gx.per_particle(w), VMAP_YS: ys}), (X,), n=cfg.n_chains)
    err = relative_error(lanes, vector)
    check(lanes.shape == (cfg.n_chains,) and logits.shape == (cfg.n_chains, cfg.n_data), "vmapped logreg: shapes")
    check(err <= 1e-4, f"vmapped logreg assess vs the vector-site model: relative error {err}")

    chains = init_chains(rng, X, ys, cfg.n_chains, logistic_regression_vmap, VMAP_YS)
    per_lane = chains.get_subtrace("data").inner.get_score()
    check(per_lane.shape == (cfg.n_chains, cfg.n_data), f"vmapped logreg: per-lane scores {tuple(per_lane.shape)}")
    request = gx.HMC(gx.Selection.at["w"], cfg.eps, L=cfg.L)
    syncs = count_syncs(lambda: gx.run_chains(rng, chains, request, cfg.n_steps))
    check(syncs == 0, f"run_chains through Vmap made {syncs} device synchronisations over {cfg.n_steps} MH steps")

    models = (("vector", (logistic_regression, "ys")), ("vmap", (logistic_regression_vmap, VMAP_YS)))

    def run(model, ys_address):
        return run_hmc_chains(rng, X, ys, n_chains=cfg.n_chains, n_steps=cfg.n_steps, eps=cfg.eps, L=cfg.L,
                              model=model, ys_address=ys_address)

    # Side by side, in turns, so that the host's drift hits both alike.
    for _, model in models:
        run(*model)
    times = {"vector": [], "vmap": []}
    finals = {}
    for _ in range(VMAP_HMC_RUNS):
        for name, model in models:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            finals[name], accs = run(*model)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
            check(bool(torch.isfinite(finals[name]).all()) and 0.0 < accs.float().mean().item() <= 1.0,
                  f"HMC ({name}): non-finite w or accept rate out of range")
    dist = within_combined_se(finals["vmap"], finals["vector"], "HMC final w, vmapped likelihood against vector site")
    steps = cfg.n_steps * cfg.L
    profs = {name: profiling.trace(lambda m=model: run(*m), steps) for name, model in models}
    ms = {name: statistics.median(t) for name, t in times.items()}
    print(f"vmapped logreg C={cfg.n_chains} N={cfg.n_data} D={cfg.dim}: assess equals the vector-site model's "
          f"(relative error {err:.3e}, limit 1e-4); per-lane scores {tuple(per_lane.shape)}; final w within "
          f"{dist:.2f} combined SE of the vector-site model's (limit 5); {syncs} device synchronisations over "
          f"{cfg.n_steps} MH steps (0 per step)")
    print(f"[{card}] HMC through Vmap C={cfg.n_chains} S={cfg.n_steps} L={cfg.L}: {ms['vmap']:.3f} ms/run against "
          f"{ms['vector']:.3f} for the vector-site model ({ms['vmap'] / ms['vector']:.3f}x; medians of "
          f"{VMAP_HMC_RUNS} alternating runs, host clock between syncs); per leapfrog step "
          f"{profs['vmap']['launch_calls_per_step']:.1f} launch calls and {profs['vmap']['device_items_per_step']:.1f} "
          f"device items against {profs['vector']['launch_calls_per_step']:.1f} and "
          f"{profs['vector']['device_items_per_step']:.1f}; device busy {profs['vmap']['device_busy_ms']:.3f} ms "
          f"against {profs['vector']['device_busy_ms']:.3f}, idle {100 * profs['vmap']['idle_share']:.1f}% against "
          f"{100 * profs['vector']['idle_share']:.1f}%")


def phase_repeat(gx) -> None:
    """`repeat` on the card: its lanes come from a static count, so every
    leaf of its trace lies on the card; a constraint on one lane weighs
    that lane's density, and an `IndexRequest` edit of one lane weighs the
    density ratio (both against the closed-form normal, 1e-5 relative)."""
    import torch.utils._pytree as pytree

    @gx.gen
    def draw(mu, sigma):
        return gx.normal(mu, sigma) @ "x"

    def logpdf(x, mu, sigma):
        return -0.5 * ((x - mu) / sigma) ** 2 - math.log(sigma) - 0.5 * math.log(2.0 * math.pi)

    k, lanes, sigma = 8192, 16, 0.7
    rng = torch.Generator(device="cuda").manual_seed(9)
    mu = torch.randn(k, generator=rng, device="cuda")
    seen, moved = torch.tensor(0.5, device="cuda"), torch.tensor(-0.5, device="cuda")
    tr, w = draw.repeat(n=lanes).generate(rng, gx.ChoiceMap.d({(2, "x"): seen}), (gx.per_particle(mu), sigma), n=k)
    xs = tr.get_choices()["x"]
    new, w_edit, _, _ = tr.edit(rng, gx.IndexRequest(3, gx.Update(gx.ChoiceMap.kw(x=moved))))
    on_card = all(v.is_cuda for t in (tr, new) for v in pytree.tree_leaves(t) if isinstance(v, torch.Tensor))
    check(on_card, "repeat: a leaf of its trace lies on the CPU")
    check(xs.shape == (k, lanes) and tr.inner.get_score().shape == (k, lanes), f"repeat: choices {tuple(xs.shape)}")
    errs = (relative_error(w, logpdf(seen, mu, sigma)),
            relative_error(w_edit, logpdf(moved, mu, sigma) - logpdf(xs[:, 3], mu, sigma)),
            relative_error(new.get_score(), logpdf(new.get_choices()["x"], mu[:, None], sigma).sum(-1)))
    check(max(errs) <= 1e-5, f"repeat: generate weight, IndexRequest weight, edited score off by {errs}")
    print(f"repeat K={k} n={lanes}: every trace leaf on the card; one-lane generate weight, IndexRequest weight and "
          f"edited score within {max(errs):.3e} relative of the closed form (limit 1e-5)")


def normal_pdf(y: float, mu: float, sd: float) -> float:
    return math.exp(-0.5 * ((y - mu) / sd) ** 2) / (sd * math.sqrt(2.0 * math.pi))


def branching_models(gx, device: str):
    """The branching path's models, defined here as the cookbook defines
    its own: the two-component mixture through `mix` with its block move,
    the two-configuration model of the reversible-jump test (its seeded
    data) with both jump directions, and `enumerative_gibbs`'s docstring
    model; with each one's closed form."""
    import types

    import numpy as np

    C, B, S = gx.ChoiceMap, gx.ChoiceMapBuilder, gx.Selection.at
    logits = torch.tensor(MIX_LOGITS, device=device)

    @gx.gen
    def narrow():
        return gx.normal(MIX_MU[0], MIX_SIG[0]) @ "v"

    @gx.gen
    def wide():
        return gx.normal(MIX_MU[1], MIX_SIG[1]) @ "v"

    @gx.gen
    def mixture():
        v = gx.mix(narrow, wide)(logits, (), ()) @ "m"
        return gx.normal(v, MIX_OBS_SD) @ "y"

    prior = [math.exp(a) / sum(math.exp(b) for b in MIX_LOGITS) for a in MIX_LOGITS]
    joint = [p * normal_pdf(MIX_Y, m, math.sqrt(s * s + MIX_OBS_SD**2)) for p, m, s in zip(prior, MIX_MU, MIX_SIG)]

    data = np.random.default_rng(1)
    ys1 = torch.tensor(0.35 + RJ_SIG * data.standard_normal(RJ_N), dtype=torch.float32, device=device)
    ys2 = torch.tensor(-0.35 + RJ_SIG * data.standard_normal(RJ_N), dtype=torch.float32, device=device)
    ones = torch.ones(RJ_N, device=device)

    @gx.gen
    def shared_mean():
        mu = gx.normal(0.0, 1.0) @ "mu"
        return (mu, mu)

    @gx.gen
    def two_means():
        return (gx.normal(0.0, 1.0) @ "mu1", gx.normal(0.0, 1.0) @ "mu2")

    @gx.gen
    def rj_model(ys1, ys2):
        m = gx.flip(0.5) @ "m"
        means = gx.switch(shared_mean, two_means)(m.to(torch.int64), (), ()) @ "k"
        _ = gx.normal(means[0][..., None] * ones, RJ_SIG) @ "y1"
        _ = gx.normal(means[1][..., None] * ones, RJ_SIG) @ "y2"

    @gx.gen
    def aux_up():
        _ = gx.normal(0.0, RJ_TAU) @ "u"

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

    def log_evidence(y, blocks):
        cov = RJ_SIG**2 * np.eye(len(y))
        for b in blocks:
            cov[np.ix_(b, b)] += 1.0
        _, logdet = np.linalg.slogdet(cov)
        return float(-0.5 * y @ np.linalg.solve(cov, y) - 0.5 * (logdet + len(y) * np.log(2 * np.pi)))

    y = torch.cat([ys1, ys2]).double().cpu().numpy()
    e0 = log_evidence(y, [list(range(2 * RJ_N))])
    e1 = log_evidence(y, [list(range(RJ_N)), list(range(RJ_N, 2 * RJ_N))])

    gibbs_prior = torch.log(torch.tensor([0.5, 0.5], device=device))

    @gx.gen
    def indicator():
        z = gx.categorical(gibbs_prior) @ "z"
        _ = gx.normal(torch.where(z == 0, -1.0, 1.0), 1.0) @ "y"

    return types.SimpleNamespace(
        mixture=mixture, block=S["m", "mixture_component"] | S["m", "component_sample", ...],
        mix_lml=math.log(sum(joint)), mix_p1=joint[1] / sum(joint),
        rj_model=rj_model, rj_args=(ys1, ys2), rj_obs=C.kw(y1=ys1, y2=ys2), up=up, down=down,
        is_up=lambda chm: ~chm["m"], rj_within=gx.Regenerate(S["k", ...]), rj_p1=1.0 / (1.0 + math.exp(e0 - e1)),
        indicator=indicator, gibbs_values=torch.arange(2, device=device),
        gibbs_p1=normal_pdf(GIBBS_Y, 1.0, 1.0) / (normal_pdf(GIBBS_Y, -1.0, 1.0) + normal_pdf(GIBBS_Y, 1.0, 1.0)),
    )


def rj_sweeps(gx, m, rng: torch.Generator, trace, sweeps: int):
    """`sweeps` sweeps of one reversible jump and one within-model MH move;
    the final trace and the jumps' accept flags, (sweeps, C)."""
    accepted = []
    for _ in range(sweeps):
        trace, acc = gx.reversible_jump(rng, trace, m.up, m.down, m.is_up)
        trace, _ = gx.mh(rng, trace, m.rj_within)
        accepted.append(acc)
    return trace, torch.stack(accepted)


def gibbs_sweeps(gx, m, rng: torch.Generator, trace, sweeps: int):
    for _ in range(sweeps):
        trace = gx.enumerative_gibbs(rng, trace, "z", m.gibbs_values)
    return trace


def branching_configurations(gx, rng: torch.Generator) -> list:
    """(label, steps, fn) of each configuration of the branching path, for
    `genjax_tpu_torch.profiling`: one mixture SIR trial, and
    `PROFILE_SWEEPS` MH steps, jump sweeps and Gibbs sweeps at C chains."""
    m = branching_models(gx, "cuda")
    alg = gx.ImportanceK(gx.Target(m.mixture, (), gx.ChoiceMap.kw(y=MIX_Y)), k_particles=MIX_PARTICLES)

    def mixture_trial():
        col = alg.run_smc(rng)
        return col.get_log_marginal_likelihood_estimate(), col.sample_particle(rng)

    mix_chains, _ = m.mixture.importance(rng, gx.ChoiceMap.kw(y=MIX_Y), (), n=BRANCH_CHAINS)
    rj_chains, _ = m.rj_model.importance(rng, m.rj_obs, m.rj_args, n=BRANCH_CHAINS)
    gibbs_chains, _ = m.indicator.importance(rng, gx.ChoiceMap.kw(y=GIBBS_Y), (), n=BRANCH_CHAINS)
    block = gx.Regenerate(m.block)
    return [
        (f"mixture SIR through mix K={MIX_PARTICLES}, one trial (importance, LML, one draw)", 1, mixture_trial),
        (f"block-move MH through Switch C={BRANCH_CHAINS}, {PROFILE_SWEEPS} MH steps; steps are MH steps",
         PROFILE_SWEEPS, lambda: gx.run_chains(rng, mix_chains, block, PROFILE_SWEEPS)),
        (f"reversible jump across Switch branches C={BRANCH_CHAINS}, {PROFILE_SWEEPS} sweeps (jump + within-model "
         "MH); steps are sweeps", PROFILE_SWEEPS, lambda: rj_sweeps(gx, m, rng, rj_chains, PROFILE_SWEEPS)),
        (f"enumerative_gibbs C={BRANCH_CHAINS}, {PROFILE_SWEEPS} sweeps over 2 values; steps are sweeps",
         PROFILE_SWEEPS, lambda: gibbs_sweeps(gx, m, rng, gibbs_chains, PROFILE_SWEEPS)),
    ]


def print_profile(card: str, label: str, prof: dict) -> None:
    print(f"[{card}] {label} profile: wall {prof['wall_ms']:.3f} ms, device busy {prof['device_busy_ms']:.3f} ms, "
          f"idle {100 * prof['idle_share']:.1f}%, {prof['device_items_per_step']:.1f} device items and "
          f"{prof['launch_calls_per_step']:.1f} launch calls per step, peak device memory {prof['peak_mib']:.1f} MiB; "
          f"K1: {prof['k1_device_kernels']} device kernels for {prof['k1_launches']} launches; "
          "largest: " + "; ".join(f"{i['name'][:60]} x{i['count']} {i['ms']:.2f} ms" for i in prof["largest"]))


def phase_branching(gx, ops, card: str) -> None:
    """The branching path: P1 mixture SIR at K=1M (K1 twice per trial, held
    against its plain twin on the run's weights), P2 block-move MH, P3
    reversible jump and P4 enumerative Gibbs at C chains, each against its
    closed form, with 0 device synchronisations per step."""
    from genjax_tpu_torch import profiling

    m = branching_models(gx, "cuda")
    rng = torch.Generator(device="cuda").manual_seed(10)
    profiles = dict(zip(("P1", "P2", "P3", "P4"), branching_configurations(gx, rng)))

    # P1: mixture SIR. Every particle draws its own component, so the
    # Switch runs both branches for all K rows and selects.
    alg = gx.ImportanceK(gx.Target(m.mixture, (), gx.ChoiceMap.kw(y=MIX_Y)), k_particles=MIX_PARTICLES)

    def trial():
        col = alg.run_smc(rng)
        before_lml = ops.fused_logsumexp.launches
        lml = col.get_log_marginal_likelihood_estimate()
        before_draw = ops.fused_logsumexp.launches
        draw = col.sample_particle(rng).get_choices()["m", "mixture_component"]
        return col, lml, draw, (before_draw - before_lml, ops.fused_logsumexp.launches - before_draw)

    times, trials = timed_runs(trial, MIX_TRIALS)
    check(all(counts == (1, 1) for *_, counts in trials),
          f"mixture SIR: K1 launches (LML, draw) per trial {[t[-1] for t in trials]}, not (1, 1)")
    lmls, p1s = [], []
    for col, lml, draw, _ in trials:
        c = col.get_particles().get_choices()["m", "mixture_component"]
        check(c.shape == (MIX_PARTICLES,) and c.dtype == torch.int64 and int(draw) in (0, 1),
              f"mixture SIR: components {tuple(c.shape)} {c.dtype}, draw {draw}")
        lmls.append(float(lml))
        p1s.append(float(torch.softmax(col.get_log_weights().double(), 0) @ (c == 1).double()))
    col = trials[-1][0]
    lw = col.get_log_weights()
    counted = ops.fused_logsumexp.launches
    got = ops.fused_logsumexp(lw)
    ops.fused_logsumexp.launches = counted  # a comparison, not a launch of the path
    ok, err = close(got, ops.logsumexp_plain(lw))
    check(ok, f"logsumexp on the mixture SIR log weights: {float(got)} vs plain {float(ops.logsumexp_plain(lw))}")
    del trials, col, lw
    print(f"mixture SIR K={MIX_PARTICLES} " + within_se(lmls, m.mix_lml, "LML") + "; "
          + within_se(p1s, m.mix_p1, "P(c=1 | y) (self-normalized)"))
    print(f"logsumexp == plain on the mixture SIR log weights (K={MIX_PARTICLES}): |err| {err:.3e} (tolerance "
          f"1e-5 * max(1, |ref|)); K1 launches per trial: 1 for the LML, 1 for the draw (each of {MIX_TRIALS} trials)")
    ms = statistics.median(times)
    print(f"[{card}] mixture SIR through mix K={MIX_PARTICLES}: {ms:.3f} ms/trial (median of {MIX_TRIALS}; host "
          f"clock between syncs), {MIX_PARTICLES / (ms * 1e-3):.4g} particles/s")
    print_profile(card, "mixture SIR", profiling.trace(profiles["P1"][2], 1))

    # P2: block-move MH through Switch.
    block = gx.Regenerate(m.block)
    chains, _ = m.mixture.importance(rng, gx.ChoiceMap.kw(y=MIX_Y), (), n=BRANCH_CHAINS)
    new, w, _, _ = block.edit(rng, chains, gx.Diff.no_change(()))
    err_w = relative_error(w, new.get_score() - chains.get_score())
    check(err_w <= 1e-5, f"block Regenerate: weight vs the change of the score, relative error {err_w}")
    syncs = count_syncs(lambda: gx.run_chains(rng, chains, block, BLOCK_MH_STEPS))
    check(syncs == 0, f"block-move MH made {syncs} device synchronisations over {BLOCK_MH_STEPS} MH steps")
    times, results = timed_runs(lambda: gx.run_chains(rng, chains, block, BLOCK_MH_STEPS), BRANCH_RUNS)
    final, accepted = results[-1]
    p1 = (final.get_choices()["m", "mixture_component"] == 1).double().mean().item()
    se = math.sqrt(m.mix_p1 * (1 - m.mix_p1) / BRANCH_CHAINS)
    check(abs(p1 - m.mix_p1) < 5 * se, f"block-move MH P(c=1 | y) {p1} vs {m.mix_p1} (SE {se})")
    ms = statistics.median(times)
    print(f"block-move MH C={BRANCH_CHAINS} S={BLOCK_MH_STEPS}: P(c=1 | y) over the final states {p1:.5f} (exact "
          f"{m.mix_p1:.5f}, {abs(p1 - m.mix_p1) / se:.2f} binomial SE off, limit 5); accept rate "
          f"{accepted.float().mean().item():.4f}; weight equals the change of the score (relative error {err_w:.2e}); "
          f"{syncs} device synchronisations over {BLOCK_MH_STEPS} MH steps (0 per step)")
    print(f"[{card}] block-move MH through Switch C={BRANCH_CHAINS} S={BLOCK_MH_STEPS}: {ms:.3f} ms/run, "
          f"{ms / BLOCK_MH_STEPS:.3f} ms per MH step (median of {BRANCH_RUNS} runs; host clock between syncs)")
    print_profile(card, f"block-move MH ({PROFILE_SWEEPS} steps)", profiling.trace(profiles["P2"][2], PROFILE_SWEEPS))

    # P3: reversible jump across the Switch's branches.
    chains, _ = m.rj_model.importance(rng, m.rj_obs, m.rj_args, n=BRANCH_CHAINS)
    syncs = count_syncs(lambda: rj_sweeps(gx, m, rng, chains, PROFILE_SWEEPS))
    check(syncs == 0, f"reversible jump made {syncs} device synchronisations over {PROFILE_SWEEPS} sweeps")
    times, results = timed_runs(lambda: rj_sweeps(gx, m, rng, chains, RJ_SWEEPS), BRANCH_RUNS)
    final, accepted = results[-1]
    p1 = final.get_choices()["m"].double().mean().item()
    se = math.sqrt(m.rj_p1 * (1 - m.rj_p1) / BRANCH_CHAINS)
    check(abs(p1 - m.rj_p1) < 5 * se, f"reversible jump P(m=1 | y) {p1} vs {m.rj_p1} (SE {se})")
    rate = accepted.float().mean().item()
    check(0.05 < rate < 0.95, f"reversible jump accept rate {rate}")
    ms = statistics.median(times)
    print(f"reversible jump C={BRANCH_CHAINS}, {RJ_SWEEPS} sweeps: P(m=1 | y) over the final states {p1:.5f} (exact "
          f"{m.rj_p1:.5f}, {abs(p1 - m.rj_p1) / se:.2f} binomial SE off, limit 5); jump accept rate {rate:.4f}; "
          f"{syncs} device synchronisations over {PROFILE_SWEEPS} sweeps (0 per step)")
    print(f"[{card}] reversible jump C={BRANCH_CHAINS}: {ms:.3f} ms per {RJ_SWEEPS} sweeps, {ms / RJ_SWEEPS:.3f} ms "
          f"per sweep (median of {BRANCH_RUNS} runs; host clock between syncs)")
    print_profile(card, f"reversible jump ({PROFILE_SWEEPS} sweeps)", profiling.trace(profiles["P3"][2], PROFILE_SWEEPS))

    # P4: enumerative Gibbs, exact in one sweep.
    chains, _ = m.indicator.importance(rng, gx.ChoiceMap.kw(y=GIBBS_Y), (), n=BRANCH_CHAINS)
    syncs = count_syncs(lambda: gibbs_sweeps(gx, m, rng, chains, GIBBS_SWEEPS))
    check(syncs == 0, f"enumerative_gibbs made {syncs} device synchronisations over {GIBBS_SWEEPS} sweeps")
    times, results = timed_runs(lambda: gibbs_sweeps(gx, m, rng, chains, GIBBS_SWEEPS), BRANCH_RUNS)
    z = results[-1].get_choices()["z"]
    p1 = (z == 1).double().mean().item()
    se = math.sqrt(m.gibbs_p1 * (1 - m.gibbs_p1) / BRANCH_CHAINS)
    check(z.shape == (BRANCH_CHAINS,) and abs(p1 - m.gibbs_p1) < 5 * se,
          f"enumerative_gibbs P(z=1 | y) {p1} vs {m.gibbs_p1} (SE {se}), z {tuple(z.shape)}")
    ms = statistics.median(times)
    print(f"enumerative_gibbs C={BRANCH_CHAINS}: P(z=1 | y) {p1:.5f} (exact {m.gibbs_p1:.5f}, "
          f"{abs(p1 - m.gibbs_p1) / se:.2f} binomial SE off, limit 5); {syncs} device synchronisations over "
          f"{GIBBS_SWEEPS} sweeps (0 per step)")
    print(f"[{card}] enumerative_gibbs C={BRANCH_CHAINS}: {ms / GIBBS_SWEEPS:.3f} ms per sweep (median of "
          f"{BRANCH_RUNS} runs of {GIBBS_SWEEPS} sweeps; host clock between syncs)")
    print_profile(card, f"enumerative_gibbs ({PROFILE_SWEEPS} sweeps)", profiling.trace(profiles["P4"][2], PROFILE_SWEEPS))


def counted(ops) -> tuple[int, int]:
    return ops.fused_logsumexp.launches, ops.fused_logsumexp_ess.launches


def k1_against_plain(ops, lw: torch.Tensor) -> tuple[float, float]:
    """Both K1 entry points on `lw` (comparison launches, so the counts are
    put back): each log-sum-exp against the float32 plain twin, and the
    ESS against the twin's formula, `exp(-logsumexp(2 (x - logsumexp(x))))`,
    evaluated in float64 on the same float32 inputs. The float32 twin rounds
    `logsumexp(x)` to float32 before it subtracts it, which at |lse| ~ 200
    (S1's weights at the last steps) moves its ESS by up to 2 |lse| 2^-24 ~
    2.5e-5 relative, more than the kernel's own error. Returns the kernel's
    largest |error| over max(1, |ref|), which `close` holds within 1e-5, and
    the float32 twin's own ESS error on the same scale."""
    before = counted(ops)
    got, (got_lse, got_ess) = ops.fused_logsumexp(lw), ops.fused_logsumexp_ess(lw)
    ops.fused_logsumexp.launches, ops.fused_logsumexp_ess.launches = before
    ref, (ref_lse, twin_ess) = ops.logsumexp_plain(lw), ops.logsumexp_ess_plain(lw)
    x = lw.double()
    ref_ess = torch.exp(-torch.logsumexp(2.0 * (x - torch.logsumexp(x, 0)), 0))
    worst = 0.0
    for what, g, r in (("logsumexp", got, ref), ("logsumexp_ess lse", got_lse, ref_lse), ("logsumexp_ess ess", got_ess, ref_ess)):
        ok, err = close(g, r)
        check(ok, f"{what} on a run's own weights (N={lw.numel()}): {float(g)} vs plain {float(r)}")
        worst = max(worst, err / max(1.0, abs(float(r))))
    return worst, close(twin_ess, ref_ess)[1] / max(1.0, abs(float(ref_ess)))


def within_se_density(values: list[float], exact: float, what: str, n_se: float = 5.0) -> str:
    """An estimator unbiased for exp(exact) (an LML, a log density
    estimate): the mean of exp(value - exact) is 1 within `n_se` SE."""
    ratios = [math.exp(v - exact) for v in values]
    return within_se(ratios, 1.0, f"{what} (exp(estimate - exact))", n_se)


def lg_kalman(a: float, ys):
    """The scalar linear-Gaussian SSM of the PMMH, particle Gibbs and FFBS
    tests (z_0 ~ N(0, 1), z_t = a z_{t-1} + N(0, Q^2), y_t = z_t + N(0,
    R^2)): (log p(y), filtered means and variances, predicted means and
    variances), in float64."""
    mu, p, ll, out = 0.0, 1.0, 0.0, []
    for t, y in enumerate(ys):
        if t:
            mu, p = a * mu, a * a * p + LG_Q**2
        mp, pp = mu, p
        s = p + LG_R**2
        ll += -0.5 * (math.log(2 * math.pi * s) + (y - mu) ** 2 / s)
        k = p / s
        mu, p = mu + k * (y - mu), (1 - k) * p
        out.append((mu, p, mp, pp))
    return (ll, *(list(c) for c in zip(*out)))


def lg_rts(a: float, ys) -> tuple[list, list]:
    """The exact smoothed means and variances."""
    _, mf, pf, mp, pp = lg_kalman(a, ys)
    ms, ps = list(mf), list(pf)
    for t in range(len(ys) - 2, -1, -1):
        c = pf[t] * a / pp[t + 1]
        ms[t] = mf[t] + c * (ms[t + 1] - mp[t + 1])
        ps[t] = pf[t] + c * c * (ps[t + 1] - pp[t + 1])
    return ms, ps


def lg_smoothing_paths(a: float, ys, n: int, seed: int):
    """`n` exact draws from p(z | y): the Kalman filter, then backward
    sampling (numpy, float64)."""
    import numpy as np

    _, mf, pf, _, pp = lg_kalman(a, ys)
    rng = np.random.default_rng(seed)
    out = np.empty((n, len(ys)))
    out[:, -1] = mf[-1] + math.sqrt(pf[-1]) * rng.standard_normal(n)
    for t in range(len(ys) - 2, -1, -1):
        gain = pf[t] * a / pp[t + 1]
        out[:, t] = mf[t] + gain * (out[:, t + 1] - a * mf[t]) + math.sqrt(pf[t] - gain * a * pf[t]) * rng.standard_normal(n)
    return out


def lg_data(T: int, seed: int) -> list[float]:
    import numpy as np

    rng = np.random.default_rng(seed)
    z, ys = rng.standard_normal(), []
    for t in range(T):
        if t:
            z = LG_A * z + LG_Q * rng.standard_normal()
        ys.append(float(z + LG_R * rng.standard_normal()))
    return ys


def lg_models(gx):
    """The PMMH and particle Gibbs tests' models: the parameter `a` is the
    trailing argument."""

    @gx.gen
    def init(a):
        z = gx.normal(0.0, 1.0) @ "z"
        _ = gx.normal(z, LG_R) @ "y"
        return z

    @gx.gen
    def step(z_prev, t, a):
        z = gx.normal(a * z_prev, LG_Q) @ "z"
        _ = gx.normal(z, LG_R) @ "y"
        return z

    return init, step


def batch_means(chain: list[float], batches: int = 10) -> list[float]:
    size = len(chain) // batches
    return [statistics.fmean(chain[i * size : (i + 1) * size]) for i in range(batches)]


def grid_posterior_mean(ys, lo: float = -1.5, hi: float = 2.5, n: int = 801) -> float:
    """E[a | y] under a N(0, 1) prior, by quadrature over the Kalman
    marginal."""
    grid = [lo + (hi - lo) * i / (n - 1) for i in range(n)]
    lp = [lg_kalman(a, ys)[0] - 0.5 * a * a for a in grid]
    top = max(lp)
    w = [math.exp(v - top) for v in lp]
    return sum(a * wi for a, wi in zip(grid, w)) / sum(w)


def phase_smc(gx, ops, card: str, dev: str = "cuda") -> None:
    """The SMC path: S1 BASELINE config 3 (the 64-state HMM's bootstrap
    filter at K=10k, T=50) with each resampler against the forward
    algorithm; S2 the same HMM as the scan program under SMCDriver; S3 the
    dense round of `bench.py:477-531` at K=1M against its closed forms;
    S4 Importance / ImportanceK(q=) / ChangeTarget / CSMC, PMMH, PGAS,
    FFBS and tempered SMC at their JAX tests' configurations against
    closed forms. K1 is held against its plain twin on S1's and S3's own
    weights."""
    from genjax_tpu_torch import profiling
    from genjax_tpu_torch.inference.exact_testbed import build_hmm_chain_model
    from genjax_tpu_torch.models import conjugate, hmm

    cfg = hmm.BenchConfig()
    K, T, init = cfg.smc_particles, cfg.T, cfg.initial_state()
    obs = cfg.data(dev)
    exact = float(hmm.exact_log_marginal(cfg.hmm(), obs, init))
    rng = torch.Generator(device=dev).manual_seed(11)
    profiles = dict(zip(("S1", "S2", "S3"), profiling.smc_configurations(rng, dev)))

    # S1: the filter with each resampler.
    for method in RESAMPLING:
        pf = hmm.hmm_filter(cfg.hmm(), init, K, method, dev)

        def run():
            before = counted(ops)
            lml, z = pf.run(rng, obs)
            return lml, z, tuple(a - b for a, b in zip(counted(ops), before))

        times, results = timed_runs(run, SMC_FILTER_RUNS)
        for lml, z, counts in results:
            check(z.shape == (K,) and z.device.type == torch.device(dev).type,
                  f"S1 {method}: final states {tuple(z.shape)} on {z.device}")
            check(counts == (0, T - 1), f"S1 {method}: {counts} (logsumexp, logsumexp_ess) launches per filter, not (0, {T - 1})")
        syncs = count_syncs(lambda: pf.run(rng, obs))
        check(syncs <= T - 1, f"S1 {method}: {syncs} device synchronisations over {T - 1} steps")
        ms = statistics.median(times)
        print(f"S1 config-3 filter ({method}) K={K} T={T} " + within_se([float(r[0]) for r in results], exact,
              "LML against the forward algorithm"))
        print(f"[{card}] S1 filter ({method}) K={K} T={T}: {ms:.3f} ms/filter (median of {SMC_FILTER_RUNS}; host clock "
              f"between syncs), {K * T / (ms * 1e-3):.4g} particle-steps/s; {syncs / (T - 1):.2f} device "
              f"synchronisations and 1 K1 launch (logsumexp_ess) per step")
    # K1 against its plain twin on the weights it reduces on the path: with
    # the gate held shut, the weights collected after step t are the ones
    # that step's `logsumexp_ess` reduced (collected after a resample that
    # fired, they would be zeros).
    _, _, lws = dataclasses.replace(pf, ess_threshold=0.0).run(rng, obs, collect=lambda z, lw: lw)
    err1, twin1 = (max(e) for e in zip(*(k1_against_plain(ops, lws[t]) for t in range(1, T))))
    print(f"K1 == plain on S1's own weights (the K={K} log weights that each of the {T - 1} steps of a {pf.resampling} "
          f"run with the gate held shut reduced, spread {float((lws[-1].max() - lws[-1].min())):.1f} nats at the last): "
          f"max |err| / max(1, |plain|) {err1:.3e} (tolerance 1e-5; the ESS against the twin's formula in float64, "
          f"from which the float32 twin's own ESS is {twin1:.3e} off)")
    print_profile(card, "S1 filter (systematic)", profiling.trace(profiles["S1"][2], profiles["S1"][1]))

    # S2: the HMM scan program under SMCDriver.
    model = build_hmm_chain_model(cfg.hmm(), T, dev)
    driver = gx.smc.SMCDriver(n_particles=K)

    def drive():
        before = counted(ops)
        col = hmm.run_hmm_smc(rng, model, obs, init, driver, cfg.rejuvenate_every)
        lml = col.get_log_marginal_likelihood_estimate()
        return lml, tuple(a - b for a, b in zip(counted(ops), before))

    # A run takes seconds: the sync count's run is the timed runs' warm-up,
    # and the profile is `profiling.py`'s alone.
    syncs = count_syncs(drive)
    check(syncs <= T - 1, f"S2: {syncs} device synchronisations over {T - 1} steps (the gate's alone would be {T - 1})")
    times, results = timed_runs(drive, SMC_DRIVER_RUNS, warm=False)
    ms = statistics.median(times)
    print(f"S2 HMM scan program under SMCDriver K={K} T={T} " + within_se([float(r[0]) for r in results], exact,
          "LML against the forward algorithm"))
    print(f"[{card}] S2 SMCDriver K={K} T={T}: {ms:.1f} ms/run (median of {SMC_DRIVER_RUNS}: "
          f"{', '.join(f'{t:.0f}' for t in times)}; host clock between syncs), {K * T / (ms * 1e-3):.4g} particle-steps/s; "
          f"{syncs / (T - 1):.2f} device synchronisations per step; K1 launches per run (logsumexp, logsumexp_ess) "
          f"{results[-1][1]}")

    # S3: the dense round at a million particles.
    c = conjugate.BenchConfig()
    rdriver, target = c.driver(), c.target()

    def one_round():
        before = counted(ops)
        out = conjugate.smc_round(rng, rdriver, target)
        return (*out, tuple(a - b for a, b in zip(counted(ops), before)))

    times, rounds = timed_runs(one_round, c.rounds)
    for *_, counts in rounds:
        check(counts == (1, 2), f"S3: {counts} (logsumexp, logsumexp_ess) launches per round, not (1, 2)")
    ess_after = [float(r[3].get_ess()) for r in rounds]
    check(all(abs(e - c.n_particles) <= 1e-3 * c.n_particles for e in ess_after),
          f"S3: the resampled collection's ESS {min(ess_after)}..{max(ess_after)}, not K within 1e-3")
    ess0 = statistics.fmean(float(r[1]) for r in rounds)
    syncs = count_syncs(lambda: conjugate.smc_round(rng, rdriver, target))
    check(syncs <= 1, f"S3: {syncs} device synchronisations per round (the gate's alone would be 1)")
    col = rdriver.init(rng, target)
    err3, twin3 = k1_against_plain(ops, col.get_log_weights())
    del col
    ms = statistics.median(times)
    print(f"S3 dense round K={c.n_particles} " + within_se([float(r[0]) for r in rounds], c.exact_lml(), "LML") + "; "
          + within_se([float(r[2]) for r in rounds], c.posterior_mean(), "posterior mean of x") +
          f"; ESS after the resample {min(ess_after):.1f}..{max(ess_after):.1f} of {c.n_particles}")
    del rounds
    print(f"[{card}] S3 dense SMC round K={c.n_particles}: {ms:.3f} ms/round (median of {c.rounds}; host clock between "
          f"syncs), importance ESS {ess0:.0f}/round = {ess0 / (ms * 1e-3):.4g} ESS/s; K1 launches per round: 1 logsumexp, "
          f"2 logsumexp_ess; {syncs} device synchronisations per round; K1 == plain on the round's weights: |err| / "
          f"max(1, |plain|) {err3:.3e} (tolerance 1e-5; the float32 twin's own ESS {twin3:.3e} off its formula in "
          f"float64)")
    print_profile(card, "S3 dense round", profiling.trace(profiles["S3"][2], 1))

    phase_smc_drivers(gx, card, dev)


def phase_smc_drivers(gx, card: str, dev: str = "cuda") -> None:
    """S4: the other SMC drivers on the card, each at its JAX test's
    configuration, against closed forms within 5 SE."""
    from genjax_tpu_torch.inference.particle_gibbs import csmc_sweep
    from genjax_tpu_torch.inference.pmmh import PMMH
    from genjax_tpu_torch.inference.requests import GaussianDrift
    from genjax_tpu_torch.inference.smc import ChangeTarget, Importance, ImportanceK
    from genjax_tpu_torch.inference.smoothing import ffbs_sample, smoothing_clouds
    from genjax_tpu_torch.inference.tempered import TemperedSMC

    C, S = gx.ChoiceMap, gx.Selection.at
    rng = torch.Generator(device=dev).manual_seed(12)
    t0 = time.perf_counter()

    @gx.gen
    def model(s):
        x = gx.normal(0.0, s) @ "x"
        _ = gx.normal(x, 1.0) @ "y"
        return x

    def normal_lml(prior_sd: float) -> float:
        var = prior_sd**2 + 1.0
        return -0.5 / var - 0.5 * math.log(2 * math.pi * var)

    t1, t2 = gx.Target(model, (1.0,), C.kw(y=1.0)), gx.Target(model, (2.0,), C.kw(y=1.0))

    @gx.marginal()
    @gx.gen
    def q_exact(target):
        _ = gx.normal(0.5, 1.0 / math.sqrt(2.0)) @ "x"

    @gx.marginal()
    @gx.gen
    def q_wide(target):
        _ = gx.normal(0.0, 1.5) @ "x"

    retained = C.kw(x=torch.tensor(0.2, device=dev))
    ws = torch.stack([Importance(t1, q_exact).run_smc(rng).get_log_weights()[0] for _ in range(50)])
    on_device = ws.device.type == torch.device(dev).type
    check(on_device and relative_error(ws, torch.full_like(ws, normal_lml(1.0))) <= 1e-5,
          "Importance(q=exact posterior): every weight is p(y)")
    lines = [
        within_se([float(ImportanceK(t1, q_wide, k_particles=4000).log_marginal_likelihood_estimate(rng)) for _ in range(20)],
                  normal_lml(1.0), "ImportanceK(q=) LML"),
        within_se([float(ChangeTarget(ImportanceK(t1, k_particles=4000), t2).run_smc(rng).get_log_marginal_likelihood_estimate())
                   for _ in range(20)], normal_lml(2.0), "ChangeTarget LML"),
        within_se_density([float(ImportanceK(t1, k_particles=64).estimate_logpdf(rng, retained, t1)) for _ in range(200)],
                          -0.5 * 0.09 / 0.5 - 0.5 * math.log(math.pi), "CSMC estimate_logpdf"),
    ]
    print("S4 " + "; ".join(lines))

    # PMMH (tests/inference/test_pmmh.py): K=512, T=16.
    init, step = lg_models(gx)
    ys = lg_data(16, 0)
    ys_t = torch.tensor(ys, device=dev)
    pf = gx.BootstrapFilter(step, init, 512, obs_addr="y")
    prior = lambda a: gx.normal.logpdf(a, 0.0, 1.0)  # noqa: E731
    _, (thetas, lmls, accepts) = PMMH(pf, log_prior=prior, step_scales=0.25).run(rng, torch.tensor(0.5, device=dev), ys_t, 300)
    check(thetas.device.type == torch.device(dev).type and bool(torch.isfinite(lmls).all()),
          "PMMH: parameters off the device or LML not finite")
    rate = float(accepts.float().mean())
    check(0.05 < rate < 0.95, f"PMMH accept rate {rate}")
    line = within_se(batch_means(thetas[60:].tolist()), grid_posterior_mean(ys), "PMMH posterior mean of a (batch means)")
    print(f"S4 {line}; accept rate {rate:.3f}")

    # PGAS (tests/inference/test_particle_gibbs.py): one sweep from each of
    # 150 exact smoothing paths gives exact smoothing paths.
    ys8 = lg_data(8, 2)
    ms, ps = lg_rts(LG_A, ys8)
    starts = torch.tensor(lg_smoothing_paths(LG_A, ys8, 150, 3), dtype=torch.float32, device=dev)
    pf64 = gx.BootstrapFilter(step, init, 64, obs_addr="y")
    a = torch.tensor(LG_A, device=dev)
    ys8_t = torch.tensor(ys8, device=dev)
    for ancestor_sampling in (True, False):
        out = torch.stack([csmc_sweep(rng, pf64, ys8_t, p, (a,), ancestor_sampling=ancestor_sampling) for p in starts])
        off = max(abs(m - e) / math.sqrt(v / len(starts)) for m, e, v in zip(out.double().mean(0).tolist(), ms, ps))
        check(out.device.type == torch.device(dev).type and off < 5.0,
              f"CSMC (ancestor sampling {ancestor_sampling}): {off:.2f} SE off the RTS means")
        print(f"S4 CSMC sweep (ancestor sampling {ancestor_sampling}) K=64 T=8 from 150 exact smoothing paths: means per "
              f"step within {off:.2f} SE of the RTS smoother's (limit 5)")

    # FFBS (tests/inference/test_smoothing.py): K=1024 clouds, 512 paths,
    # T=20; 16 independent runs, the mean path against the RTS means
    # (the worst of 20 t statistics of 15 degrees of freedom).
    @gx.gen
    def init1():
        z = gx.normal(0.0, 1.0) @ "z"
        _ = gx.normal(z, LG_R) @ "y"
        return z

    @gx.gen
    def step1(z_prev, t):
        z = gx.normal(0.9 * z_prev, LG_Q) @ "z"
        _ = gx.normal(z, LG_R) @ "y"
        return z

    ys20 = lg_data(20, 12)
    ms20, _ = lg_rts(0.9, ys20)
    pf1024 = gx.BootstrapFilter(step1, init1, 1024, obs_addr="y")
    run_means = []
    for _ in range(16):
        _, clouds, lws = smoothing_clouds(pf1024, rng, torch.tensor(ys20, device=dev))
        paths = ffbs_sample(rng, pf1024, clouds, lws, 512, torch.tensor(ys20, device=dev))
        check(paths.shape == (512, 20) and paths.device.type == torch.device(dev).type, f"FFBS paths {tuple(paths.shape)}")
        run_means.append(paths.double().mean(0).tolist())
    worst = 0.0
    for t in range(20):
        col = [r[t] for r in run_means]
        worst = max(worst, abs(statistics.fmean(col) - ms20[t]) / (statistics.stdev(col) / math.sqrt(len(col))))
    check(worst < 5.0, f"FFBS: the smoothed means are {worst:.2f} SE off the RTS means")
    print(f"S4 FFBS K=1024 M=512 T=20, 16 runs: smoothed means within {worst:.2f} SE of the RTS smoother's (limit 5)")

    # Tempered SMC (tests/inference/test_tempered.py) with GaussianDrift and
    # with MALA rejuvenation: K=512, 8 temperatures, 3 moves, 12 runs.
    @gx.gen
    def conj():
        mu = gx.normal(0.0, 1.0) @ "mu"
        _ = gx.normal(mu, 1.0) @ "y"

    target = gx.Target(conj, (), C.kw(y=1.0))
    betas = torch.linspace(0.0, 1.0, 8, device=dev)
    for name, request in (("GaussianDrift", GaussianDrift(S["mu"], 0.6)), ("MALA", gx.MALA(S["mu"], 0.25))):
        smc = TemperedSMC(n_particles=512, betas=betas, request=request, n_moves=3)
        runs = [smc.run(rng, target) for _ in range(12)]
        means = [float(torch.softmax(col.get_log_weights().double(), 0) @ col.get_particles().get_choices()["mu"].double())
                 for col, _ in runs]
        print(f"S4 tempered SMC with {name}: " + within_se(means, 0.5, "posterior mean of mu") + "; "
              + within_se_density([float(z) for _, z in runs], normal_lml(1.0), "log Z"))
    print(f"[{card}] S4 drivers: {time.perf_counter() - t0:.1f} s in all")


def phase_vi(gx, ops, card: str, dev: str = "cuda") -> float:
    """The VI path, BASELINE config 5 at the width of `bench.py::_ravi`:
    V1 150 ELBO steps of `train_guide` from (0, 0) against the posterior
    N(1.6, 0.2); V2 the ELBO gradient at (0, 0), the mean of 256 estimates
    against the closed form (-8, 4); V3 IWELBO values and gradients at
    N=1M, the value against -log Z and the gradient against 0, K1's
    backward held against the plain twin's on the run's own 1M log
    weights; V4 20 guided LML estimates at K=1M against the exact LML; V5
    the nested sampler at its JAX test's size against the exact evidence.
    Returns K1's largest gradient error on the path's own weights."""
    from genjax_tpu_torch import profiling
    from genjax_tpu_torch.adev import expectation
    from genjax_tpu_torch.inference import vi
    from genjax_tpu_torch.inference.nested import NestedSampler
    from genjax_tpu_torch.models import ravi

    t_phase = time.perf_counter()
    cfg = ravi.BenchConfig()
    dev = torch.device(dev)
    rng = torch.Generator(device=dev).manual_seed(13)
    exact = ravi.exact_lml(cfg.obs)
    profiles = dict(zip(("V1", "V2"), profiling.vi_configurations(torch.Generator(device=dev).manual_seed(3), dev)))

    # V1: train the guide.
    before = counted(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = ravi.train_guide(rng, n_steps=cfg.n_train, lr=cfg.lr, obs=cfg.obs, device=dev)
    torch.cuda.synchronize()
    train_ms = 1e3 * (time.perf_counter() - t0)
    launches = counted(ops)[0] - before[0]
    vmu, vls = float(params[0]), float(params[1])
    check(abs(vmu - 1.6) < 0.25, f"V1: the trained guide's mean {vmu}, not within 0.25 of 1.6")
    check(abs(math.exp(vls) - math.sqrt(0.2)) < 0.1, f"V1: the trained guide's scale {math.exp(vls)}, not within 0.1 of sqrt(0.2)")
    check(launches == cfg.n_train, f"V1: {launches} logsumexp launches over {cfg.n_train} ELBO steps, not one per step")
    syncs = count_syncs(lambda: ravi.train_guide(rng, n_steps=SYNC_STEPS, lr=cfg.lr, obs=cfg.obs, device=dev))
    print(f"V1 train_guide: {cfg.n_train} ELBO steps at {cfg.lr} from (0, 0): (vmu, exp(vls)) = ({vmu:.4f}, "
          f"{math.exp(vls):.4f}) against the posterior (1.6, {math.sqrt(0.2):.4f})")
    print(f"[{card}] V1 ELBO training: {train_ms / cfg.n_train:.3f} ms/step ({train_ms:.1f} ms for {cfg.n_train} steps, "
          f"host clock between syncs, first call included); {syncs / SYNC_STEPS:.2f} device synchronisations and "
          f"{launches / cfg.n_train:.0f} K1 launch per step")
    check(syncs == 0, f"V1: {syncs} device synchronisations over {SYNC_STEPS} ELBO steps")
    print_profile(card, "V1 guided LML at K=1M", profiling.trace(profiles["V1"][2], 1))

    # V2: the ELBO gradient at the origin.
    step = vi.ELBO(ravi.guide, lambda a, b: ravi.make_target(a, b, cfg.obs))
    origin = (torch.zeros((), device=dev), torch.zeros((), device=dev))
    times, grads = timed_runs(lambda: torch.stack(step(rng, origin)), ELBO_GRAD_ESTIMATES)
    grads = torch.stack(grads).double().cpu()
    print(f"V2 ELBO gradient at (0, 0), {ELBO_GRAD_ESTIMATES} estimates: "
          + within_se(grads[:, 0].tolist(), -8.0, "d/dvmu") + "; " + within_se(grads[:, 1].tolist(), 4.0, "d/dvls"))
    print(f"[{card}] V2 ELBO gradient: {statistics.median(times):.3f} ms per estimate (median of {ELBO_GRAD_ESTIMATES}, "
          f"host clock between syncs)")

    # V3: IWELBO at N=1M from the origin. The backward's own inputs are
    # recorded (the log weights that K1's forward reduced) and K1's gradient
    # is held against the plain twin's on them.
    @expectation
    def negated_iwelbo(vmu, vls):
        target = ravi.make_target(vmu, vls, cfg.obs)
        return -gx.ImportanceK(target, ravi.guide, k_particles=cfg.iwelbo_particles).estimate_normalizing_constant(rng, target)

    logsumexp_module = sys.modules["genjax_tpu_torch.ops.logsumexp"]
    plain_backward, seen = logsumexp_module.lse_backward, []

    def recording_backward(g, x, lse):
        seen.append(x.detach())
        return plain_backward(g, x, lse)

    def iwelbo():
        before = counted(ops)
        value, g = negated_iwelbo.value_and_grad_estimate(rng, origin)
        return value, torch.stack(g), counted(ops)[0] - before[0]

    logsumexp_module.lse_backward = recording_backward
    try:
        times, runs = timed_runs(iwelbo, IWELBO_ESTIMATES)
    finally:
        logsumexp_module.lse_backward = plain_backward
    check(all(n == 1 for *_, n in runs), f"V3: K1 launches per IWELBO estimate {[n for *_, n in runs]}, not 1")
    check(len(seen) == IWELBO_ESTIMATES + 1 and all(w.numel() == cfg.iwelbo_particles for w in seen),
          f"V3: K1's backward ran {len(seen)} times, not once per estimate at N={cfg.iwelbo_particles}")
    grad_err = max(grad_error(ops, w) for w in seen)
    gvec = torch.stack([g for _, g, _ in runs]).double().cpu()
    entry_grads = vi.IWELBO(ravi.guide, lambda a, b: ravi.make_target(a, b, cfg.obs), cfg.iwelbo_particles)(rng, origin)
    check(all(bool(torch.isfinite(g)) for g in entry_grads), f"V3: vi.IWELBO's gradient {entry_grads}")
    print(f"V3 IWELBO at N={cfg.iwelbo_particles} from (0, 0), {IWELBO_ESTIMATES} estimates: "
          + within_se([float(v) for v, _, _ in runs], -exact, "value (against -log Z)") + "; "
          + within_se(gvec[:, 0].tolist(), 0.0, "d/dvmu") + "; " + within_se(gvec[:, 1].tolist(), 0.0, "d/dvls")
          + f"; K1's backward == torch.logsumexp's on the run's own {len(seen)} weight vectors of 1M: max |err| / "
          f"max(1, |ref|) {grad_err:.3e} (tolerance {GRAD_TOLERANCE:g})")
    syncs = count_syncs(iwelbo)
    print(f"[{card}] V3 IWELBO value and gradient at N={cfg.iwelbo_particles}: {statistics.median(times):.3f} ms per "
          f"estimate (median of {IWELBO_ESTIMATES}, host clock between syncs); 1 K1 launch forward and its backward; "
          f"{syncs} device synchronisations")
    print_profile(card, "V2 IWELBO value and gradient at N=1M", profiling.trace(profiles["V2"][2], 1))

    # V4: guided LML estimates at K=1M.
    def estimate():
        before = counted(ops)
        lml = ravi.nested_smc_lml(rng, params, cfg.k_particles, cfg.obs, dev)
        return lml, counted(ops)[0] - before[0]

    times, results = timed_runs(estimate, cfg.n_estimates)
    check(all(n == 1 for _, n in results), f"V4: K1 launches per estimate {[n for _, n in results]}, not 1")
    lmls = [float(lml) for lml, _ in results]
    mean, se = statistics.fmean(lmls), statistics.stdev(lmls) / math.sqrt(len(lmls))
    check(all(math.isfinite(v) for v in lmls) and abs(mean - exact) < max(5 * se, 2e-3),
          f"V4: mean LML {mean} not within max(5 SE = {5 * se}, 2e-3) of {exact}")
    syncs = count_syncs(estimate)
    ms = statistics.median(times)
    print(f"V4 guided LML at K={cfg.k_particles}, {cfg.n_estimates} estimates: mean {mean:.6f} (exact {exact:.6f}, SE "
          f"{se:.2e}, |mean - exact| {abs(mean - exact):.2e} within max(5 SE, 2e-3))")
    print(f"[{card}] V4 guided LML K={cfg.k_particles}: {ms:.3f} ms per estimate (median of {cfg.n_estimates}, host "
          f"clock between syncs), {cfg.k_particles / (ms * 1e-3):.4g} particles/s; 1 K1 launch and {syncs} device "
          f"synchronisations per estimate")

    # V5: the nested sampler at its JAX test's size.
    @gx.gen
    def conjugate_model():
        x = gx.normal(torch.zeros(len(NESTED_Y), device=dev), 1.0) @ "x"
        _ = gx.normal(x, 0.5) @ "y"

    ys = torch.tensor(NESTED_Y, device=dev)
    ns = NestedSampler(conjugate_model, (), gx.ChoiceMap.kw(y=ys), gx.Selection.at["x"], **NESTED)
    nested_exact = sum(-0.5 * y * y / 1.25 - 0.5 * math.log(2 * math.pi * 1.25) for y in NESTED_Y)
    before = counted(ops)
    (ns_ms,), (out,) = timed_runs(lambda: ns.run(rng), 1, warm=False)
    ns_launches = counted(ops)[0] - before[0]
    lml, acc, rem = float(out["lml"]), float(out["accept_rate"]), float(out["remainder_frac"])
    check(abs(lml - nested_exact) < 0.3, f"V5: nested sampling evidence {lml} not within 0.3 of {nested_exact}")
    check(0.15 < acc < 0.9 and rem < 0.5, f"V5: accept rate {acc}, remainder fraction {rem}")
    steps = NESTED["n_iters"] * NESTED["n_mcmc"]
    print(f"V5 NestedSampler (n_live={NESTED['n_live']}, n_iters={NESTED['n_iters']}, n_mcmc={NESTED['n_mcmc']}): "
          f"evidence {lml:.4f} (exact {nested_exact:.4f}, tolerance 0.3), accept rate {acc:.3f}, remainder {rem:.3f}")
    print(f"[{card}] V5 nested sampling: {ns_ms / 1e3:.2f} s per run ({1e3 * ns_ms / steps:.1f} us per constrained "
          f"walk step, host clock between syncs); {ns_launches} K1 launches per run")
    print(f"[{card}] VI phase: {time.perf_counter() - t_phase:.1f} s in all")
    return grad_err


def phase_library(gx, ops, card: str, dev: str = "cuda") -> None:
    """The library path. D: each of the 48 distributions drawn at a
    million values through `simulate` (`distributions/library_checks.py`:
    moments, a median or a probability within 5 SE of the closed form, the
    support, and the log density of the first 4096 draws against the
    float64 reference), timed, and the three rejection samplers at
    concentrations 0.01, 1 and 100 (every lane accepted; trips and host
    reads counted). G0: the cookbook's Dirichlet mixture (N=300, 100
    sweeps) with the JAX test's five assertions; G1: a million points, 50
    sweeps, the score against a fresh `assess` and each site's against a
    fresh trace's, every sweep's counts adding to N, 0 syncs per sweep,
    time and peak memory. SV0: 20 SV filters at
    the truth (K=1024, T=200) against the CPU plain path, one
    `logsumexp_ess` launch per step, K1 against its plain twin on the
    weights the steps reduce; SV1: 100 PMMH steps; SV2: particle Gibbs at
    its JAX test's size (one `logsumexp` launch per CSMC step)."""
    from genjax_tpu_torch import profiling
    from genjax_tpu_torch.distributions import library as lib
    from genjax_tpu_torch.distributions import library_checks
    from genjax_tpu_torch.inference.particle_gibbs import ParticleGibbs
    from genjax_tpu_torch.models import gmm, stochvol

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    rng = torch.Generator(device=dev).manual_seed(17)
    profiles = dict(zip(("G1", "SV1"), profiling.library_configurations(torch.Generator(device=dev).manual_seed(5), str(dev))))

    # D: every distribution at a million draws.
    t0 = time.perf_counter()
    results = []
    for name, case in library_checks.cases().items():
        dist = getattr(lib, name)
        params = case.params(dev)
        dist.simulate(rng, dist.bind(params, case.kwargs) if case.kwargs else params, n=4_096)  # warm up
        r = library_checks.check(name, case, rng, LIBRARY_DRAWS, LIBRARY_LOGPDF)
        results.append(r)
        print(f"D {name}: {r['ms']:.3f} ms per {LIBRARY_DRAWS} draws; " + ", ".join(
            f"{k} {v:.2f}" if k.endswith("_se") else f"{k} {v:.2e}" for k, v in r.items() if k.endswith(("_se", "_err"))))
    check(len(results) == 48, f"D: {len(results)} distributions checked, not 48")
    slowest = sorted(results, key=lambda r: -r["ms"])[:5]
    print(f"[{card}] D: 48 distributions at {LIBRARY_DRAWS} draws each through simulate (CUDA events, one call each "
          f"after a warm-up): median {statistics.median(r['ms'] for r in results):.3f} ms; slowest " + ", ".join(
              f"{r['name']} {r['ms']:.3f} ms" for r in slowest) + f"; largest logpdf error against float64 "
          f"{max(r.get('logpdf_err', 0.0) for r in results):.2e} (tolerance 1e-5 of max(1, |ref|)); D took "
          f"{time.perf_counter() - t0:.1f} s")
    mu = torch.tensor([0.0, 0.6, 0.8], device=dev)
    samplers = {
        "von_mises": lambda c: lib.von_mises.simulate(rng, (0.0, c), n=LIBRARY_DRAWS),
        "von_mises_fisher": lambda c: lib.von_mises_fisher.simulate(rng, (mu, c), n=LIBRARY_DRAWS),
        "zipf": lambda c: lib.zipf.simulate(rng, (1.0 + c,), n=LIBRARY_DRAWS),  # power 1 + concentration
    }
    for c in REJECTION_CONCENTRATIONS:
        parts = []
        for name, draw in samplers.items():
            syncs = count_syncs(lambda: draw(c))
            stats = lib.rejection_stats[name]
            check(stats["accepted"], f"D {name} at {c}: not every lane accepted in {stats['trips']} trips")
            check(syncs == stats["syncs"], f"D {name} at {c}: {syncs} device synchronisations, {stats['syncs']} host reads")
            parts.append(f"{name} {stats['trips']} trips, {syncs} syncs")
        print(f"D rejection samplers at concentration {c} ({LIBRARY_DRAWS} lanes, all accepted; the host reads "
              f"'all accepted' every {lib.REJECTION_CHECK_EVERY} trips): " + "; ".join(parts))

    # G0: the cookbook's mixture.
    g = gmm.BenchConfig()
    true_means = torch.tensor(g.true_means, device=dev)
    true_probs = torch.tensor(g.true_probs, device=dev)
    true_idx, obs = gmm.simulate_gmm_data(rng, g.small_n, g.true_means, g.true_probs, device=dev)
    trace = gmm.run_gibbs(rng, obs, g.k, g.small_sweeps, device=dev)
    chm = trace.get_choices()
    score, _ = gmm.make_gmm(g.k, g.small_n, device=dev).assess(chm, ())
    check(math.isclose(float(trace.get_score()), float(score), abs_tol=1e-2, rel_tol=1e-5),
          f"G0: the trace's score {float(trace.get_score())} against a fresh assess {float(score)}")
    means = torch.sort(chm["means"]).values
    check(bool(((means - true_means).abs() < 0.3).all()), f"G0: means {means.tolist()}")
    order = torch.argsort(chm["means"])
    check(bool(((chm["probs"][order] - true_probs).abs() < 0.12).all()), f"G0: weights {chm['probs'][order].tolist()}")
    accuracy = float((torch.argsort(order)[chm["idx"]] == true_idx).float().mean())
    check(accuracy > 0.95, f"G0: assignment accuracy {accuracy}")
    check(bool((chm["obs"] == obs).all()), "G0: the observations moved")
    print(f"G0 Dirichlet mixture (cookbook: N={g.small_n}, K={g.k}, {g.small_sweeps} sweeps): means "
          f"{[round(x, 3) for x in means.tolist()]}, weights {[round(x, 3) for x in chm['probs'][order].tolist()]}, "
          f"accuracy {accuracy:.3f}, score == assess; the JAX test's five assertions hold")

    # G1: a million points.
    _, obs1 = gmm.simulate_gmm_data(rng, g.wide_n, g.true_means, g.true_probs, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trace = gmm.init_gibbs(rng, obs1, g.k, device=dev)
    torch.cuda.synchronize()
    init_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    counts = []
    for _ in range(g.wide_sweeps):
        trace, c = gmm.gibbs_sweep(rng, trace, obs1, g.k)
        counts.append(c)
    torch.cuda.synchronize()
    sweep_ms = 1e3 * (time.perf_counter() - t0) / g.wide_sweeps
    peak = torch.cuda.max_memory_allocated() - base
    counts = torch.stack(counts)
    check(bool((counts.sum(-1) == g.wide_n).all()), f"G1: counts add to {counts.sum(-1).tolist()}, not {g.wide_n}")
    wide_model = gmm.make_gmm(g.k, g.wide_n, device=dev)
    score, _ = wide_model.assess(trace.get_choices(), ())
    got = float(trace.get_score())
    check(math.isclose(got, float(score), abs_tol=1e-2, rel_tol=1e-5), f"G1: score {got} against assess {float(score)}")
    # At a million points rtol 1e-5 of the joint is about 12 nats, more than
    # the means' and weights' whole terms: each site's score is also held
    # against the same site of a fresh trace of the same choices (0 on the
    # CPU; 1e-5 for the two small sites, 1e-3 for the two of a million
    # terms), and its gap to the float64 density is printed.
    def normal_lp64(v, mu, sigma):
        return -0.5 * ((v - mu) / sigma) ** 2 - math.log(sigma) - 0.5 * math.log(2.0 * math.pi)

    fresh = wide_model.importance(rng, trace.get_choices(), ())[0]
    chm = trace.get_choices()
    m64, p64 = chm["means"].double(), chm["probs"].double()
    f64 = {"means": normal_lp64(m64, 0.0, 10.0).sum(), "probs": math.lgamma(g.k),  # Dirichlet(1, ..., 1)
           "idx": torch.log(p64)[chm["idx"]].sum(), "obs": normal_lp64(obs1.double(), m64[chm["idx"]], 0.5).sum()}
    gaps = []
    for addr, atol in (("means", 1e-5), ("probs", 1e-5), ("idx", 1e-3), ("obs", 1e-3)):
        site, again = float(trace.subtraces[addr].get_score()), float(fresh.subtraces[addr].get_score())
        check(abs(site - again) <= atol, f"G1: the {addr} site's score {site} against a fresh one {again}")
        gaps.append(f"{addr} {site:.6f} (fresh {abs(site - again):.3g}, float64 {abs(site - float(f64[addr])):.3g})")
    del fresh, chm, m64, p64, f64
    state = [trace]

    def sweeps():
        for _ in range(GMM_SYNC_SWEEPS):
            state[0] = gmm.gibbs_sweep(rng, state[0], obs1, g.k)[0]

    syncs = count_syncs(sweeps)
    check(syncs == 0, f"G1: {syncs} device synchronisations over {GMM_SYNC_SWEEPS} sweeps")
    wide_means = torch.sort(trace.get_choices()["means"]).values.tolist()
    print(f"G1 Dirichlet mixture N={g.wide_n}, K={g.k}, {g.wide_sweeps} sweeps: score {got!r} == assess "
          f"{float(score)!r} (atol 1e-2, rtol 1e-5; gap {abs(got - float(score)):.3g}); site scores against a fresh "
          f"trace's and float64: {'; '.join(gaps)}; every sweep's counts add to N; means {[round(x, 4) for x in wide_means]}")
    print(f"[{card}] G1 Gibbs sweep N={g.wide_n}: {sweep_ms:.3f} ms per sweep (host clock over {g.wide_sweeps} sweeps "
          f"between syncs; the chain's start {init_ms:.1f} ms), {g.wide_n / (sweep_ms * 1e-3):.4g} assignments/s; "
          f"{syncs} device synchronisations over {GMM_SYNC_SWEEPS} sweeps; peak device memory {peak / 2**20:.1f} MiB")
    print_profile(card, "G1 Gibbs sweep at N=1M", profiling.trace(profiles["G1"][2], 1))
    del trace, state, obs1

    # SV0: the filter at the truth against the CPU plain path.
    s = stochvol.BenchConfig()
    K, T = s.n_particles, s.T
    ys, theta = s.data(dev), stochvol.true_theta(dev)
    pf = stochvol.make_sv_filter(K)

    def run():
        before = counted(ops)
        lml, _ = pf.run(rng, ys, (theta,))
        return lml, tuple(a - b for a, b in zip(counted(ops), before))

    times, results = timed_runs(run, s.n_filters)
    for _, launched in results:
        check(launched == (0, T - 1), f"SV0: {launched} (logsumexp, logsumexp_ess) launches per filter, not (0, {T - 1})")
    cpu_rng = torch.Generator().manual_seed(3)
    ys_cpu, theta_cpu = s.data("cpu"), stochvol.true_theta("cpu")
    cpu = [float(pf.run(cpu_rng, ys_cpu, (theta_cpu,))[0]) for _ in range(s.n_filters)]
    card_lmls = [float(lml) for lml, _ in results]
    dist = within_combined_se(torch.tensor(card_lmls)[:, None], torch.tensor(cpu)[:, None], "SV0 LML against the CPU")
    syncs = count_syncs(lambda: pf.run(rng, ys, (theta,)))
    _, _, lws = dataclasses.replace(pf, ess_threshold=0.0).run(rng, ys, (theta,), collect=lambda z, lw: lw)
    err, twin = (max(e) for e in zip(*(k1_against_plain(ops, lws[t]) for t in range(1, T))))
    ms = statistics.median(times)
    print(f"SV0 stochastic volatility at the truth K={K} T={T}, {s.n_filters} filters: mean LML "
          f"{statistics.fmean(card_lmls):.4f} on the card against {statistics.fmean(cpu):.4f} on the CPU plain path "
          f"({dist:.2f} combined SE apart, within 5); K1 == plain on the weights each of the {T - 1} steps reduced: max "
          f"|err| / max(1, |plain|) {err:.3e} (tolerance 1e-5; the float32 twin's own ESS {twin:.3e} off)")
    print(f"[{card}] SV0 filter K={K} T={T}: {ms:.3f} ms/filter (median of {s.n_filters}; host clock between syncs), "
          f"{K * T / (ms * 1e-3):.4g} particle-steps/s; 1 K1 launch (logsumexp_ess) and {syncs / (T - 1):.2f} device "
          f"synchronisations per step")
    print_profile(card, "SV1 filter K=1024 T=200", profiling.trace(profiles["SV1"][2], profiles["SV1"][1]))

    # SV1: PMMH over the parameters.
    before = counted(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, thetas, lmls, accepts = stochvol.run_sv_pmmh(rng, ys, n_particles=K, n_steps=s.pmmh_steps, device=dev)
    torch.cuda.synchronize()
    pmmh_ms = 1e3 * (time.perf_counter() - t0)
    launched = tuple(a - b for a, b in zip(counted(ops), before))
    rate = float(accepts.float().mean())
    check(bool(torch.isfinite(lmls).all()), "SV1: a non-finite LML in the PMMH chain")
    check(0.02 < rate < 0.98, f"SV1: accept rate {rate}")
    check(launched == (0, (s.pmmh_steps + 1) * (T - 1)), f"SV1: K1 launches {launched} over {s.pmmh_steps} steps")
    step_ms = pmmh_ms / (s.pmmh_steps + 1)
    print(f"SV1 PMMH K={K} T={T}, {s.pmmh_steps} steps: accept rate {rate:.3f}, every LML finite; last theta "
          f"phi {math.tanh(float(thetas['phi'][-1])):.3f}, sigma {math.exp(float(thetas['log_sigma'][-1])):.3f}, "
          f"beta {math.exp(float(thetas['log_beta'][-1])):.3f}")
    print(f"[{card}] SV1 PMMH: {step_ms:.2f} ms per PMMH step (one filter each; {pmmh_ms / 1e3:.2f} s for "
          f"{s.pmmh_steps} steps and the start, host clock between syncs), "
          f"{K * T * (s.pmmh_steps + 1) / (pmmh_ms * 1e-3):.4g} particle-steps/s")

    # SV2: particle Gibbs on the same model, at its JAX test's size.
    ys2 = stochvol.simulate_sv_data(2, PG_SV["T"], stochvol.true_theta("cpu"), device="cpu")[1].to(dev)
    pg = ParticleGibbs(stochvol.make_sv_filter(PG_SV["n_particles"]), log_prior=stochvol.sv_log_prior,
                       step_scales=0.08, theta_steps=PG_SV["theta_steps"])
    before = counted(ops)
    t0 = time.perf_counter()
    _, path, (pg_thetas, pg_accepts) = pg.run(rng, stochvol.sv_theta(1.0, -1.0, 0.0, dev), ys2, n_sweeps=PG_SV["n_sweeps"])
    torch.cuda.synchronize()
    pg_ms = 1e3 * (time.perf_counter() - t0) / PG_SV["n_sweeps"]
    launched = tuple(a - b for a, b in zip(counted(ops), before))
    check(path.shape == (PG_SV["T"],) and bool(torch.isfinite(pg_thetas["phi"]).all()), "SV2: particle Gibbs output")
    check(launched[0] > 0, f"SV2: particle Gibbs launched no logsumexp ({launched})")
    print(f"SV2 particle Gibbs on SV (K={PG_SV['n_particles']}, T={PG_SV['T']}, {PG_SV['n_sweeps']} sweeps, "
          f"{PG_SV['theta_steps']} theta steps each): finite, accept rate {float(pg_accepts.float().mean()):.3f}; "
          f"K1 launches (logsumexp, logsumexp_ess) {launched}")
    print(f"[{card}] SV2 particle Gibbs: {pg_ms:.1f} ms per sweep (host clock)")
    print(f"[{card}] library phase: {time.perf_counter() - t_phase:.1f} s in all")


def relative_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max(1, max |ref|), both on the CPU in float64."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def phase_samplers(gx, card: str, dev: str = "cuda") -> None:
    """The adaptive samplers' path. N1: `run_nuts_chains` at C=8192, N=256,
    D=16, eps=0.02, S=10, max_depth 6 (timed, peak memory) and once at
    max_depth 8; the final `w` against the CPU plain path at 1024 chains
    (5 combined SE), 0 syncs over S draws of `run_chains`, each chain's
    accept statistic in [0, 1] and depth at most max_depth. H1:
    `run_eight_schools` (ChEES, 64 chains, 300 warmup and 500 sampling
    steps) against `eight_schools_quadrature` (6 SE + 0.05 with n_eff =
    C S / 20 on mu, tau and every theta) with R-hat < 1.1 on every latent,
    exactly 1 sync per ChEES step in the warmup and in the sampling. H2:
    `sample_posterior` with hmc, mala, nuts and elliptical on the conjugate
    model against its closed form. E1: `run_gp_ess` (2000 steps) against
    `gp_posterior`'s mean and marginal variances within 5 MCSE (the port's
    own ESS); its shrink trips and host reads per step. K1s: Kalman filter,
    smoother and LML and STS lml, decompose, forecast and 40 fitting steps,
    on the card against the CPU. N1 and H1 are profiled."""
    import numpy as np

    from genjax_tpu_torch import profiling
    from genjax_tpu_torch.core.typing import per_particle
    from genjax_tpu_torch.inference import chees, kalman
    from genjax_tpu_torch.inference.diagnostics import effective_sample_size
    from genjax_tpu_torch.inference.requests import elliptical, nuts
    from genjax_tpu_torch.inference.sample import sample_posterior
    from genjax_tpu_torch.models import gp, hierarchical, logreg, sts

    t_phase = time.perf_counter()
    rng = torch.Generator(device=dev).manual_seed(23)
    profiles = dict(zip(("N1", "H1"), profiling.sampler_configurations(torch.Generator(device=dev).manual_seed(6), dev)))

    # N1: logistic-regression NUTS at BASELINE config 4's width.
    cfg = logreg.BenchConfig()
    X, ys = cfg.data(dev)
    X_cpu, ys_cpu = cfg.data("cpu")
    md, md_deep = cfg.nuts_max_depth, cfg.nuts_deep_max_depth

    def nuts_run(depth: int):
        return logreg.run_nuts_chains(rng, X, ys, n_chains=cfg.n_chains, n_steps=cfg.n_steps, eps=cfg.eps, max_depth=depth)

    nuts_run(md)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, results = timed_runs(lambda: nuts_run(md), NUTS_RUNS, warm=False)
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    deep_times, _ = timed_runs(lambda: nuts_run(md_deep), 1, warm=False)
    w, accs = results[-1]
    check(w.shape == (cfg.n_chains, cfg.dim) and accs.shape == (cfg.n_chains, cfg.n_steps), "N1 output shapes")
    check(bool(torch.isfinite(w).all()) and bool(accs.all()), "N1: final w not finite, or a NUTS move not accepted")
    w_cpu, _ = logreg.run_nuts_chains(
        torch.Generator().manual_seed(24), X_cpu, ys_cpu, n_chains=NUTS_CPU_CHAINS, n_steps=cfg.n_steps, eps=cfg.eps,
        max_depth=md,
    )
    dist = within_combined_se(w, w_cpu, "N1 final w, CUDA against the CPU plain path")
    chains = logreg.init_chains(rng, X, ys, cfg.n_chains)
    request = gx.NUTS(gx.Selection.at["w"], cfg.eps, max_depth=md)
    syncs = count_syncs(lambda: gx.run_chains(rng, chains, request, cfg.n_steps))
    check(syncs == 0, f"N1: run_chains made {syncs} device synchronisations over {cfg.n_steps} NUTS draws")
    tr, depths, stats, divergent = chains, [], [], 0
    for _ in range(NUTS_INFO_DRAWS):
        tr, info = nuts.nuts_kernel(rng, tr, gx.Selection.at["w"], cfg.eps, md)
        check(bool(((info.accept_stat >= 0.0) & (info.accept_stat <= 1.0)).all()), "N1: accept_stat outside [0, 1]")
        check(bool(((info.depth >= 0) & (info.depth <= md)).all()), f"N1: a depth outside [0, {md}]")
        depths.append(info.depth.float().mean().item())
        stats.append(info.accept_stat.mean().item())
        divergent += int(info.diverged.sum())
    ms, deep_ms = statistics.median(times), deep_times[0]
    draws = cfg.n_chains * cfg.n_steps
    for depth, t in ((md, ms), (md_deep, deep_ms)):
        print(f"[{card}] N1 NUTS C={cfg.n_chains} N={cfg.n_data} D={cfg.dim} eps={cfg.eps} S={cfg.n_steps} "
              f"max_depth={depth}: {t:.1f} ms/run, {draws / (t * 1e-3):.4g} chain-steps/s, "
              f"{draws * (2**depth - 1) / (t * 1e-3):.4g} gradient evaluations/s ({2**depth - 1} per draw)"
              + (f" (median of {NUTS_RUNS}: {', '.join(f'{x:.1f}' for x in times)})" if depth == md else " (one run)"))
    print(f"N1: final w within {dist:.2f} combined SE of the CPU plain path's ({NUTS_CPU_CHAINS} chains; limit 5); "
          f"{syncs} device synchronisations over {cfg.n_steps} draws (0 per draw); peak device memory "
          f"{peak_mib:.1f} MiB; over {NUTS_INFO_DRAWS} draws: mean accept_stat {statistics.fmean(stats):.4f}, "
          f"mean depth {statistics.fmean(depths):.3f} of {md}, {divergent} divergent chain-draws")
    print_profile(card, "N1 NUTS run", profiling.trace(profiles["N1"][2], profiles["N1"][1]))

    # H1: eight schools under ChEES against the quadrature oracle.
    y, sigma = hierarchical.EIGHT_SCHOOLS_Y.to(dev), hierarchical.EIGHT_SCHOOLS_SIGMA.to(dev)
    oracle = hierarchical.eight_schools_quadrature(hierarchical.EIGHT_SCHOOLS_Y, hierarchical.EIGHT_SCHOOLS_SIGMA)
    n_chains, n_warmup, n_samples = 64, 300, 500
    leap0 = chees.chees_stats["leapfrog_total"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, theta = hierarchical.run_eight_schools(rng, y, sigma)
    torch.cuda.synchronize()
    h1_ms = 1e3 * (time.perf_counter() - t0)
    leapfrogs = chees.chees_stats["leapfrog_total"] - leap0
    check(theta.shape == (n_chains, n_samples, 8) and bool(torch.isfinite(theta).all()), "H1: theta draws")
    mu, tau = out.samples["mu"].double().cpu(), torch.exp(out.samples["log_tau"].double().cpu())
    report = schools_oracle_checks(oracle, mu, tau, theta.double().cpu(), "H1")
    rhat = max(float(v.max()) for v in torch.utils._pytree.tree_leaves(out.rhat))
    check(rhat < 1.1, f"H1: largest R-hat {rhat}")
    traces, _ = hierarchical.eight_schools.importance(
        rng, gx.ChoiceMap.kw(ys=y, log_tau=per_particle(4.0 * torch.rand(n_chains, generator=rng, device=dev) - 2.0)),
        (sigma,), n=n_chains,
    )
    sel = ~gx.ChoiceMap.kw(ys=y).get_selection()
    warm_syncs = count_syncs(lambda: chees.chees_warmup(rng, traces, sel, n_steps=SCHOOLS_SYNC_STEPS))
    run_syncs = count_syncs(lambda: chees.run_chees_chains(rng, traces, sel, out.tuned, SCHOOLS_SYNC_STEPS))
    check(warm_syncs == SCHOOLS_SYNC_STEPS and run_syncs == SCHOOLS_SYNC_STEPS,
          f"H1: {warm_syncs} and {run_syncs} syncs over {SCHOOLS_SYNC_STEPS} ChEES warmup and sampling steps")
    steps = n_warmup + n_samples
    print(f"[{card}] H1 eight schools ChEES, {n_chains} chains, {n_warmup} warmup + {n_samples} sampling steps: "
          f"{h1_ms:.1f} ms in all, {h1_ms / steps:.3f} ms per ChEES step (init and diagnostics included), "
          f"{leapfrogs} leapfrog steps ({leapfrogs / steps:.2f} per ChEES step); adapted eps "
          f"{float(out.tuned.eps):.4f}, T {float(out.tuned.trajectory_length):.4f}, accept rate "
          f"{float(out.tuned.accept_rate):.3f}")
    print(f"H1 against the quadrature oracle (6 SE + 0.05, n_eff = C S / 20): {report}; largest R-hat {rhat:.4f} "
          f"(limit 1.1); "
          f"syncs per ChEES step: {warm_syncs / SCHOOLS_SYNC_STEPS:.0f} in the warmup, "
          f"{run_syncs / SCHOOLS_SYNC_STEPS:.0f} in the sampling (over {SCHOOLS_SYNC_STEPS} steps each)")
    print_profile(card, "H1 ChEES sampling steps", profiling.trace(profiles["H1"][2], profiles["H1"][1]))

    # H2: the other four algorithms on the conjugate model.
    @gx.gen
    def conjugate():
        m = gx.normal(0.0, 1.0) @ "mu"
        _ = gx.normal(m, 1.0) @ "obs"

    kept = SAMPLE_API["n_samples"] - SAMPLE_API["thin_burn"]
    for algorithm in ("hmc", "mala", "nuts", "elliptical"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sample_posterior(rng, conjugate, gx.ChoiceMap.kw(obs=1.0), algorithm=algorithm, **SAMPLE_API)
        torch.cuda.synchronize()
        a_ms = 1e3 * (time.perf_counter() - t0)
        mus = res.samples["mu"].double().cpu()
        check(mus.shape == (SAMPLE_API["n_chains"], kept), f"H2 {algorithm}: samples {tuple(mus.shape)}")
        se = math.sqrt(0.5 / SAMPLE_API["n_chains"])
        ok = (abs(float(mus.mean()) - 0.5) < 6 * se and abs(float(mus.var()) - 0.5) < 0.15
              and float(res.rhat["mu"]) < 1.1 and float(res.ess["mu"]) > 200)
        check(ok, f"H2 {algorithm}: mean {float(mus.mean())}, var {float(mus.var())}, R-hat {float(res.rhat['mu'])}, "
                  f"ESS {float(res.ess['mu'])} against N(0.5, 0.5)")
        print(f"[{card}] H2 sample_posterior({algorithm}) {SAMPLE_API['n_chains']} chains, {SAMPLE_API['n_warmup']} "
              f"warmup + {SAMPLE_API['n_samples']} steps: {a_ms:.1f} ms; mean {float(mus.mean()):.4f} (exact 0.5, "
              f"6 SE {6 * se:.3f}), var {float(mus.var()):.4f} (exact 0.5), R-hat {float(res.rhat['mu']):.4f}, "
              f"ESS {float(res.ess['mu']):.1f}")

    # E1: the latent GP under elliptical slice sampling.
    data = np.random.default_rng(0)
    xs_np = np.linspace(0.0, 3.0, 12).astype(np.float32)
    ys_np = (np.sin(2 * xs_np) + 0.3 * data.standard_normal(12)).astype(np.float32)
    xs, yv = torch.from_numpy(xs_np).to(dev), torch.from_numpy(ys_np).to(dev)
    post_mean, post_cov, _ = gp.gp_posterior(xs, yv, 0.3)
    before = dict(elliptical.elliptical_stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fs = gp.run_gp_ess(rng, xs, yv)
    torch.cuda.synchronize()
    e1_ms = 1e3 * (time.perf_counter() - t0)
    moves = elliptical.elliptical_stats["moves"] - before["moves"]
    trips = elliptical.elliptical_stats["trips"] - before["trips"]
    reads = elliptical.elliptical_stats["syncs"] - before["syncs"]
    s = fs[GP_BURN:].double().cpu()
    mcse_mean = s.std(0) / effective_sample_size(s[None]).sqrt()
    sq = (s - s.mean(0)) ** 2
    mcse_var = sq.std(0) / effective_sample_size(sq[None]).sqrt()
    z_mean = ((s.mean(0) - post_mean.double().cpu()).abs() / mcse_mean).max().item()
    z_var = ((s.var(0) - post_cov.diagonal().double().cpu()).abs() / mcse_var).max().item()
    check(fs.shape == (2000, 12) and z_mean < 5.0 and z_var < 5.0,
          f"E1: the GP posterior mean {z_mean:.2f} and variance {z_var:.2f} MCSE from the closed form (limit 5)")
    short = count_syncs(lambda: gp.run_gp_ess(rng, xs, yv, n_steps=50))
    print(f"[{card}] E1 run_gp_ess (12 points, 2000 steps, one chain): {e1_ms:.1f} ms, {e1_ms / moves:.3f} ms per "
          f"step; the posterior mean within {z_mean:.2f} MCSE and the marginal variances within {z_var:.2f} MCSE of "
          f"the closed form (limit 5, MCSE from the port's ESS after {GP_BURN} burn-in steps); {trips / moves:.3f} "
          f"shrink trips and {reads / moves:.3f} host reads of the loop per step; {short / 50:.2f} device "
          "synchronisations per step in sync debug mode (50 steps)")

    # K1s: Kalman and STS on the card against the CPU.
    gaps = []
    mats = np.random.default_rng(0)
    A = torch.tensor([[0.9, 0.1, 0.0], [0.0, 0.8, 0.2], [0.1, 0.0, 0.7]])
    Lq = 0.3 * torch.from_numpy(mats.standard_normal((3, 3)).astype(np.float32))
    spec = dict(a=A, q=Lq @ Lq.T + 0.05 * torch.eye(3), h=torch.from_numpy(mats.standard_normal((2, 3)).astype(np.float32)),
                r=torch.tensor([[0.3, 0.05], [0.05, 0.2]]), d=3, p=2, mu0=torch.tensor([0.5, -0.5, 0.0]), p0=1.2)
    for build, p in ((dict(a=0.9, q=0.5, h=1.0, r=0.4, d=1), 1), (spec, 2)):
        m_cpu = kalman.LinearGaussianSSM.build(**build, device="cpu")
        m_dev = kalman.LinearGaussianSSM.build(**build)
        check(m_dev.A.is_cuda and m_dev.P0.is_cuda, "K1s: LinearGaussianSSM.build made its matrices off the card")
        obs = torch.from_numpy(np.random.default_rng(1).standard_normal((30, p)).astype(np.float32))
        for got, ref in zip((*m_dev.filter(obs.to(dev)), *m_dev.smooth(obs.to(dev))), (*m_cpu.filter(obs), *m_cpu.smooth(obs))):
            gaps.append(relative_gap(got, ref))
    t = np.arange(40)
    series = torch.from_numpy((0.05 * t + np.sin(np.pi * t / 2) + 0.3 * np.random.default_rng(3).standard_normal(40))
                              .astype(np.float32))
    sts_cpu, sts_dev = (
        sts.StructuralTimeSeries((sts.local_linear_trend(0.1, 0.05, 5.0, device=d), sts.seasonal(4, 0.05, device=d),
                                  sts.ar(0.7, 0.2, device=d)), obs_noise=0.3)
        for d in ("cpu", "cuda")
    )
    check(all(c.A.is_cuda for c in sts_dev.components), "K1s: the STS components were made off the card")
    gaps.append(relative_gap(sts_dev.lml(series.to(dev)), sts_cpu.lml(series)))
    parts_dev, parts_cpu = sts_dev.decompose(series.to(dev)), sts_cpu.decompose(series)
    gaps.extend(relative_gap(parts_dev[k], parts_cpu[k]) for k in parts_cpu)
    gaps.extend(relative_gap(g, r) for g, r in zip(sts_dev.forecast(series.to(dev), 6), sts_cpu.forecast(series, 6)))
    fit_dev, hist_dev = sts_dev.fit(series.to(dev), n_steps=40)
    fit_cpu, hist_cpu = sts_cpu.fit(series, n_steps=40)
    gaps.append(relative_gap(hist_dev, hist_cpu))
    gaps.append(relative_gap(torch.as_tensor(fit_dev.obs_noise), torch.as_tensor(fit_cpu.obs_noise)))
    check(max(gaps) < KALMAN_TOLERANCE, f"K1s: the card and the CPU differ by {max(gaps)} (limit {KALMAN_TOLERANCE})")
    print(f"K1s Kalman (filter, smoother, LML; scalar and 3-state models, T=30) and STS (lml, decompose, forecast, "
          f"40 fitting steps; T=40): card against CPU within {max(gaps):.2e} of the largest |value| "
          f"(limit {KALMAN_TOLERANCE})")
    print(f"[{card}] samplers phase: {time.perf_counter() - t_phase:.1f} s in all")


def algorithm_models(gx, dev: str):
    """The models of `phase_algorithms` (and of `profiling.py`'s
    configurations of the same paths), as their JAX tests define them,
    with the RBPF's constant matrices made on `dev` once."""
    import types

    from genjax_tpu_torch.inference.kalman import LinearGaussianSSM

    m = types.SimpleNamespace()

    @gx.gen
    def scalar():
        mu = gx.normal(0.0, 1.0) @ "mu"
        _ = gx.normal(mu, 1.0) @ "obs"

    @gx.gen
    def abc_model():
        t = gx.normal(0.0, 1.0) @ "theta"
        _ = gx.normal(t, 0.5) @ "y"

    @gx.gen
    def lognormal():
        x = gx.log_normal(0.0, 1.0) @ "x"
        _ = gx.normal(torch.log(x), 1.0) @ "y"

    @gx.gen
    def aux_scale():
        _ = gx.normal(0.0, 0.6) @ "u"

    def scale_move(x_chm, u_chm):
        # (x, u) -> (x e^u, -u): an involution with |det| = e^u
        return (torch.utils._pytree.tree_map(lambda x: x * torch.exp(u_chm["u"]), x_chm),
                torch.utils._pytree.tree_map(lambda u: -u, u_chm))

    @gx.gen
    def bimodal():
        mu = gx.normal(0.0, 2.0) @ "mu"
        _ = gx.normal(mu * mu, 0.3) @ "y"

    @gx.gen
    def z_init():
        return gx.normal(0.0, 1.0) @ "z"

    @gx.gen
    def z_step(z_prev, t):
        return gx.normal(RB_A_Z * z_prev, RB_Q_Z) @ "z"

    base = LinearGaussianSSM.build(a=RB_A_X, q=RB_Q_X, h=1.0, r=RB_R0, d=1, device=dev)

    def lgss_of_z(z):
        """Observation noise scaled by the regime: R(z) = (R0 e^{z/2})^2."""
        r = RB_R0 * torch.exp(0.5 * z)
        return LinearGaussianSSM(base.A, base.Q, base.H, (r * r).reshape(1, 1), base.mu0, base.P0)

    m.scalar, m.abc_model, m.lognormal, m.aux_scale, m.scale_move, m.bimodal = (
        scalar, abc_model, lognormal, aux_scale, scale_move, bimodal)
    m.z_init, m.z_step, m.lgss_of_z, m.linear = z_init, z_step, lgss_of_z, base
    m.lg_init, m.lg_step = lg_models(gx)
    return m


def rbpf_data(T: int, seed: int) -> list[float]:
    """Observations of the switching model, simulated jointly (z and x) in
    numpy float64."""
    import numpy as np

    rng = np.random.default_rng(seed)
    z, x, ys = rng.standard_normal(), rng.standard_normal(), []
    for t in range(T):
        if t:
            z = RB_A_Z * z + RB_Q_Z * rng.standard_normal()
            x = RB_A_X * x + RB_Q_X * rng.standard_normal()
        ys.append(float(x + RB_R0 * math.exp(0.5 * z) * rng.standard_normal()))
    return ys


def scalar_kalman_lml(a: float, q: float, r: float, ys) -> float:
    """log p(y) of x_0 ~ N(0, 1), x_t = a x_{t-1} + N(0, q^2), y_t = x_t +
    N(0, r^2), in float64."""
    mu, p, ll = 0.0, 1.0, 0.0
    for t, y in enumerate(ys):
        if t:
            mu, p = a * mu, a * a * p + q * q
        s = p + r * r
        ll += -0.5 * (math.log(2 * math.pi * s) + (y - mu) ** 2 / s)
        k = p / s
        mu, p = mu + k * (y - mu), (1 - k) * p
    return ll


def smc2_oracle(ys, lo: float = -1.5, hi: float = 1.5, n: int = 301) -> tuple[float, float]:
    """`tests/inference/test_smc2.py::_exact`: the posterior mean of `a`
    and the evidence by quadrature over the Kalman marginal on a grid,
    under a N(0, 1) prior, in float64."""
    grid = [lo + (hi - lo) * i / (n - 1) for i in range(n)]
    lp = [lg_kalman(a, ys)[0] - 0.5 * a * a - 0.5 * math.log(2 * math.pi) for a in grid]
    top = max(lp)
    w = [math.exp(v - top) for v in lp]
    return (sum(a * wi for a, wi in zip(grid, w)) / sum(w),
            top + math.log(sum(w)) + math.log((hi - lo) / (n - 1)))


def recording(module, name: str, seen: list):
    """Wrap `module.name` (a K1 entry point as a module imported it) so
    every input it reduces is kept in `seen`; returns the original."""
    original = getattr(module, name)

    def wrapped(x):
        seen.append(x)
        return original(x)

    setattr(module, name, wrapped)
    return original


def svgd_flops(n: int, d: int, n_data: int, problems: int = 1) -> int:
    """`bench.py:791-795`'s matmul operations per SVGD step: the distance
    product, the fused `[grads | x | 1]` contraction and about three passes
    of the density gradient's `(N, D) x (D, N_data)` product per problem."""
    cd = problems * d
    return 2 * n * n * cd + 2 * n * n * (2 * cd + 1) + problems * 3 * 2 * n * d * n_data


def svgd_logreg(gx, rng: torch.Generator, problems: list, kernel_dtype, n_particles: int, n_steps: int,
                step_size: float):
    """SVGD on logistic regression: `svgd` for one problem `(X, ys)`,
    `packed_svgd` for several. Returns (the traces, one batch per problem;
    the per-step mean |phi|)."""
    from genjax_tpu_torch.inference import svgd as sv
    from genjax_tpu_torch.models.logreg import logistic_regression

    kw = dict(n_particles=n_particles, n_steps=n_steps, step_size=step_size, kernel_dtype=kernel_dtype)
    if len(problems) == 1:
        (X, ys), = problems
        traces, phi = sv.svgd(rng, logistic_regression, (X,), gx.ChoiceMap.kw(ys=ys), gx.Selection.at["w"], **kw)
        return [traces], phi
    return sv.packed_svgd(rng, logistic_regression, [(X,) for X, _ in problems],
                          [gx.ChoiceMap.kw(ys=ys) for _, ys in problems], gx.Selection.at["w"], **kw)


def svgd_cpu_reference(problems: list, kind: str, n_particles: int, n_steps: int, step_size: float, seed: int):
    """An SVGD configuration (`svgd_logreg`; `problems` as numpy arrays) on
    the CPU plain path, for a worker process: each problem's final
    particles `w`, as numpy arrays. The worker takes six of the host's
    threads while the parent drives the card."""
    import genjax_tpu_torch as gx

    torch.set_num_threads(6)
    traces, _ = svgd_logreg(gx, torch.Generator().manual_seed(seed),
                            [(torch.from_numpy(X), torch.from_numpy(ys)) for X, ys in problems],
                            torch.bfloat16 if kind == "bf16" else None, n_particles, n_steps, step_size)
    return [tr.get_choices()["w"].numpy() for tr in traces]


def phase_algorithms(gx, ops, card: str, dev: str = "cuda") -> None:
    """The last six inference algorithms on the card (see the constants
    above). Every check raises; nothing is caught."""
    import numpy as np

    from genjax_tpu_torch import profiling
    from genjax_tpu_torch.inference import rbpf as rbpf_module
    from genjax_tpu_torch.inference import smc2 as smc2_module
    from genjax_tpu_torch.inference import svgd as sv
    from genjax_tpu_torch.inference.abc import ABCSMC, abc_rejection
    from genjax_tpu_torch.inference.involutive import involutive_mh, involutive_step
    from genjax_tpu_torch.inference.parallel_tempering import ParallelTempering
    from genjax_tpu_torch.inference.rbpf import RaoBlackwellFilter
    from genjax_tpu_torch.inference.requests import GaussianDrift
    from genjax_tpu_torch.inference.smc2 import SMC2
    from genjax_tpu_torch.models.logreg import logistic_regression, simulate_logreg_data

    import multiprocessing

    t_phase = time.perf_counter()
    sections = {}
    m = algorithm_models(gx, dev)
    rng = torch.Generator(device=dev).manual_seed(31)
    profiles = {label.split()[0]: (label, steps, fn) for label, steps, fn in
                profiling.algorithm_configurations(torch.Generator(device=dev).manual_seed(8), dev)}
    print(f"TF32 for f32 matmuls: {torch.backends.cuda.matmul.allow_tf32} (float32 matmul precision "
          f"{torch.get_float32_matmul_precision()}); bf16 contractions: torch.mm(..., out_dtype=torch.float32)")
    check(not torch.backends.cuda.matmul.allow_tf32, "f32 matmuls would run in TF32")

    # SV1-SV4: SVGD on logistic regression.
    c = SVGD_CFG
    n, sel = c["n_particles"], gx.Selection.at["w"]
    data = {d: simulate_logreg_data(torch.Generator(device=dev).manual_seed(s), c["n_data"], d)[:2]
            for d, s in ((c["dim"], 5), (c["wide_dim"], 7))}
    packed = [simulate_logreg_data(torch.Generator(device=dev).manual_seed(100 + i), c["n_data"], c["dim"])[:2]
              for i in range(c["packed_problems"])]
    # (problems, kind, steps): each run's configuration.
    runs = {
        "SV1": ([data[c["dim"]]], "f32", c["n_steps"]),
        "SV2": ([data[c["dim"]]], "bf16", c["n_steps"]),
        "SV3": ([data[c["wide_dim"]]], "bf16", c["wide_steps"]),
        "SV4": (packed, "bf16", c["packed_steps"]),
    }
    # SV1's, SV3's and SV4's configurations at the CPU's width run on the
    # CPU plain path in a worker process meanwhile (they take longer than
    # all the card's runs).
    held = ("SV1", "SV3", "SV4")
    worker = multiprocessing.get_context("spawn").Pool(1)
    cpu_references = {label: worker.apply_async(svgd_cpu_reference, (
        [(X.cpu().numpy(), ys.cpu().numpy()) for X, ys in runs[label][0]], runs[label][1], c["cpu_particles"],
        runs[label][2], c["step_size"], 32)) for label in held}

    def svgd_run(label: str, g: torch.Generator, steps: int, particles: int = n):
        problems, kind, _ = runs[label]
        return svgd_logreg(gx, g, problems, torch.bfloat16 if kind == "bf16" else None, particles, steps,
                           c["step_size"])

    results = {}
    for label, (problems, kind, steps) in runs.items():
        d = problems[0][0].shape[1]
        svgd_run(label, rng, 2)  # warm up
        syncs = count_syncs(lambda: svgd_run(label, rng, c["sync_steps"]))
        check(syncs == 0, f"{label}: {syncs} device synchronisations over a {c['sync_steps']}-step run")
        # SV1 and SV2 start from the same particles (one seed), so their
        # final means differ by the bf16 path's rounding alone.
        g = torch.Generator(device=dev).manual_seed(SVGD_SEEDS[label])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        traces, phi = svgd_run(label, g, steps)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        per_step = ms / steps
        tflops = svgd_flops(n, d, c["n_data"], len(problems)) / (per_step * 1e-3) / 1e12
        traffic_ms = 1e3 * n * n * 4 * (2 if kind == "bf16" else 4) / HBM_BYTES_PER_S
        check(bool(torch.isfinite(phi).all()), f"{label}: a non-finite Stein direction")
        for tr, (X, _) in zip(traces, problems):
            score, _ = logistic_regression.assess(tr.get_choices(), (X,), n)
            gap = relative_gap(tr.get_score(), score)
            check(gap < 1e-5, f"{label}: the traces' scores differ from a fresh assess by {gap}")
        results[label] = [tr.get_choices()["w"] for tr in traces]
        many = len(problems) > 1
        print(f"[{card}] {label} SVGD logreg N={c['n_data']} D={d}{f' x {len(problems)} problems' if many else ''} "
              f"{kind}, {n} particles x {steps} steps: {ms:.1f} ms, {per_step:.3f} ms/step, "
              f"{len(problems) * n / (per_step * 1e-3):.4g} {'problem-' if many else ''}particle-updates/s; "
              f"{tflops:.3f} TFLOP/s by bench.py's count ({100 * tflops * 1e12 / SVGD_PEAK_OPS[kind]:.3f}% of "
              f"{SVGD_PEAK_OPS[kind] / 1e12:.0f}); unfused traffic bound {traffic_ms:.4f} ms/step; peak device "
              f"memory {peak:.1f} MiB; 0 syncs over {c['sync_steps']} steps; scores equal a fresh assess")
    # SV2 (bf16) against SV1 (f32) from the same particles: the largest
    # per-dimension gap of the final means, in SV1's standard errors of
    # the mean (particles taken as independent draws).
    w1, w2 = results["SV1"][0].double(), results["SV2"][0].double()
    bf16_gap = float(((w2.mean(0) - w1.mean(0)).abs() / (w1.var(0) / n).sqrt()).max())
    check(bf16_gap < SVGD_BF16_MEAN_TOLERANCE, f"SV2's final means are {bf16_gap:.3f} of SV1's standard errors from "
          f"SV1's (limit {SVGD_BF16_MEAN_TOLERANCE})")
    print(f"SV2 (bf16) against SV1 (f32) from the same starting particles: final per-dimension means within "
          f"{bf16_gap:.4f} of SV1's standard errors (limit {SVGD_BF16_MEAN_TOLERANCE}); largest gap "
          f"{float((w2.mean(0) - w1.mean(0)).abs().max()):.2e}")

    # The Stein direction (K3) on one step's x, g and h against float64 on
    # the CPU, and its device time beside its bounds.
    X, ys = data[c["dim"]]
    traces, x0, unravel = sv._prepare_particles(rng, logistic_regression, (X,), gx.ChoiceMap.kw(ys=ys), sel, n)
    g0 = sv._grad_batch(sel, traces, (X,), unravel)(x0)
    _, h0 = sv.stein_direction(x0, g0)
    ref = sv.stein_phi_block(*(v.double().cpu() for v in (x0, x0, g0, h0)), n)
    scale = float(ref.abs().max())
    stein_err = {}
    for kind, kd in (("f32", None), ("bf16", torch.bfloat16)):
        got = sv.stein_phi_block(x0, x0, g0, h0, n, kd)
        stein_err[kind] = float((got.double().cpu() - ref).abs().max()) / scale
    check(stein_err["f32"] < STEIN_F32_TOLERANCE and stein_err["bf16"] < STEIN_BF16_TOLERANCE,
          f"the Stein direction on the card against float64: {stein_err} of max |phi| (limits "
          f"{STEIN_F32_TOLERANCE}, {STEIN_BF16_TOLERANCE})")
    # The bf16 contractions' product: bf16 operands, an f32 result, equal to
    # the f32 product of the same rounded operands up to summation order.
    xb = x0.to(torch.bfloat16)
    prod = torch.mm(xb, xb.T, out_dtype=torch.float32)
    widened = xb.float() @ xb.float().T
    mm_gap = float((prod - widened).abs().max()) / float(widened.abs().max())
    check(prod.dtype == torch.float32 and mm_gap < 1e-5,
          f"torch.mm(bf16, bf16, out_dtype=float32) gives {prod.dtype}, {mm_gap:.2e} of max from the widened product")
    print(f"torch.mm(bf16, bf16, out_dtype=torch.float32) at ({n}, {c['dim']}) x ({c['dim']}, {n}): an f32 result "
          f"within {mm_gap:.2e} of max |product| of the widened operands' f32 product (limit 1e-5)")
    # The scalar conjugate model at N=4096 against its closed form.
    conj, phi = sv.svgd(rng, m.scalar, (), gx.ChoiceMap.kw(obs=2.0), gx.Selection.at["mu"], n_particles=n,
                        n_steps=c["conjugate_steps"], step_size=0.3)
    mus = conj.get_choices()["mu"].double()
    check(abs(float(mus.mean()) - 1.0) < 0.05 and abs(float(mus.std(correction=0)) - 0.5**0.5) < 0.08
          and float(phi[-1]) < 1e-3,
          f"SVGD conjugate: mean {float(mus.mean())}, std {float(mus.std(correction=0))}, |phi| {float(phi[-1])}")
    print(f"SVGD conjugate at N={n}, {c['conjugate_steps']} steps: mean {float(mus.mean()):.4f} (exact 1, bound "
          f"0.05), std {float(mus.std(correction=0)):.4f} (exact {0.5**0.5:.4f}, bound 0.08), last mean |phi| "
          f"{float(phi[-1]):.2e}")
    # SV1's, SV3's and SV4's configurations at the CPU's width on both:
    # after their steps the runs are still converging, at a pace that
    # depends on N (the median bandwidth scales with 1 / log(N + 1)), so
    # the card is held against the CPU at one N, every problem's final
    # per-dimension particle mean within 5 combined SE (particles taken as
    # independent draws); SV1's own means are reported beside them.
    card_small = {label: svgd_run(label, rng, runs[label][2], c["cpu_particles"])[0] for label in held}
    try:
        t0 = time.perf_counter()
        cpu_w = {label: [torch.from_numpy(w) for w in r.get(timeout=900)] for label, r in cpu_references.items()}
        waited = time.perf_counter() - t0
    finally:
        worker.close()
        worker.join()
    for label in held:
        dists = [within_combined_se(tr.get_choices()["w"], w, f"{label}'s configuration at N={c['cpu_particles']}"
                                    f", problem {i}: the card against the CPU plain path")
                 for i, (tr, w) in enumerate(zip(card_small[label], cpu_w[label]))]
        print(f"{label}'s configuration ({runs[label][1]}, {len(runs[label][0])} problem(s), {runs[label][2]} "
              f"steps) at N={c['cpu_particles']}: the card's final per-dimension particle means within "
              f"{max(dists):.2f} combined SE of the CPU plain path's (limit 5)")
    sv1_gap = float((results["SV1"][0].double().cpu().mean(0) - cpu_w["SV1"][0].double().mean(0)).abs().max())
    print(f"SV1 (N={n}) differs from the CPU's N={c['cpu_particles']} means by up to {sv1_gap:.4f} (not held: a "
          f"different N); the CPU worker was waited for {waited:.1f} s")
    # K3's device time, beside its bounds (the CPU worker done, so the host
    # enqueues at its own pace).
    for kind, kd in (("f32", None), ("bf16", torch.bfloat16)):
        fn = lambda v, kd=kd: sv.stein_direction(v, g0, None, kd)  # noqa: E731
        for _ in range(3):
            fn(x0)
        device_ms, host_us = profiling.device_and_host(fn, x0, K3_CALLS)
        ops_ms = 1e3 * svgd_flops(n, c["dim"], 0) / SVGD_PEAK_OPS[kind]
        traffic_ms = 1e3 * n * n * 4 * (2 if kind == "bf16" else 4) / HBM_BYTES_PER_S
        print(f"[{card}] K3 stein_direction N={n} D={c['dim']} {kind}: device {device_ms:.4f} ms per call ({K3_CALLS} "
              f"calls behind a sleep kernel), host {host_us:.1f} us; bounds {ops_ms:.4f} ms (operations) and "
              f"{traffic_ms:.4f} ms (unfused traffic); against float64 on the CPU: {stein_err[kind]:.2e} of max |phi|")
    sections["SVGD"] = time.perf_counter() - t_phase

    # M1: SMC² on the AR(1) against the Kalman-grid oracle.
    s = SMC2_CFG
    ys_list = lg_data(s["T"], s["seed"])
    exact_mean, exact_lml = smc2_oracle(ys_list)

    def smc2(n_theta: int, n_x: int):
        return SMC2(m.lg_step, m.lg_init,
                    prior_sample=lambda g, k: torch.randn(k, generator=g, device=g.device),
                    log_prior=lambda a: gx.normal.logpdf(a, 0.0, 1.0), n_theta=n_theta, n_x=n_x, step_scales=0.25)

    def smc2_summary(out) -> tuple[float, float]:
        w = torch.softmax(out["log_weights"].double(), 0)
        return float((w * out["thetas"].double()).sum()), float(out["lml"])

    ys_dev = torch.tensor(ys_list, device=dev)
    alg = smc2(s["n_theta"], s["n_x"])
    alg.run(rng, ys_dev)  # warm up
    seen = []
    original = recording(smc2_module, "logsumexp_ess", seen)
    try:
        before = counted(ops)
        syncs = count_syncs(lambda: alg.run(rng, ys_dev))
        lse_n, ess_n = (a - b for a, b in zip(counted(ops), before))
    finally:
        smc2_module.logsumexp_ess = original
    k1_err = max(k1_against_plain(ops, seen[-1])[0], k1_against_plain(ops, seen[len(seen) // 2])[0])
    check(syncs == s["T"] - 1 and ess_n == s["T"] - 1 and lse_n == 1,
          f"M1: {syncs} syncs, {ess_n} logsumexp_ess and {lse_n} logsumexp launches over T={s['T']} "
          f"(want {s['T'] - 1}, {s['T'] - 1}, 1)")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, outs = timed_runs(lambda: alg.run(rng, ys_dev), 3, warm=False)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    for out in outs:
        mean, lml = smc2_summary(out)
        check(abs(mean - exact_mean) < 0.06 and abs(lml - exact_lml) < 0.6 and out["n_rejuvenations"] >= 1
              and 0.1 < float(out["accept_rate"]) <= 1.0,
              f"M1: theta mean {mean} (exact {exact_mean}), LML {lml} (exact {exact_lml}), "
              f"{out['n_rejuvenations']} rejuvenations, accept rate {float(out['accept_rate'])}")
    small = [smc2_summary(smc2(s["small"], s["small"]).run(g, torch.tensor(ys_list, device=d)))
             for d, g in ((dev, rng), ("cpu", torch.Generator().manual_seed(33)))]
    for (mean, lml), where in zip(small, ("card", "CPU")):
        check(abs(mean - exact_mean) < 0.06 and abs(lml - exact_lml) < 0.6,
              f"M1 {s['small']}x{s['small']} on the {where}: theta mean {mean}, LML {lml}")
    check(abs(small[0][0] - small[1][0]) < 0.12 and abs(small[0][1] - small[1][1]) < 1.2,
          f"M1 {s['small']}x{s['small']}: the card {small[0]} against the CPU {small[1]}")
    ms = statistics.median(times)
    mean, lml = smc2_summary(outs[-1])
    print(f"[{card}] M1 SMC2 {s['n_theta']} x {s['n_x']} (T={s['T']}): {ms:.1f} ms per run (median of 3: "
          f"{', '.join(f'{t:.1f}' for t in times)}), {s['n_theta'] * s['n_x'] * (s['T'] - 1) / (ms * 1e-3):.4g} state "
          f"particle-steps/s (the main filter's steps), {outs[-1]['n_rejuvenations']} rejuvenations, accept rate "
          f"{float(outs[-1]['accept_rate']):.3f}; peak device memory {peak:.1f} MiB")
    print(f"M1 against the Kalman-grid oracle: theta mean {mean:.4f} (exact {exact_mean:.4f}, bound 0.06), LML "
          f"{lml:.4f} (exact {exact_lml:.4f}, bound 0.6); {s['small']}x{s['small']}: card {small[0][0]:.4f}, "
          f"{small[0][1]:.4f}, CPU {small[1][0]:.4f}, {small[1][1]:.4f}; {syncs} syncs, {ess_n} logsumexp_ess and "
          f"{lse_n} logsumexp launches per run (T={s['T']}); K1 against its plain twin on the run's theta weights "
          f"within {k1_err:.2e} of max(1, |ref|)")
    print_profile(card, "M1 SMC2 time step", profiling.trace(profiles["M1"][2], profiles["M1"][1]))
    print_profile(card, "M1 SMC2 rejuvenation", profiling.trace(profiles["M1r"][2], profiles["M1r"][1]))

    sections["M1"] = time.perf_counter() - t_phase - sum(sections.values())
    # R1: the RBPF at K=1M.
    r = RBPF_CFG
    ys_rb = rbpf_data(r["T"], r["data_seed"])
    ys_dev = torch.tensor(ys_rb, device=dev)[:, None]
    linear = RaoBlackwellFilter(m.z_step, m.z_init, lambda z: m.linear, r["n_particles"])
    lml_lin, _ = linear.run(rng, ys_dev)
    exact_lin = scalar_kalman_lml(RB_A_X, RB_Q_X, RB_R0, ys_rb)
    check(abs(float(lml_lin) - exact_lin) < 1e-5 * max(1.0, abs(exact_lin)),
          f"R1 fully linear: LML {float(lml_lin)} against the Kalman LML {exact_lin}")
    rb = RaoBlackwellFilter(m.z_step, m.z_init, m.lgss_of_z, r["n_particles"])
    rb.run(rng, ys_dev)  # warm up
    seen = []
    original = recording(rbpf_module, "logsumexp_ess", seen)
    try:
        before = counted(ops)
        syncs = count_syncs(lambda: rb.run(rng, ys_dev))
        lse_n, ess_n = (a - b for a, b in zip(counted(ops), before))
    finally:
        rbpf_module.logsumexp_ess = original
    k1_err = max(k1_against_plain(ops, seen[-1])[0], k1_against_plain(ops, seen[len(seen) // 2])[0])
    check(syncs == r["T"] - 1 and ess_n == r["T"] - 1 and lse_n == 1,
          f"R1: {syncs} syncs, {ess_n} logsumexp_ess and {lse_n} logsumexp launches over T={r['T']}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, outs = timed_runs(lambda: rb.run(rng, ys_dev)[0], r["runs"], warm=False)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    m_cpu = algorithm_models(gx, "cpu")
    rb_cpu = RaoBlackwellFilter(m_cpu.z_step, m_cpu.z_init, m_cpu.lgss_of_z, r["cpu_particles"])
    g_cpu = torch.Generator().manual_seed(34)
    ys_cpu = torch.tensor(ys_rb)[:, None]
    cpu_lmls = torch.stack([rb_cpu.run(g_cpu, ys_cpu)[0] for _ in range(r["runs"])])
    dist = within_combined_se(torch.stack(outs)[:, None], cpu_lmls[:, None], "R1 LML, the card against the CPU")
    ms = statistics.median(times)
    print(f"[{card}] R1 RBPF K={r['n_particles']} T={r['T']}: {ms:.1f} ms per filter (median of {r['runs']}), "
          f"{r['n_particles'] * r['T'] / (ms * 1e-3):.4g} particle-steps/s; peak device memory {peak:.1f} MiB")
    print(f"R1: mean LML {float(torch.stack(outs).mean()):.4f} over {r['runs']} runs, within {dist:.2f} combined SE "
          f"of the CPU plain path's {float(cpu_lmls.mean()):.4f} (K={r['cpu_particles']}); fully linear case "
          f"{float(lml_lin):.6f} against the Kalman LML {exact_lin:.6f}; {syncs} syncs, {ess_n} logsumexp_ess and "
          f"{lse_n} logsumexp launches per filter; K1 against its plain twin on the filter's own weights within "
          f"{k1_err:.2e} of max(1, |ref|)")
    print_profile(card, "R1 RBPF step", profiling.trace(profiles["R1"][2], profiles["R1"][1]))

    sections["R1"] = time.perf_counter() - t_phase - sum(sections.values())
    # A1: ABC-SMC at 1M particles, and rejection ABC at 1M.
    a = ABC_CFG
    abc = ABCSMC(m.abc_model, (), gx.Selection.at["theta"], summary_fn=lambda tr: tr.get_choices()["y"],
                 observed_summary=1.0, n_particles=a["n_particles"], n_generations=a["n_generations"],
                 n_moves=a["n_moves"])
    abc.run(rng)  # warm up
    before = counted(ops)
    syncs = count_syncs(lambda: abc.run(rng))
    lse_n = counted(ops)[0] - before[0]
    check(lse_n == a["n_generations"], f"A1: {lse_n} logsumexp launches over {a['n_generations']} generations")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, outs = timed_runs(lambda: abc.run(rng), a["runs"], warm=False)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    means, stds = [], []
    for out in outs:
        th = out["traces"].get_choices()["theta"].double()
        eps = out["epsilons"]
        means.append(float(th.mean()))
        stds.append(float(th.std(correction=0)))
        check(bool((eps[1:] < eps[:-1]).all()) and bool((out["distances"] <= eps[-1]).all())
              and 0.02 < float(out["accept_rate"]) < 0.95 and abs(stds[-1] - 0.2**0.5) < 0.12,
              f"A1: epsilons {eps.tolist()}, accept rate {float(out['accept_rate'])}, std {stds[-1]}")
    mean_line = within_se(means, 0.8, "A1 theta mean over runs")
    rej = abc_rejection(rng, m.abc_model, (), lambda tr: tr.get_choices()["y"], 1.0,
                        tolerance=a["rejection_tolerance"], n_particles=a["n_particles"])
    acc = rej["accepted"]
    est = float((rej["traces"].get_choices()["theta"] * acc).sum() / acc.sum())
    check(abs(est - 0.8) < 0.02 and bool((rej["distances"][acc] < a["rejection_tolerance"]).all()),
          f"A1 rejection: accepted mean {est}")
    ms = statistics.median(times)
    print(f"[{card}] A1 ABC-SMC {a['n_particles']} particles, {a['n_generations']} generations x {a['n_moves']} "
          f"moves: {ms:.1f} ms per run (median of {a['runs']}), {a['n_particles'] * a['n_generations'] * a['n_moves'] / (ms * 1e-3):.4g} "
          f"particle-moves/s; peak device memory {peak:.1f} MiB; {syncs} syncs and {lse_n} logsumexp launches per run")
    print(f"A1: {mean_line}; population std {statistics.fmean(stds):.4f} (exact {0.2**0.5:.4f}, bound 0.12); final "
          f"tolerance {float(outs[-1]['epsilons'][-1]):.4g}; rejection ABC at tolerance {a['rejection_tolerance']}: "
          f"accept rate {float(rej['accept_rate']):.4f}, accepted mean {est:.4f} (exact 0.8, bound 0.02)")

    sections["A1"] = time.perf_counter() - t_phase - sum(sections.values())
    # I1: involutive MH with the scaling move at 8192 chains.
    ic = INVOLUTIVE_CFG
    tr0, _ = m.lognormal.importance(rng, gx.ChoiceMap.kw(y=2.0), (), n=ic["n_chains"])
    new_tr, log_alpha = involutive_step(rng, tr0, gx.Selection.at["x"], m.aux_scale, m.scale_move)
    u = torch.log(new_tr.get_choices()["x"] / tr0.get_choices()["x"])
    s_old, _ = m.lognormal.assess(tr0.get_choices(), (), ic["n_chains"])
    s_new, _ = m.lognormal.assess(new_tr.get_choices(), (), ic["n_chains"])
    gap = relative_gap(log_alpha, s_new - s_old + u)
    check(gap < 1e-4, f"I1: log alpha against the hand derivation: {gap}")

    def inv_chain(steps: int):
        t = tr0
        for _ in range(steps):
            t, _ = involutive_mh(rng, t, gx.Selection.at["x"], m.aux_scale, m.scale_move)
        return t

    syncs = count_syncs(lambda: inv_chain(ic["sync_steps"]))
    check(syncs == 0, f"I1: {syncs} syncs over {ic['sync_steps']} steps")
    times, (final,) = timed_runs(lambda: inv_chain(ic["n_steps"]), 1, warm=False)
    z = torch.log(final.get_choices()["x"]).double().cpu()
    se_mean, se_var = math.sqrt(0.5 / z.numel()), 0.5 * math.sqrt(2.0 / (z.numel() - 1))
    check(abs(float(z.mean()) - 1.0) < 5 * se_mean and abs(float(z.var()) - 0.5) < 5 * se_var,
          f"I1: log x mean {float(z.mean())}, variance {float(z.var())} against N(1, 1/2)")
    print(f"[{card}] I1 involutive MH (scaling move) C={ic['n_chains']}: {times[0] / ic['n_steps']:.3f} ms per step "
          f"({ic['n_steps']} steps); log x over the chains' last states: mean {float(z.mean()):.4f} (exact 1, 5 SE "
          f"{5 * se_mean:.4f}), variance {float(z.var()):.4f} (exact 0.5, 5 SE {5 * se_var:.4f}); log alpha against "
          f"the hand derivation within {gap:.2e}; {syncs} syncs over {ic['sync_steps']} steps")

    sections["I1"] = time.perf_counter() - t_phase - sum(sections.values())
    # T1: parallel tempering on the bimodal target.
    p = PT_CFG
    target = gx.Target(m.bimodal, (), gx.ChoiceMap.kw(y=4.0))
    pt = ParallelTempering(betas=torch.tensor([1.0, 0.5, 0.25, 0.1, 0.02], device=dev),
                           request=GaussianDrift(gx.Selection.at["mu"], 0.5), n_moves=2)

    def pt_run(sweeps: int):
        return pt.run(rng, target, sweeps, collect=lambda t: t.get_choices()["mu"],
                      init_constraint=gx.ChoiceMap.kw(mu=2.0))

    syncs = count_syncs(lambda: pt_run(p["sync_sweeps"]))
    check(syncs == 0, f"T1: {syncs} syncs over {p['sync_sweeps']} sweeps")
    times, (out,) = timed_runs(lambda: pt_run(p["n_sweeps"]), 1, warm=False)
    neg = float((out.collected[p["burn"]:] < 0.0).float().mean())
    check(0.1 < neg < 0.9 and torch.equal(torch.sort(out.perm).values.cpu(), torch.arange(5))
          and bool((out.swap_rates > 0.0).all()),
          f"T1: share of cold draws below 0 {neg}, perm {out.perm.tolist()}, swap rates {out.swap_rates.tolist()}")
    print(f"[{card}] T1 parallel tempering, 5 replicas, {p['n_sweeps']} sweeps x 2 moves: {times[0] / p['n_sweeps']:.3f} "
          f"ms per sweep; the cold chain below 0 in {neg:.3f} of its draws after {p['burn']} (both modes: bound "
          f"(0.1, 0.9)); swap rates {', '.join(f'{v:.3f}' for v in out.swap_rates.tolist())}; {syncs} syncs over "
          f"{p['sync_sweeps']} sweeps")
    print_profile(card, "SV1 SVGD step (f32)", profiling.trace(profiles["SV1"][2], profiles["SV1"][1]))
    print_profile(card, "SV2 SVGD step (bf16)", profiling.trace(profiles["SV2"][2], profiles["SV2"][1]))
    sections["T1 and profiles"] = time.perf_counter() - t_phase - sum(sections.values())
    print(f"[{card}] algorithms phase: {time.perf_counter() - t_phase:.1f} s in all ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in sections.items()) + ")")


def alternating(fns: dict, pairs: int) -> dict:
    """Host-clock ms of each of `fns`' calls, run in turn `pairs` times (one
    untimed round first), each between two device synchronisations: so
    that a host that drifts during the run moves every mode alike."""
    times = {name: [] for name in fns}
    for rnd in range(pairs + 1):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if rnd:
                times[name].append(1e3 * (time.perf_counter() - t0))
    return times


def phase_aux(gx, ops, card: str, dev: str = "cuda") -> None:
    """The auxiliary layer on the card: C1 a checkpoint of a 1M-particle
    SMC state and a bit-identical resume, C2 the public API's checks on
    the main path (bit-identical results with the checks on, under
    `checked_mode()` and off, and their cost per step), C3 a profile trace
    and operation counts of one SIR trial at 1M, C4 time travel over the
    SIR log weights through K1."""
    import os
    import tempfile

    import torch.utils._pytree as pytree

    from genjax_tpu_torch.core import typecheck
    from genjax_tpu_torch.entry import N_PARTICLES, N_STEPS, entry
    from genjax_tpu_torch.models.beta_bernoulli import beta_bernoulli
    from genjax_tpu_torch.models.logreg import BenchConfig, run_hmc_chains
    from genjax_tpu_torch.models.ssm import run_bootstrap_filter, simulate_ssm_data
    from genjax_tpu_torch.profiling import PROFILE_ATTEMPTS
    from genjax_tpu_torch.utils import (
        annotate, cost_summary, device_memory_stats, profile_trace, restore_checkpoint, save_checkpoint, tag,
        time_machine,
    )

    k = AUX_CFG["n_particles"]
    mib = 2**20

    # C1: checkpoint and resume at K particles.
    @gx.gen
    def conjugate():
        x = gx.normal(0.0, 1.0) @ "x"
        _ = gx.normal(x, 1.0) @ "y"
        return x

    target = gx.Target(conjugate, (), gx.ChoiceMap.kw(y=1.0))
    # Threshold 1: the resample branch runs whatever the ESS is.
    driver = gx.smc.SMCDriver(n_particles=k, ess_threshold=1.0)
    coll = driver.init(torch.Generator(device=dev).manual_seed(0), target)
    state = {"collection": coll, "rng": torch.Generator(device=dev).manual_seed(1)}
    fresh = {"collection": driver.init(torch.Generator(device=dev).manual_seed(2), target),
             "rng": torch.Generator(device=dev)}
    mem_before = device_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smc_state.pt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, state)
        save_ms = 1e3 * (time.perf_counter() - t0)
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        restored = restore_checkpoint(path, fresh)
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
    mem_after = device_memory_stats()
    live_leaves, restored_leaves = pytree.tree_leaves(state), pytree.tree_leaves(restored)
    check(len(live_leaves) == len(restored_leaves), "checkpoint: leaf count")
    for a, b in zip(live_leaves, restored_leaves):
        if isinstance(a, torch.Tensor):
            check(b.device == a.device and b.dtype == a.dtype and torch.equal(a, b),
                  f"checkpoint: a restored leaf differs ({tuple(a.shape)} {a.dtype} on {a.device})")
        elif isinstance(a, torch.Generator):
            check(b.device == a.device and torch.equal(a.get_state(), b.get_state()), "checkpoint: generator state")
        else:
            check(a == b, f"checkpoint: restored value {b!r} for {a!r}")

    def resume(s):
        c = driver.rejuvenate(s["rng"], s["collection"], gx.Regenerate(gx.Selection.at["x"]))
        return driver.maybe_resample(s["rng"], c)

    before = counted(ops)
    live, back = resume(state), resume(restored)
    check(dev != "cuda" or counted(ops)[1] - before[1] == 2, "C1: each resume should launch logsumexp_ess once")
    for a, b in zip(pytree.tree_leaves(live), pytree.tree_leaves(back)):
        if isinstance(a, torch.Tensor):
            check(torch.equal(a, b), f"C1: the resumed states differ at a leaf of shape {tuple(a.shape)}")
    lml_live, lml_back = live.get_log_marginal_likelihood_estimate(), back.get_log_marginal_likelihood_estimate()
    check(torch.equal(lml_live, lml_back), f"C1: LML {float(lml_live)} live, {float(lml_back)} restored")
    lw = coll.get_log_weights().double()
    w = torch.exp(lw - lw.max())
    se = math.sqrt(float((w * w).mean() / w.mean() ** 2 - 1.0) / k)  # delta method: Var(log Z^) ~ Var(w) / (K E[w]^2)
    lml = float(lml_live)
    check(abs(lml - CONJUGATE_LML) < 5 * se, f"C1: LML {lml} not within 5 SE ({se:.2e}) of {CONJUGATE_LML}")
    k1_err = max(k1_against_plain(ops, coll.get_log_weights())[0], k1_against_plain(ops, live.get_log_weights())[0])
    x = live.get_particles().get_choices()["x"]
    check(x.shape == (k,) and bool(torch.isfinite(x).all()), "C1: resumed particles")
    print(f"C1 checkpoint of SMCDriver state at K={k}: {len(live_leaves)} leaves, every leaf and the generator "
          f"state bit-identical after restore; resumed (Regenerate x, then resample) from the live and the restored "
          f"state: every leaf and the LML bit-identical; LML {lml:.6f} (exact {CONJUGATE_LML:.6f}, SE {se:.2e}, "
          f"{abs(lml - CONJUGATE_LML) / se:.2f} SE off); K1 == plain on the importance and the resampled weights "
          f"(|err| {k1_err:.2e} of max(1, |ref|), limit 1e-5)")
    print(f"[{card}] C1 save_checkpoint {save_ms:.2f} ms, restore_checkpoint {restore_ms:.2f} ms (to the card), "
          f"file {size / mib:.2f} MiB ({size} bytes); device memory before {mem_before}, after {mem_after}")
    del coll, state, fresh, restored, live, back, lw, w, x

    # C2: the checks on the main path. Each filter runs from one seed in
    # each mode; the checks draw nothing and launch nothing.
    modes = {
        "checks on (default)": lambda fn: fn(),
        "checked_mode()": lambda fn: _in_checked_mode(gx, fn),
        "do_typecheck(False)": lambda fn: _typecheck_off(gx, fn),
    }
    check(gx.is_typechecked(), "the public API's checks are not on by default")
    fn_small, _ = entry(dev)
    _, ys = simulate_ssm_data(torch.Generator().manual_seed(1), BIG_FILTER_STEPS)
    ys = ys.to(dev)
    filters = {
        f"K={N_PARTICLES} T={N_STEPS}": (
            N_STEPS, AUX_CFG["filter_pairs"], lambda: fn_small(torch.Generator(device=dev).manual_seed(7))[0]),
        f"K={BIG_FILTER_PARTICLES} T={BIG_FILTER_STEPS}": (
            BIG_FILTER_STEPS, AUX_CFG["big_filter_pairs"],
            lambda: run_bootstrap_filter(torch.Generator(device=dev).manual_seed(7), ys, n_particles=BIG_FILTER_PARTICLES)[0]),
    }
    for label, (steps, pairs, run) in filters.items():
        lmls, entries = {}, {}
        for mode, call in modes.items():
            e0 = typecheck.entries()
            lmls[mode] = call(run)
            entries[mode] = typecheck.entries() - e0
        ref = lmls["checks on (default)"]
        check(all(torch.equal(v, ref) for v in lmls.values()),
              f"C2 filter {label}: LMLs differ between modes {[float(v) for v in lmls.values()]}")
        check(entries["do_typecheck(False)"] == 0, f"C2 filter {label}: wrappers entered with the checks off")
        times = alternating({mode: (lambda call=call: call(run)) for mode, call in modes.items()}, pairs)
        print(f"[{card}] C2 filter {label}: LML {float(ref):.6f} bit-identical in the three modes; "
              + "; ".join(f"{mode} {statistics.median(t) / steps:.4f} ms/step (median of {pairs}: "
                          f"{', '.join(f'{x:.2f}' for x in t)} ms/filter)" for mode, t in times.items())
              + f"; wrapped calls per step {entries['checks on (default)'] / steps:.2f} "
              f"({entries['checks on (default)']} per filter; {entries['checked_mode()']} under checked_mode())")
        cost_line(card, f"filter {label} (per step)", steps, times["checks on (default)"],
                  times["do_typecheck(False)"], entries["checks on (default)"])

    # The cost of one wrapper, alone: a trivial function with the
    # signature of `generate` (five checked parameters) and of `merge`
    # (one), wrapped and not, called back to back.
    def generate_like(self, rng: torch.Generator, constraint: gx.ChoiceMap, args: tuple,
                      n: int | tuple | None = None, like: gx.Trace | None = None):
        return rng

    def merge_like(self, other: gx.ChoiceMap):
        return other

    chm, g = gx.ChoiceMap.kw(y=1.0), torch.Generator(device=dev)
    for label, fn, call_args in (("generate (5 checked parameters)", generate_like, (None, g, chm, (), 8, None)),
                                 ("merge (1 checked parameter)", merge_like, (chm, chm))):
        wrapped = typecheck._wrap(fn, label)
        check(wrapped is not fn, f"C2: {label} was not wrapped")
        us = {}
        for name, f in (("plain", fn), ("wrapped", wrapped)) * 2:
            t0 = time.perf_counter()
            for _ in range(AUX_CFG["wrapper_calls"]):
                f(*call_args)
            us[name] = 1e6 * (time.perf_counter() - t0) / AUX_CFG["wrapper_calls"]
        print(f"[{card}] C2 one wrapper, {label}: {us['wrapped'] - us['plain']:.3f} us per call over the plain "
              f"function's {us['plain']:.3f} us ({AUX_CFG['wrapper_calls']} calls each, the second of two passes)")

    # The checks' cost on the other two host-bound paths: logreg HMC (one
    # run is S MH steps of L leapfrog steps) and block-move MH through
    # Switch (one run is `block_steps` MH steps).
    cfg = BenchConfig()
    X, yl = cfg.data(dev)
    rng = torch.Generator(device=dev).manual_seed(40)
    m = branching_models(gx, dev)
    block = gx.Regenerate(m.block)
    chains, _ = m.mixture.importance(rng, gx.ChoiceMap.kw(y=MIX_Y), (), n=BRANCH_CHAINS)
    paths = {
        f"logreg HMC C={cfg.n_chains} (per MH step of L={cfg.L})": (
            cfg.n_steps, AUX_CFG["hmc_pairs"],
            lambda: run_hmc_chains(rng, X, yl, n_chains=cfg.n_chains, n_steps=cfg.n_steps, eps=cfg.eps, L=cfg.L)),
        f"block-move MH C={BRANCH_CHAINS} (per MH step)": (
            AUX_CFG["block_steps"], AUX_CFG["block_pairs"],
            lambda: gx.run_chains(rng, chains, block, AUX_CFG["block_steps"])),
    }
    for label, (steps, pairs, run) in paths.items():
        e0 = typecheck.entries()
        run()
        per_run = typecheck.entries() - e0
        times = alternating({"on": run, "off": lambda run=run: _typecheck_off(gx, run)}, pairs)
        cost_line(card, label, steps, times["on"], times["off"], per_run)
    del chains, m

    # C3: a profile of one SIR trial at K particles, and its counts.
    alg = gx.ImportanceK(gx.Target(beta_bernoulli, (2.0, 2.0), gx.ChoiceMap.d({"v": True})), k_particles=k)

    @annotate("sir_trial")
    def trial():
        col = alg.run_smc(rng)
        return col.get_log_marginal_likelihood_estimate(), col.sample_particle(rng)

    trial()
    # The profiler has come back without device intervals for runs that
    # launched kernels (one trace of 21 in `profiling.trace`, and K1's
    # kernel alone missing from a trace that held the others): such a
    # trace is taken again, as `profiling.trace` takes it.
    attempts = []
    for _ in range(PROFILE_ATTEMPTS):
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            with profile_trace(tmp) as log_dir:
                trial()
                torch.cuda.synchronize()
            events = json.loads((Path(log_dir) / "trace.json").read_text())["traceEvents"]
        names = [e.get("name", "") for e in events]
        kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        attempts.append((len(events), len(kernels), sum("genjax_lse" in n for n in kernels)))
        if dev != "cuda" or attempts[-1][2]:
            break
    check("sir_trial" in names, "C3: the profile trace holds no sir_trial span")
    check(dev != "cuda" or attempts[-1][2] > 0,
          f"C3: no profile trace held K1's kernel (genjax_lse): (events, kernels, K1 kernels) {attempts}")
    costs = cost_summary(trial)
    check(all(costs[key] > 0 for key in ("flops", "bytes accessed", "transcendentals")), f"C3: cost_summary {costs}")
    print(f"C3 profile_trace of one SIR trial at K={k} under annotate('sir_trial'): the span present; (events, "
          f"device kernels, K1 kernels) per trace taken {attempts}; cost_summary: "
          + ", ".join(f"{key} {v:.4g}" for key, v in costs.items()))

    # C4: time travel over the SIR log weights; both values from K1.
    def weights_lse():
        col = alg.run_smc(rng)
        return ops.logsumexp(tag(col.get_log_weights(), "w"))

    before = counted(ops)[0]
    dbg = time_machine(weights_lse)()
    shifted = dbg.jump("w").remix(dbg.current() + 3.0)
    check(dev != "cuda" or counted(ops)[0] - before == 2, "C4: the two log-sum-exps should be one K1 launch each")
    a, b = float(dbg.retval), float(shifted.retval)
    ok, err = close(torch.tensor(b - 3.0), torch.tensor(a))
    check(ok and shifted.n_frames == 1, f"C4: remix(w + 3) gave {b}, the original {a}")
    print(f"C4 time_machine over the SIR log weights at K={k}: lse(w) {a:.6f}, jump('w').remix(w + 3) "
          f"{b:.6f}, shift {b - a:.7f} (|err| {err:.2e}, limit 1e-5 * max(1, |ref|)), both K1 launches")


@contextlib.contextmanager
def dense_plan():
    """Every static edit under the fallback plan (JAX's `_FALLBACK_PLAN`):
    each site recomputed under unknown argdiffs, as the dense edits did."""
    from genjax_tpu_torch.lang import static

    real = static._static_edit_plan
    static._static_edit_plan = lambda *a, **k: static._FALLBACK_PLAN
    try:
        yield
    finally:
        static._static_edit_plan = real


@contextlib.contextmanager
def counting_densities(box: list):
    """Count the sites' density evaluations into `box[0]`: every draw
    (which scores what it draws) and every re-score of a kept value."""
    from genjax_tpu_torch.distributions.distribution import Distribution

    draw, density = Distribution._draw, Distribution._density

    def counted_draw(self, *a, **k):
        box[0] += 1
        return draw(self, *a, **k)

    def counted_density(self, *a, **k):
        box[0] += 1
        return density(self, *a, **k)

    Distribution._draw, Distribution._density = counted_draw, counted_density
    try:
        yield
    finally:
        Distribution._draw, Distribution._density = draw, density


def schools_oracle_checks(oracle, mus, taus, thetas, label: str) -> str:
    """H1's rule: mu, tau and each theta within 6 SE + 0.05 of the
    quadrature oracle, n_eff = C S / 20, from (C, S) draws."""
    n_eff = mus.shape[0] * mus.shape[1] / 20.0
    report = []
    for got, mean, var, what in ((mus.mean(), oracle.mu_mean, oracle.mu_var, "mu"),
                                 (taus.mean(), oracle.tau_mean, oracle.tau_var, "tau")):
        se = math.sqrt(float(var) / n_eff)
        gap = abs(float(got) - float(mean))
        check(gap < 6 * se + 0.05, f"{label} {what}: {float(got)} against the oracle's {float(mean)} (6 SE {6 * se})")
        report.append(f"{what} {float(got):.3f} (oracle {float(mean):.3f}, bound {6 * se + 0.05:.3f})")
    th_err = (thetas.mean((0, 1)) - oracle.theta_mean.double()).abs()
    th_bound = 6 * (oracle.theta_var.double() / n_eff).sqrt() + 0.05
    check(bool((th_err < th_bound).all()), f"{label} theta means off: {th_err.tolist()} against {th_bound.tolist()}")
    report.append(f"every theta within its bound (largest gap {float(th_err.max()):.3f})")
    return "; ".join(report)


def phase_incremental(gx, ops, card: str, dev: str = "cuda") -> None:
    """Incremental edits on the card. I1: MH-within-Gibbs on eight schools
    at 8192 chains (non-centered over mu, log_tau, z from the prior;
    centered over mu, log_tau, theta from the non-centered chains' last
    state), held against the quadrature oracle, each site's moved share
    above a floor, R-hat under 1.1 on the non-centered chains and the
    centered chains away from their start; the analysis runs once
    per model (0 cache misses after the first sweep, 0 fallbacks), 0
    syncs per sweep, one sweep's weights under the plan equal to the dense
    weights on the same state and generator; the plan against the dense
    fallback plan in alternating runs (ms, density evaluations and device
    items per sweep). I2: resample-move at K=1M, 10 runs: ImportanceK
    from the prior on `ys`, the LML through K1 (one launch, held against
    its plain twin on the run's own weights), a systematic resample, one
    Gibbs sweep; the LML and the posterior mean of mu against the oracle.
    I3: `SafeHMC` over mu and log_tau on the centered model (retdiff
    NoChange); on the non-centered one it raises."""
    from genjax_tpu_torch import profiling
    from genjax_tpu_torch.core.typing import per_particle
    from genjax_tpu_torch.inference.diagnostics import split_rhat
    from genjax_tpu_torch.inference.requests import SafeHMC
    from genjax_tpu_torch.lang import analysis
    from genjax_tpu_torch.models import hierarchical as h

    cfg = INCREMENTAL_CFG
    t_phase = time.perf_counter()
    rng = torch.Generator(device=dev).manual_seed(13)
    y, sigma = h.EIGHT_SCHOOLS_Y.to(dev), h.EIGHT_SCHOOLS_SIGMA.to(dev)
    oracle = h.eight_schools_quadrature(h.EIGHT_SCHOOLS_Y, h.EIGHT_SCHOOLS_SIGMA)
    C, obs = cfg["chains"], gx.ChoiceMap.kw(ys=y)
    models = {
        "non-centered": (h.eight_schools, [gx.Selection.at[a] for a in ("mu", "log_tau", "z")]),
        "centered": (h.eight_schools_centered, [gx.Selection.at[a] for a in ("mu", "log_tau", "theta")]),
    }

    def collect(t):
        ch = t.get_choices()
        return ch["mu"], ch["log_tau"], t.get_retval()

    traces = {}
    tr, _ = h.eight_schools.importance(rng, obs, (sigma,), n=C)
    for label, (model, sels) in models.items():
        if label == "centered":
            last = traces["non-centered"]
            ch = last.get_choices()
            start_mu, start_lt = ch["mu"].double().cpu(), ch["log_tau"].double().cpu()
            start = obs | gx.ChoiceMap.kw(mu=per_particle(ch["mu"]), log_tau=per_particle(ch["log_tau"]),
                                          theta=per_particle(last.get_retval()))
            tr, _ = model.importance(rng, start, (sigma,), n=C)
        s0 = analysis.stats()
        tr = gx.gibbs_sweep(rng, tr, sels)  # the first sweep runs the analysis
        s1 = analysis.stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr, _ = gx.gibbs_chain(rng, tr, sels, cfg["burn"] - 1)
        tr, (mus, lts, thetas) = gx.gibbs_chain(rng, tr, sels, cfg["sweeps"], collect)
        torch.cuda.synchronize()
        run_ms = 1e3 * (time.perf_counter() - t0)
        syncs = count_syncs(lambda: gx.gibbs_chain(rng, tr, sels, cfg["sync_sweeps"]))
        s2 = analysis.stats()
        # One analysis, or none where an earlier path (H1's ChEES edits)
        # analyzed the same model at the same shapes.
        first = s1["misses"] - s0["misses"]
        check(first <= 1, f"I1 {label}: {first} analyses in the first sweep")
        check(s2["misses"] == s1["misses"], f"I1 {label}: {s2['misses'] - s1['misses']} cache misses after the first sweep")
        check(s2["fallbacks"] == s0["fallbacks"], f"I1 {label}: fallbacks {s0['fallbacks']} -> {s2['fallbacks']}")
        check(syncs == 0, f"I1 {label}: {syncs} syncs over {cfg['sync_sweeps']} sweeps")
        mus, taus, lts = mus.T.double().cpu(), torch.exp(lts.T.double().cpu()), lts.T.double().cpu()
        thetas = thetas.transpose(0, 1).double().cpu()
        check(bool(torch.isfinite(thetas).all()) and thetas.shape == (C, cfg["sweeps"], 8), f"I1 {label}: theta draws")
        report = schools_oracle_checks(oracle, mus, taus, thetas, f"I1 {label}")
        rhat = {k: float(split_rhat(v).max()) for k, v in (("mu", mus), ("log_tau", lts), ("theta", thetas))}
        # Each site's share of (chain, sweep) steps whose value moved: a
        # stuck kernel fails its floor.
        moved = {k: float((v[:, 1:] != v[:, :-1]).reshape(C, cfg["sweeps"] - 1, -1).any(-1).double().mean())
                 for k, v in (("mu", mus), ("log_tau", lts), ("theta", thetas))}
        floors = cfg["moved_floor"][label]
        check(all(moved[k] >= floors[k] for k in moved), f"I1 {label}: moved shares {moved} under {floors}")
        if label == "non-centered":
            check(max(rhat.values()) < 1.1, f"I1 {label}: R-hat {rhat}")
            held = "limit 1.1"
        else:
            # Prior-proposal Gibbs does not mix in the funnel (R-hat over
            # 1.1). The chains start at the non-centered chains' posterior
            # draws; they must leave them (the correlation across chains
            # of each start with the last draw under its bound), and then
            # stay on the oracle's posterior: a kernel that moves and does
            # not keep the posterior fails the oracle checks.
            corr = {k: float(torch.corrcoef(torch.stack([a, b[:, -1]]))[0, 1])
                    for k, a, b in (("mu", start_mu, mus), ("log_tau", start_lt, lts))}
            check(all(corr[k] < cfg["start_corr_max"][k] for k in corr),
                  f"I1 {label}: the chains did not leave their start: correlations {corr}")
            held = (f"reported; the chains left their start: correlation of start and last draw "
                    f"{', '.join(f'{k} {v:.3f}' for k, v in corr.items())} (limits "
                    f"{', '.join(f'{k} {v}' for k, v in cfg['start_corr_max'].items())})")
        hits = s2["hits"] - s1["hits"]
        print(f"[{card}] I1 {label} eight schools MH-within-Gibbs, {C} chains, {cfg['burn']} burn-in + "
              f"{cfg['sweeps']} collected sweeps: {run_ms / (cfg['burn'] - 1 + cfg['sweeps']):.3f} ms per sweep; "
              f"{report}; split R-hat {', '.join(f'{k} {v:.4f}' for k, v in rhat.items())} ({held}); "
              f"moved shares {', '.join(f'{k} {v:.3f}' for k, v in moved.items())} (floors "
              f"{', '.join(f'{k} {v}' for k, v in floors.items())}); "
              f"analysis: {first} run(s) in the first sweep, {hits} cache hits and 0 misses after it, 0 fallbacks; "
              f"{syncs} syncs over {cfg['sync_sweeps']} sweeps")

        # One sweep's weights under the plan against the dense weights, on
        # the same state and generator.
        worst, t = 0.0, tr
        for sel in sels:
            state = rng.get_state()
            new, w, _, _ = gx.Regenerate(sel).edit(rng, t, gx.Diff.no_change(t.get_args()))
            rng.set_state(state)
            with dense_plan():
                dense, w_dense, _, _ = gx.Regenerate(sel).edit(rng, t, gx.Diff.no_change(t.get_args()))
            gap = float(((w - w_dense).abs() / torch.clamp(w_dense.abs(), min=1.0)).max())
            check(gap <= 1e-5, f"I1 {label}: plan weights against dense weights at {sel}: {gap}")
            for a, b in zip(torch.utils._pytree.tree_leaves(new.get_choices()),
                            torch.utils._pytree.tree_leaves(dense.get_choices())):
                check(torch.equal(a, b), f"I1 {label}: the plan's proposal differs from the dense one at {sel}")
            worst = max(worst, gap)
            t, _ = gx.mh(rng, t, gx.Regenerate(sel))

        # The plan against the dense fallback plan: time, density
        # evaluations and device items per sweep.
        def sweeps(n):
            return lambda: gx.gibbs_chain(rng, tr, sels, n)

        def dense_sweeps(n):
            def run():
                with dense_plan():
                    return gx.gibbs_chain(rng, tr, sels, n)
            return run

        times = alternating({"plan": sweeps(cfg["timed_sweeps"]), "dense": dense_sweeps(cfg["timed_sweeps"])},
                            cfg["timed_pairs"])
        per_sweep = {k: statistics.median(v) / cfg["timed_sweeps"] for k, v in times.items()}
        evals = {}
        for k, fn in (("plan", sweeps(1)), ("dense", dense_sweeps(1))):
            box = [0]
            with counting_densities(box):
                fn()
            evals[k] = box[0]
        profs = {k: profiling.trace(fn, 1) for k, fn in (("plan", sweeps(1)), ("dense", dense_sweeps(1)))}
        print(f"[{card}] I1 {label}: one sweep's weights under the plan equal the dense ones (largest gap "
              f"{worst:.2e} of max(1, |w|), limit 1e-5; proposals identical); per sweep, plan against dense "
              f"(alternating, {cfg['timed_pairs']} pairs of {cfg['timed_sweeps']} sweeps, host clock, median): "
              f"{per_sweep['plan']:.3f} ms against {per_sweep['dense']:.3f} ms "
              f"({per_sweep['dense'] / per_sweep['plan']:.2f}x); density evaluations {evals['plan']} against "
              f"{evals['dense']}; device items {profs['plan']['device_items_per_step']:.1f} against "
              f"{profs['dense']['device_items_per_step']:.1f}")
        for k, prof in profs.items():
            print_profile(card, f"I1 {label} sweep ({k})", prof)
        traces[label] = tr

    # I2: resample-move at a million particles.
    K = cfg["particles"]
    target = gx.Target(h.eight_schools, (sigma,), obs)
    sels = models["non-centered"][1]
    lmls, mu_means, k1_err = [], [], 0.0
    before = ops.fused_logsumexp.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for run in range(cfg["rm_runs"]):
        coll = gx.ImportanceK(target, k_particles=K).run_smc(rng)
        lw = coll.get_log_weights()
        lse = ops.logsumexp(lw)
        if run == 0:
            k1_err, _ = k1_against_plain(ops, lw)
        moved = gx.gibbs_sweep(rng, coll.resample(rng, "systematic", lse=lse).get_particles(), sels)
        lmls.append(float(lse) - math.log(K))
        mu_means.append(float(moved.get_choices()["mu"].double().mean()))
    torch.cuda.synchronize()
    rm_ms = 1e3 * (time.perf_counter() - t0) / cfg["rm_runs"]
    launched = ops.fused_logsumexp.launches - before
    check(launched == cfg["rm_runs"], f"I2: {launched} K1 launches over {cfg['rm_runs']} runs (one per LML)")
    print(f"[{card}] I2 resample-move K={K}, {cfg['rm_runs']} runs: {rm_ms:.1f} ms per run; "
          f"{within_se(lmls, float(oracle.log_evidence), 'LML', 5.0)}; "
          f"{within_se(mu_means, float(oracle.mu_mean), 'posterior mean of mu', 5.0)}; K1 {launched} launches "
          f"(one per LML), against its plain twin on run 0's weights: largest error {k1_err:.2e} of max(1, |ref|)")

    # I3: SafeHMC over mu and log_tau.
    sel = gx.Selection.at["mu"] | gx.Selection.at["log_tau"]
    request = SafeHMC(sel, cfg["hmc_eps"], cfg["hmc_L"])
    ctr = traces["centered"]
    _, alpha, rd, _ = request.edit(rng, ctr, gx.Diff.no_change(ctr.get_args()))
    check(gx.Diff.static_check_no_change(rd), "I3: SafeHMC's retdiff on the centered model")
    # A chain in the funnel's neck (tau ~ e^-6) takes leapfrog steps that
    # diverge (NaN, then rejected), as HMC on the centered model does.
    diverged = int((~torch.isfinite(alpha)).sum())
    check(alpha.shape == (C,) and diverged <= C // 100, f"I3: SafeHMC's log accept ratios: {diverged} not finite")
    accepted = []
    for _ in range(cfg["hmc_steps"]):
        ctr, acc = gx.mh(rng, ctr, request)
        accepted.append(acc)
    rate = float(torch.stack(accepted).float().mean())
    try:
        request.edit(rng, traces["non-centered"], gx.Diff.no_change(traces["non-centered"].get_args()))
        raised = False
    except AssertionError:
        raised = True
    check(raised, "I3: SafeHMC on the non-centered model (theta = mu + tau z is the return value) did not raise")
    print(f"[{card}] I3 SafeHMC over mu and log_tau, centered, {C} chains: retdiff NoChange, "
          f"{cfg['hmc_steps']} MH steps at eps {cfg['hmc_eps']}, L {cfg['hmc_L']}: accept rate {rate:.3f}; "
          f"{diverged} of {C} first moves diverged (the funnel's neck); on the non-centered model it raises")
    # P2's block move regenerates the mixture's one latent site and
    # re-scores the observation that reads it, so the plan keeps no site:
    # against the dense fallback plan in alternating runs, with each one's
    # density evaluations and launch calls per step.
    m = branching_models(gx, dev)
    mix_chains, _ = m.mixture.importance(rng, gx.ChoiceMap.kw(y=MIX_Y), (), n=BRANCH_CHAINS)
    block = gx.Regenerate(m.block)

    def block_steps():
        return gx.run_chains(rng, mix_chains, block, PROFILE_SWEEPS)

    def dense_block_steps():
        with dense_plan():
            return block_steps()

    times = alternating({"plan": block_steps, "dense": dense_block_steps}, cfg["p2_pairs"])
    p2 = {k: statistics.median(v) / PROFILE_SWEEPS for k, v in times.items()}
    p2_evals = {}
    for k, fn in (("plan", block_steps), ("dense", dense_block_steps)):
        box = [0]
        with counting_densities(box):
            fn()
        p2_evals[k] = box[0] / PROFILE_SWEEPS
    p2_profs = {k: profiling.trace(fn, PROFILE_SWEEPS) for k, fn in (("plan", block_steps), ("dense", dense_block_steps))}
    print(f"[{card}] P2 block-move MH C={BRANCH_CHAINS} under the plan against the dense fallback plan (alternating, "
          f"{cfg['p2_pairs']} pairs of {PROFILE_SWEEPS} steps, host clock, median): {p2['plan']:.3f} ms against "
          f"{p2['dense']:.3f} ms per MH step; density evaluations per step {p2_evals['plan']:.1f} against "
          f"{p2_evals['dense']:.1f}; launch calls per step {p2_profs['plan']['launch_calls_per_step']:.1f} against "
          f"{p2_profs['dense']['launch_calls_per_step']:.1f}")
    for k, prof in p2_profs.items():
        print_profile(card, f"P2 block-move MH step ({k})", prof)

    # Logreg HMC's final `Update` of each MH step goes through the plan
    # too: its device items per leapfrog step beside PERF.md §5's 76.1
    # (P2's, N1's and H1's are in their own phases' profile lines).
    from genjax_tpu_torch.models import logreg

    hmc = logreg.BenchConfig()
    X, yl = hmc.data(dev)
    print_profile(card, "logreg HMC under the edit plan (per leapfrog step; PERF.md §5: 76.1 items)",
                  profiling.trace(lambda: logreg.run_hmc_chains(rng, X, yl, n_chains=hmc.n_chains, n_steps=hmc.n_steps,
                                                                eps=hmc.eps, L=hmc.L), hmc.n_steps * hmc.L))
    print(f"[{card}] phase_incremental wall: {time.perf_counter() - t_phase:.1f} s; analysis record of the whole "
          f"smoke {analysis.stats()}")


def uncounted(ops, fn):
    """`fn()` with the K1 launch counts left as they were: a reference or
    the dense side of a comparison is not the path under test."""
    before = counted(ops)
    try:
        return fn()
    finally:
        ops.fused_logsumexp.launches, ops.fused_logsumexp_ess.launches = before


def run_through(round_):
    """Run a round written as a generator (it yields after each piece) to
    its end: its return value."""
    while True:
        try:
            next(round_)
        except StopIteration as done:
            return done.value


def piece_ms(round_) -> dict:
    """Host-clock ms of each piece of a round written as a generator, each
    between two device synchronisations."""
    times = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name in round_:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times[name] = 1e3 * (t1 - t0)
        t0 = t1
    return times


def phase_parallel(gx, ops, card: str) -> None:
    """The parallel layer at world size 1 (NCCL on the card) in this process,
    each driver held against the stitched dense run from the same
    generators (at one rank: the dense driver fed `fork(rng, 1)[0]`), K1
    held against its plain twin on the path's own weights, then
    `dryrun_multichip` on 1 and 2 ranks. The references' and the dense
    sides' K1 launches are not counted on the path."""
    import tempfile

    import torch.distributed as dist

    from genjax_tpu_torch.adev.core import fork
    from genjax_tpu_torch.entry import dryrun_multichip
    from genjax_tpu_torch.inference.mcmc import run_chains
    from genjax_tpu_torch.inference.parallel_tempering import ParallelTempering
    from genjax_tpu_torch.inference.requests import HMC, GaussianDrift
    from genjax_tpu_torch.inference.svgd import svgd
    from genjax_tpu_torch.models import conjugate, logreg
    from genjax_tpu_torch.parallel import (
        GridSMC,
        ShardedSMC,
        grid_mesh,
        particle_mesh,
        pooled_lml,
        sharded_mh_chains,
        sharded_pt_run,
        sharded_svgd,
    )
    from genjax_tpu_torch import profiling
    from genjax_tpu_torch.parallel import certify
    from genjax_tpu_torch.parallel import collectives as C

    t_phase = time.perf_counter()
    cfg, dev = PARALLEL_CFG, "cuda"

    def twin(seed: int) -> tuple[torch.Generator, torch.Generator]:
        return torch.Generator(device=dev).manual_seed(seed), torch.Generator(device=dev).manual_seed(seed)

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b))
                   if isinstance(x, torch.Tensor))

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            pmesh = particle_mesh(device_type=dev)
            C.reset_stats()

            # PS1: ShardedSMC rounds against the dense S3 round.
            c = conjugate.BenchConfig()
            target, driver = c.target(), c.driver()
            smc = ShardedSMC(n_particles=c.n_particles, mesh=pmesh, ess_threshold=c.ess_threshold)
            select_x = gx.Regenerate(gx.Selection.at["x"])

            # Each round yields after each piece, for `piece_ms`; the dense
            # one is `conjugate.smc_round`'s, piece for piece.
            def sharded_round(rng, shard=None):
                col = smc.init(rng, target)
                if shard is not None:
                    shard.append(col.get_log_weights())
                yield "init"
                lml = smc.lml(col)
                yield "lml"
                ess0 = smc.ess(col)
                yield "ess"
                col = smc.maybe_resample(rng, col)
                yield "maybe_resample"
                col = smc.rejuvenate(rng, col, select_x)
                yield "rejuvenate"
                mean = C.all_reduce(col.get_particles().get_choices()["x"].sum(), pmesh, "particles") / c.n_particles
                yield "mean"
                return lml, ess0, mean, col

            def dense_round(rng):
                col = driver.init(rng, target)
                yield "init"
                lml = col.get_log_marginal_likelihood_estimate()
                yield "lml"
                ess0 = col.get_ess()
                yield "ess"
                col = driver.maybe_resample(rng, col)
                yield "maybe_resample"
                col = driver.rejuvenate(rng, col, select_x)
                yield "rejuvenate"
                mean = col.get_particles().get_choices()["x"].mean()
                yield "mean"
                return lml, ess0, mean, col

            rng, rng_ref = twin(41)
            shard = []
            lml, _, _, col = run_through(sharded_round(rng, shard))
            k1_ps1, _ = k1_against_plain(ops, shard.pop())
            ref = certify.StitchedSMC(c.n_particles, 1, c.ess_threshold)
            blocks = ref.init(rng_ref, target)
            ref_lml = float(uncounted(ops, lambda: ref.lml(blocks)))
            blocks = uncounted(ops, lambda: ref.rejuvenate(rng_ref, ref.maybe_resample(rng_ref, blocks), select_x))
            check(same(col, blocks[0]), "PS1: round 1's particles and weights differ from the dense round from fork(rng, 1)[0]")
            lml_gap = abs(float(lml) - ref_lml)
            check(lml_gap <= 1e-6 * max(1.0, abs(ref_lml)), f"PS1: round 1's LML {float(lml)} against the dense {ref_lml}")
            del col, blocks
            rounds = [run_through(sharded_round(rng))[:3] for _ in range(cfg["rounds"])]
            ms = alternating({"sharded": lambda: run_through(sharded_round(rng)),
                              "dense": lambda: uncounted(ops, lambda: conjugate.smc_round(rng, driver, target))},
                             cfg["timed_pairs"])
            pieces = {"sharded": [], "dense": []}
            for i in range(cfg["piece_pairs"] + 1):
                split = {"sharded": piece_ms(sharded_round(rng)),
                         "dense": uncounted(ops, lambda: piece_ms(dense_round(rng)))}
                for name, p in split.items():
                    if i:
                        pieces[name].append(p)
            print(f"PS1 ShardedSMC, 1 rank (nccl), K={c.n_particles}, {cfg['rounds']} rounds, each resampling: "
                  + within_se([float(r[0]) for r in rounds], c.exact_lml(), "LML") + "; "
                  + within_se([float(r[2]) for r in rounds], c.posterior_mean(), "posterior mean of x")
                  + f"; round 1's particles and weights equal to the dense round from fork(rng, 1)[0], bit for bit, its "
                  f"LML {lml_gap:.2e} from the dense logsumexp - log K (K1's pair against its single entry point)")
            print(f"[{card}] PS1 ms per round: sharded {statistics.median(ms['sharded']):.3f}, dense S3 "
                  f"{statistics.median(ms['dense']):.3f} (medians of {cfg['timed_pairs']} alternating pairs: "
                  f"{', '.join(f'{a:.3f}/{b:.3f}' for a, b in zip(ms['sharded'], ms['dense']))}); the layer's cost "
                  f"{statistics.median(ms['sharded']) - statistics.median(ms['dense']):.3f} ms per round")
            med = {name: {k: statistics.median(p[k] for p in runs) for k in runs[0]} for name, runs in pieces.items()}
            print(f"[{card}] PS1 ms per piece, sharded/dense (medians of {cfg['piece_pairs']} alternating pairs, a "
                  "device sync after each piece): " + ", ".join(
                      f"{k} {med['sharded'][k]:.3f}/{med['dense'][k]:.3f}" for k in med["sharded"])
                  + f"; sums {sum(med['sharded'].values()):.3f}/{sum(med['dense'].values()):.3f}")
            print_profile(card, "PS1 sharded round", profiling.trace(lambda: run_through(sharded_round(rng)), 1))
            print_profile(card, "PS1's dense S3 round, same process",
                          uncounted(ops, lambda: profiling.trace(lambda: conjugate.smc_round(rng, driver, target), 1)))

            # PG1: GridSMC at C=8 x K=131072 on a 1 x 1 mesh.
            gmesh = grid_mesh(1, 1, device_type=dev)
            grid = GridSMC(n_chains=cfg["grid_chains"], n_particles=cfg["grid_particles"], mesh=gmesh, ess_threshold=2.0)
            rng, rng_ref = twin(42)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gcol = grid.init(rng, target)
            lmls, esss = grid.per_chain_lml(gcol), grid.per_chain_ess(gcol)
            grid_lw = gcol.get_log_weights()
            gcol = grid.rejuvenate(rng, grid.maybe_resample(rng, gcol), select_x)
            torch.cuda.synchronize()
            grid_ms = 1e3 * (time.perf_counter() - t0)
            k1_pg1 = max(k1_against_plain(ops, row)[0] for row in grid_lw)
            del grid_lw
            gref = certify.StitchedGrid(cfg["grid_chains"], cfg["grid_particles"], 1, 1)
            gblocks = gref.init(rng_ref, target)
            u0 = torch.rand(cfg["grid_chains"], generator=rng_ref, device=dev)
            gblocks = uncounted(ops, lambda: gref.rejuvenate(rng_ref, gref.resample(u0, gblocks), select_x))
            check(same(gcol, gblocks[(0, 0)]), "PG1: the grid round differs from the stitched dense run")
            k = cfg["grid_particles"]
            ses = [math.sqrt(max(k / float(e) - 1.0, 0.0) / k) for e in esss]
            worst = max(abs(float(v) - c.exact_lml()) / se for v, se in zip(lmls, ses))
            check(worst < 5.0, f"PG1: a chain's LML {worst:.2f} SE off log N(1; 0, sqrt 2)")
            pooled = float(pooled_lml(lmls, gmesh, "chains"))
            k1_pooled, _ = k1_against_plain(ops, lmls)
            print(f"[{card}] PG1 GridSMC C={cfg['grid_chains']} x K={k}: every chain's LML within {worst:.2f} SE "
                  f"(limit 5; SE from each chain's ESS) of {c.exact_lml():.6f}; pooled LML {pooled:.6f}; one round "
                  f"(init, LML, ESS, maybe_resample resampling every chain, rejuvenate) {grid_ms:.1f} ms; equal to the "
                  "stitched dense run, bit for bit")
            print(f"[{card}] K1 == plain on the parallel path's own weights, |err| / max(1, |plain|) (tolerance 1e-5): "
                  f"PS1's shard (N={c.n_particles}) {k1_ps1:.3e}; PG1's worst of {cfg['grid_chains']} rows (N={k}) "
                  f"{k1_pg1:.3e}; the pooled chain LMLs (N={cfg['grid_chains']}) {k1_pooled:.3e}")
            del gcol, gblocks

            # PC1: logreg HMC chains against the dense run from the fork.
            h = logreg.BenchConfig()
            X, ys = h.data(dev)
            cmesh = particle_mesh(axis_name="chains", device_type=dev)
            traces = logreg.init_chains(torch.Generator(device=dev).manual_seed(43), X, ys, h.n_chains)
            req = HMC(gx.Selection.at["w"], h.eps, L=h.L)
            rng, rng_ref = twin(44)
            finals, accs = sharded_mh_chains(rng, traces, req, h.n_steps, cmesh)
            d_finals, d_accs = run_chains(fork(rng_ref, 1)[0], traces, req, h.n_steps)
            check(torch.equal(finals.get_choices()["w"], d_finals.get_choices()["w"]) and torch.equal(accs, d_accs),
                  "PC1: sharded HMC chains differ from the dense run from fork(rng, 1)[0]")
            ms = alternating({"sharded": lambda: sharded_mh_chains(rng, traces, req, h.n_steps, cmesh),
                              "dense": lambda: run_chains(rng, traces, req, h.n_steps)}, cfg["timed_pairs"])
            print(f"[{card}] PC1 sharded_mh_chains, logreg HMC C={h.n_chains} N={h.n_data} D={h.dim} eps {h.eps} L={h.L} "
                  f"S={h.n_steps}: equal to the dense run from the fork, bit for bit; accept rate "
                  f"{float(accs.float().mean()):.3f}; ms per run sharded {statistics.median(ms['sharded']):.3f}, dense "
                  f"{statistics.median(ms['dense']):.3f} (medians of {cfg['timed_pairs']} alternating pairs; PERF.md "
                  f"section 5's dense run: 109.114 ms, NVIDIA H100 80GB HBM3, 700.00 W)")

            # PT1: T1's bimodal ladder.
            @gx.gen
            def bimodal():
                mu = gx.normal(0.0, 2.0) @ "mu"
                _ = gx.normal(mu * mu, 0.3) @ "y"

            btarget = gx.Target(bimodal, (), gx.ChoiceMap.kw(y=4.0))
            pt = ParallelTempering(betas=torch.tensor([1.0, 0.5, 0.25, 0.1, 0.02], device=dev),
                                   request=GaussianDrift(gx.Selection.at["mu"], 0.5), n_moves=2)
            rmesh = particle_mesh(axis_name="replicas", device_type=dev)
            collect = lambda t: t.get_choices()["mu"]  # noqa: E731
            start = gx.ChoiceMap.kw(mu=2.0)
            rng, rng_ref = twin(45)
            res = sharded_pt_run(rng, pt, btarget, cfg["pt_check_sweeps"], rmesh, collect=collect, init_constraint=start)
            _, res_ref = uncounted(ops, lambda: certify.stitched_pt(rng_ref, pt, btarget, cfg["pt_check_sweeps"], 1,
                                                                    collect=collect, init_constraint=start))
            check(torch.equal(res.perm, res_ref.perm) and torch.equal(res.collected, res_ref.collected),
                  "PT1: the short run differs from the stitched dense run")
            times, (out,) = timed_runs(lambda: sharded_pt_run(rng, pt, btarget, cfg["pt_sweeps"], rmesh, collect=collect,
                                                              init_constraint=start), 1, warm=False)
            neg = float((out.collected[cfg["pt_burn"]:] < 0.0).float().mean())
            check(0.1 < neg < 0.9 and torch.equal(torch.sort(out.perm).values.cpu(), torch.arange(5))
                  and bool((out.swap_rates > 0.0).all()),
                  f"PT1: share of cold draws below 0 {neg}, perm {out.perm.tolist()}, swap rates {out.swap_rates.tolist()}")
            print(f"[{card}] PT1 sharded_pt_run, T1's ladder (5 replicas, 1 rank), {cfg['pt_sweeps']} sweeps x 2 moves: "
                  f"{times[0] / cfg['pt_sweeps']:.3f} ms per sweep; the cold chain below 0 in {neg:.3f} of its draws "
                  f"after {cfg['pt_burn']} (both modes: bound (0.1, 0.9)); swap rates "
                  f"{', '.join(f'{v:.3f}' for v in out.swap_rates.tolist())}")

            # PV1: SVGD at SV1's width with an explicit bandwidth.
            s = SVGD_CFG
            Xs, yss = logreg.simulate_logreg_data(torch.Generator(device=dev).manual_seed(5), s["n_data"], s["dim"])[:2]
            sv_args = (logreg.logistic_regression, (Xs,), gx.ChoiceMap.kw(ys=yss), gx.Selection.at["w"])
            kw = dict(n_particles=s["n_particles"], n_steps=cfg["sv_steps"], step_size=s["step_size"],
                      bandwidth=cfg["sv_bandwidth"])
            rng, rng_ref = twin(46)

            def timed(fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                return out, 1e3 * (time.perf_counter() - t0) / cfg["sv_steps"]

            # The check's two runs are the first timed pair; the second runs
            # the other way round.
            (straces, _), sharded_ms = timed(lambda: sharded_svgd(rng, *sv_args, mesh=pmesh, **kw))
            (dtraces, _), dense_ms = timed(lambda: svgd(fork(rng_ref, 1)[0], *sv_args, **kw))
            w, wd = straces.get_choices()["w"], dtraces.get_choices()["w"]
            gap = float((w - wd).abs().max() / wd.abs().max())
            check(gap <= 1e-6, f"PV1: the sharded transport is {gap:.2e} of max |x| off the dense one (limit 1e-6)")
            dense_ms = [dense_ms, timed(lambda: svgd(rng, *sv_args, **kw))[1]]
            sharded_ms = [sharded_ms, timed(lambda: sharded_svgd(rng, *sv_args, mesh=pmesh, **kw))[1]]
            print(f"[{card}] PV1 sharded_svgd N={s['n_particles']} D={s['dim']} ({s['n_data']} data), {cfg['sv_steps']} "
                  f"steps, bandwidth {cfg['sv_bandwidth']}: {gap:.2e} of max |x| from the dense svgd (limit 1e-6); ms per "
                  f"step sharded {', '.join(f'{v:.3f}' for v in sharded_ms)}, dense "
                  f"{', '.join(f'{v:.3f}' for v in dense_ms)} (2 pairs, the first with the first run's set-up; SV1 "
                  f"2.05-4.14 ms)")
            stats = C.stats()
            phase_parallel_warmup_data(gx, ops, card, cmesh, twin)
        finally:
            dist.destroy_process_group()
    print(f"[{card}] the collectives of the one-rank phases (NCCL): " + "; ".join(
        f"{axis}: " + ", ".join(f"{k} {v['calls']} calls {v['bytes']} B" for k, v in kinds.items() if v["calls"])
        for axis, kinds in stats.items()))

    # The dry runs spawn their ranks; both run at once, on the one card.
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cfg["dryrun_ranks"])) as pool:
        runs = {n: pool.submit(dryrun_multichip, n, dev) for n in cfg["dryrun_ranks"]}
        runs = {n: f.result() for n, f in runs.items()}
    for n, results in runs.items():
        for r in results:
            print(f"[{card}] dryrun_multichip({n}) rank {r['rank']}: " + "; ".join(
                f"{section}: " + ", ".join(f"{axis} " + " ".join(f"{k} {v['calls']}x{v['bytes']}B"
                                                               for k, v in kinds.items() if v["calls"])
                                           for axis, kinds in st.items())
                for section, st in r["stats"].items()))
    print(f"[{card}] dryrun_multichip at {', '.join(map(str, runs))} ranks, at once: {time.perf_counter() - t0:.1f} s")
    print(f"[{card}] phase_parallel wall: {time.perf_counter() - t_phase:.1f} s")


def warmup_against_dense(label: str, got, ref) -> str:
    """A sharded `warmup_chains` result against the plain dense one at
    JAX's test tolerances (`WARMUP_TOLERANCE`): eps, every inverse-mass
    entry and the accept rate."""
    gaps = {"log eps": abs(math.log(float(got.eps)) - math.log(float(ref.eps))),
            "log inv_mass": max(float((torch.log(a) - torch.log(b)).abs().max())
                                for a, b in zip(torch.utils._pytree.tree_leaves(got.inv_mass),
                                                torch.utils._pytree.tree_leaves(ref.inv_mass))),
            "accept": abs(float(got.accept_rate) - float(ref.accept_rate))}
    for k, v in gaps.items():
        check(v < WARMUP_TOLERANCE[k], f"{label}: |d {k}| {v} against the dense warmup (limit {WARMUP_TOLERANCE[k]})")
    return ", ".join(f"|d {k}| {v:.4f} (limit {WARMUP_TOLERANCE[k]})" for k, v in gaps.items())


def timed_ms(fn) -> tuple:
    """`(fn(), host-clock ms)` between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def collective_line(stats: dict) -> str:
    return "; ".join(f"{axis}: " + ", ".join(f"{k} {v['calls']} calls {v['bytes']} B" for k, v in kinds.items()
                                             if v["calls"]) for axis, kinds in stats.items())


def phase_parallel_warmup_data(gx, ops, card: str, cmesh, twin) -> None:
    """W1, W2, D1 and D2 at one NCCL rank (the process group of
    `phase_parallel`): the warmups over the chain axis `cmesh` against the
    stitched dense warmup (each entry within 1e-5 relative; whether bit for
    bit is printed) and against the plain dense warmup at JAX's
    tolerances, then the data-sharded likelihoods against the dense model
    from the same generator, with their collectives. The dense sides' K1
    launches are not counted on the path."""
    from genjax_tpu_torch import profiling
    from genjax_tpu_torch.inference import chees
    from genjax_tpu_torch.inference.adaptation import warmup_chains
    from genjax_tpu_torch.inference.mcmc import run_chains, share_chain_args
    from genjax_tpu_torch.inference.requests import HMC
    from genjax_tpu_torch.models import logreg
    from genjax_tpu_torch.parallel import certify, particle_mesh
    from genjax_tpu_torch.parallel import collectives as C
    from genjax_tpu_torch.parallel.data import data_sharded
    from genjax_tpu_torch.parallel.launch import launch

    cfg, dev = PARALLEL_CFG, "cuda"
    t_sec = time.perf_counter()

    def against_stitched(label: str, res, ref, warmed, ref_warmed) -> str:
        got, want = certify.warmup_numbers(res), certify.warmup_numbers(ref)
        gap = certify.warmup_gap(got, want)
        check(gap <= 1e-5, f"{label}: {gap:.2e} (relative) off the stitched dense warmup (limit 1e-5)")
        same = certify.warmup_equal(got, want) and all(
            torch.equal(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(warmed.get_choices()),
                                              torch.utils._pytree.tree_leaves(ref_warmed.get_choices())))
        return "bit for bit" if same else f"within {gap:.2e} relative"

    # W1: warmup_chains on logreg at config 4's width, the chains over the mesh.
    h = logreg.BenchConfig()
    X, ys = h.data(dev)
    traces = logreg.init_chains(torch.Generator(device=dev).manual_seed(47), X, ys, h.n_chains)
    sel = gx.Selection.at["w"]
    kw = dict(n_steps=cfg["warmup_steps"], L=cfg["warmup_L"])
    rng, rng_ref = twin(48)
    C.reset_stats()
    (warmed, res), w1_sharded = timed_ms(lambda: warmup_chains(rng, traces, sel, mesh=cmesh, **kw))
    w1_stats = C.stats()
    ref_blocks, ref = certify.stitched_warmup(rng_ref, [traces], sel, cfg["warmup_steps"], L=cfg["warmup_L"])
    w1_stitched = against_stitched("W1", res, ref, warmed, ref_blocks[0])
    (_, dense), w1_dense = timed_ms(lambda: warmup_chains(torch.Generator(device=dev).manual_seed(48), traces, sel, **kw))
    w1_jax = warmup_against_dense("W1", res, dense)
    w1_dense = [w1_dense, timed_ms(lambda: warmup_chains(rng, traces, sel, **kw))[1]]
    w1_sharded = [w1_sharded, timed_ms(lambda: warmup_chains(rng, traces, sel, mesh=cmesh, **kw))[1]]
    steps = cfg["warmup_steps"]
    print(f"[{card}] W1 warmup_chains over the chain axis (1 rank, nccl), logreg HMC C={h.n_chains} N={h.n_data} "
          f"D={h.dim} L={cfg['warmup_L']}, {steps} steps: eps {float(res.eps):.5f}, accept {float(res.accept_rate):.4f}; "
          f"equal to the stitched dense warmup {w1_stitched} (limit 1e-5 relative on eps and every inverse-mass "
          f"entry); against the plain dense warmup: {w1_jax}; ms per warmup step sharded "
          f"{', '.join(f'{v / steps:.4f}' for v in w1_sharded)}, dense {', '.join(f'{v / steps:.4f}' for v in w1_dense)} "
          f"(runs in the order sharded, dense, dense, sharded); collectives {collective_line(w1_stats)}")
    del warmed, ref_blocks, traces

    # W2: chees_warmup on eight schools at H1's width and cap.
    n_c, steps = cfg["chees_chains"], cfg["chees_steps"]
    start, ssel = certify.eight_schools_start(49, n_c, dev)
    rng, rng_ref = twin(50)
    leap0 = chees.chees_stats["leapfrog_total"]
    (warmed, res), w2_sharded = timed_ms(lambda: chees.chees_warmup(rng, start, ssel, n_steps=steps, mesh=cmesh))
    w2_leapfrogs = (chees.chees_stats["leapfrog_total"] - leap0) / steps
    ref_blocks, ref = certify.stitched_chees(rng_ref, [start], ssel, steps)
    w2_stitched = against_stitched("W2", res, ref, warmed, ref_blocks[0])
    syncs = count_syncs(lambda: chees.chees_warmup(rng, start, ssel, n_steps=SCHOOLS_SYNC_STEPS, mesh=cmesh))
    check(syncs == SCHOOLS_SYNC_STEPS, f"W2: {syncs} syncs over {SCHOOLS_SYNC_STEPS} sharded ChEES steps (1 per step)")
    del warmed, ref_blocks, start
    # Against the plain dense warmup: a sharded run draws its chains from
    # its fork, so it and the dense run are independent draws, and one
    # 64-chain ChEES warmup spreads wider than JAX's same-key tolerances
    # (log T most). The means over independent
    # pairs, each a sharded and a dense warmup from one start, are held to
    # them; the pairs run on gloo ranks sharing the card, each rank with a
    # chain axis of its own.
    n_pairs, n_ranks = cfg["chees_pairs"], cfg["chees_pair_ranks"]
    t_pairs = time.perf_counter()
    seeds = list(range(3000, 3000 + n_pairs))
    pairs = [p for r in launch(certify.chees_pairs_rank_body, n_ranks, backend="gloo", device=dev, timeout=600,
                               args=(seeds, n_c, steps, 1024, dev)) for p in r]
    t_pairs = time.perf_counter() - t_pairs
    gaps = {}
    for key, limit in WARMUP_TOLERANCE.items():
        if key == "log inv_mass":
            diffs = [[a - b for a, b in zip(p["sharded"][key], p["dense"][key])] for p in pairs]
            per_entry = [[d[i] for d in diffs] for i in range(len(diffs[0]))]
            mean, se = max(((abs(statistics.fmean(e)), statistics.stdev(e) / math.sqrt(n_pairs)) for e in per_entry))
        else:
            diff = [p["sharded"][key] - p["dense"][key] for p in pairs]
            mean, se = abs(statistics.fmean(diff)), statistics.stdev(diff) / math.sqrt(n_pairs)
        check(mean < limit, f"W2: the mean |d {key}| over {n_pairs} pairs is {mean} against the dense warmups (limit "
                            f"{limit}; SE {se})")
        gaps[key] = (mean, se, limit)

    def pair_mean(kind: str, key: str) -> float:
        return statistics.fmean(p[kind][key] for p in pairs)

    pair_ms = {kind: 1e3 * pair_mean(kind, "seconds") / steps for kind in ("sharded", "dense")}
    print(f"[{card}] W2 chees_warmup over the chain axis (1 rank, nccl), eight schools, {n_c} chains, {steps} steps, "
          f"max_leapfrog 1024 (H1's): eps {float(res.eps):.5f}, T {float(res.trajectory_length):.4f}, accept "
          f"{float(res.accept_rate):.4f}; equal to the stitched dense warmup {w2_stitched}; {w2_sharded / steps:.3f} ms "
          f"per ChEES step at {w2_leapfrogs:.2f} leapfrog steps per step; {syncs / SCHOOLS_SYNC_STEPS:.0f} sync per "
          f"step (over {SCHOOLS_SYNC_STEPS})")
    print(f"[{card}] W2 against the plain dense warmup: {n_pairs} independent pairs (a sharded warmup over a one-rank "
          f"chain axis and a dense one from the same start, seeds {seeds[0]}-{seeds[-1]}) on {n_ranks} gloo ranks "
          f"sharing the card, {t_pairs:.1f} s; mean difference sharded - dense, |mean| (SE; JAX's limit): " + ", ".join(
              f"{k} {m:.4f} ({se:.4f}; {lim})" for k, (m, se, lim) in gaps.items())
          + " (log inv_mass: the widest entry); mean over the pairs, sharded and dense: log T "
          f"{pair_mean('sharded', 'log T'):.4f}, {pair_mean('dense', 'log T'):.4f}; leapfrog steps per ChEES step "
          f"{pair_mean('sharded', 'leapfrogs'):.3f}, {pair_mean('dense', 'leapfrogs'):.3f} (largest "
          f"{max(p['sharded']['leapfrogs'] for p in pairs):.2f}, {max(p['dense']['leapfrogs'] for p in pairs):.2f}); "
          f"ms per ChEES step {pair_ms['sharded']:.3f}, {pair_ms['dense']:.3f} ({n_ranks} processes on the card, each "
          "pair's sharded run first)")

    # D1: logreg HMC with the data over a "data" axis, against the dense run.
    dmesh = particle_mesh(axis_name="data", device_type=dev)
    model = data_sharded(logreg.logistic_regression, dmesh, ["ys"], data_args=(0,))
    init = 51
    start = share_chain_args(model.importance(torch.Generator(device=dev).manual_seed(init), gx.ChoiceMap.kw(ys=ys),
                                              (X,), n=h.n_chains)[0], (X,))
    dense_start = logreg.init_chains(torch.Generator(device=dev).manual_seed(init), X, ys, h.n_chains)
    req = HMC(sel, h.eps, L=h.L)
    rng, rng_ref = twin(52)
    C.reset_stats()
    finals, accs = run_chains(rng, start, req, h.n_steps)
    d1_stats = C.stats()
    d_finals, d_accs = run_chains(rng_ref, dense_start, req, h.n_steps)
    score, d_score = finals.get_score(), d_finals.get_score()
    gap = float(((score - d_score).abs() / d_score.abs()).max())
    w, wd = finals.get_choices()["w"], d_finals.get_choices()["w"]
    w_gap = float(((w - wd).abs() / wd.abs().clamp(min=1.0)).max())
    check(gap <= 1e-5 and w_gap <= 1e-5 and torch.equal(accs, d_accs),
          f"D1: scores {gap:.2e} and w {w_gap:.2e} (relative) off the dense run (limit 1e-5)")
    per_step = h.L + 1
    limit = h.n_chains * h.dim * 4
    ar = d1_stats["data"]["all_reduce"]
    others = {k: v for k, v in d1_stats["data"].items() if k != "all_reduce" and v["calls"]}
    check(set(d1_stats) == {"data"} and not others and ar["calls"] == h.n_steps * (2 * per_step + 1)
          and ar["bytes"] == h.n_steps * ((per_step + 1) * h.n_chains * 4 + per_step * limit),
          f"D1: the collectives are not one score (C floats) per density pass and one gradient (C x D) per backward: "
          f"{d1_stats}")
    ms = alternating({"sharded": lambda: run_chains(rng, start, req, h.n_steps),
                      "dense": lambda: run_chains(rng, dense_start, req, h.n_steps)}, cfg["data_pairs"])
    print(f"[{card}] D1 data-sharded logreg HMC (1 rank, nccl), C={h.n_chains} N={h.n_data} D={h.dim} eps {h.eps} "
          f"L={h.L} S={h.n_steps}: scores {gap:.2e}, w {w_gap:.2e} (relative) from the dense run from the same "
          f"generator (limit 1e-5), accept flags equal; collectives per HMC step {ar['calls'] / h.n_steps:.0f} "
          f"all-reduces, {ar['bytes'] / h.n_steps:.0f} B, the largest {limit} B = C D 4 (a gradient), no all-gather; "
          f"ms per run sharded {statistics.median(ms['sharded']):.3f}, dense {statistics.median(ms['dense']):.3f} "
          f"(medians of {cfg['data_pairs']} alternating pairs)")
    print_profile(card, "D1 data-sharded HMC run (per HMC step)",
                  profiling.trace(lambda: run_chains(rng, start, req, h.n_steps), h.n_steps))
    print_profile(card, "D1's dense HMC run, same process (per HMC step)",
                  profiling.trace(lambda: run_chains(rng, dense_start, req, h.n_steps), h.n_steps))
    del start, dense_start, finals, d_finals

    # D2: data-sharded importance from the prior at K=1M, the LML through K1.
    k = cfg["data_particles"]
    rng, rng_ref = twin(53)
    C.reset_stats()
    (lml, lw), d2_ms = timed_ms(lambda: (lambda lw: (ops.logsumexp(lw) - math.log(k), lw))(
        model.importance(rng, gx.ChoiceMap.kw(ys=ys), (X,), n=k)[1]))
    d2_stats = C.stats()
    (ref_lml, ref_lw), d2_dense_ms = timed_ms(lambda: uncounted(ops, lambda: (lambda lw: (
        ops.logsumexp(lw) - math.log(k), lw))(logreg.logistic_regression.importance(
            rng_ref, gx.ChoiceMap.kw(ys=ys), (X,), n=k)[1])))
    lml_gap = abs(float(lml) - float(ref_lml)) / max(1.0, abs(float(ref_lml)))
    check(lml_gap <= 1e-5, f"D2: the data-sharded LML {float(lml)} against the dense {float(ref_lml)} (limit 1e-5)")
    k1_d2, _ = k1_against_plain(ops, lw)
    check(k1_d2 <= 1e-6, f"D2: K1 {k1_d2:.2e} of max(1, |plain|) off its plain twin on the weights (limit 1e-6)")
    ar = d2_stats["data"]["all_reduce"]
    print(f"[{card}] D2 data-sharded importance of logreg from the prior (1 rank, nccl), K={k} N={h.n_data} D={h.dim}: "
          f"LML {float(lml):.6f}, {lml_gap:.2e} (relative) from the dense importance from the same generator (limit "
          f"1e-5); K1 on the all-reduced weights {k1_d2:.3e} of max(1, |plain|) from its plain twin (limit 1e-6); "
          f"{ar['calls']} all-reduce of {ar['bytes']} B (the weights); ms sharded {d2_ms:.3f}, dense {d2_dense_ms:.3f} "
          f"(one run each, the first)")
    del lw, ref_lw
    print(f"[{card}] W1-D2 wall: {time.perf_counter() - t_sec:.1f} s")


def cost_line(card: str, label: str, steps: int, on: list, off: list, per_run: int) -> None:
    """Print the checks' cost on one path from alternating runs with the
    checks on and off (ms per run) and the wrapped calls of one run."""
    a, b = statistics.median(on), statistics.median(off)
    print(f"[{card}] C2 cost of the checks, {label}: on {a / steps:.4f} ms/step, off {b / steps:.4f} ms/step "
          f"(medians of {len(on)} alternating runs; on/off {a / b:.4f}); {per_run / steps:.2f} wrapped calls per "
          f"step, {1e3 * (a - b) / max(per_run, 1):.3f} us per wrapped call (on - off over the calls); runs on: "
          f"{', '.join(f'{x:.2f}' for x in on)}; off: {', '.join(f'{x:.2f}' for x in off)} ms")


def _in_checked_mode(gx, fn):
    with gx.checked_mode():
        return fn()


def _typecheck_off(gx, fn):
    gx.do_typecheck(False)
    try:
        return fn()
    finally:
        gx.do_typecheck(True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import genjax_tpu_torch as gx
    from genjax_tpu_torch import ops
    from genjax_tpu_torch.lang import analysis
    from genjax_tpu_torch.ops import _build

    t_smoke = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.library_path("logsumexp")
    _build.load_library("logsumexp")
    print(f"built {lib.name} from genjax_tpu_torch/csrc/logsumexp.cu in {time.perf_counter() - t0:.2f} s")

    kernels = phase_kernel(ops, card)
    backward = phase_kernel_backward(ops, card)

    # The main paths, each with every launch count set to 0 just before it
    # and read just after.
    # And the edit plan's record of each path: analyses, cache hits, and
    # the edits that fell back to the dense plan, by reason.
    plans = []

    def drive(phase) -> dict:
        ops.fused_logsumexp.launches = ops.fused_logsumexp_ess.launches = 0
        before = analysis.stats()
        phase()
        after = analysis.stats()
        plans.append({
            "analyses": after["analyses"] - before["analyses"], "hits": after["hits"] - before["hits"],
            "fallbacks": {r: n - before["fallbacks"].get(r, 0) for r, n in after["fallbacks"].items()
                          if n > before["fallbacks"].get(r, 0)},
        })
        return {"logsumexp": ops.fused_logsumexp.launches, "logsumexp_ess": ops.fused_logsumexp_ess.launches}

    paths = {
        "particle": drive(lambda: (phase_sir(gx, ops, card), phase_filter(ops, card))),
        "mcmc": drive(lambda: (phase_hmc(gx, card), phase_polyreg(gx, ops, card))),
        "combinator": drive(lambda: (phase_hmm_scan(gx, ops, card), phase_logreg_vmap(gx, card), phase_repeat(gx))),
        "branching": drive(lambda: phase_branching(gx, ops, card)),
        "smc": drive(lambda: phase_smc(gx, ops, card)),
    }
    vi_grad_err = []
    paths["vi"] = drive(lambda: vi_grad_err.append(phase_vi(gx, ops, card)))
    paths["library"] = drive(lambda: phase_library(gx, ops, card))
    # No module of the samplers' path reduces a 1-D weight vector: it
    # launches no K1, and its counts are read and reported, not required.
    paths["samplers"] = drive(lambda: phase_samplers(gx, card))
    paths["algorithms"] = drive(lambda: phase_algorithms(gx, ops, card))
    t_aux = time.perf_counter()
    paths["aux"] = drive(lambda: phase_aux(gx, ops, card))
    print(f"[{card}] phase_aux wall: {time.perf_counter() - t_aux:.1f} s")
    paths["incremental"] = drive(lambda: phase_incremental(gx, ops, card))
    paths["parallel"] = drive(lambda: phase_parallel(gx, ops, card))
    backward["grad_max_abs_err"] = max(backward["grad_max_abs_err"], *vi_grad_err)
    launches = {name: sum(p[name] for p in paths.values()) for name in ("logsumexp", "logsumexp_ess")}
    for name, count in paths["particle"].items():
        check(count > 0, f"the particle path launched no {name} kernel")
    check(paths["mcmc"]["logsumexp"] > 0, "the MCMC path (polyreg) launched no logsumexp kernel")
    check(paths["combinator"]["logsumexp"] > 0, "the combinator path (the HMM unfold) launched no logsumexp kernel")
    check(paths["branching"]["logsumexp"] > 0, "the branching path (mixture SIR) launched no logsumexp kernel")
    for name, count in paths["smc"].items():
        check(count > 0, f"the SMC path launched no {name} kernel")
    check(paths["vi"]["logsumexp"] > 0, "the VI path (ELBO, IWELBO, the guided LML) launched no logsumexp kernel")
    for name, count in paths["library"].items():
        check(count > 0, f"the library path (the SV filter, PMMH, particle Gibbs) launched no {name} kernel")
    for name, count in paths["algorithms"].items():
        check(count > 0, f"the last six algorithms' path (SMC², the RBPF, ABC-SMC) launched no {name} kernel")
    for name, count in paths["aux"].items():
        check(count > 0, f"the auxiliary layer's path (the resumed SMC state, SIR, time travel) launched no {name} kernel")
    check(paths["incremental"]["logsumexp"] > 0, "the incremental edits' path (I2's LML) launched no logsumexp kernel")
    check(paths["parallel"]["logsumexp_ess"] > 0, "the parallel path (the sharded LML and ESS) launched no logsumexp_ess kernel")
    check(paths["parallel"]["logsumexp"] > 0, "the parallel path (D2's data-sharded LML) launched no logsumexp kernel")
    print("kernel launches on the main paths: " + ", ".join(
        f"{name} {count} (" + ", ".join(f"{path} path {p[name]}" for path, p in paths.items()) + ")"
        for name, count in launches.items()))
    print("the edit plan on the main paths: " + "; ".join(f"{path} path {p}" for path, p in zip(paths, plans)))
    print(f"[{card}] smoke total wall: {time.perf_counter() - t_smoke:.1f} s")

    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "genjax_tpu_torch/csrc/logsumexp.cu",
        "replaces": "genjax_tpu/ops/logsumexp.py:21",
        "launches": launches[name],
        **record,
        **(backward if name == "logsumexp" else {}),
    } for name, record in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
