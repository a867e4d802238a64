"""Plain reference of the nonlinear state-space model and its bootstrap
particle filter, its control, its work counts, the maker of the cell's
observations, and the judge of the cell's outputs.

Model: `z_0 ~ N(0, 1)`, `z_t ~ N(a z_{t-1} + s sin z_{t-1}, q)`,
`y_t ~ N(z_t, r)`, with `a, s, q, r` from the configuration file (0.9,
0.5, 0.5, 0.4). The filter proposes from the transition, weighs by the
observation's density, and resamples systematically when the effective
sample size falls under `ess_threshold * K`; the log marginal likelihood
telescopes over the resampling steps, and one final resample leaves the
returned states equally weighted.

Plain torch only: this file imports nothing of the program under test.
The judge runs this filter in float64, with a generator of its own, on the
observations both sides were handed, and compares the distribution of the
program's answers with its own.
"""

import math

import torch

# Each limit lies between the largest reading of sound runs over a dozen
# seeds or more and the smallest reading of the control (this reference
# computed in bfloat16, `Control`), on the card at the cell's own size.
# PERF.md gives the readings each was set from.
LIMITS = {
    "lml_z": 8.0,
    "state_chi2": 2.0,
    "distinct_gap": 0.1,
    "resample_gap": 2.0,
}

REFERENCE_RUNS = 6  # float64 filters per observation sequence
MIN_PER_BIN = 64  # reference states per bin of the two-sample chi-square, at least


def make_inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """`traffic["datasets"]` observation sequences of `traffic["steps"]`
    steps, simulated from the model by the equations above in float32 on
    `device`, from a generator seeded with `seed`."""
    d, steps = traffic["datasets"], traffic["steps"]
    g = torch.Generator(device=device).manual_seed(seed)
    z = config["init_scale"] * torch.randn(d, generator=g, device=device)
    ys = []
    for t in range(steps):
        if t:
            z = _transition(config, z) + config["trans_noise"] * torch.randn(d, generator=g, device=device)
        ys.append(z + config["obs_noise"] * torch.randn(d, generator=g, device=device))
    return {"observations": torch.stack(ys, dim=1).contiguous()}


def _transition(config: dict, z: torch.Tensor) -> torch.Tensor:
    return config["trans_coef"] * z + config["sin_coef"] * torch.sin(z)


def log_normal(x: torch.Tensor, loc, scale: float) -> torch.Tensor:
    u = (x - loc) / scale
    return -0.5 * u * u - (math.log(scale) + 0.5 * math.log(2.0 * math.pi))


def systematic_ancestors(gen: torch.Generator, log_w: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Output slot j copies the first particle whose normalized cumulative
    weight reaches `(j + u) / K`, u one uniform draw."""
    n = log_w.shape[0]
    cdf = torch.cumsum(torch.exp(log_w - lse), 0)
    cdf = cdf / cdf[-1]
    u = torch.rand((), generator=gen, dtype=log_w.dtype, device=log_w.device)
    positions = (torch.arange(n, dtype=log_w.dtype, device=log_w.device) + u) / n
    return torch.clamp(torch.searchsorted(cdf, positions), max=n - 1)


def bootstrap_filter(config: dict, gen: torch.Generator, ys: torch.Tensor, n: int, dtype=torch.float64):
    """One filter of the observations `ys` with `n` particles, every float
    in `dtype`. Returns `(lml, final states, resamples)`, the last counting
    the gate's resamples and not the final one."""
    dev, thr = ys.device, config["ess_threshold"] * n
    ys = ys.to(dtype)
    log_n = math.log(n)
    z = config["init_scale"] * torch.randn(n, generator=gen, dtype=dtype, device=dev)
    log_w = log_normal(ys[0], z, config["obs_noise"])
    lml = torch.zeros((), dtype=dtype, device=dev)
    resamples = 0
    for t in range(1, ys.shape[0]):
        z = _transition(config, z) + config["trans_noise"] * torch.randn(n, generator=gen, dtype=dtype, device=dev)
        log_w = log_w + log_normal(ys[t], z, config["obs_noise"])
        lse = torch.logsumexp(log_w, 0)
        ess = torch.exp(2.0 * lse - torch.logsumexp(2.0 * log_w, 0))
        if float(ess) < thr:
            lml = lml + (lse - log_n)
            z = z[systematic_ancestors(gen, log_w, lse)]
            log_w = torch.zeros_like(log_w)
            resamples += 1
    lse = torch.logsumexp(log_w, 0)
    lml = lml + (lse - log_n)
    return float(lml), z[systematic_ancestors(gen, log_w, lse)], resamples


def inflation(x: torch.Tensor) -> float:
    """`sum m^2 / sum m` over the multiplicities m of `x`'s distinct values:
    how much repeated particles widen a bin's count beyond a sample of
    distinct draws."""
    m = torch.unique(x, return_counts=True)[1].double()
    return float((m * m).sum() / m.sum())


def two_sample_chi2(a: torch.Tensor, b: torch.Tensor) -> float:
    """Chi-square per degree of freedom between two samples of one size, in
    bins of about `sqrt(K)` of `b`'s values each, over `b`'s own inflation
    (the repeats resampling leaves): about 1 where `a` is drawn as `b` is.
    A sample shifted by a fraction of the spread reads the higher the more
    particles there are; the bins are narrower than bfloat16's steps, so a
    sample rounded to that grid leaves most of them empty."""
    per_bin = max(MIN_PER_BIN, math.isqrt(b.numel()))
    a, b = a.double(), b.double()
    if not bool(torch.isfinite(a).all()):
        return math.inf
    edges = torch.unique_consecutive(torch.sort(b).values[per_bin::per_bin])
    bins = edges.numel() + 1
    ca = torch.bincount(torch.bucketize(a, edges), minlength=bins).double()
    cb = torch.bincount(torch.bucketize(b, edges), minlength=bins).double()
    used = (ca + cb) > 0
    stat = ((ca - cb) ** 2 / torch.clamp(ca + cb, min=1.0))[used].sum()
    return float(stat) / max(1, int(used.sum()) - 1) / inflation(b)


def distinct_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """`|log(distinct values of a / distinct values of b)|`, both as float32
    (the configuration's precision): after resampling, how many distinct
    particles survive. Systematic resampling of the same weights keeps
    about as many in every run; fewer show a batch left out or states
    rounded to a coarser grid."""
    na = torch.unique(a.float()).numel()
    nb = torch.unique(b.float()).numel()
    return abs(math.log(na / nb))


def judge(config: dict, traffic: dict, inputs: dict, calls: list, kept: list, seed: int, device):
    """The numbers compared, and the facts the per-layer readers may use.
    Every call brings its sequence, its LML and the number of times its
    ESS gate fired (`calls`).

    `REFERENCE_RUNS` float64 filters of each observation sequence, then:

    - `lml_z`: for each sequence, the distance between the mean LML of
      the program's calls on it and the reference's, in standard errors
      (pooled variance of both samples); the worst sequence.
    - `resample_gap`: for each sequence, the distance between the mean
      number of the gate's resamples in the program's calls on it and in
      the reference's filters; the worst sequence.
    - `state_chi2`: each kept call's final states against the first
      reference filter's of its sequence (`two_sample_chi2`); the worst.
    - `distinct_gap`: the same pairs, by `distinct_gap`; the worst.
    """
    ys, n = inputs["observations"], traffic["particles"]
    gen = torch.Generator(device=device).manual_seed(seed)
    ref_lml, ref_states, ref_resamples = {}, {}, {}
    for d in range(ys.shape[0]):
        runs = [bootstrap_filter(config, gen, ys[d], n) for _ in range(REFERENCE_RUNS)]
        ref_lml[d] = [r[0] for r in runs]
        ref_states[d] = runs[0][1]
        ref_resamples[d] = [r[2] for r in runs]
    lml_z = resample_gap = 0.0
    for d, refs in ref_lml.items():
        prog = [(lml, resamples) for (dataset, resamples), lml in calls if dataset == d]
        if prog:  # a window shorter than the sequences has none on some
            lml_z = max(lml_z, _pooled_z([lml for lml, _ in prog], refs))
            gap = abs(_mean([r for _, r in prog]) - _mean(ref_resamples[d]))
            resample_gap = max(resample_gap, gap)
    worst = {"lml_z": lml_z, "state_chi2": 0.0, "distinct_gap": 0.0, "resample_gap": resample_gap}
    for rec in kept:
        ref_final = ref_states[rec["dataset"]]
        worst["state_chi2"] = max(worst["state_chi2"], two_sample_chi2(rec["states"], ref_final))
        worst["distinct_gap"] = max(worst["distinct_gap"], distinct_gap(rec["states"], ref_final))
    checks = [{"name": name, "value": worst[name], "limit": LIMITS[name]} for name in LIMITS]
    facts = {
        "kept_calls": len(kept),
        "reference_resamples_per_filter": _mean([r for runs in ref_resamples.values() for r in runs]),
    }
    if calls:
        facts["program_resamples_per_filter"] = _mean([r for (_, r), _ in calls])
    return checks, facts


def _mean(xs: list) -> float:
    return sum(xs) / len(xs)


def _pooled_z(a: list, b: list) -> float:
    """|mean a - mean b| over its standard error, from the pooled variance."""
    if len(a) + len(b) < 3 or not all(math.isfinite(x) for x in a):
        return math.inf
    ma, mb = sum(a) / len(a), sum(b) / len(b)
    ss = sum((x - ma) ** 2 for x in a) + sum((x - mb) ** 2 for x in b)
    var = ss / (len(a) + len(b) - 2)
    se = math.sqrt(var * (1.0 / len(a) + 1.0 / len(b)))
    return abs(ma - mb) / se if se > 0 else (0.0 if ma == mb else math.inf)


class Control:
    """This reference in the program's place, computed in bfloat16 (the
    precision below the configuration's float32), in the program's output
    records."""

    def __init__(self, config: dict, traffic: dict, inputs: dict, seed: int, device):
        self.config, self.n = config, traffic["particles"]
        self.ys = inputs["observations"]
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def call(self, i: int):
        d = i % self.ys.shape[0]
        lml, states, resamples = bootstrap_filter(self.config, self.gen, self.ys[d], self.n, torch.bfloat16)
        return {"lml": lml, "states": states, "dataset": d, "resamples": resamples}, lml

    def small(self, out):
        return out["dataset"], out["resamples"]

    def record(self, out):
        return out


# Bytes per particle: the initial step writes its state and weight; each
# later step reads and writes both (float32); each resample, the gate's
# and the final one, writes one ancestor index (int32) and copies one row
# (read and written).
INIT_BYTES, STEP_BYTES, RESAMPLE_BYTES = 8, 16, 12
# Floating-point operations per particle: the initial draw and density;
# each step's transition (sin, two multiplies, two adds, the noise's scale
# and add), density (subtract, divide, square, add), weight update, and the
# log-sum-exp and ESS (subtract, exp, add, square, add); each resample's
# normalized cumulative weight and position (exp, add, divide).
INIT_FLOPS, STEP_FLOPS, RESAMPLE_FLOPS = 6, 7 + 4 + 1 + 5, 3


def work(config: dict, traffic: dict, facts: dict) -> dict:
    """What one filter must do, whatever implements it. The resamples are
    what these observations need: the reference's gate count on the same
    sequences, plus the final resample."""
    n, steps = traffic["particles"], traffic["steps"]
    resamples = facts.get("reference_resamples_per_filter")
    out = {
        "units_per_call": n * steps,
        "k1_bytes": {"lse": 4 * n + 4, "lse_ess": 4 * n + 8},
    }
    if resamples is not None:
        r = resamples + 1
        out["flops_per_call"] = n * (INIT_FLOPS + STEP_FLOPS * (steps - 1) + RESAMPLE_FLOPS * r)
        out["bytes_per_call"] = n * (INIT_BYTES + STEP_BYTES * (steps - 1) + RESAMPLE_BYTES * r)
    return out
