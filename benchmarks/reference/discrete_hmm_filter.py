"""Plain reference of the 64-state discrete HMM and its bootstrap particle
filter: the exact forward algorithm, a float64 filter, its control, its
work counts, the maker of the cell's observations, and the judge of the
cell's outputs.

Model (GenJAX's discrete-HMM exact-inference testbed): `N` states on a
circle; the transition and observation logits of states `i` and `j` are
`eps^d` where their distance around the circle `d` is at most `k`, else
`-1 / sigma`, with `eps = sigma` (both tables: `k` 2, `sigma` 0.5);
`z_1 ~ categorical(trans[z_0])` from the first state `z_0`,
`z_t ~ categorical(trans[z_{t-1}])`, `y_t ~ categorical(obs[z_t])`. The
filter proposes from the transition, weighs by the observation's
probability, and resamples systematically when the effective sample size
falls under `ess_threshold * K`; one final resample leaves the returned
states equally weighted.

The forward algorithm gives, in float64, the exact log p(y_{1:T}) and the
exact filtering marginal p(z_T | y_{1:T}): the judge holds the program's
LML and final states to those, and to this float64 filter's own readings
at the same K.

Plain torch only: this file imports nothing of the program under test.
"""

import math

import torch

# A float32 matrix product on the card may run in TF32; none may here.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Each limit lies between the largest reading of sound runs over a dozen
# seeds or more and the smallest reading of the control (this reference
# computed in bfloat16, `Control`), on the card at the cell's own size.
# PERF.md gives the readings each was set from.
LIMITS = {
    # Standard errors of the program's own calls: a sound run's worst of
    # eight sequences is the largest of eight |t| values (sound 2.96 at
    # most over 21 seeds; the control 123 and up).
    "lml_z": 6.0,
    # The program's TV over the reference filter's mean TV at the same K:
    # about 1 when sound (a run's median of its six calls 0.85-1.20 over
    # 7 seeds), one call's TV spreading by 15-17% (its coefficient of
    # variation), so the worst of six reads 0.97-1.72 over 21 seeds; the
    # control 129 and up, bfloat16's CDF steps skewing the resampled
    # states.
    "state_tv": 3.0,
    # Gate firings a filter: the same observations fire the same gates.
    # Held by one fault alone: sound runs and the control both read 0, the
    # gate firing at all 49 steps in each (so would a gate that always
    # fired); a gate that never fires reads 49.
    "resample_gap": 2.0,
}

REFERENCE_RUNS = 6  # float64 filters per observation sequence


def logits(config: dict, table: str, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """The `(N, N)` banded-circulant logits of `table` ("trans" or "obs"):
    `sigma^d` within distance `k` of the diagonal around the circle, else
    `-1 / sigma`."""
    n, k, sigma = config["n_states"], config[f"adjacency_{table}"], config[f"sigma_{table}"]
    i = torch.arange(n, dtype=torch.float64, device=device)
    d = (i[:, None] - i[None, :]).abs()
    d = torch.minimum(d, n - d)
    return torch.where(d <= k, sigma**d, -1.0 / sigma).to(dtype)


def log_tables(config: dict, dtype=torch.float64, device="cpu"):
    """The transition and observation log probabilities, rows normalized
    in float64, then cast to `dtype`."""
    return tuple(torch.log_softmax(logits(config, t, device=device), -1).to(dtype) for t in ("trans", "obs"))


def forward(config: dict, ys: torch.Tensor):
    """The forward algorithm in float64: `(log p(y_{1:T}), p(z_T | y_{1:T}))`
    for the observations `ys` (`(T,)` int64), from the first state."""
    trans, obs = log_tables(config, device=ys.device)
    log_alpha = trans[config["initial_state"]] + obs[:, ys[0]]
    lml = torch.logsumexp(log_alpha, 0)
    log_alpha = log_alpha - lml
    for t in range(1, ys.shape[0]):
        post = torch.logsumexp(log_alpha[:, None] + trans, 0) + obs[:, ys[t]]
        evidence = torch.logsumexp(post, 0)
        lml, log_alpha = lml + evidence, post - evidence
    return float(lml), torch.exp(log_alpha)


def offsets(gen: torch.Generator, row: torch.Tensor, n: int) -> torch.Tensor:
    """`n` draws of a circular offset from the log probabilities `row`
    (inverse CDF, in `row`'s dtype). The tables are circulant, so a draw
    from row `i` of one is `(i + offset) mod N`, the offset drawn from its
    row 0."""
    cdf = torch.cumsum(torch.exp(row), 0)
    u = torch.rand(n, generator=gen, dtype=row.dtype, device=row.device) * cdf[-1]
    return torch.clamp(torch.searchsorted(cdf, u), max=row.shape[0] - 1)


def step(gen: torch.Generator, z: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """One draw from row `z` of the circulant `table` for each entry of `z`."""
    return torch.remainder(z + offsets(gen, table[0], z.shape[0]), table.shape[0])


def make_inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """`traffic["datasets"]` observation sequences of `traffic["steps"]`
    steps (int64, on `device`), simulated from the model in float64 from a
    generator seeded with `seed`."""
    d, steps = traffic["datasets"], traffic["steps"]
    g = torch.Generator(device=device).manual_seed(seed)
    trans, obs = log_tables(config, device=device)
    z = torch.full((d,), config["initial_state"], dtype=torch.int64, device=device)
    ys = []
    for _ in range(steps):
        z = step(g, z, trans)
        ys.append(step(g, z, obs))
    return {"observations": torch.stack(ys, dim=1).contiguous()}


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
    trans, obs = log_tables(config, dtype, dev)
    log_n = math.log(n)
    z = step(gen, torch.full((n,), config["initial_state"], dtype=torch.int64, device=dev), trans)
    log_w = obs[z, ys[0]]
    lml = torch.zeros((), dtype=dtype, device=dev)
    resamples = 0
    for t in range(1, ys.shape[0]):
        z = step(gen, z, trans)
        log_w = log_w + obs[z, ys[t]]
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


def total_variation(states: torch.Tensor, marginal: torch.Tensor) -> float:
    """Half the L1 distance between the histogram of `states` and
    `marginal`; 1 where a state lies outside `0..N-1`."""
    n_states = marginal.shape[0]
    if bool(((states < 0) | (states >= n_states)).any()):
        return 1.0
    hist = torch.bincount(states, minlength=n_states).double() / states.numel()
    return 0.5 * float((hist - marginal.to(hist.device)).abs().sum())


def judge(config: dict, traffic: dict, inputs: dict, calls: list, kept: list, seed: int, device):
    """The numbers compared, and the facts the per-layer readers may use.
    Every call brings its sequence, its LML and the number of times its
    ESS gate fired (`calls`).

    The forward algorithm on each sequence, and `REFERENCE_RUNS` float64
    filters of it, then:

    - `lml_z`: for each sequence, the distance between the mean LML of
      the program's calls on it and the exact log p(y_{1:T}), in standard
      errors of those calls (the variance pooled over the sequences, each
      call about its own sequence's mean); the worst sequence.
    - `state_tv`: each kept call's final states against the exact
      p(z_T | y_{1:T}) in total variation, over the mean of the reference
      filters' own on that sequence; the worst.
    - `resample_gap`: for each sequence, the distance between the mean
      number of the gate's resamples in the program's calls on it and in
      the reference's filters; the worst sequence.
    """
    ys, n = inputs["observations"], traffic["particles"]
    gen = torch.Generator(device=device).manual_seed(seed)
    exact, ref_tv, ref_resamples = {}, {}, {}
    for d in range(ys.shape[0]):
        exact[d] = forward(config, ys[d])
        runs = [bootstrap_filter(config, gen, ys[d], n) for _ in range(REFERENCE_RUNS)]
        ref_tv[d] = _mean([total_variation(states, exact[d][1]) for _, states, _ in runs])
        ref_resamples[d] = [r for _, _, r in runs]
    by_seq = {d: [(lml, r) for (dataset, r), lml in calls if dataset == d] for d in exact}
    by_seq = {d: prog for d, prog in by_seq.items() if prog}  # a short window misses some
    se2 = _pooled_variance([[lml for lml, _ in prog] for prog in by_seq.values()])
    worst = {"lml_z": 0.0, "state_tv": 0.0, "resample_gap": 0.0}
    for d, prog in by_seq.items():
        worst["lml_z"] = max(worst["lml_z"], _z(_mean([lml for lml, _ in prog]) - exact[d][0], se2 / len(prog)))
        gap = abs(_mean([r for _, r in prog]) - _mean(ref_resamples[d]))
        worst["resample_gap"] = max(worst["resample_gap"], gap)
    tv_ratios = [total_variation(rec["states"], exact[rec["dataset"]][1]) / ref_tv[rec["dataset"]] for rec in kept]
    worst["state_tv"] = max(tv_ratios, default=0.0)
    checks = [{"name": name, "value": worst[name], "limit": LIMITS[name]} for name in LIMITS]
    facts = {
        "kept_calls": len(kept),
        "reference_resamples_per_filter": _mean([r for runs in ref_resamples.values() for r in runs]),
        "reference_tv": _mean(list(ref_tv.values())),
    }
    if tv_ratios:
        facts["state_tv_median"] = _median(tv_ratios)
    if calls:
        facts["program_resamples_per_filter"] = _mean([r for (_, r), _ in calls])
    return checks, facts


def _mean(xs: list) -> float:
    return sum(xs) / len(xs)


def _median(xs: list) -> float:
    s = sorted(xs)
    m = len(s) // 2
    return s[m] if len(s) % 2 else (s[m - 1] + s[m]) / 2


def _pooled_variance(groups: list) -> float:
    """The variance of values about their own group's mean, pooled over the
    groups; inf with no degree of freedom or a value not finite."""
    values = [x for g in groups for x in g]
    dof = len(values) - len(groups)
    if dof < 1 or not all(math.isfinite(x) for x in values):
        return math.inf
    return sum(sum((x - _mean(g)) ** 2 for x in g) for g in groups) / dof


def _z(gap: float, var: float) -> float:
    """|gap| over the standard error `sqrt(var)`."""
    if not math.isfinite(gap) or math.isinf(var):
        return math.inf
    return abs(gap) / math.sqrt(var) if var > 0 else (0.0 if gap == 0 else math.inf)


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


# Bytes per particle, the least a filter moves: the initial step writes
# its state (int64) and weight (float32); each later step reads and writes
# both; each resample, the gate's and the final one, writes one ancestor
# index (int32) and copies one state (read and written). The 64 x 64
# tables stay in cache and count nothing.
INIT_BYTES, STEP_BYTES, RESAMPLE_BYTES = 8 + 4, 2 * (8 + 4), 4 + 2 * 8
# Floating-point operations per category of a row: a Gumbel-argmax draw
# (the noise's log, the subtraction, the comparison) and a row's
# log-sum-exp for a score (the maximum, the subtraction, the exp, the
# sum). A step draws one state and scores it and its observation; a later
# step adds the weight update and K1's log-sum-exp and ESS (subtract, exp,
# add, square, add); a resample, its normalized cumulative weight and
# position (exp, add, divide).
DRAW_FLOPS, SCORE_FLOPS = 3, 4
WEIGHT_FLOPS, RESAMPLE_FLOPS = 1 + 5, 3


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
        site = config["n_states"] * (DRAW_FLOPS + 2 * SCORE_FLOPS)
        out["flops_per_call"] = n * (site * steps + WEIGHT_FLOPS * (steps - 1) + RESAMPLE_FLOPS * r)
        out["bytes_per_call"] = n * (INIT_BYTES + STEP_BYTES * (steps - 1) + RESAMPLE_BYTES * r)
    return out
