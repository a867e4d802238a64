"""Plain reference of beta-bernoulli SIR, its control, its work counts, and
the judge of the cell's outputs.

Model: `p ~ Beta(2, 2)`, `v ~ Bernoulli(p)`, `v = True` observed. One SIR
trial draws K particles from the prior, weighs each by the likelihood of
the observation (`log p`), estimates the log marginal likelihood
`logsumexp(w) - log K`, and draws one particle in proportion to its weight.
The exact answers: the posterior is Beta(3, 2) and the marginal likelihood
is 1/2. The drawn particle's law departs from the posterior by terms of
order 1/K.

Plain torch only: this file imports nothing of the program under test.
The judge reads the program's outputs (the particles' `p`, their weights
and scores, the LML and the drawn particle) and works out again in
float64 what each should be; the program's derived numbers are only
judged.
"""

import math

import torch

# Each limit lies between the largest reading of sound runs over a dozen
# seeds or more and the smallest reading of the control (this reference
# computed in bfloat16, `Control`), on the card at the cell's own size.
# PERF.md gives the readings each was set from.
LIMITS = {
    "beta_chi2": 1.5,
    "weight_gap": 2e-5,
    "score_gap": 5e-5,
    "lml_gap": 5e-5,
    "lml_z": 6.0,
    "draw_z": 6.0,
}

LOG6 = math.log(6.0)
MAX_BINS = 4096  # equal-probability bins of the draws' goodness of fit


def make_inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """The observation is fixed by the configuration; the seed drives only
    the draws."""
    return {"observed": bool(config["observed"])}


def beta22_cdf(p: torch.Tensor) -> torch.Tensor:
    """The Beta(2, 2) distribution function, `3 p^2 - 2 p^3`."""
    return p * p * (3.0 - 2.0 * p)


def joint_logpdf(p: torch.Tensor) -> torch.Tensor:
    """`log Beta(p; 2, 2) + log Bernoulli(True; p)`: a particle's score."""
    return LOG6 + 2.0 * torch.log(p) + torch.log1p(-p)


def beta32_cdf(p: torch.Tensor) -> torch.Tensor:
    """The Beta(3, 2) distribution function, `4 p^3 - 3 p^4`: the
    posterior's."""
    return p * p * p * (4.0 - 3.0 * p)


def chi2_dof(p: torch.Tensor, cdf) -> tuple[float, int]:
    """Pearson's chi-square of the draws `p` against the distribution `cdf`,
    and its degrees of freedom, in equal-probability bins of about 64 draws
    each: fine enough that draws rounded to a coarser grid than float32's
    leave most bins empty."""
    n = p.numel()
    bins = max(16, min(MAX_BINS, n // 64))
    if not bool(((p >= 0) & (p <= 1)).all()):  # NaN too
        return math.inf, bins - 1
    idx = torch.clamp((cdf(p.double()) * bins).long(), 0, bins - 1)
    counts = torch.bincount(idx, minlength=bins).double()
    expected = n / bins
    return float(((counts - expected) ** 2).sum() / expected), bins - 1


def beta_chi2(p: torch.Tensor) -> float:
    """The chi-square per degree of freedom of the draws `p` against
    Beta(2, 2)."""
    chi2, dof = chi2_dof(p, beta22_cdf)
    return chi2 / dof


def draw_z(drawn: torch.Tensor) -> float:
    """The chi-square of the drawn particles against the posterior Beta(3, 2)
    in standard deviations above its mean, `(chi2 - dof) / sqrt(2 dof)`:
    about N(0, 1) where the draws follow the weights, at any number of
    draws."""
    if drawn.numel() == 0:
        return math.inf
    chi2, dof = chi2_dof(drawn, beta32_cdf)
    return (chi2 - dof) / math.sqrt(2.0 * dof)


def _relative_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest `|got - ref| / max(1, |ref|)`; equal values (infinities
    too) are no gap, and a NaN is an infinite one."""
    got = got.double()
    gap = (got - ref).abs() / torch.clamp(ref.abs(), min=1.0)
    gap = torch.where(got == ref, torch.zeros_like(gap), gap)
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, math.inf), gap)
    return float(gap.max()) if gap.numel() else 0.0


def judge(config: dict, traffic: dict, inputs: dict, calls: list, kept: list, seed: int, device):
    """The numbers compared, each the worst over what it covers, and the
    facts the per-layer readers may use.

    - `beta_chi2`: each kept call's K draws against Beta(2, 2).
    - `weight_gap`: each kept particle's weight against `log p` (float64).
    - `score_gap`: each kept particle's score, and each kept call's drawn
      particle's, against `joint_logpdf(p)` (float64).
    - `lml_gap`: each kept call's LML against `logsumexp(log p) - log K`
      (float64) of its own particles.
    - `lml_z`: the mean of every call's LML against the exact one, in
      standard errors of the mean, from the estimator's exact variance.
    - `draw_z`: every call's drawn `p` against the posterior (`draw_z`).
    """
    n = traffic["particles"]
    worst = {name: 0.0 for name in LIMITS}
    for rec in kept:
        p = rec["p"].double()
        log_p = torch.log(p)
        worst["beta_chi2"] = max(worst["beta_chi2"], beta_chi2(rec["p"]))
        worst["weight_gap"] = max(worst["weight_gap"], _relative_gap(rec["weight"], log_p))
        worst["score_gap"] = max(worst["score_gap"], _relative_gap(rec["score"], joint_logpdf(p)))
        ref_lml = float(torch.logsumexp(log_p, 0)) - math.log(n)
        lml_gap = abs(float(rec["lml"]) - ref_lml)
        worst["lml_gap"] = max(worst["lml_gap"], lml_gap if math.isfinite(lml_gap) else math.inf)
        drawn_score = _relative_gap(rec["drawn_score"].reshape(1), joint_logpdf(rec["drawn_p"].double().reshape(1)))
        worst["score_gap"] = max(worst["score_gap"], drawn_score)
    worst["lml_z"] = _z_of_mean([lml for _, lml in calls], *exact_lml(config, n))
    drawn = torch.stack([p.reshape(()) for p, _ in calls]) if calls else torch.empty(0)
    worst["draw_z"] = draw_z(drawn)
    checks = [{"name": name, "value": worst[name], "limit": LIMITS[name]} for name in LIMITS]
    return checks, {"kept_calls": len(kept), "draws": drawn.numel()}


def exact_lml(config: dict, n: int) -> tuple[float, float]:
    """The exact log marginal likelihood and the variance of its K-particle
    estimate `log mean(w)`, `w` the likelihood of the observation under a
    prior draw (`p`, or `1 - p`): `Var(w) / (K E[w]^2)` to first order; its
    bias, `-Var / 2`, is a thousandth of a run's standard error."""
    a, b = config["alpha"], config["beta"]
    mean_w = (a if config["observed"] else b) / (a + b)
    var_w = a * b / ((a + b) ** 2 * (a + b + 1))
    return math.log(mean_w), var_w / (n * mean_w**2)


def _z_of_mean(xs: list, exact: float, var: float) -> float:
    """|mean(xs) - exact| over the standard error of the mean of `len(xs)`
    draws of variance `var`."""
    if not xs or not all(math.isfinite(x) for x in xs):
        return math.inf
    return abs(sum(xs) / len(xs) - exact) / math.sqrt(var / len(xs))


class Control:
    """This reference in the program's place, computed in bfloat16 (the
    precision below the configuration's float32): the draws, weights,
    scores, LML and the drawn particle, in the program's output records."""

    def __init__(self, config: dict, traffic: dict, inputs: dict, seed: int, device):
        self.n = traffic["particles"]
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def call(self, i: int):
        n, dt, dev, g = self.n, torch.bfloat16, self.device, self.gen
        p = torch.sort(torch.rand((n, 3), generator=g, dtype=dt, device=dev), dim=-1).values[:, 1]
        log_p = torch.log(p)
        score = 2.0 * log_p + torch.log1p(-p) + LOG6
        lml = torch.logsumexp(log_p, 0) - math.log(n)
        u = torch.rand(n, generator=g, dtype=dt, device=dev)
        idx = torch.argmax(log_p - torch.log(-torch.log(u))).reshape(1)
        # Copies of the drawn row: indexing by a 0-d tensor gives a view,
        # which would keep each call's particles alive in the window.
        drawn_p, drawn_score = p.index_select(0, idx).squeeze(0), score.index_select(0, idx).squeeze(0)
        out = {"p": p, "weight": log_p, "score": score, "lml": lml, "drawn_p": drawn_p, "drawn_score": drawn_score}
        return out, float(lml)

    def small(self, out):
        return out["drawn_p"]

    def record(self, out):
        return out


# Floating-point operations per particle of one trial: the draw (the
# middle of three uniforms: three compare-exchanges), the density and the
# weight (log p, 1 - p, log(1 - p), and three adds for the score), the LML
# (subtract, exp, add) and the categorical draw (normalize, two logs, add,
# compare).
FLOPS_PER_PARTICLE = 3 + 6 + 3 + 5
# Bytes per particle of one trial: the draw, the score and the weight
# written once (float32), the weights read once for the LML and once for
# the draw.
BYTES_PER_PARTICLE = 4 * 3 + 4 * 2


def work(config: dict, traffic: dict, facts: dict) -> dict:
    """What one call must do, whatever implements it: its units of work,
    floating-point operations and bytes, and the bytes of each launch of
    the log-sum-exp reduction (K values read, one float written)."""
    n = traffic["particles"]
    return {
        "units_per_call": n,
        "flops_per_call": FLOPS_PER_PARTICLE * n,
        "bytes_per_call": BYTES_PER_PARTICLE * n,
        "k1_bytes": {"lse": 4 * n + 4, "lse_ess": 4 * n + 8},
    }
