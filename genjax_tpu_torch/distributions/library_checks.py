"""One check per distribution of the library: draw through `simulate`,
hold the draws' moments against their closed forms (the fraction below
the median, or one probability, where the moments do not exist), and the
log density of the first draws against a float64 reference (`scipy.stats`
where SciPy has the family, its formula in float64 otherwise).

`chip_smoke.py` runs every case at a million draws on the card and the
CPU tests run it at 8192; SciPy is imported only by `reference` functions,
when a check runs. Each case's parameters are Python numbers or tensors
made on the check's device.
"""

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

EULER = 0.5772156649015329


@dataclasses.dataclass(frozen=True)
class Case:
    """`params(device)` gives the positional parameters and `kwargs` the
    keyword ones. `support(v)` is True where a draw lies in the support.
    `stat(v)` maps the draws to the scalar whose mean (and variance)
    `mean`/`var` give; `median` or `prob = (event(v), p)` replace them for
    heavy tails. `reference(v64)` is the float64 log density of draws `v64`
    (a numpy array); `tol` its agreement, per unit of max(1, |ref|)."""

    params: Callable[[Any], tuple]
    support: Callable[[torch.Tensor], torch.Tensor]
    mean: float | None = None
    var: float | None = None
    median: float | None = None
    prob: tuple | None = None
    stat: Callable[[torch.Tensor], torch.Tensor] = lambda v: v
    kwargs: dict = dataclasses.field(default_factory=dict)
    reference: Callable[[np.ndarray], np.ndarray] | None = None
    tol: float = 1e-5


def _t(device, *xs):
    return torch.tensor(xs, dtype=torch.float32, device=device)


def _real(v):
    return torch.isfinite(v)


def _positive(v):
    return torch.isfinite(v) & (v > 0)


def _nonneg(v):
    return torch.isfinite(v) & (v >= 0)


def _unit(v):
    return (v >= 0) & (v <= 1)


def _counts(v):
    vf = v.float()
    return (vf >= 0) & (vf == torch.floor(vf))


def _stats():
    from scipy import stats

    return stats


def _special():
    from scipy import special

    return special


def _sigmoid(x):
    return 1.0 / (1.0 + math.exp(-x))


def _g(x):
    return math.gamma(x)


_MU3 = (0.6, 0.0, 0.8)
_COV = ((2.0, 0.3, 0.1), (0.3, 1.0, 0.2), (0.1, 0.2, 1.5))
_CAT = (0.2, -1.0, 0.5)
_DIR = (1.2, 0.7, 2.5)


def _cat_probs():
    e = np.exp(np.array(_CAT))
    return e / e.sum()


def _half_t_mean(df, loc, scale):
    return loc + scale * 2 * math.sqrt(df) * _g((df + 1) / 2) / (math.sqrt(math.pi) * (df - 1) * _g(df / 2))


def _kumaraswamy_moment(a, b, k):
    return b * _g(1 + k / a) * _g(b) / _g(1 + k / a + b)


def _truncated_cauchy_median(loc, scale, low, high):
    fa, fb = (math.atan((x - loc) / scale) / math.pi + 0.5 for x in (low, high))
    return loc + scale * math.tan(math.pi * ((fa + fb) / 2 - 0.5))


def _vmf3_mean_cosine(kappa):
    return 1 / math.tanh(kappa) - 1 / kappa


def _power_spherical_mean_cosine(kappa, d=3):
    # t = 2z - 1 with z ~ Beta((d-1)/2 + kappa, (d-1)/2).
    a, b = (d - 1) / 2 + kappa, (d - 1) / 2
    return 2 * a / (a + b) - 1


def _power_spherical_logpdf64(x, kappa, d=3):
    sp = _special()
    a, b = (d - 1) / 2 + kappa, (d - 1) / 2
    log_norm = -((a + b) * math.log(2) + b * math.log(math.pi) + sp.gammaln(a) - sp.gammaln(a + b))
    return log_norm + kappa * np.log1p(x @ np.array(_MU3))


def cases() -> dict[str, Case]:
    """The 48 cases, by distribution name."""
    st = _stats
    sp = _special
    p_bern = _sigmoid(-0.4)
    p_nb = 0.4
    cp = _cat_probs()
    mu3 = np.array(_MU3)
    cov = np.array(_COV)
    return {
        "normal": Case(lambda d: (0.5, 1.3), _real, 0.5, 1.69, reference=lambda v: st().norm(0.5, 1.3).logpdf(v)),
        "uniform": Case(lambda d: (-1.0, 3.0), lambda v: (v >= -1) & (v <= 3), 1.0, 16 / 12,
                        reference=lambda v: st().uniform(-1.0, 4.0).logpdf(v)),
        "beta": Case(lambda d: (2.5, 1.5), _unit, 2.5 / 4, 3.75 / 80, reference=lambda v: st().beta(2.5, 1.5).logpdf(v)),
        "gamma": Case(lambda d: (2.5, 1.5), _nonneg, 2.5 / 1.5, 2.5 / 2.25,
                      reference=lambda v: st().gamma(2.5, scale=1 / 1.5).logpdf(v)),
        "dirichlet": Case(lambda d: (_t(d, *_DIR),), lambda v: _unit(v).all(-1) & ((v.sum(-1) - 1).abs() < 1e-4),
                          1.2 / 4.4, 1.2 * 3.2 / (4.4**2 * 5.4), stat=lambda v: v[..., 0],
                          reference=lambda v: st().dirichlet(np.array(_DIR)).logpdf((v / v.sum(-1, keepdims=True)).T)),
        "flip": Case(lambda d: (0.3,), lambda v: (v == 0) | (v == 1), 0.3, 0.21, stat=lambda v: v.float(),
                     reference=lambda v: st().bernoulli(0.3).logpmf(v)),
        "bernoulli": Case(lambda d: (), lambda v: (v == 0) | (v == 1), p_bern, p_bern * (1 - p_bern),
                          kwargs={"logits": -0.4}, reference=lambda v: st().bernoulli(p_bern).logpmf(v)),
        "geometric": Case(lambda d: (), _counts, 0.7 / 0.3, 0.7 / 0.09, kwargs={"probs": 0.3},
                          reference=lambda v: st().geom(0.3, loc=-1).logpmf(v)),
        "categorical": Case(lambda d: (_t(d, *_CAT),), lambda v: (v >= 0) & (v < 3), float(cp @ np.arange(3)),
                            float(cp @ np.arange(3) ** 2 - (cp @ np.arange(3)) ** 2), stat=lambda v: v.double(),
                            reference=lambda v: np.log(cp)[v.astype(np.int64)]),
        "mv_normal_diag": Case(lambda d: (_t(d, 0.5, -1.0), _t(d, 1.3, 0.7)), lambda v: _real(v).all(-1), -1.0, 0.49,
                               stat=lambda v: v[..., 1],
                               reference=lambda v: st().norm([0.5, -1.0], [1.3, 0.7]).logpdf(v).sum(-1)),
        "cauchy": Case(lambda d: (0.5, 2.0), _real, median=0.5, reference=lambda v: st().cauchy(0.5, 2.0).logpdf(v)),
        "half_cauchy": Case(lambda d: (0.5, 2.0), lambda v: v >= 0.5, median=2.5,
                            reference=lambda v: st().halfcauchy(0.5, 2.0).logpdf(v)),
        "exp_half_cauchy": Case(lambda d: (1.5,), _real, median=math.log(1.5),
                                reference=lambda v: st().halfcauchy(0.0, 1.5).logpdf(np.exp(v)) + v),
        "half_normal": Case(lambda d: (1.3,), _nonneg, 1.3 * math.sqrt(2 / math.pi), 1.69 * (1 - 2 / math.pi),
                            reference=lambda v: st().halfnorm(scale=1.3).logpdf(v)),
        "student_t": Case(lambda d: (5.0, 0.5, 1.5), _real, 0.5, 2.25 * 5 / 3,
                          reference=lambda v: st().t(5.0, 0.5, 1.5).logpdf(v)),
        "half_student_t": Case(lambda d: (5.0, 0.5, 1.5), lambda v: v >= 0.5, _half_t_mean(5.0, 0.5, 1.5),
                               reference=lambda v: math.log(2) + st().t(5.0, 0.5, 1.5).logpdf(v)),
        "exponential": Case(lambda d: (1.7,), _nonneg, 1 / 1.7, 1 / 1.7**2, reference=lambda v: st().expon(scale=1 / 1.7).logpdf(v)),
        "inverse_gamma": Case(lambda d: (4.5, 1.5), _positive, 1.5 / 3.5, 2.25 / (3.5**2 * 2.5),
                              reference=lambda v: st().invgamma(4.5, scale=1.5).logpdf(v)),
        "exp_gamma": Case(lambda d: (2.5, 1.5), _real, float(sp().digamma(2.5)) - math.log(1.5), float(sp().polygamma(1, 2.5)),
                          reference=lambda v: st().loggamma(2.5, loc=-math.log(1.5)).logpdf(v)),
        "exp_inverse_gamma": Case(lambda d: (2.5, 1.5), _real, math.log(1.5) - float(sp().digamma(2.5)),
                                  float(sp().polygamma(1, 2.5)),
                                  reference=lambda v: st().loggamma(2.5, loc=-math.log(1.5)).logpdf(-v)),
        "chi2": Case(lambda d: (3.0,), _nonneg, 3.0, 6.0, reference=lambda v: st().chi2(3.0).logpdf(v)),
        "chi": Case(lambda d: (3.0,), _nonneg, 2 * math.sqrt(2 / math.pi), 3 - 8 / math.pi, reference=lambda v: st().chi(3.0).logpdf(v)),
        "laplace": Case(lambda d: (0.3, 1.2), _real, 0.3, 2 * 1.44, reference=lambda v: st().laplace(0.3, 1.2).logpdf(v)),
        "gumbel": Case(lambda d: (0.3, 1.2), _real, 0.3 + 1.2 * EULER, math.pi**2 / 6 * 1.44,
                       reference=lambda v: st().gumbel_r(0.3, 1.2).logpdf(v)),
        "log_normal": Case(lambda d: (0.3, 0.8), _positive, math.exp(0.62), (math.exp(0.64) - 1) * math.exp(1.24),
                           reference=lambda v: st().lognorm(0.8, scale=math.exp(0.3)).logpdf(v)),
        "logit_normal": Case(lambda d: (0.3, 0.8), lambda v: (v > 0) & (v < 1), median=_sigmoid(0.3),
                             reference=lambda v: st().norm(0.3, 0.8).logpdf(sp().logit(v)) - np.log(v) - np.log1p(-v)),
        "truncated_normal": Case(lambda d: (0.5, 1.2, -1.0, 2.5), lambda v: (v >= -1) & (v <= 2.5),
                                 float(st().truncnorm(-1.25, 5 / 3, 0.5, 1.2).mean()),
                                 float(st().truncnorm(-1.25, 5 / 3, 0.5, 1.2).var()),
                                 reference=lambda v: st().truncnorm(-1.25, 5 / 3, 0.5, 1.2).logpdf(v)),
        "truncated_cauchy": Case(lambda d: (0.5, 1.2, -1.0, 2.5), lambda v: (v >= -1) & (v <= 2.5),
                                 median=_truncated_cauchy_median(0.5, 1.2, -1.0, 2.5),
                                 reference=lambda v: st().cauchy(0.5, 1.2).logpdf(v)
                                 - math.log(st().cauchy(0.5, 1.2).cdf(2.5) - st().cauchy(0.5, 1.2).cdf(-1.0))),
        "weibull": Case(lambda d: (1.7, 1.3), _nonneg, 1.3 * _g(1 + 1 / 1.7), 1.69 * (_g(1 + 2 / 1.7) - _g(1 + 1 / 1.7) ** 2),
                        reference=lambda v: st().weibull_min(1.7, scale=1.3).logpdf(v)),
        "kumaraswamy": Case(lambda d: (2.0, 3.0), _unit, _kumaraswamy_moment(2, 3, 1),
                            _kumaraswamy_moment(2, 3, 2) - _kumaraswamy_moment(2, 3, 1) ** 2,
                            reference=lambda v: math.log(6.0) + np.log(v) + 2 * np.log1p(-(v**2))),
        "double_sided_maxwell": Case(lambda d: (0.25, 1.3), _real, 0.25, 3 * 1.69,
                                     reference=lambda v: math.log(0.5) + st().maxwell(scale=1.3).logpdf(np.abs(v - 0.25))),
        "moyal": Case(lambda d: (0.3, 1.2), _real, float(st().moyal(0.3, 1.2).mean()), float(st().moyal(0.3, 1.2).var()),
                      reference=lambda v: st().moyal(0.3, 1.2).logpdf(v)),
        "inverse_gaussian": Case(lambda d: (1.5, 2.0), _positive, 1.5, 1.5**3 / 2.0,
                                 reference=lambda v: st().invgauss(0.75, scale=2.0).logpdf(v)),
        "lambert_w_normal": Case(lambda d: (0.5, 1.2, 0.3), _real, median=0.5,
                                 reference=lambda v: _lambert_w_normal64(v, 0.5, 1.2, 0.3)),
        "non_central_chi2": Case(lambda d: (3.0, 2.0), _positive, 5.0, 14.0, reference=lambda v: st().ncx2(3.0, 2.0).logpdf(v)),
        "beta_quotient": Case(lambda d: (2.0, 3.0, 2.5, 1.5), _positive, 0.8),
        "von_mises": Case(lambda d: (0.5, 2.0), lambda v: (v >= -math.pi) & (v < math.pi),
                          float(sp().i1(2.0) / sp().i0(2.0)), stat=lambda v: torch.cos(v - 0.5),
                          reference=lambda v: st().vonmises(2.0, loc=0.5).logpdf(v)),
        "von_mises_fisher": Case(lambda d: (_t(d, *_MU3), 3.0), lambda v: ((v * v).sum(-1) - 1).abs() < 1e-4,
                                 _vmf3_mean_cosine(3.0), stat=lambda v: v @ _t(v.device, *_MU3),
                                 reference=lambda v: 3.0 * v @ mu3 + math.log(3.0) - math.log(4 * math.pi * math.sinh(3.0))),
        "power_spherical": Case(lambda d: (_t(d, *_MU3), 3.0), lambda v: ((v * v).sum(-1) - 1).abs() < 1e-4,
                                _power_spherical_mean_cosine(3.0), stat=lambda v: v @ _t(v.device, *_MU3),
                                reference=lambda v: _power_spherical_logpdf64(v, 3.0)),
        "mv_normal": Case(lambda d: (_t(d, 0.5, -1.0, 2.0), torch.tensor(_COV, device=d)), lambda v: _real(v).all(-1),
                          -1.0, 1.0, stat=lambda v: v[..., 1],
                          reference=lambda v: st().multivariate_normal([0.5, -1.0, 2.0], cov).logpdf(v)),
        "binomial": Case(lambda d: (10.0, 0.3), lambda v: _counts(v) & (v <= 10), 3.0, 2.1,
                         reference=lambda v: st().binom(10, 0.3).logpmf(v)),
        "beta_binomial": Case(lambda d: (10.0, 2.0, 3.0), lambda v: _counts(v) & (v <= 10), 4.0, 10 * 6 * 15 / (25 * 6),
                              reference=lambda v: st().betabinom(10, 2.0, 3.0).logpmf(v)),
        "poisson": Case(lambda d: (3.5,), _counts, 3.5, 3.5, stat=lambda v: v.float(), reference=lambda v: st().poisson(3.5).logpmf(v)),
        "negative_binomial": Case(lambda d: (4.0,), _counts, 4 * p_nb / (1 - p_nb), 4 * p_nb / (1 - p_nb) ** 2,
                                  stat=lambda v: v.float(), kwargs={"probs": p_nb},
                                  reference=lambda v: st().nbinom(4.0, 1 - p_nb).logpmf(v)),
        "multinomial": Case(lambda d: (10.0, _t(d, 0.2, 0.3, 0.5)), lambda v: _counts(v).all(-1) & (v.sum(-1) == 10),
                            2.0, 1.6, stat=lambda v: v[..., 0],
                            reference=lambda v: st().multinomial(10, [0.2, 0.3, 0.5]).logpmf(v)),
        "dirichlet_multinomial": Case(lambda d: (10.0, _t(d, *_DIR)), lambda v: _counts(v).all(-1) & (v.sum(-1) == 10),
                                      10 * 1.2 / 4.4, 10 * (1.2 / 4.4) * (3.2 / 4.4) * 14.4 / 5.4, stat=lambda v: v[..., 0],
                                      reference=lambda v: st().dirichlet_multinomial(np.array(_DIR), 10).logpmf(v)),
        "skellam": Case(lambda d: (2.5, 1.5), lambda v: v.float() == torch.floor(v.float()), 1.0, 4.0, stat=lambda v: v.float(),
                        reference=lambda v: st().skellam(2.5, 1.5).logpmf(v)),
        "zipf": Case(lambda d: (3.0,), lambda v: v >= 1, prob=(lambda v: v == 1, float(1 / sp().zeta(3.0))),
                     reference=lambda v: st().zipf(3.0).logpmf(v)),
    }


def _lambert_w_normal64(v, loc, scale, d):
    sp = _special()
    u = (v - loc) / scale
    w = np.real(sp.lambertw(d * u * u))
    z = np.sign(u) * np.sqrt(w / d)
    with np.errstate(divide="ignore", invalid="ignore"):
        log_dz_du = np.where(np.abs(u) > 1e-30, np.log(np.abs(z)) - np.log(np.abs(u)) - np.log1p(w), 0.0)
    return -0.5 * z * z - 0.5 * math.log(2 * math.pi) + log_dz_du - math.log(scale)


def _within(values: torch.Tensor, exact: float, n_se: float) -> float:
    """How many standard errors the mean of `values` lies from `exact`."""
    x = values.double()
    se = float(x.std()) / math.sqrt(x.numel())
    return abs(float(x.mean()) - exact) / se if se > 0 else (0.0 if float(x.mean()) == exact else math.inf)


def check(name: str, case: Case, rng: torch.Generator, n: int, n_logpdf: int = 4096, n_se: float = 5.0) -> dict:
    """Draw `n` values of `name` through `simulate`, check them, and return
    what was measured: the distances in SE, the largest log-density error
    against the reference, and the draw's time in ms (device included).
    Raises `AssertionError` on a failed check (also under `python -O`)."""
    import genjax_tpu_torch.distributions.library as lib

    dist = getattr(lib, name)
    device = rng.device
    args = dist.bind(case.params(device), case.kwargs) if case.kwargs else case.params(device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True) if device.type == "cuda" else None
    end = torch.cuda.Event(enable_timing=True) if device.type == "cuda" else None
    if start is not None:
        start.record()
    tr = dist.simulate(rng, args, n=n)
    if end is not None:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        ms = float("nan")
    v, score = tr.get_retval(), tr.get_score()
    out = {"name": name, "ms": ms, "shape": tuple(v.shape)}
    if v.shape[0] != n or score.shape != (n,):
        raise AssertionError(f"{name}: draws {tuple(v.shape)}, scores {tuple(score.shape)}")
    inside = case.support(v)
    if not bool(inside.all()):
        raise AssertionError(f"{name}: {int((~inside).sum())} of {n} draws outside the support")
    if not bool(torch.isfinite(score).all()):
        raise AssertionError(f"{name}: a draw scores {float(score.min())}")
    stat = case.stat(v).double()
    if case.mean is not None:
        out["mean_se"] = _within(stat, case.mean, n_se)
        if out["mean_se"] >= n_se:
            raise AssertionError(f"{name}: mean {float(stat.mean())} is {out['mean_se']:.2f} SE from {case.mean}")
    if case.var is not None and case.mean is not None:
        out["var_se"] = _within((stat - case.mean) ** 2, case.var, n_se)
        if out["var_se"] >= n_se:
            raise AssertionError(f"{name}: variance is {out['var_se']:.2f} SE from {case.var}")
    if case.median is not None:
        out["median_se"] = _within((stat < case.median).double(), 0.5, n_se)
        if out["median_se"] >= n_se:
            raise AssertionError(f"{name}: the fraction below {case.median} is {out['median_se']:.2f} SE from 1/2")
    if case.prob is not None:
        event, p = case.prob
        out["prob_se"] = _within(event(v).double(), p, n_se)
        if out["prob_se"] >= n_se:
            raise AssertionError(f"{name}: P(event) is {out['prob_se']:.2f} SE from {p}")
    if case.reference is not None:
        head = v[:n_logpdf]
        got = dist.logpdf(head, *args).double().cpu().numpy()
        ref = np.asarray(case.reference(head.double().cpu().numpy()), dtype=np.float64)
        err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
        out["logpdf_err"] = float(err.max())
        if out["logpdf_err"] > case.tol:
            raise AssertionError(f"{name}: logpdf {out['logpdf_err']:.3e} from the float64 reference")
    return out
