"""The samplers of the port's distribution library
(`genjax_tpu_torch.distributions.library`) on the CPU: held at 5 standard
errors of their closed-form moments (or, for the heavy-tailed families, of
the median or of one probability) at n = 8192, the three rejection
samplers' every lane accepted, and `library_checks.check`, the check that
`chip_smoke.py` runs at a million draws on the card, for each of the 48
distributions.
"""

import math
import zlib

import numpy as np
import pytest
import torch

from genjax_tpu_torch.distributions import library as T

torch.set_num_threads(1)

N_DRAWS = 8192


def _within(x: np.ndarray, exact: float, what: str, n_se: float = 5.0):
    x = np.asarray(x, dtype=np.float64)
    se = x.std(ddof=1) / math.sqrt(x.size)
    assert abs(x.mean() - exact) < n_se * se, (what, x.mean(), exact, se)


def _moments(draws: torch.Tensor, mean: float, var: float):
    x = draws.double().numpy()
    _within(x, mean, "mean")
    _within((x - mean) ** 2, var, "variance")


def _below_median(draws: torch.Tensor, median: float):
    _within((draws.double().numpy() < median).astype(np.float64), 0.5, "fraction below the median")


def _sample(name, *params, **kw):
    return getattr(T, name).sample(torch.Generator().manual_seed(zlib.crc32(name.encode())), *params, n=N_DRAWS, **kw)


_HEAVY = {
    # name -> (params, closed-form median)
    "cauchy": ((0.5, 2.0), 0.5),
    "half_cauchy": ((0.5, 2.0), 2.5),
    "exp_half_cauchy": ((1.5,), math.log(1.5)),
    "truncated_cauchy": ((0.5, 1.2, -1.0, 2.5), None),
    "half_student_t": ((1.5, 0.5, 1.5), None),
    "lambert_w_normal": ((0.5, 1.2, 0.3), 0.5),
}


def _median_from_logpdf(name, params, lo, hi):
    """The median by integrating the port's own density on a fine grid
    (float64 quadrature of exp(logpdf))."""
    xs = np.linspace(lo, hi, 400_001)
    pdf = np.exp(getattr(T, name).logpdf(torch.from_numpy(xs.astype(np.float32)), *params).double().numpy())
    cdf = np.cumsum(pdf) * (xs[1] - xs[0])
    return float(xs[np.searchsorted(cdf / cdf[-1], 0.5)])


@pytest.mark.parametrize("name", sorted(_HEAVY))
def test_heavy_tailed_samplers_split_at_their_median(name):
    params, median = _HEAVY[name]
    if median is None:
        lo, hi = {"truncated_cauchy": (-1.0, 2.5), "half_student_t": (0.5, 4000.0)}[name]
        median = _median_from_logpdf(name, params, lo, hi)
    _below_median(_sample(name, *params), median)


def _g(x):
    return math.gamma(x)


# name -> (params, mean, variance), the closed forms.
_MOMENTS = {
    "half_normal": ((1.3,), 1.3 * math.sqrt(2 / math.pi), 1.69 * (1 - 2 / math.pi)),
    "student_t": ((5.0, 0.5, 1.5), 0.5, 2.25 * 5 / 3),
    "exponential": ((1.7,), 1 / 1.7, 1 / 1.7**2),
    "inverse_gamma": ((4.5, 1.5), 1.5 / 3.5, 2.25 / (3.5**2 * 2.5)),
    # log Gamma(2.5, rate 1.5): mean digamma(2.5) - log 1.5, variance trigamma(2.5).
    "exp_gamma": ((2.5, 1.5), 0.7031566 - math.log(1.5), 0.4903577),
    "exp_inverse_gamma": ((2.5, 1.5), -0.7031566 + math.log(1.5), 0.4903577),
    "chi2": ((3.0,), 3.0, 6.0),
    "chi": ((3.0,), 2 * math.sqrt(2 / math.pi), 3.0 - 8 / math.pi),
    "laplace": ((0.3, 1.2), 0.3, 2 * 1.44),
    "gumbel": ((0.3, 1.2), 0.3 + 1.2 * 0.5772156649, math.pi**2 / 6 * 1.44),
    "log_normal": ((0.3, 0.8), math.exp(0.3 + 0.32), (math.exp(0.64) - 1) * math.exp(0.6 + 0.64)),
    "weibull": ((1.7, 1.3), 1.3 * _g(1 + 1 / 1.7), 1.69 * (_g(1 + 2 / 1.7) - _g(1 + 1 / 1.7) ** 2)),
    "kumaraswamy": ((2.0, 3.0), 3 * _g(1.5) * _g(3) / _g(4.5), 3 * _g(2) * _g(3) / _g(5) - (3 * _g(1.5) * _g(3) / _g(4.5)) ** 2),
    "double_sided_maxwell": ((0.25, 1.3), 0.25, 3 * 1.69),
    "inverse_gaussian": ((1.5, 2.0), 1.5, 1.5**3 / 2.0),
    "non_central_chi2": ((3.0, 2.0), 5.0, 2 * (3.0 + 4.0)),
    "binomial": ((10.0, 0.3), 3.0, 2.1),
    "beta_binomial": ((10.0, 2.0, 3.0), 4.0, 10 * 2 * 3 * 15 / (25 * 6)),
    "poisson": ((3.5,), 3.5, 3.5),
    "skellam": ((2.5, 1.5), 1.0, 4.0),
}


@pytest.mark.parametrize("name", sorted(_MOMENTS))
def test_sampler_moments(name):
    params, mean, var = _MOMENTS[name]
    _moments(_sample(name, *params).float(), mean, var)


def test_more_sampler_moments():
    # Keyword parameterizations and the families whose moments need more
    # than one number.
    p = 1 / (1 + math.exp(0.3))
    _moments(_sample("binomial", 10.0, logits=-0.3).float(), 10 * (1 - p) * 0 + 10 * p, 10 * p * (1 - p))
    q = 0.4  # failures before r successes with success probability 1 - q
    _moments(_sample("negative_binomial", 4.0, probs=q).float(), 4 * q / (1 - q), 4 * q / (1 - q) ** 2)
    # Truncated normal: mean and variance from the standard formulas.
    from scipy import stats

    tn = stats.truncnorm((-1.0 - 0.5) / 1.2, (2.5 - 0.5) / 1.2, loc=0.5, scale=1.2)
    _moments(_sample("truncated_normal", 0.5, 1.2, -1.0, 2.5), tn.mean(), tn.var())
    _moments(_sample("moyal", 0.3, 1.2), stats.moyal(0.3, 1.2).mean(), stats.moyal(0.3, 1.2).var())
    ln = stats.logitnorm if hasattr(stats, "logitnorm") else None
    if ln is not None:
        _moments(_sample("logit_normal", 0.3, 0.8), ln(0.3, 0.8).mean(), ln(0.3, 0.8).var())
    draws = _sample("multinomial", 10.0, torch.tensor([0.2, 0.3, 0.5]))
    assert bool((draws.sum(-1) == 10.0).all())
    for i, pi in enumerate([0.2, 0.3, 0.5]):
        _moments(draws[:, i], 10 * pi, 10 * pi * (1 - pi))
    draws = _sample("dirichlet_multinomial", 10.0, torch.tensor([1.2, 0.7, 2.5]))
    a0 = 4.4
    for i, ai in enumerate([1.2, 0.7, 2.5]):
        pi = ai / a0
        _moments(draws[:, i], 10 * pi, 10 * pi * (1 - pi) * (10 + a0) / (1 + a0))
    mu, cov = torch.tensor([0.5, -1.0, 2.0]), torch.tensor([[2.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 1.5]])
    draws = _sample("mv_normal", mu, cov)
    for i in range(3):
        _moments(draws[:, i], float(mu[i]), float(cov[i, i]))
    _within((draws[:, 0] - 0.5).double().numpy() * (draws[:, 1] + 1.0).double().numpy(), 0.3, "covariance")


@pytest.mark.parametrize("name", ["von_mises_fisher", "power_spherical"])
def test_directional_samplers_lie_on_the_sphere_with_the_right_mean_cosine(name):
    from scipy import integrate

    mu = torch.tensor([0.6, 0.0, 0.8])
    kappa = 3.0
    draws = _sample(name, mu, kappa)
    np.testing.assert_allclose(draws.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    cos = (draws @ mu).double().numpy()
    # E[mu . x] from the port's own density of t = mu . x on S^2 (the
    # density of t is proportional to exp(logpdf) on [-1, 1] for d = 3).
    if name == "von_mises_fisher":
        expected = 1 / math.tanh(kappa) - 1 / kappa
    else:
        num = integrate.quad(lambda t: t * (1 + t) ** kappa, -1, 1)[0]
        expected = num / integrate.quad(lambda t: (1 + t) ** kappa, -1, 1)[0]
    _within(cos, expected, "mean cosine")


def test_von_mises_sampler_mean_resultant():
    # E[cos(x - loc)] = I1(kappa) / I0(kappa).
    from scipy import special

    draws = _sample("von_mises", 0.5, 2.0)
    assert bool(((draws >= -math.pi) & (draws < math.pi)).all())
    _within(np.cos(draws.double().numpy() - 0.5), special.i1(2.0) / special.i0(2.0), "mean resultant")


def test_zipf_sampler_mass_at_one():
    from scipy import special

    draws = _sample("zipf", 2.5)
    assert draws.dtype == torch.int32 and int(draws.min()) >= 1
    _within((draws == 1).double().numpy(), 1 / special.zeta(2.5), "P(X = 1)")


@pytest.mark.parametrize("concentration", [0.01, 1.0, 100.0])
def test_rejection_samplers_accept_every_lane(concentration):
    # Each lane keeps its first accepted proposal; the host reads "all
    # accepted" once every `REJECTION_CHECK_EVERY` trips.
    rng = torch.Generator().manual_seed(11)
    draws = {
        "von_mises": T.von_mises.sample(rng, 0.0, concentration, n=N_DRAWS),
        "von_mises_fisher": T.von_mises_fisher.sample(rng, torch.tensor([0.0, 0.6, 0.8]), concentration, n=N_DRAWS),
        "zipf": T.zipf.sample(rng, 1.0 + concentration, n=N_DRAWS),
    }
    for name, x in draws.items():
        stats = T.rejection_stats[name]
        assert stats["accepted"], (name, stats)
        assert stats["syncs"] == math.ceil(stats["trips"] / T.REJECTION_CHECK_EVERY), stats
        assert bool(torch.isfinite(x.float()).all())
    assert int(draws["zipf"].min()) >= 1


def _check_names():
    from genjax_tpu_torch.distributions.library_checks import cases

    return sorted(cases())


@pytest.mark.parametrize("name", _check_names())
def test_the_card_check_of_each_distribution_passes_on_the_cpu(name):
    # `library_checks.check` at 8192 draws: what `chip_smoke.py` runs at a
    # million on the card (support, moments or a median or a probability
    # at 5 SE, the log density of the first draws against float64 SciPy).
    from genjax_tpu_torch.distributions import library_checks

    out = library_checks.check(name, library_checks.cases()[name], torch.Generator().manual_seed(21), N_DRAWS, 1024)
    assert out["shape"][0] == N_DRAWS
    assert len(library_checks.cases()) == 48
