"""The distribution library: the 48 distributions of
`genjax_tpu/distributions/library.py`, with its parameterizations,
defaults and keyword names, and the factories `native_distribution` (the
port's `exact_density`) and `tfp_distribution`.

Support semantics: a value outside the support scores exactly `-inf`
(`_guard_support`), the formula evaluated at a safe value there so no NaN
reaches a gradient. The port departs from the reference where the
reference contradicts that rule or itself (ROADMAP section 3): a
non-integer count scores `-inf` for geometric, poisson, binomial,
beta_binomial, negative_binomial, multinomial and dirichlet_multinomial
(R3); the two count-vector families compare their sum in integers (R4);
the beta quotient's density has b1 and b2 where they belong (R8). Each is
recorded beside the reference's behaviour in
`tests/test_torch_distribution_support.py` and
`tests/test_torch_distributions.py`. Beta and kumaraswamy keep the
reference's closed interval (R5).

Samplers draw from a `torch.Generator` on the generator's device (PyTorch's
`torch._standard_gamma`, `torch.poisson` and `torch.binomial` with
`generator=`); `torch.distributions` is not used, as its samplers draw
from the global generator. The three rejection samplers (von Mises, von
Mises-Fisher, zipf) run one masked loop over the whole batch
(`_rejection`). Parameters may be scalars or tensors (a vector `loc`
draws a vector). With a particle count `n` a site draws
`(n, *per-particle shape)` values (`core.typing.sample_shape`): a
parameter marked `PerParticle` brings its own particle axis, any other is
shared. `sample_shape=` on a site is `distribution.SampleShaped`.
"""

import math

import torch

from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import PerParticle, batch_dims, device_of, host_scalar, on_device, sample_shape
from genjax_tpu_torch.distributions.distribution import ExactDensity, _signature, exact_density
from genjax_tpu_torch.distributions.mathx import (
    betaln,
    gammaln,
    hyp2f1,
    lambertw,
    log,
    log1p,
    log_bessel_i0,
    log_bessel_iv,
    log_binom,
    softplus,
    xlog1py,
    xlogy,
)

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _guard_support(in_support, v, safe, lp_fn):
    """Score `-inf` outside the support instead of NaN or a wrong finite
    value. The formula is evaluated at `safe` outside the support, so it
    never sees an out-of-support value."""
    vs = torch.where(in_support, v, safe)
    return torch.where(in_support, lp_fn(vs), -math.inf)


def _rand(rng, shape):
    return torch.rand(shape, generator=rng, device=rng.device)


# -- normal ----------------------------------------------------------------


def _normal_sample(rng, loc, scale, n=None):
    eps = torch.randn(sample_shape(n, loc, scale), generator=rng, device=rng.device)
    return loc + scale * eps


def _normal_logpdf(v, loc, scale):
    z = (v - loc) / scale
    return -0.5 * z * z - log(scale) - _HALF_LOG_2PI


normal = exact_density(_normal_sample, _normal_logpdf, "normal")


# -- uniform ---------------------------------------------------------------


def _uniform_sample(rng, low=0.0, high=1.0, n=None):
    return low + (high - low) * _rand(rng, sample_shape(n, low, high))


def _uniform_logpdf(v, low=0.0, high=1.0):
    in_support = (v >= low) & (v <= high)
    return torch.where(in_support, -log(high - low), -math.inf)


uniform = exact_density(_uniform_sample, _uniform_logpdf, "uniform")


# -- beta ------------------------------------------------------------------


def _host_small_int(v, limit: int) -> int | None:
    """`v` as an int when the host can read it for free and it is an
    integer in [1, limit]; None otherwise."""
    fv = host_scalar(v)
    if fv is not None and fv.is_integer() and 1.0 <= fv <= limit:
        return int(fv)
    return None


def _beta_sample(rng, concentration1, concentration0, n=None):
    shape = sample_shape(n, concentration1, concentration0)
    # Order-statistic fast path: for integer (a, b) with a + b <= 9,
    # Beta(a, b) is the a-th smallest of a + b - 1 uniforms; Beta(2, 2) is
    # the middle of three. The concentrations are read on the host only
    # when that is free (Python numbers, 0-d CPU tensors).
    a = _host_small_int(concentration1, 8)
    b = _host_small_int(concentration0, 8)
    if a is not None and b is not None and a + b <= 9:
        k = a + b - 1
        if k == 1:
            return _rand(rng, shape)
        u = _rand(rng, tuple(shape) + (k,))
        return torch.sort(u, dim=-1).values[..., a - 1]
    # Otherwise the gamma ratio G1 / (G1 + G2).
    return _beta_ratio(rng, concentration1, concentration0, shape)


def _beta_logpdf(v, concentration1, concentration0):
    # Closed [0, 1]: xlogy / xlog1py give the boundary limits; the guard
    # handles values outside.
    return _guard_support(
        (v >= 0.0) & (v <= 1.0),
        v,
        0.5,
        lambda vs: xlogy(concentration1 - 1.0, vs)
        + xlog1py(concentration0 - 1.0, -vs)
        - betaln(concentration1, concentration0),
    )


beta = exact_density(_beta_sample, _beta_logpdf, "beta")


# -- gamma -----------------------------------------------------------------


def _standard_gamma(rng, concentration, shape):
    """Gamma(concentration, 1) draws of `shape` from `rng`: PyTorch's
    sampler, whose backward is the implicit reparameterization gradient
    with respect to the concentration (Figurnov et al. 2018). The JAX
    library's closed forms for half-integer shapes (`_fast_gamma_unit`)
    are slower on the card from shape 1 up; Z^2 / 2 at shape 1/2 is
    faster, but no path of the port draws that shape
    (`python3 -m genjax_tpu_torch.sampler_probe`, PERF.md §6)."""
    c = on_device(concentration, rng.device, torch.float32)
    return torch._standard_gamma(c.expand(shape).contiguous(), generator=rng)


def _gamma_sample(rng, concentration, rate, n=None):
    return _standard_gamma(rng, concentration, sample_shape(n, concentration, rate)) / rate


def _gamma_logpdf(v, concentration, rate):
    # v = 0 stays in the formula (xlogy gives the boundary limit for every
    # concentration); v < 0 scores -inf.
    return _guard_support(
        v >= 0.0,
        v,
        1.0,
        lambda vs: xlogy(concentration, rate) + xlogy(concentration - 1.0, vs) - rate * vs - gammaln(concentration),
    )


gamma = exact_density(_gamma_sample, _gamma_logpdf, "gamma")


# -- dirichlet ---------------------------------------------------------------


def _dirichlet_sample(rng, concentration, n=None):
    g = _standard_gamma(rng, concentration, sample_shape(n, concentration))
    return g / g.sum(-1, keepdim=True)


def _dirichlet_logpdf(v, concentration):
    # Each component in [0, 1] (the simplex's sum is not checked, as in the
    # reference); the formula sees 0.5 outside, so no NaN reaches a gradient.
    in_support = ((v >= 0.0) & (v <= 1.0)).all(-1)
    vs = torch.where(in_support.unsqueeze(-1), v, 0.5)
    conc = on_device(concentration, v.device, torch.float32)
    lp = xlogy(conc - 1.0, vs).sum(-1) + torch.lgamma(conc.sum(-1)) - torch.lgamma(conc).sum(-1)
    return torch.where(in_support, lp, -math.inf)


dirichlet = exact_density(_dirichlet_sample, _dirichlet_logpdf, "dirichlet")


# -- flip ------------------------------------------------------------------


def _flip_sample(rng, p, n=None):
    return _rand(rng, sample_shape(n, p)) < p


def _flip_logpdf(v, p):
    vf = v.to(torch.float32)
    return torch.where(
        (vf == 0.0) | (vf == 1.0),
        xlogy(vf, p) + xlog1py(1.0 - vf, -p),
        -math.inf,
    )


flip = exact_density(_flip_sample, _flip_logpdf, "flip")


def _bind_logits_probs(args: tuple, kwargs: dict) -> tuple:
    """`(logits, probs)` from a bare positional parameter (logits, as the
    reference reads it) or the keywords."""
    unknown = set(kwargs) - {"logits", "probs"}
    if unknown:
        raise TypeError(f"unexpected parameters {sorted(unknown)}")
    return (args[0] if args else kwargs.get("logits"), kwargs.get("probs"))


# -- bernoulli -------------------------------------------------------------


@Pytree.dataclass
class Bernoulli(ExactDensity):
    """Bernoulli over `{0, 1}` (int32 draws), parameterized by `logits=`
    or `probs=`. The logits form scores with softplus, stable where the
    sigmoid saturates in float32. A bare positional parameter is logits.

    >>> import torch
    >>> from genjax_tpu_torch.distributions.library import bernoulli
    >>> v = torch.tensor([0, 1, 2])
    >>> bernoulli.logpdf(v, logits=torch.tensor(0.0)).tolist()[2], round(float(bernoulli.logpdf(v[1], probs=0.25)), 4)
    (-inf, -1.3863)
    """

    def bind(self, args, kwargs):
        return _bind_logits_probs(args, kwargs)

    def sample(self, rng, logits=None, probs=None, n=None):
        p = _probs(logits, probs)
        return (_rand(rng, sample_shape(n, p)) < p).to(torch.int32)

    def logpdf(self, v, logits=None, probs=None):
        vf = torch.as_tensor(v).to(torch.float32)
        log_p, log_1mp = _log_p_1mp(logits, probs)
        # Support {0, 1}: a fractional or out-of-range value scores -inf.
        return torch.where((vf == 0.0) | (vf == 1.0), vf * log_p + (1.0 - vf) * log_1mp, -math.inf)


bernoulli = Bernoulli()


# -- geometric ---------------------------------------------------------------


def _geometric_sample(rng, p, n=None):
    # The number of failures before the first success, by inversion.
    u = 1e-7 + (1.0 - 1e-7) * _rand(rng, sample_shape(n, p))
    return torch.floor(torch.log(u) / log1p(-p)).to(torch.int32)


def _geometric_logpdf(v, p):
    vf = torch.as_tensor(v).to(torch.float32)
    return _guard_support((vf >= 0.0) & (vf == torch.floor(vf)), vf, 0.0, lambda vs: xlog1py(vs, -p) + log(p))


def _probs(logits, probs):
    if probs is not None:
        return probs
    return torch.sigmoid(logits) if isinstance(logits, torch.Tensor) else 1.0 / (1.0 + math.exp(-logits))


@Pytree.dataclass
class Geometric(ExactDensity):
    """Geometric over `{0, 1, ...}` (the failures before the first
    success; int32 draws), parameterized by `logits=` or `probs=`; a bare
    positional parameter is logits. A negative or non-integer value scores
    `-inf`.

    >>> import torch
    >>> from genjax_tpu_torch.distributions.library import geometric
    >>> lp = geometric.logpdf(torch.tensor([0.0, 2.0, 1.5, -1.0]), probs=torch.tensor(0.5))
    >>> [round(x, 4) for x in lp.tolist()]
    [-0.6931, -2.0794, -inf, -inf]
    """

    def bind(self, args, kwargs):
        return _bind_logits_probs(args, kwargs)

    def sample(self, rng, logits=None, probs=None, n=None):
        return _geometric_sample(rng, _probs(logits, probs), n)

    def logpdf(self, v, logits=None, probs=None):
        return _geometric_logpdf(v, _probs(logits, probs))


geometric = Geometric()


# -- categorical -----------------------------------------------------------


@Pytree.dataclass
class Categorical(ExactDensity):
    """Categorical over `0..n-1` (int64 draws), parameterized by `logits=`
    (unnormalized) or `probs=` along the last axis; a bare positional
    parameter is logits. One Gumbel-argmax draw per row of logits; a value
    outside `0..n-1` scores `-inf` (an index would otherwise wrap).

    >>> import torch
    >>> from genjax_tpu_torch.distributions.library import categorical
    >>> lp = categorical.logpdf(torch.tensor([0, 2, 3, -1]), logits=torch.zeros(3))
    >>> [round(x, 4) for x in lp.tolist()]
    [-1.0986, -1.0986, -inf, -inf]
    """

    # The parameters have one axis (over the categories) that a value lacks.
    param_event_extra = (1, 1)

    def bind(self, args, kwargs):
        return _bind_logits_probs(args, kwargs)

    def sample(self, rng, logits=None, probs=None, n=None):
        if logits is None:
            logits = log(probs)
        # argmax(logits + Gumbel), the Gumbel noise as -log of an Exp(1) draw.
        e = torch.empty(sample_shape(n, logits), device=rng.device).exponential_(generator=rng)
        return torch.argmax(logits - torch.log(e), dim=-1)

    def logpdf(self, v, logits=None, probs=None):
        if logits is None:
            logits = log(probs)
        v = torch.as_tensor(v, device=logits.device)
        if v.is_floating_point():
            whole = v == torch.floor(v)
            v = torch.where(whole, v, -1.0).to(torch.int64)
        else:
            v = v.to(torch.int64)
        n_cat = logits.shape[-1]
        in_support = (v >= 0) & (v < n_cat)
        vs = torch.where(in_support, v, 0)
        if logits.dim() == 1:
            picked = logits[vs]
        else:
            lead = torch.broadcast_shapes(vs.shape, logits.shape[:-1])
            picked = torch.gather(logits.expand(*lead, n_cat), -1, vs.expand(lead).unsqueeze(-1)).squeeze(-1)
        # log_softmax(logits)[v], without the normalized table.
        return torch.where(in_support, picked - torch.logsumexp(logits, dim=-1), -math.inf)


categorical = Categorical()


# -- mv_normal_diag ----------------------------------------------------------


def _mv_normal_diag_sample(rng, loc, scale_diag, n=None):
    eps = torch.randn(sample_shape(n, loc, scale_diag), generator=rng, device=rng.device)
    return loc + scale_diag * eps


def _mv_normal_diag_logpdf(v, loc, scale_diag):
    return _normal_logpdf(v, loc, scale_diag).sum(-1)


mv_normal_diag = exact_density(_mv_normal_diag_sample, _mv_normal_diag_logpdf, "mv_normal_diag")



# -- the rest of the library -------------------------------------------------

native_distribution = exact_density  # JAX's name of the factory

_LOG_2 = math.log(2.0)
_LOG_PI = math.log(math.pi)
_TINY = torch.finfo(torch.float32).tiny


def _f(x, device):
    """A parameter as a float32 tensor on `device` (a Python number filled
    there, never copied from the host)."""
    return on_device(x, device, torch.float32)


def _own_shape(p) -> torch.Size:
    """A parameter's shape without the batch axes it is marked with."""
    if isinstance(p, PerParticle):
        return p.shape[p._depth :]
    return p.shape if isinstance(p, torch.Tensor) else torch.Size()


def _draw_shape(n, *params_and_event_ranks) -> torch.Size:
    """The batch axes `n`, then the broadcast of the parameters' own shapes
    less their last `event_rank` axes: the shape of one draw's scalar part
    (`(param, event_rank)` pairs; a number has no shape)."""
    shapes = []
    for p, r in params_and_event_ranks:
        if isinstance(p, torch.Tensor):
            own = _own_shape(p)
            shapes.append(own[: len(own) - r])
    base = torch.broadcast_shapes(*shapes) if shapes else torch.Size()
    return torch.Size((*batch_dims(n), *base))


def _normal(rng, shape):
    return torch.randn(shape, generator=rng, device=rng.device)


def _exponential(rng, shape):
    return torch.empty(shape, device=rng.device).exponential_(generator=rng)


def _cauchy_draw(rng, shape):
    return torch.empty(shape, device=rng.device).cauchy_(generator=rng)


def _open_uniform(rng, shape, low=1e-7, high=1.0 - 1e-7):
    return low + (high - low) * _rand(rng, shape)


def _beta_ratio(rng, a, b, shape):
    """Beta(a, b) draws as the gamma ratio G_a / (G_a + G_b)."""
    g1 = _standard_gamma(rng, a, shape)
    g0 = _standard_gamma(rng, b, shape)
    return g1 / (g1 + g0)


def _log_standard_gamma(rng, concentration, shape):
    """log Gamma(concentration, 1) draws, exact for small shapes: Gamma(a)
    = Gamma(a + 1) U^(1/a), so the log never underflows."""
    c = _f(concentration, rng.device)
    g = _standard_gamma(rng, c + 1.0, shape)
    return torch.log(g) + torch.log(_open_uniform(rng, shape, _TINY, 1.0)) / c


def _poisson_draw(rng, rate, shape):
    return torch.poisson(_f(rate, rng.device).expand(shape).contiguous(), generator=rng)


def _binomial_draw(rng, count, p, shape):
    count = _f(count, rng.device).expand(shape).contiguous()
    return torch.binomial(count, _f(p, rng.device).expand(shape).contiguous(), generator=rng)


def _float(v):
    return torch.as_tensor(v).to(torch.float32)


def _counts_in_support(vf, upper=None):
    """Non-negative whole counts (at most `upper`): R3 of the reference,
    which scores a non-integer count finitely, is not kept."""
    ok = (vf >= 0.0) & (vf == torch.floor(vf))
    return ok if upper is None else ok & (vf <= upper)


# -- rejection samplers ----------------------------------------------------------

REJECTION_MAX_TRIPS = 100  # JAX's cap: an unaccepted lane keeps its initial value
REJECTION_CHECK_EVERY = 4  # trips between the host's reads of "every lane accepted"

# name -> {"trips", "syncs", "accepted"} of the last draw of each rejection
# sampler: the trips it ran, the host reads (device synchronisations) of the
# all-accepted flag, and whether every lane accepted.
rejection_stats: dict = {}


def _rejection(name: str, init: torch.Tensor, propose) -> torch.Tensor:
    """A masked rejection loop over the whole batch: `propose()` returns a
    candidate and an accept flag per lane; each lane keeps its first
    accepted candidate (its `init` if none in `REJECTION_MAX_TRIPS`). The
    host reads whether every lane has accepted once every
    `REJECTION_CHECK_EVERY` trips."""
    value, accepted = init, torch.zeros(init.shape, dtype=torch.bool, device=init.device)
    syncs, done = 0, False
    trip = 0
    for trip in range(1, REJECTION_MAX_TRIPS + 1):
        candidate, ok = propose()
        value = torch.where(~accepted & ok, candidate, value)
        accepted = accepted | ok
        if trip % REJECTION_CHECK_EVERY == 0 or trip == REJECTION_MAX_TRIPS:
            syncs += 1
            done = bool(accepted.all())
            if done:
                break
    rejection_stats[name] = {"trips": trip, "syncs": syncs, "accepted": done}
    return value


# -- continuous scalar families ---------------------------------------------------


def _cauchy_sample(rng, loc=0.0, scale=1.0, n=None):
    return loc + scale * _cauchy_draw(rng, sample_shape(n, loc, scale))


def _cauchy_logpdf(v, loc=0.0, scale=1.0):
    z = (v - loc) / scale
    return -_LOG_PI - log(scale) - torch.log1p(z * z)


cauchy = exact_density(_cauchy_sample, _cauchy_logpdf, "cauchy")


def _half_cauchy_sample(rng, loc, scale, n=None):
    return loc + scale * _cauchy_draw(rng, sample_shape(n, loc, scale)).abs()


def _half_cauchy_logpdf(v, loc, scale):
    z = (v - loc) / scale
    return torch.where(v >= loc, _LOG_2 - _LOG_PI - log(scale) - torch.log1p(z * z), -math.inf)


half_cauchy = exact_density(_half_cauchy_sample, _half_cauchy_logpdf, "half_cauchy")


def _exp_half_cauchy_sample(rng, scale, n=None):
    # |Cauchy| is tan(pi u / 2) for u uniform on (0, 1): open at 0, so the
    # log is finite.
    u = _rand(rng, sample_shape(n, scale)).clamp_(min=_TINY)
    return log(scale) + torch.log(torch.tan(0.5 * math.pi * u))


def _exp_half_cauchy_logpdf(v, scale):
    # X = log HalfCauchy(0, scale): log(2/pi) + z - log1p(e^{2z}).
    z = v - log(scale)
    return _LOG_2 - _LOG_PI + z - torch.nn.functional.softplus(2.0 * z)


exp_half_cauchy = exact_density(_exp_half_cauchy_sample, _exp_half_cauchy_logpdf, "exp_half_cauchy")


def _half_normal_sample(rng, scale, n=None):
    return scale * _normal(rng, sample_shape(n, scale)).abs()


def _half_normal_logpdf(v, scale):
    z = v / scale
    return torch.where(v >= 0, _LOG_2 - 0.5 * z * z - log(scale) - _HALF_LOG_2PI, -math.inf)


half_normal = exact_density(_half_normal_sample, _half_normal_logpdf, "half_normal")


def _student_t_draw(rng, df, shape):
    g = _standard_gamma(rng, _f(df, rng.device) / 2.0, shape)
    return _normal(rng, shape) / torch.sqrt(2.0 * g / df)


def _student_t_sample(rng, df, loc, scale, n=None):
    return loc + scale * _student_t_draw(rng, df, sample_shape(n, df, loc, scale))


def _student_t_logpdf(v, df, loc, scale):
    z = (v - loc) / scale
    return (
        gammaln((df + 1.0) / 2.0)
        - gammaln(df / 2.0)
        - 0.5 * log(df * math.pi)
        - log(scale)
        - ((df + 1.0) / 2.0) * torch.log1p(z * z / df)
    )


student_t = exact_density(_student_t_sample, _student_t_logpdf, "student_t")


def _half_student_t_sample(rng, df, loc, scale, n=None):
    return loc + scale * _student_t_draw(rng, df, sample_shape(n, df, loc, scale)).abs()


def _half_student_t_logpdf(v, df, loc, scale):
    return torch.where(v >= loc, _LOG_2 + _student_t_logpdf(v, df, loc, scale), -math.inf)


half_student_t = exact_density(_half_student_t_sample, _half_student_t_logpdf, "half_student_t")


def _exponential_sample(rng, rate, n=None):
    return _exponential(rng, sample_shape(n, rate)) / rate


def _exponential_logpdf(v, rate):
    return torch.where(v >= 0, log(rate) - rate * v, -math.inf)


exponential = exact_density(_exponential_sample, _exponential_logpdf, "exponential")


def _inverse_gamma_sample(rng, concentration, scale, n=None):
    return scale / _standard_gamma(rng, concentration, sample_shape(n, concentration, scale))


def _inverse_gamma_logpdf(v, concentration, scale):
    return _guard_support(
        v > 0.0,
        v,
        1.0,
        lambda vs: xlogy(concentration, scale)
        - (concentration + 1.0) * torch.log(vs)
        - scale / vs
        - gammaln(concentration),
    )


inverse_gamma = exact_density(_inverse_gamma_sample, _inverse_gamma_logpdf, "inverse_gamma")


def _exp_gamma_sample(rng, concentration, rate=1.0, n=None):
    return _log_standard_gamma(rng, concentration, sample_shape(n, concentration, rate)) - log(rate)


def _exp_gamma_logpdf(v, concentration, rate=1.0):
    # X = log Gamma(concentration, rate).
    return xlogy(concentration, rate) + concentration * v - rate * torch.exp(v) - gammaln(concentration)


exp_gamma = exact_density(_exp_gamma_sample, _exp_gamma_logpdf, "exp_gamma")


def _exp_inverse_gamma_sample(rng, concentration, scale=1.0, n=None):
    return -(_log_standard_gamma(rng, concentration, sample_shape(n, concentration, scale)) - log(scale))


def _exp_inverse_gamma_logpdf(v, concentration, scale=1.0):
    # X = log InverseGamma(concentration, scale) = -log Gamma(concentration, scale).
    return xlogy(concentration, scale) - concentration * v - scale * torch.exp(-v) - gammaln(concentration)


exp_inverse_gamma = exact_density(_exp_inverse_gamma_sample, _exp_inverse_gamma_logpdf, "exp_inverse_gamma")


def _chi2_sample(rng, df, n=None):
    return 2.0 * _standard_gamma(rng, _f(df, rng.device) / 2.0, sample_shape(n, df))


def _chi2_logpdf(v, df):
    return _gamma_logpdf(v, df / 2.0, 0.5)


chi2 = exact_density(_chi2_sample, _chi2_logpdf, "chi2")


def _chi_sample(rng, df, n=None):
    return torch.sqrt(_chi2_sample(rng, df, n))


def _chi_logpdf(v, df):
    return _guard_support(
        v >= 0.0,
        v,
        1.0,
        lambda vs: xlogy(df - 1.0, vs) - vs * vs / 2.0 - (df / 2.0 - 1.0) * _LOG_2 - gammaln(df / 2.0),
    )


chi = exact_density(_chi_sample, _chi_logpdf, "chi")


def _laplace_sample(rng, loc, scale, n=None):
    eps = torch.finfo(torch.float32).eps / 2.0  # float32's epsneg: u in (-1, 1)
    u = -1.0 + eps + (2.0 - eps) * _rand(rng, sample_shape(n, loc, scale))
    return loc + scale * torch.sign(u) * torch.log1p(-u.abs())


def _laplace_logpdf(v, loc, scale):
    return -(v - loc).abs() / scale - log(2.0 * scale)


laplace = exact_density(_laplace_sample, _laplace_logpdf, "laplace")


def _gumbel_sample(rng, loc, scale, n=None):
    # An Exp(1) draw of exactly 0 (probability 2^-24 a draw) would give +inf.
    return loc - scale * torch.log(_exponential(rng, sample_shape(n, loc, scale)).clamp_(min=_TINY))


def _gumbel_logpdf(v, loc, scale):
    z = (v - loc) / scale
    return -z - torch.exp(-z) - log(scale)


gumbel = exact_density(_gumbel_sample, _gumbel_logpdf, "gumbel")


def _log_normal_sample(rng, loc, scale, n=None):
    return torch.exp(_normal_sample(rng, loc, scale, n))


def _log_normal_logpdf(v, loc, scale):
    return _guard_support(v > 0.0, v, 1.0, lambda vs: _normal_logpdf(torch.log(vs), loc, scale) - torch.log(vs))


log_normal = exact_density(_log_normal_sample, _log_normal_logpdf, "log_normal")


def _logit_normal_sample(rng, loc, scale, n=None):
    return torch.sigmoid(_normal_sample(rng, loc, scale, n))


def _logit_normal_logpdf(v, loc, scale):
    return _guard_support(
        (v > 0.0) & (v < 1.0),
        v,
        0.5,
        lambda vs: _normal_logpdf(torch.logit(vs), loc, scale) - torch.log(vs) - torch.log1p(-vs),
    )


logit_normal = exact_density(_logit_normal_sample, _logit_normal_logpdf, "logit_normal")


def _truncated_normal_sample(rng, loc, scale, low, high, n=None):
    dev = rng.device
    shape = sample_shape(n, loc, scale, low, high)
    a, b = _f((low - loc) / scale, dev), _f((high - loc) / scale, dev)
    ea, eb = torch.erf(a / math.sqrt(2.0)), torch.erf(b / math.sqrt(2.0))
    u = ea + (eb - ea) * _rand(rng, shape)
    z = math.sqrt(2.0) * torch.special.erfinv(u)
    # Into the open interval (a, b), as JAX clamps.
    z = torch.minimum(torch.maximum(z, torch.nextafter(a, torch.tensor(math.inf, device=dev))),
                      torch.nextafter(b, torch.tensor(-math.inf, device=dev)))
    return loc + scale * z


def _truncated_normal_logpdf(v, loc, scale, low, high):
    dev = device_of(v, loc, scale, low, high)
    a, b = _f((low - loc) / scale, dev), _f((high - loc) / scale, dev)
    z = (v - loc) / scale
    lp = -0.5 * z * z - _HALF_LOG_2PI - log(scale) - torch.log(torch.special.ndtr(b) - torch.special.ndtr(a))
    return torch.where((v >= low) & (v <= high), lp, -math.inf)


truncated_normal = exact_density(_truncated_normal_sample, _truncated_normal_logpdf, "truncated_normal")


def _cauchy_cdf(z):
    return torch.atan(z) / math.pi + 0.5


def _truncated_cauchy_sample(rng, loc, scale, low, high, n=None):
    dev = rng.device
    a = _cauchy_cdf(_f((low - loc) / scale, dev))
    b = _cauchy_cdf(_f((high - loc) / scale, dev))
    u = a + (b - a) * _rand(rng, sample_shape(n, loc, scale, low, high))
    return loc + scale * torch.tan(math.pi * (u - 0.5))


def _truncated_cauchy_logpdf(v, loc, scale, low, high):
    dev = device_of(v, loc, scale, low, high)
    a = _cauchy_cdf(_f((low - loc) / scale, dev))
    b = _cauchy_cdf(_f((high - loc) / scale, dev))
    lp = _cauchy_logpdf(v, loc, scale) - torch.log(b - a)
    return torch.where((v >= low) & (v <= high), lp, -math.inf)


truncated_cauchy = exact_density(_truncated_cauchy_sample, _truncated_cauchy_logpdf, "truncated_cauchy")


def _weibull_sample(rng, concentration, scale, n=None):
    return _exponential(rng, sample_shape(n, concentration, scale)) ** (1.0 / concentration) * scale


def _weibull_logpdf(v, concentration, scale):
    def lp(vs):
        z = vs / scale
        return log(concentration) - log(scale) + xlogy(concentration - 1.0, z) - z**concentration

    return _guard_support(v >= 0.0, v, 1.0, lp)


weibull = exact_density(_weibull_sample, _weibull_logpdf, "weibull")


def _kumaraswamy_sample(rng, concentration1, concentration0, n=None):
    u = _open_uniform(rng, sample_shape(n, concentration1, concentration0))
    return (1.0 - u ** (1.0 / concentration0)) ** (1.0 / concentration1)


def _kumaraswamy_logpdf(v, concentration1, concentration0):
    # Closed [0, 1], as the reference (its R5, kept for parity).
    a, b = concentration1, concentration0
    return _guard_support(
        (v >= 0.0) & (v <= 1.0),
        v,
        0.5,
        lambda vs: log(a) + log(b) + xlogy(a - 1.0, vs) + xlog1py(b - 1.0, -(vs**a)),
    )


kumaraswamy = exact_density(_kumaraswamy_sample, _kumaraswamy_logpdf, "kumaraswamy")


def _double_sided_maxwell_sample(rng, loc, scale, n=None):
    shape = sample_shape(n, loc, scale)
    norm = torch.linalg.vector_norm(_normal(rng, (*shape, 3)), dim=-1)
    sign = torch.where(_rand(rng, shape) < 0.5, -1.0, 1.0)
    return sign * norm * scale + loc


def _double_sided_maxwell_logpdf(v, loc, scale):
    z = (v - loc) / scale
    return 2.0 * torch.log(z.abs()) - 0.5 * z * z - _HALF_LOG_2PI - log(scale)


double_sided_maxwell = exact_density(_double_sided_maxwell_sample, _double_sided_maxwell_logpdf, "double_sided_maxwell")


def _moyal_sample(rng, loc, scale, n=None):
    u = _open_uniform(rng, sample_shape(n, loc, scale))
    # F(z) = erfc(exp(-z/2) / sqrt(2)), inverted through erfinv.
    return loc + scale * (-2.0 * torch.log(math.sqrt(2.0) * torch.special.erfinv(1.0 - u)))


def _moyal_logpdf(v, loc, scale):
    z = (v - loc) / scale
    return -0.5 * (z + torch.exp(-z)) - _HALF_LOG_2PI - log(scale)


moyal = exact_density(_moyal_sample, _moyal_logpdf, "moyal")


def _inverse_gaussian_sample(rng, loc, concentration, n=None):
    # X = lambda * Wald(mu / lambda) (Michael, Schucany & Haas), as JAX's wald.
    shape = sample_shape(n, loc, concentration)
    mean = _f(loc / concentration, rng.device)
    y = _normal(rng, shape) ** 2
    u = _rand(rng, shape)
    x = mean + mean * mean * y / 2.0 - mean / 2.0 * torch.sqrt(4.0 * mean * y + mean * mean * y * y)
    return concentration * torch.where(u <= mean / (mean + x), x, mean * mean / x)


def _inverse_gaussian_logpdf(v, loc, concentration):
    lam, mu = concentration, loc
    return _guard_support(
        v > 0.0,
        v,
        1.0,
        lambda vs: 0.5 * (log(lam) - math.log(2.0 * math.pi) - 3.0 * torch.log(vs))
        - lam * (vs - mu) ** 2 / (2.0 * mu * mu * vs),
    )


inverse_gaussian = exact_density(_inverse_gaussian_sample, _inverse_gaussian_logpdf, "inverse_gaussian")


def _lambert_w_normal_sample(rng, loc, scale, tailweight, n=None):
    # Y = loc + scale * Z exp(d Z^2 / 2).
    z = _normal(rng, sample_shape(n, loc, scale, tailweight))
    return loc + scale * z * torch.exp(tailweight * z * z / 2.0)


def _lambert_w_normal_logpdf(v, loc, scale, tailweight):
    d = _f(tailweight, device_of(v))
    u = (v - loc) / scale
    # Invert u = z exp(d z^2 / 2): z = sign(u) sqrt(W(d u^2) / d).
    w = lambertw(d * u * u)
    z2 = torch.where(d > 0, w / torch.clamp(d, min=1e-30), u * u)
    z = torch.sign(u) * torch.sqrt(torch.clamp(z2, min=0.0))
    log_dz_du = torch.where(u.abs() > 1e-30, torch.log(z.abs()) - torch.log(u.abs()) - torch.log1p(w), 0.0)
    return _normal_logpdf(z, 0.0, 1.0) + log_dz_du - log(scale)


lambert_w_normal = exact_density(_lambert_w_normal_sample, _lambert_w_normal_logpdf, "lambert_w_normal")


def _non_central_chi2_sample(rng, df, noncentrality, n=None):
    # J ~ Poisson(nc / 2), then ChiSq(df + 2J) = 2 Gamma(df / 2 + J).
    shape = sample_shape(n, df, noncentrality)
    j = _poisson_draw(rng, _f(noncentrality, rng.device) / 2.0, shape)
    return 2.0 * _standard_gamma(rng, df / 2.0 + j, shape)


def _non_central_chi2_logpdf(v, df, noncentrality):
    lam = noncentrality
    nu = df / 2.0 - 1.0
    return _guard_support(
        v > 0.0,
        v,
        1.0,
        lambda vs: -_LOG_2
        - (vs + lam) / 2.0
        + (nu / 2.0) * (torch.log(vs) - log(lam))
        + log_bessel_iv(nu, torch.sqrt(lam * vs), num_terms=60),
    )


non_central_chi2 = exact_density(_non_central_chi2_sample, _non_central_chi2_logpdf, "non_central_chi2")


def _beta_quotient_sample(
    rng, concentration1_numerator, concentration0_numerator, concentration1_denominator, concentration0_denominator, n=None
):
    shape = sample_shape(
        n, concentration1_numerator, concentration0_numerator, concentration1_denominator, concentration0_denominator
    )
    x = _beta_ratio(rng, concentration1_numerator, concentration0_numerator, shape)
    y = _beta_ratio(rng, concentration1_denominator, concentration0_denominator, shape)
    return x / y


def _beta_quotient_logpdf(v, a1, b1, a2, b2):
    """X / Y for X ~ Beta(a1, b1), Y ~ Beta(a2, b2), through Gauss's 2F1
    (Pham-Gia 2000): for z <= 1, z^(a1-1) B(a1+a2, b2) 2F1(a1+a2, 1-b1;
    a1+a2+b2; z); above 1, the reciprocal argument with b1 and b2 trading
    places; both over B(a1, b1) B(a2, b2). The reference swaps b1 and b2
    in both branches (its fault R8: its density integrates to 1 only where
    b1 == b2)."""
    in_support = v > 0.0
    v = torch.where(in_support, v, 1.0)
    log_norm = -betaln(a1, b1) - betaln(a2, b2)
    z_lo = torch.clamp(v, 1e-30, 1.0)
    lp_lo = (
        log_norm
        + betaln(a1 + a2, b2)
        + xlogy(a1 - 1.0, z_lo)
        + torch.log(hyp2f1(a1 + a2, 1.0 - b1, a1 + a2 + b2, z_lo))
    )
    z_hi = torch.clamp(v, min=1.0)
    lp_hi = (
        log_norm
        + betaln(a1 + a2, b1)
        - (a2 + 1.0) * torch.log(z_hi)
        + torch.log(hyp2f1(a1 + a2, 1.0 - b2, a1 + a2 + b1, 1.0 / z_hi))
    )
    return torch.where(in_support, torch.where(v <= 1.0, lp_lo, lp_hi), -math.inf)


beta_quotient = exact_density(_beta_quotient_sample, _beta_quotient_logpdf, "beta_quotient")


# -- directional -------------------------------------------------------------------


def _von_mises_sample(rng, loc, concentration, n=None):
    # Best-Fisher (1979), every lane in one masked loop.
    shape = sample_shape(n, loc, concentration)
    kappa = _f(concentration, rng.device).expand(shape)
    tau = 1.0 + torch.sqrt(1.0 + 4.0 * kappa * kappa)
    rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * torch.clamp(kappa, min=1e-10))
    r = (1.0 + rho * rho) / (2.0 * rho)

    def propose():
        u1, u2 = _rand(rng, shape), _rand(rng, shape)
        z = torch.cos(math.pi * u1)
        f = (1.0 + r * z) / (r + z)
        c = kappa * (r - f)
        ok = (c * (2.0 - c) - u2 > 0) | (torch.log(c / torch.clamp(u2, min=1e-30)) + 1.0 - c >= 0)
        return f, ok

    w = _rejection("von_mises", torch.zeros(shape, device=rng.device), propose)
    sign = torch.where(_rand(rng, shape) < 0.5, -1.0, 1.0)
    theta = sign * torch.arccos(torch.clamp(w, -1.0, 1.0))
    # The small-concentration limit: uniform on the circle.
    theta = torch.where(kappa < 1e-5, -math.pi + 2.0 * math.pi * _rand(rng, shape), theta)
    return torch.remainder(loc + theta + math.pi, 2.0 * math.pi) - math.pi


def _von_mises_logpdf(v, loc, concentration):
    kappa = _f(concentration, v.device)
    return kappa * torch.cos(v - loc) - math.log(2.0 * math.pi) - log_bessel_i0(kappa)


von_mises = exact_density(_von_mises_sample, _von_mises_logpdf, "von_mises")


def _householder_rotate(x, mu):
    """The Householder reflection taking e1 to the unit vector `mu`,
    applied to `x` (over the last axis)."""
    e1 = (torch.arange(mu.shape[-1], device=mu.device) == 0).to(mu.dtype)  # no host write
    u = e1 - mu
    norm = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    u = torch.where(norm > 1e-12, u / torch.clamp(norm, min=1e-12), u)
    return x - 2.0 * (u * x).sum(-1, keepdim=True) * u


def _tangent(rng, shape, d):
    """Uniform directions on the unit sphere of dimension d - 2."""
    v = _normal(rng, (*shape, d - 1))
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def _on_sphere(rng, t, mu):
    """A unit vector with component `t` along `mu` and a uniform direction
    orthogonal to it."""
    d = mu.shape[-1]
    v = _tangent(rng, t.shape, d)
    x = torch.cat([t[..., None], torch.sqrt(torch.clamp(1.0 - t * t, min=0.0))[..., None] * v], dim=-1)
    return _householder_rotate(x, mu)


def _vmf_log_norm(kappa, dim, device):
    """log C_d(kappa) of the von Mises-Fisher density on S^(d-1)."""
    nu = dim / 2.0 - 1.0
    kappa = _f(kappa, device)
    return nu * torch.log(torch.clamp(kappa, min=1e-30)) - (dim / 2.0) * math.log(2.0 * math.pi) - log_bessel_iv(nu, kappa)


def _von_mises_fisher_sample(rng, mean_direction, concentration, n=None):
    # Wood (1994): the component along the mean by rejection, every lane in
    # one masked loop.
    mu = _f(mean_direction, rng.device)
    d = mu.shape[-1]
    shape = _draw_shape(n, (mean_direction, 1), (concentration, 0))
    kappa = _f(concentration, rng.device).expand(shape)
    b = (-2.0 * kappa + torch.sqrt(4.0 * kappa * kappa + (d - 1.0) ** 2)) / (d - 1.0)
    x0 = (1.0 - b) / (1.0 + b)
    c = kappa * x0 + (d - 1.0) * torch.log1p(-x0 * x0)

    def propose():
        z = _beta_ratio(rng, (d - 1.0) / 2.0, (d - 1.0) / 2.0, shape)
        u = _rand(rng, shape)
        w = (1.0 - (1.0 + b) * z) / (1.0 - (1.0 - b) * z)
        return w, kappa * w + (d - 1.0) * torch.log1p(-x0 * w) - c >= torch.log(u)

    w = _rejection("von_mises_fisher", torch.zeros(shape, device=rng.device), propose)
    return _on_sphere(rng, w, mu)


def _von_mises_fisher_logpdf(v, mean_direction, concentration):
    d = mean_direction.shape[-1]
    return concentration * (v * mean_direction).sum(-1) + _vmf_log_norm(concentration, d, v.device)


von_mises_fisher = exact_density(
    _von_mises_fisher_sample, _von_mises_fisher_logpdf, "von_mises_fisher", param_event_extra=(0, -1)
)


def _power_spherical_sample(rng, mean_direction, concentration, n=None):
    # De Cao & Aziz (2020): exact, without rejection.
    mu = _f(mean_direction, rng.device)
    d = mu.shape[-1]
    shape = _draw_shape(n, (mean_direction, 1), (concentration, 0))
    alpha = (d - 1.0) / 2.0 + _f(concentration, rng.device)
    z = _beta_ratio(rng, alpha, (d - 1.0) / 2.0, shape)
    return _on_sphere(rng, 2.0 * z - 1.0, mu)


def _power_spherical_logpdf(v, mean_direction, concentration):
    d = mean_direction.shape[-1]
    kappa = concentration
    alpha = (d - 1.0) / 2.0 + kappa
    bet = (d - 1.0) / 2.0
    # N = 2^(a+b) pi^b Gamma(a) / Gamma(a+b).
    log_norm = -((alpha + bet) * _LOG_2 + bet * _LOG_PI + gammaln(alpha) - gammaln(alpha + bet))
    return log_norm + kappa * torch.log1p((v * mean_direction).sum(-1))


power_spherical = exact_density(
    _power_spherical_sample, _power_spherical_logpdf, "power_spherical", param_event_extra=(0, -1)
)


# -- multivariate normal --------------------------------------------------------------


def _cholesky(covariance_matrix):
    """The lower Cholesky factor, with its status kept on the device:
    `cholesky` reads it on the host to raise, a device synchronisation per
    call on a CUDA tensor (an elliptical slice move scores this site on
    every trip). A matrix that is not positive definite gives a factor of
    NaN, as JAX's does, so its samples and densities are NaN."""
    L, info = torch.linalg.cholesky_ex(covariance_matrix)
    return torch.where((info == 0)[..., None, None], L, float("nan"))


def _mv_normal_sample(rng, loc, covariance_matrix, n=None):
    # loc + L eps, L the Cholesky factor (shared or one per particle).
    loc = _f(loc, rng.device)
    d = loc.shape[-1]
    shape = _draw_shape(n, (loc, 1), (covariance_matrix, 2))
    chol = _cholesky(covariance_matrix)
    eps = _normal(rng, (*shape, d))
    if chol.dim() == 2:  # one factor for every draw: one product
        return loc + eps @ chol.mT
    return loc + (chol @ eps[..., None])[..., 0]


def _mv_normal_logpdf(v, loc, covariance_matrix):
    d = loc.shape[-1]
    chol = _cholesky(covariance_matrix)
    diff = v - loc
    if chol.dim() == 2:
        # One factor: invert it once, then one product for every draw (a
        # triangular solve with a million right-hand sides took 16.8 s on
        # the card, PERF.md PR 8).
        eye = torch.eye(d, dtype=chol.dtype, device=chol.device)
        y = diff @ torch.linalg.solve_triangular(chol, eye, upper=False).mT
    else:
        lead = torch.broadcast_shapes(diff.shape[:-1], chol.shape[:-2])
        y = torch.linalg.solve_triangular(chol.expand(*lead, d, d), diff.expand(*lead, d)[..., None], upper=False)[..., 0]
    log_det = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (y * y).sum(-1) - log_det - 0.5 * d * math.log(2.0 * math.pi)


mv_normal = exact_density(_mv_normal_sample, _mv_normal_logpdf, "mv_normal", param_event_extra=(0, 1))


# -- discrete families ----------------------------------------------------------------


def _log_p_1mp(logits, probs):
    """(log p, log(1 - p)), from the logits by softplus where given so."""
    if probs is None:
        return -softplus(-logits), -softplus(logits)
    return log(probs), log1p(-probs)


def _binomial_sample(rng, total_count, probs=None, logits=None, n=None):
    p = _probs(logits, probs)
    return _binomial_draw(rng, total_count, p, sample_shape(n, total_count, p))


def _binomial_logpdf(v, total_count, probs=None, logits=None):
    log_p, log_1mp = _log_p_1mp(logits, probs)
    vf = _float(v)
    return _guard_support(
        _counts_in_support(vf, total_count),
        vf,
        0.0,
        lambda vs: log_binom(total_count, vs) + vs * log_p + (total_count - vs) * log_1mp,
    )


binomial = exact_density(_binomial_sample, _binomial_logpdf, "binomial")


def _beta_binomial_sample(rng, total_count, concentration1, concentration0, n=None):
    shape = sample_shape(n, total_count, concentration1, concentration0)
    return _binomial_draw(rng, total_count, _beta_ratio(rng, concentration1, concentration0, shape), shape)


def _beta_binomial_logpdf(v, total_count, concentration1, concentration0):
    n, a, b = total_count, concentration1, concentration0
    vf = _float(v)
    return _guard_support(
        _counts_in_support(vf, n),
        vf,
        0.0,
        lambda vs: log_binom(n, vs) + betaln(vs + a, n - vs + b) - betaln(a, b),
    )


beta_binomial = exact_density(_beta_binomial_sample, _beta_binomial_logpdf, "beta_binomial")


def _poisson_sample(rng, rate, n=None):
    return _poisson_draw(rng, rate, sample_shape(n, rate)).to(torch.int32)


def _poisson_logpdf(v, rate):
    vf = _float(v)
    return _guard_support(_counts_in_support(vf), vf, 0.0, lambda vs: xlogy(vs, rate) - rate - torch.lgamma(vs + 1.0))


poisson = exact_density(_poisson_sample, _poisson_logpdf, "poisson")


def _negative_binomial_sample(rng, total_count, logits=None, probs=None, n=None):
    # Gamma-Poisson: lam ~ Gamma(r, rate (1 - p) / p), X ~ Poisson(lam).
    p = _probs(logits, probs)
    shape = sample_shape(n, total_count, p)
    lam = _standard_gamma(rng, total_count, shape) * (p / (1.0 - p))
    return torch.poisson(lam, generator=rng).to(torch.int32)


def _negative_binomial_logpdf(v, total_count, logits=None, probs=None):
    r = total_count
    log_p, log_1mp = _log_p_1mp(logits, probs)
    vf = _float(v)
    return _guard_support(
        _counts_in_support(vf),
        vf,
        0.0,
        lambda vs: torch.lgamma(vs + r) - gammaln(r) - torch.lgamma(vs + 1.0) + r * log_1mp + vs * log_p,
    )


negative_binomial = exact_density(_negative_binomial_sample, _negative_binomial_logpdf, "negative_binomial")


def _multinomial_draw(rng, total_count, p, shape):
    """Counts over the last axis of `shape` by conditional binomials: the
    count of category i given the counts before it."""
    p = (p / p.sum(-1, keepdim=True)).expand(shape)
    remaining = _f(total_count, rng.device).expand(shape[:-1]).contiguous()
    left = torch.ones(shape[:-1], device=rng.device)
    counts = []
    for i in range(shape[-1] - 1):
        q = torch.clamp(p[..., i] / torch.clamp(left, min=_TINY), 0.0, 1.0)
        c = torch.binomial(remaining, q.contiguous(), generator=rng)
        counts.append(c)
        remaining = remaining - c
        left = left - p[..., i]
    counts.append(remaining)
    return torch.stack(counts, dim=-1)


def _multinomial_sample(rng, total_count, probs=None, logits=None, n=None):
    p = torch.softmax(logits, dim=-1) if probs is None else _f(probs, rng.device)
    shape = _draw_shape(n, (total_count, 0), (p, 1)) + (p.shape[-1],)
    return _multinomial_draw(rng, total_count, p, shape)


def _count_vector_in_support(vf, total_count):
    """Whole non-negative counts whose sum, taken in integers, is
    `total_count` (R4 of the reference compares float sums with `==`)."""
    whole = _counts_in_support(vf).all(-1)
    total = torch.as_tensor(total_count, device=vf.device)
    sums = torch.where(whole[..., None], vf, 0.0).to(torch.int64).sum(-1)
    return whole & (total == torch.floor(total)) & (sums == total.to(torch.int64))


def _multinomial_logpdf(v, total_count, probs=None, logits=None):
    log_p = torch.log_softmax(logits, dim=-1) if probs is None else log(probs)
    vf = _float(v)
    in_support = _count_vector_in_support(vf, total_count)
    vs = torch.where(in_support[..., None], vf, 0.0)
    lp = gammaln(total_count + 1.0) - torch.lgamma(vs + 1.0).sum(-1) + (vs * log_p).sum(-1)
    return torch.where(in_support, lp, -math.inf)


multinomial = exact_density(_multinomial_sample, _multinomial_logpdf, "multinomial", param_event_extra=(-1, 0, 0))


def _dirichlet_multinomial_sample(rng, total_count, concentration, n=None):
    shape = _draw_shape(n, (total_count, 0), (concentration, 1)) + (_own_shape(concentration)[-1],)
    g = _standard_gamma(rng, concentration, shape)
    return _multinomial_draw(rng, total_count, g / g.sum(-1, keepdim=True), shape)


def _dirichlet_multinomial_logpdf(v, total_count, concentration):
    a = concentration
    vf = _float(v)
    a0 = a.sum(-1)
    in_support = _count_vector_in_support(vf, total_count)
    vs = torch.where(in_support[..., None], vf, 0.0)
    lp = (
        gammaln(total_count + 1.0)
        - torch.lgamma(vs + 1.0).sum(-1)
        + torch.lgamma(a0)
        - torch.lgamma(total_count + a0)
        + (torch.lgamma(vs + a) - torch.lgamma(a)).sum(-1)
    )
    return torch.where(in_support, lp, -math.inf)


dirichlet_multinomial = exact_density(
    _dirichlet_multinomial_sample, _dirichlet_multinomial_logpdf, "dirichlet_multinomial", param_event_extra=(-1, 0)
)


def _skellam_sample(rng, rate1, rate2, n=None):
    shape = sample_shape(n, rate1, rate2)
    return (_poisson_draw(rng, rate1, shape) - _poisson_draw(rng, rate2, shape)).to(torch.int32)


def _skellam_logpmf(v, rate1, rate2):
    vf = _float(v)
    return (
        -(rate1 + rate2)
        + (vf / 2.0) * (log(rate1) - log(rate2))
        + log_bessel_iv(vf.abs(), 2.0 * torch.sqrt(_f(rate1 * rate2, vf.device)), num_terms=60)
    )


skellam = exact_density(_skellam_sample, _skellam_logpmf, "skellam")

_INT32_CEILING = 2147483520.0  # the largest float32 below 2^31: casts saturate as XLA's do


def _zipf_sample(rng, power, n=None):
    # Devroye's rejection-inversion over {1, 2, ...}, every lane in one
    # masked loop.
    shape = sample_shape(n, power)
    a = _f(power, rng.device).expand(shape)
    scale = 2.0 ** (a - 1.0)

    def propose():
        u = _open_uniform(rng, shape, 1e-12, 1.0)
        v = _rand(rng, shape)
        x = torch.floor(u ** (-1.0 / (a - 1.0)))
        t = (1.0 + 1.0 / x) ** (a - 1.0)
        return x, torch.isfinite(x) & (v * x * (t - 1.0) / (scale - 1.0) <= t / scale)

    x = _rejection("zipf", torch.ones(shape, device=rng.device), propose)
    return torch.clamp(x, max=_INT32_CEILING).to(torch.int32)


def _zipf_logpmf(v, power):
    vf = _float(v)
    zeta = torch.special.zeta(_f(power, vf.device), 1.0)
    return _guard_support(vf >= 1.0, vf, 1.0, lambda vs: -power * torch.log(vs) - torch.log(zeta))


zipf = exact_density(_zipf_sample, _zipf_logpmf, "zipf")


def tfp_distribution(dist_ctor, name: str | None = None) -> ExactDensity:
    """A generative function from a constructor of a TFP-style
    distribution object: anything with `.sample(seed=<torch.Generator>,
    sample_shape=...)` and `.log_prob(v)` (JAX's factory of the same name,
    with a generator where JAX passes a key). Parameters bind by the
    constructor's signature. Under a particle count the object draws the
    batch axes that its parameters do not carry; a non-scalar `log_prob`
    is summed into the site's score, as JAX sums it.

    >>> import torch
    >>> from genjax_tpu_torch.distributions import tfp_distribution
    >>> class Degenerate:
    ...     def __init__(self, loc):
    ...         self.loc = loc
    ...     def sample(self, seed=None, sample_shape=()):
    ...         return torch.full(sample_shape, self.loc)
    ...     def log_prob(self, v):
    ...         return torch.where(v == self.loc, 0.0, -torch.inf)
    >>> point = tfp_distribution(Degenerate, name="degenerate")
    >>> tr = point.simulate(torch.Generator().manual_seed(0), (2.5,))
    >>> float(tr.get_retval()), float(tr.get_score())
    (2.5, 0.0)
    """

    def sample_fn(rng, *args, n=None):
        dims = batch_dims(n)
        carried = max([p._depth for p in args if isinstance(p, PerParticle)], default=0)
        shape = tuple(dims[: len(dims) - carried])
        dist = dist_ctor(*args)
        return dist.sample(seed=rng, sample_shape=shape) if shape else dist.sample(seed=rng)

    def logpdf_fn(v, *args):
        return dist_ctor(*args).log_prob(v)

    return exact_density(sample_fn, logpdf_fn, name or getattr(dist_ctor, "__name__", "tfp"), signature=_signature(dist_ctor, 0))


__all__ = [
    "bernoulli",
    "beta",
    "beta_binomial",
    "beta_quotient",
    "binomial",
    "categorical",
    "cauchy",
    "chi",
    "chi2",
    "dirichlet",
    "dirichlet_multinomial",
    "double_sided_maxwell",
    "exp_gamma",
    "exp_half_cauchy",
    "exp_inverse_gamma",
    "exponential",
    "flip",
    "gamma",
    "geometric",
    "gumbel",
    "half_cauchy",
    "half_normal",
    "half_student_t",
    "inverse_gamma",
    "inverse_gaussian",
    "kumaraswamy",
    "lambert_w_normal",
    "laplace",
    "log_normal",
    "logit_normal",
    "moyal",
    "multinomial",
    "mv_normal",
    "mv_normal_diag",
    "native_distribution",
    "negative_binomial",
    "non_central_chi2",
    "normal",
    "poisson",
    "power_spherical",
    "skellam",
    "student_t",
    "tfp_distribution",
    "truncated_cauchy",
    "truncated_normal",
    "uniform",
    "von_mises",
    "von_mises_fisher",
    "weibull",
    "zipf",
]
