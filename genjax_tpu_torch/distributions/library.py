"""The distributions of the particle, MCMC, combinator and VI paths:
`normal`, `uniform`, `beta`, `gamma`, `dirichlet`, `flip`, `bernoulli`,
`geometric`, `categorical` and `mv_normal_diag`.

Counterpart of the same ten in `genjax_tpu/distributions/library.py`,
with their parameterizations and support semantics: a value outside the
support scores exactly `-inf` (`_guard_support`), a non-integer count
for `geometric` included (the reference scores it finitely: its fault R3,
recorded in `tests/test_torch_distributions.py`). Samplers draw from a
`torch.Generator` on the generator's device. Parameters may be scalars or
tensors (a vector `loc` draws a vector). With a particle count `n` a site
draws `(n, *per-particle shape)` values (`core.typing.sample_shape`): a
parameter marked `PerParticle` brings its own particle axis, any other
is shared.

The other distributions of the JAX library come later.
"""

import math

import torch

from genjax_tpu_torch.core.gfi import GenerativeFunctionClosure
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import host_scalar, on_device, sample_shape
from genjax_tpu_torch.distributions.distribution import ExactDensity, exact_density
from genjax_tpu_torch.distributions.mathx import betaln, gammaln, log, log1p, xlog1py, xlogy

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
    c1 = torch.as_tensor(concentration1, dtype=torch.float32, device=rng.device).expand(shape)
    c0 = torch.as_tensor(concentration0, dtype=torch.float32, device=rng.device).expand(shape)
    g1 = torch._standard_gamma(c1.contiguous(), generator=rng)
    g0 = torch._standard_gamma(c0.contiguous(), generator=rng)
    return g1 / (g1 + g0)


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
    with respect to the concentration (Figurnov et al. 2018)."""
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

    def __call__(self, *args, logits=None, probs=None) -> GenerativeFunctionClosure:
        if args:
            logits = args[0]
        return GenerativeFunctionClosure(self, (logits, probs))

    def sample(self, rng, logits=None, probs=None, n=None):
        p = torch.sigmoid(logits) if probs is None else probs
        return (_rand(rng, sample_shape(n, p)) < p).to(torch.int32)

    def logpdf(self, v, logits=None, probs=None):
        vf = torch.as_tensor(v).to(torch.float32)
        if probs is None:
            # (log p, log 1-p) = (-softplus(-l), -softplus(l))
            log_p, log_1mp = -torch.nn.functional.softplus(-logits), -torch.nn.functional.softplus(logits)
        else:
            log_p, log_1mp = log(probs), log1p(-probs)
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

    def __call__(self, *args, logits=None, probs=None) -> GenerativeFunctionClosure:
        if args:
            logits = args[0]
        return GenerativeFunctionClosure(self, (logits, probs))

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

    def __call__(self, *args, logits=None, probs=None) -> GenerativeFunctionClosure:
        if args:
            logits = args[0]
        return GenerativeFunctionClosure(self, (logits, probs))

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


__all__ = [
    "bernoulli",
    "beta",
    "categorical",
    "dirichlet",
    "flip",
    "gamma",
    "geometric",
    "mv_normal_diag",
    "normal",
    "uniform",
]
