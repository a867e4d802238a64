"""The support of the port's distributions
(`genjax_tpu_torch.distributions.library`) against
`genjax_tpu.distributions`, on the CPU: out-of-support values score
exactly `-inf` (the counterpart of
`tests/distributions/test_support_guards.py`), density gradients are
finite at the support's edges and match JAX's, and the three places where
the port departs from the reference are recorded beside the reference's
own behaviour: R3 (a non-integer count scores `-inf`), R4 (count sums
compared in integers) and R8 (the beta quotient's density).
"""

import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_tpu.distributions import library as J
from genjax_tpu_torch.distributions import library as T

torch.set_num_threads(1)

N_DRAWS = 8192


def f32(x):
    return np.asarray(x, dtype=np.float32)


# (name, params, out-of-support values, an in-support value): the port's
# counterpart of `tests/distributions/test_support_guards.py`.
SUPPORT = [
    ("chi2", (4.0,), [-2.0], 1.0),
    ("chi", (3.0,), [-2.0], 1.0),
    ("inverse_gamma", (3.0, 2.0), [-1.0, 0.0], 1.0),
    ("log_normal", (0.0, 1.0), [-1.0, 0.0], 1.0),
    ("logit_normal", (0.0, 1.0), [-0.5, 0.0, 1.0, 1.5], 0.4),
    ("weibull", (2.0, 1.0), [-1.0], 1.0),
    ("weibull", (1.0, 1.0), [-1.0], 1.0),
    ("kumaraswamy", (2.0, 3.0), [-0.5, 1.5], 0.3),
    ("inverse_gaussian", (1.0, 2.0), [-1.0, 0.0], 1.0),
    ("exponential", (2.0,), [-1.0], 1.0),
    ("half_normal", (1.0,), [-1.0], 1.0),
    ("half_cauchy", (0.0, 1.0), [-1.0], 1.0),
    ("half_student_t", (3.0, 0.0, 1.0), [-1.0], 1.0),
    ("truncated_normal", (0.0, 1.0, -1.0, 1.0), [-2.0, 2.0], 0.5),
    ("truncated_cauchy", (0.0, 1.0, -1.0, 1.0), [-2.0, 2.0], 0.5),
    ("beta_quotient", (2.0, 2.0, 2.0, 2.0), [-0.5, 0.0], 0.7),
    ("non_central_chi2", (4.0, 1.0), [-1.0, 0.0], 2.0),
    ("poisson", (2.0,), [-1, -2], 3),
    ("negative_binomial", (3.0, None, 0.4), [-1], 2),
    ("binomial", (5.0, 0.4), [-1, 6], 3),
    ("beta_binomial", (5.0, 2.0, 2.0), [-1, 6], 3),
    ("zipf", (2.0,), [0, -1], 3),
]


@pytest.mark.parametrize("name,params,oos,ins", SUPPORT, ids=[f"{c[0]}-{i}" for i, c in enumerate(SUPPORT)])
def test_out_of_support_is_neg_inf_like_jax(name, params, oos, ins):
    for v in [*oos, ins]:
        ref = float(getattr(J, name).logpdf(v, *params))
        got = float(getattr(T, name).logpdf(v, *params))
        assert (got == -math.inf) == (ref == -math.inf) == (v != ins), (v, got, ref)
        if v == ins:
            assert math.isclose(got, ref, rel_tol=1e-5, abs_tol=1e-5), (got, ref)


@pytest.mark.parametrize(
    "name,params,v",
    [
        ("poisson", (2.0,), 1.5),
        ("binomial", (5.0, 0.4), 2.5),
        ("beta_binomial", (5.0, 2.0, 2.0), 2.5),
        ("negative_binomial", (3.0, None, 0.4), 0.25),
    ],
)
def test_non_integer_count_r3_reference_and_port(name, params, v):
    # R3: the reference scores a non-integer count finitely (it checks only
    # v >= 0); the port takes `_guard_support`'s documented semantics.
    assert np.isfinite(float(getattr(J, name).logpdf(v, *params)))
    assert float(getattr(T, name).logpdf(v, *params)) == -math.inf
    whole = math.floor(v)
    np.testing.assert_allclose(
        float(getattr(T, name).logpdf(whole, *params)), float(getattr(J, name).logpdf(whole, *params)), rtol=1e-5
    )


def test_non_integer_count_vectors_r3_reference_and_port():
    v = f32([1.5, 3.5, 5.0])
    p, a = f32([0.2, 0.3, 0.5]), f32([1.2, 0.7, 2.5])
    assert np.isfinite(float(J.multinomial.logpdf(jnp.asarray(v), 10.0, probs=jnp.asarray(p))))
    assert np.isfinite(float(J.dirichlet_multinomial.logpdf(jnp.asarray(v), 10.0, jnp.asarray(a))))
    assert float(T.multinomial.logpdf(torch.from_numpy(v), 10.0, probs=torch.from_numpy(p))) == -math.inf
    assert float(T.dirichlet_multinomial.logpdf(torch.from_numpy(v), 10.0, torch.from_numpy(a))) == -math.inf


def test_beta_quotient_density_r8_reference_and_port():
    # R8: for z <= 1 the density of X / Y is z^(a1-1) B(a1+a2, b2)
    # 2F1(a1+a2, 1-b1; a1+a2+b2; z) / (B(a1,b1) B(a2,b2)) (Pham-Gia 2000),
    # and b1, b2 trade places above 1; the reference swaps them in both
    # branches, so with b1 != b2 its density integrates to 1.54, not 1,
    # and its median is not the sampler's. The port's integrates to 1 and
    # splits its own draws at half (float64 quadrature of exp(logpdf)).
    params = (2.0, 3.0, 2.5, 1.5)
    xs = np.geomspace(1e-6, 400.0, 4_001)
    port = np.exp(T.beta_quotient.logpdf(torch.from_numpy(xs.astype(np.float32)), *params).double().numpy())
    ref = np.exp(np.asarray(J.beta_quotient.logpdf(jnp.asarray(xs, dtype=jnp.float32), *params), dtype=np.float64))
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (port[1:] + port[:-1]) * np.diff(xs))])
    assert abs(cdf[-1] - 1.0) < 1e-3
    assert np.trapezoid(ref, xs) > 1.5
    median = float(xs[np.searchsorted(cdf, 0.5)])
    _below_median(_sample("beta_quotient", *params), median)


def _sample(name, *params, **kw):
    return getattr(T, name).sample(torch.Generator().manual_seed(zlib.crc32(name.encode())), *params, n=N_DRAWS, **kw)


def _below_median(draws: torch.Tensor, median: float):
    x = (draws.double().numpy() < median).astype(np.float64)
    se = x.std(ddof=1) / math.sqrt(x.size)
    assert abs(x.mean() - 0.5) < 5 * se, (x.mean(), se)


def test_count_sum_in_integers_r4_reference_and_port():
    # R4: the reference compares the float32 sum of the counts with `==`;
    # 2^24 + 1 + 1 sums to 2^24 in float32, so a valid vector of total
    # 2^24 + 2 scores -inf there. The port sums the counts in integers.
    v = f32([2.0**24, 1.0, 1.0])
    total = 2.0**24 + 2.0
    p = f32([0.98, 0.01, 0.01])
    assert float(J.multinomial.logpdf(jnp.asarray(v), total, probs=jnp.asarray(p))) == -math.inf
    got = float(T.multinomial.logpdf(torch.from_numpy(v), total, probs=torch.from_numpy(p)))
    ref64 = math.lgamma(total + 1) - sum(math.lgamma(c + 1) for c in v.tolist()) + sum(
        c * math.log(q) for c, q in zip(v.tolist(), p.astype(np.float64).tolist())
    )
    assert math.isfinite(got) and abs(got - ref64) < 1e-4 * abs(ref64)
    a = f32([1.0, 1.0, 1.0])
    assert float(J.dirichlet_multinomial.logpdf(jnp.asarray(v), total, jnp.asarray(a))) == -math.inf
    assert math.isfinite(float(T.dirichlet_multinomial.logpdf(torch.from_numpy(v), total, torch.from_numpy(a))))


@pytest.mark.parametrize(
    "name,params,v",
    [
        ("half_normal", (1.3,), 0.0),
        ("exponential", (2.0,), 0.0),
        ("weibull", (1.0, 1.0), 0.0),
        ("chi", (3.0,), 1.0),
        ("inverse_gamma", (3.0, 2.0), 0.7),
        ("log_normal", (0.3, 0.8), 1.2),
        ("logit_normal", (0.3, 0.8), 0.4),
        ("student_t", (3.5, 0.5, 1.5), 2.0),
        ("cauchy", (0.5, 2.0), -1.0),
        ("laplace", (0.3, 1.2), 1.0),
        ("gumbel", (0.3, 1.2), 1.0),
        ("kumaraswamy", (2.0, 3.0), 0.3),
        ("truncated_normal", (0.0, 1.0, -1.0, 1.0), 0.5),
        ("inverse_gaussian", (1.0, 2.0), 1.0),
        ("exp_gamma", (2.5, 1.5), 0.2),
        ("exp_half_cauchy", (1.5,), 0.3),
        ("von_mises", (0.5, 2.0), 1.0),
    ],
)
def test_density_gradients_are_finite_on_the_support_edges_and_match_jax(name, params, v):
    # The double-`where` guard keeps the untaken branch's NaN out of the
    # gradient at a support edge (v = 0 of a half-line); where JAX's
    # gradient is finite the two agree.
    x = torch.tensor(v, requires_grad=True)
    ps = [torch.tensor(p, requires_grad=True) for p in params]
    lp = getattr(T, name).logpdf(x, *ps)
    grads = torch.autograd.grad(lp, [x, *ps])
    assert all(torch.isfinite(g).all() for g in grads), grads
    ref = jax.grad(lambda *a: getattr(J, name).logpdf(*a), argnums=tuple(range(len(params) + 1)))(
        jnp.float32(v), *[jnp.float32(p) for p in params]
    )
    for g, r in zip(grads, ref):
        if np.isfinite(np.asarray(r)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
