"""The port's ADEV strategies that estimate by sampling, one site at a time
(reparameterization, REINFORCE with and without a baseline, MVD, implicit
reparameterization of beta, gamma and dirichlet draws) against the
closed-form gradient of their expectation and against `genjax_tpu.adev`'s
own estimates on the CPU (the batched forms: `test_torch_adev_batched.py`).

Each test draws R independent gradient estimates on each side (one walk
each) and holds the port's mean within 5 standard errors of the closed
form, JAX's likewise, and the two means within 5 combined standard
errors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu.adev as jadev
import genjax_tpu_torch.adev as tadev

torch.set_num_threads(1)

R = 2000


def _port_draws(loss, args, r=R, argnum=0):
    return np.array(
        [float(loss.grad_estimate(torch.Generator().manual_seed(s), args)[argnum]) for s in range(r)]
    )


def _jax_draws(loss, args, r=R, argnum=0):
    keys = jax.random.split(jax.random.key(17), r)
    return np.asarray(jax.jit(jax.vmap(lambda k: loss.grad_estimate(k, args)[argnum]))(keys), dtype=np.float64)


def _stat(port, ref, exact, n_se=5.0):
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    se = port.std(ddof=1) / math.sqrt(len(port))
    se_ref = ref.std(ddof=1) / math.sqrt(len(ref))
    assert abs(port.mean() - exact) < n_se * se + 1e-9, (port.mean(), exact, se)
    assert abs(ref.mean() - exact) < n_se * se_ref + 1e-9, (ref.mean(), exact, se_ref)
    assert abs(port.mean() - ref.mean()) < n_se * math.hypot(se, se_ref) + 1e-9, (port.mean(), ref.mean())


def _ind_t(b):
    return torch.where(b, 1.0, 0.0)


def _ind_j(b):
    return jax.lax.cond(b, lambda: 1.0, lambda: 0.0)


# Unbatched sites: (name, port loss, JAX loss, argument, exact gradient).
def _square_loss(site_t, site_j):
    # E[(x - 2)^2] for x ~ N(mu, 1): d/dmu = 2 (mu - 2) = -3 at mu = 0.5.
    return (
        lambda mu: (site_t(mu, 1.0) - 2.0) ** 2,
        lambda mu: jnp.square(site_j(mu, 1.0) - 2.0),
    )


UNBATCHED = {
    "normal_reparam": (*_square_loss(tadev.normal_reparam, jadev.normal_reparam), 0.5, -3.0),
    "normal_reinforce": (*_square_loss(tadev.normal_reinforce, jadev.normal_reinforce), 0.5, -3.0),
    # E = p.
    "flip_reinforce": (lambda p: _ind_t(tadev.flip_reinforce(p)), lambda p: _ind_j(jadev.flip_reinforce(p)), 0.4, 1.0),
    "flip_mvd": (lambda p: _ind_t(tadev.flip_mvd(p)), lambda p: _ind_j(jadev.flip_mvd(p)), 0.4, 1.0),
    # A deliberately bad baseline of 5 leaves the estimate unbiased.
    "baseline_flip_reinforce": (
        lambda p: _ind_t(tadev.baseline(tadev.flip_reinforce)(5.0, p)),
        lambda p: _ind_j(jadev.baseline(jadev.flip_reinforce)(5.0, p)),
        0.4,
        1.0,
    ),
    # Failures before the first success: E = (1 - p) / p, d/dp = -1 / p^2.
    "geometric_reinforce": (
        lambda p: tadev.geometric_reinforce(p).float(),
        lambda p: jadev.geometric_reinforce(p).astype(jnp.float32),
        0.6,
        -1.0 / 0.36,
    ),
    # E[Beta(a, 2)] = a / (a + 2): d/da = 2 / (a + 2)^2 at a = 1.
    "beta_implicit": (lambda a: tadev.beta_implicit(a, 2.0), lambda a: jadev.beta_implicit(a, 2.0), 1.0, 2.0 / 9.0),
    # E[Gamma(c, rate r)] = c / r: d/dc = 1 / r, d/dr = -c / r^2.
    "gamma_implicit_concentration": (
        lambda c: tadev.gamma_implicit(c, 2.0),
        lambda c: jadev.gamma_implicit(c, 2.0),
        3.0,
        0.5,
    ),
    "gamma_implicit_rate": (
        lambda r: tadev.gamma_implicit(3.0, r),
        lambda r: jadev.gamma_implicit(3.0, r),
        2.0,
        -0.75,
    ),
    # E[v^2] = c (c + 1) / r^2: d/dc = (2c + 1) / r^2 = 5 at c = 2, r = 1.
    "gamma_implicit_second_moment": (
        lambda c: tadev.gamma_implicit(c, 1.0) ** 2,
        lambda c: jadev.gamma_implicit(c, 1.0) ** 2,
        2.0,
        5.0,
    ),
    # E[v_0] = a0 / (a0 + a1 + a2): d/da0 = (a1 + a2) / A^2 = 5 / 36.
    "dirichlet_implicit": (
        lambda a0: tadev.dirichlet_implicit(torch.stack([a0, torch.tensor(2.0), torch.tensor(3.0)]))[0],
        lambda a0: jadev.dirichlet_implicit(jnp.array([a0, 2.0, 3.0]))[0],
        1.0,
        5.0 / 36.0,
    ),
}


@pytest.mark.parametrize("case", sorted(UNBATCHED))
def test_unbatched_strategy_is_unbiased_like_jax(case):
    tsrc, jsrc, x, exact = UNBATCHED[case]
    _stat(_port_draws(tadev.expectation(tsrc), (x,)), _jax_draws(jadev.expectation(jsrc), (x,)), exact)
