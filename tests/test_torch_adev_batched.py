"""The port's batched ADEV strategies whose estimates are random
(per-site Rao-Blackwellized enumeration and MVD over a continuation that
is not linear, REINFORCE with and without per-lane baselines) against the
closed-form gradient of their expectation and against `genjax_tpu.adev`'s
own estimates under `jax.vmap`, on the CPU.

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


def _jax_vmapped(prim, n, *args):
    keys = jax.random.split(jax.random.key(1), n)
    return jax.vmap(lambda k: jadev.sample_primitive(prim, *args, key=k))(keys)


def _sq_count_t(prim):
    return lambda p: _ind_t(prim(p, n=3)).sum() ** 2


def _sq_count_j(prim):
    return lambda p: jnp.sum(jnp.where(_jax_vmapped(prim, 3, p), 1.0, 0.0)) ** 2


# Batched sites (n lanes): (port loss, JAX loss, argument, exact gradient, draws).
BATCHED = {
    # (sum b_i)^2 for 3 iid Bern(p): dE/dp = n (1 - 2p) + 2 n^2 p.
    "flip_enum_nonlinear": (
        _sq_count_t(tadev.flip_enum), _sq_count_j(jadev.flip_enum), 0.4, 3 * 0.2 + 18 * 0.4, 800
    ),
    "flip_mvd_nonlinear": (
        _sq_count_t(tadev.flip_mvd), _sq_count_j(jadev.flip_mvd), 0.4, 3 * 0.2 + 18 * 0.4, 1000
    ),
    # sum (x_i - 2)^2, x_i ~ N(mu, 1), 4 lanes: d/dmu = 8 (mu - 2).
    "normal_reinforce": (
        lambda mu: ((tadev.normal_reinforce(mu, 1.0, n=4) - 2.0) ** 2).sum(),
        lambda mu: jnp.sum(jnp.square(_jax_vmapped(jadev.normal_reinforce, 4, mu, 1.0) - 2.0)),
        0.5,
        -12.0,
        R,
    ),
    "flip_reinforce": (
        lambda p: _ind_t(tadev.flip_reinforce(p, n=3)).sum(),
        lambda p: jnp.sum(jnp.where(_jax_vmapped(jadev.flip_reinforce, 3, p), 1.0, 0.0)),
        0.4,
        3.0,
        R,
    ),
    "baseline_flip_reinforce": (
        lambda p: _ind_t(tadev.sample_primitive(tadev.baseline(tadev.flip_reinforce), 0.5, p, n=3)).sum(),
        lambda p: jnp.sum(jnp.where(_jax_vmapped(jadev.baseline(jadev.flip_reinforce), 3, 0.5, p), 1.0, 0.0)),
        0.4,
        3.0,
        R,
    ),
}


@pytest.mark.parametrize("case", sorted(BATCHED))
def test_batched_strategy_is_unbiased_like_jax(case):
    tsrc, jsrc, x, exact, r = BATCHED[case]
    port = _port_draws(tadev.expectation(tsrc), (x,), r)
    ref = _jax_draws(jadev.expectation(jsrc), (x,), 2000)
    _stat(port, ref, exact)
