"""The port's ADEV (`genjax_tpu_torch.adev`) against `genjax_tpu.adev` on the
CPU.

Deterministic: where a strategy's gradient is exact whatever the draw
(enumeration over a continuation that is linear in the enumerated values,
`add_cost`, `jvp_estimate`'s `Dual`), the port's `grad_estimate` equals
JAX's to float32 tolerance, `|got - ref| <= 1e-5 * max(1, |ref|)`.

Statistical: the mean of R independent gradient estimates (one walk each,
R generators seeded 0..R-1 on the port's side, `jax.random.split` keys on
JAX's) lies within 5 standard errors of the closed form, and within 5
combined standard errors of JAX's own mean over its R estimates.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu.adev as jadev
import genjax_tpu_torch.adev as tadev
from genjax_tpu_torch.core.typing import per_particle

torch.set_num_threads(1)


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), (got, ref)


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


def _port(loss, args, seed=0):
    return [g.numpy() for g in loss.grad_estimate(_rng(seed), args)]


def _jax(loss, args, seed=0):
    return [np.asarray(g) for g in loss.grad_estimate(jax.random.key(seed), args)]


def _port_draws(loss, args, r, argnum=0):
    return np.array([float(loss.grad_estimate(_rng(s), args)[argnum]) for s in range(r)])


def _jax_draws(loss, args, r, argnum=0):
    keys = jax.random.split(jax.random.key(17), r)
    return np.asarray(jax.jit(jax.vmap(lambda k: loss.grad_estimate(k, args)[argnum]))(keys), dtype=np.float64)


def _stat(port, ref, exact, n_se=5.0):
    """The port's mean within n_se SE of `exact` and within n_se combined
    SE of JAX's mean."""
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    se = port.std(ddof=1) / math.sqrt(len(port))
    se_ref = ref.std(ddof=1) / math.sqrt(len(ref))
    assert abs(port.mean() - exact) < n_se * se + 1e-9, (port.mean(), exact, se)
    assert abs(ref.mean() - exact) < n_se * se_ref + 1e-9, (ref.mean(), exact, se_ref)
    assert abs(port.mean() - ref.mean()) < n_se * math.hypot(se, se_ref) + 1e-9, (port.mean(), ref.mean())


def _ind(b, t=1.0, f=0.0):
    return torch.where(b, t, f)


# -- enumeration: exact ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flip_enum_gradient_is_exact_like_jax(seed):
    @tadev.expectation
    def tloss(p):
        return _ind(tadev.flip_enum(p))

    @jadev.expectation
    def jloss(p):
        return jax.lax.cond(jadev.flip_enum(p), lambda: 1.0, lambda: 0.0)

    got, ref = _port(tloss, (0.3,), seed), _jax(jloss, (0.3,), seed)
    _close(got, ref)
    _close(got, [1.0])  # E = p


@pytest.mark.parametrize(
    "name,p,exact",
    [("weighted", 0.5, 4.0), ("nonlinear", 0.4, 0.8)],
)
def test_flip_enum_continuations_like_jax(name, p, exact):
    # weighted: E = 3p - (1 - p); nonlinear: E = p * p.
    @tadev.expectation
    def tloss(q):
        b = tadev.flip_enum(q)
        return _ind(b, 3.0, -1.0) if name == "weighted" else _ind(b) * q

    @jadev.expectation
    def jloss(q):
        b = jadev.flip_enum(q)
        if name == "weighted":
            return jax.lax.cond(b, lambda: 3.0, lambda: -1.0)
        return jax.lax.cond(b, lambda: 1.0, lambda: 0.0) * q

    got = _port(tloss, (p,))
    _close(got, _jax(jloss, (p,)))
    _close(got, [exact])


def test_flip_enum_parallel_like_jax():
    @tadev.expectation
    def tloss(p):
        return _ind(tadev.flip_enum_parallel(p))

    @jadev.expectation
    def jloss(p):
        return jax.lax.cond(jadev.flip_enum_parallel(p), lambda: 1.0, lambda: 0.0)

    _close(_port(tloss, (0.3,)), _jax(jloss, (0.3,)))


def test_categorical_enum_gradient_and_value_like_jax():
    vals = np.array([0.0, 1.0, 4.0], dtype=np.float32)
    probs = np.array([0.2, 0.3, 0.5], dtype=np.float32)

    @tadev.expectation
    def tloss(pr):
        return torch.from_numpy(vals)[tadev.categorical_enum_parallel(pr)]

    @jadev.expectation
    def jloss(pr):
        return jnp.asarray(vals)[jadev.categorical_enum_parallel(pr)]

    got = _port(tloss, (torch.from_numpy(probs),))
    _close(got, _jax(jloss, (jnp.asarray(probs),)))
    exact = jax.grad(lambda p: jnp.sum(p / jnp.sum(p) * vals))(jnp.asarray(probs))
    _close(got, [np.asarray(exact)])
    # The primal is the normalized expectation, the sampler's semantics.
    probs2 = np.array([0.1, 0.6, 0.3], dtype=np.float32)
    v = tloss.estimate(_rng(), (torch.from_numpy(probs2),))
    _close(float(v), float(jloss.estimate(jax.random.key(0), (jnp.asarray(probs2),))))
    _close(float(v), float(np.sum(probs2 / probs2.sum() * vals)))


# -- batched enumeration: the linear sums are exact -----------------------------------


def _jax_vmapped(prim, n, *args):
    keys = jax.random.split(jax.random.key(1), n)
    return jax.vmap(lambda k: jadev.sample_primitive(prim, *args, key=k))(keys)


@pytest.mark.parametrize("which", ["flip_enum", "flip_enum_parallel"])
@pytest.mark.parametrize("seed", [0, 1])
def test_batched_flip_enum_linear_sum_exact_like_jax(which, seed):
    @tadev.expectation
    def tloss(p):
        return _ind(getattr(tadev, which)(p, n=3)).sum()

    @jadev.expectation
    def jloss(p):
        return jnp.sum(jnp.where(_jax_vmapped(getattr(jadev, which), 3, p), 1.0, 0.0))

    got = _port(tloss, (0.3,), seed)
    _close(got, _jax(jloss, (0.3,), seed))
    _close(got, [3.0])


def test_batched_flip_enum_per_site_parameters_exact_like_jax():
    vals = np.array([1.0, -2.0, 5.0], dtype=np.float32)
    ps = np.array([0.2, 0.5, 0.7], dtype=np.float32)

    @tadev.expectation
    def tloss(p):
        return torch.where(tadev.flip_enum(per_particle(p), n=3), torch.from_numpy(vals), 0.0).sum()

    @jadev.expectation
    def jloss(p):
        keys = jax.random.split(jax.random.key(1), 3)
        bs = jax.vmap(lambda k, pi: jadev.sample_primitive(jadev.flip_enum, pi, key=k))(keys, p)
        return jnp.sum(jnp.where(bs, vals, 0.0))

    got = _port(tloss, (torch.from_numpy(ps),))
    _close(got, _jax(jloss, (jnp.asarray(ps),)))
    _close(got, [vals])


def test_batched_categorical_enum_linear_sum_exact_like_jax():
    vals = np.array([0.0, 1.0, 4.0], dtype=np.float32)
    probs = np.array([0.2, 0.3, 0.5], dtype=np.float32)

    @tadev.expectation
    def tloss(pr):
        return torch.from_numpy(vals)[tadev.categorical_enum_parallel(pr, n=4)].sum()

    @jadev.expectation
    def jloss(pr):
        return jnp.sum(jnp.asarray(vals)[_jax_vmapped(jadev.categorical_enum_parallel, 4, pr)])

    got = _port(tloss, (torch.from_numpy(probs),))
    _close(got, _jax(jloss, (jnp.asarray(probs),)))
    exact = jax.grad(lambda p: 4.0 * jnp.sum(p / jnp.sum(p) * vals))(jnp.asarray(probs))
    _close(got, [np.asarray(exact)])


def test_batched_enum_baseline_is_an_exact_no_op_like_jax():
    wrapped_t, wrapped_j = tadev.baseline(tadev.flip_enum), jadev.baseline(jadev.flip_enum)

    @tadev.expectation
    def tloss(p):
        return _ind(tadev.sample_primitive(wrapped_t, 7.0, p, n=3)).sum()

    @jadev.expectation
    def jloss(p):
        keys = jax.random.split(jax.random.key(1), 3)
        bs = jax.vmap(lambda k: jadev.sample_primitive(wrapped_j, 7.0, p, key=k))(keys)
        return jnp.sum(jnp.where(bs, 1.0, 0.0))

    got = _port(tloss, (0.3,))
    _close(got, _jax(jloss, (0.3,)))
    _close(got, [3.0])


# -- add_cost, Dual, value_and_grad -------------------------------------------------------


def test_add_cost_contributes_to_the_gradient_like_jax():
    @tadev.expectation
    def tloss(p):
        tadev.add_cost(3.0 * p)
        return _ind(tadev.flip_enum(p))

    @jadev.expectation
    def jloss(p):
        jadev.add_cost(3.0 * p)
        return jax.lax.cond(jadev.flip_enum(p), lambda: 1.0, lambda: 0.0)

    got = _port(tloss, (0.25,))
    _close(got, _jax(jloss, (0.25,)))
    _close(got, [4.0])  # E = 3p + p


def test_multiple_costs_and_value_like_jax():
    @tadev.expectation
    def tgrad(p):
        tadev.add_cost(p)
        tadev.add_cost(p * p)
        return 0.0 * p

    @jadev.expectation
    def jgrad(p):
        jadev.add_cost(p)
        jadev.add_cost(p * p)
        return 0.0 * p

    _close(_port(tgrad, (0.5,)), _jax(jgrad, (0.5,)))
    _close(_port(tgrad, (0.5,)), [2.0])  # 1 + 2p

    @tadev.expectation
    def tvalue(p):
        tadev.add_cost(2.0 * p)
        return p

    @jadev.expectation
    def jvalue(p):
        jadev.add_cost(2.0 * p)
        return p

    got = float(tvalue.estimate(_rng(), (0.5,)))
    _close(got, float(jvalue.estimate(jax.random.key(0), (0.5,))))
    _close(got, 1.5)


def test_a_cost_after_a_reinforce_site_enters_its_score_term():
    # CPS order: REINFORCE multiplies the value of its continuation, which
    # holds the costs added after it and not those added before.
    # E = E_b[1(b) + c] with c = 5 after the site: dE/dp = 1, and the score
    # term's mean is (1 + 5) dlogp = 0 in expectation: the estimator stays
    # unbiased whatever c, as in JAX.
    @tadev.expectation
    def tloss(p):
        b = tadev.flip_reinforce(p)
        tadev.add_cost(torch.full((), 5.0))
        return _ind(b)

    @jadev.expectation
    def jloss(p):
        b = jadev.flip_reinforce(p)
        jadev.add_cost(5.0)
        return jax.lax.cond(b, lambda: 1.0, lambda: 0.0)

    _stat(_port_draws(tloss, (0.4,), 3000), _jax_draws(jloss, (0.4,), 3000), 1.0)


def test_jvp_estimate_dual_like_jax():
    @tadev.expectation
    def tloss(p):
        return _ind(tadev.flip_enum(p))

    @jadev.expectation
    def jloss(p):
        return jax.lax.cond(jadev.flip_enum(p), lambda: 1.0, lambda: 0.0)

    got = tloss.jvp_estimate(_rng(), (tadev.Dual(torch.tensor(0.3), torch.tensor(1.0)),))
    ref = jloss.jvp_estimate(jax.random.key(0), (jadev.Dual(jnp.asarray(0.3), jnp.asarray(1.0)),))
    _close(float(got.primal), float(ref.primal))
    _close(float(got.tangent), float(ref.tangent))
    _close([float(got.primal), float(got.tangent)], [0.3, 1.0])


def test_value_and_grad_like_jax():
    @tadev.expectation
    def tloss(p):
        return _ind(tadev.flip_enum(p), 2.0, 0.0)

    @jadev.expectation
    def jloss(p):
        return jax.lax.cond(jadev.flip_enum(p), lambda: 2.0, lambda: 0.0)

    v, (g,) = tloss.value_and_grad_estimate(_rng(), (0.25,))
    jv, (jg,) = jloss.value_and_grad_estimate(jax.random.key(0), (0.25,))
    _close([float(v), float(g)], [float(jv), float(jg)])
    _close(float(g), 2.0)


def test_sites_outside_an_expectation_sample_plainly():
    rng = _rng(3)
    v = tadev.normal_reparam.sample(rng, torch.tensor(1.0), torch.tensor(2.0), n=5)
    assert v.shape == (5,) and v.grad_fn is None
    assert tadev.flip_enum(0.5).dtype == torch.bool


def test_an_execution_that_raises_leaves_no_handler_behind():
    @tadev.expectation
    def bad(p):
        tadev.flip_enum(p)
        raise ValueError("inside the loss")

    with pytest.raises(ValueError, match="inside the loss"):
        bad.grad_estimate(_rng(), (0.3,))
    assert tadev.flip_enum(0.5).shape == ()  # a plain draw: no ADEV handler left on the stack
