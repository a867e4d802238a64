"""The port's variational objectives (`genjax_tpu_torch.inference.vi`) and
BASELINE config 5 (`genjax_tpu_torch.models.ravi`) against
`genjax_tpu.inference.vi` and `genjax_tpu.models.ravi` on the CPU.

Random quantities are held at 5 standard errors: a mean of R independent
gradient estimates against its closed form, and against JAX's mean of R
estimates on its own keys (5 combined SE). A gradient at a known optimum
has mean 0. The guide's sites run their strategies through
`ImportanceK`'s particle axis, and each gradient passes through the
logsumexp wrapper's plain twin (`ops.logsumexp` on the CPU). Wake-sleep,
`fit` and `advi`: `tests/test_torch_vi_drivers.py`.
"""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.inference import vi as jvi
from genjax_tpu.models import ravi as jravi
from genjax_tpu_torch import convert
from genjax_tpu_torch.inference import vi as tvi
from genjax_tpu_torch.models import ravi as travi

torch.set_num_threads(1)


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


def _port_draws(step, args, r):
    return np.array([[float(g) for g in step(_rng(s), args)] for s in range(r)])


def _jax_draws(step, args, r):
    keys = jax.random.split(jax.random.key(23), r)
    out = jax.jit(jax.vmap(lambda k: jnp.stack([jnp.asarray(g) for g in step(k, args)])))(keys)
    return np.asarray(out, dtype=np.float64)


def _stat(port, ref, exact, n_se=5.0):
    """Per column: the port's mean within n_se SE of `exact`, JAX's too,
    and the two within n_se combined SE."""
    port, ref = np.atleast_2d(port.T).T, np.atleast_2d(ref.T).T
    exact = np.broadcast_to(np.asarray(exact, dtype=np.float64), port.shape[1:])
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    se = port.std(0, ddof=1) / math.sqrt(len(port))
    se_ref = ref.std(0, ddof=1) / math.sqrt(len(ref))
    assert np.all(np.abs(port.mean(0) - exact) < n_se * se + 1e-9), (port.mean(0), exact, se)
    assert np.all(np.abs(ref.mean(0) - exact) < n_se * se_ref + 1e-9), (ref.mean(0), exact, se_ref)
    assert np.all(np.abs(port.mean(0) - ref.mean(0)) < n_se * np.hypot(se, se_ref) + 1e-9)


def test_elbo_gradient_at_the_origin_matches_the_closed_form_like_jax():
    # Negated ELBO of N(vmu, exp(vls)) against mu ~ N(0, 1), y ~ N(mu, 0.5),
    # y = 2: gradient (5 vmu - 8, 5 exp(2 vls) - 1) = (-8, 4) at (0, 0).
    port = _port_draws(tvi.ELBO(travi.guide, travi.make_target), (0.0, 0.0), 512)
    ref = _jax_draws(jvi.ELBO(jravi.guide, jravi.make_target), (0.0, 0.0), 512)
    _stat(port, ref, [-8.0, 4.0])


def test_iwelbo_gradient_vanishes_in_mean_and_its_value_is_the_lml():
    # The IWELBO at N = 4096 is log Z up to O(1/N): the gradient with
    # respect to the guide has mean ~0 and the value is -log Z.
    step = tvi.IWELBO(travi.guide, travi.make_target, N=4096)
    port = _port_draws(step, (0.0, 0.0), 24)
    ref = _jax_draws(jvi.IWELBO(jravi.guide, jravi.make_target, N=4096), (0.0, 0.0), 24)
    _stat(port, ref, [0.0, 0.0])

    @tgx.adev.expectation
    def neg_iwelbo(vmu, vls):
        target = travi.make_target(vmu, vls)
        return -tgx.ImportanceK(target, travi.guide, k_particles=4096).estimate_normalizing_constant(_rng(5), target)

    values = np.array([float(neg_iwelbo.estimate(_rng(s), (0.0, 0.0))) for s in range(24)])
    se = values.std(ddof=1) / math.sqrt(len(values))
    assert abs(values.mean() + travi.exact_lml()) < 5 * se + 1e-4


def test_iwelbo_flip_enum_guide_matches_its_closed_form_like_jax():
    # IWELBO (N=4) with a flip_enum guide over a binary latent: the batched,
    # per-site Rao-Blackwellized enumeration. The exact gradient enumerates
    # all 2^4 particle assignments (`tests/inference/test_vi.py:145`).
    p_z, p_y = 0.3, (0.2, 0.9)
    n = 4

    @tgx.gen
    def tmodel(_q):
        z = tgx.flip(p_z) @ "z"
        _ = tgx.flip(torch.where(z, p_y[1], p_y[0])) @ "y"

    @tgx.marginal()
    @tgx.gen
    def tguide(target):
        (q,) = target.args
        _ = tvi.flip_enum(q) @ "z"

    @jgx.gen
    def jmodel(_q):
        z = jgx.flip(p_z) @ "z"
        _ = jgx.flip(jnp.where(z, p_y[1], p_y[0])) @ "y"

    @jgx.marginal()
    @jgx.gen
    def jguide(target):
        (q,) = target.args
        _ = jvi.flip_enum(q) @ "z"

    def exact_neg_iwelbo(q):
        total = 0.0
        for zs in itertools.product([False, True], repeat=n):
            zs = jnp.array(zs)
            log_w = jnp.where(zs, jnp.log(p_z * p_y[1]), jnp.log((1 - p_z) * p_y[0])) - jnp.where(
                zs, jnp.log(q), jnp.log(1 - q)
            )
            total += jnp.prod(jnp.where(zs, q, 1 - q)) * (jax.scipy.special.logsumexp(log_w) - jnp.log(n))
        return -total

    exact = float(jax.grad(exact_neg_iwelbo)(0.4))
    step = tvi.IWELBO(tguide, lambda q: tgx.Target(tmodel, (q,), tgx.ChoiceMap.kw(y=True)), N=n)
    jstep = jvi.IWELBO(jguide, lambda q: jgx.Target(jmodel, (q,), jgx.ChoiceMap.kw(y=True)), N=n)
    _stat(_port_draws(step, (0.4,), 200), _jax_draws(jstep, (0.4,), 1000), exact)


def test_iwelbo_reinforce_guide_is_unbiased_at_the_optimum_like_jax():
    # The guide family holds the posterior N(3 * 100 / 100.01, 0.1): the
    # IWELBO gradient (N = 4, batched REINFORCE) has mean 0 there.
    opt = 3.0 * 100.0 / (100.0 + 0.01)

    @tgx.gen
    def tmodel(_vmu):
        mu = tgx.normal(0.0, 10.0) @ "mu"
        _ = tgx.normal(mu, 0.1) @ "v"

    @tgx.marginal()
    @tgx.gen
    def tguide(target):
        (vmu,) = target.args
        _ = tvi.normal_reinforce(vmu, 0.1) @ "mu"

    @jgx.gen
    def jmodel(_vmu):
        mu = jgx.normal(0.0, 10.0) @ "mu"
        _ = jgx.normal(mu, 0.1) @ "v"

    @jgx.marginal()
    @jgx.gen
    def jguide(target):
        (vmu,) = target.args
        _ = jvi.normal_reinforce(vmu, 0.1) @ "mu"

    step = tvi.IWELBO(tguide, lambda v: tgx.Target(tmodel, (v,), tgx.ChoiceMap.kw(v=3.0)), N=4)
    jstep = jvi.IWELBO(jguide, lambda v: jgx.Target(jmodel, (v,), jgx.ChoiceMap.kw(v=3.0)), N=4)
    _stat(_port_draws(step, (opt,), 1000), _jax_draws(jstep, (opt,), 2000), 0.0)


def test_jax_trained_ravi_parameters_carried_across_give_the_same_lml():
    # Train in JAX, carry the parameters over, and estimate the LML at
    # K = 8192 on both sides: the means agree within 5 combined SE, and
    # each is within 5 SE of the exact LML.
    params = jravi.train_guide(jax.random.key(13), n_steps=150)
    carried = convert.variational_params(tuple(np.asarray(p) for p in params), device="cpu")
    runs = 16
    port = np.array([float(travi.nested_smc_lml(_rng(s), carried, 8192, device="cpu")) for s in range(runs)])
    keys = jax.random.split(jax.random.key(14), runs)
    ref = np.asarray(jax.jit(jax.vmap(lambda k: jravi.nested_smc_lml(k, params, 8192)))(keys), dtype=np.float64)
    _stat(port, ref, travi.exact_lml())
    # The carried guide scores a value as the JAX guide does.
    for mu in (-1.0, 1.6, 2.5):
        jw = jravi.guide.estimate_logpdf(jax.random.key(0), jgx.ChoiceMap.kw(mu=mu), jravi.make_target(*params))
        tw = travi.guide.estimate_logpdf(_rng(0), tgx.ChoiceMap.kw(mu=mu), travi.make_target(*carried))
        np.testing.assert_allclose(float(tw), float(jw), rtol=1e-5, atol=1e-5)


def test_train_guide_finds_the_posterior():
    vmu, vls = travi.train_guide(0, n_steps=150, device="cpu")
    assert abs(float(vmu) - 1.6) < 0.25
    assert abs(math.exp(float(vls)) - math.sqrt(0.2)) < 0.1


def test_run_ravi_on_the_cpu():
    params, guided, prior, exact = travi.run_ravi(1, n_train=150, k_particles=8192, device="cpu")
    assert abs(float(params[0]) - 1.6) < 0.25
    assert abs(float(guided) - exact) < 0.02
    assert abs(float(prior) - exact) < 0.1


def test_entry_points_refuse_a_generator_on_another_device():
    with pytest.raises(ValueError, match="device"):
        travi.train_guide(_rng(), n_steps=1, device="meta")
