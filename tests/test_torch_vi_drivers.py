"""The port's wake-sleep gradients, the `fit` driver and automatic
mean-field VI (`genjax_tpu_torch.inference.vi`: `PWake`, `QWake`, `fit`,
`advi`, `mean_field_guide`) against `genjax_tpu.inference.vi` on the CPU.

Gradients at a known optimum have mean 0: the port's mean of R estimates
lies within 5 standard errors of it, JAX's too, and the two within 5
combined SE. The training loops are held to the tolerances of JAX's own
tests (`tests/inference/test_vi.py:253`, `tests/inference/test_advi.py`).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.inference import vi as jvi
from genjax_tpu_torch.inference import vi as tvi

torch.set_num_threads(1)


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


def _port_draws(step, args, r):
    return np.array([[float(g) for g in pytree.tree_leaves(step(_rng(s), args))] for s in range(r)])


def _jax_draws(step, args, r):
    keys = jax.random.split(jax.random.key(23), r)
    out = jax.jit(jax.vmap(lambda k: jnp.stack([jnp.asarray(g) for g in jax.tree_util.tree_leaves(step(k, args))])))(keys)
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


def _wake_sleep(gx, vi, backend):
    """The wake-sleep setting of `tests/inference/test_vi.py:253`: a fixed
    posterior approximation q* = N(0.8, 0.6); PWake's optimum is theta* =
    0.8, QWake's (phi_mu, phi_sd) = (0.8, 0.6)."""
    exp = torch.exp if backend == "torch" else jnp.exp

    @gx.gen
    def model(theta, _pmu, _plogsd):
        mu = gx.normal(theta, 1.0) @ "mu"
        _ = gx.normal(mu, 0.5) @ "y"

    @gx.marginal()
    @gx.gen
    def posterior_approx(target):
        _ = vi.normal_reparam(0.8, 0.6) @ "mu"

    @gx.marginal()
    @gx.gen
    def proposal(target):
        (_theta, pmu, plogsd) = target.args
        _ = vi.normal_reparam(pmu, exp(plogsd)) @ "mu"

    def make_target(theta, pmu, plogsd):
        return gx.Target(model, (theta, pmu, plogsd), gx.ChoiceMap.kw(y=1.0))

    return vi.PWake(posterior_approx, make_target), vi.QWake(proposal, posterior_approx, make_target)


def test_wake_sleep_gradients_vanish_at_the_known_optima_like_jax():
    t_p, t_q = _wake_sleep(tgx, tvi, "torch")
    j_p, j_q = _wake_sleep(jgx, jvi, "jax")
    optimum = (0.8, 0.8, math.log(0.6))
    _stat(_port_draws(t_p, optimum, 400)[:, :1], _jax_draws(j_p, optimum, 1000)[:, :1], 0.0)
    _stat(_port_draws(t_q, optimum, 400)[:, 1:], _jax_draws(j_q, optimum, 1000)[:, 1:], [0.0, 0.0])
    # Away from the optimum they point back to it: dtheta = theta - 0.8,
    # dphi_mu = phi_mu - 0.8 (with phi_sd = 0.6).
    away = (0.0, 0.0, math.log(0.6))
    _stat(_port_draws(t_p, away, 400)[:, :1], _jax_draws(j_p, away, 1000)[:, :1], -0.8)
    q = _port_draws(t_q, away, 400)
    assert abs(q[:, 1].mean() + 0.8 / 0.36) < 5 * q[:, 1].std(ddof=1) / math.sqrt(len(q))


def test_wake_sleep_drives_the_parameters_to_the_known_optima():
    # The loop of `tests/inference/test_vi.py:253`, same tolerances.
    p_step, q_step = _wake_sleep(tgx, tvi, "torch")
    params = (0.0, 0.0, 0.0)
    rng = _rng(41)
    trail = []
    for i in range(600):
        d_theta = float(p_step(rng, params)[0])
        d_phi = [float(g) for g in q_step(rng, params)]
        lr = 5e-2 if i < 400 else 1e-2
        params = (params[0] - lr * d_theta, params[1] - lr * d_phi[1], params[2] - lr * d_phi[2])
        if i >= 500:
            trail.append(params)
    avg = np.mean(np.array(trail), 0)
    assert avg[0] == pytest.approx(0.8, abs=0.15)
    assert avg[1] == pytest.approx(0.8, abs=0.15)
    assert math.exp(avg[2]) == pytest.approx(0.6, abs=0.12)


@tgx.gen
def conjugate():
    mu = tgx.normal(0.0, 1.0) @ "mu"
    _ = tgx.normal(mu, 1.0) @ "y"


@jgx.gen
def jconjugate():
    mu = jgx.normal(0.0, 1.0) @ "mu"
    _ = jgx.normal(mu, 1.0) @ "y"


def test_advi_elbo_gradient_vanishes_at_the_conjugate_posterior_like_jax():
    # y = 2: the posterior is N(1, 1/sqrt(2)), in the guide family, so the
    # mean-field ELBO's gradient has mean 0 at (mu, log_sigma) = (1, log(1/sqrt 2)).
    specs = tvi._discover_flat_latents(conjugate, (), tgx.ChoiceMap.kw(y=2.0))
    assert specs == {"mu": ()}
    assert jvi._discover_flat_latents(jconjugate, (), jgx.ChoiceMap.kw(y=2.0)) == {"mu": ()}
    t_guide, j_guide = tvi.mean_field_guide(specs), jvi.mean_field_guide({"mu": ()})
    t_wrapped = conjugate.contramap(lambda *a: a[:-1])
    j_wrapped = jconjugate.contramap(lambda *a: a[:-1])

    def t_target(mu, log_sigma):
        return tgx.Target(t_wrapped, ({"mu": {"log_sigma": log_sigma, "mu": mu}},), tgx.ChoiceMap.kw(y=2.0))

    def j_target(mu, log_sigma):
        return jgx.Target(j_wrapped, ({"mu": {"log_sigma": log_sigma, "mu": mu}},), jgx.ChoiceMap.kw(y=2.0))

    opt = (1.0, math.log(1.0 / math.sqrt(2.0)))
    _stat(_port_draws(tvi.ELBO(t_guide, t_target), opt, 512), _jax_draws(jvi.ELBO(j_guide, j_target), opt, 512), [0.0, 0.0])


def test_advi_recovers_the_conjugate_posterior():
    params, guide, make_target, gnorms = tvi.advi(0, conjugate, (), tgx.ChoiceMap.kw(y=2.0), n_steps=1500, device="cpu")
    assert abs(float(params["mu"]["mu"]) - 1.0) < 0.1
    assert abs(math.exp(float(params["mu"]["log_sigma"])) - 0.7071) < 0.1
    _, latents = guide.random_weighted(_rng(1), make_target(params))
    assert bool(torch.isfinite(latents["mu"]))
    assert gnorms.shape == (1500,) and bool(torch.isfinite(gnorms).all())


def test_fit_driver_standalone_with_adam_defaults():
    @tgx.marginal()
    @tgx.gen
    def guide(target):
        vmu, log_vsigma = target.args
        _ = tvi.normal_reparam(vmu, torch.exp(log_vsigma)) @ "mu"

    wrapped = conjugate.contramap(lambda *a: ())

    def make_target(vmu, log_vsigma):
        return tgx.Target(wrapped, (vmu, log_vsigma), tgx.ChoiceMap.kw(y=2.0))

    (vmu, vls), gnorms = tvi.fit(4, tvi.ELBO(guide, make_target), (0.0, 0.0), n_steps=1500, device="cpu")
    assert abs(float(vmu) - 1.0) < 0.1
    assert gnorms.shape == (1500,)


def test_advi_refuses_nested_discrete_and_rank_two_latents_like_jax():
    @tgx.gen
    def inner():
        return tgx.normal(0.0, 1.0) @ "u"

    @tgx.gen
    def nested():
        z = inner() @ "sub"
        _ = tgx.normal(z, 1.0) @ "y"

    @tgx.gen
    def mixed():
        b = tgx.flip(0.3) @ "b"
        _ = tgx.normal(torch.where(b, 1.0, -1.0), 1.0) @ "y"

    with pytest.raises(NotImplementedError, match="flat"):
        tvi.advi(3, nested, (), tgx.ChoiceMap.kw(y=1.0), device="cpu")
    with pytest.raises(NotImplementedError, match="real-valued"):
        tvi.advi(5, mixed, (), tgx.ChoiceMap.kw(y=0.5), device="cpu")
    with pytest.raises(NotImplementedError, match="rank"):
        tvi.mean_field_guide({"m": (2, 3)})
    with pytest.raises(NotImplementedError, match="rank"):
        jvi.mean_field_guide({"m": (2, 3)})


def test_mean_field_guide_over_a_vector_latent_scores_like_jax():
    specs = {"w": (2,)}
    params = {"w": {"mu": np.array([0.5, -1.0], np.float32), "log_sigma": np.array([0.1, -0.3], np.float32)}}
    t_guide, j_guide = tvi.mean_field_guide(specs), jvi.mean_field_guide(specs)
    t_params = {"w": {k: torch.from_numpy(v) for k, v in params["w"].items()}}
    j_params = {"w": {k: jnp.asarray(v) for k, v in params["w"].items()}}
    w = np.array([0.3, -0.2], np.float32)
    tw = t_guide.estimate_logpdf(_rng(), tgx.ChoiceMap.kw(w=torch.from_numpy(w)), tgx.Target(conjugate, (t_params,), tgx.ChoiceMap.empty()))
    jw = j_guide.estimate_logpdf(jax.random.key(0), jgx.ChoiceMap.kw(w=jnp.asarray(w)), jgx.Target(jconjugate, (j_params,), jgx.ChoiceMap.empty()))
    np.testing.assert_allclose(float(tw), float(jw), rtol=1e-5, atol=1e-5)
