"""Kalman inference (`inference/kalman.py`) and structural time series
(`models/sts.py`), port against JAX on the CPU.

Deterministic, on the same numpy-made series: the filter's means,
covariances and log marginal likelihood, the RTS smoother's means and
covariances, and a batched `kalman_predict_update` against JAX's `vmap`,
for a scalar model and a 3-state model with a 2-D observation; STS `lml`,
`decompose` (through the `eigh` pseudo-inverse: the smoothed results are
compared, not eigenvectors) and `forecast` for trend + seasonal + AR; and
`fit` after 40 Adam steps (optax's update written out) against optax's.
All in float32, the recursions summing in different orders: 1e-4 of the
largest |value| for filtered and smoothed moments and forecasts (the
Kalman moments agree far closer; the STS decomposition, through the `eigh`
pseudo-inverse, is the loosest), 1e-4 for the fitted scales and the
evidence history.

Statistical and structural, after `tests/distributions/test_sts.py`: a
single-level STS is the raw SSM; the level forecast has its closed form;
sampling with a singular Q stays finite and the decomposition recovers
the seasonal and level states; 100 Adam steps on 100 points recover the
noise scales.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu.inference.kalman as jk
import genjax_tpu.models.sts as js
import genjax_tpu_torch.inference.kalman as tk
import genjax_tpu_torch.models.sts as ts

torch.set_num_threads(1)


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(1.0, np.abs(ref).max()))


def _models():
    rng = np.random.default_rng(0)
    A = np.array([[0.9, 0.1, 0.0], [0.0, 0.8, 0.2], [0.1, 0.0, 0.7]], np.float32)
    Lq = 0.3 * rng.standard_normal((3, 3)).astype(np.float32)
    H = rng.standard_normal((2, 3)).astype(np.float32)
    mats = dict(
        a=A, q=(Lq @ Lq.T + 0.05 * np.eye(3)).astype(np.float32), h=H,
        r=np.array([[0.3, 0.05], [0.05, 0.2]], np.float32), d=3, p=2,
        mu0=np.array([0.5, -0.5, 0.0], np.float32), p0=np.float32(1.2),
    )
    scalar = dict(a=0.9, q=0.5, h=1.0, r=0.4, d=1)
    return {"scalar": (scalar, 1), "matrix": (mats, 2)}


def _build(lib, spec):
    conv = jnp.asarray if lib is jk else torch.as_tensor
    kw = {} if lib is jk else {"device": "cpu"}
    return lib.LinearGaussianSSM.build(**{k: conv(v) if isinstance(v, np.ndarray) else v for k, v in spec.items()}, **kw)


@pytest.mark.parametrize("name", ["scalar", "matrix"])
def test_filter_smooth_lml_match_jax(name):
    spec, p = _models()[name]
    ys = np.random.default_rng(1).standard_normal((30, p)).astype(np.float32)
    jm, tm = _build(jk, spec), _build(tk, spec)
    for got, ref in zip(tm.filter(torch.from_numpy(ys)), jm.filter(jnp.asarray(ys))):
        _close(got, ref, 1e-4)
    _close(tm.lml(torch.from_numpy(ys)), jm.lml(jnp.asarray(ys)), 1e-4)
    for got, ref in zip(tm.smooth(torch.from_numpy(ys)), jm.smooth(jnp.asarray(ys))):
        _close(got, ref, 1e-4)
    zs, ysim = tm.sample(torch.Generator().manual_seed(0), 12)
    assert zs.shape == (12, spec["d"]) and ysim.shape == (12, p) and bool(torch.isfinite(ysim).all())


def test_batched_predict_update_matches_vmapped_jax():
    spec, p = _models()["matrix"]
    jm, tm = _build(jk, spec), _build(tk, spec)
    rng = np.random.default_rng(2)
    mu = rng.standard_normal((16, 3)).astype(np.float32)
    L = 0.5 * rng.standard_normal((16, 3, 3)).astype(np.float32)
    P = (L @ L.transpose(0, 2, 1) + 0.1 * np.eye(3)).astype(np.float32)
    y = rng.standard_normal((16, p)).astype(np.float32)
    ref = jax.vmap(lambda m, c, o: jk.kalman_predict_update(jm.A, jm.Q, jm.H, jm.R, m, c, o))(
        jnp.asarray(mu), jnp.asarray(P), jnp.asarray(y)
    )
    got = tk.kalman_predict_update(tm.A, tm.Q, tm.H, tm.R, torch.from_numpy(mu), torch.from_numpy(P),
                                   torch.from_numpy(y))
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)


def _sts(lib):
    kw = {} if lib is js else {"device": "cpu"}
    return lib.StructuralTimeSeries(
        (lib.local_linear_trend(0.1, 0.05, 5.0, **kw), lib.seasonal(4, 0.05, **kw), lib.ar(0.7, 0.2, **kw)),
        obs_noise=0.3,
    )


def _series(T: int = 40) -> np.ndarray:
    t = np.arange(T)
    rng = np.random.default_rng(3)
    return (0.05 * t + np.sin(np.pi * t / 2) + 0.3 * rng.standard_normal(T)).astype(np.float32)


def test_sts_lml_decompose_forecast_match_jax():
    ys = _series()
    jsts, tsts = _sts(js), _sts(ts)
    _close(tsts.lml(torch.from_numpy(ys)), jsts.lml(jnp.asarray(ys)), 1e-4)
    ref_parts, parts = jsts.decompose(jnp.asarray(ys)), tsts.decompose(torch.from_numpy(ys))
    assert sorted(parts) == sorted(ref_parts) == ["ar1", "seasonal4", "trend"]
    for k in parts:
        _close(parts[k], ref_parts[k], 1e-4)
    for got, ref in zip(tsts.forecast(torch.from_numpy(ys), 6), jsts.forecast(jnp.asarray(ys), 6)):
        _close(got, ref, 1e-4)


def test_sts_fit_matches_optax_step_for_step():
    ys = _series(30)
    init_j = js.StructuralTimeSeries((js.local_level(0.05, 1.0), js.seasonal(4, 0.02)), obs_noise=1.0)
    init_t = ts.StructuralTimeSeries(
        (ts.local_level(0.05, 1.0, device="cpu"), ts.seasonal(4, 0.02, device="cpu")), obs_noise=1.0
    )
    fit_j, hist_j = init_j.fit(jnp.asarray(ys), n_steps=40)
    fit_t, hist_t = init_t.fit(torch.from_numpy(ys), n_steps=40)
    _close(hist_t, hist_j, 1e-4)
    for cj, ct in zip(fit_j.components, fit_t.components):
        _close(ct.q, cj.q, 1e-4)
    _close(fit_t.obs_noise, fit_j.obs_noise, 1e-4)
    # The seasonal block's structural zeros stay zero.
    assert bool((fit_t.components[1].q[1:] == 0.0).all())


def test_single_level_equals_raw_ssm_and_forecast_closed_form():
    ys = torch.tensor([0.3, 1.0, 0.5, -0.2, 0.8])
    sts = ts.StructuralTimeSeries((ts.local_level(0.2, initial_scale=1.0, device="cpu"),), obs_noise=0.3)
    ref = tk.LinearGaussianSSM.build(a=1.0, q=0.2, h=1.0, r=0.3, p0=1.0, device="cpu")
    assert torch.allclose(sts.lml(ys), ref.lml(ys[:, None]), atol=1e-5)
    means, variances = sts.forecast(ys, 3)
    mus, Ps, _ = ref.filter(ys[:, None])
    assert torch.allclose(means, mus[-1, 0].expand(3), atol=1e-6)
    expected = torch.tensor([float(Ps[-1, 0, 0]) + k * 0.04 + 0.09 for k in (1, 2, 3)])
    assert torch.allclose(variances, expected, atol=1e-6)
    m = _sts(ts).ssm()
    assert m.A.shape == (6, 6) and float(m.A[0, 2]) == 0.0 and float(m.A[5, 0]) == 0.0


def test_decomposition_recovers_seasonal_and_level():
    sts = ts.StructuralTimeSeries(
        (ts.local_level(0.05, device="cpu"), ts.seasonal(4, 0.01, device="cpu")), obs_noise=0.2
    )
    zs, yobs = sts.ssm().sample(torch.Generator().manual_seed(0), 48)
    assert bool(torch.isfinite(yobs).all())  # singular Q: the eigh square root
    parts = sts.decompose(yobs[:, 0])
    assert np.corrcoef(zs[:, 1].numpy(), parts["seasonal4"].numpy())[0, 1] > 0.99
    assert np.corrcoef(zs[:, 0].numpy(), parts["level"].numpy())[0, 1] > 0.85


def test_gradient_fit_recovers_scales():
    true = ts.StructuralTimeSeries((ts.local_level(0.3, initial_scale=1.0, device="cpu"),), obs_noise=0.2)
    _, ysim = true.ssm().sample(torch.Generator().manual_seed(1), 100)
    y = ysim[:, 0]
    init = ts.StructuralTimeSeries((ts.local_level(0.05, initial_scale=1.0, device="cpu"),), obs_noise=1.0)
    fitted, history = init.fit(y, n_steps=100, learning_rate=0.1)
    assert float(fitted.lml(y)) >= float(true.lml(y)) - 1.0
    assert float(fitted.lml(y)) > float(init.lml(y)) + 25.0
    assert abs(float(fitted.components[0].q[0]) - 0.3) < 0.1
    assert abs(float(fitted.obs_noise) - 0.2) < 0.1
    assert history[-1] > history[0]
