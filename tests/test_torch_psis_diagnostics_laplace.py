"""Convergence diagnostics (`inference/diagnostics.py`), PSIS
(`inference/psis.py`) and MAP/Laplace (`inference/map_laplace.py`), port
against JAX on the CPU.

Deterministic, on the same numpy-made inputs: `split_rhat` and
`effective_sample_size` on iid, drifting and AR(1) chains with trailing
axes and odd step counts (1e-5 relative); `fit_gpd_shape` on GPD tails
across shape regimes, `pareto_k` and `psis_smooth` on Gaussian importance
weights, `elpd_loo` and `elpd_waic` on a pointwise log-likelihood matrix
(1e-4 relative: the grid softmax and the tail quantiles sum hundreds of
float32 terms in different orders); `map_estimate` after 60 Adam steps
against optax's Adam (the iterates and the log-density history, 1e-5
relative), and the Laplace covariance and evidence at the mode (1e-4
relative: a Hessian by double backward against `jax.hessian`).

Statistical and exact, after the JAX tests: R-hat flags disjoint and
drifting chains, ESS tracks the AR(1) closed form; the GPD fit recovers
its shape, k-hat orders proposals, equal weights give -inf, smoothing
never inflates; LOO matches the exact leave-one-out predictive; the
Laplace approximation is exact on a Gaussian posterior, and its samples
have its covariance.
"""

import math

import jax
import jax.numpy as jnp
import jax.random as jrand
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.inference import diagnostics as jd
from genjax_tpu.inference import map_laplace as jml
from genjax_tpu.inference import psis as jp
from genjax_tpu.models.logreg import logistic_regression as jax_logreg
from genjax_tpu_torch.inference import diagnostics as td
from genjax_tpu_torch.inference import map_laplace as tml
from genjax_tpu_torch.inference import psis as tp
from genjax_tpu_torch.models.logreg import logistic_regression

torch.set_num_threads(1)


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(1.0, np.abs(ref[np.isfinite(ref)]).max()))


def _ar1(rng, m, n, rho, shape=()):
    x = np.zeros((m, n) + shape)
    x[:, 0] = rng.standard_normal((m,) + shape)
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + math.sqrt(1 - rho**2) * rng.standard_normal((m,) + shape)
    return x.astype(np.float32)


SAMPLES = {
    "iid": lambda r: r.standard_normal((8, 500)).astype(np.float32),
    "drift": lambda r: (r.standard_normal((4, 400)) + np.linspace(0, 3, 400)).astype(np.float32),
    "ar1_trailing_odd": lambda r: _ar1(r, 4, 301, 0.8, (3,)),
    "disjoint": lambda r: (r.standard_normal((6, 200)) + 5.0 * np.arange(6)[:, None]).astype(np.float32),
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_rhat_and_ess_match_jax(name):
    x = SAMPLES[name](np.random.default_rng(0))
    _close(td.split_rhat(torch.from_numpy(x)), jd.split_rhat(jnp.asarray(x)), 1e-5)
    _close(td.effective_sample_size(torch.from_numpy(x)), jd.effective_sample_size(jnp.asarray(x)), 1e-5)


def test_diagnostics_over_a_tree_and_their_verdicts():
    rng = np.random.default_rng(1)
    tree = {"a": torch.from_numpy(SAMPLES["iid"](rng)), "b": torch.from_numpy(_ar1(rng, 4, 400, 0.9, (2,)))}
    rh, es = td.split_rhat(tree), td.effective_sample_size(tree)
    assert rh["a"].shape == () and rh["b"].shape == (2,) and es["b"].shape == (2,)
    assert float(rh["a"]) < 1.02 and 2500 < float(es["a"])
    assert float(td.split_rhat(torch.from_numpy(SAMPLES["disjoint"](rng)))) > 2.0
    assert float(td.split_rhat(torch.from_numpy(SAMPLES["drift"](rng)))) > 1.1
    # AR(1): ESS / draws -> (1 - rho) / (1 + rho)
    x = torch.from_numpy(_ar1(rng, 8, 2000, 0.5))
    ratio = float(td.effective_sample_size(x)) / x.numel()
    assert abs(ratio - 1.0 / 3.0) < 0.08
    with pytest.raises(ValueError):
        td.split_rhat(torch.zeros(5))


def _gpd(rng, n, k):
    u = rng.uniform(size=n)
    return (-np.log(1 - u) if k == 0 else (np.power(1 - u, -k) - 1) / k).astype(np.float32)


def _gaussian_is_logw(rng, n, sd):
    x = rng.normal(size=n)
    return (-0.5 * x**2 / sd**2 - np.log(sd) + 0.5 * x**2).astype(np.float32)


@pytest.mark.parametrize("k_true", [-0.3, 0.1, 0.5, 0.9])
def test_gpd_fit_matches_jax_and_recovers_shape(k_true):
    x = _gpd(np.random.default_rng(0), 4000, k_true)
    ref = jp.fit_gpd_shape(jnp.asarray(x))
    got = tp.fit_gpd_shape(torch.from_numpy(x))
    for g, r in zip(got, ref):
        _close(g, r, 1e-4)
    assert abs(float(got[0]) - k_true) < 0.08 and abs(float(got[1]) - 1.0) < 0.1


@pytest.mark.parametrize("sd", [1.2, 2.0, 4.0])
def test_psis_smooth_and_pareto_k_match_jax(sd):
    lw = _gaussian_is_logw(np.random.default_rng(1), 8000, sd)
    ref_sm, ref_k = jp.psis_smooth(jnp.asarray(lw))
    sm, k = tp.psis_smooth(torch.from_numpy(lw))
    _close(k, ref_k, 1e-4)
    _close(sm, ref_sm, 1e-4)
    _close(tp.pareto_k(torch.from_numpy(lw)), jp.pareto_k(jnp.asarray(lw)), 1e-4)
    assert float(sm.max()) <= float(lw.max()) + 1e-5
    # the body passes through untouched
    body = sm == torch.from_numpy(lw)
    assert int(body.sum()) >= 8000 - tp._tail_size(8000)


def test_pareto_k_orders_proposals_and_edge_cases():
    rng = np.random.default_rng(1)
    ks = [float(tp.pareto_k(torch.from_numpy(_gaussian_is_logw(rng, 8000, sd)))) for sd in (1.2, 2.0, 4.0)]
    assert ks[0] < ks[1] < ks[2] and ks[0] < 0.6 and ks[2] > 0.7, ks
    assert float(tp.psis_smooth(torch.zeros(4000))[1]) == -math.inf
    sm, k = tp.psis_smooth(torch.randn(20))
    assert float(k) == math.inf and sm.shape == (20,)
    # A batch of rows is smoothed row by row.
    rows = torch.from_numpy(np.stack([_gaussian_is_logw(rng, 2000, sd) for sd in (1.2, 4.0)]))
    bsm, bk = tp.psis_smooth(rows)
    for i in range(2):
        osm, ok = tp.psis_smooth(rows[i])
        assert torch.equal(bsm[i], osm) and torch.allclose(bk[i], ok)


def _loo_case():
    rng = np.random.default_rng(2)
    n, s = 30, 4000
    y = 0.7 + rng.standard_normal(n)
    m_post, v_post = y.sum() / (n + 1), 1.0 / (n + 1)
    mus = m_post + math.sqrt(v_post) * rng.standard_normal((s, 1))
    ll = (-0.5 * (y[None] - mus) ** 2 - 0.5 * math.log(2 * math.pi)).astype(np.float32)
    return y, ll


def test_elpd_loo_and_waic_match_jax():
    _, ll = _loo_case()
    ref, got = jax.jit(jp.elpd_loo)(jnp.asarray(ll)), tp.elpd_loo(torch.from_numpy(ll))
    for name in ("elpd", "se", "p_loo", "pointwise", "pareto_k"):
        _close(getattr(got, name), getattr(ref, name), 1e-4)
    ref, got = jp.elpd_waic(jnp.asarray(ll)), tp.elpd_waic(torch.from_numpy(ll))
    for name in ("elpd", "se", "p_waic", "pointwise"):
        _close(getattr(got, name), getattr(ref, name), 1e-4)
    with pytest.raises(ValueError):
        tp.elpd_loo(torch.zeros(5))


def test_elpd_loo_matches_exact_loo():
    y, ll = _loo_case()
    n = y.shape[0]
    m_i = (y.sum() - y) / n
    var = 1.0 / n + 1.0
    exact = float(np.sum(-0.5 * (y - m_i) ** 2 / var - 0.5 * np.log(2 * math.pi * var)))
    res = tp.elpd_loo(torch.from_numpy(ll))
    assert abs(float(res.elpd) - exact) < 0.15
    assert 0.5 < float(res.p_loo) < 2.0 and float(res.pareto_k.max()) < 0.7


def _logreg_single(seed=4, n=60, d=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    ys = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ np.array([1.0, -1.0, 0.5])))).astype(np.int32)
    w0 = (0.3 * rng.standard_normal(d)).astype(np.float32)
    jtr, _ = jax_logreg.importance(jrand.key(0), jgx.ChoiceMap.kw(w=jnp.asarray(w0), ys=jnp.asarray(ys)),
                                   (jnp.asarray(X),))
    ttr, _ = logistic_regression.importance(
        torch.Generator(), tgx.ChoiceMap.kw(w=torch.from_numpy(w0), ys=torch.from_numpy(ys)), (torch.from_numpy(X),)
    )
    return jtr, ttr


def test_map_estimate_and_laplace_match_jax():
    jtr, ttr = _logreg_single()
    jmap, jhist = jax.jit(lambda t: jml.map_estimate(jrand.key(1), t, jgx.Selection.at["w"], n_steps=60))(jtr)
    tmap, thist = tml.map_estimate(torch.Generator(), ttr, tgx.Selection.at["w"], n_steps=60)
    _close(tmap.get_choices()["w"], jmap.get_choices()["w"], 1e-5)
    _close(thist, jhist, 1e-5)
    jmode, _ = jax.jit(lambda t: jml.map_estimate(jrand.key(1), t, jgx.Selection.at["w"], n_steps=400))(jtr)
    tmode, _ = tml.map_estimate(torch.Generator(), ttr, tgx.Selection.at["w"], n_steps=400)
    jlap = jax.jit(lambda t: jml.laplace_approximation(t, jgx.Selection.at["w"]))(jmode)
    tlap = tml.laplace_approximation(tmode, tgx.Selection.at["w"])
    _close(tlap.mean, jlap.mean, 1e-4)
    _close(tlap.covariance, jlap.covariance, 1e-4)
    _close(tlap.log_marginal, jlap.log_marginal, 1e-4)


def test_laplace_exact_on_gaussian_posterior_and_samples():
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.normal(size=(50, 2)), dtype=torch.float32)
    y = X @ torch.tensor([1.0, -2.0]) + 0.3 * torch.tensor(rng.normal(size=50), dtype=torch.float32)

    @tgx.gen
    def linreg(X):
        w = tgx.mv_normal_diag(torch.zeros(2), torch.ones(2)) @ "w"
        _ = tgx.mv_normal_diag(w @ X.mT, 0.3 * torch.ones(50)) @ "y"

    g = torch.Generator().manual_seed(1)
    tr, _ = linreg.importance(g, tgx.ChoiceMap.kw(y=y), (X,))
    map_tr, _ = tml.map_estimate(g, tr, tgx.Selection.at["w"], n_steps=1500)
    lap = tml.laplace_approximation(map_tr, tgx.Selection.at["w"])
    prec = torch.eye(2) + X.T @ X / 0.09
    cov = torch.linalg.inv(prec)
    mean = cov @ (X.T @ y / 0.09)
    assert torch.allclose(map_tr.get_choices()["w"], mean, atol=1e-3)
    assert torch.allclose(lap.covariance, cov, atol=1e-5)
    draws = lap.sample(g, 20000)["w"].double()
    assert torch.allclose(draws.mean(0), mean.double(), atol=4 * math.sqrt(float(cov.diagonal().max()) / 20000))
    emp = torch.cov(draws.T)
    assert torch.allclose(emp, cov.double(), atol=0.05 * float(cov.abs().max()))


def test_map_estimate_over_a_chain_batch():
    @tgx.gen
    def conjugate():
        mu = tgx.normal(0.0, 1.0) @ "mu"
        _ = tgx.normal(mu, 1.0) @ "obs"

    tr, _ = conjugate.importance(
        torch.Generator(), tgx.ChoiceMap.kw(obs=1.0, mu=tgx.per_particle(torch.tensor([-3.0, 0.0, 4.0]))), (), n=3
    )
    map_tr, hist = tml.map_estimate(torch.Generator(), tr, tgx.Selection.at["mu"], n_steps=300)
    assert hist.shape == (300, 3)
    assert torch.allclose(map_tr.get_choices()["mu"], torch.full((3,), 0.5), atol=1e-2)
