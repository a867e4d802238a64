"""Elliptical slice sampling (`inference/requests/elliptical.py`) and the
GP models (`models/gp.py`) in the port, on the CPU.

Deterministic, against JAX on the same numpy-made inputs: the RBF and
Matern-3/2 kernel matrices (1-D and 2-D inputs, 1e-5 of the largest
|value|), `gp_posterior`'s mean, covariance and log marginal likelihood
(float32 Cholesky solves on both sides: 1e-4 of the largest |value|), and
the GP regression model's score on latent values drawn from its prior
(1e-5 of the largest |score|, at a lengthscale where float32 factors the
Gram matrix stably).

Statistical, after `tests/inference/test_elliptical.py` and
`tests/distributions/test_gp.py`: the weight is 0 and MH always accepts;
the score after a move is the model's; a batch of chains recovers the
scalar conjugate posterior and an iid vector posterior with a non-zero
prior mean; `run_gp_ess` recovers the GP posterior mean within 5 Monte
Carlo standard errors (from the port's own ESS) and its marginal standard
deviations within 0.05. The host reads of the shrink loop: one every
`ELLIPTICAL_CHECK_EVERY` trips, `trips / ELLIPTICAL_CHECK_EVERY + 1` per
move that ends with every chain accepted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.models import gp as jgp
from genjax_tpu_torch import convert
from genjax_tpu_torch.inference.diagnostics import effective_sample_size
from genjax_tpu_torch.inference.requests import elliptical as tell
from genjax_tpu_torch.models import gp as tgp

torch.set_num_threads(1)

_rng = np.random.default_rng(0)
XS = np.linspace(0.0, 3.0, 12).astype(np.float32)
YS = (np.sin(2 * XS) + 0.3 * _rng.standard_normal(12)).astype(np.float32)


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("kernel", ["rbf_kernel", "matern32_kernel"])
@pytest.mark.parametrize("dim", [1, 2])
def test_kernels_match_jax(kernel, dim):
    rng = np.random.default_rng(dim)
    xs = rng.standard_normal((9, dim) if dim > 1 else 9).astype(np.float32)
    zs = rng.standard_normal((7, dim) if dim > 1 else 7).astype(np.float32)
    ref = getattr(jgp, kernel)(jnp.asarray(xs), jnp.asarray(zs), 0.8, 1.7)
    got = getattr(tgp, kernel)(torch.from_numpy(xs), torch.from_numpy(zs), 0.8, 1.7)
    _close(got, ref, 1e-5)
    same = getattr(tgp, kernel)(torch.from_numpy(xs), torch.from_numpy(xs))
    assert torch.allclose(same.diagonal(), torch.ones(9), atol=1e-6)


@pytest.mark.parametrize("kernel", ["rbf_kernel", "matern32_kernel"])
def test_gp_posterior_matches_jax(kernel):
    ref = jgp.gp_posterior(jnp.asarray(XS), jnp.asarray(YS), 0.3, 0.9, 1.2, getattr(jgp, kernel))
    got = tgp.gp_posterior(torch.from_numpy(XS), torch.from_numpy(YS), 0.3, 0.9, 1.2, getattr(tgp, kernel))
    for g, r in zip(got, ref):
        _close(g, r, 1e-4)


def test_gp_model_score_matches_jax():
    # Latent values drawn from the prior (float64 numpy), at a lengthscale
    # whose Gram matrix float32 factors stably (at lengthscale 1 over these
    # 12 points its condition number is about 1e7, and the two float32
    # Cholesky factors' quadratic forms part by 0.7%).
    ls = 0.4
    d2 = (XS[:, None].astype(np.float64) - XS[None, :]) ** 2
    K = np.exp(-0.5 * d2 / ls**2) + 1e-5 * np.eye(12)
    fs = (np.random.default_rng(5).standard_normal((6, 12)) @ np.linalg.cholesky(K).T).astype(np.float32)
    jm = jgp.make_gp_regression()
    ref = jax.vmap(
        lambda f: jm.assess(jgx.ChoiceMap.kw(f=f, y=jnp.asarray(YS)), (jnp.asarray(XS), 0.3, ls, 1.0))[0]
    )(jnp.asarray(fs))
    tr = convert.chain_batch(tgp.make_gp_regression(), (XS, 0.3, ls, 1.0), {"f": fs}, {"y": YS}, device="cpu")
    _close(tr.get_score(), ref, 1e-5)


@tgx.gen
def scalar_model():
    mu = tgx.normal(1.0, 2.0) @ "mu"
    _ = tgx.normal(mu, 1.0) @ "obs"
    return mu


SC_OBS, SC_POST_MEAN, SC_POST_STD = 3.0, 2.6, 0.8**0.5  # posterior N(2.6, 0.8)


def test_weight_is_zero_and_mh_always_accepts():
    rng = torch.Generator().manual_seed(0)
    tr, _ = scalar_model.importance(rng, tgx.ChoiceMap.kw(obs=SC_OBS), (), n=8)
    req = tgx.EllipticalSlice(tgx.Selection.at["mu"], mean=1.0)
    new_tr, w, _, bwd = req.edit(rng, tr, tgx.Diff.no_change(()))
    assert torch.equal(w, torch.zeros(8)) and isinstance(bwd, tgx.EllipticalSlice)
    _, accepted = tgx.mh(rng, tr, req)
    assert bool(accepted.all())
    # The score after a move is the model's own.
    score, _ = scalar_model.assess(new_tr.get_choices(), ())
    assert torch.allclose(score, new_tr.get_score(), atol=1e-5)
    assert not torch.equal(new_tr.get_choices()["mu"], tr.get_choices()["mu"])


def test_functional_form_on_one_trace_moves_state():
    rng = torch.Generator().manual_seed(1)
    tr, _ = scalar_model.importance(rng, tgx.ChoiceMap.kw(obs=SC_OBS), ())
    new_tr = tgx.inference.requests.elliptical_slice(rng, tr, tgx.Selection.at["mu"], mean=1.0)
    assert new_tr.get_score().shape == () and float(new_tr.get_choices()["mu"]) != float(tr.get_choices()["mu"])


def test_host_reads_follow_the_trips():
    rng = torch.Generator().manual_seed(2)
    tr, _ = scalar_model.importance(rng, tgx.ChoiceMap.kw(obs=SC_OBS), (), n=256)
    req = tgx.EllipticalSlice(tgx.Selection.at["mu"], mean=1.0)
    for _ in range(5):
        before = dict(tell.elliptical_stats)
        tr, _ = tgx.mh(rng, tr, req)
        moved = {k: v - before[k] for k, v in tell.elliptical_stats.items()}
        assert moved["moves"] == 1 and moved["capped"] == 0 and moved["trips"] % tell.ELLIPTICAL_CHECK_EVERY == 0
        assert moved["syncs"] == moved["trips"] // tell.ELLIPTICAL_CHECK_EVERY + 1


def test_chains_recover_scalar_posterior():
    rng = torch.Generator().manual_seed(0)
    traces, _ = scalar_model.importance(rng, tgx.ChoiceMap.kw(obs=SC_OBS), (), n=64)
    req = tgx.EllipticalSlice(tgx.Selection.at["mu"], mean=1.0)
    _, mus = tgx.run_chains(rng, traces, req, 150, collect=lambda t: t.get_choices()["mu"])
    s = mus[:, 30:].double()
    assert s.shape == (64, 120)
    assert abs(float(s.mean()) - SC_POST_MEAN) < 0.1
    assert abs(float(s.std()) - SC_POST_STD) < 0.1


def test_chains_recover_vector_posterior_with_prior_mean():
    d = 8

    @tgx.gen
    def vector_model(y):
        f = tgx.normal(torch.full((d,), 0.5), 1.0) @ "f"
        _ = tgx.normal(f, 0.5) @ "y"
        return f

    y = torch.linspace(-1.0, 2.0, d)
    post_mean, post_std = (0.5 + 4.0 * y) / 5.0, (1.0 / 5.0) ** 0.5
    rng = torch.Generator().manual_seed(1)
    traces, _ = vector_model.importance(rng, tgx.ChoiceMap.kw(y=y), (y,), n=64)
    _, fs = tgx.run_chains(
        rng, traces, tgx.EllipticalSlice(tgx.Selection.at["f"], mean=0.5), 120,
        collect=lambda t: t.get_choices()["f"],
    )
    s = fs[:, 20:].reshape(-1, d)
    assert float((s.mean(0) - post_mean).abs().max()) < 0.12
    assert float((s.std(0) - post_std).abs().max()) < 0.1


def test_run_gp_ess_recovers_exact_posterior():
    xs, ys = torch.from_numpy(XS), torch.from_numpy(YS)
    mean, cov, _ = tgp.gp_posterior(xs, ys, 0.3)
    fs = tgp.run_gp_ess(torch.Generator().manual_seed(0), xs, ys, n_steps=1000)
    assert fs.shape == (1000, 12)
    s = fs[200:].double()
    ess = effective_sample_size(s[None])
    mcse = s.std(0) / ess.sqrt()
    assert bool(((s.mean(0) - mean.double()).abs() < 5 * mcse).all()), ((s.mean(0) - mean) / mcse)
    assert float((s.std(0) - cov.diagonal().double().sqrt()).abs().max()) < 0.05
