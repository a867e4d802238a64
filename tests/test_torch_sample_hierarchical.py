"""`sample_posterior` (`inference/sample.py`) and eight schools
(`models/hierarchical.py`) in the port, on the CPU.

Deterministic, against JAX on the same inputs: `eight_schools_quadrature`
(every moment and the log evidence, within 1e-4 of the largest
|value|: both sum 361,201 float32 grid terms, in different orders), and the
scores of both parameterizations on a numpy-made chain batch (1e-5 of the
largest |score|).

Statistical, after `tests/inference/test_sample_api.py` and
`tests/inference/test_hierarchical.py`: each of the five algorithms
recovers the conjugate posterior with R-hat < 1.1 and ESS > 200 (NUTS at
max_depth 4 on the CPU); an explicit selection over a vector site
recovers the exact linear-regression posterior mean; the posterior
predictive matches its closed form; `init` moves the start and not the
posterior; an unknown algorithm raises; ChEES on eight schools recovers
the oracle's moments with the JAX test's rule (6 SE + 0.05, n_eff = C S /
20) at 16 chains.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.models import hierarchical as jh
from genjax_tpu_torch import convert
from genjax_tpu_torch.inference.sample import posterior_predictive, sample_posterior
from genjax_tpu_torch.models import hierarchical as th

torch.set_num_threads(1)

POST_MEAN, POST_VAR = 0.5, 0.5


@tgx.gen
def conjugate():
    mu = tgx.normal(0.0, 1.0) @ "mu"
    _ = tgx.normal(mu, 1.0) @ "obs"


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("n_schools", [8, 1])
def test_quadrature_matches_jax(n_schools):
    y, s = np.array(jh.EIGHT_SCHOOLS_Y)[:n_schools], np.array(jh.EIGHT_SCHOOLS_SIGMA)[:n_schools]
    ref = jh.eight_schools_quadrature(jnp.asarray(y), jnp.asarray(s))
    got = th.eight_schools_quadrature(torch.from_numpy(y), torch.from_numpy(s))
    for name in ("mu_mean", "mu_var", "tau_mean", "log_tau_mean", "theta_mean", "theta_var", "log_evidence"):
        _close(getattr(got, name), getattr(ref, name), 1e-4)
    if n_schools == 8:
        _close(got.tau_var, ref.tau_var, 1e-4)


def test_model_scores_match_jax():
    rng = np.random.default_rng(0)
    c = 16
    mu = (5.0 * rng.standard_normal(c)).astype(np.float32)
    lt = rng.uniform(-2.0, 2.0, c).astype(np.float32)
    z = rng.standard_normal((c, 8)).astype(np.float32)
    theta = (mu[:, None] + np.exp(lt)[:, None] * z).astype(np.float32)
    y, sigma = np.asarray(jh.EIGHT_SCHOOLS_Y), np.asarray(jh.EIGHT_SCHOOLS_SIGMA)
    for jm, tm, latents in (
        (jh.eight_schools, th.eight_schools, {"mu": mu, "log_tau": lt, "z": z}),
        (jh.eight_schools_centered, th.eight_schools_centered, {"mu": mu, "log_tau": lt, "theta": theta}),
    ):
        ref = jax.vmap(
            lambda *vals: jm.assess(
                jgx.ChoiceMap.d({**dict(zip(latents, vals)), "ys": jnp.asarray(y)}), (jnp.asarray(sigma),)
            )[0]
        )(*(jnp.asarray(v) for v in latents.values()))
        tr = convert.chain_batch(tm, (sigma,), latents, {"ys": y}, device="cpu")
        _close(tr.get_score(), ref, 1e-5)


def test_parameterizations_same_joint():
    mu, lt = torch.tensor(3.0), torch.tensor(0.7)
    theta = torch.linspace(-5.0, 20.0, 8)
    z = (theta - mu) / torch.exp(lt)
    y, s = th.EIGHT_SCHOOLS_Y, th.EIGHT_SCHOOLS_SIGMA
    s_c, _ = th.eight_schools_centered.assess(tgx.ChoiceMap.kw(mu=mu, log_tau=lt, theta=theta, ys=y), (s,))
    s_nc, _ = th.eight_schools.assess(tgx.ChoiceMap.kw(mu=mu, log_tau=lt, z=z, ys=y), (s,))
    assert abs(float(s_nc - (s_c + 8 * lt))) < 1e-4


@pytest.mark.parametrize("algorithm", ["chees", "hmc", "mala", "nuts", "elliptical"])
def test_conjugate_exactness_and_diagnostics(algorithm):
    out = sample_posterior(
        torch.Generator().manual_seed(0), conjugate, tgx.ChoiceMap.kw(obs=1.0), algorithm=algorithm,
        n_chains=64, n_warmup=100, n_samples=200, thin_burn=50, L=5, max_depth=4,
    )
    mus = out.samples["mu"].double()
    assert mus.shape == (64, 150)
    assert abs(float(mus.mean()) - POST_MEAN) < 6 * math.sqrt(POST_VAR / 64)
    assert abs(float(mus.var()) - POST_VAR) < 0.15
    assert float(out.rhat["mu"]) < 1.1
    assert float(out.ess["mu"]) > 200
    assert out.flat()["mu"].shape == (64 * 150,)


def test_explicit_selection_and_multivariate():
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.normal(size=(40, 2)), dtype=torch.float32)
    y = X @ torch.tensor([1.0, -1.0]) + 0.3 * torch.tensor(rng.normal(size=40), dtype=torch.float32)

    @tgx.gen
    def linreg(X):
        w = tgx.mv_normal_diag(torch.zeros(2), torch.ones(2)) @ "w"
        _ = tgx.mv_normal_diag(w @ X.mT, 0.3 * torch.ones(40)) @ "y"

    out = sample_posterior(
        torch.Generator().manual_seed(1), linreg, tgx.ChoiceMap.kw(y=y), (X,), selection=tgx.Selection.at["w"],
        algorithm="chees", n_chains=32, n_warmup=100, n_samples=150, thin_burn=50,
    )
    assert out.samples["w"].shape == (32, 100, 2)
    prec = torch.eye(2) + X.T @ X / 0.09
    mean = torch.linalg.solve(prec, X.T @ y / 0.09)
    est = out.flat()["w"].mean(0)
    assert torch.allclose(est, mean, atol=0.05), (est, mean)
    assert bool((out.rhat["w"] < 1.15).all())


def test_posterior_predictive_matches_closed_form():
    out = sample_posterior(
        torch.Generator().manual_seed(3), conjugate, tgx.ChoiceMap.kw(obs=1.0), algorithm="hmc",
        n_chains=64, n_warmup=80, n_samples=150, thin_burn=50, L=5,
    )
    ys = posterior_predictive(torch.Generator().manual_seed(4), conjugate, (), out.flat())["obs"].double()
    # A new observation's predictive is N(0.5, 1.5); the chains are the
    # independent unit.
    assert abs(float(ys.mean()) - 0.5) < 6 * math.sqrt(1.5 / 64)
    assert abs(float(ys.var()) - 1.5) < 0.2


def test_init_overrides_start_not_selection():
    for init in (
        tgx.ChoiceMap.kw(mu=torch.full((64,), 3.0)),
        lambda r: tgx.ChoiceMap.kw(mu=4.0 * torch.rand(64, generator=r) - 2.0),
    ):
        out = sample_posterior(
            torch.Generator().manual_seed(1), conjugate, tgx.ChoiceMap.kw(obs=1.0), algorithm="hmc",
            n_chains=64, n_warmup=100, n_samples=150, L=5, init=init,
        )
        mus = out.samples["mu"].double()
        assert abs(float(mus.mean()) - POST_MEAN) < 6 * math.sqrt(POST_VAR / 64)
        assert float(mus.var()) > 0.2  # the kernel moved mu from its start


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="unknown algorithm"):
        sample_posterior(torch.Generator(), conjugate, tgx.ChoiceMap.kw(obs=1.0), algorithm="gibbs", n_chains=4)


def test_eight_schools_chees_recovers_oracle_moments():
    oracle = th.eight_schools_quadrature(th.EIGHT_SCHOOLS_Y, th.EIGHT_SCHOOLS_SIGMA)
    c, s = 16, 300
    out, theta = th.run_eight_schools(torch.Generator().manual_seed(0), n_chains=c, n_warmup=200, n_samples=s)
    mu = out.samples["mu"].double()
    tau = torch.exp(out.samples["log_tau"].double())
    n_eff = c * s / 20.0  # the JAX test's autocorrelation discount
    for got, mean, var, label in [
        (mu.mean(), oracle.mu_mean, oracle.mu_var, "mu"),
        (tau.mean(), oracle.tau_mean, oracle.tau_var, "tau"),
    ]:
        se = math.sqrt(float(var) / n_eff)
        assert abs(float(got) - float(mean)) < 6 * se + 0.05, f"{label}: {float(got)} vs oracle {float(mean)}"
    th_err = (theta.double().mean((0, 1)) - oracle.theta_mean.double()).abs()
    th_se = (oracle.theta_var.double() / n_eff).sqrt()
    assert bool((th_err < 6 * th_se + 0.05).all()), (th_err, 6 * th_se)
    assert theta.shape == (c, s, 8)
