"""The MCMC path as a whole, port (`genjax_tpu_torch`) against JAX
(`genjax_tpu`) on the CPU: logistic-regression HMC and MALA, polynomial
regression IS + MALA, and Regenerate-MH.

The two packages draw different random numbers, so the comparisons are
statistical: the ports of the JAX model tests
(`tests/inference/test_models.py`) keep their criteria, the port's chain
means sit within 5 combined standard errors of JAX's on the same data,
and Regenerate-MH's posterior within 5 standard errors of the exact one.
Each run's chains start from the prior and are independent, so a chain
mean's standard error is the chains' standard deviation over sqrt(C).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

import genjax_tpu_torch as tgx
from genjax_tpu.models.logreg import run_hmc_chains as jax_run_hmc_chains
from genjax_tpu.models.logreg import simulate_logreg_data as jax_simulate_logreg_data
from genjax_tpu.models.polyreg import run_is_mh as jax_run_is_mh
from genjax_tpu_torch.models.logreg import run_hmc_chains, run_mala_chains, simulate_logreg_data
from genjax_tpu_torch.models.polyreg import run_is_mh, simulate_polyreg_data

torch.set_num_threads(1)


def _logreg_data(seed: int, n: int, d: int):
    """The same data for both packages, made by JAX's simulator."""
    X, ys, w_true = jax_simulate_logreg_data(jax.random.key(seed), n, d)
    return X, ys, torch.tensor(np.asarray(X)), torch.tensor(np.asarray(ys))


def _map(X: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """The posterior mode of logistic regression, by gradient ascent."""
    w = np.zeros(X.shape[1])
    for _ in range(2000):
        p = 1.0 / (1.0 + np.exp(-X @ w))
        w = w + 1e-3 * (X.T @ (ys - p) - w)
    return w


def test_logreg_hmc_recovers_the_map():
    # Port of TestLogReg.test_hmc_recovers_map, at N = 100 points.
    X, ys, Xt, yst = _logreg_data(3, 100, 4)
    w_map = _map(np.asarray(X, np.float64), np.asarray(ys, np.float64))
    ws, accs = run_hmc_chains(torch.Generator().manual_seed(4), Xt, yst, n_chains=64, n_steps=30, eps=0.05, L=8)
    assert accs.shape == (64, 30) and ws.shape == (64, 4)
    assert np.allclose(ws.mean(0).numpy(), w_map, atol=0.25)
    assert accs.float().mean() > 0.5


def test_logreg_mala_accepts():
    # Port of TestLogReg.test_mala_runs.
    _, _, Xt, yst = _logreg_data(5, 100, 3)
    ws, accs = run_mala_chains(torch.Generator().manual_seed(6), Xt, yst, n_chains=32, n_steps=100, eps=0.005)
    assert torch.isfinite(ws).all()
    assert accs.float().mean() > 0.3


def test_logreg_hmc_posterior_mean_matches_jax():
    X, ys, Xt, yst = _logreg_data(7, 100, 3)
    C = 64
    jws, _ = jax.jit(lambda k: jax_run_hmc_chains(k, X, ys, n_chains=C, n_steps=20, eps=0.1, L=5))(
        jax.random.key(8)
    )
    ws, _ = run_hmc_chains(torch.Generator().manual_seed(8), Xt, yst, n_chains=C, n_steps=20, eps=0.1, L=5)
    jws, ws = np.asarray(jws, np.float64), ws.numpy().astype(np.float64)
    se = np.sqrt(jws.var(0, ddof=1) / C + ws.var(0, ddof=1) / C)
    assert (np.abs(ws.mean(0) - jws.mean(0)) < 5 * se).all(), (ws.mean(0), jws.mean(0), se)


def test_polyreg_recovers_the_coefficients():
    # Port of TestPolyReg.test_coefficient_recovery.
    xs = np.linspace(-1, 1, 30).astype(np.float32)
    true_c = np.array([0.5, -1.0, 2.0], np.float32)
    ys = (np.stack([np.ones_like(xs), xs, xs**2], -1) @ true_c).astype(np.float32)
    lml, coeffs = run_is_mh(torch.Generator().manual_seed(0), torch.tensor(xs), torch.tensor(ys), 512, 100)
    assert np.allclose(coeffs.mean(0).numpy(), true_c, atol=0.25)
    assert math.isfinite(float(lml))


def test_polyreg_lml_matches_jax_across_seeds():
    xs = np.linspace(-2, 2, 16).astype(np.float32)
    ys = (0.5 - xs + 0.3 * xs**2 + 0.3 * np.random.default_rng(0).standard_normal(16)).astype(np.float32)
    seeds = 6
    run = jax.jit(lambda k: jax_run_is_mh(k, jnp.asarray(xs), jnp.asarray(ys), 128, 2)[0])
    ref = np.array([float(run(jax.random.key(s))) for s in range(seeds)])
    got = np.array(
        [float(run_is_mh(torch.Generator().manual_seed(s), torch.tensor(xs), torch.tensor(ys), 128, 2)[0])
         for s in range(seeds)]
    )
    se = math.sqrt(got.var(ddof=1) / seeds + ref.var(ddof=1) / seeds)
    assert abs(got.mean() - ref.mean()) < 5 * se, (got.mean(), ref.mean(), se)


@tgx.gen
def _normal_normal():
    mu = tgx.normal(0.0, 1.0) @ "mu"
    _ = tgx.normal(mu, 1.0) @ "obs"


def test_regenerate_mh_samples_the_exact_posterior():
    # mu ~ N(0, 1), obs ~ N(mu, 1), obs = 1: the posterior is N(1/2, 1/2).
    C = 2048
    rng = torch.Generator().manual_seed(0)
    tr, _ = _normal_normal.importance(rng, tgx.ChoiceMap.kw(obs=1.0), (), n=C)
    final, accs = tgx.run_chains(rng, tr, tgx.Regenerate(tgx.Selection.at["mu"]), 30)
    mu = final.get_choices()["mu"].double()
    assert accs.shape == (C, 30)
    assert abs(float(mu.mean()) - 0.5) < 5 * math.sqrt(0.5 / C)
    # The sample variance of C normal draws has SE var * sqrt(2 / (C - 1)).
    assert abs(float(mu.var()) - 0.5) < 5 * 0.5 * math.sqrt(2 / (C - 1))
    # Independent prior proposals: the acceptance rate is E[min(1, L'/L)].
    assert 0.3 < float(accs.float().mean()) < 0.9


def test_simulated_logreg_data_is_balanced_and_int32():
    X, ys, w_true = simulate_logreg_data(torch.Generator().manual_seed(0), 500, 3)
    assert X.shape == (500, 3) and ys.dtype == torch.int32 and w_true.shape == (3,)
    p = torch.sigmoid(X @ w_true)
    # ys ~ Bernoulli(p): the count of ones within 5 SE of its mean.
    assert abs(float(ys.sum()) - float(p.sum())) < 5 * math.sqrt(float((p * (1 - p)).sum()))


def test_simulated_polyreg_data_has_the_bench_curve_and_noise():
    xs, ys = simulate_polyreg_data(torch.Generator().manual_seed(0), 2000, 0.3)
    assert xs.shape == ys.shape == (2000,) and float(xs[0]) == -2.0 and float(xs[-1]) == 2.0
    resid = (ys - (0.5 - xs + 0.3 * xs**2)).double()
    # Mean 0 within 5 SE; the sample sd within 5 SE of 0.3 (SE sd / sqrt(2(n-1))).
    assert abs(float(resid.mean())) < 5 * 0.3 / math.sqrt(2000)
    assert abs(float(resid.std()) - 0.3) < 5 * 0.3 / math.sqrt(2 * 1999)
