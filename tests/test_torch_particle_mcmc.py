"""The port's particle-MCMC, smoothing and tempering drivers
(`genjax_tpu_torch.inference.pmmh`, `particle_gibbs`, `smoothing`,
`tempered`) against `genjax_tpu` and the linear-Gaussian closed forms, on
the CPU.

Deterministic parts (`path_log_joint`, the pinned particle's weight, the
FFBS backward logits, `_loglik`, the tempered collection's evidence) are
fed the same numpy-made inputs as JAX and compared at float32 tolerance,
1e-5 per unit of magnitude (`_close`). Random parts are held against
exact answers (the Kalman marginal likelihood and the RTS smoother, in
numpy float64), and the PMMH chain against JAX's own chain, within 5
standard errors: independent draws where the test can make them (one
CSMC sweep from exact smoothing paths, independent FFBS and tempered
runs), batch means along a chain otherwise.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.inference import particle_gibbs as jpg
from genjax_tpu.inference import tempered as jtempered
from genjax_tpu.inference.particle_filter import BootstrapFilter as JBootstrapFilter
from genjax_tpu.inference.pmmh import PMMH as JPMMH
from genjax_tpu_torch import convert
from genjax_tpu_torch.inference import particle_gibbs as tpg
from genjax_tpu_torch.inference import tempered as ttempered
from genjax_tpu_torch.inference.pmmh import PMMH
from genjax_tpu_torch.inference.requests import GaussianDrift
from genjax_tpu_torch.inference.smoothing import backward_logits, ffbs_sample, smoothing_clouds
from genjax_tpu_torch.inference.tempered import TemperedSMC

torch.set_num_threads(1)

JC, TC = jgx.ChoiceMap, tgx.ChoiceMap
KEY = jax.random.key(0)
Q, R_OBS, A_TRUE = 0.5, 0.4, 0.8


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), (got, ref)


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


def _within_se(values, exact, n_se=5.0):
    values = np.asarray(values, dtype=np.float64)
    se = values.std(ddof=1) / math.sqrt(len(values))
    assert np.isfinite(values).all()
    assert abs(values.mean() - exact) < n_se * se, (values.mean(), exact, se)


def _batch_means(chain, batches=10):
    chain = np.asarray(chain, dtype=np.float64)
    return chain[: len(chain) // batches * batches].reshape(batches, -1).mean(1)


def _batch_means_within_se(chain, exact, batches=10, n_se=5.0):
    """A chain's mean against `exact` within `n_se` batch-means SE."""
    _within_se(_batch_means(chain, batches), exact, n_se)


# -- the linear-Gaussian SSM, one pair, and its closed forms ---------------------------


@jgx.gen
def j_init(a):
    z = jgx.normal(0.0, 1.0) @ "z"
    _ = jgx.normal(z, R_OBS) @ "y"
    return z


@jgx.gen
def j_step(z_prev, t, a):
    z = jgx.normal(a * z_prev, Q) @ "z"
    _ = jgx.normal(z, R_OBS) @ "y"
    return z


@tgx.gen
def t_init(a):
    z = tgx.normal(0.0, 1.0) @ "z"
    _ = tgx.normal(z, R_OBS) @ "y"
    return z


@tgx.gen
def t_step(z_prev, t, a):
    z = tgx.normal(a * z_prev, Q) @ "z"
    _ = tgx.normal(z, R_OBS) @ "y"
    return z


def _data(T, seed=0):
    rng = np.random.default_rng(seed)
    z, ys = rng.standard_normal(), []
    for t in range(T):
        if t:
            z = A_TRUE * z + Q * rng.standard_normal()
        ys.append(z + R_OBS * rng.standard_normal())
    return np.array(ys, dtype=np.float32)


def _kalman(a, ys):
    """(log p(y), filtered means, filtered variances, predicted means,
    predicted variances) of the scalar model, in float64."""
    mu, p, ll = 0.0, 1.0, 0.0
    out = []
    for t, y in enumerate(np.asarray(ys, dtype=np.float64)):
        if t:
            mu, p = a * mu, a * a * p + Q * Q
        mp, pp = mu, p
        s = p + R_OBS**2
        ll += -0.5 * (math.log(2 * math.pi * s) + (y - mu) ** 2 / s)
        k = p / s
        mu, p = mu + k * (y - mu), (1 - k) * p
        out.append((mu, p, mp, pp))
    mf, pf, mp, pp = (np.array(c) for c in zip(*out))
    return ll, mf, pf, mp, pp


def _smoothing_paths(a, ys, n, seed):
    """`n` exact draws from p(z_{0:T-1} | y): the Kalman filter, then
    backward sampling."""
    _, mf, pf, _, pp = _kalman(a, ys)
    rng = np.random.default_rng(seed)
    T = len(ys)
    out = np.empty((n, T))
    out[:, -1] = mf[-1] + math.sqrt(pf[-1]) * rng.standard_normal(n)
    for t in range(T - 2, -1, -1):
        gain = pf[t] * a / pp[t + 1]
        mean = mf[t] + gain * (out[:, t + 1] - a * mf[t])
        out[:, t] = mean + math.sqrt(pf[t] - gain * a * pf[t]) * rng.standard_normal(n)
    return out.astype(np.float32)


def _rts(a, ys):
    """Exact smoothed means and variances."""
    _, mf, pf, mp, pp = _kalman(a, ys)
    ms, ps = mf.copy(), pf.copy()
    for t in range(len(ys) - 2, -1, -1):
        c = pf[t] * a / pp[t + 1]
        ms[t] = mf[t] + c * (ms[t + 1] - mp[t + 1])
        ps[t] = pf[t] + c * c * (ps[t + 1] - pp[t + 1])
    return ms, ps


def _grid_posterior(ys, lo=-1.5, hi=2.5, n=801):
    """Mean of p(a | y) under a N(0, 1) prior, by quadrature over a grid."""
    grid = np.linspace(lo, hi, n)
    lp = np.array([_kalman(a, ys)[0] for a in grid]) - 0.5 * grid**2
    w = np.exp(lp - lp.max())
    return float((grid * w).sum() / w.sum())


def _filters(n):
    return (JBootstrapFilter(j_step, j_init, n, obs_addr="y"), tgx.BootstrapFilter(t_step, t_init, n, obs_addr="y"))


def _log_prior(a):
    return tgx.normal.logpdf(a, 0.0, 1.0)


# -- particle Gibbs ------------------------------------------------------------------------


def test_path_log_joint_and_the_pinned_weight_match_jax():
    ys = _data(10)
    path = np.random.default_rng(1).standard_normal(10).astype(np.float32)
    jf, tf = _filters(8)
    for a in (0.8, -0.3):
        ref = jpg.path_log_joint(jf, jnp.asarray(path), jnp.asarray(ys), (jnp.float32(a),))
        got = tpg.path_log_joint(tf, torch.from_numpy(path), torch.from_numpy(ys), (torch.tensor(a),))
        _close(got, ref)
        ref_w = jpg._retained_step(j_step, KEY, "z", "y", path[3], ys[3], (path[2], 3, jnp.float32(a)))
        got_w = tpg._retained_step(t_step, _rng(), "z", "y", torch.tensor(path[3]), torch.tensor(ys[3]),
                                   (torch.tensor(path[2]), 3, torch.tensor(a)))
        _close(got_w, ref_w)
    # The pinned weight is g(y | z): the observation density alone.
    _close(got_w, -0.5 * ((ys[3] - path[3]) / R_OBS) ** 2 - math.log(R_OBS) - 0.5 * math.log(2 * math.pi))


@pytest.mark.parametrize("ancestor_sampling", [True, False], ids=["pgas", "plain_csmc"])
def test_csmc_sweep_keeps_the_smoothing_distribution(ancestor_sampling):
    """The CSMC sweep leaves p(z | y) invariant: one sweep from each of N
    exact smoothing paths gives N exact smoothing paths, whose means per
    time step lie within 5 SE of the RTS means."""
    T, N = 8, 150
    ys = _data(T, 2)
    starts = _smoothing_paths(A_TRUE, ys, N, 3)
    _, tf = _filters(32)
    rng = _rng(4)
    a = torch.tensor(A_TRUE)
    out = np.stack([
        tpg.csmc_sweep(rng, tf, torch.from_numpy(ys), torch.from_numpy(p), (a,), ancestor_sampling=ancestor_sampling).numpy()
        for p in starts
    ])
    ms, ps = _rts(A_TRUE, ys)
    assert out.shape == (N, T) and np.isfinite(out).all()
    assert np.all(np.abs(out.mean(0) - ms) < 5 * np.sqrt(ps / N)), (out.mean(0), ms)
    assert not np.allclose(out, starts)  # the sweep moves


def test_particle_gibbs_recovers_the_parameter_posterior():
    """The PG chain's parameter against the exact p(a | y) (quadrature
    over the Kalman marginal), within 5 batch-means SE; a dict parameter
    and `collect` give stacked outputs, as in JAX's test."""
    ys = _data(10, 5)
    _, tf = _filters(32)
    pg = tpg.ParticleGibbs(tf, log_prior=_log_prior, step_scales=0.3, theta_steps=3)
    _, path, (thetas, accs) = pg.run(_rng(6), torch.tensor(0.5), torch.from_numpy(ys), n_sweeps=200)
    assert path.shape == (10,) and thetas.shape == (200,) and 0.0 < float(accs.mean()) < 1.0
    _batch_means_within_se(thetas[50:].numpy(), _grid_posterior(ys))

    @tgx.gen
    def init2(th):
        z = tgx.normal(0.0, 1.0) @ "z"
        _ = tgx.normal(z, R_OBS) @ "y"
        return z

    @tgx.gen
    def step2(z_prev, t, th):
        z = tgx.normal(th["a"] * z_prev + th["b"], Q) @ "z"
        _ = tgx.normal(z, R_OBS) @ "y"
        return z

    pg2 = tpg.ParticleGibbs(
        tgx.BootstrapFilter(step2, init2, 16, obs_addr="y"),
        log_prior=lambda th: _log_prior(th["a"]) + _log_prior(th["b"]),
        step_scales=0.2,
    )
    theta0 = {"a": torch.tensor(0.5), "b": torch.tensor(0.0)}
    theta, path, (outs, accs) = pg2.run(_rng(7), theta0, torch.from_numpy(ys[:6]), n_sweeps=10,
                                        collect=lambda th, p: (th["a"], p[0]))
    assert outs[0].shape == (10,) and outs[1].shape == (10,) and path.shape == (6,)
    assert bool(torch.isfinite(outs[0]).all()) and set(theta) == {"a", "b"}


# -- PMMH ------------------------------------------------------------------------------------


def test_pmmh_targets_the_parameter_posterior():
    """`tests/inference/test_pmmh.py`: the chain moves (accept rate in
    (0.05, 0.95)), its carried LML tracks the exact Kalman marginal at the
    current parameter within pseudo-marginal noise (3 nats), and its mean
    lies within 5 batch-means SE of the exact posterior mean and within 5
    combined batch-means SE of JAX's chain on the same data, filter size,
    prior and step scale."""
    ys = _data(12, 8)
    jf, tf = _filters(128)
    alg = PMMH(tf, log_prior=_log_prior, step_scales=0.3)
    theta, (thetas, lmls, accepts) = alg.run(_rng(9), torch.tensor(0.0), torch.from_numpy(ys), n_steps=300)
    assert thetas.shape == (300,) and bool(torch.isfinite(lmls).all())
    assert 0.05 < float(accepts.float().mean()) < 0.95
    assert abs(float(lmls[-1]) - _kalman(float(thetas[-1]), ys)[0]) < 3.0
    assert float(theta) == float(thetas[-1])
    _batch_means_within_se(thetas[60:].numpy(), _grid_posterior(ys))
    jalg = JPMMH(jf, log_prior=lambda a: jgx.normal.logpdf(a, 0.0, 1.0), step_scales=jnp.float32(0.3))
    _, (jthetas, jlmls, _) = jax.jit(lambda key: jalg.run(key, jnp.float32(0.0), jnp.asarray(ys), n_steps=300))(KEY)
    assert bool(jnp.isfinite(jlmls).all())
    ours, theirs = _batch_means(thetas[60:].numpy()), _batch_means(np.asarray(jthetas[60:]))
    se = math.sqrt(ours.var(ddof=1) / len(ours) + theirs.var(ddof=1) / len(theirs))
    assert abs(ours.mean() - theirs.mean()) < 5 * se, (ours.mean(), theirs.mean(), se)


def test_pmmh_with_a_dict_parameter_and_collect():
    @tgx.gen
    def init2(th):
        z = tgx.normal(0.0, 1.0) @ "z"
        _ = tgx.normal(z, R_OBS) @ "y"
        return z

    @tgx.gen
    def step2(z_prev, t, th):
        z = tgx.normal(th["a"] * z_prev + th["b"], Q) @ "z"
        _ = tgx.normal(z, R_OBS) @ "y"
        return z

    alg = PMMH(tgx.BootstrapFilter(step2, init2, 64, obs_addr="y"),
               log_prior=lambda th: _log_prior(th["a"]) + _log_prior(th["b"]), step_scales=0.2)
    theta0 = {"a": torch.tensor(0.5), "b": torch.tensor(0.0)}
    _, (outs, lmls, _) = alg.run(_rng(10), theta0, torch.from_numpy(_data(8, 11)), n_steps=20)
    assert outs["a"].shape == (20,) and outs["b"].shape == (20,) and bool(torch.isfinite(lmls).all())
    _, (sums, _, _) = alg.run(_rng(10), theta0, torch.from_numpy(_data(8, 11)), n_steps=20,
                              collect=lambda th: th["a"] + th["b"])
    _close(sums, outs["a"] + outs["b"])  # the same draws, collected


# -- smoothing ---------------------------------------------------------------------------------


def test_ffbs_backward_logits_match_jax():
    """The backward kernel's logits for given clouds, weights and next
    states against JAX's `ffbs_sample` formula (`lw_t + assess` of the
    step model from every cloud member, vmapped over the trajectories and
    the cloud), at 1e-5 per unit."""
    M, K, t, a = 5, 7, 3, np.float32(0.8)
    r = np.random.default_rng(22)
    cloud, lw, z_next = (r.standard_normal(n).astype(np.float32) for n in (K, K, M))
    y = np.float32(0.4)
    jf, tf = _filters(K)

    def row(zn):
        return lw + jax.vmap(lambda zi: j_step.assess(JC.kw(z=zn, y=y), (zi, t + 1, a))[0])(cloud)

    ref = jax.vmap(row)(z_next)
    got = backward_logits(tf, torch.from_numpy(cloud), torch.from_numpy(lw), torch.from_numpy(z_next), torch.tensor(y),
                          t, (torch.tensor(a),))
    assert got.shape == (M, K)
    _close(got, ref)


def test_ffbs_matches_the_rts_smoother():
    """`tests/inference/test_smoothing.py`'s model at T=20: 20 independent
    runs of K=512 clouds and M=256 paths. At every step the runs' mean of
    the paths' means and of their variances lie within 5 SE (over the
    runs) of the RTS smoother's means and variances; and smoothing tightens
    the filter's variance at t = 0."""

    @tgx.gen
    def init():
        z = tgx.normal(0.0, 1.0) @ "z"
        _ = tgx.normal(z, R_OBS) @ "y"
        return z

    @tgx.gen
    def step(z_prev, t):
        z = tgx.normal(0.9 * z_prev, Q) @ "z"
        _ = tgx.normal(z, R_OBS) @ "y"
        return z

    ys = torch.from_numpy(_data(20, 12))
    pf = tgx.BootstrapFilter(step, init, 512, obs_addr="y")
    rng = _rng(13)
    means, variances = [], []
    for _ in range(20):
        lml, clouds, lws = smoothing_clouds(pf, rng, ys)
        assert math.isfinite(float(lml)) and clouds.shape == (20, 512) and lws.shape == (20, 512)
        paths = ffbs_sample(rng, pf, clouds, lws, 256, ys)
        assert paths.shape == (256, 20)
        means.append(paths.double().mean(0).numpy())
        variances.append(paths.double().var(0).numpy())
    ms, ps = _rts(0.9, ys.numpy())
    for got, exact in ((np.stack(means), ms), (np.stack(variances), ps)):
        se = got.std(0, ddof=1) / math.sqrt(len(got))
        assert np.all(np.abs(got.mean(0) - exact) < 5 * se), (np.abs(got.mean(0) - exact) / se).max()
    w0 = torch.softmax(lws[0].double(), 0)
    filt_var0 = float(w0 @ (clouds[0].double() - w0 @ clouds[0].double()) ** 2)
    assert float(paths[:, 0].double().var()) < filt_var0


# -- tempered SMC ----------------------------------------------------------------------------


@tgx.gen
def t_conj():
    mu = tgx.normal(0.0, 1.0) @ "mu"
    _ = tgx.normal(mu, 1.0) @ "y"


@jgx.gen
def j_conj():
    mu = jgx.normal(0.0, 1.0) @ "mu"
    _ = jgx.normal(mu, 1.0) @ "y"


TARGET = tgx.Target(t_conj, (), TC.kw(y=1.0))


def _posterior_mean(coll) -> float:
    """The collection's self-normalized estimate of E[mu | y] (its weights
    are not equal where the last step kept them)."""
    return float(torch.softmax(coll.get_log_weights().double(), 0) @ coll.get_particles().get_choices()["mu"].double())
EXACT_LML = -0.25 - 0.5 * math.log(2 * math.pi * 2.0)


def test_loglik_and_the_collections_evidence_match_jax():
    mu = np.random.default_rng(15).standard_normal(64).astype(np.float32)
    tr = convert.trace(t_conj, (), {"mu": mu}, n=64, device="cpu", observations={"y": 1.0})
    ref = jax.vmap(lambda m: jtempered._loglik(KEY, j_conj.importance(KEY, JC.kw(mu=m, y=1.0), ())[0], jgx.Selection.at["y"]))(mu)
    _close(ttempered._loglik(_rng(), tr, tgx.Selection.at["y"]), ref)
    smc = TemperedSMC(n_particles=256, betas=torch.linspace(0.0, 1.0, 6), request=tgx.Regenerate(tgx.Selection.at["mu"]))
    coll, log_z = smc.run(_rng(16), TARGET)
    _close(coll.get_log_marginal_likelihood_estimate(), log_z)
    coll2, log_z2, _ = smc.run_adaptive(_rng(17), TARGET, n_steps=8)
    _close(coll2.get_log_marginal_likelihood_estimate(), log_z2)


def test_tempered_log_z_is_unbiased_and_the_posterior_right():
    smc = TemperedSMC(n_particles=512, betas=torch.linspace(0.0, 1.0, 8), request=tgx.Regenerate(tgx.Selection.at["mu"]),
                      n_moves=2)
    rng = _rng(18)
    runs = [smc.run(rng, TARGET) for _ in range(40)]
    _within_se(np.exp([float(z) - EXACT_LML for _, z in runs]), 1.0)
    _within_se([_posterior_mean(c) for c, _ in runs], 0.5)  # exact posterior N(0.5, 0.5)
    no_moves = TemperedSMC(n_particles=1024, betas=torch.linspace(0.0, 1.0, 6))
    _within_se(np.exp([float(no_moves.run(rng, TARGET)[1]) - EXACT_LML for _ in range(30)]), 1.0)


@pytest.mark.parametrize("kind", ["mala", "drift"])
def test_tempered_with_gradient_and_drift_rejuvenation(kind):
    request = tgx.MALA(tgx.Selection.at["mu"], 0.25) if kind == "mala" else GaussianDrift(tgx.Selection.at["mu"], 0.6)
    smc = TemperedSMC(n_particles=512, betas=torch.linspace(0.0, 1.0, 8), request=request, n_moves=3)
    rng = _rng(19)
    runs = [smc.run(rng, TARGET) for _ in range(12)]
    _within_se([_posterior_mean(c) for c, _ in runs], 0.5)
    _within_se(np.exp([float(z) - EXACT_LML for _, z in runs]), 1.0)


def test_adaptive_ladder_reaches_one_and_is_unbiased():
    @tgx.gen
    def tight():
        mu = tgx.normal(0.0, 1.0) @ "mu"
        _ = tgx.normal(mu, 0.3) @ "y"

    target = tgx.Target(tight, (), TC.kw(y=2.0))
    var = 1.0 + 0.09
    exact = -0.5 * 4.0 / var - 0.5 * math.log(2 * math.pi * var)
    smc = TemperedSMC(n_particles=512, request=tgx.Regenerate(tgx.Selection.at["mu"]), n_moves=2)
    rng = _rng(20)
    runs = [smc.run_adaptive(rng, target, n_steps=10) for _ in range(16)]
    for _, _, betas in runs:
        assert bool((betas[1:] - betas[:-1] >= -1e-6).all()) and float(betas[-1]) == pytest.approx(1.0)
    effective = int(((runs[0][2] - torch.cat([torch.zeros(1), runs[0][2][:-1]])) > 1e-6).sum())
    assert effective <= 6, runs[0][2]
    _within_se(np.exp([float(z) - exact for _, z, _ in runs]), 1.0)
    _within_se([_posterior_mean(c) for c, _, _ in runs], 2.0 / 1.09)
    # A budget too small for the ESS schedule still ends at beta = 1.
    _, _, betas = smc.run_adaptive(rng, target, n_steps=3)
    assert float(betas[-1]) == pytest.approx(1.0)
