"""The port's SMC² (`genjax_tpu_torch.inference.smc2`) and Rao-Blackwellized
particle filter (`genjax_tpu_torch.inference.rbpf`) against `genjax_tpu`
and the Kalman closed forms, on the CPU.

Deterministic pieces get the same numpy-made inputs as JAX and are held
at float32 tolerance, 1e-5 per unit of magnitude (`_close`): one RBPF
Kalman step per particle against JAX's `vmap` of `kalman_predict_update`
over `lgss_of_z`, the fully linear RBPF against the Kalman LML, the
row-wise systematic resample of SMC²'s inner filters against the port's
vector resampler row by row (and JAX's, up to its float32 floor ties).
Random quantities are held against the JAX tests' oracles with their
bounds (the Kalman-grid posterior mean and evidence for SMC², the prefix
Kalman LML for the masked filter), or against JAX's own estimator within
5 combined standard errors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.inference import kalman as jkalman
from genjax_tpu.inference.rbpf import RaoBlackwellFilter as JRBPF
from genjax_tpu.inference.smc import _blocks_to_ancestors, systematic_cum_counts as jax_cum_counts
from genjax_tpu_torch.inference.kalman import LinearGaussianSSM
from genjax_tpu_torch.inference.particle_filter import BootstrapFilter
from genjax_tpu_torch.inference.rbpf import RaoBlackwellFilter
from genjax_tpu_torch.inference.smc import cum_counts_to_ancestors, systematic_cum_counts
from genjax_tpu_torch.inference.smc2 import SMC2

torch.set_num_threads(1)

A_X, Q_X, R0, A_Z, Q_Z = 0.9, 0.5, 0.4, 0.9, 0.3


def _close(got, ref, tol=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), np.max(np.abs(got - ref))


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


def _within_combined_se(a, b, n_se=5.0):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    se = math.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) < n_se * se, (a.mean(), b.mean(), se)


# -- SMC² ------------------------------------------------------------------------------------


@tgx.gen
def t_init(theta):
    z = tgx.normal(0.0, 1.0) @ "z"
    _ = tgx.normal(z, 0.4) @ "y"
    return z


@tgx.gen
def t_step(z_prev, t, theta):
    z = tgx.normal(theta * z_prev, 0.5) @ "z"
    _ = tgx.normal(z, 0.4) @ "y"
    return z


def _simulate(T=25, a_true=0.8, seed=3):
    """`tests/inference/test_smc2.py::_simulate`."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal()
    ys = [z + 0.4 * rng.standard_normal()]
    for _ in range(1, T):
        z = a_true * z + 0.5 * rng.standard_normal()
        ys.append(z + 0.4 * rng.standard_normal())
    return np.array(ys, dtype=np.float32)


def _kalman_lml(a, ys, q=0.5, r=0.4):
    mu, p, ll = 0.0, 1.0, 0.0
    for t, y in enumerate(np.asarray(ys, dtype=np.float64)):
        if t:
            mu, p = a * mu, a * a * p + q * q
        s = p + r * r
        ll += -0.5 * (math.log(2 * math.pi * s) + (y - mu) ** 2 / s)
        k = p / s
        mu, p = mu + k * (y - mu), (1 - k) * p
    return ll


def _exact(ys):
    """`tests/inference/test_smc2.py::_exact` in float64: the posterior mean
    of `a` and the evidence, by quadrature on the grid."""
    grid = np.linspace(-1.5, 1.5, 301)
    logpost = np.array([_kalman_lml(a, ys) for a in grid]) - 0.5 * grid**2 - 0.5 * math.log(2 * math.pi)
    w = np.exp(logpost - logpost.max())
    return float((w * grid).sum() / w.sum()), float(logpost.max() + math.log(w.sum()) + math.log(grid[1] - grid[0]))


def _alg(n_theta=256, n_x=256, **kw):
    return SMC2(
        t_step, t_init,
        prior_sample=lambda rng, n: torch.randn(n, generator=rng, device=rng.device),
        log_prior=lambda v: tgx.normal.logpdf(v, 0.0, 1.0),
        n_theta=n_theta, n_x=n_x, step_scales=0.25, **kw,
    )


def test_exact_oracle_matches_jax_kalman():
    ys = _simulate()
    for a in (-0.4, 0.8):
        ref = jkalman.LinearGaussianSSM.build(a=a, q=0.5, h=1.0, r=0.4, p0=1.0).lml(jnp.asarray(ys)[:, None])
        _close(_kalman_lml(a, ys), ref)


def test_posterior_mean_and_evidence_against_the_grid_oracle():
    ys = _simulate()
    exact_mean, exact_lml = _exact(ys)
    out = _alg().run(_rng(0), torch.from_numpy(ys))
    w = torch.softmax(out["log_weights"], 0)
    assert abs(float((w * out["thetas"]).sum()) - exact_mean) < 0.06
    assert abs(float(out["lml"]) - exact_lml) < 0.6
    assert out["n_rejuvenations"] >= 1
    assert 0.1 < float(out["accept_rate"]) <= 1.0


def test_collect_hook_has_one_row_per_time_index():
    ys = _simulate(T=10)
    out = _alg(32, 32).run(_rng(1), torch.from_numpy(ys), collect=lambda th, lw: (torch.softmax(lw, 0) * th).sum())
    assert out["collected"].shape == (10,) and bool(torch.isfinite(out["collected"]).all())


def test_masked_loglik_of_many_rows_matches_the_prefix_kalman_lml():
    # JAX runs 64 filters at theta = 0.7 under vmap over keys; here they are
    # 64 parameter rows of one call. Unbiased in density space: the log of
    # the mean of exp(estimate) within the JAX test's 0.15 of the exact
    # prefix evidence.
    ys = _simulate(T=12)
    alg = _alg(8, 512)
    lls, z, lw = alg._masked_loglik(_rng(2), torch.full((64,), 0.7), torch.from_numpy(ys), 6)
    assert lls.shape == (64,) and lw.shape == (64, 512) and z.shape == (64 * 512,)
    est = float(torch.logsumexp(lls, 0) - math.log(64.0))
    assert abs(est - _kalman_lml(0.7, ys[:7])) < 0.15


@pytest.mark.parametrize("seed,spread", [(0, 1.0), (1, 3.0), (2, 8.0)])
def test_row_systematic_ancestors_are_the_vector_resampler_row_by_row(seed, spread):
    rows, n = 6, 512
    lw = torch.from_numpy((spread * np.random.default_rng(seed).standard_normal((rows, n))).astype(np.float32))
    u0 = torch.rand(rows, generator=_rng(seed))
    got = cum_counts_to_ancestors(systematic_cum_counts(u0, lw, n, torch.logsumexp(lw, -1)), n)
    for i in range(rows):
        want = cum_counts_to_ancestors(systematic_cum_counts(u0[i], lw[i], n), n)
        assert torch.equal(got[i], want)
        # And JAX's, fed the same uniform: equal but at float32 floor ties.
        key = jax.random.key(seed * 10 + i)
        u_j = jax.random.uniform(key, (), dtype=jnp.float32)
        ref = np.asarray(_blocks_to_ancestors(jax_cum_counts(key, jnp.asarray(lw[i].numpy()), n), n))
        ours = cum_counts_to_ancestors(systematic_cum_counts(torch.tensor([float(u_j)]), lw[i : i + 1], n,
                                                             torch.logsumexp(lw[i : i + 1], -1)), n)[0]
        assert np.mean(ours.numpy() != ref) <= 0.01


def test_inner_resample_keeps_each_row_apart():
    # One row with weights that force a resample (ESS about 1), one whose
    # ESS stays above the threshold (2.56 of 256): the per-row where resets
    # only the first row's weights.
    alg = _alg(2, 256, inner_ess_threshold=0.01)
    thetas = torch.tensor([0.8, 0.8])
    z, lw, _ = alg._init_all(_rng(3), thetas, torch.tensor(0.3))
    lw = torch.stack([torch.linspace(0.0, 300.0, 256), torch.zeros(256)])
    z2, lw2, incr = alg._advance_all(_rng(4), thetas, z, lw, torch.tensor(0.5), 1)
    assert torch.equal(lw2[0], torch.zeros(256)) and not torch.equal(lw2[1], torch.zeros(256))
    assert incr.shape == (2,) and bool(torch.isfinite(incr).all())


def test_a_run_reads_the_gate_once_per_step_and_reduces_the_theta_weights_through_k1(monkeypatch):
    # The parameter weights go through `logsumexp_ess` once per time step
    # and `logsumexp` once at the end (the CUDA kernel on the card).
    import genjax_tpu_torch.inference.smc2 as module

    calls = {"ess": 0, "lse": 0}
    ess, lse = module.logsumexp_ess, module.logsumexp
    monkeypatch.setattr(module, "logsumexp_ess", lambda x: (calls.__setitem__("ess", calls["ess"] + 1), ess(x))[1])
    monkeypatch.setattr(module, "logsumexp", lambda x: (calls.__setitem__("lse", calls["lse"] + 1), lse(x))[1])
    _alg(16, 32).run(_rng(5), torch.from_numpy(_simulate(T=8)))
    assert calls == {"ess": 7, "lse": 1}


# -- the Rao-Blackwellized filter ----------------------------------------------------------------


@tgx.gen
def z_init():
    return tgx.normal(0.0, 1.0) @ "z"


@tgx.gen
def z_step(z_prev, t):
    return tgx.normal(A_Z * z_prev, Q_Z) @ "z"


def lgss_of_z(z):
    return LinearGaussianSSM.build(a=A_X, q=Q_X, h=1.0, r=R0 * torch.exp(0.5 * z), d=1, device="cpu")


def j_lgss_of_z(z):
    return jkalman.LinearGaussianSSM.build(a=A_X, q=Q_X, h=1.0, r=R0 * jnp.exp(0.5 * z), d=1)


@tgx.gen
def joint_init():
    z = tgx.normal(0.0, 1.0) @ "z"
    x = tgx.normal(0.0, 1.0) @ "x"
    _ = tgx.normal(x, R0 * torch.exp(0.5 * z)) @ "y"
    return (z, x)


@tgx.gen
def joint_step(state, t):
    z_prev, x_prev = state
    z = tgx.normal(A_Z * z_prev, Q_Z) @ "z"
    x = tgx.normal(A_X * x_prev, Q_X) @ "x"
    _ = tgx.normal(x, R0 * torch.exp(0.5 * z)) @ "y"
    return (z, x)


def _switching_data(T, seed):
    rng = np.random.default_rng(seed)
    z, x, ys = rng.standard_normal(), rng.standard_normal(), []
    for t in range(T):
        if t:
            z = A_Z * z + Q_Z * rng.standard_normal()
            x = A_X * x + Q_X * rng.standard_normal()
        ys.append(x + R0 * math.exp(0.5 * z) * rng.standard_normal())
    return np.array(ys, dtype=np.float32)


@pytest.mark.parametrize("predict", [False, True])
def test_one_kalman_step_per_particle_matches_jax(predict):
    rng = np.random.default_rng(7)
    z = rng.standard_normal(64).astype(np.float32)
    mu = rng.standard_normal((64, 1)).astype(np.float32)
    P = (0.2 + rng.random((64, 1, 1))).astype(np.float32)
    y = np.array([0.7], dtype=np.float32)
    rb = RaoBlackwellFilter(z_step, z_init, lgss_of_z, 64)
    got = rb.kalman_step(torch.from_numpy(z), torch.from_numpy(mu), torch.from_numpy(P), torch.from_numpy(y),
                         predict=predict)

    def one(zi, mi, Pi):
        m = j_lgss_of_z(zi)
        return jkalman.kalman_predict_update(m.A, m.Q, m.H, m.R, mi, Pi, jnp.asarray(y), predict=predict)

    ref = jax.vmap(one)(jnp.asarray(z), jnp.asarray(mu), jnp.asarray(P))
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("resampling", ["systematic", "multinomial", "stratified", "residual"])
def test_fully_linear_case_is_the_kalman_lml(resampling):
    m = LinearGaussianSSM.build(a=A_X, q=Q_X, h=1.0, r=R0, d=1, device="cpu")
    _, ys = m.sample(_rng(0), 25)
    lml, (z, mu, P) = RaoBlackwellFilter(z_step, z_init, lambda z: m, 64, resampling=resampling).run(_rng(1), ys)
    assert abs(float(lml) - float(m.lml(ys))) < 1e-4
    assert z.shape == (64,) and mu.shape == (64, 1) and P.shape == (64, 1, 1)


def test_lml_agrees_with_jax_rbpf():
    # The two packages' estimators of the same evidence, 16 runs each.
    ys = _switching_data(20, 11)
    ours = [float(RaoBlackwellFilter(z_step, z_init, lgss_of_z, 256).run(_rng(100 + i), torch.from_numpy(ys)[:, None])[0])
            for i in range(16)]

    @jgx.gen
    def jz_init():
        return jgx.normal(0.0, 1.0) @ "z"

    @jgx.gen
    def jz_step(z_prev, t):
        return jgx.normal(A_Z * z_prev, Q_Z) @ "z"

    rb = JRBPF(jz_step, jz_init, j_lgss_of_z, 256)
    theirs = jax.jit(jax.vmap(lambda k: rb.run(k, jnp.asarray(ys)[:, None])[0]))(jax.random.split(jax.random.key(3), 16))
    _within_combined_se(ours, np.asarray(theirs))


def test_agrees_with_the_joint_bootstrap_filter():
    ys = torch.from_numpy(_switching_data(30, 2))
    rb = RaoBlackwellFilter(z_step, z_init, lgss_of_z, 512)
    rb_lmls = [float(rb.run(_rng(10 + i), ys[:, None])[0]) for i in range(12)]
    pf = BootstrapFilter(joint_step, joint_init, 8192, obs_addr="y")
    pf_lmls = [float(pf.run(_rng(50 + i), ys)[0]) for i in range(12)]
    assert abs(np.mean(rb_lmls) - np.mean(pf_lmls)) < 0.25, (np.mean(rb_lmls), np.mean(pf_lmls))


def test_discrete_switching_regimes():
    p_stay = 0.9

    @tgx.gen
    def sw_init():
        return tgx.categorical(torch.log(torch.tensor([0.5, 0.5]))) @ "z"

    @tgx.gen
    def sw_step(z_prev, t):
        stay, leave = math.log(p_stay), math.log(1 - p_stay)
        logits = torch.where((z_prev == 0)[..., None], torch.tensor([stay, leave]), torch.tensor([leave, stay]))
        return tgx.categorical(logits) @ "z"

    def sw_lgss(z):
        r = torch.where(z == 0, 0.2, 1.0)
        return LinearGaussianSSM.build(a=0.95, q=0.3, h=1.0, r=r, d=1, device="cpu")

    rng = np.random.default_rng(7)
    T, x, ys = 40, 0.5, []
    for t in range(T):
        if t:
            x = 0.95 * x + 0.3 * rng.standard_normal()
        ys.append(x + (0.2 if t < T // 2 else 1.0) * rng.standard_normal())
    ys = torch.tensor(ys, dtype=torch.float32)[:, None]
    lml, (zf, _, _) = RaoBlackwellFilter(sw_step, sw_init, sw_lgss, 512).run(_rng(8), ys)
    assert bool(torch.isfinite(lml))
    assert float(zf.float().mean()) > 0.6  # the filtered regime favours regime 1 at the end


def test_variance_reduction_at_equal_particles():
    ys = torch.from_numpy(_switching_data(40, 5))
    K = 256
    rb = RaoBlackwellFilter(z_step, z_init, lgss_of_z, K)
    pf = BootstrapFilter(joint_step, joint_init, K, obs_addr="y")
    rb_lmls = torch.stack([rb.run(_rng(200 + i), ys[:, None])[0] for i in range(24)])
    pf_lmls = torch.stack([pf.run(_rng(300 + i), ys)[0] for i in range(24)])
    assert float(rb_lmls.std()) < float(pf_lmls.std()), (float(rb_lmls.std()), float(pf_lmls.std()))


def test_the_filter_reduces_its_weights_once_per_step(monkeypatch):
    import genjax_tpu_torch.inference.rbpf as module

    calls = []
    ess = module.logsumexp_ess
    monkeypatch.setattr(module, "logsumexp_ess", lambda x: (calls.append(x.shape), ess(x))[1])
    RaoBlackwellFilter(z_step, z_init, lgss_of_z, 128).run(_rng(9), torch.from_numpy(_switching_data(12, 1))[:, None])
    assert calls == [(128,)] * 11
