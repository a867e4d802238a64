"""The Dirichlet-mixture Gibbs model (`genjax_tpu_torch.models.gmm`) and
stochastic volatility (`genjax_tpu_torch.models.stochvol`) against
`genjax_tpu.models.gmm` and `genjax_tpu.models.stochvol`, on the CPU.

Deterministic quantities (the joint of identical choices, a sweep's
assignment probabilities on one state, the SV step scores and prior)
agree at float32 tolerance. Random ones are held statistically: the
filter's mean LML against JAX's within 5 combined standard errors, and the
JAX test's five assertions on the port's own Gibbs chain.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

import genjax_tpu as jgx
import genjax_tpu.models.gmm as jgmm
import genjax_tpu.models.stochvol as jsv
import genjax_tpu_torch as tgx
from genjax_tpu_torch import convert
from genjax_tpu_torch.inference.particle_gibbs import ParticleGibbs
from genjax_tpu_torch.models import gmm, stochvol as sv

torch.set_num_threads(1)

TRUE_MEANS = np.array([-5.0, 0.0, 5.0], dtype=np.float32)
TRUE_PROBS = np.array([0.25, 0.5, 0.25], dtype=np.float32)
N, K = 300, 3


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    idx = rng.choice(K, size=n, p=TRUE_PROBS)
    obs = (TRUE_MEANS[idx] + 0.5 * rng.standard_normal(n)).astype(np.float32)
    return idx, obs


def test_gmm_assess_of_jax_choices_matches_jax():
    # A JAX trace's four addresses carried across (`idx` stays an integer
    # tensor), scored by both models.
    jm = jgmm.make_gmm(K, N)
    jtr = jm.simulate(jax.random.key(3), ())
    choices = {a: np.asarray(jtr.get_choices()[a]) for a in ("means", "probs", "idx", "obs")}
    chm = convert.choice_map(choices, device="cpu")
    assert chm["idx"].dtype == torch.int32
    score, means = gmm.make_gmm(K, N, device="cpu").assess(chm, ())
    np.testing.assert_allclose(float(score), float(jtr.get_score()), rtol=1e-5)
    np.testing.assert_array_equal(means.numpy(), choices["means"])
    # The sample-shaped sites alone: N categorical draws, K prior means.
    ref_idx = float(jnp.sum(jgx.categorical.logpdf(jnp.asarray(choices["idx"]), logits=jnp.log(choices["probs"]))))
    got_idx = float(tgx.categorical.logpdf(chm["idx"], logits=torch.log(chm["probs"])).sum())
    np.testing.assert_allclose(got_idx, ref_idx, rtol=1e-5)


def test_gmm_assignment_probabilities_match_jax_on_one_state():
    _, obs = _data(1)
    rng = np.random.default_rng(2)
    means = rng.normal(0.0, 4.0, K).astype(np.float32)
    probs = rng.dirichlet(np.ones(K)).astype(np.float32)
    ref = jax.nn.softmax(jnp.log(probs)[None, :] + jgmm._normal_lp(jnp.asarray(obs)[:, None], means[None, :], 0.5), -1)
    got = torch.softmax(gmm.assignment_logits(torch.from_numpy(obs), torch.from_numpy(means), torch.from_numpy(probs)), -1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_gibbs_recovers_the_mixture_like_the_jax_test():
    # The five assertions of `tests/inference/test_gmm.py` on the port's
    # chain (seed 1, as the JAX test's key(1)). From some starts a chain
    # settles in a merged-cluster mode in either package: measured on one
    # data set, 11 of 200 JAX keys and 3 of 100 port seeds.
    true_idx, obs = _data(0)
    rng, obs_t = torch.Generator().manual_seed(1), torch.from_numpy(obs)
    trace, counts = gmm.init_gibbs(rng, obs_t, k=K, device="cpu"), []
    for _ in range(100):
        trace, c = gmm.gibbs_sweep(rng, trace, obs_t, K)
        counts.append(c)
    counts = torch.stack(counts)
    chm = trace.get_choices()
    score, _ = gmm.make_gmm(K, N, device="cpu").assess(chm, ())
    assert math.isclose(float(trace.get_score()), float(score), abs_tol=1e-2, rel_tol=1e-5)
    means = torch.sort(chm["means"]).values.numpy()
    assert np.all(np.abs(means - TRUE_MEANS) < 0.3), means
    order = torch.argsort(chm["means"])
    assert np.all(np.abs(chm["probs"][order].numpy() - TRUE_PROBS) < 0.12)
    relabel = torch.argsort(order)
    assert float((relabel[chm["idx"]].numpy() == true_idx).mean()) > 0.95
    np.testing.assert_array_equal(chm["obs"].numpy(), obs)
    # Every sweep's counts add up to N; the idx site is an integer index.
    assert counts.shape == (100, K) and bool((counts.sum(-1) == N).all())
    assert chm["idx"].dtype == torch.int64


def test_simulate_gmm_data_draws_the_mixture():
    idx, obs = gmm.simulate_gmm_data(4, 8192, TRUE_MEANS, TRUE_PROBS, device="cpu")
    freq = torch.bincount(idx, minlength=K).double() / 8192
    se = np.sqrt(TRUE_PROBS * (1 - TRUE_PROBS) / 8192)
    assert np.all(np.abs(freq.numpy() - TRUE_PROBS) < 5 * se)
    resid = (obs - torch.from_numpy(TRUE_MEANS)[idx]).double()
    assert abs(float(resid.mean())) < 5 * 0.5 / math.sqrt(8192)


TRUE = {"phi": math.atanh(0.9), "log_sigma": math.log(0.3), "log_beta": math.log(0.8)}


def _jtheta():
    return {k: jnp.asarray(v, dtype=jnp.float32) for k, v in TRUE.items()}


def _ttheta():
    return convert.variational_params({k: np.float32(v) for k, v in TRUE.items()}, device="cpu")


def test_sv_step_scores_and_prior_match_jax():
    theta_j, theta_t = _jtheta(), _ttheta()
    for k, v in sv.true_theta("cpu").items():
        np.testing.assert_allclose(float(v), float(theta_t[k]), rtol=1e-7)
    jtr = jsv.sv_init.simulate(jax.random.key(0), (theta_j,))
    z, y = float(jtr.get_choices()["z"]), float(jtr.get_choices()["y"])
    got, h = sv.sv_init.assess(tgx.ChoiceMap.kw(z=z, y=y), (theta_t,))
    np.testing.assert_allclose(float(got), float(jtr.get_score()), rtol=1e-6)
    jtr = jsv.sv_step.simulate(jax.random.key(1), (jnp.float32(0.4), 3, theta_j))
    z, y = float(jtr.get_choices()["z"]), float(jtr.get_choices()["y"])
    got, _ = sv.sv_step.assess(tgx.ChoiceMap.kw(z=z, y=y), (torch.tensor(0.4), 3, theta_t))
    np.testing.assert_allclose(float(got), float(jtr.get_score()), rtol=1e-6)
    for theta in (TRUE, {"phi": 1.0, "log_sigma": -1.0, "log_beta": 0.0}, {"phi": -0.3, "log_sigma": 0.5, "log_beta": 2.0}):
        ref = jsv.sv_log_prior({k: jnp.float32(v) for k, v in theta.items()})
        got = sv.sv_log_prior({k: torch.tensor(v, dtype=torch.float32) for k, v in theta.items()})
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_sv_filter_lml_matches_jax_at_the_truth():
    # K = 256, T = 50, 20 filters each on the same returns.
    _, ys = jsv.simulate_sv_data(jax.random.key(0), 50, _jtheta())
    runs = 20
    jpf = jsv.make_sv_filter(256)
    jl = np.asarray(jax.jit(jax.vmap(lambda k: jpf.run(k, ys, (_jtheta(),))[0]))(jax.random.split(jax.random.key(5), runs)))
    ys_t = torch.from_numpy(np.array(ys))
    pf, theta = sv.make_sv_filter(256), _ttheta()
    rng = torch.Generator().manual_seed(5)
    tl = np.array([float(pf.run(rng, ys_t, (theta,))[0]) for _ in range(runs)])
    se = math.sqrt(jl.var(ddof=1) / runs + tl.var(ddof=1) / runs)
    assert np.isfinite(tl).all() and abs(jl.mean() - tl.mean()) < 5 * se, (jl.mean(), tl.mean(), se)


def test_sv_data_pmmh_and_particle_gibbs_on_the_cpu():
    hs, ys = sv.simulate_sv_data(0, 40, sv.true_theta("cpu"), device="cpu")
    assert hs.shape == ys.shape == (40,) and bool(torch.isfinite(ys).all())
    theta, thetas, lmls, accepts = sv.run_sv_pmmh(1, ys, n_particles=64, n_steps=20, device="cpu")
    assert lmls.shape == (20,) and bool(torch.isfinite(lmls).all())
    assert thetas["phi"].shape == (20,) and accepts.dtype == torch.bool
    assert set(theta) == {"phi", "log_sigma", "log_beta"}
    pg = ParticleGibbs(sv.make_sv_filter(32), log_prior=sv.sv_log_prior, step_scales=0.08, theta_steps=2)
    theta, path, (ths, accs) = pg.run(torch.Generator().manual_seed(2), sv.sv_theta(1.0, -1.0, 0.0, "cpu"), ys, n_sweeps=5)
    assert path.shape == (40,) and bool(torch.isfinite(ths["phi"]).all())


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (gmm.make_gmm, gmm.init_gibbs, gmm.run_gibbs, gmm.simulate_gmm_data, sv.run_sv_pmmh, sv.simulate_sv_data, sv.sv_theta, sv.true_theta):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
