"""The discrete HMM of the combinator path, port against JAX on the CPU:
`categorical`'s log density and draws, the circulant tables,
`forward_filter` against JAX's and against brute force over the 5^3
paths, `path_joint_logpdf` against the scan model's `assess` (the port's
and JAX's), FFBS frequencies against the exact posterior, the exact
testbed, and the whole slice small (5 states, T=6, K=4096): the
likelihood-weighting LML within 5 SE of the exact marginal. Then the
vmapped logistic regression: its `assess` equal to the vector-site
model's and to JAX's `Vmap` version, and HMC through it equal to HMC
through the vector-site model.

Log densities are compared to 1e-5 absolute per unit of magnitude
(float32, sums in different orders); frequencies at 5 standard errors.
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
from genjax_tpu.distributions import discrete_hmm as jhmm
from genjax_tpu.inference.exact_testbed import build_hmm_chain_model as j_build
from genjax_tpu_torch import convert
from genjax_tpu_torch.distributions import discrete_hmm as thmm
from genjax_tpu_torch.inference.exact_testbed import build_hmm_chain_model, build_test_against_exact_inference
from genjax_tpu_torch.models import hmm, logreg

torch.set_num_threads(1)

JC, TC = jgx.ChoiceMap, tgx.ChoiceMap
CONFIG = (5, 1, 1, 0.5, 0.5)


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    same = got == ref  # equal infinities agree
    with np.errstate(invalid="ignore"):
        assert np.all(same | (np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref)))), (got, ref)


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


def _tables():
    jc, tc = jhmm.DiscreteHMMConfiguration(*CONFIG), thmm.DiscreteHMMConfiguration(*CONFIG)
    return jc, tc, tc.tables("cpu")


# -- categorical -----------------------------------------------------------------


@pytest.mark.parametrize("form", ["logits", "probs"])
def test_categorical_logpdf_matches_jax(form):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((7, 4)).astype(np.float32)
    v = rng.integers(-1, 6, size=7)  # some outside 0..3
    param = logits if form == "logits" else np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ref = jgx.categorical.logpdf(jnp.asarray(v), **{form: jnp.asarray(param)})
    got = tgx.categorical.logpdf(torch.from_numpy(v), **{form: torch.from_numpy(param)})
    _close(got, ref)
    assert np.isneginf(got.numpy()[(v < 0) | (v > 3)]).all()
    # One shared row of logits scored at a batch of draws, and a fractional value.
    _close(
        tgx.categorical.logpdf(torch.tensor([0, 3, 1]), logits=torch.from_numpy(logits[0])),
        jgx.categorical.logpdf(jnp.asarray([0, 3, 1]), logits=jnp.asarray(logits[0])),
    )
    assert tgx.categorical.logpdf(torch.tensor(1.5), logits=torch.zeros(3)) == -math.inf


def test_categorical_draws_statistically_and_records_its_logits():
    logits = torch.tensor([0.0, 1.0, -1.0, 0.5])
    n = 20_000
    tr = tgx.categorical.simulate(_rng(), (logits, None), n=n)
    draws = tr.get_retval()
    assert draws.shape == (n,) and draws.dtype == torch.int64
    p = torch.softmax(logits, 0).numpy()
    freq = np.bincount(draws.numpy(), minlength=4) / n
    assert np.all(np.abs(freq - p) < 5 * np.sqrt(p * (1 - p) / n))  # 5 SE
    # The shared logits are recorded as shared although they have an axis
    # that the value lacks (a length-K logits row would else be resampled).
    assert tr.args_record() == [0, 0] and tr.batched_leaves() == [0, 0, 1, 1]
    rows = tgx.per_particle(torch.zeros(6, 4))
    per_row = tgx.categorical(logits=rows).gen_fn.simulate(_rng(), (rows, None), n=6)
    assert per_row.args_record() == [1, 0] and per_row.get_retval().shape == (6,)
    one = tgx.categorical.simulate(_rng(), (None, torch.tensor([0.0, 1.0])))
    assert int(one.get_retval()) == 1 and float(one.get_score()) == 0.0


# -- the exact algorithms -----------------------------------------------------------


def test_tables_match_jax():
    jc, tc, (prior, trans, obs) = _tables()
    _close(prior, jc.prior_logits())
    _close(trans, jc.transition_log_probs())
    _close(obs, jc.observation_log_probs())
    hard = thmm.DiscreteHMMConfiguration(5, 1, 1, 0.0, 0.0).transition_tensor("cpu")
    _close(hard, jhmm.DiscreteHMMConfiguration(5, 1, 1, 0.0, 0.0).transition_tensor())


def test_forward_filter_matches_jax_and_brute_force():
    jc, tc, (prior, trans, obs) = _tables()
    observations = np.array([0, 2, 4])
    filters, log_marginal = thmm.forward_filter(prior, trans, obs, torch.from_numpy(observations))
    j_filters, j_marginal = jhmm.forward_filter(
        jc.prior_logits(), jc.transition_log_probs(), jc.observation_log_probs(), jnp.asarray(observations)
    )
    _close(filters, j_filters)
    _close(log_marginal, j_marginal)
    paths = torch.tensor(list(itertools.product(range(5), repeat=3)))  # all 5^3 latent paths at once
    joint = thmm.path_joint_logpdf(prior, trans, obs, paths, torch.from_numpy(observations))
    _close(torch.logsumexp(joint, 0), log_marginal, tol=1e-4)
    _close(tgx.DiscreteHMM.data_logpdf(tc, torch.from_numpy(observations)), j_marginal)
    # The posterior density normalizes.
    post = tgx.DiscreteHMM.estimate_logpdf(None, paths, tc, torch.from_numpy(observations))
    _close(torch.logsumexp(post, 0).exp(), 1.0, tol=1e-4)
    one = jhmm.DiscreteHMM.estimate_logpdf(jax.random.key(0), jnp.asarray([1, 2, 3]), jc, jnp.asarray(observations))
    _close(post[paths.tolist().index([1, 2, 3])], one)


def test_path_joint_logpdf_equals_the_scan_models_assess():
    jc, tc, (prior, trans, obs) = _tables()
    rng = np.random.default_rng(1)
    T, K = 6, 16
    z, x, init = rng.integers(0, 5, size=(K, T)), rng.integers(0, 5, size=T), 2
    model = build_hmm_chain_model(tc, T, "cpu")
    score, (final, _) = model.assess(convert.choice_map({"z": z}, "cpu", n=K) | TC.kw(x=torch.from_numpy(x)), (init, None), n=K)
    closed = thmm.path_joint_logpdf(trans[init], trans, obs, torch.from_numpy(z), torch.from_numpy(x))
    _close(score, closed)
    assert torch.equal(final, torch.from_numpy(z[:, -1]))
    j_model = j_build(jc, T)
    ref = jax.vmap(lambda z: j_model.assess(JC.kw(z=z, x=jnp.asarray(x)), (init, None))[0])(jnp.asarray(z))
    _close(score, ref)
    # One path without a particle axis, and the per-step scores of a trace.
    _close(model.assess(TC.kw(z=torch.from_numpy(z[0]), x=torch.from_numpy(x)), (init, None))[0], ref[0])
    tr = convert.trace(model, (init, None), {"z": z}, n=K, device="cpu", observations={"x": x})
    assert tr.inner.get_score().shape == (K, T)
    _close(tr.inner.get_score().sum(-1), ref)


def test_ffbs_frequencies_match_the_exact_posterior():
    jc, tc, (prior, trans, obs) = _tables()
    observations = torch.tensor([0, 1])
    n = 8000
    paths, filters = tgx.forward_filtering_backward_sampling(_rng(2), tc, observations, n=n)
    assert paths.shape == (n, 2) and filters.shape == (2, 5)
    every = torch.tensor(list(itertools.product(range(5), repeat=2)))
    p = tgx.DiscreteHMM.estimate_logpdf(None, every, tc, observations).exp().numpy()
    counts = np.bincount((paths[:, 0] * 5 + paths[:, 1]).numpy(), minlength=25) / n
    assert np.all(np.abs(counts - p) < 5 * np.sqrt(p * (1 - p) / n) + 1e-9)  # 5 SE
    one, _ = tgx.forward_filtering_backward_sampling(_rng(3), tc, observations)
    assert one.shape == (2,)
    tr = tgx.DiscreteHMM.simulate(_rng(4), (tc, observations), n=7)
    assert tr.get_retval().shape == (7, 2) and tr.get_score().shape == (7,)
    _close(tr.get_score(), tgx.DiscreteHMM.estimate_logpdf(None, tr.get_retval(), tc, observations))


def test_exact_testbed_problem():
    generator = build_test_against_exact_inference(4, 5, 1, 1, 0.5, 0.5, device="cpu")
    problem, config = generator(_rng(5))
    assert problem.latent_sequence.shape == (4,) and problem.observation_sequence.shape == (4,)
    jc = jhmm.DiscreteHMMConfiguration(*CONFIG)
    ref = jhmm.DiscreteHMM.estimate_logpdf(
        jax.random.key(0), jnp.asarray(problem.latent_sequence.numpy()), jc, jnp.asarray(problem.observation_sequence.numpy())
    )
    _close(problem.log_posterior, ref)
    _close(problem.log_data_marginal, jhmm.DiscreteHMM.data_logpdf(jc, jnp.asarray(problem.observation_sequence.numpy())))
    assert float(problem.log_posterior) <= 0.0 and isinstance(config, thmm.DiscreteHMMConfiguration)


# -- the slice as a whole, small ------------------------------------------------------


def test_likelihood_weighting_lml_within_5_se_of_the_exact_marginal():
    cfg = hmm.BenchConfig(n_states=5, T=6, n_particles=4096, adjacency=1)
    obs = cfg.data("cpu")
    model = build_hmm_chain_model(cfg.hmm(), cfg.T, "cpu")
    exact = float(hmm.exact_log_marginal(cfg.hmm(), obs, cfg.initial_state()))
    lmls = []
    for seed in range(12):
        col = hmm.run_hmm_importance(_rng(seed), model, obs, cfg.initial_state(), cfg.n_particles)
        lmls.append(float(col.get_log_marginal_likelihood_estimate()))
    trace = col.get_particles()
    assert trace.get_choices()["z"].shape == (4096, 6) and trace.inner.get_score().shape == (4096, 6)
    assert torch.equal(trace.get_choices()["x"], obs)  # the observations are stored once
    se = np.std(lmls, ddof=1) / np.sqrt(len(lmls))
    assert abs(np.mean(lmls) - exact) < 5 * se, (np.mean(lmls), exact, se)
    # The weights are the observation terms, and a resample keeps the record.
    _close(trace.project(_rng(), tgx.Selection.at[..., "x"]), col.get_log_weights())
    picked = col.resample(_rng(1)).get_particles()
    assert picked.get_choices()["z"].shape == (4096, 6) and picked.get_choices()["x"] is trace.get_choices()["x"]
    single = col.get_particle(7)
    assert single.get_choices()["z"].shape == (6,) and single.particle_count() is None


# -- the vmapped logistic regression ------------------------------------------------------


def _logreg_case(c=32, n=40, d=4):
    rng = np.random.default_rng(2)
    X = rng.standard_normal((n, d)).astype(np.float32)
    ys = (rng.random(n) < 0.5).astype(np.int32)
    w = (0.5 * rng.standard_normal((c, d))).astype(np.float32)
    return X, ys, w


def test_vmapped_logreg_assess_equals_vector_site_and_jax_vmap():
    X, ys, w = _logreg_case()
    c = w.shape[0]
    vector, _ = logreg.logistic_regression.assess(convert.choice_map({"w": w}, "cpu", n=c) | TC.kw(ys=_i(ys)), (_f(X),), n=c)
    chm = convert.choice_map({"w": w}, "cpu", n=c) | TC.d({("data", "y"): _i(ys)})
    lanes, logits = logreg.logistic_regression_vmap.assess(chm, (_f(X),), n=c)
    _close(lanes, vector)
    assert logits.shape == (c, X.shape[0])

    @jgx.gen
    def j_datum(x, w):
        return jgx.bernoulli(logits=jnp.sum(x * w)) @ "y"

    @jgx.gen
    def j_model(X):
        w = jgx.mv_normal_diag(jnp.zeros(X.shape[1]), jnp.ones(X.shape[1])) @ "w"
        return j_datum.vmap(in_axes=(0, None))(X, w) @ "data"

    ref = jax.vmap(lambda w: j_model.assess(JC.d({"w": w, ("data", "y"): jnp.asarray(ys)}), (jnp.asarray(X),))[0])(
        jnp.asarray(w)
    )
    _close(lanes, ref)
    tr = convert.chain_batch(logreg.logistic_regression_vmap, (X,), {"w": w}, {("data", "y"): ys}, device="cpu")
    assert tr.get_subtrace("data").inner.get_score().shape == (c, X.shape[0])
    _close(tr.get_score(), ref)


def test_hmc_through_vmap_equals_hmc_through_the_vector_site():
    X, ys, _ = _logreg_case()
    runs = [
        logreg.run_hmc_chains(_rng(3), _f(X), _i(ys), n_chains=16, n_steps=3, eps=0.02, L=3, model=model, ys_address=at)
        for model, at in ((logreg.logistic_regression, "ys"), (logreg.logistic_regression_vmap, logreg.VMAP_YS))
    ]
    (w_vector, acc_vector), (w_vmap, acc_vmap) = runs
    _close(w_vmap, w_vector.numpy(), tol=1e-4)  # the same draws through the same math, summed in another order
    assert torch.equal(acc_vector, acc_vmap)


def _f(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _i(x):
    return torch.from_numpy(np.asarray(x, dtype=np.int32))
