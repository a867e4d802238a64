"""The port's SMC library (`genjax_tpu_torch.inference.smc`, `sp`,
`particle_filter`, `requests.rejuvenate`, `requests.drift`, and
`GenerativeFunction.propose`) against `genjax_tpu` on the CPU.

Deterministic parts are fed the same numpy-made inputs (JAX's own
uniforms for the resamplers, JAX's own collections carried across by
`convert.particle_collection`) and compared at float32 tolerance: 1e-5 per
unit of magnitude for scores and weights (`_close`); ancestors exactly, up
to the float32 ties that the two packages' different summation orders
break differently (at most 2 in 1000 entries, each a tie). Random parts
(LMLs, posterior moments, resampler counts) are held against closed forms
or the exact forward algorithm within 5 standard errors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.distributions.discrete_hmm import DiscreteHMM as JDiscreteHMM
from genjax_tpu.distributions.discrete_hmm import DiscreteHMMConfiguration as JHMMConfig
from genjax_tpu.inference import smc as jsmc
from genjax_tpu.inference.requests import GaussianDrift as JGaussianDrift
from genjax_tpu.inference.requests import Rejuvenate as JRejuvenate
from genjax_tpu_torch import convert
from genjax_tpu_torch.inference import smc as tsmc
from genjax_tpu_torch.inference.requests import GaussianDrift, Rejuvenate
from genjax_tpu_torch.inference.smc import ChangeTarget, Importance, ImportanceK, SMCDriver

torch.set_num_threads(1)

JC, TC = jgx.ChoiceMap, tgx.ChoiceMap
JS, TS = jgx.Selection.at, tgx.Selection.at
KEY = jax.random.key(0)
K = 8192


def _close(got, ref, tol=1e-5):
    """|got - ref| <= tol * max(1, |ref|), elementwise, shapes equal."""
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), (got, ref)


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


def _within_se(values, exact, n_se=5.0):
    values = np.asarray(values, dtype=np.float64)
    se = values.std(ddof=1) / math.sqrt(len(values))
    assert np.isfinite(values).all()
    assert abs(values.mean() - exact) < n_se * se + 1e-9, (values.mean(), exact, se)


def _lml_within_se(lmls, exact, n_se=5.0):
    """An LML estimator is unbiased for Z: the mean of exp(lml - exact) is
    1 within `n_se` standard errors."""
    _within_se(np.exp(np.asarray(lmls, dtype=np.float64) - exact), 1.0, n_se)


def _normal_lml(y, prior_sd, obs_sd=1.0):
    var = prior_sd**2 + obs_sd**2
    return -0.5 * y * y / var - 0.5 * math.log(2 * math.pi * var)


# -- the models, one pair each ---------------------------------------------------


@jgx.gen
def j_model(s):
    x = jgx.normal(0.0, s) @ "x"
    _ = jgx.normal(x, 1.0) @ "y"
    return x


@tgx.gen
def t_model(s):
    x = tgx.normal(0.0, s) @ "x"
    _ = tgx.normal(x, 1.0) @ "y"
    return x


@jgx.gen
def j_two(s):
    x = jgx.normal(0.0, s) @ "x"
    _ = jgx.normal(x, 1.0) @ "y1"
    _ = jgx.normal(0.5 * x, 0.7) @ "y2"
    return x


@tgx.gen
def t_two(s):
    x = tgx.normal(0.0, s) @ "x"
    _ = tgx.normal(x, 1.0) @ "y1"
    _ = tgx.normal(0.5 * x, 0.7) @ "y2"
    return x


def _targets():
    return (tgx.Target(t_model, (1.0,), TC.kw(y=1.0)), tgx.Target(t_model, (2.0,), TC.kw(y=1.0)))


# -- sp: Target, Marginal, propose --------------------------------------------------


def test_target_rejects_a_marginal_and_reads_its_constraint_like_jax():
    with pytest.raises(TypeError, match="Marginal"):
        jgx.Target(jgx.marginal()(j_model), (1.0,), JC.kw(y=1.0))
    with pytest.raises(TypeError, match="Marginal"):
        tgx.Target(tgx.marginal()(t_model), (1.0,), TC.kw(y=1.0))
    jt, tt = jgx.Target(j_model, (1.0,), JC.kw(y=1.5)), tgx.Target(t_model, (1.0,), TC.kw(y=1.5))
    assert float(tt["y"]) == float(jt["y"]) == 1.5


def test_marginal_estimates_like_jax():
    """`estimate_logpdf` without an algorithm is the importance weight of
    the kept choices (deterministic when they constrain every address);
    `random_weighted` with `selection` all is the trace's own score."""
    v = np.float32(0.3)
    jm, tm = jgx.marginal()(j_model), tgx.marginal()(t_model)
    ref = jm.estimate_logpdf(KEY, JC.kw(x=v, y=np.float32(1.2)), 1.5)
    got = tm.estimate_logpdf(_rng(), TC.kw(x=torch.tensor(v), y=torch.tensor(1.2)), 1.5)
    _close(got, ref)
    w, chm = tm.random_weighted(_rng(1), 1.5, n=64)
    assert w.shape == (64,) and chm.batched_leaves() == [1, 1]
    ref_w = jax.vmap(lambda x, y: j_model.assess(JC.kw(x=x, y=y), (1.5,))[0])(chm["x"].numpy(), chm["y"].numpy())
    _close(w, ref_w)
    # A marginal over x alone: the estimate divides out y's density.
    mx = tgx.marginal(selection=TS["x"])(t_model)
    wx, chm_x = mx.random_weighted(_rng(2), 1.5, n=64)
    assert "y" not in chm_x
    _close(wx, jax.vmap(lambda x: jgx.normal.logpdf(x, 0.0, 1.5))(chm_x["x"].numpy()))


@jgx.gen
def j_joint():
    x = jgx.normal(0.0, 1.0) @ "x"
    _ = jgx.normal(x, 1.0) @ "y"


@tgx.gen
def t_joint():
    x = tgx.normal(0.0, 1.0) @ "x"
    _ = tgx.normal(x, 1.0) @ "y"


def _combined_within_se(a, b, n_se=5.0):
    """Two independent samples' means agree within `n_se` combined SE."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    se = math.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    assert abs(a.mean() - b.mean()) < n_se * se, (a.mean(), b.mean(), se)


def test_marginal_with_an_algorithm_draws_independent_rows_like_jax_vmap():
    """`Marginal(algorithm=ImportanceK(...)).random_weighted(n=)` against
    JAX's `vmap` of it over n keys: each row runs its own conditional SMC
    on its own kept choice, so the estimates' mean and spread, and the
    kept y's, agree within 5 combined SE."""
    n, k = 1000, 8
    jm = jgx.marginal(selection=JS["y"], algorithm=jsmc.ImportanceK(jgx.Target(j_joint, (), JC.kw(y=0.0)), k_particles=k))(
        j_joint
    )
    tm = tgx.marginal(selection=TS["y"], algorithm=ImportanceK(tgx.Target(t_joint, (), TC.kw(y=0.0)), k_particles=k))(
        t_joint
    )
    jw, jchm = jax.jit(jax.vmap(lambda key: jm.random_weighted(key)))(jax.random.split(jax.random.key(21), n))
    tw, tchm = tm.random_weighted(_rng(21), n=n)
    assert tw.shape == (n,) and tchm["y"].shape == (n,) and "x" not in tchm and tchm.batched_leaves() == [1]
    _combined_within_se(tw.numpy(), np.asarray(jw))
    _combined_within_se((tw.numpy() - tw.numpy().mean()) ** 2, (np.asarray(jw) - np.asarray(jw).mean()) ** 2)
    _combined_within_se(tchm["y"].numpy(), np.asarray(jchm["y"]))


@pytest.mark.parametrize("particles", [None, 16])
def test_propose_is_simulate_like_jax(particles):
    chm, score, retval = t_two.propose(_rng(3), (1.3,), particles)
    assert torch.equal(chm["x"], retval)
    lead = () if particles is None else (particles,)
    assert score.shape == lead

    def ref(x, y1, y2):
        return j_two.assess(JC.kw(x=x, y1=y1, y2=y2), (1.3,))[0]

    args = tuple(chm[a].numpy() for a in ("x", "y1", "y2"))
    _close(score, ref(*args) if particles is None else jax.vmap(ref)(*args))
    c2, s2, r2 = tgx.normal.propose(_rng(4), (0.0, 1.0))
    assert c2.get_value() == r2 and torch.isclose(s2, torch.tensor(float(jgx.normal.logpdf(float(r2), 0.0, 1.0))))


# -- the resamplers: the deterministic maps against JAX's, bit for bit ----------------


def _jax_uniforms(key, n):
    """JAX's own draws inside its resamplers: the sorted spacings and the
    permutation (multinomial, residual), the per-stratum uniforms."""
    k_space, k_perm = jax.random.split(key)
    cums = jnp.cumsum(jax.random.exponential(k_space, (n + 1,), dtype=jnp.float32))
    us = np.array(cums[:n] / cums[n])
    perm = np.array(jax.random.permutation(k_perm, n))
    u = np.array(jax.random.uniform(key, (n,), dtype=jnp.float32))
    return us, perm, u


def _ties_only(got, ref, cdf, queries, what):
    """Every mismatch is a float32 tie: the query lies within rounding of
    the cumulative weights between the two ancestors; ties are rare."""
    bad = np.nonzero(got != ref)[0]
    assert bad.size <= 2 * got.size // 1000, (what, bad.size)
    for i in bad:
        lo, hi = sorted((int(got[i]), int(ref[i])))
        span = cdf[lo:hi]
        assert np.all(np.abs(span - queries[i]) <= 1e-5), (what, i, span, queries[i])


@pytest.mark.parametrize("seed,spread", [(0, 1.0), (1, 3.0), (2, 8.0), (3, 3.0)])
def test_resampler_maps_match_jax_on_jax_uniforms(seed, spread):
    lw = (spread * np.random.default_rng(seed).standard_normal(K)).astype(np.float32)
    key = jax.random.key(seed)
    us, perm, u = _jax_uniforms(key, K)
    w64 = np.exp(lw.astype(np.float64) - lw.max())
    cdf = np.cumsum(w64 / w64.sum())
    t_lw = torch.from_numpy(lw)

    sorted_ref = np.asarray(jsmc._sorted_queries_ancestors(jnp.cumsum(jax.nn.softmax(jnp.asarray(lw))), jnp.asarray(us)))
    sorted_got = tsmc.sorted_queries_ancestors(tsmc.normalized_cdf(t_lw), torch.from_numpy(us)).numpy()
    _ties_only(sorted_got, sorted_ref, cdf, us, "sorted queries")

    ref = np.asarray(jsmc.multinomial_resample(key, jnp.asarray(lw), K))
    got = tsmc.multinomial_ancestors(torch.from_numpy(us), torch.from_numpy(perm).long(), t_lw).numpy()
    _ties_only(got, ref, cdf, us[perm], "multinomial")

    ref = np.asarray(jsmc.stratified_resample(key, jnp.asarray(lw), K))
    got = tsmc.stratified_ancestors(torch.from_numpy(u), t_lw).numpy()
    _ties_only(got, ref, cdf, (u.astype(np.float64) + np.arange(K)) / K, "stratified")

    # Residual: the same ties, and floor ties of n * w (which move one
    # block boundary); rare all the same.
    ref = np.asarray(jsmc.residual_resample(key, jnp.asarray(lw), K))
    got = tsmc.residual_ancestors(torch.from_numpy(us), torch.from_numpy(perm).long(), t_lw).numpy()
    assert (got != ref).sum() <= 2 * K // 1000
    assert set(tsmc.RESAMPLERS) == set(jsmc.RESAMPLERS)


def test_resampler_counts_unbiased_with_the_variance_order():
    """`tests/inference/test_resampler_properties.py`'s check: E[count_i]
    = N w_i for every resampler (each count mean within 5 SE), and total
    count variance systematic <= stratified <= multinomial, residual <=
    multinomial, multinomial's at its closed form sum N w (1 - w)."""
    n, trials = 256, 400
    lw = torch.from_numpy(np.random.default_rng(42).standard_normal(n).astype(np.float32))
    w = torch.softmax(lw.double(), 0).numpy()
    rng = _rng(5)
    stats = {}
    for name, fn in tsmc.RESAMPLERS.items():
        counts = np.stack([np.bincount(fn(rng, lw, n).numpy(), minlength=n) for _ in range(trials)]).astype(np.float64)
        se = np.maximum(counts.std(0, ddof=1), 1.0 / math.sqrt(trials)) / math.sqrt(trials)
        assert np.all(np.abs(counts.mean(0) - n * w) < 5 * se), name
        stats[name] = counts.var(0).sum()
    assert stats["systematic"] <= stats["stratified"] * 1.2
    assert stats["stratified"] <= stats["multinomial"] * 1.2
    assert stats["residual"] <= stats["multinomial"] * 1.2
    expected = (n * w * (1 - w)).sum()
    assert abs(stats["multinomial"] - expected) < 0.25 * expected


# -- ParticleCollection ----------------------------------------------------------------


def _jax_collection(k=64, seed=0):
    target = jgx.Target(j_model, (1.0,), JC.kw(y=1.0))
    return jsmc.ImportanceK(target, k_particles=k).run_smc(jax.random.key(seed))


def _carried(jcol):
    return convert.particle_collection(
        t_model, (1.0,), {"x": np.asarray(jcol.get_particles().get_choices()["x"])},
        np.asarray(jcol.get_log_weights()), "cpu", {"y": np.float32(1.0)}, np.asarray(jcol.is_valid),
    )


def test_collection_carried_from_jax_reads_like_jax():
    jcol = _jax_collection()
    col = _carried(jcol)
    assert bool(col.is_valid) and col.get_particles().batched_leaves().count(1) >= 2
    _close(col.get_log_marginal_likelihood_estimate(), jcol.get_log_marginal_likelihood_estimate())
    _close(col.get_ess(), jcol.get_ess(), tol=1e-4)
    _close(col.get_particles().get_score(), jcol.get_particles().get_score())
    for idx in (0, 17, torch.tensor(63)):
        tr, lw = col[idx]
        jtr, jlw = jcol[int(idx)]
        _close(lw, jlw)
        _close(tr.get_score(), jtr.get_score())
        _close(tr.get_choices()["x"], jtr.get_choices()["x"])
        assert tr.batched_leaves() == [0] * len(tr.batched_leaves())  # the trace of one particle


@pytest.mark.parametrize("method", sorted(tsmc.RESAMPLERS))
def test_collection_resample_keeps_the_lml_and_rows(method):
    col = _carried(_jax_collection(256, 1))
    new = col.resample(_rng(6), method)
    _close(new.get_log_marginal_likelihood_estimate(), col.get_log_marginal_likelihood_estimate())
    _close(new.get_ess(), 256.0, tol=1e-4)
    old_x = col.get_particles().get_choices()["x"]
    new_x = new.get_particles().get_choices()["x"]
    assert torch.isin(new_x, old_x).all() and new.get_particles().get_choices()["y"] == 1.0
    _close(new.get_particles().get_score(), jax.vmap(lambda x: j_model.assess(JC.kw(x=x, y=1.0), (1.0,))[0])(new_x.numpy()))


# -- Importance, ImportanceK(q=), CSMC, ChangeTarget --------------------------------------


def test_change_target_reweight_matches_jax():
    """The reweight of fixed particles to another target: one batched
    `importance` of the new target; deterministic given the particles."""
    jcol = _jax_collection(128, 2)
    j1, j2 = jgx.Target(j_model, (1.0,), JC.kw(y=1.0)), jgx.Target(j_model, (2.0,), JC.kw(y=1.0))
    ref = jsmc.ChangeTarget(jsmc.ImportanceK(j1, k_particles=128), j2)._reweight_collection(KEY, jcol)
    t1, t2 = _targets()
    new_particles, new_weights = ChangeTarget(ImportanceK(t1, k_particles=128), t2)._reweighted(_rng(), _carried(jcol))
    _close(new_weights, ref.get_log_weights())
    _close(new_particles.get_score(), ref.get_particles().get_score())
    assert new_particles.get_args() == (2.0,)


def test_importance_with_and_without_a_proposal():
    """`tests/inference/test_change_target.py`: both one-particle
    estimators unbiased for p(y) (5 SE), the posterior-matched proposal
    with a weight variance under 0.3 of the prior's; the CSMC weight of a
    retained value is its joint density over the proposal's, as JAX's."""

    @tgx.marginal()
    @tgx.gen
    def q(target):
        _ = tgx.normal(0.5, 1.0 / math.sqrt(2.0)) @ "x"

    @jgx.marginal()
    @jgx.gen
    def jq(target):
        _ = jgx.normal(0.5, 1.0 / jnp.sqrt(2.0)) @ "x"

    t1, _ = _targets()
    rng = _rng(7)
    exact = _normal_lml(1.0, 1.0)
    ws_prior = [float(Importance(t1).run_smc(rng).get_log_weights()[0]) for _ in range(1000)]
    ws_q = [float(Importance(t1, q).run_smc(rng).get_log_weights()[0]) for _ in range(200)]
    _lml_within_se(ws_prior, exact)
    _close(ws_q, np.full(200, exact), tol=1e-5)  # q is the exact posterior: every weight is p(y)
    assert np.var(ws_q) < 0.3 * np.var(ws_prior)
    j1 = jgx.Target(j_model, (1.0,), JC.kw(y=1.0))
    for alg, jalg in ((Importance(t1), jsmc.Importance(j1)), (Importance(t1, q), jsmc.Importance(j1, jq))):
        got = alg.run_csmc(rng, TC.kw(x=torch.tensor(0.3))).get_log_weights()
        ref = jalg.run_csmc(KEY, JC.kw(x=jnp.float32(0.3))).get_log_weights()
        _close(got, ref)


def test_importance_k_with_a_proposal_and_another_target():
    """`ImportanceK(q=)` and `ImportanceK` reweighted to another target
    (`ChangeTarget` under `log_marginal_likelihood_estimate` and
    `random_weighted`) against the closed forms, at 5 SE."""

    @tgx.marginal()
    @tgx.gen
    def q(target):
        _ = tgx.normal(0.0, 1.5) @ "x"

    t1, t2 = _targets()
    rng = _rng(8)
    lml_q = [float(ImportanceK(t1, q, k_particles=256).log_marginal_likelihood_estimate(rng)) for _ in range(30)]
    _lml_within_se(lml_q, _normal_lml(1.0, 1.0))
    lml_2 = [float(ImportanceK(t1, k_particles=512).log_marginal_likelihood_estimate(rng, t2)) for _ in range(30)]
    _lml_within_se(lml_2, _normal_lml(1.0, 2.0))
    _, latents = ImportanceK(t1, k_particles=256).random_weighted(rng, t2, n=300)
    assert latents.batched_leaves() == [1] and "y" not in latents
    xs = latents["x"].double().numpy()
    _within_se(xs, 0.8)  # the posterior mean of x under t2: y s^2 / (s^2 + 1)


@pytest.mark.parametrize("with_q", [False, True])
def test_csmc_keeps_the_retained_particle_last(with_q):
    """`run_csmc` holds the retained choices at index K-1 with their joint
    weight (JAX's `_stack_retained`); `estimate_logpdf` is the retained
    particle's score less the LML, an unbiased estimate of the posterior
    density (mean of exp within 5 SE of N(v; 0.5, 1/sqrt 2))."""

    @tgx.marginal()
    @tgx.gen
    def q(target):
        _ = tgx.normal(0.3, 1.2) @ "x"

    t1, _ = _targets()
    alg = ImportanceK(t1, q if with_q else None, k_particles=64)
    v = 0.2
    col = alg.run_csmc(_rng(9), TC.kw(x=torch.tensor(v)))
    assert float(col.get_particles().get_choices()["x"][-1]) == pytest.approx(v)
    joint = float(j_model.assess(JC.kw(x=jnp.float32(v), y=jnp.float32(1.0)), (1.0,))[0])
    q_term = float(jgx.normal.logpdf(v, 0.3, 1.2)) if with_q else 0.0
    _close(col.get_log_weights()[-1], joint - q_term)
    rng = _rng(10)
    est = [float(alg.estimate_logpdf(rng, TC.kw(x=torch.tensor(v)), t1)) for _ in range(200)]
    post = -0.5 * (v - 0.5) ** 2 / 0.5 - 0.5 * math.log(2 * math.pi * 0.5)
    _lml_within_se(est, post)
    rec = [float(alg.estimate_reciprocal_normalizing_constant(rng, t1, TC.kw(x=torch.tensor(v)), torch.tensor(0.0)))
           for _ in range(50)]
    assert np.isfinite(rec).all()


def test_change_target_lml_is_the_new_targets():
    t1, t2 = _targets()
    rng = _rng(11)
    alg = ChangeTarget(ImportanceK(t1, k_particles=1024), t2)
    lmls = [float(alg.run_smc(rng).get_log_marginal_likelihood_estimate()) for _ in range(30)]
    _lml_within_se(lmls, _normal_lml(1.0, 2.0))
    _lml_within_se([float(alg.estimate_normalizing_constant(rng, t2)) for _ in range(30)], _normal_lml(1.0, 2.0))


# -- SMCDriver ---------------------------------------------------------------------------


def test_driver_extend_weights_match_jax():
    """`extend` with a new observation: `project` of the constrained
    addresses plus `update`, the weight `log p(obs | rest)`; deterministic
    for given particles (a JAX collection carried across)."""
    jtarget = jgx.Target(j_two, (1.3,), JC.kw(y1=0.4))
    jcol = jsmc.SMCDriver(n_particles=256).init(KEY, jtarget)
    jnew = jsmc.SMCDriver(n_particles=256).extend(KEY, jcol, JC.kw(y2=jnp.float32(-0.2)))
    chm = jcol.get_particles().get_choices()
    col = convert.particle_collection(
        t_two, (1.3,), {"x": np.asarray(chm["x"]), "y2": np.asarray(chm["y2"])}, np.asarray(jcol.get_log_weights()),
        "cpu", {"y1": np.float32(0.4)},
    )
    new = SMCDriver(n_particles=256).extend(_rng(), col, TC.kw(y2=torch.tensor(-0.2)))
    _close(new.get_log_weights(), jnew.get_log_weights())
    _close(new.get_particles().get_score(), jnew.get_particles().get_score())
    assert bool(torch.all(new.get_particles().get_choices()["y2"] == -0.2))


def test_driver_extend_a_scan_model_matches_jax():
    """The same on the HMM as a `scan` program: `extend` with `C[t, "x"]`
    re-scans the unfold through `Scan`'s `Update`."""
    from genjax_tpu.inference.exact_testbed import build_hmm_chain_model as j_chain
    from genjax_tpu_torch.inference.exact_testbed import build_hmm_chain_model as t_chain

    T, n = 6, 64
    j_cfg = JHMMConfig(8, 1, 1, 0.5, 0.5)
    t_cfg = tgx.DiscreteHMMConfiguration(8, 1, 1, 0.5, 0.5)
    jm, tm = j_chain(j_cfg, T), t_chain(t_cfg, T, "cpu")
    jtarget = jgx.Target(jm, (4, None), JC.d({(0, "x"): jnp.int32(3)}))
    jcol = jsmc.SMCDriver(n_particles=n).init(KEY, jtarget)
    jnew = jsmc.SMCDriver(n_particles=n).extend(KEY, jcol, JC.d({(1, "x"): jnp.int32(5)}))
    chm = jcol.get_particles().get_choices()
    col = convert.particle_collection(
        tm, (4, None), {"z": np.asarray(chm["z"]), "x": np.asarray(chm["x"])}, np.asarray(jcol.get_log_weights()), "cpu",
    )
    new = SMCDriver(n_particles=n).extend(_rng(), col, TC.d({(1, "x"): torch.tensor(5)}))
    _close(new.get_log_weights(), jnew.get_log_weights())
    assert bool(torch.all(new.get_particles().get_choices()[1, "x"] == 5))


def test_driver_init_extend_resample_rejuvenate_against_the_closed_form():
    """`tests/inference/test_smc.py`: init, extend to y, the LML of log
    N(1; 0, sqrt 2) within 5 SE; `maybe_resample` over its threshold
    resamples (ESS K); below it keeps the collection; `rejuvenate` keeps
    the weights and the posterior (mean within 5 SE of 0.5)."""

    @tgx.gen
    def two_step():
        x = tgx.normal(0.0, 1.0) @ "x"
        return tgx.normal(x, 1.0) @ "y"

    driver = SMCDriver(n_particles=2048)
    rng = _rng(12)
    lmls, means = [], []
    for _ in range(20):
        col = driver.init(rng, tgx.Target(two_step, (), TC.empty()))
        col = driver.extend(rng, col, TC.kw(y=1.0))
        lmls.append(float(col.get_log_marginal_likelihood_estimate()))
        col = SMCDriver(n_particles=2048, ess_threshold=1.1).maybe_resample(rng, col)
        assert float(col.get_ess()) == pytest.approx(2048.0, rel=1e-4)
        moved = driver.rejuvenate(rng, col, tgx.Regenerate(TS["x"]))
        assert torch.equal(moved.get_log_weights(), col.get_log_weights())
        means.append(float(moved.get_particles().get_choices()["x"].mean()))
    _lml_within_se(lmls, _normal_lml(1.0, 1.0))
    _within_se(means, 0.5)
    kept = SMCDriver(n_particles=2048, ess_threshold=0.0).maybe_resample(rng, col)
    assert kept is col


# -- the filter's hooks ------------------------------------------------------------------


def _hmm_filters(n, resampling="systematic", **kw):
    """`tests/inference/test_pf_vs_exact.py`'s filter in both packages."""
    jcfg, tcfg = JHMMConfig(10, 2, 2, 0.5, 0.5), tgx.DiscreteHMMConfiguration(10, 2, 2, 0.5, 0.5)
    prior, trans, obs = tcfg.prior_logits("cpu"), tcfg.transition_log_probs("cpu"), tcfg.observation_log_probs("cpu")

    @tgx.gen
    def init_model():
        z = tgx.categorical(logits=prior) @ "z"
        _ = tgx.categorical(logits=obs[z]) @ "y"
        return z

    @tgx.gen
    def step_model(z_prev, _t):
        z = tgx.categorical(logits=trans[z_prev]) @ "z"
        _ = tgx.categorical(logits=obs[z]) @ "y"
        return z

    return jcfg, tgx.BootstrapFilter(step_model, init_model, n, obs_addr="y", resampling=resampling, **kw)


@pytest.mark.parametrize("resampling", sorted(tsmc.RESAMPLERS))
def test_filter_lml_with_each_resampler_against_the_forward_algorithm(resampling):
    observations = np.array([0, 3, 7, 2, 9, 9, 1, 4])
    jcfg, pf = _hmm_filters(2048, resampling)
    exact = float(JDiscreteHMM.data_logpdf(jcfg, jnp.asarray(observations)))
    rng = _rng(13)
    lmls = [float(pf.run(rng, torch.from_numpy(observations))[0]) for _ in range(16)]
    _lml_within_se(lmls, exact)


def test_filter_collect_and_model_args():
    """`collect(z, lw)` runs after each step's resampling, stacked along a
    leading T axis with step 0 first; `model_args` are appended to both
    models' arguments: the same draws as the models closed over them."""

    def models(closed):
        @tgx.gen
        def init(*theta):
            a = theta[0] if theta else closed
            z = tgx.normal(0.0, 1.0) @ "z"
            _ = tgx.normal(a * z, 0.4) @ "y"
            return z

        @tgx.gen
        def step(z_prev, t, *theta):
            a = theta[0] if theta else closed
            z = tgx.normal(a * z_prev, 0.5) @ "z"
            _ = tgx.normal(z, 0.4) @ "y"
            return z

        return step, init

    ys = torch.from_numpy(np.random.default_rng(14).standard_normal(12).astype(np.float32))
    a = torch.tensor(0.8)
    with_args = tgx.BootstrapFilter(*models(None), 512, ess_threshold=0.7)
    closed = tgx.BootstrapFilter(*models(0.8), 512, ess_threshold=0.7)
    lml, z, (zs, lws, means) = with_args.run(
        _rng(15), ys, (a,), collect=lambda z, lw: (z, lw, torch.softmax(lw, 0) @ z)
    )
    lml_c, z_c = closed.run(_rng(15), ys)
    _close(lml, lml_c)
    assert torch.equal(z, z_c)
    assert zs.shape == (12, 512) and lws.shape == (12, 512) and means.shape == (12,)
    # Step 0: the init weights, before any resampling; resampled steps
    # hold equal weights.
    init_tr, init_w = models(None)[1].importance(_rng(15), TC.kw(y=ys[0]), (a,), 512)
    _close(lws[0], init_w)
    _close(zs[0], init_tr.get_retval())
    assert bool((lws[1:] == 0.0).all(1).any())
    # Never resampling, the weights carry over every step and the LML is
    # the last ones' log mean.
    never = tgx.BootstrapFilter(*models(None), 512, ess_threshold=0.0)
    lml_n, _, lws_n = never.run(_rng(15), ys, (a,), collect=lambda z, lw: lw)
    assert not bool((lws_n[1:] == 0.0).all(1).any())
    _close(lml_n, torch.logsumexp(lws_n[-1], 0) - math.log(512))
    from genjax_tpu_torch.models.ssm import run_bootstrap_filter, simulate_ssm_data

    _, obs = simulate_ssm_data(_rng(16), 10)
    for method in tsmc.RESAMPLERS:
        lml_m, z_m = run_bootstrap_filter(_rng(17), obs, n_particles=256, resampling=method)
        assert math.isfinite(float(lml_m)) and z_m.shape == (256,)


# -- Rejuvenate and GaussianDrift --------------------------------------------------------


def _jax_chains(n=128):
    x = np.random.default_rng(18).standard_normal(n).astype(np.float32)
    return x, convert.trace(t_two, (1.3,), {"x": x}, n=n, device="cpu", observations={"y1": 0.4, "y2": -0.2})


def _jax_joint(x):
    return jax.vmap(lambda v: j_two.assess(JC.kw(x=v, y1=0.4, y2=-0.2), (1.3,))[0])(x)


def test_rejuvenate_weight_for_its_proposals_matches_jax():
    """The weight for the proposals the port drew: the `Update` weight
    plus the backward proposal's density (arguments from the NEW
    choices, the corrected L kernel) less the forward one, as JAX's
    `Rejuvenate` computes it, here from JAX's own pieces."""

    @tgx.gen
    def t_prop(x):
        _ = tgx.normal(0.5 * x + 0.1, 0.6) @ "x"

    @jgx.gen
    def j_prop(x):
        _ = jgx.normal(0.5 * x + 0.1, 0.6) @ "x"

    x, tr = _jax_chains()
    new, w, _, bwd = tr.edit(_rng(19), Rejuvenate(t_prop, lambda chm: (chm["x"],)))
    x_new = new.get_choices()["x"].numpy()
    fwd = jax.vmap(lambda a, b: j_prop.assess(JC.kw(x=b), (a,))[0])(x, x_new)
    back = jax.vmap(lambda a, b: j_prop.assess(JC.kw(x=b), (a,))[0])(x_new, x)
    _close(w, _jax_joint(x_new) - _jax_joint(x) + back - fwd)
    assert isinstance(bwd, Rejuvenate)
    # JAX's request on one chain: the same identity between its weight and
    # its own draw.
    jtr = j_two.importance(KEY, JC.kw(x=x[0], y1=0.4, y2=-0.2), (1.3,))[0]
    jnew, jw, _, _ = JRejuvenate(j_prop, lambda chm: (chm["x"],)).edit(KEY, jtr, jgx.Diff.no_change((1.3,)))
    xj = jnew.get_choices()["x"]
    ref = (jnew.get_score() - jtr.get_score() + j_prop.assess(JC.kw(x=x[0]), (xj,))[0]
           - j_prop.assess(JC.kw(x=xj), (x[0],))[0])
    _close(jw, ref)


def test_gaussian_drift_weight_for_its_proposals_matches_jax():
    x, tr = _jax_chains()
    for scale in (0.3, TC.kw(x=0.2)):
        new, w, _, bwd = tr.edit(_rng(20), GaussianDrift(TS["x"], scale))
        x_new = new.get_choices()["x"].numpy()
        assert not np.allclose(x_new, x) and new.get_choices()["y1"] == 0.4
        _close(w, _jax_joint(x_new) - _jax_joint(x))
        assert isinstance(bwd, GaussianDrift)
    # The step's scale: the spread of the moves, within 5 SE of 0.3.
    new, _, _, _ = tr.edit(_rng(21), GaussianDrift(TS["x"], 0.3))
    moves = (new.get_choices()["x"] - torch.from_numpy(x)).double().numpy()
    assert abs(moves.std() - 0.3) < 5 * 0.3 / math.sqrt(2 * len(moves))
    jtr = j_two.importance(KEY, JC.kw(x=x[0], y1=0.4, y2=-0.2), (1.3,))[0]
    jnew, jw, _, _ = JGaussianDrift(JS["x"], 0.3).edit(KEY, jtr, jgx.Diff.no_change((1.3,)))
    _close(jw, j_two.assess(JC.kw(x=jnew.get_choices()["x"], y1=0.4, y2=-0.2), (1.3,))[0] - jtr.get_score())


def test_mh_with_rejuvenate_and_drift_targets_the_posterior():
    """MH over 4096 chains with either request: the posterior of x given
    y1 and y2 (a conjugate normal), mean within 5 SE after 30 steps."""
    prec = 1 / 1.3**2 + 1.0 + 0.25 / 0.49
    mean = (0.4 + 0.5 * -0.2 / 0.49) / prec

    @tgx.gen
    def t_prop(x):
        _ = tgx.normal(0.8 * x, 0.8) @ "x"

    n = 4096
    for request in (Rejuvenate(t_prop, lambda chm: (chm["x"],)), GaussianDrift(TS["x"], 0.7)):
        tr = convert.trace(t_two, (1.3,), {"x": np.zeros(n, np.float32)}, n=n, device="cpu",
                           observations={"y1": 0.4, "y2": -0.2})
        tr, _ = tgx.mh_chain(_rng(22), tr, request, 30)
        _within_se(tr.get_choices()["x"].double().numpy(), mean)


def test_jax_exports_have_their_counterparts():
    import genjax_tpu.inference as jinf
    import genjax_tpu.inference.requests as jreq

    for name in ("Importance", "ImportanceK", "ChangeTarget", "SMCDriver", "ParticleCollection", "RESAMPLERS",
                 "multinomial_resample", "stratified_resample", "residual_resample", "systematic_resample", "ess"):
        assert hasattr(jsmc, name) and hasattr(tsmc, name), name
    for name in ("Target", "Algorithm", "Marginal", "SampleDistribution", "marginal"):
        assert hasattr(jinf, name) and hasattr(tgx.inference, name) and hasattr(tgx, name), name
    for name in ("Rejuvenate", "GaussianDrift"):
        assert hasattr(jreq, name) and hasattr(tgx.requests, name), name
    for mod in ("pmmh", "particle_gibbs", "smoothing", "tempered", "smc", "requests"):
        assert mod in jinf.__all__ and mod in tgx.inference.__all__, mod
