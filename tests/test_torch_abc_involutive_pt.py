"""The port's ABC (`genjax_tpu_torch.inference.abc`), involutive MCMC
(`involutive`) and parallel tempering (`parallel_tempering`) against
`genjax_tpu` and the conjugate closed forms, on the CPU; and the export
check of the six modules this slice ports.

Deterministic pieces get the same numpy-made inputs as JAX and are held
at float32 tolerance, 1e-5 per unit of magnitude (`_close`):
`involutive_step`'s log acceptance for JAX's own auxiliary draws (and the
scaling move's hand derivation), the re-tempered MH ratio of
`tempered_mh`, the even-odd exchange fed JAX's logliks and uniforms (the
permutation and swap rates exactly), ABC's tolerance (`jnp.quantile`) and
move scales (`jnp.std`, ddof 0). Random quantities are held against the
JAX tests' closed forms at their bounds, or at 5 standard errors of
independent chains' last states.
"""

import math

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.inference import smc as jsmc
from genjax_tpu.inference.involutive import involutive_step as j_involutive_step
from genjax_tpu.inference.parallel_tempering import ParallelTempering as JPT
from genjax_tpu.inference.requests import GaussianDrift as JDrift
from genjax_tpu_torch.core.typing import per_particle
from genjax_tpu_torch.inference.abc import ABCSMC, abc_rejection
from genjax_tpu_torch.inference.involutive import involutive_mh, involutive_step
from genjax_tpu_torch.inference.mcmc import mh
from genjax_tpu_torch.inference.parallel_tempering import ParallelTempering, deo_exchange, tempered_mh
from genjax_tpu_torch.inference.requests import GaussianDrift
from genjax_tpu_torch.inference.tempered import retempered_log_alpha

torch.set_num_threads(1)

JC, TC = jgx.ChoiceMap, tgx.ChoiceMap


def _close(got, ref, tol=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), np.max(np.abs(got - ref))


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


# -- the export check --------------------------------------------------------------------------

SIX = ("svgd", "smc2", "rbpf", "abc", "involutive", "parallel_tempering")


@pytest.mark.parametrize("module", SIX)
def test_the_six_modules_export_jax_names(module):
    import genjax_tpu.inference as jinf
    import genjax_tpu_torch.inference as tinf

    assert module in jinf.__all__ and module in tinf.__all__
    jmod, tmod = getattr(jinf, module), getattr(tinf, module)
    missing = [name for name in jmod.__all__ if not hasattr(tmod, name)]
    assert not missing, missing


# -- involutive MCMC ---------------------------------------------------------------------------


@jgx.gen
def j_lognormal():
    x = jgx.log_normal(0.0, 1.0) @ "x"
    _ = jgx.normal(jnp.log(x), 1.0) @ "y"


@tgx.gen
def t_lognormal():
    x = tgx.log_normal(0.0, 1.0) @ "x"
    _ = tgx.normal(torch.log(x), 1.0) @ "y"


@jgx.gen
def j_aux_scale():
    _ = jgx.normal(0.0, 0.6) @ "u"


@tgx.gen
def t_aux_scale():
    _ = tgx.normal(0.0, 0.6) @ "u"


def j_scale_move(x_chm, u_chm):
    return jtu.tree_map(lambda x: x * jnp.exp(u_chm["u"]), x_chm), jtu.tree_map(lambda u: -u, u_chm)


def t_scale_move(x_chm, u_chm):
    return pytree.tree_map(lambda x: x * torch.exp(u_chm["u"]), x_chm), pytree.tree_map(lambda u: -u, u_chm)


@tgx.gen
def t_normal_model():
    x = tgx.normal(0.0, 1.0) @ "x"
    _ = tgx.normal(x, 1.0) @ "y"


@tgx.gen
def t_aux_walk():
    _ = tgx.normal(0.0, 0.8) @ "u"


def t_reflect(x_chm, u_chm):
    return pytree.tree_map(lambda x: x + u_chm["u"], x_chm), pytree.tree_map(lambda u: -u, u_chm)


def test_log_alpha_matches_jax_for_its_own_aux_draws():
    xs = np.exp(np.random.default_rng(0).standard_normal(8)).astype(np.float32)
    keys = jax.random.split(jax.random.key(1), 8)

    def one(k, x):
        tr, _ = j_lognormal.importance(jax.random.key(0), JC.kw(x=x, y=2.0), ())
        new_tr, la = j_involutive_step(k, tr, jgx.Selection.at["x"], j_aux_scale, j_scale_move)
        u = j_aux_scale.simulate(jax.random.split(k)[0], ()).get_choices()["u"]  # JAX's draw inside the step
        return new_tr.get_choices()["x"], la, u

    x_new, la, u = jax.vmap(one)(keys, jnp.asarray(xs))
    tr, _ = t_lognormal.importance(_rng(0), TC.kw(x=per_particle(torch.from_numpy(xs)), y=2.0), (), n=8)
    new_tr, got = involutive_step(_rng(1), tr, tgx.Selection.at["x"], t_aux_scale, t_scale_move,
                                  aux_choices=TC.kw(u=per_particle(torch.from_numpy(np.array(u)))))
    _close(got, la)
    _close(new_tr.get_choices()["x"], x_new)


def test_log_alpha_matches_the_hand_derivation_of_the_scaling_move():
    # log alpha = [score(x') - score(x)] + u: the +u is the Jacobian term.
    tr, _ = t_lognormal.importance(_rng(0), TC.kw(y=2.0), (), n=256)
    new_tr, log_alpha = involutive_step(_rng(3), tr, tgx.Selection.at["x"], t_aux_scale, t_scale_move)
    u = torch.log(new_tr.get_choices()["x"] / tr.get_choices()["x"])
    s_old, _ = t_lognormal.assess(tr.get_choices(), (), 256)
    s_new, _ = t_lognormal.assess(new_tr.get_choices(), (), 256)
    assert torch.allclose(log_alpha, s_new - s_old + u, atol=1e-4)


def test_one_chain_without_a_chain_axis():
    tr, _ = t_lognormal.importance(_rng(0), TC.kw(y=2.0), ())
    new_tr, log_alpha = involutive_step(_rng(3), tr, tgx.Selection.at["x"], t_aux_scale, t_scale_move)
    assert log_alpha.shape == () and new_tr.get_choices()["x"].shape == ()
    s_old, _ = t_lognormal.assess(tr.get_choices(), ())
    s_new, _ = t_lognormal.assess(new_tr.get_choices(), ())
    u = torch.log(new_tr.get_choices()["x"] / tr.get_choices()["x"])
    assert torch.allclose(log_alpha, s_new - s_old + u, atol=1e-4)


def test_identity_involution_always_accepts_unchanged():
    tr, _ = t_normal_model.importance(_rng(0), TC.kw(y=2.0), (), n=16)
    new_tr, log_alpha = involutive_step(_rng(2), tr, tgx.Selection.at["x"], t_aux_walk, lambda x, u: (x, u))
    assert torch.allclose(log_alpha, torch.zeros(16), atol=1e-5)
    assert torch.equal(new_tr.get_choices()["x"], tr.get_choices()["x"])


def _last_states(model, move, n_chains, n_steps, seed, collect):
    tr, _ = model.importance(_rng(seed), TC.kw(y=2.0), (), n=n_chains)
    rng, accs = _rng(seed + 1), []
    for _ in range(n_steps):
        tr, acc = move(rng, tr)
        accs.append(acc.float().mean())
    return collect(tr).double(), float(torch.stack(accs).mean())


def test_random_walk_converges_to_the_conjugate_posterior():
    # Posterior N(1, 1/2); 4096 independent chains' last states, 5 SE.
    s, acc = _last_states(
        t_normal_model, lambda r, t: involutive_mh(r, t, tgx.Selection.at["x"], t_aux_walk, t_reflect),
        4096, 60, 0, lambda t: t.get_choices()["x"],
    )
    assert abs(float(s.mean()) - 1.0) < 5 * math.sqrt(0.5 / 4096)
    assert abs(float(s.var()) - 0.5) < 5 * 0.5 * math.sqrt(2 / 4095)
    assert 0.3 < acc < 0.95


def test_scaling_move_converges_with_the_jacobian_correction():
    # log x | y=2 ~ N(1, 1/2); a missing e^u factor shifts the mean by ~0.3.
    s, _ = _last_states(
        t_lognormal, lambda r, t: involutive_mh(r, t, tgx.Selection.at["x"], t_aux_scale, t_scale_move),
        4096, 80, 2, lambda t: torch.log(t.get_choices()["x"]),
    )
    assert abs(float(s.mean()) - 1.0) < 5 * math.sqrt(0.5 / 4096)
    assert abs(float(s.var()) - 0.5) < 5 * 0.5 * math.sqrt(2 / 4095)


def test_discrete_selection_raises():
    @tgx.gen
    def m():
        z = tgx.categorical(torch.log(torch.tensor([0.5, 0.5]))) @ "z"
        _ = tgx.normal(torch.where(z == 0, -1.0, 1.0), 1.0) @ "y"

    tr, _ = m.importance(_rng(0), TC.kw(y=0.5), (), n=4)
    with pytest.raises(TypeError, match="non-differentiable"):
        involutive_step(_rng(1), tr, tgx.Selection.at["z"], t_aux_walk, lambda x, u: (x, u))


def test_one_batched_step_moves_every_chain():
    tr, _ = t_normal_model.importance(_rng(0), TC.kw(y=2.0), (), n=8)
    new_tr, accs = involutive_mh(_rng(1), tr, tgx.Selection.at["x"], t_aux_walk, t_reflect)
    assert accs.shape == (8,) and new_tr.get_choices()["x"].shape == (8,)


# -- parallel tempering ----------------------------------------------------------------------


@jgx.gen
def j_conj():
    mu = jgx.normal(0.0, 1.0) @ "mu"
    _ = jgx.normal(mu, 1.0) @ "y"


@tgx.gen
def t_conj():
    mu = tgx.normal(0.0, 1.0) @ "mu"
    _ = tgx.normal(mu, 1.0) @ "y"


T_TARGET = tgx.Target(t_conj, (), TC.kw(y=1.0))
POST_MEAN, POST_VAR = 0.5, 0.5


@pytest.mark.parametrize("beta", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("regenerate", [False, True])
def test_tempered_ratio_matches_jax(beta, regenerate):
    # A fixed proposal (mu -> mu'), its Update weight and projections in
    # both packages; the JAX side is `tempered_mh`'s formula on JAX values.
    mus, props = np.array([0.3, -1.2, 2.0], np.float32), np.array([0.9, -0.4, 1.1], np.float32)
    obs = jgx.Selection.at["y"]
    refs = []
    for mu, mp in zip(mus, props):
        tr, _ = j_conj.importance(jax.random.key(0), JC.kw(mu=mu, y=1.0), ())
        prop, w, _, _ = jgx.Update(JC.kw(mu=mp)).edit(jax.random.key(1), tr, jgx.Diff.no_change(()))
        ll, new_ll = tr.project(jax.random.key(2), obs), prop.project(jax.random.key(2), obs)
        d = new_ll - ll
        if regenerate:
            sel = jgx.Selection.at["mu"]
            term = prop.project(jax.random.key(2), sel) - tr.project(jax.random.key(2), sel)
            refs.append((w - d) - term + beta * d)
        else:
            refs.append(w - (1.0 - beta) * d)
    tr, _ = t_conj.importance(_rng(0), TC.kw(mu=per_particle(torch.from_numpy(mus)), y=1.0), (), n=3)
    prop, w, _, _ = tgx.Update(TC.kw(mu=per_particle(torch.from_numpy(props)))).edit(_rng(1), tr, tgx.Diff.no_change(()))
    request = tgx.Regenerate(tgx.Selection.at["mu"]) if regenerate else GaussianDrift(tgx.Selection.at["mu"], 0.5)
    ll = tr.project(_rng(2), tgx.Selection.at["y"])
    alpha, _ = retempered_log_alpha(_rng(2), tr, prop, w, request, beta, tgx.Selection.at["y"], ll)
    _close(alpha, np.array(refs))


def test_beta_one_makes_the_plain_mh_decision():
    # At beta = 1 the bridge is the joint: the same draws give mh's choice.
    tr, _ = t_conj.importance(_rng(0), TC.kw(y=1.0), (), n=64)
    req = GaussianDrift(tgx.Selection.at["mu"], 0.9)
    t1, _, acc1 = tempered_mh(_rng(10), tr, req, 1.0, tgx.Selection.at["y"])
    t2, acc2 = mh(_rng(10), tr, req)
    assert torch.equal(acc1, acc2) and torch.equal(t1.get_choices()["mu"], t2.get_choices()["mu"])


def test_beta_zero_targets_the_prior():
    tr, _ = t_conj.importance(_rng(0), TC.kw(y=1.0), (), n=4096)
    req, obs, rng = GaussianDrift(tgx.Selection.at["mu"], 1.2), tgx.Selection.at["y"], _rng(5)
    ll = tr.project(rng, obs)
    for _ in range(40):
        tr, ll, _ = tempered_mh(rng, tr, req, 0.0, obs, ll)
    s = tr.get_choices()["mu"].double()
    assert abs(float(s.mean())) < 5 * math.sqrt(1.0 / 4096)
    assert abs(float(s.var()) - 1.0) < 5 * math.sqrt(2 / 4095)


def test_exchange_matches_jax_for_its_logliks_and_uniforms():
    # JAX with no moves per sweep: the replicas stay put and only the
    # exchange runs; the port's exchange fed JAX's initial logliks and the
    # uniforms JAX draws gives the same permutation and swap rates.
    betas = np.array([1.0, 0.6, 0.3, 0.1, 0.03], np.float32)
    target = jgx.Target(j_conj, (), JC.kw(y=1.0))
    pt = JPT(betas=jnp.asarray(betas), request=JDrift(jgx.Selection.at["mu"], 0.8), n_moves=0)
    key, n_sweeps = jax.random.key(4), 9
    out = pt.run(key, target, n_sweeps)
    k_init, k_run = jax.random.split(key)
    _, logliks = pt.init(k_init, target)
    perm, accs, atts = torch.arange(5), [], []
    for s, sweep_key in enumerate(jax.random.split(k_run, n_sweeps)):
        _, k_swap = jax.random.split(sweep_key)
        log_u = torch.from_numpy(np.array(jnp.log(jax.random.uniform(k_swap, (5,)))))
        perm, acc, att = deo_exchange(perm, torch.from_numpy(np.array(logliks)), torch.from_numpy(betas), s % 2, log_u)
        accs.append(acc[:-1])
        atts.append(att[:-1])
    rates = torch.stack(accs).sum(0) / torch.clamp(torch.stack(atts).sum(0), min=1)
    assert perm.tolist() == np.asarray(out.perm).tolist()
    _close(rates, out.swap_rates)


def test_cold_chain_posterior_and_bookkeeping():
    pt = ParallelTempering(betas=torch.tensor([1.0, 0.6, 0.3, 0.1]),
                           request=GaussianDrift(tgx.Selection.at["mu"], 0.8), n_moves=2)
    out = pt.run(_rng(7), T_TARGET, 1500, collect=lambda t: t.get_choices()["mu"])
    s = out.collected[250:].double()
    se = math.sqrt(POST_VAR / (s.numel() / 25))
    assert abs(float(s.mean()) - POST_MEAN) < 6 * se
    assert abs(float(s.var()) - POST_VAR) < 0.15
    assert torch.equal(torch.sort(out.perm).values, torch.arange(4))
    assert bool((out.swap_rates > 0.05).all()), out.swap_rates


def test_bimodal_mixing_beats_a_cold_chain():
    @tgx.gen
    def bimodal():
        mu = tgx.normal(0.0, 2.0) @ "mu"
        _ = tgx.normal(mu * mu, 0.3) @ "y"

    target = tgx.Target(bimodal, (), TC.kw(y=4.0))  # modes near +-2
    req = GaussianDrift(tgx.Selection.at["mu"], 0.5)
    pt = ParallelTempering(betas=torch.tensor([1.0, 0.5, 0.25, 0.1, 0.02]), request=req, n_moves=2)
    out = pt.run(_rng(11), target, 2000, collect=lambda t: t.get_choices()["mu"], init_constraint=TC.kw(mu=2.0))
    pt_neg = float((out.collected[250:] < 0.0).float().mean())
    assert 0.1 < pt_neg < 0.9, pt_neg
    tr, _ = bimodal.importance(_rng(0), TC.kw(y=4.0, mu=2.0), ())
    rng, cold = _rng(12), []
    for _ in range(2000):
        tr, _ = mh(rng, tr, req)
        cold.append(tr.get_choices()["mu"])
    cold_neg = float((torch.stack(cold)[250:] < 0.0).float().mean())
    assert cold_neg < pt_neg, (cold_neg, pt_neg)


def test_request_fn_gets_one_temperature_per_replica():
    seen = []

    def request_fn(beta):
        seen.append(beta)
        return GaussianDrift(tgx.Selection.at["mu"], 0.5 / torch.sqrt(beta))

    pt = ParallelTempering(betas=torch.tensor([1.0, 0.4, 0.1]), request_fn=request_fn)
    out = pt.run(_rng(13), T_TARGET, 600, collect=lambda t: t.get_choices()["mu"])
    assert out.collected.shape == (600,) and bool(torch.isfinite(out.collected).all())
    assert seen[0].shape == (3,) and sorted(seen[0].tolist()) == pytest.approx([0.1, 0.4, 1.0])


# -- ABC -------------------------------------------------------------------------------------


@tgx.gen
def t_abc():
    t = tgx.normal(0.0, 1.0) @ "theta"
    _ = tgx.normal(t, 0.5) @ "y"


SUMMARY = lambda tr: tr.get_choices()["y"]  # noqa: E731


def _abc(**kw):
    return ABCSMC(t_abc, (), tgx.Selection.at["theta"], summary_fn=SUMMARY, observed_summary=1.0, **kw)


@pytest.mark.parametrize("n,ties", [(128, False), (127, False), (256, True)])
def test_tolerance_is_the_linear_quantile_of_jax(n, ties):
    d = np.abs(np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    if ties:
        d = np.round(d, 1)  # many equal distances
    for q in (0.5, 0.3):
        _close(_abc(quantile=q).tolerance(torch.from_numpy(d)), jnp.quantile(jnp.asarray(d), q))


def test_move_scales_are_the_population_std_with_ddof_0():
    rng = np.random.default_rng(3)
    theta = rng.standard_normal(64).astype(np.float32)
    tr, _ = t_abc.importance(_rng(0), TC.kw(theta=per_particle(torch.from_numpy(theta))), (), n=64)
    got = _abc(n_particles=64, move_scale=1.5).move_scales(tr)
    _close(got, 1.5 * jnp.std(jnp.asarray(theta)[:, None], axis=0) + 1e-8)
    assert not np.allclose(got.numpy(), 1.5 * np.std(theta, ddof=1) + 1e-8, rtol=1e-6)


def test_abc_smc_recovers_the_conjugate_posterior():
    # Exact posterior given y=1: N(0.8, 0.2); the JAX test's bounds.
    out = _abc(n_particles=4096, n_generations=8, n_moves=5).run(_rng(0))
    th = out["traces"].get_choices()["theta"].double()
    assert abs(float(th.mean()) - 0.8) < 0.1
    assert abs(float(th.std(correction=0)) - 0.2**0.5) < 0.12
    eps = out["epsilons"]
    assert bool((eps[1:] < eps[:-1]).all()) and bool((out["distances"] <= eps[-1]).all())
    assert 0.02 < float(out["accept_rate"]) < 0.95


def test_abc_smc_resamples_through_k1_once_per_generation(monkeypatch):
    import genjax_tpu_torch.inference.smc as smc

    calls = []
    lse = smc.logsumexp
    monkeypatch.setattr(smc, "logsumexp", lambda x: (calls.append(x.shape), lse(x))[1])
    _abc(n_particles=64, n_generations=3, n_moves=1).run(_rng(5))
    assert calls == [(64,)] * 3


def test_zero_weight_particles_own_no_systematic_slot():
    # The card's float32 parallel scan could step the cdf up by an ulp at a
    # zero weight and hand the particle a slot (ABC-SMC's survivors at 1M
    # drew particles outside the tolerance; `test_torch_cuda.py` checks the
    # card). The prefix sum runs in float64: every -inf particle repeats its
    # predecessor's count, the counts are those of the float64 cdf (numpy),
    # and no ancestor has zero weight.
    from genjax_tpu_torch.inference.smc import systematic_cum_counts, systematic_resample

    n = 100_000
    d = np.abs(np.random.default_rng(9).standard_normal(n))
    lw = torch.from_numpy(np.where(d <= np.median(d), 0.0, -np.inf).astype(np.float32))
    cum = systematic_cum_counts(torch.tensor(0.37), lw, n)
    zero = ~torch.isfinite(lw)
    assert torch.equal(cum[1:][zero[1:]], cum[:-1][zero[1:]])
    w = np.exp(lw.numpy().astype(np.float64))
    cdf = np.cumsum(w) / w.sum()
    ref = np.clip(np.floor(n * cdf - np.float64(np.float32(0.37))).astype(np.int64) + 1, 0, n)
    assert np.mean(cum.numpy() != ref) < 1e-4
    anc = systematic_resample(_rng(4), lw, n)
    assert bool(torch.isfinite(lw[anc]).all())


@pytest.mark.parametrize("name", ["multinomial", "residual", "stratified", "systematic"])
def test_no_resampler_picks_a_zero_weight_particle(name):
    # Every resampler reads the one float64 cdf of `smc.prefix_cdf`: a -inf
    # particle repeats its predecessor's cdf exactly, so it owns no slot and
    # draws no query (`test_torch_cuda.py` checks the card at 1M).
    from genjax_tpu_torch.inference.smc import RESAMPLERS, normalized_cdf

    n = 100_000
    d = np.abs(np.random.default_rng(11).standard_normal(n))
    lw = torch.from_numpy(np.where(d <= np.median(d), 0.0, -np.inf).astype(np.float32))
    cdf = normalized_cdf(lw)
    zero = ~torch.isfinite(lw)
    assert cdf.dtype == torch.float64 and float(cdf[-1]) == 1.0
    assert torch.equal(cdf[1:][zero[1:]], cdf[:-1][zero[1:]])
    anc = RESAMPLERS[name](_rng(12), lw, n)
    assert anc.shape == (n,) and bool(torch.isfinite(lw[anc]).all())


def test_a_query_that_rounds_to_one_takes_the_last_weighted_particle_where_jax_takes_the_last():
    # The last stratum's float32 query (u + n - 1) / n rounds to 1 for u
    # near 1, and sorted uniforms can end at 1 too. JAX's clip hands such a
    # query the last particle whatever its weight (a fault of the reference,
    # recorded here); the port gives it the last particle of positive weight.
    n = 8
    lw = np.zeros(n, np.float32)
    lw[-2:] = -np.inf
    u = np.full(n, 0.5, np.float32)
    u[-1] = np.float32(0.9999999)
    us = (u + np.arange(n, dtype=np.float32)) / np.float32(n)
    assert us[-1] == 1.0
    ref = np.asarray(jsmc._sorted_queries_ancestors(jnp.cumsum(jax.nn.softmax(jnp.asarray(lw))), jnp.asarray(us)))
    assert ref[-1] == n - 1 and lw[ref[-1]] == -np.inf
    from genjax_tpu_torch.inference.smc import normalized_cdf, sorted_queries_ancestors, stratified_ancestors

    got = sorted_queries_ancestors(normalized_cdf(torch.from_numpy(lw)), torch.from_numpy(us)).numpy()
    assert got[-1] == n - 3 and np.array_equal(got[:-1], ref[:-1])
    assert np.array_equal(stratified_ancestors(torch.from_numpy(u), torch.from_numpy(lw)).numpy(), got)


def test_degenerate_distances_stay_finite():
    alg = ABCSMC(t_abc, (), tgx.Selection.at["theta"], summary_fn=lambda tr: 0.0, observed_summary=0.0,
                 n_particles=128, n_generations=4, n_moves=2)
    out = alg.run(_rng(3))
    assert bool(torch.isfinite(out["traces"].get_choices()["theta"]).all())
    assert bool(torch.isfinite(out["epsilons"]).all())


def test_shared_args_layout():
    data = torch.linspace(-1.0, 1.0, 7)

    @tgx.gen
    def with_data(xs):
        t = tgx.normal(0.0, 1.0) @ "theta"
        _ = tgx.normal(t[..., None] * xs, 0.5) @ "y"

    alg = ABCSMC(with_data, (data,), tgx.Selection.at["theta"], summary_fn=lambda tr: tr.get_choices()["y"],
                 observed_summary=torch.zeros(7), n_particles=32, n_generations=2, n_moves=1)
    out = alg.run(_rng(4))
    (arg,) = out["traces"].get_args()
    assert arg is data and out["distances"].shape == (32,)


def test_independent_runs_stack():
    alg = _abc(n_particles=64, n_generations=3, n_moves=2)
    eps = torch.stack([alg.run(_rng(1 + i))["epsilons"] for i in range(4)])
    assert eps.shape == (4, 3)


def test_rejection_accepted_mean_matches_the_posterior():
    rej = abc_rejection(_rng(1), t_abc, (), SUMMARY, 1.0, tolerance=0.1, n_particles=20000)
    m = rej["accepted"]
    assert float(rej["accept_rate"]) > 0.01
    est = float((rej["traces"].get_choices()["theta"] * m).sum() / m.sum())
    assert abs(est - 0.8) < 0.1
    assert bool((torch.where(m, rej["distances"], 0.0) < 0.1).all())
