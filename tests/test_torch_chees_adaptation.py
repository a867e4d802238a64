"""Warmup adaptation (`inference/adaptation.py`) and ChEES
(`inference/chees.py`), port against JAX on the CPU.

Deterministic, each against the JAX function on the same numpy-made
inputs: `da_update` over a fixed sequence of accept statistics (the
recursion's float32 state within 1e-6 relative), `cross_chain_inv_mass` on
a chain batch (1e-5 relative), Adam's scalar step (1e-6 relative), the
ChEES gradient `_chees_grad_logT` on a batch with diverged (inf and NaN)
endpoints (1e-5 relative), and one jittered HMC step of a ChEES iteration
fed the momenta and accept uniforms that JAX's `_hmc_step_collecting`
draws from each chain's key (end points and momenta within 1e-5 of the
largest |value|; the log accept probabilities, differences of scores,
within 1e-5 of the largest |score|).

Statistical, after `tests/inference/test_chees.py` and
`tests/inference/test_adaptation.py` at the port's CPU sizes: dual
averaging moves eps the right way and finds the fixed point of a
synthetic curve; the cross-chain variance recovers prior variances; HMC
and MALA warmup land their acceptance targets, recover an anisotropic
metric and leave the conjugate posterior exact; ChEES grows T on an
ill-conditioned target, survives divergences, and keeps the posterior
exact; the leapfrog cap holds. Bounds at 6 standard errors, as there.
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
from genjax_tpu.inference import adaptation as jad
from genjax_tpu.inference import chees as jchees
from genjax_tpu.inference.requests.hmc import sample_momenta as jax_sample_momenta
from genjax_tpu.models.logreg import logistic_regression as jax_logreg
from genjax_tpu_torch import convert
from genjax_tpu_torch.inference import adaptation as tad
from genjax_tpu_torch.inference import chees as tchees
from genjax_tpu_torch.inference.diagnostics import split_rhat
from genjax_tpu_torch.models.logreg import logistic_regression

torch.set_num_threads(1)


def _rel_close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(1.0, np.abs(ref).max()))


def test_da_update_sequence_matches_jax():
    stats = np.random.default_rng(0).random(60).astype(np.float32)
    jda, tda = jad.da_init(0.3), tad.da_init(0.3)
    for a in stats:
        jda = jad.da_update(jda, jnp.asarray(a), target=0.75)
        tda = tad.da_update(tda, torch.tensor(a), target=0.75)
        for name in ("log_eps", "log_eps_bar", "h_bar", "step"):
            _rel_close(getattr(tda, name), getattr(jda, name), 1e-6)
    _rel_close(tad.da_final(tda), jad.da_final(jda), 1e-6)


@jgx.gen
def jax_two_sites():
    a = jgx.normal(0.0, 0.1) @ "a"
    b = jgx.mv_normal_diag(jnp.zeros(3), 10.0 * jnp.ones(3)) @ "b"
    return a


@tgx.gen
def two_sites():
    a = tgx.normal(0.0, 0.1) @ "a"
    b = tgx.mv_normal_diag(torch.zeros(3), 10.0 * torch.ones(3)) @ "b"
    return a


def test_cross_chain_inv_mass_matches_jax():
    rng = np.random.default_rng(1)
    a = (0.1 * rng.standard_normal(40)).astype(np.float32)
    b = (10.0 * rng.standard_normal((40, 3))).astype(np.float32)
    jtrs = jax.vmap(
        lambda x, y: jax_two_sites.importance(jrand.key(0), jgx.ChoiceMap.kw(a=x, b=y), ())[0]
    )(jnp.asarray(a), jnp.asarray(b))
    ttrs = convert.chain_batch(two_sites, (), {"a": a, "b": b}, device="cpu")
    sel_j, sel_t = jgx.Selection.at["a"] | jgx.Selection.at["b"], tgx.Selection.at["a"] | tgx.Selection.at["b"]
    ref, got = jad.cross_chain_inv_mass(jtrs, sel_j), tad.cross_chain_inv_mass(ttrs, sel_t)
    for addr in ("a", "b"):
        _rel_close(got[addr], ref[addr], 1e-5)
    assert got.batched_leaves() == [0, 0]


def test_adam_step_matches_jax():
    grads = np.random.default_rng(2).standard_normal(30).astype(np.float32)
    ja, ta = jchees._Adam.init(), tchees._Adam.init()
    for g in grads:
        ja, jd = ja.step(jnp.asarray(g))
        ta, td = ta.step(torch.tensor(g))
        _rel_close(td, jd, 1e-6)


def test_chees_gradient_matches_jax():
    rng = np.random.default_rng(3)
    c = 24
    probs = rng.random(c).astype(np.float32)
    q0 = {"x": rng.standard_normal(c).astype(np.float32), "v": rng.standard_normal((c, 2)).astype(np.float32)}
    q1 = {k: (v + 0.5 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in q0.items()}
    p1 = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in q0.items()}
    q1["x"][3], q1["v"][5, 1] = np.inf, np.nan  # diverged trajectories
    probs[3] = probs[5] = 0.0
    im = {"x": np.float32(0.7), "v": np.array([1.5, 0.3], np.float32)}
    for inv_mass in (None, im):
        jin = None if inv_mass is None else {k: jnp.asarray(v) for k, v in inv_mass.items()}
        ref = jchees._chees_grad_logT(
            jnp.asarray(probs), *({k: jnp.asarray(v) for k, v in d.items()} for d in (q0, q1, p1)), jin, 1.7
        )
        # The port takes leaf lists: JAX's dict leaves come in sorted key order.
        order = sorted(q0)
        got = tchees._chees_grad_logT(
            torch.from_numpy(probs),
            *([torch.from_numpy(d[k]) for k in order] for d in (q0, q1, p1)),
            None if inv_mass is None else [torch.tensor(inv_mass[k]) for k in order],
            torch.tensor(1.7),
        )
        assert math.isfinite(float(got))
        _rel_close(got, ref, 1e-5)


def test_chees_hmc_step_matches_jax_on_jax_draws():
    rng = np.random.default_rng(4)
    n, d, c = 40, 3, 16
    X = rng.standard_normal((n, d)).astype(np.float32)
    ys = (rng.random(n) < 0.5).astype(np.int32)
    w = (0.5 * rng.standard_normal((c, d))).astype(np.float32)
    jtrs = jax.vmap(
        lambda wi: jax_logreg.importance(jrand.key(0), jgx.ChoiceMap.kw(w=wi, ys=jnp.asarray(ys)), (jnp.asarray(X),))[0]
    )(jnp.asarray(w))
    ttrs = convert.chain_batch(logistic_regression, (X,), {"w": w}, {"ys": ys}, device="cpu")
    eps, n_steps = 0.15, 7
    jim = {"w": jnp.asarray([0.5, 1.0, 2.0])}
    sel_j = jgx.Selection.at["w"]
    keys = jrand.split(jrand.key(11), c)

    def one(k, tr):
        out, (prob, _, q1, p1) = jchees._hmc_step_collecting(k, tr, sel_j, eps, n_steps, jgx.ChoiceMap.d(jim))
        k_mom, _, k_acc = jrand.split(k, 3)
        grads = tr.get_choices().filter(sel_j)
        momenta, _ = jax_sample_momenta(k_mom, grads, inv_mass=jgx.ChoiceMap.d(jim))
        return out.get_choices()["w"], prob, q1["w"], p1["w"], momenta["w"], jnp.log(jrand.uniform(k_acc))

    ref_w, ref_prob, ref_q1, ref_p1, mom, log_u = jax.jit(jax.vmap(one))(keys, jtrs)
    tim = tgx.ChoiceMap.kw(w=torch.tensor([0.5, 1.0, 2.0]))
    momenta = tgx.ChoiceMap.kw(w=tgx.per_particle(torch.from_numpy(np.array(mom))))
    out, (prob, _, q1, p1) = tchees.hmc_step_with(
        torch.Generator(), ttrs, tgx.Selection.at["w"], eps, n_steps, tim, momenta,
        torch.from_numpy(np.array(log_u)),
    )
    # The accept ratio is a difference of scores: its log within 1e-5 of
    # the largest |score|.
    scale = float(np.abs(np.asarray(jtrs.get_score())).max())
    np.testing.assert_allclose(np.log(prob.numpy()), np.log(np.asarray(ref_prob)), rtol=0, atol=1e-5 * scale)
    _rel_close(q1["w"], ref_q1, 1e-5)
    _rel_close(p1["w"], ref_p1, 1e-5)
    _rel_close(out.get_choices()["w"], ref_w, 1e-5)


# -- statistical ---------------------------------------------------------------


@tgx.gen
def aniso():
    a = tgx.normal(0.0, 0.1) @ "a"
    b = tgx.normal(0.0, 10.0) @ "b"
    return a + b


@tgx.gen
def conjugate():
    mu = tgx.normal(0.0, 1.0) @ "mu"
    _ = tgx.normal(mu, 1.0) @ "obs"


@tgx.gen
def ill_conditioned():
    x = tgx.normal(0.0, 1.0) @ "x"
    y = tgx.normal(0.0, 10.0) @ "y"


POST_MEAN, POST_VAR = 0.5, 0.5


def _conjugate(rng, n):
    return conjugate.importance(rng, tgx.ChoiceMap.kw(obs=1.0), (), n=n)[0]


@pytest.mark.parametrize("accept,grows", [(0.0, False), (1.0, True)])
def test_dual_averaging_direction(accept, grows):
    da = tad.da_init(0.5)
    for _ in range(50):
        da = tad.da_update(da, torch.tensor(accept), target=0.8)
    assert (float(tad.da_final(da)) > 0.5) == grows


def test_dual_averaging_fixed_point_of_synthetic_curve():
    # accept = exp(-eps): the fixed point is eps = -log(0.8) ~ 0.223.
    da = tad.da_init(1.0)
    for _ in range(400):
        da = tad.da_update(da, torch.exp(-torch.exp(da.log_eps)), target=0.8)
    assert abs(float(tad.da_final(da)) - 0.2231) < 0.05


def test_cross_chain_variance_estimates_prior_variance():
    trs = aniso.simulate(torch.Generator().manual_seed(0), (), n=4096)
    im = tad.cross_chain_inv_mass(trs, tgx.Selection.at["a"] | tgx.Selection.at["b"])
    assert abs(float(im["a"]) - 0.01) < 0.002
    assert abs(float(im["b"]) - 100.0) < 15.0
    # A declared chain count the leaves do not carry: unit mass, as JAX.
    im = tad.cross_chain_inv_mass(trs, tgx.Selection.at["a"], n_chains=16)
    assert im["a"].shape == (4096,) and bool((im["a"] == 1.0).all())


def test_hmc_warmup_adapts_anisotropic_metric():
    rng = torch.Generator().manual_seed(1)
    trs = aniso.simulate(rng, (), n=256)
    sel = tgx.Selection.at["a"] | tgx.Selection.at["b"]
    warmed, res = tad.warmup_chains(rng, trs, sel, n_steps=150, L=8)
    assert 0.6 < float(res.accept_rate) < 0.95
    assert 0.005 < float(res.inv_mass["a"]) < 0.02
    assert 50.0 < float(res.inv_mass["b"]) < 200.0
    final, _ = tgx.run_chains(rng, warmed, tgx.HMC(sel, res.eps, 8, res.inv_mass, jitter=0.2), 60)
    ch = final.get_choices()
    assert abs(float(ch["a"].var()) - 0.01) < 0.005
    assert abs(float(ch["b"].var()) - 100.0) < 40.0


@pytest.mark.parametrize("algorithm", ["hmc", "mala"])
def test_warmup_keeps_the_posterior_exact(algorithm):
    rng = torch.Generator().manual_seed(3)
    n = 256
    warmed, res = tad.warmup_chains(rng, _conjugate(rng, n), tgx.Selection.at["mu"], n_steps=100, L=5,
                                    algorithm=algorithm)
    if algorithm == "mala":
        assert 0.4 < float(res.accept_rate) < 0.75
        req = tgx.MALA(tgx.Selection.at["mu"], res.eps, res.inv_mass)
    else:
        assert 0.6 < float(res.accept_rate) < 0.95
        req = tgx.HMC(tgx.Selection.at["mu"], res.eps, 5, res.inv_mass, jitter=0.2)
    final, _ = tgx.run_chains(rng, warmed, req, 100)
    mus = final.get_choices()["mu"].double()
    assert abs(float(mus.mean()) - POST_MEAN) < 6 * math.sqrt(POST_VAR / n)
    assert abs(float(mus.var()) - POST_VAR) < 0.15


def test_unknown_warmup_algorithm_raises():
    with pytest.raises(ValueError, match="unknown algorithm"):
        tad.warmup_chains(torch.Generator(), _conjugate(torch.Generator(), 4), tgx.Selection.at["mu"],
                          algorithm="slice")


def test_chees_grows_trajectory_on_ill_conditioned_target():
    rng = torch.Generator().manual_seed(0)
    trs = ill_conditioned.simulate(rng, (), n=128)
    sel = tgx.Selection.at["x"] | tgx.Selection.at["y"]
    warmed, res = tchees.chees_warmup(rng, trs, sel, n_steps=100, adapt_mass=False, T0=1.0)
    assert float(res.trajectory_length) > 4.0, float(res.trajectory_length)
    assert 0.45 < float(res.accept_rate) < 0.85
    final, _ = tchees.run_chees_chains(rng, warmed, sel, res, 100)
    ch = final.get_choices()
    assert abs(float(ch["x"].var()) - 1.0) < 0.5
    assert abs(float(ch["y"].var()) - 100.0) < 50.0


def test_chees_posterior_exact_and_mixing():
    rng = torch.Generator().manual_seed(3)
    n = 256
    sel = tgx.Selection.at["mu"]
    warmed, res = tchees.chees_warmup(rng, _conjugate(rng, n), sel, n_steps=80)
    final, samples = tchees.run_chees_chains(
        rng, warmed, sel, res, 100, collect=lambda t: t.get_choices()["mu"]
    )
    assert samples.shape == (100, n)  # the batch per step: (n_steps, n_chains)
    mus = final.get_choices()["mu"].double()
    assert abs(float(mus.mean()) - POST_MEAN) < 6 * math.sqrt(POST_VAR / n)
    assert abs(float(mus.var()) - POST_VAR) < 0.15
    assert float(split_rhat(samples.T[:, 30:])) < 1.1


def test_chees_divergences_do_not_poison_adaptation():
    @tgx.gen
    def hard():
        a = tgx.normal(0.0, 0.1) @ "a"
        b = tgx.normal(0.0, 10.0) @ "b"

    rng = torch.Generator().manual_seed(11)
    trs = hard.simulate(rng, (), n=128)
    _, res = tchees.chees_warmup(rng, trs, tgx.Selection.at["a"] | tgx.Selection.at["b"], n_steps=100,
                                 adapt_mass=False)
    assert bool(torch.isfinite(res.trajectory_length)), "T went NaN"
    assert float(res.trajectory_length) > 8.0
    assert 0.45 < float(res.accept_rate) < 0.85


def test_chees_max_leapfrog_caps_work_and_one_read_per_step():
    rng = torch.Generator().manual_seed(9)
    trs = ill_conditioned.simulate(rng, (), n=32)
    before = tchees.chees_stats["syncs"]
    _, res = tchees.chees_warmup(rng, trs, tgx.Selection.at["x"] | tgx.Selection.at["y"], n_steps=40,
                                 adapt_mass=False, max_leapfrog=3)
    assert tchees.chees_stats["syncs"] - before == 40  # one host read per step
    assert 1 <= tchees.chees_stats["leapfrog"] <= 3
    assert bool(torch.isfinite(res.eps)) and bool(torch.isfinite(res.trajectory_length))
