"""Inference that branches through `Switch`, port (`genjax_tpu_torch`)
against JAX (`genjax_tpu`) and against closed forms, on the CPU.

Deterministic, against JAX on the same numpy-made chains: the candidate
weights of `enumerative_gibbs`, and the reversible jump's log acceptance
ratio in both directions fed JAX's own auxiliary draws (as the HMC core is
fed JAX's momenta in `test_torch_mcmc.py`), to 1e-5 per unit of
magnitude. Statistical, at 5 standard errors, at small widths: mixture SIR
through `mix` (the LML and P(c=1 | y)), block-move MH through `Switch`,
reversible jump across `Switch` branches against the exact evidence
ratio, `enumerative_gibbs` and `gibbs_chain`, each against its closed
form. The models are those of `docs/cookbook/08_mixture_mh.py`,
`tests/inference/test_rjmcmc.py` and `enumerative_gibbs`'s docstring.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.inference.mcmc import enumerative_gibbs as j_enumerative_gibbs
from genjax_tpu.inference.rjmcmc import JumpProposal as JJump
from genjax_tpu.inference.rjmcmc import _directed_jump as j_directed_jump
from genjax_tpu_torch.inference.mcmc import candidate_weights
from genjax_tpu_torch.inference.rjmcmc import _directed_jump as t_directed_jump

torch.set_num_threads(1)

JC, TC = jgx.ChoiceMap, tgx.ChoiceMap
JB, TB = jgx.ChoiceMapBuilder, tgx.ChoiceMapBuilder
JS, TS = jgx.Selection.at, tgx.Selection.at
PP = tgx.per_particle


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), (got, ref)


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


def _within(est: float, exact: float, se: float, what: str, n_se: float = 5.0) -> None:
    assert math.isfinite(est) and abs(est - exact) < n_se * se, f"{what}: {est} vs {exact} (SE {se})"


def _npdf(y, mu, sd):
    return math.exp(-0.5 * ((y - mu) / sd) ** 2) / (sd * math.sqrt(2.0 * math.pi))


# -- the mixture of cookbook chapter 8 --------------------------------------------

LOGITS = [0.3, -0.2]
MU, SIG, OBS_SD, Y = [0.0, 5.0], [1.0, 2.0], 0.5, 2.5


@tgx.gen
def narrow():
    return tgx.normal(0.0, 1.0) @ "v"


@tgx.gen
def wide():
    return tgx.normal(5.0, 2.0) @ "v"


@tgx.gen
def mixture():
    v = tgx.mix(narrow, wide)(torch.tensor(LOGITS), (), ()) @ "m"
    return tgx.normal(v, OBS_SD) @ "y"


def _mixture_exact() -> tuple[float, float]:
    """(log p(y), P(c=1 | y)): v integrates out per component."""
    prior = np.exp(LOGITS) / np.exp(LOGITS).sum()
    joint = [p * _npdf(Y, m, math.sqrt(s * s + OBS_SD**2)) for p, m, s in zip(prior, MU, SIG)]
    return math.log(sum(joint)), joint[1] / sum(joint)


BLOCK = TS["m", "mixture_component"] | TS["m", "component_sample", ...]


def test_mixture_sir_lml_and_component_posterior():
    lml_exact, p1_exact = _mixture_exact()
    target = tgx.Target(mixture, (), TC.kw(y=Y))
    alg = tgx.ImportanceK(target, k_particles=4096)
    rng = _rng(0)
    lmls, p1s = [], []
    for _ in range(12):
        col = alg.run_smc(rng)
        c = col.get_particles().get_choices()["m", "mixture_component"]
        assert c.shape == (4096,)
        lmls.append(float(col.get_log_marginal_likelihood_estimate()))
        p1s.append(float(torch.softmax(col.get_log_weights().double(), 0) @ (c == 1).double()))
    for vals, exact, what in ((lmls, lml_exact, "LML"), (p1s, p1_exact, "P(c=1 | y)")):
        _within(float(np.mean(vals)), exact, float(np.std(vals, ddof=1) / math.sqrt(len(vals))), what)


def test_block_mh_through_switch_matches_the_component_posterior():
    _, p1_exact = _mixture_exact()
    chains = 4096
    rng = _rng(1)
    traces, _ = mixture.importance(rng, TC.kw(y=Y), (), n=chains)
    new, w, _, _ = tgx.Regenerate(BLOCK).edit(rng, traces, tgx.Diff.no_change(()))
    _close(w, (new.get_score() - traces.get_score()).numpy(), 1e-4)  # the weight is the joint's change
    final, accepted = tgx.run_chains(rng, traces, tgx.Regenerate(BLOCK), 80)
    assert accepted.shape == (chains, 80) and 0.02 < float(accepted.float().mean()) < 0.9
    p1 = float((final.get_choices()["m", "mixture_component"] == 1).double().mean())
    _within(p1, p1_exact, math.sqrt(p1_exact * (1 - p1_exact) / chains), "block MH P(c=1 | y)")


# -- enumerative Gibbs --------------------------------------------------------------


@jgx.gen
def j_two_means():
    z = jgx.categorical(jnp.log(jnp.array([0.5, 0.5]))) @ "z"
    _ = jgx.normal(jnp.where(z == 0, -1.0, 1.0), 1.0) @ "y"


@tgx.gen
def t_two_means():
    z = tgx.categorical(torch.log(torch.tensor([0.5, 0.5]))) @ "z"
    _ = tgx.normal(torch.where(z == 0, -1.0, 1.0), 1.0) @ "y"


@jgx.gen
def j_three(mu):
    z = jgx.categorical(jnp.array([0.2, -0.4, 0.1])) @ "z"
    x = jgx.normal(mu[z], 1.0) @ "x"
    _ = jgx.normal(x, 0.3) @ "y"


@tgx.gen
def t_three(mu):
    z = tgx.categorical(torch.tensor([0.2, -0.4, 0.1])) @ "z"
    x = tgx.normal(mu[z], 1.0) @ "x"
    _ = tgx.normal(x, 0.3) @ "y"


def test_enumerative_gibbs_candidate_weights_like_jax():
    rng = np.random.default_rng(2)
    C, mu = 16, np.array([-2.0, 0.5, 3.0], dtype=np.float32)
    z = rng.integers(0, 3, C)
    x = rng.standard_normal(C).astype(np.float32)
    y = (x + 0.3 * rng.standard_normal(C)).astype(np.float32)
    values = np.arange(3)

    def j_weights(zi, xi, yi):
        tr, _ = j_three.generate(jax.random.key(0), JC.kw(z=zi, x=xi, y=yi), (jnp.asarray(mu),))
        return jax.vmap(lambda v: jgx.Update(JC.kw(z=v)).edit(jax.random.key(1), tr, jgx.Diff.no_change(tr.get_args()))[1])(
            jnp.asarray(values))

    ref = jax.vmap(j_weights)(z, x, y)
    tr, _ = t_three.generate(_rng(), TC.kw(z=PP(torch.tensor(z)), x=PP(torch.tensor(x)), y=PP(torch.tensor(y))),
                             (torch.tensor(mu),), n=C)
    got = candidate_weights(_rng(), tr, ("z",), torch.tensor(values))
    assert got.shape == (C, 3)
    _close(got, ref)
    # The weight of the current value is 0.
    _close(got[torch.arange(C), torch.tensor(z)], np.zeros(C))


def test_enumerative_gibbs_one_chain_like_jax():
    tr_j, _ = j_two_means.generate(jax.random.key(0), JC.kw(z=0, y=0.9), ())
    new_j = j_enumerative_gibbs(jax.random.key(1), tr_j, "z", jnp.arange(2))
    tr_t, _ = t_two_means.generate(_rng(), TC.kw(z=torch.tensor(0), y=0.9), ())
    w = candidate_weights(_rng(), tr_t, ("z",), torch.arange(2))
    _close(w, [0.0, math.log(_npdf(0.9, 1.0, 1.0) / _npdf(0.9, -1.0, 1.0))])
    new_t = tgx.enumerative_gibbs(_rng(), tr_t, "z", torch.arange(2))
    assert int(new_t.get_choices()["z"]) in (0, 1) and int(new_j.get_choices()["z"]) in (0, 1)
    js, _ = j_two_means.assess(JC.kw(z=int(new_t.get_choices()["z"]), y=0.9), ())
    _close(new_t.get_score(), js)


def test_enumerative_gibbs_matches_the_full_conditional():
    exact = _npdf(0.9, 1.0, 1.0) / (_npdf(0.9, -1.0, 1.0) + _npdf(0.9, 1.0, 1.0))
    chains = 8192
    rng = _rng(3)
    tr, _ = t_two_means.importance(rng, TC.kw(y=0.9), (), n=chains)
    for _ in range(2):
        tr = tgx.enumerative_gibbs(rng, tr, "z", torch.arange(2))
    z = tr.get_choices()["z"]
    assert z.shape == (chains,) and z.dtype == torch.int64
    _within(float((z == 1).double().mean()), exact, math.sqrt(exact * (1 - exact) / chains), "P(z=1 | y)")
    _close(tr.get_score(), t_two_means.assess(TC.kw(z=PP(z), y=0.9), (), n=chains)[0].numpy())


@tgx.gen
def t_normal_pair():
    mu = tgx.normal(0.0, 1.0) @ "mu"
    _ = tgx.normal(mu, 1.0) @ "obs"


def test_gibbs_chain_matches_the_conjugate_posterior():
    """Prior-proposal MH within Gibbs on mu | obs ~ N(obs / 2, 1 / 2)."""
    chains = 4096
    rng = _rng(4)
    tr, _ = t_normal_pair.importance(rng, TC.kw(obs=1.2), (), n=chains)
    final, mus = tgx.gibbs_chain(rng, tr, [TS["mu"]], 30, lambda t: t.get_choices()["mu"])
    assert mus.shape == (30, chains)
    mu = final.get_choices()["mu"].double()
    _within(float(mu.mean()), 0.6, math.sqrt(0.5 / chains), "E[mu | obs]")
    once = tgx.gibbs_sweep(rng, final, [TS["mu"]])
    assert once.get_choices()["mu"].shape == (chains,)


# -- reversible jump (tests/inference/test_rjmcmc.py) --------------------------------

N, RJ_SIG, TAU = 4, 0.5, 0.7
_data = np.random.default_rng(1)
YS1 = (0.35 + RJ_SIG * _data.standard_normal(N)).astype(np.float32)
YS2 = (-0.35 + RJ_SIG * _data.standard_normal(N)).astype(np.float32)


@jgx.gen
def j_rb0():
    mu = jgx.normal(0.0, 1.0) @ "mu"
    return (mu, mu)


@jgx.gen
def j_rb1():
    return (jgx.normal(0.0, 1.0) @ "mu1", jgx.normal(0.0, 1.0) @ "mu2")


@jgx.gen
def j_rj_model(ys1, ys2):
    m = jgx.flip(0.5) @ "m"
    means = jgx.switch(j_rb0, j_rb1)(m.astype(jnp.int32), (), ()) @ "k"
    _ = jgx.normal(means[0] * jnp.ones(N), RJ_SIG) @ "y1"
    _ = jgx.normal(means[1] * jnp.ones(N), RJ_SIG) @ "y2"


@tgx.gen
def t_rb0():
    mu = tgx.normal(0.0, 1.0) @ "mu"
    return (mu, mu)


@tgx.gen
def t_rb1():
    return (tgx.normal(0.0, 1.0) @ "mu1", tgx.normal(0.0, 1.0) @ "mu2")


@tgx.gen
def t_rj_model(ys1, ys2):
    m = tgx.flip(0.5) @ "m"
    means = tgx.switch(t_rb0, t_rb1)(m.to(torch.int64), (), ()) @ "k"
    _ = tgx.normal(means[0][..., None] * torch.ones(N), RJ_SIG) @ "y1"
    _ = tgx.normal(means[1][..., None] * torch.ones(N), RJ_SIG) @ "y2"


@jgx.gen
def j_aux_up():
    _ = jgx.normal(0.0, TAU) @ "u"


@jgx.gen
def j_aux_down():
    return 0.0


@tgx.gen
def t_aux_up():
    _ = tgx.normal(0.0, TAU) @ "u"


@tgx.gen
def t_aux_down():
    return 0.0


def _proposals(C, B, J, aux_up, aux_down):
    up = J(
        read=lambda chm: chm["k", "mu"].unmask(0.0),
        aux=aux_up,
        involution=lambda mu, u: ((mu + u["u"], mu - u["u"]), C.empty()),
        constraint=lambda p: B["m"].set(True) | B["k", "mu1"].set(p[0]) | B["k", "mu2"].set(p[1]),
    )
    down = J(
        read=lambda chm: (chm["k", "mu1"].unmask(0.0), chm["k", "mu2"].unmask(0.0)),
        aux=aux_down,
        involution=lambda p, u: ((p[0] + p[1]) / 2.0, C.kw(u=(p[0] - p[1]) / 2.0)),
        constraint=lambda mu: B["m"].set(False) | B["k", "mu"].set(mu),
    )
    return up, down


J_UP, J_DOWN = _proposals(JC, JB, JJump, j_aux_up, j_aux_down)
T_UP, T_DOWN = _proposals(TC, TB, tgx.JumpProposal, t_aux_up, t_aux_down)


def _log_evidence(y, blocks):
    n = len(y)
    cov = RJ_SIG**2 * np.eye(n)
    for b in blocks:
        for i in b:
            for j in b:
                cov[i, j] += 1.0
    _, logdet = np.linalg.slogdet(cov)
    return float(-0.5 * y @ np.linalg.solve(cov, y) - 0.5 * (logdet + n * np.log(2 * np.pi)))


def exact_post_m1() -> float:
    y = np.concatenate([YS1, YS2]).astype(np.float64)
    e0 = _log_evidence(y, [list(range(2 * N))])
    e1 = _log_evidence(y, [list(range(N)), list(range(N, 2 * N))])
    return 1.0 / (1.0 + np.exp(e0 - e1))


def _rj_values(chains: int, seed: int):
    rng = np.random.default_rng(seed)
    m = rng.random(chains) < 0.5
    return (m, *(0.5 * rng.standard_normal((3, chains))).astype(np.float32))


def _t_rj_chains(chains: int, seed: int):
    """Chains with m, mu, mu1 and mu2 from numpy, every site constrained."""
    m, mu, mu1, mu2 = _rj_values(chains, seed)
    chm = TC.kw(m=PP(torch.tensor(m)), y1=torch.tensor(YS1), y2=torch.tensor(YS2)) | TB["k"].set(
        TC.kw(mu=PP(torch.tensor(mu)), mu1=PP(torch.tensor(mu1)), mu2=PP(torch.tensor(mu2))))
    return t_rj_model.generate(_rng(), chm, (torch.tensor(YS1), torch.tensor(YS2)), n=chains)[0]


@functools.cache
def _j_rj_chains(chains: int, seed: int):
    """The same chains in JAX."""

    def j_one(mi, a, b, c):
        chm = JC.kw(m=mi, y1=YS1, y2=YS2) | JB["k"].set(JC.kw(mu=a, mu1=b, mu2=c))
        return j_rj_model.generate(jax.random.key(0), chm, (YS1, YS2))[0]

    return jax.jit(jax.vmap(j_one))(*_rj_values(chains, seed))


@pytest.mark.parametrize("direction", ["up", "down"])
def test_jump_log_acceptance_ratio_fed_jax_draws_like_jax(direction):
    chains = 12
    jtr, ttr = _j_rj_chains(chains, 5), _t_rj_chains(chains, 5)
    _close(ttr.get_score(), jtr.get_score())
    keys = jax.random.split(jax.random.key(6), chains)
    j_fwd, j_rev, t_fwd, t_rev, j_aux, t_aux = (
        (J_UP, J_DOWN, T_UP, T_DOWN, j_aux_up, t_aux_up) if direction == "up"
        else (J_DOWN, J_UP, T_DOWN, T_UP, j_aux_down, t_aux_down))
    jnew, jalpha = jax.jit(jax.vmap(lambda k, t: j_directed_jump(k, t, j_fwd, j_rev, jgx.Diff.no_change(t.get_args()))))(
        keys, jtr)

    # rjmcmc.py:81-83: the auxiliary draw comes from the first split of
    # the direction's key.
    u = jax.vmap(lambda k: j_aux.simulate(jax.random.split(k)[0], ()).get_choices())(keys)
    if direction == "up":
        aux_tr, _ = t_aux.generate(_rng(), TC.kw(u=PP(torch.tensor(np.asarray(u["u"])))), (), n=chains)
    else:
        aux_tr = t_aux.simulate(_rng(), (), n=chains)
    tnew, talpha = t_directed_jump(_rng(), ttr, t_fwd, t_rev, tgx.Diff.no_change(ttr.get_args()), aux_tr)
    scale = float(np.abs(np.asarray(jtr.get_score())).max())
    assert np.all(np.abs(talpha.numpy() - np.asarray(jalpha)) <= 1e-5 * scale), (talpha, jalpha)
    _close(tnew.get_score(), jnew.get_score())
    assert (tnew.get_choices()["m"].numpy() == np.asarray(jnew.get_choices()["m"])).all()


def test_jump_dimension_mismatch_raises():
    bad_up = tgx.JumpProposal(
        read=T_UP.read, aux=t_aux_up, involution=lambda mu, u: (mu + u["u"], TC.empty()),
        constraint=lambda p: TB["m"].set(True) | TB["k", "mu1"].set(p),
    )
    ttr = _t_rj_chains(4, 7)
    with pytest.raises(ValueError, match="conserve total dimension"):
        tgx.reversible_jump(_rng(), ttr, bad_up, T_DOWN, lambda chm: ~chm["m"])


def test_reversible_jump_branch_occupancy_matches_the_exact_posterior():
    exact = exact_post_m1()
    assert 0.2 < exact < 0.8
    chains = 2048
    rng = _rng(8)
    tr, _ = t_rj_model.importance(rng, TC.kw(y1=torch.tensor(YS1), y2=torch.tensor(YS2)),
                                  (torch.tensor(YS1), torch.tensor(YS2)), n=chains)
    within = tgx.Regenerate(TS["k", ...])
    accepted = []
    for _ in range(60):
        tr, acc = tgx.reversible_jump(rng, tr, T_UP, T_DOWN, lambda chm: ~chm["m"])
        tr, _ = tgx.mh(rng, tr, within)
        accepted.append(acc)
    rate = float(torch.stack(accepted).float().mean())
    assert 0.1 < rate < 0.9, rate
    p1 = float(tr.get_choices()["m"].double().mean())
    _within(p1, exact, math.sqrt(exact * (1 - exact) / chains), "RJ P(m=1 | y)")
