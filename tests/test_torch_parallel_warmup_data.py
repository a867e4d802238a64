"""The port's warmup adaptation over a sharded chain axis
(`inference/adaptation.py`, `inference/chees.py`,
`inference/requests/nuts.py` with `mesh=`) and its data-sharded
likelihoods (`parallel/data.py`), on four gloo ranks of the CPU, against
JAX on the whole batch, the stitched dense port run and the dense model.

After JAX's `tests/parallel/test_sharded_warmup.py` and
`tests/parallel/test_data_sharded.py`. One pool of four ranks runs every
case (`parallel/certify.py::warmup_data_rank_body`); the references are
computed here, in one process. Tolerances, beside each assertion:

- deterministic, against JAX on the same numpy inputs: the sharded
  `cross_chain_inv_mass` 1e-6 relative, the sharded ChEES gradient 1e-5,
  the data-sharded score, its gradient with respect to `w` and the
  importance weights 1e-5 (of max(1, |ref|));
- against the stitched dense warmup (each rank's fork, the blocks'
  float64 partial sums added in rank order): eps, T and every inverse-mass
  entry 1e-5 relative, JAX's dry-run rule;
- against the dense model on the whole data from the same generator: the
  edits' weights and HMC's scores and final `w` 1e-5 relative;
- statistical, at JAX's own tolerances (`|d log eps| < 0.3`, `|d log
  inv_mass| < 0.3`, `|d accept| < 0.08`, `|d log T| < 0.5`): each side's
  mean over 8 warmups from independent generators, since one 64-chain
  variance estimate spreads by about 0.15 in log (the port's own runs), so
  two independent single runs would differ by more than 0.3 about one time
  in seven; and every warmed mean within 6 sqrt(0.5 / 64) of 0.5.
"""

import math

import jax
import jax.numpy as jnp
import jax.random as jrand
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
from genjax_tpu.inference import adaptation as jad
from genjax_tpu.inference import chees as jchees
from genjax_tpu.models.logreg import logistic_regression as jax_logreg
from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import Update
from genjax_tpu_torch.core.requests import Regenerate
from genjax_tpu_torch.core.typing import per_particle
from genjax_tpu_torch.inference.mcmc import run_chains, share_chain_args
from genjax_tpu_torch.inference.requests import HMC
from genjax_tpu_torch.models.logreg import logistic_regression
from genjax_tpu_torch.parallel import certify
from genjax_tpu_torch.parallel.launch import launch

WORLD, SEED = 4, 11
W, D = certify.WARMUP, certify.DATA
N_CHAINS = W["n_chains"]


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def ranks():
    return launch(certify.warmup_data_rank_body, WORLD, timeout=120, args=(SEED,))


def _close(got, ref, rtol: float) -> None:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(1.0, float(np.abs(ref).max())))


def _rel(got, ref, rtol: float) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64), rtol=rtol, atol=0)


def test_no_rank_imports_jax(ranks):
    assert all(r["foreign_modules"] == [] for r in ranks)


@jgx.gen
def jax_two_sites():
    a = jgx.normal(0.0, 0.1) @ "a"
    _ = jgx.mv_normal_diag(jnp.zeros(3), 10.0 * jnp.ones(3)) @ "b"
    return a


def test_sharded_inv_mass_equals_jax_on_the_whole_batch(ranks):
    inp = certify.warmup_inputs(SEED, N_CHAINS)
    jtrs = jax.vmap(
        lambda x, y: jax_two_sites.importance(jrand.key(0), jgx.ChoiceMap.kw(a=x, b=y), ())[0]
    )(jnp.asarray(inp["a"]), jnp.asarray(inp["b"]))
    ref = jad.cross_chain_inv_mass(jtrs, jgx.Selection.at["a"] | jgx.Selection.at["b"])
    for r in ranks:
        for addr in ("a", "b"):
            _rel(r["inv_mass"][addr], np.asarray(ref[addr]), 1e-6)  # rtol 1e-6
    # Two all-reduces on "chains": the sums, then the squared deviations.
    assert ranks[0]["inv_mass"]["stats"]["chains"]["all_reduce"]["calls"] == 2


@pytest.mark.parametrize("case", ["unit", "mass"])
def test_sharded_chees_gradient_equals_jax_on_the_whole_batch(ranks, case):
    inp = certify.warmup_inputs(SEED, N_CHAINS)
    tree = {k: {name: jnp.asarray(v) for name, v in inp[k].items()} for k in ("q0", "q1", "p1")}
    im = None if case == "unit" else {k: jnp.asarray(v) for k, v in inp["im"].items()}
    ref = float(jchees._chees_grad_logT(jnp.asarray(inp["probs"]), tree["q0"], tree["q1"], tree["p1"], im,
                                        float(inp["traj_t"])))
    assert math.isfinite(ref)
    for r in ranks:
        _close(r["grad_logT"][case], ref, 1e-5)  # rtol 1e-5


def _jax_warmups() -> dict:
    """JAX's dense warmups on its conjugate model, one per replicate, each
    from a chain batch of its own keys, jitted once."""
    @jgx.gen
    def conjugate():
        mu = jgx.normal(0.0, 1.0) @ "mu"
        _ = jgx.normal(mu, 1.0) @ "obs"

    sel = jgx.Selection.at["mu"]

    def batch(k):
        return jax.vmap(lambda kk: conjugate.importance(kk, jgx.ChoiceMap.kw(obs=1.0), ())[0])(
            jrand.split(k, N_CHAINS))

    warm = jax.jit(lambda k0, k1: jad.warmup_chains(k1, batch(k0), sel, n_steps=W["n_steps"], L=W["L"]))
    chees = jax.jit(lambda k0, k1: jchees.chees_warmup(k1, batch(k0), sel, n_steps=W["n_steps"],
                                                       max_leapfrog=W["max_leapfrog"]))
    out = {"warmup": [], "chees": []}
    for r in range(W["replicates"]):
        k0, k1, k2 = jrand.split(jrand.key(1000 + r), 3)
        traces, res = warm(k0, k1)
        out["warmup"].append({"eps": float(res.eps), "inv_mass": float(res.inv_mass["mu"]),
                              "accept_rate": float(res.accept_rate), "mu": np.asarray(traces.get_choices()["mu"])})
        traces, res = chees(k0, k2)
        out["chees"].append({"eps": float(res.eps), "T": float(res.trajectory_length),
                             "accept_rate": float(res.accept_rate), "mu": np.asarray(traces.get_choices()["mu"])})
    return out


@pytest.fixture(scope="module")
def jax_warmups():
    return _jax_warmups()


def _mean_log(runs: list, key: str) -> float:
    return float(np.mean([math.log(float(np.asarray(r[key]).reshape(-1)[0])) for r in runs]))


def test_sharded_warmup_chains_agrees_with_jax_dense(ranks, jax_warmups):
    port, ref = ranks[0]["warmup"], jax_warmups["warmup"]
    port_im = [{"inv_mass": r["inv_mass"][0]} for r in port]
    assert abs(_mean_log(port, "eps") - _mean_log(ref, "eps")) < 0.3
    assert abs(_mean_log(port_im, "inv_mass") - _mean_log(ref, "inv_mass")) < 0.3
    assert abs(np.mean([float(r["accept_rate"]) for r in port]) - np.mean([r["accept_rate"] for r in ref])) < 0.08


def test_sharded_chees_warmup_agrees_with_jax_dense(ranks, jax_warmups):
    port, ref = ranks[0]["chees"], jax_warmups["chees"]
    assert abs(_mean_log(port, "eps") - _mean_log(ref, "eps")) < 0.3
    assert abs(_mean_log(port, "T") - _mean_log(ref, "T")) < 0.5


@pytest.mark.parametrize("kind", ["warmup", "chees"])
def test_sharded_warmups_sit_on_the_posterior(ranks, jax_warmups, kind):
    bound = 6.0 * math.sqrt(0.5 / N_CHAINS)
    for i in range(W["replicates"]):
        mus = np.concatenate([r[kind][i]["mu"] for r in ranks])
        assert mus.shape == (N_CHAINS,) and abs(float(mus.mean()) - 0.5) < bound
        assert abs(float(jax_warmups[kind][i]["mu"].mean()) - 0.5) < bound


@pytest.mark.parametrize("kind", ["warmup", "chees"])
def test_every_rank_holds_the_same_adaptation(ranks, kind):
    for i in range(W["replicates"]):
        head = ranks[0][kind][i]
        assert all(certify.warmup_equal(r[kind][i], head) for r in ranks[1:])  # bit for bit


def _stitched(kind: str, i: int):
    seed = {"warmup": SEED + 200, "chees": SEED + 300, "nuts": SEED + 401}[kind] + (0 if kind == "nuts" else i)
    start = SEED + 400 if kind == "nuts" else SEED + 100 + i
    blocks = certify.blocks_of(certify.warmup_start(start, N_CHAINS, "cpu"), WORLD)
    sel = Selection.at["mu"]
    if kind == "warmup":
        return certify.stitched_warmup(_gen(seed), blocks, sel, W["n_steps"], L=W["L"])
    if kind == "chees":
        return certify.stitched_chees(_gen(seed), blocks, sel, W["n_steps"], max_leapfrog=W["max_leapfrog"])
    return certify.stitched_nuts(_gen(seed), blocks, sel, W["nuts_steps"], max_depth=W["nuts_depth"])


@pytest.mark.parametrize("kind", ["warmup", "chees", "nuts"])
def test_sharded_warmup_equals_the_stitched_dense_warmup(ranks, kind):
    """Each rank's fork replayed block by block, the partial sums added
    in rank order in float64: eps, T and the inverse mass within 1e-5
    relative, and so every rank's warmed chains."""
    blocks, res = _stitched(kind, 0)
    ref = certify.warmup_numbers(res)
    got = ranks[0][kind] if kind == "nuts" else ranks[0][kind][0]
    assert certify.warmup_gap(got, ref) <= 1e-5  # rtol 1e-5
    for r, block in zip(ranks, blocks):
        mine = r[kind] if kind == "nuts" else r[kind][0]
        _rel(mine["mu"], block.get_choices()["mu"].numpy(), 1e-5)  # rtol 1e-5


def test_chees_pairs_are_a_sharded_and_a_dense_warmup(ranks):
    """`chees_pairs_rank_body` (W2's pairs on the card): each rank's pair
    is the warmup over its own one-rank chain axis, equal to the stitched
    dense warmup of one block, and the plain dense warmup, from one
    eight-schools start and one generator seed."""
    from genjax_tpu_torch.inference.chees import chees_warmup

    p = W["pairs"]
    for rank, r in enumerate(ranks):
        ((pair,),) = [r["chees_pairs"]]
        seed = SEED + 300 + rank
        start, sel = certify.eight_schools_start(seed, p["n_chains"], "cpu")
        _, sharded = certify.stitched_chees(_gen(seed + 1), [start], sel, p["n_steps"], max_leapfrog=p["max_leapfrog"])
        _, dense = chees_warmup(_gen(seed + 1), start, sel, n_steps=p["n_steps"], max_leapfrog=p["max_leapfrog"])
        for kind, res in (("sharded", sharded), ("dense", dense)):
            want = [math.log(float(res.eps)), math.log(float(res.trajectory_length)), float(res.accept_rate)]
            got = [pair[kind][k] for k in ("log eps", "log T", "accept")]
            _rel(got, want, 1e-5)  # rtol 1e-5
            _rel(pair[kind]["log inv_mass"], np.log(np.concatenate(
                [v.double().reshape(-1).numpy() for v in torch.utils._pytree.tree_leaves(res.inv_mass)])), 1e-5)
            assert pair[kind]["leapfrogs"] >= 1


def test_warmup_statistics_are_all_reduced_over_chains(ranks):
    """JAX's HLO pin (`all-reduce` in the compiled warmup), read from the
    collectives' record: every warmup reduction is an all-reduce on
    "chains" of a few floats (the mean acceptance, the variance of one
    site), nothing else."""
    for kind in ("warmup", "chees"):
        st = ranks[0][kind][0]["stats"]
        assert set(st) == {"chains"}
        kinds = {k: v for k, v in st["chains"].items() if v["calls"]}
        assert set(kinds) == {"all_reduce"} and kinds["all_reduce"]["calls"] >= W["n_steps"]


def _data():
    return certify.data_inputs(SEED, D["n"], D["d"], D["c"])


def test_data_sharded_score_and_gradient_equal_jax(ranks):
    """The sum over the ranks of the likelihood and the gradient of the
    whole score with respect to `w` (a backward that counted the prior
    once per rank, or the likelihood of one rank only, would be off by a
    factor of the rank count)."""
    data = _data()
    X, ys = jnp.asarray(data["X"]), jnp.asarray(data["ys"])

    def score(w):
        return jax_logreg.assess(jgx.ChoiceMap.kw(w=w, ys=ys), (X,))[0]

    ref = np.asarray(jax.vmap(score)(jnp.asarray(data["w"])))
    ref_grad = np.asarray(jax.vmap(jax.grad(score))(jnp.asarray(data["w"])))
    for r in ranks:
        _close(r["assess"]["score"], ref, 1e-5)  # rtol 1e-5
        _close(r["assess"]["grad"], ref_grad, 1e-5)  # rtol 1e-5


def test_data_sharded_importance_weights_equal_jax(ranks):
    data = _data()
    X, ys = jnp.asarray(data["X"]), jnp.asarray(data["ys"])
    ref = np.asarray(jax.vmap(
        lambda w: jax_logreg.importance(jrand.key(0), jgx.ChoiceMap.kw(w=w, ys=ys), (X,))[1])(jnp.asarray(data["w"])))
    for r in ranks:
        _close(r["importance"]["lw"], ref, 1e-5)  # rtol 1e-5
        _close(r["importance"]["score"], ref, 1e-5)  # w constrained too: the weight is the score


def _dense_traces(data, seed: int | None = None):
    X, ys = torch.as_tensor(data["X"]), torch.as_tensor(data["ys"])
    if seed is None:
        cm = ChoiceMap.kw(w=per_particle(torch.as_tensor(data["w"])), ys=ys)
        traces, _ = logistic_regression.importance(_gen(SEED + 5), cm, (X,), n=D["c"])
    else:
        traces, _ = logistic_regression.importance(_gen(seed), ChoiceMap.kw(ys=ys), (X,), n=D["c"])
    return share_chain_args(traces, (X,))


def test_data_sharded_edits_equal_the_dense_model(ranks):
    """`Update` and `Regenerate` through the edit plan's per-site weights:
    the global weights and scores, as the dense model gives them from the
    same generators."""
    data = _data()
    traces = _dense_traces(data)
    same = Diff.no_change(traces.get_args())
    new, uw, _, _ = Update(ChoiceMap.kw(w=per_particle(torch.as_tensor(data["w2"])))).edit(_gen(SEED + 6), traces, same)
    regen, rw, _, _ = Regenerate(Selection.at["w"]).edit(_gen(SEED + 7), traces, same)
    for r in ranks:
        e = r["edits"]
        _close(e["update_w"], uw.numpy(), 1e-5)  # rtol 1e-5
        _close(e["update_score"], new.get_score().numpy(), 1e-5)
        assert np.array_equal(e["regenerated"], regen.get_choices()["w"].numpy())  # the replicated draw
        _close(e["regenerate_w"], rw.numpy(), 1e-5)
        _close(e["regenerate_score"], regen.get_score().numpy(), 1e-5)
        _rel(r["simulate"]["score"], r["simulate"]["assess"], 1e-6)  # simulate scores what assess scores


def test_data_sharded_hmc_equals_the_dense_run(ranks):
    """HMC with the replicated generator on every rank (JAX's test holds
    1e-2 on the scores): the dense model's run from the same generator."""
    data = _data()
    start = _dense_traces(data, SEED + 9)
    finals, accs = run_chains(_gen(SEED + 10), start, HMC(Selection.at["w"], D["eps"], L=D["L"]), D["steps"])
    for r in ranks:
        h = r["hmc"]
        assert np.array_equal(h["accs"], accs.numpy())
        _rel(h["score"], finals.get_score().numpy(), 1e-5)  # rtol 1e-5
        _close(h["w"], finals.get_choices()["w"].numpy(), 1e-5)


def test_data_sharded_collectives_are_chain_sized(ranks):
    """JAX's HLO pin (no all-reduce or all-gather of more than C D floats:
    the data is never gathered), read from the collectives' record: HMC's
    only collectives are all-reduces on "data" of a score `(C,)` or a
    gradient `(C, D)`."""
    limit = D["c"] * D["d"] * 4
    for case in ("assess", "hmc"):
        st = ranks[0][case]["stats"]
        assert set(st) == {"data"}
        kinds = {k: v for k, v in st["data"].items() if v["calls"]}
        assert set(kinds) == {"all_reduce"}
        calls, total = kinds["all_reduce"]["calls"], kinds["all_reduce"]["bytes"]
        assert total <= calls * limit
    # Per HMC step: L + 1 gradients (a score forward, a gradient backward)
    # and the final update's score.
    per_step = D["L"] + 1
    assert ranks[0]["hmc"]["stats"]["data"]["all_reduce"]["calls"] == D["steps"] * (2 * per_step + 1)
    assert ranks[0]["hmc"]["stats"]["data"]["all_reduce"]["bytes"] == D["steps"] * (
        (per_step + 1) * D["c"] * 4 + per_step * limit)
