"""The port's sharded SMC layer (`genjax_tpu_torch.parallel`: `smc.py`,
`chains.py`, `mesh.py`, `collectives.py`) on four gloo ranks of the CPU,
against the stitched dense port run and against `genjax_tpu.parallel` on
four devices of the virtual CPU mesh.

After JAX's `tests/parallel/test_sharded.py`, `test_hlo_collectives.py`
and the SMC part of `test_dryrun_certifies.py`. One pool of four ranks
runs every case (`parallel/certify.py::smc_rank_body`); the references are
computed here, in one process. Tolerances, stated beside each assertion:
bit for bit where the sharded arithmetic is the dense port's (the
ancestors, the exchanged rows, every round's particles and weights, the
chains); 1e-6 relative where an all-reduce sums the shards in another
order than one logsumexp (LML, ESS; also against JAX, which sums as the
port does); JAX's ancestors within its float32 cdf's tie rate (at most
1e-3 of slots, each off by one); estimates within 5 standard errors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_tpu.parallel import particle_mesh as j_particle_mesh
from genjax_tpu.parallel import sharded_ess as j_sharded_ess
from genjax_tpu.parallel import sharded_lml as j_sharded_lml
from genjax_tpu.parallel import sharded_systematic_ancestors as j_sharded_ancestors
from genjax_tpu_torch.adev.core import fork
from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.gather import take_rows
from genjax_tpu_torch.core.requests import Regenerate
from genjax_tpu_torch.inference.mcmc import run_chains, share_chain_args
from genjax_tpu_torch.inference.requests import MALA
from genjax_tpu_torch.inference.smc import ess, systematic_resample
from genjax_tpu_torch.inference.sp import Target
from genjax_tpu_torch.ops import logsumexp
from genjax_tpu_torch.parallel import certify
from genjax_tpu_torch.parallel.launch import launch
from genjax_tpu_torch.parallel.smc import systematic_slot_ancestors

WORLD, K, SEED = 4, 4096, 7
PER = K // WORLD
INPUTS = certify.smc_inputs(SEED, K)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's sharded LML and ESS, and its ancestors, on four devices, each
    compiled once (an eager `shard_map` compiles op by op)."""
    mesh = j_particle_mesh(WORLD)
    return (jax.jit(lambda lw: (j_sharded_lml(lw, mesh), j_sharded_ess(lw, mesh))),
            jax.jit(lambda key, lw: j_sharded_ancestors(key, lw, mesh)))


@pytest.fixture(scope="module")
def ranks():
    return launch(certify.smc_rank_body, WORLD, timeout=120, args=(SEED, K))


def _rel(got: float, ref: float) -> float:
    return abs(got - ref) / max(1.0, abs(ref))


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x.shape == y.shape and np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))


@pytest.mark.parametrize("case", ["lw", "dead"])
def test_sharded_lml_and_ess_match_the_dense_port_and_jax(ranks, jax_sharded, case):
    lw = INPUTS[case]
    lml, est = ranks[0][f"lml_{case}"], ranks[0][f"ess_{case}"]
    # Every rank holds the same all-reduced value, bit for bit.
    assert all(r[f"lml_{case}"] == lml and r[f"ess_{case}"] == est for r in ranks)
    t = torch.as_tensor(lw)
    assert _rel(lml, float(logsumexp(t)) - math.log(K)) <= 1e-6  # rtol 1e-6: the dense port
    assert _rel(est, float(ess(t))) <= 1e-6 * est  # rtol 1e-6
    j_lml, j_ess = (float(v) for v in jax_sharded[0](jnp.asarray(lw)))
    assert _rel(lml, j_lml) <= 1e-6  # rtol 1e-6: JAX's sharded_lml
    assert abs(est - j_ess) <= 1e-6 * j_ess  # rtol 1e-6


def test_a_rank_whose_weights_are_all_minus_inf_adds_nothing(ranks):
    """Rank 1's block is all `-inf` (its K1 pair is `-inf` and a NaN ESS,
    R2); the sums skip it, so LML and ESS are finite and those of the
    three live blocks."""
    live = torch.as_tensor(np.concatenate([INPUTS["dead"][:PER], INPUTS["dead"][2 * PER :]]))
    lml, est = ranks[0]["lml_dead"], ranks[0]["ess_dead"]
    assert math.isfinite(lml) and math.isfinite(est)
    assert _rel(lml, float(logsumexp(live)) - math.log(K)) <= 1e-6  # rtol 1e-6
    assert abs(est - float(ess(live))) <= 1e-6 * est  # rtol 1e-6


def test_all_minus_inf_gives_the_dense_ports_values_where_jax_sharded_gives_nan(ranks, jax_sharded):
    """Every block `-inf`: the port's LML is `-inf`, as the dense
    `logsumexp` gives, and its ESS NaN (R2). JAX's `sharded_lml` gives NaN
    there (`exp(-inf - -inf)`), recorded as R10."""
    assert ranks[0]["lml_all_dead"] == -math.inf and math.isnan(ranks[0]["ess_all_dead"])
    j_lml, j_ess = (float(v) for v in jax_sharded[0](jnp.asarray(INPUTS["all_dead"])))
    assert math.isnan(j_lml) and math.isnan(j_ess)


def test_ancestors_equal_the_dense_resampler_bit_for_bit(ranks):
    dense = systematic_resample(_gen(SEED + 1), torch.as_tensor(INPUTS["lw"]), K).numpy()
    assert np.array_equal(np.concatenate([r["anc"] for r in ranks]), dense)  # bit for bit


def test_slot_ancestors_against_jax_fed_its_own_uniform(jax_sharded):
    """The deterministic entry fed JAX's `u0`: the float64 cdf against
    JAX's float32 one differs at floor ties only (ROADMAP section 3)."""
    lw = INPUTS["lw"]
    key = jax.random.key(3)
    j_anc = np.asarray(jax_sharded[1](key, jnp.asarray(lw)))
    u0 = torch.tensor(float(jax.random.uniform(key, (), dtype=jnp.float32)))
    port = np.concatenate([systematic_slot_ancestors(u0, torch.as_tensor(lw), r * PER, (r + 1) * PER).numpy()
                           for r in range(WORLD)])
    assert np.mean(port != j_anc) <= 1e-3  # the recorded tie rate
    assert np.max(np.abs(port.astype(np.int64) - j_anc)) <= 1  # each tie one ancestor off


def _blocks():
    X = torch.as_tensor(np.random.default_rng(SEED).standard_normal((PER, 3)).astype(np.float32))
    target = Target(certify.wide, (X,), ChoiceMap.kw(y=0.5))
    return [target.importance(g, ChoiceMap.empty(), n=PER)[0] for g in fork(_gen(SEED + 2), WORLD)]


@pytest.mark.parametrize("case,weights,u_seed", [("near", "lw", SEED + 3), ("far", "far", SEED + 4)])
def test_the_exchange_equals_the_stitched_take_rows(ranks, case, weights, u_seed):
    """At healthy ESS the rows ride the neighbour exchange; with all the
    mass on particle 0, ranks 2 and 3 reach past their neighbours and the
    rows are all-gathered. Both equal the dense `take_rows` of the
    stitched blocks, bit for bit; the shared argument is never moved."""
    stitched = certify.stitch(_blocks())
    anc = systematic_resample(_gen(u_seed), torch.as_tensor(INPUTS[weights]), K)
    want = certify.blocks_of(take_rows(stitched, anc), WORLD)
    for r in range(WORLD):
        assert _same(ranks[r][f"exchange_{case}"], certify.leaves_np(want[r]))  # bit for bit
        assert ranks[r][f"exchange_{case}_shared_kept"]
        stats = ranks[r][f"stats_exchange_{case}"]["particles"]
        assert stats["all_reduce"]["calls"] == 1  # n_far
        if case == "near":
            assert stats["exchange"]["calls"] == 1 and stats["all_gather"] == {"calls": 1, "bytes": 4 * K}
        else:
            # The weights, then one gather per dtype of the rows (float32, bool).
            assert stats["exchange"]["calls"] == 0 and stats["all_gather"]["calls"] == 3


def test_sharded_smc_rounds_equal_the_stitched_dense_run(ranks):
    """init, extend, maybe_resample (ess_threshold 2: it always fires) and
    rejuvenate, three rounds: every rank's weights and particles equal the
    stitched dense run's block bit for bit; the LML within 1e-6 of its
    logsumexp and within 5 SE of log N(1; 0, sqrt 2)."""
    ref = certify.StitchedSMC(K, WORLD, ess_threshold=2.0)
    rng = _gen(SEED + 5)
    for i in range(3):
        blocks = ref.init(rng, Target(certify.conjugate, (), ChoiceMap.empty()))
        blocks = ref.extend(rng, blocks, ChoiceMap.kw(y=1.0))
        lml = float(ref.lml(blocks))
        weights = [b.get_log_weights().numpy() for b in blocks]
        blocks = ref.rejuvenate(rng, ref.maybe_resample(rng, blocks), Regenerate(Selection.at["x"]))
        for r in range(WORLD):
            got = ranks[r]["rounds"][i]
            assert np.array_equal(got["weights"], weights[r])  # bit for bit
            assert _same(got["x"], certify.leaves_np(blocks[r].get_particles()))  # bit for bit
            assert np.array_equal(got["after"], blocks[r].get_log_weights().numpy())  # bit for bit
        got = ranks[0]["rounds"][i]
        assert _rel(got["lml"], lml) <= 1e-6  # rtol 1e-6
        se = math.sqrt(max(K / got["ess"] - 1.0, 0.0) / K)  # the delta method's SE of log Z-hat
        assert abs(got["lml"] - certify.EXACT_LML) < 5 * se  # 5 SE


def test_the_collectives_record_matches_what_jax_pins_in_hlo(ranks):
    """LML and ESS are scalar all-reduces only; a resample at healthy ESS
    gathers the K weights and exchanges two neighbour blocks, no row
    all-gather; extend and rejuvenation use no collective."""
    for r in ranks:
        red = r["stats_reductions"]["particles"]
        # 3 cases x (LML, ESS) x (a max of one float32, a sum of two float64).
        assert red["all_reduce"] == {"calls": 12, "bytes": 6 * 4 + 6 * 16}
        assert all(red[k]["calls"] == 0 for k in ("all_gather", "exchange", "broadcast", "staged"))
        for rnd in r["rounds"]:
            res = rnd["stats_resample"]["particles"]
            assert res["all_reduce"]["calls"] == 3  # the gate's max and sum, then n_far
            assert res["all_gather"] == {"calls": 1, "bytes": 4 * K}
            row_bytes = sum(v.nbytes for v in rnd["x"] if v.shape[:1] == (PER,))
            assert res["exchange"] == {"calls": 1, "bytes": 2 * row_bytes}
            assert rnd["stats_extend"] == {} and rnd["stats_rejuvenate"] == {}


def test_shard_leading_axis_reads_the_record(ranks):
    """A shared argument with exactly K rows stays whole (JAX's
    `test_data_rows_equal_particle_count` case); per-particle leaves and a
    bare (K,) tensor split by rank; a 0-d tensor stays whole."""
    X = torch.as_tensor(np.random.default_rng(SEED).standard_normal((K, 3)).astype(np.float32))
    full, _ = Target(certify.wide, (X,), ChoiceMap.kw(y=0.5)).importance(_gen(SEED + 9), ChoiceMap.empty(), n=K)
    for r, res in enumerate(ranks):
        assert _same(res["shard"]["leaves"], certify.leaves_np(certify.blocks_of(full, WORLD)[r]))  # bit for bit
        assert res["shard"]["shared_kept"] and res["shard"]["scalar_kept"]
        assert np.array_equal(res["shard"]["rows"], np.arange(r * PER, (r + 1) * PER))


def test_sharded_mh_chains_equal_the_dense_run_from_each_fork(ranks):
    """MALA on the shared-argument layout (JAX's
    `test_sharded_mh_chains_with_shared_args`): each rank's chains equal
    `run_chains` on its block from its fork, bit for bit; the design
    matrix stays one shared copy; no collective runs."""
    Xc = torch.as_tensor(np.random.default_rng(SEED + 6).standard_normal((32, 3)).astype(np.float32))
    ys = torch.zeros(32)
    inits = [certify.regression.importance(g, ChoiceMap.kw(ys=ys), (Xc,), n=16)[0] for g in fork(_gen(SEED + 7), WORLD)]
    for r, (g, tr) in enumerate(zip(fork(_gen(SEED + 8), WORLD), inits)):
        finals, accs = run_chains(g, share_chain_args(tr, (Xc,)), MALA(Selection.at["w"], 1e-2), 5)
        got = ranks[r]["chains"]
        assert np.array_equal(got["w"], finals.get_choices()["w"].numpy())  # bit for bit
        assert np.array_equal(got["accs"], accs.numpy()) and got["accs"].shape == (16, 5)
        assert np.array_equal(got["score"], finals.get_score().numpy())  # bit for bit
        assert got["shared_kept"] and got["stats"] == {}


def test_a_spawned_rank_imports_neither_jax_nor_the_jax_package(ranks):
    """The rank bodies live in the port; a rank never imports a test
    module, jax or `genjax_tpu`."""
    assert all(r["foreign_modules"] == [] for r in ranks)
