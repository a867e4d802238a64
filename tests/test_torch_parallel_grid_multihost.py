"""The port's 2-D grid and multi-host layer (`genjax_tpu_torch.parallel`:
`grid.py`, `multihost.py`) and `entry.dryrun_multichip`, on four gloo
ranks of the CPU, against the stitched dense port run and against
`genjax_tpu.parallel` on four devices of the virtual CPU mesh.

After JAX's `tests/parallel/test_grid.py`, `test_multihost.py`,
`test_hlo_island_collectives.py` and `test_multiprocess.py`. One pool of
four ranks on a 2 x 2 mesh runs the cases
(`parallel/certify.py::grid_rank_body`) with `LOCAL_WORLD_SIZE=2`, so
`hybrid_mesh` sees two nodes of two ranks, as JAX's two-process test has
two processes. Tolerances, beside each assertion: bit for bit where the
arithmetic is the dense port's (the grid's particles and weights after a
resample and a move, the chains left alone); 1e-6 relative for the
all-reduced per-chain LML and ESS against one logsumexp and against
JAX's; 1e-5 absolute for the island run against the single-process run,
as JAX's two-process test holds it; JAX's ancestors within its float32
tie rate; estimates within 5 standard errors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_tpu.inference.smc import ParticleCollection as JParticleCollection
from genjax_tpu.parallel import GridSMC as JGridSMC
from genjax_tpu.parallel import grid_mesh as j_grid_mesh
from genjax_tpu.parallel import pooled_lml as j_pooled_lml
from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.requests import Regenerate
from genjax_tpu_torch.entry import dryrun_multichip
from genjax_tpu_torch.inference.smc import ess
from genjax_tpu_torch.inference.sp import Target
from genjax_tpu_torch.ops import logsumexp
from genjax_tpu_torch.parallel import certify, initialize_multihost, pooled_lml
from genjax_tpu_torch.parallel.launch import launch
from genjax_tpu_torch.parallel.smc import systematic_slot_ancestors

WORLD, SEED = 4, 21
C_, K = 4, 512
TARGET = Target(certify.conjugate, (), ChoiceMap.kw(y=1.0))


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def ranks():
    return launch(certify.grid_rank_body, WORLD, timeout=120, args=(SEED,), env={"LOCAL_WORLD_SIZE": "2"})


def _coords(r: int) -> tuple[int, int]:
    return r // 2, r % 2


def _collection(lw):
    """A JAX collection that carries only the weights the reductions read
    (a real `ParticleCollection`, so JAX's runtime type checks pass)."""
    return JParticleCollection(particles=None, log_weights=lw, is_valid=jnp.array(True))


def test_per_chain_lml_and_ess_match_the_dense_port_and_jax(ranks):
    lw = certify.grid_inputs(SEED, C_, K)
    jsmc = JGridSMC(n_chains=C_, n_particles=K, mesh=j_grid_mesh(2, 2))
    j_lml, j_ess = (np.asarray(v) for v in jax.jit(
        lambda w: (jsmc.per_chain_lml(_collection(w)), jsmc.per_chain_ess(_collection(w))))(jnp.asarray(lw)))
    for r, res in enumerate(ranks):
        c, _ = _coords(r)
        for j in range(2):
            row = torch.as_tensor(lw[2 * c + j])
            dense_lml, dense_ess = float(logsumexp(row)) - math.log(K), float(ess(row))
            assert abs(res["lml"][j] - dense_lml) <= 1e-6 * max(1.0, abs(dense_lml))  # rtol 1e-6
            assert abs(res["ess"][j] - dense_ess) <= 1e-6 * dense_ess  # rtol 1e-6
            assert abs(res["lml"][j] - j_lml[2 * c + j]) <= 1e-6 * max(1.0, abs(dense_lml))  # rtol 1e-6: JAX
            assert abs(res["ess"][j] - j_ess[2 * c + j]) <= 1e-6 * dense_ess  # rtol 1e-6
        # Only the particle group carries anything, and only scalars.
        stats = res["stats_reductions"]
        assert set(stats) == {"particles"} and stats["particles"]["all_reduce"]["calls"] == 4
        assert stats["particles"]["all_reduce"]["bytes"] == 2 * (2 * 4 + 2 * 2 * 8)


def test_per_chain_ancestors_against_jax_fed_its_uniforms():
    """Each chain's slots from JAX's own per-chain uniform (one key per
    chain), the port's float64 cdf against JAX's float32 one: ties only."""
    lw = certify.grid_inputs(SEED, C_, K)
    jsmc = JGridSMC(n_chains=C_, n_particles=K, mesh=j_grid_mesh(2, 2))
    key = jax.random.key(3)
    j_anc = np.asarray(jax.jit(jsmc._per_chain_ancestors)(key, jnp.asarray(lw)))
    u0 = torch.tensor([float(jax.random.uniform(k, (), dtype=jnp.float32)) for k in jax.random.split(key, C_)])
    lw_t = torch.as_tensor(lw)
    lse = torch.stack([logsumexp(row) for row in lw_t])
    port = np.concatenate([systematic_slot_ancestors(u0, lw_t, p * 256, (p + 1) * 256, lse).numpy()
                           for p in range(2)], axis=1)
    assert np.mean(port != j_anc) <= 1e-3  # the recorded tie rate
    assert np.max(np.abs(port - j_anc)) <= 1  # each tie one ancestor off


def test_a_grid_round_equals_the_stitched_dense_run(ranks):
    """init, per-chain LML, resample (one uniform per chain), rejuvenate:
    every rank's particles and weights equal the stitched dense run's,
    bit for bit; the chain group carries nothing."""
    ref = certify.StitchedGrid(C_, K, 2, 2)
    rng = _gen(SEED + 1)
    blocks = ref.init(rng, TARGET)
    lmls = ref.per_chain_lml(blocks).numpy()
    u0 = torch.rand(C_, generator=rng)
    blocks = ref.rejuvenate(rng, ref.resample(u0, blocks), Regenerate(Selection.at["x"]))
    for r, res in enumerate(ranks):
        c, p = _coords(r)
        assert np.allclose(res["round_lml"], lmls[2 * c : 2 * c + 2], rtol=0, atol=1e-5)  # atol 1e-5
        assert all(abs(v - certify.EXACT_LML) < 5 * certify.LML_SD / math.sqrt(K) for v in res["round_lml"])  # 5 SE
        want = blocks[(c, p)]
        got = res["round"]
        leaves = certify.leaves_np(want.get_particles())
        assert all(np.array_equal(a, b) for a, b in zip(got["x"], leaves))  # bit for bit
        assert np.array_equal(got["lw"], want.get_log_weights().numpy())  # bit for bit
        assert set(res["stats_resample"]) == {"particles"}
        assert res["stats_resample"]["particles"]["all_gather"] == {"calls": 1, "bytes": 2 * K * 4}


def test_maybe_resample_is_per_chain(ranks):
    """Chain 1 (on the ranks of chain coordinate 0) degenerate: only it
    resamples, onto its dominant particle; every other chain is left as it
    was, bit for bit (JAX's `test_maybe_resample_is_per_chain`)."""
    dominant = ranks[0]["degenerate"]["x_before"][1, 0]
    for r, res in enumerate(ranks):
        c, _ = _coords(r)
        d = res["degenerate"]
        keep = [0] if c == 0 else [0, 1]
        for j in keep:
            assert np.array_equal(d["x_after"][j], d["x_before"][j])  # bit for bit
            assert np.array_equal(d["lw_after"][j], d["lw_before"][j])
        if c == 0:
            assert np.all(d["x_after"][1] == dominant)
            assert np.all(d["lw_after"][1] == d["lw_after"][1, 0])


def test_maybe_resample_on_one_particle_rank_reuses_the_gates_lse(tmp_path, monkeypatch):
    """On a 1 x 1 mesh (a one-rank gloo group in this process) the rows the
    resample reads are the gate's: its K1 pairs give their lse, and no
    second reduction runs per chain. Every chain resampled (threshold 2)
    equals the stitched dense resample, bit for bit."""
    import torch.distributed as dist

    from genjax_tpu_torch.parallel import GridSMC, grid_mesh
    from genjax_tpu_torch.parallel import grid as grid_module

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        grid = GridSMC(n_chains=C_, n_particles=K, mesh=grid_mesh(1, 1, device_type="cpu"), ess_threshold=2.0)
        ref = certify.StitchedGrid(C_, K, 1, 1)
        rng, rng_ref = _gen(SEED + 3), _gen(SEED + 3)
        col, blocks = grid.init(rng, TARGET), ref.init(rng_ref, TARGET)
        calls = []
        monkeypatch.setattr(grid_module, "logsumexp", lambda x: calls.append(x) or logsumexp(x))
        got = grid.maybe_resample(rng, col)
    finally:
        dist.destroy_process_group()
    want = ref.resample(torch.rand(C_, generator=rng_ref), blocks)[(0, 0)]
    assert not calls  # the gate's lse, reused
    assert np.array_equal(got.get_log_weights().numpy(), want.get_log_weights().numpy())  # bit for bit
    assert all(np.array_equal(a, b) for a, b in zip(certify.leaves_np(got.get_particles()),
                                                    certify.leaves_np(want.get_particles())))  # bit for bit


def test_a_shared_design_matrix_with_k_rows_stays_whole(ranks):
    """JAX's `test_data_rows_equal_particle_count` and
    `test_full_round_with_shared_args`: a design matrix with as many rows as
    a chain's particles is one shared copy through init, resample and a
    move, and every cell's score is its choices' joint density."""
    X = torch.as_tensor(np.random.default_rng(SEED + 2).standard_normal((16, 3)).astype(np.float32))
    ys = torch.zeros(16)
    for res in ranks:
        sh = res["shared"]
        assert sh["kept_after_init"] and sh["kept_after_moves"] and sh["shape"] == (16, 3)
        for w, score in zip(sh["w"], sh["score"]):
            want, _ = certify.regression.assess(ChoiceMap.kw(w=torch.as_tensor(w), ys=ys), (X,))
            assert abs(float(want) - score) <= 1e-4 * max(1.0, abs(score))  # 1e-4, JAX's atol


def test_hybrid_mesh_over_two_nodes_and_its_errors(ranks):
    for res in ranks:
        assert res["initialized"] is True
        assert res["hybrid_default"] == {"islands": 2, "particles": 2}
        assert res["hybrid_4x1"] == {"islands": 4, "particles": 1}
        err = res["hybrid_errors"]
        assert "multiple of the node count" in err["fewer_islands"]
        assert "must divide the local rank count" in err["not_dividing"]
        assert "inconsistent" in err["inconsistent"]


def test_initialize_multihost_contract():
    """Single process: a no-op query that reports False; a lone process_id
    is a launcher bug and raises (JAX's contract)."""
    assert initialize_multihost() is False
    with pytest.raises(ValueError, match="process_id was given without"):
        initialize_multihost(process_id=0)


def test_pooled_lml_is_the_density_mean_like_jax():
    lmls = [-1.0, -2.0, -3.0]
    want = math.log(sum(math.exp(v) for v in lmls) / 3)
    got = float(pooled_lml(torch.tensor(lmls)))
    assert abs(got - want) <= 1e-6 and abs(got - float(j_pooled_lml(jnp.asarray(lmls)))) <= 1e-6  # atol 1e-6


def test_island_run_equals_the_single_process_run(ranks):
    """Two islands of 2048 particles over two "nodes": per-island LMLs and
    the pooled LML within 1e-5 of the single-process stitched run from the
    same generator (JAX's two-process bound), the pooled one within 6 SE of
    the oracle (JAX's bound); the island axis carries n scalars, once."""
    ref = certify.StitchedGrid(2, 2048, 2, 2)
    lmls = ref.per_chain_lml(ref.init(_gen(SEED + 3), TARGET))
    pooled = float(pooled_lml(lmls))
    for r, res in enumerate(ranks):
        isl = res["islands"]
        assert abs(float(isl["lml"][0]) - float(lmls[r // 2])) <= 1e-5  # atol 1e-5
        assert abs(isl["pooled"] - pooled) <= 1e-5  # atol 1e-5
        assert abs(isl["pooled"] - certify.EXACT_LML) <= 6 * certify.LML_SD / math.sqrt(4096)
        assert isl["stats"]["islands"]["all_gather"] == {"calls": 1, "bytes": 8}
        assert sum(v["calls"] for v in isl["stats"]["islands"].values()) == 1
        assert isl["stats"]["particles"]["exchange"]["calls"] == 0


def test_dtensor_round_trip(ranks):
    """Rows split over the islands, replicated over the particles: the
    global shape is (8, 2), and each rank's rows come back as numpy."""
    for res in ranks:
        assert res["dtensor"]["shape"] == (8, 2)
        assert np.array_equal(res["dtensor"]["back"], res["dtensor"]["local"])


def test_dryrun_multichip_certifies_every_driver_on_four_cpu_ranks():
    """The entry point itself on four gloo ranks (it raises on any failed
    check): every section runs, and the resample at healthy ESS moves the
    weights and the neighbour blocks only; the warmups over the chain axis
    reduce on "chains" and data-sharded HMC on "data", all-reduces only,
    and the warmups equal the stitched dense ones bit for bit."""
    results = dryrun_multichip(WORLD, device="cpu", timeout=120)
    assert [r["rank"] for r in results] == list(range(WORLD))
    for r in results:
        sections = {"smc", "degenerate_resample", "far_fallback", "chains", "grid", "islands", "svgd", "pt",
                    "warmup", "chees", "data_hmc"}
        assert set(r["stats"]) == sections
        for name, axis in (("warmup", "chains"), ("chees", "chains"), ("data_hmc", "data")):
            assert set(r["stats"][name]) == {axis}
            assert {k for k, v in r["stats"][name][axis].items() if v["calls"]} == {"all_reduce"}
        assert r["bitwise"] == {"warmup": True, "chees": True}
        smc = r["stats"]["smc"]["particles"]
        assert smc["exchange"]["calls"] == 1 and smc["all_gather"] == {"calls": 1, "bytes": 4 * 32768 * WORLD}
        assert r["stats"]["degenerate_resample"]["particles"]["all_gather"]["calls"] == 2  # the far path
        assert r["stats"]["chains"] == {}
        assert abs(r["lml"] - certify.EXACT_LML) <= 6 * certify.LML_SD / math.sqrt(32768 * WORLD)
