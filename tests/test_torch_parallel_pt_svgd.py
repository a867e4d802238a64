"""The port's sharded parallel tempering and SVGD
(`genjax_tpu_torch.parallel`: `pt.py`, `svgd.py`) on four gloo ranks of
the CPU, against the stitched dense port run, the conjugate closed forms
and `genjax_tpu.parallel.svgd` on four devices of the virtual CPU mesh.

After JAX's `tests/parallel/test_sharded_pt.py` and
`test_sharded_svgd.py`. One pool of four ranks runs every case
(`parallel/certify.py::pt_svgd_rank_body`). Tolerances, beside each
assertion: bit for bit for PT against the stitched dense run (the same
moves on the same streams, the same exchange); 1e-6 of max |x| for SVGD
with an explicit bandwidth against the dense transport (the kernel block
`(N/n, N)` is one matmul of another shape than the dense `(N, N)`); 1e-5
of max |phi| for the Stein direction against JAX's on the same inputs;
posteriors at 5 standard errors or JAX's own bounds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from genjax_tpu.parallel import sharded_stein_direction as j_sharded_stein_direction
from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.inference.sp import Target
from genjax_tpu_torch.parallel import certify
from genjax_tpu_torch.parallel.launch import launch

WORLD, SEED = 4, 5
T, SWEEPS = 8, 40


@pytest.fixture(scope="module")
def ranks():
    return launch(certify.pt_svgd_rank_body, WORLD, timeout=120, args=(SEED,))


def test_sharded_pt_equals_the_stitched_dense_run(ranks):
    """The permutation, the cold chain's statistic, the swap rates and every
    replica's state equal the stitched dense run's, bit for bit."""
    target = Target(certify.wide_pt, (torch.zeros(8),), ChoiceMap.kw(y=1.0))
    traces, res = certify.stitched_pt(torch.Generator().manual_seed(SEED), certify.pt_ladder("cpu"), target, SWEEPS,
                                      WORLD, collect=lambda t: t.get_choices()["w"].sum(-1))
    for r, got in enumerate(ranks):
        pt = got["pt"]
        assert np.array_equal(pt["perm"], res.perm.numpy())  # bit for bit
        assert np.array_equal(pt["collected"], res.collected.numpy()) and pt["collected"].shape == (SWEEPS,)
        assert np.array_equal(pt["swap_rates"], res.swap_rates.numpy())
        assert np.array_equal(pt["logliks"], res.logliks.numpy()[r * 2 : (r + 1) * 2])
        assert np.array_equal(pt["w"], traces[r].get_choices()["w"].numpy())


def test_replica_state_never_crosses_ranks(ranks):
    """Per sweep, one all-gather of the T log likelihoods and one of the
    T collected statistics, nothing else (JAX pins the same in HLO)."""
    for got in ranks:
        stats = got["pt"]["stats"]
        assert set(stats) == {"replicas"}
        assert stats["replicas"]["all_gather"] == {"calls": 2 * SWEEPS, "bytes": 2 * SWEEPS * T * 4}
        assert all(v["calls"] == 0 for k, v in stats["replicas"].items() if k != "all_gather")


def test_sharded_pt_recovers_the_conjugate_posterior(ranks):
    """1000 sweeps of the ladder (1, 0.6, 0.3, 0.1) x 2 (JAX runs 3000),
    200 burned: the cold chain's mean within 5 batch-means SE of 0.5, its
    variance within 0.15 of 0.5 (JAX's bound)."""
    samples = ranks[0]["pt_posterior"][200:].astype(np.float64)
    assert all(np.array_equal(r["pt_posterior"], ranks[0]["pt_posterior"]) for r in ranks)
    batches = samples.reshape(50, -1).mean(1)
    se = batches.std(ddof=1) / math.sqrt(len(batches))
    assert abs(samples.mean() - 0.5) < 5 * se  # 5 SE
    assert abs(samples.var() - 0.5) < 0.15


def test_uneven_replica_count_is_refused(ranks):
    assert "must divide evenly" in ranks[0]["pt_uneven"]


def test_stein_direction_matches_jax(ranks):
    """The same positions and gradients, an explicit bandwidth and the
    median heuristic (the ranks' bandwidths averaged): within 1e-5 of max
    |phi| of JAX's `sharded_stein_direction` under `shard_map`."""
    x, g = certify.stein_inputs(SEED)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("particles",))

    def j_phi(bandwidth):
        fn = shard_map(lambda a, b: j_sharded_stein_direction(a, b, "particles", x.shape[0], bandwidth), mesh=mesh,
                       in_specs=(P("particles"), P("particles")), out_specs=P("particles"))
        return np.asarray(jax.jit(fn)(jnp.asarray(x), jnp.asarray(g)))

    for key, bandwidth in (("h1", 1.0), ("median", None)):
        want = j_phi(bandwidth)
        got = np.concatenate([r["stein"][key] for r in ranks])
        assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))  # 1e-5 of max |phi|


def test_sharded_svgd_equals_the_dense_transport(ranks):
    """An explicit bandwidth: the particles within 1e-6 of max |x| of the
    dense transport of the same starting particles; two all-gathers per
    step and one all-reduce of the diagnostic at the end."""
    y = torch.tensor(certify.SVGD_Y)
    x = certify.stitched_svgd(torch.Generator().manual_seed(SEED + 2), certify.vector_model, (y,), ChoiceMap.kw(y=y),
                              Selection.at["w"], 64, 50, WORLD, 0.2, 1.0).numpy()
    got = np.concatenate([r["svgd"]["w"] for r in ranks])
    assert np.max(np.abs(got - x)) <= 1e-6 * np.max(np.abs(x))  # 1e-6 of max |x|
    for r in ranks:
        stats = r["svgd"]["stats"]["particles"]
        assert stats["all_gather"] == {"calls": 100, "bytes": 2 * 50 * 64 * 4 * 4}
        assert stats["all_reduce"]["calls"] == 1 and stats["exchange"]["calls"] == 0
        assert r["svgd"]["norms"].shape == (50,) and np.array_equal(r["svgd"]["norms"], ranks[0]["svgd"]["norms"])


def test_sharded_svgd_with_the_median_heuristic_recovers_the_posterior(ranks):
    """256 particles, 400 steps: the mean within 0.05 and the sd within 0.08
    of the conjugate posterior N(4y/5, 1/5) (JAX's bounds)."""
    ws = np.concatenate([r["svgd_median"] for r in ranks])
    post_mean = 0.8 * np.asarray(certify.SVGD_Y)
    assert np.max(np.abs(ws.mean(0) - post_mean)) < 0.05
    assert np.max(np.abs(ws.std(0) - math.sqrt(0.2))) < 0.08


def test_indivisible_particle_count_is_refused(ranks):
    assert "must be divisible" in ranks[0]["svgd_indivisible"]
