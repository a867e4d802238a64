"""The port's particle utilities (`genjax_tpu_torch.inference.smc`,
`core.gather`) against `genjax_tpu`: systematic cumulative counts (and
`systematic_resample` on the CPU as their plain composition), the
resampling row copy, and the LML and ESS of a `ParticleCollection`.
Inputs are made with numpy; JAX's uniform draw `u0` is handed to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp as jax_logsumexp

from genjax_tpu.core.gather import take_rows as jax_take_rows
from genjax_tpu.inference.smc import ParticleCollection as JaxParticleCollection
from genjax_tpu.inference.smc import _blocks_to_ancestors, systematic_cum_counts as jax_cum_counts
from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.gather import take_rows
from genjax_tpu_torch.core.typing import per_particle
from genjax_tpu_torch.inference.smc import (
    ParticleCollection,
    cum_counts_to_ancestors,
    systematic_ancestors_plain,
    systematic_cum_counts,
    systematic_resample,
)
from genjax_tpu_torch.models.beta_bernoulli import beta_bernoulli
from genjax_tpu_torch.ops import fused_systematic_ancestors

torch.set_num_threads(1)

K = 8192


def _log_weights(seed: int, spread: float = 3.0, n: int = K) -> np.ndarray:
    return (spread * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("given_lse", [False, True], ids=["lse_computed", "lse_given"])
@pytest.mark.parametrize("seed,spread,n", [(0, 1.0, K), (1, 3.0, K), (2, 8.0, K), (3, 3.0, 5000)])
def test_systematic_cum_counts_match_jax(seed, spread, n, given_lse):
    lw = _log_weights(seed, spread)
    key = jax.random.key(seed)
    u0 = jax.random.uniform(key, (), dtype=jnp.float32)  # the draw inside JAX's function
    ref = np.asarray(jax_cum_counts(key, jnp.asarray(lw), n))
    # A caller that holds logsumexp(lw) already (the filter, `resample`)
    # hands it over; JAX's own value stands in for it here.
    lse = torch.tensor(np.asarray(jax_logsumexp(jnp.asarray(lw)))) if given_lse else None
    got = systematic_cum_counts(torch.tensor(np.asarray(u0)), torch.from_numpy(lw), n, lse).numpy()
    # Both sides round float32 normalised weights and a cumulative sum, in
    # different orders, so a count whose exact value n * cdf_i - u0 sits
    # within rounding of an integer (a floor tie) may land one apart. Every
    # mismatch must be such a tie (within 0.01 of an integer in float64),
    # off by one, and ties stay rare: at most 2 in 10^3 entries. (Measured
    # over 20 seeds and spreads 1, 3, 8 at K=8192: 2.5e-4 of entries, at
    # most 14 in one vector, with `exp(lw - lse)` divided by its total;
    # 5.0e-4 with `torch.softmax`. float64-exact counts themselves differ
    # from JAX's float32 ones at 3.8e-4, so 1 in 10^4 is out of reach of
    # any float32 implementation.)
    w = np.exp(lw.astype(np.float64) - lw.max())
    exact = n * np.cumsum(w / w.sum()) - float(u0)
    mismatch = np.nonzero(got != ref)[0]
    assert (np.abs(got[mismatch].astype(np.int64) - ref[mismatch]) == 1).all()
    assert (np.abs(exact[mismatch] - np.round(exact[mismatch])) < 0.01).all()
    assert mismatch.size <= 2 * K // 1000


@pytest.mark.parametrize("given_lse", [False, True], ids=["lse_computed", "lse_given"])
@pytest.mark.parametrize("seed,spread,n", [(0, 1.0, K), (1, 3.0, K), (2, 8.0, K), (3, 3.0, 5000)])
def test_systematic_resample_on_the_cpu_is_the_plain_twin(seed, spread, n, given_lse):
    # On CPU log weights `systematic_resample` draws its uniform and maps it
    # with the plain twin, bit for bit the composition of the counts and
    # their ancestors; K2 (the CUDA kernel) is not launched, and the call
    # is counted.
    lw = torch.from_numpy(_log_weights(seed, spread))
    lse = torch.logsumexp(lw, 0) if given_lse else None
    launches, calls = fused_systematic_ancestors.launches, systematic_resample.calls
    got = systematic_resample(torch.Generator().manual_seed(seed), lw, n, lse)
    u0 = torch.rand((), generator=torch.Generator().manual_seed(seed))
    assert torch.equal(got, cum_counts_to_ancestors(systematic_cum_counts(u0, lw, n, lse), n))
    assert torch.equal(got, systematic_ancestors_plain(u0, lw, n, lse))
    assert fused_systematic_ancestors.launches == launches
    assert systematic_resample.calls == calls + 1


def test_systematic_counts_give_each_particle_floor_or_ceil_of_its_share():
    lw = _log_weights(4, 2.0)
    n = K
    anc = systematic_resample(torch.Generator().manual_seed(0), torch.from_numpy(lw), n)
    counts = np.bincount(anc.numpy(), minlength=K)
    share = n * np.exp(lw - lw.max()) / np.exp(lw - lw.max()).sum()
    assert counts.sum() == n
    assert (counts >= np.floor(share) - 1).all() and (counts <= np.ceil(share) + 1).all()
    assert (np.abs(counts - share) < 1).mean() > 0.999


CUM_CASES = {
    "ends_at_n": np.array([0, 3, 3, 5, 8, 8], dtype=np.int32),
    "ends_below_n": np.array([0, 3, 3, 5, 7, 7], dtype=np.int32),  # f32 cdf ends below 1
    "first_empty": np.array([0, 0, 8, 8, 8, 8], dtype=np.int32),
    "one_owner": np.array([8, 8, 8, 8, 8, 8], dtype=np.int32),
}


@pytest.mark.parametrize("case", sorted(CUM_CASES))
def test_ancestors_of_crafted_counts_match_jax(case):
    cum = CUM_CASES[case]
    ref = np.asarray(_blocks_to_ancestors(jnp.asarray(cum), 8))
    got = cum_counts_to_ancestors(torch.from_numpy(cum.astype(np.int64)), 8).numpy()
    np.testing.assert_array_equal(got, ref)


def test_row_copy_is_bit_exact_against_jax_take_rows():
    rng = np.random.default_rng(5)
    tree = {
        "p": {"value": rng.random(K).astype(np.float32), "score": rng.standard_normal(K).astype(np.float32)},
        "v": {"value": rng.random(K) < 0.5, "count": rng.integers(0, 9, K).astype(np.int32)},
        "z": rng.standard_normal((K, 3)).astype(np.float32),
        "obs": rng.standard_normal(5).astype(np.float32),  # shared: no particle axis
    }
    key = jax.random.key(7)
    cum = jax_cum_counts(key, jnp.asarray(_log_weights(6, 4.0)), K)
    ref = jax_take_rows(
        jax.tree_util.tree_map(jnp.asarray, tree), _blocks_to_ancestors(cum, K), n_rows=K
    )
    anc = cum_counts_to_ancestors(torch.from_numpy(np.asarray(cum).astype(np.int64)), K)
    # The same leaves as a choice map, whose record says that every leaf
    # but the observation carries the particle axis.
    chm = ChoiceMap.d(
        jax.tree_util.tree_map(lambda v: per_particle(torch.from_numpy(v)), {k: v for k, v in tree.items() if k != "obs"})
        | {"obs": torch.from_numpy(tree["obs"])}
    )
    got = take_rows(chm, anc)
    for path, ref_leaf in jax.tree_util.tree_leaves_with_path(ref):
        got_leaf = got[tuple(k.key for k in path)]
        assert got_leaf.numpy().dtype == np.asarray(ref_leaf).dtype
        np.testing.assert_array_equal(got_leaf.numpy(), np.asarray(ref_leaf))
    assert got["obs"] is chm["obs"]


def test_row_copy_of_a_trace_keeps_shared_leaves():
    tr, _ = beta_bernoulli.importance(
        torch.Generator().manual_seed(0), ChoiceMap.d({"v": True}), (2.0, 2.0), n=64
    )
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 64, 64))
    out = take_rows(tr, idx)  # the trace's own record
    np.testing.assert_array_equal(out.get_choices()["p"].numpy(), tr.get_choices()["p"].numpy()[idx.numpy()])
    assert out.get_choices()["v"].shape == () and out.get_args() == (2.0, 2.0)


LW_CASES = {
    "normal": _log_weights(10, 1.0),
    "spread": _log_weights(11, 30.0),
    "some_neg_inf": np.where(np.arange(K) % 3 == 0, -np.inf, _log_weights(12, 2.0)).astype(np.float32),
    "all_neg_inf": np.full(K, -np.inf, dtype=np.float32),
}


@pytest.mark.parametrize("case", sorted(LW_CASES))
def test_lml_and_ess_match_jax(case):
    lw = LW_CASES[case]
    jcol = JaxParticleCollection(jnp.zeros(K), jnp.asarray(lw), jnp.array(True))
    tcol = ParticleCollection(torch.zeros(K), torch.from_numpy(lw))
    ref_lml = float(jcol.get_log_marginal_likelihood_estimate())
    ref_ess = float(jcol.get_ess())
    got_lml = float(tcol.get_log_marginal_likelihood_estimate())
    got_ess = float(tcol.get_ess())
    if case == "all_neg_inf":
        # The LML is -inf on both sides. The ESS is NaN on both sides: the
        # JAX `ess` computes -inf - (-inf) (an open fault of the JAX
        # package), and the port keeps its semantics until both change.
        assert ref_lml == got_lml == -np.inf
        assert np.isnan(ref_ess) and np.isnan(got_ess)
        return
    # Tolerance 1e-5 * max(1, |ref|): one float32 reduction over K terms.
    assert abs(got_lml - ref_lml) <= 1e-5 * max(1.0, abs(ref_lml))
    assert abs(got_ess - ref_ess) <= 1e-5 * max(1.0, abs(ref_ess))


def test_resample_keeps_the_lml_and_equalizes_weights():
    lw = torch.from_numpy(_log_weights(13, 2.0))
    col = ParticleCollection(ChoiceMap.kw(x=per_particle(torch.arange(K, dtype=torch.float32))), lw)
    new = col.resample(torch.Generator().manual_seed(0))
    torch.testing.assert_close(
        new.get_log_marginal_likelihood_estimate(), col.get_log_marginal_likelihood_estimate()
    )
    assert torch.unique(new.get_log_weights()).numel() == 1
    assert bool((new.get_particles()["x"][1:] >= new.get_particles()["x"][:-1]).all())


def test_sample_particle_draws_in_proportion_to_weight():
    w = np.array([0.1, 0.2, 0.3, 0.4])
    col = ParticleCollection(ChoiceMap.kw(i=per_particle(torch.arange(4))), torch.log(torch.tensor(w, dtype=torch.float32)))
    rng = torch.Generator().manual_seed(0)
    n = 8000
    draws = np.array([int(col.sample_particle(rng)["i"]) for _ in range(n)])
    freq = np.bincount(draws, minlength=4) / n
    se = np.sqrt(w * (1 - w) / n)
    assert (np.abs(freq - w) < 5 * se).all()
