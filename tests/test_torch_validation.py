"""SBC and Geweke (`inference/validation.py`) in the port, on the CPU.

Deterministic, against JAX: the default summaries of a chain batch (every
selected numeric value, with and without squares, against JAX's `vmap`
of its summary function; exact), and `SBCResult.histogram` and
`uniformity` on the same ranks (the chi-square statistic and p-value
within 1e-5 relative).

Statistical, after `tests/inference/test_validation.py`, both ways: a
correct kernel passes comfortably (SBC p > 1e-3; Geweke |z| < 5) and a
planted bug fails decisively (p < 1e-8; |z| > 10), with the JAX test's
thresholds; the identity kernel passes SBC (it is invariant); a
non-stationary walk keeps Geweke's z finite.
"""

import jax
import jax.numpy as jnp
import jax.random as jrand
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.inference import validation as jv
from genjax_tpu_torch import convert
from genjax_tpu_torch.inference import validation as tv

torch.set_num_threads(1)


@tgx.gen
def nn_model():
    mu = tgx.normal(0.0, 1.0) @ "mu"
    _ = tgx.normal(mu, 1.0) @ "y"


@jgx.gen
def jax_nn_model():
    mu = jgx.normal(0.0, 1.0) @ "mu"
    _ = jgx.normal(mu, 1.0) @ "y"


@tgx.gen
def vec_model():
    mu = tgx.normal(0.0, 1.0) @ "mu"
    v = tgx.mv_normal_diag(torch.zeros(3), torch.ones(3)) @ "v"
    flag = tgx.flip(0.5) @ "b"
    _ = tgx.normal(mu + v.sum(-1), 1.0) @ "y"


@jgx.gen
def jax_vec_model():
    mu = jgx.normal(0.0, 1.0) @ "mu"
    v = jgx.mv_normal_diag(jnp.zeros(3), jnp.ones(3)) @ "v"
    flag = jgx.flip(0.5) @ "b"
    _ = jgx.normal(mu + v.sum(-1), 1.0) @ "y"


LATENTS = tgx.Selection.at["mu"]


@pytest.mark.parametrize("with_squares", [False, True])
def test_default_summaries_match_jax(with_squares):
    rng = np.random.default_rng(0)
    c = 12
    vals = {
        "mu": rng.standard_normal(c).astype(np.float32),
        "v": rng.standard_normal((c, 3)).astype(np.float32),
        "b": rng.random(c) < 0.5,
        "y": rng.standard_normal(c).astype(np.float32),
    }
    jtrs = jax.vmap(
        lambda *xs: jax_vec_model.importance(jrand.key(0), jgx.ChoiceMap.d(dict(zip(vals, xs))), ())[0]
    )(*(jnp.asarray(v) for v in vals.values()))
    ttrs = convert.chain_batch(vec_model, (), vals, device="cpu")
    for jsel, tsel in (
        (jgx.Selection.all(), tgx.Selection.all()),
        (jgx.Selection.at["mu"] | jgx.Selection.at["v"], tgx.Selection.at["mu"] | tgx.Selection.at["v"]),
    ):
        ref = jax.vmap(jv._flat_summaries(jsel, with_squares))(jtrs)
        got = tv._flat_summaries(tsel, with_squares)(ttrs)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_histogram_and_uniformity_match_jax():
    ranks = np.random.default_rng(1).integers(0, 31, size=(200, 3)).astype(np.int32)
    ref = jv.SBCResult(ranks=jnp.asarray(ranks), n_draws=30)
    got = tv.SBCResult(ranks=torch.from_numpy(ranks), n_draws=30)
    for n_bins in (None, 7):
        np.testing.assert_array_equal(got.histogram(n_bins).numpy(), np.asarray(ref.histogram(n_bins)))
        for g, r in zip(got.uniformity(n_bins), ref.uniformity(n_bins)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="n_bins"):
        got.uniformity(n_bins=100)


def _always_accept(update_fn):
    """A kernel that sets `mu` to `update_fn(rng, trace)` on every chain
    with no MH correction: the planted-bug kit."""

    def kernel(rng, tr):
        new_mu = update_fn(rng, tr)
        new_tr, _, _, _ = tgx.Update(tgx.ChoiceMap.kw(mu=tgx.per_particle(new_mu))).edit(
            rng, tr, tgx.Diff.no_change(tr.get_args())
        )
        return new_tr

    return kernel


def _noise(rng, tr):
    return torch.randn(tr.get_choices()["mu"].shape, generator=rng)


def test_sbc_correct_kernel_ranks_uniform():
    res = tv.sbc(torch.Generator().manual_seed(0), nn_model, (), LATENTS, tgx.Regenerate(LATENTS),
                 n_replicates=512, n_draws=19, thin=3)
    assert res.ranks.shape == (512, 1)
    assert int(res.ranks.min()) >= 0 and int(res.ranks.max()) <= 19
    stat, p = res.uniformity()
    assert float(p[0]) > 1e-3, (float(stat[0]), float(p[0]))


def test_sbc_correct_gradient_kernel_and_custom_summaries():
    res = tv.sbc(
        torch.Generator().manual_seed(4), nn_model, (), LATENTS, tgx.HMC(LATENTS, 0.4, L=4),
        n_replicates=512, n_draws=19, thin=2,
        summaries=lambda tr: torch.stack([tr.get_choices()["mu"], tr.get_choices()["mu"] ** 2], -1),
    )
    assert res.ranks.shape == (512, 2)
    _, p = res.uniformity()
    assert bool((p > 1e-3).all()), p


def test_sbc_wrong_posterior_fails():
    # Independence draws around y (the true conditional mean is y / 2).
    bad = _always_accept(lambda r, tr: tr.get_choices()["y"] + 0.3 * _noise(r, tr))
    res = tv.sbc(torch.Generator().manual_seed(2), nn_model, (), LATENTS, bad, n_replicates=512, n_draws=19)
    _, p = res.uniformity()
    assert float(p[0]) < 1e-8


def test_sbc_identity_kernel_is_invariant_so_passes():
    res = tv.sbc(torch.Generator().manual_seed(3), nn_model, (), LATENTS, lambda r, tr: tr,
                 n_replicates=512, n_draws=19)
    _, p = res.uniformity()
    assert float(p[0]) > 1e-3


def test_geweke_correct_kernel_passes():
    res = tv.geweke(torch.Generator().manual_seed(1), nn_model, (), LATENTS, tgx.Regenerate(LATENTS),
                    n_forward=4096, n_steps=256, n_chains=8)
    assert res.z_scores.shape == (4,)  # (mu, y) and their squares
    assert float(res.max_abs_z()) < 5.0, res.z_scores


def test_geweke_wrong_conditional_fails():
    bad = _always_accept(lambda r, tr: tr.get_choices()["y"] / 2.0 + 0.1 * _noise(r, tr))
    res = tv.geweke(torch.Generator().manual_seed(1), nn_model, (), LATENTS, bad,
                    n_forward=4096, n_steps=256, n_chains=8)
    assert float(res.max_abs_z()) > 10.0, res.z_scores


def test_geweke_ess_guards_nonstationary_chain():
    bad = _always_accept(lambda r, tr: tr.get_choices()["mu"] + 0.5 * _noise(r, tr))
    res = tv.geweke(torch.Generator().manual_seed(5), nn_model, (), LATENTS, bad,
                    n_forward=1024, n_steps=256, n_chains=8)
    assert bool(torch.isfinite(res.z_scores).all())
    assert float(res.mean_chain[2]) > 3.0 * float(res.mean_forward[2])
