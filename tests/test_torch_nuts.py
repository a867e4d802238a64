"""NUTS (`inference/requests/nuts.py`), port against JAX on the CPU.

Deterministic: the port's core, `nuts_draw`, fed the draws that JAX's
`_nuts_draw` makes from each chain's key (the momenta from `k_mom`, each
level's direction, leaf and merge uniforms from `fold_in(k_tree, d)`),
gives JAX's new state, depth, accept statistic and divergence flag, for a
2-D correlated Gaussian (unit and non-unit mass, a step size small enough
to reach the maximum depth and one large enough to diverge) and for a
small logistic regression. Both compute in float32 and sum the density in
different orders; the discrete decisions (directions, U-turns, the
multinomial picks) come out the same on these cases, so the depth and the
flags agree exactly and the states within 1e-5 of the largest |value|
(the accept statistic within 1e-5).

The statistical tests are in `test_torch_nuts_stats.py`.
"""

import jax
import jax.numpy as jnp
import jax.random as jrand
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.inference.requests import nuts as jnuts
from genjax_tpu.models.logreg import logistic_regression as jax_logreg
from genjax_tpu_torch import convert
from genjax_tpu_torch.inference.requests import nuts as tnuts
from genjax_tpu_torch.models.logreg import logistic_regression

torch.set_num_threads(1)


@jgx.gen
def jax_chain_model():
    mu1 = jgx.normal(0.0, 1.0) @ "mu1"
    mu2 = jgx.normal(mu1, 1.0) @ "mu2"
    _ = jgx.normal(mu2, 1.0) @ "y"


@tgx.gen
def chain_model():
    mu1 = tgx.normal(0.0, 1.0) @ "mu1"
    mu2 = tgx.normal(mu1, 1.0) @ "mu2"
    _ = tgx.normal(mu2, 1.0) @ "y"


def jax_draws(key, dim: int, im, max_depth: int):
    """The randomness `_nuts_draw` takes from one chain's key."""
    k_mom, k_tree = jrand.split(key)
    p0 = jrand.normal(k_mom, (dim,)) / jnp.sqrt(im)
    dirs, merges, leaves = [], [], []
    for d in range(max_depth):
        k_dir, k_leaf, k_merge = jrand.split(jrand.fold_in(k_tree, d), 3)
        dirs.append(jrand.bernoulli(k_dir))
        merges.append(jrand.uniform(k_merge))
        leaves.extend(jrand.uniform(jrand.fold_in(k_leaf, i)) for i in range(1 << d))
    return p0, jnp.stack(dirs), jnp.stack(leaves), jnp.stack(merges)


def _gauss_case(c: int = 32, seed: int = 0):
    rng = np.random.default_rng(seed)
    cov = np.array([[2.0, 1.0], [1.0, 2.0]]) / 3.0
    q = rng.multivariate_normal([2 / 3, 4 / 3], 1.5 * cov, size=c).astype(np.float32)
    per_chain = {"mu1": q[:, 0], "mu2": q[:, 1]}
    sel_j = jgx.Selection.at["mu1"] | jgx.Selection.at["mu2"]
    sel_t = tgx.Selection.at["mu1"] | tgx.Selection.at["mu2"]

    def jtr(v1, v2):
        chm = jgx.ChoiceMap.kw(mu1=v1, mu2=v2, y=2.0)
        return jax_chain_model.importance(jrand.key(0), chm, ())[0]

    jtrs = jax.vmap(jtr)(jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]))
    ttrs = convert.chain_batch(chain_model, (), per_chain, {"y": np.float32(2.0)}, device="cpu")
    return jtrs, ttrs, sel_j, sel_t


def _logreg_case(c: int = 16, seed: int = 1, n: int = 50, d: int = 4):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w_true = rng.standard_normal(d).astype(np.float32)
    ys = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ w_true))).astype(np.int32)
    w = (w_true + 0.3 * rng.standard_normal((c, d))).astype(np.float32)

    def jtr(wi):
        chm = jgx.ChoiceMap.kw(w=wi, ys=jnp.asarray(ys))
        return jax_logreg.importance(jrand.key(0), chm, (jnp.asarray(X),))[0]

    jtrs = jax.vmap(jtr)(jnp.asarray(w))
    ttrs = convert.chain_batch(logistic_regression, (X,), {"w": w}, {"ys": ys}, device="cpu")
    return jtrs, ttrs, jgx.Selection.at["w"], tgx.Selection.at["w"]


def _jax_inv_mass(jtrs, sel, scale):
    if scale is None:
        return None
    vals = jax.vmap(lambda t: t.get_choices().filter(sel))(jtrs)
    return jax.tree_util.tree_map(lambda v: scale * jnp.ones(v.shape[1:]), vals)


CASES = {
    "gauss_eps0.3": (_gauss_case, 0.3, 4, None),
    "gauss_mass_eps0.4": (_gauss_case, 0.4, 4, 0.6),
    "gauss_tiny_eps": (_gauss_case, 0.005, 4, None),
    "gauss_diverging_eps": (_gauss_case, 3.5, 4, None),
    "logreg_eps0.05": (_logreg_case, 0.05, 4, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nuts_core_matches_jax_on_jax_draws(name):
    make, eps, max_depth, mass = CASES[name]
    jtrs, ttrs, sel_j, sel_t = make()
    c = ttrs.particle_count()
    keys = jrand.split(jrand.key(7), c)
    jmass = _jax_inv_mass(jtrs, sel_j, mass)

    def one(k, tr):
        q0, im, logp_grad, _ = jnuts._flat_problem(sel_j, tr, jgx.Diff.no_change(tr.get_args()), jmass)
        q_new, info = jnuts._nuts_draw(k, q0, im, logp_grad, jnp.asarray(eps), max_depth)
        return q_new, info, jax_draws(k, q0.shape[0], im, max_depth)

    ref_q, ref_info, (p0, dirs, leaves, merges) = jax.jit(jax.vmap(one))(keys, jtrs)

    tmass = None
    if mass is not None:
        tmass = ttrs.get_choices().filter(sel_t).map_choices(
            lambda ch: tgx.ChoiceMap.choice(torch.full(ch.v.shape[1:], mass))
        )
    q0, im, logp_grad, _ = tnuts._flat_problem(sel_t, ttrs, tgx.Diff.no_change(ttrs.get_args()), tmass)
    q_new, info = tnuts.nuts_draw(
        q0, im, logp_grad, eps, max_depth,
        torch.from_numpy(np.array(p0)),
        torch.from_numpy(np.array(dirs)).T,
        torch.from_numpy(np.array(leaves)).T,
        torch.from_numpy(np.array(merges)).T,
    )
    ref_q = np.asarray(ref_q)
    np.testing.assert_array_equal(info.depth.numpy(), np.asarray(ref_info.depth))
    np.testing.assert_array_equal(info.diverged.numpy(), np.asarray(ref_info.diverged))
    np.testing.assert_allclose(q_new.numpy(), ref_q, rtol=0, atol=1e-5 * max(1.0, np.abs(ref_q).max()))
    np.testing.assert_allclose(info.accept_stat.numpy(), np.asarray(ref_info.accept_stat), rtol=0, atol=1e-5)
    if name == "gauss_tiny_eps":
        assert (info.depth == max_depth).all()
    if name == "gauss_diverging_eps":
        assert info.diverged.any()


def test_nuts_randomness_layout():
    q0 = torch.zeros(5, 3)
    p0, right, leaf_u, merge_u = tnuts.nuts_randomness(torch.Generator().manual_seed(0), q0, torch.ones(3), 4)
    assert p0.shape == (5, 3) and right.shape == (4, 5) and right.dtype == torch.bool
    assert leaf_u.shape == (15, 5) and merge_u.shape == (4, 5)
    assert [len(tnuts._level_schedule(d)) for d in range(4)] == [1, 2, 4, 8]
    # Leaf 3 of a depth-2 subtree closes the nodes [2..3] and [0..3].
    assert tnuts._level_schedule(2)[3] == (False, 1, [0, 1])
