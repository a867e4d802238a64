"""The port's SVGD (`genjax_tpu_torch.inference.svgd`) and its helpers
(`core/pytree.py::ravel_pytree`, `map_laplace.adagrad`) against
`genjax_tpu` and the conjugate closed forms, on the CPU.

Deterministic pieces get the same numpy-made inputs as JAX and are held
at float32 tolerance, 1e-5 per unit of magnitude (`_close`) unless a test
states another: the flat order of `ravel_pytree`, the RBF kernel, the
median bandwidth, `stein_phi_block`, `stein_direction` (f32; the bf16
path at the tolerance measured and stated in its test), the per-particle
gradient, optax's Adagrad, and SVGD's transport itself (deterministic
given its starting particles: the port's steps against JAX's
`stein_direction` and `vmap(grad)` fed the same particles). Posteriors
are held against the conjugate closed forms with the JAX tests' bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree as jax_ravel

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.inference import svgd as jsvgd
from genjax_tpu_torch.core.pytree import ravel_pytree
from genjax_tpu_torch.inference import svgd as tsvgd
from genjax_tpu_torch.inference.map_laplace import adagrad

torch.set_num_threads(1)


def _close(got, ref, tol=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), np.max(np.abs(got - ref))


def _normal(seed, *shape, scale=1.0):
    return np.asarray(scale * np.random.default_rng(seed).standard_normal(shape), dtype=np.float32)


@jgx.gen
def j_scalar():
    mu = jgx.normal(0.0, 1.0) @ "mu"
    _ = jgx.normal(mu, 1.0) @ "obs"
    return mu


@tgx.gen
def t_scalar():
    mu = tgx.normal(0.0, 1.0) @ "mu"
    _ = tgx.normal(mu, 1.0) @ "obs"
    return mu


D = 4


@tgx.gen
def t_vector(y):
    w = tgx.normal(torch.zeros(D), 1.0) @ "w"
    _ = tgx.normal(w, 0.5) @ "y"
    return w


@jgx.gen
def j_logreg(X):
    w = jgx.normal(jnp.zeros(X.shape[-1]), 1.0) @ "w"
    _ = jgx.bernoulli(logits=X @ w) @ "ys"


@tgx.gen
def t_logreg(X):
    w = tgx.normal(torch.zeros(X.shape[-1]), 1.0) @ "w"
    _ = tgx.bernoulli(logits=w @ X.mT) @ "ys"


# -- the helpers --------------------------------------------------------------------------


def _trees():
    a, b, c = _normal(0, 3), _normal(1, 2, 2), _normal(2)
    return [
        ({"b": b, "a": a, "c": c}, "a dict inserted out of order"),
        ({"z": {"y": c, "x": a}, "a": (b, a)}, "nested dicts and a tuple"),
        ([{"k2": a, "k1": b}, c], "a list of dicts"),
    ]


@pytest.mark.parametrize("i", range(3))
def test_ravel_pytree_uses_jax_leaf_order(i):
    tree, _ = _trees()[i]
    ref, _ = jax_ravel(jax.tree_util.tree_map(jnp.asarray, tree))
    flat, unravel = ravel_pytree(jax.tree_util.tree_map(torch.from_numpy, tree))
    _close(flat, ref, 0.0)
    back = unravel(flat)
    for got, want in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, back)), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(got, want)


def test_ravel_pytree_of_a_choice_map_in_jax_order_and_dtypes():
    # Sites made in program order b, a, n (an integer site): JAX flattens
    # the static choice map's dict by sorted key and promotes the int.
    b, a = _normal(3, 2), _normal(4)
    ref, _ = jax_ravel(jgx.ChoiceMap.kw(b=jnp.asarray(b), a=jnp.asarray(a), n=jnp.asarray(3)))
    flat, unravel = ravel_pytree(tgx.ChoiceMap.kw(b=torch.from_numpy(b), a=torch.from_numpy(a), n=torch.tensor(3)))
    _close(flat, ref, 0.0)
    assert unravel(flat)["n"].dtype == torch.int64 and int(unravel(flat)["n"]) == 3


def test_ravel_pytree_of_rows_is_ravel_pytree_row_by_row():
    tree = {"b": torch.from_numpy(_normal(5, 6, 2)), "a": torch.from_numpy(_normal(6, 6))}
    flat, unravel = ravel_pytree(tree, (6,))
    assert flat.shape == (6, 3)
    for i in range(6):
        _close(flat[i], ravel_pytree({k: v[i] for k, v in tree.items()})[0], 0.0)
    assert torch.equal(unravel(flat)["b"], tree["b"])


def test_adagrad_matches_optax_step_for_step():
    x = _normal(7, 5, 3)
    opt, state = optax.adagrad(0.5), None
    state = opt.init(jnp.asarray(x))
    ours = adagrad(0.5)
    ours_state = ours.init([torch.from_numpy(x)])
    for step in range(4):
        g = _normal(8 + step, 5, 3) * (0.0 if step == 2 else 1.0)  # a zero gradient too
        ref, state = opt.update(jnp.asarray(g), state)
        got, ours_state = ours.update([torch.from_numpy(g)], ours_state)
        _close(got[0], ref)


# -- the kernel pieces ----------------------------------------------------------------------


@pytest.mark.parametrize("bandwidth", [None, 0.7])
def test_rbf_kernel_matches_jax(bandwidth):
    x = _normal(10, 48, 3)
    Kj, hj = jsvgd.rbf_kernel(jnp.asarray(x), bandwidth)
    Kt, ht = tsvgd.rbf_kernel(torch.from_numpy(x), bandwidth)
    _close(ht, hj)
    _close(Kt, Kj)
    assert torch.allclose(Kt, Kt.T, atol=1e-6) and torch.allclose(torch.diag(Kt), torch.ones(48), atol=1e-6)


def test_median_bandwidth_of_an_even_block_averages_the_middle_pair():
    # 128 x 128 squared distances: an even count, where jnp.median averages
    # the two middle values and torch.median would take the lower.
    x = _normal(11, 300, 2)
    d2 = np.asarray(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1), dtype=np.float32)
    ref = jsvgd._bandwidth_from_d2_block(jnp.asarray(d2), 300, None)
    got = tsvgd._bandwidth_from_d2_block(torch.from_numpy(d2), 300, None)
    _close(got, ref)
    block = torch.from_numpy(d2[:128, :128]).reshape(-1)
    lower = torch.median(block) / np.log(301.0)
    assert float(lower) != pytest.approx(float(ref), rel=1e-7)  # the two rules differ here


@pytest.mark.parametrize("n,d,h", [(64, 3, 0.9), (200, 16, 2.5), (130, 5, 0.3)])
def test_stein_phi_block_matches_jax(n, d, h):
    x, g = _normal(12 + n, n, d), _normal(13 + n, n, d)
    rows = x[: n // 3]
    ref = jsvgd.stein_phi_block(jnp.asarray(rows), jnp.asarray(x), jnp.asarray(g), jnp.asarray(h), n)
    got = tsvgd.stein_phi_block(torch.from_numpy(rows), torch.from_numpy(x), torch.from_numpy(g), torch.tensor(h), n)
    _close(got, ref)


@pytest.mark.parametrize("n,d", [(96, 4), (256, 16)])
def test_stein_direction_matches_jax_in_f32(n, d):
    x = _normal(20 + n, n, d)
    g = -x + _normal(21 + n, n, d, scale=0.1)
    ref, hj = jsvgd.stein_direction(jnp.asarray(x), jnp.asarray(g))
    got, ht = tsvgd.stein_direction(torch.from_numpy(x), torch.from_numpy(g))
    _close(ht, hj)
    _close(got, ref)


def test_stein_direction_in_bf16_against_f32_and_jax():
    # bf16 operands with f32 accumulation, random gradients (no cancellation
    # toward a fixed point): measured 0.78-1.2% of max|phi| against the f32
    # direction over seeds 0-2 (JAX's docstring: about 0.4% on the
    # distances), and 0.3-4.3e-5 of max|phi| from JAX's bf16 path fed the
    # same values (the two round the same operands, then sum in other
    # orders); held at 2e-2 and 2e-4 of max|phi|.
    n, d = 256, 16
    x, g = _normal(30, n, d), _normal(31, n, d)
    f32, h = tsvgd.stein_direction(torch.from_numpy(x), torch.from_numpy(g))
    bf16, _ = tsvgd.stein_direction(torch.from_numpy(x), torch.from_numpy(g), kernel_dtype=torch.bfloat16)
    scale = float(f32.abs().max())
    assert float((bf16 - f32).abs().max()) < 2e-2 * scale
    ref, _ = jsvgd.stein_direction(jnp.asarray(x), jnp.asarray(g), kernel_dtype=jnp.bfloat16)
    assert float(np.abs(bf16.numpy() - np.asarray(ref)).max()) < 2e-4 * scale


def test_stein_direction_signs_at_a_symmetric_pair():
    close = torch.tensor([[-0.05], [0.05]])
    far = torch.tensor([[-3.0], [3.0]])
    phi_close, _ = tsvgd.stein_direction(close, -close, bandwidth=1.0)
    phi_far, _ = tsvgd.stein_direction(far, -far, bandwidth=1.0)
    assert torch.allclose(phi_close[0], -phi_close[1], atol=1e-6)
    assert phi_close[0, 0] < 0 < phi_close[1, 0]  # too close: repulsion pushes apart
    assert phi_far[0, 0] > 0 > phi_far[1, 0]  # too far: the gradient pulls together


# -- svgd and packed_svgd -----------------------------------------------------------------


def _logreg_data(n_data=32, d=3):
    X = _normal(40, n_data, d)
    ys = (np.random.default_rng(41).random(n_data) < 1 / (1 + np.exp(-X @ np.array([1.0, -0.5, 0.3])))).astype(np.int32)
    return X, ys


def test_per_particle_gradient_matches_jax_vmap_grad():
    X, ys = _logreg_data()
    x = _normal(42, 64, 3)
    rng = torch.Generator().manual_seed(0)
    traces, _, unravel = tsvgd._prepare_particles(
        rng, t_logreg, (torch.from_numpy(X),), tgx.ChoiceMap.kw(ys=torch.from_numpy(ys)), tgx.Selection.at["w"], 64
    )
    got = tsvgd._grad_batch(tgx.Selection.at["w"], traces, (torch.from_numpy(X),), unravel)(torch.from_numpy(x))
    ref = jax.vmap(jax.grad(lambda w: j_logreg.assess(jgx.ChoiceMap.kw(w=w, ys=jnp.asarray(ys)), (jnp.asarray(X),))[0]))(
        jnp.asarray(x)
    )
    _close(got, ref)


@pytest.mark.parametrize("kernel_dtype", [None, "bf16"])
def test_transport_matches_jax_from_the_same_particles(kernel_dtype):
    # SVGD is deterministic given its starting particles: 25 steps of the
    # port's loop against JAX's stein_direction and vmap(grad), each fed the
    # same starting matrix. f32: 1e-4 of max(1, |x|) after 25 steps (the
    # two sum in other orders); bf16: 1e-3 (a bf16 rounding flips as an
    # operand moves by an ulp).
    X, ys = _logreg_data()
    x0 = _normal(43, 128, 3)
    kd_t = None if kernel_dtype is None else torch.bfloat16
    kd_j = None if kernel_dtype is None else jnp.bfloat16
    rng = torch.Generator().manual_seed(0)
    traces, _, unravel = tsvgd._prepare_particles(
        rng, t_logreg, (torch.from_numpy(X),), tgx.ChoiceMap.kw(ys=torch.from_numpy(ys)), tgx.Selection.at["w"], 128
    )
    grad_fn = tsvgd._grad_batch(tgx.Selection.at["w"], traces, (torch.from_numpy(X),), unravel)
    got, outs = tsvgd._transport(torch.from_numpy(x0), grad_fn, 25, 0.05, None, None, None, kd_t)
    jgrad = jax.vmap(jax.grad(lambda w: j_logreg.assess(jgx.ChoiceMap.kw(w=w, ys=jnp.asarray(ys)), (jnp.asarray(X),))[0]))
    x = jnp.asarray(x0)
    for _ in range(25):
        phi, _ = jsvgd.stein_direction(x, jgrad(x), None, kd_j)
        x = x + 0.05 * phi
    _close(got, x, 1e-4 if kernel_dtype is None else 1e-3)
    assert outs.shape == (25,)


def test_scalar_conjugate_recovers_posterior_moments():
    # obs=2 -> posterior N(1.0, 0.5); the JAX test's bounds.
    traces, phi = tsvgd.svgd(
        torch.Generator().manual_seed(0), t_scalar, (), tgx.ChoiceMap.kw(obs=2.0), tgx.Selection.at["mu"],
        n_particles=128, n_steps=400, step_size=0.3,
    )
    mus = traces.get_choices()["mu"]
    assert abs(float(mus.mean()) - 1.0) < 0.05
    assert abs(float(mus.std(correction=0)) - 0.5**0.5) < 0.08
    assert float(phi[-1]) < 1e-3


def test_scores_consistent_with_choices():
    traces, _ = tsvgd.svgd(
        torch.Generator().manual_seed(1), t_scalar, (), tgx.ChoiceMap.kw(obs=2.0), tgx.Selection.at["mu"],
        n_particles=32, n_steps=50,
    )
    score, _ = t_scalar.assess(traces.get_choices(), (), 32)
    _close(traces.get_score(), score)


def test_adagrad_recovers_the_vector_posterior():
    y = torch.linspace(-1.0, 1.0, D)
    traces, _ = tsvgd.svgd(
        torch.Generator().manual_seed(0), t_vector, (y,), tgx.ChoiceMap.kw(y=y), tgx.Selection.at["w"],
        n_particles=256, n_steps=500, optimizer=adagrad(0.5),
    )
    ws = traces.get_choices()["w"]
    assert float((ws.mean(0) - 4.0 * y / 5.0).abs().max()) < 0.03
    assert float((ws.std(0, correction=0) - 0.2**0.5).abs().max()) < 0.08


def test_shared_args_layout():
    y = torch.linspace(-1.0, 1.0, D)
    traces, _ = tsvgd.svgd(
        torch.Generator().manual_seed(0), t_vector, (y,), tgx.ChoiceMap.kw(y=y), tgx.Selection.at["w"],
        n_particles=16, n_steps=5,
    )
    (arg,) = traces.get_args()
    assert arg is y and not any(traces.args_record())


def test_discrete_selection_raises():
    @tgx.gen
    def m2():
        z = tgx.categorical(torch.log(torch.tensor([0.5, 0.5]))) @ "z"
        _ = tgx.normal(torch.where(z == 0, -1.0, 1.0), 1.0) @ "y"

    with pytest.raises(TypeError, match="non-differentiable"):
        tsvgd.svgd(torch.Generator().manual_seed(0), m2, (), tgx.ChoiceMap.kw(y=0.5), tgx.Selection.at["z"],
                   n_particles=8, n_steps=2)


def test_packed_single_problem_is_plain_svgd_bitwise():
    kw = dict(selection=tgx.Selection.at["mu"], n_particles=64, n_steps=50, step_size=0.3, bandwidth=0.7)
    plain, phi_plain = tsvgd.svgd(torch.Generator().manual_seed(3), t_scalar, (), tgx.ChoiceMap.kw(obs=2.0), **kw)
    packed, phi_packed = tsvgd.packed_svgd(
        torch.Generator().manual_seed(3), t_scalar, [()], [tgx.ChoiceMap.kw(obs=2.0)], **kw
    )
    assert len(packed) == 1
    assert torch.equal(packed[0].get_choices()["mu"], plain.get_choices()["mu"])
    assert torch.equal(packed[0].get_score(), plain.get_score())
    assert torch.equal(phi_packed, phi_plain)


def test_packed_marginals_match_conjugate_oracles():
    obs = [-2.0, 0.0, 2.0]
    traces, phi = tsvgd.packed_svgd(
        torch.Generator().manual_seed(0), t_scalar, [(), (), ()], [tgx.ChoiceMap.kw(obs=y) for y in obs],
        tgx.Selection.at["mu"], n_particles=256, n_steps=500, step_size=0.3,
    )
    for tr, y in zip(traces, obs):
        mus = tr.get_choices()["mu"]
        assert abs(float(mus.mean()) - y / 2.0) < 0.08, y
        assert abs(float(mus.std(correction=0)) - 0.5**0.5) < 0.15, y
    assert float(phi[-1]) < 5e-3


def test_packed_scores_consistent_per_problem():
    traces, _ = tsvgd.packed_svgd(
        torch.Generator().manual_seed(1), t_scalar, [(), ()], [tgx.ChoiceMap.kw(obs=1.0), tgx.ChoiceMap.kw(obs=-1.0)],
        tgx.Selection.at["mu"], n_particles=32, n_steps=20, step_size=0.2,
    )
    for tr in traces:
        score, _ = t_scalar.assess(tr.get_choices(), (), 32)
        _close(tr.get_score(), score)


def test_packed_length_mismatch_raises():
    with pytest.raises(ValueError, match="same length"):
        tsvgd.packed_svgd(torch.Generator().manual_seed(0), t_scalar, [()],
                          [tgx.ChoiceMap.kw(obs=1.0), tgx.ChoiceMap.kw(obs=2.0)], tgx.Selection.at["mu"],
                          n_particles=8, n_steps=1)
