"""The particle-axis record of `genjax_tpu_torch`, against `genjax_tpu`.

Whether a leaf carries the particle (or chain) axis is recorded where the
value is made, never read off its size. These tests build the cases where
a size would mislead: a shared argument or data vector whose length
equals the particle count. JAX, whose `vmap` knows the batch axis of
every value, is the reference: resampling and `get_particle` leave a
shared argument whole, and the scores do not depend on whether the data
length equals the chain count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.inference.smc import ParticleCollection as JaxParticleCollection
from genjax_tpu.models.logreg import logistic_regression as jax_logreg
from genjax_tpu.models.polyreg import polynomial_regression as jax_polyreg
from genjax_tpu_torch import convert
from genjax_tpu_torch.core.gather import take_rows
from genjax_tpu_torch.core.staging import where_tree
from genjax_tpu_torch.core.typing import per_particle, sample_shape
from genjax_tpu_torch.models.logreg import logistic_regression
from genjax_tpu_torch.models.polyreg import polynomial_regression

torch.set_num_threads(1)

K = 8


@tgx.gen
def _shift_model(xs):
    x = tgx.normal(0.0, 1.0) @ "x"
    _ = tgx.normal(x[..., None] + xs, 1.0) @ "y"
    return x


@jgx.gen
def _jax_shift_model(xs):
    x = jgx.normal(0.0, 1.0) @ "x"
    _ = jgx.normal(x + xs, 1.0) @ "y"
    return x


def _collections():
    """The same K particles in both packages, with xs = arange(K) shared."""
    xs = np.arange(K, dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(K).astype(np.float32)
    y = np.zeros(K, np.float32)
    lw = np.linspace(-3.0, 0.0, K).astype(np.float32)
    jtr = jax.vmap(
        lambda xi: _jax_shift_model.importance(
            jax.random.key(0), jgx.ChoiceMap.d({"x": xi, "y": jnp.asarray(y)}), (jnp.asarray(xs),)
        )[0]
    )(jnp.asarray(x))
    jcol = JaxParticleCollection(jtr, jnp.asarray(lw), jnp.array(True))
    col = convert.particle_collection(_shift_model, (xs,), {"x": x}, lw, device="cpu", observations={"y": y})
    return xs, jcol, col


def test_resample_keeps_a_shared_argument_of_length_k_whole():
    xs, jcol, col = _collections()
    jnew = jcol.resample(jax.random.key(1), "systematic")
    new = col.resample(torch.Generator().manual_seed(1))
    # JAX's vmap-built collection: every particle holds xs whole.
    np.testing.assert_array_equal(np.asarray(jnew.get_particles().get_args()[0]), np.tile(xs, (K, 1)))
    # The port stores xs once, untouched by the row copy.
    assert new.get_particles().get_args()[0] is col.get_particles().get_args()[0]
    np.testing.assert_array_equal(new.get_particles().get_args()[0].numpy(), xs)
    np.testing.assert_array_equal(new.get_particles().get_choices()["y"].numpy(), np.zeros(K, np.float32))
    # The per-particle value is resampled: each row is one of the old ones.
    assert set(new.get_particles().get_choices()["x"].tolist()) <= set(col.get_particles().get_choices()["x"].tolist())


def test_get_particle_returns_a_shared_argument_of_length_k_whole():
    xs, jcol, col = _collections()
    for i in (0, 2, K - 1):
        jp, p = jcol.get_particle(i), col.get_particle(i)
        np.testing.assert_array_equal(p.get_args()[0].numpy(), np.asarray(jp.get_args()[0]))
        np.testing.assert_array_equal(p.get_args()[0].numpy(), xs)
        assert float(p.get_choices()["x"]) == float(jp.get_choices()["x"])
        assert p.get_score().shape == () and abs(float(p.get_score()) - float(jp.get_score())) <= 1e-5 * max(
            1.0, abs(float(jp.get_score()))
        )
        # One particle's trace records no particle axis.
        assert p.particle_count() is None and not any(p.batched_leaves())


@tgx.gen
def _arg_model(xs):
    x = tgx.normal(0.0, 1.0) @ "x"
    _ = tgx.normal(x, 1.0) @ "y"
    return x


def test_sir_collection_keeps_a_shared_argument_of_length_k_through_resample_and_get_particle():
    # Only the public SIR API: the model's argument xs = arange(K) is shared
    # by every particle, and neither resampling nor `get_particle` may
    # treat it as a particle column because its length is K.
    xs = torch.arange(float(K))
    target = tgx.Target(_arg_model, (xs,), tgx.ChoiceMap.kw(y=1.0))
    col = tgx.ImportanceK(target, k_particles=K).run_smc(torch.Generator().manual_seed(0))
    new = col.resample(torch.Generator().manual_seed(1))
    assert new.get_particles().get_args()[0].tolist() == xs.tolist()
    assert col.get_particle(2).get_args()[0].tolist() == xs.tolist()
    assert new.get_particle(5).get_args()[0].tolist() == xs.tolist()


def test_take_rows_of_a_trace_reads_its_record():
    xs, _, col = _collections()
    tr = col.get_particles()
    assert tr.particle_count() == K
    idx = torch.tensor([3, 3, 0, 1, 2, 7, 6, 5])
    out = take_rows(tr, idx)
    np.testing.assert_array_equal(out.get_choices()["x"].numpy(), tr.get_choices()["x"].numpy()[idx.numpy()])
    assert out.get_args()[0] is tr.get_args()[0]
    np.testing.assert_array_equal(out.get_score().numpy(), tr.get_score().numpy()[idx.numpy()])


@pytest.mark.parametrize("n_data", [16, 17], ids=["data_length_equals_chains", "data_length_differs"])
def test_logreg_scores_do_not_depend_on_the_data_length_matching_the_chain_count(n_data):
    c = 16
    rng = np.random.default_rng(n_data)
    X = rng.standard_normal((n_data, 3)).astype(np.float32)
    ys = rng.integers(0, 2, n_data).astype(np.int32)
    w = rng.standard_normal((c, 3)).astype(np.float32)
    ref = jax.vmap(
        lambda wi: jax_logreg.assess(jgx.ChoiceMap.d({"w": wi, "ys": jnp.asarray(ys)}), (jnp.asarray(X),))[0]
    )(jnp.asarray(w))
    tr = convert.chain_batch(logistic_regression, (X,), {"w": w}, {"ys": ys}, device="cpu")
    # One float32 density pass: 1e-5 of the largest |score|.
    tol = 1e-5 * float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(tr.get_score().numpy(), np.asarray(ref), rtol=0, atol=tol)
    # A step of MH keeps X and ys shared, whole.
    new, accepted = tgx.mh(torch.Generator().manual_seed(0), tr, tgx.MALA(tgx.Selection.at["w"], 1e-3))
    assert accepted.shape == (c,)
    assert new.get_args()[0] is tr.get_args()[0] and new.get_args()[0].shape == (n_data, 3)
    assert new.get_choices()["ys"] is tr.get_choices()["ys"]


@pytest.mark.parametrize("k", [20, 21], ids=["particles_equal_design_points", "particles_differ"])
def test_polyreg_scores_and_resample_with_as_many_particles_as_design_points(k):
    n_points = 20
    rng = np.random.default_rng(k)
    xs = np.linspace(-1.0, 1.0, n_points).astype(np.float32)
    ys = rng.standard_normal(n_points).astype(np.float32)
    coeffs = rng.standard_normal((k, 3)).astype(np.float32)
    ref = jax.vmap(
        lambda c: jax_polyreg.assess(jgx.ChoiceMap.d({"coeffs": c, "ys": jnp.asarray(ys)}), (jnp.asarray(xs), 0.3))[0]
    )(jnp.asarray(coeffs))
    col = convert.particle_collection(
        polynomial_regression, (xs, 0.3), {"coeffs": coeffs}, np.zeros(k, np.float32), device="cpu",
        observations={"ys": ys},
    )
    tol = 1e-5 * float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(col.get_particles().get_score().numpy(), np.asarray(ref), rtol=0, atol=tol)
    new = col.resample(torch.Generator().manual_seed(0)).get_particles()
    np.testing.assert_array_equal(new.get_args()[0].numpy(), xs)
    assert new.get_retval().shape == (k, n_points) and new.get_choices()["ys"].shape == (n_points,)


def test_vector_parameters_draw_one_vector_per_particle():
    # A shared loc of length D draws (n, D), whatever n is, D = n included.
    for n, d in [(5, 3), (4, 4)]:
        loc = torch.arange(float(d))
        tr = tgx.normal.simulate(torch.Generator().manual_seed(0), (loc, 1.0), n=n)
        assert tr.get_retval().shape == (n, d) and tr.get_score().shape == (n,)
        assert tuple(sample_shape(n, loc, 1.0)) == (n, d)
    # A per-particle loc brings its own axis.
    loc = per_particle(torch.zeros(4, 4))
    assert tuple(sample_shape(4, loc, 1.0)) == (4, 4)
    tr = tgx.mv_normal_diag.simulate(torch.Generator().manual_seed(0), (torch.zeros(3), torch.ones(3)), n=3)
    assert tr.get_retval().shape == (3, 3) and tr.get_score().shape == (3,)


def test_where_tree_passes_shared_leaves_through_and_selects_rows():
    X = torch.arange(4.0)
    new = tgx.ChoiceMap.kw(w=per_particle(torch.ones(4, 2)), X=X, s=torch.ones(4))
    old = tgx.ChoiceMap.kw(w=per_particle(torch.zeros(4, 2)), X=X, s=torch.zeros(4))
    flag = torch.tensor([True, False, True, False])
    out = where_tree(flag, new, old)
    assert out["X"] is X
    np.testing.assert_array_equal(out["w"].numpy(), np.array([[1, 1], [0, 0], [1, 1], [0, 0]], np.float32))
    # A shared leaf holds the same value for every particle.
    assert out["s"] is new["s"]


def test_the_row_gathers_refuse_a_tree_without_a_record():
    with pytest.raises(TypeError, match="record"):
        take_rows({"w": torch.zeros(4, 2)}, torch.tensor([0, 0, 1, 1]))


def test_run_chains_refuses_a_trace_without_a_chain_axis():
    tr = logistic_regression.simulate(torch.Generator().manual_seed(0), (torch.zeros(5, 2),))
    with pytest.raises(ValueError, match="chain axis"):
        tgx.run_chains(torch.Generator(), tr, tgx.MALA(tgx.Selection.at["w"], 1e-3), 2)


def test_an_edit_keeps_the_record_and_refuses_to_change_it():
    X = torch.zeros(6, 2)
    tr, _ = logistic_regression.importance(
        torch.Generator().manual_seed(0), tgx.ChoiceMap.kw(ys=torch.zeros(6, dtype=torch.int32)), (X,), n=4
    )
    # A shared constraint on a per-chain site gives every chain that value.
    new, _, _, _ = tr.update(torch.Generator(), tgx.ChoiceMap.kw(w=torch.ones(2)))
    assert new.get_choices()["w"].shape == (4, 2) and new.batched_leaves() == tr.batched_leaves()
    # A per-chain value for the shared observation is refused.
    with pytest.raises(ValueError, match="shares"):
        tr.update(torch.Generator(), tgx.ChoiceMap.kw(ys=per_particle(torch.zeros(4, 6, dtype=torch.int32))))


@pytest.mark.parametrize("model", ["ssm_step", "shared_arg_of_length_k"])
def test_generate_like_an_earlier_trace_matches_the_marked_run(model):
    # A filter's later steps reuse the first step's record (`like=`): the
    # body runs on plain tensors, and the draws, weights and record are
    # those of a run that learns the record from the marks.
    from genjax_tpu_torch.models.ssm import make_ssm_models

    if model == "ssm_step":
        gen_fn, constraint = make_ssm_models()[1], tgx.ChoiceMap.kw(y=torch.tensor(0.3))

        def args(seed):
            return (torch.randn(K, generator=torch.Generator().manual_seed(seed)), seed)
    else:
        gen_fn, constraint = _shift_model, tgx.ChoiceMap.kw(y=torch.zeros(K))

        def args(seed):
            return (torch.arange(float(K)) + seed,)

    def marked(a):
        return tuple(per_particle(v) if isinstance(v, torch.Tensor) and model == "ssm_step" else v for v in a)

    first, _ = gen_fn.generate(torch.Generator().manual_seed(0), constraint, marked(args(0)), K)
    ref, ref_w = gen_fn.generate(torch.Generator().manual_seed(1), constraint, marked(args(1)), K)
    got, got_w = gen_fn.generate(torch.Generator().manual_seed(1), constraint, args(1), K, like=first)
    assert got.batched_leaves() == ref.batched_leaves()
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(ref)):
        assert type(a) is type(b) and (not isinstance(a, torch.Tensor) or torch.equal(a, b))
    assert torch.equal(got_w, ref_w)


def test_generate_like_a_trace_refuses_a_site_it_does_not_hold():
    @tgx.gen
    def other(xs):
        return tgx.normal(xs, 1.0) @ "w"

    first, _ = _arg_model.generate(torch.Generator(), tgx.ChoiceMap.kw(y=0.0), (torch.zeros(()),), K)
    with pytest.raises(tgx.MissingAddress, match="like"):
        other.generate(torch.Generator(), tgx.ChoiceMap.empty(), (torch.zeros(()),), K, like=first)
