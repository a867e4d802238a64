"""`Closure`, `nth` and `PythonicPytree` (after `tests/core/test_pytree.py`),
keyword arguments on the GFI (`handle_kwargs`, `IgnoreKwargs`, the
closure's `kwargs`; after `tests/lang/test_static_gen_fn.py` and
`tests/lang/test_gfi_properties.py`), `partial_apply` and `@gen` methods,
against `genjax_tpu` on the CPU.

Scores and weights of fixed numpy-made choices are held against JAX's at
float32 tolerance, 1e-6 relative. A partially applied model's fixed
arguments are leaves of its generative function, which a trace records as
shared by every particle: no resampler touches them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu_torch.core.pytree import Closure, PythonicPytree, nth

torch.set_num_threads(1)


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


def _close(got, ref, tol=1e-6):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), (got, ref)


# -- Closure, nth, PythonicPytree --------------------------------------------------------------


def test_closure_call():
    clo = Closure((2.0,), lambda a, b: a + b)
    assert clo(3.0) == 5.0


def test_closure_dynamic_args_are_leaves():
    clo = Closure((torch.tensor(2.0),), lambda a, b: a * b)
    leaves, spec = pytree.tree_flatten(clo)
    assert len(leaves) == 1
    doubled = pytree.tree_unflatten([leaves[0] * 2], spec)
    assert float(doubled(3.0)) == 12.0
    # JAX's `jit` over a closure: here `torch.func.vmap` over its leaves.
    out = torch.func.vmap(lambda c, x: c(x), in_dims=(0, None))(Closure((torch.tensor([1.0, 2.0]),), clo.fn), 3.0)
    assert out.tolist() == [3.0, 6.0]


def test_partial_decorator():
    @tgx.Pytree.partial(10.0)
    def f(a, b):
        return a - b

    assert f(4.0) == 6.0


def test_same_code_closures_share_treedef():
    # Running the same `def` again makes a new function object; the treedef
    # must still compare equal (same code and closure cells).
    def mk(c):
        def f(x):
            return x + c

        return Closure((), f)

    def td(v):
        return pytree.tree_structure(v)

    assert td(mk(1.0)) == td(mk(1.0))  # same code, same cell
    assert td(mk(1.0)) != td(mk(2.0))  # same code, another cell

    def mk2(c):
        def f(x):
            return x * c

        return Closure((), f)

    assert td(mk(1.0)) != td(mk2(1.0))  # other code


def test_nth():
    tree = {"a": torch.arange(5), "b": torch.arange(10.0).reshape(5, 2)}
    row = nth(tree, 2)
    assert row["a"] == 2
    assert row["b"].shape == (2,)
    j_row = jgx.core.nth({"a": jnp.arange(5), "b": jnp.arange(10.0).reshape(5, 2)}, 2)
    assert row["b"].tolist() == np.asarray(j_row["b"]).tolist()


@tgx.Pytree.dataclass
class _Pair(PythonicPytree):
    a: torch.Tensor
    b: torch.Tensor


def test_pythonic_pytree():
    p = _Pair(torch.arange(3.0), torch.arange(6.0).reshape(3, 2))
    assert len(p) == 3
    assert float(p[1].a) == 1.0 and p[1].b.tolist() == [2.0, 3.0]
    both = p + p
    assert len(both) == 6 and both.a.tolist() == [0.0, 1.0, 2.0, 0.0, 1.0, 2.0]
    assert [float(q.a) for q in p] == [0.0, 1.0, 2.0]


# -- keyword arguments on the GFI ----------------------------------------------------------------


@jgx.gen
def j_simple_normal(mu):
    return jgx.normal(mu, 1.0) @ "x"


@tgx.gen
def t_simple_normal(mu):
    return tgx.normal(mu, 1.0) @ "x"


def test_kwargs():
    @tgx.gen
    def model(x, y, z=1.0):
        _ = tgx.normal(x + y, z) @ "v"
        return x + y + z

    kw_model = model.handle_kwargs()
    tr = kw_model.simulate(_rng(0), ((1.0, 2.0), {"z": 3.0}))
    assert float(tr.get_retval()) == 6.0


def _kw_models():
    @jgx.gen
    def j_kw(x, scale=1.0):
        return jgx.normal(x, scale) @ "v"

    @tgx.gen
    def t_kw(x, scale=1.0):
        return tgx.normal(x, scale) @ "v"

    return j_kw, t_kw


def test_kwargs_model_full_gfi_like_jax():
    j_kw, t_kw = _kw_models()
    jm, tm = j_kw.handle_kwargs(), t_kw.handle_kwargs()
    args = ((0.5,), {"scale": 2.0})
    tr = tm.simulate(_rng(0), args)
    v = tr.get_choices()["v"]
    _close(tr.get_score(), jgx.normal.logpdf(jnp.asarray(v.numpy()), 0.5, 2.0))
    score, _ = tm.assess(tr.get_choices(), args)
    _close(score, tr.get_score())
    for value in np.random.default_rng(4).normal(size=5).astype(np.float32):
        t_score, _ = tm.assess(tgx.ChoiceMap.kw(v=torch.tensor(value)), args)
        j_score, _ = jm.assess(jgx.ChoiceMap.kw(v=jnp.asarray(value)), args)
        _close(t_score, j_score)
        _, t_w = tm.generate(_rng(1), tgx.ChoiceMap.kw(v=torch.tensor(value)), args)
        _, j_w = jm.generate(jax.random.key(1), jgx.ChoiceMap.kw(v=jnp.asarray(value)), args)
        _close(t_w, j_w)
    # An edit through keyword argdiffs.
    new_tr, w, _, _ = tm.edit(_rng(2), tr, tgx.Update(tgx.ChoiceMap.kw(v=0.0)), tgx.Diff.no_change(args))
    _close(w, new_tr.get_score() - tr.get_score())


def test_kwargs_at_a_site_like_jax():
    """`callee(x, scale=s) @ "addr"` inside a `@gen` body goes through
    `handle_kwargs`; a distribution binds its keyword parameters itself."""
    j_kw, t_kw = _kw_models()

    @jgx.gen
    def j_outer(s):
        return j_kw(0.5, scale=s) @ "inner"

    @tgx.gen
    def t_outer(s):
        return t_kw(0.5, scale=s) @ "inner"

    value = np.float32(0.7)
    t_score, _ = t_outer.assess(tgx.ChoiceMap.d({("inner", "v"): torch.tensor(value)}), (2.0,))
    j_score, _ = j_outer.assess(jgx.ChoiceMap.d({("inner", "v"): jnp.asarray(value)}), (2.0,))
    _close(t_score, j_score)
    tr = t_outer.simulate(_rng(3), (2.0,), n=16)
    assert tr.get_choices()["inner", "v"].shape == (16,)


def test_ignore_kwargs_drops_the_keywords():
    tm = tgx.normal.handle_kwargs()
    assert isinstance(tm, tgx.IgnoreKwargs)
    tr = tm.simulate(_rng(0), ((0.0, 1.0), {"ignored": 1}))
    score, _ = tm.assess(tr.get_choices(), ((0.0, 1.0), {}))
    _close(score, tr.get_score())
    with pytest.raises(NotImplementedError):
        tm.handle_kwargs()


def test_closure_kwargs_and_direct_call():
    j_kw, t_kw = _kw_models()
    clo = t_kw(0.0, scale=1e-3)
    assert clo.kwargs == {"scale": 1e-3}
    gen_fn, args = clo.get_gen_fn_with_args()
    assert args == ((0.0,), {"scale": 1e-3})
    assert abs(float(clo(_rng(0)))) < 1e-2
    assert float(t_simple_normal(1.0).__abstract_call__()) == 0.0
    assert t_simple_normal(1.0).get_gen_fn_with_args() == (t_simple_normal, (1.0,))


# -- partial_apply and @gen methods ------------------------------------------------------------


def test_partial_apply():
    fixed = t_simple_normal.partial_apply(2.0)
    tr = fixed.simulate(_rng(0), ())
    assert tr.get_args() == () and fixed.partial_args() == (2.0,)
    value = np.float32(1.25)
    t_score, _ = fixed.assess(tgx.ChoiceMap.kw(x=torch.tensor(value)), ())
    j_score, _ = j_simple_normal.partial_apply(2.0).assess(jgx.ChoiceMap.kw(x=jnp.asarray(value)), ())
    _close(t_score, j_score)


def test_gen_method_binds_its_instance():
    class Model:
        def __init__(self, mu):
            self.mu = mu

        @tgx.gen
        def run(self, scale):
            return tgx.normal(self.mu, scale) @ "x"

    m = Model(3.0)
    bound = m.run
    assert isinstance(bound, tgx.StaticGenerativeFunction) and bound.partial_args() == (m,)
    assert Model.run.partial_args() == ()
    score, _ = bound.assess(tgx.ChoiceMap.kw(x=3.0), (1.0,))
    _close(score, -0.5 * np.log(2 * np.pi))
    assert bound.__name__ == "run"


def test_partial_args_are_shared_by_the_particles():
    """A partially applied model's fixed tensor has the particle count's
    length; it is a leaf of the generative function, recorded as shared:
    neither `ImportanceK` nor `SMCDriver.maybe_resample` (its row copy)
    touches it."""

    @tgx.gen
    def model(centers):
        x = tgx.normal(centers.mean(), 1.0) @ "x"
        _ = tgx.normal(x, 1.0) @ "y"
        return x

    K = 64
    centers = torch.linspace(-1.0, 1.0, K)
    fixed = model.partial_apply(centers)
    target = tgx.Target(fixed, (), tgx.ChoiceMap.kw(y=1.0))
    col = tgx.ImportanceK(target, k_particles=K).run_smc(_rng(0))
    tr = col.get_particles()
    assert tr.get_gen_fn().partial_args()[0] is centers
    n_fn = len(pytree.tree_leaves(tr.get_gen_fn()))
    assert n_fn == 1 and tr.batched_leaves()[:n_fn] == [0]
    driver = tgx.smc.SMCDriver(n_particles=K, ess_threshold=1.0)
    resampled = driver.maybe_resample(_rng(1), col)
    assert torch.equal(resampled.get_particles().get_gen_fn().partial_args()[0], centers)
    assert resampled.get_particles().get_choices()["x"].shape == (K,)
    # The resample moved the particles' rows, not the shared argument.
    assert not torch.equal(resampled.get_particles().get_choices()["x"], tr.get_choices()["x"])
