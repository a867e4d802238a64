"""The branching combinators, port (`genjax_tpu_torch`) against JAX
(`genjax_tpu`) on the CPU, on the same numpy-made inputs: the `Mask` value
and its algebra, the `Switch`, `Mask` and `MaskedSel` nodes of choice maps
and selections with the builder, `Switch` (`simulate`, `assess`,
`generate`, `project`, a same-branch `Update`, an index-changing `Update`,
a block `Regenerate`), `MaskCombinator`'s four-case edit lattice with
`-inf` inner scores, `mix` and `or_else` densities, `masked_iterate` and
`masked_iterate_final` with mixed flags, and the out-of-range index (R7).

JAX runs one particle per `vmap` lane; the port runs the batch at once,
every particle with its own branch index or flag. Both compute in
float32: scores of O(10) are compared to 1e-5 per unit of magnitude
(`_close`), and a `-inf` must be `-inf` on both sides (never NaN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.core.choice_map import MaskedSel as JMaskedSel
from genjax_tpu.core.choice_map import Switch as JSwitchChm
from genjax_tpu_torch.core.choice_map import MaskedSel as TMaskedSel
from genjax_tpu_torch.core.choice_map import Switch as TSwitchChm

torch.set_num_threads(1)

JC, TC = jgx.ChoiceMap, tgx.ChoiceMap
JB, TB = jgx.ChoiceMapBuilder, tgx.ChoiceMapBuilder
JS, TS = jgx.Selection.at, tgx.Selection.at
JM, TM = jgx.Mask, tgx.Mask
K = 8
MU = 0.3
KEY = jax.random.key(0)
PP = tgx.per_particle


def _close(got, ref, tol=1e-5, nan_at=False):
    """|got - ref| <= tol * max(1, |ref|) elementwise, shapes equal; equal
    infinities match. Neither side may be NaN, except where `nan_at` holds
    and both are."""
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    both_nan = np.isnan(got) & np.isnan(ref) & np.asarray(nan_at)
    assert not (np.isnan(got) & ~both_nan).any() and not (np.isnan(ref) & ~both_nan).any(), (got, ref)
    same_inf = np.isinf(got) & (got == ref)
    with np.errstate(invalid="ignore"):  # inf - inf where both are infinite
        near = np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))
    assert np.all(both_nan | same_inf | near), (got, ref)


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    idx = np.array([0, 1, 1, 0, 1, 0, 0, 1], dtype=np.int32)
    xs = rng.standard_normal(K).astype(np.float32)
    zs = rng.standard_normal(K).astype(np.float32)
    return idx, xs, zs


# -- the models, one pair each -------------------------------------------------


@jgx.gen
def j_b0(mu):
    return jgx.normal(mu, 1.0) @ "x"


@tgx.gen
def t_b0(mu):
    return tgx.normal(mu, 1.0) @ "x"


@jgx.gen
def j_b1(mu):
    x = jgx.normal(mu + 1.0, 2.0) @ "x"
    z = jgx.normal(x, 0.5) @ "z"
    return x + z


@tgx.gen
def t_b1(mu):
    x = tgx.normal(mu + 1.0, 2.0) @ "x"
    z = tgx.normal(x, 0.5) @ "z"
    return x + z


J_SW, T_SW = jgx.switch(j_b0, j_b1), tgx.switch(t_b0, t_b1)
J_ARGS = lambda i: (i, (MU,), (MU,))  # noqa: E731
T_ARGS = lambda i: (i, (MU,), (MU,))  # noqa: E731


@jgx.gen
def j_unif():
    return jgx.uniform(0.0, 1.0) @ "u"


@tgx.gen
def t_unif():
    return tgx.uniform(0.0, 1.0) @ "u"


# -- Mask: the value and its algebra ---------------------------------------------


def _mask_ops(M, A):
    """The cases of `tests/core/test_mask.py`, built with one package's
    `Mask` (`M`) and array constructor (`A`)."""
    T, F = A(True), A(False)
    vec = lambda *v: A(list(v))  # noqa: E731
    return {
        "build_true_flattens": lambda: M.build(A(3.0), True).flatten(),
        "build_false_flattens": lambda: M.build(A(3.0), False).flatten(),
        "build_dynamic": lambda: M.build(A(3.0), T).flatten(),
        "build_nested_and": lambda: M.build(M.build(A(1.0), T), F),
        "maybe_mask_true": lambda: M.maybe_mask(A(2.0), True),
        "maybe_mask_false": lambda: M.maybe_mask(A(2.0), False),
        "unmask_default_invalid": lambda: M(A(3.0), F).unmask(default=A(9.0)),
        "unmask_default_valid": lambda: M(A(3.0), T).unmask(default=A(9.0)),
        "unmask_vector": lambda: M(vec(0.0, 1.0, 2.0), vec(True, False, True)).unmask(default=A(-1.0)),
        "getitem_vector": lambda: M(vec(0.0, 1.0, 2.0), vec(True, False, True))[1],
        "getitem_matrix_rows": lambda: M(A([[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]), vec(True, False, True))[2],
        "or_concrete": lambda: M(A(1.0), True) | M(A(2.0), True),
        "or_concrete_invalid_left": lambda: M(A(1.0), False) | M(A(2.0), True),
        "or_dynamic": lambda: M(A(1.0), F) | M(A(2.0), T),
        "or_vector": lambda: M(vec(1.0, 2.0, 3.0), vec(True, False, True)) | M(vec(4.0, 5.0, 6.0), vec(False, True, False)),
        "xor": lambda: M(A(1.0), T) ^ M(A(2.0), F),
        "xor_both_true": lambda: M(A(1.0), T) ^ M(A(2.0), T),
        "xor_vector": lambda: M(vec(1.0, 2.0), vec(True, True)) ^ M(vec(4.0, 5.0), vec(False, True)),
        "invert": lambda: ~M(A(1.0), T),
        "or_n": lambda: M.or_n(M(A(1.0), F), M(A(2.0), F), M(A(3.0), T)),
        "xor_n": lambda: M.xor_n(M(A(1.0), F), M(A(2.0), T), M(A(3.0), F)),
        "tuple_value": lambda: M((A(1.0), vec(2.0, 3.0)), F) | M((A(4.0), vec(5.0, 6.0)), T),
    }


def _mask_parts(x):
    """A comparable form: None, a bare value, or (value leaves, flag)."""
    if x is None:
        return None
    if isinstance(x, (JM, TM)):
        leaves = jax.tree_util.tree_leaves(x.value) if isinstance(x, JM) else torch.utils._pytree.tree_leaves(x.value)
        flag = x.flag if isinstance(x.flag, bool) else bool(np.all(_np(x.flag))) if _np(x.flag).ndim == 0 else _np(x.flag)
        return [_np(v) for v in leaves], flag
    return _np(x)


@pytest.mark.parametrize("case", sorted(_mask_ops(JM, jnp.asarray)))
def test_mask_algebra_like_jax(case):
    got = _mask_parts(_mask_ops(TM, torch.tensor)[case]())
    ref = _mask_parts(_mask_ops(JM, jnp.asarray)[case]())
    if ref is None or got is None:
        assert got is None and ref is None, (got, ref)
    elif isinstance(ref, tuple):
        assert isinstance(got, tuple), got
        for g, r in zip(got[0], ref[0]):
            _close(g, r)
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    else:
        _close(got, ref)


@pytest.mark.parametrize(
    "bad,error",
    [
        (lambda M, A: M(M(A(1.0), True), True), AssertionError),
        (lambda M, A: M(A(np.zeros((4, 3), np.float32)), A([True, False, True])), ValueError),
        (lambda M, A: M((A(1.0), A(2.0)), A(True)) | M((A(1.0), (A(2.0), A(3.0))), A(True)), ValueError),
        (lambda M, A: M(A(np.zeros(2, np.float32)), A(True)) | M(A(np.zeros(3, np.float32)), A(True)), ValueError),
    ],
    ids=["mask_of_mask", "flag_does_not_cover", "structure_mismatch", "shape_mismatch"],
)
def test_mask_misuse_raises_like_jax(bad, error):
    with pytest.raises(error):
        bad(JM, jnp.asarray)
    with pytest.raises(error):
        bad(TM, torch.tensor)


def test_mask_with_a_particle_axis_keeps_its_record():
    flag = PP(torch.tensor([True, False, True]))
    m = TM(PP(torch.arange(6.0).reshape(3, 2)), flag)
    assert m.record == (1,) and m.flag_depth == 1
    # The flag covers the particle axis only; each particle's value is
    # selected whole.
    np.testing.assert_array_equal(m.unmask(default=-1.0).numpy(), [[0.0, 1.0], [-1.0, -1.0], [4.0, 5.0]])
    union = m | TM(PP(torch.full((3, 2), 9.0)), PP(torch.tensor([False, True, False])))
    assert union.flag.tolist() == [True, True, True]
    np.testing.assert_array_equal(union.value.numpy(), [[0.0, 1.0], [9.0, 9.0], [4.0, 5.0]])


# -- choice maps and selections ------------------------------------------------


def _chm_cases(C, B, A):
    return {
        "switch_concrete": lambda: C.switch(1, [C.kw(x=A(1.0)), C.kw(x=A(3.0))])["x"],
        "switch_dynamic_x": lambda: C.switch(A(1), [C.d({"x": A(1.0), "y": A(2.0)}), C.d({"x": A(3.0), "y": A(4.0)}),
                                                    C.d({"x": A(5.0), "y": A(6.0)})])["x"],
        "switch_dynamic_y": lambda: C.switch(A(2), [C.d({"x": A(1.0), "y": A(2.0)}), C.d({"x": A(3.0), "y": A(4.0)}),
                                                    C.d({"x": A(5.0), "y": A(6.0)})])["y"],
        "switch_branch_only_address": lambda: C.switch(A(0), [C.kw(v=A(1.0)), C.kw(u=A(2.0))])["u"],
        "mask_true": lambda: C.kw(x=A(1.0)).mask(True)["x"],
        "mask_dynamic_false": lambda: C.kw(x=A(1.0)).mask(A(False))("x").get_value(),
        "mask_dynamic_true_nested": lambda: C.d({("a", "b"): A(2.0)}).mask(A(True))["a", "b"],
        "filter_by_flag": lambda: C.kw(x=A(1.0), y=A(2.0)).filter(A(False))["y"],
        "filter_by_selection": lambda: C.kw(x=A(1.0), y=A(2.0)).filter(JS["x"] if C is JC else TS["x"])["x"],
        "or_masked_left": lambda: (C.kw(x=A(1.0)).mask(A(False)) | C.kw(x=A(2.0)))["x"],
        "or_masked_both": lambda: (C.kw(x=A(1.0)).mask(A(True)) | C.kw(x=A(2.0)).mask(A(False)))["x"],
        "or_switch_and_static": lambda: (C.switch(A(1), [C.kw(v=A(1.0)), C.kw(v=A(2.0))]) | C.kw(w=A(3.0)))["w"],
        "builder_set": lambda: (B["a", "b"].set(A(3.0)) | B["a", "b"].set(A(4.0)))["a", "b"],
        "builder_switch": lambda: B["k"].switch(1, [C.kw(mu=A(0.5)), C.kw(mu1=A(1.5))])["k", "mu1"],
        "builder_at": lambda: C.kw(x=A(1.0)).at["y"].set(A(2.0))["y"],
        "builder_nested_switch": lambda: (B["mk"].set(C.switch(A(0), [B["v"].set(A(1.0)), B["u"].set(A(2.0))]))
                                          | B["on"].set(A(True)))["mk", "v"],
    }


def _value(x):
    if isinstance(x, (JM, TM)):
        return _np(x.value), np.asarray(_np(x.flag)) if not isinstance(x.flag, bool) else x.flag
    return _np(x), True


@pytest.mark.parametrize("case", sorted(_chm_cases(JC, JB, jnp.asarray)))
def test_choice_map_switch_and_mask_like_jax(case):
    got = _value(_chm_cases(TC, TB, torch.tensor)[case]())
    ref = _value(_chm_cases(JC, JB, jnp.asarray)[case]())
    _close(got[0], ref[0])
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))


@pytest.mark.parametrize(
    "make",
    [
        lambda C, B, A: C.switch(A(0), [B["v"].set(A(1.0)), B["u"].set(A(2.0))]).filter(
            (JS if C is JC else TS)["other"]),
        lambda C, B, A: C.switch(A(0), [C.empty(), C.empty()]),
        lambda C, B, A: C.kw(x=A(1.0)).mask(False),
    ],
    ids=["filtered_switch_husk", "switch_of_empties", "mask_false"],
)
def test_empty_switch_and_mask_collapse_like_jax(make):
    assert make(JC, JB, jnp.asarray).static_is_empty()
    assert make(TC, TB, torch.tensor).static_is_empty()


def test_filtered_husk_is_pruned_under_a_static_node():
    for C, B, S, A in ((JC, JB, JS, jnp.asarray), (TC, TB, TS, torch.tensor)):
        chm = B["mk"].set(C.switch(A(0), [B["v"].set(A(1.0)), B["u"].set(A(2.0))])) | B["on"].set(A(True))
        assert set(chm.filter(S["on"]).children) == {"on"}
        kept = C.switch(A(0), [B["v"].set(A(1.0)), C.empty()])
        assert not kept.static_is_empty() and kept("v").get_value() is not None


def test_switch_node_over_particles_masks_each_branch():
    idx, xs, zs = _data()
    chm = TC.switch(PP(torch.tensor(idx)), [TC.kw(x=PP(torch.tensor(xs))), TC.kw(x=PP(torch.tensor(zs)), z=PP(torch.tensor(zs)))])
    assert isinstance(chm, TSwitchChm) and chm.depth == 1
    x = chm["x"]
    np.testing.assert_array_equal(x.value.numpy(), np.where(idx == 0, xs, zs))
    assert x.flag.tolist() == [True] * K
    assert chm["z"].flag.tolist() == (idx == 1).tolist()
    jx = jax.vmap(lambda i, a, b: JC.switch(i, [JC.kw(x=a), JC.kw(x=b, z=b)])["x"].value)(idx, xs, zs)
    np.testing.assert_array_equal(x.value.numpy(), np.asarray(jx))
    assert isinstance(JC.switch(jnp.asarray(1), [JC.kw(x=1.0), JC.kw(x=2.0)]), JSwitchChm)


def test_masked_selection_like_jax():
    for flag in (True, False):
        j = JMaskedSel.build(JS["x"], flag)
        t = TMaskedSel.build(TS["x"], flag)
        assert bool(j["x"]) == bool(t["x"]) == flag
    j = JMaskedSel.build(JS["x"], jnp.asarray([True, False]))
    t = TMaskedSel.build(TS["x"], torch.tensor([True, False]))
    assert isinstance(t, TMaskedSel) and isinstance(j, JMaskedSel)
    np.testing.assert_array_equal(t("x").check().numpy(), np.asarray(j("x").check()))
    assert t("y").check() is False
    # A masked selection filters a map into masked values.
    got = TC.kw(x=torch.tensor([1.0, 2.0])).filter(t)["x"]
    ref = JC.kw(x=jnp.asarray([1.0, 2.0])).filter(j)["x"]
    np.testing.assert_array_equal(got.flag.numpy(), np.asarray(ref.flag))


# -- Switch ---------------------------------------------------------------------


@pytest.mark.parametrize("i", [0, 1])
def test_switch_assess_one_branch_like_jax(i):
    sample = dict(x=0.7, z=-0.2)
    js, jr = J_SW.assess(JC.kw(**sample), J_ARGS(jnp.int32(i)))
    for index in (i, torch.tensor(i)):
        ts, tr = T_SW.assess(TC.kw(**{k: torch.tensor(v) for k, v in sample.items()}), T_ARGS(index))
        _close(ts, js)
        _close(tr, jr)


def test_switch_assess_per_particle_like_jax():
    idx, xs, zs = _data()
    js, jr = jax.vmap(lambda i, x, z: J_SW.assess(JC.kw(x=x, z=z), J_ARGS(i)))(idx, xs, zs)
    ts, tr = T_SW.assess(TC.kw(x=PP(torch.tensor(xs)), z=PP(torch.tensor(zs))), T_ARGS(PP(torch.tensor(idx))), n=K)
    _close(ts, js)
    _close(tr, jr)


def test_switch_simulate_scores_its_own_choices_like_jax():
    idx = _data()[0]
    tr = T_SW.simulate(_rng(1), T_ARGS(PP(torch.tensor(idx))), n=K)
    chm = tr.get_choices()
    x, z = chm["x"], chm["z"]
    assert x.flag.tolist() == [True] * K and z.flag.tolist() == (idx == 1).tolist()
    js, jr = jax.vmap(lambda i, a, b: J_SW.assess(JC.kw(x=a, z=b), J_ARGS(i)))(idx, x.value.numpy(), z.value.numpy())
    _close(tr.get_score(), js)
    _close(tr.get_retval(), jr)
    # Every branch's subtrace is kept for every particle.
    assert [s.get_score().shape for s in tr.subtraces] == [(K,), (K,)]


def _traces(idx, xs, zs):
    """The same fully constrained traces on both sides."""
    jtr, jw = jax.vmap(lambda i, a, b: J_SW.generate(KEY, JC.kw(x=a, z=b), J_ARGS(i)))(idx, xs, zs)
    ttr, tw = T_SW.generate(_rng(), TC.kw(x=PP(torch.tensor(xs)), z=PP(torch.tensor(zs))), T_ARGS(PP(torch.tensor(idx))), n=K)
    _close(tw, jw)
    _close(ttr.get_score(), jtr.get_score())
    return jtr, ttr


def test_switch_generate_weights_like_jax():
    idx, xs, _ = _data()
    jw = jax.vmap(lambda i, a: J_SW.generate(KEY, JC.kw(x=a), J_ARGS(i))[1])(idx, xs)
    tr, tw = T_SW.generate(_rng(2), TC.kw(x=PP(torch.tensor(xs))), T_ARGS(PP(torch.tensor(idx))), n=K)
    _close(tw, jw)  # the weight is x's density alone: z is drawn fresh where branch 1 runs
    np.testing.assert_array_equal(tr.get_choices()["x"].value.numpy(), xs)


@pytest.mark.parametrize("sel", ["x", "z"])
def test_switch_project_like_jax(sel):
    idx, xs, zs = _data()
    jtr, ttr = _traces(idx, xs, zs)
    jw = jax.vmap(lambda t: t.project(KEY, JS[sel]))(jtr)
    _close(ttr.project(_rng(), TS[sel]), jw)


def test_switch_same_branch_update_like_jax():
    idx, xs, zs = _data()
    jtr, ttr = _traces(idx, xs, zs)
    new_x = (xs + 0.5).astype(np.float32)
    jnew, jw, _, jbwd = jax.vmap(
        lambda t, a: jgx.Update(JC.kw(x=a)).edit(KEY, t, jgx.Diff.no_change(t.get_args())))(jtr, new_x)
    tnew, tw, _, tbwd = tgx.Update(TC.kw(x=PP(torch.tensor(new_x)))).edit(_rng(), ttr, tgx.Diff.no_change(ttr.get_args()))
    _close(tw, jw)
    _close(tnew.get_score(), jnew.get_score())
    _close(tnew.get_retval(), jnew.get_retval())
    # The backward request puts the old x back.
    _close(tbwd.constraint["x"].value, xs)
    back, w_back, _, _ = tbwd.edit(_rng(), tnew, tgx.Diff.no_change(tnew.get_args()))
    _close(w_back, -tw.numpy())


def test_switch_index_changing_update_like_jax():
    idx, xs, zs = _data()
    jtr, ttr = _traces(idx, xs, zs)
    new_idx = np.array([1, 1, 0, 0, 1, 1, 0, 0], dtype=np.int32)  # moves half the particles, both ways
    new_x, new_z = (xs - 0.25).astype(np.float32), (zs + 0.75).astype(np.float32)

    def j_edit(t, i, a, b):
        diffs = (jgx.Diff.unknown_change(i), jgx.Diff.no_change((MU,)), jgx.Diff.no_change((MU,)))
        return jgx.Update(JC.kw(x=a, z=b)).edit(KEY, t, diffs)

    jnew, jw, _, _ = jax.vmap(j_edit)(jtr, new_idx, new_x, new_z)
    diffs = (tgx.Diff.unknown_change(PP(torch.tensor(new_idx))), tgx.Diff.no_change((MU,)), tgx.Diff.no_change((MU,)))
    tnew, tw, _, tbwd = tgx.Update(TC.kw(x=PP(torch.tensor(new_x)), z=PP(torch.tensor(new_z)))).edit(_rng(), ttr, diffs)
    _close(tw, jw)
    _close(tnew.get_score(), jnew.get_score())
    _close(tnew.get_retval(), jnew.get_retval())
    moved = new_idx != idx
    # Where the branch moved the weight is the change of the score.
    _close(tw.numpy()[moved], (tnew.get_score() - ttr.get_score()).numpy()[moved])
    assert tnew.get_idx().tolist() == new_idx.tolist()
    # The backward request holds the old choices where the branch moved.
    back_x = tbwd.constraint["x"]
    np.testing.assert_array_equal(back_x.value.numpy()[moved], xs[moved])


def test_switch_empty_update_with_the_index_unchanged_keeps_the_trace():
    idx, xs, zs = _data()
    _, ttr = _traces(idx, xs, zs)
    new, w, _, _ = tgx.Update(TC.empty()).edit(_rng(5), ttr, tgx.Diff.no_change(ttr.get_args()))
    _close(w, np.zeros(K))
    _close(new.get_score(), ttr.get_score().numpy())
    np.testing.assert_array_equal(new.get_choices()["z"].value.numpy(), ttr.get_choices()["z"].value.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_switch_block_regenerate_weight_is_the_score_change(seed):
    idx = _data(seed)[0]
    block = TS["x"] | TS["z"]
    tr = T_SW.simulate(_rng(seed), T_ARGS(PP(torch.tensor(idx))), n=K)
    new_idx = PP(torch.tensor(1 - idx))
    diffs = (tgx.Diff.unknown_change(new_idx), tgx.Diff.no_change((MU,)), tgx.Diff.no_change((MU,)))
    for d in (tgx.Diff.no_change(tr.get_args()), diffs):
        new, w, _, _ = tgx.Regenerate(block).edit(_rng(seed + 10), tr, d)
        _close(w, (new.get_score() - tr.get_score()).numpy(), 1e-5)
    if seed:
        return  # JAX's convention, once
    jtr = J_SW.simulate(jax.random.key(seed), J_ARGS(jnp.int32(idx[0])))
    jnew, jw, _, _ = jgx.Regenerate(JS["x"] | JS["z"]).edit(jax.random.key(seed + 10), jtr, jgx.Diff.no_change(jtr.get_args()))
    _close(jw, jnew.get_score() - jtr.get_score(), 1e-5)


def test_switch_with_an_int_index_runs_one_branch_into_a_zero_template():
    tr = T_SW.simulate(_rng(3), T_ARGS(1))
    assert [type(s).__name__ for s in tr.subtraces] == ["StaticTrace", "StaticTrace"]
    assert float(tr.subtraces[0].get_score()) == 0.0 and float(tr.get_score()) == float(tr.subtraces[1].get_score())
    chm = tr.get_choices()
    assert "z" in chm and float(chm["z"]) == float(tr.subtraces[1].get_choices()["z"])
    js, _ = J_SW.assess(JC.kw(x=float(chm["x"]), z=float(chm["z"])), J_ARGS(jnp.int32(1)))
    _close(tr.get_score(), js)


@pytest.mark.parametrize("old,new", [(0, 0), (1, 1), (0, 1), (1, 0)])
def test_switch_update_with_int_indices_like_jax(old, new):
    """Both indices known on the host: the one branch is edited in place
    (kept) or by the fresh path (moved), its new sites constrained."""
    sample = dict(x=0.7, z=-0.2)
    jtr, _ = J_SW.generate(KEY, JC.kw(**sample), J_ARGS(jnp.int32(old)))
    ttr, _ = T_SW.generate(_rng(), TC.kw(**{k: torch.tensor(v) for k, v in sample.items()}), T_ARGS(old))
    diffs_j = (jgx.Diff.unknown_change(jnp.int32(new)), jgx.Diff.no_change((MU,)), jgx.Diff.no_change((MU,)))
    diffs_t = (tgx.Diff.unknown_change(new), tgx.Diff.no_change((MU,)), tgx.Diff.no_change((MU,)))
    jnew, jw, _, _ = jgx.Update(JC.kw(x=1.1, z=0.3)).edit(KEY, jtr, diffs_j)
    tnew, tw, _, bwd = tgx.Update(TC.kw(x=torch.tensor(1.1), z=torch.tensor(0.3))).edit(_rng(), ttr, diffs_t)
    _close(tw, jw)
    _close(tnew.get_score(), jnew.get_score())
    _close(tnew.get_retval(), jnew.get_retval())
    back, w_back, _, _ = bwd.edit(_rng(), tnew, (tgx.Diff.unknown_change(old), *diffs_t[1:]))
    _close(w_back, -float(tw))
    _close(back.get_score(), ttr.get_score())


def test_unsupported_backward_request_raises_when_run():
    _, ttr = _traces(*_data())
    with pytest.raises(tgx.core.concepts.NotSupportedEditRequest, match="not representable"):
        tgx.UnsupportedBackwardRequest("branches differ").edit(_rng(), ttr, tgx.Diff.no_change(ttr.get_args()))


# -- R7: the index out of range ----------------------------------------------------


@jgx.gen
def j_lo():
    return jgx.normal(0.0, 1.0) @ "v"


@jgx.gen
def j_hi():
    return jgx.normal(5.0, 1.0) @ "v"


@tgx.gen
def t_lo():
    return tgx.normal(0.0, 1.0) @ "v"


@tgx.gen
def t_hi():
    return tgx.normal(5.0, 1.0) @ "v"


@pytest.mark.parametrize("index,clamped", [(2, 1), (-1, 0)])
def test_out_of_range_index_reference_and_port(index, clamped):
    """The reference as it stands: `multi_switch` clamps the index for the
    run while `tree_choose` wraps it for the select, so the retval and the
    score are another branch's zero template, `"v"` reads as absent, and
    `assess` scores 0. The port clamps once, where the index enters."""
    j_sw = jgx.switch(j_lo, j_hi)
    jtr = j_sw.simulate(jax.random.key(0), (jnp.int32(index), (), ()))
    assert float(jtr.get_retval()) == 0.0 and float(jtr.get_score()) == 0.0
    assert not bool(jtr.get_choices()["v"].flag)
    js, _ = j_sw.assess(JC.kw(v=5.0), (jnp.int32(index), (), ()))
    assert float(js) == 0.0

    t_sw = tgx.switch(t_lo, t_hi)
    for i in (index, torch.tensor(index)):
        tr = t_sw.simulate(_rng(0), (i, (), ()))
        ref = t_sw.simulate(_rng(0), (clamped, (), ()))
        assert float(tr.get_retval()) == float(ref.get_retval()) and float(tr.get_score()) == float(ref.get_score())
        assert float(tr.get_score()) != 0.0 and "v" in tr.get_choices()
        ts, _ = t_sw.assess(TC.kw(v=torch.tensor(5.0)), (i, (), ()))
        js_clamped, _ = j_sw.assess(JC.kw(v=5.0), (jnp.int32(clamped), (), ()))
        _close(ts, js_clamped)
    # Per particle, the clamped index is what the trace stores and uses.
    tr = t_sw.simulate(_rng(0), (PP(torch.tensor([index, clamped])), (), ()), n=2)
    assert tr.get_idx().tolist() == [clamped, clamped]
    assert torch.equal(tr.get_retval()[0] > 2.5, tr.get_retval()[1] > 2.5)


# -- MaskCombinator: the four-case lattice -------------------------------------------

LATTICE = [(pre, post, u0, u1) for pre in (True, False) for post in (True, False) for u0 in (0.5, 2.0) for u1 in (0.25, 2.0)]


def _lattice_jax(pre, post, u0, u1):
    masked = j_unif.mask()
    tr, w0 = masked.generate(KEY, JC.kw(u=u0), (pre,))
    new, w, _, _ = jgx.Update(JC.kw(u=u1)).edit(KEY, tr, (jgx.Diff.unknown_change(post),))
    return tr.get_score(), w0, new.get_score(), w


def _both_out(pre, post, u0, u1):
    """T->T from an out-of-support value to another: the inner weight is
    -inf - -inf, NaN on both sides (the distribution's, not the mask's)."""
    return np.asarray(pre) & np.asarray(post) & (np.asarray(u0) == 2.0) & (np.asarray(u1) == 2.0)


@pytest.mark.parametrize("flags", ["bool", "tensor"])
@pytest.mark.parametrize("pre,post,u0,u1", LATTICE)
def test_mask_edit_lattice_like_jax(pre, post, u0, u1, flags):
    """u0 or u1 = 2.0 lies outside the uniform's support: an inner score of
    -inf, which a masked-off side must turn into 0, never NaN."""
    wrap = (lambda f: f) if flags == "bool" else torch.tensor
    masked = t_unif.mask()
    tr, w0 = masked.generate(_rng(), TC.kw(u=torch.tensor(u0)), (wrap(pre),))
    new, w, _, bwd = tgx.Update(TC.kw(u=torch.tensor(u1))).edit(_rng(), tr, (tgx.Diff.unknown_change(wrap(post)),))
    ref = _lattice_jax(pre, post, u0, u1)
    for got, r in zip((tr.get_score(), w0, new.get_score(), w), ref):
        _close(got, r, nan_at=_both_out(pre, post, u0, u1))
    # The backward update puts u0 back where the new flag holds; a concrete
    # False flag leaves it empty.
    if post is False and flags == "bool":
        assert bwd.constraint.static_is_empty()
    else:
        held = bwd.constraint["u"]
        value, flag = (held.value, held.flag) if isinstance(held, tgx.Mask) else (held, True)
        assert float(value) == u0 and bool(flag) == post


def test_mask_edit_lattice_per_particle_like_jax():
    pre, post, u0, u1 = (np.array(c) for c in zip(*LATTICE))
    u0, u1 = u0.astype(np.float32), u1.astype(np.float32)
    refs = [np.array(r) for r in zip(*(_lattice_jax(*case) for case in LATTICE))]
    masked = t_unif.mask()
    n = len(LATTICE)
    tr, w0 = masked.generate(_rng(), TC.kw(u=PP(torch.tensor(u0))), (PP(torch.tensor(pre)),), n=n)
    new, w, _, bwd = tgx.Update(TC.kw(u=PP(torch.tensor(u1)))).edit(
        _rng(), tr, (tgx.Diff.unknown_change(PP(torch.tensor(post))),))
    for got, r in zip((tr.get_score(), w0, new.get_score(), w), refs):
        _close(got, r, nan_at=_both_out(pre, post, u0, u1))
    # The backward update holds where the new flag does.
    assert bwd.constraint["u"].flag.tolist() == post.tolist()
    ret = new.get_retval()
    assert isinstance(ret, tgx.Mask) and ret.flag.tolist() == post.tolist()


@pytest.mark.parametrize("flag", [True, False])
def test_mask_assess_and_project_like_jax(flag):
    for u in (0.5, 2.0):
        js, jr = j_unif.mask().assess(JC.kw(u=u), (jnp.asarray(flag),))
        ts, tr = t_unif.mask().assess(TC.kw(u=torch.tensor(u)), (torch.tensor(flag),))
        _close(ts, js)
        assert bool(tr.flag) == bool(jr.flag) and float(tr.value) == float(jr.value)
        jtr, _ = j_unif.mask().generate(KEY, JC.kw(u=u), (flag,))
        ttr, _ = t_unif.mask().generate(_rng(), TC.kw(u=torch.tensor(u)), (flag,))
        _close(ttr.project(_rng(), TS["u"]), jtr.project(KEY, JS["u"]))
        assert ("u" in ttr.get_choices()) == flag


# -- mix and or_else ------------------------------------------------------------------

LOGITS = np.array([0.3, -0.2], dtype=np.float32)


@jgx.gen
def j_na():
    return jgx.normal(0.0, 1.0) @ "v"


@jgx.gen
def j_wi():
    return jgx.normal(5.0, 2.0) @ "v"


@tgx.gen
def t_na():
    return tgx.normal(0.0, 1.0) @ "v"


@tgx.gen
def t_wi():
    return tgx.normal(5.0, 2.0) @ "v"


def test_mix_log_density_like_jax():
    idx, xs, _ = _data(3)
    j_mix, t_mix = jgx.mix(j_na, j_wi), tgx.mix(t_na, t_wi)

    def j_one(c, v):
        return j_mix.assess(JC.kw(mixture_component=c) | JB["component_sample", "v"].set(v), (jnp.asarray(LOGITS), (), ()))

    js, jr = jax.vmap(j_one)(idx, xs)
    sample = TC.kw(mixture_component=PP(torch.tensor(idx, dtype=torch.int64))) | TB["component_sample", "v"].set(PP(torch.tensor(xs)))
    ts, tr = t_mix.assess(sample, (torch.tensor(LOGITS), (), ()), n=K)
    _close(ts, js)
    _close(tr, jr)
    # And the closed form: log softmax(logits)_c + log N(v; mu_c, sigma_c).
    mu, sig = np.array([0.0, 5.0])[idx], np.array([1.0, 2.0])[idx]
    log_prior = LOGITS - np.log(np.exp(LOGITS).sum())
    exact = log_prior[idx] - 0.5 * ((xs - mu) / sig) ** 2 - np.log(sig) - 0.5 * np.log(2 * np.pi)
    _close(ts, exact)


def test_mix_generate_weight_like_jax():
    idx, xs, _ = _data(4)
    j_mix, t_mix = jgx.mix(j_na, j_wi), tgx.mix(t_na, t_wi)
    jw = jax.vmap(lambda c, v: j_mix.generate(
        KEY, JC.kw(mixture_component=c) | JB["component_sample", "v"].set(v), (jnp.asarray(LOGITS), (), ()))[1])(idx, xs)
    sample = TC.kw(mixture_component=PP(torch.tensor(idx, dtype=torch.int64))) | TB["component_sample", "v"].set(PP(torch.tensor(xs)))
    tr, tw = t_mix.generate(_rng(), sample, (torch.tensor(LOGITS), (), ()), n=K)
    _close(tw, jw)
    _close(tr.get_score(), jw)


@pytest.mark.parametrize("flag", [True, False])
def test_or_else_log_density_like_jax(flag):
    j_oe, t_oe = jgx.or_else(j_b0, j_b1), tgx.or_else(t_b0, t_b1)
    js, jr = j_oe.assess(JC.kw(x=0.4, z=1.1), (jnp.asarray(flag), (MU,), (MU,)))
    for f in (flag, torch.tensor(flag)):
        ts, tr = t_oe.assess(TC.kw(x=torch.tensor(0.4), z=torch.tensor(1.1)), (f, (MU,), (MU,)))
        _close(ts, js)
        _close(tr, jr)


def test_or_else_per_particle_like_jax():
    idx, xs, zs = _data(5)
    flags = idx == 0
    j_oe, t_oe = jgx.or_else(j_b0, j_b1), tgx.or_else(t_b0, t_b1)
    js, _ = jax.vmap(lambda f, a, b: j_oe.assess(JC.kw(x=a, z=b), (f, (MU,), (MU,))))(flags, xs, zs)
    ts, _ = t_oe.assess(TC.kw(x=PP(torch.tensor(xs)), z=PP(torch.tensor(zs))), (PP(torch.tensor(flags)), (MU,), (MU,)), n=K)
    _close(ts, js)
    tr = t_oe.simulate(_rng(6), (PP(torch.tensor(flags)), (MU,), (MU,)), n=K)
    assert (tr.get_choices()["z"].flag.numpy() == ~flags).all()


# -- masked_iterate ---------------------------------------------------------------------

T_STEPS = 5
FLAGS = np.array([True, False, True, True, False])


@jgx.gen
def j_step(x):
    return jgx.normal(x, 1.0) @ "x"


@tgx.gen
def t_step(x):
    return tgx.normal(x, 1.0) @ "x"


@pytest.mark.parametrize("final", [False, True], ids=["masked_iterate", "masked_iterate_final"])
def test_masked_iterate_assess_like_jax(final):
    xs = np.random.default_rng(7).standard_normal(T_STEPS).astype(np.float32)
    j_fn = (jgx.masked_iterate_final if final else jgx.masked_iterate)()(j_step)
    t_fn = (tgx.masked_iterate_final if final else tgx.masked_iterate)()(t_step)
    js, jr = j_fn.assess(JC.kw(x=jnp.asarray(xs)), (jnp.float32(0.2), jnp.asarray(FLAGS)))
    ts, tr = t_fn.assess(TC.kw(x=torch.tensor(xs)), (torch.tensor(0.2), torch.tensor(FLAGS)))
    _close(ts, js)
    _close(tr, jr)
    # The masked-out steps add nothing: the score is the flagged steps' sum.
    prev = np.concatenate([[0.2], xs[:-1]])
    terms = -0.5 * (xs - prev) ** 2 - 0.5 * np.log(2 * np.pi)
    _close(ts, terms[FLAGS].sum())


@pytest.mark.parametrize("final", [False, True], ids=["masked_iterate", "masked_iterate_final"])
def test_masked_iterate_over_particles_like_jax(final):
    rng = np.random.default_rng(8)
    xs = rng.standard_normal((K, T_STEPS)).astype(np.float32)
    x0 = rng.standard_normal(K).astype(np.float32)
    j_fn = (jgx.masked_iterate_final if final else jgx.masked_iterate)()(j_step)
    t_fn = (tgx.masked_iterate_final if final else tgx.masked_iterate)()(t_step)
    js, jr = jax.vmap(lambda a, b: j_fn.assess(JC.kw(x=a), (b, jnp.asarray(FLAGS))))(xs, x0)
    ts, tr = t_fn.assess(TC.kw(x=PP(torch.tensor(xs))), (PP(torch.tensor(x0)), torch.tensor(FLAGS)), n=K)
    _close(ts, js)
    _close(tr, jr)
    tr_sim = t_fn.simulate(_rng(9), (PP(torch.tensor(x0)), torch.tensor(FLAGS)), n=K)
    sim_x = tr_sim.get_choices()["x"]
    sim_x = sim_x.value if isinstance(sim_x, tgx.Mask) else sim_x
    js2, _ = jax.vmap(lambda a, b: j_fn.assess(JC.kw(x=a), (b, jnp.asarray(FLAGS))))(sim_x.numpy(), x0)
    _close(tr_sim.get_score(), js2)


@pytest.mark.parametrize("branch", [0, 1])
def test_inner_trace_of_a_switch_with_a_0d_index_tensor_like_jax(branch):
    """`get_subtrace` names the branch a 0-d index tensor holds (JAX reads
    `subtraces[idx]`); an index with a batch axis names a branch per row,
    and the refusal points to the choices, whose `Switch` node selects."""
    _, xs, zs = _data()
    j_chm = JC.kw(x=jnp.asarray(xs[0])) if branch == 0 else JC.kw(x=jnp.asarray(xs[0]), z=jnp.asarray(zs[0]))
    t_chm = TC.kw(x=torch.tensor(xs[0])) if branch == 0 else TC.kw(x=torch.tensor(xs[0]), z=torch.tensor(zs[0]))
    j_tr, _ = J_SW.importance(KEY, j_chm, J_ARGS(jnp.asarray(branch)))
    t_tr, _ = T_SW.importance(_rng(), t_chm, T_ARGS(torch.tensor(branch)))
    _close(t_tr.get_subtrace("x").get_score(), j_tr.get_subtrace("x").get_score())
    _close(t_tr.get_subtrace("x").get_retval(), j_tr.get_subtrace("x").get_retval())
    idx, _, _ = _data()
    batched = T_SW.simulate(_rng(1), T_ARGS(PP(torch.tensor(idx, dtype=torch.int64))), n=K)
    with pytest.raises(NotImplementedError, match="get_choices"):
        batched.get_subtrace("x")
