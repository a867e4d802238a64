"""Incremental edits (`lang/analysis.py`, the edit plan of
`lang/static.py`) against `genjax_tpu` on the CPU, case for case after
`tests/lang/test_incremental_edit.py`, `tests/lang/test_nested_incremental.py`
and `tests/lang/test_analysis_cache.py`.

Both packages run the same models on the same numpy-made choices: the
site graphs (order, dependencies, the sites that read the arguments, the
return value's dependencies, per-leaf argument masks) must be equal;
weights of edits of fixed choices agree within 1e-6 relative (float32);
where JAX shows that an edit reuses a subtrace (`is`), the port must too,
and where JAX proves a retdiff `NoChange`, so must the port. Where JAX
counts equations of a jaxpr, the port counts what it runs instead: density
calls of a counting distribution, operations dispatched (`TorchDispatchMode`),
branch executions.

Each place where the analysis cannot follow the model (a value that
reaches Python, an in-place write into an untracked tensor, an `out=`,
a request not known without running it) must fall back to the dense plan,
be counted in `analysis.stats()`, and still give the right weight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.lang.analysis import site_graph as jsite_graph
from genjax_tpu_torch.lang import analysis
from genjax_tpu_torch.lang import static as tstatic
from genjax_tpu_torch.lang.analysis import site_graph as tsite_graph

torch.set_num_threads(1)

J, T = jgx, tgx
TOL = 1e-6


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), (got, ref)


def _graph(g):
    return (
        tuple(g.order),
        {k: frozenset(v) for k, v in g.deps.items()},
        frozenset(g.args_reach),
        frozenset(g.retval_deps),
        bool(g.retval_reads_args),
    )


def _same_graph(jmodel, tmodel, jargs, targs):
    jg, tg = jsite_graph(jmodel.source, jargs), tsite_graph(tmodel.source, targs)
    assert _graph(tg) == _graph(jg)
    return jg, tg


def _traces(jmodel, tmodel, choices: dict, jargs, targs):
    """The same trace in both packages: every address constrained to the
    numpy-made `choices` (a flat dict of address -> float)."""
    jtr, _ = jmodel.generate(jax.random.key(0), J.ChoiceMap.d({k: jnp.float32(v) for k, v in choices.items()}), jargs)
    ttr, _ = tmodel.generate(_rng(), T.ChoiceMap.d({k: torch.tensor(v, dtype=torch.float32) for k, v in choices.items()}),
                             targs)
    _close(ttr.get_score(), jtr.get_score())
    return jtr, ttr


def _count_fallbacks():
    return sum(analysis.stats()["fallbacks"].values())


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ops(fn) -> int:
    with _Ops() as log:
        fn()
    return log.n


_CHOICES = {"a": 0.3, "b": -0.7, "c": 1.1}


@J.gen
def j_chain(mu):
    a = J.normal(mu, 1.0) @ "a"
    b = J.normal(a, 1.0) @ "b"
    J.normal(0.0, 1.0) @ "c"
    return b


@T.gen
def t_chain(mu):
    a = T.normal(mu, 1.0) @ "a"
    b = T.normal(a, 1.0) @ "b"
    T.normal(0.0, 1.0) @ "c"
    return b


# -- TestSiteGraph --------------------------------------------------------------------------------


def test_dependencies():
    _, tg = _same_graph(j_chain, t_chain, (0.0,), (0.0,))
    assert tg.order == ("a", "b", "c") and tg.deps["b"] == frozenset({"a"}) and "c" not in tg.args_reach


@pytest.mark.parametrize("touched,args_changed", [({"a"}, False), ({"c"}, False), (set(), True), ({"b"}, True)])
def test_weight_sets(touched, args_changed):
    jg, tg = _same_graph(j_chain, t_chain, (0.0,), (0.0,))
    assert tg.weight_set(frozenset(touched), args_changed) == jg.weight_set(frozenset(touched), args_changed)


@pytest.mark.parametrize("touched", [{"c"}, {"b"}, {"a"}])
def test_retval_change(touched):
    jg, tg = _same_graph(j_chain, t_chain, (0.0,), (0.0,))
    assert tg.retval_unchanged(frozenset(touched), False) == jg.retval_unchanged(frozenset(touched), False)


# -- TestIncrementalUpdate ------------------------------------------------------------------------


def test_unaffected_subtraces_reused():
    jtr, ttr = _traces(j_chain, t_chain, _CHOICES, (0.0,), (0.0,))
    jnew, jw, jrd, _ = jtr.update(jax.random.key(1), J.ChoiceMap.kw(c=2.0))
    tnew, tw, trd, _ = ttr.update(_rng(1), T.ChoiceMap.kw(c=2.0))
    for addr in ("a", "b"):
        assert jnew.get_subtrace(addr) is jtr.get_subtrace(addr)
        assert tnew.get_subtrace(addr) is ttr.get_subtrace(addr)
    _close(tw, jw)
    assert T.Diff.static_check_no_change(trd) == J.Diff.static_check_no_change(jrd) is True


def test_constraining_a_recomputes_b_not_c():
    jtr, ttr = _traces(j_chain, t_chain, _CHOICES, (0.0,), (0.0,))
    jnew, jw, jrd, _ = jtr.update(jax.random.key(1), J.ChoiceMap.kw(a=1.0))
    tnew, tw, trd, _ = ttr.update(_rng(1), T.ChoiceMap.kw(a=1.0))
    assert tnew.get_subtrace("c") is ttr.get_subtrace("c") and jnew.get_subtrace("c") is jtr.get_subtrace("c")
    assert tnew.get_subtrace("b") is not ttr.get_subtrace("b")
    _close(tw, jw)
    _close(tnew.get_choices()["b"], jnew.get_choices()["b"])
    assert T.Diff.static_check_no_change(trd) == J.Diff.static_check_no_change(jrd) is True


def test_argdiffs_nochange_skips_everything_but_constrained():
    """JAX lowers the edit and finds its density work gone; the port counts
    density calls: an `Update` of "c" under NoChange arguments scores "c"
    alone."""
    calls = []
    counted = T.exact_density(
        lambda rng, loc, scale, n=None: T.normal.sample(rng, loc, scale, n=n),
        lambda v, loc, scale: calls.append(1) or T.normal.logpdf(v, loc, scale),
        "counted_normal",
    )

    @T.gen
    def model(mu):
        a = counted(mu, 1.0) @ "a"
        b = counted(a, 1.0) @ "b"
        counted(0.0, 1.0) @ "c"
        return b

    _, ttr = _traces(j_chain, model, _CHOICES, (0.0,), (0.0,))
    jtr, _ = _traces(j_chain, t_chain, _CHOICES, (0.0,), (0.0,))
    calls.clear()
    _, tw, _, _ = ttr.update(_rng(1), T.ChoiceMap.kw(c=2.0))
    assert len(calls) == 1
    _close(tw, jtr.update(jax.random.key(1), J.ChoiceMap.kw(c=2.0))[1])


def test_update_weight_total_consistency():
    jtr, ttr = _traces(j_chain, t_chain, _CHOICES, (0.5,), (0.5,))
    jnew, jw, _, _ = jtr.update(jax.random.key(1), J.ChoiceMap.kw(b=0.3))
    tnew, tw, _, _ = ttr.update(_rng(1), T.ChoiceMap.kw(b=0.3))
    _close(tw, jw)
    _close(tw, tnew.get_score() - ttr.get_score())


# -- TestIncrementalRegenerate ----------------------------------------------------------------------


def test_regenerate_c_reuses_a_b():
    jtr, ttr = _traces(j_chain, t_chain, _CHOICES, (0.0,), (0.0,))
    jnew, _, jrd, _ = J.Regenerate(J.Selection.at["c"]).edit(jax.random.key(1), jtr, J.Diff.no_change(jtr.get_args()))
    tnew, tw, trd, _ = T.Regenerate(T.Selection.at["c"]).edit(_rng(1), ttr, T.Diff.no_change(ttr.get_args()))
    for addr in ("a", "b"):
        assert jnew.get_subtrace(addr) is jtr.get_subtrace(addr)
        assert tnew.get_subtrace(addr) is ttr.get_subtrace(addr)
    assert T.Diff.static_check_no_change(trd) == J.Diff.static_check_no_change(jrd) is True
    assert float(tnew.get_choices()["c"]) != _CHOICES["c"]
    _close(tw, tnew.get_score() - ttr.get_score())


def test_safe_hmc_static_retdiff():
    from genjax_tpu.inference.requests import HMC as JHMC
    from genjax_tpu_torch.inference.requests import HMC as THMC

    jtr, _ = j_chain.importance(jax.random.key(0), J.ChoiceMap.kw(b=1.0), (0.0,))
    ttr, _ = t_chain.importance(_rng(), T.ChoiceMap.kw(b=1.0), (0.0,))
    _, _, jrd, _ = JHMC(J.Selection.at["c"], jnp.asarray(0.1), L=2).edit(jax.random.key(1), jtr, J.Diff.no_change((0.0,)))
    _, _, trd, _ = THMC(T.Selection.at["c"], 0.1, L=2).edit(_rng(1), ttr, T.Diff.no_change((0.0,)))
    assert T.Diff.static_check_no_change(trd) == J.Diff.static_check_no_change(jrd) is True


# -- TestDynamicFallback ----------------------------------------------------------------------------


def test_switch_constraint_falls_back():
    """A constraint whose addresses the program decides (`ChoiceMap.switch`
    on an index tensor) is not known without running it: the dense plan,
    counted, with the right weight."""
    jtr, ttr = _traces(j_chain, t_chain, _CHOICES, (0.0,), (0.0,))
    jc = J.ChoiceMap.switch(jnp.array(0), [J.ChoiceMap.kw(a=1.0), J.ChoiceMap.kw(b=1.0)])
    tc = T.ChoiceMap.switch(torch.tensor(0), [T.ChoiceMap.kw(a=1.0), T.ChoiceMap.kw(b=1.0)])
    before = _count_fallbacks()
    tnew, tw, _, _ = ttr.update(_rng(1), tc)
    jnew, jw, _, _ = jtr.update(jax.random.key(1), jc)
    assert _count_fallbacks() == before + 1
    assert "not known without running" in " ".join(analysis.stats()["fallbacks"])
    _close(tw, jw)
    _close(tw, tnew.get_score() - ttr.get_score())


# -- TestCompositeRetvalPropagation -----------------------------------------------------------------


@J.gen
def j_passthrough(x):
    b = J.flip(0.5) @ "b"
    return x + jnp.float32(b)


@J.gen
def j_composite_chain(x):
    a = j_passthrough(x) @ "a"
    return J.normal(a, 1.0) @ "c"


@T.gen
def t_passthrough(x):
    b = T.flip(0.5) @ "b"
    return x + b.to(torch.float32)


@T.gen
def t_composite_chain(x):
    a = t_passthrough(x) @ "a"
    return T.normal(a, 1.0) @ "c"


def _composite_traces():
    jtr, _ = j_composite_chain.generate(jax.random.key(0), J.ChoiceMap.d({("a", "b"): True, "c": jnp.float32(0.4)}),
                                        (jnp.float32(0.0),))
    ttr, _ = t_composite_chain.generate(_rng(), T.ChoiceMap.d({("a", "b"): torch.tensor(True), "c": torch.tensor(0.4)}),
                                        (torch.tensor(0.0),))
    _close(ttr.get_score(), jtr.get_score())
    return jtr, ttr


def test_composite_retval_propagates():
    _same_graph(j_composite_chain, t_composite_chain, (jnp.float32(0.0),), (torch.tensor(0.0),))
    jtr, ttr = _composite_traces()
    jnew, jw, _, _ = j_composite_chain.edit(jax.random.key(1), jtr, J.Update(J.ChoiceMap.empty()),
                                            (J.Diff.unknown_change(jnp.float32(3.0)),))
    tnew, tw, _, _ = t_composite_chain.edit(_rng(1), ttr, T.Update(T.ChoiceMap.empty()),
                                            (T.Diff.unknown_change(torch.tensor(3.0)),))
    score, _ = t_composite_chain.assess(tnew.get_choices(), (torch.tensor(3.0),))
    _close(tnew.get_score(), score)
    _close(tw, jw)
    _close(tw, score - ttr.get_score())
    assert bool(tnew.get_choices()["a", "b"]) == bool(ttr.get_choices()["a", "b"])
    _close(tnew.get_choices()["c"], jnew.get_choices()["c"])


def test_distribution_chain_keeps_reuse_under_changed_args():
    jtr, ttr = _traces(j_chain, t_chain, _CHOICES, (0.0,), (0.0,))
    jnew, jw, _, _ = j_chain.edit(jax.random.key(1), jtr, J.Update(J.ChoiceMap.empty()),
                                  (J.Diff.unknown_change(jnp.float32(2.0)),))
    tnew, tw, _, _ = t_chain.edit(_rng(1), ttr, T.Update(T.ChoiceMap.empty()),
                                  (T.Diff.unknown_change(torch.tensor(2.0)),))
    for addr in ("b", "c"):
        assert jnew.get_subtrace(addr) is jtr.get_subtrace(addr)
        assert tnew.get_subtrace(addr) is ttr.get_subtrace(addr)
    score, _ = t_chain.assess(tnew.get_choices(), (torch.tensor(2.0),))
    _close(tnew.get_score(), score)
    _close(tw, jw)


# -- TestPerLeafArgdiffMasks ------------------------------------------------------------------------


@J.gen
def j_mixed_inputs(a, x):
    return J.normal(a + x, 1.0) @ "v"


@J.gen
def j_two_input_site(x):
    a = J.normal(0.0, 1.0) @ "a"
    return j_mixed_inputs(a, x) @ "b"


@T.gen
def t_mixed_inputs(a, x):
    return T.normal(a + x, 1.0) @ "v"


@T.gen
def t_two_input_site(x):
    a = T.normal(0.0, 1.0) @ "a"
    return t_mixed_inputs(a, x) @ "b"


@pytest.mark.parametrize("touched,args_changed", [(set(), True), ({"a"}, False), ({"a"}, True), (set(), False)])
def test_argdiff_masks(touched, args_changed):
    """JAX's `test_args_changed_only_x_leaf` and
    `test_touched_upstream_only_a_leaf`, and the two other corners."""
    jg, tg = _same_graph(j_two_input_site, t_two_input_site, (jnp.float32(0.0),), (torch.tensor(0.0),))
    tmask = tg.argdiff_mask("b", frozenset(touched), args_changed)
    assert tmask == tuple(jg.argdiff_mask("b", frozenset(touched), args_changed))


def test_update_keeps_values_and_weight_under_per_leaf_plan():
    choices = {"a": 0.25, ("b", "v"): -1.5}
    jtr, _ = j_two_input_site.generate(jax.random.key(0), J.ChoiceMap.d({k: jnp.float32(v) for k, v in choices.items()}),
                                       (jnp.float32(0.0),))
    ttr, _ = t_two_input_site.generate(_rng(), T.ChoiceMap.d({k: torch.tensor(v) for k, v in choices.items()}),
                                       (torch.tensor(0.0),))
    jnew, jw, _, _ = j_two_input_site.edit(jax.random.key(1), jtr, J.Update(J.ChoiceMap.empty()),
                                           (J.Diff.unknown_change(jnp.float32(1.5)),))
    tnew, tw, _, _ = t_two_input_site.edit(_rng(1), ttr, T.Update(T.ChoiceMap.empty()),
                                           (T.Diff.unknown_change(torch.tensor(1.5)),))
    score, _ = t_two_input_site.assess(tnew.get_choices(), (torch.tensor(1.5),))
    _close(tnew.get_score(), score)
    _close(tw, jw)
    assert tnew.get_subtrace("a") is ttr.get_subtrace("a")
    _close(tnew.get_choices()["b", "v"], -1.5)


# -- TestClosureCaptureEdit / TestStaticRequestCaptureEdit ------------------------------------------


@J.gen
def j_scaled_site(s):
    return J.normal(s, 0.5) @ "w"


@J.gen
def j_closure_capture(x):
    a = J.normal(x, 1.0) @ "a"
    return j_scaled_site.partial_apply(a)() @ "v"


@T.gen
def t_scaled_site(s):
    return T.normal(s, 0.5) @ "w"


@T.gen
def t_closure_capture(x):
    a = T.normal(x, 1.0) @ "a"
    return t_scaled_site.partial_apply(a)() @ "v"


def _capture_traces():
    choices = {"a": 0.2, ("v", "w"): 0.9}
    jtr, _ = j_closure_capture.generate(jax.random.key(0), J.ChoiceMap.d({k: jnp.float32(v) for k, v in choices.items()}),
                                        (jnp.float32(0.0),))
    ttr, _ = t_closure_capture.generate(_rng(), T.ChoiceMap.d({k: torch.tensor(v) for k, v in choices.items()}),
                                        (torch.tensor(0.0),))
    _close(ttr.get_score(), jtr.get_score())
    return jtr, ttr


def test_update_rescores_captured_value():
    jg, tg = _same_graph(j_closure_capture, t_closure_capture, (jnp.float32(0.0),), (torch.tensor(0.0),))
    # The capture is a leaf of the callee: the plan recomputes "v" densely.
    assert tg.site_edit_info("v", frozenset({"a"}), False) == (None, True)
    assert jg.site_edit_info("v", frozenset({"a"}), False) == (None, True)
    jtr, ttr = _capture_traces()
    jnew, jw, _, _ = j_closure_capture.edit(jax.random.key(1), jtr, J.Update(J.ChoiceMap.kw(a=4.0)),
                                            J.Diff.no_change(jtr.get_args()))
    tnew, tw, _, _ = t_closure_capture.edit(_rng(1), ttr, T.Update(T.ChoiceMap.kw(a=4.0)),
                                            T.Diff.no_change(ttr.get_args()))
    score, _ = t_closure_capture.assess(tnew.get_choices(), ttr.get_args())
    _close(tnew.get_score(), score)
    _close(tw, jw)
    _close(tnew.get_choices()["v", "w"], 0.9)


def test_sibling_update_rescores_captured_value():
    jtr, ttr = _capture_traces()
    jreq = J.StaticRequest({"a": J.Update(J.ChoiceMap.value(jnp.float32(4.0)))})
    treq = T.StaticRequest({"a": T.Update(T.ChoiceMap.value(torch.tensor(4.0)))})
    jnew, jw, _, _ = j_closure_capture.edit(jax.random.key(1), jtr, jreq, J.Diff.no_change(jtr.get_args()))
    tnew, tw, _, _ = t_closure_capture.edit(_rng(1), ttr, treq, T.Diff.no_change(ttr.get_args()))
    score, _ = t_closure_capture.assess(tnew.get_choices(), ttr.get_args())
    _close(tnew.get_score(), score)
    _close(tw, jw)
    _close(tnew.get_choices()["v", "w"], 0.9)


def test_regenerate_on_capture_tainted_site():
    jtr, ttr = _capture_traces()
    req = T.StaticRequest({"a": T.Update(T.ChoiceMap.value(torch.tensor(2.0))), "v": T.Regenerate(T.Selection.all())})
    tnew, tw, _, bwd = t_closure_capture.edit(_rng(7), ttr, req, T.Diff.no_change(ttr.get_args()))
    jreq = J.StaticRequest({"a": J.Update(J.ChoiceMap.value(jnp.float32(2.0))), "v": J.Regenerate(J.Selection.all())})
    _, _, _, jbwd = j_closure_capture.edit(jax.random.key(7), jtr, jreq, J.Diff.no_change(jtr.get_args()))
    score, _ = t_closure_capture.assess(tnew.get_choices(), ttr.get_args())
    _close(tnew.get_score(), score)
    _close(tw, score - ttr.get_score())
    assert float(tnew.get_choices()["v", "w"]) != 0.9
    assert {k: type(v).__name__ for k, v in bwd.addressed.items()} == {
        k: type(v).__name__ for k, v in jbwd.addressed.items()}


# -- TestEditTreedefStability ------------------------------------------------------------------------


def test_capture_edit_treedef_stable():
    _, ttr = _capture_traces()
    tnew, _, _, _ = t_closure_capture.edit(_rng(1), ttr, T.Update(T.ChoiceMap.kw(a=4.0)), T.Diff.no_change(ttr.get_args()))
    assert pytree.tree_structure(tnew) == pytree.tree_structure(ttr)
    merged = tgx.core.staging.where_tree(torch.tensor(True), tnew, ttr)
    _close(merged.get_score(), tnew.get_score())


def test_inbody_combinator_regenerate_treedef_stable():
    @T.gen
    def inner_a(x):
        return T.normal(x, 1.0) @ "v"

    @T.gen
    def inner_b(x):
        return T.normal(x + 2.0, 0.5) @ "v"

    @T.gen
    def model(x):
        return T.mix(inner_a, inner_b)(torch.tensor([0.1, -0.1]), (x,), (x,)) @ "m"

    for n in (None, 6):
        tr = model.simulate(_rng(0), (torch.tensor(0.3),), n=n)
        new, w, _, _ = T.Regenerate(T.Selection.at["m"]).edit(_rng(1), tr, T.Diff.no_change(tr.get_args()))
        assert pytree.tree_structure(new) == pytree.tree_structure(tr)
        flag = torch.tensor(False) if n is None else torch.zeros(n, dtype=torch.bool)
        tgx.core.staging.where_tree(flag, new, tr)
        _close(w, new.get_score() - tr.get_score(), 1e-5)


# -- TestSwitchPathPrecision -------------------------------------------------------------------------


def test_mix_edit_single_branch_execution(monkeypatch):
    """JAX counts one `cond` in the edit's jaxpr; the port counts runs of
    the Switch's fresh path (the branch the index moved to): none, since
    the plan hands the Switch a NoChange index when only its data changed.
    With 8 particles the index is a tensor, so the path is the run-time
    one."""
    jmixed = J.mix(j_chain, j_chain)

    @J.gen
    def jmodel(x):
        return jmixed(jnp.array([0.0, 0.0]), (x,), (x + 1.0,)) @ "mx"

    jtr = jmodel.simulate(jax.random.key(0), (jnp.float32(0.0),))
    jaxpr = str(jax.make_jaxpr(lambda k, t, x: jmodel.edit(k, t, J.Update(J.ChoiceMap.empty()),
                                                            (J.Diff.unknown_change(x),))[1])(
        jax.random.key(1), jtr, jnp.float32(0.5)))
    assert jaxpr.count("cond[") == 1

    tmixed = T.mix(t_chain, t_chain)

    @T.gen
    def tmodel(x):
        return tmixed(torch.tensor([0.0, 0.0]), (x,), (x + 1.0,)) @ "mx"

    from genjax_tpu_torch.combinators.switch import Switch

    fresh = []
    real = Switch._fresh_edit
    monkeypatch.setattr(Switch, "_fresh_edit", lambda self, *a: fresh.append(1) or real(self, *a))
    ttr = tmodel.simulate(_rng(0), (torch.tensor(0.0),), n=8)
    new, w, _, _ = tmodel.edit(_rng(1), ttr, T.Update(T.ChoiceMap.empty()), (T.Diff.unknown_change(torch.tensor(0.5)),))
    assert fresh == []
    score, _ = tmodel.assess(new.get_choices(), (torch.tensor(0.5),), 8)
    _close(w, score - ttr.get_score(), 1e-5)
    # An unknown index takes the fresh path too (the dense reference).
    sw = ttr.get_subtrace("mx").get_subtrace("component_sample")
    sw.get_gen_fn().edit(_rng(2), sw, T.Update(T.ChoiceMap.empty()), T.Diff.unknown_change(sw.get_args()), 8)
    assert fresh


# -- TestVmapArgdiffThreading ------------------------------------------------------------------------


def test_no_change_edit_smaller_than_unknown():
    """JAX: the NoChange edit's jaxpr has fewer equations. The port: fewer
    dispatched operations, and a reused kernel site."""

    @J.gen
    def jlane(mu):
        a = J.normal(mu, 1.0) @ "a"
        b = J.normal(a, 1.0) @ "b"
        J.normal(0.0, 1.0) @ "c"
        return b

    jm = jlane.vmap(in_axes=(0,))
    mus = np.zeros(64, dtype=np.float32)
    jtr = jm.simulate(jax.random.key(0), (jnp.asarray(mus),))

    def jcount(ad):
        f = lambda k, t, m: jm.edit(k, t, J.Update(J.ChoiceMapBuilder[3, "c"].set(1.0)), (ad(m),))[1]  # noqa: E731
        return len(jax.make_jaxpr(f)(jax.random.key(1), jtr, jnp.asarray(mus)).jaxpr.eqns)

    assert jcount(J.Diff.no_change) < jcount(J.Diff.unknown_change)

    tm = t_chain.vmap(in_axes=(0,))
    ttr = tm.simulate(_rng(0), (torch.from_numpy(mus),))

    def tedit(ad):
        return tm.edit(_rng(1), ttr, T.Update(T.ChoiceMapBuilder[3, "c"].set(1.0)), (ad(torch.from_numpy(mus)),))

    assert _ops(lambda: tedit(T.Diff.no_change)) < _ops(lambda: tedit(T.Diff.unknown_change))
    new, w, _, _ = tedit(T.Diff.no_change)
    assert new.inner.get_subtrace("a") is ttr.inner.get_subtrace("a")
    # Against the lanes' score changes summed in float64 (the difference of
    # the two float32 totals loses ~1e-5 to cancellation).
    _close(w, (new.inner.get_score().double() - ttr.inner.get_score().double()).sum(), 1e-6)


def test_scan_keeps_the_scanned_slice_tangents():
    """`Scan` hands each step the caller's tangents of the scanned input
    (JAX `scan.py:215`): a step kernel whose site reads only `x` keeps it
    under NoChange xs."""

    @T.gen
    def step(c, x):
        T.normal(x, 1.0) @ "u"
        z = T.normal(c, 1.0) @ "z"
        return z, z

    model = step.scan(n=4)
    xs = torch.arange(4.0)
    tr = model.simulate(_rng(0), (torch.tensor(0.0), xs))
    seen = []
    real = tstatic.StaticGenerativeFunction.edit

    def spy(self, rng, trace, request, argdiffs, n=None):
        seen.append(T.Diff.static_check_no_change(argdiffs[1]))
        return real(self, rng, trace, request, argdiffs, n)

    tstatic.StaticGenerativeFunction.edit = spy
    try:
        new, w, _, _ = model.edit(_rng(1), tr, T.Update(T.ChoiceMap.empty()),
                                  (T.Diff.unknown_change(torch.tensor(1.0)), T.Diff.no_change(xs)))
    finally:
        tstatic.StaticGenerativeFunction.edit = real
    assert seen == [True] * 4
    score, _ = model.assess(new.get_choices(), (torch.tensor(1.0), xs))
    _close(w, score - tr.get_score(), 1e-5)


# -- test_nested_incremental -------------------------------------------------------------------------


@J.gen
def j_block(mu):
    p = J.normal(mu, 1.0) @ "p"
    J.normal(p, 1.0) @ "q"
    J.normal(0.0, 1.0) @ "r"
    return p


@J.gen
def j_outer():
    a = j_block(0.0) @ "left"
    b = j_block(1.0) @ "right"
    return a + b


@T.gen
def t_block(mu):
    p = T.normal(mu, 1.0) @ "p"
    T.normal(p, 1.0) @ "q"
    T.normal(0.0, 1.0) @ "r"
    return p


@T.gen
def t_outer():
    a = t_block(0.0) @ "left"
    b = t_block(1.0) @ "right"
    return a + b


def _outer_traces():
    vals = {(s, k): v for s in ("left", "right") for k, v in zip("pqr", (0.1, -0.4, 0.8))}
    jtr, _ = j_outer.generate(jax.random.key(0), J.ChoiceMap.d({k: jnp.float32(v) for k, v in vals.items()}), ())
    ttr, _ = t_outer.generate(_rng(), T.ChoiceMap.d({k: torch.tensor(v) for k, v in vals.items()}), ())
    return jtr, ttr


def test_inner_reuse_recurses():
    jtr, ttr = _outer_traces()
    jnew, jw, _, _ = jtr.update(jax.random.key(1), J.ChoiceMap.entry(2.0, "left", "r"))
    tnew, tw, _, _ = ttr.update(_rng(1), T.ChoiceMap.entry(2.0, "left", "r"))
    assert tnew.get_subtrace("right") is ttr.get_subtrace("right")
    assert jnew.get_subtrace("right") is jtr.get_subtrace("right")
    for addr in ("p", "q"):
        assert tnew.get_subtrace("left").get_subtrace(addr) is ttr.get_subtrace("left").get_subtrace(addr)
    _close(tw, jw)


def test_compiled_size_scales_with_affected():
    """JAX: the compiled edit is smaller than the compiled assess. The
    port: the edit dispatches fewer operations than the assess."""
    _, ttr = _outer_traces()
    edit_ops = _ops(lambda: ttr.update(_rng(1), T.ChoiceMap.entry(2.0, "left", "r")))
    assess_ops = _ops(lambda: t_outer.assess(ttr.get_choices(), ()))
    assert edit_ops < assess_ops


def test_vmapped_builder():
    """JAX builds the indexed map under `vmap`; the port builds it from the
    index tensor at once. Both read a masked value at index 4 and nothing
    at 42."""
    jchm = jax.vmap(lambda i, v: J.ChoiceMapBuilder["x", i].set(v))(jnp.arange(10), jnp.ones(10) * 3.0)
    tchm = T.ChoiceMapBuilder["x", torch.arange(10)].set(torch.ones(10) * 3.0)
    jv, tv = jchm["x", 4], tchm["x", 4]
    assert isinstance(tv, T.Mask) and bool(jv.primal_flag()) and bool(tv.flag)
    _close(tv.value, jv.value)
    missing = tchm("x").get_submap(42).get_value()
    assert not bool(jchm("x").get_submap(42).get_value().primal_flag()) and not bool(missing.flag)


def test_indexed_constraint_in_vmap_generate():
    @J.gen
    def jkernel(mu):
        return J.normal(mu, 1.0) @ "z"

    @T.gen
    def tkernel(mu):
        return T.normal(mu, 1.0) @ "z"

    jc = jax.vmap(lambda i, v: J.ChoiceMapBuilder[i, "z"].set(v))(jnp.array([1, 3]), jnp.array([5.0, 7.0]))
    tc = T.ChoiceMapBuilder[torch.tensor([1, 3]), "z"].set(torch.tensor([5.0, 7.0]))
    jtr, jw = jkernel.vmap(in_axes=(0,)).generate(jax.random.key(0), jc, (jnp.zeros(6),))
    ttr, tw = tkernel.vmap(in_axes=(0,)).generate(_rng(), tc, (torch.zeros(6),))
    _close(ttr.get_choices()[1, "z"], 5.0)
    _close(ttr.get_choices()[3, "z"], 7.0)
    _close(tw, jw)


# -- test_analysis_cache ------------------------------------------------------------------------------


@J.gen
def j_steered(flag, mu):
    x = J.normal(mu, 1.0) @ "x"
    y = J.normal(x, 1.0) @ "y" if flag else J.normal(0.0, 1.0) @ "y"
    return y


@T.gen
def t_steered(flag, mu):
    x = T.normal(mu, 1.0) @ "x"
    y = T.normal(x, 1.0) @ "y" if flag else T.normal(0.0, 1.0) @ "y"
    return y


def _update_x(jm, tm, mu, new_x):
    jtr, _ = jm.generate(jax.random.key(0), J.ChoiceMap.kw(x=jnp.float32(0.2), y=jnp.float32(-0.3)), (mu,))
    ttr, _ = tm.generate(_rng(), T.ChoiceMap.kw(x=torch.tensor(0.2), y=torch.tensor(-0.3)), (mu,))
    _, jw, _, _ = jm.edit(jax.random.key(1), jtr, J.Update(J.ChoiceMap.kw(x=new_x)), J.Diff.no_change((mu,)))
    tnew, tw, _, _ = tm.edit(_rng(1), ttr, T.Update(T.ChoiceMap.kw(x=new_x)), T.Diff.no_change((mu,)))
    score, _ = tm.assess(tnew.get_choices(), (mu,))
    _close(tnew.get_score(), score)
    _close(tw, score - ttr.get_score())
    _close(tw, jw)


@pytest.mark.parametrize("first", [False, True], ids=["independent_first", "dependent_first"])
def test_partial_apply_variants_do_not_alias(first):
    """JAX's `test_partial_apply_variants_do_not_alias` and
    `test_opposite_priming_order`: the bound flag steers the source, so it
    is part of the key."""
    _update_x(j_steered.partial_apply(first), t_steered.partial_apply(first), 0.3, 2.0)
    _update_x(j_steered.partial_apply(not first), t_steered.partial_apply(not first), 0.3, 2.0)


def test_cache_hits_after_the_first_edit():
    @T.gen
    def model(mu):
        a = T.normal(mu, 1.0) @ "a"
        return T.normal(a, 1.0) @ "b"

    tr = model.simulate(_rng(), (torch.tensor(0.0),), n=16)
    before = analysis.stats()
    for seed in range(5):
        tr, _ = T.mh(_rng(seed), tr, T.Regenerate(T.Selection.at["a"]))
    after = analysis.stats()
    assert after["misses"] - before["misses"] == 1 and after["hits"] - before["hits"] == 4


def test_a_callee_built_in_the_body_is_analyzed_once():
    """A model that builds `mix(f, g)` at a site makes a new function at
    every run; the key compares it by code and closure cells, so the edits
    after the first analyze nothing (JAX stages it once per trace)."""

    @T.gen
    def lo():
        return T.normal(-1.0, 1.0) @ "v"

    @T.gen
    def hi():
        return T.normal(1.0, 1.0) @ "v"

    @T.gen
    def model():
        v = T.mix(lo, hi)(torch.tensor([0.3, -0.2]), (), ()) @ "m"
        return T.normal(v, 0.5) @ "y"

    tr, _ = model.importance(_rng(), T.ChoiceMap.kw(y=0.4), (), n=32)
    tr, _ = T.mh(_rng(1), tr, T.Regenerate(T.Selection.at["m"]))
    before = analysis.stats()
    for seed in range(3):
        tr, _ = T.mh(_rng(seed), tr, T.Regenerate(T.Selection.at["m"]))
    after = analysis.stats()
    assert after["misses"] == before["misses"] and after["hits"] > before["hits"]
    assert after["fallbacks"] == before["fallbacks"]


def test_the_key_holds_a_tensor_closure_leaf_by_its_version():
    """A closure's tensor leaf is keyed by the object and its `_version`
    (no bytes read from a device): an in-place write is a new key."""
    data = torch.zeros(200)
    src = t_steered.partial_apply(data).source
    k1 = analysis.cache_key(src, (0.0,))
    assert k1 == analysis.cache_key(src, (1.0,))
    data.add_(1.0)
    assert k1 != analysis.cache_key(src, (0.0,))
    small = t_steered.partial_apply(torch.tensor(True)).source
    assert analysis.cache_key(small, (0.0,)) == analysis.cache_key(t_steered.partial_apply(torch.tensor(True)).source,
                                                                     (0.0,))


def _captured_flag_model(flag, where):
    """`t_steered` with its flag captured in a closure cell or held as a
    default, not applied as an argument."""
    if where == "default":
        @T.gen
        def model(mu, flag=flag):
            x = T.normal(mu, 1.0) @ "x"
            return T.normal(x, 1.0) @ "y" if flag[0] > 0 else T.normal(0.0, 1.0) @ "y"
        return model

    @T.gen
    def model(mu):
        x = T.normal(mu, 1.0) @ "x"
        return T.normal(x, 1.0) @ "y" if flag[0] > 0 else T.normal(0.0, 1.0) @ "y"
    return model


@pytest.mark.parametrize("where,n", [("cell", 1), ("cell", 200), ("default", 1), ("default", 200)],
                         ids=["cell_bytes", "cell_version", "default_bytes", "default_version"])
def test_a_captured_flag_changed_in_place_is_a_new_key(where, n):
    """A tensor that the source captures (a closure cell, a default) and
    reads to steer its control flow is keyed by value (by its bytes up to
    128 elements, by the object and its `_version` beyond): after an
    in-place write, `y` reads `x`, and an edit of `x` re-scores it, with
    JAX's weight for the steered model."""
    flag = torch.zeros(n)
    tm = _captured_flag_model(flag, where)
    _update_x(j_steered.partial_apply(False), tm, 0.3, 2.0)
    flag[0] = 1.0
    _update_x(j_steered.partial_apply(True), tm, 0.3, 2.0)


def test_the_cache_keeps_no_closure_data_alive():
    """The key holds a closure's tensors, and what the source captures, by
    weak references: once the caller drops them, nothing of the cache
    keeps them (a loop over fresh data on a card would hold its memory)."""
    import gc
    import weakref

    def run():
        data, captured = torch.zeros(200), torch.ones(300)

        @T.gen
        def model(d, mu):
            x = T.normal(mu + captured[0] * 0.0, 1.0) @ "x"
            return T.normal(x + d[0] * 0.0, 1.0) @ "y"

        closure = model.partial_apply(data)
        tr = closure.simulate(_rng(), (torch.tensor(0.0),))
        before = analysis.stats()["misses"]
        tr.update(_rng(1), T.ChoiceMap.kw(x=0.5))
        assert analysis.stats()["misses"] == before + 1
        return weakref.ref(data), weakref.ref(captured)

    refs = run()
    gc.collect()
    assert all(r() is None for r in refs)


# -- the 200-address model ----------------------------------------------------------------------------


def test_two_hundred_addresses_rescore_only_the_touched_site_and_its_readers(monkeypatch):
    calls = []
    counted = T.exact_density(
        lambda rng, loc, scale, n=None: T.normal.sample(rng, loc, scale, n=n),
        lambda v, loc, scale: calls.append(1) or T.normal.logpdf(v, loc, scale),
        "counted_normal",
    )
    n_sites, k = 200, 117

    @T.gen
    def tmodel(x0):
        x = x0
        for i in range(n_sites):
            x = counted(x, 1.0) @ f"x{i}"
        return x

    @J.gen
    def jmodel(x0):
        x = x0
        for i in range(n_sites):
            x = J.normal(x, 1.0) @ f"x{i}"
        return x

    vals = np.random.default_rng(0).normal(size=n_sites).astype(np.float32).cumsum()
    ttr, _ = tmodel.generate(_rng(), T.ChoiceMap.d({f"x{i}": torch.tensor(v) for i, v in enumerate(vals)}), (0.0,))
    jtr, _ = jmodel.generate(jax.random.key(0), J.ChoiceMap.d({f"x{i}": jnp.float32(v) for i, v in enumerate(vals)}),
                             (0.0,))
    before = _count_fallbacks()
    calls.clear()
    new, w, _, _ = ttr.update(_rng(1), T.ChoiceMap.d({f"x{k}": 0.5}))
    assert len(calls) == 2  # x_k and x_{k+1}, its one reader
    assert _count_fallbacks() == before
    assert all(new.get_subtrace(f"x{i}") is ttr.get_subtrace(f"x{i}") for i in range(n_sites) if i not in (k, k + 1))
    _, jw, _, _ = jtr.update(jax.random.key(1), J.ChoiceMap.d({f"x{k}": 0.5}))
    _close(w, jw)
    # The dense plan visits every site; its weight is the same within 1e-6.
    monkeypatch.setattr(tstatic, "_static_edit_plan", lambda *a, **kw: tstatic._FALLBACK_PLAN)
    calls.clear()
    _, w_dense, _, _ = ttr.update(_rng(1), T.ChoiceMap.d({f"x{k}": 0.5}))
    assert len(calls) == n_sites
    _close(w, w_dense)


# -- the trouble spots: each a counted fallback with the right weight ---------------------------------


def _fallback_case(body, reason):
    @T.gen
    def model(mu):
        a = T.normal(mu, 1.0) @ "a"
        return T.normal(body(a), 1.0) @ "b"

    tr = model.simulate(_rng(0), (torch.tensor(0.0),))
    before = analysis.stats()["fallbacks"]
    new, w, _, _ = tr.update(_rng(1), T.ChoiceMap.kw(a=0.7))
    after = analysis.stats()["fallbacks"]
    grew = [r for r in after if after[r] > before.get(r, 0)]
    assert len(grew) == 1 and reason in grew[0], (grew, reason)
    score, _ = model.assess(new.get_choices(), (torch.tensor(0.0),))
    _close(w, score - tr.get_score(), 1e-5)


def _inplace_untracked(a):
    buf = torch.zeros(1)
    buf[0] = a
    return buf[0]


def _out_untracked(a):
    buf = torch.zeros(())
    torch.add(a, 1.0, out=buf)
    return buf


@pytest.mark.parametrize("body,reason", [
    (lambda a: a if a > 0 else -a, "__bool__"),
    (lambda a: a.item(), "item"),
    (lambda a: int(a), "__int__"),
    (lambda a: float(a), "__float__"),
    (lambda a: a.tolist(), "tolist"),
    (lambda a: torch.as_tensor(a.numpy()), "numpy"),
    (lambda a: [0.0, 1.0][a.to(torch.int64)], "__index__"),
    (_inplace_untracked, "does not track"),
    (_out_untracked, "does not track"),
], ids=["bool", "item", "int", "float", "tolist", "numpy", "index", "inplace_untracked", "out_untracked"])
def test_a_trouble_spot_falls_back_and_is_counted(body, reason):
    _fallback_case(body, reason)


def _plus_equals(buf, c):
    buf += c
    return buf


def _write_through_a_view(buf, c):
    buf[1:].copy_(c.expand(1))
    return buf


def _write_into_a_viewed_base(buf, c):
    tail = buf[1:]
    buf.mul_(0.0)
    return tail + c


@pytest.mark.parametrize("write", [_plus_equals, _write_through_a_view, _write_into_a_viewed_base],
                         ids=["plus_equals", "through_a_view", "into_a_viewed_base"])
def test_an_inplace_write_into_a_placeholder_falls_back_and_rescores_its_readers(write):
    """A write into a tracked tensor, also through a view that shares its
    base's storage, ends the analysis: the edit of `c` falls back, is
    counted, and re-scores `d`, with JAX's weight for the same dataflow
    (`buf.at[1:].set(c)` and the like)."""
    j_writes = {
        _plus_equals: lambda buf, c: buf + c,
        _write_through_a_view: lambda buf, c: buf.at[1:].set(c),
        _write_into_a_viewed_base: lambda buf, c: buf[1:] * 0.0 + c,
    }

    @J.gen
    def jm(mu):
        a = J.normal(mu, 1.0) @ "a"
        c = J.normal(0.0, 1.0) @ "c"
        buf = j_writes[write](a * jnp.ones(2), c)
        return J.normal(buf.sum(), 1.0) @ "d"

    @T.gen
    def tm(mu):
        a = T.normal(mu, 1.0) @ "a"
        c = T.normal(0.0, 1.0) @ "c"
        buf = write(a * torch.ones(2), c)
        return T.normal(buf.sum(), 1.0) @ "d"

    vals = dict(a=0.4, c=-0.2, d=0.9)
    jtr, _ = jm.generate(jax.random.key(0), J.ChoiceMap.kw(**{k: jnp.float32(v) for k, v in vals.items()}), (0.0,))
    ttr, _ = tm.generate(_rng(), T.ChoiceMap.kw(**{k: torch.tensor(v) for k, v in vals.items()}), (0.0,))
    _close(ttr.get_score(), jtr.get_score())
    before = analysis.stats()["fallbacks"]
    tnew, tw, _, _ = ttr.update(_rng(1), T.ChoiceMap.kw(c=1.3))
    after = analysis.stats()["fallbacks"]
    grew = [r for r in after if after[r] > before.get(r, 0)]
    assert len(grew) == 1 and "in place" in grew[0], grew
    _, jw, _, _ = jtr.update(jax.random.key(1), J.ChoiceMap.kw(c=jnp.float32(1.3)))
    _close(tw, jw)
    score, _ = tm.assess(tnew.get_choices(), (0.0,))
    _close(tw, score - ttr.get_score())


def test_python_number_arguments_are_staged():
    """A Python number argument is a 0-d placeholder that the arguments
    reach, as JAX traces it; a change of it re-scores its readers."""

    @J.gen
    def jm(mu, s):
        a = J.normal(mu, s) @ "a"
        return J.normal(a, 1.0) @ "b"

    @T.gen
    def tm(mu, s):
        a = T.normal(mu, s) @ "a"
        return T.normal(a, 1.0) @ "b"

    _, tg = _same_graph(jm, tm, (0.0, 2.0), (0.0, 2.0))
    assert tg.argdiff_mask("a", frozenset(), True) == (True, True)
    jtr, _ = jm.generate(jax.random.key(0), J.ChoiceMap.kw(a=jnp.float32(0.4), b=jnp.float32(1.0)), (0.0, 2.0))
    ttr, _ = tm.generate(_rng(), T.ChoiceMap.kw(a=torch.tensor(0.4), b=torch.tensor(1.0)), (0.0, 2.0))
    _, jw, _, _ = jm.edit(jax.random.key(1), jtr, J.Update(J.ChoiceMap.empty()),
                          (J.Diff.no_change(0.0), J.Diff.unknown_change(3.0)))
    new, tw, _, _ = tm.edit(_rng(1), ttr, T.Update(T.ChoiceMap.empty()),
                            (T.Diff.no_change(0.0), T.Diff.unknown_change(3.0)))
    _close(tw, jw)
    assert new.get_subtrace("b") is ttr.get_subtrace("b")


# -- the differences from JAX that this slice removes -------------------------------------------------


def test_regenerate_backward_request_is_a_static_request_like_jax():
    jtr, ttr = _traces(j_chain, t_chain, _CHOICES, (0.0,), (0.0,))
    _, _, _, jbwd = J.Regenerate(J.Selection.at["a"]).edit(jax.random.key(1), jtr, J.Diff.no_change((0.0,)))
    _, _, _, tbwd = T.Regenerate(T.Selection.at["a"]).edit(_rng(1), ttr, T.Diff.no_change((0.0,)))
    assert type(jbwd).__name__ == type(tbwd).__name__ == "StaticRequest"
    kinds = lambda r: {k: type(v).__name__ for k, v in r.addressed.items()}  # noqa: E731
    assert kinds(tbwd) == kinds(jbwd) == {"a": "Update", "b": "Update", "c": "EmptyRequest"}
    _close(tbwd.addressed["a"].constraint.get_value(), jbwd.addressed["a"].constraint.get_value())


@pytest.mark.parametrize("edit", ["update_c", "update_b", "regen_c", "regen_a", "args"])
def test_retdiffs_like_jax(edit):
    jtr, ttr = _traces(j_chain, t_chain, _CHOICES, (0.0,), (0.0,))
    jreq, treq, jad, tad = {
        "update_c": (J.Update(J.ChoiceMap.kw(c=1.0)), T.Update(T.ChoiceMap.kw(c=1.0)), 0.0, 0.0),
        "update_b": (J.Update(J.ChoiceMap.kw(b=1.0)), T.Update(T.ChoiceMap.kw(b=1.0)), 0.0, 0.0),
        "regen_c": (J.Regenerate(J.Selection.at["c"]), T.Regenerate(T.Selection.at["c"]), 0.0, 0.0),
        "regen_a": (J.Regenerate(J.Selection.at["a"]), T.Regenerate(T.Selection.at["a"]), 0.0, 0.0),
        "args": (J.Update(J.ChoiceMap.empty()), T.Update(T.ChoiceMap.empty()), 1.0, 1.0),
    }[edit]
    jdiff = J.Diff.unknown_change if edit == "args" else J.Diff.no_change
    tdiff = T.Diff.unknown_change if edit == "args" else T.Diff.no_change
    _, _, jrd, _ = jreq.edit(jax.random.key(1), jtr, (jdiff(jnp.float32(jad)),))
    _, _, trd, _ = treq.edit(_rng(1), ttr, (tdiff(torch.tensor(tad)),))
    assert T.Diff.static_check_no_change(trd) == J.Diff.static_check_no_change(jrd)


def test_unselected_site_with_unchanged_arguments_is_kept_like_jax():
    calls = []
    counted = T.exact_density(
        lambda rng, loc, scale, n=None: T.normal.sample(rng, loc, scale, n=n),
        lambda v, loc, scale: calls.append(1) or T.normal.logpdf(v, loc, scale),
        "counted_normal",
    )
    ttr = counted.simulate(_rng(), (0.0, 1.0), 4)
    jtr = J.normal.simulate(jax.random.key(0), (0.0, 1.0))
    calls.clear()
    tnew, tw, trd, tbwd = counted.edit(_rng(1), ttr, T.Regenerate(T.Selection.none()), T.Diff.no_change((0.0, 1.0)))
    jnew, jw, jrd, jbwd = J.normal.edit(jax.random.key(1), jtr, J.Regenerate(J.Selection.none()),
                                        J.Diff.no_change((0.0, 1.0)))
    assert tnew is ttr and jnew is jtr and calls == []
    _close(tw, jw)
    assert T.Diff.static_check_no_change(trd) and J.Diff.static_check_no_change(jrd)
    assert tbwd.constraint.static_is_empty() and jbwd.constraint.static_is_empty()
    # Changed arguments re-score, and store the new ones; unchanged keep the old.
    new, w, _, _ = counted.edit(_rng(1), ttr, T.Regenerate(T.Selection.none()), T.Diff.unknown_change((1.0, 1.0)))
    assert calls and new.args == (1.0, 1.0)
    kept, _, _, _ = counted.edit(_rng(1), ttr, T.Update(T.ChoiceMap.empty()), T.Diff.no_change((0.0, 1.0)))
    assert kept.args is ttr.args


# -- the rest of core/diff.py, incremental, to_shape_fn, DiffAnnotate, SafeHMC ------------------------


def test_diff_tree_helpers_like_jax():
    primals = (1.0, (2.0, 3.0))
    jt = (J.NoChange, (J.UnknownChange, J.NoChange))
    tt = (T.NoChange, (T.UnknownChange, T.NoChange))
    jd, td = J.Diff.tree_diff(primals, jt), T.Diff.tree_diff(primals, tt)
    names = lambda t: [type(x).__name__ for x in pytree.tree_leaves(t, is_leaf=lambda x: isinstance(x, T.ChangeTangent))]  # noqa: E731
    jnames = [type(x).__name__ for x in jax.tree_util.tree_leaves(J.Diff.tree_tangent(jd),
                                                                  is_leaf=lambda x: isinstance(x, J.ChangeTangent))]
    assert names(T.Diff.tree_tangent(td)) == jnames
    assert T.Diff.static_check_tree_diff(td) == J.Diff.static_check_tree_diff(jd) is True
    assert T.Diff.static_check_tree_diff((1.0, td)) == J.Diff.static_check_tree_diff((1.0, jd)) is False
    assert T.Diff.tree_primal(td) == primals
    assert names(T.Diff.tree_tangent((1.0,))) == ["_UnknownChange"]


@pytest.mark.parametrize("tangents", [("N", "N"), ("N", "U"), ("U", "U")])
def test_incremental_like_jax(tangents):
    pick = lambda m, t: m.NoChange if t == "N" else m.UnknownChange  # noqa: E731
    import importlib

    from genjax_tpu.core.diff import incremental as jinc
    from genjax_tpu_torch.core.diff import incremental as tinc

    jout = jinc(lambda a, b: a * b)(None, (2.0, 3.0), tuple(pick(J, t) for t in tangents))
    tout = tinc(lambda a, b: a * b)(None, (2.0, 3.0), tuple(pick(T, t) for t in tangents))
    assert tout.primal == jout.primal == 6.0
    assert type(tout.tangent).__name__ == type(jout.tangent).__name__
    assert importlib.import_module("genjax_tpu_torch.incremental").incremental is tinc


@pytest.mark.parametrize("name,args", [
    ("normal", (np.zeros((3, 2), np.float32), 1.0)),
    ("categorical", (np.zeros((4, 5), np.float32),)),
    ("mv_normal_diag", (np.zeros((2, 3), np.float32), np.ones((2, 3), np.float32))),
    ("flip", (0.3,)),
    ("dirichlet", (np.ones((2, 4), np.float32),)),
])
def test_to_shape_fn_like_jax(name, args):
    jfn, tfn = getattr(J, name), getattr(T, name)
    jout = J.to_shape_fn(lambda k, *a: jfn.sample(k, *a), jnp.zeros)(jax.random.key(0), *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    tout = T.to_shape_fn(lambda rng, *a: tfn.sample(rng, *a))(_rng(), *targs)
    assert tuple(tout.shape) == tuple(jout.shape) and tout.device.type == "meta"
    zeros = tfn.__abstract_call__(*targs)
    assert tuple(zeros.shape) == tuple(jout.shape) and not zeros.any()
    assert str(zeros.dtype).split(".")[-1].replace("int64", "int32").replace("bool", "bool") == str(jout.dtype) or \
        zeros.dtype.is_floating_point == jnp.issubdtype(jout.dtype, jnp.floating)


@pytest.mark.parametrize("sampler", ["_standard_gamma", "_sample_dirichlet", "poisson", "binomial"])
def test_shape_only_samplers_without_meta_kernels(sampler):
    """Samplers that some PyTorch versions give no meta kernel answer a
    shape-only call with their operand's shape and dtype, on meta."""
    fn = getattr(torch, sampler)
    args = (torch.ones(4, 3),) if sampler != "binomial" else (torch.full((4, 3), 5.0), torch.full((4, 3), 0.5))
    real = fn(*args, generator=_rng())
    out = T.to_shape_fn(lambda rng, *a: fn(*a, generator=rng))(_rng(), *args)
    assert out.device.type == "meta" and out.shape == real.shape and out.dtype == real.dtype


def test_abstract_calls_of_combinators_draw_nothing():
    """The static language and each combinator answer `__abstract_call__`
    with zeros of their call's return shape, with no draw: the generator
    of a shape-only call is never read."""

    @T.gen
    def kernel(x):
        return T.normal(x, 1.0) @ "z"

    @T.gen
    def step(c, x):
        z = T.normal(c + x, 1.0) @ "z"
        return z, z

    cases = [
        (t_chain, (torch.tensor(0.0),)),
        (kernel.vmap(in_axes=(0,)), (torch.zeros(5),)),
        (step.scan(n=4), (torch.tensor(0.0), torch.arange(4.0))),
        (T.mix(kernel, kernel), (torch.zeros(2), (torch.tensor(0.0),), (torch.tensor(1.0),))),
        (kernel.mask(), (torch.tensor(True), torch.tensor(0.0))),
        (kernel.map(lambda v: v * 2.0), (torch.tensor(0.0),)),
    ]
    for fn, args in cases:
        state = torch.random.get_rng_state()
        with _Ops() as log:
            out = fn.__abstract_call__(*args)
        real = fn.simulate(_rng(), args).get_retval()
        assert pytree.tree_structure(out) == pytree.tree_structure(real)
        for a, b in zip(pytree.tree_leaves(out), pytree.tree_leaves(real)):
            if isinstance(b, torch.Tensor):
                assert a.shape == b.shape and not a.any()
        assert torch.equal(state, torch.random.get_rng_state())
        assert log.n < 200


def test_diff_annotate_and_request_dimap_like_jax():
    jtr, ttr = _traces(j_chain, t_chain, _CHOICES, (0.0,), (0.0,))
    seen = []
    treq = T.Update(T.ChoiceMap.kw(c=1.0)).dimap(pre=lambda ad: seen.append("pre") or ad,
                                                 post=lambda rd: seen.append("post") or T.Diff.unknown_change(
                                                     T.Diff.tree_primal(rd)))
    jreq = J.Update(J.ChoiceMap.kw(c=1.0)).dimap(pre=lambda ad: ad,
                                                 post=lambda rd: J.Diff.unknown_change(J.Diff.tree_primal(rd)))
    assert type(treq).__name__ == type(jreq).__name__ == "DiffAnnotate"
    _, tw, trd, _ = treq.edit(_rng(1), ttr, T.Diff.no_change((0.0,)))
    _, jw, jrd, _ = jreq.edit(jax.random.key(1), jtr, J.Diff.no_change((0.0,)))
    assert seen == ["pre", "post"]
    _close(tw, jw)
    assert T.Diff.static_check_no_change(trd) == J.Diff.static_check_no_change(jrd) is False
    assert T.Update(T.ChoiceMap.empty()).map(lambda r: r).retdiff_fn is not None
    assert T.Update(T.ChoiceMap.empty()).contramap(lambda a: a).argdiff_fn is not None


def test_safe_hmc_on_eight_schools():
    """`SafeHMC` over `mu` and `log_tau` of the centered model runs (theta
    is drawn, so the return value keeps its value); on the non-centered
    model theta = mu + tau * z is the return value, and it raises, as
    JAX's does."""
    from genjax_tpu.inference.requests import SafeHMC as JSafe
    from genjax_tpu.models import hierarchical as jh
    from genjax_tpu_torch.inference.requests import SafeHMC as TSafe
    from genjax_tpu_torch.models import hierarchical as th

    sel_t = T.Selection.at["mu"] | T.Selection.at["log_tau"]
    sel_j = J.Selection.at["mu"] | J.Selection.at["log_tau"]
    sigma = th.EIGHT_SCHOOLS_SIGMA
    obs = T.ChoiceMap.kw(ys=th.EIGHT_SCHOOLS_Y)
    jobs = J.ChoiceMap.kw(ys=jnp.asarray(th.EIGHT_SCHOOLS_Y.numpy()))
    jsigma = jnp.asarray(sigma.numpy())
    for tmodel, jmodel, raises in ((th.eight_schools_centered, jh.eight_schools_centered, False),
                                   (th.eight_schools, jh.eight_schools, True)):
        ttr, _ = tmodel.importance(_rng(), obs, (sigma,), n=16)
        jtr, _ = jmodel.importance(jax.random.key(0), jobs, (jsigma,))
        if raises:
            with pytest.raises(AssertionError, match="SafeHMC"):
                TSafe(sel_t, 0.01, L=2).edit(_rng(1), ttr, T.Diff.no_change((sigma,)))
            with pytest.raises(AssertionError, match="SafeHMC"):
                JSafe(sel_j, 0.01, L=2).edit(jax.random.key(1), jtr, J.Diff.no_change((jsigma,)))
        else:
            new, alpha, rd, _ = TSafe(sel_t, 0.01, L=2).edit(_rng(1), ttr, T.Diff.no_change((sigma,)))
            _, _, jrd, _ = JSafe(sel_j, 0.01, L=2).edit(jax.random.key(1), jtr, J.Diff.no_change((jsigma,)))
            assert T.Diff.static_check_no_change(rd) and J.Diff.static_check_no_change(jrd)
            assert alpha.shape == (16,) and bool(torch.isfinite(alpha).all())
