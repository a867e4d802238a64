"""The public API's checks (`core/typecheck.py`, on by default) and the
opt-in GFI validation (`core/checked.py`, `checked_mode()`) against
`genjax_tpu`'s: a counterpart of each case of `tests/core/test_typecheck.py`
and `tests/core/test_checked_mode.py`.

For each malformed call, both packages raise `TypeError`, and where JAX's
message names a parameter the port's names the same one. The one
difference is the key: JAX's parameter is `key` (a PRNG key), the port's
is `rng` (a `torch.Generator`), so where JAX's message says `key` the
port's says `rng`. In place of JAX's "the compiled HLO is identical with
and without the checks", the port's checks must leave the dispatched aten
operations, every result and the generator's state identical.
"""

import jax
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.core.checked import checked_mode as j_checked_mode
from genjax_tpu_torch.core import typecheck
from genjax_tpu_torch.core.checked import checked_mode, is_checked
from genjax_tpu_torch.core.typecheck import do_typecheck, is_typechecked

torch.set_num_threads(1)


@jgx.gen
def j_model():
    x = jgx.normal(0.0, 1.0) @ "x"
    _ = jgx.normal(x, 1.0) @ "y"
    return x


@tgx.gen
def t_model():
    x = tgx.normal(0.0, 1.0) @ "x"
    _ = tgx.normal(x, 1.0) @ "y"
    return x


@jgx.gen
def j_mu_model(mu):
    x = jgx.normal(mu, 1.0) @ "x"
    _ = jgx.normal(x, 1.0) @ "y"
    return x


@tgx.gen
def t_mu_model(mu):
    x = tgx.normal(mu, 1.0) @ "x"
    _ = tgx.normal(x, 1.0) @ "y"
    return x


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def trs():
    return j_model.simulate(jax.random.key(0), ()), t_model.simulate(_rng(0), ())


def both_raise(jax_call, port_call, jax_match, port_match, jax_param=None, port_param=None, checked=True):
    """Both calls raise TypeError (inside each package's `checked_mode()`
    where `checked`); each message matches its pattern, and where a
    parameter is given each message names it (JAX's `key` is the port's
    `rng`)."""
    ctx_j, ctx_t = (j_checked_mode(), checked_mode()) if checked else (_null(), _null())
    with ctx_j, pytest.raises(TypeError, match=jax_match) as j_err:
        jax_call()
    with ctx_t, pytest.raises(TypeError, match=port_match) as t_err:
        port_call()
    if jax_param is not None:
        assert f"`{jax_param}`" in str(j_err.value), str(j_err.value)
        assert f"`{port_param or jax_param}`" in str(t_err.value), str(t_err.value)
    return str(j_err.value), str(t_err.value)


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# -- tests/core/test_typecheck.py: TestBoundaryErrors ----------------------------------------------


def test_filter_rejects_dict(trs):
    j, t = trs
    both_raise(lambda: j.get_choices().filter({"x": True}), lambda: t.get_choices().filter({"x": True}),
               r"filter.*selection", r"filter.*selection", "selection")


def test_filter_rejects_choice_map(trs):
    j, t = trs
    both_raise(lambda: j.get_choices().filter(jgx.ChoiceMap.kw(x=1.0)),
               lambda: t.get_choices().filter(tgx.ChoiceMap.kw(x=1.0)),
               r"filter.*selection", r"filter.*selection", "selection")


def test_merge_rejects_dict(trs):
    j, t = trs
    both_raise(lambda: j.get_choices().merge({"y": 1}), lambda: t.get_choices().merge({"y": 1}),
               r"merge.*other", r"merge.*other", "other")


def test_simulate_rejects_raw_seed():
    both_raise(lambda: j_model.simulate(42, ()), lambda: t_model.simulate(42, ()),
               r"key.*PRNG", r"rng.*torch\.Generator", "key", "rng")


def test_simulate_rejects_list_args():
    both_raise(lambda: j_model.simulate(jax.random.key(0), [1.0]), lambda: t_model.simulate(_rng(), [1.0]),
               r"args", r"args", "args")


def test_target_rejects_non_tuple_args():
    both_raise(lambda: jgx.Target(j_model, "oops", jgx.ChoiceMap.empty()),
               lambda: tgx.Target(t_model, "oops", tgx.ChoiceMap.empty()), r"args", r"args", "args")


def test_error_names_method_and_param(trs):
    j, t = trs
    for msg in both_raise(lambda: j.get_choices().merge({"y": 1}), lambda: t.get_choices().merge({"y": 1}),
                          r"merge", r"merge"):
        assert "merge" in msg and "`other`" in msg and "dict" in msg


# -- TestValidCallsUnchanged -----------------------------------------------------------------


def test_flag_and_selection_filters_pass(trs):
    _, t = trs
    with checked_mode():
        chm = t.get_choices()
        assert chm.filter(True) is not None
        assert chm.filter(torch.tensor(False)) is not None
        assert chm.filter(tgx.Selection.at["x"]) is not None


def test_inference_runs_under_checked_mode():
    with checked_mode():
        target = tgx.Target(t_model, (), tgx.ChoiceMap.kw(y=0.5))
        alg = tgx.ImportanceK(target, k_particles=32)
        w, s = alg.random_weighted(_rng(1), target)
    assert s["x"].shape == () and w.shape == ()


def test_edit_requests_under_checked_mode(trs):
    _, t = trs
    with checked_mode():
        for req in (
            tgx.Update(tgx.ChoiceMap.kw(x=0.3)),
            tgx.Regenerate(tgx.Selection.at["x"]),
            tgx.HMC(tgx.Selection.at["x"], 0.05),
        ):
            new_tr, *_ = req.edit(_rng(2), t, tgx.Diff.no_change(()))
            assert new_tr.get_score().shape == ()


def test_default_on_catches_without_optin(trs):
    j, t = trs
    both_raise(lambda: j.get_choices().merge({"y": 1}), lambda: t.get_choices().merge({"y": 1}),
               r"merge.*other", r"merge.*other", "other", checked=False)
    both_raise(lambda: j_model.simulate(7, ()), lambda: t_model.simulate(7, ()),
               r"key.*PRNG", r"rng.*torch\.Generator", "key", "rng", checked=False)


def test_do_typecheck_false_disables(trs):
    _, t = trs
    assert is_typechecked()
    do_typecheck(False)
    try:
        assert not is_typechecked()
        # The wrappers are off: a wrong type falls through to whatever the
        # implementation does, never the checks' error.
        try:
            t.get_choices().merge({"y": 1})
        except TypeError as e:
            assert "`other`" not in str(e)
        except Exception:
            pass
        # checked_mode still puts the wrappers on while the checks are off.
        with checked_mode():
            with pytest.raises(TypeError, match=r"merge.*other"):
                t.get_choices().merge({"y": 1})
    finally:
        do_typecheck(True)
    assert is_typechecked()


# -- TestZeroCompiledCost: the same operations, results and draws -----------------------------------


class _Log(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _logged_run(on: bool):
    do_typecheck(on)
    try:
        rng = _rng(5)
        with _Log() as log:
            tr = t_mu_model.simulate(rng, (0.5,), n=8)
            _, w = t_mu_model.importance(rng, tgx.ChoiceMap.kw(y=1.0), (0.5,), n=8)
            new, w_edit, _, _ = tr.update(rng, tgx.ChoiceMap.kw(x=0.0))
            score, _ = t_mu_model.assess(new.get_choices(), (0.5,))
        return log.ops, [tr.get_score(), w, w_edit, score], rng.get_state()
    finally:
        do_typecheck(True)


def test_dispatched_ops_results_and_draws_identical_with_and_without_typecheck():
    on_ops, on_vals, on_state = _logged_run(True)
    off_ops, off_vals, off_state = _logged_run(False)
    assert on_ops == off_ops and len(on_ops) > 10
    assert all(torch.equal(a, b) for a, b in zip(on_vals, off_vals))
    assert torch.equal(on_state, off_state)


def test_hmc_step_and_adev_gradient_identical_with_and_without_typecheck():
    """HMC's gradient and ADEV's estimate run instrumented methods under
    `torch.func` transforms and autograd: the wrappers take functorch's
    wrapped tensors, and change nothing."""
    from genjax_tpu_torch.inference import vi
    from genjax_tpu_torch.models import ravi

    def run():
        rng = _rng(9)
        chains, _ = t_mu_model.importance(rng, tgx.ChoiceMap.kw(y=1.0), (0.0,), n=16)
        new, acc = tgx.mh(rng, chains, tgx.HMC(tgx.Selection.at["x"], 0.1, L=3))
        grads = vi.ELBO(ravi.guide, ravi.make_target)(rng, (0.0, 0.0))
        return [new.get_choices()["x"], new.get_score(), acc, *grads]

    do_typecheck(False)
    try:
        off = run()
    finally:
        do_typecheck(True)
    e0 = typecheck.entries()
    on = run()
    assert typecheck.entries() > e0
    assert all(torch.equal(a, b) for a, b in zip(on, off))


# -- TestInstrumentation ---------------------------------------------------------------------


def test_idempotent():
    # A first call may wrap framework subclasses defined since import (by
    # other test modules); a second call finds nothing left to wrap.
    typecheck.instrument(tgx)
    assert typecheck.instrument(tgx) == 0


def test_instrument_wraps_a_non_trivial_count():
    assert len(typecheck._INSTALLED) > 100


def test_subclass_overrides_wrapped():
    from genjax_tpu_torch.core.choice_map import Static

    assert getattr(vars(Static)["filter"], "__gx_typechecked__", False)


def test_base_interface_wrapped():
    from genjax_tpu_torch.core.gfi import GenerativeFunction

    assert getattr(vars(GenerativeFunction)["simulate"], "__gx_typechecked__", False)


def test_wrappers_preserve_metadata():
    import inspect

    fn = vars(tgx.ChoiceMap)["filter"]
    assert fn.__name__ == "filter"
    assert hasattr(fn, "__wrapped__")
    assert "selection" in inspect.signature(fn).parameters


# -- tests/core/test_checked_mode.py: TestCheckedMode ----------------------------------------------


def test_raw_seed_instead_of_key():
    both_raise(lambda: j_mu_model.simulate(42, (0.0,)), lambda: t_mu_model.simulate(42, (0.0,)),
               "PRNG key", "torch.Generator", "key", "rng")


def test_args_not_a_tuple():
    both_raise(lambda: j_mu_model.simulate(jax.random.key(0), 0.0), lambda: t_mu_model.simulate(_rng(), 0.0),
               "TUPLE", "TUPLE", "args")


def test_dict_instead_of_choice_map():
    both_raise(lambda: j_mu_model.generate(jax.random.key(0), {"y": 1.0}, (0.0,)),
               lambda: t_mu_model.generate(_rng(), {"y": 1.0}, (0.0,)), r"ChoiceMap\.d", r"ChoiceMap\.d",
               "constraint")
    both_raise(lambda: j_mu_model.assess({"x": 0.0, "y": 1.0}, (0.0,)),
               lambda: t_mu_model.assess({"x": 0.0, "y": 1.0}, (0.0,)), "ChoiceMap", "ChoiceMap", "sample")


def test_non_request_edit():
    j_tr = j_mu_model.simulate(jax.random.key(0), (0.0,))
    t_tr = t_mu_model.simulate(_rng(), (0.0,))
    both_raise(
        lambda: j_mu_model.edit(jax.random.key(1), j_tr, jgx.ChoiceMap.kw(x=1.0), jgx.Diff.no_change((0.0,))),
        lambda: t_mu_model.edit(_rng(1), t_tr, tgx.ChoiceMap.kw(x=1.0), tgx.Diff.no_change((0.0,))),
        "EditRequest", "EditRequest", "edit_request",
    )


def test_distribution_entry_points():
    both_raise(lambda: jgx.normal.simulate(0, (0.0, 1.0)), lambda: tgx.normal.simulate(0, (0.0, 1.0)),
               "PRNG key", "torch.Generator", "key", "rng")
    both_raise(lambda: jgx.normal.simulate(jax.random.key(0), 0.0), lambda: tgx.normal.simulate(_rng(), 0.0),
               "TUPLE", "TUPLE", "args")


def test_valid_calls_pass_and_mode_restores():
    with checked_mode():
        tr = t_mu_model.simulate(_rng(), (0.0,))
        score, _ = t_mu_model.assess(tr.get_choices(), (0.0,))
        assert torch.isclose(score, tr.get_score())
    assert not is_checked()


def test_checked_calls_work_under_torch_func():
    """JAX's checks run at trace time under `jit`; the port's run inside
    `torch.func.grad` (functorch's wrapped tensors pass) and change
    nothing."""
    chm = tgx.ChoiceMap.kw(x=0.3, y=1.0)

    def f(mu):
        return t_mu_model.assess(chm, (mu,))[0]

    with checked_mode():
        g = torch.func.grad(f)(torch.tensor(0.0))
    assert torch.isfinite(g) and torch.isclose(g, torch.tensor(0.3))


# -- TestConstructorValidation ---------------------------------------------------------------


def test_target_args_must_be_tuple():
    both_raise(lambda: jgx.Target(j_mu_model, 0.0, jgx.ChoiceMap.kw(x=1.0)),
               lambda: tgx.Target(t_mu_model, 0.0, tgx.ChoiceMap.kw(x=1.0)), "TUPLE", "TUPLE", "args")


def test_target_constraint_must_be_choice_map():
    both_raise(lambda: jgx.Target(j_mu_model, (0.0,), {"x": 1.0}),
               lambda: tgx.Target(t_mu_model, (0.0,), {"x": 1.0}), "ChoiceMap", "ChoiceMap", "constraint")


def test_mask_rejects_non_flag():
    both_raise(lambda: jgx.ChoiceMap.kw(x=1.0).mask("x"), lambda: tgx.ChoiceMap.kw(x=1.0).mask("x"),
               "flag", "flag", "flag")


def test_filter_rejects_non_selection():
    both_raise(lambda: jgx.ChoiceMap.kw(x=1.0).filter("x"), lambda: tgx.ChoiceMap.kw(x=1.0).filter("x"),
               "[Ss]election", "[Ss]election", "selection")


def test_or_rejects_dict():
    both_raise(lambda: jgx.ChoiceMap.kw(x=1.0) | {"y": 2.0}, lambda: tgx.ChoiceMap.kw(x=1.0) | {"y": 2.0},
               "ChoiceMap", "ChoiceMap", "other")


def test_selection_operand_types():
    from genjax_tpu import SelectionBuilder as JS
    from genjax_tpu_torch import SelectionBuilder as TS

    both_raise(lambda: JS["x"] | "y", lambda: TS["x"] | "y", "Selection", "Selection")
    both_raise(lambda: JS["x"] & "y", lambda: TS["x"] & "y", "Selection", "Selection")


def test_selection_filter_rejects_dict():
    from genjax_tpu import SelectionBuilder as JS
    from genjax_tpu_torch import SelectionBuilder as TS

    both_raise(lambda: JS["x"].filter({"x": 1.0}), lambda: TS["x"].filter({"x": 1.0}), "ChoiceMap", "ChoiceMap",
               "sample")


def test_unchecked_stays_permissive():
    chm = tgx.ChoiceMap.kw(x=1.0)
    kept = chm.filter(tgx.Selection.at["x"])
    assert "x" in kept
    assert "x" in tgx.Selection.at["x"].filter(chm)
