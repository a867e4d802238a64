"""`StaticRequest` (per-address edit sub-requests) and `VectorRequest`
over `Scan` against `genjax_tpu` on the CPU, case for case after
`tests/lang/test_static_request.py`, with the backward requests that
`Regenerate` now answers with (a `StaticRequest`, as in JAX) through the
combinators that hand them on.

Both packages edit the same numpy-made choices; weights agree within 1e-6
relative (float32), and the backward requests agree in kind, address by
address.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as J
import genjax_tpu_torch as T
from genjax_tpu.combinators import VectorRequest as JVectorRequest
from genjax_tpu_torch.combinators import VectorRequest as TVectorRequest

torch.set_num_threads(1)


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


def _close(got, ref, tol=1e-6):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), (got, ref)


def _kinds(request) -> dict:
    return {k: type(v).__name__ for k, v in request.addressed.items()}


@J.gen
def j_model():
    a = J.normal(0.0, 1.0) @ "a"
    b = J.normal(a, 1.0) @ "b"
    c = J.normal(0.0, 1.0) @ "c"
    return a + b + c


@T.gen
def t_model():
    a = T.normal(0.0, 1.0) @ "a"
    b = T.normal(a, 1.0) @ "b"
    c = T.normal(0.0, 1.0) @ "c"
    return a + b + c


_CHOICES = {"a": 0.4, "b": -0.2, "c": 1.3}


def _traces():
    jtr, _ = j_model.generate(jax.random.key(0), J.ChoiceMap.d({k: jnp.float32(v) for k, v in _CHOICES.items()}), ())
    ttr, _ = t_model.generate(_rng(), T.ChoiceMap.d({k: torch.tensor(v) for k, v in _CHOICES.items()}), ())
    _close(ttr.get_score(), jtr.get_score())
    return jtr, ttr


def test_mixed_per_address_requests():
    jtr, ttr = _traces()
    jreq = J.StaticRequest({"a": J.Update(J.ChoiceMap.choice(1.0)), "c": J.Regenerate(J.Selection.all())})
    treq = T.StaticRequest({"a": T.Update(T.ChoiceMap.choice(1.0)), "c": T.Regenerate(T.Selection.all())})
    jnew, _, jrd, jbwd = jreq.edit(jax.random.key(1), jtr, J.Diff.no_change(()))
    tnew, tw, trd, tbwd = treq.edit(_rng(1), ttr, T.Diff.no_change(()))
    _close(tnew.get_choices()["a"], jnew.get_choices()["a"])
    # "b" keeps its value, re-scored against a = 1 (EmptyRequest under
    # changed argdiffs is an empty Update).
    _close(tnew.get_choices()["b"], _CHOICES["b"])
    _close(tnew.get_subtrace("b").get_score(), jnew.get_subtrace("b").get_score())
    assert float(tnew.get_choices()["c"]) != _CHOICES["c"]
    assert type(tbwd).__name__ == type(jbwd).__name__ == "StaticRequest"
    assert _kinds(tbwd) == _kinds(jbwd)
    assert T.Diff.static_check_no_change(trd) == J.Diff.static_check_no_change(jrd) is False
    _close(tw, tnew.get_score() - ttr.get_score())


def test_weight_consistency():
    jtr, ttr = _traces()
    jnew, jw, _, _ = J.StaticRequest({"a": J.Update(J.ChoiceMap.choice(0.5))}).edit(jax.random.key(1), jtr,
                                                                                   J.Diff.no_change(()))
    tnew, tw, _, _ = T.StaticRequest({"a": T.Update(T.ChoiceMap.choice(0.5))}).edit(_rng(1), ttr, T.Diff.no_change(()))
    _close(tw, jw)
    _close(tw, tnew.get_score() - ttr.get_score())


def test_backward_static_request_undoes_the_move():
    """The backward request of a `StaticRequest` edit applied to the new
    trace gives back the old values, with the negated weight (SMCP3's
    round trip)."""
    _, ttr = _traces()
    treq = T.StaticRequest({"a": T.Update(T.ChoiceMap.choice(0.5)), "c": T.Update(T.ChoiceMap.choice(-1.0))})
    new, w, _, bwd = treq.edit(_rng(1), ttr, T.Diff.no_change(()))
    back, w_back, _, _ = bwd.edit(_rng(2), new, T.Diff.no_change(()))
    for addr, v in _CHOICES.items():
        _close(back.get_choices()[addr], v)
    _close(w_back, -w)


def test_static_request_dispatches_from_edit_under_particles():
    jtr, _ = _traces()
    ttr, _ = t_model.generate(_rng(), T.ChoiceMap.d({k: T.per_particle(torch.full((5,), v)) for k, v in _CHOICES.items()}),
                              (), n=5)
    new, tw, _, bwd = t_model.edit(_rng(1), ttr, T.StaticRequest({"a": T.Update(T.ChoiceMap.choice(0.5))}),
                                   T.Diff.no_change(()))
    _, jw, _, _ = J.StaticRequest({"a": J.Update(J.ChoiceMap.choice(0.5))}).edit(jax.random.key(1), jtr,
                                                                                J.Diff.no_change(()))
    _close(tw, np.full(5, float(jw)))
    assert _kinds(bwd) == {"a": "Update", "b": "Update", "c": "Update"}


@J.gen
def j_walk(c, _x):
    z = J.normal(c, 1.0) @ "z"
    return z, z


@T.gen
def t_walk(c, _x):
    z = T.normal(c, 1.0) @ "z"
    return z, z


def test_vector_update_over_scan():
    jm, tm = j_walk.scan(n=6), t_walk.scan(n=6)
    zs = np.random.default_rng(0).normal(size=6).astype(np.float32)
    jtr, _ = jm.generate(jax.random.key(0), J.ChoiceMap.kw(z=jnp.asarray(zs)), (0.0, None))
    ttr, _ = tm.generate(_rng(), T.ChoiceMap.kw(z=torch.from_numpy(zs)), (0.0, None))
    flags = np.arange(6) == 2
    vals = np.full(6, 9.0, dtype=np.float32)
    jreq = JVectorRequest(J.Update(J.ChoiceMap.kw(z=J.Mask(jnp.asarray(vals), jnp.asarray(flags)))))
    treq = TVectorRequest(T.Update(T.ChoiceMap.kw(z=T.Mask(torch.from_numpy(vals), torch.from_numpy(flags)))))
    jnew, jw, _, jbwd = jreq.edit(jax.random.key(1), jtr, J.Diff.no_change((0.0, None)))
    tnew, tw, _, tbwd = treq.edit(_rng(1), ttr, T.Diff.no_change((0.0, None)))
    new_z = tnew.get_choices()["z"]
    _close(new_z[2], 9.0)
    _close(new_z[:2], zs[:2])
    _close(new_z[3:], zs[3:])
    _close(tw, jw, 1e-5)
    _close(tw, tnew.get_score() - ttr.get_score(), 1e-4)
    assert type(tbwd).__name__ == type(jbwd).__name__ == "VectorRequest"


def test_scan_regenerate_backward_holds_each_steps_static_request():
    """`Scan`'s re-scan `Regenerate` answers with a `VectorRequest` of the
    steps' backward requests; a `@gen` kernel's are `StaticRequest`s now,
    and the `VectorRequest` runs them step by step."""

    @T.gen
    def kernel(c, _x):
        z = T.normal(c, 1.0) @ "z"
        u = T.normal(0.0, 1.0) @ "u"
        return z + u, z

    model = kernel.scan(n=4)
    tr = model.simulate(_rng(0), (torch.tensor(0.0), None), n=3)
    new, w, _, bwd = T.Regenerate(T.Selection.at[..., "u"]).edit(_rng(1), tr, T.Diff.no_change((torch.tensor(0.0), None)))
    assert isinstance(bwd, TVectorRequest) and all(type(r).__name__ == "StaticRequest" for r in bwd.request)
    # "z" reads the carry, whose tangent is UnknownChange at every step (as
    # in JAX): it is re-scored, and answers with an (empty) Update.
    assert [_kinds(r) for r in bwd.request] == [{"z": "Update", "u": "Update"}] * 4
    back, w_back, _, _ = bwd.edit(_rng(2), new, T.Diff.no_change((torch.tensor(0.0), None)))
    _close(back.get_choices()["u"], tr.get_choices()["u"])
    _close(w_back, -w, 1e-5)


def test_switch_same_branch_regenerate_selects_the_static_requests():
    """A `Switch` with an index tensor answers a same-branch `Regenerate`
    with the branches' `StaticRequest`s of one layout selected leaf by
    leaf by the index, as JAX's `tree_choose` does."""

    @T.gen
    def lo():
        return T.normal(-5.0, 1.0) @ "v"

    @T.gen
    def hi():
        return T.normal(5.0, 1.0) @ "v"

    sw = T.switch(lo, hi)
    idx = T.per_particle(torch.tensor([0, 1, 1, 0]))
    tr = sw.simulate(_rng(0), (idx, (), ()), n=4)
    new, w, _, bwd = sw.edit(_rng(1), tr, T.Regenerate(T.Selection.at["v"]), T.Diff.no_change((idx, (), ())), 4)
    assert type(bwd).__name__ == "StaticRequest" and _kinds(bwd) == {"v": "Update"}
    # Each particle's old value, from the branch its index names.
    held = bwd.addressed["v"].constraint.get_value()
    old = torch.where(idx.as_subclass(torch.Tensor) == 0, tr.subtraces[0].get_choices()["v"],
                      tr.subtraces[1].get_choices()["v"])
    _close(held, old)
    _close(w, new.get_score() - tr.get_score(), 1e-5)


@pytest.mark.parametrize("wrap", ["mask", "dimap"])
def test_combinators_hand_the_static_request_on(wrap):
    """`Mask` and `Dimap` hand their inner `Regenerate`'s backward request
    on as it is, as JAX's do."""

    @T.gen
    def inner(x):
        return T.normal(x, 1.0) @ "v"

    if wrap == "mask":
        fn, args = inner.mask(), (torch.tensor(True), torch.tensor(0.0))
    else:
        fn, args = inner.contramap(lambda x: (x + 1.0,)), (torch.tensor(0.0),)
    tr = fn.simulate(_rng(0), args)
    _, w, _, bwd = fn.edit(_rng(1), tr, T.Regenerate(T.Selection.at["v"]), T.Diff.no_change(args))
    assert type(bwd).__name__ == "StaticRequest" and _kinds(bwd) == {"v": "Update"}
