"""Indexed addresses of the port's choice maps and selections, against the
JAX package's on the same numpy-made values: `chm[i, "x"]`, `chm["x"]`,
`chm(i)`, `S[i, "x"]`, `S[..., "x"]`, `ChoiceMap.d` / `kw` / `entry` with
index components, `extend`, `merge`, `filter`, the address grammar, and the
all-lanes view (`at_lanes`) that the combinators use. Values are compared
exactly (they are copied, not computed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.core.choice_map import statically_unmatchable_at_index_level as j_unmatchable
from genjax_tpu_torch.core.choice_map import (
    ChoiceMapNoValueAtAddress,
    Indexed,
    MaskedSel,
    _validate_addr,
    statically_unmatchable_at_index_level,
)
from genjax_tpu_torch.core.mask import Mask

torch.set_num_threads(1)

TS = tgx.Selection.at
JC, TC = jgx.ChoiceMap, tgx.ChoiceMap
JS = jgx.Selection.at
RNG = np.random.default_rng(0)
X = RNG.standard_normal((4, 3)).astype(np.float32)  # 4 steps of a 3-vector
Z = RNG.integers(0, 5, size=4)


def _pair():
    return (
        JC.kw(x=jnp.asarray(X), z=jnp.asarray(Z)),
        TC.kw(x=torch.from_numpy(X), z=torch.from_numpy(Z)),
    )


@pytest.mark.parametrize("idx", [0, 2, 3])
def test_stacked_map_indexes_like_jax(idx):
    j, t = _pair()
    np.testing.assert_array_equal(t[idx, "x"].numpy(), np.asarray(j[idx, "x"]))
    np.testing.assert_array_equal(t(idx)["z"].numpy(), np.asarray(j(idx)["z"]))
    np.testing.assert_array_equal(t.get_submap(idx)["x"].numpy(), np.asarray(j.get_submap(idx)["x"]))
    np.testing.assert_array_equal(t["x"].numpy(), X)  # the bare address: the whole stacked array
    np.testing.assert_array_equal(t[torch.tensor(idx), "x"].numpy(), X[idx])  # a 0-d index tensor
    assert (idx, "x") in t and (idx, "q") not in t


def test_index_addresses_the_axis_behind_the_particle_axis():
    v = torch.from_numpy(RNG.standard_normal((6, 4, 3)).astype(np.float32))  # K=6 particles, 4 steps
    t = TC.kw(x=tgx.per_particle(v), shared=torch.from_numpy(X))
    assert torch.equal(t[2, "x"], v[:, 2]) and torch.equal(t[2, "shared"], torch.from_numpy(X[2]))
    assert t(2).batched_leaves() == [1, 0]
    assert torch.equal(t(slice(1, 3))["x"], v[:, 1:3])
    assert torch.equal(t[torch.tensor([3, 0]), "x"], v[:, [3, 0]])


@pytest.mark.parametrize("query", [1, 2])
def test_entries_under_an_index_like_jax(query):
    j = JC.d({(1, "x"): jnp.asarray(X[1]), (2, "x"): jnp.asarray(X[2]), "top": 1.5})
    t = TC.d({(1, "x"): torch.from_numpy(X[1]), (2, "x"): torch.from_numpy(X[2]), "top": 1.5})
    # Both resolve a Python int against a Python int when the map is built.
    np.testing.assert_array_equal(t[query, "x"].numpy(), np.asarray(j[query, "x"]))
    assert (query, "x") in t and (0, "x") not in t and t["top"] == 1.5
    with pytest.raises(ChoiceMapNoValueAtAddress):
        t[0, "x"]
    assert isinstance(TC.entry(torch.tensor(1.0), 3, "x"), Indexed)
    assert TC.kw(x=1.0).extend(3)(3)["x"] == 1.0
    assert TC.entry({"a": 1.0}, 2, "sub")[2, "sub", "a"] == 1.0


def test_entries_under_a_device_index_hold_a_flag():
    t = TC.entry(torch.tensor(7.0), torch.tensor(2), "x")  # a 0-d tensor is compared on the device
    hit, miss = t(torch.tensor(2))["x"], t(3)("x")
    assert float(hit) == 7.0 if not isinstance(hit, Mask) else float(hit.value) == 7.0 and bool(hit.flag)
    assert miss.static_is_empty() or not bool(miss.get_value().flag)
    rows = TC.entry(torch.from_numpy(X[:2]), torch.tensor([3, 1]), "x")  # row 0 at index 3, row 1 at index 1
    got = rows(torch.tensor(1))["x"]
    assert isinstance(got, Mask) and bool(got.flag) and torch.equal(got.value, torch.from_numpy(X[1]))
    assert not bool(rows(torch.tensor(0))["x"].flag)
    j = JC.entry(jnp.asarray(X[:2]), jnp.asarray([3, 1]), "x")
    np.testing.assert_array_equal(got.value.numpy(), np.asarray(j[1, "x"].value))


def test_merge_extend_filter_like_jax():
    j, t = _pair()
    j2 = j | JC.d({(1, "extra"): 2.0})
    t2 = t.merge(TC.d({(1, "extra"): 2.0}))
    assert float(t2[1, "extra"]) == float(j2[1, "extra"])
    np.testing.assert_array_equal(t2[1, "x"].numpy(), X[1])
    for sel_j, sel_t in ((JS["x"], TS["x"]), (JS[..., "z"], TS[..., "z"]), (~JS["x"], ~TS["x"])):
        fj, ft = j.filter(sel_j), t.filter(sel_t)
        for addr in ("x", "z"):
            assert (addr in ft) == (addr in fj)
    nested = t.extend("outer")
    np.testing.assert_array_equal(nested["outer", 3, "x"].numpy(), X[3])
    assert TC.kw(x=torch.zeros(0)).static_is_empty()  # a zero-length batch carries no choices


@pytest.mark.parametrize(
    "make",
    [
        lambda S: S[1, "x"],
        lambda S: S[..., "x"],
        lambda S: S["x"],
        lambda S: S[1, "x"] | S["y"],
        lambda S: S[1, "x"] & S[..., "x"],
        lambda S: ~S[1, "x"],
        lambda S: S[()],
    ],
)
def test_selections_with_index_components_like_jax(make):
    sj, st = make(JS), make(TS)
    for addr in [(1, "x"), (2, "x"), "x", "y", (1, "y"), (1,), ()]:
        if addr == ():
            assert bool(st.check()) == bool(sj.check())
        else:
            assert (addr in st) == bool(sj[addr]), addr
    assert statically_unmatchable_at_index_level(st) == j_unmatchable(sj)


def test_selection_over_every_lane_at_once():
    lanes = torch.arange(4)
    one = TS[2, "x"].at_lanes(lanes)
    assert isinstance(one, MaskedSel) and one("x").check().tolist() == [False, False, True, False]
    assert one("y").check() is False
    assert TS[..., "x"].at_lanes(lanes)("x").check() is True
    assert (~TS[2, "x"]).at_lanes(lanes)("x").check().tolist() == [True, True, False, True]
    both = (TS[0, "x"] | TS[3, "x"]).at_lanes(lanes)("x").check()
    assert both.tolist() == [True, False, False, True]
    # Two lane levels: the outer flag gains an axis, flags stay aligned to the innermost.
    nested = TS[1, 2, "x"].at_lanes(torch.arange(3)).at_lanes(lanes)("x").check()
    assert nested.shape == (3, 4) and nested.nonzero().tolist() == [[1, 2]]
    assert TS["x"].at_lanes(lanes).check() is False


def test_choice_map_over_every_lane_at_once():
    lanes = torch.arange(4)
    stacked = TC.kw(x=torch.from_numpy(X)).at_lanes(lanes)("x")
    assert stacked.value_is_batched() == 1 and not isinstance(stacked.get_value(), Mask)  # the lane axis is one more batch axis
    one = TC.d({(2, "x"): torch.from_numpy(X[2])}).at_lanes(lanes)["x"]
    assert isinstance(one, Mask) and one.flag.tolist() == [False, False, True, False] and one.flag_depth == 1
    two = TC.d({(0, "x"): torch.from_numpy(X[0]), (3, "x"): torch.from_numpy(X[3])}).at_lanes(lanes)["x"]
    assert two.flag.tolist() == [True, False, False, True]
    assert torch.equal(two.value[0], torch.from_numpy(X[0])) and torch.equal(two.value[3], torch.from_numpy(X[3]))
    rows = TC.entry(torch.from_numpy(X[:2]), torch.tensor([3, 1]), "x").at_lanes(lanes)["x"]
    assert rows.flag.tolist() == [False, True, False, True] and torch.equal(rows.value[3], torch.from_numpy(X[0]))
    per_particle = TC.d({(1, "s"): tgx.per_particle(torch.arange(6.0))}).at_lanes(lanes)("s")
    assert per_particle.get_value().value.shape == (6, 1) and per_particle.value_is_batched() == 2
    with pytest.raises(ValueError, match="rows along the indexed axis"):
        TC.kw(x=torch.zeros(3)).at_lanes(lanes)
    sel = TC.d({(2, "x"): 1.0}).get_selection().at_lanes(lanes)("x").check()
    assert sel.tolist() == [False, False, True, False]


@pytest.mark.parametrize(
    "addr, ok",
    [
        ((1, "x"), True),
        ((torch.tensor(1), "x", slice(None)), True),
        ((torch.tensor([0, 1]), "x"), True),
        ((slice(None), 1), False),
        ((torch.tensor([0, 1]), torch.tensor([0, 1])), False),
        ((slice(0, 2), "x"), False),
        ((1.5, "x"), None),
        ((torch.zeros(2, 2, dtype=torch.long),), False),
    ],
)
def test_address_grammar(addr, ok):
    if ok:
        assert _validate_addr(addr) == addr
    else:
        with pytest.raises(TypeError if ok is None else ValueError):
            _validate_addr(addr)
    if addr == (slice(0, 2), "x"):
        assert _validate_addr(addr, allow_partial_slice=True) == addr


@pytest.mark.parametrize("flags", ["per_row", "one_for_all", "per_particle_row"])
def test_index_tensor_over_masked_choices_like_jax(flags):
    """`C[idx, "x"]` over a `Mask`: a lane holds where it is indexed AND
    its row's flag holds (JAX's `Mask.build(row, found)`), here through a
    `Vmap`'s generate, whose weight and choices are held against JAX's."""
    n_lanes, K = 5, 3
    rng = np.random.default_rng(3)
    mu = np.arange(n_lanes, dtype=np.float32)
    idx = np.array([0, 2, 4])
    lead = (K,) if flags == "per_particle_row" else ()
    vals = rng.standard_normal(lead + (3,)).astype(np.float32)
    flag = {"per_row": np.array([True, False, True]), "one_for_all": np.array(False),
            "per_particle_row": rng.random((K, 3)) < 0.5}[flags]

    @jgx.gen
    def j_lane(m):
        return jgx.normal(m, 1.0) @ "x"

    @tgx.gen
    def t_lane(m):
        return tgx.normal(m, 1.0) @ "x"

    def j_weight(v, f):
        chm = JC.entry(jgx.Mask(v, f), jnp.asarray(idx), "x")
        tr, w = j_lane.vmap(in_axes=(0,)).generate(jax.random.key(0), chm, (jnp.asarray(mu),))
        return w, tr.get_choices()["x"]

    mark = tgx.per_particle if lead else (lambda v: v)
    t_chm = TC.entry(Mask(mark(torch.from_numpy(vals)), mark(torch.from_numpy(flag))), torch.from_numpy(idx), "x")
    tr, w = t_lane.vmap(in_axes=(0,)).generate(torch.Generator().manual_seed(0), t_chm, (torch.from_numpy(mu),),
                                               n=K if lead else None)
    ref_w, ref_x = (jax.vmap(j_weight) if lead else j_weight)(jnp.asarray(vals), jnp.asarray(flag))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=1e-5, atol=1e-5)
    held = np.zeros(lead + (n_lanes,), bool)
    held[..., idx] = np.broadcast_to(flag, lead + (3,))
    x = tr.get_choices()["x"].numpy()
    np.testing.assert_array_equal(x[held], np.asarray(ref_x)[held])  # the constrained lanes; the others are fresh draws
