"""The combinators, port (`genjax_tpu_torch`) against JAX (`genjax_tpu`) on
the CPU, on the same numpy-made inputs: `Vmap`, `Scan`, `Dimap`, `repeat`
and the derived scans (`accumulate`, `reduce`, `iterate`, `iterate_final`).

For each: `assess` score and return value; per-lane and per-step scores;
`generate` weights with the constraint on one index, on every index and
absent (the port's own sampled choices are carried to JAX, whose fully
constrained trace gives the reference score and `project`); `project` of
`S[i, "x"]` and `S[..., "x"]`; `Update` weight and discard; `IndexRequest`
weight and backward request. Each also under a particle axis (`n=K`)
against `jax.vmap` of the JAX method, and nested. Both sides compute in
float32 and sum in different orders: scores of O(10) are compared to 1e-5
absolute per unit of magnitude (`_close`). Random draws are compared
statistically at 5 standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu_torch import convert
from genjax_tpu_torch.combinators import ScanTrace, VmapTrace

torch.set_num_threads(1)

TS = tgx.Selection.at
JC, TC = jgx.ChoiceMap, tgx.ChoiceMap
JS = jgx.Selection.at
K, N, D, T = 6, 5, 3, 4
KEY = jax.random.key(0)


def _close(got, ref, tol=1e-5):
    """|got - ref| <= tol * max(1, |ref|), elementwise, shapes equal."""
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), (got, ref)


def _t(x):
    return convert.tensor(x, "cpu")


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


# -- the models, one pair each ----------------------------------------------


@jgx.gen
def j_datum(x, w):
    z = jgx.normal(jnp.sum(x * w), 1.0) @ "z"
    return jgx.normal(z, 0.5) @ "y"


@tgx.gen
def t_datum(x, w):
    z = tgx.normal((x * w).sum(-1), 1.0) @ "z"
    return tgx.normal(z, 0.5) @ "y"


J_VMAP, T_VMAP = j_datum.vmap(in_axes=(0, None)), t_datum.vmap(in_axes=(0, None))


@jgx.gen
def j_step(c, x):
    z = jgx.normal(0.9 * c + x, 1.0) @ "z"
    _ = jgx.normal(z, 0.5) @ "y"
    return z, 2.0 * z


@tgx.gen
def t_step(c, x):
    z = tgx.normal(0.9 * c + x, 1.0) @ "z"
    _ = tgx.normal(z, 0.5) @ "y"
    return z, 2.0 * z


J_SCAN, T_SCAN = j_step.scan(n=T), t_step.scan(n=T)


def _vmap_inputs(seed=0, particles=None):
    rng = np.random.default_rng(seed)
    lead = () if particles is None else (particles,)
    X = rng.standard_normal((N, D)).astype(np.float32)
    w = rng.standard_normal(lead + (D,)).astype(np.float32)
    z = rng.standard_normal(lead + (N,)).astype(np.float32)
    y = rng.standard_normal(lead + (N,)).astype(np.float32)
    return X, w, z, y


def _scan_inputs(seed=1, particles=None):
    rng = np.random.default_rng(seed)
    lead = () if particles is None else (particles,)
    xs = rng.standard_normal(T).astype(np.float32)
    c0 = np.float32(0.3)
    z = rng.standard_normal(lead + (T,)).astype(np.float32)
    y = rng.standard_normal(lead + (T,)).astype(np.float32)
    return c0, xs, z, y


def _j_trace(model, args, choices):
    """JAX's fully constrained trace of one particle."""
    chm = JC.d({k: jnp.asarray(v) for k, v in choices.items()})
    return model.importance(KEY, chm, args)[0]


# -- Vmap ----------------------------------------------------------------------


def test_vmap_assess_score_and_retval():
    X, w, z, y = _vmap_inputs()
    ref_s, ref_r = J_VMAP.assess(JC.kw(z=jnp.asarray(z), y=jnp.asarray(y)), (jnp.asarray(X), jnp.asarray(w)))
    s, r = T_VMAP.assess(TC.kw(z=_t(z), y=_t(y)), (_t(X), _t(w)))
    _close(s, ref_s)
    _close(r, ref_r)


def test_vmap_assess_under_particle_axis():
    X, w, z, y = _vmap_inputs(particles=K)
    one = lambda w, z, y: J_VMAP.assess(JC.kw(z=z, y=y), (jnp.asarray(X), w))  # noqa: E731
    ref_s, ref_r = jax.vmap(one)(jnp.asarray(w), jnp.asarray(z), jnp.asarray(y))
    sample = TC.kw(z=tgx.per_particle(_t(z)), y=tgx.per_particle(_t(y)))
    s, r = T_VMAP.assess(sample, (_t(X), tgx.per_particle(_t(w))), n=K)
    _close(s, ref_s)
    _close(r, ref_r)


def test_vmap_per_lane_scores_match_jax_lane_by_lane():
    X, w, z, y = _vmap_inputs(particles=K)
    one = lambda w, z, y: _j_trace(J_VMAP, (jnp.asarray(X), w), {"z": z, "y": y})  # noqa: E731
    j_tr = jax.vmap(one)(jnp.asarray(w), jnp.asarray(z), jnp.asarray(y))
    # `w` is per particle: an argument is carried across marked (numpy arguments are shared).
    tr = convert.trace(T_VMAP, (X, tgx.per_particle(_t(w))), {"z": z, "y": y}, n=K, device="cpu", kind=VmapTrace)
    assert isinstance(tr, VmapTrace)
    with pytest.raises(TypeError, match="ScanTrace"):
        convert.trace(T_VMAP, (X, tgx.per_particle(_t(w))), {"z": z, "y": y}, n=K, device="cpu", kind=ScanTrace)
    lanes = tr.inner.get_score()
    assert lanes.shape == (K, N)
    _close(lanes, j_tr.inner.get_score())  # tolerance 1e-5 per lane
    _close(tr.get_score(), j_tr.get_score())
    assert tr.get_choices()["y"].shape == (K, N) and tr.get_choices()[2, "y"].shape == (K,)


@pytest.mark.parametrize("where", ["one lane", "every lane", "absent"])
@pytest.mark.parametrize("particles", [None, K])
def test_vmap_generate_weight(where, particles):
    X, w, _, y = _vmap_inputs(particles=particles)
    lane = 2
    y_t = _t(y) if particles is None else tgx.per_particle(_t(y))
    w_t = _t(w) if particles is None else tgx.per_particle(_t(w))
    constraint = {
        "one lane": TC.d({(lane, "y"): y_t[..., lane]}),
        "every lane": TC.kw(y=y_t),
        "absent": TC.empty(),
    }[where]
    tr, weight = T_VMAP.generate(_rng(3), constraint, (_t(X), w_t), n=particles)
    choices = {k: tr.get_choices()[k].numpy() for k in ("z", "y")}
    selection = {"one lane": JS[lane, "y"], "every lane": JS[..., "y"], "absent": None}[where]

    def reference(w, z, y):
        j_tr = _j_trace(J_VMAP, (jnp.asarray(X), w), {"z": z, "y": y})
        proj = jnp.zeros(()) if selection is None else j_tr.project(KEY, selection)
        return j_tr.get_score(), proj

    if particles is None:
        ref_score, ref_weight = reference(jnp.asarray(w), choices["z"], choices["y"])
    else:
        ref_score, ref_weight = jax.vmap(reference)(jnp.asarray(w), choices["z"], choices["y"])
    _close(tr.get_score(), ref_score)
    _close(weight, ref_weight)
    if where == "one lane":
        np.testing.assert_array_equal(choices["y"][..., lane], y[..., lane])
        assert not np.allclose(choices["y"][..., 0], y[..., 0])
    if where == "every lane":
        np.testing.assert_array_equal(choices["y"], y)


@pytest.mark.parametrize("particles", [None, K])
def test_vmap_project(particles):
    X, w, z, y = _vmap_inputs(particles=particles)
    w_t = _t(w) if particles is None else tgx.per_particle(_t(w))
    chm = convert.choice_map({"z": z, "y": y}, "cpu", n=particles)
    tr, _ = T_VMAP.generate(_rng(), chm, (_t(X), w_t), n=particles)

    def reference(w, z, y):
        j_tr = _j_trace(J_VMAP, (jnp.asarray(X), w), {"z": z, "y": y})
        return j_tr.project(KEY, JS[1, "z"]), j_tr.project(KEY, JS[..., "z"]), j_tr.project(KEY, JS[1, "z"] | JS[3, "y"])

    args = (jnp.asarray(w), jnp.asarray(z), jnp.asarray(y))
    refs = reference(*args) if particles is None else jax.vmap(reference)(*args)
    _close(tr.project(_rng(), TS[1, "z"]), refs[0])
    _close(tr.project(_rng(), TS[..., "z"]), refs[1])
    _close(tr.project(_rng(), TS[1, "z"] | TS[3, "y"]), refs[2])
    with pytest.raises(ValueError, match="cannot match"):
        tr.project(_rng(), TS["z"])


@pytest.mark.parametrize("particles", [None, K])
def test_vmap_update_weight_and_discard(particles):
    X, w, z, y = _vmap_inputs(particles=particles)
    w_t = _t(w) if particles is None else tgx.per_particle(_t(w))
    tr, _ = T_VMAP.generate(_rng(), convert.choice_map({"z": z, "y": y}, "cpu", n=particles), (_t(X), w_t), n=particles)
    new_z = np.float32(0.25)
    new_all = np.linspace(-1, 1, N).astype(np.float32)

    def reference(w, z, y):
        j_tr = _j_trace(J_VMAP, (jnp.asarray(X), w), {"z": z, "y": y})
        one, w_one, _, d_one = j_tr.update(KEY, JC.d({(1, "z"): new_z}))
        every, w_every, _, d_every = j_tr.update(KEY, JC.kw(z=jnp.asarray(new_all)))
        return w_one, one.get_score(), w_every, every.get_score(), d_every["z"]

    args = (jnp.asarray(w), jnp.asarray(z), jnp.asarray(y))
    ref = reference(*args) if particles is None else jax.vmap(reference)(*args)
    one, w_one, _, d_one = tr.update(_rng(), TC.d({(1, "z"): torch.tensor(0.25)}))
    _close(w_one, ref[0])
    _close(one.get_score(), ref[1])
    _close(one.get_choices()[1, "z"], np.broadcast_to(new_z, z[..., 1].shape))
    _close(one.get_choices()[0, "z"], z[..., 0])
    # The discard holds the old value of the updated lane only (a Mask
    # over the lanes, as JAX's vmap of the kernel's discard).
    held = d_one["z"]
    assert held.flag.tolist() == [i == 1 for i in range(N)]
    _close(d_one[1, "z"].value, z[..., 1])
    assert bool(d_one[1, "z"].flag) and not bool(d_one[0, "z"].flag)
    every, w_every, _, d_every = tr.update(_rng(), TC.kw(z=_t(new_all)))
    _close(w_every, ref[2])
    _close(every.get_score(), ref[3])
    _close(d_every["z"], ref[4])
    # The backward request restores the trace and negates the weight.
    back, w_back, _, _ = one.update(_rng(), d_one)
    _close(w_back, -np.asarray(ref[0]))
    _close(back.get_choices()["z"], z)


@pytest.mark.parametrize("particles", [None, K])
def test_vmap_index_request(particles):
    X, w, z, y = _vmap_inputs(particles=particles)
    w_t = _t(w) if particles is None else tgx.per_particle(_t(w))
    tr, _ = T_VMAP.generate(_rng(), convert.choice_map({"z": z, "y": y}, "cpu", n=particles), (_t(X), w_t), n=particles)
    lane, value = 3, np.float32(-0.5)

    def reference(w, z, y):
        j_tr = _j_trace(J_VMAP, (jnp.asarray(X), w), {"z": z, "y": y})
        new, weight, _, bwd = j_tr.edit(KEY, jgx.IndexRequest(jnp.asarray(lane), jgx.Update(JC.kw(z=value))))
        return weight, new.get_score(), new.get_choices()["z"], bwd.request.constraint["z"]

    args = (jnp.asarray(w), jnp.asarray(z), jnp.asarray(y))
    ref = reference(*args) if particles is None else jax.vmap(reference)(*args)
    new, weight, _, bwd = tr.edit(_rng(), tgx.IndexRequest(lane, tgx.Update(TC.kw(z=torch.tensor(-0.5)))))
    _close(weight, ref[0])
    _close(new.get_score(), ref[1])
    _close(new.get_choices()["z"], ref[2])
    assert isinstance(bwd, tgx.IndexRequest) and bwd.idx == lane
    _close(bwd.request.constraint["z"], ref[3])
    # A 0-d index tensor addresses the same lane.
    same, w_same, _, _ = tr.edit(_rng(), tgx.IndexRequest(torch.tensor(lane), tgx.Update(TC.kw(z=torch.tensor(-0.5)))))
    _close(w_same, ref[0])
    _close(same.inner.get_score(), new.inner.get_score())


def test_vmap_regenerate_one_lane_and_draws_statistically():
    X, w, z, y = _vmap_inputs()
    n = 512
    tr, _ = T_VMAP.generate(_rng(), TC.kw(y=_t(y)), (_t(X), _t(w)), n=n)
    new, weight, _, bwd = tr.edit(_rng(5), tgx.Regenerate(TS[2, "z"]))
    old_z, new_z = tr.get_choices()["z"], new.get_choices()["z"]
    changed = (old_z != new_z).float().mean(0)
    assert changed[2] == 1.0 and changed[[0, 1, 3, 4]].sum() == 0.0
    _close(weight, (new.get_score() - tr.get_score()).numpy(), tol=1e-4)
    assert isinstance(bwd, tgx.Regenerate)
    # The fresh draws of lane 2 come from its prior N(x_2 . w, 1): 5 SE.
    mean = float(X[2] @ w)
    assert abs(float(new_z[:, 2].mean()) - mean) < 5.0 / np.sqrt(n)
    # And simulate draws every lane from its own prior.
    sim = T_VMAP.simulate(_rng(7), (_t(X), _t(w)), n=n).get_choices()["z"]
    assert np.all(np.abs(sim.mean(0).numpy() - X @ w) < 5.0 / np.sqrt(n))


def test_vmap_in_axes_other_than_zero_and_axis_checks():
    X, w, z, y = _vmap_inputs()
    moved = t_datum.vmap(in_axes=(1, None))
    s, _ = moved.assess(TC.kw(z=_t(z), y=_t(y)), (_t(X.T.copy()), _t(w)))
    ref, _ = T_VMAP.assess(TC.kw(z=_t(z), y=_t(y)), (_t(X), _t(w)))
    _close(s, ref)
    with pytest.raises(ValueError, match="no argument is mapped"):
        t_datum.vmap(in_axes=None).simulate(_rng(), (_t(X), _t(w)))
    with pytest.raises(ValueError, match="disagree"):
        t_datum.vmap(in_axes=(0, 0)).simulate(_rng(), (_t(X), _t(w)))


# -- Scan ----------------------------------------------------------------------


def test_scan_assess_score_and_retval():
    c0, xs, z, y = _scan_inputs()
    ref_s, (ref_c, ref_ys) = J_SCAN.assess(JC.kw(z=jnp.asarray(z), y=jnp.asarray(y)), (c0, jnp.asarray(xs)))
    s, (c, ys) = T_SCAN.assess(TC.kw(z=_t(z), y=_t(y)), (float(c0), _t(xs)))
    _close(s, ref_s)
    _close(c, ref_c)
    _close(ys, ref_ys)


def test_scan_assess_under_particle_axis():
    c0, xs, z, y = _scan_inputs(particles=K)
    one = lambda z, y: J_SCAN.assess(JC.kw(z=z, y=y), (c0, jnp.asarray(xs)))  # noqa: E731
    ref_s, (ref_c, ref_ys) = jax.vmap(one)(jnp.asarray(z), jnp.asarray(y))
    s, (c, ys) = T_SCAN.assess(convert.choice_map({"z": z, "y": y}, "cpu", n=K), (float(c0), _t(xs)), n=K)
    _close(s, ref_s)
    _close(c, ref_c)
    _close(ys, ref_ys)


def test_scan_per_step_scores_match_jax_step_by_step():
    c0, xs, z, y = _scan_inputs(particles=K)
    one = lambda z, y: _j_trace(J_SCAN, (c0, jnp.asarray(xs)), {"z": z, "y": y})  # noqa: E731
    j_tr = jax.vmap(one)(jnp.asarray(z), jnp.asarray(y))
    tr = convert.trace(T_SCAN, (float(c0), xs), {"z": z, "y": y}, n=K, device="cpu", kind=ScanTrace)
    assert isinstance(tr, ScanTrace)
    steps = tr.inner.get_score()
    assert steps.shape == (K, T)
    _close(steps, j_tr.inner.get_score())  # tolerance 1e-5 per step
    _close(tr.get_score(), j_tr.get_score())
    _close(tr.get_retval()[0], j_tr.get_retval()[0])
    _close(tr.get_retval()[1], j_tr.get_retval()[1])
    assert tr.get_choices()["z"].shape == (K, T) and tr.get_choices()[1, "z"].shape == (K,)


@pytest.mark.parametrize("where", ["one step", "every step", "absent"])
@pytest.mark.parametrize("particles", [None, K])
def test_scan_generate_weight(where, particles):
    c0, xs, _, y = _scan_inputs(particles=particles)
    step = 2
    y_t = _t(y) if particles is None else tgx.per_particle(_t(y))
    constraint = {
        "one step": TC.d({(step, "y"): y_t[..., step]}),
        "every step": TC.kw(y=y_t),
        "absent": TC.empty(),
    }[where]
    tr, weight = T_SCAN.generate(_rng(3), constraint, (float(c0), _t(xs)), n=particles)
    choices = {k: tr.get_choices()[k].numpy() for k in ("z", "y")}
    selection = {"one step": JS[step, "y"], "every step": JS[..., "y"], "absent": None}[where]

    def reference(z, y):
        j_tr = _j_trace(J_SCAN, (c0, jnp.asarray(xs)), {"z": z, "y": y})
        proj = jnp.zeros(()) if selection is None else j_tr.project(KEY, selection)
        return j_tr.get_score(), proj

    if particles is None:
        ref_score, ref_weight = reference(choices["z"], choices["y"])
    else:
        ref_score, ref_weight = jax.vmap(reference)(choices["z"], choices["y"])
    _close(tr.get_score(), ref_score)
    _close(weight, np.broadcast_to(ref_weight, tuple(weight.shape)))
    if where == "one step":
        np.testing.assert_array_equal(choices["y"][..., step], y[..., step])
    if where == "every step":
        np.testing.assert_array_equal(choices["y"], y)


@pytest.mark.parametrize("particles", [None, K])
def test_scan_project(particles):
    c0, xs, z, y = _scan_inputs(particles=particles)
    tr = convert.trace(T_SCAN, (float(c0), xs), {"z": z, "y": y}, n=particles, device="cpu")

    def reference(z, y):
        j_tr = _j_trace(J_SCAN, (c0, jnp.asarray(xs)), {"z": z, "y": y})
        return j_tr.project(KEY, JS[1, "z"]), j_tr.project(KEY, JS[..., "y"])

    args = (jnp.asarray(z), jnp.asarray(y))
    refs = reference(*args) if particles is None else jax.vmap(reference)(*args)
    _close(tr.project(_rng(), TS[1, "z"]), refs[0])
    _close(tr.project(_rng(), TS[..., "y"]), refs[1])
    with pytest.raises(ValueError, match="cannot match"):
        tr.project(_rng(), TS["z"])


@pytest.mark.parametrize("particles", [None, K])
def test_scan_update_weight_and_discard(particles):
    c0, xs, z, y = _scan_inputs(particles=particles)
    tr = convert.trace(T_SCAN, (float(c0), xs), {"z": z, "y": y}, n=particles, device="cpu")
    new_all = np.linspace(-1, 1, T).astype(np.float32)

    def reference(z, y):
        j_tr = _j_trace(J_SCAN, (c0, jnp.asarray(xs)), {"z": z, "y": y})
        one, w_one, _, _ = j_tr.update(KEY, JC.d({(1, "z"): np.float32(0.25)}))
        every, w_every, _, d_every = j_tr.update(KEY, JC.kw(z=jnp.asarray(new_all)))
        return w_one, one.get_score(), one.get_retval()[1], w_every, every.get_score(), d_every["z"]

    args = (jnp.asarray(z), jnp.asarray(y))
    ref = reference(*args) if particles is None else jax.vmap(reference)(*args)
    one, w_one, _, d_one = tr.update(_rng(), TC.d({(1, "z"): torch.tensor(0.25)}))
    _close(w_one, ref[0])
    _close(one.get_score(), ref[1])
    _close(one.get_retval()[1], ref[2])
    _close(d_one[1, "z"], z[..., 1])
    every, w_every, _, d_every = tr.update(_rng(), TC.kw(z=_t(new_all)))
    _close(w_every, ref[3])
    _close(every.get_score(), ref[4])
    _close(d_every["z"], ref[5])
    back, w_back, _, _ = one.update(_rng(), d_one)
    _close(w_back, -np.asarray(ref[0]))
    _close(back.get_choices()["z"], z)


@pytest.mark.parametrize("step", [0, 2, T - 1])
@pytest.mark.parametrize("particles", [None, K])
def test_scan_index_request(step, particles):
    """The single-step edit: its weight counts the edited step and the
    revisited next step (whose carry-in changed)."""
    c0, xs, z, y = _scan_inputs(particles=particles)
    tr = convert.trace(T_SCAN, (float(c0), xs), {"z": z, "y": y}, n=particles, device="cpu")
    value = np.float32(-0.5)

    def reference(z, y):
        j_tr = _j_trace(J_SCAN, (c0, jnp.asarray(xs)), {"z": z, "y": y})
        new, weight, _, bwd = j_tr.edit(KEY, jgx.IndexRequest(jnp.asarray(step), jgx.Update(JC.kw(z=value))))
        return weight, new.get_score(), new.get_choices()["z"], new.get_retval()[0], new.get_retval()[1], bwd.request.constraint["z"]

    args = (jnp.asarray(z), jnp.asarray(y))
    ref = reference(*args) if particles is None else jax.vmap(reference)(*args)
    for idx in (step, torch.tensor(step)):
        request = tgx.IndexRequest(idx, tgx.Update(TC.kw(z=torch.tensor(-0.5))))
        new, weight, _, bwd = tr.edit(_rng(), request)
        _close(weight, ref[0])
        _close(new.get_score(), ref[1])
        _close(new.get_choices()["z"], ref[2])
        _close(new.get_retval()[0], ref[3])
        _close(new.get_retval()[1], ref[4])
        assert isinstance(bwd, tgx.IndexRequest)
        _close(bwd.request.constraint["z"], ref[5])
    # The dense re-scan gives the same weight.
    _, w_dense, _, _ = tr.update(_rng(), TC.d({(step, "z"): torch.tensor(-0.5)}))
    _close(w_dense, ref[0])


def test_scan_index_request_carry_check_behind_its_flag():
    """A kernel whose carry-out depends on its carry-in is no case for the
    single-step edit: the check, run inside `do_checkify()` as JAX runs
    it, says so."""
    from genjax_tpu_torch.checkify import do_checkify

    @tgx.gen
    def drift(c, _):
        z = tgx.normal(c, 1.0) @ "z"
        return c + z, z

    rng = _rng()
    scan = tgx.Scan(drift, T)
    tr = scan.simulate(rng, (0.0, None), n=K)
    request = tgx.IndexRequest(1, tgx.Update(TC.kw(z=torch.tensor(3.0))))
    tr.edit(rng, request)  # unchecked by default, as JAX is outside checkify
    with do_checkify():
        with pytest.raises(ValueError, match="carry-out changed"):
            scan.edit(rng, tr, request, tgx.Diff.no_change(tr.get_args()))
    # A Markov kernel (the carry is the fresh draw) passes the check.
    ok = tgx.Scan(t_step, T)
    c0, xs, _, _ = _scan_inputs()
    tr = ok.simulate(rng, (float(c0), _t(xs)), n=K)
    with do_checkify():
        ok.edit(rng, tr, request, tgx.Diff.no_change(tr.get_args()))


def test_scan_regenerate_rescan_and_vector_request():
    c0, xs, z, y = _scan_inputs(particles=K)
    tr = convert.trace(T_SCAN, (float(c0), xs), {"z": z, "y": y}, n=K, device="cpu")
    new, weight, _, bwd = tr.edit(_rng(4), tgx.Regenerate(TS[1, "z"]))
    changed = (new.get_choices()["z"] != tr.get_choices()["z"]).float().mean(0)
    assert changed.tolist() == [0.0, 1.0, 0.0, 0.0]
    _close(weight, (new.get_score() - tr.get_score()).numpy(), tol=1e-4)
    assert isinstance(bwd, tgx.VectorRequest)
    back, w_back, _, _ = new.edit(_rng(), bwd)
    _close(w_back, -weight.numpy(), tol=1e-4)
    _close(back.get_choices()["z"], z)
    # The same draw through the single-step edit: same trace, same weight.
    one, w_one, _, _ = tr.edit(_rng(4), tgx.IndexRequest(1, tgx.Regenerate(TS["z"])))
    _close(w_one, weight.numpy())
    _close(one.get_choices()["z"], new.get_choices()["z"].numpy())


def test_scan_buffers_are_allocated_once_and_carry_settles():
    """A shared initial carry that becomes per particle: the stored step-0
    carry-in is broadcast, every leaf has its step axis behind the
    particle axis, and resampling acts on the particle axis only."""
    c0, xs, _, y = _scan_inputs()
    tr, w = T_SCAN.generate(_rng(), TC.kw(y=_t(y)), (float(c0), _t(xs)), n=K)
    carry_in = tr.inner.get_args()[0]
    assert carry_in.shape == (K, T) and bool((carry_in[:, 0] == float(c0)).all())
    _close(carry_in[:, 1:], tr.get_choices()["z"][:, :-1].numpy())
    col = tgx.ParticleCollection(tr, w).resample(_rng(1))
    picked = col.get_particles()
    assert picked.get_choices()["z"].shape == (K, T)
    assert picked.get_args()[1] is tr.get_args()[1]  # the shared xs pass through untouched
    s, _ = T_SCAN.assess(picked.get_choices(), picked.get_args(), n=K)
    _close(s, picked.get_score().numpy())


# -- Dimap, repeat, the derived scans ---------------------------------------------


def test_dimap_map_contramap():
    c0, xs, z, y = _scan_inputs()
    j = j_step.dimap(pre=lambda c, x: (c + 1.0, x), post=lambda args, xformed, ret: ret[0] + args[0] + xformed[0])
    t = t_step.dimap(pre=lambda c, x: (c + 1.0, x), post=lambda args, xformed, ret: ret[0] + args[0] + xformed[0])
    chm_j, chm_t = JC.kw(z=z[0], y=y[0]), TC.kw(z=_t(z[0]), y=_t(y[0]))
    ref_s, ref_r = j.assess(chm_j, (c0, xs[0]))
    s, r = t.assess(chm_t, (_t(c0), _t(xs[0])))
    _close(s, ref_s)
    _close(r, ref_r)
    tr, w = t.generate(_rng(), TC.kw(y=_t(y[0])), (_t(c0), _t(xs[0])), n=K)
    j_w = jax.vmap(lambda z: j.importance(KEY, JC.kw(z=z, y=y[0]), (c0, xs[0]))[0].project(KEY, JS["y"]))(
        jnp.asarray(tr.get_choices()["z"].numpy())
    )
    _close(w, j_w)
    assert tr.get_retval().shape == (K,) and tr.batched_leaves().count(1) >= 3
    new, w_up, _, discard = tr.update(_rng(), TC.kw(z=torch.tensor(0.1)))
    _close(w_up, (new.get_score() - tr.get_score()).numpy(), tol=1e-4)
    _close(discard["z"], tr.get_choices()["z"].numpy())
    _close(tr.project(_rng(), TS["y"]), j_w)
    doubled, halved = t_step.map(lambda ret: ret[1]), t_step.contramap(lambda c: (c, 0.0))
    _close(doubled.assess(chm_t, (_t(c0), _t(xs[0])))[1], 2.0 * z[0])
    _close(halved.assess(chm_t, (_t(c0),))[0], j_step.assess(chm_j, (c0, 0.0))[0])


@pytest.mark.parametrize("particles", [None, K])
def test_repeat(particles):
    rng = np.random.default_rng(5)
    lead = () if particles is None else (particles,)
    v = rng.standard_normal(lead + (N,)).astype(np.float32)
    j, t = jgx.normal.repeat(n=N), tgx.normal.repeat(n=N)
    one = lambda v: j.assess(jgx.ChoiceMap.choice(v), (0.5, 2.0))  # noqa: E731
    ref_s, ref_r = one(jnp.asarray(v)) if particles is None else jax.vmap(one)(jnp.asarray(v))
    value = _t(v) if particles is None else tgx.per_particle(_t(v))
    s, r = t.assess(tgx.ChoiceMap.choice(value), (0.5, 2.0), n=particles)
    _close(s, ref_s)
    _close(r, ref_r)
    tr = t.simulate(_rng(), (0.5, 2.0), n=512)
    draws = tr.get_retval()
    assert draws.shape == (512, N) and tr.get_score().shape == (512,)
    assert abs(float(draws.mean()) - 0.5) < 5 * 2.0 / np.sqrt(512 * N)  # 5 SE


def test_repeat_inside_gen():
    @jgx.gen
    def j_model():
        mu = jgx.normal(0.0, 1.0) @ "mu"
        return jgx.normal.repeat(n=N)(mu, 0.5) @ "xs"

    @tgx.gen
    def t_model():
        mu = tgx.normal(0.0, 1.0) @ "mu"
        return tgx.normal.repeat(n=N)(mu, 0.5) @ "xs"

    rng = np.random.default_rng(6)
    mu, xs = rng.standard_normal(K).astype(np.float32), rng.standard_normal((K, N)).astype(np.float32)
    ref = jax.vmap(lambda mu, xs: j_model.assess(JC.kw(mu=mu, xs=xs), ())[0])(jnp.asarray(mu), jnp.asarray(xs))
    s, r = t_model.assess(convert.choice_map({"mu": mu, "xs": xs}, "cpu", n=K), (), n=K)
    _close(s, ref)
    assert r.shape == (K, N)
    # Observed xs shared by every particle, mu per particle.
    tr, w = t_model.importance(_rng(), TC.kw(xs=_t(xs[0])), (), n=K)
    x0 = jnp.asarray(xs[0])
    ref_w = jax.vmap(lambda mu: j_model.importance(KEY, JC.kw(mu=mu, xs=x0), ())[0].project(KEY, JS[..., "xs"]))(
        jnp.asarray(tr.get_choices()["mu"].numpy())
    )
    _close(w, ref_w)
    assert tr.get_subtrace("xs").inner.get_score().shape == (K, N)


@pytest.mark.parametrize("name", ["accumulate", "reduce", "iterate", "iterate_final"])
@pytest.mark.parametrize("particles", [None, K])
def test_derived_scans(name, particles):
    @jgx.gen
    def j_add(c, x):
        return jgx.normal(c + x, 1.0) @ "v"

    @tgx.gen
    def t_add(c, x):
        return tgx.normal(c + x, 1.0) @ "v"

    @jgx.gen
    def j_next(c):
        return jgx.normal(0.5 * c, 1.0) @ "v"

    @tgx.gen
    def t_next(c):
        return tgx.normal(0.5 * c, 1.0) @ "v"

    rng = np.random.default_rng(7)
    lead = () if particles is None else (particles,)
    xs = rng.standard_normal(T).astype(np.float32)
    v = rng.standard_normal(lead + (T,)).astype(np.float32)
    if name in ("accumulate", "reduce"):
        j, t = getattr(j_add, name)(), getattr(t_add, name)()
        j_args, t_args = (np.float32(0.2), jnp.asarray(xs)), (0.2, _t(xs))
    else:
        j, t = getattr(j_next, name)(n=T), getattr(t_next, name)(n=T)
        j_args, t_args = (np.float32(0.2),), (0.2,)
    one = lambda v: j.assess(JC.kw(v=v), j_args)  # noqa: E731
    ref_s, ref_r = one(jnp.asarray(v)) if particles is None else jax.vmap(one)(jnp.asarray(v))
    s, r = t.assess(convert.choice_map({"v": v}, "cpu", n=particles), t_args, n=particles)
    _close(s, ref_s)
    _close(r, ref_r)
    tr, w = t.generate(_rng(), convert.choice_map({"v": v}, "cpu", n=particles), t_args, n=particles)
    _close(tr.get_score(), ref_s)
    _close(tr.get_retval(), ref_r)
    _close(w, ref_s)


# -- nesting -------------------------------------------------------------------


def test_vmap_of_vmap():
    @jgx.gen
    def j_cell(x, w):
        return jgx.normal(x * w, 1.0) @ "y"

    @tgx.gen
    def t_cell(x, w):
        return tgx.normal(x * w, 1.0) @ "y"

    j = j_cell.vmap(in_axes=(0, None)).vmap(in_axes=(0, None))
    t = t_cell.vmap(in_axes=(0, None)).vmap(in_axes=(0, None))
    rng = np.random.default_rng(8)
    X = rng.standard_normal((N, D)).astype(np.float32)
    w = rng.standard_normal(K).astype(np.float32)
    y = rng.standard_normal((K, N, D)).astype(np.float32)
    ref = jax.vmap(lambda w, y: j.assess(JC.kw(y=y), (jnp.asarray(X), w))[0])(jnp.asarray(w), jnp.asarray(y))
    s, r = t.assess(convert.choice_map({"y": y}, "cpu", n=K), (_t(X), tgx.per_particle(_t(w))), n=K)
    _close(s, ref)
    assert r.shape == (K, N, D)
    tr, weight = t.generate(_rng(), TC.d({(1, 2, "y"): torch.tensor(0.5)}), (_t(X), tgx.per_particle(_t(w))), n=K)
    assert tr.inner.inner.get_score().shape == (K, N, D)
    assert bool((tr.get_choices()[1, 2, "y"] == 0.5).all()) and not bool((tr.get_choices()[1, 1, "y"] == 0.5).any())
    cell = -0.5 * (0.5 - X[1, 2] * w) ** 2 - 0.5 * np.log(2 * np.pi)
    _close(weight, cell)
    _close(tr.project(_rng(), TS[1, 2, "y"]), cell)


def test_scan_of_a_vmap_kernel():
    @jgx.gen
    def j_inner(x, c):
        return jgx.normal(x + c, 1.0) @ "y"

    @tgx.gen
    def t_inner(x, c):
        return tgx.normal(x + c, 1.0) @ "y"

    @jgx.gen
    def j_row(c, xrow):
        ys = j_inner.vmap(in_axes=(0, None))(xrow, c) @ "row"
        return 0.1 * jnp.sum(ys), ys

    @tgx.gen
    def t_row(c, xrow):
        ys = t_inner.vmap(in_axes=(0, None))(xrow, c) @ "row"
        return 0.1 * ys.sum(-1), ys

    rng = np.random.default_rng(9)
    xs = rng.standard_normal((T, N)).astype(np.float32)
    y = rng.standard_normal((K, T, N)).astype(np.float32)
    j, t = j_row.scan(n=T), t_row.scan(n=T)
    one = lambda y: j.assess(JC.d({("row", "y"): y}), (np.float32(0.0), jnp.asarray(xs)))  # noqa: E731
    ref_s, (ref_c, ref_ys) = jax.vmap(one)(jnp.asarray(y))
    chm = convert.choice_map({("row", "y"): y}, "cpu", n=K)
    s, (c, ys) = t.assess(chm, (0.0, _t(xs)), n=K)
    _close(s, ref_s)
    _close(c, ref_c)
    _close(ys, ref_ys)
    tr, w = t.generate(_rng(), chm, (0.0, _t(xs)), n=K)
    _close(w, ref_s)
    assert tr.get_choices()["row", "y"].shape == (K, T, N)
    assert tr.inner.get_subtrace("row").inner.get_score().shape == (K, T, N)  # per step and lane
    _close(tr.get_choices()[2, "row", 1, "y"], y[:, 2, 1])
    _close(tr.project(_rng(), TS[2, "row", 1, "y"]), -0.5 * (y[:, 2, 1] - xs[2, 1] - np.asarray(tr.inner.get_args()[0][:, 2])) ** 2 - 0.5 * np.log(2 * np.pi))


def test_postfix_methods_and_decorators_agree():
    c0, xs, z, y = _scan_inputs()
    chm = TC.kw(z=_t(z), y=_t(y))
    a = tgx.scan(n=T)(t_step).assess(chm, (float(c0), _t(xs)))[0]
    b = t_step.scan(n=T).assess(chm, (float(c0), _t(xs)))[0]
    _close(a, b.numpy())
    X, w, zz, yy = _vmap_inputs()
    a = tgx.vmap(in_axes=(0, None))(t_datum).assess(TC.kw(z=_t(zz), y=_t(yy)), (_t(X), _t(w)))[0]
    b = T_VMAP.assess(TC.kw(z=_t(zz), y=_t(yy)), (_t(X), _t(w)))[0]
    _close(a, b.numpy())
    assert isinstance(tgx.repeat(n=3)(tgx.normal), tgx.Vmap)
    assert isinstance(tgx.dimap()(t_step), tgx.Dimap) and isinstance(tgx.map(lambda r: r)(t_step), tgx.Dimap)
    assert isinstance(tgx.contramap(lambda *a: a)(t_step), tgx.Dimap)
    for name in ("accumulate", "reduce"):
        assert isinstance(getattr(tgx, name)()(t_step), tgx.Dimap)
    for name in ("iterate", "iterate_final"):
        assert isinstance(getattr(tgx, name)(n=2)(t_step), tgx.Dimap)


def test_trace_without_sites_scores_zero_on_its_device_and_importance_passes_like():
    @tgx.gen
    def nothing(c, _):
        return c + 1.0, c

    tr = nothing.simulate(_rng(), (torch.zeros(3), None))
    assert tr.get_score().device == tr.get_retval()[0].device and float(tr.get_score()) == 0.0
    scanned = nothing.scan(n=3).simulate(_rng(), (torch.zeros(()), None), n=K)
    assert float(scanned.get_score().sum()) == 0.0 and scanned.get_retval()[1].shape == (3,)
    first, _ = t_step.importance(_rng(), TC.kw(y=torch.tensor(0.1)), (tgx.per_particle(torch.zeros(K)), 0.0), n=K)
    again, w = t_step.importance(_rng(), TC.kw(y=torch.tensor(0.1)), (torch.ones(K), 0.0), n=K, like=first)
    assert again.batched_leaves() == first.batched_leaves() and w.shape == (K,)


def test_shared_per_lane_argument_of_length_k_survives_resample():
    """K particles and K lanes: the mapped design matrix and the stacked
    observations have the particle count as their leading length, and are
    shared. Resampling and `get_particle` leave them alone (the record
    says so, not the size) while they gather the per-particle `w` and the
    `(K, K)` per-lane scores."""
    from genjax_tpu_torch.models.logreg import logistic_regression_vmap

    k = 8
    rng = _rng(2)
    X = torch.randn(k, 3, generator=rng)
    ys = (torch.rand(k, generator=rng) < 0.5).to(torch.int32)
    trs, lw = logistic_regression_vmap.importance(rng, TC.d({("data", "y"): ys}), (X,), n=k)
    picked = tgx.ParticleCollection(trs, lw).resample(rng).get_particles()
    data = picked.get_subtrace("data")
    assert picked.get_args()[0] is X and data.get_args()[0] is X
    assert data.inner.get_args()[0] is trs.get_subtrace("data").inner.get_args()[0]  # the lanes' x, shared
    assert torch.equal(picked.get_choices()["data", "y"], ys) and data.inner.get_score().shape == (k, k)
    score, _ = logistic_regression_vmap.assess(picked.get_choices(), (X,), n=k)
    _close(score, picked.get_score().numpy())
    one = tgx.ParticleCollection(trs, lw).get_particle(3)
    assert one.get_choices()["w"].shape == (3,) and one.get_subtrace("data").inner.get_score().shape == (k,)
    assert one.get_args()[0] is X and one.particle_count() is None
    _close(logistic_regression_vmap.assess(one.get_choices(), (X,))[0], one.get_score().numpy())


def test_hmc_and_mh_over_a_scan_model():
    """The MCMC requests see a scan model through its stacked choices:
    `S[..., "z"]` selects every step's `z`. HMC's accept ratio is the
    change of the score plus the change of the kinetic term along the
    leapfrog path, recomputed here from the model's gradient (1e-3: two
    float32 leapfrog paths)."""
    c0, xs, z, y = _scan_inputs(particles=K)
    tr = convert.trace(T_SCAN, (float(c0), xs), {"z": z}, n=K, device="cpu", observations={"y": y[0]})
    momenta = np.random.default_rng(11).standard_normal((K, T)).astype(np.float32)
    request = tgx.HMC(TS[..., "z"], 0.05, L=3)
    new, alpha, _, _ = request.edit_with(_rng(), tr, TC.kw(z=tgx.per_particle(_t(momenta))))
    assert alpha.shape == (K,) and new.inner.get_score().shape == (K, T)
    _close(alpha, (new.get_score() - tr.get_score()).numpy() + _kinetic_change(request, tr, new, momenta), tol=1e-3)
    final, accepted = tgx.run_chains(_rng(1), tr, request, 4)
    assert accepted.shape == (K, 4) and final.get_choices()["z"].shape == (K, T)
    assert torch.equal(final.get_choices()["y"], tr.get_choices()["y"])  # the shared observations stay
    final, accepted = tgx.run_chains(_rng(2), tr, tgx.Regenerate(TS[2, "z"]), 3)
    changed = (final.get_choices()["z"] != tr.get_choices()["z"]).any(0)
    assert changed.tolist() == [False, False, True, False]


def _kinetic_change(request, tr, new, momenta):
    """log N(p_final) - log N(p_0) of an HMC move, recomputed by running
    the leapfrog on the model's gradient."""
    from genjax_tpu_torch.inference.requests.hmc import make_selection_grad_fn

    grad_fn = make_selection_grad_fn(request.selection, tr, tgx.Diff.no_change(tr.get_args()))
    values = tr.get_choices().filter(request.selection)
    v, p = values["z"], torch.from_numpy(momenta)
    _, g = grad_fn(values)
    for _ in range(request.L):
        p = p + 0.5 * request.eps * g["z"]
        v = v + request.eps * p
        _, g = grad_fn(TC.kw(z=tgx.per_particle(v)))
        p = p + 0.5 * request.eps * g["z"]
    return (-0.5 * (p * p).sum(-1) + 0.5 * torch.from_numpy(momenta).pow(2).sum(-1)).numpy()


def test_edits_reach_through_nested_combinators():
    """An `IndexRequest` inside an `IndexRequest` edits one cell of a
    `vmap` of a `vmap`; a scan step's `Regenerate` reaches one lane of the
    `vmap` its kernel traces; the weight is the change of the score, only
    the addressed cell moves, and one particle's row of a nested trace
    assesses to its own score."""

    @tgx.gen
    def cell(x, w):
        return tgx.normal(x * w, 1.0) @ "y"

    grid = cell.vmap(in_axes=(0, None)).vmap(in_axes=(0, None))
    rng = _rng(3)
    X, w = torch.randn(N, D, generator=rng), tgx.per_particle(torch.randn(K, generator=rng))
    tr = grid.simulate(rng, (X, w), n=K)
    request = tgx.IndexRequest(2, tgx.IndexRequest(1, tgx.Update(TC.kw(y=torch.tensor(0.3)))))
    for new, weight in (tr.edit(rng, request)[:2], tr.edit(rng, tgx.Regenerate(TS[2, 1, "y"]))[:2]):
        moved = (new.get_choices()["y"] != tr.get_choices()["y"]).nonzero()[:, 1:].unique(dim=0)
        assert moved.tolist() == [[2, 1]]
        _close(weight, (new.get_score() - tr.get_score()).numpy(), tol=1e-4)
    one = tgx.ParticleCollection(tr, torch.zeros(K)).get_particle(3)
    assert one.get_choices()["y"].shape == (N, D) and not any(one.batched_leaves())
    _close(grid.assess(one.get_choices(), (X, tr.get_args()[1][3]))[0], one.get_score().numpy())

    @tgx.gen
    def lane(x, c):
        return tgx.normal(x + c, 1.0) @ "y"

    @tgx.gen
    def row(c, xrow):
        ys = lane.vmap(in_axes=(0, None))(xrow, c) @ "row"
        return 0.1 * ys.sum(-1), ys

    rows = row.scan(n=T)
    xs = torch.randn(T, N, generator=rng)
    tr = rows.simulate(rng, (0.0, xs), n=K)
    new, weight, _, _ = tr.edit(rng, tgx.Update(TC.d({(1, "row", 2, "y"): torch.tensor(0.5)})))
    _close(weight, (new.get_score() - tr.get_score()).numpy(), tol=1e-4)
    assert bool((new.get_choices()[1, "row", 2, "y"] == 0.5).all())
    new, weight, _, _ = tr.edit(rng, tgx.IndexRequest(T - 1, tgx.Regenerate(TS["row", 1, "y"])))
    moved = (new.get_choices()["row", "y"] != tr.get_choices()["row", "y"]).nonzero()[:, 1:].unique(dim=0)
    assert moved.tolist() == [[T - 1, 1]]
    _close(weight, (new.get_score() - tr.get_score()).numpy(), tol=1e-4)
    one = tgx.ParticleCollection(tr, torch.zeros(K)).get_particle(1)
    _close(rows.assess(one.get_choices(), (0.0, xs))[0], one.get_score().numpy())


@pytest.mark.parametrize("particles", [None, K])
def test_scan_over_zero_steps_like_jax(particles):
    """`n=0` is a valid length (`tests/combinators/test_combinator_parity.py`):
    no steps, the carry passed through, score and weights 0, for simulate,
    generate, assess and update, with or without scanned arguments."""

    @jgx.gen
    def j_walk(state, sigma):
        x = jgx.normal(state, sigma) @ "x"
        return x, x + 1

    @tgx.gen
    def t_walk(state, sigma):
        x = tgx.normal(state, sigma) @ "x"
        return x, x + 1

    j_args, t_args = (2.0, jnp.arange(0, dtype=float)), (2.0, torch.arange(0, dtype=torch.float32))
    j_tr = j_walk.scan(n=0).simulate(KEY, j_args)
    tr = t_walk.scan(n=0).simulate(_rng(), t_args, n=particles)
    lead = () if particles is None else (particles,)
    _close(tr.get_score(), np.broadcast_to(np.asarray(j_tr.get_score()), lead))
    assert tr.get_retval()[0] == j_tr.get_retval()[0] == 2.0
    assert tuple(tr.get_retval()[1].shape) == lead + (0,) and j_tr.get_retval()[1].shape == (0,)
    _, j_w = j_walk.scan().importance(jax.random.key(1), j_tr.get_choices(), j_args)
    gen_tr, w = t_walk.scan().importance(_rng(1), tr.get_choices(), t_args, n=particles)
    _close(w, np.broadcast_to(np.asarray(j_w), lead))
    assert gen_tr.get_retval()[0] == 2.0
    # JAX's assess traces the kernel even for no steps, so the empty sample
    # raises there (a zero-length array makes no choice in either package);
    # the port answers with what the other methods give: score 0, the
    # carry passed through.
    with pytest.raises(jgx.MissingAddress):
        j_walk.scan(n=0).assess(j_tr.get_choices(), j_args)
    s, (c, ys) = t_walk.scan(n=0).assess(tr.get_choices(), t_args, n=particles)
    _close(s, np.zeros(lead))
    assert c == 2.0 and tuple(ys.shape) == lead + (0,)
    new_j = (5.0, j_args[1])
    j_new, j_uw, _, _ = j_tr.update(KEY, JC.empty(), jgx.Diff.unknown_change(new_j))
    new, uw, _, discard = tr.update(_rng(), TC.empty(), tgx.Diff.unknown_change((5.0, t_args[1])))
    _close(uw, j_uw)
    assert new.get_retval()[0] == j_new.get_retval()[0] == 5.0 and discard.static_is_empty()
    # Nothing scanned over: the explicit length alone.
    @jgx.gen
    def j_add(c, _x):
        return c + (jgx.normal(0.0, 1.0) @ "z"), None

    @tgx.gen
    def t_add(c, _x):
        return c + (tgx.normal(0.0, 1.0) @ "z"), None

    j_none = j_add.scan(n=0).simulate(KEY, (1.0, None))
    t_none = t_add.scan(n=0).simulate(_rng(), (1.0, None), n=particles)
    _close(t_none.get_score(), np.broadcast_to(np.asarray(j_none.get_score()), lead))
    assert t_none.get_retval()[0] == j_none.get_retval()[0] == 1.0


@pytest.mark.parametrize("particles", [None, K])
def test_scan_update_through_a_stacked_vector_request_like_jax(particles):
    """JAX's `VectorRequest` holds one stacked request and gives step `t`
    slice `t` of every leaf; the port takes that form beside its tuple of
    per-step requests. Weight, retdiff and new choices against JAX."""
    from genjax_tpu.combinators.scan import VectorRequest as JVectorRequest

    c0, xs, z, y = _scan_inputs(particles=particles)
    new_z = np.random.default_rng(9).standard_normal((() if particles is None else (particles,)) + (T,)).astype(np.float32)
    tr = convert.trace(T_SCAN, (float(c0), xs), {"z": z, "y": y}, n=particles, device="cpu")

    def reference(z, y, new_z):
        j_tr = _j_trace(J_SCAN, (c0, jnp.asarray(xs)), {"z": z, "y": y})
        new, w, retdiff, _ = j_tr.edit(KEY, JVectorRequest(jgx.Update(JC.kw(z=new_z))))
        return w, new.get_choices()["z"], new.get_score(), retdiff[0].primal, retdiff[1].primal

    args = (jnp.asarray(z), jnp.asarray(y), jnp.asarray(new_z))
    ref = reference(*args) if particles is None else jax.vmap(reference)(*args)
    stacked = _t(new_z) if particles is None else tgx.per_particle(_t(new_z))
    new, w, retdiff, bwd = tr.edit(_rng(), tgx.VectorRequest(tgx.Update(TC.kw(z=stacked))))
    _close(w, ref[0])
    _close(new.get_choices()["z"], ref[1])
    _close(new.get_score(), ref[2])
    _close(retdiff[0].primal, ref[3])
    _close(retdiff[1].primal, ref[4])
    back, w_back, _, _ = new.edit(_rng(), bwd)  # the backward request: a tuple, one per step
    _close(w_back, -np.asarray(ref[0]))
    _close(back.get_choices()["z"], z)


def test_vmap_in_axes_reach_into_a_pytree_dataclass_like_jax():
    """`in_axes` is any pytree prefix of the arguments, as for `jax.vmap`:
    a `Pytree` dataclass maps some fields and shares others."""
    from genjax_tpu.core.pytree import Pytree as JPytree
    from genjax_tpu_torch.core.pytree import Pytree as TPytree

    @JPytree.dataclass
    class JParams(JPytree):
        loc: jax.Array
        scale: jax.Array

    @TPytree.dataclass
    class TParams(TPytree):
        loc: torch.Tensor
        scale: torch.Tensor

    @jgx.gen
    def j_lane(p, shift):
        return jgx.normal(p.loc + shift, p.scale) @ "x"

    @tgx.gen
    def t_lane(p, shift):
        return tgx.normal(p.loc + shift, p.scale) @ "x"

    rng = np.random.default_rng(4)
    loc, scale = rng.standard_normal(N).astype(np.float32), np.float32(0.7)
    x = rng.standard_normal(N).astype(np.float32)
    for j_axes, t_axes, j_p, t_p in (
        ((JParams(0, None), None), (TParams(0, None), None), JParams(jnp.asarray(loc), jnp.asarray(scale)),
         TParams(_t(loc), _t(scale))),
        ((JParams(0, 0), None), (TParams(0, 0), None), JParams(jnp.asarray(loc), jnp.full(N, scale)),
         TParams(_t(loc), torch.full((N,), float(scale)))),
    ):
        ref, ref_x = j_lane.vmap(in_axes=j_axes).assess(JC.kw(x=jnp.asarray(x)), (j_p, jnp.asarray(0.2)))
        got, got_x = t_lane.vmap(in_axes=t_axes).assess(TC.kw(x=_t(x)), (t_p, torch.tensor(0.2)))
        _close(got, ref)
        _close(got_x, ref_x)
    with pytest.raises(ValueError, match="does not match"):
        t_lane.vmap(in_axes=(TParams(0, None), None)).assess(TC.kw(x=_t(x)), ((_t(loc), _t(scale)), torch.tensor(0.2)))
