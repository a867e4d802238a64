"""The port's auxiliary layer against `genjax_tpu`'s, on the CPU: time
travel, the checkify gate (with `Scan.edit_index`'s carry check and
`Mask.unmask`) and the facade modules, after `tests/core/test_aux.py`;
checkpoint and resume, profiling and the operation counters, after
`tests/utils/test_checkpoint_profiling.py`.

Deterministic quantities get the same numpy-made inputs in both packages
and are held at float32 tolerance, 1e-5 per unit of magnitude; a resumed
run is held bit for bit against the live one.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.checkify import do_checkify as j_do_checkify
from genjax_tpu_torch import convert
from genjax_tpu_torch.checkify import do_checkify, optional_check, should_check
from genjax_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from genjax_tpu_torch.utils.profiling import annotate, cost_summary, device_memory_stats, profile_trace

torch.set_num_threads(1)


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), (got, ref)


# -- time travel -----------------------------------------------------------------------------


def _program(rec, tag):
    def program(x):
        a = rec(x + 1.0, "a")
        b = rec(a * 2.0, "b")
        return tag(b - 0.5, "c")

    return program


def test_record_and_navigate_like_jax():
    from genjax_tpu.time_travel import rec as jrec, tag as jtag, time_machine as jtm
    from genjax_tpu_torch.time_travel import rec, tag, time_machine

    for dbg in (time_machine(_program(rec, tag))(torch.tensor(1.0)), jtm(_program(jrec, jtag))(jnp.array(1.0))):
        assert dbg.n_frames == 3
        assert float(dbg.retval) == 3.5
        assert float(dbg.current()) == 2.0
        assert float(dbg.fwd().current()) == 4.0
        assert float(dbg.bwd().current()) == 2.0
        assert float(dbg.jump("c").current()) == 3.5 and dbg.current_label() == "c"
        with pytest.raises(KeyError):
            dbg.jump("nowhere")


def test_remix():
    from genjax_tpu_torch.time_travel import rec, time_machine

    def program(x):
        a = rec(x + 1.0, "a")
        return rec(a * 2.0, "b")

    dbg = time_machine(program)(torch.tensor(1.0))
    assert float(dbg.jump("a").remix(torch.tensor(10.0)).retval) == 20.0
    # By position too, for a frame without a label.
    dbg = time_machine(lambda x: rec(x * 3.0) + 1.0)(torch.tensor(2.0))
    assert float(dbg.remix(torch.tensor(5.0)).retval) == 6.0


def test_rec_outside_is_identity():
    from genjax_tpu_torch.time_travel import rec

    x = torch.tensor(5.0)
    assert rec(x, "x") is x


def test_works_under_torch_func():
    """JAX's runs under `jit`; the port's records inside `torch.func.vmap`
    and `grad` (the frames hold functorch's tensors)."""
    from genjax_tpu_torch.time_travel import rec, time_machine

    def run(x):
        return time_machine(lambda v: rec(v * 2, "a") + 1)(x).retval

    assert torch.equal(torch.func.vmap(run)(torch.tensor([1.0, 2.0])), torch.tensor([3.0, 5.0]))
    assert float(torch.func.grad(run)(torch.tensor(2.0))) == 2.0


# -- the checkify gate -------------------------------------------------------------------------


def test_gate_off_by_default():
    assert not should_check()
    with do_checkify():
        assert should_check()
    assert not should_check()


def test_optional_check_runs_only_inside():
    ran = []
    optional_check(lambda: ran.append(1))
    assert not ran
    with do_checkify():
        optional_check(lambda: ran.append(1))
    assert ran == [1]


def test_unmask_without_default_is_checked_only_under_checkify():
    from genjax_tpu_torch.core.mask import Mask

    m = Mask(torch.tensor([1.0, 2.0]), torch.tensor([True, False]), (1,), 1)
    assert torch.equal(m.unmask(), torch.tensor([1.0, 2.0]))  # unchecked, as JAX is
    with do_checkify(), pytest.raises(ValueError, match="unmask"):
        m.unmask()
    with do_checkify():
        assert torch.equal(Mask(torch.tensor(1.0), torch.tensor(True), (0,), 0).unmask(), torch.tensor(1.0))


@jgx.gen
def j_resampled(carry, _x):
    z = jgx.normal(carry, 1.0) @ "z"
    return z, 2.0 * z


@tgx.gen
def t_resampled(carry, _x):
    z = tgx.normal(carry, 1.0) @ "z"
    return z, 2.0 * z


@jgx.gen
def j_accumulating(carry, _x):
    z = jgx.normal(0.0, 1.0) @ "z"
    return carry + z, z


@tgx.gen
def t_accumulating(carry, _x):
    z = tgx.normal(0.0, 1.0) @ "z"
    return carry + z, z


def _scan_traces(j_kernel, t_kernel, c0):
    """Both packages' traces of the kernel scanned over 6 steps, holding
    the same numpy-made z."""
    z = np.random.default_rng(3).normal(size=6).astype(np.float32)
    j_tr, _ = j_kernel.scan(n=6).generate(jax.random.key(0), jgx.ChoiceMap.kw(z=jnp.asarray(z)), (c0, None))
    t_tr = convert.trace(t_kernel.scan(n=6), (c0, None), {"z": z}, device="cpu")
    return j_tr, t_tr


def _edit_both(j_tr, t_tr, idx, z_new, c0):
    jreq = jgx.IndexRequest(jnp.array(idx), jgx.Update(jgx.ChoiceMap.kw(z=z_new)))
    treq = tgx.IndexRequest(torch.tensor(idx), tgx.Update(tgx.ChoiceMap.kw(z=z_new)))
    return (jreq.edit(jax.random.key(1), j_tr, jgx.Diff.no_change((c0, None))),
            treq.edit(_rng(1), t_tr, tgx.Diff.no_change((c0, None))))


def test_unstable_kernel_caught_under_checkify_like_jax():
    j_tr, t_tr = _scan_traces(j_accumulating, t_accumulating, 0.0)
    with j_do_checkify(), pytest.raises(Exception, match="carry"):
        _edit_both(j_tr, t_tr, 2, 5.0, 0.0)
    with do_checkify(), pytest.raises(ValueError, match="carry-out changed"):
        tgx.IndexRequest(torch.tensor(2), tgx.Update(tgx.ChoiceMap.kw(z=5.0))).edit(
            _rng(1), t_tr, tgx.Diff.no_change((0.0, None)))
    # Outside the gate the edit runs unchecked in both.
    (j_new, j_w, _, _), (t_new, t_w, _, _) = _edit_both(j_tr, t_tr, 2, 5.0, 0.0)
    _close(t_w, j_w)


def test_stable_kernel_passes_checkify_like_jax():
    j_tr, t_tr = _scan_traces(j_resampled, t_resampled, 0.5)
    with j_do_checkify(), do_checkify():
        (j_new, j_w, _, _), (t_new, t_w, _, _) = _edit_both(j_tr, t_tr, 2, 5.0, 0.5)
    assert float(t_new.get_choices()["z"][2]) == 5.0
    _close(t_new.get_choices()["z"], j_new.get_choices()["z"])
    _close(t_w, j_w)
    _close(t_new.get_score(), j_new.get_score())


def test_edit_at_final_step_always_sound_like_jax():
    j_tr, t_tr = _scan_traces(j_accumulating, t_accumulating, 0.0)
    with j_do_checkify(), do_checkify():
        (j_new, j_w, _, _), (t_new, t_w, _, _) = _edit_both(j_tr, t_tr, 5, 5.0, 0.0)
    assert float(t_new.get_choices()["z"][5]) == 5.0
    _close(t_w, j_w)
    _close(t_new.get_retval()[0], j_new.get_retval()[0])


# -- checkpoint and resume ---------------------------------------------------------------------


@tgx.gen
def _conjugate():
    x = tgx.normal(0.0, 1.0) @ "x"
    _ = tgx.normal(x, 1.0) @ "y"
    return x


def _target():
    return tgx.Target(_conjugate, (), tgx.ChoiceMap.kw(y=1.0))


def test_roundtrip_particle_collection(tmp_path):
    col = tgx.ImportanceK(_target(), k_particles=64).run_smc(_rng(0))
    state = {"log_weights": col.get_log_weights(), "choices_x": col.get_particles().get_choices()["x"]}
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    restored = restore_checkpoint(path, pytree.tree_map(torch.zeros_like, state))
    assert torch.equal(restored["log_weights"], state["log_weights"])
    assert torch.equal(restored["choices_x"], state["choices_x"])


def test_collection_roundtrip_and_resume_bit_identical(tmp_path):
    """A restored collection and generator, resumed with a rejuvenation
    and a resample, give the live state's every leaf and LML bit for bit
    (JAX's test on its particle mesh, here one device)."""
    driver = tgx.smc.SMCDriver(n_particles=256, ess_threshold=1.0)
    coll = driver.init(_rng(0), _target())
    state = {"collection": coll, "rng": _rng(7)}
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, state)
    fresh = {"collection": driver.init(_rng(123), _target()), "rng": torch.Generator()}
    restored = restore_checkpoint(path, fresh)
    for a, b in zip(pytree.tree_leaves(state), pytree.tree_leaves(restored)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert type(restored["collection"]) is type(coll)

    def resume(s):
        c = driver.rejuvenate(s["rng"], s["collection"], tgx.Regenerate(tgx.Selection.at["x"]))
        return driver.maybe_resample(s["rng"], c)

    live, back = resume(state), resume(restored)
    for a, b in zip(pytree.tree_leaves(live), pytree.tree_leaves(back)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert torch.equal(live.get_log_marginal_likelihood_estimate(), back.get_log_marginal_likelihood_estimate())
    # The resumed generator was restored, not shared: the live one moved on.
    assert fresh["rng"] is not restored["rng"]


def test_plain_trace_roundtrip(tmp_path):
    tr = _conjugate.simulate(_rng(3), ())
    path = os.path.join(tmp_path, "trace_ckpt")
    save_checkpoint(path, tr)
    restored = restore_checkpoint(path, tr)
    assert torch.equal(tr.get_score(), restored.get_score())
    assert torch.equal(tr.get_choices()["x"], restored.get_choices()["x"])


def test_restore_refuses_a_target_of_another_shape(tmp_path):
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, {"w": torch.zeros(4), "n": 3})
    with pytest.raises(ValueError, match="leaf 0"):
        restore_checkpoint(path, {"w": torch.zeros(5), "n": 3})
    with pytest.raises(ValueError, match="leaf 0"):
        restore_checkpoint(path, {"w": torch.zeros(4, dtype=torch.float64), "n": 3})
    with pytest.raises(ValueError, match="leaves saved"):
        restore_checkpoint(path, {"w": torch.zeros(4)})
    assert restore_checkpoint(path, {"w": torch.ones(4), "n": 0})["n"] == 3
    # The file holds no pickled object: `torch.load` reads it with weights only.
    assert torch.load(path, weights_only=True)["format"].startswith("genjax_tpu_torch.checkpoint")


# -- profiling -----------------------------------------------------------------------------------


def test_annotate_preserves_semantics_and_names_the_span(tmp_path):
    @annotate("density-pass")
    def f(x):
        return torch.sum(torch.square(x))

    x = torch.arange(8.0)
    assert torch.equal(f(x), torch.sum(torch.square(x)))
    with profile_trace(str(tmp_path / "prof")) as d:
        f(x)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert d == str(tmp_path / "prof")
    assert any(e.get("name") == "density-pass" for e in events)


def test_profile_trace_writes_capture(tmp_path):
    log_dir = os.path.join(tmp_path, "prof")
    with profile_trace(log_dir) as d:
        _ = torch.ones(16) * 2.0
    produced = [f for _root, _dirs, files in os.walk(d) for f in files]
    assert produced, "profiler trace produced no files"


def test_cost_counters_present_and_at_least_jax():
    from genjax_tpu.utils.profiling import cost_summary as j_cost_summary

    s = cost_summary(lambda x: (x @ x.T).sum(), torch.ones(64, 64))
    assert s["flops"] >= 2 * 64 * 64 * 64
    assert s.get("bytes accessed", 0) > 0 and s["memory_bytes"] == 0.0
    ref = j_cost_summary(lambda x: (x @ x.T).sum(), jnp.ones((64, 64)))
    assert s["flops"] >= ref["flops"]
    _close(s["bytes accessed"], ref["bytes accessed"], tol=1e-2)  # the same two operations, unfused in both
    # XLA counts after fusion: an elementwise chain reads and writes its
    # intermediates in the port, not in JAX.
    x = np.ones(4096, dtype=np.float32)
    chain = cost_summary(lambda v: torch.exp(v) * 2.0 + 1.0, torch.from_numpy(x))
    j_chain = j_cost_summary(lambda v: jnp.exp(v) * 2.0 + 1.0, jnp.asarray(x))
    assert chain["bytes accessed"] > j_chain["bytes accessed"] and chain["flops"] >= j_chain["flops"]


def test_transcendentals_equal_jax():
    from genjax_tpu.utils.profiling import cost_summary as j_cost_summary

    x = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    s = cost_summary(lambda v: torch.exp(v).sum(), torch.from_numpy(x))
    ref = j_cost_summary(lambda v: jnp.exp(v).sum(), jnp.asarray(x))
    assert s["transcendentals"] == ref["transcendentals"] == 4096


def test_cost_summary_on_gfi_method():
    @tgx.gen
    def model(X):
        w = tgx.mv_normal_diag(torch.zeros(4), torch.ones(4)) @ "w"
        _ = tgx.normal(X @ w, 1.0) @ "ys"

    X = torch.ones(16, 4)
    s = cost_summary(lambda rng: model.simulate(rng, (X,)).get_score(), _rng(0))
    assert s["flops"] > 0 and s["transcendentals"] > 0


def test_device_memory_stats_shape():
    stats = device_memory_stats()
    assert isinstance(stats, dict)  # empty on the CPU, as JAX's
    assert device_memory_stats("cpu") == {}


# -- the facades -----------------------------------------------------------------------------


def test_incremental_module():
    from genjax_tpu_torch.incremental import Diff, NoChange, UnknownChange

    d = Diff(1.0, NoChange)
    assert d.get_primal() == 1.0 and d.get_tangent() is NoChange and UnknownChange is not NoChange


def test_typing_module():
    from genjax_tpu_torch.typing import Array, FloatArray, PRNGKey, ScalarShaped, static_check_is_concrete

    assert PRNGKey is torch.Generator and Array is torch.Tensor
    assert FloatArray == (float | torch.Tensor)
    assert ScalarShaped(torch.tensor(1.0)) and not ScalarShaped(torch.zeros(2))
    assert static_check_is_concrete(torch.ones(2))
    assert torch.func.vmap(lambda t: torch.tensor(static_check_is_concrete(t)))(torch.ones(2, 1)).tolist() == [0, 0]


def test_experimental_module():
    from genjax_tpu_torch.experimental import fused_logsumexp

    x = np.random.default_rng(1).normal(size=1000).astype(np.float32)
    from genjax_tpu.experimental import fused_logsumexp as j_fused_logsumexp

    _close(fused_logsumexp(torch.from_numpy(x)), j_fused_logsumexp(jnp.asarray(x), interpret=True))


def test_pretty_warns_where_treescope_is_absent(monkeypatch):
    import builtins

    from genjax_tpu_torch.pretty import pretty

    real_import = builtins.__import__

    def no_treescope(name, *args, **kwargs):
        if name == "treescope":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_treescope)
    with pytest.warns(UserWarning, match="treescope is not installed"):
        pretty()


def test_top_level_surface():
    for name in [
        "gen", "beta", "flip", "normal", "Target", "ChoiceMap",
        "ChoiceMapBuilder", "SelectionBuilder", "Selection", "Mask",
        "Diff", "Update", "Regenerate", "EmptyRequest",
        "vmap", "scan", "switch", "mask", "mix", "or_else", "repeat",
        "dimap", "map", "contramap", "accumulate", "reduce", "iterate",
        "iterate_final", "masked_iterate", "masked_iterate_final",
        "IndexRequest", "StaticGenerativeFunction", "Trace",
        "GenerativeFunction", "DiscreteHMM", "marginal", "pretty",
        "Pytree", "Const", "Closure", "rec", "tag", "time_machine",
        "checked_mode", "do_typecheck", "do_checkify", "empty_trace",
    ]:
        assert hasattr(tgx, name), name
    from genjax_tpu_torch.inference import requests, smc, vi  # noqa: F401
    from genjax_tpu_torch.inference.smc import ChangeTarget, Importance, ImportanceK, SMCAlgorithm  # noqa: F401
    from genjax_tpu_torch.inference.requests import HMC, Rejuvenate  # noqa: F401
    from genjax_tpu_torch.inference.vi import ELBO, IWELBO, PWake, QWake, adev_distribution  # noqa: F401
    from genjax_tpu_torch.adev import expectation, Dual, ADEVPrimitive, sample_primitive  # noqa: F401


def test_empty_trace_is_the_zero_trace():
    zt = tgx.empty_trace(_conjugate, ())
    assert float(zt.get_score()) == 0.0 and "x" in zt.get_choices()
