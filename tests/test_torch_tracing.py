"""The program's spans and counters (`utils/profiling.py`,
`inference/particle_filter.py::filter_stats`), on the CPU.

A span records only while a `torch.profiler` runs: then it is a
`record_function` in the trace and a record in `spans()`, with its parent
and its root; otherwise it is one shared no-op object. The particle path's
spans nest as the benchmark's readers expect, the filter's counters agree
with a count of its row copies, and nothing the spans do moves an output.

This file imports neither JAX nor the test suite's conftest, so it also
runs on the card's machine (`python -m pytest --noconftest
tests/test_torch_tracing.py`), whose torch is another version.
"""

import collections

import pytest
import torch

import genjax_tpu_torch as gx
from genjax_tpu_torch.inference import particle_filter
from genjax_tpu_torch.models.beta_bernoulli import beta_bernoulli
from genjax_tpu_torch.models.ssm import make_ssm_models, simulate_ssm_data
from genjax_tpu_torch.utils import profiling
from genjax_tpu_torch.utils.profiling import annotate, reset_spans, span, spans

CPU = [torch.profiler.ProfilerActivity.CPU]
K, T = 4096, 20


def profiled(fn):
    """`fn()` under a CPU profiler, with the span buffer emptied first:
    (its result, the records, the profiler's event names)."""
    reset_spans()
    with torch.profiler.profile(activities=CPU) as prof:
        out = fn()
    return out, spans(), {e.name for e in prof.events()}


def by_seq(records):
    return {r.seq: r for r in records}


def ancestors(rec, index):
    names = []
    while rec.parent is not None:
        rec = index[rec.parent]
        names.append(rec.name)
    return names


def make_filter(n=K):
    init_model, step_model = make_ssm_models()
    return particle_filter.BootstrapFilter(step_model, init_model, n, obs_addr="y")


def observations():
    return simulate_ssm_data(torch.Generator().manual_seed(1), T)[1]


def sir_trial(seed):
    rng = torch.Generator().manual_seed(seed)
    alg = gx.ImportanceK(gx.Target(beta_bernoulli, (2.0, 2.0), gx.ChoiceMap.d({"v": True})), k_particles=K)
    col = alg.run_smc(rng)
    lml = col.get_log_marginal_likelihood_estimate()
    drawn = col.sample_particle(rng)
    return col.get_particles().get_choices()["p"], col.get_log_weights(), lml, drawn.get_choices()["p"]


def test_the_profilers_flag_flips_with_the_profiler():
    """`span` reads `torch.autograd.profiler._is_profiler_enabled`, which torch
    sets when a profiler starts and clears when it stops."""
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False
    with torch.profiler.profile(activities=CPU):
        assert flag() is True
    assert flag() is False


def test_outside_a_profiler_a_span_is_the_shared_no_op(monkeypatch):
    def refused(name):
        raise AssertionError(f"a trace event {name!r} outside a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(profiling, "_TraceEvent", refused)
    reset_spans()
    first, second = span("a"), span("b")
    assert first is second
    with first:
        with second:
            pass
    assert annotate("c")(lambda x: x + 1)(1) == 2
    assert spans() == []


def test_nested_spans_record_parents_and_a_shared_root():
    @annotate("outer")
    def outer():
        with span("middle"):
            with span("inner"):
                torch.ones(4).sum()
        with span("sibling"):
            pass
        return 7

    (out, second), records, names = profiled(lambda: (outer(), outer()))
    assert out == 7 and second == 7
    assert [r.name for r in records] == ["outer", "middle", "inner", "sibling"] * 2
    assert {"outer", "middle", "inner", "sibling"} <= names
    for first in (0, 4):
        o, m, i, s = records[first:first + 4]
        assert o.parent is None and o.root == o.seq
        assert m.parent == o.seq and i.parent == m.seq and s.parent == o.seq
        assert {m.root, i.root, s.root} == {o.seq}
        assert o.start_ns <= m.start_ns <= i.start_ns <= i.end_ns <= m.end_ns <= s.start_ns <= s.end_ns <= o.end_ns
    assert records[0].root != records[4].root


def test_a_spans_trace_event_has_an_operations_scope():
    """A span's event is of the scope of an aten operation's, not of
    `record_function`'s user scope, which on a CUDA trace would also put
    an interval on the device's timeline."""

    def both():
        with span("program.span"):
            torch.ones(2).sum()
        with torch.profiler.record_function("user.annotation"):
            pass

    with torch.profiler.profile(activities=CPU) as prof:
        both()
    scope = {e.name: e.scope for e in prof.events()}
    assert scope["program.span"] == scope["aten::sum"] != scope["user.annotation"]


def test_a_span_closes_when_its_block_raises():
    def broken():
        with span("outer"):
            with span("raises"):
                raise ValueError("inside")

    with pytest.raises(ValueError):
        profiled(broken)
    _, records, _ = profiled(lambda: span("after").__enter__().__exit__(None, None, None))
    assert [(r.name, r.parent) for r in records] == [("after", None)]
    assert records[0].end_ns is not None


def test_the_buffer_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=3))

    def five():
        for i in range(5):
            with span(f"s{i}"):
                pass

    _, records, _ = profiled(five)
    assert [r.name for r in records] == ["s2", "s3", "s4"]
    reset_spans()
    assert spans() == []


def test_the_package_import_is_kept_as_a_set_up_step(monkeypatch):
    monkeypatch.setattr(profiling, "_setup", dict(profiling._setup))
    setup = profiling.setup_spans()
    assert 0 < setup["setup.package_import"]["seconds"] < 600
    profiling.record_setup("setup.test_step", 0, built=False)
    assert profiling.setup_spans()["setup.test_step"]["built"] is False


def test_the_filters_spans_per_step_and_per_resample():
    pf, ys = make_filter(), observations()
    before = dict(particle_filter.filter_stats)
    _, records, names = profiled(lambda: pf.run(torch.Generator().manual_seed(3), ys))
    resamples = particle_filter.filter_stats["resamples"] - before["resamples"]
    assert particle_filter.filter_stats["steps"] - before["steps"] == T - 1
    count = collections.Counter(r.name for r in records)
    assert count["filter.run"] == 1 and count["filter.step"] == T - 1
    assert count["filter.gate"] == T - 1 and count["filter.gate_read"] == T - 1
    assert 0 < resamples < T - 1
    assert count["filter.resample"] == resamples + 1 and count["filter.take_rows"] == resamples + 1
    assert count["gen.generate"] == T  # the initial importance and one generate a step
    index = by_seq(records)
    for r in records:
        chain = ancestors(r, index)
        if r.name == "filter.gate_read":
            assert chain == ["filter.gate", "filter.step", "filter.run"]
        elif r.name == "filter.gate":
            assert chain == ["filter.step", "filter.run"]
        elif r.name == "filter.step":
            assert chain == ["filter.run"]
        elif r.name in ("filter.resample", "filter.take_rows"):
            assert chain in (["filter.step", "filter.run"], ["filter.run"])
        elif r.name == "dist.draw":
            assert chain[:1] == ["gen.generate"] and chain[-1] == "filter.run"
    assert sum(ancestors(r, index) == ["filter.run"] for r in records if r.name == "filter.resample") == 1
    assert {"filter.run", "filter.step", "filter.gate", "filter.gate_read", "filter.resample"} <= names


@pytest.mark.parametrize("seed", [0, 5])
def test_the_resample_counter_equals_the_row_copies_less_the_final_one(monkeypatch, seed):
    pf, ys = make_filter(1024), observations()
    copies, real = [], particle_filter._take_rows

    def counted(z, idx):
        copies.append(idx.shape[0])
        return real(z, idx)

    monkeypatch.setattr(particle_filter, "_take_rows", counted)
    for call in range(3):
        before = particle_filter.filter_stats["resamples"]
        copies.clear()
        pf.run(torch.Generator().manual_seed(seed + call), ys)
        assert particle_filter.filter_stats["resamples"] - before == len(copies) - 1
        assert copies and all(n == 1024 for n in copies)


def test_a_sir_trials_distributions_sit_under_generate_under_importance():
    _, records, names = profiled(lambda: sir_trial(0))
    index = by_seq(records)
    roots = [r.name for r in records if r.parent is None]
    assert roots == ["smc.importance", "smc.lml", "smc.sample_particle"]
    draws = [r for r in records if r.name == "dist.draw"]
    densities = [r for r in records if r.name == "dist.density"]
    assert len(draws) == 1 and len(densities) == 1  # p drawn, v held to its observation
    for r in draws + densities:
        assert ancestors(r, index) == ["gen.generate", "smc.importance"]
    assert {"smc.importance", "gen.generate", "dist.draw", "dist.density", "smc.lml"} <= names


def test_outputs_are_bit_identical_with_and_without_a_profiler():
    pf, ys = make_filter(), observations()
    plain_filter = pf.run(torch.Generator().manual_seed(11), ys)
    traced_filter, records, _ = profiled(lambda: pf.run(torch.Generator().manual_seed(11), ys))
    assert records
    for a, b in zip(plain_filter, traced_filter):
        assert torch.equal(a, b)
    plain_sir = sir_trial(12)
    traced_sir, records, _ = profiled(lambda: sir_trial(12))
    assert records
    for a, b in zip(plain_sir, traced_sir):
        assert torch.equal(a, b)
