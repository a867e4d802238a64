"""The yardstick's counts and the readers' arithmetic against values worked
out by hand at small K and T."""

import math
from types import SimpleNamespace

import pytest

from conftest import ROOT
from harness import peaks, spec
from harness.trace import _by_name, _idle_gaps, busy_us, merged


@pytest.fixture(scope="module")
def cells():
    bench = spec.load_spec(ROOT)
    return {w["name"]: spec.resolve(bench, ROOT, w["name"]) for w in bench["workloads"]}


def ctx(work, calls=1000, seconds=1.0, trace=None, traffic=None):
    window = SimpleNamespace(calls=calls, seconds=seconds, latencies_s=[seconds / calls] * calls)
    return SimpleNamespace(work=work, window=window, trace=trace, traffic=traffic or {}, setup_s=12.5)


def test_sir_work_by_hand(cells):
    ref = spec.reference_module(cells["sir-bb.k1m"])
    w = ref.work({}, {"particles": 1000}, {})
    # 17 operations and 20 bytes a particle: 3 + 6 + 3 + 5 and 4 * 3 + 4 * 2.
    assert w["flops_per_call"] == 17_000 and w["bytes_per_call"] == 20_000 and w["units_per_call"] == 1000
    assert w["k1_bytes"] == {"lse": 4004, "lse_ess": 4008}


def test_filter_work_by_hand(cells):
    ref = spec.reference_module(cells["filter-ssm.k4m.t50"])
    w = ref.work({}, {"particles": 100, "steps": 5}, {"reference_resamples_per_filter": 2.0})
    # Bytes a particle: 8 + 16 * 4 + 12 * 3 = 108; operations 6 + 17 * 4 + 3 * 3 = 83.
    assert w["bytes_per_call"] == 10_800 and w["flops_per_call"] == 8_300 and w["units_per_call"] == 500
    assert "bytes_per_call" not in ref.work({}, {"particles": 100, "steps": 5}, {})


def test_mfu_by_hand():
    read = spec.metric_reader("mfu.sir")
    # 20,000 bytes over 3.35 TB/s is 5.970e-9 s, above 17,000 flops over
    # 67 TFLOP/s (2.537e-10 s); against 1 ms per call that is 5.970e-4 %.
    value = read(ctx({"flops_per_call": 17_000, "bytes_per_call": 20_000}))
    assert value == pytest.approx(100 * (20_000 / 3.35e12) / 1e-3, rel=1e-12)
    assert value == pytest.approx(5.970149253731343e-04, rel=1e-9)
    assert read(ctx({"units_per_call": 1})) is None


def test_k1_roofline_by_hand():
    read = spec.metric_reader("k1_roofline.filter")
    trace = {"k1_kernels": [("void genjax_lse<true>(float const*)", 2e-6), ("void genjax_lse<false>(float const*)", 1e-6)],
             "k1_launched": 2}
    work = {"k1_bytes": {"lse": 4004, "lse_ess": 4008}}
    # (4008 + 4004) / 3.35e12 s of least time over 3 us of kernel time.
    assert read(ctx(work, trace=trace)) == pytest.approx(100 * 8012 / 3.35e12 / 3e-6, rel=1e-12)
    trace["k1_launched"] = 3  # a kernel missing from the trace: no reading
    assert read(ctx(work, trace=trace)) is None
    assert read(ctx(work, trace=None)) is None


def test_launch_idle_and_end_to_end_readers_by_hand():
    trace = {"launch_calls": 7600, "calls": 4, "complete": True, "busy_s": 0.03, "window_s": 0.12}
    c = ctx({"units_per_call": 50 * 1000}, calls=300, seconds=12.0, trace=trace, traffic={"steps": 50})
    assert spec.metric_reader("launches_per_call.sir")(c) == 1900
    assert spec.metric_reader("launches_per_step.filter")(c) == 38
    assert spec.metric_reader("idle_share.sir")(c) == pytest.approx(75.0)
    assert spec.metric_reader("particle_steps_per_s")(c) == pytest.approx(50_000 * 300 / 12.0)
    assert spec.metric_reader("particles_per_s")(c) == pytest.approx(50_000 * 300 / 12.0)
    assert spec.metric_reader("call_p95_ms")(c) == pytest.approx(40.0)
    assert spec.metric_reader("setup_s")(c) == 12.5
    trace["complete"] = False
    assert spec.metric_reader("idle_share.filter")(c) is None


def test_p95_interpolates_between_order_statistics():
    c = ctx({}, calls=21)
    c.window.latencies_s = [i / 1000 for i in range(21)]  # 0..20 ms
    assert spec.metric_reader("call_p95_ms")(c) == pytest.approx(19.0)


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_trace_reduction_by_hand():
    assert busy_us([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]) == 4.0
    assert merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
    items = [("k", 0.0, 10.0), ("k", 30.0, 40.0), ("j", 45.0, 50.0)]
    assert _by_name(items) == [["k", 2, 2e-5], ["j", 1, 5e-6]]
    host = [(9.0, 35.0, "aten::add"), (12.0, 20.0, "aten::mul"), (40.0, 46.0, "cudaLaunchKernel")]
    gaps = _idle_gaps(items, host)
    # Gap (10, 30): middle 20, innermost aten op there is aten::mul; gap
    # (40, 45): middle 42.5, only the launch call.
    assert gaps == [["aten::mul", 2e-5], ["cudaLaunchKernel", 5e-6]]
    assert math.isclose(sum(s for _, s in gaps), 2.5e-5)
