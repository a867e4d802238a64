"""The readers of the program's spans and counters, worked out by hand on a
made-up span buffer: a probe's span, then two attempts of the traced
segment, of which only the last counts; and nothing where the run was not
traced, the buffer is empty, or the program keeps no spans or counters."""

from types import SimpleNamespace

import pytest
import torch

from harness import spec
from genjax_tpu_torch.inference import particle_filter
from genjax_tpu_torch.utils import profiling
from genjax_tpu_torch.utils.profiling import SpanRecord


class Buffer:
    """Span records built in start order, each call's times offset."""

    def __init__(self):
        self.records = []

    def add(self, name, parent, start, end):
        rec = SpanRecord(len(self.records), name, parent.seq if parent else None,
                         parent.root if parent else len(self.records), start)
        rec.end_ns = end
        self.records.append(rec)
        return rec

    def filter_call(self, t0, scale):
        """One filter of two steps' worth of spans: the initial generate,
        one step that fires the gate, and the final resample."""
        ns = lambda t: t0 + scale * t  # noqa: E731
        run = self.add("filter.run", None, ns(0), ns(100_000))
        gen = self.add("gen.generate", run, ns(1_000), ns(11_000))
        self.add("dist.draw", gen, ns(2_000), ns(5_000))
        self.add("dist.density", gen, ns(6_000), ns(8_000))
        step = self.add("filter.step", run, ns(12_000), ns(60_000))
        gen = self.add("gen.generate", step, ns(13_000), ns(20_000))
        self.add("dist.draw", gen, ns(14_000), ns(15_000))
        self.add("k1.logsumexp_ess", step, ns(21_000), ns(23_000))
        gate = self.add("filter.gate", step, ns(24_000), ns(34_000))
        self.add("filter.gate_read", gate, ns(25_000), ns(33_000))
        self.add("filter.resample", step, ns(35_000), ns(40_000))
        self.add("filter.take_rows", step, ns(41_000), ns(44_000))
        self.add("filter.resample", run, ns(61_000), ns(62_000))
        self.add("filter.take_rows", run, ns(62_000), ns(64_000))

    def sir_call(self, t0, scale):
        ns = lambda t: t0 + scale * t  # noqa: E731
        imp = self.add("smc.importance", None, ns(0), ns(20_000))
        gen = self.add("gen.generate", imp, ns(1_000), ns(15_000))
        self.add("dist.draw", gen, ns(2_000), ns(9_000))
        self.add("dist.density", gen, ns(10_000), ns(12_000))
        lml = self.add("smc.lml", None, ns(21_000), ns(30_000))
        self.add("k1.logsumexp", lml, ns(22_000), ns(25_000))
        draw = self.add("smc.sample_particle", None, ns(31_000), ns(40_000))
        self.add("k1.logsumexp", draw, ns(33_000), ns(34_000))


def two_attempts(call):
    buf = Buffer()
    buf.add("k1.logsumexp", None, 0, 500)  # the probe before the first attempt
    for attempt, scale in ((0, 3), (1, 1)):  # the first attempt's spans 3x as long
        for c in range(2):
            getattr(buf, call)(1_000_000 * (1 + 2 * attempt + c), scale)
    return buf.records


@pytest.fixture
def buffer(monkeypatch):
    def use(records):
        monkeypatch.setattr(profiling, "spans", lambda: list(records))

    return use


def ctx(trace=True, steps=None):
    return SimpleNamespace(trace={"calls": 2} if trace else None, traffic={} if steps is None else {"steps": steps})


# Per filter step (2 calls x 2 steps) of the last attempt, by hand:
# generate self (10 - 5) + (7 - 1) = 11 us a call; the distributions
# 3 + 2 + 1 = 6; K1 2; the gate's read 8; the resampler 5 + 3 + 1 + 2 = 11.
FILTER = {"gen_host_us.filter": 22 / 4, "dist_host_us.filter": 12 / 4, "k1_host_us.filter": 4 / 4,
          "gate_wait_us.filter": 16 / 4, "resample_host_us.filter": 22 / 4}
# Per SIR trial: generate self 14 - 9 = 5 us; the distributions 7 + 2 = 9;
# K1 3 + 1 = 4.
SIR = {"gen_host_us.sir": 5.0, "dist_host_us.sir": 9.0, "k1_host_us.sir": 4.0}


@pytest.mark.parametrize("name", sorted(FILTER))
def test_filter_span_readers_by_hand(buffer, name):
    buffer(two_attempts("filter_call"))
    assert spec.metric_reader(name)(ctx(steps=2)) == pytest.approx(FILTER[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(SIR))
def test_sir_span_readers_by_hand(buffer, name):
    buffer(two_attempts("sir_call"))
    assert spec.metric_reader(name)(ctx()) == pytest.approx(SIR[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(FILTER) + sorted(SIR))
def test_span_readers_read_nothing_without_spans(buffer, monkeypatch, name):
    read = spec.metric_reader(name)
    buffer(two_attempts("filter_call" if name.endswith("filter") else "sir_call"))
    assert read(ctx(trace=False, steps=2)) is None
    buffer([])
    assert read(ctx(steps=2)) is None
    buffer(Buffer().records + two_attempts("sir_call")[:9])  # the probe and one call, of two traced
    assert read(ctx(steps=2)) is None
    monkeypatch.delattr(profiling, "spans")  # a program that keeps no spans
    assert read(ctx(steps=2)) is None


def test_resample_share_reads_the_filters_counters(monkeypatch):
    read = spec.metric_reader("resample_share.filter")
    monkeypatch.setattr(particle_filter, "filter_stats", {"steps": 49 * 8, "resamples": 27 * 8})
    assert read(ctx(trace=False)) == pytest.approx(100 * 27 / 49, rel=1e-12)
    monkeypatch.setattr(particle_filter, "filter_stats", {"steps": 0, "resamples": 0})
    assert read(ctx()) is None
    monkeypatch.delattr(particle_filter, "filter_stats")
    assert read(ctx()) is None


@pytest.mark.parametrize("name, key", [("k1_load_s", "setup.k1_load"), ("package_import_s", "setup.package_import")])
def test_set_up_readers_read_the_programs_records(monkeypatch, name, key):
    read = spec.metric_reader(name)
    monkeypatch.setattr(profiling, "setup_spans", lambda: {key: {"seconds": 2.75, "nvcc": True}})
    assert read(ctx()) == 2.75
    monkeypatch.setattr(profiling, "setup_spans", lambda: {})
    assert read(ctx()) is None
    monkeypatch.delattr(profiling, "setup_spans")
    assert read(ctx()) is None


def test_the_readers_read_a_profiled_filter_on_the_cpu():
    """Two profiled attempts of two small filters: the gate's wait is the
    last attempt's `filter.gate_read` time, per step."""
    from genjax_tpu_torch.models.ssm import make_ssm_models, simulate_ssm_data

    init_model, step_model = make_ssm_models()
    pf = particle_filter.BootstrapFilter(step_model, init_model, 512, obs_addr="y")
    ys = simulate_ssm_data(torch.Generator().manual_seed(1), 6)[1]
    profiling.reset_spans()
    for _ in range(2):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for c in range(2):
                pf.run(torch.Generator().manual_seed(c), ys)
    records = profiling.spans()
    last = records[[i for i, r in enumerate(records) if r.name == "filter.run"][-2]:]
    reads = [r.end_ns - r.start_ns for r in last if r.name == "filter.gate_read"]
    assert len(reads) == 2 * 5
    c = ctx(steps=6)
    assert spec.metric_reader("gate_wait_us.filter")(c) == pytest.approx(sum(reads) / 1e3 / 12, rel=1e-12)
    for name in ("gen_host_us.filter", "dist_host_us.filter", "resample_host_us.filter"):
        assert spec.metric_reader(name)(c) > 0
    assert spec.metric_reader("k1_host_us.filter")(c) == 0  # the CPU runs K1's plain twin, no span
