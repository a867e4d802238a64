"""The discrete-HMM filter cell on the CPU at a small size: the program's
call path agrees with the exact forward algorithm and the reference
filter, the bfloat16 control and each of the cell's faults come out not
correct, and the work counts and the categorical reader by hand."""

from types import SimpleNamespace

import pytest

from conftest import ROOT
from harness import spec
from harness.cell import run_cell

NAME = "filter-hmm64.k1m.t50"
# Two sequences, so that a few seconds' calls give each several.
SMALL = {"particles": 8192, "steps": 20, "datasets": 2}
SEED = 2**31 + 4242
SECONDS = 4.0


@pytest.fixture(scope="module")
def cell():
    return spec.resolve(spec.load_spec(ROOT), ROOT, NAME)


def run_small(cell, **kw):
    return run_cell(cell, SEED, SECONDS, False, device="cpu", overrides=SMALL, **kw)


def test_program_agrees_with_the_exact_values_on_the_cpu(cell):
    outcome = run_small(cell)
    assert outcome.result["correct"] is True, outcome.result["checks"]
    assert outcome.result["failed"] == 0 and outcome.result["attempted"] > 2
    assert set(outcome.result["checks"]) == {"lml_z", "state_tv", "resample_gap"}


def test_the_control_is_not_correct(cell):
    """The reference in bfloat16 in the program's place fails the cell."""
    outcome = run_small(cell, control=True)
    assert outcome.result["correct"] is False
    assert any(c["value"] == "inf" or c["value"] > c["limit"] for c in outcome.result["checks"].values())


FAULTS = sorted(spec.fault_module(spec.resolve(spec.load_spec(ROOT), ROOT, NAME)).FAULTS.items())


@pytest.mark.parametrize("fault,caught_by", [(f, by) for f, (_, by) in FAULTS], ids=[f for f, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault, caught_by):
    plant, _ = spec.fault_module(cell).FAULTS[fault]
    plant(monkeypatch.setattr)
    outcome = run_small(cell)
    assert outcome.result["correct"] is False
    check = outcome.result["checks"][caught_by]
    assert check["value"] == "inf" or check["value"] > check["limit"], outcome.result["checks"]


def test_work_by_hand(cell):
    ref = spec.reference_module(cell)
    w = ref.work(cell.config, {"particles": 100, "steps": 5}, {"reference_resamples_per_filter": 4.0})
    # Bytes a particle: 12 + 24 * 4 + 20 * 5 = 208. Operations: a draw and
    # two scores over 64 categories each step, 64 * (3 + 2 * 4) = 704, five
    # times; 6 for each later step's weight and K1; 3 for each resample.
    assert w["bytes_per_call"] == 100 * 208 and w["units_per_call"] == 500
    assert w["flops_per_call"] == 100 * (704 * 5 + 6 * 4 + 3 * 5)
    assert w["k1_bytes"] == {"lse": 404, "lse_ess": 408}
    assert "bytes_per_call" not in ref.work(cell.config, {"particles": 100, "steps": 5}, {})


def test_the_categorical_reader_by_hand(monkeypatch):
    from genjax_tpu_torch.distributions import library
    from genjax_tpu_torch.inference import particle_filter

    read = spec.metric_reader("categorical_entries.hmm")
    ctx = SimpleNamespace(traffic={"particles": 1000, "steps": 50})
    # Three filters of 50 steps: 147 steps after each one's first, and
    # 3 x 64 entries for each of 1000 x 50 x 3 particle-steps.
    monkeypatch.setattr(particle_filter, "filter_stats", {"steps": 147, "resamples": 100})
    monkeypatch.setattr(library, "categorical_stats", {"drawn": 150_000, "scored": 300_000, "entries": 28_800_000})
    assert read(ctx) == 192.0
    monkeypatch.setattr(library, "categorical_stats", {"drawn": 150_000, "scored": 150_000, "entries": 19_200_000})
    assert read(ctx) == 128.0
    monkeypatch.delattr(library, "categorical_stats")
    assert read(ctx) is None
