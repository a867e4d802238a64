"""The reader of `k4_share.hmm`, worked out on the program's counters: 100
where K4 drew and scored every categorical row, and nothing without the
counter (a program without K4) or without a row."""

from types import SimpleNamespace

import pytest

from harness import spec


def ctx():
    return SimpleNamespace(trace={"calls": 2}, traffic={"particles": 1024, "steps": 50})


def test_k4_share_reads_the_categorical_counters(monkeypatch):
    from genjax_tpu_torch.distributions import library

    read = spec.metric_reader("k4_share.hmm")
    stats = {"drawn": 150_000, "scored": 300_000, "entries": 28_800_000, "k4_rows": 450_000}
    monkeypatch.setattr(library, "categorical_stats", stats)
    assert read(ctx()) == 100.0
    stats["k4_rows"] = 150_000
    assert read(ctx()) == pytest.approx(100.0 / 3, rel=1e-12)
    stats["k4_rows"] = 0
    assert read(ctx()) == 0.0
    monkeypatch.setattr(library, "categorical_stats", {"drawn": 0, "scored": 0, "entries": 0, "k4_rows": 0})
    assert read(ctx()) is None
    monkeypatch.setattr(library, "categorical_stats", {"drawn": 150_000, "scored": 300_000, "entries": 28_800_000})
    assert read(ctx()) is None
    monkeypatch.delattr(library, "categorical_stats")
    assert read(ctx()) is None
