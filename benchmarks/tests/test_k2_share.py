"""The reader of `k2_share.filter`, worked out on the program's counters:
100 where every systematic_resample call launched K2, and nothing without the
counters (a program without K2) or without a call."""

from types import SimpleNamespace

import pytest

from harness import spec


def ctx():
    return SimpleNamespace(trace={"calls": 2}, traffic={})


def test_k2_share_reads_the_resamplers_counters(monkeypatch):
    from genjax_tpu_torch import ops
    from genjax_tpu_torch.inference import smc

    read = spec.metric_reader("k2_share.filter")
    resample = lambda *args: None  # noqa: E731
    resample.calls = 27 * 8
    monkeypatch.setattr(smc, "systematic_resample", resample)
    monkeypatch.setattr(ops, "fused_systematic_ancestors", SimpleNamespace(launches=27 * 8))
    assert read(ctx()) == 100.0
    ops.fused_systematic_ancestors.launches = 27 * 4
    assert read(ctx()) == pytest.approx(50.0, rel=1e-12)
    resample.calls = 0
    assert read(ctx()) is None
    monkeypatch.setattr(smc, "systematic_resample", lambda *args: None)
    assert read(ctx()) is None
    resample.calls = 8
    monkeypatch.setattr(smc, "systematic_resample", resample)
    monkeypatch.delattr(ops, "fused_systematic_ancestors")
    assert read(ctx()) is None
