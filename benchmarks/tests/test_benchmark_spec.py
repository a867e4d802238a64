"""`BENCHMARK.json` against its contract, and every name in it resolved to
its files; a cell and a metric added as new files and entries alone run
through the harness unchanged."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_spec(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmarks/run.py"]
    assert bench["paths"] == ["benchmarks"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_name_and_unit_is_well_formed(bench):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in bench[key]]
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_end_to_end_metrics_and_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one(bench):
    for w in bench["workloads"]:
        cell = spec.resolve(bench, ROOT, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])


def test_per_layer_metrics_name_their_layer_and_cells(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m["workloads"]) <= cells and 1 <= len(m["layer"]) <= 200
        if m["name"].split(".")[0].endswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_name_resolves_to_its_files(bench):
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmarks/")
        assert (BENCH_DIR / "configs" / f"{c['name']}.py").is_file()
        assert (BENCH_DIR / "reference" / f"{c['name']}.py").is_file()
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        cell = spec.resolve(bench, ROOT, w["name"])
        program, reference = spec.program_module(cell), spec.reference_module(cell)
        assert hasattr(program, "Program")
        for attr in ("make_inputs", "judge", "work", "Control", "LIMITS"):
            assert hasattr(reference, attr), (w["config"], attr)
        faults = spec.fault_module(cell).FAULTS
        assert faults and all(caught_by in reference.LIMITS for _, caught_by in faults.values())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"])), m["name"]


def test_an_unknown_cell_is_refused(bench):
    with pytest.raises(KeyError):
        spec.resolve(bench, ROOT, "no-such-cell")


ADDED_CELL = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
from pathlib import Path
from harness import spec
from harness.cell import run_cell
root = Path({copy!r})
cell = spec.resolve(spec.load_spec(root), root, "sir-bb.k4k")
outcome = run_cell(cell, 2**31 + 7, 0.5, False, device="cpu")
print(json.dumps(outcome.result))
"""


def test_a_cell_and_a_metric_added_as_files_alone_are_run(tmp_path):
    """A copy of the benchmark gains a traffic file, a metric reader and
    their entries in `BENCHMARK.json`; the harness runs the new cell and
    reports the new metric, with no file of the copy edited."""
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, copy / "benchmarks", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(copy): p.read_bytes() for p in (copy / "benchmarks").rglob("*") if p.is_file()}

    (copy / "benchmarks" / "traffic" / "k4k.json").write_text(json.dumps(
        {"particles": 4096, "warmup_calls": 1, "keep": 2, "trace_calls": 4}))
    (copy / "benchmarks" / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx.window.calls / ctx.window.seconds\n")
    bench["workloads"].append({"name": "sir-bb.k4k", "config": "beta_bernoulli_sir", "traffic": "k4k",
                               "chips": 1, "why": "a small cell for the test"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["sir-bb.k4k"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ADDED_CELL.format(bench=str(copy / "benchmarks"), root=str(ROOT), copy=str(copy))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"call_p95_ms", "setup_s", "calls_per_s"}
    after = {p.relative_to(copy): p.read_bytes() for p in (copy / "benchmarks").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)
