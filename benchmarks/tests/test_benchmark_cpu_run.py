"""Each cell's call path and its reference agree at a small size on the CPU
(the harness's test-only entry), the control and each fault that a cell can
have come out not correct, and the command itself refuses to run without a
card."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT
from harness import spec
from harness.cell import run_cell

SMALL = {
    "sir-bb.k1m": {"particles": 65536},
    "filter-ssm.k4m.t50": {"particles": 8192, "steps": 20},
}
SEED = 2**31 + 12345


def cell(name):
    return spec.resolve(spec.load_spec(ROOT), ROOT, name)


def run_small(name, seconds=1.0, **kw):
    return run_cell(cell(name), SEED, seconds, False, device="cpu", overrides=SMALL[name], **kw)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_program_agrees_with_the_reference_on_the_cpu(name):
    outcome = run_small(name)
    assert outcome.result["correct"] is True, outcome.result["checks"]
    assert outcome.result["failed"] == 0 and outcome.result["attempted"] > 1
    readings = outcome.result["checks"]
    assert all(isinstance(c["value"], float) and c["value"] <= c["limit"] for c in readings.values())
    assert list(outcome.result)[-1] == "checks"


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_is_not_correct(name):
    """The reference in bfloat16 in the program's place fails the cell."""
    outcome = run_small(name, control=True)
    assert outcome.result["correct"] is False
    assert any(c["value"] == "inf" or c["value"] > c["limit"] for c in outcome.result["checks"].values())


def _faults():
    """(cell, fault, the number it has to fail) for each fault of each
    cell's configuration (`faults/<config>.py`)."""
    for name in sorted(SMALL):
        for fault, (_, caught_by) in spec.fault_module(cell(name)).FAULTS.items():
            yield name, fault, caught_by


FAULTS = list(_faults())


@pytest.mark.parametrize("name,fault,caught_by", FAULTS, ids=[f"{n}-{f}" for n, f, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault, caught_by):
    plant, _ = spec.fault_module(cell(name)).FAULTS[fault]
    plant(monkeypatch.setattr)
    outcome = run_small(name)
    assert outcome.result["correct"] is False
    check = outcome.result["checks"][caught_by]
    assert check["value"] == "inf" or check["value"] > check["limit"], outcome.result["checks"]


def test_the_command_fails_without_a_card(no_card):
    out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", "sir-bb.k1m", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


NO_JAX = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
from pathlib import Path
from harness import spec
from harness.cell import forbidden_modules, run_cell
root = Path({root!r})
for name, small in {small!r}.items():
    run_cell(spec.resolve(spec.load_spec(root), root, name), 3, 0.3, False, device="cpu", overrides=small)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
print(json.dumps(forbidden_modules()))
"""


def test_a_run_loads_no_module_of_jax_or_the_jax_package():
    code = NO_JAX.format(bench=str(BENCH_DIR), root=str(ROOT), small=SMALL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    *_, tops, forbidden = out.stdout.strip().splitlines()
    assert json.loads(forbidden) == []
    assert not {"jax", "jaxlib", "flax", "genjax_tpu"} & set(json.loads(tops))
    assert "genjax_tpu_torch" in json.loads(tops)


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory holding only `BENCHMARK.json` and the benchmark's
    files, the harness cannot find the program and gives no result."""
    import shutil

    shutil.copytree(BENCH_DIR, tmp_path / "benchmarks", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = (f"import sys; sys.path[:0] = [{str(tmp_path / 'benchmarks')!r}]\n"
            "from pathlib import Path\nfrom harness import spec\nfrom harness.cell import run_cell\n"
            f"root = Path({str(tmp_path)!r})\n"
            "run_cell(spec.resolve(spec.load_spec(root), root, 'sir-bb.k1m'), 1, 0.2, False, device='cpu',"
            " overrides={'particles': 1024})\nprint('{}')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "genjax_tpu_torch" in out.stderr


@pytest.mark.gpu
def test_the_command_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", "sir-bb.k1m", "--seed", "5",
                          "--seconds", "2", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"particles_per_s", "call_p95_ms", "setup_s"}
