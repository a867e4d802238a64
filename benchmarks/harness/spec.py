"""Find a cell's files by the names in `BENCHMARK.json`.

A cell (`workloads[]`) names its configuration and its traffic mix; from
the names alone the harness finds:

- `configs/<config>.json`: the configuration as it is run (the file that
  `configs[].file` names);
- `configs/<config>.py`: `Program`, the call into the program under test;
- `reference/<config>.py`: the plain reference, its control, its judge,
  the input maker and the work counts;
- `faults/<config>.py`: the faults that the configuration's cells can
  have, planted by `control.py --fault` and the tests, never by a run;
- `traffic/<traffic>.json`: the traffic mix;
- `metrics/<metric>.py`, else `metrics/<family>.py` (the part of the name
  before the first dot): the reader of each metric.

Adding a configuration, a cell or a metric is adding files and entries.
"""

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    workload: dict
    config_entry: dict
    config: dict
    traffic: dict
    bench_dir: Path
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def resolve(spec: dict, root: Path, cell_name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell named `cell_name`, with its configuration, traffic and the
    metrics it reports; raises `KeyError` for an unknown name."""
    workload = next((w for w in spec["workloads"] if w["name"] == cell_name), None)
    if workload is None:
        raise KeyError(f"no workload named {cell_name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == workload["config"])
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{workload['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=cell_name,
        workload=workload,
        config_entry=entry,
        config=config,
        traffic=traffic,
        bench_dir=bench_dir,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, cell_name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, cell_name)],
    )


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def program_module(cell: Cell):
    return load_module(cell.bench_dir / "configs" / f"{cell.workload['config']}.py", f"bench_config_{cell.workload['config']}")


def reference_module(cell: Cell):
    return load_module(cell.bench_dir / "reference" / f"{cell.workload['config']}.py", f"bench_reference_{cell.workload['config']}")


def fault_module(cell: Cell):
    return load_module(cell.bench_dir / "faults" / f"{cell.workload['config']}.py", f"bench_faults_{cell.workload['config']}")


def metric_path(metric_name: str, bench_dir: Path = BENCH_DIR) -> Path:
    """`metrics/<name>.py` if it exists, else `metrics/<family>.py`."""
    whole = bench_dir / "metrics" / f"{metric_name}.py"
    if whole.exists():
        return whole
    return bench_dir / "metrics" / f"{metric_name.split('.')[0]}.py"


def metric_reader(metric_name: str, bench_dir: Path = BENCH_DIR):
    path = metric_path(metric_name, bench_dir)
    return load_module(path, f"bench_metric_{path.stem.replace('.', '_')}").read
