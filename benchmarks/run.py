"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic and
metrics are found by the names in `BENCHMARK.json` (`harness/spec.py`).
With `--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics and the trace's breakdown. The last line
of standard output is the result, one JSON object; the last lines of
standard error are the numbers compared with their limits. Without a CUDA
card, or with fewer cards than the cell asks for, the run exits with code
2 and prints no result. It also fails, and prints no result, where a
module of JAX or of the JAX package has been loaded.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(1, str(ROOT))  # the program under test; sys.path[0] is this folder


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from harness import spec
    from harness.cell import forbidden_modules, run_cell

    cell = spec.resolve(spec.load_spec(ROOT), ROOT, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    outcome = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda")
    loaded = forbidden_modules()
    if loaded:
        print(f"modules of JAX or of the JAX package were loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for line in outcome.lines:
        print(line)
    for name, value, limit, passed in outcome.checks:
        print(f"check {name} {value} limit {limit} {'ok' if passed else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(outcome.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
