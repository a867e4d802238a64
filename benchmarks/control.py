"""Run a cell's control, or the program with one of the cell's faults
planted, through the rest of a run (window, judge, limits), on several
seeds in one process. The control is the plain reference, computed in
bfloat16, in the program's place; a fault is one of `faults/<config>.py`.
Both have to come out not correct on every seed; their readings are the
upper readings of PERF.md's limits. The benchmark's own runs never run
either.

    python3 benchmarks/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...] [--fault <name>]

Needs the card.
"""

import argparse
import json
import sys

import run  # puts the program under test on the path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fault", help="plant this fault in the program instead of running the control")
    args = parser.parse_args(argv)

    import torch

    from harness import spec
    from harness.cell import run_cell

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = spec.resolve(spec.load_spec(run.ROOT), run.ROOT, args.workload)
    if args.fault:
        plant, _ = spec.fault_module(cell).FAULTS[args.fault]
        plant(setattr)
    for seed in args.seeds:
        outcome = run_cell(cell, seed, args.seconds, False, device="cuda", control=not args.fault)
        readings = {name: value for name, value, _, _ in outcome.checks}
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": outcome.result["correct"],
                          "attempted": outcome.result["attempted"], "readings": readings,
                          "metrics": outcome.result["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
