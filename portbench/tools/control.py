#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the card, at
the cell's own size: for each seed, a run of the program with the
control's readings beside its own (the reference in float8 put in the
program's place), and a run with each fault planted underneath the timed
path.

    python3 portbench/tools/control.py --workload qwen3-14b.docqa \\
        --seconds 20 --seeds 11 12 13 [--faults token]

One JSON line a run: the seed, the fault (or null) and every number
compared.  The benchmark's own runs never run the control.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import run as R  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    args = ap.parse_args()

    from harness.spec import load_cell

    cell = load_cell(args.workload)
    for seed in args.seeds:
        for fault in [None] + args.faults:
            out = R.run_cell(cell, seed, args.seconds, False,
                             fault=fault, control=fault is None)
            print(json.dumps({"seed": seed, "fault": fault,
                              "metrics": out["metrics"],
                              "checks": {k: v["value"] for k, v in
                                         out["checks"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
