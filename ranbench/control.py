#!/usr/bin/env python3
"""Read the control of a cell's comparison: the reference one precision
below the configuration's, put in the program's place, on the slots a run
samples, for each seed given.

    python3 ranbench/control.py --workload mixed273.b64 --seeds 11 12 13

Prints one JSON line per seed with each compared number; a control that
the limits do not catch reads as passing.
"""
import argparse
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    from ranbench.harness.cell import load_cell
    cell = load_cell(Path.cwd(), args.workload)
    for seed in args.seeds:
        got = cell.driver().control(cell, seed, device=args.device)
        print(json.dumps({"seed": seed, **{c.name: c.value for c in got},
                          "caught": not all(c.ok for c in got)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
