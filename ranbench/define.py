#!/usr/bin/env python3
"""Work out the data a cell's traffic file freezes: the LDPC launches of one
batch with their shapes and the sweeps the reference decoder needs.

    python3 ranbench/define.py --workload mixed273.b64 --seed 1 [--device cpu]

Prints one JSON object, the traffic file's ``kernels`` entry.
"""
import argparse
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    from ranbench.harness.cell import load_cell
    cell = load_cell(Path.cwd(), args.workload)
    print(json.dumps(cell.driver().kernel_shapes(cell, args.seed,
                                                 args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
