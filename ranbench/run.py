#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: run one cell and print its
result line.

    python3 ranbench/run.py --workload mixed273.b64 --seed 7 --seconds 10 --trace 0

Run from the root of a checkout that holds ``BENCHMARK.json``.  The cell's
files are found by name under ``ranbench/``.  Exits non-zero, printing no
result, without CUDA or with fewer cards than the cell asks for, when the
program or a cell file is missing, or when JAX or the JAX package is loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    if not (root / "BENCHMARK.json").is_file():
        print("no BENCHMARK.json in the working directory", file=sys.stderr)
        return 2
    sys.path.insert(0, str(CHECKOUT))
    from ranbench.harness import cell as cell_mod
    from ranbench.harness import result, runner
    runner.cache_dirs(root)
    chips = cell_mod.load_cell(root, args.workload).chips
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    line, compared = runner.run_cell(root, args.workload, args.seed,
                                     args.seconds, bool(args.trace), T0)
    result.emit(line, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
