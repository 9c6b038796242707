"""The benchmark's tests: the checkout's root on the path (the harness,
the reference and the program import from there), one thread per worker,
and the helper that builds a throwaway cell from files in a temporary
directory."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))
torch.set_num_threads(1)
BENCH_DIR = CHECKOUT / "ranbench"


def write_cell(root: Path, *, config: str, traffic: str, config_body: dict,
               traffic_body: dict, end_to_end: list, per_layer: list,
               chips: int = 1) -> str:
    """A checkout at `root`: a copy of the benchmark's folder, a manifest of
    one cell, and that cell's configuration and traffic files; returns the
    cell's name."""
    name = f"{config}.{traffic}"
    shutil.copytree(BENCH_DIR, root / "ranbench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "ranbench" / "configs").mkdir(parents=True, exist_ok=True)
    (root / "ranbench" / "workloads").mkdir(parents=True, exist_ok=True)
    (root / "ranbench" / "configs" / f"{config}.json").write_text(
        json.dumps(config_body))
    (root / "ranbench" / "workloads" / f"{name}.json").write_text(
        json.dumps(traffic_body))
    manifest = {
        "command": ["python3", "ranbench/run.py"], "paths": ["ranbench"],
        "run_seconds": 1,
        "configs": [{"name": config, "source": "test",
                     "file": f"ranbench/configs/{config}.json",
                     "reduced": [], "why": "test"}],
        "workloads": [{"name": name, "config": config, "traffic": traffic,
                       "chips": chips, "why": "test"}],
        "end_to_end": end_to_end, "per_layer": per_layer}
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return name


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
