"""One run of one cell: load it by name, set up the program through the
cell's driver, measure for the given seconds, judge the outputs against the
reference, and build the result line."""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path

from . import guard, result
from .cell import load_cell
from .spans import Spans


@dataclasses.dataclass
class Outcome:
    """What a driver hands back from a run."""
    attempted: int
    failed: int
    end_to_end: dict          # {metric: value}
    compared: list            # [result.Compared]
    device: dict              # platform, kind, count, memory_peak_bytes
    spans: Spans
    trace: dict | None = None  # trace.reduce_trace of the traced stretch


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernel library goes to ``build/kernels`` there)."""
    base = Path(root) / "build" / "ranbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def per_layer(cell, out: Outcome) -> dict:
    """{metric: (value, unit)} of the cell's per-layer metrics whose readers
    found something to read."""
    found = {}
    for m in cell.per_layer:
        value = cell.reader(m["name"]).read(cell, out)
        if value is not None:
            found[m["name"]] = (value, m["unit"])
    return found


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, t0: float, device: str | None = None) -> tuple:
    """→ (result line, compared numbers).  `device` None is the card (the
    caller has checked that there are enough); tests pass "cpu"."""
    cell = load_cell(Path(root), workload)
    out = cell.driver().run(cell, seed=seed, seconds=seconds, trace=trace,
                            t0=t0, device=device)
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if trace:
        metrics = per_layer(cell, out)
        device_info = dict(out.device, busy_s=out.trace["busy_s"],
                           window_s=out.trace["window_s"])
        breakdown = {"device_ops": out.trace["device_ops"],
                     "idle_gaps": out.trace["idle_gaps"]}
    else:
        missing = set(units) - set(out.end_to_end)
        if missing:
            raise RuntimeError(f"the driver measured no {sorted(missing)}")
        metrics = {k: (out.end_to_end[k], units[k]) for k in units}
        device_info, breakdown = out.device, None
    loaded = guard.forbidden_loaded()
    if loaded:
        raise RuntimeError(f"forbidden modules loaded: {loaded}")
    correct = result.judge(out.compared)
    return (result.line(correct, out.attempted, out.failed, metrics,
                        device_info, out.compared, breakdown), out.compared)
