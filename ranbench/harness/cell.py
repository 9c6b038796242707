"""A cell of the benchmark, found by name under the directory that holds
``BENCHMARK.json``: its entry there, its configuration file, its traffic
file (``ranbench/workloads/<cell>.json``), its driver
(``ranbench/drivers/<traffic kind>.py``) and the readers of its per-layer
metrics (``ranbench/metrics/<metric>.py``).  Adding a cell, a traffic mix or
a metric adds files; nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
_LOADED: dict[Path, object] = {}


def load_module(path: Path):
    """The Python file at `path` as a module, imported once."""
    path = Path(path).resolve()
    if path not in _LOADED:
        name = "ranbench_" + re.sub(r"\W", "_", str(path))
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None or spec.loader is None or not path.is_file():
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict            # the configuration file as run
    traffic: dict           # workloads/<cell>.json
    end_to_end: list[dict]  # the manifest's end-to-end metrics of this cell
    per_layer: list[dict]   # the manifest's per-layer metrics of this cell
    root: Path              # where BENCHMARK.json lies

    def file(self, kind: str, filename: str) -> Path:
        """``<root>/ranbench/<kind>/<filename>``."""
        return self.root / "ranbench" / kind / filename

    def driver(self):
        """The driver of the cell's traffic kind."""
        return load_module(self.file("drivers",
                                     f"{self.traffic['driver']}.py"))

    def reader(self, metric: str):
        """The reader of the per-layer metric `metric`."""
        return load_module(self.file("metrics", f"{metric}.py"))


def _applies(metric: dict, cell: str, reported: set[str] | None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(root: Path, name: str) -> Cell:
    """The cell `name` of ``root/BENCHMARK.json``: its configuration file by
    the manifest's path under `root`, its traffic file, driver and metric
    readers by name under ``root/ranbench``."""
    manifest = json.loads((Path(root) / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    conf = configs[w["config"]]
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=json.loads((Path(root) / conf["file"]).read_text()),
        traffic=json.loads((Path(root) / "ranbench" / "workloads"
                            / f"{name}.json").read_text()),
        end_to_end=e2e, per_layer=per_layer, root=Path(root))
