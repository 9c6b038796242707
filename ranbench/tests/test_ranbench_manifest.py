"""The manifest and every cell's files load by name and keep to the
benchmark's contract; nothing the benchmark loads is JAX or the JAX
package, and the reference loads nothing of the program."""
import json
import re
import subprocess
import sys

import pytest

from conftest import CHECKOUT
from ranbench.harness.cell import BENCH_DIR, load_cell, load_module

MANIFEST = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["ranbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MANIFEST[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("ranbench/")
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(
        1, len(CELLS) // 4)


def test_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        reported = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(reported)
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert layers <= {"slot pipeline", "FAPI front", "upper PHY",
                      "kernels", "device"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    cell = load_cell(CHECKOUT, name)
    assert cell.config["precision"] == "float32"
    driver = cell.driver()
    assert callable(driver.run) and callable(driver.control)
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    assert any(m["name"] != "setup_s" for m in cell.end_to_end)
    assert cell.per_layer
    assert set(cell.traffic["limits"]) >= {"verdicts_differ",
                                           "sinr_gap_db"}


def test_cell_files_are_found_under_the_root(tmp_path):
    from conftest import write_cell
    name = write_cell(tmp_path, config="c", traffic="t",
                      config_body={"precision": "float32"},
                      traffic_body={"driver": "scan_mixed"},
                      end_to_end=[], per_layer=[])
    cell = load_cell(tmp_path, name)
    assert cell.traffic == {"driver": "scan_mixed"}
    path = tmp_path / "ranbench" / "drivers" / "scan_mixed.py"
    assert cell.driver() is load_module(path)
    assert cell.driver() is not load_cell(CHECKOUT, CELLS[0]).driver()


def _loaded(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, "
         f"{str(CHECKOUT)!r})\n{code}\nprint(' '.join(sorted({{m.split('.')"
         f"[0] for m in sys.modules}})))"],
        capture_output=True, text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_program():
    tops = _loaded("import ranbench.reference.models.gnb_mixed, "
                   "ranbench.reference.models.fapi_carrier, "
                   "ranbench.reference.phy.upper.upper_phy")
    assert "srsran_project_23_5_tpu_torch" not in tops
    assert not tops & {"jax", "jaxlib", "flax", "srsran_project_23_5_tpu"}


def test_benchmark_loads_no_jax():
    tops = _loaded(
        "from pathlib import Path\n"
        "from ranbench.harness.cell import load_cell\n"
        f"for n in {CELLS!r}:\n"
        f"    c = load_cell(Path({str(CHECKOUT)!r}), n); c.driver()\n"
        "    [c.reader(m['name']) for m in c.per_layer]\n"
        "import srsran_project_23_5_tpu_torch.phy.pipeline, "
        "srsran_project_23_5_tpu_torch.phy.upper.upper_phy")
    assert "srsran_project_23_5_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "srsran_project_23_5_tpu"}


def test_run_refuses_without_a_manifest(tmp_path):
    got = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"),
                          "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert got.returncode != 0 and got.stdout == ""


def test_run_refuses_without_a_card(tmp_path):
    """Without CUDA (this sandbox) a run exits non-zero and prints no
    result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    got = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"),
                          "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1"], cwd=CHECKOUT,
                         capture_output=True, text=True, timeout=120)
    assert got.returncode != 0 and got.stdout == ""
