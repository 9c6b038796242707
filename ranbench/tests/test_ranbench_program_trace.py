"""The readers of the program's spans and counts on a hand-built Chrome
trace and hand-built tracer records: each gives the value worked out by
hand, the stretch keeps out the spans of a step that began before it, one
parse gives the device operations that ``trace.read_chrome_trace`` gives,
and a program without spans (the parent of this reader) leaves every reader
at None."""
import json
import types

import pytest

from conftest import BENCH_DIR
from ranbench.harness import program_trace
from ranbench.harness.cell import load_module

BASE_NS = 1_700_000_000_000_000_000
NEW = ("upper_phy.prep_ms", "upper_phy.indications_ms",
       "upper_phy.h2d_per_slot", "device.idle_pct.fapi.upper_phy",
       "pipeline.noise_ms")


def _x(name, s, e, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(s),
            "dur": float(e - s), "pid": 1, "tid": 1}


def _rec(name, s, e, id, parent=None, counts=None):
    """A record of the program's tracer, as the helper reads it."""
    return types.SimpleNamespace(
        name=name, cat="t", start_ns=BASE_NS + int(1e3 * s),
        end_ns=BASE_NS + int(1e3 * e), id=id, parent=parent, req=None,
        tid=1, counts=counts)


# the FAPI cell (µs): the stretch is 100-1100; a UL slot began at 80 in the
# step before it; then a DL slot and two UL slots
FAPI = [
    _x("ranbench.traced", 100, 1100),
    _x("upper_phy.ul_slot", 80, 180), _x("upper_phy.ul_prep", 82, 95),
    _x("graphs.copy_in", 95, 105), _x("upper_phy.indications", 150, 170),
    _x("upper_phy.dl_slot", 200, 300), _x("upper_phy.dl_prep", 202, 230),
    _x("graphs.copy_in", 230, 240), _x("graphs.replay", 240, 250),
    _x("upper_phy.dl_out", 250, 260),
    _x("upper_phy.ul_slot", 400, 700), _x("upper_phy.ul_prep", 402, 452),
    _x("graphs.copy_in", 452, 462), _x("graphs.replay", 462, 480),
    _x("upper_phy.fetch", 480, 600), _x("upper_phy.indications", 600, 690),
    _x("upper_phy.ul_slot", 800, 1000), _x("upper_phy.ul_prep", 800, 830),
    _x("graphs.copy_in", 830, 840), _x("upper_phy.indications", 900, 960),
    _x("graphs.copy_in", 1050, 1060),        # no upper PHY slot around it
    _x("ranbench.ul_slot", 395, 705),
    _x("k", 60, 150, "kernel"), _x("k", 245, 255, "kernel"),
    _x("memcpy", 470, 560, "gpu_memcpy"), _x("k", 850, 870, "kernel"),
    _x("k", 1020, 1090, "kernel")]
FAPI_RECORDS = [
    _rec("upper_phy.ul_prep", 82, 95, 6, 5, {"h2d": 4}),
    _rec("upper_phy.ul_slot", 80, 180, 5),
    _rec("upper_phy.dl_prep", 202, 230, 11, 10, {"h2d": 3}),
    _rec("upper_phy.dl_slot", 200, 300, 10),
    _rec("upper_phy.ul_prep", 402, 452, 21, 20, {"h2d": 2}),
    _rec("upper_phy.ul_slot", 400, 700, 20),
    _rec("inner", 805, 810, 32, 31, {"h2d": 1}),
    _rec("upper_phy.ul_prep", 800, 830, 31, 30, {"h2d": 2}),
    _rec("upper_phy.ul_slot", 800, 1000, 30),
    _rec("elsewhere", 1050, 1060, 40, None, {"h2d": 7})]

# the mixed cell (µs): the stretch is 1000-5000; a dispatch began at 900
MIXED = [
    _x("ranbench.traced", 1000, 5000),
    _x("pipeline.dispatch", 900, 1300), _x("pipeline.noise", 950, 1050),
    _x("pipeline.launch", 1050, 1200),
    _x("cudaGraphLaunch", 1100, 1150, "cuda_runtime"),
    _x("k", 1500, 1600, "kernel"),
    _x("pipeline.dispatch", 2000, 2600), _x("pipeline.payloads", 2000, 2050),
    _x("pipeline.noise", 2050, 2250), _x("pipeline.launch", 2250, 2500),
    _x("pipeline.fold", 2500, 2590),
    _x("cudaGraphLaunch", 2300, 2490, "cuda_runtime"),
    _x("k", 2900, 3000, "kernel"), _x("k", 2800, 2850, "kernel"),
    _x("cudaLaunchKernel", 2510, 2520, "cuda_runtime"),
    _x("k", 2520, 2530, "kernel"),
    _x("pipeline.dispatch", 3000, 3800), _x("pipeline.noise", 3050, 3150),
    _x("pipeline.launch", 3200, 3350),
    _x("pipeline.launch", 3260, 3700, "gpu_user_annotation"),
    _x("cudaGraphLaunch_v10000", 3210, 3300, "cuda_runtime"),
    _x("k", 3260, 3700, "kernel")]


def _run(tmp_path, monkeypatch, events, records=()):
    path = tmp_path / "build" / "ranbench" / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"baseTimeNanoseconds": BASE_NS,
                                "traceEvents": events}))
    monkeypatch.setattr(program_trace, "_records", lambda: list(records))
    cell = types.SimpleNamespace(root=tmp_path)
    out = types.SimpleNamespace(trace={"busy_s": 1.0})
    return {name: load_module(BENCH_DIR / "metrics" / f"{name}.py").read(
        cell, out) for name in NEW}


def test_fapi_readers(tmp_path, monkeypatch):
    got = _run(tmp_path, monkeypatch, FAPI, FAPI_RECORDS)
    # the slots at 200, 400 and 800; prep + copy-in 38, 60 and 40 µs
    assert got["upper_phy.prep_ms"] == pytest.approx(138e-3 / 3)
    # the UL slots at 400 and 800: 90 and 60 µs
    assert got["upper_phy.indications_ms"] == pytest.approx(75e-3)
    # 3, 2 and 2 + 1 below the three slots
    assert got["upper_phy.h2d_per_slot"] == pytest.approx(8 / 3)
    # idle while open: 100-180 (busy to 150) 30, 200-300 90, 400-700 210,
    # 800-1000 180 µs of 1000
    assert got["device.idle_pct.fapi.upper_phy"] == pytest.approx(51.0)
    assert got["pipeline.noise_ms"] is None


def test_fapi_idle_within_the_cell_idle(tmp_path, monkeypatch):
    from ranbench.harness import trace
    got = _run(tmp_path, monkeypatch, FAPI, FAPI_RECORDS)
    device, host, _ = trace.read_chrome_trace(
        tmp_path / "build" / "ranbench" / "trace.json", "ranbench.")
    r = trace.reduce_trace(device, host, (100.0, 1100.0))
    assert 100 * r["idle_s"] / r["window_s"] == pytest.approx(76.0)
    assert got["device.idle_pct.fapi.upper_phy"] <= 76.0


def test_mixed_readers(tmp_path, monkeypatch):
    got = _run(tmp_path, monkeypatch, MIXED)
    # the dispatches at 2000 and 3000: 200 and 100 µs of noise
    assert got["pipeline.noise_ms"] == pytest.approx(0.15)
    assert got["upper_phy.prep_ms"] is None
    assert got["upper_phy.h2d_per_slot"] is None
    assert got["device.idle_pct.fapi.upper_phy"] is None


def test_one_parse_gives_the_trace_modules_device_operations(
        tmp_path, monkeypatch):
    from ranbench.harness import trace
    _run(tmp_path, monkeypatch, MIXED)
    path = tmp_path / "build" / "ranbench" / "trace.json"
    pt = program_trace.load(types.SimpleNamespace(root=tmp_path),
                            types.SimpleNamespace(trace={"busy_s": 1.0}))
    device, host, _ = trace.read_chrome_trace(path, "")
    assert pt.device_ops == device
    assert pt.base_ns == BASE_NS and pt.window == (1000.0, 5000.0)
    assert sum(map(len, pt.ranges.values())) == len(host)


def test_program_without_spans_reads_nothing(tmp_path, monkeypatch):
    bare = [e for e in FAPI + MIXED
            if not e["name"].startswith(("upper_phy.", "pipeline.",
                                         "graphs."))]
    got = _run(tmp_path, monkeypatch, bare)
    assert got == {name: None for name in NEW}
    # no traced stretch in the run
    cell = types.SimpleNamespace(root=tmp_path)
    assert program_trace.load(cell, types.SimpleNamespace(trace=None)) is None
