"""The ``scan_harq`` driver end to end at 68 PRB on the CPU, as a cell added
from files in a temporary directory: a sound run is correct; the control
(the reference in bfloat16) and each fault the cell can have (a combination
that drops the softbuffer, a combined buffer decoded on the truncated rv=0
graph, a first transmission reported as passing) come out not correct; a
program without ``harq_pair_batch`` is refused before anything runs; and the
readers of the decoder's launches tell full-graph launches from rv=0 ones
in an exported trace and hold them against the capture's count."""
import dataclasses
import json
import time
import types

import pytest
import torch

from conftest import write_cell
from ranbench.harness import decoder_launches, program_trace, runner
from ranbench.harness.runner import Outcome
from ranbench.harness.spans import Spans

TINY = {"args": {"nof_prb": 68, "qm": 6, "rate": 0.6533, "snr_db": 20.0},
        "harq": {"rv": [0, 2], "retransmissions": 1, "snr_db": 12.5},
        "precision": "float32"}
TRAFFIC = {"driver": "scan_harq", "pairs_per_batch": 2, "scan_batches": 2,
           "trace_dispatches": 1,
           "limits": {"verdicts_differ": 0, "sinr_gap_db": 0.001,
                      "rel_gap": 0.0001}}
E2E = [{"name": "mixed_slot_us", "unit": "us", "better": "lower",
        "bound": 0.05, "source": "host_clock"},
       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
        "source": "host_clock"}]
PER_LAYER = [{"name": n, "unit": "%", "better": b, "source": "device_trace",
              "layer": layer, "moves": "mixed_slot_us"}
             for n, b, layer in (
                 ("ldpc_dec_full.roofline_pct.harq", "higher", "kernels"),
                 ("ldpc_dec.roofline_pct.harq", "higher", "kernels"),
                 ("device.idle_pct.harq", "lower", "device"))]
SEED = 2**31 + 23456


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    from ranbench.harness.cell import load_cell
    name = write_cell(tmp_path, config="tiny_harq", traffic="b2",
                      config_body=TINY, traffic_body=TRAFFIC,
                      end_to_end=E2E, per_layer=PER_LAYER)
    driver = load_cell(tmp_path, name).driver()
    monkeypatch.setattr(driver, "PAYLOAD_SETS", 2)
    monkeypatch.setattr(driver, "SAMPLE_PAIRS", 3)
    return tmp_path, name


def _run(root, name, trace=False, seconds=0.5):
    line, compared = runner.run_cell(root, name, SEED, seconds, trace,
                                     time.perf_counter(), device="cpu")
    return json.loads(line), compared


def test_sound_run_is_correct(tiny):
    out, compared = _run(*tiny)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "limits"]
    assert out["correct"] and out["failed"] == 0
    # two mixed slots a pair, 2 pairs a batch, 2 batches a dispatch
    assert out["attempted"] % 8 == 0 and out["attempted"] >= 8
    assert set(out["metrics"]) == {"mixed_slot_us", "setup_s"}
    assert [c.name for c in compared] == list(out["limits"])


def test_traced_run_reports_idle(tiny, monkeypatch):
    # no profiler trace of a device on the CPU: the reduction stands in,
    # and with no exported trace the decoder readers find nothing
    from ranbench.harness import trace as trace_mod

    def fake_exit(self, *exc):
        self.spans.annotate = False
        self.result = trace_mod.reduce_trace(
            [("k", 0.0, 5.0)], [("ranbench.traced", 0.0, 10.0)], (0.0, 10.0))
        return False
    monkeypatch.setattr(trace_mod.Profiled, "__enter__", lambda self: self)
    monkeypatch.setattr(trace_mod.Profiled, "__exit__", fake_exit)
    out, _ = _run(*tiny, trace=True)
    assert set(out["metrics"]) == {"device.idle_pct.harq"}
    assert out["correct"]


def test_control_is_caught(tiny):
    from ranbench.harness.cell import load_cell
    cell = load_cell(*tiny)
    got = cell.driver().control(cell, SEED, dispatches=2, device="cpu")
    assert not all(c.ok for c in got)


def test_combination_without_the_softbuffer_is_caught(tiny, monkeypatch):
    # the retransmission decoded alone: the combination fails
    from srsran_project_23_5_tpu_torch.phy.upper import harq
    monkeypatch.setattr(harq, "soft_combine",
                        lambda llr, prior, new_data=None: llr)
    out, _ = _run(*tiny)
    assert not out["correct"]
    assert out["limits"]["verdicts_differ"]["value"] > 0
    assert out["failed"] == out["attempted"]


def test_combined_buffer_on_the_truncated_graph_is_caught(tiny, monkeypatch):
    from srsran_project_23_5_tpu_torch.phy.upper import sch
    real = sch.decode_cbs

    def truncated(llr, cfg, iters=6):
        return real(llr, dataclasses.replace(cfg, rv=0), iters)
    monkeypatch.setattr(sch, "decode_cbs", truncated)
    out, _ = _run(*tiny)
    assert not out["correct"]
    assert out["limits"]["verdicts_differ"]["value"] > 0


def test_first_transmission_reported_passing_is_caught(tiny, monkeypatch):
    from srsran_project_23_5_tpu_torch.models import gnb_mixed
    real = gnb_mixed.harq_pair_batch

    def passing(payloads, noise, cfg, retx_rv=2):
        res = real(payloads, noise, cfg, retx_rv)
        res.first.ul0_ok = torch.ones_like(res.first.ul0_ok)
        return res
    monkeypatch.setattr(gnb_mixed, "harq_pair_batch", passing)
    out, _ = _run(*tiny)
    assert not out["correct"]
    assert out["limits"]["verdicts_differ"]["value"] > 0


def test_program_without_pairs_is_refused_first(tiny, monkeypatch):
    from srsran_project_23_5_tpu_torch.models import gnb_mixed
    from srsran_project_23_5_tpu_torch.phy import pipeline
    monkeypatch.delattr(gnb_mixed, "harq_pair_batch")
    built = []
    monkeypatch.setattr(pipeline.SlotPipeline, "__init__",
                        lambda *a, **k: built.append(1))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="harq_pair_batch"):
        _run(*tiny)
    assert not built and time.perf_counter() - t0 < 5.0


# ------------------------------------------- the decoder launches' readers
SHAPES = {"ldpc_dec": {"match": "ldpc_decode_kernel", "per_batch": [
              {"rows": 20, "z": 384, "base_graph": 1, "k": 8448,
               "n": 26112, "used_blocks": 35, "edges": 144, "sweeps": 6.0},
              {"rows": 8, "z": 352, "base_graph": 1, "k": 7744, "n": 23936,
               "used_blocks": 36, "edges": 150, "sweeps": 6.0}]},
          "ldpc_dec_full": {"match": "ldpc_decode_kernel", "per_batch": [
              {"rows": 20, "z": 384, "base_graph": 1, "k": 8448,
               "n": 26112, "used_blocks": 68, "edges": 316, "sweeps": 3.0},
              {"rows": 8, "z": 352, "base_graph": 1, "k": 7744, "n": 23936,
               "used_blocks": 68, "edges": 316, "sweeps": 3.0}]}}
# per batch: rv=0 x20, rv=0 x8, full x20, full x8 (shared memory, µs)
BATCH = ((20, 66816, 10.0), (8, 62000, 8.0), (20, 193536, 30.0),
         (8, 177408, 20.0))


def _trace(path, replays: int, with_smem: bool = True):
    """A trace of `replays` graph replays of K=2 batches in the window,
    after a replay that started before it."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "ranbench.traced",
           "ts": 1000.0, "dur": 1e6}]
    t = 500.0
    for r in range(replays + 1):
        corr = 100 + r
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
                   "ts": t, "dur": 5.0, "args": {"correlation": corr}})
        for _ in range(2):
            for grid, smem, dur in BATCH:
                args = {"grid": [grid, 1, 1], "correlation": corr}
                if with_smem:
                    args["shared memory"] = smem + 1024
                ev.append({"ph": "X", "cat": "kernel",
                           "name": "ldpc_decode_kernel<false>", "ts": t + 10,
                           "dur": dur, "args": args})
                t += dur + 1.0
        t = max(t, 1000.0 + 200.0 * (r + 1))
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": ev}))


def _records(full_rows: int, k: int = 2):
    """Tracer records: a capture whose warm-up and capture each ran K
    pair batches counting `full_rows` full-graph rows each."""
    rec = lambda i, name, parent, counts=None: types.SimpleNamespace(
        id=i, name=name, parent=parent, start_ns=i, counts=counts)
    out = [rec(1, "graphs.capture", None)]
    out += [rec(2 + j, "harq.pair", 1, {"ldpc.full_graph": full_rows,
                                         "harq.combined": 4})
            for j in range(2 * k)]
    return out


def _cell(tmp_path):
    return types.SimpleNamespace(root=tmp_path, traffic={
        "scan_batches": 2, "kernels": SHAPES})


@pytest.mark.parametrize("with_smem", [True, False])
def test_reader_tells_full_graph_launches(tmp_path, monkeypatch, with_smem):
    from ranbench.harness import roofline
    cell = _cell(tmp_path)
    _trace(program_trace.trace_path(cell), replays=3, with_smem=with_smem)
    monkeypatch.setattr(program_trace, "_records", lambda: _records(28))
    decoder_launches._LOADED.clear()
    out = Outcome(0, 0, {}, [], {}, Spans(), trace={"busy_s": 1.0})
    full = decoder_launches.roofline_pct(cell, out, full=True)
    rv0 = decoder_launches.roofline_pct(cell, out, full=False)
    per = {s["rows"]: roofline.decoder_least_seconds(s)
           for s in SHAPES["ldpc_dec_full"]["per_batch"]}
    # the replays in the window: 3 × 2 batches of each full shape
    assert full == pytest.approx(100.0 * 6 * (per[20] + per[8])
                                 / (6 * 50.0 * 1e-6))
    per = {s["rows"]: roofline.decoder_least_seconds(s)
           for s in SHAPES["ldpc_dec"]["per_batch"]}
    assert rv0 == pytest.approx(100.0 * 6 * (per[20] + per[8])
                                / (6 * 18.0 * 1e-6))


def test_reader_is_none_when_replays_miss_the_capture(tmp_path, monkeypatch):
    cell = _cell(tmp_path)
    _trace(program_trace.trace_path(cell), replays=2)
    out = Outcome(0, 0, {}, [], {}, Spans(), trace={"busy_s": 1.0})
    decoder_launches._LOADED.clear()
    monkeypatch.setattr(program_trace, "_records", lambda: _records(20))
    assert decoder_launches.roofline_pct(cell, out, full=True) is None
    monkeypatch.setattr(program_trace, "_records", lambda: [])
    assert decoder_launches.roofline_pct(cell, out, full=True) is None
    # the rv=0 share needs no count
    assert decoder_launches.roofline_pct(cell, out, full=False) is not None
