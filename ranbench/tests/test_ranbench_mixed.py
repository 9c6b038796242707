"""The ``scan_mixed`` driver end to end at 68 PRB on the CPU, as a cell
added from files in a temporary directory: a sound run is correct and its
result line has exactly the contract's keys; the control (the reference in
bfloat16) and each fault the cell can have (a decoded bit altered where it
is produced, with the program's TB verdict intact or blind to it, half of
each batch left out) come out not correct."""
import json
import time

import pytest
import torch

from conftest import write_cell
from ranbench.harness import runner

TINY = {"args": {"nof_prb": 68, "qm": 2, "rate": 0.5}, "precision": "float32"}
TRAFFIC = {"driver": "scan_mixed", "slots_per_batch": 2, "scan_batches": 2,
           "trace_dispatches": 1,
           "limits": {"verdicts_differ": 0, "sinr_gap_db": 0.001,
                      "rel_gap": 0.0001}}
E2E = [{"name": "mixed_slot_us", "unit": "us", "better": "lower",
        "bound": 0.05, "source": "host_clock"},
       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
        "source": "host_clock"}]
PER_LAYER = [{"name": "pipeline.enqueue_ms", "unit": "ms", "better": "lower",
              "source": "host_clock", "layer": "slot pipeline",
              "moves": "mixed_slot_us"}]
SEED = 2**31 + 12345


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    from ranbench.harness.cell import load_cell
    name = write_cell(tmp_path, config="tiny_mixed", traffic="b2",
                      config_body=TINY, traffic_body=TRAFFIC,
                      end_to_end=E2E, per_layer=PER_LAYER)
    driver = load_cell(tmp_path, name).driver()
    monkeypatch.setattr(driver, "PAYLOAD_SETS", 2)
    monkeypatch.setattr(driver, "SAMPLE_SLOTS", 3)
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
    assert out["attempted"] % 4 == 0 and out["attempted"] >= 4
    assert set(out["metrics"]) == {"mixed_slot_us", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert [c.name for c in compared] == list(out["limits"])


def test_traced_run_reports_per_layer(tiny, monkeypatch):
    # no profiler trace of a device on the CPU: the reduction stands in
    from ranbench.harness import trace as trace_mod

    def fake_exit(self, *exc):
        self.spans.annotate = False
        self.result = trace_mod.reduce_trace(
            [("k", 0.0, 5.0)], [("ranbench.traced", 0.0, 10.0)], (0.0, 10.0))
        return False
    monkeypatch.setattr(trace_mod.Profiled, "__enter__", lambda self: self)
    monkeypatch.setattr(trace_mod.Profiled, "__exit__", fake_exit)
    out, _ = _run(*tiny, trace=True)
    assert list(out)[-2:] == ["breakdown", "limits"]
    assert set(out["metrics"]) == {"pipeline.enqueue_ms"}
    assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
    assert out["correct"]


def test_control_is_caught(tiny):
    from ranbench.harness.cell import load_cell
    cell = load_cell(*tiny)
    got = cell.driver().control(cell, SEED, dispatches=2, device="cpu")
    assert not all(c.ok for c in got)


def test_altered_decoded_bit_is_caught(tiny, monkeypatch):
    from srsran_project_23_5_tpu_torch.phy.upper import sch
    real = sch.decode_cbs

    def flipped(llr, cfg, iters=6):
        bits, ok = real(llr, cfg, iters)
        bits = bits.clone()
        bits[0, 0, 0] ^= 1
        return bits, ok
    monkeypatch.setattr(sch, "decode_cbs", flipped)
    out, _ = _run(*tiny)
    assert not out["correct"]
    assert out["limits"]["verdicts_differ"]["value"] > 0


def test_decoded_bit_the_verdict_misses_is_caught(tiny, monkeypatch):
    # a decoded bit altered and the program's TB verdict blind to it: the
    # verdicts agree with the reference, the decoded TB's bit errors do not
    from srsran_project_23_5_tpu_torch.models import gnb_mixed
    from srsran_project_23_5_tpu_torch.phy.upper import sch
    real = sch.decode_cbs

    def flipped(llr, cfg, iters=6):
        bits, ok = real(llr, cfg, iters)
        bits = bits.clone()
        bits[:, 0, 0] ^= 1
        return bits, ok
    monkeypatch.setattr(sch, "decode_cbs", flipped)
    monkeypatch.setattr(gnb_mixed, "_tb_ok", lambda dec, sh, tb: torch.ones(
        tb.shape[0], dtype=torch.bool, device=tb.device))
    out, _ = _run(*tiny)
    assert not out["correct"]
    assert out["limits"]["verdicts_differ"]["value"] > 0
    assert out["failed"] == out["attempted"]


def test_half_batch_left_out_is_caught(tiny, monkeypatch):
    from srsran_project_23_5_tpu_torch.models import gnb_mixed
    real = gnb_mixed.mixed_slot_batch

    def half(payloads, ndl, nul, cfg):
        h = ndl.shape[0] // 2
        res = real({k: v[:h] for k, v in payloads.items()}, ndl[:h],
                   nul[:h], cfg)
        for f in vars(res):
            v = getattr(res, f)
            setattr(res, f, torch.cat([v, v]))
        return res
    monkeypatch.setattr(gnb_mixed, "mixed_slot_batch", half)
    # one dispatch of 4 slots, all of them in the sample of 3 and the
    # failed ones
    out, _ = _run(*tiny, seconds=0.01)
    assert not out["correct"]


@pytest.mark.cuda
def test_card_cell_runs(card):
    """The b8 cell for two seconds on the card (the chip only)."""
    from ranbench.harness.cell import BENCH_DIR
    line, _ = runner.run_cell(BENCH_DIR.parent, "mixed273.b8", SEED, 2.0,
                              False, time.perf_counter())
    assert json.loads(line)["correct"]
