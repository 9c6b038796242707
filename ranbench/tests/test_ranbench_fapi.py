"""The ``fapi_tdd`` driver end to end at 68 PRB on the CPU, as a cell added
from files in a temporary directory: a sound run over the TDD pattern is
correct; the control (the reference in bfloat16) and an indication altered
where it is produced, in every UL slot or in one outside the sample, come
out not correct."""
import json
import time

import numpy as np
import pytest

from conftest import write_cell
from ranbench.harness import runner

TINY = {"args": {"nof_prb": 68}, "precision": "float32"}
TRAFFIC = {"driver": "fapi_tdd", "pattern": "DDSUU", "full_ul": 3,
           "periods": 1, "sample_dl": 2, "sample_ul": 2, "trace_slots": 4,
           "limits": {"verdicts_differ": 0, "sinr_gap_db": 0.001,
                      "ta_gap_samples": 0.0001, "level_gap": 0.0001,
                      "dl_grid_gap": 0.0001}}
E2E = [{"name": "fapi_slot_ms", "unit": "ms", "better": "lower",
        "bound": 0.05, "source": "host_clock"},
       {"name": "fapi_slot_ms_p95", "unit": "ms", "better": "lower",
        "bound": 0.05, "source": "host_clock"},
       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
        "source": "host_clock"}]
PER_LAYER = [{"name": "fapi.translate_ms", "unit": "ms", "better": "lower",
              "source": "host_clock", "layer": "FAPI front",
              "moves": "fapi_slot_ms"},
             {"name": "upper_phy.ul_slot_ms", "unit": "ms", "better": "lower",
              "source": "host_clock", "layer": "upper PHY",
              "moves": "fapi_slot_ms_p95"}]
SEED = 2**31 + 99


@pytest.fixture
def tiny(tmp_path):
    name = write_cell(tmp_path, config="tiny_fapi", traffic="tdd",
                      config_body=TINY, traffic_body=TRAFFIC,
                      end_to_end=E2E, per_layer=PER_LAYER)
    return tmp_path, name


@pytest.fixture
def unsampled(tmp_path):
    name = write_cell(tmp_path, config="tiny_fapi", traffic="tdd",
                      config_body=TINY,
                      traffic_body=dict(TRAFFIC, sample_ul=0),
                      end_to_end=E2E, per_layer=PER_LAYER)
    return tmp_path, name


def _run(root, name):
    line, _ = runner.run_cell(root, name, SEED, 0.3, False,
                              time.perf_counter(), device="cpu")
    return json.loads(line)


def test_sound_fapi_run_is_correct(tiny):
    out = _run(*tiny)
    assert out["correct"], out["limits"]
    assert out["failed"] == 0 and out["attempted"] >= 4
    assert set(out["metrics"]) == {"fapi_slot_ms", "fapi_slot_ms_p95",
                                   "setup_s"}


def test_fapi_control_is_caught(tiny):
    from ranbench.harness.cell import load_cell
    cell = load_cell(*tiny)
    got = cell.driver().control(cell, SEED, device="cpu")
    assert not all(c.ok for c in got)


def test_altered_pucch_bit_is_caught(tiny, monkeypatch):
    from srsran_project_23_5_tpu_torch.phy.upper import upper_phy
    real = upper_phy.UpperPhy.process_ul_slot

    def altered(self, *args, **kw):
        inds = real(self, *args, **kw)
        for i in inds:
            if type(i).__name__ == "UciIndication" and i.harq_bits is not None:
                i.harq_bits = 1 - np.asarray(i.harq_bits)
        return inds
    monkeypatch.setattr(upper_phy.UpperPhy, "process_ul_slot", altered)
    out = _run(*tiny)
    assert not out["correct"] and out["failed"] > 0


def test_altered_slot_outside_the_sample_is_caught(unsampled, monkeypatch):
    # one UL slot of the window sends back a wrong RxData payload; no UL
    # slot is drawn for the sample, so only its own miss brings it there
    from srsran_project_23_5_tpu_torch.phy.upper import upper_phy
    real = upper_phy.UpperPhy.process_ul_slot
    calls = []

    def altered(self, *args, **kw):
        inds = real(self, *args, **kw)
        calls.append(1)
        if len(calls) == 4:        # the setup pass takes the first two
            for i in inds:
                if type(i).__name__ == "RxDataIndication":
                    i.payload = 1 - np.asarray(i.payload)
        return inds
    monkeypatch.setattr(upper_phy.UpperPhy, "process_ul_slot", altered)
    out = _run(*unsampled)
    assert out["failed"] == 1
    assert not out["correct"]
    assert out["limits"]["verdicts_differ"]["value"] == 1
