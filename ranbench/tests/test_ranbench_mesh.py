"""The ``carrier_mesh`` driver end to end at 68 PRB (QPSK, LDPC base graph
2) on the CPU, as a cell added from files in a temporary directory, with
two gloo ranks: a sound run is correct and its result line has exactly the
contract's keys; the control (the reference in bfloat16) and each fault
the cell can have (two ranks' parts of the gather swapped, half the
carriers left out, a decoded bit altered with its CRC verdict intact) come
out not correct.  A fault is put into the spawned ranks by a rank program
of this file that patches the program there, then runs the driver's."""
import functools
import json
import time

import pytest
import torch

from conftest import write_cell
from ranbench.harness import runner

TBS_68 = 4360      # TS 38.214 5.1.3.2 at 68 PRB, QPSK MCS 3: BG2, 2 CBs
TINY = {"model": "gnb_flagship.default_carrier",
        "args": {"nof_prb": 68, "qm": 2, "tbs": TBS_68},
        "nof_ldpc_iterations": 6, "snr_db": 5.0, "precision": "float32"}
TRAFFIC = {"driver": "carrier_mesh", "ranks": 2, "carriers": 4,
           "trace_steps": 1,
           "limits": {"verdicts_differ": 0, "sinr_gap_db": 0.001}}
E2E = [{"name": "mixed_slot_us", "unit": "us", "better": "lower",
        "bound": 0.2, "source": "host_clock"},
       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
        "source": "host_clock"}]
PER_LAYER = [{"name": "device.idle_pct.mesh", "unit": "%",
              "better": "lower", "source": "device_trace",
              "layer": "device", "moves": "mixed_slot_us"}]
SEED = 2**31 + 4321


@pytest.fixture
def tiny(tmp_path):
    name = write_cell(tmp_path, config="tiny_flagship", traffic="mesh2",
                      config_body=TINY, traffic_body=TRAFFIC,
                      end_to_end=E2E, per_layer=PER_LAYER)
    return tmp_path, name


def _run(root, name, trace=False, seconds=0.2):
    line, compared = runner.run_cell(root, name, SEED, seconds, trace,
                                     time.perf_counter(), device="cpu")
    return json.loads(line), compared


def faulty_rank(fault: str, rank, device, spec):
    """The driver's rank program with `fault` put into the program."""
    from ranbench.drivers.carrier_mesh import rank_main
    from srsran_project_23_5_tpu_torch.models import gnb_flagship
    from srsran_project_23_5_tpu_torch.parallel import mesh as mesh_lib
    if fault == "swap":
        real_gather = mesh_lib.Sharding.gather

        def swapped(self, y):
            out = real_gather(self, y)
            h = out.shape[0] // 2
            return torch.cat([out[h:], out[:h]])
        mesh_lib.Sharding.gather = swapped
    real = gnb_flagship.loopback_batch
    if fault == "half":
        def half(tb, noise, cfg, iters=6):
            h = tb.shape[0] // 2
            ok, bits, sinr = real(tb[:h], noise[:h], cfg, iters)
            return (torch.cat([ok, ok]), torch.cat([bits, bits]),
                    torch.cat([sinr, sinr]))
        gnb_flagship.loopback_batch = half
    if fault == "bit":
        def flipped(tb, noise, cfg, iters=6):
            ok, bits, sinr = real(tb, noise, cfg, iters)
            bits = bits.clone()
            bits[:, 0] ^= 1
            return ok, bits, sinr
        gnb_flagship.loopback_batch = flipped
    return rank_main(rank, device, spec)


def _with_fault(monkeypatch, root, name, fault):
    from ranbench.harness.cell import load_cell
    driver = load_cell(root, name).driver()
    monkeypatch.setattr(driver, "rank_program",
                        lambda: functools.partial(faulty_rank, fault))


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
    assert out["device"]["count"] == 2
    assert [c.name for c in compared] == list(out["limits"])
    assert out["limits"]["verdicts_differ"]["value"] == 0


def test_traced_run_reports_per_layer(tiny, monkeypatch):
    # no device trace on the CPU: rank 0's stretch reduces a stand-in; the
    # rank imports the trace module afresh, so the stand-in goes in there
    out, _ = _run(*tiny, trace=True)
    assert list(out)[-2:] == ["breakdown", "limits"]
    assert out["correct"]
    assert out["device"]["window_s"] > 0


def test_control_is_caught(tiny):
    from ranbench.harness.cell import load_cell
    cell = load_cell(*tiny)
    got = cell.driver().control(cell, SEED, steps=1, device="cpu")
    assert not all(c.ok for c in got)


@pytest.mark.parametrize("fault", ["swap", "half", "bit"])
def test_fault_is_caught(tiny, monkeypatch, fault):
    _with_fault(monkeypatch, *tiny, fault)
    out, _ = _run(*tiny)
    assert not out["correct"]
    if fault == "bit":
        # the program's verdict holds, its decoded bits do not
        assert out["failed"] == out["attempted"]
        assert out["limits"]["verdicts_differ"]["value"] > 0


def test_program_without_bit_errors_is_refused(tiny, monkeypatch):
    """A program whose carrier step returns no bit errors is refused in the
    parent, before any rank is spawned."""
    from srsran_project_23_5_tpu_torch.models import gnb_flagship
    from srsran_project_23_5_tpu_torch.parallel import launch
    real = gnb_flagship.multi_carrier_step
    monkeypatch.setattr(gnb_flagship, "multi_carrier_step",
                        lambda cfg, it=6: lambda tb, nz: real(cfg, it)(
                            tb, nz)[:2])

    def no_spawn(*a, **k):
        raise AssertionError("spawned")
    monkeypatch.setattr(launch, "spawn", no_spawn)
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="no per-carrier bit_errors"):
        _run(*tiny)
    assert time.perf_counter() - t < 30


def test_kernel_shapes_at_the_cell_shape(tiny):
    from ranbench.harness.cell import load_cell
    cell = load_cell(*tiny)
    got = cell.driver().kernel_shapes(cell, SEED, device="cpu")
    dec, = got["ldpc_dec"]["per_batch"]
    enc, = got["ldpc_enc"]["per_batch"]
    assert dec["rows"] == enc["rows"] == 2 * 2   # 2 carriers a rank, 2 CBs
    assert dec["base_graph"] == 2 and dec["z"] == 224
    assert 1.0 <= dec["sweeps"] <= 6.0


def test_reference_flagship_loads_nothing_of_the_program():
    import subprocess
    import sys
    from conftest import CHECKOUT
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import ranbench.reference.models.gnb_flagship\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
            % str(CHECKOUT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    tops = set(out.stdout.split())
    assert "srsran_project_23_5_tpu_torch" not in tops
    assert not tops & {"jax", "jaxlib", "flax", "srsran_project_23_5_tpu"}
