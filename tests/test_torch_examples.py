"""Parity of the port's examples (``srsran_project_23_5_tpu_torch/examples``)
with ``examples/`` at the repository root (CPU, small sizes):

- ``rrc_attach_demo``: the JAX example's output (run through ``runpy``)
  equals the port's line for line;
- ``radio_ssb`` at 20 slots, period 10: the same printed lines (slots sent,
  slots detected, PSS correlation, PBCH ok), and each detection's PSS
  correlation within 1e-3 of the JAX receiver's on the JAX example's own
  UL grids;
- ``phy_loopback`` at 24 PRB, 16QAM, 20 dB: the header (TBS) equal, and
  the JAX example's op sequence (``tx_slot`` → ``demodulate_slot`` →
  ``pusch_receive``) against the port's ``loopback`` on the same numpy
  noise: CRC equal, SINR within 0.05 dB, EVM within 1e-3 relative;
- ``mixed_slot_demo`` at 68 PRB: the TB sizes of the JAX
  ``default_mixed(68, 2, 0.5)``, the slot ok, the keys of the JAX
  ``mixed_slot_dict``;
- without ``--device`` and without a card, each PHY example raises.

The JAX receiver on the CPU decodes with its XLA decoder, so the loopback
is compared at 20 dB, where every codeblock converges.
"""
import contextlib
import dataclasses
import io
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from srsran_project_23_5_tpu.models import gnb_flagship, gnb_mixed
from srsran_project_23_5_tpu.phy.lower import lower_phy as jlower
from srsran_project_23_5_tpu.phy.lower import ofdm
from srsran_project_23_5_tpu.phy.upper import sch, ssb
from srsran_project_23_5_tpu.ran import numerology, tbs as jtbs
from srsran_project_23_5_tpu_torch.examples import (mixed_slot_demo,
                                                    phy_loopback, radio_ssb,
                                                    rrc_attach_demo)
from srsran_project_23_5_tpu_torch.models import fapi_carrier

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _run_jax_example(name: str, argv: list[str]) -> list[str]:
    """The printed lines of ``examples/<name>.py`` run as a script."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [name + ".py", *argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(REPO / "examples" / f"{name}.py"),
                           run_name="__main__")
    finally:
        sys.argv = saved
    return out.getvalue().splitlines()


def _run_port(main, argv: list[str]) -> tuple[dict, list[str]]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(argv)
    return res, out.getvalue().splitlines()


def test_rrc_attach_demo_prints_what_jax_prints():
    want = _run_jax_example("rrc_attach_demo", [])
    res, got = _run_port(rrc_attach_demo.main, [])
    assert got == want
    assert res["gnb_state"] == "active" and res["ue_drbs"] == [(1, 4)]
    assert len(res["messages"]["RRCSetupRequest (UL-CCCH, Msg3)"]) == 6


def test_radio_ssb_matches_jax(monkeypatch):
    """Both examples at 20 slots, SSB period 10, on the same host noise."""
    argv = ["--slots", "20", "--period", "10"]
    grids = {}

    class Recording(jlower.AsyncLowerPhy):
        def __init__(self, cfg, dl_grid, ul_grid, **kw):
            def keep(slot, grid):
                grids[slot] = np.asarray(grid)
                ul_grid(slot, grid)
            super().__init__(cfg, dl_grid, keep, **kw)
    monkeypatch.setattr(jlower, "AsyncLowerPhy", Recording)
    want = _run_jax_example("radio_ssb", argv)
    res, got = _run_port(radio_ssb.main, argv + ["--device", "cpu"])
    assert got == want
    assert res["tx_slots"] == [0, 10]
    assert [s for s, _, _ in res["found"]] == res["tx_slots"]
    assert all(ok for _, _, ok in res["found"])
    # the JAX receiver's correlation on the JAX example's UL grids
    cfg = jlower.LowerPhyConfig(mu=1, nfft=512, nof_prb=24)
    k0 = (cfg.nsc - 240) // 2
    pss = ssb.pss_sequence(ssb.SsbConfig(pci=123).nid2)
    for slot, corr, _ in res["found"]:
        win = grids[slot][2, k0 + 56:k0 + 183]
        want_corr = abs(np.vdot(pss, win)) / (np.linalg.norm(win)
                                              * np.linalg.norm(pss) + 1e-12)
        assert abs(corr - want_corr) <= 1e-3, (slot, corr, want_corr)


def test_phy_loopback_matches_jax_op_sequence():
    """The header, then two slots of the JAX example's op sequence against
    the port's ``loopback`` on the same TBs and numpy noise."""
    prb, qm, rate, snr = 24, 4, 0.5, 20.0
    res, lines = _run_port(phy_loopback.main, [
        "--prb", str(prb), "--qm", str(qm), "--snr-db", str(snr),
        "--slots", "2", "--device", "cpu"])
    tbs = jtbs.tbs_calculate(14, 36, 0, rate, qm, 1, prb)
    assert lines[0] == (f"carrier: {prb} PRB, Qm {qm}, TBS {tbs} bits, "
                        f"SNR {snr} dB")
    assert res["tbs"] == tbs and all(ok for ok, _, _ in res["slots"])

    jcfg = gnb_flagship.CarrierConfig(
        mu=1, nfft=numerology.min_nfft(prb), nof_prb=prb,
        sh=sch.ShConfig(rnti=0x4601, tbs=tbs, qm=qm, nof_prb=prb,
                        dmrs_symbols=(2, 7, 11)))

    @jax.jit
    def jax_slot(tb, noise):
        bb = gnb_flagship.tx_slot(tb, jcfg)
        grid = ofdm.demodulate_slot(bb + noise, jcfg.nsc, jcfg.mu, jcfg.nfft)
        r = sch.pusch_receive(grid[None], jcfg.sh, 8)
        return r.tb_crc_ok, r.sinr_db, r.evm

    tcfg = phy_loopback.carrier(prb, qm, rate)
    samples = numerology.slot_num_samples(jcfg.mu, jcfg.nfft)
    assert tcfg.sh.tbs == tbs and tcfg.slot_samples == samples
    sigma = fapi_carrier.noise_sigma(tcfg, snr)
    rng = np.random.default_rng(11)
    for _ in range(2):
        tb = rng.integers(0, 2, size=tbs).astype(np.int8)
        noise = (sigma * (rng.standard_normal(samples)
                          + 1j * rng.standard_normal(samples))
                 ).astype(np.complex64)
        j_ok, j_sinr, j_evm = (np.asarray(x) for x in jax_slot(tb, noise))
        ok, sinr, evm = phy_loopback.loopback(
            torch.from_numpy(tb), torch.from_numpy(noise), tcfg)
        assert bool(ok) == bool(j_ok) is True
        assert abs(float(sinr) - float(j_sinr)) <= 0.05
        assert abs(float(evm) - float(j_evm)) <= 1e-3 * float(j_evm)


def test_mixed_slot_demo_at_68_prb():
    res, lines = _run_port(mixed_slot_demo.main, ["--device", "cpu"])
    jcfg = gnb_mixed.default_mixed(68, 2, 0.5)
    assert lines[0] == (
        f"68 PRB mixed slot on cpu: DL TBs {jcfg.pdsch0.tbs}+"
        f"{jcfg.pdsch1.tbs} b (UE0 2-layer), UL TBs {jcfg.pusch0.tbs}+"
        f"{jcfg.pusch1.tbs} b (UE0 2x2)")
    assert bool(res["out"]["ok"])
    assert set(res["out"]) == {
        f.name for f in dataclasses.fields(gnb_mixed.MixedSlotResult)}
    assert lines[-1] == "all channels verified OK"


@pytest.mark.parametrize("example", [radio_ssb, phy_loopback,
                                     mixed_slot_demo])
def test_phy_examples_default_to_the_card(example, monkeypatch):
    """Without --device an example runs on the current CUDA device; where
    there is none it raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
