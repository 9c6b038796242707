"""Parity of the port's FAPI-driven upper PHY (``UpperPhy``, slot programs,
HARQ softbuffers) with the JAX package (CPU).

The JAX requests are carried over with ``convert.from_jax_message`` so both
packages get the same requests, and the same numpy rx grids.  Indications
are compared field by field: verdicts, bits and preamble indices equal,
SINR within 0.05 dB, TA within 0.05 samples, detection metrics within 1e-4
relative, HARQ-combined LLRs within 1e-4 of max|ref|.  The JAX receiver on
the CPU decodes with its XLA decoder, so decoded bits are compared where
every codeblock converges (or, for the failing first transmission, where
both verdicts agree).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srsran_project_23_5_tpu.fapi import messages as fapi
from srsran_project_23_5_tpu.ops import prach as prach_ops
from srsran_project_23_5_tpu.phy.upper import (pucch, sch, slot_programs,
                                               ulsch, upper_phy)
from srsran_project_23_5_tpu.phy.upper.csi_rs import CsiRsConfig
from srsran_project_23_5_tpu.phy.upper.pdcch import PdcchConfig
from srsran_project_23_5_tpu.phy.upper.ssb import SsbConfig
from srsran_project_23_5_tpu.ran import tbs as tbs_mod
from srsran_project_23_5_tpu_torch import convert
from srsran_project_23_5_tpu_torch.fapi import messages as tfapi
from srsran_project_23_5_tpu_torch.phy.upper import harq as tharq
from srsran_project_23_5_tpu_torch.phy.upper import sch as tsch
from srsran_project_23_5_tpu_torch.phy.upper import \
    slot_programs as tslot_programs
from srsran_project_23_5_tpu_torch.phy.upper import upper_phy as tupper_phy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _phys(nof_prb, bucketed=True, **kw):
    jcfg = upper_phy.UpperPhyConfig(nof_prb=nof_prb, bucketed=bucketed, **kw)
    return (upper_phy.UpperPhy(jcfg),
            tupper_phy.UpperPhy(convert.from_jax_upper_phy(jcfg), "cpu"))


def _awgn(rng, shape, sigma):
    return (sigma / np.sqrt(2) * (rng.standard_normal(shape)
                                  + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def _ul(jphy, tphy, rx, req, slot_count=0, prach_rx=None):
    """The same slot through both packages → (JAX, port) indications."""
    want = jphy.process_ul_slot(
        jnp.asarray(rx), req, slot_count=slot_count,
        prach_rx=None if prach_rx is None else jnp.asarray(prach_rx))
    got = tphy.process_ul_slot(
        torch.from_numpy(rx), convert.from_jax_message(req),
        slot_count=slot_count,
        prach_rx=None if prach_rx is None else torch.from_numpy(prach_rx))
    return want, got


def _assert_same_indications(got, want):
    assert [type(i).__name__ for i in got] == [type(i).__name__ for i in want]
    for g, w in zip(got, want):
        assert type(g) is getattr(tfapi, type(w).__name__)
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if f.name == "sinr_db":
                assert abs(a - b) < 0.05, (f.name, a, b)
            elif f.name == "ta_samples":
                assert abs(a - b) < 0.05, (f.name, a, b)
            elif f.name == "metric":
                assert abs(a - b) <= 1e-4 * max(abs(b), 1.0), (a, b)
            elif f.name == "preambles":
                assert [p[0] for p in a] == [p[0] for p in b]
                for pa, pb in zip(a, b):
                    assert abs(pa[1] - pb[1]) <= 1e-4 * pb[1]
                    assert abs(pa[2] - pb[2]) < 1e-3
            elif isinstance(b, np.ndarray) or f.name in ("payload",
                                                         "harq_bits",
                                                         "uci_bits"):
                assert (a is None) == (b is None), f.name
                if b is not None:
                    assert np.array_equal(np.asarray(a), np.asarray(b)), \
                        f.name
            else:
                assert a == b, (f.name, a, b)


# ------------------------------------------------------------ downlink
def _dl_request(rng, slot):
    sh = sch.ShConfig(rnti=0x100, tbs=1608, qm=2, prb_start=30, nof_prb=20,
                      dmrs_symbols=(2, 7, 11), slot_in_frame=slot,
                      reserved_patterns=((5, (0,)),))
    sh2 = sch.ShConfig(rnti=0x101, tbs=1032, qm=4, prb_start=2, nof_prb=8,
                       first_symbol=1, nof_symbols=13, slot_in_frame=slot,
                       vrb_to_prb_interleaved=True, bwp_nof_prb=12)
    req = fapi.DlTtiRequest(
        sfn=0, slot=slot,
        ssb_pdus=[fapi.SsbPdu(SsbConfig(pci=7),
                              rng.integers(0, 2, 32).astype(np.int8), 12)],
        pdcch_pdus=[fapi.PdcchPdu(
            PdcchConfig(rnti=0x100, payload_size=30, aggregation_level=2,
                        coreset_start_prb=0, start_symbol=0),
            rng.integers(0, 2, 30).astype(np.int8))],
        pdsch_pdus=[fapi.PdschPdu(sh), fapi.PdschPdu(sh2)],
        csi_rs_pdus=[fapi.CsiRsPdu(CsiRsConfig(row=2, prb_start=30,
                                               nof_prb=20, symbol=5))])
    data = fapi.TxDataRequest(0, slot, [
        rng.integers(0, 2, p.config.tbs).astype(np.int8)
        for p in req.pdsch_pdus])
    return req, data


@pytest.mark.parametrize("bucketed", [True, False])
def test_dl_slot_assembly_matches(bucketed):
    """SSB + PDCCH + 2×PDSCH (one VRB-interleaved, one with the CSI-RS RE
    reserved) + CSI-RS on a 52-PRB grid, two slots of one signature: grids
    within 1e-5 of max|ref|."""
    rng = np.random.default_rng(0)
    jphy, tphy = _phys(52, bucketed)
    for slot in (0, 3):
        req, data = _dl_request(rng, slot)
        want = np.asarray(jphy.process_dl_slot(req, data))
        got = tphy.process_dl_slot(convert.from_jax_message(req),
                                   convert.from_jax_message(data))
        assert got.shape == (14, 52 * 12) and got.dtype == torch.complex64
        assert (np.abs(want) > 0).sum() > 1000
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-5, err
    if bucketed:
        assert tphy.dl_programs.nof_compiled == 1
        assert jphy.dl_programs.nof_compiled == 1


# ------------------------------------------------------------ HARQ
@pytest.mark.parametrize("bucketed,rv", [(True, 0), (False, 0), (True, 2),
                                        (False, 2)])
def test_ul_harq_retransmission_matches(bucketed, rv):
    """First transmission at −2 dB fails; the retransmission (rv 0, or rv 2
    on the full graph) combines and passes, in both packages, with the same
    indications and softbuffers."""
    rng = np.random.default_rng(1)
    jphy, tphy = _phys(24, bucketed)
    sh = sch.ShConfig(rnti=0x200, tbs=1608, qm=2, nof_prb=24,
                      dmrs_symbols=(2, 7, 11), slot_in_frame=1)
    tb = rng.integers(0, 2, sh.tbs).astype(np.int8)

    def rx_at(cfg, snr_db):
        clean = np.asarray(sch.pdsch_transmit(
            jnp.asarray(tb), cfg, jnp.zeros((14, 288), jnp.complex64)))
        return (clean[None] + _awgn(rng, (1, 14, 288), 10 ** (-snr_db / 20))
                ).astype(np.complex64)

    req1 = fapi.UlTtiRequest(0, 1, pusch_pdus=[
        fapi.PuschPdu(sh, harq_process=3, new_data=True)])
    want, got = _ul(jphy, tphy, rx_at(sh, -2.0), req1, slot_count=0)
    _assert_same_indications(got, want)
    assert not got[0].tb_crc_ok and len(tphy.softbuffers) == 1
    prior_t = tphy.softbuffers.get(0x200, 3)
    prior_j = np.asarray(jphy.softbuffers.get(0x200, 3))
    assert tuple(prior_t.shape) == tsch.llr_full_shape(
        convert.from_jax_sh(sh))
    assert (np.abs(prior_t.numpy() - prior_j).max()
            <= 1e-4 * np.abs(prior_j).max())

    sh2 = dataclasses.replace(sh, slot_in_frame=2, rv=rv)
    req2 = fapi.UlTtiRequest(0, 2, pusch_pdus=[
        fapi.PuschPdu(sh2, harq_process=3, new_data=False)])
    rx2 = rx_at(sh2, -2.0)
    if bucketed:
        # the combined LLRs of the program, before the softbuffer is
        # released: where(new_data, llr, llr + prior) on both sides
        sig = slot_programs.signature(req2)
        w_out = jphy.ul_programs.get(sig)(
            jnp.asarray(rx2), (jnp.asarray(prior_j),), (jnp.bool_(False),),
            jnp.zeros((1, 139), jnp.complex64),
            (slot_programs.pusch_cinits(sh2),), ())
        treq2 = convert.from_jax_message(req2)
        t_out = tphy.ul_programs.get(tslot_programs.signature(treq2))(
            torch.from_numpy(rx2), (prior_t,), (torch.tensor(False),),
            torch.zeros((1, 139), dtype=torch.complex64),
            (tslot_programs.pusch_cinits(treq2.pusch_pdus[0].config),), ())
        w_llr = np.asarray(w_out["pusch"][0]["combined_llr"])
        t_llr = t_out["pusch"][0]["combined_llr"].numpy()
        assert np.abs(t_llr - w_llr).max() <= 1e-4 * np.abs(w_llr).max()
    want, got = _ul(jphy, tphy, rx2, req2, slot_count=1)
    _assert_same_indications(got, want)
    assert got[-1].tb_crc_ok
    rxd = [i for i in got if isinstance(i, tfapi.RxDataIndication)][0]
    assert np.array_equal(rxd.payload, tb)
    assert len(tphy.softbuffers) == 0 and len(jphy.softbuffers) == 0
    if bucketed:
        assert tphy.ul_programs.nof_compiled == jphy.ul_programs.nof_compiled


def test_softbuffer_expiry_matches():
    jpool, tpool = upper_phy.SoftbufferPool(expiry_slots=5), \
        tharq.SoftbufferPool(expiry_slots=5)
    for pool, z in ((jpool, jnp.zeros((1, 100))), (tpool, torch.zeros(1, 100))):
        pool.combine(1, 0, z, True, slot_count=0)
        combined = pool.combine(1, 0, z + 1, False, slot_count=1)
        assert float(combined.sum()) == 100.0
        assert len(pool) == 1
        pool.run_slot(5)
        assert len(pool) == 1
        pool.run_slot(6)
        assert len(pool) == 0


# ------------------------------------------------------------ PUCCH + PRACH
def test_ul_pucch_f1_f2_and_prach_matches():
    """PUCCH F1 and F2 of a slot other than 0, a long-format PRACH window
    and a short one whose 64 preambles span several roots."""
    rng = np.random.default_rng(2)
    jphy, tphy = _phys(24, nfft=512)
    f1 = pucch.PucchF1Config(prb=0, nof_symbols=14, nof_harq_bits=1,
                             slot_in_frame=4)
    f2 = pucch.PucchF2Config(prb_start=20, nof_prb=4, start_symbol=12,
                             rnti=0x77, nof_uci_bits=7, slot_in_frame=4)
    uci = rng.integers(0, 2, 7).astype(np.int8)
    grid = pucch.pucch_f1_transmit(jnp.asarray([1], jnp.int8), f1,
                                   jnp.zeros((14, 288), jnp.complex64))
    grid = pucch.pucch_f2_transmit(jnp.asarray(uci), f2, grid)
    rx = (np.asarray(grid)[None].repeat(2, axis=0)
          + _awgn(rng, (2, 14, 288), 0.14)).astype(np.complex64)
    for length, root, pre in ((839, 11, 4), (139, 22, 37)):
        ns = prach_ops.num_shifts(length, 13)
        tx_pre = prach_ops.generate(root + pre // ns, pre % ns, length, 13)
        prach_rx = (tx_pre[None] + _awgn(rng, (2, length), 0.07)
                    ).astype(np.complex64)
        req = fapi.UlTtiRequest(
            0, 4, prach_pdus=[fapi.PrachPdu(root_sequence_index=root,
                                            length=length)],
            pucch_pdus=[fapi.PucchPdu(format1=f1, rnti=0x66, harq_pid=2),
                        fapi.PucchPdu(format2=f2)])
        want, got = _ul(jphy, tphy, rx, req, slot_count=4, prach_rx=prach_rx)
        _assert_same_indications(got, want)
        uci_f1, uci_f2, rach = got
        assert uci_f1.detected and uci_f1.harq_bits.ravel()[0] == 1
        assert uci_f2.detected and np.array_equal(uci_f2.uci_bits, uci)
        assert [p[0] for p in rach.preambles] == [pre]


# ------------------------------------------------------------ bucketing
NOF_PRB = 36
NSC = NOF_PRB * 12


def _sh(rnti, prb_start, nof_prb, qm=2, rate=0.5, **kw):
    bits = tbs_mod.tbs_calculate(14, 36, 0, rate, qm, 1, nof_prb)
    return sch.ShConfig(rnti=rnti, tbs=bits, qm=qm, prb_start=prb_start,
                        nof_prb=nof_prb, dmrs_symbols=(2, 7, 11), **kw)


def _tx_slot(rng, pdus, f1_cfgs, acks):
    grid = jnp.zeros((14, NSC), jnp.complex64)
    tbs = []
    for pdu in pdus:
        tb = rng.integers(0, 2, pdu.config.tbs).astype(np.int8)
        tbs.append(tb)
        grid = sch.pusch_transmit(jnp.asarray(tb), pdu.config, grid)
    for cfg, ack in zip(f1_cfgs, acks):
        grid = pucch.pucch_f1_transmit(jnp.asarray([ack], jnp.int8), cfg,
                                       grid)
    return ((np.asarray(grid)[None] + _awgn(rng, (1, 14, NSC), 0.02))
            .astype(np.complex64), tbs)


def test_mixed_traffic_nine_slots_three_programs_matches():
    """Nine slots rotating three PDU mixes (rnti, slot and payloads change
    every slot) compile three programs in each package, with the same
    indications slot by slot."""
    rng = np.random.default_rng(3)
    jphy, tphy = _phys(NOF_PRB)
    bucket_a = [_sh(0x10, 0, 8), _sh(0x11, 8, 8)]
    bucket_b = [_sh(0x12, 16, 16)]
    for slot in range(9):
        if slot % 3 == 0:
            cfgs, f1s = bucket_a, [pucch.PucchF1Config(prb=NOF_PRB - 1)]
        elif slot % 3 == 1:
            cfgs, f1s = bucket_b, []
        else:
            cfgs, f1s = bucket_a + bucket_b, [
                pucch.PucchF1Config(prb=NOF_PRB - 1)]
        cfgs = [dataclasses.replace(c, slot_in_frame=slot) for c in cfgs]
        f1s = [dataclasses.replace(c, slot_in_frame=slot) for c in f1s]
        pdus = [fapi.PuschPdu(c, harq_process=slot % 8) for c in cfgs]
        req = fapi.UlTtiRequest(
            0, slot, pusch_pdus=pdus,
            pucch_pdus=[fapi.PucchPdu(format1=c) for c in f1s])
        rx, tbs = _tx_slot(rng, pdus, f1s, [1] * len(f1s))
        want, got = _ul(jphy, tphy, rx, req, slot_count=slot)
        _assert_same_indications(got, want)
        rxd = [i for i in got if isinstance(i, tfapi.RxDataIndication)]
        assert len(rxd) == len(pdus)
        for ind, tb in zip(rxd, tbs):
            np.testing.assert_array_equal(ind.payload, tb)
    assert tphy.ul_programs.nof_compiled == 3
    assert jphy.ul_programs.nof_compiled == 3


def test_fused_matches_legacy_per_pdu_path():
    """The same slot (PUSCH with UCI, a 16QAM PUSCH, PUCCH F2) through the
    fused and the per-PDU path of the port, and through the JAX fused
    path: the same indications."""
    rng = np.random.default_rng(4)
    u = ulsch.UciOnPusch(nof_harq_ack_bits=2, nof_csi_part1_bits=7,
                         g_harq_ack=16, g_harq_ack_rvd=16, g_csi_part1=64)
    cfgs = [_sh(0x20, 0, 8, uci=u), _sh(0x21, 8, 16, qm=4, rate=0.4,
                                          time_interp=True)]
    f2 = pucch.PucchF2Config(prb_start=30, nof_prb=2, rnti=0x22,
                             nof_uci_bits=5)
    pdus = [fapi.PuschPdu(c) for c in cfgs]
    req = fapi.UlTtiRequest(0, 0, pusch_pdus=pdus,
                            pucch_pdus=[fapi.PucchPdu(format2=f2)])
    ack, csi1 = np.array([1, 0], np.int8), rng.integers(0, 2, 7).astype(
        np.int8)
    tbs = [rng.integers(0, 2, c.tbs).astype(np.int8) for c in cfgs]
    grid = sch.pusch_transmit(jnp.asarray(tbs[0]), cfgs[0],
                              jnp.zeros((14, NSC), jnp.complex64),
                              ack_bits=jnp.asarray(ack),
                              csi1_bits=jnp.asarray(csi1))
    grid = sch.pusch_transmit(jnp.asarray(tbs[1]), cfgs[1], grid)
    grid = pucch.pucch_f2_transmit(jnp.asarray(csi1[:5]), f2, grid)
    rx = (np.asarray(grid)[None] + _awgn(rng, (1, 14, NSC), 0.02)
          ).astype(np.complex64)

    jphy, tphy = _phys(NOF_PRB)
    want, got = _ul(jphy, tphy, rx, req)
    _assert_same_indications(got, want)
    _, legacy = _phys(NOF_PRB, bucketed=False)
    got_l = legacy.process_ul_slot(torch.from_numpy(rx),
                                   convert.from_jax_message(req))
    _assert_same_indications(got_l, want)
    for i in got:
        if isinstance(i, tfapi.CrcIndication):
            assert i.tb_crc_ok
    # UCI multiplexed on the first PUSCH, as JAX's pusch_receive decodes it
    o = tphy.last_ul_slot["pusch"][0]
    w = sch.pusch_receive(jnp.asarray(rx), cfgs[0])
    assert np.array_equal(o["ack_bits"], np.asarray(w.ack_bits))
    assert np.array_equal(o["ack_bits"], ack)
    assert np.array_equal(o["csi1_bits"], csi1) and bool(o["csi1_valid"])


# ------------------------------------------------------------ FAPI carrier
def test_fapi_carrier_slots_cpu():
    """The carrier scenario ``chip_smoke.py`` drives on the card, at 68 PRB
    on the CPU: DL slots (one VRB-interleaved) pass the UE-side symbol
    check; both UL mixes pass every check; the HARQ pair fails at rv=0 and
    passes combined with rv=2; one program per signature."""
    from srsran_project_23_5_tpu_torch.models import fapi_carrier, gnb_mixed
    car = fapi_carrier.tiny_carrier()
    phy = tupper_phy.UpperPhy(car.upper_phy, "cpu")
    gen = torch.Generator().manual_seed(5)
    rng = np.random.default_rng(5)
    gate = gnb_mixed.symbol_gate(car.pdsch_a.qm, car.snr_db)
    for slot, vrb in ((0, False), (5, True)):
        req, data = fapi_carrier.dl_request(car, slot, rng, vrb)
        grid = phy.process_dl_slot(req, data)
        ue = fapi_carrier.downlink(grid, car, gen)
        for p in req.pdsch_pdus:
            match, _, _ = tsch.symbol_verify(ue[None], grid[None], p.config)
            assert float(match[0]) > gate
    reqs = []
    for slot in range(3):
        ul = fapi_carrier.ul_request(car, slot, full=slot % 2 == 0)
        pay = fapi_carrier.ul_payloads(ul, rng)
        rx, prach_rx = fapi_carrier.uplink(ul, pay, car, gen)
        inds = phy.process_ul_slot(rx, ul, slot_count=slot,
                                   prach_rx=prach_rx)
        checks = fapi_carrier.ul_checks(car, ul, pay, inds,
                                        phy.last_ul_slot["pusch"])
        assert all(checks.values()), (slot, checks)
        reqs.append(ul)
    first = fapi_carrier.ul_request(car, 3, full=False, harq_process=15)
    retx = fapi_carrier.ul_request(car, 4, full=False, harq_process=15, rv=2,
                                   new_data=False)
    pay = fapi_carrier.ul_payloads(first, rng)
    verdicts = []
    for i, req in enumerate((first, retx)):
        rx, _ = fapi_carrier.uplink(req, pay, car, gen,
                                    snr_db=car.harq_snr_db)
        inds = phy.process_ul_slot(rx, req, slot_count=3 + i)
        verdicts.append(fapi_carrier.ul_checks(car, req, pay, inds,
                                               None)["crc"])
    assert verdicts == [False, True] and len(phy.softbuffers) == 0
    reqs += [first, retx]
    sigs = {tslot_programs.signature(r) for r in reqs}
    assert phy.ul_programs.nof_compiled == len(sigs) == 3


# ------------------------------------------------------------ FAPI, config
def test_fapi_messages_carry_over():
    rng = np.random.default_rng(5)
    req, data = _dl_request(rng, 2)
    treq = convert.from_jax_message(req)
    assert isinstance(treq, tfapi.DlTtiRequest)
    assert (treq.ssb_pdus[0].first_subcarrier
            == req.ssb_pdus[0].first_subcarrier)
    assert treq.pdsch_pdus[1].config.vrb_to_prb_interleaved
    assert np.array_equal(treq.pdcch_pdus[0].payload_bits,
                          req.pdcch_pdus[0].payload_bits)
    for name in ("DlTtiRequest", "UlTtiRequest", "TxDataRequest", "PrachPdu",
                 "PuschPdu", "PucchPdu", "CrcIndication", "RxDataIndication",
                 "UciIndication", "CsiIndication", "RachIndication",
                 "SlotIndication", "UlDciRequest"):
        assert ([f.name for f in dataclasses.fields(getattr(tfapi, name))]
                == [f.name for f in dataclasses.fields(getattr(fapi, name))])
    ul = fapi.UlTtiRequest(1, 3, pusch_pdus=[fapi.PuschPdu(_sh(1, 0, 4), 5,
                                                           False)])
    tul = convert.from_jax_message(ul)
    assert tul.pusch_pdus[0].harq_process == 5
    assert not tul.pusch_pdus[0].new_data
    assert tslot_programs.signature(tul)[0][0].slot_in_frame == 0


def test_sanitize_mode_is_refused():
    with pytest.raises(NotImplementedError, match="sanitize"):
        tupper_phy.UpperPhy(tupper_phy.UpperPhyConfig(sanitize=True))


def test_fetch_is_one_transfer_of_every_leaf():
    tree = {"a": [torch.tensor([1, 0], dtype=torch.int8),
                  torch.tensor(True)],
            "b": {"c": torch.tensor([[0.5, -2.0]])}}
    out = tslot_programs.fetch(tree)
    assert out["a"][0].dtype == np.int8 and list(out["a"][0]) == [1, 0]
    assert out["a"][1].dtype == np.bool_ and bool(out["a"][1])
    assert out["b"]["c"].shape == (1, 2) and out["b"]["c"][0, 1] == -2.0


def test_upper_phy_imports_no_jax():
    code = ("import sys\n"
            "import srsran_project_23_5_tpu_torch.phy.upper.upper_phy\n"
            "import srsran_project_23_5_tpu_torch.phy.upper.slot_programs\n"
            "import srsran_project_23_5_tpu_torch.fapi.messages\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m.split('.')[0] == 'srsran_project_23_5_tpu')\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
