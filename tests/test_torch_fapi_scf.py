"""Parity of the port's SCF FAPI layer (``fapi/scf.py``, ``fapi/builders.py``)
with the JAX package (CPU), on the cases of ``tests/test_fapi_scf.py`` and
``tests/test_fapi_scf_path.py``.

- The same builder calls in both packages give translated processor configs
  that are equal field by field (the JAX ones carried over with
  ``convert``), the UCI-on-PUSCH G values from the beta/alpha tables among
  them.
- The SCF-built UL request at 36 PRB (PUSCH + PUCCH F1) goes through both
  ``UpperPhy``s on the same numpy rx grid: the indications are equal
  (verdicts and bits equal, SINR within 0.05 dB, metrics within 1e-4
  relative).  The JAX receiver on the CPU decodes with its XLA decoder; at
  this SNR every codeblock converges, where it agrees with the port's
  Pallas semantics (ROADMAP trap 1).
- The SCF-built DL request gives the same DL grid in both packages (within
  1e-5 of max|ref|).
- ``models/fapi_carrier``'s SCF-built slots translate in the port as in
  JAX, and differ from the carrier's own requests only in what SCF cannot
  express.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srsran_project_23_5_tpu.fapi import builders as jbuilders
from srsran_project_23_5_tpu.fapi import messages as jfapi
from srsran_project_23_5_tpu.fapi import scf as jscf
from srsran_project_23_5_tpu.phy.upper import pucch as jpucch
from srsran_project_23_5_tpu.phy.upper import sch as jsch
from srsran_project_23_5_tpu.phy.upper import ulsch as julsch
from srsran_project_23_5_tpu.phy.upper import upper_phy as jupper_phy
from srsran_project_23_5_tpu.ran import tbs as tbs_mod
from srsran_project_23_5_tpu_torch import convert
from srsran_project_23_5_tpu_torch.fapi import builders, scf
from srsran_project_23_5_tpu_torch.fapi import messages as tfapi
from srsran_project_23_5_tpu_torch.models import fapi_carrier
from srsran_project_23_5_tpu_torch.phy.upper import pucch as tpucch
from srsran_project_23_5_tpu_torch.phy.upper import sch as tsch
from srsran_project_23_5_tpu_torch.phy.upper import ulsch as tulsch
from srsran_project_23_5_tpu_torch.phy.upper import upper_phy as tupper_phy

torch.set_num_threads(1)

NOF_PRB = 36
NSC = NOF_PRB * 12


def _both(fn):
    """fn(builders, scf) run with each package's modules → (JAX, port)."""
    return fn(jbuilders, jscf), fn(builders, scf)


def _pdsch(bld, s, b=None, rb_start=10, rb_size=52, tb_bytes=1000):
    b = b or bld.DlTtiRequestBuilder(sfn=12, slot=3)
    (b.add_pdsch_pdu()
      .set_basic_parameters(rnti=0x4601)
      .set_bwp_parameters(bwp_size=106, bwp_start=0)
      .add_codeword(target_code_rate=6580, qam_mod_order=6, mcs_index=20,
                    mcs_table=0, rv_index=0, tb_size_bytes=tb_bytes)
      .set_codeword_information_parameters(nid_pdsch=1, num_layers=1)
      .set_dmrs_parameters(
          dmrs_symbol_mask=s.symbols_to_dmrs_mask((2, 7, 11)),
          dmrs_type=s.DmrsCfgType.TYPE_1, scrambling_id=1, nscid=0,
          num_cdm_grps_no_data=2, dmrs_ports=0b1)
      .set_pdsch_allocation_in_frequency_type_1(rb_start=rb_start,
                                                rb_size=rb_size)
      .set_pdsch_allocation_in_time_parameters(2, 12))
    return b.build()


def _pusch(bld, s, ack=1, csi1=4, alpha=0, beta_ack=9, beta_csi=13,
           layers=1):
    b = bld.UlTtiRequestBuilder(sfn=0, slot=9)
    p = (b.add_pusch_pdu()
          .set_basic_parameters(rnti=0x4602)
          .set_bwp_parameters(bwp_size=106, bwp_start=0)
          .set_information_parameters(
              target_code_rate=3080, qam_mod_order=4, mcs_index=10,
              mcs_table=0, transform_precoding=False, nid_pusch=1,
              num_layers=layers)
          .set_dmrs_parameters(
              dmrs_symbol_mask=s.symbols_to_dmrs_mask((2, 7, 11)),
              dmrs_type=s.DmrsCfgType.TYPE_1, scrambling_id=1,
              pusch_dmrs_identity=1, nscid=0, num_cdm_grps_no_data=2,
              dmrs_ports=(1 << layers) - 1)
          .set_allocation_in_frequency_type_1_parameters(rb_start=0,
                                                         rb_size=24)
          .set_allocation_in_time_parameters(0, 14)
          .add_optional_pusch_data(rv_index=0, harq_process_id=2,
                                   new_data=True, tb_size_bytes=300))
    if ack or csi1:
        p.add_optional_pusch_uci(harq_ack_bits=ack, csi1_bits=csi1,
                                 alpha_scaling=alpha,
                                 beta_offset_harq_ack=beta_ack,
                                 beta_offset_csi1=beta_csi)
    return b.build()


def _pucch(bld, s):
    b = bld.UlTtiRequestBuilder(0, 5)
    (b.add_pucch_pdu()
      .set_basic_parameters(0x4601, s.PucchFormatType.F1)
      .set_allocation_in_frequency_parameters(prb_start=105)
      .set_allocation_in_time_parameters(0, 14)
      .set_format1_parameters(initial_cyclic_shift=6)
      .set_uci_bit_lengths(harq_bits=1))
    (b.add_pucch_pdu()
      .set_basic_parameters(0x4601, s.PucchFormatType.F2)
      .set_allocation_in_frequency_parameters(prb_start=1, prb_size=1)
      .set_allocation_in_time_parameters(12, 2)
      .set_uci_bit_lengths(harq_bits=0, csi1_bits=4)
      .set_scrambling(nid_scrambling=1))
    return b.build()


def _pdcch(s):
    return s.DlPdcchPdu(
        coreset_bwp_size=48, coreset_bwp_start=0, start_symbol_index=0,
        duration_symbols=1,
        cce_reg_mapping_type=s.CceToRegMappingType.INTERLEAVED,
        interleaver_size=2, shift_index=17,
        dl_dci=[s.DlDciPdu(rnti=0x4601, nid_pdcch_data=1,
                           nrnti_pdcch_data=0x4601, cce_index=4,
                           aggregation_level=4, payload_size_bits=39)])


def _same_req(got, want) -> None:
    """A port processor request equals a JAX one carried over: configs
    equal, payload bits equal."""
    want = convert.from_jax_message(want)
    assert type(got) is type(want)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, list):
            assert len(a) == len(b), f.name
            for pa, pb in zip(a, b):
                for g in dataclasses.fields(pb):
                    va, vb = getattr(pa, g.name), getattr(pb, g.name)
                    if isinstance(vb, np.ndarray):
                        assert np.array_equal(va, vb), (f.name, g.name)
                    else:
                        assert va == vb, (f.name, g.name, va, vb)
        else:
            assert a == b, f.name


# ------------------------------------------------- test_fapi_scf.py cases
@pytest.mark.parametrize("syms", [(2, 7, 11), (0,), (2, 11), (),
                                  tuple(range(14))])
def test_dmrs_mask_roundtrip_matches(syms):
    mask = scf.symbols_to_dmrs_mask(syms)
    assert mask == jscf.symbols_to_dmrs_mask(syms)
    assert scf.dmrs_mask_to_symbols(mask) == jscf.dmrs_mask_to_symbols(
        mask) == syms


def test_pdsch_builder_translates_to_processor_config():
    jreq, treq = _both(_pdsch)
    got = scf.pdsch_to_config(treq.pdsch_pdus[0], slot_in_frame=3)
    want = jscf.pdsch_to_config(jreq.pdsch_pdus[0], slot_in_frame=3)
    assert got == convert.from_jax_sh(want)
    assert got == tsch.ShConfig(
        rnti=0x4601, tbs=8000, qm=6, rv=0, nof_layers=1, prb_start=10,
        nof_prb=52, first_symbol=2, nof_symbols=12, dmrs_symbols=(2, 7, 11),
        dmrs_cdm_groups_without_data=2, nid=1, nid_dmrs=1, n_scid=0,
        slot_in_frame=3)


# (O_ack, O_csi1, alpha index, beta ACK index, beta CSI index, layers):
# the reserved O <= 2 case, the rate-matched O > 2 case, every alpha, the
# ends of both beta tables and an index past them (taken modulo), 2 layers
UCI_CASES = [(1, 4, 0, 9, 13, 1), (2, 7, 1, 0, 0, 1), (3, 0, 2, 15, 18, 1),
             (0, 11, 3, 4, 19, 1), (5, 6, 3, 17, 7, 2), (11, 11, 0, 12, 16, 1)]


@pytest.mark.parametrize("case", UCI_CASES)
def test_pusch_builder_with_uci_g_computation(case):
    ack, csi1, alpha, b_ack, b_csi, layers = case
    jreq, treq = _both(lambda bld, s: _pusch(bld, s, ack, csi1, alpha, b_ack,
                                             b_csi, layers))
    got = scf.pusch_to_config(treq.pusch_pdus[0], slot_in_frame=9)
    want = jscf.pusch_to_config(jreq.pusch_pdus[0], slot_in_frame=9)
    assert got == convert.from_jax_sh(want)
    u = got.uci
    assert (u.nof_harq_ack_bits, u.nof_csi_part1_bits) == (ack, csi1)
    # O_ack <= 2 takes the reserved-bit path, O_ack > 2 is rate-matched
    assert (u.g_harq_ack_rvd > 0) == (0 < ack <= 2)
    assert (u.g_harq_ack > 0) == (ack > 2)
    assert u.g_csi_part1 % got.qm == 0 and (u.g_csi_part1 > 0) == (csi1 > 0)


def test_beta_alpha_tables_equal():
    assert scf._BETA_HARQ == jscf._BETA_HARQ
    assert scf._BETA_CSI == jscf._BETA_CSI
    assert scf._ALPHA == jscf._ALPHA


def test_pucch_builder_f1_f2():
    jreq, treq = _both(_pucch)
    for jp, tp in zip(jreq.pucch_pdus, treq.pucch_pdus):
        got = scf.pucch_to_config(tp, slot_in_frame=5)
        want = jscf.pucch_to_config(jp, slot_in_frame=5)
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    f1, f2 = (scf.pucch_to_config(p, 5) for p in treq.pucch_pdus)
    assert isinstance(f1, tpucch.PucchF1Config)
    assert (f1.prb, f1.initial_cyclic_shift, f1.slot_in_frame) == (105, 6, 5)
    assert isinstance(f2, tpucch.PucchF2Config)
    assert (f2.prb_start, f2.nof_uci_bits, f2.n_id) == (1, 4, 1)
    # F0/F3/F4 are outside the 23.5 scope, as upstream
    for fmt in (scf.PucchFormatType.F0, scf.PucchFormatType.F3,
                scf.PucchFormatType.F4):
        with pytest.raises(ValueError):
            scf.pucch_to_config(scf.UlPucchPdu(format_type=fmt))


def test_pdcch_pdu_to_configs():
    got = scf.pdcch_to_configs(_pdcch(scf))
    want = jscf.pdcch_to_configs(_pdcch(jscf))
    assert got == [convert.from_jax_pdcch(c) for c in want]
    c = got[0]
    assert (c.rnti, c.cce_index, c.aggregation_level) == (0x4601, 4, 4)
    assert c.interleaved and c.shift == 17 and c.coreset_nof_prb == 48


def test_uci_field_of_no_bits_is_empty():
    """A UCI field with G = 0 encodes to no bits (the JAX tile of 0
    repetitions); the SCF translation gives an O <= 2 HARQ-ACK G = 0."""
    for o in (1, 2):
        bits = np.ones(o, np.int8)
        want = np.asarray(julsch.encode_uci_field(jnp.asarray(bits), o, 0, 4))
        got = tulsch.encode_uci_field(torch.from_numpy(bits)[None], o, 0, 4)
        assert want.shape == (0,) and tuple(got.shape) == (1, 0)


# -------------------------------------------- test_fapi_scf_path.py cases
def _scf_ul(bld, s, tbs_bits, slot):
    b = bld.UlTtiRequestBuilder(sfn=0, slot=slot)
    (b.add_pusch_pdu()
      .set_basic_parameters(rnti=0x4601)
      .set_bwp_parameters(bwp_size=NOF_PRB, bwp_start=0)
      .set_information_parameters(
          target_code_rate=5120, qam_mod_order=2, mcs_index=5, mcs_table=0,
          transform_precoding=False, nid_pusch=1, num_layers=1)
      .set_dmrs_parameters(
          dmrs_symbol_mask=s.symbols_to_dmrs_mask((2, 7, 11)),
          dmrs_type=s.DmrsCfgType.TYPE_1, scrambling_id=1,
          pusch_dmrs_identity=1, nscid=0, num_cdm_grps_no_data=2,
          dmrs_ports=0b1)
      .set_allocation_in_frequency_type_1_parameters(rb_start=0, rb_size=16)
      .set_allocation_in_time_parameters(0, 14)
      .add_optional_pusch_data(rv_index=0, harq_process_id=3, new_data=True,
                               tb_size_bytes=tbs_bits // 8))
    (b.add_pucch_pdu()
      .set_basic_parameters(0x4601, s.PucchFormatType.F1)
      .set_allocation_in_frequency_parameters(prb_start=NOF_PRB - 1)
      .set_allocation_in_time_parameters(0, 14)
      .set_format1_parameters(initial_cyclic_shift=0)
      .set_uci_bit_lengths(harq_bits=1))
    return b.build()


def _same_indications(got, want) -> None:
    assert [type(i).__name__ for i in got] == [type(i).__name__ for i in want]
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if f.name in ("sinr_db", "ta_samples"):
                assert abs(a - b) < 0.05, (f.name, a, b)
            elif f.name == "metric":
                assert abs(a - b) <= 1e-4 * max(abs(b), 1.0), (a, b)
            elif isinstance(b, np.ndarray) or b is None:
                assert (a is None) == (b is None), f.name
                if b is not None:
                    assert np.array_equal(np.asarray(a), b), f.name
            else:
                assert a == b, (f.name, a, b)


def scf_ul_slot(seed: int = 3, slot: int = 5):
    """The SCF-built UL slot of test_fapi_scf_path: both translated
    requests, the TB, the PUSCH + PUCCH F1 grid and its noisy rx grid
    [1, 14, nsc] (numpy)."""
    rng = np.random.default_rng(seed)
    tbs_bits = tbs_mod.tbs_calculate(14, 36, 0, 0.5, 2, 1, 16)
    jreq, treq = _both(lambda bld, s: _scf_ul(bld, s, tbs_bits, slot))
    jul = jscf.ul_tti_to_processor_request(jreq)
    tul = scf.ul_tti_to_processor_request(treq)
    cfg = jul.pusch_pdus[0].config
    tb = rng.integers(0, 2, cfg.tbs).astype(np.int8)
    grid = jsch.pusch_transmit(jnp.asarray(tb), cfg,
                               jnp.zeros((14, NSC), jnp.complex64))
    grid = np.asarray(jpucch.pucch_f1_transmit(
        jnp.asarray([1], jnp.int8), jul.pucch_pdus[0].format1, grid))
    noise = 0.02 / np.sqrt(2) * (rng.standard_normal((1, 14, NSC))
                                 + 1j * rng.standard_normal((1, 14, NSC)))
    rx = (grid[None] + noise).astype(np.complex64)
    return jul, tul, tb, grid, rx


@pytest.mark.parametrize("bucketed", [True, False])
def test_scf_ul_request_drives_both_upper_phys(bucketed):
    jul, tul, tb, grid, rx = scf_ul_slot()
    _same_req(tul, jul)
    assert tul.pusch_pdus[0].harq_process == 3
    cfg = tul.pusch_pdus[0].config
    # the port's UE side builds the same grid from the translated configs
    tgrid = tsch.pusch_transmit(
        torch.from_numpy(tb)[None], cfg,
        torch.zeros((1, 14, NSC), dtype=torch.complex64))
    tgrid = tpucch.pucch_f1_transmit(torch.ones((1, 1), dtype=torch.int8),
                                     tul.pucch_pdus[0].format1, tgrid)[0]
    assert np.abs(tgrid.numpy() - grid).max() <= 1e-5 * np.abs(grid).max()

    jphy = jupper_phy.UpperPhy(jupper_phy.UpperPhyConfig(
        nof_prb=NOF_PRB, bucketed=bucketed))
    tphy = tupper_phy.UpperPhy(tupper_phy.UpperPhyConfig(
        nof_prb=NOF_PRB, bucketed=bucketed), "cpu")
    want = jphy.process_ul_slot(jnp.asarray(rx), jul, slot_count=5)
    got = tphy.process_ul_slot(torch.from_numpy(rx), tul, slot_count=5)
    _same_indications(got, want)
    crc = [i for i in got if isinstance(i, tfapi.CrcIndication)]
    rxd = [i for i in got if isinstance(i, tfapi.RxDataIndication)]
    uci = [i for i in got if isinstance(i, tfapi.UciIndication)]
    assert len(crc) == 1 and crc[0].tb_crc_ok and crc[0].harq_process == 3
    np.testing.assert_array_equal(rxd[0].payload, tb)
    assert uci and uci[0].detected and uci[0].harq_bits[0] == 1


def test_scf_dl_request_translation_and_grid():
    def build(bld, s):
        b = bld.DlTtiRequestBuilder(sfn=1, slot=2)
        _pdsch(bld, s, b, rb_start=4, rb_size=8, tb_bytes=100)
        b.req.pdsch_pdus[0].bwp_size = NOF_PRB
        b.add_pdcch_pdu(s.DlPdcchPdu(
            coreset_bwp_size=NOF_PRB, start_symbol_index=0,
            duration_symbols=1,
            dl_dci=[s.DlDciPdu(
                rnti=0x4601, cce_index=0, aggregation_level=4,
                payload=np.packbits(dci).tobytes(),
                payload_size_bits=len(dci))]))
        return b.build()

    dci = np.array([1, 0, 1, 1, 0, 1, 0, 0, 1, 1], np.uint8)
    jreq, treq = _both(build)
    want = jscf.dl_tti_to_processor_request(jreq)
    got = scf.dl_tti_to_processor_request(treq)
    _same_req(got, want)
    assert got.pdsch_pdus[0].config.tbs == 800
    assert got.pdsch_pdus[0].config.prb_start == 4
    assert got.pdcch_pdus[0].config.payload_size == 10
    np.testing.assert_array_equal(got.pdcch_pdus[0].payload_bits,
                                  dci.astype(np.int8))
    tb = np.random.default_rng(4).integers(0, 2, 800).astype(np.int8)
    jgrid = np.asarray(jupper_phy.UpperPhy(jupper_phy.UpperPhyConfig(
        nof_prb=NOF_PRB)).process_dl_slot(
            want, jfapi.TxDataRequest(1, 2, [tb])))
    tgrid = tupper_phy.UpperPhy(tupper_phy.UpperPhyConfig(
        nof_prb=NOF_PRB), "cpu").process_dl_slot(
            got, tfapi.TxDataRequest(1, 2, [tb])).numpy()
    assert np.abs(tgrid - jgrid).max() <= 1e-5 * np.abs(jgrid).max()


def test_ssb_and_csi_rs_pdus_pass_through():
    """SSB and CSI-RS PDUs cross the SCF layer untranslated, as in JAX."""
    car = fapi_carrier.tiny_carrier()
    req, _ = fapi_carrier.scf_dl_request(car, 0, np.random.default_rng(0))
    req.csi_rs_pdus.append(tfapi.CsiRsPdu(car.csi_rs))
    out = scf.dl_tti_to_processor_request(req)
    want = jscf.dl_tti_to_processor_request(req)
    assert want.ssb_pdus == out.ssb_pdus and want.csi_rs_pdus == \
        out.csi_rs_pdus
    assert out.ssb_pdus == req.ssb_pdus and out.csi_rs_pdus == \
        req.csi_rs_pdus
    assert out.ssb_pdus[0] is req.ssb_pdus[0]


# ------------------------------------------ the carrier's SCF-built slots
def _to_jax_scf(x):
    """A port SCF request or PDU rebuilt from the JAX package's classes
    (the processor PDUs that SCF passes through are kept as they are)."""
    if isinstance(x, list):
        return [_to_jax_scf(v) for v in x]
    if not dataclasses.is_dataclass(x) or type(x).__module__ != scf.__name__ \
            and type(x).__module__ != builders.__name__:
        return x
    cls = getattr(jscf if type(x).__module__ == scf.__name__ else jbuilders,
                  type(x).__name__)
    return cls(**{f.name: _to_jax_scf(getattr(x, f.name))
                  for f in dataclasses.fields(x)})


@pytest.mark.parametrize("slot,vrb", [(0, False), (5, True)])
def test_fapi_carrier_scf_dl_translates_as_in_jax(slot, vrb):
    """The carrier's DL slot as an SCF MAC builds it, or (vrb) its
    interleaved PDSCH alone, translates as in JAX and into the carrier's
    own request."""
    car = fapi_carrier.tiny_carrier()
    if vrb:
        b = builders.DlTtiRequestBuilder(sfn=0, slot=slot)
        fapi_carrier._scf_pdsch(b, car.pdsch_vrb, car.nof_prb)
        sreq = b.build()
    else:
        sreq, data = fapi_carrier.scf_dl_request(car, slot,
                                                 np.random.default_rng(slot))
    got = scf.dl_tti_to_processor_request(sreq)
    want = jscf.dl_tti_to_processor_request(_to_jax_scf(sreq))
    assert [p.config for p in got.pdsch_pdus] == [
        convert.from_jax_sh(p.config) for p in want.pdsch_pdus]
    assert [p.config for p in got.pdcch_pdus] == [
        convert.from_jax_pdcch(p.config) for p in want.pdcch_pdus]
    assert all(np.array_equal(a.payload_bits, b.payload_bits)
               for a, b in zip(got.pdcch_pdus, want.pdcch_pdus))
    if vrb:
        assert [p.config for p in got.pdsch_pdus] == [
            dataclasses.replace(car.pdsch_vrb, slot_in_frame=slot)]
        return
    # against the carrier's own request: the same draws; the CSI-RS RE
    # reservation of PDSCH A (which the translation has no field for)
    # differs, and so the CSI-RS is left out
    native, ndata = fapi_carrier.dl_request(car, slot,
                                            np.random.default_rng(slot))
    assert all(np.array_equal(a, b) for a, b in
               zip(data.transport_blocks, ndata.transport_blocks))
    assert fapi_carrier.request_differences(got, native) == [
        "pdsch_pdus[0].config.reserved_patterns: () → ((5, (0,)),)",
        "csi_rs_pdus: 0 PDUs → 1"]


@pytest.mark.parametrize("full", [True, False])
def test_fapi_carrier_scf_ul_translates_as_in_jax(full):
    car = fapi_carrier.tiny_carrier()
    sreq = fapi_carrier.scf_ul_request(car, 2, full=full)
    got = scf.ul_tti_to_processor_request(sreq)
    _same_req(got, jscf.ul_tti_to_processor_request(_to_jax_scf(sreq)))
    diff = fapi_carrier.request_differences(
        got, fapi_carrier.ul_request(car, 2, full=full))
    b = "pusch_pdus[1]" if full else "pusch_pdus[0]"
    # the 3-bit HARQ-ACK (rate-matched) and the beta-offset G values, no
    # time interpolation, no PRACH sub-carrier or F1 HARQ process field
    assert {d.split(":")[0] for d in diff} == {
        f"{b}.config.time_interp", f"{b}.config.uci.nof_harq_ack_bits",
        f"{b}.config.uci.g_harq_ack", f"{b}.config.uci.g_harq_ack_rvd",
        f"{b}.config.uci.g_csi_part1", "pucch_pdus[0].harq_pid",
        *(("prach_pdus[0].sc_start", "pucch_pdus[1].rnti") if full else ())}


def test_scf_ul_slot_over_the_fronthaul_matches():
    """The slice as a whole: the SCF-built UL slot's rx grid crosses split
    7.2 (BFP w=9, one eAxC) from an RU-side sector to a DU-side sector and
    into UpperPhy, in each package: the frames are equal byte for byte, the
    rebuilt grids equal, and the indications equal and right."""
    from srsran_project_23_5_tpu import ofh as jofh
    from srsran_project_23_5_tpu_torch import ofh as tofh

    jul, tul, tb, _, rx = scf_ul_slot(seed=8, slot=6)

    def over_ofh(mod, grid, **kw):
        frames, got = [], {}
        ru = mod.OfhSector(mod.OfhSectorConfig(nof_prb=NOF_PRB, eaxc_dl=2),
                           frames.append, **kw)
        du = mod.OfhSector(mod.OfhSectorConfig(nof_prb=NOF_PRB, eaxc_ul=2),
                           lambda f: None, **kw)
        du.on_ul_slot = lambda key, g: got.update({key: g})
        ru.transmit_dl_slot(0, 3, 0, grid)
        for f in frames:
            du.handle_rx_frame(f)
        return frames, got[(0, 3, 0)]

    jframes, jgrid = over_ofh(jofh, rx[0])
    tframes, tgrid = over_ofh(tofh, rx[0], device="cpu")
    assert tframes == jframes and len(tframes) == 15
    np.testing.assert_array_equal(tgrid.numpy(), np.asarray(jgrid))
    snr = np.mean(np.abs(rx[0]) ** 2) / np.mean(np.abs(tgrid.numpy()
                                                       - rx[0]) ** 2)
    assert 10 * np.log10(snr) > 40
    want = jupper_phy.UpperPhy(jupper_phy.UpperPhyConfig(
        nof_prb=NOF_PRB)).process_ul_slot(jnp.asarray(jgrid)[None], jul,
                                          slot_count=6)
    got = tupper_phy.UpperPhy(tupper_phy.UpperPhyConfig(
        nof_prb=NOF_PRB), "cpu").process_ul_slot(tgrid[None], tul,
                                                 slot_count=6)
    _same_indications(got, want)
    crc = [i for i in got if isinstance(i, tfapi.CrcIndication)]
    rxd = [i for i in got if isinstance(i, tfapi.RxDataIndication)]
    assert crc[0].tb_crc_ok and np.array_equal(rxd[0].payload, tb)
