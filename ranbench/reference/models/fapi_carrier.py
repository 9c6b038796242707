"""A FAPI-driven carrier: the requests a MAC would send to ``UpperPhy`` for

Copied from the port's
``srsran_project_23_5_tpu_torch/models/fapi_carrier.py``, unchanged.

one cell, and the UE and channel side that answers them.

The layout follows the mixed slot (``models/gnb_mixed.py``), sized off
``nof_prb`` (273 PRB at 100 MHz, μ=1, nfft 4096 by default):

  DL_TTI: SSB (32-bit PBCH payload) ‖ PDCCH DL DCI + UL DCI (AL4) ‖
          PDSCH A on PRBs [0, n/2) with the CSI-RS RE reserved ‖ PDSCH B up
          to the SSB ‖ CSI-RS row 2 — or, in a VRB slot, the two DCIs and
          one VRB-interleaved PDSCH over the whole BWP;
  UL_TTI: PUSCH A (4 layers, PRBs [0, n/2)) ‖ PUSCH B (1 layer, time
          interpolation, 2 HARQ-ACK bits (the reserved O ≤ 2 case) and 7
          CSI part 1 bits multiplexed on it) ‖ PUCCH F1 (1 bit) ‖ PUCCH F2
          (11 CSI bits, symbols 12-13) ‖ a 139-chip PRACH window over 12
          symbols (64 preambles: several roots), or PUSCH B and PUCCH F1
          alone.

Channels are frequency-flat and unitary (a 4×4 unitary matrix for the
4-layer UE, unit-norm vectors for the single-antenna UEs, the identity in
the downlink), applied on the resource grid; the uplink and downlink go
through OFDM and AWGN at a per-RE SNR.  The PRACH preamble sits on the
grid with a delay of a few ZC chips; the gNB's window is the mean of its
REs over the 12 symbols.  Randomness comes from numpy generators
(payloads) and an explicit ``torch.Generator`` (noise).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..fapi import builders, scf
from ..fapi import messages as fapi
from ..ops import prach as prach_ops
from ..phy.lower import ofdm
from ..phy.upper import csi_rs, pdcch, pucch, sch, ssb, ulsch
from ..phy.upper.upper_phy import UpperPhyConfig
from ..ran import numerology, tbs as tbs_mod
from ..ran.constants import NRE

NOF_RX = 4


@dataclasses.dataclass(frozen=True)
class FapiCarrier:
    """Static configuration of the carrier and its UEs (slot 0)."""
    mu: int
    nfft: int
    nof_prb: int
    pdsch_a: sch.ShConfig
    pdsch_b: sch.ShConfig
    pdsch_vrb: sch.ShConfig
    pusch_a: sch.ShConfig          # 4 layers
    pusch_b: sch.ShConfig          # 1 layer, UCI, time interpolation
    pdcch_dl: pdcch.PdcchConfig
    pdcch_ul: pdcch.PdcchConfig
    ssb: ssb.SsbConfig
    ssb_sc: int
    csi_rs: csi_rs.CsiRsConfig
    pucch_f1: pucch.PucchF1Config
    pucch_f2: pucch.PucchF2Config
    prach_root: int = 22
    prach_ncs: int = 13
    prach_nof_preambles: int = 64
    prach_sc: int = 3072
    prach_nof_symbols: int = 12
    prach_preamble: int = 37       # root prach_root + 3, shift 7
    prach_delay_chips: int = 2
    snr_db: float = 20.0
    # per-RE SNR of the HARQ pair: PUSCH B's rv=0 transmission fails there
    # and the rv=0 + rv=2 combination passes
    harq_snr_db: float = 14.0
    nof_ldpc_iterations: int = 6

    @property
    def nsc(self) -> int:
        return self.nof_prb * NRE

    @property
    def upper_phy(self) -> UpperPhyConfig:
        return UpperPhyConfig(nof_prb=self.nof_prb, nof_rx_ports=NOF_RX,
                              nfft=self.nfft,
                              nof_ldpc_iterations=self.nof_ldpc_iterations)

    @property
    def prach_ta_samples(self) -> float:
        """The injected PRACH delay in samples at the carrier rate."""
        return self.prach_delay_chips * self.nfft / 139.0


def _sh(prb0: int, nprb: int, layers: int, first: int, nsym: int, rnti: int,
        qm: int, rate: float, **kw) -> sch.ShConfig:
    """A shared channel with the TS 38.214 TBS of its allocation at `rate`."""
    cfg = sch.ShConfig(rnti=rnti, tbs=8, qm=qm, nof_layers=layers,
                       prb_start=prb0, nof_prb=nprb, first_symbol=first,
                       nof_symbols=nsym, dmrs_symbols=(2, 7, 11), **kw)
    nre_prb = cfg.nof_data_re // nprb
    tbs = tbs_mod.tbs_calculate(nsym, nsym * NRE - nre_prb, 0, rate, qm,
                                layers, nprb)
    return dataclasses.replace(cfg, tbs=tbs)


def default_carrier(nof_prb: int = 273, qm: int = 6, rate: float = 0.6533,
                    rate_b: float = 0.66, **over) -> FapiCarrier:
    """The 100 MHz carrier (273 PRB, nfft 4096, 64QAM, R≈0.65; PUSCH B at
    R≈0.66, which makes it BG1 Z=384) by default; needs nof_prb ≥ 68."""
    if nof_prb < 68:
        raise ValueError("the carrier layout needs >= 68 PRB")
    ue0 = nof_prb // 2
    ssb_prb = nof_prb - 20
    uci = ulsch.UciOnPusch(nof_harq_ack_bits=2, nof_csi_part1_bits=7,
                           g_harq_ack=12 * qm, g_harq_ack_rvd=12 * qm,
                           g_csi_part1=32 * qm)
    base = FapiCarrier(
        mu=1, nfft=numerology.min_nfft(nof_prb), nof_prb=nof_prb,
        pdsch_a=_sh(0, ue0, 1, 1, 13, 0x4601, qm, rate,
                    reserved_patterns=((5, (0,)),)),
        pdsch_b=_sh(ue0, ssb_prb - ue0, 1, 1, 13, 0x4602, qm, rate),
        pdsch_vrb=_sh(0, nof_prb, 1, 1, 13, 0x4603, qm, rate,
                      vrb_to_prb_interleaved=True, bwp_nof_prb=nof_prb),
        pusch_a=_sh(0, ue0, 4, 0, 14, 0x4601, qm, rate),
        pusch_b=_sh(ue0, nof_prb - 18 - ue0, 1, 0, 14, 0x4602, qm, rate_b,
                    time_interp=True, uci=uci),
        pdcch_dl=pdcch.PdcchConfig(rnti=0x4601, payload_size=40,
                                   aggregation_level=4, cce_index=0),
        pdcch_ul=pdcch.PdcchConfig(rnti=0x4602, payload_size=40,
                                   aggregation_level=4, cce_index=4),
        ssb=ssb.SsbConfig(pci=123), ssb_sc=ssb_prb * NRE,
        csi_rs=csi_rs.CsiRsConfig(row=2, prb_start=0, nof_prb=ue0, symbol=5),
        pucch_f1=pucch.PucchF1Config(prb=nof_prb - 2, nof_harq_bits=1),
        pucch_f2=pucch.PucchF2Config(prb_start=nof_prb - 1, nof_prb=1,
                                     start_symbol=12, nof_symbols=2,
                                     rnti=0x4602, nof_uci_bits=11),
        prach_sc=(nof_prb - 17) * NRE)
    return dataclasses.replace(base, **over) if over else base


def tiny_carrier(**over) -> FapiCarrier:
    """Small carrier for CPU tests: the same layout and modulation on 68
    PRB (nfft 1024)."""
    return default_carrier(nof_prb=68, **over)


def _at_slot(cfg, slot: int):
    return dataclasses.replace(cfg, slot_in_frame=slot)


# ------------------------------------------------------------------ requests
def dl_request(car: FapiCarrier, slot: int, rng: np.random.Generator,
               vrb: bool = False):
    """(DL_TTI.request, TX_Data.request) of one slot with random payloads."""
    dcis = [fapi.PdcchPdu(c, rng.integers(0, 2, c.payload_size)
                          .astype(np.int8))
            for c in (car.pdcch_dl, car.pdcch_ul)]
    if vrb:
        req = fapi.DlTtiRequest(
            0, slot, pdcch_pdus=dcis,
            pdsch_pdus=[fapi.PdschPdu(_at_slot(car.pdsch_vrb, slot))])
    else:
        req = fapi.DlTtiRequest(
            0, slot,
            ssb_pdus=[fapi.SsbPdu(car.ssb, rng.integers(0, 2, ssb.PBCH_A)
                                  .astype(np.int8), car.ssb_sc)],
            pdcch_pdus=dcis,
            pdsch_pdus=[fapi.PdschPdu(_at_slot(c, slot))
                        for c in (car.pdsch_a, car.pdsch_b)],
            csi_rs_pdus=[fapi.CsiRsPdu(car.csi_rs)])
    data = fapi.TxDataRequest(0, slot, [
        rng.integers(0, 2, p.config.tbs).astype(np.int8)
        for p in req.pdsch_pdus])
    return req, data


def ul_request(car: FapiCarrier, slot: int, full: bool = True,
               harq_process: int | None = None, rv: int = 0,
               new_data: bool = True) -> fapi.UlTtiRequest:
    """UL_TTI.request of one slot: the full mix (PUSCH A and B, PUCCH F1 and
    F2, PRACH) or PUSCH B and PUCCH F1 alone."""
    pid = slot % 8 if harq_process is None else harq_process
    b = fapi.PuschPdu(dataclasses.replace(car.pusch_b, slot_in_frame=slot,
                                          rv=rv), pid, new_data)
    f1 = fapi.PucchPdu(format1=_at_slot(car.pucch_f1, slot), rnti=0x4602,
                       harq_pid=pid)
    if not full:
        return fapi.UlTtiRequest(0, slot, pusch_pdus=[b], pucch_pdus=[f1])
    return fapi.UlTtiRequest(
        0, slot,
        prach_pdus=[fapi.PrachPdu(car.prach_root, 139, car.prach_ncs,
                                  sc_start=car.prach_sc,
                                  nof_symbols=car.prach_nof_symbols,
                                  nof_preambles=car.prach_nof_preambles)],
        pusch_pdus=[fapi.PuschPdu(_at_slot(car.pusch_a, slot), pid, True), b],
        pucch_pdus=[f1, fapi.PucchPdu(format2=_at_slot(car.pucch_f2, slot))])


# ------------------------------------------------------- SCF-built requests
def _code_rate_scf(cfg: sch.ShConfig) -> int:
    return round(cfg.code_rate * 10240)       # R x 1024 x 10


def _dmrs_ports(cfg: sch.ShConfig) -> int:
    return (1 << cfg.nof_layers) - 1


def _scf_pdsch(b: builders.DlTtiRequestBuilder, cfg: sch.ShConfig,
               bwp_size: int) -> None:
    vrb = (scf.VrbToPrbMappingType.INTERLEAVED_RB_SIZE2
           if cfg.vrb_to_prb_interleaved
           else scf.VrbToPrbMappingType.NON_INTERLEAVED)
    (b.add_pdsch_pdu()
      .set_basic_parameters(rnti=cfg.rnti)
      .set_bwp_parameters(bwp_size=bwp_size, bwp_start=0)
      .add_codeword(target_code_rate=_code_rate_scf(cfg),
                    qam_mod_order=cfg.qm, mcs_index=0, mcs_table=0,
                    rv_index=cfg.rv, tb_size_bytes=cfg.tbs // 8)
      .set_codeword_information_parameters(nid_pdsch=cfg.nid,
                                           num_layers=cfg.nof_layers)
      .set_dmrs_parameters(
          dmrs_symbol_mask=scf.symbols_to_dmrs_mask(cfg.dmrs_symbols),
          dmrs_type=scf.DmrsCfgType.TYPE_1, scrambling_id=cfg.nid_dmrs,
          nscid=cfg.n_scid,
          num_cdm_grps_no_data=cfg.dmrs_cdm_groups_without_data,
          dmrs_ports=_dmrs_ports(cfg))
      .set_pdsch_allocation_in_frequency_type_1(
          rb_start=cfg.prb_start, rb_size=cfg.nof_prb, vrb_to_prb=vrb)
      .set_pdsch_allocation_in_time_parameters(cfg.first_symbol,
                                               cfg.nof_symbols))


def _scf_pdcch(cfgs, payloads) -> scf.DlPdcchPdu:
    """One CORESET PDU carrying a DCI per config (the CORESET fields are
    the first config's)."""
    c = cfgs[0]
    return scf.DlPdcchPdu(
        coreset_bwp_size=c.coreset_nof_prb,
        coreset_bwp_start=c.coreset_start_prb,
        start_symbol_index=c.start_symbol, duration_symbols=c.nof_symbols,
        cce_reg_mapping_type=(scf.CceToRegMappingType.INTERLEAVED
                              if c.interleaved
                              else scf.CceToRegMappingType.NON_INTERLEAVED),
        interleaver_size=c.interleaver_rows, shift_index=c.shift,
        dl_dci=[scf.DlDciPdu(
            rnti=d.rnti, nid_pdcch_data=d.n_id, nrnti_pdcch_data=d.n_rnti,
            cce_index=d.cce_index, aggregation_level=d.aggregation_level,
            payload=np.packbits(bits.astype(np.uint8)).tobytes(),
            payload_size_bits=d.payload_size)
            for d, bits in zip(cfgs, payloads)])


def scf_dl_request(car: FapiCarrier, slot: int, rng: np.random.Generator):
    """``dl_request``'s slot built as an SCF-speaking MAC builds it, with
    ``fapi.builders`` (the same draws from rng): (ScfDlTtiRequest,
    TX_Data.request).  The SSB PDU is the processor PDU, which
    ``scf.dl_tti_to_processor_request`` passes through.  The CSI-RS is left
    out: its RE lies in PDSCH A, whose reservation of it the translation
    has no field for, so the CSI-RS would overwrite PDSCH A's data there."""
    dcis = [rng.integers(0, 2, c.payload_size).astype(np.int8)
            for c in (car.pdcch_dl, car.pdcch_ul)]
    b = builders.DlTtiRequestBuilder(sfn=0, slot=slot)
    b.add_pdcch_pdu(_scf_pdcch((car.pdcch_dl, car.pdcch_ul), dcis))
    b.add_ssb_pdu(fapi.SsbPdu(car.ssb, rng.integers(0, 2, ssb.PBCH_A)
                              .astype(np.int8), car.ssb_sc))
    for c in (car.pdsch_a, car.pdsch_b):
        _scf_pdsch(b, c, car.nof_prb)
    req = b.build()
    data = fapi.TxDataRequest(0, slot, [
        rng.integers(0, 2, 8 * p.cws[0].tb_size_bytes).astype(np.int8)
        for p in req.pdsch_pdus])
    return req, data


# HARQ-ACK bits of an SCF-built PUSCH B: the translation carries no ACK of
# 1 or 2 bits (it sets only the reserved G), so the SCF slot sends 3, which
# are rate-matched
SCF_ACK_BITS = 3


def _scf_pusch(b: builders.UlTtiRequestBuilder, cfg: sch.ShConfig,
               nof_prb: int, pid: int) -> None:
    p = (b.add_pusch_pdu()
          .set_basic_parameters(rnti=cfg.rnti)
          .set_bwp_parameters(bwp_size=nof_prb, bwp_start=0)
          .set_information_parameters(
              target_code_rate=_code_rate_scf(cfg), qam_mod_order=cfg.qm,
              mcs_index=0, mcs_table=0, transform_precoding=False,
              nid_pusch=cfg.nid, num_layers=cfg.nof_layers)
          .set_dmrs_parameters(
              dmrs_symbol_mask=scf.symbols_to_dmrs_mask(cfg.dmrs_symbols),
              dmrs_type=scf.DmrsCfgType.TYPE_1, scrambling_id=cfg.nid_dmrs,
              pusch_dmrs_identity=cfg.nid_dmrs, nscid=cfg.n_scid,
              num_cdm_grps_no_data=cfg.dmrs_cdm_groups_without_data,
              dmrs_ports=_dmrs_ports(cfg))
          .set_allocation_in_frequency_type_1_parameters(
              rb_start=cfg.prb_start, rb_size=cfg.nof_prb)
          .set_allocation_in_time_parameters(cfg.first_symbol,
                                             cfg.nof_symbols)
          .add_optional_pusch_data(rv_index=cfg.rv, harq_process_id=pid,
                                   new_data=True,
                                   tb_size_bytes=cfg.tbs // 8))
    if cfg.uci.any:
        p.add_optional_pusch_uci(harq_ack_bits=SCF_ACK_BITS,
                                 csi1_bits=cfg.uci.nof_csi_part1_bits)


def scf_ul_request(car: FapiCarrier, slot: int, full: bool = True):
    """``ul_request``'s slot built with ``fapi.builders``: the
    ScfUlTtiRequest, new data on HARQ process slot % 8.  PUSCH B's UCI
    carries ``SCF_ACK_BITS`` HARQ-ACK bits and the carrier's CSI part 1
    bits, with the builder's beta offsets."""
    pid = slot % 8
    b = builders.UlTtiRequestBuilder(sfn=0, slot=slot)
    if full:
        _scf_pusch(b, car.pusch_a, car.nof_prb, pid)
    _scf_pusch(b, car.pusch_b, car.nof_prb, pid)
    f1 = car.pucch_f1
    (b.add_pucch_pdu()
      .set_basic_parameters(0x4602, scf.PucchFormatType.F1)
      .set_allocation_in_frequency_parameters(prb_start=f1.prb)
      .set_allocation_in_time_parameters(f1.start_symbol, f1.nof_symbols)
      .set_format1_parameters(initial_cyclic_shift=f1.initial_cyclic_shift,
                              time_domain_occ=f1.occ_index,
                              nid_hopping=f1.n_id)
      .set_uci_bit_lengths(harq_bits=f1.nof_harq_bits))
    if full:
        f2 = car.pucch_f2
        (b.add_pucch_pdu()
          .set_basic_parameters(f2.rnti, scf.PucchFormatType.F2)
          .set_allocation_in_frequency_parameters(prb_start=f2.prb_start,
                                                  prb_size=f2.nof_prb)
          .set_allocation_in_time_parameters(f2.start_symbol,
                                             f2.nof_symbols)
          .set_uci_bit_lengths(harq_bits=0, csi1_bits=f2.nof_uci_bits)
          .set_scrambling(nid_scrambling=f2.n_id, nid0_dmrs=f2.n_id0))
        b.add_prach_pdu(scf.UlPrachPdu(
            phys_cell_id=car.ssb.pci, prach_format=scf.PrachFormatType.A1,
            num_cs=car.prach_ncs,
            maintenance_v3_prach_res_config_index=car.prach_root,
            maintenance_v3_num_preamble_indices=car.prach_nof_preambles))
    return b.build()


def request_differences(got, want) -> list[str]:
    """Where two processor requests of one slot differ: one
    "<PDU list>[i].<field>: got → want" entry per differing field of the
    PDUs and their configs (the UCI of a PUSCH config field by field)."""
    def fields(x, path):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                yield from fields(getattr(x, f.name), f"{path}.{f.name}")
        else:
            yield path, x

    out = []
    for name in ("ssb_pdus", "pdcch_pdus", "pdsch_pdus", "csi_rs_pdus",
                 "prach_pdus", "pusch_pdus", "pucch_pdus"):
        a, b = getattr(got, name, []), getattr(want, name, [])
        if len(a) != len(b):
            out.append(f"{name}: {len(a)} PDUs → {len(b)}")
            continue
        for i, (pa, pb) in enumerate(zip(a, b)):
            for (path, va), (_, vb) in zip(fields(pa, f"{name}[{i}]"),
                                           fields(pb, f"{name}[{i}]")):
                same = (np.array_equal(va, vb)
                        if isinstance(va, np.ndarray) else va == vb)
                if not same:
                    out.append(f"{path}: {va} → {vb}")
    return out


def ul_payloads(req: fapi.UlTtiRequest, rng: np.random.Generator) -> dict:
    """Random payloads of every UL PDU: per PUSCH (tb, ack, csi1), per PUCCH
    (F1 bits | None, F2 bits | None)."""
    pusch_p = []
    for p in req.pusch_pdus:
        u = p.config.uci
        pusch_p.append(tuple(rng.integers(0, 2, n).astype(np.int8)
                             for n in (p.config.tbs, u.nof_harq_ack_bits,
                                       u.nof_csi_part1_bits)))
    pucch_p = [(rng.integers(0, 2, p.format1.nof_harq_bits).astype(np.int8)
                if p.format1 else None,
                rng.integers(0, 2, p.format2.nof_uci_bits).astype(np.int8)
                if p.format2 else None) for p in req.pucch_pdus]
    return {"pusch": pusch_p, "pucch": pucch_p}


# ------------------------------------------------------------------ channels
@functools.lru_cache(maxsize=8)
def channels(device: torch.device):
    """(H4 [4, 4] unitary, unit-norm vectors of PUSCH B, PUCCH F1, PUCCH F2
    and the PRACH UE) on `device`."""
    rng = np.random.default_rng(2024)
    h4 = np.linalg.qr(rng.standard_normal((4, 4))
                      + 1j * rng.standard_normal((4, 4)))[0]
    vecs = [v / np.linalg.norm(v) for v in
            rng.standard_normal((4, NOF_RX)) + 1j * rng.standard_normal(
                (4, NOF_RX))]
    return tuple(torch.from_numpy(np.asarray(h, np.complex64)).to(device)
                 for h in (h4, *vecs))


def noise_sigma(car: FapiCarrier, snr_db: float) -> float:
    """Standard deviation of each of I and Q of the baseband noise that
    gives a per-RE SNR of snr_db on unit-power REs after the nfft-point
    OFDM demodulation (only ``car.nfft`` is read: any carrier config
    serves)."""
    return math.sqrt(car.nfft) * 10 ** (-snr_db / 20) / math.sqrt(2.0)


def add_awgn(bb: torch.Tensor, car: FapiCarrier, snr_db: float,
             generator: torch.Generator) -> torch.Tensor:
    """Baseband plus complex AWGN at a per-RE SNR, drawn on bb's device."""
    nz = torch.randn((2, *bb.shape), generator=generator, device=bb.device,
                     dtype=torch.float32) * noise_sigma(car, snr_db)
    return bb + torch.complex(nz[0], nz[1])


def _awgn_ofdm(grid: torch.Tensor, car: FapiCarrier, snr_db: float,
               generator: torch.Generator) -> torch.Tensor:
    """[ports, 14, nsc] → OFDM → AWGN at a per-RE SNR → demodulated grid."""
    bb = ofdm.modulate_slot(grid, car.mu, car.nfft)
    return ofdm.demodulate_slot(add_awgn(bb, car, snr_db, generator),
                                car.nsc, car.mu, car.nfft)


def downlink(grid: torch.Tensor, car: FapiCarrier, generator: torch.Generator,
             snr_db: float | None = None) -> torch.Tensor:
    """The UE's received grid [1, 14, nsc] of a DL grid [14, nsc]."""
    return _awgn_ofdm(grid[None], car,
                      car.snr_db if snr_db is None else snr_db, generator)


@functools.lru_cache(maxsize=8)
def _prach_preamble(car: FapiCarrier, device: torch.device) -> torch.Tensor:
    ns = prach_ops.num_shifts(139, car.prach_ncs)
    pre = prach_ops.generate(car.prach_root + car.prach_preamble // ns,
                             car.prach_preamble % ns, 139, car.prach_ncs)
    # a delay of d chips is the phase ramp e^{-j2πkd/139} in frequency
    ramp = np.exp(-2j * np.pi * np.arange(139) * car.prach_delay_chips / 139)
    return torch.from_numpy((pre * ramp).astype(np.complex64)).to(device)


def uplink(req: fapi.UlTtiRequest, payloads: dict, car: FapiCarrier,
           generator: torch.Generator, snr_db: float | None = None):
    """The UEs' transmissions of one UL slot through the channels, OFDM and
    AWGN → (rx grid [4, 14, nsc], PRACH window [4, 139] | None) on the
    generator's device."""
    dev = generator.device
    h4, h_b, h_f1, h_f2, h_p = channels(dev)
    t = lambda a: torch.from_numpy(a)[None].to(dev)
    nsc = car.nsc
    z1 = torch.zeros((1, 14, nsc), dtype=torch.complex64, device=dev)
    rx = torch.zeros((NOF_RX, 14, nsc), dtype=torch.complex64, device=dev)
    for pdu, (tb, ack, csi1) in zip(req.pusch_pdus, payloads["pusch"]):
        cfg = pdu.config
        if cfg.nof_layers == 4:
            g = sch.pusch_transmit(t(tb), cfg, torch.zeros(
                (1, 4, 14, nsc), dtype=torch.complex64, device=dev))[0]
            rx = rx + torch.einsum("rt,tsk->rsk", h4, g)
        else:
            u = cfg.uci
            g = sch.pusch_transmit(
                t(tb), cfg, z1,
                ack_bits=t(ack) if u.nof_harq_ack_bits else None,
                csi1_bits=t(csi1) if u.nof_csi_part1_bits else None)[0]
            rx = rx + h_b[:, None, None] * g
    for pdu, (b1, b2) in zip(req.pucch_pdus, payloads["pucch"]):
        if pdu.format1 is not None:
            g = pucch.pucch_f1_transmit(t(b1), pdu.format1, z1)[0]
            rx = rx + h_f1[:, None, None] * g
        if pdu.format2 is not None:
            g = pucch.pucch_f2_transmit(t(b2), pdu.format2, z1)[0]
            rx = rx + h_f2[:, None, None] * g
    for pdu in req.prach_pdus:
        lo = pdu.sc_start
        rx[:, :pdu.nof_symbols, lo:lo + 139] += (
            h_p[:, None, None] * _prach_preamble(car, dev))
    rx = _awgn_ofdm(rx, car, car.snr_db if snr_db is None else snr_db,
                    generator)
    prach_rx = None
    for pdu in req.prach_pdus:
        lo = pdu.sc_start
        prach_rx = rx[:, :pdu.nof_symbols, lo:lo + 139].mean(dim=1)
    return rx, prach_rx


# ------------------------------------------------------------------ checks
def ul_checks(car: FapiCarrier, req: fapi.UlTtiRequest, payloads: dict,
              inds: list, pusch_outputs: list | None) -> dict[str, bool]:
    """Verdicts of one UL slot's indications against what the UEs sent:
    every CRC passes and every RxData payload is its TB; the UCI multiplexed
    on each PUSCH (``pusch_outputs``: ``UpperPhy.last_ul_slot["pusch"]``,
    None on the per-PDU path) and each PUCCH's bits are recovered; the
    PRACH preamble is the only one detected and its TA is the injected
    delay within one sample of the detector's delay grid (2 samples at
    nfft 4096)."""
    crc = [i for i in inds if isinstance(i, fapi.CrcIndication)]
    rxd = [i for i in inds if isinstance(i, fapi.RxDataIndication)]
    uci = [i for i in inds if isinstance(i, fapi.UciIndication)]
    rach = [i for i in inds if isinstance(i, fapi.RachIndication)]
    out = {"crc": (len(crc) == len(req.pusch_pdus)
                   and all(c.tb_crc_ok for c in crc)),
           "payload": (len(rxd) == len(req.pusch_pdus) and all(
               np.array_equal(r.payload, p[0])
               for r, p in zip(rxd, payloads["pusch"])))}
    if pusch_outputs is not None:
        out["uci_on_pusch"] = all(
            all(np.array_equal(o[f"{name}_bits"], sent)
                and bool(o[f"{name}_valid"])
                for name, sent in (("ack", ack), ("csi1", csi1)) if sent.size)
            for o, (_, ack, csi1) in zip(pusch_outputs, payloads["pusch"]))
    sent = [b for pair in payloads["pucch"] for b in pair if b is not None]
    out["pucch"] = (len(uci) == len(sent) and all(
        u.detected and np.array_equal(
            u.harq_bits if u.harq_bits is not None else u.uci_bits, s)
        for u, s in zip(uci, sent)))
    if req.prach_pdus:
        tol = car.nfft / 2048          # one sample of the 2048-point PDP
        out["prach"] = (len(rach) == 1
                        and [p[0] for p in rach[0].preambles]
                        == [car.prach_preamble]
                        and abs(rach[0].preambles[0][2]
                                - car.prach_ta_samples) <= tol)
    return out
