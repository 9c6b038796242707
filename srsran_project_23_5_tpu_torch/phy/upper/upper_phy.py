"""Upper PHY orchestration: FAPI slot requests → grids → indications.

Counterpart of ``srsran_project_23_5_tpu/phy/upper/upper_phy.py``.  Each DL
slot's PDUs build one [14, nsc] grid and each UL slot's PDUs run against
one [nrx, 14, nsc] received grid, on the device the ``UpperPhy`` was made
for; the host only routes messages and owns the HARQ softbuffer pool.  The
default (bucketed) path runs one cached program per slot signature
(``slot_programs``); ``bucketed=False`` keeps the per-PDU path for A/B
comparison.  The modules below take a leading slot batch; the upper PHY
calls them with B = 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...fapi import messages as fapi
from ...support import sanitizers
from . import csi_rs as csi_rs_proc
from . import pdcch as pdcch_proc
from . import pucch as pucch_proc
from . import sch, slot_programs, ssb as ssb_proc
from ...utils.device import resolve as resolve_device
from .harq import SoftbufferPool


@dataclasses.dataclass(frozen=True)
class UpperPhyConfig:
    nof_prb: int = 106
    nof_rx_ports: int = 1
    nof_tx_ports: int = 1
    prach_detection_threshold: float = 16.0
    nfft: int = 0                 # carrier FFT size (TA chip→sample conv)
    # bucketed=True routes slots through one program per slot signature
    # (slot_programs.py — the production path); False keeps the per-PDU
    # dispatch for A/B comparison
    bucketed: bool = True
    nof_ldpc_iterations: int = 6
    # sanitize=True checks every DL slot's PDUs for two channels claiming
    # one RE (support/sanitizers.py, raises GridOverlapError) before the
    # grid is built; a host-side debug mode, off on the real-time path
    sanitize: bool = False

    @property
    def nsc(self) -> int:
        return self.nof_prb * 12


def _bits(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int8), device=device)


class UpperPhy:
    """One carrier's upper PHY: DL grid assembly + UL processing.

    ``last_ul_slot`` holds the host copy of the last fused UL slot's
    outputs, including the UCI decoded on each PUSCH (the JAX package
    computes it and raises no indication for it)."""

    def __init__(self, config: UpperPhyConfig,
                 device: torch.device | str | None = None) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.softbuffers = SoftbufferPool()
        self.ul_programs = slot_programs.UlSlotPrograms(
            config.nof_ldpc_iterations)
        self.dl_programs = slot_programs.DlSlotPrograms(config.nsc)
        self.last_ul_slot: dict | None = None

    # ------------------------------------------------------------- downlink
    def process_dl_slot(self, req: fapi.DlTtiRequest,
                        data: fapi.TxDataRequest | None = None
                        ) -> torch.Tensor:
        """Build the slot's DL resource grid [14, nsc] from FAPI PDUs."""
        if self.config.sanitize:
            sanitizers.check_dl_slot(req, self.config.nof_tx_ports,
                                     self.config.nsc)
        dev = self.device
        tbs = data.transport_blocks if data else []
        if self.config.bucketed:
            if len(tbs) < len(req.pdsch_pdus):
                # PDSCH PDUs without TX_Data are skipped, as on the per-PDU
                # path
                req = dataclasses.replace(
                    req, pdsch_pdus=req.pdsch_pdus[:len(tbs)])
            fn = self.dl_programs.get(slot_programs.dl_signature(req))
            return fn(
                tuple(_bits(p.payload_bits, dev) for p in req.ssb_pdus),
                tuple(_bits(p.payload_bits, dev) for p in req.pdcch_pdus),
                tuple(_bits(tb, dev) for tb in tbs[:len(req.pdsch_pdus)]),
                tuple(slot_programs.pusch_cinits(p.config)
                      for p in req.pdsch_pdus), dev)
        grid = torch.zeros((1, 14, self.config.nsc), dtype=torch.complex64,
                           device=dev)
        for pdu in req.ssb_pdus:
            k0 = pdu.first_subcarrier
            # the SSB sits on symbols 2..5 (case A, first candidate)
            grid[:, 2:6, k0:k0 + ssb_proc.SSB_NSC] = ssb_proc.ssb_assemble(
                _bits(pdu.payload_bits, dev)[None], pdu.config)
        for pdu in req.pdcch_pdus:
            grid = pdcch_proc.pdcch_transmit(
                _bits(pdu.payload_bits, dev)[None], pdu.config, grid)
        for pdu, tb in zip(req.pdsch_pdus, tbs):
            grid = sch.pdsch_transmit(_bits(tb, dev)[None], pdu.config, grid)
        # CSI-RS after PDSCH: its REs sit in the PDSCH's reserved pattern
        for pdu in req.csi_rs_pdus:
            grid = csi_rs_proc.generate(pdu.config, grid)
        return grid[0]

    # --------------------------------------------------------------- uplink
    def process_ul_slot(self, rx_grid: torch.Tensor, req: fapi.UlTtiRequest,
                        slot_count: int = 0,
                        prach_rx: torch.Tensor | None = None
                        ) -> list[object]:
        """Run the slot's UL PDUs on rx_grid [nrx, 14, nsc] (or [14, nsc]);
        prach_rx: the occasion's frequency-domain window [nrx, L].  Returns
        FAPI indications: CRC (and RxData on a pass) per PUSCH, UCI per
        PUCCH format, RACH per PRACH occasion, in that order."""
        if rx_grid.dim() == 2:
            rx_grid = rx_grid[None]
        if self.config.bucketed:
            return self._process_ul_slot_fused(rx_grid, req, slot_count,
                                               prach_rx)
        pend_pusch, pend_pucch, pend_prach = [], [], []
        for pdu in req.pusch_pdus:
            cfg = pdu.config
            d = sch.pusch_demodulate(rx_grid[None], cfg)
            llr = self.softbuffers.combine(cfg.rnti, pdu.harq_process,
                                           d.llr_full[0], pdu.new_data,
                                           slot_count)
            res = sch.pusch_decode(llr[None], cfg, d.noise_var, d.rsrp,
                                   nof_ldpc_iterations=(
                                       self.config.nof_ldpc_iterations),
                                   demod=d)
            pend_pusch.append((pdu, res))
        for pdu in req.pucch_pdus:
            r1 = (pucch_proc.pucch_f1_detect(rx_grid[None], pdu.format1)
                  if pdu.format1 is not None else None)
            r2 = (pucch_proc.pucch_f2_receive(rx_grid[None], pdu.format2)
                  if pdu.format2 is not None else None)
            pend_pucch.append((pdu, r1, r2))
        for pdu in req.prach_pdus:
            if prach_rx is None:
                continue
            metric, delay = slot_programs.prach_scan(
                prach_rx, pdu.root_sequence_index, pdu.length,
                pdu.zero_correlation_zone, pdu.nof_preambles)
            pend_prach.append((pdu, metric, delay))

        out: list[object] = []
        for pdu, res in pend_pusch:
            cfg = pdu.config
            ok = bool(res.tb_crc_ok[0])
            if ok:
                self.softbuffers.release(cfg.rnti, pdu.harq_process)
                out.append(fapi.RxDataIndication(
                    req.sfn, req.slot, cfg.rnti, pdu.harq_process,
                    res.tb_bits[0].cpu().numpy()))
            ta = 0.0
            if res.ta_norm is not None and self.config.nfft:
                ta = float(res.ta_norm[0]) * self.config.nfft
            out.append(fapi.CrcIndication(
                req.sfn, req.slot, cfg.rnti, pdu.harq_process, ok,
                float(res.sinr_db[0]), ta_samples=ta))
        for pdu, r1, r2 in pend_pucch:
            if r1 is not None:
                out.append(fapi.UciIndication(
                    req.sfn, req.slot, pdu.rnti, r1.bits[0].cpu().numpy(),
                    None, bool(r1.detected[0]),
                    float(r1.detection_metric[0]),
                    harq_pid=pdu.harq_pid, is_sr=pdu.is_sr))
            if r2 is not None:
                out.append(fapi.UciIndication(
                    req.sfn, req.slot, pdu.format2.rnti, None,
                    r2.uci_bits[0].cpu().numpy(), bool(r2.detected[0]),
                    float(r2.metric[0])))
        for pdu, metric, delay in pend_prach:
            out.append(self._rach_indication(req, pdu, metric.cpu().numpy(),
                                             delay.cpu().numpy()))
        self.softbuffers.run_slot(slot_count)
        return out

    def _rach_indication(self, req: fapi.UlTtiRequest, pdu: fapi.PrachPdu,
                         m: np.ndarray, d: np.ndarray) -> fapi.RachIndication:
        if m.ndim > 1:          # combine rx ports
            m = m.mean(axis=0)
            d = d[0]
        # the delay arrives in ZC-chip units; the MAC's TA command wants
        # samples at the carrier rate (chip = nfft/length samples for the
        # in-grid short format)
        scale = self.config.nfft / pdu.length if self.config.nfft else 1.0
        hits = [(int(i), float(m[i]), float(d[i]) * scale)
                for i in np.nonzero(
                    m > self.config.prach_detection_threshold)[0]]
        return fapi.RachIndication(req.sfn, req.slot, pdu.occasion, hits)

    # ---------------------------------------------- fused (bucketed) path
    def _process_ul_slot_fused(self, rx_grid: torch.Tensor,
                               req: fapi.UlTtiRequest, slot_count: int,
                               prach_rx: torch.Tensor | None
                               ) -> list[object]:
        dev = rx_grid.device
        if prach_rx is None and req.prach_pdus:
            # no PRACH window captured this slot: the occasion's PDUs are
            # skipped, no RACH.indication raised
            req = fapi.UlTtiRequest(req.sfn, req.slot, prach_pdus=[],
                                    pusch_pdus=req.pusch_pdus,
                                    pucch_pdus=req.pucch_pdus)
        fn = self.ul_programs.get(slot_programs.signature(req))

        priors, new_data = [], []
        for pdu in req.pusch_pdus:
            st = self.softbuffers.get(pdu.config.rnti, pdu.harq_process)
            shape = sch.llr_full_shape(pdu.config)
            fresh = pdu.new_data or st is None or tuple(st.shape) != shape
            priors.append(torch.zeros(shape, dtype=torch.float32, device=dev)
                          if fresh else st)
            new_data.append(torch.tensor(fresh, device=dev))
        if prach_rx is None:
            prach_rx = torch.zeros((1, 139), dtype=torch.complex64,
                                   device=dev)
        cinits = tuple(slot_programs.pusch_cinits(pdu.config)
                       for pdu in req.pusch_pdus)
        pucch_data = tuple(slot_programs.pucch_slot_data(pdu, dev)
                           for pdu in req.pucch_pdus)

        out = fn(rx_grid, tuple(priors), tuple(new_data), prach_rx, cinits,
                 pucch_data)
        # combined LLRs stay on the device; everything else comes to the
        # host in one transfer
        for pdu, o in zip(req.pusch_pdus, out["pusch"]):
            self.softbuffers.put(pdu.config.rnti, pdu.harq_process,
                                 o.pop("combined_llr"), slot_count)
        host = slot_programs.fetch(out)
        self.last_ul_slot = host

        inds: list[object] = []
        for pdu, o in zip(req.pusch_pdus, host["pusch"]):
            cfg = pdu.config
            ok = bool(o["tb_crc_ok"])
            if ok:
                self.softbuffers.release(cfg.rnti, pdu.harq_process)
                inds.append(fapi.RxDataIndication(
                    req.sfn, req.slot, cfg.rnti, pdu.harq_process,
                    o["tb_bits"]))
            ta = (float(o["ta_norm"]) * self.config.nfft
                  if self.config.nfft else 0.0)
            inds.append(fapi.CrcIndication(
                req.sfn, req.slot, cfg.rnti, pdu.harq_process, ok,
                float(o["sinr_db"]), ta_samples=ta))
        for pdu, o in zip(req.pucch_pdus, host["pucch"]):
            if "f1" in o:
                r = o["f1"]
                inds.append(fapi.UciIndication(
                    req.sfn, req.slot, pdu.rnti, r["bits"], None,
                    bool(r["detected"]), float(r["metric"]),
                    harq_pid=pdu.harq_pid, is_sr=pdu.is_sr))
            if "f2" in o:
                r = o["f2"]
                inds.append(fapi.UciIndication(
                    req.sfn, req.slot, pdu.format2.rnti, None,
                    r["uci_bits"], bool(r["detected"]), float(r["metric"])))
        for pdu, o in zip(req.prach_pdus, host["prach"]):
            inds.append(self._rach_indication(req, pdu, o["metric"],
                                              o["delay"]))
        self.softbuffers.run_slot(slot_count)
        return inds
