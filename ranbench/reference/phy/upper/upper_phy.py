"""Upper PHY, the plain per-PDU path: FAPI processor requests → the DL
grid and the UL indications.

A frozen copy of the port's ``phy/upper/upper_phy.py`` without its
captured slot programs: each DL PDU is written into the grid in turn and
each UL PDU is received on its own (``bucketed=False`` in the port).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...fapi import messages as fapi
from ...ops import prach as prach_ops
from ...precision import q
from . import csi_rs as csi_rs_proc
from . import pdcch as pdcch_proc
from . import pucch as pucch_proc
from . import sch, ssb as ssb_proc
from ...utils.device import resolve as resolve_device
from .harq import SoftbufferPool


def prach_scan(prach_rx: torch.Tensor, root: int, length: int, zcz: int,
               nof_preambles: int):
    """Detect over as many roots as the preamble count needs: the global
    preamble index p maps to (root + p // n_shifts, shift p % n_shifts).
    Returns (metric, delay in chips), each [..., nof_preambles]."""
    ns = prach_ops.num_shifts(length, zcz)
    nroots = max(1, -(-nof_preambles // ns))
    ms, ds = [], []
    for ri in range(nroots):
        metric, delay, _ = prach_ops.detect(prach_rx, root + ri, length, zcz)
        ms.append(metric)
        ds.append(delay)
    return (torch.cat(ms, dim=-1)[..., :nof_preambles],
            torch.cat(ds, dim=-1)[..., :nof_preambles])


@dataclasses.dataclass(frozen=True)
class UpperPhyConfig:
    nof_prb: int = 106
    nof_rx_ports: int = 1
    nof_tx_ports: int = 1
    prach_detection_threshold: float = 16.0
    nfft: int = 0                 # carrier FFT size (TA chip→sample conv)
    nof_ldpc_iterations: int = 6

    @property
    def nsc(self) -> int:
        return self.nof_prb * 12


def _bits(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int8), device=device)


class UpperPhy:
    """One carrier's upper PHY: DL grid assembly + UL processing, PDU by
    PDU."""

    def __init__(self, config: UpperPhyConfig,
                 device: torch.device | str | None = None) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.softbuffers = SoftbufferPool()

    # ------------------------------------------------------------- downlink
    def process_dl_slot(self, req: fapi.DlTtiRequest,
                        data: fapi.TxDataRequest | None = None
                        ) -> torch.Tensor:
        """Build the slot's DL resource grid [14, nsc] from FAPI PDUs (a
        tensor of its own: the next slot does not overwrite it)."""
        dev = self.device
        tbs = data.transport_blocks if data else []
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
        return q(grid[0])

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
        # the received grid and PRACH window as a receiver one precision
        # below would hold them (inside ``precision.bfloat16()`` only)
        rx_grid = q(rx_grid)
        prach_rx = None if prach_rx is None else q(prach_rx)
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
            metric, delay = prach_scan(
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
