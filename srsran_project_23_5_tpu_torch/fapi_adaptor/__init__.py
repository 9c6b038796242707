"""FAPI adaptors (reference lib/fapi_adaptor): MAC ↔ FAPI ↔ PHY glue.

- MacToFapiTranslator: MacSlotOutput (scheduler result + MAC PDUs) →
  DL_TTI.request + TX_Data.request + UL_TTI.request
  (mac_to_fapi_translator.cpp:60-143).
- FapiToMacTranslator: upper-PHY indications (CRC/RxData/UCI/RACH) →
  MAC handlers (fapi_to_mac_data_msg_translator.cpp).

Each scheduler grant maps to one static ShConfig so each distinct
(prbs, qm, tbs) shape compiles once (fapi_to_phy_translator.cpp:234's
PDU→processor-config resolution, TPU-style).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..fapi import messages as fapi
from ..mac import MacCellProcessor, MacSlotOutput
from ..phy.upper.pdcch import PdcchConfig
from ..phy.upper.pucch import PucchF1Config, PucchF2Config
from ..phy.upper.sch import ShConfig
from ..phy.upper.ssb import SsbConfig
from ..scheduler import CellConfig, dci as dci_mod
from ..scheduler.results import DlGrant, UlGrant


def _bits(data: bytes, nof_bits: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(bytes(data), dtype=np.uint8)
                         )[:nof_bits].astype(np.int8)


def _bytes(bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(bits, dtype=np.uint8)).tobytes()


class MacToFapiTranslator:
    def __init__(self, cell: CellConfig, dmrs_symbols=(2, 7, 11)) -> None:
        self.cell = cell
        self.dmrs_symbols = tuple(dmrs_symbols)

    def _sh_config(self, g, slot: int, is_dl: bool,
                   csi_rs: bool = False) -> ShConfig:
        # DL rides symbols 2..13 (0-1 are the PDCCH control region); UL
        # uses the full slot.  Geometry matches the scheduler's TBS math
        # (pdsch_symbols=12, 3 whole DM-RS symbols).
        first, nsym = (2, 12) if is_dl else (0, 14)
        # CSI-RS slots reserve the resource's REs out of the PDSCH
        # (re_pattern reservation; row 2 = subcarrier 0 of every PRB)
        resv = (((self.cell.csi_rs_symbol, (0,)),)
                if (is_dl and csi_rs) else ())
        return ShConfig(
            rnti=g.rnti, tbs=g.tbs_bytes * 8, qm=g.qm, rv=g.rv,
            prb_start=g.prb_start, nof_prb=g.prb_len,
            first_symbol=first, nof_symbols=nsym,
            dmrs_symbols=self.dmrs_symbols, nid=self.cell.pci,
            nid_dmrs=self.cell.pci,
            slot_in_frame=slot % self.cell.slots_per_frame,
            reserved_patterns=resv)

    def _pdcch_pdu(self, g, slot: int) -> fapi.PdcchPdu:
        """Grant → PDCCH PDU: packed DCI + CCE-allocated candidate
        (mac_to_fapi_translator.cpp PDCCH path + dci_packing)."""
        n = self.cell.nof_prb
        d = dci_mod.Dci(is_dl=isinstance(g, DlGrant),
                        prb_start=g.prb_start, prb_len=g.prb_len,
                        mcs=g.mcs, ndi=int(g.ndi), rv=g.rv,
                        harq_pid=g.harq_pid,
                        pri=max(getattr(g, "pucch_pri", 0), 0))
        cfg = PdcchConfig(
            rnti=g.rnti, payload_size=dci_mod.dci_size(n),
            aggregation_level=g.aggregation_level, cce_index=g.cce_index,
            start_symbol=0, nof_symbols=1, n_id=self.cell.pci,
            n_rnti=g.rnti)
        return fapi.PdcchPdu(cfg, dci_mod.pack(d, n))

    def _ssb_pdu(self, sfn: int) -> fapi.SsbPdu:
        payload = np.unpackbits(np.frombuffer(
            np.uint32((sfn << 10) | self.cell.pci).tobytes(),
            dtype=np.uint8)).astype(np.int8)
        k0 = max(0, (self.cell.nof_prb * 12 - 240) // 2)
        k0 = min(k0, 6)   # keep inside the SSB-reserved PRBs when narrow
        return fapi.SsbPdu(SsbConfig(pci=self.cell.pci, sfn=sfn),
                           payload, first_subcarrier=k0)

    def translate(self, out: MacSlotOutput, sfn: int, slot: int
                  ) -> tuple[fapi.DlTtiRequest, fapi.TxDataRequest,
                             fapi.UlTtiRequest, fapi.UlDciRequest]:
        res = out.result
        dl = fapi.DlTtiRequest(sfn, slot)
        tx = fapi.TxDataRequest(sfn, slot)
        ul = fapi.UlTtiRequest(sfn, slot)
        ul_dci = fapi.UlDciRequest(sfn, slot)
        if res.ssb:
            dl.ssb_pdus.append(self._ssb_pdu(sfn))
        if res.csi_rs:
            from ..phy.upper.csi_rs import CsiRsConfig
            dl.csi_rs_pdus.append(fapi.CsiRsPdu(CsiRsConfig(
                row=2, prb_start=0, nof_prb=self.cell.nof_prb,
                symbol=self.cell.csi_rs_symbol,
                scrambling_id=self.cell.pci,
                slot_in_frame=slot % self.cell.slots_per_frame)))
        for g in res.ul_dcis:
            ul_dci.pdcch_pdus.append(self._pdcch_pdu(g, slot))
        # UL DCIs ride the same slot's DL control region
        dl.pdcch_pdus.extend(ul_dci.pdcch_pdus)
        for g in res.dl_grants:
            tb: Optional[bytes] = None
            if g.is_rar:
                tb = out.rar_pdus.get(g.rnti)
            elif g.is_sib:
                tb = out.sib1_pdu
            else:
                tb = out.dl_pdus.get((g.rnti, g.harq_pid))
            if tb is None:
                continue
            cfg = self._sh_config(g, slot, True, csi_rs=res.csi_rs)
            dl.pdcch_pdus.append(self._pdcch_pdu(g, slot))
            dl.pdsch_pdus.append(fapi.PdschPdu(cfg))
            tx.transport_blocks.append(_bits(tb.ljust(g.tbs_bytes, b"\x00"),
                                             cfg.tbs))
        if res.sib1 is not None and out.sib1_pdu is not None:
            cfg = self._sh_config(res.sib1, slot, True, csi_rs=res.csi_rs)
            dl.pdcch_pdus.append(self._pdcch_pdu(res.sib1, slot))
            dl.pdsch_pdus.append(fapi.PdschPdu(cfg))
            tx.transport_blocks.append(_bits(out.sib1_pdu, cfg.tbs))
        if res.paging is not None and out.paging_pdu is not None:
            cfg = self._sh_config(res.paging, slot, True,
                                  csi_rs=res.csi_rs)
            dl.pdcch_pdus.append(self._pdcch_pdu(res.paging, slot))
            dl.pdsch_pdus.append(fapi.PdschPdu(cfg))
            tx.transport_blocks.append(_bits(out.paging_pdu, cfg.tbs))
        for g in res.ul_grants:
            ul.pusch_pdus.append(fapi.PuschPdu(
                self._sh_config(g, slot, False), harq_process=g.harq_pid,
                new_data=(g.rv == 0)))
        for p in res.pucch:
            if p.format == 1:
                ul.pucch_pdus.append(fapi.PucchPdu(
                    format1=PucchF1Config(
                        prb=p.prb, nof_harq_bits=p.nof_harq_bits,
                        initial_cyclic_shift=p.initial_cyclic_shift,
                        slot_in_frame=slot % self.cell.slots_per_frame),
                    rnti=p.rnti, harq_pid=p.harq_pid,
                    is_sr=(p.harq_pid == -1)))
            else:
                ul.pucch_pdus.append(fapi.PucchPdu(
                    format2=PucchF2Config(
                        prb_start=p.prb, nof_prb=1,
                        rnti=p.rnti, nof_uci_bits=p.nof_uci_bits,
                        slot_in_frame=slot % self.cell.slots_per_frame),
                    rnti=p.rnti))
        if res.prach_occasion:
            ul.prach_pdus.append(fapi.PrachPdu(
                root_sequence_index=self.cell.prach_root_sequence,
                length=139,
                zero_correlation_zone=self.cell.prach_zero_correlation_zone,
                sc_start=self.cell.prach_prb_start * 12,
                nof_preambles=self.cell.prach_nof_preambles))
        return dl, tx, ul, ul_dci


class FapiToMacTranslator:
    """Routes uplink indications into the MAC (fapi_to_mac_*)."""

    def __init__(self, mac: MacCellProcessor) -> None:
        self.mac = mac
        # HARQ-ACK context: which (rnti, harq) a PUCCH slot acknowledges
        self._ack_ctx: dict[tuple[int, int], list[tuple[int, int]]] = {}

    def register_ack_context(self, sfn: int, slot: int,
                             entries: list[tuple[int, int]]) -> None:
        self._ack_ctx[(sfn, slot)] = entries

    def handle_indications(self, indications: list) -> None:
        for ind in indications:
            if isinstance(ind, fapi.CrcIndication):
                self.mac.handle_crc_indication(ind.rnti, ind.harq_process,
                                               ind.tb_crc_ok, ind.sinr_db,
                                               ind.ta_samples)
            elif isinstance(ind, fapi.CsiIndication):
                self.mac.handle_csi_report(ind.rnti, ind.cqi)
            elif isinstance(ind, fapi.RxDataIndication):
                nof_bytes = len(ind.payload) // 8
                self.mac.handle_rx_pdu(
                    ind.rnti, _bytes(ind.payload[: nof_bytes * 8]))
            elif isinstance(ind, fapi.UciIndication):
                self._handle_uci(ind)
            elif isinstance(ind, fapi.RachIndication):
                for idx, _metric, delay in ind.preambles:
                    self.mac.handle_rach_indication(
                        ind.slot, ind.occasion, idx, int(delay))

    def _handle_uci(self, ind: fapi.UciIndication) -> None:
        """UCI routing: SR → scheduler, F2 CSI → CQI report, F1 HARQ →
        the HARQ process named by the PDU (fapi_to_mac uci routing)."""
        if ind.is_sr:
            if ind.detected:
                self.mac.scheduler.handle_sr_indication(ind.rnti)
            return
        if ind.uci_bits is not None:
            if ind.detected:
                bits = np.asarray(ind.uci_bits).astype(np.int64)
                cqi = 0
                for b in bits[:4]:
                    cqi = (cqi << 1) | int(b)
                self.mac.handle_csi_report(ind.rnti, cqi)
            return
        if ind.harq_bits is not None and ind.harq_pid >= 0:
            ack = bool(ind.detected) and bool(np.all(ind.harq_bits))
            self.mac.handle_harq_ack(ind.rnti, ind.harq_pid, ack)
            return
        # legacy path: slot-registered ack context
        ctx = self._ack_ctx.pop((ind.sfn, ind.slot), [])
        ack = bool(ind.detected) and (
            ind.harq_bits is None or bool(np.all(ind.harq_bits)))
        for rnti, harq in ctx:
            self.mac.handle_harq_ack(rnti, harq, ack)
