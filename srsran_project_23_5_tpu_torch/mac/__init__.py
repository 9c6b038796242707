"""MAC layer (TS 38.321; reference lib/mac).

- MacCellProcessor: slot-driven DL path — runs the scheduler, assembles
  DL-SCH MAC PDUs from RLC bearers (mac_cell_processor.cpp:77-287,
  dl_sch_pdu_assembler) and returns the slot's scheduling result + PDUs
  for the FAPI adaptor.
- UL path: decode UL-SCH PDUs, route LCID subPDUs to RLC bearers, BSR CEs
  to the scheduler, CCCH to the RRC/DU-manager hook (mac_ul pdu_rx_handler).
- RACH handling + contention resolution; RLF via the scheduler's
  consecutive-KO streaks (rlf_detector.h:34-84).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..scheduler import CellConfig, CellScheduler, SlotResult
from ..scheduler.results import DlGrant
from . import pdu as mac_pdu


@dataclasses.dataclass
class MacUe:
    rnti: int
    bearers: dict = dataclasses.field(default_factory=dict)  # lcid -> rlc
    conres_id: bytes = b""          # first 6 bytes of Msg3 CCCH


@dataclasses.dataclass
class MacSlotOutput:
    result: SlotResult
    dl_pdus: dict[tuple[int, int], bytes]   # (rnti, harq_pid) -> MAC PDU
    rar_pdus: dict[int, bytes]              # ra_rnti -> RAR MAC PDU
    sib1_pdu: Optional[bytes] = None
    paging_pdu: Optional[bytes] = None      # P-RNTI paging records


class MacCellProcessor:
    def __init__(self, cfg: CellConfig,
                 on_ccch: Optional[Callable[[int, bytes], None]] = None,
                 on_rlf: Optional[Callable[[int], None]] = None,
                 sib1_payload: bytes = b"\x40sib1",
                 pcap=None) -> None:
        self.cfg = cfg
        self.scheduler = CellScheduler(cfg)
        self.ues: dict[int, MacUe] = {}
        self._on_ccch = on_ccch or (lambda rnti, sdu: None)
        self._on_rlf = on_rlf or (lambda rnti: None)
        self.sib1_payload = sib1_payload
        self.pcap = pcap

    # ------------------------------------------------------------ UE mgmt
    def add_ue(self, rnti: int, bearers: dict) -> MacUe:
        """bearers: lcid -> RLC entity (with pull_pdu/handle_pdu/
        buffer_state)."""
        ue = MacUe(rnti, dict(bearers))
        self.ues[rnti] = ue
        if rnti not in self.scheduler.ues:
            self.scheduler.add_ue(rnti)
        return ue

    def remove_ue(self, rnti: int) -> None:
        self.ues.pop(rnti, None)
        self.scheduler.remove_ue(rnti)

    def add_bearer(self, rnti: int, lcid: int, rlc_entity) -> None:
        self.ues[rnti].bearers[lcid] = rlc_entity

    # ------------------------------------------------------------ DL slot
    def handle_slot_indication(self, slot: int) -> MacSlotOutput:
        # refresh DL buffer states from RLC (the reference pushes these
        # event-driven; polling per slot is equivalent here)
        for rnti, ue in self.ues.items():
            for lcid, rlc in ue.bearers.items():
                self.scheduler.handle_dl_buffer_state(rnti, lcid,
                                                      rlc.buffer_state())
        res = self.scheduler.run_slot(slot)
        for rnti in self.scheduler.rlf_ues:
            self._on_rlf(rnti)
        self.scheduler.rlf_ues.clear()
        out = MacSlotOutput(res, {}, {})
        if res.sib1 is not None:
            out.sib1_pdu = self.sib1_payload.ljust(res.sib1.tbs_bytes,
                                                   b"\x00")
        if res.paging is not None:
            # paging record list: length-prefixed UE identities
            recs = res.paging_records
            body = b"".join(bytes([len(r)]) + r for r in recs)
            out.paging_pdu = body.ljust(res.paging.tbs_bytes, b"\x00")
        for rar in res.rars:
            grant_bits = self._pack_rar_ul_grant(rar.msg3_grant)
            out.rar_pdus[rar.ra_rnti] = mac_pdu.encode_rar_pdu(
                [mac_pdu.RarGrant(rar.rapid, rar.ta, grant_bits,
                                  rar.tc_rnti)])
        for g in res.dl_grants:
            if g.is_rar or g.is_sib:
                continue
            out.dl_pdus[(g.rnti, g.harq_pid)] = self._assemble_dl_pdu(g)
        return out

    @staticmethod
    def _pack_rar_ul_grant(msg3) -> int:
        """Pack Msg3 PRBs/MCS into the 27-bit RAR UL grant (simplified
        TS 38.213 Table 8.2-1 layout: prb_start(10)|prb_len(7)|mcs(4))."""
        return ((msg3.prb_start & 0x3FF) << 17) \
            | ((msg3.prb_len & 0x7F) << 10) | ((msg3.mcs & 0xF) << 6)

    @staticmethod
    def unpack_rar_ul_grant(grant: int) -> tuple[int, int, int]:
        return (grant >> 17) & 0x3FF, (grant >> 10) & 0x7F, (grant >> 6) & 0xF

    def _assemble_dl_pdu(self, g: DlGrant) -> bytes:
        ue = self.ues.get(g.rnti)
        budget = g.tbs_bytes
        subpdus: list[mac_pdu.SubPdu] = []
        if ue is not None:
            sched_ue = self.scheduler.ues.get(g.rnti)
            if sched_ue is not None and sched_ue.pending_conres:
                subpdus.append(mac_pdu.ce_con_res(ue.conres_id))
                budget -= 7
                sched_ue.pending_conres = False
            if sched_ue is not None and sched_ue.pending_ta_cmd is not None:
                # uplink time-alignment maintenance: residual PUSCH TA →
                # TA command CE (ta_cmd CE in dl_sch_pdu_assembler)
                subpdus.append(mac_pdu.ce_ta_cmd(sched_ue.pending_ta_cmd))
                budget -= 2
                sched_ue.pending_ta_cmd = None
            for lcid in sorted(ue.bearers):
                rlc = ue.bearers[lcid]
                while budget > 3 and rlc.buffer_state() > 0:
                    sdu = rlc.pull_pdu(budget - 3)
                    if not sdu:
                        break
                    subpdus.append(mac_pdu.SubPdu(lcid, sdu))
                    budget -= len(sdu) + (2 if len(sdu) < 256 else 3)
        out = mac_pdu.encode_pdu(subpdus, g.tbs_bytes, uplink=False)
        if self.pcap is not None:
            self.pcap.push_pdu(out, rnti=g.rnti, direction=1,
                               harq_id=g.harq_pid)
        return out

    # ------------------------------------------------------------ UL path
    def handle_rx_pdu(self, rnti: int, data: bytes) -> None:
        """UL-SCH MAC PDU from a decoded PUSCH (pdu_rx_handler.cpp)."""
        if self.pcap is not None:
            self.pcap.push_pdu(data, rnti=rnti, direction=0)
        for sp in mac_pdu.decode_pdu(data, uplink=True):
            if sp.lcid in (mac_pdu.LCID_UL_CCCH, mac_pdu.LCID_UL_CCCH48):
                ue = self.ues.get(rnti)
                if ue is None:
                    ue = self.add_ue(rnti, {})
                ue.conres_id = sp.payload[:6]
                self.scheduler.ues[rnti].pending_conres = True
                self._on_ccch(rnti, sp.payload)
            elif sp.lcid in (mac_pdu.LCID_SHORT_BSR,
                             mac_pdu.LCID_SHORT_TRUNC_BSR):
                _lcg, nof_bytes = mac_pdu.parse_short_bsr(sp.payload)
                self.scheduler.handle_bsr(rnti, nof_bytes)
            elif sp.lcid == mac_pdu.LCID_C_RNTI:
                pass                       # RA with C-RNTI: not in v1
            elif mac_pdu.MIN_LC_LCID <= sp.lcid <= mac_pdu.MAX_LC_LCID:
                ue = self.ues.get(rnti)
                if ue is not None and sp.lcid in ue.bearers:
                    ue.bearers[sp.lcid].handle_pdu(sp.payload)

    # ------------------------------------------------------- indications
    def handle_rach_indication(self, slot: int, occasion: int,
                               preamble: int, ta: int = 0) -> None:
        self.scheduler.handle_rach_indication(slot, occasion, preamble, ta)

    def handle_csi_report(self, rnti: int, cqi: int) -> None:
        self.scheduler.handle_csi_report(rnti, cqi)

    def handle_crc_indication(self, rnti: int, harq_pid: int,
                              ok: bool, sinr_db: float | None = None,
                              ta_samples: float | None = None) -> None:
        self.scheduler.handle_crc_indication(rnti, harq_pid, ok, sinr_db,
                                             ta_samples)

    def handle_harq_ack(self, rnti: int, harq_pid: int, ack: bool) -> None:
        self.scheduler.handle_harq_ack(rnti, harq_pid, ack)
