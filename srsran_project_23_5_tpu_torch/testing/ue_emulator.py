"""UE emulator: MAC/RLC/PDCP/RRC UE side for full-stack integration tests.

Plays the UE role against a DuHigh + CuCp/CuUp stack at the MAC PDU
level (the PHY is exercised separately; the reference does the same in
du_high_test.cpp, driving MAC PDUs directly with a phy_dummy).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .. import pdcp, rlc, rrc
from .. import security as sec
from ..mac import MacCellProcessor, MacSlotOutput, pdu as mac_pdu
from ..support.timers import TimerManager


class UeEmulator:
    def __init__(self, preamble: int = 23,
                 timers: Optional[TimerManager] = None) -> None:
        self.timers = timers or TimerManager()
        self.preamble = preamble
        self.rnti: Optional[int] = None
        # uplink time alignment (samples at the carrier rate): set from
        # the RAR TA, maintained by TA command CEs
        self.timing_advance_samples: float = 0.0
        self.last_cqi: int = 0           # CSI-RS measurement for PUCCH F2
        self.nof_sib1_decoded = 0
        self.conres_ok = False
        self.ip_rx: list[bytes] = []           # DL user-plane deliveries
        self._ul_ip_q: list[bytes] = []
        self._msg3: bytes = b""
        self.srb1 = rlc.RlcAmEntity(rlc.RlcAmConfig(t_reassembly=20),
                                    self._on_srb1_sdu, self.timers)
        self.rrc = rrc.RrcUeSide(send_ul=self.srb1.handle_sdu)
        self.drb_rlc: dict[int, rlc.RlcAmEntity] = {}   # lcid -> entity
        self.drb_pdcp: dict[int, pdcp.PdcpEntity] = {}
        self._sec_ctx: Optional[sec.SecurityContext] = None
        self.k_gnb = b"\x07" * 32             # same root key as AmfStub

    # ------------------------------------------------------------ access
    def want_prach(self) -> bool:
        return self.rnti is None

    def build_msg3(self, ue_identity: bytes = b"\xaa\xbb\xcc\xdd\xee\xff"
                   ) -> bytes:
        self._msg3 = self.rrc.connect(ue_identity, b"nas-registration")
        return self._msg3

    # ------------------------------------------------------------- RRC/UP
    def _on_srb1_sdu(self, sdu: bytes) -> None:
        prev_state = self.rrc.state
        self.rrc.handle_dl_message(sdu)
        if (prev_state != rrc.RrcUeState.SECURE
                and self.rrc.state == rrc.RrcUeState.SECURE):
            self._sec_ctx = sec.SecurityContext(
                self.k_gnb, sec.CipheringAlgorithm(self.rrc.ciphering),
                sec.IntegrityAlgorithm(self.rrc.integrity))
        if self.rrc.state == rrc.RrcUeState.ACTIVE and not self.drb_rlc:
            for d in self.rrc.drbs:
                self._setup_drb(d)

    def _setup_drb(self, d) -> None:
        entity = rlc.RlcAmEntity(rlc.RlcAmConfig(),
                                 lambda p, dd=d: self.drb_pdcp[
                                     dd.lcid].handle_pdu(p),
                                 self.timers)
        pd = pdcp.PdcpEntity(
            pdcp.PdcpConfig(sn_size=18, is_srb=False, integrity=False,
                            bearer_id=d.drb_id, direction=0),
            self._sec_ctx,
            on_tx_pdu=entity.handle_sdu,
            on_rx_sdu=self.ip_rx.append,
            timers=self.timers)
        self.drb_rlc[d.lcid] = entity
        self.drb_pdcp[d.lcid] = pd
        for pkt in self._ul_ip_q:
            pd.handle_sdu(pkt)
        self._ul_ip_q.clear()

    def send_ip_packet(self, pkt: bytes) -> None:
        if self.drb_pdcp:
            next(iter(self.drb_pdcp.values())).handle_sdu(pkt)
        else:
            self._ul_ip_q.append(pkt)

    # --------------------------------------------------------- MAC driving
    def step(self, mac: MacCellProcessor, out: MacSlotOutput,
             slot: int) -> None:
        """Process one slot's MAC output and feed uplink back (emulating
        the radio round-trip the PHY loopback provides in the full app)."""
        self.timers.tick(1)
        res = out.result
        if res.prach_occasion and self.want_prach():
            mac.handle_rach_indication(slot, 0, self.preamble, ta=0)
        for ra_rnti, rar_wire in out.rar_pdus.items():
            for g in mac_pdu.decode_rar_pdu(rar_wire):
                if g.rapid == self.preamble and self.rnti is None:
                    self.rnti = g.tc_rnti
        for ug in res.ul_grants:
            if ug.rnti != self.rnti:
                continue
            wire = self.build_ul_pdu(ug)
            mac.handle_rx_pdu(ug.rnti, wire)
            mac.handle_crc_indication(ug.rnti, ug.harq_pid, True)
        for (rnti, pid), wire in out.dl_pdus.items():
            if rnti != self.rnti:
                continue
            self.consume_dl_pdu(wire)
            mac.handle_harq_ack(rnti, pid, True)
        # keep the gNB aware of pending UL data (standing BSR)
        if self.rnti is not None and self._ul_buffer():
            mac.scheduler.handle_bsr(self.rnti, self._ul_buffer())

    def build_ul_pdu(self, ug) -> bytes:
        """Assemble the UL-SCH MAC PDU for a grant (the app's PHY loop
        transmits this through PUSCH; step() short-circuits it)."""
        if ug.is_msg3:
            return mac_pdu.encode_pdu(
                [mac_pdu.SubPdu(mac_pdu.LCID_UL_CCCH,
                                self._msg3 or self.build_msg3())],
                ug.tbs_bytes, uplink=True)
        subs = []
        budget = ug.tbs_bytes - 4
        for lcid, ent in [(1, self.srb1)] + sorted(self.drb_rlc.items()):
            while budget > 3 and ent.buffer_state() > 0:
                sdu = ent.pull_pdu(budget - 3)
                if not sdu:
                    break
                subs.append(mac_pdu.SubPdu(lcid, sdu))
                budget -= len(sdu) + 3
        subs.append(mac_pdu.ce_short_bsr(0, self._ul_buffer()))
        return mac_pdu.encode_pdu(subs, ug.tbs_bytes, uplink=True)

    def consume_dl_pdu(self, wire: bytes) -> None:
        for sp in mac_pdu.decode_pdu(wire):
            if sp.lcid == mac_pdu.LCID_DL_CON_RES:
                self.conres_ok = True
            elif sp.lcid == mac_pdu.LCID_DL_TA_CMD:
                self.timing_advance_samples += mac_pdu.parse_ta_cmd(
                    sp.payload)
            elif sp.lcid == 1:
                self.srb1.handle_pdu(sp.payload)
            elif sp.lcid in self.drb_rlc:
                self.drb_rlc[sp.lcid].handle_pdu(sp.payload)

    def _ul_buffer(self) -> int:
        n = self.srb1.buffer_state()
        for ent in self.drb_rlc.values():
            n += ent.buffer_state()
        return n
