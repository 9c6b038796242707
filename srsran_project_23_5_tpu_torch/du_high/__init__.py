"""DU-high: MAC + RLC + F1AP-DU glue (reference lib/du_high +
lib/du_manager).

Per-UE bearer management: SRB1 (RLC AM over LCID 1) carries RRC between
the MAC and the CU via F1AP RRC message transfers; DRBs are created on
F1AP UE Context Setup and joined to the CU-UP through F1-U bearers.
run_slot() drives the MAC cell processor (the FAPI adaptor consumes its
output).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .. import asn1, du_manager, f1ap, f1u, rlc
from ..mac import MacCellProcessor, MacSlotOutput
from ..rrc import messages_38331 as m38331
from ..scheduler import CellConfig
from ..support.srslog import get_logger
from ..support.timers import TimerManager


@dataclasses.dataclass
class _DuUe:
    rnti: int
    due_id: int
    srb1: rlc.RlcAmEntity
    drbs: dict = dataclasses.field(default_factory=dict)  # drb_id -> entity


class DuHigh:
    def __init__(self, cfg: CellConfig,
                 f1_send: Callable[[bytes], None],
                 f1u_broker: Optional[f1u.LocalF1uBroker] = None,
                 timers: Optional[TimerManager] = None,
                 mac_pcap=None) -> None:
        self.log = get_logger("DU", "warning")
        self.cfg = cfg
        self.timers = timers or TimerManager()
        self.f1u_broker = f1u_broker or f1u.LocalF1uBroker()
        self.mac = MacCellProcessor(cfg, on_ccch=self._on_ccch,
                                    on_rlf=self._on_rlf, pcap=mac_pcap)
        self.f1ap = f1ap.F1apDu(f1_send)
        self.f1ap.on_dl_rrc = self._on_dl_rrc
        self.f1ap.on_ue_context_setup = self._on_ue_context_setup
        self.f1ap.on_ue_release = self._on_ue_release
        self.ues: dict[int, _DuUe] = {}          # due_id -> ue
        self._rnti_to_due: dict[int, int] = {}
        # du_manager layer: cell validation + pooled per-UE resources.
        # The PUCCH pool is SHARED with the scheduler (one allocation per
        # RNTI serves both the scheduler's opportunity checks and the
        # RRC-delivered dedicated config).
        du_manager.DuCellManager().add_cell(cfg)
        self.ue_mgr = du_manager.DuUeManager(
            cfg, pucch_mgr=self.mac.scheduler.pucch_mgr)

    def start(self) -> None:
        self.f1ap.f1_setup([self.cfg.pci])

    # ------------------------------------------------------------ uplink
    def _on_ccch(self, rnti: int, ccch_sdu: bytes) -> None:
        """Msg3 CCCH → Initial UL RRC Message Transfer + SRB1 creation
        (du_manager ue_creation_procedure). The UE context is created
        BEFORE sending — the CU can answer synchronously."""
        due = self.f1ap.allocate_due_id()
        try:
            res = self.ue_mgr.create_ue(rnti, due)  # pooled PUCCH + SRB1
        except du_manager.ResourceExhausted as e:
            # creation fails cleanly; the UE's RA attempt times out and
            # retries later (ue_creation_procedure.cpp failure path)
            self.log.warning("UE creation rejected rnti={:#x}: {}",
                             rnti, e)
            return
        srb1 = rlc.RlcAmEntity(
            rlc.RlcAmConfig(t_reassembly=20),
            on_sdu=lambda sdu, d=due: self.f1ap.ul_rrc(d, 1, sdu),
            timers=self.timers)
        ue = _DuUe(rnti, due, srb1)
        self.ues[due] = ue
        self._rnti_to_due[rnti] = due
        self.mac.add_bearer(rnti, 1, srb1)
        self.f1ap.initial_ul_rrc(due, rnti, self.cfg.pci, ccch_sdu,
                                 self._du_to_cu_container(res))

    def _du_to_cu_container(self, res) -> bytes:
        """DUtoCURRCContainer: the DU's CellGroupConfig — SRB1's RLC
        bearer plus the pooled PUCCH allocation as dedicated uplink
        config (the CU embeds it verbatim in RRCSetup's
        masterCellGroup, as in f1ap_du_ue_context_update)."""
        a = res.pucch
        return m38331.encode_cell_group({
            "cellGroupId": 0,
            "rlc-BearerToAddModList": [{
                "logicalChannelIdentity": 1,
                "servedRadioBearer": ("srb-Identity", 1)}],
            "spCellConfig": m38331.build_sp_cell_config(
                sr={"res_id": a.sr.resource.res_id,
                    "prb": a.sr.resource.prb,
                    "cs": a.sr.resource.initial_cyclic_shift,
                    "period_slots": a.sr.period_slots,
                    "offset": a.sr.offset},
                csi={"res_id": a.csi.resource.res_id,
                     "prb": a.csi.resource.prb_start,
                     "nof_prb": a.csi.resource.nof_prb,
                     "period_slots": a.csi.period_slots,
                     "offset": a.csi.offset})})

    # ---------------------------------------------------------- downlink
    def _on_dl_rrc(self, due: int, srb_id: int, container: bytes) -> None:
        ue = self.ues.get(due)
        if ue is None:
            return
        # SRB0 (CCCH) rides TM — deliver via SRB1's AM too (the MAC PDU
        # carries LCID 1 either way; the UE-side RRC does not distinguish)
        ue.srb1.handle_sdu(container)

    def _on_ue_context_setup(self, msg: f1ap.UeContextSetupRequest) -> list:
        ue = self.ues.get(msg.gnb_du_ue_id)
        if ue is None:
            return []
        created = []
        items = [asn1.decode(raw) for raw in msg.drbs_to_setup]
        lcids = self.ue_mgr.configure_drbs(msg.gnb_du_ue_id,
                                           [it.drb_id for it in items])
        for item in items:
            lcid = lcids[item.drb_id]
            if lcid != item.lcid:
                self.log.warning("lcid override drb={} cu={} du={}",
                                 item.drb_id, item.lcid, lcid)
            fb = self.f1u_broker.du_side(msg.gnb_cu_ue_id, item.drb_id)
            entity = rlc.RlcAmEntity(
                rlc.RlcAmConfig(),
                on_sdu=fb.transmit,                  # UL: RLC SDU → F1-U
                timers=self.timers)
            fb.on_rx = entity.handle_sdu             # DL: F1-U → RLC queue
            ue.drbs[item.drb_id] = entity
            self.mac.add_bearer(ue.rnti, lcid, entity)
            created.append(item.drb_id)
        self.log.info("UE ctx setup due={} drbs={}", msg.gnb_du_ue_id,
                      created)
        return created

    def _on_ue_release(self, due: int) -> None:
        ue = self.ues.pop(due, None)
        if ue is not None:
            self._rnti_to_due.pop(ue.rnti, None)
            self.ue_mgr.delete_ue(due)       # PUCCH/LCIDs back to pools
            self.mac.remove_ue(ue.rnti)

    def _on_rlf(self, rnti: int) -> None:
        self.log.warning("RLF detected rnti={:#x}", rnti)

    # ----------------------------------------------------------- slot I/O
    def run_slot(self, slot: int) -> MacSlotOutput:
        self.timers.tick(1)
        return self.mac.handle_slot_indication(slot)

    def handle_f1_message(self, data: bytes) -> None:
        self.f1ap.handle_message(data)
