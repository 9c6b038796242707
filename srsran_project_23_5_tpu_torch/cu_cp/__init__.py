"""CU-CP: gNB control plane (reference lib/cu_cp).

Owns the NGAP endpoint (to AMF), F1AP-CU (to DUs), E1AP (to CU-UP) and
one RRC state machine per UE; runs the attach routine the reference
implements in lib/cu_cp/routines (UE context setup + PDU session
resource setup):

  InitialULRRCMessage(Msg3) → RRCSetup → RRCSetupComplete
  → NGAP InitialUEMessage → InitialContextSetup(K_gNB, sessions)
  → SecurityModeCommand/Complete
  → E1 BearerContextSetup (CU-UP) + F1 UEContextSetup (DU)
  → RRCReconfiguration/Complete → InitialContextSetupResponse
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .. import asn1, e1ap, f1ap, ngap, rrc
from ..support.srslog import get_logger


@dataclasses.dataclass
class CuUeContext:
    cue_id: int
    rrc_ue: rrc.RrcUe
    amf_ue_id: int = 0
    k_gnb: bytes = b""
    sessions: list = dataclasses.field(default_factory=list)
    drbs: list = dataclasses.field(default_factory=list)
    state: str = "initial"
    e1_done: bool = False
    f1_done: bool = False
    nas_queue: list = dataclasses.field(default_factory=list)


class CuCp:
    def __init__(self, amf_send: Callable[[bytes], None],
                 f1_send: Callable[[bytes], None],
                 e1_send: Optional[Callable[[bytes], None]] = None) -> None:
        self.log = get_logger("CU-CP", "warning")
        self.ngap = ngap.NgapCuCp(amf_send)
        self.f1ap = f1ap.F1apCu(f1_send)
        self.e1ap = e1ap.E1apCuCp(e1_send) if e1_send else None
        self.ues: dict[int, CuUeContext] = {}
        self.f1_setup_done = False

        self.f1ap.on_f1_setup = lambda m: setattr(self, "f1_setup_done",
                                                  True)
        self.f1ap.on_initial_ul_rrc = self._on_initial_ul_rrc
        self.f1ap.on_ul_rrc = self._on_ul_rrc
        self.f1ap.on_ue_context_setup_response = self._on_f1_ctx_response
        self.ngap.on_dl_nas = self._on_dl_nas
        self.ngap.on_initial_ctx = self._on_initial_ctx
        self.ngap.on_release = self._on_ngap_release
        if self.e1ap:
            self.e1ap.on_bearer_setup_response = self._on_e1_response

    def start(self) -> None:
        self.ngap.ng_setup()

    # ------------------------------------------------------- F1 (DU) side
    def _on_initial_ul_rrc(self, cue: int,
                           msg: f1ap.InitialUlRrcMessageTransfer) -> None:
        ue = CuUeContext(cue, rrc.RrcUe(
            cue,
            send_dl=lambda cont, c=cue: self.f1ap.dl_rrc(c, 0, cont),
            on_nas_ul=lambda nas, c=cue: self._on_ue_nas(c, nas),
            on_active=lambda r, c=cue: self._on_rrc_active(c)))
        self.ues[cue] = ue
        self.log.info("initial UL RRC for cue={}", cue)
        setup_req = rrc.decode_setup_request(msg.rrc_container)
        ue.rrc_ue.handle_setup_request(
            setup_req, du_cell_group=msg.du_to_cu_rrc_container)
        # after RRCSetup, DL-DCCH flows on SRB1
        ue.rrc_ue._send_dl = lambda cont, c=cue: self.f1ap.dl_rrc(c, 1, cont)

    def _on_ul_rrc(self, cue: int, srb: int, container: bytes) -> None:
        ue = self.ues.get(cue)
        if ue is None:
            return
        prev = ue.rrc_ue.state
        ue.rrc_ue.handle_ul_message(container)
        if (prev == rrc.RrcUeState.SMC_SENT
                and ue.rrc_ue.state == rrc.RrcUeState.SECURE):
            self._after_security(cue)

    def _on_ue_nas(self, cue: int, nas: bytes) -> None:
        ue = self.ues[cue]
        if ue.state == "initial":
            ue.state = "registering"
            self.ngap.initial_ue_message(cue, nas)
        else:
            self.ngap.ul_nas(ue.amf_ue_id, cue, nas)

    # ------------------------------------------------------ NGAP (AMF) side
    def _on_dl_nas(self, ran_ue_id: int, nas: bytes) -> None:
        ue = self.ues.get(ran_ue_id)
        if ue is not None:
            ue.rrc_ue.send_dl_nas(nas)

    def _on_initial_ctx(self, msg: ngap.InitialContextSetupRequest) -> None:
        ue = self.ues.get(msg.ran_ue_id)
        if ue is None:
            return
        ue.amf_ue_id = msg.amf_ue_id
        ue.k_gnb = msg.security_key
        ue.sessions = [asn1.decode(s) for s in msg.pdu_sessions]
        if msg.nas_pdu:
            ue.nas_queue.append(msg.nas_pdu)
        ue.state = "securing"
        ue.rrc_ue.start_security(ue.k_gnb)

    def _after_security(self, cue: int) -> None:
        ue = self.ues[cue]
        ue.state = "setting-up-bearers"
        ue.drbs = [rrc.DrbConfig(drb_id=i + 1, lcid=4 + i, qfi=s.qfi)
                   for i, s in enumerate(ue.sessions)]
        if self.e1ap is not None and ue.sessions:
            self.e1ap.bearer_setup(cue, ue.k_gnb, [
                e1ap.BearerSessionItem(s.session_id, d.drb_id, s.qfi,
                                       s.ul_teid)
                for s, d in zip(ue.sessions, ue.drbs)])
        else:
            ue.e1_done = True
        self.f1ap.ue_context_setup(cue, [1], [
            f1ap.DrbItem(d.drb_id, d.lcid, "am", d.qfi) for d in ue.drbs])

    def _on_e1_response(self, msg: e1ap.BearerContextSetupResponse) -> None:
        ue = self.ues.get(msg.cu_cp_ue_id)
        if ue is None:
            return
        ue.e1_done = True
        self._maybe_reconfigure(ue)

    def _on_f1_ctx_response(self, msg: f1ap.UeContextSetupResponse) -> None:
        ue = self.ues.get(msg.gnb_cu_ue_id)
        if ue is None:
            return
        ue.f1_done = True
        self._maybe_reconfigure(ue)

    def _maybe_reconfigure(self, ue: CuUeContext) -> None:
        if ue.e1_done and ue.f1_done and ue.state == "setting-up-bearers":
            ue.state = "reconfiguring"
            nas, ue.nas_queue = ue.nas_queue, []
            ue.rrc_ue.reconfigure(ue.drbs, nas)

    def _on_rrc_active(self, cue: int) -> None:
        ue = self.ues[cue]
        ue.state = "active"
        self.ngap.initial_ctx_response(ue.amf_ue_id, cue)
        if ue.sessions:
            self.ngap.pdu_session_response(ue.amf_ue_id, cue, [
                ngap.PduSessionItem(s.session_id, s.qfi, s.ul_teid,
                                    dl_teid=0x1000 + cue)
                for s in ue.sessions])

    def _on_ngap_release(self, ran_ue_id: int) -> None:
        self.f1ap.ue_release(ran_ue_id)
        self.ues.pop(ran_ue_id, None)

    # ------------------------------------------------------------- handlers
    def handle_f1_message(self, data: bytes) -> None:
        self.f1ap.handle_message(data)

    def handle_ngap_message(self, data: bytes) -> None:
        self.ngap.handle_message(data)

    def handle_e1_message(self, data: bytes) -> None:
        if self.e1ap:
            self.e1ap.handle_message(data)
