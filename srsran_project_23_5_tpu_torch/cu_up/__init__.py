"""CU-UP: gNB user plane (reference lib/cu_up).

PDU session manager: NG-U GTP-U endpoint ↔ SDAP ↔ PDCP ↔ F1-U bearers.
Bearer contexts are created by E1AP BearerContextSetup from the CU-CP;
downlink core packets flow GTP-U→SDAP→PDCP→F1-U(→DU RLC), uplink the
reverse.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .. import e1ap, f1u, gtpu, pdcp, sdap
from .. import security as sec
from ..support.timers import TimerManager


@dataclasses.dataclass
class _Bearer:
    session_id: int
    drb_id: int
    qfi: int
    ul_teid: int          # core's TEID for uplink G-PDUs
    dl_teid: int          # our TEID the core addresses downlink to
    pdcp_entity: pdcp.PdcpEntity
    f1u_bearer: f1u.F1uBearer


class CuUp:
    def __init__(self, e1_send: Callable[[bytes], None],
                 ngu_send: Callable[[bytes], None],
                 timers: Optional[TimerManager] = None) -> None:
        self.e1ap = e1ap.E1apCuUp(e1_send)
        self.e1ap.on_bearer_setup = self._on_bearer_setup
        self.e1ap.on_bearer_release = self._on_bearer_release
        self._ngu_send = ngu_send        # raw GTP-U PDUs toward the core
        self.demux = gtpu.GtpuDemux()
        self.timers = timers or TimerManager()
        self._next_ue_id = 1
        self._next_teid = 0x2000
        self.ues: dict[int, list[_Bearer]] = {}
        # hook for the app to join a new DRB to the DU side:
        # f(cu_cp_ue_id, drb_id, lcid?) -> F1uBearer (CU side, connected)
        self.create_f1u_bearer: Callable[[int, int], f1u.F1uBearer] = \
            lambda ue, drb: f1u.create_local_connector()[0]

    def start(self) -> None:
        self.e1ap.e1_setup()

    # -------------------------------------------------------------- E1AP
    def _on_bearer_setup(self, msg: e1ap.BearerContextSetupRequest
                         ) -> tuple[int, list]:
        from .. import asn1
        ue_id = self._next_ue_id
        self._next_ue_id += 1
        ctx = sec.SecurityContext(msg.security_key) if msg.security_key \
            else None
        bearers = []
        dl_teids = []
        for item_raw in msg.pdu_sessions:
            item = asn1.decode(item_raw)
            dl_teid = self._next_teid
            self._next_teid += 1
            fb = self.create_f1u_bearer(msg.cu_cp_ue_id, item.drb_id)
            entity = pdcp.PdcpEntity(
                pdcp.PdcpConfig(sn_size=18, is_srb=False, integrity=False,
                                bearer_id=item.drb_id, direction=1),
                ctx,
                on_tx_pdu=fb.transmit,
                on_rx_sdu=lambda sdu, it=item: self._ul_sdu(it, sdu),
                timers=self.timers)
            fb.on_rx = entity.handle_pdu
            b = _Bearer(item.session_id, item.drb_id, item.qfi,
                        item.ul_teid, dl_teid, entity, fb)
            bearers.append(b)
            dl_teids.append(dl_teid)
            self.demux.add_tunnel(
                dl_teid, lambda h, p, bb=b: bb.pdcp_entity.handle_sdu(p))
        self.ues[ue_id] = bearers
        return ue_id, dl_teids

    def _on_bearer_release(self, ue_id: int) -> None:
        for b in self.ues.pop(ue_id, []):
            self.demux.remove_tunnel(b.dl_teid)

    # ---------------------------------------------------------- data path
    def _ul_sdu(self, item, sdu: bytes) -> None:
        """Uplink PDCP SDU → GTP-U toward the core."""
        self._ngu_send(gtpu.encode(
            gtpu.GtpuHeader(item.ul_teid, qfi=item.qfi), sdu))

    def handle_ngu_pdu(self, data: bytes) -> bool:
        """Downlink G-PDU from the core."""
        return self.demux.handle_pdu(data)

    def handle_e1_message(self, data: bytes) -> None:
        self.e1ap.handle_message(data)
