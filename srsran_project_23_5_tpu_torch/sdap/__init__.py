"""SDAP layer (TS 37.324; reference lib/sdap): QoS-flow ↔ DRB mapping
with optional SDAP header (D/C, QFI)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass
class SdapConfig:
    default_drb: int = 1
    header_dl: bool = False
    header_ul: bool = False


class SdapEntity:
    """Maps QFI→DRB downlink and DRB→QFI uplink
    (sdap_entity_impl in lib/sdap)."""

    def __init__(self, cfg: SdapConfig,
                 on_dl_pdu: Callable[[int, bytes], None],
                 on_ul_sdu: Callable[[int, bytes], None]) -> None:
        self.cfg = cfg
        self._qfi_to_drb: dict[int, int] = {}
        self._drb_to_qfi: dict[int, int] = {}
        self._on_dl_pdu = on_dl_pdu      # (drb_id, pdu)
        self._on_ul_sdu = on_ul_sdu      # (qfi, sdu)

    def add_mapping(self, qfi: int, drb_id: int) -> None:
        self._qfi_to_drb[qfi] = drb_id
        self._drb_to_qfi[drb_id] = qfi

    def handle_dl_sdu(self, sdu: bytes, qfi: int) -> None:
        drb = self._qfi_to_drb.get(qfi, self.cfg.default_drb)
        pdu = sdu
        if self.cfg.header_dl:
            pdu = bytes([0x80 | (qfi & 0x3F)]) + sdu   # D/C=1, RDI/RQI=0
        self._on_dl_pdu(drb, pdu)

    def handle_ul_pdu(self, pdu: bytes, drb_id: int) -> None:
        if self.cfg.header_ul:
            qfi = pdu[0] & 0x3F
            self._on_ul_sdu(qfi, pdu[1:])
        else:
            self._on_ul_sdu(self._drb_to_qfi.get(drb_id, 0), pdu)
