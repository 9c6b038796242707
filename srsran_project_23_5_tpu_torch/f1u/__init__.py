"""F1-U: CU-UP ↔ DU user-plane connector (TS 38.425 NR-U framing;
reference lib/f1u/local_connector for the co-located CU/DU case).

The local connector joins a CU-UP bearer and a DU bearer in-process —
downlink PDCP PDUs flow CU→DU with transmit/delivery notifications back,
uplink PDCP PDUs flow DU→CU. A socket-backed variant can replace it
without changing either side (same handler interfaces).
"""
from __future__ import annotations

import struct
from typing import Callable, Optional


def nru_dl_encode(pdcp_pdu: bytes, nru_sn: int) -> bytes:
    """Minimal NR-U DL USER DATA (PDU Type 0) frame: type/flags + NR-U SN."""
    return struct.pack("!BBH", 0x00, 0x00, nru_sn & 0xFFFF) + pdcp_pdu


def nru_dl_decode(data: bytes) -> tuple[int, bytes]:
    _t, _f, sn = struct.unpack_from("!BBH", data)
    return sn, data[4:]


def nru_status_encode(highest_delivered: int) -> bytes:
    """DL DATA DELIVERY STATUS (PDU Type 1), delivered NR-U SN only."""
    return struct.pack("!BBH", 0x10, 0x01, highest_delivered & 0xFFFF)


def nru_status_decode(data: bytes) -> int:
    _t, _f, sn = struct.unpack_from("!BBH", data)
    return sn


class F1uBearer:
    """One side of an F1-U bearer."""

    def __init__(self) -> None:
        self.on_rx: Optional[Callable[[bytes], None]] = None
        self._peer: Optional["F1uBearer"] = None
        self.tx_sn = 0
        self.highest_delivered = -1

    def connect(self, peer: "F1uBearer") -> None:
        self._peer = peer
        peer._peer = self

    def transmit(self, pdcp_pdu: bytes) -> None:
        assert self._peer is not None, "bearer not connected"
        frame = nru_dl_encode(pdcp_pdu, self.tx_sn)
        self.tx_sn = (self.tx_sn + 1) & 0xFFFF
        self._peer._receive(frame)

    def _receive(self, frame: bytes) -> None:
        sn, pdu = nru_dl_decode(frame)
        self.highest_delivered = sn
        if self.on_rx is not None:
            self.on_rx(pdu)


def create_local_connector() -> tuple[F1uBearer, F1uBearer]:
    """(cu_side, du_side) joined in-process."""
    cu, du = F1uBearer(), F1uBearer()
    cu.connect(du)
    return cu, du


class LocalF1uBroker:
    """Pairs the CU-UP and DU ends of each (cu_ue_id, drb_id) bearer when
    the two sides are co-located (the reference's
    lib/f1u/local_connector factory)."""

    def __init__(self) -> None:
        self._pairs: dict[tuple[int, int], tuple[F1uBearer, F1uBearer]] = {}

    def _pair(self, key: tuple[int, int]) -> tuple[F1uBearer, F1uBearer]:
        if key not in self._pairs:
            self._pairs[key] = create_local_connector()
        return self._pairs[key]

    def cu_side(self, cu_ue_id: int, drb_id: int) -> F1uBearer:
        return self._pair((cu_ue_id, drb_id))[0]

    def du_side(self, cu_ue_id: int, drb_id: int) -> F1uBearer:
        return self._pair((cu_ue_id, drb_id))[1]
