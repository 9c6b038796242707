"""GTP-U (TS 29.281; reference lib/gtpu): header serdes, tunnel entities,
TEID demux over a UDP gateway."""
from __future__ import annotations

import dataclasses
import struct
from typing import Callable, Optional

GTPU_PORT = 2152
MSG_GPDU = 0xFF
MSG_ECHO_REQ = 1
MSG_ECHO_RSP = 2
MSG_ERROR_IND = 26
MSG_END_MARKER = 254

EXT_PDU_SESSION_CONTAINER = 0x85


@dataclasses.dataclass
class GtpuHeader:
    teid: int
    msg_type: int = MSG_GPDU
    seq: Optional[int] = None
    qfi: Optional[int] = None        # via PDU-session-container extension
    pdu_type: int = 0                # 0 = DL PDU SESSION INFORMATION


def encode(h: GtpuHeader, payload: bytes) -> bytes:
    flags = 0x30                     # version 1, PT=1
    if h.qfi is not None:
        flags |= 0x04                # E
    if h.seq is not None:
        flags |= 0x02                # S
    opt = ext = b""
    if flags & 0x07:
        next_ext = EXT_PDU_SESSION_CONTAINER if h.qfi is not None else 0
        opt = struct.pack("!HBB", h.seq or 0, 0, next_ext)
        if h.qfi is not None:
            # ext = len (4-byte units) | pdu_type/spare | qfi | next-ext=0
            content = bytes([(h.pdu_type & 0xF) << 4, h.qfi & 0x3F])
            total = 1 + len(content) + 1     # len byte + content + next byte
            pad = (-total) % 4
            content += b"\x00" * pad
            ext = bytes([(total + pad) // 4]) + content + b"\x00"
    length = len(payload) + len(opt) + len(ext)
    hdr = struct.pack("!BBHI", flags, h.msg_type, length, h.teid)
    return hdr + opt + ext + payload


def decode(data: bytes) -> tuple[GtpuHeader, bytes]:
    flags, msg_type, length, teid = struct.unpack_from("!BBHI", data)
    assert flags >> 5 == 1, "GTP version must be 1"
    off = 8
    h = GtpuHeader(teid, msg_type)
    next_ext = 0
    if flags & 0x07:
        seq, _npdu, next_ext = struct.unpack_from("!HBB", data, off)
        if flags & 0x02:
            h.seq = seq
        off += 4
    while next_ext:
        ext_len = data[off] * 4
        if next_ext == EXT_PDU_SESSION_CONTAINER:
            h.pdu_type = data[off + 1] >> 4
            h.qfi = data[off + 2] & 0x3F
        next_ext = data[off + ext_len - 1]
        off += ext_len
    return h, data[off:8 + length]


class GtpuDemux:
    """TEID → tunnel dispatch (gtpu_demux_impl in lib/gtpu)."""

    def __init__(self) -> None:
        self._tunnels: dict[int, Callable[[GtpuHeader, bytes], None]] = {}

    def add_tunnel(self, teid: int,
                   handler: Callable[[GtpuHeader, bytes], None]) -> None:
        self._tunnels[teid] = handler

    def remove_tunnel(self, teid: int) -> None:
        self._tunnels.pop(teid, None)

    def handle_pdu(self, data: bytes) -> bool:
        h, payload = decode(data)
        fn = self._tunnels.get(h.teid)
        if fn is None:
            return False
        fn(h, payload)
        return True


class GtpuTunnelTx:
    """NG-U uplink/downlink tunnel transmitter."""

    def __init__(self, teid: int, send: Callable[[bytes], None],
                 qfi: Optional[int] = None) -> None:
        self.teid = teid
        self.qfi = qfi
        self._send = send

    def handle_sdu(self, sdu: bytes) -> None:
        self._send(encode(GtpuHeader(self.teid, qfi=self.qfi), sdu))
