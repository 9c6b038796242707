"""eCPRI packet serdes (eCPRI spec v2; reference lib/ofh/ecpri).

Common header: 1B (version|reserved|concatenation) | 1B message type |
2B payload size, then per-type subheader: IQ data (type 0) and
real-time control (type 2) carry PC_ID/RTC_ID + SEQ_ID.
"""
from __future__ import annotations

import dataclasses
import struct

ECPRI_VERSION = 1
MSG_TYPE_IQ_DATA = 0
MSG_TYPE_RT_CONTROL = 2


@dataclasses.dataclass
class EcpriHeader:
    msg_type: int
    pc_id: int                 # eAxC id (or RTC id for control)
    seq_id: int


def encode(h: EcpriHeader, payload: bytes) -> bytes:
    first = (ECPRI_VERSION << 4) | 0   # no concatenation
    body = struct.pack("!HH", h.pc_id & 0xFFFF, h.seq_id & 0xFFFF) + payload
    return struct.pack("!BBH", first, h.msg_type, len(body)) + body


def decode(data: bytes) -> tuple[EcpriHeader, bytes]:
    first, msg_type, size = struct.unpack_from("!BBH", data)
    assert first >> 4 == ECPRI_VERSION, "bad eCPRI version"
    pc_id, seq_id = struct.unpack_from("!HH", data, 4)
    return EcpriHeader(msg_type, pc_id, seq_id), data[8:4 + size]
