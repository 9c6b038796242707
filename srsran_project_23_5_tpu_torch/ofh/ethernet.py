"""VLAN Ethernet framing for OFH (reference lib/ofh/ethernet): frames
carry eCPRI (ethertype 0xAEFE) with an 802.1Q VLAN tag. Transport here
is any byte-pipe (UDP socket / in-memory queue) instead of a raw
AF_PACKET socket — raw sockets need CAP_NET_RAW the test environment
doesn't have; the frame layout is the same.
"""
from __future__ import annotations

import dataclasses
import struct

ETHERTYPE_ECPRI = 0xAEFE
ETHERTYPE_VLAN = 0x8100


@dataclasses.dataclass
class VlanFrameParams:
    dst_mac: bytes = b"\xff\xff\xff\xff\xff\xff"
    src_mac: bytes = b"\x02\x00\x00\x00\x00\x01"
    vlan_id: int = 1
    pcp: int = 7                 # priority


def encode(params: VlanFrameParams, payload: bytes) -> bytes:
    tci = (params.pcp << 13) | (params.vlan_id & 0xFFF)
    return (params.dst_mac + params.src_mac
            + struct.pack("!HH", ETHERTYPE_VLAN, tci)
            + struct.pack("!H", ETHERTYPE_ECPRI) + payload)


def decode(frame: bytes) -> tuple[VlanFrameParams, bytes]:
    dst, src = frame[:6], frame[6:12]
    et, tci = struct.unpack_from("!HH", frame, 12)
    assert et == ETHERTYPE_VLAN, "missing VLAN tag"
    inner_et = struct.unpack_from("!H", frame, 16)[0]
    assert inner_et == ETHERTYPE_ECPRI, "not an eCPRI frame"
    return VlanFrameParams(dst, src, tci & 0xFFF, tci >> 13), frame[18:]
