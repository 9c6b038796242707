"""RLC PDU header encode/decode (TS 38.322 §6.2.2).

Reference: lib/rlc/rlc_um_pdu.h / rlc_am_pdu.h — re-expressed as pure
functions over bytes.

Segmentation info (SI): 00 full SDU, 01 first segment, 10 last segment,
11 middle segment. SO (segment offset, 16 bit) present for SI in {10,11}.
"""
from __future__ import annotations

import dataclasses
import struct

SI_FULL = 0b00
SI_FIRST = 0b01
SI_LAST = 0b10
SI_MIDDLE = 0b11


@dataclasses.dataclass
class UmHeader:
    si: int
    sn: int = 0          # absent on-wire when si == SI_FULL
    so: int = 0          # present when si in {SI_LAST, SI_MIDDLE}
    sn_size: int = 6     # 6 or 12


def um_encode(h: UmHeader) -> bytes:
    if h.si == SI_FULL:
        return bytes([h.si << 6])
    if h.sn_size == 6:
        out = bytes([(h.si << 6) | (h.sn & 0x3F)])
    else:
        out = bytes([(h.si << 6) | ((h.sn >> 8) & 0x0F), h.sn & 0xFF])
    if h.si in (SI_LAST, SI_MIDDLE):
        out += struct.pack("!H", h.so)
    return out


def um_decode(data: bytes, sn_size: int = 6) -> tuple[UmHeader, bytes]:
    si = data[0] >> 6
    if si == SI_FULL:
        return UmHeader(si, sn_size=sn_size), data[1:]
    if sn_size == 6:
        sn = data[0] & 0x3F
        off = 1
    else:
        sn = ((data[0] & 0x0F) << 8) | data[1]
        off = 2
    so = 0
    if si in (SI_LAST, SI_MIDDLE):
        so = struct.unpack_from("!H", data, off)[0]
        off += 2
    return UmHeader(si, sn, so, sn_size), data[off:]


@dataclasses.dataclass
class AmHeader:
    si: int
    sn: int
    poll: bool = False
    so: int = 0
    sn_size: int = 12    # 12 or 18


def am_encode(h: AmHeader) -> bytes:
    dc = 1  # data
    if h.sn_size == 12:
        out = struct.pack(
            "!H", (dc << 15) | (int(h.poll) << 14) | (h.si << 12)
            | (h.sn & 0xFFF))
    else:
        out = bytes([(dc << 7) | (int(h.poll) << 6) | (h.si << 4)
                     | ((h.sn >> 16) & 0x3)]) + struct.pack(
            "!H", h.sn & 0xFFFF)
    if h.si in (SI_LAST, SI_MIDDLE):
        out += struct.pack("!H", h.so)
    return out


def am_decode(data: bytes, sn_size: int = 12) -> tuple[AmHeader, bytes]:
    assert data[0] & 0x80, "not an AMD PDU (D/C=0 is a control PDU)"
    poll = bool(data[0] & 0x40)
    si = (data[0] >> 4) & 0x3
    if sn_size == 12:
        sn = ((data[0] & 0x0F) << 8) | data[1]
        off = 2
    else:
        sn = ((data[0] & 0x03) << 16) | (data[1] << 8) | data[2]
        off = 3
    so = 0
    if si in (SI_LAST, SI_MIDDLE):
        so = struct.unpack_from("!H", data, off)[0]
        off += 2
    return AmHeader(si, sn, poll, so, sn_size), data[off:]


@dataclasses.dataclass
class StatusNack:
    sn: int
    so_start: int = 0
    so_end: int = 0xFFFF      # 0xFFFF = "until end of SDU"
    has_so: bool = False
    range: int = 0            # NACK range (nof consecutive SNs), 0 = absent


@dataclasses.dataclass
class StatusPdu:
    ack_sn: int
    nacks: list[StatusNack] = dataclasses.field(default_factory=list)
    sn_size: int = 12


def status_encode(s: StatusPdu) -> bytes:
    """STATUS PDU (TS 38.322 §6.2.2.5), CPT=000."""
    bits: list[tuple[int, int]] = []  # (value, width)
    bits.append((0, 1))               # D/C = 0 control
    bits.append((0, 3))               # CPT
    bits.append((s.ack_sn, s.sn_size))
    bits.append((1 if s.nacks else 0, 1))            # E1 after ACK_SN
    for i, n in enumerate(s.nacks):
        bits.append((n.sn, s.sn_size))
        is_last = i == len(s.nacks) - 1
        bits.append((0 if is_last else 1, 1))        # E1: more NACKs follow
        bits.append((int(n.has_so), 1))              # E2
        bits.append((int(n.range > 0), 1))           # E3
        if n.has_so:
            bits.append((n.so_start, 16))
            bits.append((n.so_end, 16))
        if n.range > 0:
            bits.append((n.range, 8))
    # pack MSB-first, pad to byte
    acc, nbits = 0, 0
    for v, w in bits:
        acc = (acc << w) | (v & ((1 << w) - 1))
        nbits += w
    pad = (-nbits) % 8
    acc <<= pad
    return acc.to_bytes((nbits + pad) // 8, "big")


def status_decode(data: bytes, sn_size: int = 12) -> StatusPdu:
    acc = int.from_bytes(data, "big")
    total = 8 * len(data)
    pos = 0

    def take(w: int) -> int:
        nonlocal pos
        v = (acc >> (total - pos - w)) & ((1 << w) - 1)
        pos += w
        return v

    dc = take(1)
    assert dc == 0, "not a control PDU"
    cpt = take(3)
    assert cpt == 0, f"unknown control PDU type {cpt}"
    ack_sn = take(sn_size)
    s = StatusPdu(ack_sn, sn_size=sn_size)
    e1 = take(1)
    while e1:
        sn = take(sn_size)
        e1 = take(1)
        e2 = take(1)
        e3 = take(1)
        n = StatusNack(sn)
        if e2:
            n.has_so = True
            n.so_start = take(16)
            n.so_end = take(16)
        if e3:
            n.range = take(8)
        s.nacks.append(n)
    return s


def is_control_pdu(data: bytes) -> bool:
    return (data[0] & 0x80) == 0
