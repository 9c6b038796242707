"""O-RAN C-plane / U-plane message serdes (reference lib/ofh/serdes).

U-plane (IQ data, section type via data direction): application header
(dataDirection|payloadVersion|filterIndex, frameId, subframe+slot,
symbolId) + one section (sectionId, rb, symInc, startPrb, numPrb,
compression meta) + compressed IQ.
C-plane type 1 (DL/UL radio channel): same timing header + section with
startPrb/numPrb/numSymbols.
"""
from __future__ import annotations

import dataclasses
import struct

from . import compression

DIR_UL = 0
DIR_DL = 1


@dataclasses.dataclass
class TimingHeader:
    direction: int
    frame: int
    subframe: int
    slot: int
    symbol: int

    def pack(self) -> bytes:
        b0 = (self.direction << 7) | (1 << 4)       # payloadVersion=1
        b2 = ((self.subframe & 0xF) << 4) | ((self.slot >> 2) & 0xF)
        b3 = ((self.slot & 0x3) << 6) | (self.symbol & 0x3F)
        return bytes([b0, self.frame & 0xFF, b2, b3])

    @classmethod
    def unpack(cls, data: bytes) -> "TimingHeader":
        direction = data[0] >> 7
        frame = data[1]
        subframe = data[2] >> 4
        slot = ((data[2] & 0xF) << 2) | (data[3] >> 6)
        symbol = data[3] & 0x3F
        return cls(direction, frame, subframe, slot, symbol)


@dataclasses.dataclass
class UplaneMessage:
    timing: TimingHeader
    section_id: int
    start_prb: int
    nof_prb: int
    iq: object                      # [nof_prb, 12] complex
    comp_width: int = 9


def uplane_header(msg: UplaneMessage) -> bytes:
    """The U-plane message's header and section fields (msg.iq unused)."""
    hdr = msg.timing.pack()
    sec = struct.pack(
        "!HBB",
        ((msg.section_id & 0xFFF) << 4) | ((msg.start_prb >> 8) & 0x3),
        msg.start_prb & 0xFF, msg.nof_prb & 0xFF)
    # udCompHdr: iqWidth(4) | compMeth(4): 1 = BFP, 0 = none
    meth = 0 if msg.comp_width == 16 else 1
    sec += bytes([((msg.comp_width & 0xF) << 4) | meth, 0])
    return hdr + sec


def uplane_encode(msg: UplaneMessage) -> bytes:
    payload = compression.compress_prbs(msg.iq, msg.comp_width)
    return uplane_header(msg) + payload


def uplane_decode_header(data: bytes) -> UplaneMessage:
    """The header and section fields; iq holds the compressed payload."""
    timing = TimingHeader.unpack(data[:4])
    w, sp_lo, nprb = struct.unpack_from("!HBB", data, 4)
    section_id = w >> 4
    start_prb = ((w & 0x3) << 8) | sp_lo
    comp = data[8]
    width = comp >> 4
    if width == 0:
        width = 16
    nof_prb = nprb if nprb else 256
    return UplaneMessage(timing, section_id, start_prb, nof_prb, data[10:],
                         width)


def uplane_decode(data: bytes):
    msg = uplane_decode_header(data)
    msg.iq = compression.decompress_prbs(msg.iq, msg.nof_prb, msg.comp_width)
    return msg


@dataclasses.dataclass
class CplaneSection:
    timing: TimingHeader
    section_id: int
    start_prb: int
    nof_prb: int
    nof_symbols: int


def cplane_encode(s: CplaneSection) -> bytes:
    hdr = s.timing.pack()
    # sectionType 1, one section
    hdr += bytes([1, 1, 0, 0])
    sec = struct.pack(
        "!HBBB",
        ((s.section_id & 0xFFF) << 4) | ((s.start_prb >> 8) & 0x3),
        s.start_prb & 0xFF, s.nof_prb & 0xFF, s.nof_symbols & 0xF)
    return hdr + sec


def cplane_decode(data: bytes) -> CplaneSection:
    timing = TimingHeader.unpack(data[:4])
    assert data[4] == 1, "only section type 1 supported"
    w, sp_lo, nprb, nsym = struct.unpack_from("!HBBB", data, 8)
    return CplaneSection(timing, w >> 4, ((w & 0x3) << 8) | sp_lo,
                         nprb if nprb else 256, nsym & 0xF)
