"""MAC PDU framing (TS 38.321 §6.1.2; reference lib/mac/mac_dl/
dl_sch_pdu_assembler.cpp and mac_ul/ul_sch_pdu.cpp).

A MAC PDU is a train of subPDUs: R|F|LCID [+ L] + payload. DL-SCH and
UL-SCH use different LCID spaces for control elements (Tables 6.2.1-1/2).
"""
from __future__ import annotations

import dataclasses
import struct

# DL-SCH LCIDs (Table 6.2.1-1)
LCID_CCCH = 0
LCID_DL_CON_RES = 62          # UE Contention Resolution Identity CE
LCID_DL_TA_CMD = 61           # Timing Advance Command CE
LCID_DL_DRX = 60
LCID_PADDING = 63

# UL-SCH LCIDs (Table 6.2.1-2)
LCID_UL_CCCH = 0              # 64-bit CCCH SDU (Msg3 RRCSetupRequest)
LCID_UL_CCCH48 = 52           # 48-bit CCCH
LCID_C_RNTI = 58              # C-RNTI CE
LCID_SHORT_TRUNC_BSR = 59
LCID_LONG_TRUNC_BSR = 60
LCID_SHORT_BSR = 61
LCID_LONG_BSR = 62
LCID_SE_PHR = 57              # Single-entry PHR

MIN_LC_LCID, MAX_LC_LCID = 1, 32

# fixed CE sizes in bytes (0 = variable/has L field)
_FIXED_CE_SIZE_DL = {LCID_DL_CON_RES: 6, LCID_DL_TA_CMD: 1, LCID_DL_DRX: 0,
                     LCID_PADDING: -1}
# Deviation from TS 38.321: UL CCCH is variable-length here (gets an L
# field) because the framework's RRC containers are not 48/64-bit fixed.
_FIXED_CE_SIZE_UL = {LCID_C_RNTI: 2, LCID_SHORT_BSR: 1,
                     LCID_SHORT_TRUNC_BSR: 1, LCID_SE_PHR: 2,
                     LCID_PADDING: -1}


@dataclasses.dataclass
class SubPdu:
    lcid: int
    payload: bytes


def _encode_subheader(lcid: int, length: int, fixed: bool) -> bytes:
    if fixed:
        return bytes([lcid & 0x3F])
    if length < 256:
        return bytes([lcid & 0x3F, length])          # F=0, 8-bit L
    return bytes([0x40 | (lcid & 0x3F)]) + struct.pack("!H", length)


def encode_pdu(subpdus: list[SubPdu], pdu_size: int, uplink: bool = False
               ) -> bytes:
    """Assemble subPDUs + padding into exactly pdu_size bytes."""
    fixed_sizes = _FIXED_CE_SIZE_UL if uplink else _FIXED_CE_SIZE_DL
    out = bytearray()
    for sp in subpdus:
        fixed = sp.lcid in fixed_sizes and fixed_sizes[sp.lcid] >= 0
        out += _encode_subheader(sp.lcid, len(sp.payload), fixed)
        out += sp.payload
    assert len(out) <= pdu_size, f"PDU overflow {len(out)} > {pdu_size}"
    pad = pdu_size - len(out)
    if pad:
        out += bytes([LCID_PADDING]) + bytes(pad - 1)
    return bytes(out)


def decode_pdu(data: bytes, uplink: bool = False) -> list[SubPdu]:
    fixed_sizes = _FIXED_CE_SIZE_UL if uplink else _FIXED_CE_SIZE_DL
    out: list[SubPdu] = []
    off = 0
    while off < len(data):
        octet = data[off]
        lcid = octet & 0x3F
        if lcid == LCID_PADDING:
            break
        fsz = fixed_sizes.get(lcid)
        if fsz is not None and fsz >= 0:
            off += 1
            out.append(SubPdu(lcid, data[off:off + fsz]))
            off += fsz
            continue
        if octet & 0x40:              # F=1: 16-bit L
            length = struct.unpack_from("!H", data, off + 1)[0]
            off += 3
        else:
            length = data[off + 1]
            off += 2
        out.append(SubPdu(lcid, data[off:off + length]))
        off += length
    return out


# ------------------------------------------------------- control elements
def ce_ta_cmd(delta_samples: int) -> SubPdu:
    """Timing Advance Command CE (TS 38.321 §6.1.3.4, 1 byte).  The
    6-bit field carries T_A; this stack's granularity is 1 carrier sample
    with the neutral point at 31 (applied delta = T_A - 31)."""
    ta = max(0, min(63, int(delta_samples) + 31))
    return SubPdu(LCID_DL_TA_CMD, bytes([ta & 0x3F]))


def parse_ta_cmd(payload: bytes) -> int:
    """TA command CE payload → signed sample delta."""
    return (payload[0] & 0x3F) - 31


def ce_con_res(ue_identity: bytes) -> SubPdu:
    """UE Contention Resolution Identity: first 48 bits of the Msg3 CCCH
    SDU (§6.1.3.3)."""
    return SubPdu(LCID_DL_CON_RES, bytes(ue_identity[:6]).ljust(6, b"\x00"))


def ce_ta_command(tag_id: int, ta: int) -> SubPdu:
    return SubPdu(LCID_DL_TA_CMD, bytes([((tag_id & 3) << 6) | (ta & 0x3F)]))


# TS 38.321 Table 6.1.3.1-1 buffer-size levels (5-bit), exponential
_BS_TABLE_5BIT = [0] + [int(10 * 1.172 ** i) for i in range(1, 32)]


def bsr_encode_level(nof_bytes: int) -> int:
    for i, th in enumerate(_BS_TABLE_5BIT):
        if nof_bytes <= th:
            return i
    return 31


def bsr_decode_level(level: int) -> int:
    """Upper bound in bytes of a 5-bit BSR level."""
    return _BS_TABLE_5BIT[min(level, 31)]


def ce_short_bsr(lcg: int, nof_bytes: int) -> SubPdu:
    return SubPdu(LCID_SHORT_BSR,
                  bytes([((lcg & 7) << 5) | bsr_encode_level(nof_bytes)]))


def parse_short_bsr(payload: bytes) -> tuple[int, int]:
    """(lcg, buffer-bytes upper bound)."""
    return payload[0] >> 5, bsr_decode_level(payload[0] & 0x1F)


def ce_c_rnti(rnti: int) -> SubPdu:
    return SubPdu(LCID_C_RNTI, struct.pack("!H", rnti))


# ------------------------------------------------------------ RAR (Msg2)
@dataclasses.dataclass
class RarGrant:
    rapid: int
    ta: int                       # timing advance command (12 bit)
    ul_grant: int                 # 27-bit packed UL grant for Msg3
    tc_rnti: int


def encode_rar_pdu(grants: list[RarGrant]) -> bytes:
    """MAC RAR PDU (§6.1.5/§6.2.3): E|T=1|RAPID subheader + 7-byte RAR."""
    out = bytearray()
    for i, g in enumerate(grants):
        e = 1 if i < len(grants) - 1 else 0
        out.append((e << 7) | (1 << 6) | (g.rapid & 0x3F))
        blob = ((g.ta & 0xFFF) << 43) | ((g.ul_grant & 0x7FFFFFF) << 16) \
            | (g.tc_rnti & 0xFFFF)
        out += blob.to_bytes(7, "big")
    return bytes(out)


def decode_rar_pdu(data: bytes) -> list[RarGrant]:
    out = []
    off = 0
    while off < len(data):
        hdr = data[off]
        off += 1
        if not (hdr & 0x40):      # T=0: BI subheader, skip
            continue
        blob = int.from_bytes(data[off:off + 7], "big")
        off += 7
        out.append(RarGrant(hdr & 0x3F, (blob >> 43) & 0xFFF,
                            (blob >> 16) & 0x7FFFFFF, blob & 0xFFFF))
        if not (hdr & 0x80):
            break
    return out
