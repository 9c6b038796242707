"""DCI payload packing (TS 38.212 §7.3.1, DCI formats 0_0 / 1_0 shape).

The reference builds DCIs in lib/scheduler/support/dci_builder.cpp and
lib/ran/pdcch/dci_packing.cpp.  This codec carries the fields the TPU
stack's grants need — format flag, frequency-domain RA as a RIV,
time-domain index, MCS, NDI, RV, HARQ id — in a fixed A-bit payload so
one PdcchConfig/polar shape serves every grant of a cell.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def riv_encode(prb_start: int, prb_len: int, n_bwp: int) -> int:
    """TS 38.214 §5.1.2.2.2 resource indication value."""
    assert 1 <= prb_len <= n_bwp - prb_start
    if (prb_len - 1) <= n_bwp // 2:
        return n_bwp * (prb_len - 1) + prb_start
    return (n_bwp * (n_bwp - prb_len + 1)
            + (n_bwp - 1 - prb_start))


def riv_decode(riv: int, n_bwp: int) -> tuple[int, int]:
    prb_len = riv // n_bwp + 1
    prb_start = riv % n_bwp
    if prb_start + prb_len > n_bwp:
        prb_len = n_bwp - prb_len + 2
        prb_start = n_bwp - 1 - prb_start
    return prb_start, prb_len


def riv_bits(n_bwp: int) -> int:
    return math.ceil(math.log2(n_bwp * (n_bwp + 1) / 2))


@dataclasses.dataclass(frozen=True)
class Dci:
    """Unified UL/DL grant DCI (format flag distinguishes 0_0 vs 1_0)."""
    is_dl: bool
    prb_start: int
    prb_len: int
    time_domain: int = 0      # row index into the cell's TD allocation table
    mcs: int = 0
    ndi: int = 0
    rv: int = 0
    harq_pid: int = 0
    # PUCCH resource indicator (DCI 1_0 PRI): selects the cell's F1
    # resource carrying this grant's HARQ-ACK (uci_allocator_impl.cpp)
    pri: int = 0


def dci_size(n_bwp: int) -> int:
    # 1 format + RIV + 4 TD + 5 MCS + 1 NDI + 2 RV + 4 HARQ + 3 PRI
    return 1 + riv_bits(n_bwp) + 4 + 5 + 1 + 2 + 4 + 3


def pack(d: Dci, n_bwp: int) -> np.ndarray:
    fields = [
        (int(d.is_dl), 1),
        (riv_encode(d.prb_start, d.prb_len, n_bwp), riv_bits(n_bwp)),
        (d.time_domain, 4), (d.mcs, 5), (d.ndi & 1, 1), (d.rv, 2),
        (d.harq_pid, 4), (d.pri, 3),
    ]
    out = []
    for value, width in fields:
        assert 0 <= value < (1 << width), (value, width)
        out.extend((value >> (width - 1 - i)) & 1 for i in range(width))
    return np.asarray(out, dtype=np.int8)


def unpack(bits: np.ndarray, n_bwp: int) -> Dci:
    bits = np.asarray(bits).astype(np.int64)
    pos = 0

    def take(width: int) -> int:
        nonlocal pos
        v = 0
        for i in range(width):
            v = (v << 1) | int(bits[pos + i])
        pos += width
        return v

    is_dl = bool(take(1))
    prb_start, prb_len = riv_decode(take(riv_bits(n_bwp)), n_bwp)
    td = take(4)
    mcs = take(5)
    ndi = take(1)
    rv = take(2)
    harq = take(4)
    pri = take(3)
    return Dci(is_dl=is_dl, prb_start=prb_start, prb_len=prb_len,
               time_domain=td, mcs=mcs, ndi=ndi, rv=rv, harq_pid=harq,
               pri=pri)
