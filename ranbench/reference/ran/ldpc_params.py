"""LDPC transport-block parameter derivation (TS 38.212 §5.2.2, §5.4.2, §7.2.2).

Copied from the port's ``srsran_project_23_5_tpu_torch/ran/ldpc_params.py``,
unchanged.

The port's copy of ``srsran_project_23_5_tpu/ran/ldpc_params.py`` (the
functions the shared-channel slice needs, unchanged)."""
from __future__ import annotations

import dataclasses
import math

from .constants import LDPC_BG1_K, LDPC_BG2_K, LDPC_MAX_SEG_BG1, LDPC_MAX_SEG_BG2

# All valid lifting sizes Zc = a * 2^j (TS 38.212 Table 5.3.2-1).
_LIFT_BASES = (2, 3, 5, 7, 9, 11, 13, 15)
ALL_LIFTING_SIZES: tuple[int, ...] = tuple(sorted(
    a << j for a in _LIFT_BASES for j in range(8) if (a << j) <= 384))


def lifting_set_index(zc: int) -> int:
    """Set index iLS in {0..7} of a lifting size (TS 38.212 Table 5.3.2-1)."""
    if zc not in ALL_LIFTING_SIZES:
        raise ValueError(f"invalid lifting size {zc}")
    a = zc
    while a % 2 == 0 and a > 2:
        a //= 2
    return _LIFT_BASES.index(a)


def base_graph(tbs: int, rate: float) -> int:
    """Select LDPC base graph 1 or 2 (TS 38.212 §7.2.2), tbs in bits."""
    if tbs <= 292 or (tbs <= 3824 and rate <= 0.67) or rate <= 0.25:
        return 2
    return 1


@dataclasses.dataclass(frozen=True)
class SegmentParams:
    """Geometry of TB→codeblock segmentation (TS 38.212 §5.2.2)."""
    base_graph: int
    nof_segments: int       # C
    lifting_size: int       # Zc
    lifting_index: int      # iLS
    segment_length: int     # K  (message bits per CB incl. filler)
    payload_length: int     # K' (message bits per CB excl. filler)
    nof_filler_bits: int    # K - K'
    tb_crc_bits: int        # 24 (CRC24A) or 16 (CRC16)
    cb_crc_bits: int        # 24 (CRC24B) when C > 1, else 0
    full_codeblock_length: int  # N = 66*Zc or 50*Zc

    @property
    def nof_message_blocks(self) -> int:
        return LDPC_BG1_K if self.base_graph == 1 else LDPC_BG2_K


def segment_tb(tbs: int, bg: int) -> SegmentParams:
    """Segmentation geometry for a transport block of `tbs` bits."""
    tb_crc = 24 if tbs > 3824 else 16
    b = tbs + tb_crc
    kcb = LDPC_MAX_SEG_BG1 if bg == 1 else LDPC_MAX_SEG_BG2
    if b <= kcb:
        c, cb_crc, b_prime = 1, 0, b
    else:
        cb_crc = 24
        c = math.ceil(b / (kcb - cb_crc))
        b_prime = b + c * cb_crc
    k_prime = math.ceil(b_prime / c)

    if bg == 1:
        kb = 22
    elif b > 640:
        kb = 10
    elif b > 560:
        kb = 9
    elif b > 192:
        kb = 8
    else:
        kb = 6

    zc = next(z for z in ALL_LIFTING_SIZES if kb * z >= k_prime)
    k = (LDPC_BG1_K if bg == 1 else LDPC_BG2_K) * zc
    n = (66 if bg == 1 else 50) * zc
    return SegmentParams(
        base_graph=bg, nof_segments=c, lifting_size=zc,
        lifting_index=lifting_set_index(zc), segment_length=k,
        payload_length=k_prime, nof_filler_bits=k - k_prime,
        tb_crc_bits=tb_crc, cb_crc_bits=cb_crc, full_codeblock_length=n)


def rate_match_k0(bg: int, zc: int, rv: int, ncb: int) -> int:
    """Circular-buffer start offset k0 (TS 38.212 Table 5.4.2.1-2)."""
    denom = 66 * zc if bg == 1 else 50 * zc
    num = {1: (0, 17, 33, 56), 2: (0, 13, 25, 43)}[bg][rv]
    return (num * ncb // denom) * zc


def rate_match_lengths(total_bits: int, nof_segments: int, qm: int,
                       nof_layers: int) -> list[int]:
    """Per-codeblock rate-matched length E_r (TS 38.212 §5.4.2.1)."""
    g = total_bits
    c = nof_segments
    unit = nof_layers * qm
    cut = c - (g // unit) % c  # first segments get the floor value
    lengths = [unit * (g // (unit * c)) if r < cut
               else unit * math.ceil(g / (unit * c)) for r in range(c)]
    if sum(lengths) != g:
        raise ValueError(f"G={g} does not split into {c} segments of "
                         f"multiples of {unit}")
    return lengths
