"""Transport block size determination (TS 38.214 §5.1.3.2).

Re-hosted from ``srsran_project_23_5_tpu/ran/tbs.py`` (unchanged).
"""
from __future__ import annotations

import math

from .constants import NRE

# TS 38.214 Table 5.1.3.2-1 (valid TBS for Ninfo <= 3824).
TBS_TABLE = (
    24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128, 136, 144,
    152, 160, 168, 176, 184, 192, 208, 224, 240, 256, 272, 288, 304, 320,
    336, 352, 368, 384, 408, 432, 456, 480, 504, 528, 552, 576, 608, 640,
    672, 704, 736, 768, 808, 848, 888, 928, 984, 1032, 1064, 1128, 1160,
    1192, 1224, 1256, 1288, 1320, 1352, 1416, 1480, 1544, 1608, 1672, 1736,
    1800, 1864, 1928, 2024, 2088, 2152, 2216, 2280, 2408, 2472, 2536, 2600,
    2664, 2728, 2792, 2856, 2976, 3104, 3240, 3368, 3496, 3624, 3752, 3824,
)


def tbs_calculate(nof_symb_sh: int, nof_dmrs_prb: int, nof_oh_prb: int,
                  target_code_rate: float, qm: int, nof_layers: int,
                  n_prb: int, tb_scaling_field: int = 0) -> int:
    """Transport block size in bits from the TS 38.214 §5.1.3.2 inputs:
    symbols allocated, DM-RS REs per PRB, xOverhead per PRB, code rate R,
    Qm, layers, PRBs and the TB scaling field S."""
    nre_prime = NRE * nof_symb_sh - nof_dmrs_prb - nof_oh_prb
    nre = min(156, nre_prime) * n_prb
    scaling = 1.0 / (1 << tb_scaling_field)
    ninfo = scaling * nre * target_code_rate * qm * nof_layers

    if ninfo <= 3824:
        n = max(3, int(math.floor(math.log2(ninfo))) - 6) if ninfo >= 1 else 3
        ninfo_prime = max(24, (1 << n) * int(ninfo) // (1 << n))
        return next(t for t in TBS_TABLE if t >= ninfo_prime)

    n = int(math.floor(math.log2(ninfo - 24))) - 5
    ninfo_prime = max(3840, (1 << n) * round((ninfo - 24) / (1 << n)))
    if target_code_rate <= 0.25:
        c = math.ceil((ninfo_prime + 24) / 3816)
        return 8 * c * math.ceil((ninfo_prime + 24) / (8 * c)) - 24
    if ninfo_prime > 8424:
        c = math.ceil((ninfo_prime + 24) / 8424)
        return 8 * c * math.ceil((ninfo_prime + 24) / (8 * c)) - 24
    return 8 * math.ceil((ninfo_prime + 24) / 8) - 24
