"""Polar code construction (TS 38.212 §5.3.1, §5.4.1).

Re-hosted from ``srsran_project_23_5_tpu/ops/polar/code.py`` (numpy, host
side): per (K, E, nMax) the mother-code size N, the information set
(universal reliability sequence + rate-matching pre-freezing), the sub-block
interleaver pattern and the rate-matching mode.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from ..ldpc.graphs import _tables


class RateMatchMode:
    REPETITION = "repetition"
    PUNCTURING = "puncturing"
    SHORTENING = "shortening"


@functools.lru_cache(maxsize=1)
def reliability_q1024() -> np.ndarray:
    return _tables()["polar_q1024"].astype(np.int32)


@functools.lru_cache(maxsize=16)
def reliability_sequence(n: int) -> np.ndarray:
    """Q^N: the universal sequence filtered to entries < N."""
    q = reliability_q1024()
    return q[q < n]


@functools.lru_cache(maxsize=16)
def subblock_interleaver(n: int) -> np.ndarray:
    """J(n) pattern (TS 38.212 §5.4.1.1) for mother code size n."""
    p = _tables()["polar_pi32"].astype(np.int64)
    i = np.arange(n, dtype=np.int64)
    return (p[(32 * i) // n] * (n // 32) + i % (n // 32)).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class PolarCode:
    k: int                       # information bits (incl. CRC if attached)
    e: int                       # rate-matched output length
    n: int                       # mother code size
    mode: str                    # rate-match mode
    info_set: tuple[int, ...]    # sorted info bit positions (u-domain)
    frozen_mask: tuple[bool, ...]  # length n; True = frozen

    @property
    def log_n(self) -> int:
        return self.n.bit_length() - 1


@functools.lru_cache(maxsize=256)
def polar_code(k: int, e: int, nmax_log: int = 10) -> PolarCode:
    """Construct the code per TS 38.212 §5.3.1.2."""
    if not 0 < k <= e:
        raise ValueError(f"polar code needs 0 < K <= E, got K={k}, E={e}")
    ce = math.ceil(math.log2(e))
    if e <= (9 / 8) * (1 << (ce - 1)) and k / e < 9 / 16:
        n1 = ce - 1
    else:
        n1 = ce
    n2 = math.ceil(math.log2(8 * k))  # R_min = 1/8
    n_log = max(min(min(n1, n2), nmax_log), 5)
    n = 1 << n_log

    if e >= n:
        mode = RateMatchMode.REPETITION
    elif k / e <= 7 / 16:
        mode = RateMatchMode.PUNCTURING
    else:
        mode = RateMatchMode.SHORTENING

    jn = subblock_interleaver(n)
    frozen = np.zeros(n, dtype=bool)
    if mode == RateMatchMode.PUNCTURING:
        # punctured outputs y_{j(0)}..y_{j(N-E-1)} -> pre-freeze those inputs
        frozen[jn[: n - e]] = True
        if e >= 3 * n / 4:
            frozen[: math.ceil(3 * n / 4 - e / 2)] = True
        else:
            frozen[: math.ceil(9 * n / 16 - e / 4)] = True
    elif mode == RateMatchMode.SHORTENING:
        frozen[jn[e:]] = True

    # the most reliable positions that are not pre-frozen carry information
    q = reliability_sequence(n)
    usable = [int(i) for i in q if not frozen[i]]
    if len(usable) < k:
        raise ValueError(f"{len(usable)} usable channels for K={k}")
    info = sorted(usable[-k:])
    frozen_mask = np.ones(n, dtype=bool)
    frozen_mask[info] = False
    return PolarCode(k=k, e=e, n=n, mode=mode, info_set=tuple(info),
                     frozen_mask=tuple(bool(b) for b in frozen_mask))


@functools.lru_cache(maxsize=16)
def input_interleaver(k: int) -> np.ndarray:
    """Pi(k) input-bit interleaver for DCI (TS 38.212 §5.3.1.1, I_IL=1)."""
    pat = _tables()["polar_pi_il"].astype(np.int32)
    k_max = 164
    if k > k_max:
        raise ValueError(f"input interleaver K={k} exceeds {k_max}")
    out = [int(p) - (k_max - k) for p in pat if p >= k_max - k]
    return np.asarray(out, dtype=np.int32)
