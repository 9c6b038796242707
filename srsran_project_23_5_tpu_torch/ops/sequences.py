"""Low-PAPR sequences r_{u,v}(n) (TS 38.211 §5.2.2) and Zadoff-Chu helpers.

Re-hosted from ``srsran_project_23_5_tpu/ops/sequences.py`` (numpy, host
side; the tables are read by path like the LDPC tables).
"""
from __future__ import annotations

import functools

import numpy as np

from .ldpc.graphs import _tables


def prime_lower_than(n: int) -> int:
    for p in range(n - (1 if n > 2 else 0), 1, -1):
        if all(p % d for d in range(2, int(p ** 0.5) + 1)):
            return p
    raise ValueError(n)


@functools.lru_cache(maxsize=512)
def low_papr_sequence(u: int, v: int, m_zc: int) -> np.ndarray:
    """r_{u,v}(n), length m_zc complex128 (unit modulus); u in [0, 30) is
    the group number, v in {0, 1} the base sequence number."""
    if m_zc in (6, 12, 18, 24):
        phi = _tables()[f"phi_{m_zc}"][u].astype(np.float64)
        return np.exp(1j * phi * np.pi / 4)
    n_zc = prime_lower_than(m_zc)
    q_bar = n_zc * (u + 1) / 31
    q = (int(np.floor(q_bar + 0.5))
         + v * (1 if (int(np.floor(2 * q_bar)) % 2) == 0 else -1))
    m = np.arange(n_zc)
    x_q = np.exp(-1j * np.pi * q * m * (m + 1) / n_zc)
    n = np.arange(m_zc)
    return x_q[n % n_zc]


def cyclic_shifted(u: int, v: int, m_zc: int, alpha: float) -> np.ndarray:
    """r^(alpha)_{u,v}(n) = e^{j alpha n} r_{u,v}(n)."""
    n = np.arange(m_zc)
    return np.exp(1j * alpha * n) * low_papr_sequence(u, v, m_zc)


def zadoff_chu(root: int, length: int) -> np.ndarray:
    """Zadoff-Chu sequence x_u(n) = exp(-j π u n(n+1) / L) of prime length
    (PRACH preambles, TS 38.211 §6.3.3.1)."""
    n = np.arange(length)
    return np.exp(-1j * np.pi * root * n * (n + 1) / length)
