"""Gold (pseudo-random) sequence tables, TS 38.211 §5.2.1.

Copied from the port's ``srsran_project_23_5_tpu_torch/ops/gold.py``,
unchanged.

Re-hosts the host side of ``srsran_project_23_5_tpu/ops/gold.py``: the x1
sequence and the x2 basis-response matrix M2 (grown lazily with a vectorised
LFSR), ``gold_sequence_np`` and the device product ``gold_sequence``.  The
slice bakes its scrambling sequences and DM-RS pilots on the host from these
(they are pure configuration); ``gold_sequence`` computes a batch of them
where the c_init values live on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ran.constants import GOLD_NC

_STATE = 31


class _GoldTables:
    """Lazily grown x1 sequence and x2 basis-response matrix."""

    def __init__(self) -> None:
        self.length = 0          # valid sequence samples (past Nc offset)
        self.x1: np.ndarray | None = None          # [Nc + length]
        self.m2: np.ndarray | None = None          # [31, Nc + length]

    def grow(self, length: int) -> None:
        if length <= self.length:
            return
        total = GOLD_NC + length
        x1 = np.zeros(total + _STATE, dtype=np.uint8)
        x1[0] = 1
        # row i of m2 is the x2 sequence for init state e_i
        m2 = np.zeros((_STATE, total + _STATE), dtype=np.uint8)
        m2[np.arange(_STATE), np.arange(_STATE)] = 1
        # x1(n+31) = x1(n+3) ^ x1(n);  x2(n+31) = x2(n+3)^x2(n+2)^x2(n+1)^x2(n)
        # Dependency distance 28 allows 28-wide vectorised steps.
        n = _STATE
        while n < total + _STATE:
            w = min(28, total + _STATE - n)
            s = slice(n, n + w)
            base = n - _STATE
            x1[s] = x1[base + 3:base + 3 + w] ^ x1[base:base + w]
            m2[:, s] = (m2[:, base + 3:base + 3 + w]
                        ^ m2[:, base + 2:base + 2 + w]
                        ^ m2[:, base + 1:base + 1 + w]
                        ^ m2[:, base:base + w])
            n += w
        self.x1 = x1[:total]
        self.m2 = m2[:, :total]
        self.length = length


_tables = _GoldTables()


def gold_tables(length: int, offset: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Host tables (x1 slice, M2 slice) for `length` samples from `offset`."""
    _tables.grow(offset + length)
    lo = GOLD_NC + offset
    return _tables.x1[lo:lo + length], _tables.m2[:, lo:lo + length]


def gold_sequence_np(cinit: int, length: int, offset: int = 0) -> np.ndarray:
    """Host Gold sequence: scalar cinit → [length] uint8 {0,1}."""
    x1, m2 = gold_tables(length, offset)
    bits = ((np.uint32(cinit) >> np.arange(_STATE, dtype=np.uint32)) & 1)
    return (x1 ^ (bits.astype(np.int64) @ m2.astype(np.int64) % 2)
            ).astype(np.uint8)


def gold_sequence(cinit: torch.Tensor, length: int, offset: int = 0
                  ) -> torch.Tensor:
    """Device Gold sequence: cinit [...] integer → [..., length] int8 {0,1}
    on cinit's device, c = X1 xor (cinit bits @ M2) mod 2.  The product runs
    in float32: its terms are 0 or 1 and its sums at most 31, so every value
    is exact."""
    x1, m2 = gold_tables(length, offset)
    dev = cinit.device
    shifts = torch.arange(_STATE, dtype=torch.int64, device=dev)
    bits = ((cinit.to(torch.int64)[..., None] >> shifts) & 1).to(
        torch.float32)
    acc = bits @ torch.from_numpy(m2.astype(np.float32)).to(dev)
    return ((acc.to(torch.int32) & 1)
            ^ torch.from_numpy(x1.astype(np.int32)).to(dev)).to(torch.int8)
