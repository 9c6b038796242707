"""NR numerology and slot timing math (TS 38.211 §4.2-4.4, §5.3.1).

Re-hosted from ``srsran_project_23_5_tpu/ran/numerology.py`` (the functions
and the slot clock the port needs, unchanged).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .constants import MAX_NSYMB_PER_SLOT, NRE

# Reference FFT size against which TS 38.211 CP durations are defined.
_REF_NFFT = 2048


def scs_khz(mu: int) -> int:
    """Subcarrier spacing in kHz for numerology mu (TS 38.211 Table 4.2-1)."""
    return 15 << mu


def slots_per_subframe(mu: int) -> int:
    return 1 << mu


def slots_per_frame(mu: int) -> int:
    return 10 << mu


def sample_rate_hz(mu: int, nfft: int) -> float:
    return scs_khz(mu) * 1e3 * nfft


def min_nfft(nof_prb: int) -> int:
    """Smallest power-of-two FFT that fits the carrier's subcarriers."""
    n = 128
    while n < nof_prb * NRE:
        n *= 2
    return n


def cp_lengths(mu: int, nfft: int, slot_in_subframe: int = 0) -> np.ndarray:
    """Cyclic-prefix length in samples for the 14 symbols of a slot (normal
    CP; long CP at subframe symbols 0 and 7*2^mu)."""
    base = 144 * nfft // _REF_NFFT
    extra = 16 * (1 << mu) * nfft // _REF_NFFT
    lengths = np.full(MAX_NSYMB_PER_SLOT, base, dtype=np.int32)
    first = slot_in_subframe * MAX_NSYMB_PER_SLOT
    for l in range(MAX_NSYMB_PER_SLOT):
        if (first + l) in (0, 7 << mu):
            lengths[l] += extra
    return lengths


def slot_num_samples(mu: int, nfft: int, slot_in_subframe: int = 0) -> int:
    return (int(cp_lengths(mu, nfft, slot_in_subframe).sum())
            + MAX_NSYMB_PER_SLOT * nfft)


@dataclasses.dataclass(frozen=True)
class SlotPoint:
    """A (numerology, system frame, slot) triple: the slot clock; arithmetic
    wraps at the 1024-frame SFN period."""
    mu: int
    sfn: int
    slot_in_frame: int

    @property
    def nof_slots_per_frame(self) -> int:
        return slots_per_frame(self.mu)

    @property
    def slot_in_subframe(self) -> int:
        return self.slot_in_frame % slots_per_subframe(self.mu)

    def count(self) -> int:
        """Monotonic slot count within the 1024-frame period."""
        return self.sfn * self.nof_slots_per_frame + self.slot_in_frame

    def __add__(self, nof_slots: int) -> "SlotPoint":
        total = (self.count() + nof_slots) % (1024 * self.nof_slots_per_frame)
        return SlotPoint(self.mu, total // self.nof_slots_per_frame,
                         total % self.nof_slots_per_frame)
