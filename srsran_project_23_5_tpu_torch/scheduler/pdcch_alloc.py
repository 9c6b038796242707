"""PDCCH CCE allocation (reference
lib/scheduler/pdcch_scheduling/pdcch_resource_allocator_impl.cpp).

A CORESET of `nof_cces` CCEs is shared per slot by every DCI.  Candidate
positions follow the TS 38.213 §10.1 search-space hashing (Y_p recursion
for UE-specific search spaces, Y=0 for common), and allocation walks the
candidates first-fit against a per-slot CCE bitmap.
"""
from __future__ import annotations

import dataclasses

# TS 38.213 Table 10.1-1 A_p values for the Y recursion
_A_P = (39827, 39829, 39839)
_D = 65537


def y_p(rnti: int, coreset_id: int, slot: int) -> int:
    """UE-specific search-space hashing seed (TS 38.213 §10.1)."""
    y = rnti
    a = _A_P[coreset_id % 3]
    for _ in range(slot + 1):
        y = (a * y) % _D
    return y


@dataclasses.dataclass
class CandidateSet:
    aggregation_level: int
    nof_candidates: int


class PdcchSlotAllocator:
    """Per-slot CCE bitmap + candidate walk."""

    def __init__(self, nof_cces: int, coreset_id: int = 0) -> None:
        self.nof_cces = nof_cces
        self.coreset_id = coreset_id
        self._used = [False] * nof_cces

    def _candidates(self, al: int, nof_candidates: int, rnti: int,
                    slot: int) -> list[int]:
        n = self.nof_cces // al
        if n == 0:
            return []
        y = 0 if rnti in (0, 0xFFFF, 0xFFFE) else y_p(
            rnti, self.coreset_id, slot)
        out: list[int] = []
        for m in range(nof_candidates):
            cce = al * ((y + (m * self.nof_cces) //
                         (al * max(1, nof_candidates))) % n)
            if cce not in out:
                out.append(cce)
        return out

    def allocate(self, rnti: int, slot: int, aggregation_level: int = 4,
                 nof_candidates: int = 4) -> int | None:
        """First free candidate's CCE index, or None (blocked)."""
        for cce in self._candidates(aggregation_level, nof_candidates,
                                    rnti, slot):
            span = range(cce, cce + aggregation_level)
            if all(not self._used[i] for i in span):
                for i in span:
                    self._used[i] = True
                return cce
        return None
