"""DU RAN resource management: pooled PUCCH/LCID/DRB-id allocation.

Re-design of the reference's du_manager resource layer
(lib/du_manager/ran_resource_management/du_pucch_resource_manager.cpp:
SR/CSI (resource, offset) free-lists carved from the cell's generated
PUCCH resource list, returned to the pool on UE deletion;
pucch_resource_generator.cpp: the cell resource list itself;
du_ue/du_bearer.cpp: LCID/DRB-id allocation).

Replaces the round-4 formula-based SR/CSI derivation (scheduler/config
sr_resource): resources are now ALLOCATED from finite pools at UE
creation — two UEs can never collide by construction, exhaustion is a
detectable creation failure (du_ue_resource_update_response
release_required analogue), and the allocation is delivered to the UE
over RRC (rrc.messages_38331 PUCCH-Config) instead of being re-derived
from the RNTI.
"""
from __future__ import annotations

import dataclasses

from ..scheduler.config import CellConfig, PUCCH_F1_SHIFTS


class ResourceExhausted(Exception):
    """The cell's pool has no free resource of the requested kind."""


@dataclasses.dataclass(frozen=True)
class PucchF1Resource:
    res_id: int
    prb: int
    initial_cyclic_shift: int


@dataclasses.dataclass(frozen=True)
class PucchF2Resource:
    res_id: int
    prb_start: int
    nof_prb: int = 1


@dataclasses.dataclass(frozen=True)
class SrResource:
    """SchedulingRequestResourceConfig analogue: F1 resource + (period,
    offset) in slots."""
    resource: PucchF1Resource
    period_slots: int
    offset: int

    def is_opportunity(self, cell: CellConfig, slot: int) -> bool:
        return (cell.is_ul_slot(slot)
                and slot % self.period_slots == self.offset)


@dataclasses.dataclass(frozen=True)
class CsiResource:
    """Periodic CSI report on PUCCH F2: resource + (period, offset)."""
    resource: PucchF2Resource
    period_slots: int
    offset: int

    def is_opportunity(self, cell: CellConfig, slot: int) -> bool:
        return (cell.is_ul_slot(slot)
                and slot % self.period_slots == self.offset)


@dataclasses.dataclass(frozen=True)
class UePucchAlloc:
    sr: SrResource
    csi: CsiResource


def generate_cell_resources(cell: CellConfig) -> tuple[
        list[PucchF1Resource], list[PucchF1Resource], list[PucchF2Resource]]:
    """Cell PUCCH resource lists (pucch_resource_generator.cpp):

    - F1 HARQ-ACK resources on the TOP-edge guard PRBs (addressed by the
      DCI's PUCCH resource indicator),
    - F1 SR resources on bottom-edge PRB 0,
    - F2 CSI resources on bottom-edge PRB 1.
    """
    npkt = max(1, cell.pucch_prbs)
    harq = [PucchF1Resource(i, cell.nof_prb - npkt + i // len(
        PUCCH_F1_SHIFTS) % npkt, PUCCH_F1_SHIFTS[i % len(PUCCH_F1_SHIFTS)])
        for i in range(npkt * len(PUCCH_F1_SHIFTS))]
    base = len(harq)
    sr = [PucchF1Resource(base + i, 0, PUCCH_F1_SHIFTS[i])
          for i in range(len(PUCCH_F1_SHIFTS))]
    csi = [PucchF2Resource(base + len(sr), 1)]
    return harq, sr, csi


class PucchResourceManager:
    """Free-list allocator of per-UE SR and CSI opportunities.

    Each SR unit is (F1 resource, offset) over the UL slots of one SR
    period; each CSI unit is (F2 resource, offset) over one CSI period —
    exactly the shape of the reference's sr_offset_free_list /
    csi_offset_free_list (du_pucch_resource_manager.cpp:100-140)."""

    def __init__(self, cell: CellConfig) -> None:
        self.cell = cell
        self.harq_resources, sr_res, csi_res = generate_cell_resources(cell)
        self._sr_free: list[SrResource] = [
            SrResource(r, cell.sr_period_slots, off)
            for off in range(cell.sr_period_slots)
            if cell.is_ul_slot(off)
            for r in sr_res]
        self._csi_free: list[CsiResource] = [
            CsiResource(r, cell.csi_report_period_slots, off)
            for off in range(cell.csi_report_period_slots)
            if cell.is_ul_slot(off)
            for r in csi_res]
        # pop() takes from the END; reverse so low offsets go out first
        self._sr_free.reverse()
        self._csi_free.reverse()
        self._allocated: dict[int, UePucchAlloc] = {}

    @property
    def sr_capacity(self) -> int:
        return len(self._sr_free)

    @property
    def csi_capacity(self) -> int:
        return len(self._csi_free)

    def alloc_ue(self, rnti: int) -> UePucchAlloc:
        if rnti in self._allocated:
            return self._allocated[rnti]
        if not self._sr_free or not self._csi_free:
            raise ResourceExhausted(
                f"PUCCH pool exhausted (sr={len(self._sr_free)}, "
                f"csi={len(self._csi_free)})")
        alloc = UePucchAlloc(self._sr_free.pop(), self._csi_free.pop())
        self._allocated[rnti] = alloc
        return alloc

    def free_ue(self, rnti: int) -> None:
        alloc = self._allocated.pop(rnti, None)
        if alloc is not None:
            self._sr_free.append(alloc.sr)
            self._csi_free.append(alloc.csi)

    def get(self, rnti: int) -> UePucchAlloc | None:
        return self._allocated.get(rnti)


class LcidAllocator:
    """Per-UE logical channel ids: SRBs own 1-3, DRBs take 4..32
    (du_bearer.cpp lcid assignment)."""

    def __init__(self) -> None:
        self._used: set[int] = set()

    def alloc_srb(self, srb_id: int) -> int:
        if not 1 <= srb_id <= 3:
            raise ValueError(f"srb id {srb_id}")
        if srb_id in self._used:
            raise ResourceExhausted(f"SRB{srb_id} lcid already allocated")
        self._used.add(srb_id)
        return srb_id

    def alloc_drb(self) -> int:
        for lcid in range(4, 33):
            if lcid not in self._used:
                self._used.add(lcid)
                return lcid
        raise ResourceExhausted("no free DRB lcid")

    def free(self, lcid: int) -> None:
        self._used.discard(lcid)


class DrbIdAllocator:
    """Cell-wide DRB identities 1..32."""

    def __init__(self) -> None:
        self._used: set[int] = set()

    def alloc(self) -> int:
        for drb_id in range(1, 33):
            if drb_id not in self._used:
                self._used.add(drb_id)
                return drb_id
        raise ResourceExhausted("no free DRB id")

    def free(self, drb_id: int) -> None:
        self._used.discard(drb_id)
