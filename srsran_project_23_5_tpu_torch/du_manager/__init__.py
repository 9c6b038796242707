"""DU manager: cell + UE lifecycle and RAN resource orchestration.

The tpu-native analogue of the reference's lib/du_manager —
du_cell_manager.cpp (cell configuration store + validation),
du_ue/du_ue_manager.cpp (UE repository, creation/configuration/deletion
procedures) and ran_resource_management/ (the pooled PUCCH/LCID/DRB
allocators in `ran_resources`).  DuHigh delegates UE lifecycle here;
the scheduler consumes the per-UE PUCCH allocation this manager hands
out, and the CU delivers it to the UE over RRC (PUCCH-Config inside the
CellGroupConfig container — rrc/messages_38331.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..scheduler.config import CellConfig
from .ran_resources import (CsiResource, DrbIdAllocator, LcidAllocator,
                            PucchResourceManager, ResourceExhausted,
                            SrResource, UePucchAlloc)

__all__ = ["DuCellManager", "DuUeManager", "DuUeResources",
            "PucchResourceManager", "ResourceExhausted", "UePucchAlloc",
            "SrResource", "CsiResource"]


class DuCellManager:
    """Cell configuration store + validation (du_cell_manager.cpp)."""

    def __init__(self) -> None:
        self.cells: list[CellConfig] = []

    def add_cell(self, cfg: CellConfig) -> int:
        self.validate(cfg)
        self.cells.append(cfg)
        return len(self.cells) - 1

    @staticmethod
    def validate(cfg: CellConfig) -> None:
        if cfg.nof_prb < 11:
            raise ValueError(f"nof_prb {cfg.nof_prb}: carrier too small")
        if cfg.pucch_prbs < 1:
            raise ValueError("at least one PUCCH guard PRB required")
        if 2 * cfg.pucch_prbs + 12 > cfg.nof_prb:
            raise ValueError(
                f"PUCCH guards ({cfg.pucch_prbs} PRB/edge) + PRACH region "
                f"do not fit in {cfg.nof_prb} PRB")
        if cfg.prach_prb_start <= cfg.pucch_prbs:
            raise ValueError("PRACH region overlaps bottom-edge PUCCH")
        if cfg.sr_period_slots < 1 or cfg.csi_report_period_slots < 1:
            raise ValueError("SR/CSI periods must be positive")
        if cfg.tdd is not None:
            if cfg.tdd.nof_dl_slots + cfg.tdd.nof_ul_slots > cfg.tdd.period:
                raise ValueError("TDD pattern overcommits the period")
            if not any(cfg.is_ul_slot(s)
                       for s in range(cfg.sr_period_slots)):
                raise ValueError("no UL slot inside one SR period")


@dataclasses.dataclass
class DuUeResources:
    """Everything the DU allocated for one UE (du_ue.h du_ue members)."""
    rnti: int
    due_id: int
    pucch: UePucchAlloc
    lcids: LcidAllocator
    drbs: dict = dataclasses.field(default_factory=dict)  # drb_id -> lcid


class DuUeManager:
    """UE repository + resource procedures (du_ue_manager.cpp).

    Creation allocates pooled PUCCH resources and SRB1's LCID — a full
    pool fails creation (ue_creation_procedure.cpp bails out the same
    way); configuration allocates DRB LCIDs; deletion returns everything
    to the pools."""

    def __init__(self, cell: CellConfig,
                 pucch_mgr: Optional[PucchResourceManager] = None) -> None:
        self.cell = cell
        self.pucch_mgr = pucch_mgr or PucchResourceManager(cell)
        self.drb_ids = DrbIdAllocator()
        self.ues: dict[int, DuUeResources] = {}        # due_id -> res
        self._by_rnti: dict[int, int] = {}

    def create_ue(self, rnti: int, due_id: int) -> DuUeResources:
        pucch = self.pucch_mgr.alloc_ue(rnti)          # may raise
        lcids = LcidAllocator()
        lcids.alloc_srb(1)
        res = DuUeResources(rnti, due_id, pucch, lcids)
        self.ues[due_id] = res
        self._by_rnti[rnti] = due_id
        return res

    def configure_drbs(self, due_id: int, drb_ids: list[int]) -> dict:
        """UE context update: allocate an LCID per DRB; returns
        {drb_id: lcid} (ue_configuration_procedure.cpp)."""
        res = self.ues[due_id]
        out = {}
        for drb_id in drb_ids:
            if drb_id in res.drbs:
                out[drb_id] = res.drbs[drb_id]
                continue
            lcid = res.lcids.alloc_drb()
            res.drbs[drb_id] = lcid
            out[drb_id] = lcid
        return out

    def delete_ue(self, due_id: int) -> None:
        res = self.ues.pop(due_id, None)
        if res is None:
            return
        self._by_rnti.pop(res.rnti, None)
        self.pucch_mgr.free_ue(res.rnti)
        for drb_id in res.drbs:
            self.drb_ids.free(drb_id)

    def by_rnti(self, rnti: int) -> Optional[DuUeResources]:
        due = self._by_rnti.get(rnti)
        return self.ues.get(due) if due is not None else None
