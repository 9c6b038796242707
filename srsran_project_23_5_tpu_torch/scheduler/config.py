"""Cell configuration for the scheduler (reference
lib/scheduler/cell/cell_configuration.h, du_cell_config) plus the
cell-derived formulas (TBS, slot patterns, PUCCH resource list) that the
gNB scheduler AND the UE derive independently from the same broadcast
configuration — the UE never reads gNB-internal state."""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..ran import mcs_tables, tbs as tbs_mod


@dataclasses.dataclass(frozen=True)
class TddPattern:
    """TDD-UL-DL-ConfigCommon (TS 38.331): pattern over `period` slots with
    nof_dl leading DL slots and nof_ul trailing UL slots (rest flexible,
    used as guard)."""
    period: int = 10
    nof_dl_slots: int = 7
    nof_ul_slots: int = 2

    def is_dl(self, slot: int) -> bool:
        return (slot % self.period) < self.nof_dl_slots

    def is_ul(self, slot: int) -> bool:
        return (slot % self.period) >= self.period - self.nof_ul_slots


@dataclasses.dataclass
class CellConfig:
    pci: int = 1
    nof_prb: int = 106
    mu: int = 1                          # 30 kHz SCS
    tdd: Optional[TddPattern] = None     # None = FDD
    ssb_period_slots: int = 20           # every 10 ms at mu=1
    sib1_period_slots: int = 40
    prach_period_slots: int = 20         # one occasion per period
    prach_slot_offset: int = 19
    ra_window_slots: int = 10
    k1: int = 4                          # PDSCH → HARQ-ACK PUCCH delay
    k2: int = 4                          # DCI → PUSCH delay
    nof_harqs: int = 16
    max_dl_retx: int = 4
    mcs_table: str = "qam64"
    fixed_dl_mcs: int = 20               # link adaptation: fixed in v1
    fixed_ul_mcs: int = 15
    max_prb_per_ue: int = 0              # 0 = unlimited
    # PDSCH occupies symbols 2..13 (symbols 0-1 are the PDCCH control
    # region); 3 DM-RS symbols with CDM-groups-without-data = 2 cost the
    # full 12 RE/PRB each ⇒ TBS geometry matches the transmitted shape
    pdsch_symbols: int = 12
    pusch_symbols: int = 14
    dl_dmrs_per_prb: int = 36            # DM-RS REs/PRB (3 symbols, CDM=2)
    ul_dmrs_per_prb: int = 36
    pucch_prbs: int = 2                  # PRBs reserved at band edges
    # CORESET#0-style control region: `coreset_prbs` PRBs × 1 symbol at
    # symbol 0 ⇒ coreset_prbs // 6 CCEs shared by every DCI of the slot
    coreset_prbs: int = 48
    pdcch_candidates: int = 4            # candidates per aggregation level
    pdcch_aggregation_level: int = 4
    ssb_prbs: int = 21                   # SSB span (240 SC + rounding)
    # NZP-CSI-RS resource (row 2: 1 RE/PRB) for DL CSI acquisition
    csi_rs_period_slots: int = 20
    csi_rs_slot_offset: int = 1
    csi_rs_symbol: int = 5
    # SR opportunities + periodic CSI on PUCCH F2
    # (uci_allocator_impl.cpp / pucch_resource_manager)
    sr_period_slots: int = 16
    csi_report_period_slots: int = 40
    csi_report_slot_offset: int = 7
    csi_report_bits: int = 4             # wideband CQI
    # TA command CE threshold (samples of residual PUSCH timing error)
    ta_cmd_threshold_samples: float = 2.0
    # in-grid short PRACH occasion geometry (139 subcarriers)
    prach_root_sequence: int = 22
    prach_zero_correlation_zone: int = 13
    prach_nof_preambles: int = 64
    # paging occasions (common_scheduling/paging_scheduler.cpp)
    paging_period_slots: int = 32
    paging_slot_offset: int = 3
    # Allocation sizes are rounded up to these buckets so every grant maps
    # to one of a few compiled PHY shapes (SURVEY §7: bucketing+padding
    # replaces the reference's dynamic per-PDU dispatch).
    prb_buckets: tuple = (2, 4, 8, 16, 32, 64, 106, 162, 273)
    # Link adaptation quantizes CQI-derived MCS DOWN to these buckets:
    # every (mcs, prb_bucket) pair is one compiled PHY shape, so the MCS
    # ladder bounds the program set the same way prb_buckets does (raw
    # 0..28 MCS churned a fresh fused slot program whenever a SINR report
    # wobbled by 1 CQI).
    mcs_buckets: tuple = (0, 2, 5, 9, 14, 19, 24, 28)

    @property
    def slots_per_frame(self) -> int:
        return 10 * (1 << self.mu)

    @property
    def nof_cces(self) -> int:
        return min(self.coreset_prbs, self.nof_prb) // 6

    def is_dl_slot(self, slot: int) -> bool:
        return self.tdd is None or self.tdd.is_dl(slot % self.slots_per_frame)

    def is_ul_slot(self, slot: int) -> bool:
        return self.tdd is None or self.tdd.is_ul(slot % self.slots_per_frame)

    def is_prach_slot(self, slot: int) -> bool:
        return (self.is_ul_slot(slot) and slot % self.prach_period_slots
                == self.prach_slot_offset % self.prach_period_slots)

    @property
    def prach_prb_start(self) -> int:
        """First PRB of the 139-subcarrier in-grid PRACH region (below
        the top-edge PUCCH guard)."""
        return self.nof_prb - self.pucch_prbs - 12


# ---------------------------------------------------------------- shared
PUCCH_F1_SHIFTS = (0, 3, 6, 9)


def dl_tbs_bytes(cell: "CellConfig", mcs: int, nof_prb: int
                 ) -> tuple[int, int, float]:
    qm, r = mcs_tables.mcs_to_qm_rate(mcs, cell.mcs_table)
    bits = tbs_mod.tbs_calculate(cell.pdsch_symbols, cell.dl_dmrs_per_prb,
                                 0, r, qm, 1, nof_prb)
    return bits // 8, qm, r


def ul_tbs_bytes(cell: "CellConfig", mcs: int, nof_prb: int
                 ) -> tuple[int, int, float]:
    qm, r = mcs_tables.mcs_to_qm_rate(mcs, cell.mcs_table)
    bits = tbs_mod.tbs_calculate(cell.pusch_symbols, cell.ul_dmrs_per_prb,
                                 0, r, qm, 1, nof_prb)
    return bits // 8, qm, r


def next_ul_slot(cell: "CellConfig", slot: int) -> int:
    s = slot
    while not cell.is_ul_slot(s):
        s += 1
    return s


def pucch_f1_resource(cell: "CellConfig", idx: int) -> tuple[int, int]:
    """PRI → (prb, initial_cyclic_shift): static F1 resource list on the
    TOP-edge guard PRBs (bottom edge hosts SR/CSI)."""
    npkt = max(1, cell.pucch_prbs)
    prbs = list(range(cell.nof_prb - npkt, cell.nof_prb))
    return (prbs[(idx // len(PUCCH_F1_SHIFTS)) % npkt],
            PUCCH_F1_SHIFTS[idx % len(PUCCH_F1_SHIFTS)])


# SR/CSI opportunity resources are no longer formula-derived here: the
# DU resource manager allocates them from pools
# (du_manager/ran_resources.py) and the CU delivers them to the UE over
# RRC (rrc/messages_38331.py build_sp_cell_config).
