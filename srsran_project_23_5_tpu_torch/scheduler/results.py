"""Scheduler slot output structures (reference
include/srsran/scheduler/scheduler_slot_handler.h sched_result)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class DlGrant:
    rnti: int
    harq_pid: int
    prb_start: int
    prb_len: int
    mcs: int
    qm: int
    rate: float
    tbs_bytes: int
    rv: int
    ndi: bool
    k1: int                       # HARQ-ACK delay
    is_rar: bool = False
    is_sib: bool = False
    is_conres: bool = False
    is_paging: bool = False
    # PDCCH resources carrying this grant's DCI (CCE-allocated per slot)
    cce_index: int = 0
    aggregation_level: int = 4
    # PUCCH resource indicator signalled in the DCI: index into the
    # cell's F1 resource list for this grant's HARQ-ACK
    pucch_pri: int = 0


@dataclasses.dataclass
class UlGrant:
    rnti: int
    harq_pid: int
    prb_start: int
    prb_len: int
    mcs: int
    qm: int
    rate: float
    tbs_bytes: int
    rv: int
    ndi: bool
    is_msg3: bool = False
    cce_index: int = 0
    aggregation_level: int = 4


@dataclasses.dataclass
class PucchGrant:
    rnti: int
    prb: int
    format: int                   # 1 = HARQ-ACK, 2 = CSI/UCI
    nof_harq_bits: int = 1
    initial_cyclic_shift: int = 0  # F1 CS multiplexing within one PRB
    harq_pid: int = 0             # DL HARQ process this ACK closes
    # F2 periodic-CSI resources carry no HARQ (format == 2)
    nof_uci_bits: int = 0


@dataclasses.dataclass
class RarInfo:
    ra_rnti: int
    rapid: int
    tc_rnti: int
    ta: int
    msg3_slot: int
    msg3_grant: "UlGrant"


@dataclasses.dataclass
class SlotResult:
    slot: int
    ssb: bool = False
    csi_rs: bool = False
    sib1: Optional[DlGrant] = None
    paging: Optional[DlGrant] = None
    paging_records: list = dataclasses.field(default_factory=list)
    prach_occasion: bool = False
    rars: list[RarInfo] = dataclasses.field(default_factory=list)
    dl_grants: list[DlGrant] = dataclasses.field(default_factory=list)
    ul_grants: list[UlGrant] = dataclasses.field(default_factory=list)
    # UL grants whose DCI 0_0 goes out THIS slot (PUSCH lands at +k2);
    # becomes FAPI UL_DCI.request (messages.h ul_dci_request)
    ul_dcis: list[UlGrant] = dataclasses.field(default_factory=list)
    pucch: list[PucchGrant] = dataclasses.field(default_factory=list)
