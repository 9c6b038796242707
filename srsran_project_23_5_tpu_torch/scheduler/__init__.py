"""MAC scheduler (reference lib/scheduler, ~20k LoC) re-expressed as a
compact slot-driven cell scheduler.

Per-slot pipeline mirrors cell_scheduler.cpp:83-137:
SSB → SIB1 → PRACH guard → RA (RAR+Msg3) → UE DL → UE UL, with
policy-based UE iteration (scheduler_time_rr), HARQ state machines,
PUCCH/UCI allocation, and MCS/TBS calculation from the 38.214 tables.
"""
from .config import CellConfig, TddPattern
from .harq import HarqProcess, HarqEntity
from .results import (DlGrant, PucchGrant, RarInfo, SlotResult, UlGrant)
from .ue_context import UeContext
from .cell_scheduler import CellScheduler

__all__ = [
    "CellConfig", "TddPattern", "HarqProcess", "HarqEntity", "DlGrant",
    "PucchGrant", "RarInfo", "SlotResult", "UlGrant", "UeContext",
    "CellScheduler",
]
