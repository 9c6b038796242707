"""HARQ process state machines (reference
lib/scheduler/ue_scheduling/harq_process.h:123-213).

States: EMPTY → WAITING_ACK → (ack) EMPTY | (nack) PENDING_RETX →
WAITING_ACK ... until max_retx."""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

RV_SEQUENCE = (0, 2, 3, 1)     # TS 38.214 §5.1.2.1 typical rv cycling


class HarqState(enum.Enum):
    EMPTY = 0
    WAITING_ACK = 1
    PENDING_RETX = 2


@dataclasses.dataclass
class HarqProcess:
    pid: int
    state: HarqState = HarqState.EMPTY
    tbs_bytes: int = 0
    mcs: int = 0
    prbs: tuple[int, int] = (0, 0)       # (start, length)
    nof_retx: int = 0
    max_retx: int = 4
    ndi: bool = False
    ack_slot: int = -1                   # slot where feedback is expected

    @property
    def rv(self) -> int:
        return RV_SEQUENCE[min(self.nof_retx, 3)]

    def new_tx(self, tbs_bytes: int, mcs: int, prbs: tuple[int, int],
               ack_slot: int) -> None:
        assert self.state == HarqState.EMPTY
        self.tbs_bytes = tbs_bytes
        self.mcs = mcs
        self.prbs = prbs
        self.nof_retx = 0
        self.ndi = not self.ndi          # toggle on new data
        self.ack_slot = ack_slot
        self.state = HarqState.WAITING_ACK

    def new_retx(self, ack_slot: int) -> None:
        assert self.state == HarqState.PENDING_RETX
        self.nof_retx += 1
        self.ack_slot = ack_slot
        self.state = HarqState.WAITING_ACK

    def handle_ack(self, ack: bool) -> bool:
        """Returns True if the process dropped the TB (max retx)."""
        if self.state != HarqState.WAITING_ACK:
            return False
        if ack:
            self.state = HarqState.EMPTY
            return False
        if self.nof_retx + 1 >= self.max_retx:
            self.state = HarqState.EMPTY
            return True
        self.state = HarqState.PENDING_RETX
        return False

    def handle_timeout(self, current_slot: int, timeout: int = 32) -> None:
        """Missing feedback: treat as NACK after a guard (the reference's
        harq timeout healing)."""
        if (self.state == HarqState.WAITING_ACK
                and current_slot - self.ack_slot > timeout):
            self.handle_ack(False)


class HarqEntity:
    def __init__(self, nof_harqs: int = 16, max_retx: int = 4) -> None:
        self.processes = [HarqProcess(i, max_retx=max_retx)
                          for i in range(nof_harqs)]

    def find_empty(self) -> Optional[HarqProcess]:
        for p in self.processes:
            if p.state == HarqState.EMPTY:
                return p
        return None

    def find_pending_retx(self) -> Optional[HarqProcess]:
        for p in self.processes:
            if p.state == HarqState.PENDING_RETX:
                return p
        return None

    def handle_timeouts(self, current_slot: int) -> None:
        for p in self.processes:
            p.handle_timeout(current_slot)
