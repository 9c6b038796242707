"""Slot-tick driven timers (reference include/srsran/support/timers.h).

The reference's timer_manager advances on TTI ticks; unique_timer objects
are created against it with a duration in ticks and a callback. L2 timers
(t-Reassembly, t-Reordering, t-PollRetransmit, RRC procedure guards) all
run on this wheel — deterministic per-slot semantics, no wall clock.
"""
from __future__ import annotations

from typing import Callable, Optional


class UniqueTimer:
    def __init__(self, mgr: "TimerManager", timer_id: int) -> None:
        self._mgr = mgr
        self.id = timer_id
        self.duration: Optional[int] = None
        self.callback: Optional[Callable[[], None]] = None
        self._expiry: Optional[int] = None

    def set(self, duration_ticks: int,
            callback: Optional[Callable[[], None]] = None) -> None:
        self.duration = duration_ticks
        if callback is not None:
            self.callback = callback

    def run(self) -> None:
        assert self.duration is not None, "set() before run()"
        self._expiry = self._mgr.now + self.duration
        self._mgr._arm(self)

    def stop(self) -> None:
        self._expiry = None

    def is_running(self) -> bool:
        return self._expiry is not None

    @property
    def time_to_expiry(self) -> Optional[int]:
        if self._expiry is None:
            return None
        return max(0, self._expiry - self._mgr.now)


class TimerManager:
    """Tick-driven timer wheel; tick() fires due callbacks in creation
    order."""

    def __init__(self) -> None:
        self.now = 0
        self._timers: list[UniqueTimer] = []
        self._next_id = 0

    def create_timer(self) -> UniqueTimer:
        t = UniqueTimer(self, self._next_id)
        self._next_id += 1
        return t

    def _arm(self, t: UniqueTimer) -> None:
        if t not in self._timers:
            self._timers.append(t)

    def tick(self, n: int = 1) -> None:
        for _ in range(n):
            self.now += 1
            due = [t for t in self._timers
                   if t._expiry is not None and t._expiry <= self.now]
            for t in due:
                t._expiry = None
                if t.callback is not None:
                    t.callback()
            self._timers = [t for t in self._timers if t._expiry is not None]

    def nof_running(self) -> int:
        return len(self._timers)
