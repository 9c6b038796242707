"""Chrome-trace event tracing (about://tracing / Perfetto format).

Counterpart of the reference's event tracer (include/srsran/support/
event_tracing.h:39-54, srslog scoped_complete_event): spans recorded with
microsecond timestamps, dumped as a chrome-trace JSON array.  The JAX
profiler covers device-side tracing; this covers the host slot pipeline.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time


class EventTracer:
    def __init__(self) -> None:
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter_ns()
        self.enabled = False

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    @contextlib.contextmanager
    def span(self, name: str, category: str = "phy"):
        if not self.enabled:
            yield
            return
        begin = self._now_us()
        try:
            yield
        finally:
            end = self._now_us()
            with self._lock:
                self._events.append({
                    "name": name, "cat": category, "ph": "X",
                    "ts": begin, "dur": end - begin,
                    "pid": os.getpid(),
                    "tid": threading.get_ident() % (1 << 31),
                })

    def instant(self, name: str, category: str = "phy") -> None:
        if not self.enabled:
            return
        with self._lock:
            self._events.append({
                "name": name, "cat": category, "ph": "i",
                "ts": self._now_us(), "pid": os.getpid(),
                "tid": threading.get_ident() % (1 << 31), "s": "t",
            })

    def write(self, path: str) -> None:
        with self._lock:
            with open(path, "w") as f:
                json.dump({"traceEvents": self._events}, f)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


#: process-global tracer (open_trace_file analogue: set .enabled, then write)
tracer = EventTracer()
