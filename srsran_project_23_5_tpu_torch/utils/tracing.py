"""The port's tracer: spans and counts of the host's work around the device,
on the clock of a ``torch.profiler`` trace.

Counterpart of the reference's event tracer (include/srsran/support/
event_tracing.h:39-54, srslog scoped_complete_event).  A span keeps its
name, category, start and end, the innermost span open on its thread when
it began (its parent), a request id (its own, or else its parent's: a FAPI
slot's ``(sfn, slot)``, a scan dispatch's seed) and the counts ``add`` gave
it while it was the innermost open span.  Times are Unix-epoch nanoseconds,
the clock of ``torch.profiler``'s exported trace (its ``ts`` is µs after
its ``baseTimeNanoseconds``), so a span lines up with the device's
operations with no conversion but that one.

Spans are kept while ``enabled`` is set (the operator's switch) or while a
``torch.profiler`` records; while the profiler records, each span is also a
``record_function`` range of the same name.  With both off a span is one
shared do-nothing context and ``add`` returns at once: the cost is the read
of the two flags, and nothing is allocated.  ``write`` dumps the spans as a
Chrome trace (about://tracing, Perfetto).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


class SpanRecord:
    """One span: the context manager while it is open, then its record.
    ``parent`` is the ``id`` of the span that was innermost on the thread
    when it began (None at the top)."""
    __slots__ = ("name", "cat", "start_ns", "end_ns", "id", "parent", "req",
                 "tid", "counts", "_tracer", "_range")

    def __init__(self, tracer: "EventTracer", name: str, cat: str,
                 req) -> None:
        self._tracer, self.name, self.cat, self.req = tracer, name, cat, req
        self.counts = self._range = None

    def __enter__(self):
        stack = self._tracer._stack()
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.req is None:
                self.req = top.req
        else:
            self.parent = None
        self.id = next(self._tracer._ids)
        stack.append(self)
        self.start_ns = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        tracer, self._tracer = self._tracer, None
        tracer._local.stack.pop()
        self.tid = threading.get_ident() % (1 << 31)
        # one list append: atomic, so no lock on the hot path
        tracer._records.append(self)
        return False

    def __repr__(self) -> str:
        return (f"SpanRecord({self.name!r}, {self.cat!r}, {self.start_ns}, "
                f"{self.end_ns}, id={self.id}, parent={self.parent}, "
                f"req={self.req!r}, counts={self.counts})")


class EventTracer:
    def __init__(self) -> None:
        self._records: list[SpanRecord] = []
        self._local = threading.local()
        self._ids = itertools.count()
        self.enabled = False

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, cat: str, req=None):
        """``with tracer.span(name, cat, req):`` times the block as a span
        (a do-nothing context while tracing is off)."""
        # torch.profiler sets this module flag while it records
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return _OFF
        return SpanRecord(self, name, cat, req)

    def add(self, name: str, n: int = 1) -> None:
        """Add `n` to the count `name` of the innermost open span (nothing
        while tracing is off or no span is open)."""
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return
        stack = self._stack()
        if stack:
            top = stack[-1]
            if top.counts is None:
                top.counts = {}
            top.counts[name] = top.counts.get(name, 0) + n

    def records(self) -> list[SpanRecord]:
        """The spans closed since the last ``clear``, in the order they
        closed (a child before its parent)."""
        return list(self._records)

    def write(self, path: str) -> None:
        """The spans as a Chrome trace: ``ts`` in µs after the trace's
        ``baseTimeNanoseconds``, the parent, request id and counts under
        ``args``."""
        records = self.records()
        base = min((r.start_ns for r in records), default=0)
        events = [{"name": r.name, "cat": r.cat, "ph": "X",
                   "ts": (r.start_ns - base) / 1e3,
                   "dur": (r.end_ns - r.start_ns) / 1e3,
                   "pid": os.getpid(), "tid": r.tid,
                   "args": {"id": r.id, "parent": r.parent, "req": r.req,
                            "counts": r.counts or {}}}
                  for r in records]
        with open(path, "w") as f:
            json.dump({"baseTimeNanoseconds": base, "traceEvents": events},
                      f, default=str)

    def clear(self) -> None:
        self._records.clear()


#: process-global tracer (open_trace_file analogue: set .enabled, then write)
tracer = EventTracer()
