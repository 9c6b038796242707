"""The program's own spans and counts in the traced stretch of a run.

While ``torch.profiler`` records, the program's tracer
(``utils/tracing`` of the port) makes each of its spans a
``record_function`` range and keeps a record of it with its parent and
counts.  ``load`` parses the exported trace once per run (the device
operations as ``trace.read_chrome_trace`` takes them, every host range, and
the trace's base time, which puts the records on its clock), and takes the
tracer's records from the program as loaded, without importing it.  A
program without such spans leaves nothing to read, and every reader
returns None.

A span is in the stretch when it starts inside the ``ranbench.traced``
range, as a device operation is for ``reduce_trace``'s counts.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import sys
from pathlib import Path

from . import trace

TRACER_MODULE = "srsran_project_23_5_tpu_torch.utils.tracing"
WINDOW_SPAN = "ranbench.traced"
_LOADED: dict = {}


def trace_path(cell) -> Path:
    """Where the drivers' ``trace.Stretch`` exports a traced run's trace."""
    return cell.root / "build" / "ranbench" / "trace.json"


@dataclasses.dataclass
class ProgramTrace:
    window: tuple[float, float]          # µs, the trace's own clock
    base_ns: int                         # ts 0 in Unix-epoch ns
    device_ops: list                     # [(name, start µs, end µs)]
    ranges: dict                         # {name: [(start µs, end µs)]}
    records: list                        # the tracer's records, or []

    def starting(self, name: str) -> list:
        """The ranges named `name` that start in the stretch."""
        w0, w1 = self.window
        return [(s, e) for s, e in self.ranges.get(name, ()) if w0 <= s < w1]

    def within(self, names, outer) -> list:
        """The ranges of `names` inside one of the `outer` intervals."""
        out = []
        for name in names:
            out += [(s, e) for s, e in self.ranges.get(name, ())
                    if any(a <= s and e <= b for a, b in outer)]
        return out

    def records_starting(self, names) -> list:
        """The tracer's records of `names` that start in the stretch."""
        lo, hi = (self.base_ns + 1e3 * t for t in self.window)
        return [r for r in self.records
                if r.name in names and lo <= r.start_ns < hi]


def _records() -> list:
    """The records of the program's tracer, as loaded in this process."""
    mod = sys.modules.get(TRACER_MODULE)
    read = getattr(getattr(mod, "tracer", None), "records", None)
    return list(read()) if callable(read) else []


def _parse(path: Path) -> tuple:
    """(base ns, device operations, {name: host ranges}) of an exported
    trace."""
    with open(path) as f:
        doc = json.load(f)
    device, ranges = [], {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        cat = ev.get("cat", "")
        if cat in trace.DEVICE_CATS:
            device.append((ev["name"], s, e))
        elif cat == "user_annotation":
            ranges.setdefault(ev["name"], []).append((s, e))
    return int(doc.get("baseTimeNanoseconds", 0)), device, ranges


def load(cell, out) -> ProgramTrace | None:
    """The program's spans of this run's traced stretch, or None when the
    run was not traced or the trace has no stretch."""
    path = trace_path(cell)
    if not out.trace or not path.is_file():
        return None
    key = (str(path), path.stat().st_mtime_ns)
    if key not in _LOADED:
        _LOADED.clear()
        base, device, ranges = _parse(path)
        marks = ranges.get(WINDOW_SPAN)
        _LOADED[key] = ProgramTrace(
            window=(min(s for s, _ in marks), max(e for _, e in marks)),
            base_ns=base, device_ops=device, ranges=ranges,
            records=_records()) if marks else None
    return _LOADED[key]


def ms_per(pt: ProgramTrace, names, roots) -> float | None:
    """The time of the ranges of `names` inside the ranges of `roots` that
    start in the stretch, in ms per such root."""
    outer = [iv for root in roots for iv in pt.starting(root)]
    if not outer:
        return None
    return 1e-3 * sum(e - s for s, e in pt.within(names, outer)) / len(outer)


def idle_while_open_pct(pt: ProgramTrace, prefix: str) -> float | None:
    """The share of the stretch in which no device operation runs while a
    range whose name starts with `prefix` is open (``reduce_trace`` over
    each stretch of time that such a range covers)."""
    w0, w1 = pt.window
    if not pt.device_ops:
        return None
    spans = [(max(s, w0), min(e, w1)) for n, iv in pt.ranges.items()
             if n.startswith(prefix) for s, e in iv]
    spans = trace._merge([(s, e) for s, e in spans if e > s])
    if not spans:
        return None
    ops = sorted(pt.device_ops, key=lambda op: op[1])
    starts = [op[1] for op in ops]
    longest = max(e - s for _, s, e in ops)
    idle = 0.0
    for s, e in spans:
        lo = bisect.bisect_left(starts, s - longest)
        hi = bisect.bisect_left(starts, e)
        idle += trace.reduce_trace(ops[lo:hi], [], (s, e))["idle_s"]
    return 100.0 * idle / ((w1 - w0) * 1e-6)


def count_per(pt: ProgramTrace, roots, count: str) -> float | None:
    """The tracer's count `count` over the records of `roots` that start in
    the stretch, each with the records below it, per such root."""
    tops = {r.id for r in pt.records_starting(roots)}
    if not tops:
        return None
    by_id = {r.id: r for r in pt.records}
    total = 0
    for r in pt.records:
        up = r
        while up is not None and up.id not in tops:
            up = by_id.get(up.parent)
        if up is not None:
            total += (r.counts or {}).get(count, 0)
    return total / len(tops)
