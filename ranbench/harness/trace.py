"""A profiler trace of a steady stretch of the window, and its reduction.

``Profiled`` runs ``torch.profiler`` (CPU and CUDA activities) around a
stretch of the measured window, exports the Chrome trace to a fixed path
inside the checkout and reduces it with ``reduce_trace``: the device's
busy time (the union of kernel, copy and set intervals), the traced
window, the device operations that took most time, the idle gaps by the
host span that was open when each began, and device seconds by name.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _merge(intervals):
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(device_ops, host_spans, window) -> dict:
    """device_ops: [(name, start_us, end_us)] of device operations;
    host_spans: [(name, start_us, end_us)] of the benchmark's host spans;
    window: (start_us, end_us) of the traced stretch.

    Returns {"busy_s", "window_s", "idle_s", "device_ops": [[name, s]],
    "idle_gaps": [[host span, s]], "by_name": {name: s}, "count": {name:
    n}, "whole": {name: s}}: intervals are clipped to the window for the
    busy time, the top operations and the gaps; a gap is attributed to the
    innermost host span open at its start ("between_spans" when none is);
    ``count`` and ``whole`` take the operations that start in the window,
    each with its whole duration (what a roofline divides by).
    """
    w0, w1 = window
    if w1 <= w0:
        raise ValueError("an empty traced window")
    clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in device_ops
               if e > w0 and s < w1]
    by_name: dict[str, float] = {}
    for n, s, e in clipped:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    merged = _merge([(s, e) for _, s, e in clipped])
    busy = sum(e - s for s, e in merged) * 1e-6
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = sorted(host_spans, key=lambda t: t[1])
    by_host: dict[str, float] = {}
    for g0, g1 in gaps:
        open_ = [(s, n) for n, s, e in spans if s <= g0 < e]
        owner = max(open_)[1] if open_ else "between_spans"
        by_host[owner] = by_host.get(owner, 0.0) + (g1 - g0) * 1e-6
    # operations that start in the window, whole: counts and full seconds
    count: dict[str, int] = {}
    whole: dict[str, float] = {}
    for n, s, e in device_ops:
        if w0 <= s < w1:
            count[n] = count.get(n, 0) + 1
            whole[n] = whole.get(n, 0.0) + (e - s) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps_top = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy, "window_s": (w1 - w0) * 1e-6,
            "idle_s": (w1 - w0) * 1e-6 - busy,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps_top], "by_name": by_name,
            "count": count, "whole": whole}


def read_chrome_trace(path: Path, span_prefix: str):
    """(device_ops, host_spans, profiled range) of an exported trace: device
    operations by category, host spans whose name starts with
    `span_prefix`, and the range of all timed events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host = [], []
    lo, hi = float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        lo, hi = min(lo, s), max(hi, e)
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((ev["name"], s, e))
        elif cat == "user_annotation" and ev["name"].startswith(span_prefix):
            host.append((ev["name"], s, e))
    return device, host, (lo, hi)


class Profiled:
    """``with Profiled(path, spans) as p:`` profiles the block; the block
    ends with the device synchronised.  ``p.result`` then holds
    ``reduce_trace``'s reduction over the block's host range, the
    (``window`` marked by the outermost span named ``window_span``)."""

    def __init__(self, path: Path, spans, window_span: str) -> None:
        self.path = Path(path)
        self.spans = spans
        self.window_span = window_span
        self.result: dict | None = None

    def __enter__(self):
        import torch
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.spans.annotate = True
        return self

    def __exit__(self, *exc):
        self.spans.annotate = False
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        t0 = time.perf_counter()
        self._prof.export_chrome_trace(str(self.path))
        device, host, _ = read_chrome_trace(self.path, "ranbench.")
        marks = [(s, e) for n, s, e in host if n == self.window_span]
        if not marks:
            raise RuntimeError(f"no {self.window_span} span in the trace")
        window = (min(s for s, _ in marks), max(e for _, e in marks))
        self.result = reduce_trace(device, host, window)
        self.result["reduce_s"] = time.perf_counter() - t0
        return False


class Stretch:
    """The traced stretch of a window of numbered steps: the profiler starts
    at step `first`, one step before the ``ranbench.traced`` span opens (so
    that its start-up is outside), and both close after `count` traced steps
    with the device synchronised (`sync`).  Call ``before(i)`` and
    ``after(i)`` around step i; ``result`` then holds the reduction."""

    def __init__(self, path: Path, spans, first: int, count: int,
                 sync) -> None:
        self.path, self.spans = path, spans
        self.first, self.last = first, first + count
        self.sync = sync
        self.result: dict | None = None
        self._prof = self._span = None

    @property
    def done(self) -> bool:
        return self.result is not None

    def before(self, i: int) -> None:
        if i == self.first:
            self._prof = Profiled(self.path, self.spans, "ranbench.traced")
            self._prof.__enter__()
        elif i == self.first + 1:
            self._span = self.spans.span("ranbench.traced")
            self._span.__enter__()

    def after(self, i: int) -> None:
        if i == self.last:
            self.sync()
            self._span.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            self.result = self._prof.result
