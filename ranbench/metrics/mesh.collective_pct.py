"""mesh.collective_pct: the device time of the NCCL kernels launched while
a ``mesh.gather`` span of the program was open, as a share of rank 0's
traced busy time.  A launch is tied to its kernel by the correlation id of
the exported trace; an all-gather's kernel runs until the slowest rank has
sent its part, so the share holds rank 0's wait on the others.  A program
without ``mesh.gather`` spans leaves nothing to read."""
import json

from ranbench.harness import program_trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def collective_seconds(path, window, gathers) -> float | None:
    """Seconds of the NCCL kernels that start in `window` (µs) and were
    launched inside one of the `gathers` host ranges (µs)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    gathers = sorted(gathers)
    launched = set()
    kernels = []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, ts = ev.get("cat", ""), float(ev["ts"])
        corr = (ev.get("args") or {}).get("correlation")
        if cat in LAUNCH_CATS and corr is not None and any(
                s <= ts < e for s, e in gathers):
            launched.add(corr)
        elif cat == "kernel" and "nccl" in ev["name"].lower():
            kernels.append((corr, ts, float(ev["dur"])))
    w0, w1 = window
    got = [d for corr, ts, d in kernels if corr in launched and w0 <= ts < w1]
    return 1e-6 * sum(got) if got else None


def read(cell, out):
    pt = program_trace.load(cell, out)
    if pt is None or not out.trace or out.trace["busy_s"] <= 0:
        return None
    gathers = pt.ranges.get("mesh.gather")
    if not gathers:
        return None
    secs = collective_seconds(program_trace.trace_path(cell), pt.window,
                              gathers)
    if secs is None:
        return None
    return 100.0 * secs / out.trace["busy_s"]
