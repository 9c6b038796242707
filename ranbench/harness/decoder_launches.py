"""The LDPC decoder's launches in a traced stretch, told apart by the graph
they decode: full-graph launches (a combined or retransmitted buffer, every
variable block) and truncated ones (an rv=0 read, the transmitted span).

The exported trace keeps each kernel's launch properties under ``args``:
its shared memory (static and dynamic), its grid and its correlation id,
which for a kernel of a CUDA graph is that of the ``cudaGraphLaunch`` that
replayed it.  At one grid (the codeblocks of one PUSCH in a batch) the full
graph's state is larger than any truncation's, so a launch is full-graph
when its shared memory is the larger of the two its grid shows.  A trace
without shared memory tells them by order: a batch of HARQ pairs launches
two rv=0 decodes, then two full-graph ones, and the slower pair of each
four is the full graph.

The program's tracer counts ``ldpc.full_graph``, the codeblock rows it
decodes on the full graph, while it builds a graph; a captured replay runs
no Python.  ``rows_match_capture`` holds the full-graph rows of every
replay that starts in the stretch against the rows the capture counted.
"""
from __future__ import annotations

import json

from . import program_trace, roofline, trace

WINDOW_SPAN = "ranbench.traced"
_LOADED: dict = {}


def _parse(path) -> tuple:
    """(window µs, decoder launches [{start, end, smem, grid, corr}],
    starts of graph launches {correlation: µs}) of an exported trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks, found, graph_launches = [], [], {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        cat, name = ev.get("cat", ""), ev.get("name", "")
        args = ev.get("args") or {}
        if cat == "user_annotation" and name == WINDOW_SPAN:
            marks.append((s, e))
        elif cat in trace.DEVICE_CATS and "ldpc_decode_kernel" in name:
            grid = args.get("grid")
            found.append({"start": s, "end": e,
                          "smem": args.get("shared memory"),
                          "grid": int(grid[0]) if grid else None,
                          "corr": args.get("correlation")})
        elif name.startswith("cudaGraphLaunch") and "correlation" in args:
            graph_launches[args["correlation"]] = s
    if not marks:
        return None, [], {}
    window = (min(s for s, _ in marks), max(e for _, e in marks))
    return window, sorted(found, key=lambda x: x["start"]), graph_launches


def _classify(launches: list) -> bool:
    """Marks each launch ``full``; False where the trace cannot tell."""
    if launches and all(x["smem"] is not None and x["grid"] is not None
                        for x in launches):
        by_grid: dict = {}
        for x in launches:
            by_grid.setdefault(x["grid"], set()).add(x["smem"])
        if any(len(v) != 2 for v in by_grid.values()):
            return False
        for x in launches:
            x["full"] = x["smem"] == max(by_grid[x["grid"]])
        return True
    # by order: rv=0, rv=0, full, full in every batch; the phase whose
    # pairs take longer is the full graph's
    means = []
    for phase in (0, 1):
        d = [x["end"] - x["start"] for i, x in enumerate(launches)
             if (i // 2) % 2 == phase]
        means.append(sum(d) / len(d) if d else 0.0)
    if len(launches) < 4 or means[0] == means[1]:
        return False
    full_phase = 0 if means[0] > means[1] else 1
    for i, x in enumerate(launches):
        x["full"] = (i // 2) % 2 == full_phase
    return True


def load(cell, out) -> dict | None:
    """{"window", "launches" (each with ``full``), "graph_launches"} of
    this run's traced stretch, or None."""
    path = program_trace.trace_path(cell)
    if not out.trace or not path.is_file():
        return None
    key = (str(path), path.stat().st_mtime_ns)
    if key not in _LOADED:
        _LOADED.clear()
        window, launches, graph_launches = _parse(path)
        _LOADED[key] = ({"window": window, "launches": launches,
                         "graph_launches": graph_launches}
                        if window and _classify(launches) else None)
    return _LOADED[key]


def capture_rows(cell) -> int | None:
    """The full-graph rows that the tracer counted in the captured pass of
    the scan program: ``ldpc.full_graph`` over the last K ``harq.pair``
    records under a ``graphs.capture`` record (before them, on the card,
    the capture's eager warm-up ran the same K batches)."""
    records = program_trace._records()
    by_id = {r.id: r for r in records}
    captures = {r.id for r in records if r.name == "graphs.capture"}

    def captured(r) -> bool:
        up = by_id.get(r.parent)
        while up is not None:
            if up.id in captures:
                return True
            up = by_id.get(up.parent)
        return False

    pairs = sorted((r for r in records if r.name == "harq.pair"
                    and captured(r)), key=lambda r: r.start_ns)
    k = cell.traffic["scan_batches"]
    if len(pairs) < k:
        return None
    return sum((r.counts or {}).get("ldpc.full_graph", 0)
               for r in pairs[-k:])


def rows_match_capture(cell, lt: dict) -> bool:
    """Every replay that starts in the stretch decodes as many full-graph
    rows as the capture counted (and at least one replay does)."""
    want = capture_rows(cell)
    if not want:
        return False
    w0, w1 = lt["window"]
    replays = {c for c, s in lt["graph_launches"].items() if w0 <= s < w1}
    rows = dict.fromkeys(replays, 0)
    for x in lt["launches"]:
        if x["full"] and x["corr"] in rows:
            rows[x["corr"]] += x["grid"] or 0
    return bool(rows) and all(n == want for n in rows.values())


def roofline_pct(cell, out, full: bool) -> float | None:
    """The least time of the full-graph (or the truncated) decoder launches
    that start in the stretch, each at its shape in the cell's traffic file
    (the shape of its grid's rows, or the batch's mean shape where the
    trace gives no grid), over their profiled time.  The full-graph share
    reads None unless their rows per replay equal the capture's count."""
    spec = cell.traffic.get("kernels", {}).get(
        "ldpc_dec_full" if full else "ldpc_dec")
    lt = load(cell, out)
    if not spec or lt is None:
        return None
    if full and not rows_match_capture(cell, lt):
        return None
    w0, w1 = lt["window"]
    picked = [x for x in lt["launches"]
              if x["full"] == full and w0 <= x["start"] < w1]
    seconds = sum(x["end"] - x["start"] for x in picked) * 1e-6
    if not picked or seconds <= 0.0:
        return None
    least = {s["rows"]: roofline.decoder_least_seconds(s)
             for s in spec["per_batch"]}
    mean = sum(least.values()) / len(least)
    return roofline.share_pct(
        sum(least.get(x["grid"], mean) for x in picked), seconds)
