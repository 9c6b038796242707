"""Host spans of the benchmark's own files: a name, a start and an end on
the host clock, kept in memory.  With a profiler on, each span is also a
``record_function`` range, so that the trace can say what the host was
doing during a device gap."""
from __future__ import annotations

import contextlib
import time

import torch


class Spans:
    """Spans by name: {name: [seconds, ...]}."""

    def __init__(self) -> None:
        self.seconds: dict[str, list[float]] = {}
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.annotate:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    def mean_ms(self, name: str) -> float | None:
        xs = self.seconds.get(name)
        return 1e3 * sum(xs) / len(xs) if xs else None
