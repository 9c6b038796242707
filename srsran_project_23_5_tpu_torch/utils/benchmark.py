"""Percentile micro-benchmark harness.

Counterpart of the reference's benchmarker (include/srsran/support/
benchmark_utils.h:56-93): named measurement sets, percentile latency and
derived throughput reporting.  PyTorch returns before the GPU finishes, so
a measured function that runs on the card calls ``torch.cuda.synchronize()``
before it returns: the clock is read after each call, and without the
synchronise it measures the enqueue.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass
class Measurement:
    name: str
    times_s: list[float]
    units_per_call: float = 0.0   # e.g. bits processed per call

    def percentile_us(self, q: float) -> float:
        return float(np.percentile(np.asarray(self.times_s) * 1e6, q))

    @property
    def median_us(self) -> float:
        return self.percentile_us(50)

    def throughput_mbps(self) -> float:
        med_s = np.median(self.times_s)
        return self.units_per_call / med_s / 1e6 if med_s else 0.0


class Benchmarker:
    def __init__(self, title: str) -> None:
        self.title = title
        self.measurements: list[Measurement] = []

    def run(self, name: str, fn: Callable[[], object], *, reps: int = 20,
            warmup: int = 2, units_per_call: float = 0.0) -> Measurement:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        m = Measurement(name, times, units_per_call)
        self.measurements.append(m)
        return m

    def report(self) -> str:
        lines = [f"== {self.title} =="]
        for m in self.measurements:
            line = (f"{m.name}: p50={m.median_us:.1f}us "
                    f"p90={m.percentile_us(90):.1f}us "
                    f"p99={m.percentile_us(99):.1f}us")
            if m.units_per_call:
                line += f" throughput={m.throughput_mbps():.1f}Mbps"
            lines.append(line)
        return "\n".join(lines)
