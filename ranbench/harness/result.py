"""The result of a run: the last line of standard output, one JSON object,
and the compared numbers beside their limits as the last lines of standard
error."""
from __future__ import annotations

import dataclasses
import json
import sys


@dataclasses.dataclass
class Compared:
    """A number compared with the reference, and its limit (the number
    passes when it is at most the limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def judge(compared: list[Compared]) -> bool:
    return bool(compared) and all(c.ok for c in compared)


def line(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, compared: list[Compared],
         breakdown: dict | None = None) -> str:
    """The result line: `metrics` {name: (value, unit)}; the compared
    numbers come last, under ``limits``."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": float(v), "unit": u}
                       for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["limits"] = {c.name: {"value": float(c.value),
                              "limit": float(c.limit)} for c in compared}
    return json.dumps(out)


def emit(text: str, compared: list[Compared]) -> None:
    """Print the compared numbers as the last lines of standard error, then
    the result line as the last line of standard output."""
    for c in compared:
        print(f"{c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(text, flush=True)
