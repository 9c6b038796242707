"""The LDPC kernels' share of their roofline in a traced stretch: the least
time of the launches that start in it (shapes and sweep counts from the
cell's traffic file) over the launches' profiled time."""
from __future__ import annotations

from . import roofline

LEAST = {"ldpc_dec": roofline.decoder_least_seconds,
         "ldpc_enc": roofline.encoder_least_seconds}


def roofline_pct(cell, out, kernel: str) -> float | None:
    spec = cell.traffic.get("kernels", {}).get(kernel)
    t = out.trace
    if not spec or not t:
        return None
    names = [n for n in t["count"] if spec["match"] in n]
    launches = sum(t["count"][n] for n in names)
    seconds = sum(t["whole"][n] for n in names)
    shapes = spec["per_batch"]
    if not launches or seconds <= 0.0:
        return None
    # the batch's launches run in a fixed order, so whole batches of them
    # take each shape once; a stretch cut mid-batch is off by at most one
    per_launch = sum(LEAST[kernel](s) for s in shapes) / len(shapes)
    return roofline.share_pct(per_launch * launches, seconds)
