"""Baseband channel emulation for loopback runs and tests.

Counterpart of ``srsran_project_23_5_tpu/testing/channels.py``: a
deterministic multi-tap (TDL-like) channel at integer sample delays,
applied at baseband.  Each tap is a static shift done as pad + slice.
"""
from __future__ import annotations

import numpy as np
import torch


def normalize_taps(delays, gains_db) -> tuple[tuple[int, ...],
                                              tuple[float, ...]]:
    """(delays, power-normalised linear gains) of a dB tap profile."""
    g = 10.0 ** (np.asarray(gains_db, np.float64) / 20.0)
    g = g / np.sqrt(np.sum(g ** 2))
    return tuple(int(d) for d in delays), tuple(float(x) for x in g)


def tdl_apply(x: torch.Tensor, delays, gains) -> torch.Tensor:
    """y[n] = Σ_k g_k · x[n − d_k] over the last axis; real or complex
    scalar gains, integer delays.  No taps ⇒ x (frequency-flat)."""
    out = None
    for d, g in zip(delays, gains):
        t = x if d == 0 else torch.cat(
            [x.new_zeros((*x.shape[:-1], d)), x[..., :-d]], dim=-1)
        out = g * t if out is None else out + g * t
    return x if out is None else out
