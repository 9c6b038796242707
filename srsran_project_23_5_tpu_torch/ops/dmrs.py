"""DM-RS sequence generation for type-1 mapping (TS 38.211 §6.4.1.1, §7.4.1.1).

Counterpart of ``srsran_project_23_5_tpu/ops/dmrs.py``.  Pilots are pure
configuration, so they are built on the host from the Gold tables and moved
to the device once per configuration.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import gold

_INV_SQRT2 = np.float32(1.0) / np.float32(np.sqrt(2.0))


def dmrs_cinit(slot_in_frame: int, symbol: int, nid: int, n_scid: int) -> int:
    """c_init for DM-RS (TS 38.211 §7.4.1.1.1 / §6.4.1.1.1)."""
    return ((1 << 17) * (14 * slot_in_frame + symbol + 1) * (2 * nid + 1)
            + 2 * nid + n_scid) % (1 << 31)


@functools.lru_cache(maxsize=256)
def pilot_values(cinits: tuple[int, ...], prb_start: int, nof_prb: int,
                 device: torch.device) -> torch.Tensor:
    """QPSK pilots r(m) for the allocated PRBs: [len(cinits), 6*nof_prb]
    complex64 on `device` (one row per DM-RS symbol's c_init)."""
    count = 6 * nof_prb
    c = np.stack([gold.gold_sequence_np(ci, 2 * count, offset=12 * prb_start)
                  for ci in cinits]).astype(np.float32)
    re = (1.0 - 2.0 * c[:, 0::2]) * _INV_SQRT2
    im = (1.0 - 2.0 * c[:, 1::2]) * _INV_SQRT2
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)
