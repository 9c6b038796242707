"""DM-RS sequence generation and type-1 mapping (TS 38.211 §6.4.1.1,

Copied from the port's ``srsran_project_23_5_tpu_torch/ops/dmrs.py``,
unchanged.

§7.4.1.1).

The port's translation of ``srsran_project_23_5_tpu/ops/dmrs.py``. Pilots
are pure configuration, so they are built on the host from the Gold tables
and moved to the device once per configuration; mapping positions are static
per configuration."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ran.constants import NRE
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


@functools.lru_cache(maxsize=256)
def type1_sc_indices(prb_start: int, nof_prb: int, delta: int) -> np.ndarray:
    """Subcarrier indices of type-1 (comb-2) pilots for one CDM group."""
    prbs = np.arange(prb_start, prb_start + nof_prb)
    base = prbs[:, None] * NRE + np.arange(0, NRE, 2)[None, :] + delta
    return base.reshape(-1).astype(np.int32)


def type1_sequence_indices(prb_start: int, nof_prb: int) -> np.ndarray:
    """Gold-pair index m of each pilot (r(m)); type 1 uses 6 values per PRB,
    counted from reference point PRB 0."""
    prbs = np.arange(prb_start, prb_start + nof_prb)
    m = prbs[:, None] * 6 + np.arange(6)[None, :]
    return m.reshape(-1).astype(np.int32)


def map_onto_symbols(grid: torch.Tensor, pilots: torch.Tensor,
                     dmrs_symbols: tuple[int, ...], sc_idx: np.ndarray,
                     amplitude: float = 1.0) -> torch.Tensor:
    """Write pilots into grid symbols: grid [..., nsym, nsc], pilots
    [len(dmrs_symbols), npilot] (or broadcastable) → a new grid (the input
    is not written)."""
    scs = torch.as_tensor(np.asarray(sc_idx, np.int64), device=grid.device)
    out = grid.clone()
    for i, l in enumerate(dmrs_symbols):
        out[..., l, scs] = (amplitude * pilots[i]).to(grid.dtype)
    return out


def extract_from_symbols(grid: torch.Tensor, dmrs_symbols: tuple[int, ...],
                         sc_idx: np.ndarray) -> torch.Tensor:
    """Gather pilot REs: [..., nsym, nsc] → [..., len(dmrs_symbols), npilot]."""
    scs = torch.as_tensor(np.asarray(sc_idx, np.int64), device=grid.device)
    return torch.stack([grid[..., l, scs] for l in dmrs_symbols], dim=-2)
