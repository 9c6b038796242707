"""NZP-CSI-RS generation (TS 38.211 §7.4.1.5).

Copied from the port's
``srsran_project_23_5_tpu_torch/phy/upper/csi_rs.py``, unchanged.

The port's translation of ``srsran_project_23_5_tpu/phy/upper/csi_rs.py``:
rows 1, 2 and 4 of Table 7.4.1.5.3-1, Gold-QPSK pilots baked on the host."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...ops import gold
from ...ran.constants import NRE


@dataclasses.dataclass(frozen=True)
class CsiRsConfig:
    row: int = 2                  # Table 7.4.1.5.3-1 row (1, 2 or 4)
    prb_start: int = 0
    nof_prb: int = 106
    symbol: int = 4               # l0
    subcarrier_offset: int = 0    # k0
    scrambling_id: int = 0
    slot_in_frame: int = 0
    amplitude: float = 1.0


def _cinit(cfg: CsiRsConfig) -> int:
    return ((1 << 10) * (14 * cfg.slot_in_frame + cfg.symbol + 1)
            * (2 * cfg.scrambling_id + 1) + cfg.scrambling_id) % (1 << 31)


def _layout(cfg: CsiRsConfig) -> tuple[np.ndarray, int]:
    """(subcarrier offsets within a PRB, pilots per PRB) of the row."""
    if cfg.row == 1:      # density 3, 1 port: k0 + {0, 4, 8}
        return np.array([0, 4, 8]) + cfg.subcarrier_offset, 3
    if cfg.row == 2:      # density 1, 1 port: one RE per PRB
        return np.array([cfg.subcarrier_offset]), 1
    if cfg.row == 4:      # 4 ports, CDM2 pairs at k0, k0+2 (port 0 shown)
        return np.array([0, 2]) + cfg.subcarrier_offset, 2
    raise NotImplementedError(f"CSI-RS row {cfg.row}")


@functools.lru_cache(maxsize=16)
def _pilots(cfg: CsiRsConfig, device: torch.device) -> torch.Tensor:
    """[nof_prb·per_prb] QPSK pilots, Gold at offset 2·per_prb·prb_start."""
    _, per_prb = _layout(cfg)
    npil = cfg.nof_prb * per_prb
    c = gold.gold_sequence_np(_cinit(cfg), 2 * npil,
                              offset=2 * per_prb * cfg.prb_start)
    c = c.astype(np.float32)
    inv = np.float32(1.0) / np.float32(np.sqrt(2.0))
    pil = ((1 - 2 * c[0::2]) * inv + 1j * ((1 - 2 * c[1::2]) * inv)
           ).astype(np.complex64)
    return torch.from_numpy(pil).to(device) * cfg.amplitude


def generate(cfg: CsiRsConfig, grid: torch.Tensor) -> torch.Tensor:
    """Write the CSI-RS resource (port 0) onto [..., 14, nsc] grids (set,
    not add)."""
    offs, per_prb = _layout(cfg)
    pil = _pilots(cfg, grid.device)
    lo = cfg.prb_start * NRE
    out = grid.clone()
    blk = out[..., cfg.symbol, lo:lo + cfg.nof_prb * NRE].unflatten(
        -1, (cfg.nof_prb, NRE))
    for i, off in enumerate(offs):
        blk[..., int(off)] = pil[i::per_prb]
    return out
