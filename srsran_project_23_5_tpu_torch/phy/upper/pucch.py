"""PUCCH Format 1: HARQ-ACK transmit and correlation detection.

Counterpart of the Format 1 part of
``srsran_project_23_5_tpu/phy/upper/pucch.py``: per-symbol base sequences
with cyclic-shift hopping and the time-domain OCC are host constants; the
detector despreads the DM-RS and data symbols of every slot of the batch
at once.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...ops import gold, modulation, sequences
from ...ran.constants import NRE


@dataclasses.dataclass(frozen=True)
class PucchF1Config:
    prb: int                     # PRB index of the (single-PRB) resource
    start_symbol: int = 0
    nof_symbols: int = 14        # 4..14
    initial_cyclic_shift: int = 0
    occ_index: int = 0
    n_id: int = 0                # hopping id (group hopping disabled)
    slot_in_frame: int = 0
    nof_harq_bits: int = 1       # 1 or 2

    @property
    def data_symbols(self) -> tuple[int, ...]:
        return tuple(self.start_symbol + i
                     for i in range(1, self.nof_symbols, 2))

    @property
    def dmrs_symbols(self) -> tuple[int, ...]:
        return tuple(self.start_symbol + i
                     for i in range(0, self.nof_symbols, 2))


@functools.lru_cache(maxsize=256)
def _cs_hopping(n_id: int, slot: int) -> np.ndarray:
    """n_cs(l) per symbol of the slot (TS 38.211 §6.3.2.2.2)."""
    c = gold.gold_sequence_np(n_id, 8 * 14, offset=8 * 14 * slot)
    return (c.reshape(14, 8) << np.arange(8)).sum(axis=1) % 12


@functools.lru_cache(maxsize=64)
def _occ_w(length: int, idx: int) -> np.ndarray:
    """Time-domain OCC w_i (DFT basis, TS 38.211 Table 6.3.2.4.1-2)."""
    m = np.arange(length)
    return np.exp(2j * np.pi * idx * m / length).astype(np.complex64)


def _f1_symbol_seqs(cfg: PucchF1Config,
                    symbols: tuple[int, ...]) -> np.ndarray:
    """Base sequence × cyclic shift for each symbol: [nsym_used, 12]."""
    u = cfg.n_id % 30
    ncs = _cs_hopping(cfg.n_id, cfg.slot_in_frame)
    rows = []
    for l in symbols:
        alpha = 2 * np.pi * ((cfg.initial_cyclic_shift + ncs[l]) % 12) / 12
        rows.append(sequences.cyclic_shifted(u, 0, NRE, alpha))
    return np.asarray(rows, dtype=np.complex64)


@functools.lru_cache(maxsize=16)
def _tables(cfg: PucchF1Config, device: torch.device):
    """(data sequences [nd, 12], OCC of the data symbols [nd], DM-RS
    sequences × OCC [nm, 12]) on `device`."""
    to = lambda a: torch.from_numpy(a).to(device)
    data = to(_f1_symbol_seqs(cfg, cfg.data_symbols))
    w_d = to(_occ_w(len(cfg.data_symbols), cfg.occ_index))
    dmrs = (to(_occ_w(len(cfg.dmrs_symbols), cfg.occ_index))[:, None]
            * to(_f1_symbol_seqs(cfg, cfg.dmrs_symbols)))
    return data, w_d, dmrs


def pucch_f1_transmit(bits: torch.Tensor, cfg: PucchF1Config,
                      grid: torch.Tensor) -> torch.Tensor:
    """Map [B, nof_harq_bits] HARQ-ACK bits onto [B, 14, nsc] grids (set)."""
    data, w_d, dmrs = _tables(cfg, grid.device)
    d = modulation.modulate(bits, 1 if cfg.nof_harq_bits == 1 else 2)[..., 0]
    lo = cfg.prb * NRE
    out = grid.clone()
    for i, l in enumerate(cfg.data_symbols):
        out[..., l, lo:lo + NRE] = (d * w_d[i])[:, None] * data[i]
    for i, l in enumerate(cfg.dmrs_symbols):
        out[..., l, lo:lo + NRE] = dmrs[i]
    return out


@dataclasses.dataclass
class PucchF1Result:
    bits: torch.Tensor            # [B, nof_harq_bits] detected HARQ-ACK bits
    detection_metric: torch.Tensor   # [B]
    detected: torch.Tensor        # [B] bool: energy over the DTX threshold


def pucch_f1_detect(rx_grid: torch.Tensor, cfg: PucchF1Config,
                    dtx_threshold: float = 4.0) -> PucchF1Result:
    """Detect F1 HARQ bits from [B, nrx, 14, nsc] grids: despread the
    DM-RS symbols into a channel estimate per rx port, despread the data
    symbols, combine over subcarriers, symbols and rx ports."""
    data, w_d, dmrs = _tables(cfg, rx_grid.device)
    lo = cfg.prb * NRE
    y_m = torch.stack([rx_grid[..., l, lo:lo + NRE]
                       for l in cfg.dmrs_symbols], dim=-2)   # [B, nrx, nm, 12]
    h_est = (y_m * torch.conj(dmrs)).mean(dim=-2)            # [B, nrx, 12]
    y_d = torch.stack([rx_grid[..., l, lo:lo + NRE]
                       for l in cfg.data_symbols], dim=-2)
    d_est_res = y_d * torch.conj(data * w_d[:, None])
    num = (torch.conj(h_est)[..., None, :] * d_est_res).sum(dim=(-2, -1))
    den = (h_est.abs() ** 2).sum(dim=-1) * len(cfg.data_symbols)  # [B, nrx]
    d_hat = num.sum(dim=-1) / torch.clamp(den.sum(dim=-1), min=1e-12)

    # noise from the DM-RS residual around the averaged channel
    resid = y_m - h_est[..., None, :] * dmrs
    noise = (resid.abs() ** 2).flatten(1).mean(dim=-1) + 1e-12      # [B]
    metric = d_hat.abs() ** 2 * den.sum(dim=-1) / noise
    if cfg.nof_harq_bits == 1:
        bits = (d_hat.real + d_hat.imag <= 0).to(torch.int8)[:, None]
    else:
        bits = torch.stack([(d_hat.real <= 0).to(torch.int8),
                            (d_hat.imag <= 0).to(torch.int8)], dim=-1)
    return PucchF1Result(bits=bits, detection_metric=metric,
                         detected=metric > dtx_threshold)
