"""OFDM slot modulation/demodulation (TS 38.211 §5.3, §5.4) on ``torch.fft``.

Counterpart of ``srsran_project_23_5_tpu/phy/lower/ofdm.py``: a whole slot
of symbols is one batched IFFT/FFT over [..., symbol, nfft], the cyclic
prefixes are one static gather, and the TS 38.211 §5.4 phase compensation
is exact for any centre frequency.

Grid frequency convention: subcarrier sc in [0, nsc) maps to the centred
frequency index sc - nsc/2 (negative frequencies in the upper FFT half).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...ran import numerology
from ...ran.constants import MAX_NSYMB_PER_SLOT


def _grid_to_bins(grid: torch.Tensor, nfft: int) -> torch.Tensor:
    """[..., nsc] → [..., nfft] with DC-centred mapping."""
    half = grid.shape[-1] // 2
    pad = grid.new_zeros((*grid.shape[:-1], nfft - grid.shape[-1]))
    return torch.cat([grid[..., half:], pad, grid[..., :half]], dim=-1)


def _bins_to_grid(bins: torch.Tensor, nsc: int) -> torch.Tensor:
    half = nsc // 2
    return torch.cat([bins[..., -half:], bins[..., :half]], dim=-1)


def _symbol_starts(mu: int, nfft: int, slot_in_subframe: int) -> np.ndarray:
    cps = numerology.cp_lengths(mu, nfft, slot_in_subframe).astype(np.int64)
    return np.concatenate([[0], np.cumsum(cps + nfft)[:-1]])


def phase_compensation(mu: int, nfft: int, slot_in_subframe: int,
                       center_freq_hz: float) -> np.ndarray:
    """Per-symbol phase factor e^{-j 2π f_c t_start(l)} (TS 38.211 §5.4)."""
    fs = numerology.sample_rate_hz(mu, nfft)
    cps = numerology.cp_lengths(mu, nfft, slot_in_subframe)
    t_start = (_symbol_starts(mu, nfft, slot_in_subframe) + cps) / fs
    phase = np.mod(center_freq_hz * t_start, 1.0)   # exact modular phase
    return np.exp(-2j * np.pi * phase).astype(np.complex64)


@functools.lru_cache(maxsize=64)
def _slot_tables(mu: int, nfft: int, slot_in_subframe: int,
                 center_freq_hz: float, device: torch.device):
    """(phase compensation [14], CP-insertion gather [slot_samples] into the
    flat [14*nfft] symbols, symbol-body gather [14, nfft] from the slot)."""
    comp = torch.from_numpy(phase_compensation(
        mu, nfft, slot_in_subframe, center_freq_hz)).to(device)
    cps = numerology.cp_lengths(mu, nfft, slot_in_subframe)
    starts = _symbol_starts(mu, nfft, slot_in_subframe)
    body = np.arange(nfft)
    tx = np.concatenate([l * nfft + np.concatenate(
        [np.arange(nfft - int(cps[l]), nfft), body])
        for l in range(MAX_NSYMB_PER_SLOT)])
    rx = (starts + cps)[:, None] + body[None, :]
    return (comp, torch.from_numpy(tx).to(device),
            torch.from_numpy(rx.astype(np.int64)).to(device))


def modulate_slot(grid: torch.Tensor, mu: int, nfft: int,
                  slot_in_subframe: int = 0,
                  center_freq_hz: float = 0.0) -> torch.Tensor:
    """OFDM-modulate slots: [..., 14, nsc] complex64 → [..., slot_samples].

    Scaled so a unit-power grid yields unit-power subcarrier amplitudes
    (s[n] = Σ_k a_k e^{j2πkn/N}).
    """
    if grid.shape[-2] != MAX_NSYMB_PER_SLOT:
        raise ValueError(f"grid has {grid.shape[-2]} symbols, not 14")
    comp, tx_idx, _ = _slot_tables(mu, nfft, slot_in_subframe,
                                   float(center_freq_hz), grid.device)
    time = torch.fft.ifft(_grid_to_bins(grid, nfft), dim=-1) * nfft
    time = time * comp[:, None]
    return time.reshape(*grid.shape[:-2], -1)[..., tx_idx]


def demodulate_slot(samples: torch.Tensor, nsc: int, mu: int, nfft: int,
                    slot_in_subframe: int = 0,
                    center_freq_hz: float = 0.0) -> torch.Tensor:
    """Inverse of modulate_slot: [..., slot_samples] → [..., 14, nsc]."""
    comp, _, rx_idx = _slot_tables(mu, nfft, slot_in_subframe,
                                   float(center_freq_hz), samples.device)
    time = samples[..., rx_idx] * torch.conj(comp)[:, None]
    bins = torch.fft.fft(time, dim=-1) / nfft
    return _bins_to_grid(bins, nsc)
