"""Constellation mapping and max-log soft demapping (TS 38.211 §5.1).

Written for the benchmark from the specification, not from the port's
code.  The points are the formulas of TS 38.211 §5.1.2-5.1.6 evaluated in
float64 for every bit label; mapping is a lookup of the MSB-first label in
that table, and the max-log demapper searches the whole two-dimensional
constellation for each symbol: LLR_k = (min over points with bit k = 1 of
|y - s|² - min over points with bit k = 0 of |y - s|²) / σ², ln(P(0)/P(1)),
positive for bit 0, computed in float64 and handed on in float32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..precision import q


def _spec_point(b: list[int], qm: int) -> complex:
    """TS 38.211 §5.1: the symbol of bit label b[0..qm-1]."""
    s = [1 - 2 * v for v in b]
    if qm == 1:
        return s[0] * (1 + 1j) / np.sqrt(2.0)
    if qm == 2:
        return (s[0] + 1j * s[1]) / np.sqrt(2.0)
    if qm == 4:
        return (s[0] * (2 - s[2]) + 1j * s[1] * (2 - s[3])) / np.sqrt(10.0)
    if qm == 6:
        return (s[0] * (4 - s[2] * (2 - s[4]))
                + 1j * s[1] * (4 - s[3] * (2 - s[5]))) / np.sqrt(42.0)
    if qm == 8:
        return (s[0] * (8 - s[2] * (4 - s[4] * (2 - s[6])))
                + 1j * s[1] * (8 - s[3] * (4 - s[5] * (2 - s[7])))
                ) / np.sqrt(170.0)
    raise ValueError(f"modulation order {qm} not in (1, 2, 4, 6, 8)")


@functools.lru_cache(maxsize=None)
def _labels(qm: int) -> np.ndarray:
    """[2^qm, qm] bits of each MSB-first label."""
    lab = np.arange(1 << qm)
    return np.stack([(lab >> (qm - 1 - k)) & 1 for k in range(qm)], axis=1)


@functools.lru_cache(maxsize=None)
def constellation(qm: int) -> np.ndarray:
    """complex128 points indexed by the MSB-first bit label."""
    return np.asarray([_spec_point(list(b), qm) for b in _labels(qm)],
                      np.complex128)


@functools.lru_cache(maxsize=None)
def pam_levels(qm: int) -> np.ndarray:
    """The distinct per-axis amplitudes of the constellation (float32)."""
    return np.unique(constellation(qm).real).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables_on(qm: int, device: torch.device):
    return (torch.from_numpy(constellation(qm)).to(device),
            torch.from_numpy(_labels(qm).T == 1).to(device))


def modulate(bits: torch.Tensor, qm: int) -> torch.Tensor:
    """[..., E] {0,1} → [..., E/qm] complex64 symbols."""
    *lead, e = bits.shape
    if e % qm:
        raise ValueError(f"{e} bits do not fill {qm}-bit symbols")
    weights = 1 << torch.arange(qm - 1, -1, -1, device=bits.device)
    labels = (bits.reshape(*lead, e // qm, qm).to(torch.int64)
              * weights).sum(dim=-1)
    return _tables_on(qm, bits.device)[0][labels].to(torch.complex64)


def demodulate_soft(symbols: torch.Tensor, noise_var: torch.Tensor,
                    qm: int, chunk: int = 8192) -> torch.Tensor:
    """Max-log soft demap: [..., S] complex, [..., S] post-equalisation
    noise variance → [..., S·qm] float32 LLRs."""
    if qm not in (2, 4, 6, 8):
        raise ValueError(f"modulation order {qm} not in (2, 4, 6, 8)")
    points, is_one = _tables_on(qm, symbols.device)
    lead = symbols.shape[:-1]
    nv = torch.as_tensor(noise_var, device=symbols.device).to(
        torch.float64).expand(symbols.shape).reshape(-1)
    y = symbols.to(torch.complex128).reshape(-1)
    out = torch.empty((y.numel(), qm), dtype=torch.float64, device=y.device)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=y.device)
    for a in range(0, y.numel(), chunk):
        d2 = (y[a:a + chunk, None] - points).abs() ** 2       # [n, 2^qm]
        d2 = d2[:, None, :]                                   # [n, 1, 2^qm]
        m1 = torch.where(is_one, d2, inf).amin(dim=-1)        # [n, qm]
        m0 = torch.where(is_one, inf, d2).amin(dim=-1)
        out[a:a + chunk] = (m1 - m0) / nv[a:a + chunk, None]
    return q(out.to(torch.float32).reshape(*lead, -1))
