"""Port channel estimation from comb-2 DM-RS pilots.

Counterpart of ``estimate_comb2`` in ``srsran_project_23_5_tpu/ops/estimator.py``
(least squares at the pilots, average across DM-RS symbols, noise variance
from the residuals, time-alignment derotation and midpoint interpolation onto
the allocation).  Per-symbol time interpolation is not ported.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class CombChannelEstimate:
    """Estimate over a contiguous comb-2 allocation."""
    h_alloc: torch.Tensor     # [..., nsc_alloc] complex64
    noise_var: torch.Tensor   # [...]
    epre: torch.Tensor        # [...] average energy per pilot RE
    rsrp: torch.Tensor        # [...] |avg channel|^2 power
    ta_norm: torch.Tensor     # [...] delay in samples = ta_norm * nfft


def _comb2_interp(p: torch.Tensor) -> torch.Tensor:
    """Pilot-comb values [..., npil] at even subcarriers → allocation grid
    [..., 2*npil] via midpoint interpolation with edge extrapolation."""
    p_next = torch.cat([p[..., 1:], 2 * p[..., -1:] - p[..., -2:-1]], dim=-1)
    pair = torch.stack([p, 0.5 * (p + p_next)], dim=-1)
    return pair.reshape(*p.shape[:-1], 2 * p.shape[-1])


def estimate_comb2(rx_pilots: torch.Tensor,
                   tx_pilots: torch.Tensor) -> CombChannelEstimate:
    """LS + average + structured linear interpolation for comb-2 pilots on a
    contiguous allocation (CDM group 0).

    rx_pilots: [..., ndmrs_sym, npilot] at allocation subcarriers 2k;
    tx_pilots broadcastable to it.  The delay ramp is estimated from the
    mean lag-1 pilot correlation, removed before the interpolation and
    re-applied after it.
    """
    lse = rx_pilots * torch.conj(tx_pilots) / (tx_pilots.abs() ** 2)
    ndmrs = lse.shape[-2]
    p = lse.mean(dim=-2)                                     # [..., npilot]
    if ndmrs > 1:
        resid = lse - p[..., None, :]
        noise_var = ((resid.abs() ** 2).mean(dim=(-1, -2))
                     * ndmrs / (ndmrs - 1))
    else:
        diff = lse[..., 0, 1:] - lse[..., 0, :-1]
        noise_var = 0.5 * (diff.abs() ** 2).mean(dim=-1)
    epre = (rx_pilots.abs() ** 2).mean(dim=(-1, -2))
    rsrp = (p.abs() ** 2).mean(dim=-1)

    # phase per pilot step (pilots are two subcarriers apart)
    corr = (p[..., 1:] * torch.conj(p[..., :-1])).sum(dim=-1)
    phi = torch.angle(corr)                                  # [...]
    ta_norm = -phi / (4.0 * math.pi)
    npil = p.shape[-1]
    m_idx = torch.arange(npil, dtype=torch.float32, device=p.device)
    derot = torch.exp(-1j * phi[..., None] * m_idx)
    sc_idx = torch.arange(2 * npil, dtype=torch.float32, device=p.device)
    rerot = torch.exp(1j * (phi[..., None] / 2.0) * sc_idx)
    h_alloc = _comb2_interp(p * derot) * rerot
    return CombChannelEstimate(h_alloc=h_alloc, noise_var=noise_var,
                               epre=epre, rsrp=rsrp, ta_norm=ta_norm)
