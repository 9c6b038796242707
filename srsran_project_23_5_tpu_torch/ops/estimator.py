"""Port channel estimation from comb-2 DM-RS pilots.

Counterpart of ``estimate_comb2``, ``estimate_comb2_occ2`` and
``estimate_port`` in ``srsran_project_23_5_tpu/ops/estimator.py`` (least
squares at the pilots, CDM despreading for two layers per CDM group, average
across DM-RS symbols, noise variance from the residuals, time-alignment
derotation, per-DM-RS-symbol estimates for time interpolation, and linear
interpolation onto the allocation).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch


@dataclasses.dataclass
class CombChannelEstimate:
    """Estimate over a contiguous comb-2 allocation."""
    h_alloc: torch.Tensor     # [..., nsc_alloc] complex64
    noise_var: torch.Tensor   # [...]
    epre: torch.Tensor        # [...] average energy per pilot RE
    rsrp: torch.Tensor        # [...] |avg channel|^2 power
    # [...] delay in samples = ta_norm * nfft (single-layer estimate only)
    ta_norm: torch.Tensor | None = None
    # [..., ndmrs, nsc_alloc] per-DM-RS-symbol estimates (time_interp)
    h_dmrs: torch.Tensor | None = None


@dataclasses.dataclass
class ChannelEstimate:
    """Estimate over the full grid (``estimate_port``)."""
    h: torch.Tensor           # [..., nsym, nsc] complex64
    noise_var: torch.Tensor   # [...]
    epre: torch.Tensor
    rsrp: torch.Tensor


def _comb2_interp(p: torch.Tensor) -> torch.Tensor:
    """Pilot-comb values [..., npil] at even subcarriers → allocation grid
    [..., 2*npil] via midpoint interpolation with edge extrapolation."""
    p_next = torch.cat([p[..., 1:], 2 * p[..., -1:] - p[..., -2:-1]], dim=-1)
    pair = torch.stack([p, 0.5 * (p + p_next)], dim=-1)
    return pair.reshape(*p.shape[:-1], 2 * p.shape[-1])


def estimate_comb2(rx_pilots: torch.Tensor, tx_pilots: torch.Tensor,
                   time_interp: bool = False) -> CombChannelEstimate:
    """LS + average + structured linear interpolation for comb-2 pilots on a
    contiguous allocation (CDM group 0).

    rx_pilots: [..., ndmrs_sym, npilot] at allocation subcarriers 2k;
    tx_pilots broadcastable to it.  The delay ramp is estimated from the
    mean lag-1 pilot correlation, removed before the interpolation and
    re-applied after it.  time_interp=True also returns the estimate of each
    DM-RS symbol (h_dmrs) for interpolation across time.
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
    h_dmrs = (_comb2_interp(lse * derot[..., None, :]) * rerot[..., None, :]
              if time_interp else None)
    return CombChannelEstimate(h_alloc=h_alloc, noise_var=noise_var,
                               epre=epre, rsrp=rsrp, ta_norm=ta_norm,
                               h_dmrs=h_dmrs)


def estimate_comb2_occ2(rx_pilots: torch.Tensor, tx_pilots: torch.Tensor,
                        sc_offset: int = 0) -> CombChannelEstimate:
    """Two-layer CDM despread estimate (DM-RS type 1): CDM group 0 (ports
    0/1, even comb) or, with sc_offset=1, CDM group 1 (ports 2/3, odd comb).

    The two ports of a group share the comb and are separated by the
    frequency OCC [+1,+1] / [+1,-1] over consecutive pilot pairs.
    rx_pilots: [..., ndmrs_sym, npilot]; tx_pilots the port-0 (un-OCC'd)
    pilots.  Returns h_alloc [..., 2, nsc_alloc], the channel of each layer
    over the allocation, and noise_var/epre/rsrp per leading index (no
    ta_norm).
    """
    lse = rx_pilots * torch.conj(tx_pilots) / (tx_pilots.abs() ** 2)
    even = lse[..., 0::2]
    odd = lse[..., 1::2]
    h = torch.stack([0.5 * (even + odd), 0.5 * (even - odd)],
                    dim=-3)                                # [..., 2, nsym, np]
    ndmrs = h.shape[-2]
    p = h.mean(dim=-2)                                     # [..., 2, npair]
    if ndmrs > 1:
        resid = h - p[..., None, :]
        # despreading halves the per-RE noise: scale the residual var by 2
        noise_var = (2.0 * (resid.abs() ** 2).mean(dim=(-1, -2, -3))
                     * ndmrs / (ndmrs - 1))
    else:
        diff = p[..., 1:] - p[..., :-1]
        noise_var = (diff.abs() ** 2).mean(dim=(-1, -2))
    epre = (rx_pilots.abs() ** 2).mean(dim=(-1, -2))
    rsrp = (p.abs() ** 2).mean(dim=(-1, -2))
    # pair j covers allocation subcarriers {4j, 4j+2} (+sc_offset):
    # interpolate from the centres 4j+1 onto every allocation subcarrier
    npair = p.shape[-1]
    sc = 4 * np.arange(npair) + 1 + sc_offset
    h_alloc = _interp_freq(p, sc, 4 * npair)
    return CombChannelEstimate(h_alloc=h_alloc, noise_var=noise_var,
                               epre=epre, rsrp=rsrp)


def estimate_port(rx_pilots: torch.Tensor, tx_pilots: torch.Tensor,
                  sc_idx: np.ndarray, nsc: int, nsym: int) -> ChannelEstimate:
    """LS + average + linear-interpolation estimate over the whole grid.

    rx_pilots: [..., ndmrs_sym, npilot]; tx_pilots broadcastable to it;
    sc_idx: the pilot subcarriers (a regular comb).  Returns h [..., nsym,
    nsc], constant in time (average across the DM-RS symbols).
    """
    lse = rx_pilots * torch.conj(tx_pilots) / (tx_pilots.abs() ** 2)
    ndmrs = lse.shape[-2]
    h_avg = lse.mean(dim=-2)                                 # [..., npilot]
    if ndmrs > 1:
        resid = lse - h_avg[..., None, :]
        noise_var = ((resid.abs() ** 2).mean(dim=(-1, -2))
                     * ndmrs / (ndmrs - 1))
    else:
        diff = lse[..., 0, 1:] - lse[..., 0, :-1]
        noise_var = 0.5 * (diff.abs() ** 2).mean(dim=-1)
    epre = (rx_pilots.abs() ** 2).mean(dim=(-1, -2))
    rsrp = (h_avg.abs() ** 2).mean(dim=-1)
    h_full = _interp_freq(h_avg, sc_idx, nsc)
    h = h_full[..., None, :].expand(*h_full.shape[:-1], nsym, nsc)
    return ChannelEstimate(h=h, noise_var=noise_var, epre=epre, rsrp=rsrp)


def _interp_freq(h_pilot: torch.Tensor, sc_idx: np.ndarray,
                 nsc: int) -> torch.Tensor:
    """Linear interpolation + edge extrapolation onto [0, nsc) from a
    regular pilot comb (every DM-RS pattern in use): per-phase weighted
    sums of two shifted pilot views, interleaved by a stack and a
    reshape."""
    sc = np.asarray(sc_idx, dtype=np.int64)
    steps = np.diff(sc)
    if len(sc) < 2 or np.any(steps != steps[0]):
        raise ValueError("frequency interpolation needs a regular pilot comb")
    return _interp_freq_regular(h_pilot, int(sc[0]), int(steps[0]), nsc)


@functools.lru_cache(maxsize=64)
def _edge_weights(first: int, step: int, ntail: int, device: torch.device):
    """Extrapolation weights of the head and tail subcarriers: one op per
    edge however wide it is (a PUCCH resource extrapolates over the whole
    carrier)."""
    return (torch.tensor([(t - first) / step for t in range(first)],
                         dtype=torch.float32, device=device),
            torch.tensor([t / step for t in range(ntail)],
                         dtype=torch.float32, device=device))


def _interp_freq_regular(h_pilot: torch.Tensor, first: int, step: int,
                         nsc: int) -> torch.Tensor:
    """Linear interpolation for pilots at subcarriers first + step·k."""
    npil = h_pilot.shape[-1]
    pl = h_pilot[..., :-1]
    pr = h_pilot[..., 1:]
    phases = []
    for r in range(step):
        w = np.float32(r / step)
        phases.append(float(np.float32(1.0) - w) * pl + float(w) * pr
                      if r else pl)
    # [..., npil-1, step] → [..., (npil-1)·step]: targets
    # [first, first + step·(npil-1))
    body = torch.stack(phases, dim=-1).reshape(*h_pilot.shape[:-1],
                                               (npil - 1) * step)
    p0, p1 = h_pilot[..., 0:1], h_pilot[..., 1:2]
    pm, pe = h_pilot[..., -2:-1], h_pilot[..., -1:]
    ntail = nsc - first - step * (npil - 1)
    w_head, w_tail = _edge_weights(first, step, ntail, h_pilot.device)
    return torch.cat([p0 + w_head * (p1 - p0), body, pe + w_tail * (pe - pm)],
                     dim=-1)
