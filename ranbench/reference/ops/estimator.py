"""Channel estimation from DM-RS pilots, in float64.

Written for the benchmark from the definitions of the JAX package's
``srsran_project_23_5_tpu/ops/estimator.py`` (after srsRAN's
``port_channel_estimator_average_impl``), not from the port's code: the
least-squares estimate y/x at each pilot, its mean over the DM-RS symbols,
the noise variance as the unbiased variance of the per-symbol estimates
around that mean (half the mean squared first difference along frequency
with one DM-RS symbol), the delay ramp from the phase of the lag-1 pilot
correlation, and linear interpolation with linear extrapolation at the edges
written as a gather of the two pilots around each subcarrier.  Inputs are
promoted to complex128; the estimate is handed on in complex64.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class CombChannelEstimate:
    """Estimate over a contiguous comb-2 allocation."""
    h_alloc: torch.Tensor     # [..., nsc_alloc] complex64
    noise_var: torch.Tensor   # [...]
    epre: torch.Tensor        # [...] average energy per pilot RE
    rsrp: torch.Tensor        # [...] |average channel|^2
    ta_norm: torch.Tensor | None = None   # [...] delay / nfft
    h_dmrs: torch.Tensor | None = None    # [..., ndmrs, nsc_alloc]


@dataclasses.dataclass
class ChannelEstimate:
    """Estimate over the full grid (``estimate_port``)."""
    h: torch.Tensor           # [..., nsym, nsc] complex64
    noise_var: torch.Tensor
    epre: torch.Tensor
    rsrp: torch.Tensor


def _c128(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.complex128)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.complex64 if x.is_complex() else torch.float32)


def interpolate(values: torch.Tensor, positions, targets) -> torch.Tensor:
    """Piecewise-linear interpolation along the last axis from values at
    the increasing `positions` onto `targets`, extended linearly beyond
    the first and the last pilot."""
    pos = np.asarray(positions, np.float64)
    tgt = np.asarray(targets, np.float64)
    left = np.clip(np.searchsorted(pos, tgt, side="right") - 1, 0,
                   len(pos) - 2)
    w = (tgt - pos[left]) / (pos[left + 1] - pos[left])
    dev = values.device
    left_t = torch.from_numpy(left).to(dev)
    w_t = torch.from_numpy(w).to(dev)
    return (values[..., left_t] * (1.0 - w_t)
            + values[..., left_t + 1] * w_t)


def _noise_from_symbols(lse: torch.Tensor, mean: torch.Tensor,
                        dims: tuple[int, ...]) -> torch.Tensor:
    """Unbiased variance of the per-symbol estimates around their mean,
    summed over `dims` (the DM-RS symbol axis is -2 of lse)."""
    ndmrs = lse.shape[-2]
    count = math.prod(lse.shape[d] for d in dims)
    ss = ((lse - mean.unsqueeze(-2)).abs() ** 2).sum(dim=dims)
    return ss * ndmrs / (count * (ndmrs - 1))


def estimate_comb2(rx_pilots: torch.Tensor, tx_pilots: torch.Tensor,
                   time_interp: bool = False) -> CombChannelEstimate:
    """Pilots at allocation subcarriers 2k (CDM group 0, one layer):
    rx_pilots [..., ndmrs, npil], tx_pilots broadcastable to it.  The
    delay ramp e^{jφ·sc/2} (φ the phase step between neighbouring pilots)
    is taken off before the interpolation and put back after it."""
    y, x = _c128(rx_pilots), _c128(tx_pilots)
    lse = y / x
    ndmrs, npil = lse.shape[-2], lse.shape[-1]
    p = lse.mean(dim=-2)
    if ndmrs > 1:
        noise_var = _noise_from_symbols(lse, p, (-1, -2))
    else:
        noise_var = 0.5 * ((lse[..., 0, 1:] - lse[..., 0, :-1]).abs() ** 2
                           ).mean(dim=-1)
    epre = (y.abs() ** 2).mean(dim=(-1, -2))
    rsrp = (p.abs() ** 2).mean(dim=-1)
    phi = torch.angle((p[..., 1:] * p[..., :-1].conj()).sum(dim=-1))
    pilot_sc = np.arange(npil) * 2
    all_sc = np.arange(2 * npil)
    dev = p.device

    def ramp(sc) -> torch.Tensor:
        s = torch.from_numpy(np.asarray(sc, np.float64)).to(dev)
        return torch.polar(torch.ones_like(phi[..., None] * s),
                           phi[..., None] * s / 2.0)

    at_pilots, at_all = ramp(pilot_sc), ramp(all_sc)
    h = interpolate(p * at_pilots.conj(), pilot_sc, all_sc) * at_all
    h_dmrs = None
    if time_interp:
        h_dmrs = _f32(interpolate(lse * at_pilots.conj()[..., None, :],
                                  pilot_sc, all_sc) * at_all[..., None, :])
    return CombChannelEstimate(
        h_alloc=_f32(h), noise_var=_f32(noise_var), epre=_f32(epre),
        rsrp=_f32(rsrp), ta_norm=_f32(-phi / (4.0 * math.pi)),
        h_dmrs=h_dmrs)


def estimate_comb2_occ2(rx_pilots: torch.Tensor, tx_pilots: torch.Tensor,
                        sc_offset: int = 0) -> CombChannelEstimate:
    """Two layers on one CDM group (DM-RS type 1, TS 38.211 Table
    6.4.1.1.3-1): the frequency OCC [+1, +1] / [+1, -1] over each pair of
    neighbouring pilots separates them.  rx_pilots [..., ndmrs, npil] on
    the comb sc_offset + 2k; tx_pilots the un-spread port-0 pilots.
    Returns h_alloc [..., 2, 2·npil]: each layer's channel, placed at the
    pair's centre sc_offset + 4j + 1 and interpolated onto the allocation;
    the noise variance is the despread residual's, doubled back to one RE."""
    y, x = _c128(rx_pilots), _c128(tx_pilots)
    lse = y / x
    pairs = lse.reshape(*lse.shape[:-1], lse.shape[-1] // 2, 2)
    occ = torch.tensor([[1.0, 1.0], [1.0, -1.0]], dtype=torch.complex128,
                       device=lse.device)
    h = torch.einsum("...sjc,lc->...lsj", pairs, occ) / 2.0  # [.., 2, s, np]
    p = h.mean(dim=-2)
    ndmrs = h.shape[-2]
    if ndmrs > 1:
        noise_var = 2.0 * _noise_from_symbols(h, p, (-1, -2, -3))
    else:
        noise_var = ((p[..., 1:] - p[..., :-1]).abs() ** 2).mean(dim=(-1, -2))
    epre = (y.abs() ** 2).mean(dim=(-1, -2))
    rsrp = (p.abs() ** 2).mean(dim=(-1, -2))
    npair = p.shape[-1]
    centres = 4 * np.arange(npair) + 1 + sc_offset
    h_alloc = interpolate(p, centres, np.arange(4 * npair))
    return CombChannelEstimate(h_alloc=_f32(h_alloc),
                               noise_var=_f32(noise_var), epre=_f32(epre),
                               rsrp=_f32(rsrp))


def estimate_port(rx_pilots: torch.Tensor, tx_pilots: torch.Tensor,
                  sc_idx: np.ndarray, nsc: int, nsym: int) -> ChannelEstimate:
    """Pilots at the subcarriers sc_idx of the grid: rx_pilots [..., ndmrs,
    npil].  Returns h [..., nsym, nsc], the same in every symbol."""
    y, x = _c128(rx_pilots), _c128(tx_pilots)
    lse = y / x
    ndmrs = lse.shape[-2]
    p = lse.mean(dim=-2)
    if ndmrs > 1:
        noise_var = _noise_from_symbols(lse, p, (-1, -2))
    else:
        noise_var = 0.5 * ((lse[..., 0, 1:] - lse[..., 0, :-1]).abs() ** 2
                           ).mean(dim=-1)
    epre = (y.abs() ** 2).mean(dim=(-1, -2))
    rsrp = (p.abs() ** 2).mean(dim=-1)
    h = interpolate(p, np.asarray(sc_idx), np.arange(nsc))
    h = _f32(h)[..., None, :].expand(*h.shape[:-1], nsym, nsc)
    return ChannelEstimate(h=h, noise_var=_f32(noise_var), epre=_f32(epre),
                           rsrp=_f32(rsrp))
