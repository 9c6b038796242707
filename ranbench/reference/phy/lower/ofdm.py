"""OFDM slot modulation and demodulation (TS 38.211 §5.3.1), in float64.

Written for the benchmark from the specification, not from the port's
code: each of the 14 symbols is an nfft-point inverse DFT of its subcarriers
(subcarrier sc at the centred frequency sc - nsc/2), scaled so that
s[n] = Σ_k a_k e^{j2πkn/N}, preceded by its cyclic prefix, one symbol after
another; the receiver drops each prefix and takes the DFT over 1/N.  The
cyclic prefix is N_CP,l = 144κ·2^-μ Tc, plus 16κ Tc for the symbols l = 0
and l = 7·2^μ of a subframe (κ = 64, Tc = 1/(480 kHz·4096)).  A slot at
the start of its subframe with no carrier offset is all the benchmark uses.
"""
from __future__ import annotations

import torch

from ...precision import q

NSYMB = 14
_KAPPA = 64
_TC_PER_S = 480_000 * 4096


def cp_samples(mu: int, nfft: int) -> list[int]:
    """The cyclic prefix of each symbol of slot 0 of a subframe, in samples
    at the rate 15 kHz·2^μ·nfft."""
    rate = 15_000 * (1 << mu) * nfft
    out = []
    for l in range(NSYMB):
        tc = 144 * _KAPPA // (1 << mu) + (16 * _KAPPA if l in (0, 7 << mu)
                                          else 0)
        n, rem = divmod(tc * rate, _TC_PER_S)
        if rem:
            raise ValueError(f"nfft {nfft} gives no whole-sample prefix")
        out.append(n)
    return out


def _bins(nsc: int, nfft: int) -> torch.Tensor:
    """The DFT bin of each subcarrier."""
    return (torch.arange(nsc) - nsc // 2) % nfft


def modulate_slot(grid: torch.Tensor, mu: int, nfft: int) -> torch.Tensor:
    """[..., 14, nsc] → [..., slot samples] complex64."""
    if grid.shape[-2] != NSYMB:
        raise ValueError(f"grid has {grid.shape[-2]} symbols, not 14")
    nsc = grid.shape[-1]
    spec = grid.new_zeros((*grid.shape[:-1], nfft), dtype=torch.complex128)
    spec[..., _bins(nsc, nfft).to(grid.device)] = grid.to(torch.complex128)
    body = torch.fft.ifft(spec, dim=-1) * nfft
    parts = []
    for l, cp in enumerate(cp_samples(mu, nfft)):
        parts += [body[..., l, nfft - cp:], body[..., l, :]]
    return q(torch.cat(parts, dim=-1).to(torch.complex64))


def demodulate_slot(samples: torch.Tensor, nsc: int, mu: int,
                    nfft: int) -> torch.Tensor:
    """[..., slot samples] → [..., 14, nsc] complex64."""
    x = samples.to(torch.complex128)
    symbols, at = [], 0
    for cp in cp_samples(mu, nfft):
        at += cp
        symbols.append(x[..., at:at + nfft])
        at += nfft
    if at != samples.shape[-1]:
        raise ValueError(f"{samples.shape[-1]} samples, a slot has {at}")
    spec = torch.fft.fft(torch.stack(symbols, dim=-2), dim=-1) / nfft
    return q(spec[..., _bins(nsc, nfft).to(samples.device)]
             .to(torch.complex64))
