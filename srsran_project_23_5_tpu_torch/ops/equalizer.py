"""Zero-forcing equalisers with post-equalisation noise variance.

Counterpart of ``zf_1xn`` and ``zf_nx2`` in
``srsran_project_23_5_tpu/ops/equalizer.py``.
"""
from __future__ import annotations

import torch


def zf_1xn(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """SIMO zero-forcing (= MRC) equaliser.

    y, h: [..., nrx, n_re] complex; noise_var: [...] or broadcastable.
    Returns (x_hat [..., n_re], post_noise_var [..., n_re]).
    """
    num = (torch.conj(h) * y).sum(dim=-2)
    den = torch.clamp((h.abs() ** 2).sum(dim=-2), min=1e-12)
    x_hat = num / den
    nv = torch.as_tensor(noise_var, device=y.device)[..., None]
    post_nv = nv.expand(x_hat.shape) / den
    return x_hat, post_nv


def zf_nx2(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """N×2 MIMO zero-forcing by the 2×2 normal equations, N ≥ 2 rx ports:
    x̂ = (HᴴH)⁻¹Hᴴy per RE, post-equalisation noise σ²·diag((HᴴH)⁻¹).

    y: [..., nrx, n_re]; h: [..., nrx, 2, n_re]; noise_var broadcastable
    to [...].  Returns (x_hat [..., 2, n_re], post_noise_var [..., 2, n_re]).
    """
    h0 = h[..., 0, :]                                   # [..., nrx, n_re]
    h1 = h[..., 1, :]
    a00 = (h0.abs() ** 2).sum(dim=-2)
    a11 = (h1.abs() ** 2).sum(dim=-2)
    a01 = (torch.conj(h0) * h1).sum(dim=-2)
    b0 = (torch.conj(h0) * y).sum(dim=-2)
    b1 = (torch.conj(h1) * y).sum(dim=-2)
    det = torch.clamp(a00 * a11 - a01.abs() ** 2, min=1e-12)
    x0 = (a11 * b0 - a01 * b1) / det
    x1 = (a00 * b1 - torch.conj(a01) * b0) / det
    nv = torch.as_tensor(noise_var, device=y.device)[..., None]
    return (torch.stack([x0, x1], dim=-2),
            torch.stack([nv * a11 / det, nv * a00 / det], dim=-2))
