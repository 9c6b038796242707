"""Zero-forcing equalisers with post-equalisation noise variance.

Counterpart of ``srsran_project_23_5_tpu/ops/equalizer.py``: SIMO
zero-forcing (MRC) and MMSE, 2×2 zero-forcing by explicit inverse, N×2 and
N×4 zero-forcing.  A noise variance given as a Python number becomes a
device-side fill, never a host-to-device copy.
"""
from __future__ import annotations

import torch


def _noise_var(noise_var, like: torch.Tensor) -> torch.Tensor:
    """noise_var as a float32 tensor on like's device, with a trailing RE
    axis."""
    if not isinstance(noise_var, torch.Tensor):
        noise_var = torch.full((), float(noise_var), dtype=torch.float32,
                               device=like.device)
    return noise_var[..., None]


def zf_1xn(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
           tx_scaling: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """SIMO zero-forcing (= MRC) equaliser.

    y, h: [..., nrx, n_re] complex; noise_var: [...] or broadcastable.
    Returns (x_hat [..., n_re], post_noise_var [..., n_re]).
    """
    num = (torch.conj(h) * y).sum(dim=-2)
    den = torch.clamp((h.abs() ** 2).sum(dim=-2), min=1e-12)
    nv = _noise_var(noise_var, y).expand(num.shape)
    return num / (den * tx_scaling), nv / (den * tx_scaling ** 2)


def mmse_1xn(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
             tx_scaling: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """SIMO MMSE equaliser (regularised by the noise variance), rescaled so
    that the estimate is conditionally unbiased.

    y, h: [..., nrx, n_re] complex; noise_var: [...] or broadcastable.
    Returns (x_hat [..., n_re], post_noise_var [..., n_re]).
    """
    nv = _noise_var(noise_var, y)
    num = (torch.conj(h) * y).sum(dim=-2)
    gain = (h.abs() ** 2).sum(dim=-2)
    den = gain + nv / (tx_scaling ** 2)
    x_hat = num / (den * tx_scaling)
    post_nv = nv / torch.clamp(gain * tx_scaling ** 2, min=1e-12)
    return x_hat / torch.clamp(gain / den, min=1e-6), post_nv


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
    nv = _noise_var(noise_var, y)
    return (torch.stack([x0, x1], dim=-2),
            torch.stack([nv * a11 / det, nv * a00 / det], dim=-2))


def zf_2x2(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """2×2 MIMO zero-forcing by the explicit inverse of H per RE.

    y: [..., 2, n_re]; h: [..., 2 rx, 2 tx, n_re]; noise_var broadcastable
    to [...].  Returns (x_hat [..., 2, n_re], post_noise_var [..., 2, n_re]).
    """
    h00, h01 = h[..., 0, 0, :], h[..., 0, 1, :]
    h10, h11 = h[..., 1, 0, :], h[..., 1, 1, :]
    det = h00 * h11 - h01 * h10
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    y0, y1 = y[..., 0, :], y[..., 1, :]
    x0 = (h11 * y0 - h01 * y1) / det
    x1 = (-h10 * y0 + h00 * y1) / det
    inv_det2 = 1.0 / det.abs() ** 2
    nv = _noise_var(noise_var, y)
    nv0 = nv * (h11.abs() ** 2 + h01.abs() ** 2) * inv_det2
    nv1 = nv * (h10.abs() ** 2 + h00.abs() ** 2) * inv_det2
    return torch.stack([x0, x1], dim=-2), torch.stack([nv0, nv1], dim=-2)


def zf_nx4(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """N×4 MIMO zero-forcing, N ≥ 4 rx ports: x̂ = (HᴴH)⁻¹Hᴴy per RE with the
    4×4 Hermitian Gram matrix G = [[A, B], [Bᴴ, C]] inverted blockwise
    through the Schur complement S = C − BᴴA⁻¹B, every step an elementwise
    complex multiply-add over the RE axis.

    y: [..., nrx, n_re]; h: [..., nrx, 4, n_re]; noise_var broadcastable
    to [...].  Returns (x_hat [..., 4, n_re], post_noise_var [..., 4, n_re]).
    """
    hs = [h[..., i, :] for i in range(4)]                 # [..., nrx, n_re]
    g = {(i, j): (torch.conj(hs[i]) * hs[j]).sum(dim=-2)
         for i in range(4) for j in range(i, 4)}
    b = [(torch.conj(hs[i]) * y).sum(dim=-2) for i in range(4)]
    g00, g11 = g[(0, 0)].real, g[(1, 1)].real
    g22, g33 = g[(2, 2)].real, g[(3, 3)].real
    g01, g23 = g[(0, 1)], g[(2, 3)]
    b00, b01v, b10, b11v = g[(0, 2)], g[(0, 3)], g[(1, 2)], g[(1, 3)]
    # A⁻¹ (2×2 Hermitian)
    det_a = torch.clamp(g00 * g11 - g01.abs() ** 2, min=1e-12)
    i00, i11 = g11 / det_a, g00 / det_a
    i01 = -g01 / det_a
    # T = A⁻¹B
    t00 = i00 * b00 + i01 * b10
    t01 = i00 * b01v + i01 * b11v
    t10 = torch.conj(i01) * b00 + i11 * b10
    t11 = torch.conj(i01) * b01v + i11 * b11v
    # S = C − BᴴT (Hermitian)
    s00 = g22 - (torch.conj(b00) * t00 + torch.conj(b10) * t10).real
    s11 = g33 - (torch.conj(b01v) * t01 + torch.conj(b11v) * t11).real
    s01 = g23 - (torch.conj(b00) * t01 + torch.conj(b10) * t11)
    det_s = torch.clamp(s00 * s11 - s01.abs() ** 2, min=1e-12)
    j00, j11 = s11 / det_s, s00 / det_s
    j01 = -s01 / det_s
    # u = A⁻¹b_a; v = b_b − Bᴴu; x_b = S⁻¹v; x_a = u − T x_b
    u0 = i00 * b[0] + i01 * b[1]
    u1 = torch.conj(i01) * b[0] + i11 * b[1]
    v0 = b[2] - (torch.conj(b00) * u0 + torch.conj(b10) * u1)
    v1 = b[3] - (torch.conj(b01v) * u0 + torch.conj(b11v) * u1)
    x2 = j00 * v0 + j01 * v1
    x3 = torch.conj(j01) * v0 + j11 * v1
    x0 = u0 - (t00 * x2 + t01 * x3)
    x1 = u1 - (t10 * x2 + t11 * x3)
    # post noise var σ²·diag(G⁻¹); top block A⁻¹ + T S⁻¹ Tᴴ
    d0 = i00 + (t00.abs() ** 2 * j00 + t01.abs() ** 2 * j11
                + 2.0 * (t00 * j01 * torch.conj(t01)).real)
    d1 = i11 + (t10.abs() ** 2 * j00 + t11.abs() ** 2 * j11
                + 2.0 * (t10 * j01 * torch.conj(t11)).real)
    nv = _noise_var(noise_var, y)
    return (torch.stack([x0, x1, x2, x3], dim=-2),
            torch.stack([nv * d0, nv * d1, nv * j00, nv * j11], dim=-2))
