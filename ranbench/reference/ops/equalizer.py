"""Zero-forcing equalisation with the post-equalisation noise variance, in
float64.

Written for the benchmark from the definition the JAX package's
``srsran_project_23_5_tpu/ops/equalizer.py`` implements, not from the
port's code: per resource element x̂ = (HᴴH)⁻¹Hᴴy and the noise variance of
layer l, σ²·[(HᴴH)⁻¹]_ll, by one batched complex128 inverse of the L×L Gram
matrix (``torch.linalg.inv``) for any number of layers.  With one layer
this is maximum-ratio combining.  The result is handed on in complex64 and
float32.
"""
from __future__ import annotations

import torch


def _noise(noise_var, like: torch.Tensor) -> torch.Tensor:
    nv = torch.as_tensor(noise_var, dtype=torch.float64, device=like.device)
    return nv[..., None, None]


def zf(y: torch.Tensor, h: torch.Tensor, noise_var
       ) -> tuple[torch.Tensor, torch.Tensor]:
    """y [..., nrx, n_re]; h [..., nrx, L, n_re]; noise_var broadcastable
    to [...].  Returns (x̂ [..., L, n_re] complex64, post-equalisation noise
    variance [..., L, n_re] float32)."""
    hh = h.to(torch.complex128).movedim(-1, -3)         # [..., n_re, nrx, L]
    yy = y.to(torch.complex128).movedim(-1, -2)[..., None]  # [.., n_re, nrx, 1]
    hh_h = hh.conj().transpose(-1, -2)                  # [..., n_re, L, nrx]
    g_inv = torch.linalg.inv(hh_h @ hh)                 # [..., n_re, L, L]
    x = (g_inv @ (hh_h @ yy))[..., 0]                   # [..., n_re, L]
    post = torch.diagonal(g_inv, dim1=-2, dim2=-1).real * _noise(noise_var, x)
    return (x.movedim(-1, -2).to(torch.complex64),
            post.movedim(-1, -2).to(torch.float32))


def zf_1xn(y: torch.Tensor, h: torch.Tensor, noise_var
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer over nrx ports: y, h [..., nrx, n_re] → (x̂ [..., n_re],
    post noise variance [..., n_re])."""
    x, nv = zf(y, h[..., None, :], noise_var)
    return x[..., 0, :], nv[..., 0, :]


def zf_nx2(y: torch.Tensor, h: torch.Tensor, noise_var
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two layers: h [..., nrx, 2, n_re]."""
    return zf(y, h, noise_var)


def zf_nx4(y: torch.Tensor, h: torch.Tensor, noise_var
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Four layers: h [..., nrx, 4, n_re]."""
    return zf(y, h, noise_var)
