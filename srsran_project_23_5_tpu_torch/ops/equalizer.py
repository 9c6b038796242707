"""SIMO zero-forcing equaliser with post-equalisation noise variance.

Counterpart of ``zf_1xn`` in ``srsran_project_23_5_tpu/ops/equalizer.py``.
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
