"""Batched polar decoder: fast simplified successive cancellation (SSC).

Copied from the port's
``srsran_project_23_5_tpu_torch/ops/polar/decoder.py``, unchanged.

The port's translation of ``srsran_project_23_5_tpu/ops/polar/decoder.py``:
rate-0, rate-1 and repetition nodes, min-sum f and exact g in float32, over
any leading dimensions. The tree recursion depends only on the frozen mask,
so it unrolls on the host into a fixed sequence of a few hundred small
tensor ops per call; callers run it once per slot batch."""
from __future__ import annotations

import numpy as np
import torch

from . import encoder as polar_encoder
from .code import PolarCode


def _f(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Check node (min-sum): sign(a)·sign(b)·min(|a|, |b|)."""
    return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())


def _g(a: torch.Tensor, b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Variable node: b + (1-2u)·a given the left partial sum u."""
    return b + (1.0 - 2.0 * u.to(a.dtype)) * a


def _hard(llr: torch.Tensor) -> torch.Tensor:
    return (llr <= 0).to(torch.int8)  # positive LLR ⇒ bit 0


def decode(llr: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """SSC-decode [..., N] codeword LLRs → [..., N] u-domain bits int8."""
    mask = np.asarray(code.frozen_mask, dtype=bool)
    if llr.shape[-1] != code.n:
        raise ValueError(f"{llr.shape[-1]} LLRs for a code of N={code.n}")

    def rec(alpha: torch.Tensor, m: np.ndarray):
        """(beta x-domain bits, u-domain bits), both [..., size]."""
        size = alpha.shape[-1]
        if m.all():  # rate-0: all frozen, u = x = 0
            z = torch.zeros(alpha.shape, dtype=torch.int8, device=alpha.device)
            return z, z
        if not m.any():  # rate-1: hard decision; u = enc(x) (G_N involution)
            beta = _hard(alpha)
            return beta, polar_encoder.encode(beta)
        if size > 1 and m[:-1].all() and not m[-1]:  # repetition node
            u_last = _hard(alpha.sum(dim=-1, keepdim=True))
            beta = u_last.expand(alpha.shape)
            u = torch.cat([u_last.new_zeros((*alpha.shape[:-1], size - 1)),
                           u_last], dim=-1)
            return beta, u
        half = size // 2
        a, b = alpha[..., :half], alpha[..., half:]
        beta_l, u_l = rec(_f(a, b), m[:half])
        beta_r, u_r = rec(_g(a, b, beta_l), m[half:])
        beta = torch.cat([beta_l ^ beta_r, beta_r], dim=-1)
        return beta, torch.cat([u_l, u_r], dim=-1)

    _, u = rec(llr.to(torch.float32), mask)
    return u
