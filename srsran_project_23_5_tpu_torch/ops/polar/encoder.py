"""Polar encoder: x = u · G_N by butterfly XOR stages (TS 38.212 §5.3.1).

Counterpart of ``srsran_project_23_5_tpu/ops/polar/encoder.py``; every
function works on any leading dimensions.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _allocate_index(info_set: tuple[int, ...], n: int,
                    device: torch.device) -> torch.Tensor:
    """Gather map u[i] = ext[perm[i]], where ext[K] is the frozen zero."""
    perm = np.full(n, len(info_set), dtype=np.int64)
    perm[np.asarray(info_set, dtype=np.int64)] = np.arange(len(info_set))
    return torch.from_numpy(perm).to(device)


@functools.lru_cache(maxsize=64)
def _info_index(info_set: tuple[int, ...],
                device: torch.device) -> torch.Tensor:
    return torch.tensor(info_set, dtype=torch.int64, device=device)


def allocate(info_bits: torch.Tensor, info_set: tuple[int, ...],
             n: int) -> torch.Tensor:
    """Place [..., K] info bits into the u-domain vector [..., N] (frozen
    positions 0), as one gather."""
    zero = info_bits.new_zeros((*info_bits.shape[:-1], 1))
    ext = torch.cat([info_bits, zero], dim=-1)
    return ext[..., _allocate_index(info_set, n, info_bits.device)]


def encode(u: torch.Tensor) -> torch.Tensor:
    """[..., N] u-domain bits → [..., N] codeword (G_N = F^{⊗log2 N})."""
    n = u.shape[-1]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"polar code length {n} is not a power of two")
    lead = u.shape[:-1]
    x = u
    # stage s combines pairs at distance n >> (s+1): [x_l ^ x_r, x_r]
    for s in range(log_n):
        half = n >> (s + 1)
        shaped = x.reshape(*lead, 1 << s, 2, half)
        right = shaped[..., 1, :]
        x = torch.stack([shaped[..., 0, :] ^ right, right],
                        dim=-2).reshape(*lead, n)
    return x


def extract_message(u_hat: torch.Tensor,
                    info_set: tuple[int, ...]) -> torch.Tensor:
    """[..., N] decoded u-domain bits → [..., K] info bits."""
    return u_hat[..., _info_index(info_set, u_hat.device)]
