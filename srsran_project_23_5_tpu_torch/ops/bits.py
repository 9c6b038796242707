"""Bit packing and unpacking.

Counterpart of ``srsran_project_23_5_tpu/ops/bits.py``.  A bit string is an
int8 tensor with one bit per element, MSB-first with respect to the packed
byte form; the packed form is uint8, 8 bits per byte.  The tensor functions
work over any leading batch dimensions; the ``_np`` ones are their host
counterparts.
"""
from __future__ import annotations

import numpy as np
import torch


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 8n] {0,1} int8 → [..., n] uint8, MSB-first."""
    *lead, length = bits.shape
    if length % 8:
        raise ValueError(f"{length} bits do not fill whole bytes")
    weights = 1 << torch.arange(7, -1, -1, device=bits.device)
    grouped = bits.reshape(*lead, length // 8, 8).to(torch.int64)
    return (grouped * weights).sum(dim=-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """[..., n] uint8 → [..., 8n] {0,1} int8, MSB-first."""
    *lead, nbytes = packed.shape
    shifts = torch.arange(7, -1, -1, device=packed.device, dtype=torch.uint8)
    return ((packed[..., None] >> shifts) & 1).reshape(
        *lead, nbytes * 8).to(torch.int8)


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits.astype(np.uint8), axis=-1)


def unpack_bits_np(packed: np.ndarray) -> np.ndarray:
    return np.unpackbits(packed.astype(np.uint8), axis=-1).astype(np.int8)
