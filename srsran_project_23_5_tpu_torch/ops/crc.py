"""CRC calculators for the 3GPP generator polynomials (TS 38.212 §5.1).

Counterpart of ``srsran_project_23_5_tpu/ops/crc.py``: a CRC over GF(2) is a
linear map, so it is one product of the bits with a remainder matrix
``M[i] = x^(L-1-i+p) mod g(x)``, taken mod 2.  ``torch.matmul`` on CUDA takes
no integer types, so the product runs in float32 and is exact while the sum
(≤ L) stays below 2^24 — with TF32 off, which ``crc`` checks on the card.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# name: (degree, coefficients below the leading term)
POLYNOMIALS: dict[str, tuple[int, int]] = {
    "crc24A": (24, 0x864CFB),
    "crc24B": (24, 0x800063),
    "crc24C": (24, 0xB2B117),
    "crc16": (16, 0x1021),
    "crc11": (11, 0x621),
    "crc6": (6, 0x21),
}

_EXACT_F32_SUM = 1 << 24


@functools.lru_cache(maxsize=None)
def _powers(name: str, upto: int) -> tuple[int, ...]:
    """P[k] = x^k mod g(x) for k in [0, upto]."""
    degree, coeffs = POLYNOMIALS[name]
    top = 1 << degree
    table = [1]
    while len(table) <= upto:
        r = table[-1] << 1
        if r & top:
            r ^= top | coeffs
        table.append(r)
    return tuple(table)


@functools.lru_cache(maxsize=256)
def remainder_matrix(name: str, msg_len: int) -> np.ndarray:
    """[msg_len, degree] uint8 matrix M with crc = bits @ M (mod 2); bit j of
    the output is the coefficient of x^(degree-1-j) (CRC bits MSB-first)."""
    degree, _ = POLYNOMIALS[name]
    powers = np.asarray(_powers(name, msg_len - 1 + degree), dtype=np.int64)
    rows = powers[msg_len - 1 + degree - np.arange(msg_len)]
    shifts = degree - 1 - np.arange(degree)
    return ((rows[:, None] >> shifts[None, :]) & 1).astype(np.uint8)


@functools.lru_cache(maxsize=256)
def _remainder_matrix_on(name: str, msg_len: int,
                         device: torch.device) -> torch.Tensor:
    return torch.from_numpy(remainder_matrix(name, msg_len)).to(
        device=device, dtype=torch.float32)


def crc_np(bits: np.ndarray, name: str) -> np.ndarray:
    """Host CRC: [..., L] {0,1} → [..., degree] {0,1} int64 (MSB-first)."""
    m = remainder_matrix(name, bits.shape[-1])
    return (bits.astype(np.int64) @ m.astype(np.int64)) % 2


def crc(bits: torch.Tensor, name: str) -> torch.Tensor:
    """[..., L] int8 {0,1} → [..., degree] int8 CRC bits."""
    msg_len = bits.shape[-1]
    if msg_len >= _EXACT_F32_SUM:
        raise ValueError(f"CRC message of {msg_len} bits exceeds the exact "
                         "float32 range")
    if bits.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("GF(2) CRC product needs "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    m = _remainder_matrix_on(name, msg_len, bits.device)
    acc = torch.matmul(bits.to(torch.float32), m)
    return (acc.to(torch.int32) & 1).to(torch.int8)


def crc_attach(bits: torch.Tensor, name: str) -> torch.Tensor:
    """Append CRC bits: [..., L] → [..., L + degree]."""
    return torch.cat([bits, crc(bits, name)], dim=-1)


def crc_check(bits_with_crc: torch.Tensor, name: str) -> torch.Tensor:
    """[..., L+degree] → [...] bool, True when the CRC matches."""
    degree, _ = POLYNOMIALS[name]
    expected = crc(bits_with_crc[..., :-degree], name)
    return torch.all(expected == bits_with_crc[..., -degree:], dim=-1)
