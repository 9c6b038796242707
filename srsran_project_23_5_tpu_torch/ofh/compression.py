"""O-RAN fronthaul IQ compression (block floating point, O-RAN WG4 CUS §A.1).

Counterpart of ``srsran_project_23_5_tpu/ofh/compression.py``.  Each PRB's
24 real values (I and Q of 12 subcarriers, interleaved) share a 4-bit
exponent; the mantissas are ``width``-bit signed integers packed MSB first,
so a PRB is 1 exponent byte and 3·width mantissa bytes (24·width is always a
multiple of 8).  Width 16 is the "none" scheme: native little-endian int16,
48 bytes per PRB, no exponent.

The slot functions (``compress_slot``/``decompress_slot``) pack or unpack a
whole [..., nof_prb, 12] grid with a few tensor operations on the grid's
device: no Python loop over PRBs or values.  ``compress_prbs`` and
``decompress_prbs`` keep the byte API of one message on top of them.

The exponent is ceil(log2(max(max|x|, 1) + 1)) − (width − 1), at least 0,
as in the JAX package, but computed exactly from the float's bits
(``torch.frexp``): a float32 ``log2`` is not exact next to powers of two, and
two libraries round it differently there.  Where the JAX package's
``jnp.ceil(jnp.log2(·))`` is one too small, its mantissas clip by one LSB;
this module gives the exact exponent (``tests/test_torch_fronthaul.py``
lists such PRBs).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

IQ_SCALE = 32767.0          # float grid → int16 full scale


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2**e as float32, exactly, for integer e in [-126, 127] (the float's
    exponent field set directly)."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


@functools.lru_cache(maxsize=8)
def _iq_scale_on(device: torch.device) -> torch.Tensor:
    """IQ_SCALE as a 0-dim tensor on `device`.  Dividing by it divides each
    value, correctly rounded, on every device; a CUDA tensor divided by a
    Python number is multiplied by its reciprocal instead, which can be
    one ulp off."""
    return torch.tensor(IQ_SCALE, dtype=torch.float32, device=device)


def _ceil_log2(y: torch.Tensor) -> torch.Tensor:
    """ceil(log2(y)) exactly for float32 y > 0: y = m·2^e with m in
    [0.5, 1), so the answer is e, or e − 1 where y is a power of two."""
    m, e = torch.frexp(y)
    return e - (m == 0.5).to(e.dtype)


def bfp_params(iq: torch.Tensor, width: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-PRB exponent and quantised mantissas.

    iq: [..., nof_prb, 24] float32 (interleaved I/Q scaled to ±1), on any
    device.  Returns (exponents [..., nof_prb] int32, mantissas
    [..., nof_prb, 24] int32 in [-2^(w-1), 2^(w-1)-1]).
    """
    scaled = iq.to(torch.float32) * IQ_SCALE
    max_abs = scaled.abs().amax(dim=-1)
    raw_bits = _ceil_log2(torch.clamp(max_abs, min=1.0) + 1.0)
    exp = torch.clamp(raw_bits - (width - 1), min=0).to(torch.int32)
    mant = torch.round(scaled * _pow2(-exp)[..., None]).to(torch.int32)
    lim = 2 ** (width - 1) - 1
    return exp, torch.clamp(mant, -lim - 1, lim)


def bfp_reconstruct(exp: torch.Tensor, mant: torch.Tensor) -> torch.Tensor:
    """Mantissas and exponent → float IQ in ±1."""
    return (mant.to(torch.float32) * _pow2(exp)[..., None]) / _iq_scale_on(
        mant.device)


def compressed_prb_size(width: int) -> int:
    if width == 16:
        return 48
    return 1 + (24 * width + 7) // 8


def _interleave(iq: torch.Tensor) -> torch.Tensor:
    """[..., 12] complex → [..., 24] float32, I and Q interleaved."""
    return torch.view_as_real(iq.to(torch.complex64)).reshape(
        *iq.shape[:-1], 24)


def _deinterleave(flat: torch.Tensor) -> torch.Tensor:
    """[..., 24] float32 → [..., 12] complex64."""
    return torch.complex(flat[..., 0::2], flat[..., 1::2])


@functools.lru_cache(maxsize=32)
def _msb_first(width: int, device: torch.device) -> torch.Tensor:
    """The shifts width-1, ..., 0 on `device` (made once per device)."""
    return torch.arange(width - 1, -1, -1, dtype=torch.int32, device=device)


def _pack_mantissas(mant: torch.Tensor, width: int) -> torch.Tensor:
    """[..., 24] signed ints → [..., 3·width] uint8: each value's low
    ``width`` bits, MSB first, one after another (mask, shift, then OR the
    bits of each byte together)."""
    dev = mant.device
    u = mant.to(torch.int32) & ((1 << width) - 1)
    bits = (u[..., None] >> _msb_first(width, dev)) & 1      # [..., 24, w]
    bits = bits.reshape(*mant.shape[:-1], 3 * width, 8)
    return (bits << _msb_first(8, dev)).sum(dim=-1).to(torch.uint8)


def _unpack_mantissas(data: torch.Tensor, width: int) -> torch.Tensor:
    """[..., 3·width] uint8 → [..., 24] int32, sign-extended."""
    dev = data.device
    bits = (data.to(torch.int32)[..., None] >> _msb_first(8, dev)) & 1
    bits = bits.reshape(*data.shape[:-1], 24, width)
    v = (bits << _msb_first(width, dev)).sum(dim=-1).to(torch.int32)
    return v - ((v >> (width - 1)) & 1) * (1 << width)


def compress_slot(iq: torch.Tensor, width: int = 9) -> torch.Tensor:
    """[..., nof_prb, 12] complex → [..., nof_prb, compressed_prb_size]
    uint8 on iq's device: the wire bytes of every PRB."""
    flat = _interleave(iq)
    if width == 16:               # "none" compression
        vals = torch.round(flat * IQ_SCALE).to(torch.int32).to(torch.int16)
        return vals.view(torch.uint8)
    exp, mant = bfp_params(flat, width)
    return torch.cat([(exp & 0x0F).to(torch.uint8)[..., None],
                      _pack_mantissas(mant, width)], dim=-1)


def decompress_slot(data: torch.Tensor, width: int = 9) -> torch.Tensor:
    """[..., nof_prb, compressed_prb_size] uint8 → [..., nof_prb, 12]
    complex64 on data's device."""
    if width == 16:
        vals = data.contiguous().view(torch.int16).to(torch.float32)
        return _deinterleave(vals / _iq_scale_on(vals.device))
    exp = data[..., 0].to(torch.int32) & 0x0F
    mant = _unpack_mantissas(data[..., 1:], width)
    return _deinterleave(bfp_reconstruct(exp, mant))


def compress_prbs(iq, width: int = 9) -> bytes:
    """[nof_prb, 12] complex (numpy, or a tensor on any device) → O-RAN BFP
    bytes (per PRB: 1 exponent byte + 12*2*width bits of mantissas)."""
    wire = compress_slot(torch.as_tensor(iq), width)
    return wire.cpu().numpy().tobytes()


def decompress_prbs(data: bytes, nof_prb: int, width: int = 9
                    ) -> np.ndarray:
    """O-RAN BFP bytes → [nof_prb, 12] complex64 (numpy)."""
    size = compressed_prb_size(width)
    wire = np.frombuffer(data, np.uint8, count=nof_prb * size).copy()
    return decompress_slot(torch.from_numpy(wire.reshape(nof_prb, size)),
                           width).numpy()
