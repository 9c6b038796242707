"""Short-block coding for UCI ≤ 11 bits (TS 38.212 §5.3.3, §5.4.3).

Copied from the port's ``srsran_project_23_5_tpu_torch/ops/short_block.py``,
unchanged.

The port's translation of ``srsran_project_23_5_tpu/ops/short_block.py``.
Encoder: the (32, K) Reed-Muller-like basis (Table 5.3.3.3-1) as a GF(2)
product; 1- and 2-bit special cases per §5.3.3.1-2. Detector: maximum-
likelihood correlation of the folded soft bits against all 2^K codewords,
one [..., 32] × [32, 2^K] product."""
from __future__ import annotations

import functools

import numpy as np
import torch

from .ldpc.graphs import _tables


@functools.lru_cache(maxsize=1)
def basis() -> np.ndarray:
    """(11, 32) basis sequences M_{i,n} transposed view (Table 5.3.3.3-1)."""
    return _tables()["short_block_basis"].astype(np.int8)


@functools.lru_cache(maxsize=16)
def codebook(k: int) -> np.ndarray:
    """All 2^k codewords in ±1 form: [2^k, 32] (bit 0 → +1)."""
    b = basis()[:k]                           # [k, 32]
    msgs = ((np.arange(1 << k)[:, None] >> np.arange(k)) & 1).astype(np.int8)
    cw = (msgs @ b) % 2                       # [2^k, 32]
    return (1 - 2 * cw).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _on(k: int, device: torch.device):
    """(basis [k, 32] int8, codebook transposed [32, 2^k]) on `device`."""
    return (torch.from_numpy(basis()[:k].copy()).to(device),
            torch.from_numpy(codebook(k).T.copy()).to(device))


def encode(bits: torch.Tensor, e: int, qm: int = 2) -> torch.Tensor:
    """[..., K] {0,1} int8 → [..., E] encoded and rate-matched bits.

    K in [3, 11] uses the basis; K in {1, 2} the §5.3.3.1-2 forms with the
    placeholder bits encoded as 1.
    """
    k = bits.shape[-1]
    bits = bits.to(torch.int8)
    if k == 1:
        b0 = bits[..., 0:1]
        one = torch.ones_like(b0)
        seq = torch.cat([b0] + [one] * (qm - 1), dim=-1) if qm > 1 else b0
    elif k == 2:
        b0, b1 = bits[..., 0:1], bits[..., 1:2]
        b2 = b0 ^ b1
        one = torch.ones_like(b0)
        if qm == 1:
            seq = torch.cat([b0, b1, b2], dim=-1)
        else:
            # [c0 c1 x c2 c0 x c1 c2 x] for Qm = 2 (§5.3.3.2)
            seq = torch.cat([b0, b1, one, b2, b0, one, b1, b2, one], dim=-1)
    else:
        m, _ = _on(k, bits.device)
        # GF(2) product as an elementwise AND + parity (no integer matmul)
        seq = ((bits[..., :, None] & m).sum(dim=-2) & 1).to(torch.int8)
    # rate matching §5.4.3: cyclic repetition to E bits
    reps = -(-e // seq.shape[-1])
    return torch.cat([seq] * reps, dim=-1)[..., :e]


def detect(llr: torch.Tensor, k: int, e: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """ML-detect K in [3, 11] bits from [..., E] soft bits (LLR > 0 ⇒ bit 0).

    Returns (bits [..., K] int8, metric [...]): the normalised correlation of
    the best codeword.
    """
    if not 3 <= k <= 11:
        raise ValueError(f"short-block detection takes 3..11 bits, got {k}")
    reps = -(-e // 32)
    pad = llr.new_zeros((*llr.shape[:-1], reps * 32 - e))
    folded = torch.cat([llr, pad], dim=-1).reshape(
        *llr.shape[:-1], reps, 32).sum(dim=-2)
    _, cb_t = _on(k, llr.device)
    scores = torch.matmul(folded, cb_t)                      # [..., 2^k]
    best = torch.argmax(scores, dim=-1)
    shifts = torch.arange(k, device=llr.device)
    bits = ((best[..., None] >> shifts) & 1).to(torch.int8)
    norm = torch.sqrt((folded ** 2).sum(dim=-1) * 32.0) + 1e-9
    metric = torch.gather(scores, -1, best[..., None])[..., 0] / norm
    return bits, metric
