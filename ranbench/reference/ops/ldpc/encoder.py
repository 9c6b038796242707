"""Batched QC-LDPC encoder (TS 38.212 §5.3.2) — plain PyTorch version.

Copied from the port's
``srsran_project_23_5_tpu_torch/ops/ldpc/encoder.py``, unchanged.

The port's translation of ``srsran_project_23_5_tpu/ops/ldpc/encoder.py``
and the plain reference of the CUDA encoder kernel (``encoder_cuda.py``).
The batch of codeblocks is the parallel axis; the encode is a static
sequence of cyclic rolls and XORs over [batch, Zc] blocks (P^s x = roll(x,
-s)):

1. lam_i = Σ_j P^{s_ij} m_j for the 4 core rows;
2. the XOR of the 4 core rows leaves P^s p0 = Λ → p0 = roll(Λ, s);
3. forward substitution along the double diagonal gives p1, p2, p3;
4. each extension row's parity is the XOR of its message and core terms.

``encode_np`` is an independent host reference for the tests: it solves
H·[msg; p] = 0 over GF(2) by Gaussian elimination on the dense lifted H.
"""
from __future__ import annotations

import numpy as np
import torch

from .graphs import LiftedGraph, lifted_graph, parity_check_dense


def _pshift(x: torch.Tensor, s: int) -> torch.Tensor:
    """Apply circulant P^s to block x: (P^s x)_k = x_{(k+s) mod Z}."""
    return torch.roll(x, -s, dims=-1) if s else x


def _core_p0_shift(graph: LiftedGraph) -> int:
    """Effective single shift s with P^s p0 = XOR of the 4 core-row lams."""
    k = graph.nof_msg_blocks
    exps = [s for r in range(4)
            for c, s in zip(graph.row_cols[r], graph.row_shifts[r]) if c == k]
    # mod-2 cancellation of equal exponents
    residual = [e for e in set(exps) if exps.count(e) % 2 == 1]
    if len(residual) != 1:
        raise ValueError(f"unexpected core structure: {exps}")
    return residual[0]


def encode(msg_bits: torch.Tensor, base_graph: int,
           lifting_size: int) -> torch.Tensor:
    """[batch, K_b*Zc] int8 {0,1} (fillers zero) → full codeword
    [batch, N_full*Zc] int8; the transmit circular buffer is
    codeword[:, 2*Zc:]."""
    graph = lifted_graph(base_graph, lifting_size)
    k, m, z = graph.nof_msg_blocks, graph.nof_check_blocks, lifting_size
    b, klen = msg_bits.shape
    if klen != k * z:
        raise ValueError(f"message length {klen} != {k}*{z}")
    blocks = list(msg_bits.to(torch.int8).reshape(b, k, z).unbind(1))

    def row_lam(r: int, max_col: int) -> torch.Tensor:
        acc = None
        for c, s in zip(graph.row_cols[r], graph.row_shifts[r]):
            if c < max_col:
                term = _pshift(blocks[c], s)
                acc = term if acc is None else acc ^ term
        return acc

    lam = [row_lam(r, k) for r in range(4)]
    blocks.append(torch.roll(lam[0] ^ lam[1] ^ lam[2] ^ lam[3],
                             _core_p0_shift(graph), dims=-1))
    # forward substitution: row r holds parity columns k..k+r+1, the highest
    # is the new unknown; P^{s_new} p_new = acc → p_new = roll(acc, s_new)
    for r in range(3):
        new_col = k + 1 + r
        s_new = dict(zip(graph.row_cols[r], graph.row_shifts[r]))[new_col]
        blocks.append(torch.roll(row_lam(r, new_col), s_new, dims=-1))
    # extension rows: single identity parity at column k+r
    for r in range(4, m):
        blocks.append(row_lam(r, k + 4))
    return torch.stack(blocks, dim=1).reshape(b, graph.nof_var_blocks * z)


def encode_np(msg_bits: np.ndarray, base_graph: int,
              lifting_size: int) -> np.ndarray:
    """Host reference encode: [batch, K_b*Zc] {0,1} → full codeword
    [batch, N_full*Zc] uint8, by Gaussian elimination over GF(2) on the
    parity part of the dense lifted H (tests only)."""
    graph = lifted_graph(base_graph, lifting_size)
    h = parity_check_dense(graph)
    k = graph.nof_msg_blocks * lifting_size
    m = h.shape[1] - k
    hp = h[:, k:].astype(np.uint8).copy()
    rhs = (h[:, :k] @ msg_bits.T.astype(np.uint8)) % 2          # [m, batch]
    piv_cols = []
    row = 0
    for col in range(m):
        hits = np.flatnonzero(hp[row:, col])
        if hits.size == 0:
            continue
        piv = row + int(hits[0])
        hp[[row, piv]] = hp[[piv, row]]
        rhs[[row, piv]] = rhs[[piv, row]]
        others = np.flatnonzero(hp[:, col])
        others = others[others != row]
        hp[others] ^= hp[row]
        rhs[others] ^= rhs[row]
        piv_cols.append(col)
        row += 1
    if row != m:
        raise ValueError("the parity part of H is not full rank")
    p = np.zeros((m, msg_bits.shape[0]), dtype=np.uint8)
    p[piv_cols] = rhs[:len(piv_cols)]
    return np.concatenate([msg_bits.astype(np.uint8), p.T], axis=1)
