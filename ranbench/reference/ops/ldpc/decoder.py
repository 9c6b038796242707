"""Layered normalised min-sum LDPC decoder, plain PyTorch: the semantics of

Copied from the plain decoder of the port's
``srsran_project_23_5_tpu_torch/ops/ldpc/decoder_cuda.py``.

the port's CUDA decoder kernel (app and c2v stored in bfloat16, computed in
float32; syndrome checked after each sweep; a codeblock that passes
freezes), with the sweeps each codeblock ran."""
from __future__ import annotations

import functools

import numpy as np
import torch

from .graphs import LiftedGraph, lifted_graph

SCALE = 0.8                 # min-sum normalisation


def _layers(graph: LiftedGraph, nof_used_blocks: int | None = None):
    """Static layer schedule truncated to the rate-matched graph: rows whose
    variables all lie below `nof_used_blocks`, with compacted c2v edge
    offsets (exact for rv=0 reads; see decoder_pallas._layers)."""
    out, e0 = [], 0
    for cols, shifts in zip(graph.row_cols, graph.row_shifts):
        if nof_used_blocks is None or max(cols) < nof_used_blocks:
            out.append((e0, tuple(cols), tuple(shifts)))
            e0 += len(cols)
    return out, e0


def used_blocks(base_graph: int, z: int, longest_cb_bits: int) -> int:
    """Variable blocks carrying transmitted LLRs for an rv=0 circular-buffer
    read of `longest_cb_bits` bits (+ the 2Zc punctured blocks)."""
    graph = lifted_graph(base_graph, z)
    n_core = graph.nof_msg_blocks + 4          # systematic + core parity
    n = 2 + -(-longest_cb_bits // z)
    return max(min(n, graph.nof_var_blocks), n_core)


@functools.lru_cache(maxsize=64)
def _schedule(base_graph: int, z: int, nof_used_blocks: int | None):
    graph = lifted_graph(base_graph, z)
    n = (graph.nof_var_blocks if nof_used_blocks is None
         else min(nof_used_blocks, graph.nof_var_blocks))
    layers, n_edges = _layers(graph, nof_used_blocks)
    return graph, n, layers, n_edges


def state_bytes(base_graph: int, z: int,
                nof_used_blocks: int | None = None) -> int:
    """Bytes of one codeblock's state in the kernel's shared memory: app in
    bf16 and 8 B of compressed c2v per (check row, lane)."""
    _, n, layers, _ = _schedule(base_graph, z, nof_used_blocks)
    return (8 * len(layers) + 2 * n) * z


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to bfloat16 (nearest even), kept in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _steps(nof_iterations: int, check_period: int) -> int:
    """Loop steps of the Pallas schedule: each runs `check_period` sweeps,
    then the syndrome check."""
    if check_period < 1:
        raise ValueError(f"check_period must be >= 1, got {check_period}")
    return -(-nof_iterations // check_period)


def _messages(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """One check row's new messages (float32, before the bf16 store) from
    t [batch, deg, z]; every row has degree >= 3."""
    a = t.abs()
    two = torch.topk(a, 2, dim=1, largest=False).values
    m1, m2 = two[:, 0:1], two[:, 1:2]
    neg = t < 0.0
    neg_prod = (neg.sum(dim=1, keepdim=True) % 2) == 1
    msg = torch.where(a == m1, m2, m1) * scale
    return torch.where(neg_prod != neg, -msg, msg)


@functools.lru_cache(maxsize=64)
def _layer_index(base_graph: int, z: int, nof_used_blocks: int | None,
                 device: torch.device):
    """Per layer: (e0, deg, flat app index [deg, z] of rot(app_c, s))."""
    _, _, layers, _ = _schedule(base_graph, z, nof_used_blocks)
    lane = np.arange(z)
    out = []
    for e0, cols, shifts in layers:
        idx = np.stack([c * z + (lane + s) % z for c, s in zip(cols, shifts)])
        out.append((e0, len(cols), torch.from_numpy(idx).to(device)))
    return out


def _decode_plain(llr, base_graph, lifting_size, nof_iterations,
                  check_period, nof_used_blocks):
    """decode_plain, plus the sweeps each codeblock ran [batch] int64."""
    z = lifting_size
    graph, n, _, n_edges = _schedule(base_graph, z, nof_used_blocks)
    k = graph.nof_msg_blocks
    b = llr.shape[0]
    dev = llr.device
    layers = _layer_index(base_graph, z, nof_used_blocks, dev)
    scale = torch.tensor(SCALE, dtype=torch.float32, device=dev)
    app = _bf16(llr[:, :n * z].to(torch.float32)).contiguous()   # [b, n*z]
    c2v = torch.zeros((b, n_edges, z), dtype=torch.float32, device=dev)

    def sweep(frozen: torch.Tensor) -> None:
        hold = frozen[:, None, None]
        for e0, deg, idx in layers:
            v = app[:, idx]                                      # [b, deg, z]
            old = c2v[:, e0:e0 + deg]
            t = v - old
            msg = _messages(t, scale)
            c2v[:, e0:e0 + deg] = torch.where(hold, old, _bf16(msg))
            app[:, idx] = torch.where(hold, v, _bf16(t + msg))

    def syndrome() -> torch.Tensor:
        ok = torch.ones(b, dtype=torch.bool, device=dev)
        for _, _, idx in layers:
            odd = ((app[:, idx] <= 0.0).sum(dim=1) % 2) == 1     # [b, z]
            ok &= ~odd.any(dim=1)
        return ok

    done = torch.zeros(b, dtype=torch.bool, device=dev)
    sweeps = torch.zeros(b, dtype=torch.int64, device=dev)
    for _ in range(_steps(nof_iterations, check_period)):
        if bool(done.all()):
            break
        for _ in range(check_period):
            sweep(done)
        sweeps += torch.where(done, 0, check_period)
        done = done | syndrome()
    bits = (app[:, :k * z] <= 0.0).to(torch.int8)
    return bits, done, sweeps


def decode_plain(llr: torch.Tensor, base_graph: int, lifting_size: int,
                 nof_iterations: int = 6, check_period: int = 1,
                 nof_used_blocks: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch decode with the Pallas kernel's semantics.

    llr: [batch, N_full*Zc] float; returns (bits [batch, K] int8,
    ok [batch] bool).
    """
    bits, ok, _ = _decode_plain(llr, base_graph, lifting_size, nof_iterations,
                                check_period, nof_used_blocks)
    return bits, ok


def sweeps_needed(llr: torch.Tensor, base_graph: int, lifting_size: int,
                  nof_iterations: int = 6, check_period: int = 1,
                  nof_used_blocks: int | None = None) -> torch.Tensor:
    """Sweeps each codeblock runs before its syndrome passes (or the
    iteration cap), counted by the plain version: [batch] int64."""
    return _decode_plain(llr, base_graph, lifting_size, nof_iterations,
                         check_period, nof_used_blocks)[2]
