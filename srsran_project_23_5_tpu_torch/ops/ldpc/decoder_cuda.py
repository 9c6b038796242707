"""Layered normalised min-sum LDPC decoder: the plain PyTorch version, the
CUDA kernel ``csrc/ldpc_decoder.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``decoder_pallas._make_kernel`` /
``_decode_tiles`` / ``decode`` (srsran_project_23_5_tpu/ops/ldpc/
decoder_pallas.py) with its semantics, which both versions here copy exactly:

- app (a-posteriori LLRs) and c2v (check-to-variable messages) are stored
  in bfloat16 and computed in float32; the input LLRs round to bf16 first;
- per layer: t = rot(app_c, s) - c2v_e; min1/min2 of |t|, sign product by
  ``t < 0`` (so -0.0 counts as +1); msg = 0.8·sgnprod·sgn(t)·(m2 if
  |t| == m1 else m1); c2v_e ← msg, app_c ← rot⁻¹(t + msg);
- the syndrome (``v <= 0`` parity per check row) is first checked after
  ``check_period`` sweeps; a codeblock whose syndrome passes freezes, so its
  result does not depend on the other codeblocks of the batch;
- hard bits are ``app <= 0`` over the message columns;
- ``nof_used_blocks`` truncates the graph to the rate-matched span.

``decode`` takes ``decode_plain`` only for a CPU tensor; for a CUDA tensor it
launches the kernel (one CTA per codeblock, all codeblocks in one launch) or
raises.  Where app + c2v of a codeblock fit in shared memory the kernel keeps
both there; otherwise (the full BG1 graph at Z > 302, i.e. every rv > 0 or
HARQ-combined decode at Z = 320/352/384) it keeps app there and c2v in a
global scratch buffer.  ``decode.launches`` counts kernel launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils import kernels
from .graphs import LiftedGraph, lifted_graph

__all__ = ["decode", "decode_plain", "used_blocks", "state_bytes"]

SCALE = 0.8                 # min-sum normalisation
SMEM_LIMIT = 232_448        # dynamic shared memory a block may hold on sm_90


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
    """Bytes one codeblock's app + c2v take in the kernel (bf16); above
    SMEM_LIMIT the kernel moves c2v to device memory."""
    _, n, _, n_edges = _schedule(base_graph, z, nof_used_blocks)
    return 2 * (n + n_edges) * z


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to bfloat16 (nearest even), kept in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _steps(nof_iterations: int, check_period: int) -> int:
    """Loop steps of the Pallas schedule: each runs `check_period` sweeps,
    then the syndrome check."""
    if check_period < 1:
        raise ValueError(f"check_period must be >= 1, got {check_period}")
    return -(-nof_iterations // check_period)


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


def decode_plain(llr: torch.Tensor, base_graph: int, lifting_size: int,
                 nof_iterations: int = 6, check_period: int = 1,
                 nof_used_blocks: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch decode with the Pallas kernel's semantics.

    llr: [batch, N_full*Zc] float; returns (bits [batch, K] int8,
    ok [batch] bool).
    """
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
            a = t.abs()
            two = torch.topk(a, 2, dim=1, largest=False).values
            m1, m2 = two[:, 0:1], two[:, 1:2]      # every row has degree >= 3
            neg = t < 0.0
            neg_prod = (neg.sum(dim=1, keepdim=True) % 2) == 1
            msg = torch.where(a == m1, m2, m1) * scale
            msg = torch.where(neg_prod != neg, -msg, msg)
            c2v[:, e0:e0 + deg] = torch.where(hold, old, _bf16(msg))
            app[:, idx] = torch.where(hold, v, _bf16(t + msg))

    def syndrome() -> torch.Tensor:
        ok = torch.ones(b, dtype=torch.bool, device=dev)
        for _, _, idx in layers:
            odd = ((app[:, idx] <= 0.0).sum(dim=1) % 2) == 1     # [b, z]
            ok &= ~odd.any(dim=1)
        return ok

    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for _ in range(_steps(nof_iterations, check_period)):
        if bool(done.all()):
            break
        for _ in range(check_period):
            sweep(done)
        done = done | syndrome()
    bits = (app[:, :k * z] <= 0.0).to(torch.int8)
    return bits, done


@functools.lru_cache(maxsize=64)
def _graph_arrays(base_graph: int, z: int, nof_used_blocks: int | None,
                  device: torch.device):
    """Device copies of the compacted layer schedule for the kernel."""
    _, _, layers, _ = _schedule(base_graph, z, nof_used_blocks)
    layer_off = np.asarray([e0 for e0, _, _ in layers]
                           + [layers[-1][0] + len(layers[-1][1])])
    cols = np.concatenate([np.asarray(c) for _, c, _ in layers])
    shifts = np.concatenate([np.asarray(s) for _, _, s in layers])
    d_max = max(len(c) for _, c, _ in layers)
    tensors = tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                    for a in (layer_off, cols, shifts))
    return tensors, len(layers), d_max


def decode(llr: torch.Tensor, base_graph: int, lifting_size: int,
           nof_iterations: int = 6, check_period: int = 1,
           nof_used_blocks: int | None = None, _global_c2v: bool = False
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode a batch of codeblocks; same contract as
    decoder_pallas.decode: llr [batch, N_full*Zc] float32 →
    (bits [batch, K] int8, ok [batch] bool).  ``_global_c2v`` forces the
    global-c2v instance on a shape that fits in shared memory (tests)."""
    if llr.device.type == "cpu":
        return decode_plain(llr, base_graph, lifting_size, nof_iterations,
                            check_period, nof_used_blocks)
    if llr.device.type != "cuda":
        raise ValueError(f"no LDPC decoder for device {llr.device}")
    z = lifting_size
    graph, n, _, n_edges = _schedule(base_graph, z, nof_used_blocks)
    k = graph.nof_msg_blocks
    if (llr.dtype != torch.float32 or llr.dim() != 2
            or llr.shape[1] < n * z or llr.stride(1) != 1):
        raise ValueError(f"decoder takes float32 [batch, >= {n * z}] rows "
                         f"with unit stride, got {llr.dtype} "
                         f"{tuple(llr.shape)} strides {llr.stride()}")
    global_c2v = (_global_c2v
                  or state_bytes(base_graph, z, nof_used_blocks) > SMEM_LIMIT)
    steps = _steps(nof_iterations, check_period)
    batch = llr.shape[0]
    bits = torch.empty((batch, k * z), dtype=torch.int8, device=llr.device)
    ok = torch.empty((batch,), dtype=torch.bool, device=llr.device)
    if batch == 0:
        return bits, ok
    (layer_off, cols, shifts), nof_layers, d_max = _graph_arrays(
        base_graph, z, nof_used_blocks, llr.device)
    # c2v scratch of the global instance; the kernel clears it
    c2v = (torch.empty((batch, n_edges * z), dtype=torch.bfloat16,
                       device=llr.device) if global_c2v else None)
    stream = torch.cuda.current_stream(llr.device).cuda_stream
    err = kernels.library().lib.ldpc_decode(
        llr.data_ptr(), llr.stride(0), bits.data_ptr(), ok.data_ptr(), batch,
        layer_off.data_ptr(), cols.data_ptr(), shifts.data_ptr(), nof_layers,
        z, n, k, n_edges, d_max, steps, check_period, SCALE,
        c2v.data_ptr() if c2v is not None else None, stream)
    kernels.check(err, "ldpc_decode launch")
    decode.launches += 1
    return bits, ok


decode.launches = 0
