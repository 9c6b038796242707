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
raises.  The kernel keeps each check row's messages compressed, per lane:
bf16(0.8·m1) and bf16(0.8·m2) in one word, the message signs and the argmin
edge in another (``c2v_compress`` / ``c2v_expand`` spell out that layout
for the tests), so the state of every graph fits in shared memory.
``decode.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...utils import kernels
from .graphs import LiftedGraph, lifted_graph

__all__ = ["decode", "decode_plain", "used_blocks", "state_bytes",
           "c2v_compress", "c2v_expand"]

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


def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 bit patterns of float32 values (nearest even), as int64."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def c2v_compress(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's stored form of one check row's messages, from its t
    [batch, deg, z] float32: (mag, sgn) [batch, z] int64 words, mag =
    bf16(0.8·m1) | bf16(0.8·m2) << 16, sgn = message sign bits (bit e) |
    argmin edge << 27."""
    a = t.abs()
    two = torch.topk(a, 2, dim=1, largest=False).values
    scale = torch.tensor(SCALE, dtype=torch.float32, device=t.device)
    mag = _bf16_bits(two[:, 0] * scale) | _bf16_bits(two[:, 1] * scale) << 16
    neg = (t < 0.0).to(torch.int64)
    flip = neg.sum(dim=1) % 2
    weights = 1 << torch.arange(t.shape[1], device=t.device)[None, :, None]
    signs = ((neg ^ flip[:, None]) * weights).sum(dim=1)
    return mag, signs | torch.argmin(a, dim=1) << 27


def c2v_expand(mag: torch.Tensor, sgn: torch.Tensor, deg: int
               ) -> torch.Tensor:
    """The messages [batch, deg, z] float32 (bf16 values) that the kernel
    rebuilds from (mag, sgn): ±(e == argmin ? M2 : M1)."""
    e = torch.arange(deg, device=mag.device)[None, :, None]
    bits = torch.where(e == (sgn >> 27)[:, None], mag[:, None] >> 16,
                       mag[:, None] & 0xFFFF)
    bits = bits | ((sgn[:, None] >> e) & 1) << 15
    return (bits << 16).to(torch.int32).view(torch.float32)


@functools.lru_cache(maxsize=64)
def _graph_arrays(base_graph: int, z: int, nof_used_blocks: int | None,
                  device: torch.device):
    """Device copies of the compacted layer schedule for the kernel: layer
    offsets and one packed word per edge, col·z | shift << 16 | col << 25."""
    _, _, layers, _ = _schedule(base_graph, z, nof_used_blocks)
    layer_off = np.asarray([e0 for e0, _, _ in layers]
                           + [layers[-1][0] + len(layers[-1][1])], np.int32)
    cols = np.concatenate([c for _, c, _ in layers]).astype(np.int64)
    shifts = np.concatenate([s for _, _, s in layers]).astype(np.int64)
    sched = (cols * z | shifts << 16 | cols << 25).astype(np.uint32).view(
        np.int32)
    d_max = max(len(c) for _, c, _ in layers)
    tensors = tuple(torch.from_numpy(a).to(device) for a in (layer_off, sched))
    return tensors, len(layers), d_max


def _launch(llr, base_graph, z, nof_iterations, check_period,
            nof_used_blocks, diag=None):
    """One kernel launch: (bits, ok); the diagnostic instance when `diag`
    ([batch, 8] int64) is given."""
    graph, n, _, n_edges = _schedule(base_graph, z, nof_used_blocks)
    k = graph.nof_msg_blocks
    if (llr.dtype != torch.float32 or llr.dim() != 2
            or llr.shape[1] < n * z or llr.stride(1) != 1):
        raise ValueError(f"decoder takes float32 [batch, >= {n * z}] rows "
                         f"with unit stride, got {llr.dtype} "
                         f"{tuple(llr.shape)} strides {llr.stride()}")
    steps = _steps(nof_iterations, check_period)
    batch = llr.shape[0]
    bits = torch.empty((batch, k * z), dtype=torch.int8, device=llr.device)
    ok = torch.empty((batch,), dtype=torch.bool, device=llr.device)
    if batch == 0:
        return bits, ok
    (layer_off, sched), nof_layers, d_max = _graph_arrays(
        base_graph, z, nof_used_blocks, llr.device)
    vec = llr.data_ptr() % 16 == 0 and llr.stride(0) % 4 == 0
    err = kernels.library().lib.ldpc_decode(
        llr.data_ptr(), llr.stride(0), int(vec), bits.data_ptr(),
        ok.data_ptr(), batch, layer_off.data_ptr(), sched.data_ptr(),
        nof_layers, z, n, k, n_edges, d_max, steps, check_period, SCALE,
        None if diag is None else diag.data_ptr(),
        torch.cuda.current_stream(llr.device).cuda_stream)
    kernels.check(err, "ldpc_decode launch")
    return bits, ok


def decode(llr: torch.Tensor, base_graph: int, lifting_size: int,
           nof_iterations: int = 6, check_period: int = 1,
           nof_used_blocks: int | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode a batch of codeblocks; same contract as
    decoder_pallas.decode: llr [batch, N_full*Zc] float32 →
    (bits [batch, K] int8, ok [batch] bool)."""
    if llr.device.type == "cpu":
        return decode_plain(llr, base_graph, lifting_size, nof_iterations,
                            check_period, nof_used_blocks)
    if llr.device.type != "cuda":
        raise ValueError(f"no LDPC decoder for device {llr.device}")
    out = _launch(llr, base_graph, lifting_size, nof_iterations,
                  check_period, nof_used_blocks)
    if llr.shape[0]:
        decode.launches += 1
    return out


decode.launches = 0


def phase_split(llr: torch.Tensor, base_graph: int, lifting_size: int,
                nof_iterations: int = 6, check_period: int = 1,
                nof_used_blocks: int | None = None):
    """The kernel's diagnostic instance (measurement only; not counted in
    ``decode.launches``): (diag, bits, ok) with diag [batch, 8] int64 per
    CTA: SM cycles of LLR load + c2v clear, sweeps, syndrome checks, bit
    write and the whole CTA; the sweeps run; globaltimer ns at start and
    end."""
    if llr.device.type != "cuda":
        raise ValueError("the phase split needs the CUDA kernel")
    diag = torch.zeros((llr.shape[0], 8), dtype=torch.int64,
                       device=llr.device)
    bits, ok = _launch(llr, base_graph, lifting_size, nof_iterations,
                       check_period, nof_used_blocks, diag)
    return diag, bits, ok


def ctas_per_sm(base_graph: int, lifting_size: int,
                nof_used_blocks: int | None = None) -> int:
    """CTAs of the kernel that one SM holds at this shape (CUDA occupancy
    calculator; needs the card)."""
    _, n, layers, _ = _schedule(base_graph, lifting_size, nof_used_blocks)
    out = ctypes.c_int(0)
    kernels.check(kernels.library().lib.ldpc_decode_ctas_per_sm(
        lifting_size, len(layers), n, ctypes.byref(out)),
        "ldpc_decode occupancy")
    return out.value
