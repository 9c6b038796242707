"""QC-LDPC encoder: the CUDA kernel ``csrc/ldpc_encoder.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``encoder_pallas._make_kernel`` /
``_encode_tiles`` / ``encode`` (srsran_project_23_5_tpu/ops/ldpc/
encoder_pallas.py).  The kernel holds the codeword bit-packed in shared
memory, each Z-bit block twice back to back so that a rotation is a funnel
shift (``pack_doubled`` / ``rotated_words`` spell out that layout for the
tests), and computes every extension row at once; the source note in the
``.cu`` file says what bounds it on the H100 and how the design answers
that.

``encode`` takes the plain PyTorch version (``encode_plain``, the port of
``encoder.encode``) only for a CPU tensor; for a CUDA tensor it launches the
kernel or raises.  ``encode.launches`` counts kernel launches.
"""
from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from ...utils import graphs, kernels
from .encoder import _core_p0_shift
from .encoder import encode as encode_plain
from .graphs import lifted_graph

__all__ = ["encode", "encode_plain", "pack_doubled", "rotated_words"]

THREADS = 512               # threads per CTA (kThreads in the kernel)


def doubled_words(z: int) -> int:
    """Words of one doubled block: 2Z bits and one word of slack."""
    return (2 * z + 31) // 32 + 1


def pack_doubled(bits: torch.Tensor) -> torch.Tensor:
    """The kernel's form of Z-bit blocks [..., Z] (0/1): int64 words
    [..., doubled_words(Z)] holding the block's bits from bit 0 and again
    from bit Z."""
    z = bits.shape[-1]
    pos = torch.arange(2 * z, device=bits.device)
    doubled = bits[..., pos % z].to(torch.int64)
    padded = torch.zeros((*bits.shape[:-1], 32 * doubled_words(z)),
                         dtype=torch.int64, device=bits.device)
    padded[..., :2 * z] = doubled
    weights = 1 << torch.arange(32, device=bits.device)
    return (padded.reshape(*bits.shape[:-1], -1, 32) * weights).sum(-1)


def rotated_words(doubled: torch.Tensor, s: int, z: int) -> torch.Tensor:
    """Words [..., ceil(Z/32)] of P^s x (lane j holds x[(j+s) mod Z]) from
    x's doubled block, as the kernel reads them: a funnel shift of two words
    at bit offset 32w + s, the last word masked to Z bits."""
    nw = -(-z // 32)
    pos = 32 * torch.arange(nw, device=doubled.device) + s
    lo, hi = doubled[..., pos >> 5], doubled[..., (pos >> 5) + 1]
    words = ((hi << 32 | lo) >> (pos & 31)) & 0xFFFFFFFF
    if z % 32:
        words[..., -1] &= (1 << (z % 32)) - 1
    return words


def _core_steps(graph, z: int):
    """The edges (col, shift) of each of the kernel's rows: the 4 core steps
    p0..p3 with their rolls folded into the shifts (roll(x, r) = P^(Z-r) x),
    then the extension rows over columns < k+4."""
    k = graph.nof_msg_blocks
    rows = [list(zip(c, s)) for c, s in zip(graph.row_cols,
                                            graph.row_shifts)]
    back = (z - _core_p0_shift(graph)) % z
    p0 = collections.Counter((c, (s + back) % z)
                             for row in rows[:4] for c, s in row if c < k)
    steps = [sorted(e for e, count in p0.items() if count % 2)]
    for r in range(3):
        back = (z - dict(rows[r])[k + 1 + r]) % z
        steps.append([(c, (s + back) % z) for c, s in rows[r]
                      if c < k + 1 + r])
    return steps + [[(c, s) for c, s in row if c < k + 4]
                    for row in rows[4:]]


@functools.lru_cache(maxsize=64)
def _graph_arrays(base_graph: int, z: int, device: torch.device):
    """Device copies of the kernel's row offsets and packed edges
    (col << 16 | shift)."""
    rows = _core_steps(lifted_graph(base_graph, z), z)
    row_off = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    edges = np.asarray([c << 16 | s for row in rows for c, s in row])
    return tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                 for a in (row_off, edges))


def per_cta(base_graph: int, z: int) -> int:
    """Codeblocks per CTA: enough that the extension rows fill the CTA's
    threads, at most 8."""
    graph = lifted_graph(base_graph, z)
    items = (graph.nof_check_blocks - 4) * -(-z // 32)
    return max(1, min(8, THREADS // items))


def _launch(msg_bits: torch.Tensor, base_graph: int, z: int
            ) -> torch.Tensor:
    """One kernel launch over the batch."""
    graph = lifted_graph(base_graph, z)
    k, n = graph.nof_msg_blocks, graph.nof_var_blocks
    if (msg_bits.dtype != torch.int8 or msg_bits.dim() != 2
            or msg_bits.shape[1] != k * z or not msg_bits.is_contiguous()):
        raise ValueError(f"encoder takes contiguous int8 [batch, {k * z}], "
                         f"got {msg_bits.dtype} {tuple(msg_bits.shape)}")
    batch = msg_bits.shape[0]
    out = torch.empty((batch, n * z), dtype=torch.int8, device=msg_bits.device)
    if batch == 0:
        return out
    row_off, edges = _graph_arrays(base_graph, z, msg_bits.device)
    vec = z % 16 == 0 and msg_bits.data_ptr() % 16 == 0
    err = kernels.library().lib.ldpc_encode(
        msg_bits.data_ptr(), out.data_ptr(), batch, int(vec),
        row_off.data_ptr(), edges.data_ptr(), edges.numel(), z, k,
        graph.nof_check_blocks, n, per_cta(base_graph, z),
        torch.cuda.current_stream(msg_bits.device).cuda_stream)
    kernels.check(err, "ldpc_encode launch")
    return out


def encode(msg_bits: torch.Tensor, base_graph: int,
           lifting_size: int) -> torch.Tensor:
    """[batch, K_b*Zc] int8 {0,1} → full codeword [batch, N_full*Zc] int8."""
    if msg_bits.device.type == "cpu":
        return encode_plain(msg_bits, base_graph, lifting_size)
    if msg_bits.device.type != "cuda":
        raise ValueError(f"no LDPC encoder for device {msg_bits.device}")
    out = _launch(msg_bits, base_graph, lifting_size)
    if msg_bits.shape[0]:
        encode.launches += 1
    return out


encode.launches = 0
graphs.KERNELS["encoder"] = encode
