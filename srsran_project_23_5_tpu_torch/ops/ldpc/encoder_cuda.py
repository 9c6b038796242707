"""QC-LDPC encoder: the CUDA kernel ``csrc/ldpc_encoder.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``encoder_pallas._make_kernel`` /
``_encode_tiles`` / ``encode`` (srsran_project_23_5_tpu/ops/ldpc/
encoder_pallas.py).  One CTA encodes one codeblock with the codeword held in
shared memory and one thread per lane; the source note in the ``.cu`` file
says what bounds it on the H100 and how the design answers that.

``encode`` takes the plain PyTorch version (``encode_plain``, the port of
``encoder.encode``) only for a CPU tensor; for a CUDA tensor it launches the
kernel or raises.  ``encode.launches`` counts kernel launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils import kernels
from .encoder import _core_p0_shift
from .encoder import encode as encode_plain
from .graphs import lifted_graph

__all__ = ["encode", "encode_plain"]


@functools.lru_cache(maxsize=64)
def _graph_arrays(base_graph: int, z: int, device: torch.device):
    """Device copies of the row offsets, edge columns and edge shifts, plus
    the static scalars of the encode schedule."""
    graph = lifted_graph(base_graph, z)
    k = graph.nof_msg_blocks
    row_off = np.concatenate([[0], np.cumsum([len(c) for c in graph.row_cols])])
    cols = np.concatenate([np.asarray(c) for c in graph.row_cols])
    shifts = np.concatenate([np.asarray(s) for s in graph.row_shifts])
    s_new = tuple(dict(zip(graph.row_cols[r], graph.row_shifts[r]))[k + 1 + r]
                  for r in range(3))
    tensors = tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                    for a in (row_off, cols, shifts))
    return tensors, s_new, _core_p0_shift(graph)


def encode(msg_bits: torch.Tensor, base_graph: int,
           lifting_size: int) -> torch.Tensor:
    """[batch, K_b*Zc] int8 {0,1} → full codeword [batch, N_full*Zc] int8."""
    if msg_bits.device.type == "cpu":
        return encode_plain(msg_bits, base_graph, lifting_size)
    if msg_bits.device.type != "cuda":
        raise ValueError(f"no LDPC encoder for device {msg_bits.device}")
    graph = lifted_graph(base_graph, lifting_size)
    z, k, n = lifting_size, graph.nof_msg_blocks, graph.nof_var_blocks
    if (msg_bits.dtype != torch.int8 or msg_bits.dim() != 2
            or msg_bits.shape[1] != k * z or not msg_bits.is_contiguous()):
        raise ValueError(f"encoder takes contiguous int8 [batch, {k * z}], "
                         f"got {msg_bits.dtype} {tuple(msg_bits.shape)}")
    batch = msg_bits.shape[0]
    out = torch.empty((batch, n * z), dtype=torch.int8, device=msg_bits.device)
    if batch == 0:
        return out
    (row_off, cols, shifts), s_new, p0 = _graph_arrays(base_graph, z,
                                                       msg_bits.device)
    stream = torch.cuda.current_stream(msg_bits.device).cuda_stream
    err = kernels.library().lib.ldpc_encode(
        msg_bits.data_ptr(), out.data_ptr(), batch, row_off.data_ptr(),
        cols.data_ptr(), shifts.data_ptr(), z, k, graph.nof_check_blocks, n,
        p0, *s_new, stream)
    kernels.check(err, "ldpc_encode launch")
    encode.launches += 1
    return out


encode.launches = 0
