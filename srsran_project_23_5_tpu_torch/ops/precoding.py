"""Layer mapping and precoding (TS 38.211 §7.3.1.3-4, §6.3.1.5).

Counterpart of ``srsran_project_23_5_tpu/ops/precoding.py``.  Layer mapping
is a reshape and a transpose; precoding is one complex product.
"""
from __future__ import annotations

import numpy as np
import torch


def layer_map(symbols: torch.Tensor, nof_layers: int) -> torch.Tensor:
    """Codeword symbols [..., M] → layers [..., L, M/L] with
    lay[l, i] = d[i·L + l] (TS 38.211 Table 7.3.1.3-1, one codeword)."""
    m = symbols.shape[-1]
    if m % nof_layers:
        raise ValueError(f"{m} symbols do not split into {nof_layers} layers")
    return symbols.reshape(*symbols.shape[:-1], m // nof_layers,
                           nof_layers).transpose(-1, -2)


def layer_demap_llr(llr_layers: torch.Tensor, qm: int) -> torch.Tensor:
    """Per-layer LLRs [..., L, M_l·qm] → codeword LLRs [..., L·M_l·qm]:
    codeword bit (L·i + l)·qm + q is layer bit (l, i·qm + q)."""
    *lead, v, mq = llr_layers.shape
    x = llr_layers.reshape(*lead, v, mq // qm, qm).transpose(-3, -2)
    return x.reshape(*lead, v * mq)


def apply_precoding(layers: torch.Tensor, w: np.ndarray) -> torch.Tensor:
    """[..., L, n_re] layers × w [P, L] → [..., P, n_re] ports."""
    w_t = torch.from_numpy(np.asarray(w, np.complex64)).to(layers.device)
    if layers.shape[-2] != w_t.shape[1]:
        raise ValueError(f"{layers.shape[-2]} layers for a precoder of "
                         f"{w_t.shape[1]}")
    return torch.matmul(w_t, layers)


def identity_precoder(nof_ports: int, nof_layers: int) -> np.ndarray:
    w = np.zeros((nof_ports, nof_layers), dtype=np.complex64)
    for l in range(nof_layers):
        w[l % nof_ports, l] = 1.0
    return w
