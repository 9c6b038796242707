"""Layer mapping and precoding (TS 38.211 §7.3.1.3-4, §6.3.1.5).

Counterpart of ``srsran_project_23_5_tpu/ops/precoding.py``.  Layer mapping
is a reshape and a transpose; precoding is one complex product.
"""
from __future__ import annotations

import functools

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


def layer_demap(layers: torch.Tensor) -> torch.Tensor:
    """Inverse of ``layer_map``: layers [..., L, M/L] → symbols [..., M]."""
    *lead, v, mdiv = layers.shape
    return layers.transpose(-1, -2).reshape(*lead, v * mdiv)


def layer_demap_llr(llr_layers: torch.Tensor, qm: int) -> torch.Tensor:
    """Per-layer LLRs [..., L, M_l·qm] → codeword LLRs [..., L·M_l·qm]:
    codeword bit (L·i + l)·qm + q is layer bit (l, i·qm + q)."""
    *lead, v, mq = llr_layers.shape
    x = llr_layers.reshape(*lead, v, mq // qm, qm).transpose(-3, -2)
    return x.reshape(*lead, v * mq)


@functools.lru_cache(maxsize=64)
def _precoder_on(data: bytes, shape: tuple[int, int],
                 device: torch.device) -> torch.Tensor:
    """A precoding matrix (complex64 bytes) on `device`, copied once."""
    return torch.from_numpy(np.frombuffer(data, np.complex64).reshape(
        shape).copy()).to(device)


def apply_precoding(layers: torch.Tensor, w: np.ndarray) -> torch.Tensor:
    """[..., L, n_re] layers × w [P, L] → [..., P, n_re] ports."""
    w = np.ascontiguousarray(w, np.complex64)
    w_t = _precoder_on(w.tobytes(), w.shape, layers.device)
    if layers.shape[-2] != w_t.shape[1]:
        raise ValueError(f"{layers.shape[-2]} layers for a precoder of "
                         f"{w_t.shape[1]}")
    return torch.matmul(w_t, layers)


def identity_precoder(nof_ports: int, nof_layers: int) -> np.ndarray:
    w = np.zeros((nof_ports, nof_layers), dtype=np.complex64)
    for l in range(nof_layers):
        w[l % nof_ports, l] = 1.0
    return w


def one_layer_codebook(nof_ports: int, pmi: int) -> np.ndarray:
    """Single-layer type-I codebook column [P, 1] (TS 38.214 Table
    5.2.2.2.1-5 for two ports; a DFT beam for more)."""
    if nof_ports == 1:
        return np.ones((1, 1), dtype=np.complex64)
    if nof_ports == 2:
        phase = [1, 1j, -1, -1j][pmi % 4]
        return (np.array([[1.0], [phase]], dtype=np.complex64)
                / np.sqrt(2.0))
    n = np.arange(nof_ports)
    return (np.exp(2j * np.pi * pmi * n / nof_ports)[:, None]
            / np.sqrt(nof_ports)).astype(np.complex64)
