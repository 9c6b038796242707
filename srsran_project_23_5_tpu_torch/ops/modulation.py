"""Constellation mapping and max-log soft demapping (TS 38.211 §5.1).

Counterpart of ``srsran_project_23_5_tpu/ops/modulation.py`` for QPSK,
16QAM, 64QAM and 256QAM.  NR QAM is Gray-labelled square QAM with independent
I/Q axes, so each axis maps and demaps as PAM.  LLRs follow ln(P(0)/P(1))
(positive ⇒ bit 0).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_NORM = {2: np.sqrt(2.0), 4: np.sqrt(10.0), 6: np.sqrt(42.0),
         8: np.sqrt(170.0)}


def _check_qm(qm: int) -> None:
    if qm not in _NORM:
        raise ValueError(f"modulation order {qm} not in (2, 4, 6, 8)")


def _pam_level(bits: np.ndarray) -> float:
    """level = (1-2b0) * (2^(n-1) - (1-2b1)*(2^(n-2) - ... ))."""
    if len(bits) == 1:
        return 1.0 - 2.0 * bits[0]
    inner = _pam_level(bits[1:])
    return (1.0 - 2.0 * bits[0]) * (2 ** (len(bits) - 1) - inner)


@functools.lru_cache(maxsize=None)
def pam_levels(qm: int) -> np.ndarray:
    """Per-axis PAM level for each axis bit label (size 2^(qm/2))."""
    _check_qm(qm)
    nb = qm // 2
    levels = np.empty(1 << nb, dtype=np.float32)
    for label in range(1 << nb):
        bits = np.array([(label >> (nb - 1 - k)) & 1 for k in range(nb)])
        levels[label] = _pam_level(bits) / _NORM[qm]
    return levels


def modulate(bits: torch.Tensor, qm: int) -> torch.Tensor:
    """[..., E] {0,1} int8 → [..., E/qm] complex64 symbols.

    The Gray-coded PAM amplitude is evaluated arithmetically per axis,
    level = s0·(2^(n-1) − s1·(2^(n-2) − …)) with s_k = 1−2b_k.
    """
    _check_qm(qm)
    *lead, e = bits.shape
    if e % qm:
        raise ValueError(f"{e} bits do not fill {qm}-bit symbols")
    s = 1.0 - 2.0 * bits.reshape(*lead, e // qm, qm).to(torch.float32)

    def axis(sb: torch.Tensor) -> torch.Tensor:
        nb = sb.shape[-1]
        lvl = sb[..., nb - 1]
        for k in range(nb - 2, -1, -1):
            lvl = sb[..., k] * (2.0 ** (nb - 1 - k) - lvl)
        return lvl

    norm = float(np.float32(_NORM[qm]))
    return torch.complex(axis(s[..., 0::2]) / norm, axis(s[..., 1::2]) / norm)


@functools.lru_cache(maxsize=None)
def _demap_tables(qm: int, device: torch.device):
    nb = qm // 2
    labels = np.arange(1 << nb)
    bit_of = np.stack([(labels >> (nb - 1 - k)) & 1 for k in range(nb)])
    return (torch.from_numpy(pam_levels(qm)).to(device),
            torch.from_numpy(bit_of == 1).to(device))


def demodulate_soft(symbols: torch.Tensor, noise_var: torch.Tensor,
                    qm: int) -> torch.Tensor:
    """Max-log soft demap: [..., S] complex, [..., S] noise → [..., S*qm] f32.

    noise_var is the post-equalisation noise variance per RE.
    """
    _check_qm(qm)
    lead = symbols.shape[:-1]
    if qm == 2:
        # QPSK closed form: llr = 2*sqrt(2)*y_axis / sigma^2
        gain = float(np.float32(2.0 * np.sqrt(2.0)))
        llr = torch.stack([gain * symbols.real / noise_var,
                           gain * symbols.imag / noise_var], dim=-1)
        return llr.reshape(*lead, -1)

    nb = qm // 2
    levels, is_one = _demap_tables(qm, symbols.device)
    big = torch.tensor(1e30, dtype=torch.float32, device=symbols.device)

    def axis_llr(y: torch.Tensor) -> torch.Tensor:
        d2 = (y[..., None] - levels) ** 2                      # [..., S, 2^nb]
        outs = []
        for k in range(nb):
            d2_1 = torch.where(is_one[k], d2, big).amin(dim=-1)
            d2_0 = torch.where(is_one[k], big, d2).amin(dim=-1)
            outs.append(d2_1 - d2_0)
        return torch.stack(outs, dim=-1)                       # [..., S, nb]

    # bit order per symbol is [re0, im0, re1, im1, ...]
    llr = torch.stack([axis_llr(symbols.real), axis_llr(symbols.imag)],
                      dim=-1).reshape(*lead, symbols.shape[-1], qm)
    return (llr / noise_var[..., None]).reshape(*lead, -1)
