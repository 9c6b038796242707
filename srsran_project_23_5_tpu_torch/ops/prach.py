"""PRACH preamble generation and detection (TS 38.211 §6.3.3).

Counterpart of ``srsran_project_23_5_tpu/ops/prach.py`` (unrestricted set
and restricted set A, short 139- and long 839-chip sequences):
frequency-domain Zadoff-Chu preambles are host constants; detection
correlates against the root sequence, takes a zero-padded ``torch.fft.ifft``
to a power-of-two size, and picks the peak of the power-delay profile in the
window of each cyclic shift (all windows are one gather).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .sequences import zadoff_chu


@functools.lru_cache(maxsize=256)
def root_sequence_freq(root: int, length: int) -> np.ndarray:
    """Frequency-domain ZC preamble y_u = DFT(x_u), unit average power."""
    x = zadoff_chu(root, length)
    return (np.fft.fft(x) / np.sqrt(length)).astype(np.complex64)


def num_shifts(length: int, n_cs: int) -> int:
    """Preambles per root in the unrestricted set (N_cs = 0 ⇒ one)."""
    return 1 if n_cs == 0 else length // n_cs


def generate(root: int, shift_idx: int, length: int, n_cs: int) -> np.ndarray:
    """Frequency-domain preamble of cyclic shift v (host constant): a time
    shift by C_v = v·N_cs is a phase ramp in frequency."""
    return generate_cv(root, shift_idx * n_cs, length)


@functools.lru_cache(maxsize=256)
def restricted_a_cv(length: int, n_cs: int, root: int) -> tuple[int, ...]:
    """Restricted set A cyclic shifts C_v (TS 38.211 §6.3.3.1): d_u is the
    cyclic distance a one-chip Doppler offset moves root u's correlation
    peak, and the shifts are grouped so that a preamble and its Doppler
    images never collide.  Empty where the root has no shifts at N_cs."""
    d = pow(root, -1, length)            # u·d ≡ 1 (mod L), folded < L/2
    d_u = d if 2 * d < length else length - d
    if n_cs <= d_u < length / 3:
        n_shift = d_u // n_cs
        d_start = 2 * d_u + n_shift * n_cs
        n_group = length // d_start
        n_shift_bar = max((length - 2 * d_u - n_group * d_start) // n_cs, 0)
    elif length / 3 <= d_u <= (length - n_cs) // 2:
        n_shift = (length - 2 * d_u) // n_cs
        d_start = length - 2 * d_u + n_shift * n_cs
        n_group = d_u // d_start
        n_shift_bar = min(max((d_u - n_group * d_start) // n_cs, 0),
                          n_shift)
    else:
        return ()
    w = n_shift * n_group + n_shift_bar
    return tuple(d_start * (v // n_shift) + (v % n_shift) * n_cs
                 for v in range(w))


def unrestricted_cv(length: int, n_cs: int) -> tuple[int, ...]:
    return tuple(v * n_cs for v in range(num_shifts(length, n_cs)))


def generate_cv(root: int, cv: int, length: int) -> np.ndarray:
    """Frequency-domain preamble of an explicit cyclic shift C_v."""
    y = root_sequence_freq(root, length)
    k = np.arange(length)
    return (y * np.exp(2j * np.pi * cv * k / length)).astype(np.complex64)


@functools.lru_cache(maxsize=64)
def _detect_tables(root: int, length: int, cvs: tuple[int, ...],
                   win_chips: int, dft_size: int, device: torch.device):
    """(root sequence, window gather [ncv, width] into the extended PDP,
    window width, samples per chip)."""
    scale = dft_size / length                     # samples per ZC chip
    # trailing guard: the interpolation sidelobes of a zero-delay peak in
    # window v+1 spill into the last ~2 chips of window v
    guard = int(np.ceil(2 * scale))
    width = min(int(round(win_chips * scale)), dft_size)
    if len(cvs) > 1:
        width = max(width - guard, 1)
    # the preamble x_u((n + C_v) mod L) puts the peak of shift v with delay
    # d chips at sample (d - C_v)·scale mod D
    begins = np.asarray([(dft_size - int(round(cv * scale))) % dft_size
                         for cv in cvs], np.int64)
    idx = begins[:, None] + np.arange(width, dtype=np.int64)[None, :]
    y = torch.from_numpy(root_sequence_freq(root, length)).to(device)
    return y, torch.from_numpy(idx).to(device), width, scale


def detect_cv(rx_freq: torch.Tensor, root: int, length: int,
              cvs: tuple[int, ...], win_chips: int, dft_size: int = 2048):
    """Detector over an explicit cyclic-shift list: rx_freq [..., length]
    → (metric [..., ncv], delay in chips [..., ncv], rssi [...])."""
    y, idx, width, scale = _detect_tables(root, length, tuple(cvs), win_chips,
                                          dft_size, rx_freq.device)
    corr = rx_freq * torch.conj(y)
    pad = corr.new_zeros((*rx_freq.shape[:-1], dft_size - length))
    td = torch.fft.ifft(torch.cat([corr, pad], dim=-1), dim=-1)
    pdp = td.abs() ** 2                            # [..., dft_size]
    noise = pdp.mean(dim=-1, keepdim=True)
    ext = torch.cat([pdp, pdp[..., :width]], dim=-1)
    win = ext[..., idx]                            # [..., ncv, width]
    peak = win.amax(dim=-1)
    arg = torch.argmax(win, dim=-1)                # first maximum
    rssi = (rx_freq.abs() ** 2).mean(dim=-1)
    return peak / (noise + 1e-12), arg.to(torch.float32) / scale, rssi


def detect(rx_freq: torch.Tensor, root: int, length: int, n_cs: int,
           dft_size: int = 2048, restricted_set: str = "unrestricted"):
    """Detect preambles in received frequency-domain PRACH windows
    [..., length] → (metric [..., n_shifts], delay [..., n_shifts] in
    ZC-chip units, rssi [...]).  restricted_set: "unrestricted" or
    "type_a"."""
    if restricted_set == "type_a":
        cvs = restricted_a_cv(length, n_cs, root)
        if not cvs:
            raise ValueError(
                f"no restricted-A shifts for root {root}, N_cs {n_cs}")
    elif restricted_set == "unrestricted":
        cvs = unrestricted_cv(length, n_cs)
    else:
        raise ValueError(f"unknown PRACH restricted set {restricted_set!r}")
    win = n_cs if n_cs else length
    return detect_cv(rx_freq, root, length, cvs, win, dft_size)
