"""PRACH preamble generation and detection (TS 38.211 §6.3.3).

Copied from the port's ``srsran_project_23_5_tpu_torch/ops/prach.py``,
except ``detect_cv``, written for the benchmark in float64 from the
definitions of the JAX package's detector.

The port's translation of ``srsran_project_23_5_tpu/ops/prach.py``
(unrestricted set and restricted set A, short 139- and long 839-chip
sequences): frequency-domain Zadoff-Chu preambles are host constants;
detection correlates against the root sequence, takes a zero-padded
``torch.fft.ifft`` to a power-of-two size, and picks the peak of the power-
delay profile in the window of each cyclic shift (all windows are one
gather)."""
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


def detect_cv(rx_freq: torch.Tensor, root: int, length: int,
              cvs: tuple[int, ...], win_chips: int, dft_size: int = 2048):
    """Detector over an explicit cyclic-shift list, in float64: rx_freq
    [..., length] → (metric [..., ncv], delay in chips [..., ncv], rssi
    [...]).

    The power-delay profile is |IDFT_D(rx · conj(y_u))|², D = dft_size
    points with the length-L correlation zero-padded, so one ZC chip is
    D/L samples.  The preamble of shift C_v with a delay of d chips peaks
    at sample (d - C_v)·D/L mod D, so its window starts at D - C_v·D/L and
    runs for win_chips·D/L samples, less a trailing guard of 2 chips where
    several shifts share the root (the sidelobes of the next shift's
    zero-delay peak).  Metric: the window's peak over the profile's mean;
    delay: the first peak sample's offset in chips."""
    y = torch.from_numpy(_root_freq64(root, length)).to(rx_freq.device)
    x = rx_freq.to(torch.complex128)
    pdp = torch.fft.ifft(x * y.conj(), n=dft_size, dim=-1).abs() ** 2
    noise = pdp.mean(dim=-1)
    scale = dft_size / length
    width = min(int(round(win_chips * scale)), dft_size)
    if len(cvs) > 1:
        width = max(width - int(np.ceil(2 * scale)), 1)
    metric, delay = [], []
    for cv in cvs:
        begin = (dft_size - int(round(cv * scale))) % dft_size
        idx = torch.arange(begin, begin + width, device=x.device) % dft_size
        win = pdp[..., idx]
        peak, arg = win.max(dim=-1)
        metric.append(peak / (noise + 1e-12))
        delay.append(arg.to(torch.float64) / scale)
    rssi = (x.abs() ** 2).mean(dim=-1)
    return (torch.stack(metric, dim=-1).to(torch.float32),
            torch.stack(delay, dim=-1).to(torch.float32),
            rssi.to(torch.float32))


@functools.lru_cache(maxsize=256)
def _root_freq64(root: int, length: int) -> np.ndarray:
    """DFT of the ZC root sequence x_u(n) = e^{-jπun(n+1)/L}, unit average
    power, in complex128."""
    n = np.arange(length, dtype=np.float64)
    x = np.exp(-1j * np.pi * root * n * (n + 1) / length)
    return np.fft.fft(x) / np.sqrt(length)


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
