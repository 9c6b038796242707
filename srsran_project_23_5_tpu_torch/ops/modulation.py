"""Constellation mapping and max-log soft demapping (TS 38.211 §5.1).

Counterpart of ``srsran_project_23_5_tpu/ops/modulation.py`` for BPSK
and π/2-BPSK (mapping only), QPSK, 16QAM, 64QAM and 256QAM.  NR QAM is
Gray-labelled square QAM with independent I/Q axes, so each axis maps and
demaps as PAM; ``modulate_lut`` is the constellation-table mapper.  LLRs
follow ln(P(0)/P(1)) (positive ⇒ bit 0).

``pusch_llr`` is the PUSCH LLR stage (demap, layer demap, descramble,
clip) and the RMS EVM of each batch row in one CUDA kernel,
``csrc/pusch_llr.cu``; ``pusch_llr_plain`` and ``evm_plain`` are the same
stage in plain PyTorch, which the wrapper takes only for a CPU tensor.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ran.constants import LLR_MAX
from ..utils import graphs, kernels
from ..utils.tracing import tracer
from .precoding import layer_demap_llr

#: modulation scheme → bits per symbol
QM = {"BPSK": 1, "QPSK": 2, "QAM16": 4, "QAM64": 6, "QAM256": 8}
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
def constellation(qm: int) -> np.ndarray:
    """Complex table of size 2^qm indexed by the MSB-first packed bit
    label (qm = 1: BPSK, (1-2b)(1+j)/√2)."""
    if qm == 1:
        return np.array([1 + 1j, -1 - 1j], dtype=np.complex64) / np.sqrt(2)
    _check_qm(qm)
    points = np.empty(1 << qm, dtype=np.complex64)
    for label in range(1 << qm):
        bits = np.array([(label >> (qm - 1 - k)) & 1 for k in range(qm)])
        points[label] = (_pam_level(bits[0::2])
                         + 1j * _pam_level(bits[1::2])) / _NORM[qm]
    return points


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

    qm = 1 is BPSK, d = (1-2b)(1+j)/√2.  Otherwise the Gray-coded PAM
    amplitude is evaluated arithmetically per axis,
    level = s0·(2^(n-1) − s1·(2^(n-2) − …)) with s_k = 1−2b_k.
    """
    if qm != 1:
        _check_qm(qm)
    *lead, e = bits.shape
    if e % qm:
        raise ValueError(f"{e} bits do not fill {qm}-bit symbols")
    s = 1.0 - 2.0 * bits.reshape(*lead, e // qm, qm).to(torch.float32)
    if qm == 1:
        v = s[..., 0] / float(np.float32(np.sqrt(2.0)))
        return torch.complex(v, v)

    def axis(sb: torch.Tensor) -> torch.Tensor:
        nb = sb.shape[-1]
        lvl = sb[..., nb - 1]
        for k in range(nb - 2, -1, -1):
            lvl = sb[..., k] * (2.0 ** (nb - 1 - k) - lvl)
        return lvl

    norm = float(np.float32(_NORM[qm]))
    return torch.complex(axis(s[..., 0::2]) / norm, axis(s[..., 1::2]) / norm)


@functools.lru_cache(maxsize=None)
def _constellation_on(qm: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(constellation(qm).astype(np.complex64)).to(device)


def modulate_lut(bits: torch.Tensor, qm: int) -> torch.Tensor:
    """Table mapper: [..., E] {0,1} → [..., E/qm] complex64, one gather of
    the MSB-first bit label from ``constellation(qm)``."""
    *lead, e = bits.shape
    if e % qm:
        raise ValueError(f"{e} bits do not fill {qm}-bit symbols")
    weights = 1 << torch.arange(qm - 1, -1, -1, device=bits.device)
    labels = (bits.reshape(*lead, e // qm, qm).to(torch.int64)
              * weights).sum(dim=-1)
    return _constellation_on(qm, bits.device)[labels]


def modulate_pi2_bpsk(bits: torch.Tensor) -> torch.Tensor:
    """π/2-BPSK (TS 38.211 §5.1.1): [..., E] {0,1} → [..., E] complex64,
    the BPSK point rotated by j on odd symbol indices."""
    s = (1.0 - 2.0 * bits.to(torch.float32)) / float(np.sqrt(2.0))
    odd = torch.arange(bits.shape[-1], device=bits.device) % 2 == 1
    return torch.complex(torch.where(odd, -s, s), s)


def quantize_llr(llr: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Float LLRs → the saturating int8 domain (±LLR_MAX)."""
    return torch.clamp(torch.round(llr * scale), -LLR_MAX, LLR_MAX).to(
        torch.int8)


def hard_decision(llr: torch.Tensor) -> torch.Tensor:
    """Int8 or float LLRs → hard bits {0,1} int8 (llr <= 0 ⇒ 1)."""
    return (llr <= 0).to(torch.int8)


@functools.lru_cache(maxsize=None)
def _demap_tables(qm: int, device: torch.device):
    nb = qm // 2
    labels = np.arange(1 << nb)
    bit_of = np.stack([(labels >> (nb - 1 - k)) & 1 for k in range(nb)])
    return (torch.from_numpy(pam_levels(qm)).to(device),
            torch.from_numpy(bit_of == 1).to(device),
            torch.from_numpy(bit_of == 0).to(device))


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
    levels, is_one, is_zero = _demap_tables(qm, symbols.device)

    def axis_llr(y: torch.Tensor) -> torch.Tensor:
        d2 = (y[..., None] - levels) ** 2                      # [..., S, 2^nb]
        outs = []
        for k in range(nb):
            d2_1 = d2.masked_fill(is_zero[k], 1e30).amin(dim=-1)
            d2_0 = d2.masked_fill(is_one[k], 1e30).amin(dim=-1)
            outs.append(d2_1 - d2_0)
        return torch.stack(outs, dim=-1)                       # [..., S, nb]

    # bit order per symbol is [re0, im0, re1, im1, ...]
    llr = torch.stack([axis_llr(symbols.real), axis_llr(symbols.imag)],
                      dim=-1).reshape(*lead, symbols.shape[-1], qm)
    return (llr / noise_var[..., None]).reshape(*lead, -1)


def pusch_llr_plain(x_hat: torch.Tensor, post_nv: torch.Tensor,
                    sign: torch.Tensor, qm: int) -> torch.Tensor:
    """The PUSCH LLR stage in plain PyTorch: equalised symbols x_hat
    [B, S] (one layer) or [B, L, S] complex64 with their post-equalisation
    noise variance (same shape, float32) → the clipped, descrambled codeword
    LLRs [B, L·S·qm] (sign [L·S·qm] ±1)."""
    llr = demodulate_soft(x_hat, post_nv, qm)
    if x_hat.dim() == 3:
        llr = layer_demap_llr(llr, qm)
    return torch.clamp(llr * sign, -float(LLR_MAX), float(LLR_MAX))


def evm_plain(x_hat: torch.Tensor, qm: int) -> torch.Tensor:
    """RMS error-vector magnitude of [..., n] symbols against the nearest
    constellation point → [...] (the JAX package's ``sch.evm_calculate``;
    the nearest level per axis by ``argmin`` over ``pam_levels(qm)``, which
    at qm = 2 are its ±1/√2)."""
    levels = _demap_tables(qm, x_hat.device)[0]

    def nearest(axis_vals: torch.Tensor) -> torch.Tensor:
        return levels[(axis_vals[..., None] - levels).abs().argmin(dim=-1)]

    hard = torch.complex(nearest(x_hat.real), nearest(x_hat.imag))
    return ((x_hat - hard).abs() ** 2).mean(dim=-1).sqrt()


_QPSK_GAIN = float(np.float32(2.0 * np.sqrt(2.0)))


def _stage_shape(x_hat: torch.Tensor, post_nv: torch.Tensor,
                 sign: torch.Tensor, qm: int) -> tuple[int, int, int]:
    """(B, L, S) of the stage's inputs; raises where they do not fit."""
    _check_qm(qm)
    if x_hat.dim() not in (2, 3):
        raise ValueError(f"x_hat is [B, S] or [B, L, S], got "
                         f"{tuple(x_hat.shape)}")
    batch, nsym = x_hat.shape[0], x_hat.shape[-1]
    layers = x_hat.shape[1] if x_hat.dim() == 3 else 1
    if (post_nv.shape != x_hat.shape
            or sign.shape != (layers * nsym * qm,)):
        raise ValueError(f"noise {tuple(post_nv.shape)} and sign "
                         f"{tuple(sign.shape)} do not fit symbols "
                         f"{tuple(x_hat.shape)} at qm={qm}")
    return batch, layers, nsym


#: per device, the kernel's per-row tickets (``csrc/pusch_llr.cu``): made
#: zero once and zero again after every launch, so a captured graph may hold
#: them; a larger batch adds a larger buffer and keeps the old one
_TICKETS: dict[torch.device, list[torch.Tensor]] = {}


def _tickets(device: torch.device, batch: int) -> torch.Tensor:
    held = _TICKETS.setdefault(device, [])
    if not held or held[-1].numel() < batch:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("pusch_llr's first call at this batch size "
                               "on a device must not be inside a graph "
                               "capture: warm it up eagerly first")
        held.append(torch.zeros(max(batch, 1024), dtype=torch.int32,
                                device=device))
    return held[-1]


def _launch(x_hat: torch.Tensor, post_nv: torch.Tensor, sign: torch.Tensor,
            qm: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch over the batch → (LLRs, EVM)."""
    batch, layers, nsym = _stage_shape(x_hat, post_nv, sign, qm)
    if (x_hat.dtype != torch.complex64 or x_hat.is_conj()
            or post_nv.dtype != torch.float32 or sign.dtype != torch.float32):
        raise ValueError(f"pusch_llr takes complex64 symbols and float32 "
                         f"noise and sign, got {x_hat.dtype}, "
                         f"{post_nv.dtype}, {sign.dtype}")
    if post_nv.device != x_hat.device or sign.device != x_hat.device:
        raise ValueError(f"pusch_llr inputs on {x_hat.device}, "
                         f"{post_nv.device}, {sign.device}")
    if not (x_hat.is_contiguous() and post_nv.is_contiguous()
            and sign.is_contiguous()) or sign.data_ptr() % 8:
        raise ValueError("pusch_llr takes contiguous inputs, the sign "
                         "8-byte aligned")
    dev = x_hat.device
    out = torch.empty((batch, layers * nsym * qm), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        # the plain mean over no REs
        return out, torch.full((batch,), float("nan"), device=dev)
    evm = torch.empty(batch, dtype=torch.float32, device=dev)
    lib = kernels.library().lib
    chunks = lib.pusch_llr_chunks(batch, layers, nsym)
    partial = torch.empty(batch * chunks, dtype=torch.float32, device=dev)
    ticket = _tickets(torch.device("cuda", x_hat.get_device()), batch)
    levels = pam_levels(qm)
    err = lib.pusch_llr(
        x_hat.data_ptr(), post_nv.data_ptr(), sign.data_ptr(),
        out.data_ptr(), evm.data_ptr(), partial.data_ptr(), ticket.data_ptr(),
        batch, layers, nsym, qm, levels.ctypes.data, _QPSK_GAIN,
        float(LLR_MAX), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "pusch_llr launch")
    return out, evm


def pusch_llr(x_hat: torch.Tensor, post_nv: torch.Tensor, sign: torch.Tensor,
              qm: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The PUSCH LLR stage and the EVM: (``pusch_llr_plain``, ``evm_plain``
    over each row's L·S symbols).  The CUDA kernel for a CUDA tensor: the
    LLRs bit-identical to the plain chain on the card, the EVM within the
    rounding of its sum's order; the plain chain for a CPU tensor.
    ``pusch_llr.launches`` counts kernel launches; the tracer counts
    ``pusch.llr_kernel``, or ``pusch.llr_plain``, per call."""
    if x_hat.device.type == "cpu":
        _stage_shape(x_hat, post_nv, sign, qm)
        tracer.add("pusch.llr_plain")
        return (pusch_llr_plain(x_hat, post_nv, sign, qm),
                evm_plain(x_hat.flatten(1), qm))
    if x_hat.device.type != "cuda":
        raise ValueError(f"no PUSCH LLR kernel for device {x_hat.device}")
    tracer.add("pusch.llr_kernel")
    out, evm = _launch(x_hat, post_nv, sign, qm)
    if out.numel():
        pusch_llr.launches += 1
    return out, evm


pusch_llr.launches = 0
graphs.KERNELS["pusch_llr"] = pusch_llr
