"""PUCCH Format 1 (sequence detection) and Format 2 (UCI demodulation).

Copied from the port's ``srsran_project_23_5_tpu_torch/phy/upper/pucch.py``,
except ``pucch_f1_detect``, written for the benchmark in float64 from the
definitions of the JAX package's detector.

The port's translation of ``srsran_project_23_5_tpu/phy/upper/pucch.py``: F1
carries 1-2 HARQ-ACK bits on cyclic-shifted base sequences with the time-
domain OCC; F2 carries 3-11 UCI bits, short-block coded, scrambled and QPSK
modulated, with DM-RS on every third subcarrier. Sequences are host
constants; every slot of the batch is processed at once. The slot-dependent
sequences (F1 cyclic-shift hopping, F2 DM-RS c_init or its pilots) can be
passed in, so one config normalised to slot 0 serves every slot."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...ops import dmrs as dmrs_ops
from ...ops import (equalizer, estimator, gold, modulation, sequences,
                    short_block)
from ...ran.constants import NRE


@dataclasses.dataclass(frozen=True)
class PucchF1Config:
    prb: int                     # PRB index of the (single-PRB) resource
    start_symbol: int = 0
    nof_symbols: int = 14        # 4..14
    initial_cyclic_shift: int = 0
    occ_index: int = 0
    n_id: int = 0                # hopping id (group hopping disabled)
    slot_in_frame: int = 0
    nof_harq_bits: int = 1       # 1 or 2

    @property
    def data_symbols(self) -> tuple[int, ...]:
        return tuple(self.start_symbol + i
                     for i in range(1, self.nof_symbols, 2))

    @property
    def dmrs_symbols(self) -> tuple[int, ...]:
        return tuple(self.start_symbol + i
                     for i in range(0, self.nof_symbols, 2))


@functools.lru_cache(maxsize=256)
def _cs_hopping(n_id: int, slot: int) -> np.ndarray:
    """n_cs(l) per symbol of the slot (TS 38.211 §6.3.2.2.2)."""
    c = gold.gold_sequence_np(n_id, 8 * 14, offset=8 * 14 * slot)
    return (c.reshape(14, 8) << np.arange(8)).sum(axis=1) % 12


@functools.lru_cache(maxsize=64)
def _occ_w(length: int, idx: int) -> np.ndarray:
    """Time-domain OCC w_i (DFT basis, TS 38.211 Table 6.3.2.4.1-2)."""
    m = np.arange(length)
    return np.exp(2j * np.pi * idx * m / length).astype(np.complex64)


def _f1_symbol_seqs(cfg: PucchF1Config,
                    symbols: tuple[int, ...]) -> np.ndarray:
    """Base sequence × cyclic shift for each symbol: [nsym_used, 12]."""
    u = cfg.n_id % 30
    ncs = _cs_hopping(cfg.n_id, cfg.slot_in_frame)
    rows = []
    for l in symbols:
        alpha = 2 * np.pi * ((cfg.initial_cyclic_shift + ncs[l]) % 12) / 12
        rows.append(sequences.cyclic_shifted(u, 0, NRE, alpha))
    return np.asarray(rows, dtype=np.complex64)


def f1_slot_seqs(cfg: PucchF1Config) -> tuple[np.ndarray, np.ndarray]:
    """(data_seqs, dmrs_seqs) for the config's slot — the cyclic-shift
    hopping n_cs(l) is the only slot-dependent term (TS 38.211
    §6.3.2.2.2), so passing these to ``pucch_f1_transmit/detect`` lets one
    config serve every slot of the frame."""
    return (_f1_symbol_seqs(cfg, cfg.data_symbols),
            _f1_symbol_seqs(cfg, cfg.dmrs_symbols))


@functools.lru_cache(maxsize=16)
def _occ_on(cfg: PucchF1Config, device: torch.device):
    """(OCC of the data symbols [nd], of the DM-RS symbols [nm])."""
    return tuple(torch.from_numpy(_occ_w(len(syms), cfg.occ_index)).to(device)
                 for syms in (cfg.data_symbols, cfg.dmrs_symbols))


@functools.lru_cache(maxsize=64)
def f1_slot_seqs_on(cfg: PucchF1Config, device: torch.device):
    """``f1_slot_seqs`` as complex64 tensors on `device` (cached)."""
    return tuple(torch.from_numpy(a).to(device) for a in f1_slot_seqs(cfg))


def _tables(cfg: PucchF1Config, device: torch.device, seqs=None):
    """(data sequences [nd, 12], OCC of the data symbols [nd], DM-RS
    sequences × OCC [nm, 12]) on `device`; seqs: (data, DM-RS) sequences
    of the slot (``f1_slot_seqs``) instead of the config's own."""
    data, dmrs = f1_slot_seqs_on(cfg, device) if seqs is None else seqs
    w_d, w_m = _occ_on(cfg, device)
    return data, w_d, w_m[:, None] * dmrs


def pucch_f1_transmit(bits: torch.Tensor, cfg: PucchF1Config,
                      grid: torch.Tensor, seqs=None) -> torch.Tensor:
    """Map [B, nof_harq_bits] HARQ-ACK bits onto [B, 14, nsc] grids (set).
    seqs: optional (data, DM-RS) sequence tensors from ``f1_slot_seqs``."""
    data, w_d, dmrs = _tables(cfg, grid.device, seqs)
    d = modulation.modulate(bits, 1 if cfg.nof_harq_bits == 1 else 2)[..., 0]
    lo = cfg.prb * NRE
    out = grid.clone()
    for i, l in enumerate(cfg.data_symbols):
        out[..., l, lo:lo + NRE] = (d * w_d[i])[:, None] * data[i]
    for i, l in enumerate(cfg.dmrs_symbols):
        out[..., l, lo:lo + NRE] = dmrs[i]
    return out


@dataclasses.dataclass
class PucchF1Result:
    bits: torch.Tensor            # [B, nof_harq_bits] detected HARQ-ACK bits
    detection_metric: torch.Tensor   # [B]
    detected: torch.Tensor        # [B] bool: energy over the DTX threshold


def pucch_f1_detect(rx_grid: torch.Tensor, cfg: PucchF1Config,
                    dtx_threshold: float = 4.0, seqs=None) -> PucchF1Result:
    """Detect F1 HARQ bits from [B, nrx, 14, nsc] grids, in float64: per
    rx port the channel of each subcarrier is the mean over the DM-RS
    symbols of y·conj(s) (s the cyclic-shifted sequence times its OCC
    weight); the data symbols despread the same way are combined with
    that channel over subcarriers, symbols and ports into one estimate of
    the BPSK or QPSK symbol d̂ = Σ conj(h)·y·conj(s) / Σ|h|²·nd.  The
    metric is |d̂|²·Σ|h|²·nd over the mean squared DM-RS residual
    y - h·s.  seqs: optional (data, DM-RS) sequence tensors from
    ``f1_slot_seqs``."""
    data, w_d, dmrs = _tables(cfg, rx_grid.device, seqs)
    c = torch.complex128
    s_d = (data * w_d[:, None]).to(c)                        # [nd, 12]
    s_m = dmrs.to(c)                                         # [nm, 12]
    lo = cfg.prb * NRE
    grid = rx_grid[..., lo:lo + NRE].to(c)                   # [B, r, 14, 12]
    y_m = grid[..., list(cfg.dmrs_symbols), :]
    y_d = grid[..., list(cfg.data_symbols), :]
    nd = len(cfg.data_symbols)
    h = torch.einsum("brik,ik->brk", y_m, s_m.conj()) / len(cfg.dmrs_symbols)
    z = torch.einsum("brk,brik,ik->b", h.conj(), y_d, s_d.conj())
    energy = (h.abs() ** 2).sum(dim=(1, 2)) * nd              # [B]
    d_hat = z / torch.clamp(energy, min=1e-12)
    resid = y_m - h[:, :, None, :] * s_m
    noise = (resid.abs() ** 2).mean(dim=(1, 2, 3)) + 1e-12
    metric = (d_hat.abs() ** 2 * energy / noise).to(torch.float32)
    if cfg.nof_harq_bits == 1:
        bits = (d_hat.real + d_hat.imag <= 0).to(torch.int8)[:, None]
    else:
        bits = torch.stack([(d_hat.real <= 0).to(torch.int8),
                            (d_hat.imag <= 0).to(torch.int8)], dim=-1)
    return PucchF1Result(bits=bits, detection_metric=metric,
                         detected=metric > dtx_threshold)


# ---------------------------------------------------------------------- F2
@dataclasses.dataclass(frozen=True)
class PucchF2Config:
    prb_start: int
    nof_prb: int                 # 1..16
    start_symbol: int = 12
    nof_symbols: int = 2         # 1 or 2
    rnti: int = 0
    n_id: int = 0                # data scrambling
    n_id0: int = 0               # DM-RS scrambling
    nof_uci_bits: int = 4        # 3..11 (short-block path)
    slot_in_frame: int = 0

    @property
    def symbols(self) -> tuple[int, ...]:
        return tuple(self.start_symbol + i for i in range(self.nof_symbols))

    @functools.cached_property
    def data_sc(self) -> np.ndarray:
        """Data subcarriers: all except DM-RS at k ≡ 1 (mod 3)."""
        lo, hi = self.prb_start * NRE, (self.prb_start + self.nof_prb) * NRE
        ks = np.arange(lo, hi)
        return ks[ks % 3 != 1].astype(np.int32)

    @functools.cached_property
    def dmrs_sc(self) -> np.ndarray:
        lo, hi = self.prb_start * NRE, (self.prb_start + self.nof_prb) * NRE
        ks = np.arange(lo, hi)
        return ks[ks % 3 == 1].astype(np.int32)

    @property
    def nof_data_re(self) -> int:
        return len(self.data_sc) * self.nof_symbols

    @property
    def scrambling_cinit(self) -> int:
        return ((self.rnti << 15) + self.n_id) % (1 << 31)


def f2_dmrs_cinits(cfg: PucchF2Config) -> np.ndarray:
    """[nsym] uint32 DM-RS c_init values for the config's slot."""
    return np.asarray([dmrs_ops.dmrs_cinit(cfg.slot_in_frame, l, cfg.n_id0, 0)
                       for l in cfg.symbols], np.uint32)


@functools.lru_cache(maxsize=64)
def _f2_pilots_on(cinits: tuple[int, ...], npil: int, m0: int,
                  device: torch.device) -> torch.Tensor:
    c = np.stack([gold.gold_sequence_np(ci, 2 * npil, offset=2 * m0)
                  for ci in cinits]).astype(np.float32)
    inv = np.float32(1.0) / np.float32(np.sqrt(2.0))
    re = (1 - 2 * c[:, 0::2]) * inv
    im = (1 - 2 * c[:, 1::2]) * inv
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


def f2_dmrs_pilots(cfg: PucchF2Config, device: torch.device,
                   cinits=None) -> torch.Tensor:
    """[nsym, npilot] DM-RS pilots on `device`, cached per c_init (TS 38.211
    §6.4.1.3.2: Gold-QPSK with the sequence offset aligned to the PRB
    position).  cinits: the slot's [nsym] c_init values
    (``f2_dmrs_cinits``), default the config's own."""
    if cinits is None:
        cinits = f2_dmrs_cinits(cfg)
    return _f2_pilots_on(tuple(int(c) for c in cinits), len(cfg.dmrs_sc),
                         4 * cfg.prb_start, device)


@functools.lru_cache(maxsize=16)
def _f2_tables(cfg: PucchF2Config, device: torch.device):
    """(data subcarriers, DM-RS subcarriers, scrambling bits, scrambling
    LLR sign) on `device`."""
    e = cfg.nof_data_re * 2
    seq = gold.gold_sequence_np(cfg.scrambling_cinit, e).astype(np.int8)
    to = lambda a: torch.from_numpy(a).to(device)
    return (to(cfg.data_sc.astype(np.int64)), to(cfg.dmrs_sc.astype(np.int64)),
            to(seq), to(1.0 - 2.0 * seq.astype(np.float32)))


def pucch_f2_transmit(uci_bits: torch.Tensor, cfg: PucchF2Config,
                      grid: torch.Tensor, dmrs_cinits=None,
                      pilots: torch.Tensor | None = None) -> torch.Tensor:
    """Map [B, nof_uci_bits] UCI bits onto [B, 14, nsc] grids (set).
    pilots: the slot's DM-RS (``f2_dmrs_pilots``) as a tensor, in place of
    the ones of ``dmrs_cinits`` or the config's slot."""
    data_sc, dmrs_sc, seq, _ = _f2_tables(cfg, grid.device)
    enc = short_block.encode(uci_bits, cfg.nof_data_re * 2)
    syms = modulation.modulate(enc ^ seq, 2)                 # [B, n_data_re]
    per_sym = len(cfg.data_sc)
    if pilots is None:
        pilots = f2_dmrs_pilots(cfg, grid.device, dmrs_cinits)
    out = grid.clone()
    for i, l in enumerate(cfg.symbols):
        out[..., l, data_sc] = syms[:, i * per_sym:(i + 1) * per_sym]
        out[..., l, dmrs_sc] = pilots[i]
    return out


@dataclasses.dataclass
class PucchF2Result:
    uci_bits: torch.Tensor        # [B, nof_uci_bits]
    metric: torch.Tensor          # [B]
    detected: torch.Tensor        # [B] bool


def pucch_f2_receive(rx_grid: torch.Tensor, cfg: PucchF2Config,
                     detection_threshold: float = 0.5,
                     dmrs_cinits=None,
                     pilots: torch.Tensor | None = None) -> PucchF2Result:
    """Receive F2 UCI from [B, nrx, 14, nsc] grids: channel estimate from
    the DM-RS over the grid, MRC, QPSK soft demap, descramble, short-block
    ML detection.  pilots: as in ``pucch_f2_transmit``."""
    data_sc, dmrs_sc, _, sign = _f2_tables(cfg, rx_grid.device)
    if pilots is None:
        pilots = f2_dmrs_pilots(cfg, rx_grid.device, dmrs_cinits)
    y_p = torch.stack([rx_grid[..., l, dmrs_sc] for l in cfg.symbols], dim=-2)
    est = estimator.estimate_port(y_p, pilots, cfg.dmrs_sc, rx_grid.shape[-1],
                                  rx_grid.shape[-2])
    y = torch.stack([rx_grid[..., l, data_sc] for l in cfg.symbols], dim=-2)
    h = torch.stack([est.h[..., l, data_sc] for l in cfg.symbols], dim=-2)
    yf, hf = y.flatten(-2), h.flatten(-2)                  # [B, nrx, n]
    nv = torch.clamp(est.noise_var.mean(dim=-1), min=1e-9)
    x_hat, post_nv = equalizer.zf_1xn(yf, hf, nv)
    llr = modulation.demodulate_soft(x_hat, post_nv, 2) * sign
    bits, metric = short_block.detect(llr, cfg.nof_uci_bits, llr.shape[-1])
    return PucchF2Result(uci_bits=bits, metric=metric,
                         detected=metric > detection_threshold)
