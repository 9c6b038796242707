"""PDCCH processor: DCI encoding, QPSK mapping with DM-RS, and the receivers.

Copied from the port's ``srsran_project_23_5_tpu_torch/phy/upper/pdcch.py``,
unchanged.

The port's translation of ``srsran_project_23_5_tpu/phy/upper/pdcch.py`` (TS
38.212 §7.3, TS 38.211 §7.3.2):

TX: DCI payload → CRC24C over (24 ones ‖ payload) → RNTI mask on the last
16 CRC bits → input interleaver → polar encode → rate match (E = 108·AL) →
scramble → QPSK → CCE/REG mapping with DM-RS at k ≡ 1 (mod 4).

RX: the inverse with SSC polar decoding and the CRC/RNTI check; the blind
decode metric is the CRC pass.

CORESETs of 1-3 symbols, with the non-interleaved or the interleaved
(§7.3.2.2 REG-bundle interleaver) CCE-to-REG mapping.  The scrambling
sequence, the RE positions and the DM-RS pilots are configuration and are
baked on the host.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...ops import crc as crc_ops
from ...ops import dmrs as dmrs_ops
from ...ops import gold, modulation
from ...ops.polar import code as polar_code
from ...ops.polar import decoder as polar_decoder
from ...ops.polar import encoder as polar_encoder
from ...ops.polar import rate_match as polar_rm
from ...ran.constants import NRE


@dataclasses.dataclass(frozen=True)
class PdcchConfig:
    """One DCI candidate of a CORESET."""
    rnti: int
    payload_size: int            # DCI bits (A)
    aggregation_level: int = 4   # 1/2/4/8/16 CCEs
    cce_index: int = 0
    coreset_start_prb: int = 0
    start_symbol: int = 0
    nof_symbols: int = 1         # CORESET duration (1..3)
    n_id: int = 1                # pdcch-DMRS-ScramblingID / scrambling id
    n_rnti: int = 0              # scrambling RNTI
    # interleaved CCE-to-REG mapping (TS 38.211 §7.3.2.2): REG bundles of
    # L = 6 permuted by the (R, C) block interleaver with shift n_shift
    interleaved: bool = False
    coreset_nof_prb: int = 48    # CORESET width (sets the bundle count)
    interleaver_rows: int = 2    # R
    shift: int = 0               # n_shift (typically the PCI)

    @property
    def e(self) -> int:
        # 1 CCE = 6 REGs, 9 data REs per REG, QPSK
        return self.aggregation_level * 6 * 9 * 2

    @property
    def k(self) -> int:
        return self.payload_size + 24

    @functools.cached_property
    def code(self) -> polar_code.PolarCode:
        return polar_code.polar_code(self.k, self.e, nmax_log=9)

    @property
    def scrambling_cinit(self) -> int:
        return ((self.n_rnti << 16) + self.n_id) % (1 << 31)

    @functools.cached_property
    def re_indices(self) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
        """(data_sym, data_sc, dmrs_sym, dmrs_sc) of the candidate's REGs,
        in mapping order.  REG numbering is time-first (§7.3.2.2): REG r
        sits at symbol start + r mod nof_symbols of its CCE's bundle, which
        spans 6/nof_symbols PRBs × nof_symbols symbols."""
        dsym, dsc, msym, msc = [], [], [], []
        for r in range(self.aggregation_level * 6):
            bundle = self._bundle_of(self.cce_index + r // 6)
            prb = (self.coreset_start_prb
                   + bundle * (6 // self.nof_symbols)
                   + (r % 6) // self.nof_symbols)
            sym = self.start_symbol + r % self.nof_symbols
            ks = np.arange(prb * NRE, prb * NRE + NRE)
            is_dmrs = (ks % 4) == 1
            dsym.extend([sym] * int((~is_dmrs).sum()))
            dsc.extend(ks[~is_dmrs])
            msym.extend([sym] * int(is_dmrs.sum()))
            msc.extend(ks[is_dmrs])
        return (np.asarray(dsym, np.int32), np.asarray(dsc, np.int32),
                np.asarray(msym, np.int32), np.asarray(msc, np.int32))

    def _bundle_of(self, cce: int) -> int:
        """CCE → REG bundle through the §7.3.2.2 block interleaver (bundle
        size 6: one bundle per CCE); the identity when non-interleaved."""
        if not self.interleaved:
            return cce
        nb = (self.coreset_nof_prb * self.nof_symbols) // 6
        r_rows = self.interleaver_rows
        if nb % r_rows:
            raise ValueError(f"{nb} REG bundles do not fill "
                             f"{r_rows} interleaver rows")
        c, r = divmod(cce, r_rows)
        return (r * (nb // r_rows) + c + self.shift) % nb


def _dmrs_np(cfg: PdcchConfig, symbol: int, first_prb: int,
             npil: int) -> np.ndarray:
    """Gold-QPSK DM-RS pilots of one CORESET symbol, 3 per PRB, the
    sequence indexed from `first_prb` (§7.4.1.3)."""
    c = gold.gold_sequence_np(dmrs_ops.dmrs_cinit(0, symbol, cfg.n_id, 0),
                              2 * npil, offset=2 * 3 * first_prb)
    c = c.astype(np.float32)
    inv = np.float32(1.0) / np.float32(np.sqrt(2.0))
    return ((1 - 2 * c[0::2]) * inv + 1j * ((1 - 2 * c[1::2]) * inv)
            ).astype(np.complex64)


def _pilots_np(cfg: PdcchConfig) -> np.ndarray:
    """The candidate's DM-RS pilots in ``re_indices`` DM-RS order: per
    symbol, the symbol's sequence from the PRB of its first DM-RS RE in REG
    order (for a non-interleaved one-symbol candidate, its first PRB)."""
    _, _, msym, msc = cfg.re_indices
    pil = np.zeros(msc.size, np.complex64)
    for l in range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols):
        sel = msym == l
        ks = msc[sel]
        pil[sel] = _dmrs_np(cfg, l, int(ks[0]) // NRE, ks.size)
    return pil


@functools.lru_cache(maxsize=64)
def _tables(cfg: PdcchConfig, device: torch.device):
    """Host-baked constants of one configuration on `device`: scrambling
    bits [E] int8, their LLR sign [E], the RNTI mask [16] int8, the input
    interleaver, its inverse, and the DM-RS pilots of the candidate."""
    seq = gold.gold_sequence_np(cfg.scrambling_cinit, cfg.e).astype(np.int8)
    rnti = np.asarray([(cfg.rnti >> (15 - i)) & 1 for i in range(16)],
                      np.int8)
    pi = polar_code.input_interleaver(cfg.k).astype(np.int64)
    pil = _pilots_np(cfg)
    return (torch.from_numpy(seq).to(device),
            torch.from_numpy(1.0 - 2.0 * seq.astype(np.float32)).to(device),
            torch.from_numpy(rnti).to(device),
            torch.from_numpy(pi).to(device),
            torch.from_numpy(np.argsort(pi)).to(device),
            torch.from_numpy(pil).to(device))


def _dci_crc(payload: torch.Tensor) -> torch.Tensor:
    """CRC24C over (24 ones ‖ payload): [..., A] → [..., 24]."""
    ones = payload.new_ones((*payload.shape[:-1], 24))
    return crc_ops.crc(torch.cat([ones, payload], dim=-1), "crc24C")


def encode_dci(payload: torch.Tensor, cfg: PdcchConfig) -> torch.Tensor:
    """DCI payloads [..., A] int8 → rate-matched bits [..., E]."""
    _, _, rnti, pi, _, _ = _tables(cfg, payload.device)
    crc = _dci_crc(payload)
    crc = torch.cat([crc[..., :8], crc[..., 8:] ^ rnti], dim=-1)
    c = torch.cat([payload, crc], dim=-1)[..., pi]
    u = polar_encoder.allocate(c, cfg.code.info_set, cfg.code.n)
    return polar_rm.match(polar_encoder.encode(u), cfg.code)


@functools.lru_cache(maxsize=64)
def _re_flat(cfg: PdcchConfig, nsc: int, device: torch.device
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat indices into [14·nsc] of the candidate's data REs and DM-RS
    REs, in mapping order."""
    dsym, dsc, msym, msc = cfg.re_indices
    flat = lambda l, k: torch.from_numpy(
        l.astype(np.int64) * nsc + k).to(device)
    return flat(dsym, dsc), flat(msym, msc)


def pdcch_transmit(payload: torch.Tensor, cfg: PdcchConfig,
                   grid: torch.Tensor) -> torch.Tensor:
    """Map [B, A] DCIs onto [B, ..., 14, nsc] grids (set, not add; every
    port of a multi-port grid gets the candidate).

    Every CORESET is two index writes (data, DM-RS) over the flattened
    symbol × subcarrier plane.
    """
    seq, _, _, _, _, pil = _tables(cfg, payload.device)
    syms = modulation.modulate(encode_dci(payload, cfg) ^ seq, 2)  # [B, E/2]
    bsz = syms.shape[0]
    ports = (1,) * (grid.dim() - 3)
    out = grid.clone(memory_format=torch.contiguous_format)
    d_idx, m_idx = _re_flat(cfg, grid.shape[-1], grid.device)
    plane = out.view(*grid.shape[:-2], -1)
    plane[..., d_idx] = syms.reshape(bsz, *ports, -1)
    plane[..., m_idx] = pil.expand(bsz, *ports, -1)
    return out


@dataclasses.dataclass
class PdcchResult:
    payload: torch.Tensor
    crc_ok: torch.Tensor


def _decode_bits_to_payload(llr: torch.Tensor, cfg: PdcchConfig
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Descrambled candidate LLRs [..., E] → (payload [..., A], crc_ok)."""
    _, _, rnti, _, pi_inv, _ = _tables(cfg, llr.device)
    u = polar_decoder.decode(polar_rm.dematch(llr, cfg.code), cfg.code)
    de = polar_encoder.extract_message(u, cfg.code.info_set)[..., pi_inv]
    payload, crc = de[..., :cfg.payload_size], de[..., cfg.payload_size:]
    crc = torch.cat([crc[..., :8], crc[..., 8:] ^ rnti], dim=-1)
    return payload, torch.all(_dci_crc(payload) == crc, dim=-1)


def decode_dci_llr(llr: torch.Tensor, cfg: PdcchConfig) -> PdcchResult:
    """Candidate data-RE LLRs [..., E] (mapping order, before
    descrambling) → DCI: descramble, polar rate-dematch, SSC decode, CRC24C
    with the RNTI unmasked."""
    _, sign, _, _, _, _ = _tables(cfg, llr.device)
    payload, ok = _decode_bits_to_payload(llr * sign, cfg)
    return PdcchResult(payload=payload, crc_ok=ok)


def _port0(rx_grid: torch.Tensor) -> torch.Tensor:
    """[B, 14, nsc] of a [B, 14, nsc] or [B, nrx, 14, nsc] grid (port 0)."""
    return rx_grid[:, 0] if rx_grid.dim() == 4 else rx_grid


@functools.lru_cache(maxsize=64)
def _data_offsets(aggregation_level: int, device: torch.device
                  ) -> torch.Tensor:
    """Data RE offsets within a contiguous candidate's AL·72 subcarriers
    (every offset but k ≡ 1 mod 4)."""
    k = np.arange(aggregation_level * 6 * NRE)
    return torch.from_numpy(k[k % 4 != 1]).to(device)


def _llr(y: torch.Tensor, cfg: PdcchConfig) -> torch.Tensor:
    """Descrambled QPSK LLRs [..., E] of the data REs [..., E/2] (no
    equalisation: a flat channel per candidate, noise variance 0.1)."""
    _, sign, _, _, _, _ = _tables(cfg, y.device)
    nv = torch.full(y.shape, 0.1, dtype=torch.float32, device=y.device)
    return modulation.demodulate_soft(y, nv, 2) * sign


def pdcch_blind_receive(rx_grid: torch.Tensor, cfg: PdcchConfig,
                        cce_indices: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """UE-side blind decode of one aggregation level over the candidate
    CCE indices [M] (a tensor, so the candidates may move every slot).
    Non-interleaved one-symbol CORESET: a candidate is a contiguous
    AL·6-PRB span (its start clamped into the grid), so all M candidates'
    data REs are one gather, and the M SSC decodes run as one batch.

    rx_grid: [B, 14, nsc] or [B, nrx, 14, nsc] (port 0 is used).
    Returns (payloads [B, M, A], crc_ok [B, M]).
    """
    if cfg.nof_symbols != 1:
        raise ValueError("blind receive needs a one-symbol CORESET")
    row = _port0(rx_grid)[:, cfg.start_symbol]                  # [B, nsc]
    width = cfg.aggregation_level * 6 * NRE
    start = (cfg.coreset_start_prb + cce_indices.to(row.device) * 6) * NRE
    start = torch.clamp(start, 0, row.shape[-1] - width)
    idx = start[:, None] + _data_offsets(cfg.aggregation_level, row.device)
    return _decode_bits_to_payload(_llr(row[:, idx], cfg), cfg)


def pdcch_receive(rx_grid: torch.Tensor, cfg: PdcchConfig) -> PdcchResult:
    """Receive the configured candidate without equalisation (loopback
    validation): rx_grid [B, 14, nsc] or [B, nrx, 14, nsc] (port 0) →
    payload [B, A], crc_ok [B]."""
    grid = _port0(rx_grid)
    d_idx, _ = _re_flat(cfg, grid.shape[-1], grid.device)
    y = grid.reshape(grid.shape[0], -1)[:, d_idx]
    payload, ok = _decode_bits_to_payload(_llr(y, cfg), cfg)
    return PdcchResult(payload=payload, crc_ok=ok)
