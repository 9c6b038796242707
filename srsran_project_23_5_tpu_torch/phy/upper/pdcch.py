"""PDCCH processor: DCI encoding, QPSK mapping with DM-RS, and the DCI
decode from equalised candidate LLRs.

Counterpart of ``srsran_project_23_5_tpu/phy/upper/pdcch.py`` (TS 38.212
§7.3, TS 38.211 §7.3.2):

TX: DCI payload → CRC24C over (24 ones ‖ payload) → RNTI mask on the last
16 CRC bits → input interleaver → polar encode → rate match (E = 108·AL) →
scramble → QPSK → CCE/REG mapping with DM-RS at k ≡ 1 (mod 4).

Only the non-interleaved one-symbol CORESET is ported (``convert`` refuses
the others); the scrambling sequence and the DM-RS pilots are configuration
and are baked on the host.
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
    """One DCI candidate in a non-interleaved one-symbol CORESET."""
    rnti: int
    payload_size: int            # DCI bits (A)
    aggregation_level: int = 4   # 1/2/4/8/16 CCEs
    cce_index: int = 0
    coreset_start_prb: int = 0
    start_symbol: int = 0
    n_id: int = 1                # pdcch-DMRS-ScramblingID / scrambling id
    n_rnti: int = 0              # scrambling RNTI

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


@functools.lru_cache(maxsize=64)
def _tables(cfg: PdcchConfig, device: torch.device):
    """Host-baked constants of one configuration on `device`: scrambling
    bits [E] int8, their LLR sign [E], the RNTI mask [16] int8, the input
    interleaver, its inverse, and the DM-RS pilots of the candidate."""
    seq = gold.gold_sequence_np(cfg.scrambling_cinit, cfg.e).astype(np.int8)
    rnti = np.asarray([(cfg.rnti >> (15 - i)) & 1 for i in range(16)],
                      np.int8)
    pi = polar_code.input_interleaver(cfg.k).astype(np.int64)
    # DM-RS: Gold-QPSK, 3 pilots per PRB indexed by absolute PRB (§7.4.1.3)
    first_prb = cfg.coreset_start_prb + cfg.cce_index * 6
    npil = cfg.aggregation_level * 6 * 3
    c = gold.gold_sequence_np(dmrs_ops.dmrs_cinit(0, cfg.start_symbol,
                                                  cfg.n_id, 0),
                              2 * npil, offset=2 * 3 * first_prb)
    c = c.astype(np.float32)
    inv = np.float32(1.0) / np.float32(np.sqrt(2.0))
    pil = ((1 - 2 * c[0::2]) * inv + 1j * ((1 - 2 * c[1::2]) * inv)
           ).astype(np.complex64)
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


def pdcch_transmit(payload: torch.Tensor, cfg: PdcchConfig,
                   grid: torch.Tensor) -> torch.Tensor:
    """Map [B, A] DCIs onto [B, ..., 14, nsc] grids (set, not add).

    The candidate of a non-interleaved one-symbol CORESET is one contiguous
    AL·6-PRB span: viewed as [nreg·3, 4] quads, k ≡ 1 (mod 4) is DM-RS and
    the other three offsets carry data, so the row is one interleave and
    one slice write.
    """
    seq, _, _, _, _, pil = _tables(cfg, payload.device)
    syms = modulation.modulate(encode_dci(payload, cfg) ^ seq, 2)  # [B, E/2]
    bsz = syms.shape[0]
    width = cfg.aggregation_level * 6 * NRE
    row = torch.stack([syms[..., 0::3], pil.expand(bsz, -1),
                       syms[..., 1::3], syms[..., 2::3]],
                      dim=-1).reshape(bsz, width)
    lo = (cfg.coreset_start_prb + cfg.cce_index * 6) * NRE
    out = grid.clone()
    out[..., cfg.start_symbol, lo:lo + width] = row.reshape(
        bsz, *(1,) * (grid.dim() - 3), width)
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
