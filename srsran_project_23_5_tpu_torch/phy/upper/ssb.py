"""SSB processor: PSS, SSS, PBCH encode/modulate and SS/PBCH block assembly.

Counterpart of ``srsran_project_23_5_tpu/phy/upper/ssb.py`` (TS 38.211
§7.4.2-§7.4.3, TS 38.212 §7.1): the block is rendered as a [B, 4, 240]
tensor that the caller places at its offset, and the PBCH is received from
such a block.  The sequences (PSS, SSS, both PBCH scramblings, the PBCH
DM-RS) and the RE positions are configuration and are baked on the host.
"""
from __future__ import annotations

import dataclasses
import functools
import typing

import numpy as np
import torch

from ...ops import crc as crc_ops
from ...ops import gold, modulation
from ...ops.polar import code as polar_code
from ...ops.polar import decoder as polar_decoder
from ...ops.polar import encoder as polar_encoder
from ...ops.polar import rate_match as polar_rm

SSB_NSYM = 4
SSB_NSC = 240
PBCH_A = 32          # payload bits (24 MIB + 8 timing)
PBCH_K = 56          # A + CRC24
PBCH_E = 864

# TS 38.212 Table 7.1.1-1: PBCH payload interleaver pattern G(j).
_G = (16, 23, 18, 17, 8, 30, 10, 6, 24, 7, 0, 5, 3, 2, 1, 4,
      9, 11, 12, 13, 14, 15, 19, 20, 21, 22, 25, 26, 27, 28, 29, 31)
_G_INV = tuple(int(x) for x in np.argsort(np.asarray(_G)))


@functools.lru_cache(maxsize=8)
def _mseq(taps: tuple[int, ...], init: tuple[int, ...]) -> np.ndarray:
    """Length-127 m-sequence x(i+7) = sum_t x(i+t) mod 2."""
    x = np.zeros(127 + 7, dtype=np.int8)
    x[:7] = init
    for i in range(127):
        x[i + 7] = sum(x[i + t] for t in taps) % 2
    return x[:127]


def pss_sequence(nid2: int) -> np.ndarray:
    """d_PSS (TS 38.211 §7.4.2.2): BPSK of the m-sequence shifted by
    43·N_ID2."""
    x = _mseq((4, 0), (0, 1, 1, 0, 1, 1, 1))
    n = np.arange(127)
    return (1.0 - 2.0 * x[(n + 43 * nid2) % 127]).astype(np.float32)


def sss_sequence(nid1: int, nid2: int) -> np.ndarray:
    """d_SSS (TS 38.211 §7.4.2.3)."""
    x0 = _mseq((4, 0), (1, 0, 0, 0, 0, 0, 0))
    x1 = _mseq((1, 0), (1, 0, 0, 0, 0, 0, 0))
    m0 = 15 * (nid1 // 112) + 5 * nid2
    m1 = nid1 % 112
    n = np.arange(127)
    return ((1.0 - 2.0 * x0[(n + m0) % 127])
            * (1.0 - 2.0 * x1[(n + m1) % 127])).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SsbConfig:
    pci: int                     # physical cell id N_ID^cell (0..1007)
    ssb_idx: int = 0             # SS/PBCH block index
    lmax: int = 8                # max SSB candidates (4/8/64)
    sfn: int = 0
    hrf: int = 0                 # half-radio-frame bit

    @property
    def nid1(self) -> int:
        return self.pci // 3

    @property
    def nid2(self) -> int:
        return self.pci % 3


@functools.lru_cache(maxsize=1)
def _pbch_code() -> polar_code.PolarCode:
    return polar_code.polar_code(PBCH_K, PBCH_E, nmax_log=9)


def _first_scrambling_seq(cfg: SsbConfig) -> np.ndarray:
    """First (payload-level) scrambling (TS 38.211 §7.1.1): Gold by PCI at
    offset v·M, v = 2·sfn2 + sfn3, sparing the SFN/HRF/SSB-index bits."""
    v = 2 * ((cfg.sfn >> 1) & 1) + ((cfg.sfn >> 2) & 1)
    m = 29 if cfg.lmax < 64 else 26
    c = gold.gold_sequence_np(cfg.pci, (v + 1) * m)[v * m:]
    seq = np.zeros(PBCH_A, dtype=np.int8)
    spare = {_G[10 + 2], _G[10 + 1], _G[10 + 7]}  # sfn2nd, sfn3rd, hrf slots
    if cfg.lmax == 64:
        spare |= {_G[10 + 5], _G[10 + 6], _G[29]}
    j = 0
    for i in range(PBCH_A):
        if i in spare:
            continue
        seq[i] = c[j]
        j += 1
    return seq


def _second_scrambling_seq(cfg: SsbConfig) -> np.ndarray:
    """Second scrambling of the whole codeword: Gold by PCI at offset
    i_SSB·E."""
    i_ssb = ((cfg.ssb_idx & 0b111) if cfg.lmax >= 8
             else (cfg.ssb_idx & 0b11) + 4 * cfg.hrf)
    return gold.gold_sequence_np(cfg.pci, PBCH_E,
                                 offset=i_ssb * PBCH_E).astype(np.int8)


def dmrs_pbch_pilots_np(cfg: SsbConfig) -> np.ndarray:
    """[144] QPSK PBCH DM-RS pilots (TS 38.211 §7.4.1.4.1), host side."""
    i_ssb = (cfg.ssb_idx & 0b111) if cfg.lmax >= 8 else (cfg.ssb_idx & 0b11)
    ii = i_ssb + 4 * cfg.hrf if cfg.lmax < 8 else i_ssb
    cinit = ((1 << 11) * (ii + 1) * (cfg.pci // 4 + 1)
             + (1 << 6) * (ii + 1) + (cfg.pci % 4)) % (1 << 31)
    c = gold.gold_sequence_np(cinit, 2 * 144).astype(np.float32)
    inv = np.float32(1.0) / np.float32(np.sqrt(2.0))
    return ((1 - 2 * c[0::2]) * inv + 1j * ((1 - 2 * c[1::2]) * inv)
            ).astype(np.complex64)


def _dmrs_positions(cfg: SsbConfig) -> tuple[np.ndarray, np.ndarray]:
    """(symbol, subcarrier) of the PBCH DM-RS within the 4×240 block
    (v = PCI mod 4), in pilot order."""
    v = cfg.pci % 4
    syms, scs = [], []
    for sc in range(v, SSB_NSC, 4):
        syms += [1, 3]
        scs += [sc, sc]
    for sc in [*range(v, 48, 4), *range(192 + v, SSB_NSC, 4)]:
        syms.append(2)
        scs.append(sc)
    return np.asarray(syms, np.int32), np.asarray(scs, np.int32)


def _data_positions(cfg: SsbConfig) -> tuple[np.ndarray, np.ndarray]:
    """(symbol, subcarrier) of the PBCH data REs, in symbol order: symbol
    1, symbol 2 below and above the SSS, symbol 3."""
    v = cfg.pci % 4
    syms, scs = [], []
    for sym, rng in ((1, range(SSB_NSC)), (2, range(48)),
                     (2, range(192, SSB_NSC)), (3, range(SSB_NSC))):
        for sc in rng:
            if sc % 4 != v:
                syms.append(sym)
                scs.append(sc)
    return np.asarray(syms, np.int32), np.asarray(scs, np.int32)


class _Tables(typing.NamedTuple):
    g_inv: torch.Tensor          # payload interleaver a = payload[g_inv]
    g: torch.Tensor              # its inverse: payload = a[g]
    first: torch.Tensor          # first scrambling [32]
    pi: torch.Tensor             # polar input interleaver [56]
    pi_inv: torch.Tensor
    second: torch.Tensor         # second scrambling [864]
    pilots: torch.Tensor         # PBCH DM-RS [144]
    pss: torch.Tensor
    sss: torch.Tensor
    data_idx: torch.Tensor       # PBCH data REs, flat into [4·240]


@functools.lru_cache(maxsize=16)
def _tables(cfg: SsbConfig, device: torch.device) -> _Tables:
    """The configuration's host-baked constants on `device`."""
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    pi = polar_code.input_interleaver(PBCH_K).astype(np.int64)
    dsym, dsc = _data_positions(cfg)
    return _Tables(
        g_inv=to(np.asarray(_G_INV, np.int64)), g=to(np.asarray(_G, np.int64)),
        first=to(_first_scrambling_seq(cfg)), pi=to(pi),
        pi_inv=to(np.argsort(pi)), second=to(_second_scrambling_seq(cfg)),
        pilots=to(dmrs_pbch_pilots_np(cfg)),
        pss=to(pss_sequence(cfg.nid2).astype(np.complex64)),
        sss=to(sss_sequence(cfg.nid1, cfg.nid2).astype(np.complex64)),
        data_idx=to(dsym.astype(np.int64) * SSB_NSC + dsc))


def dmrs_pbch_pilots(cfg: SsbConfig,
                     device: torch.device | str) -> torch.Tensor:
    """[144] QPSK PBCH DM-RS pilots on `device`."""
    return _tables(cfg, torch.device(device)).pilots


def pbch_encode(payload: torch.Tensor, cfg: SsbConfig) -> torch.Tensor:
    """[..., 32] payload bits → [..., 864] coded bits."""
    t = _tables(cfg, payload.device)
    a = payload[..., t.g_inv] ^ t.first
    with_crc = crc_ops.crc_attach(a, "crc24C")[..., t.pi]
    code = _pbch_code()
    u = polar_encoder.allocate(with_crc, code.info_set, code.n)
    return polar_rm.match(polar_encoder.encode(u), code) ^ t.second


def ssb_assemble(payload: torch.Tensor, cfg: SsbConfig,
                 amplitude: float = 1.0) -> torch.Tensor:
    """[B, 32] PBCH payloads → [B, 4, 240] SS/PBCH blocks.

    Each PBCH row is a comb-4 interleave of [n, 4] quads, DM-RS at
    k ≡ v (mod 4) and data at the other offsets, in the order of the
    receiver's data and DM-RS positions.
    """
    t = _tables(cfg, payload.device)
    v = cfg.pci % 4
    bsz = payload.shape[0]
    syms = modulation.modulate(pbch_encode(payload, cfg), 2) * amplitude
    pil = t.pilots * amplitude
    dcols = [j for j in range(4) if j != v]

    def comb_rows(data_chunk: torch.Tensor, pil_chunk: torch.Tensor
                  ) -> torch.Tensor:
        cols = [None] * 4
        cols[v] = pil_chunk.expand(bsz, -1)
        for i, j in enumerate(dcols):
            cols[j] = data_chunk[..., i::3]
        return torch.stack(cols, dim=-1).reshape(bsz, -1)

    # data order: sym1 (180), sym2 lo (36), sym2 hi (36), sym3 (180);
    # pilot order: sym1/sym3 interleaved per subcarrier (120), sym2 lo+hi (24)
    block = syms.new_zeros((bsz, SSB_NSYM, SSB_NSC))
    block[:, 0, 56:183] = amplitude * t.pss
    block[:, 1] = comb_rows(syms[:, :180], pil[0:120:2])
    block[:, 2, 0:48] = comb_rows(syms[:, 180:216], pil[120:132])
    block[:, 2, 192:240] = comb_rows(syms[:, 216:252], pil[132:144])
    block[:, 2, 56:183] = amplitude * t.sss
    block[:, 3] = comb_rows(syms[:, 252:432], pil[1:120:2])
    return block


def pbch_decode(llr: torch.Tensor, cfg: SsbConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., 864] PBCH LLRs → (payload [..., 32] int8, crc_ok [...])."""
    t = _tables(cfg, llr.device)
    code = _pbch_code()
    llr = llr * (1.0 - 2.0 * t.second.to(torch.float32))
    u = polar_decoder.decode(polar_rm.dematch(llr, code), code)
    de = polar_encoder.extract_message(u, code.info_set)[..., t.pi_inv]
    a = de[..., :PBCH_A] ^ t.first
    return a[..., t.g], crc_ops.crc_check(de, "crc24C")


def ssb_receive_pbch(block: torch.Tensor, cfg: SsbConfig,
                     noise_var: float = 0.05
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode the PBCH of received [B, 4, 240] SS/PBCH blocks (loopback; no
    equalisation) → (payload [B, 32], crc_ok [B])."""
    y = block.flatten(-2)[..., _tables(cfg, block.device).data_idx]
    nv = torch.full(y.shape, noise_var, dtype=torch.float32,
                    device=y.device)
    return pbch_decode(modulation.demodulate_soft(y, nv, 2), cfg)
