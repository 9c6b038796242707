"""UL-SCH multiplexing/demultiplexing of UCI on PUSCH (TS 38.212 §6.2.7).

Counterpart of ``srsran_project_23_5_tpu/phy/upper/ulsch.py``.  Which RE of
which symbol carries HARQ-ACK, CSI part 1, CSI part 2 or SCH data depends
only on the static allocation, so the per-symbol stride arithmetic of the
reference's ulsch_demultiplex runs once on the host (numpy, the same code as
the JAX package) and emits index tables; on the device the multiplex and
demultiplex are gathers over the codeword bit stream of every slot of the
batch.

When O_ack <= 2 the ACK bits ride *reserved* REs that puncture SCH (or CSI
part 2): the punctured field positions read LLR 0 on receive and are
dropped on transmit.

Spec deviation (documented, as in the JAX package): placeholder y bits
(1-bit UCI, Qm>=2) are scrambled with the regular Gold sequence rather than
the repeat-previous rule of TS 38.211 §6.3.1.1; transmit and receive here
are consistent with each other, and the y position is ignored by the fold.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ...ops import short_block
from ...ran.constants import NRE

_ZERO = -1  # sentinel: punctured field position (no stream bit)


@dataclasses.dataclass(frozen=True)
class UciOnPusch:
    """Static UCI-on-PUSCH multiplexing configuration for one PUSCH.

    g_* are the ENCODED lengths (multiples of Qm); g_harq_ack_rvd is the
    reserved-bit count used when O_ack <= 2 (ACK punctures data instead of
    being rate-matched around, TS 38.212 §6.2.7).
    """
    nof_harq_ack_bits: int = 0      # O_ack (information bits)
    nof_csi_part1_bits: int = 0     # O_csi1
    nof_csi_part2_bits: int = 0     # O_csi2
    g_harq_ack: int = 0             # G_ack encoded bits
    g_csi_part1: int = 0            # G_csi1
    g_csi_part2: int = 0            # G_csi2
    g_harq_ack_rvd: int = 0         # reserved bits (O_ack <= 2 case)

    @property
    def any(self) -> bool:
        return (self.g_harq_ack or self.g_csi_part1 or self.g_csi_part2
                or self.g_harq_ack_rvd) != 0


def uci_encoded_bits(o_uci: int, crc_bits: int, beta: float, alpha: float,
                     sum_kr: int, m_uci_sc: int, qm: int,
                     nof_layers: int = 1) -> int:
    """Q'_uci * Qm * nof_layers per TS 38.212 §6.3.2.4.1.1-3.

    sum_kr: total payload bits of the UL-SCH codeblocks (denominator term);
    m_uci_sc: total REs available for UCI across the allocation.
    """
    if o_uci == 0:
        return 0
    q_prime = min(
        math.ceil((o_uci + crc_bits) * beta * m_uci_sc / max(sum_kr, 1)),
        math.ceil(alpha * m_uci_sc))
    return q_prime * qm * nof_layers


@functools.lru_cache(maxsize=256)
def demux_positions(nof_prb: int, qm: int, nof_layers: int,
                    first_symbol: int, nof_symbols: int,
                    dmrs_symbols: tuple[int, ...],
                    nof_cdm_groups_without_data: int,
                    g_ack: int, g_csi1: int, g_csi2: int, g_ack_rvd: int
                    ) -> dict:
    """Host-side field position tables (ulsch_demultiplex_impl.cpp:74-314).

    Returns dict of int32 arrays: for each field, entry i is the codeword
    stream bit position of the field's i-th output bit, or -1 when the
    position is punctured (zero-filled on RX, dropped on TX).  'total_bits'
    is the multiplexed stream length G_total.
    """
    bpr = qm * nof_layers
    dmrs_set = set(dmrs_symbols)
    l1 = None
    seen_dmrs = False
    for l in range(first_symbol, first_symbol + nof_symbols):
        if l in dmrs_set:
            seen_dmrs = True
        elif seen_dmrs:
            l1 = l
            break
    l1_csi = next(l for l in range(first_symbol, first_symbol + nof_symbols)
                  if l not in dmrs_set)
    if l1 is None:
        l1 = l1_csi

    nof_re_dmrs = (NRE - nof_cdm_groups_without_data * 6) * nof_prb

    sch: list[int] = []
    ack: list[int] = []
    csi1: list[int] = []
    csi2: list[int] = []
    m_rvd = m_ack = m_csi1 = m_csi2 = 0
    pos = 0

    def consume(dst: list[int]):
        nonlocal pos
        dst.extend(range(pos, pos + bpr))
        pos += bpr

    def puncture(dst: list[int]):
        dst.extend([_ZERO] * bpr)

    for l in range(first_symbol, first_symbol + nof_symbols):
        if l in dmrs_set:
            for _ in range(nof_re_dmrs):
                consume(sch)
            continue
        m_ulsch_sc = nof_prb * NRE
        m_uci_sc = m_ulsch_sc
        m_uci_rvd = 0
        ack_d = ack_cnt = rvd_d = rvd_cnt = 0
        csi1_d = csi1_cnt = csi2_d = csi2_cnt = 0

        if l >= l1:
            rvd_rem = g_ack_rvd - m_rvd
            ack_rem = g_ack - m_ack
            if g_ack_rvd and rvd_rem:
                rvd_d, rvd_cnt = 1, m_uci_sc
                if rvd_rem < m_uci_sc * bpr:
                    rvd_d = (m_uci_sc * bpr) // rvd_rem
                    rvd_cnt = -(-rvd_rem // bpr)
                m_uci_rvd = rvd_cnt
                if ack_rem:
                    ack_d, ack_cnt = 1, m_uci_rvd
                    if ack_rem < m_uci_rvd * bpr:
                        ack_d = (m_uci_rvd * bpr) // ack_rem
                        ack_cnt = -(-ack_rem // bpr)
            elif ack_rem:
                ack_d, ack_cnt = 1, m_uci_sc
                if ack_rem < m_uci_sc * bpr:
                    ack_d = (m_uci_sc * bpr) // ack_rem
                    ack_cnt = -(-ack_rem // bpr)
                m_uci_sc -= ack_cnt

        if l >= l1_csi:
            csi1_rem = g_csi1 - m_csi1
            csi2_rem = g_csi2 - m_csi2
            if m_uci_sc > m_uci_rvd and csi1_rem:
                csi1_d, csi1_cnt = 1, m_uci_sc - m_uci_rvd
                if csi1_rem < (m_uci_sc - m_uci_rvd) * bpr:
                    csi1_d = ((m_uci_sc - m_uci_rvd) * bpr) // csi1_rem
                    csi1_cnt = -(-csi1_rem // bpr)
                m_uci_sc -= csi1_cnt
            if m_uci_sc > 0 and csi2_rem:
                csi2_d, csi2_cnt = 1, m_uci_sc
                if csi2_rem < m_uci_sc * bpr:
                    csi2_d = (m_uci_sc * bpr) // csi2_rem
                    csi2_cnt = -(-csi2_rem // bpr)
                m_uci_sc -= csi2_cnt

        m_rvd += rvd_cnt * bpr
        m_ack += ack_cnt * bpr
        m_csi1 += csi1_cnt * bpr
        m_csi2 += csi2_cnt * bpr

        i_ack = i_csi1 = i_csi2 = 0
        for i_sc in range(m_ulsch_sc):
            is_reserved = rvd_cnt != 0 and (i_sc % rvd_d == 0)
            is_zero = False
            if is_reserved:
                rvd_cnt -= 1
            if g_ack_rvd:
                if is_reserved and ack_cnt and (i_ack % ack_d == 0):
                    i_ack += 1
                    consume(ack)
                    ack_cnt -= 1
                    is_zero = True
                elif is_reserved:
                    i_ack += 1
            else:
                if ack_cnt and (i_ack % ack_d == 0):
                    i_ack += 1
                    consume(ack)
                    ack_cnt -= 1
                    continue
                i_ack += 1
            if not is_reserved and csi1_cnt and (i_csi1 % csi1_d == 0):
                i_csi1 += 1
                consume(csi1)
                csi1_cnt -= 1
                continue
            if not is_reserved:
                i_csi1 += 1
            if csi2_cnt and (i_csi2 % csi2_d == 0):
                i_csi2 += 1
                if is_zero:
                    puncture(csi2)
                else:
                    consume(csi2)
                csi2_cnt -= 1
                continue
            i_csi2 += 1
            if is_zero:
                puncture(sch)
            else:
                consume(sch)

    if not (m_ack == g_ack and m_csi1 == g_csi1 and m_csi2 == g_csi2):
        raise ValueError("UCI field lengths do not fit the allocation")
    return {
        "sch": np.asarray(sch, dtype=np.int32),
        "ack": np.asarray(ack, dtype=np.int32),
        "csi1": np.asarray(csi1, dtype=np.int32),
        "csi2": np.asarray(csi2, dtype=np.int32),
        "total_bits": pos,
    }


@functools.lru_cache(maxsize=256)
def _mux_perm_cached(key: tuple) -> np.ndarray:
    maps = demux_positions(*key)
    total = maps["total_bits"]
    perm = np.empty(total, dtype=np.int32)
    off = 0
    for field in ("sch", "ack", "csi1", "csi2"):
        idx = maps[field]
        real = idx >= 0
        perm[idx[real]] = off + np.flatnonzero(real).astype(np.int32)
        off += len(idx)
    return perm


@functools.lru_cache(maxsize=64)
def _mux_perm_on(key: tuple, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_mux_perm_cached(key).astype(np.int64)).to(device)


@functools.lru_cache(maxsize=64)
def _demux_index_on(key: tuple, device: torch.device) -> tuple:
    """Per field, the gather index into [llr ‖ 0] (punctured → the 0)."""
    maps = demux_positions(*key)
    total = maps["total_bits"]
    return tuple(
        torch.from_numpy(np.where(maps[f] < 0, total, maps[f])
                         .astype(np.int64)).to(device)
        for f in ("sch", "ack", "csi1", "csi2"))


def multiplex(sch_bits: torch.Tensor, ack_bits: torch.Tensor,
              csi1_bits: torch.Tensor, csi2_bits: torch.Tensor,
              maps_key: tuple) -> torch.Tensor:
    """TX: interleave encoded field streams [B, n_field] into the codeword
    stream [B, G_total] — one inverse-permutation gather; punctured field
    bits are dropped (their stream positions belong to the ACK field)."""
    src = torch.cat([sch_bits, ack_bits, csi1_bits, csi2_bits], dim=-1)
    return src[..., _mux_perm_on(maps_key, src.device)]


def demultiplex(llr: torch.Tensor, maps_key: tuple
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """RX: split descrambled codeword LLRs [B, G_total] into per-field LLR
    streams (sch, ack, csi1, csi2) — four gathers; punctured positions read
    LLR 0.  Takes ``ShConfig.uci_maps_key`` (the JAX function takes the
    tables themselves) so the device index stays cached."""
    pad = torch.cat([llr, llr.new_zeros((*llr.shape[:-1], 1))], dim=-1)
    return tuple(pad[..., idx]
                 for idx in _demux_index_on(maps_key, llr.device))


# ---------------------------------------------------------------------------
# UCI field encode/decode (encoded-bit domain, scrambling by the caller)

def encode_uci_field(bits: torch.Tensor, o_bits: int, g: int,
                     qm: int) -> torch.Tensor:
    """Encode [B, O] UCI bits, O <= 11, to [B, G] encoded bits (§5.3.3 +
    §5.4.3)."""
    bits = bits.to(torch.int8)
    x = bits.new_ones((bits.shape[0], max(qm - 2, 0)))
    if o_bits == 1:
        b0 = bits[:, 0:1]
        block = torch.cat([b0, b0, x], dim=-1) if qm >= 2 else b0
    elif o_bits == 2:
        b0, b1 = bits[:, 0:1], bits[:, 1:2]
        b2 = b0 ^ b1
        block = torch.cat([b0, b1, x, b2, b0, x, b1, b2, x], dim=-1)
    else:
        return short_block.encode(bits, g, qm)
    reps = -(-g // block.shape[-1])
    return torch.cat([block] * reps, dim=-1)[:, :g]


@functools.lru_cache(maxsize=8)
def _two_bit_tables(device: torch.device):
    cands = np.array([[0, 0, 0], [0, 1, 1], [1, 0, 1], [1, 1, 0]], np.float32)
    return (torch.from_numpy(1.0 - 2.0 * cands).to(device),
            torch.from_numpy(cands[:, :2].astype(np.int8)).to(device))


def decode_uci_field(llr: torch.Tensor, o_bits: int, qm: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode O <= 11 UCI bits from field LLRs [B, G].

    Returns (bits [B, O] int8, valid [B] bool) — short-block ML for 3..11
    bits, repetition fold for 1-2 bits.
    """
    g = llr.shape[-1]
    bsz = llr.shape[0]
    if o_bits >= 3:
        bits, metric = short_block.detect(llr, o_bits, g)
        return bits, metric > 0.25
    qm_eff = max(qm, 1)
    if o_bits == 1:
        n = (g // qm_eff) * qm_eff
        folded = llr[:, :n].reshape(bsz, -1, qm_eff)[..., 0].sum(dim=-1)
        return (folded <= 0).to(torch.int8)[:, None], folded.abs() > 0
    # o_bits == 2: blocks of 3 modulation symbols [c0 c1|c2 c0|c1 c2]
    blk = 3 * qm_eff
    n = (g // blk) * blk
    trip = llr[:, :n].reshape(bsz, -1, 3, qm_eff)[..., :2]   # [B, reps, 3, 2]
    l0 = trip[:, :, 0, 0].sum(dim=-1) + trip[:, :, 1, 1].sum(dim=-1)
    l1 = trip[:, :, 0, 1].sum(dim=-1) + trip[:, :, 2, 0].sum(dim=-1)
    l2 = trip[:, :, 1, 0].sum(dim=-1) + trip[:, :, 2, 1].sum(dim=-1)
    sgn, cand_bits = _two_bit_tables(llr.device)
    scores = (torch.stack([l0, l1, l2], dim=-1)[:, None, :] * sgn).sum(dim=-1)
    best = torch.argmax(scores, dim=-1)
    return cand_bits[best], scores.amax(dim=-1) > 0
