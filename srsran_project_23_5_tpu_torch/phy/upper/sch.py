"""Shared-channel processors: PDSCH transmit and PUSCH receive.

Counterpart of ``srsran_project_23_5_tpu/phy/upper/sch.py`` for single-layer
allocations without UCI, reserved RE patterns, VRB interleaving or time
interpolation (``convert.from_jax_sh`` refuses those).  Every function works
on a leading slot batch B:

- PDSCH TX: segmentation + CRC → LDPC encode (CUDA kernel on the card) →
  rate match → scramble → QAM → RE map with DM-RS, onto [B, 14, nsc] grids;
- PUSCH RX: DM-RS estimate → ZF → soft demap → descramble → dematch → LDPC
  decode (CUDA kernel on the card) → CRC, from [B, nrx, 14, nsc] grids.

The encode of all B·C codeblocks of a batch is one kernel launch, and so is
the decode.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...ops import dmrs, equalizer, estimator, gold, modulation
from ...ops.ldpc import decoder_cuda, encoder_cuda, rate_match, segmentation
from ...ran import ldpc_params
from ...ran.constants import LLR_MAX, NRE


@dataclasses.dataclass(frozen=True)
class ShConfig:
    """Static configuration of one single-layer PDSCH/PUSCH allocation
    (DM-RS type 1, CDM group 0)."""
    rnti: int
    tbs: int                     # transport block size (bits)
    qm: int                      # modulation order (2/4/6/8)
    rv: int = 0
    prb_start: int = 0
    nof_prb: int = 106
    first_symbol: int = 0
    nof_symbols: int = 14
    dmrs_symbols: tuple[int, ...] = (2, 7, 11)
    dmrs_cdm_groups_without_data: int = 2
    nid: int = 1                 # scrambling identity
    nid_dmrs: int = 1
    n_scid: int = 0
    slot_in_frame: int = 0

    @functools.cached_property
    def symbol_plan(self) -> list[tuple[int, str]]:
        """(symbol, kind) in mapping order; kind ∈ {full, comb_data, dmrs}."""
        plan = []
        for l in range(self.first_symbol, self.first_symbol + self.nof_symbols):
            if l in self.dmrs_symbols:
                kind = ("comb_data" if self.dmrs_cdm_groups_without_data < 2
                        else "dmrs")
            else:
                kind = "full"
            plan.append((l, kind))
        return plan

    @functools.cached_property
    def nof_data_re(self) -> int:
        width = self.nof_prb * NRE
        per_kind = {"full": width, "comb_data": width // 2, "dmrs": 0}
        return sum(per_kind[kind] for _, kind in self.symbol_plan)

    @functools.cached_property
    def nof_bits(self) -> int:
        return self.nof_data_re * self.qm

    @functools.cached_property
    def code_rate(self) -> float:
        return self.tbs / self.nof_bits

    @functools.cached_property
    def segments(self) -> ldpc_params.SegmentParams:
        bg = ldpc_params.base_graph(self.tbs, self.code_rate)
        return ldpc_params.segment_tb(self.tbs, bg)

    @functools.cached_property
    def cb_lengths(self) -> list[int]:
        return ldpc_params.rate_match_lengths(
            self.nof_bits, self.segments.nof_segments, self.qm, 1)

    @property
    def scrambling_cinit(self) -> int:
        return ((self.rnti << 15) + self.nid) % (1 << 31)

    def dmrs_cinit(self, symbol: int) -> int:
        return dmrs.dmrs_cinit(self.slot_in_frame, symbol, self.nid_dmrs,
                               self.n_scid)

    @property
    def sc_bounds(self) -> tuple[int, int]:
        return self.prb_start * NRE, (self.prb_start + self.nof_prb) * NRE

    def rate_match_key(self) -> tuple:
        seg = self.segments
        return (seg.base_graph, seg.lifting_size, self.rv, seg.payload_length,
                seg.segment_length, tuple(self.cb_lengths), self.qm)


@functools.lru_cache(maxsize=256)
def _scramble_seq(cinit: int, nof_bits: int, device: torch.device):
    """Host-baked scrambling sequence (pure configuration): (int8 {0,1} bits,
    float32 ±1 LLR sign) on `device`."""
    seq = gold.gold_sequence_np(cinit, nof_bits).astype(np.int8)
    sign = 1.0 - 2.0 * seq.astype(np.float32)
    return (torch.from_numpy(seq).to(device),
            torch.from_numpy(sign).to(device))


def _dmrs_pilots(cfg: ShConfig, device: torch.device) -> torch.Tensor:
    """[ndmrs_sym, 6*nof_prb] pilot values (DM-RS port 0)."""
    return dmrs.pilot_values(tuple(cfg.dmrs_cinit(l) for l in cfg.dmrs_symbols),
                             cfg.prb_start, cfg.nof_prb, device)


def _encode_sch(tb_bits: torch.Tensor, cfg: ShConfig) -> torch.Tensor:
    """TB bits [B, A] → rate-matched codeword bits [B, G]."""
    seg = cfg.segments
    cbs = segmentation.segment_tx(tb_bits, seg)                   # [B, C, K]
    bsz, c, k = cbs.shape
    cw = encoder_cuda.encode(cbs.reshape(bsz * c, k).contiguous(),
                             seg.base_graph, seg.lifting_size)
    return rate_match.match_tb(cw.reshape(bsz, c, -1), *cfg.rate_match_key())


def map_res(syms: torch.Tensor, cfg: ShConfig, grid: torch.Tensor,
            pilots: torch.Tensor) -> torch.Tensor:
    """Slice-based RE mapping of [B, n_re] symbols onto [B, 14, nsc] grids:
    each symbol of the contiguous allocation is one row write; DM-RS
    symbols interleave the comb-2 pilots with data (CDM 1) or zeros
    (CDM 2)."""
    lo, hi = cfg.sc_bounds
    width = hi - lo
    out = grid.clone()
    dmrs_i = {l: i for i, l in enumerate(cfg.dmrs_symbols)}
    pos = 0
    for l, kind in cfg.symbol_plan:
        if kind == "full":
            row = syms[:, pos:pos + width]
            pos += width
        else:
            pil = pilots[dmrs_i[l]].expand(syms.shape[0], -1)
            if kind == "comb_data":
                other = syms[:, pos:pos + width // 2]
                pos += width // 2
            else:
                other = torch.zeros_like(pil)
            row = torch.stack([pil, other], dim=-1).reshape(-1, width)
        out[:, l, lo:hi] = row
    return out


def pdsch_transmit(tb_bits: torch.Tensor, cfg: ShConfig,
                   grid: torch.Tensor) -> torch.Tensor:
    """Process [B, A] transport blocks onto [B, 14, nsc] grids."""
    codeword = _encode_sch(tb_bits, cfg)
    seq, _ = _scramble_seq(cfg.scrambling_cinit, cfg.nof_bits, grid.device)
    syms = modulation.modulate(codeword ^ seq, cfg.qm)            # [B, n_re]
    return map_res(syms, cfg, grid, _dmrs_pilots(cfg, grid.device))


@dataclasses.dataclass
class PuschDemod:
    """Output of the PUSCH front half (pre-LDPC), per slot of the batch."""
    llr_full: torch.Tensor         # [B, C, N_full*Zc]
    noise_var: torch.Tensor        # [B]
    rsrp: torch.Tensor             # [B]
    evm: torch.Tensor              # [B]
    post_noise_var: torch.Tensor   # [B] mean post-equalisation noise var
    ta_norm: torch.Tensor          # [B]


@dataclasses.dataclass
class PuschResult:
    tb_bits: torch.Tensor          # [B, A] int8
    tb_crc_ok: torch.Tensor        # [B] bool
    cb_crc_ok: torch.Tensor        # [B, C] bool
    noise_var: torch.Tensor
    rsrp: torch.Tensor
    sinr_db: torch.Tensor          # [B]
    evm: torch.Tensor | None = None
    ta_norm: torch.Tensor | None = None


@functools.lru_cache(maxsize=None)
def _evm_levels(qm: int, device: torch.device) -> torch.Tensor:
    levels = (modulation.pam_levels(qm) if qm > 2
              else np.array([1, -1], np.float32) / np.sqrt(2.0))
    return torch.from_numpy(levels.astype(np.float32)).to(device)


def evm_calculate(x_hat: torch.Tensor, qm: int) -> torch.Tensor:
    """RMS error-vector magnitude of [..., n] symbols against the nearest
    constellation point → [...]."""
    levels = _evm_levels(qm, x_hat.device)

    def nearest(axis_vals: torch.Tensor) -> torch.Tensor:
        return levels[(axis_vals[..., None] - levels).abs().argmin(dim=-1)]

    hard = torch.complex(nearest(x_hat.real), nearest(x_hat.imag))
    return ((x_hat - hard).abs() ** 2).mean(dim=-1).sqrt()


def pusch_demodulate(rx_grid: torch.Tensor, cfg: ShConfig) -> PuschDemod:
    """Front half of the PUSCH receiver: [B, nrx, 14, nsc] grids →
    per-codeblock LLRs."""
    lo, hi = cfg.sc_bounds
    tx_pilots = _dmrs_pilots(cfg, rx_grid.device)
    rx_pilots = torch.stack(
        [rx_grid[..., l, lo:hi][..., 0::2] for l in cfg.dmrs_symbols],
        dim=-2)                                           # [B, nrx, ndmrs, npil]
    est = estimator.estimate_comb2(rx_pilots, tx_pilots)

    y_rows, h_rows = [], []
    for l, kind in cfg.symbol_plan:
        row = rx_grid[..., l, lo:hi]
        if kind == "full":
            y_rows.append(row)
            h_rows.append(est.h_alloc)
        elif kind == "comb_data":
            y_rows.append(row[..., 1::2])
            h_rows.append(est.h_alloc[..., 1::2])
    y = torch.cat(y_rows, dim=-1)                          # [B, nrx, n_re]
    h = torch.cat(h_rows, dim=-1)
    noise_var = torch.clamp(est.noise_var.mean(dim=-1), min=1e-9)   # [B]
    x_hat, post_nv = equalizer.zf_1xn(y, h, noise_var)     # [B, n_re]

    _, sign = _scramble_seq(cfg.scrambling_cinit, cfg.nof_bits, rx_grid.device)
    llr = modulation.demodulate_soft(x_hat, post_nv, cfg.qm) * sign
    llr = torch.clamp(llr, -float(LLR_MAX), float(LLR_MAX))
    full = rate_match.dematch_tb(llr, *cfg.rate_match_key())
    return PuschDemod(llr_full=full, noise_var=noise_var,
                      rsrp=est.rsrp.mean(dim=-1),
                      evm=evm_calculate(x_hat, cfg.qm),
                      post_noise_var=post_nv.mean(dim=-1),
                      ta_norm=est.ta_norm.mean(dim=-1))


def pusch_decode(llr_full: torch.Tensor, cfg: ShConfig,
                 noise_var: torch.Tensor, rsrp: torch.Tensor,
                 nof_ldpc_iterations: int = 6,
                 demod: PuschDemod | None = None) -> PuschResult:
    """Back half: [B, C, N] LLRs → decoded TBs + CRC + SINR.  All B·C
    codeblocks go to the decoder in one call."""
    seg = cfg.segments
    # rv=0 circular-buffer reads are contiguous: truncate the decoding graph
    # to the transmitted span (exact); other rvs decode the full graph.
    n_used = (decoder_cuda.used_blocks(seg.base_graph, seg.lifting_size,
                                       max(cfg.cb_lengths))
              if cfg.rv == 0 else None)
    bsz, c, n = llr_full.shape
    bits, ok = decoder_cuda.decode(
        llr_full.reshape(bsz * c, n), seg.base_graph, seg.lifting_size,
        nof_iterations=nof_ldpc_iterations, nof_used_blocks=n_used)
    return pusch_finish(bits.reshape(bsz, c, -1), ok.reshape(bsz, c), cfg,
                        noise_var, rsrp, demod)


def pusch_finish(bits: torch.Tensor, ok: torch.Tensor, cfg: ShConfig,
                 noise_var: torch.Tensor, rsrp: torch.Tensor,
                 demod: PuschDemod | None = None) -> PuschResult:
    """Decoded codeblock bits [B, C, K] → PuschResult (desegment + CRC +
    SINR).  Unit symbol energy ⇒ SINR = 1/mean post-equalisation noise
    variance; rsrp/noise_var without a demod."""
    tb, tb_ok, cb_ok = segmentation.desegment_rx(bits, cfg.segments)
    tb_ok = tb_ok & ok.all(dim=-1)
    if demod is not None:
        sinr = 1.0 / torch.clamp(demod.post_noise_var, min=1e-12)
    else:
        sinr = rsrp / noise_var
    return PuschResult(
        tb_bits=tb, tb_crc_ok=tb_ok, cb_crc_ok=cb_ok & ok,
        noise_var=noise_var, rsrp=rsrp,
        sinr_db=10.0 * torch.log10(torch.clamp(sinr, min=1e-12)),
        evm=demod.evm if demod is not None else None,
        ta_norm=demod.ta_norm if demod is not None else None)


def pusch_receive(rx_grid: torch.Tensor, cfg: ShConfig,
                  nof_ldpc_iterations: int = 6) -> PuschResult:
    """Full PUSCH receiver (single transmission, no HARQ combining)."""
    d = pusch_demodulate(rx_grid, cfg)
    return pusch_decode(d.llr_full, cfg, d.noise_var, d.rsrp,
                        nof_ldpc_iterations, demod=d)
