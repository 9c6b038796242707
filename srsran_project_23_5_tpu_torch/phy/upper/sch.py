"""Shared-channel processors: PDSCH/PUSCH transmit and PUSCH receive.

Counterpart of ``srsran_project_23_5_tpu/phy/upper/sch.py`` for one or two
layers, with reserved RE patterns, without UCI, VRB interleaving or time
interpolation (``convert.from_jax_sh`` refuses those).  Every function works
on a leading slot batch B:

- TX: segmentation + CRC → LDPC encode (CUDA kernel on the card) → rate
  match → scramble → QAM → layer map → RE map with DM-RS, onto [B, 14, nsc]
  (one layer) or [B, port, 14, nsc] grids;
- RX: DM-RS estimate → ZF → soft demap → layer demap → descramble →
  dematch → LDPC decode (CUDA kernel on the card) → CRC, from
  [B, nrx, 14, nsc] grids;
- ``symbol_verify``: the UE-side check of a downlink allocation against the
  known transmitted grid, without decoding.

The encode of all B·C codeblocks of a batch is one kernel launch, and so is
the decode.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...ops import dmrs, equalizer, estimator, gold, modulation, precoding
from ...ops.ldpc import decoder_cuda, encoder_cuda, rate_match, segmentation
from ...ran import ldpc_params
from ...ran.constants import LLR_MAX, NRE

# half the minimum distance of each constellation's axis
HALF_MIN_DISTANCE = {2: 1 / np.sqrt(2), 4: 1 / np.sqrt(10),
                     6: 1 / np.sqrt(42), 8: 1 / np.sqrt(170)}


@dataclasses.dataclass(frozen=True)
class ShConfig:
    """Static configuration of one PDSCH/PUSCH allocation (DM-RS type 1).

    nof_layers 1 or 2; two layers ride DM-RS ports 0/1 of CDM group 0,
    separated by the frequency OCC, and need
    dmrs_cdm_groups_without_data == 2 and ≥ 2 rx ports on receive.
    reserved_patterns: ((symbol, (sc offsets within a PRB, ...)), ...) —
    data mapping skips those REs in every PRB of the allocation.
    """
    rnti: int
    tbs: int                     # transport block size (bits)
    qm: int                      # modulation order (2/4/6/8)
    rv: int = 0
    nof_layers: int = 1
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
    reserved_patterns: tuple = ()

    def __post_init__(self) -> None:
        if self.nof_layers not in (1, 2):
            raise ValueError(f"nof_layers {self.nof_layers} not in (1, 2)")
        if self.nof_layers == 2 and self.dmrs_cdm_groups_without_data < 2:
            raise ValueError("two layers need dmrs_cdm_groups_without_data "
                             "== 2")

    @functools.cached_property
    def symbol_plan(self) -> list[tuple[int, str]]:
        """(symbol, kind) in mapping order; kind ∈ {full, comb_data, dmrs,
        reserved}."""
        resv = dict(self.reserved_patterns)
        plan = []
        for l in range(self.first_symbol, self.first_symbol + self.nof_symbols):
            if l in self.dmrs_symbols:
                kind = ("comb_data" if self.dmrs_cdm_groups_without_data < 2
                        else "dmrs")
            elif l in resv:
                kind = "reserved"
            else:
                kind = "full"
            plan.append((l, kind))
        return plan

    @functools.cached_property
    def reserved_keep_offsets(self) -> dict[int, tuple[int, ...]]:
        """symbol → kept (data) subcarrier offsets within each PRB."""
        return {l: tuple(k for k in range(NRE) if k not in set(offs))
                for l, offs in self.reserved_patterns}

    @functools.cached_property
    def data_re_indices(self) -> tuple[np.ndarray, np.ndarray]:
        """(symbol_idx, sc_idx) arrays of the data REs in mapping order."""
        sc_lo, sc_hi = self.sc_bounds
        syms, scs = [], []
        for l, kind in self.symbol_plan:
            if kind == "dmrs":
                continue
            if kind == "comb_data":
                ks = np.arange(sc_lo + 1, sc_hi, 2)
            elif kind == "reserved":
                keep = np.asarray(self.reserved_keep_offsets[l])
                prbs = np.arange(self.prb_start, self.prb_start + self.nof_prb)
                ks = (prbs[:, None] * NRE + keep[None, :]).reshape(-1)
            else:
                ks = np.arange(sc_lo, sc_hi)
            syms.append(np.full(ks.shape, l, dtype=np.int32))
            scs.append(ks.astype(np.int32))
        return np.concatenate(syms), np.concatenate(scs)

    @functools.cached_property
    def nof_data_re(self) -> int:
        return len(self.data_re_indices[0])

    @functools.cached_property
    def nof_bits(self) -> int:
        return self.nof_data_re * self.qm * self.nof_layers

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
            self.nof_bits, self.segments.nof_segments, self.qm,
            self.nof_layers)

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


def _dmrs_occ(cfg: ShConfig, layer: int) -> np.ndarray:
    """Frequency OCC w_f of DM-RS port `layer` over the pilot index
    (TS 38.211 Table 6.4.1.1.3-1: ports 1000/1002 [+1,+1], 1001/1003
    [+1,-1])."""
    npil = 6 * cfg.nof_prb
    if layer % 2 == 0:
        return np.ones(npil, np.float32)
    return np.where(np.arange(npil) % 2 == 0, 1.0, -1.0).astype(np.float32)


def _dmrs_comb(layer: int) -> int:
    """CDM group (= comb offset) of DM-RS port `layer` (type 1)."""
    return 0 if layer < 2 else 1


@functools.lru_cache(maxsize=64)
def _layer_pilots(cfg: ShConfig, layer: int,
                  device: torch.device) -> torch.Tensor:
    occ = torch.from_numpy(_dmrs_occ(cfg, layer)).to(device)
    return _dmrs_pilots(cfg, device) * occ


def _encode_sch(tb_bits: torch.Tensor, cfg: ShConfig) -> torch.Tensor:
    """TB bits [B, A] → rate-matched codeword bits [B, G]."""
    seg = cfg.segments
    cbs = segmentation.segment_tx(tb_bits, seg)                   # [B, C, K]
    bsz, c, k = cbs.shape
    cw = encoder_cuda.encode(cbs.reshape(bsz * c, k).contiguous(),
                             seg.base_graph, seg.lifting_size)
    return rate_match.match_tb(cw.reshape(bsz, c, -1), *cfg.rate_match_key())


def _keep_resv(x: torch.Tensor, cfg: ShConfig, l: int) -> torch.Tensor:
    """[..., nof_prb*12] → the kept REs of reserved symbol l,
    [..., nof_prb*nk]."""
    keep = cfg.reserved_keep_offsets[l]
    nk = len(keep)
    blk = x.reshape(*x.shape[:-1], cfg.nof_prb, NRE)
    if keep == tuple(range(keep[0], keep[0] + nk)):
        kept = blk[..., keep[0]:keep[0] + nk]
    else:
        kept = blk[..., list(keep)]
    return kept.reshape(*x.shape[:-1], cfg.nof_prb * nk)


def map_res(syms: torch.Tensor, cfg: ShConfig, grid: torch.Tensor,
            pilots: torch.Tensor, pilot_comb: int = 0) -> torch.Tensor:
    """Slice-based RE mapping of [B, n_re] symbols onto [B, ..., 14, nsc]
    grids: each symbol of the contiguous allocation is one row write (set,
    not add); DM-RS symbols interleave the comb-2 pilots with data (CDM 1)
    or zeros (CDM 2, pilots on comb `pilot_comb`); reserved symbols leave
    their reserved offsets at zero."""
    lo, hi = cfg.sc_bounds
    width = hi - lo
    bsz = syms.shape[0]
    out = grid.clone()
    lead = (bsz,) + (1,) * (out.dim() - 3)
    dmrs_i = {l: i for i, l in enumerate(cfg.dmrs_symbols)}
    pos = 0
    for l, kind in cfg.symbol_plan:
        if kind == "full":
            row = syms[:, pos:pos + width]
            pos += width
        elif kind == "reserved":
            keep = cfg.reserved_keep_offsets[l]
            nk = len(keep)
            chunk = syms[:, pos:pos + cfg.nof_prb * nk].reshape(
                bsz, cfg.nof_prb, nk)
            pos += cfg.nof_prb * nk
            block = syms.new_zeros((bsz, cfg.nof_prb, NRE))
            if keep == tuple(range(keep[0], keep[0] + nk)):
                block[..., keep[0]:keep[0] + nk] = chunk
            else:
                block[..., list(keep)] = chunk
            row = block.reshape(bsz, width)
        else:
            pil = pilots[dmrs_i[l]].expand(bsz, -1)
            if kind == "comb_data":
                pair = [pil, syms[:, pos:pos + width // 2]]
                pos += width // 2
            elif pilot_comb:
                pair = [torch.zeros_like(pil), pil]
            else:
                pair = [pil, torch.zeros_like(pil)]
            row = torch.stack(pair, dim=-1).reshape(bsz, width)
        out[..., l, lo:hi] = row.reshape(*lead, width)
    return out


def _scramble_modulate_map(codeword: torch.Tensor, cfg: ShConfig,
                           grid: torch.Tensor) -> torch.Tensor:
    """Scramble, modulate and map [B, G] codeword bits.  One layer maps onto
    a [B, 14, nsc] grid; two layers onto a [B, port, 14, nsc] grid: layer
    map, per-layer RE mapping with the OCC'd DM-RS, then the layer planes
    are added onto the ports (directly when the ports are the layers, else
    through the identity precoder)."""
    seq, _ = _scramble_seq(cfg.scrambling_cinit, cfg.nof_bits, grid.device)
    syms = modulation.modulate(codeword ^ seq, cfg.qm)            # [B, n_re]
    if cfg.nof_layers == 1:
        return map_res(syms, cfg, grid, _dmrs_pilots(cfg, grid.device))
    if grid.dim() != 4:
        raise ValueError("multi-layer transmit needs a [B, port, 14, nsc] "
                         f"grid, got {tuple(grid.shape)}")
    bsz, nports = grid.shape[:2]
    lay = precoding.layer_map(syms, cfg.nof_layers)               # [B, L, n]
    zeros = grid.new_zeros((bsz, *grid.shape[2:]))
    layer_grids = torch.stack(
        [map_res(lay[:, l], cfg, zeros, _layer_pilots(cfg, l, grid.device),
                 pilot_comb=_dmrs_comb(l))
         for l in range(cfg.nof_layers)], dim=1)           # [B, L, 14, nsc]
    if nports == cfg.nof_layers:
        return grid + layer_grids
    w = precoding.identity_precoder(nports, cfg.nof_layers)
    return grid + precoding.apply_precoding(
        layer_grids.reshape(bsz, cfg.nof_layers, -1), w).reshape(grid.shape)


def pdsch_transmit(tb_bits: torch.Tensor, cfg: ShConfig,
                   grid: torch.Tensor) -> torch.Tensor:
    """Process [B, A] transport blocks onto [B, 14, nsc] grids (one layer)
    or [B, port, 14, nsc] grids."""
    return _scramble_modulate_map(_encode_sch(tb_bits, cfg), cfg, grid)


def pusch_transmit(tb_bits: torch.Tensor, cfg: ShConfig,
                   grid: torch.Tensor) -> torch.Tensor:
    """UL-SCH transmit without UCI (the UE side of a loopback)."""
    return _scramble_modulate_map(_encode_sch(tb_bits, cfg), cfg, grid)


@dataclasses.dataclass
class PuschDemod:
    """Output of the PUSCH front half (pre-LDPC), per slot of the batch."""
    llr_full: torch.Tensor         # [B, C, N_full*Zc]
    noise_var: torch.Tensor        # [B]
    rsrp: torch.Tensor             # [B]
    evm: torch.Tensor              # [B]
    post_noise_var: torch.Tensor   # [B] mean post-equalisation noise var
    ta_norm: torch.Tensor | None = None   # [B] (single layer only)
    sch_llr: torch.Tensor | None = None   # [B, G] descrambled, pre-dematch


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


def _data_rows(grid: torch.Tensor, cfg: ShConfig,
               h: torch.Tensor | None = None):
    """Data REs of the allocation in mapping order: grid [..., 14, nsc] →
    y [..., n_re]; with a channel h [..., w] over the allocation also the
    channel at those REs."""
    lo, hi = cfg.sc_bounds
    ys, hs = [], []
    for l, kind in cfg.symbol_plan:
        row = grid[..., l, lo:hi]
        if kind == "full":
            ys.append(row)
            hs.append(h)
        elif kind == "reserved":
            ys.append(_keep_resv(row, cfg, l))
            hs.append(None if h is None else _keep_resv(h, cfg, l))
        elif kind == "comb_data":
            ys.append(row[..., 1::2])
            hs.append(None if h is None else h[..., 1::2])
    y = torch.cat(ys, dim=-1)
    return y if h is None else (y, torch.cat(hs, dim=-1))


def _rx_pilots(rx_grid: torch.Tensor, cfg: ShConfig) -> torch.Tensor:
    lo, hi = cfg.sc_bounds
    return torch.stack([rx_grid[..., l, lo:hi][..., 0::2]
                        for l in cfg.dmrs_symbols], dim=-2)


def _equalize(rx_grid: torch.Tensor, cfg: ShConfig):
    """Estimate and equalise the allocation of [B, nrx, 14, nsc] grids →
    (estimate, x_hat [B, (L,) n_re], post noise var, like x_hat)."""
    tx_pilots = _dmrs_pilots(cfg, rx_grid.device)
    rx_pilots = _rx_pilots(rx_grid, cfg)                  # [B, nrx, ndmrs, np]
    if cfg.nof_layers == 2:
        est = estimator.estimate_comb2_occ2(rx_pilots, tx_pilots)
        eq = equalizer.zf_nx2
    else:
        est = estimator.estimate_comb2(rx_pilots, tx_pilots)
        eq = equalizer.zf_1xn
    y, h = _data_rows(rx_grid, cfg, est.h_alloc)
    noise_var = torch.clamp(est.noise_var.mean(dim=-1), min=1e-9)   # [B]
    x_hat, post_nv = eq(y, h, noise_var)
    return est, x_hat, post_nv


def symbol_check(demod: PuschDemod, codeword: torch.Tensor) -> torch.Tensor:
    """Fraction [B] of codeword bits whose hard LLR decision matches."""
    hard = (demod.sch_llr < 0).to(torch.int8)
    return (hard == codeword.to(torch.int8)).to(torch.float32).mean(dim=-1)


def symbol_verify(rx_grid: torch.Tensor, tx_grid: torch.Tensor,
                  cfg: ShConfig) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """UE-side symbol-domain check of a downlink allocation against the
    known transmitted grid: estimate and equalise as ``pusch_demodulate``
    does, then count the equalised data symbols whose per-axis deviation
    from the transmitted point is under half the minimum distance.

    rx_grid: [B, nrx, 14, nsc] (or [B, 14, nsc]); tx_grid: [B, port, 14,
    nsc] or [B, 14, nsc], ports carrying the layers (identity mapping).
    Returns (symbol match fraction, EVM against the reference, mean post
    noise variance), each [B].
    """
    if rx_grid.dim() == 3:
        rx_grid = rx_grid[:, None]
    if tx_grid.dim() == 3:
        tx_grid = tx_grid[:, None]
    _, x_hat, nv = _equalize(rx_grid, cfg)
    if cfg.nof_layers == 2:
        x_ref = _data_rows(tx_grid[:, :2], cfg)                 # [B, 2, n]
    else:
        x_ref = _data_rows(tx_grid[:, :1], cfg)[:, 0]
    half_d = float(HALF_MIN_DISTANCE[cfg.qm])
    d = x_hat - x_ref
    hit = (d.real.abs() < half_d) & (d.imag.abs() < half_d)
    dims = tuple(range(1, d.dim()))
    return (hit.to(torch.float32).mean(dim=dims),
            (d.abs() ** 2).mean(dim=dims).sqrt(), nv.mean(dim=dims))


def pusch_demodulate(rx_grid: torch.Tensor, cfg: ShConfig) -> PuschDemod:
    """Front half of the PUSCH receiver: [B, nrx, 14, nsc] grids →
    per-codeblock LLRs."""
    est, x_hat, post_nv = _equalize(rx_grid, cfg)
    _, sign = _scramble_seq(cfg.scrambling_cinit, cfg.nof_bits, rx_grid.device)
    llr = modulation.demodulate_soft(x_hat, post_nv, cfg.qm)
    if cfg.nof_layers == 2:
        llr = precoding.layer_demap_llr(llr, cfg.qm)             # [B, G]
        evm = evm_calculate(x_hat.flatten(-2), cfg.qm)
        ta_norm = None
    else:
        evm = evm_calculate(x_hat, cfg.qm)
        ta_norm = est.ta_norm.mean(dim=-1)
    llr = torch.clamp(llr * sign, -float(LLR_MAX), float(LLR_MAX))
    full = rate_match.dematch_tb(llr, *cfg.rate_match_key())
    return PuschDemod(llr_full=full,
                      noise_var=torch.clamp(est.noise_var.mean(dim=-1),
                                            min=1e-9),
                      rsrp=est.rsrp.mean(dim=-1), evm=evm,
                      post_noise_var=post_nv.flatten(1).mean(dim=-1),
                      ta_norm=ta_norm, sch_llr=llr)


def pusch_decode(llr_full: torch.Tensor, cfg: ShConfig,
                 noise_var: torch.Tensor, rsrp: torch.Tensor,
                 nof_ldpc_iterations: int = 6,
                 demod: PuschDemod | None = None) -> PuschResult:
    """Back half: [B, C, N] LLRs → decoded TBs + CRC + SINR.  All B·C
    codeblocks go to the decoder in one call."""
    bits, ok = decode_cbs(llr_full, cfg, nof_ldpc_iterations)
    return pusch_finish(bits, ok, cfg, noise_var, rsrp, demod)


def decode_cbs(llr_full: torch.Tensor, cfg: ShConfig,
               nof_ldpc_iterations: int = 6
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, C, N] LLRs → (bits [B, C, K], ok [B, C]) in one decoder call.
    rv=0 circular-buffer reads are contiguous, so the decoding graph is
    truncated to the transmitted span (exact); other rvs decode the full
    graph."""
    seg = cfg.segments
    n_used = (decoder_cuda.used_blocks(seg.base_graph, seg.lifting_size,
                                       max(cfg.cb_lengths))
              if cfg.rv == 0 else None)
    bsz, c, n = llr_full.shape
    bits, ok = decoder_cuda.decode(
        llr_full.reshape(bsz * c, n), seg.base_graph, seg.lifting_size,
        nof_iterations=nof_ldpc_iterations, nof_used_blocks=n_used)
    return bits.reshape(bsz, c, -1), ok.reshape(bsz, c)


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
