"""Shared-channel processors: PDSCH/PUSCH transmit and PUSCH receive.

Counterpart of ``srsran_project_23_5_tpu/phy/upper/sch.py``: one, two or
four layers, reserved RE patterns, UCI multiplexed on PUSCH, interleaved
VRB-to-PRB mapping and per-symbol time interpolation.  Every function works
on a leading slot batch B:

- TX: segmentation + CRC → LDPC encode (CUDA kernel on the card) → rate
  match → UCI multiplex → scramble → QAM → layer map → RE map with DM-RS
  (→ VRB-to-PRB interleave), onto [B, 14, nsc] (one layer) or
  [B, port, 14, nsc] grids;
- RX: (PRB-to-VRB gather →) DM-RS estimate → ZF → soft demap → layer demap
  → descramble → UCI demultiplex → dematch → LDPC decode (CUDA kernel on the
  card) → CRC and UCI decode, from [B, nrx, 14, nsc] grids;
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
from ...ran import ldpc_params, vrb_prb
from ...ran.constants import NRE
from ...utils.tracing import tracer
from . import ulsch

# half the minimum distance of each constellation's axis
HALF_MIN_DISTANCE = {2: 1 / np.sqrt(2), 4: 1 / np.sqrt(10),
                     6: 1 / np.sqrt(42), 8: 1 / np.sqrt(170)}


@dataclasses.dataclass(frozen=True)
class ShConfig:
    """Static configuration of one PDSCH/PUSCH allocation (DM-RS type 1).

    nof_layers 1, 2 or 4; layers 0/1 ride DM-RS ports 0/1 of CDM group 0
    (even comb), layers 2/3 ports 2/3 of CDM group 1 (odd comb), the two
    ports of a group separated by the frequency OCC; several layers need
    dmrs_cdm_groups_without_data == 2 and as many rx ports on receive.
    time_interp: per-symbol linear interpolation of the channel between the
    DM-RS symbols (else their average).
    vrb_to_prb_interleaved: TS 38.211 §7.3.1.6 bundle-2 interleaving over
    the BWP [0, bwp_nof_prb) (0 ⇒ prb_start + nof_prb).
    reserved_patterns: ((symbol, (sc offsets within a PRB, ...)), ...) —
    data mapping skips those REs in every PRB of the allocation.
    uci: UCI multiplexed on the PUSCH (empty for PDSCH).
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
    time_interp: bool = False
    vrb_to_prb_interleaved: bool = False
    bwp_nof_prb: int = 0
    reserved_patterns: tuple = ()
    uci: ulsch.UciOnPusch = ulsch.UciOnPusch()

    def __post_init__(self) -> None:
        if self.nof_layers not in (1, 2, 4):
            raise ValueError(f"nof_layers {self.nof_layers} not in (1, 2, 4)")
        if self.nof_layers > 1 and self.dmrs_cdm_groups_without_data < 2:
            raise ValueError(f"{self.nof_layers} layers need "
                             "dmrs_cdm_groups_without_data == 2")

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
    def uci_maps_key(self) -> tuple:
        u = self.uci
        return (self.nof_prb, self.qm, self.nof_layers, self.first_symbol,
                self.nof_symbols, self.dmrs_symbols,
                self.dmrs_cdm_groups_without_data, u.g_harq_ack,
                u.g_csi_part1, u.g_csi_part2, u.g_harq_ack_rvd)

    @functools.cached_property
    def uci_maps(self) -> dict:
        return ulsch.demux_positions(*self.uci_maps_key)

    @functools.cached_property
    def g_sch(self) -> int:
        """UL-SCH rate-matched length after UCI multiplexing (= nof_bits
        without UCI; includes the reserved/punctured bits)."""
        if not self.uci.any:
            return self.nof_bits
        return len(self.uci_maps["sch"])

    @functools.cached_property
    def cb_lengths(self) -> list[int]:
        return ldpc_params.rate_match_lengths(
            self.g_sch, self.segments.nof_segments, self.qm, self.nof_layers)

    @property
    def scrambling_cinit(self) -> int:
        return ((self.rnti << 15) + self.nid) % (1 << 31)

    @functools.cached_property
    def dmrs_sc_indices(self) -> np.ndarray:
        return dmrs.type1_sc_indices(self.prb_start, self.nof_prb, delta=0)

    def dmrs_cinit(self, symbol: int) -> int:
        return dmrs.dmrs_cinit(self.slot_in_frame, symbol, self.nid_dmrs,
                               self.n_scid)

    @property
    def sc_bounds(self) -> tuple[int, int]:
        return self.prb_start * NRE, (self.prb_start + self.nof_prb) * NRE

    @functools.cached_property
    def vrb_sc_maps(self) -> tuple[np.ndarray, np.ndarray]:
        """(fwd_sc, inv_sc): phys[fwd_sc[v]] = virt[v]; virt = phys[fwd_sc]
        gathers the receiver back to virtual (contiguous) order."""
        n_bwp = self.bwp_nof_prb or (self.prb_start + self.nof_prb)
        prb_map = vrb_prb.interleaved_vrb_to_prb(n_bwp, 2)
        fwd = (prb_map[:, None] * NRE + np.arange(NRE)[None, :]
               ).reshape(-1).astype(np.int32)
        inv = np.empty_like(fwd)
        inv[fwd] = np.arange(len(fwd), dtype=np.int32)
        return fwd, inv

    @functools.cached_property
    def time_weights(self) -> list[tuple[int, int, float]]:
        """Per-symbol (d0, d1, w1) linear time-interpolation coefficients
        between bracketing DM-RS symbols: h(l) = (1-w1)·h_dmrs[d0] +
        w1·h_dmrs[d1], clamped at the slot edges."""
        ds = self.dmrs_symbols
        out = []
        for l in range(self.first_symbol,
                       self.first_symbol + self.nof_symbols):
            if l <= ds[0] or len(ds) == 1:
                out.append((0, 0, 0.0))
            elif l >= ds[-1]:
                out.append((len(ds) - 1, len(ds) - 1, 0.0))
            else:
                i = max(j for j in range(len(ds)) if ds[j] <= l)
                w1 = (l - ds[i]) / (ds[i + 1] - ds[i])
                out.append((i, i + 1, float(w1)))
        return out

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
def _occ_on(cfg: ShConfig, layer: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_dmrs_occ(cfg, layer)).to(device)


@functools.lru_cache(maxsize=64)
def _vrb_index_on(cfg: ShConfig, which: int,
                  device: torch.device) -> torch.Tensor:
    """vrb_sc_maps[which] (0: fwd, 1: inv) as an int64 index on `device`."""
    return torch.from_numpy(cfg.vrb_sc_maps[which].astype(np.int64)).to(device)


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
            pilots: torch.Tensor | None = None,
            pilot_comb: int = 0) -> torch.Tensor:
    """Slice-based RE mapping of [B, n_re] symbols onto [B, ..., 14, nsc]
    grids: each symbol of the contiguous allocation is one row write (set,
    not add); DM-RS symbols interleave the comb-2 pilots ([ndmrs, w/2],
    default the config's own) with data (CDM 1) or zeros (CDM 2, pilots on
    comb `pilot_comb`); reserved symbols leave their reserved offsets at
    zero.  With VRB-to-PRB interleaving the virtual row is permuted onto the
    BWP's physical subcarriers and ADDED to the grid, as in the JAX
    package."""
    lo, hi = cfg.sc_bounds
    width = hi - lo
    bsz = syms.shape[0]
    if pilots is None:
        pilots = _dmrs_pilots(cfg, syms.device)
    out = grid.clone()
    lead = (bsz,) + (1,) * (out.dim() - 3)
    dmrs_i = {l: i for i, l in enumerate(cfg.dmrs_symbols)}
    if cfg.vrb_to_prb_interleaved:
        inv = _vrb_index_on(cfg, 1, syms.device)
        n_bwp_sc = inv.shape[0]
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
        if cfg.vrb_to_prb_interleaved:
            virt = row.new_zeros((bsz, n_bwp_sc))
            virt[:, lo:hi] = row
            out[..., l, :n_bwp_sc] += virt[:, inv].reshape(*lead, n_bwp_sc)
        else:
            out[..., l, lo:hi] = row.reshape(*lead, width)
    return out


def _scramble_modulate_map(codeword: torch.Tensor, cfg: ShConfig,
                           grid: torch.Tensor,
                           pilots: torch.Tensor | None = None,
                           w: np.ndarray | None = None) -> torch.Tensor:
    """Scramble, modulate and map [B, G] codeword bits.  One layer maps onto
    a [B, 14, nsc] grid; several layers onto a [B, port, 14, nsc] grid:
    layer map, per-layer RE mapping with the OCC'd DM-RS on the layer's CDM
    group comb, then the layer planes are precoded onto the ports by w
    [port, layer] (without w: added directly when the ports are the layers,
    else through the identity precoder).  A single layer is mapped as it
    is, w or not, as in the JAX function.
    pilots: the port-0 DM-RS [ndmrs, w/2] (default the config's own)."""
    seq, _ = _scramble_seq(cfg.scrambling_cinit, cfg.nof_bits, grid.device)
    syms = modulation.modulate(codeword ^ seq, cfg.qm)            # [B, n_re]
    if pilots is None:
        pilots = _dmrs_pilots(cfg, grid.device)
    if cfg.nof_layers == 1:
        return map_res(syms, cfg, grid, pilots)
    if grid.dim() != 4:
        raise ValueError("multi-layer transmit needs a [B, port, 14, nsc] "
                         f"grid, got {tuple(grid.shape)}")
    bsz, nports = grid.shape[:2]
    lay = precoding.layer_map(syms, cfg.nof_layers)               # [B, L, n]
    zeros = grid.new_zeros((bsz, *grid.shape[2:]))
    layer_grids = torch.stack(
        [map_res(lay[:, l], cfg, zeros, pilots * _occ_on(cfg, l, grid.device),
                 pilot_comb=_dmrs_comb(l))
         for l in range(cfg.nof_layers)], dim=1)           # [B, L, 14, nsc]
    if w is None and nports == cfg.nof_layers:
        return grid + layer_grids
    if w is None:
        w = precoding.identity_precoder(nports, cfg.nof_layers)
    return grid + precoding.apply_precoding(
        layer_grids.reshape(bsz, cfg.nof_layers, -1), w).reshape(grid.shape)


def pdsch_transmit(tb_bits: torch.Tensor, cfg: ShConfig,
                   grid: torch.Tensor,
                   pilots: torch.Tensor | None = None,
                   w: np.ndarray | None = None) -> torch.Tensor:
    """Process [B, A] transport blocks onto [B, 14, nsc] grids (one layer)
    or [B, port, 14, nsc] grids.  pilots: the DM-RS of the slot
    ([ndmrs, 6·nof_prb], ``dmrs.pilot_values``), default the config's own.
    w: a [port, layer] precoding matrix for several layers (default the
    identity layer→port mapping)."""
    return _scramble_modulate_map(_encode_sch(tb_bits, cfg), cfg, grid,
                                  pilots, w)


def pusch_transmit(tb_bits: torch.Tensor, cfg: ShConfig, grid: torch.Tensor,
                   ack_bits: torch.Tensor | None = None,
                   csi1_bits: torch.Tensor | None = None,
                   csi2_bits: torch.Tensor | None = None,
                   pilots: torch.Tensor | None = None) -> torch.Tensor:
    """UL-SCH transmit (the UE side of a loopback) with the UCI fields
    ([B, O] bits each) multiplexed per TS 38.212 §6.2.7 before scrambling."""
    sch_bits = _encode_sch(tb_bits, cfg)
    if not cfg.uci.any:
        return _scramble_modulate_map(sch_bits, cfg, grid, pilots)
    u = cfg.uci
    bsz = sch_bits.shape[0]

    def field(bits, o_bits, name):
        if not o_bits:
            return sch_bits.new_zeros((bsz, 0))
        return ulsch.encode_uci_field(bits, o_bits, len(cfg.uci_maps[name]),
                                      cfg.qm)

    codeword = ulsch.multiplex(
        sch_bits, field(ack_bits, u.nof_harq_ack_bits, "ack"),
        field(csi1_bits, u.nof_csi_part1_bits, "csi1"),
        field(csi2_bits, u.nof_csi_part2_bits, "csi2"), cfg.uci_maps_key)
    return _scramble_modulate_map(codeword, cfg, grid, pilots)


@dataclasses.dataclass
class PuschDemod:
    """Output of the PUSCH front half (pre-LDPC), per slot of the batch."""
    llr_full: torch.Tensor         # [B, C, N_full*Zc]
    noise_var: torch.Tensor        # [B]
    rsrp: torch.Tensor             # [B]
    evm: torch.Tensor              # [B]
    post_noise_var: torch.Tensor   # [B] mean post-equalisation noise var
    ack_llr: torch.Tensor          # [B, G_ack] ([B, 0] without UCI)
    csi1_llr: torch.Tensor
    csi2_llr: torch.Tensor
    ta_norm: torch.Tensor | None = None   # [B] (single layer only)
    sch_llr: torch.Tensor | None = None   # [B, G_sch] descrambled, pre-dematch


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
    # UCI on PUSCH, [B, O] bits and [B] validity (None when not configured)
    ack_bits: torch.Tensor | None = None
    ack_valid: torch.Tensor | None = None
    csi1_bits: torch.Tensor | None = None
    csi1_valid: torch.Tensor | None = None
    csi2_bits: torch.Tensor | None = None
    csi2_valid: torch.Tensor | None = None


#: the JAX package's name for the plain EVM (``pusch_demodulate`` takes the
#: EVM from ``modulation.pusch_llr``)
evm_calculate = modulation.evm_plain


def _data_rows(grid: torch.Tensor, cfg: ShConfig, h_of=None):
    """Data REs of the allocation in mapping order: grid [..., 14, nsc] →
    y [..., n_re]; with ``h_of(l)``, the channel [..., w] of symbol l over
    the allocation, also the channel at those REs."""
    lo, hi = cfg.sc_bounds
    ys, hs = [], []
    for l, kind in cfg.symbol_plan:
        row = grid[..., l, lo:hi]
        h = h_of(l) if h_of is not None and kind != "dmrs" else None
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
    return y if h_of is None else (y, torch.cat(hs, dim=-1))


def _rx_pilots(rx_grid: torch.Tensor, cfg: ShConfig,
               comb: int = 0) -> torch.Tensor:
    lo, hi = cfg.sc_bounds
    return torch.stack([rx_grid[..., l, lo:hi][..., comb::2]
                        for l in cfg.dmrs_symbols], dim=-2)


def _to_virtual(grid: torch.Tensor, cfg: ShConfig) -> torch.Tensor:
    """Physical → virtual (contiguous VRB) subcarrier order of the BWP: one
    gather, after which the slice-structured chain applies unchanged."""
    if not cfg.vrb_to_prb_interleaved:
        return grid
    fwd = _vrb_index_on(cfg, 0, grid.device)
    return torch.cat([grid[..., fwd], grid[..., fwd.shape[0]:]], dim=-1)


def _equalize(rx_grid: torch.Tensor, cfg: ShConfig,
              tx_pilots: torch.Tensor | None = None,
              per_symbol: bool = True):
    """Estimate and equalise the allocation of [B, nrx, 14, nsc] grids (in
    virtual order) → (estimate of CDM group 0 / the single layer, x_hat
    [B, (L,) n_re], post noise var like x_hat, noise variance [B]).

    Several layers: CDM despread per group (group 1 on the odd comb for
    four layers), then N×L ZF per RE.  One layer: comb-2 estimate and MRC;
    with time_interp and ``per_symbol`` the channel of each data symbol is
    interpolated between the DM-RS symbols.
    """
    if tx_pilots is None:
        tx_pilots = _dmrs_pilots(cfg, rx_grid.device)
    rx_pilots = _rx_pilots(rx_grid, cfg)                  # [B, nrx, ndmrs, np]
    if cfg.nof_layers > 1:
        est = estimator.estimate_comb2_occ2(rx_pilots, tx_pilots)
        if cfg.nof_layers == 4:
            est1 = estimator.estimate_comb2_occ2(_rx_pilots(rx_grid, cfg, 1),
                                                 tx_pilots, sc_offset=1)
            h_layers = torch.cat([est.h_alloc, est1.h_alloc], dim=-2)
            nv_est = 0.5 * (est.noise_var.mean(dim=-1)
                            + est1.noise_var.mean(dim=-1))
            eq = equalizer.zf_nx4
        else:
            h_layers = est.h_alloc
            nv_est = est.noise_var.mean(dim=-1)
            eq = equalizer.zf_nx2
        h_of = lambda l: h_layers
    else:
        interp = cfg.time_interp and per_symbol
        est = estimator.estimate_comb2(rx_pilots, tx_pilots,
                                       time_interp=cfg.time_interp)
        nv_est = est.noise_var.mean(dim=-1)
        eq = equalizer.zf_1xn

        def h_of(l: int) -> torch.Tensor:
            if not interp:
                return est.h_alloc
            d0, d1, w1 = cfg.time_weights[l - cfg.first_symbol]
            h0 = est.h_dmrs[..., d0, :]
            if w1 == 0.0:
                return h0
            return (1.0 - w1) * h0 + w1 * est.h_dmrs[..., d1, :]

    y, h = _data_rows(rx_grid, cfg, h_of)
    noise_var = torch.clamp(nv_est, min=1e-9)                   # [B]
    x_hat, post_nv = eq(y, h, noise_var)
    return est, x_hat, post_nv, noise_var


def symbol_check(demod: PuschDemod, codeword: torch.Tensor) -> torch.Tensor:
    """Fraction [B] of codeword bits whose hard LLR decision matches."""
    hard = (demod.sch_llr < 0).to(torch.int8)
    return (hard == codeword.to(torch.int8)).to(torch.float32).mean(dim=-1)


def symbol_verify(rx_grid: torch.Tensor, tx_grid: torch.Tensor,
                  cfg: ShConfig) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """UE-side symbol-domain check of a downlink allocation against the
    known transmitted grid: estimate and equalise as ``pusch_demodulate``
    does (the channel averaged over the DM-RS symbols, as in the JAX
    package), then count the equalised data symbols whose per-axis
    deviation from the transmitted point is under half the minimum distance.
    A VRB-interleaved allocation is gathered back to virtual order in both
    grids first.

    rx_grid: [B, nrx, 14, nsc] (or [B, 14, nsc]); tx_grid: [B, port, 14,
    nsc] or [B, 14, nsc], ports carrying the layers (identity mapping).
    Returns (symbol match fraction, EVM against the reference, mean post
    noise variance), each [B].
    """
    if rx_grid.dim() == 3:
        rx_grid = rx_grid[:, None]
    if tx_grid.dim() == 3:
        tx_grid = tx_grid[:, None]
    rx_grid, tx_grid = _to_virtual(rx_grid, cfg), _to_virtual(tx_grid, cfg)
    _, x_hat, nv, _ = _equalize(rx_grid, cfg, per_symbol=False)
    if cfg.nof_layers > 1:
        x_ref = _data_rows(tx_grid[:, :cfg.nof_layers], cfg)    # [B, L, n]
    else:
        x_ref = _data_rows(tx_grid[:, :1], cfg)[:, 0]
    half_d = float(HALF_MIN_DISTANCE[cfg.qm])
    d = x_hat - x_ref
    hit = (d.real.abs() < half_d) & (d.imag.abs() < half_d)
    dims = tuple(range(1, d.dim()))
    return (hit.to(torch.float32).mean(dim=dims),
            (d.abs() ** 2).mean(dim=dims).sqrt(), nv.mean(dim=dims))


def pusch_demodulate(rx_grid: torch.Tensor, cfg: ShConfig,
                     tx_pilots: torch.Tensor | None = None) -> PuschDemod:
    """Front half of the PUSCH receiver: [B, nrx, 14, nsc] grids →
    per-codeblock LLRs (HARQ-combinable) and the UCI field LLRs.

    tx_pilots: the slot's DM-RS ([ndmrs, 6·nof_prb], ``dmrs.pilot_values``);
    default the config's own (its slot_in_frame).
    """
    if rx_grid.dim() == 3:
        rx_grid = rx_grid[:, None]
    est, x_hat, post_nv, noise_var = _equalize(_to_virtual(rx_grid, cfg),
                                               cfg, tx_pilots)
    _, sign = _scramble_seq(cfg.scrambling_cinit, cfg.nof_bits, rx_grid.device)
    llr, evm = modulation.pusch_llr(x_hat, post_nv, sign, cfg.qm)  # [B, G]
    ta_norm = None if cfg.nof_layers > 1 else est.ta_norm.mean(dim=-1)
    if cfg.uci.any:
        sch_llr, ack, csi1, csi2 = ulsch.demultiplex(llr, cfg.uci_maps_key)
    else:
        sch_llr, ack, csi1, csi2 = llr, llr[:, :0], llr[:, :0], llr[:, :0]
    full = rate_match.dematch_tb(sch_llr, *cfg.rate_match_key())
    return PuschDemod(llr_full=full, noise_var=noise_var,
                      rsrp=est.rsrp.mean(dim=-1), evm=evm,
                      post_noise_var=post_nv.flatten(1).mean(dim=-1),
                      ack_llr=ack, csi1_llr=csi1, csi2_llr=csi2,
                      ta_norm=ta_norm, sch_llr=sch_llr)


def pusch_decode(llr_full: torch.Tensor, cfg: ShConfig,
                 noise_var: torch.Tensor, rsrp: torch.Tensor,
                 nof_ldpc_iterations: int = 6,
                 demod: PuschDemod | None = None) -> PuschResult:
    """Back half: [B, C, N] LLRs → decoded TBs + CRC + SINR (+ UCI).  All
    B·C codeblocks go to the decoder in one call."""
    bits, ok = decode_cbs(llr_full, cfg, nof_ldpc_iterations)
    return pusch_finish(bits, ok, cfg, noise_var, rsrp, demod)


def used_blocks(cfg: ShConfig) -> int | None:
    """Variable blocks the decoder runs: rv=0 circular-buffer reads are
    contiguous, so the graph is truncated to the transmitted span (exact);
    retransmissions and HARQ-combined buffers wrap and take the full graph
    (None)."""
    seg = cfg.segments
    if cfg.rv != 0:
        return None
    return decoder_cuda.used_blocks(seg.base_graph, seg.lifting_size,
                                    max(cfg.cb_lengths))


def decode_cbs(llr_full: torch.Tensor, cfg: ShConfig,
               nof_ldpc_iterations: int = 6
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, C, N] LLRs → (bits [B, C, K], ok [B, C]) in one decoder call.
    The tracer counts ``ldpc.full_graph``, the codeblock rows decoded on
    the full graph (``used_blocks`` None)."""
    seg = cfg.segments
    bsz, c, n = llr_full.shape
    used = used_blocks(cfg)
    if used is None:
        tracer.add("ldpc.full_graph", bsz * c)
    bits, ok = decoder_cuda.decode(
        llr_full.reshape(bsz * c, n), seg.base_graph, seg.lifting_size,
        nof_iterations=nof_ldpc_iterations, nof_used_blocks=used)
    return bits.reshape(bsz, c, -1), ok.reshape(bsz, c)


def pusch_finish(bits: torch.Tensor, ok: torch.Tensor, cfg: ShConfig,
                 noise_var: torch.Tensor, rsrp: torch.Tensor,
                 demod: PuschDemod | None = None) -> PuschResult:
    """Decoded codeblock bits [B, C, K] → PuschResult (desegment + CRC +
    SINR + UCI decode).  Unit symbol energy ⇒ SINR = 1/mean post-equalisation
    noise variance; rsrp/noise_var without a demod."""
    tb, tb_ok, cb_ok = segmentation.desegment_rx(bits, cfg.segments)
    tb_ok = tb_ok & ok.all(dim=-1)
    if demod is not None:
        sinr = 1.0 / torch.clamp(demod.post_noise_var, min=1e-12)
    else:
        sinr = rsrp / noise_var
    res = PuschResult(
        tb_bits=tb, tb_crc_ok=tb_ok, cb_crc_ok=cb_ok & ok,
        noise_var=noise_var, rsrp=rsrp,
        sinr_db=10.0 * torch.log10(torch.clamp(sinr, min=1e-12)),
        evm=demod.evm if demod is not None else None,
        ta_norm=demod.ta_norm if demod is not None else None)
    if demod is not None and cfg.uci.any:
        u = cfg.uci
        if u.nof_harq_ack_bits:
            res.ack_bits, res.ack_valid = ulsch.decode_uci_field(
                demod.ack_llr, u.nof_harq_ack_bits, cfg.qm)
        if u.nof_csi_part1_bits:
            res.csi1_bits, res.csi1_valid = ulsch.decode_uci_field(
                demod.csi1_llr, u.nof_csi_part1_bits, cfg.qm)
        if u.nof_csi_part2_bits:
            res.csi2_bits, res.csi2_valid = ulsch.decode_uci_field(
                demod.csi2_llr, u.nof_csi_part2_bits, cfg.qm)
    return res


def llr_full_shape(cfg: ShConfig) -> tuple[int, int]:
    """Shape of one slot's ``PuschDemod.llr_full`` ([C codeblocks, N full
    buffer]): the HARQ softbuffer size.  N spans the full codeword including
    the 2·Zc punctured systematic prefix (68·Zc / 52·Zc)."""
    seg = cfg.segments
    return (seg.nof_segments,
            seg.full_codeblock_length + 2 * seg.lifting_size)


def pusch_receive(rx_grid: torch.Tensor, cfg: ShConfig,
                  nof_ldpc_iterations: int = 6,
                  tx_pilots: torch.Tensor | None = None) -> PuschResult:
    """Full PUSCH receiver (single transmission, no HARQ combining)."""
    d = pusch_demodulate(rx_grid, cfg, tx_pilots=tx_pilots)
    return pusch_decode(d.llr_full, cfg, d.noise_var, d.rsrp,
                        nof_ldpc_iterations, demod=d)
