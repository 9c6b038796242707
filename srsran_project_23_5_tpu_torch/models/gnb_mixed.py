"""Mixed slot: the full per-slot channel mix of a 273-PRB carrier.

Counterpart of ``srsran_project_23_5_tpu/models/gnb_mixed.py``.  One slot
carries

  DL: PDCCH (DL DCI + UL grant, AL4) ‖ SS/PBCH block ‖ NZP-CSI-RS ‖
      PDSCH UE0 (2 layers) ‖ PDSCH UE1 (1 layer)
  UL: PUSCH UE0 (2 layers) ‖ PUSCH UE1 ‖ PUCCH F1 (HARQ-ACK) ‖
      PRACH occasion (139-chip preamble, 12 repetitions, in the time
      domain at the RACH UE's own delay)

and checks every channel: the gNB receives both PUSCH through the LDPC
decoder, detects the PUCCH and the PRACH preamble and its timing; the UE
side checks both PDSCH in the symbol domain against the transmitted grid,
the PDCCH candidate (and, once per batch, the full DCI decode), the SSB
block and its PSS, and measures the CSI-RS SINR.

Every function works on a leading batch of B slots.  The default channels
are frequency-flat and unitary, applied on the resource grid, so the whole
uplink is one 2-port OFDM modulation and one demodulation;
``tdl_channel`` makes them frequency-selective (TDL taps applied at
baseband to each transmitted stream).  The channel noise is an argument:
two [B, 2, slot_samples] complex64 tensors (downlink and uplink, rx port
second) with standard deviation ``noise_sigma(cfg)`` per sample.  Each UE's
codeblocks of the whole batch are encoded in one LDPC encoder launch and
decoded in one decoder launch.  Options: the PRACH occasion on the grid
instead of in the time domain, the UE-side LDPC decode of both PDSCH
instead of the symbol check, the downlink checks off.  HARQ:
``harq_pair_batch`` runs a batch of pairs as a gNB receives them (a first
transmission at rv=0 that fails, its rv=2 retransmission, the softbuffer
combine and one full-graph decode of the sum), each transmission a full
mixed slot, and ``harq_batch_fn_for_pipeline`` hands it to
``SlotPipeline``; ``harq_retx_batch`` is the same pair's PUSCHs alone,
with the retransmission also decoded alone.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..ops import modulation
from ..ops import prach as prach_ops
from ..ops.channel_mix import channel_mix, vecmix
from ..ops.ldpc import segmentation
from ..phy.lower import ofdm
from ..phy.upper import csi_rs as csi_rs_proc
from ..phy.upper import harq
from ..phy.upper import pdcch as pdcch_proc
from ..phy.upper import pucch as pucch_proc
from ..phy.upper import sch
from ..phy.upper import ssb as ssb_proc
from ..ran import numerology, tbs as tbs_mod
from ..ran.constants import NRE
from ..testing.channels import normalize_taps, tdl_apply
from ..utils.device import resolve as resolve_device
from ..utils.tracing import tracer


@dataclasses.dataclass(frozen=True)
class MixedSlotConfig:
    """Static configuration of one full mixed slot."""
    mu: int
    nfft: int
    nof_prb: int
    pdsch0: sch.ShConfig          # DL UE0, 2 layers
    pdsch1: sch.ShConfig          # DL UE1, 1 layer
    pusch0: sch.ShConfig          # UL UE0, 2 layers
    pusch1: sch.ShConfig          # UL UE1, 1 layer
    pdcch_dl: pdcch_proc.PdcchConfig
    pdcch_ul: pdcch_proc.PdcchConfig
    ssb: ssb_proc.SsbConfig
    ssb_prb_start: int
    csi_rs: csi_rs_proc.CsiRsConfig
    pucch: pucch_proc.PucchF1Config
    prach_root: int = 22
    prach_ncs: int = 13
    prach_preamble: int = 3       # expected preamble index
    prach_sc_start: int = 3072    # first subcarrier of the 139-chip window
    prach_nof_symbols: int = 12   # repetition count
    # time domain: the RACH UE's burst, CP + prach_nof_symbols nfft-sample
    # repetitions at prach_start_sample + prach_delay_samples (an un-timed
    # UE); otherwise the preamble sits on the grid's first
    # prach_nof_symbols symbols
    prach_time_domain: bool = True
    prach_start_sample: int = 0
    prach_cp_samples: int = 0     # 0 → nfft // 16
    prach_delay_samples: int = 0  # 0 → nfft // 64 (injected TA)
    snr_db: float = 20.0
    nof_ldpc_iterations: int = 6
    ue_decode_dl: bool = False    # UE-side LDPC decode of both PDSCH
    verify_dl_sch: bool = True    # UE-side PDSCH checks
    verify_dl_ctrl: bool = True   # PDCCH / SSB / PSS / CSI-RS checks
    prach_threshold: float = 16.0
    # frequency-selective channel: tap delays (samples) and linear gains
    # applied at baseband to each tx stream; empty → flat grid channels
    tdl_delays: tuple[int, ...] = ()
    tdl_gains: tuple[float, ...] = ()

    @property
    def nsc(self) -> int:
        return self.nof_prb * NRE

    @property
    def slot_samples(self) -> int:
        return numerology.slot_num_samples(self.mu, self.nfft)

    @property
    def prach_cp(self) -> int:
        return self.prach_cp_samples or self.nfft // 16

    @property
    def prach_delay(self) -> int:
        return self.prach_delay_samples or self.nfft // 64


# Unitary 2×2 channels: orthonormal columns keep the post-ZF SINR of each
# layer at the per-RE SNR; unit-norm vectors do the same for the
# single-antenna UEs through MRC.
def _unitary(theta: float, phi: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.asarray([[c, s * np.exp(1j * phi)],
                       [-s * np.exp(-1j * phi), c]], np.complex64)


H_UL = _unitary(0.6435, 0.7)      # UE0 (2 antennas) → gNB (2 antennas)
H_DL = _unitary(0.9273, -0.4)     # gNB (2 ports) → UE (2 antennas)
H1_UL = np.asarray([0.6 + 0.5j, -0.6245j], np.complex64)     # UE1, |h|=1
H2_UL = np.asarray([0.3 - 0.8j, 0.5196], np.complex64)       # UE2/3, |h|=1


def default_mixed(nof_prb: int = 273, qm: int = 6, rate: float = 0.6533,
                  snr_db: float = 20.0, **over) -> MixedSlotConfig:
    """The 100 MHz carrier (273 PRB, nfft 4096, 64QAM, R≈0.65) by default;
    allocations sized off nof_prb ≥ 68."""
    if nof_prb < 68:
        raise ValueError("the mixed layout needs ≥ 68 PRB (SSB, PRACH, UEs)")
    nfft = numerology.min_nfft(nof_prb)
    ssb_start = nof_prb - 20
    prach_sc = (nof_prb - 17) * NRE
    pucch_prb = nof_prb - 2
    ue0_prb = nof_prb // 2                      # DL+UL UE0 span
    ul1_prb = nof_prb - 18 - ue0_prb            # UL UE1 span
    dl1_prb = ssb_start - ue0_prb               # DL UE1 span

    def mk(prb0, nprb, layers, first, nsym, rnti, resv=()):
        cfg = sch.ShConfig(
            rnti=rnti, tbs=8, qm=qm, nof_layers=layers, prb_start=prb0,
            nof_prb=nprb, first_symbol=first, nof_symbols=nsym,
            dmrs_symbols=(2, 7, 11), reserved_patterns=resv)
        nre_prb = cfg.nof_data_re // nprb
        tbs = tbs_mod.tbs_calculate(nsym, nsym * NRE - nre_prb, 0, rate,
                                    qm, layers, nprb)
        return dataclasses.replace(cfg, tbs=tbs)

    base = MixedSlotConfig(
        mu=1, nfft=nfft, nof_prb=nof_prb,
        pdsch0=mk(0, ue0_prb, 2, 1, 13, 0x4601, resv=((5, (0,)),)),
        pdsch1=mk(ue0_prb, dl1_prb, 1, 1, 13, 0x4602),
        pusch0=mk(0, ue0_prb, 2, 0, 14, 0x4601),
        pusch1=mk(ue0_prb, ul1_prb, 1, 0, 14, 0x4602),
        pdcch_dl=pdcch_proc.PdcchConfig(
            rnti=0x4601, payload_size=40, aggregation_level=4, cce_index=0,
            start_symbol=0),
        pdcch_ul=pdcch_proc.PdcchConfig(
            rnti=0x4602, payload_size=40, aggregation_level=4, cce_index=4,
            start_symbol=0),
        ssb=ssb_proc.SsbConfig(pci=123), ssb_prb_start=ssb_start,
        csi_rs=csi_rs_proc.CsiRsConfig(
            row=2, prb_start=0, nof_prb=ue0_prb, symbol=5),
        pucch=pucch_proc.PucchF1Config(prb=pucch_prb, nof_harq_bits=1),
        prach_sc_start=prach_sc, snr_db=snr_db)
    return dataclasses.replace(base, **over) if over else base


def tiny_mixed(**over) -> MixedSlotConfig:
    """Small mixed carrier for CPU tests (68 PRB, QPSK, rate 1/2)."""
    return default_mixed(nof_prb=68, qm=2, rate=0.5, **over)


def tdl_channel(cfg: MixedSlotConfig, delays=(0, 4, 9),
                gains_db=(0.0, -3.0, -6.0)) -> MixedSlotConfig:
    """The frequency-selective variant: TDL-like taps at integer sample
    delays, power-normalised."""
    delays, gains = normalize_taps(delays, gains_db)
    return dataclasses.replace(cfg, tdl_delays=delays, tdl_gains=gains)


def make_payloads(cfg: MixedSlotConfig, rng: np.random.Generator,
                  batch: int, device: torch.device | str | None = None
                  ) -> dict[str, torch.Tensor]:
    """Random per-slot payloads: {name: [batch, n] int8 {0,1}} on `device`
    (default: the current CUDA device; the same draws, in the same order,
    as the JAX ``make_payloads``)."""
    device = resolve_device(device)
    sizes = {"tb_dl0": cfg.pdsch0.tbs, "tb_dl1": cfg.pdsch1.tbs,
             "tb_ul0": cfg.pusch0.tbs, "tb_ul1": cfg.pusch1.tbs,
             "dci_dl": cfg.pdcch_dl.payload_size,
             "dci_ul": cfg.pdcch_ul.payload_size,
             "pbch": ssb_proc.PBCH_A, "ack": cfg.pucch.nof_harq_bits}
    return {k: torch.from_numpy(rng.integers(0, 2, size=(batch, n))
                                .astype(np.int8)).to(device)
            for k, n in sizes.items()}


def noise_sigma(cfg: MixedSlotConfig) -> float:
    """Standard deviation per complex sample of the channel noise:
    ``modulate_slot`` makes a unit-power RE an amplitude-1 subcarrier and
    ``demodulate_slot`` divides by nfft, so sqrt(nfft)·10^(-snr/20) gives
    a per-RE SNR of snr_db."""
    return float(np.sqrt(cfg.nfft) * 10 ** (-cfg.snr_db / 20))


def draw_noise(cfg: MixedSlotConfig, batch: int, generator: torch.Generator
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Downlink and uplink noise [batch, 2, slot_samples] complex64, drawn
    on the generator's device."""
    nz = torch.randn((2, batch, 2, 2, cfg.slot_samples), generator=generator,
                     device=generator.device, dtype=torch.float32)
    nz = nz * (noise_sigma(cfg) / math.sqrt(2.0))
    return (torch.complex(nz[0, :, 0], nz[0, :, 1]),
            torch.complex(nz[1, :, 0], nz[1, :, 1]))


def symbol_gate(qm: int, snr_db: float, est_loss_db: float = 1.0) -> float:
    """Gate of the UE-side symbol check: the expected fraction of equalised
    REs inside the half-minimum-distance cell at the operating point
    (est_loss_db budgets the channel-estimation loss), minus a margin.  A
    broken chain scores ~1/2^qm."""
    snr = 10 ** ((snr_db - est_loss_db) / 10)
    q = 0.5 * math.erfc(sch.HALF_MIN_DISTANCE[qm] * np.sqrt(snr))
    return max(0.85, (1.0 - 2.0 * q) ** 2 - 0.02)


def hard_match_gate(qm: int, snr_db: float) -> float:
    """Gate of a hard-bit codeword check: ~4σ below the expected match
    fraction of uncoded hard decisions, far above a broken chain's ~0.5."""
    ber = 0.5 * math.erfc(sch.HALF_MIN_DISTANCE[qm] * np.sqrt(10 ** (snr_db / 10)))
    return max(0.9, 1.0 - 4.0 * ber - 0.005)


@dataclasses.dataclass
class MixedSlotResult:
    """Verdicts and measurements of a batch of mixed slots, each [B]."""
    ok: torch.Tensor              # every channel of the slot verified
    sinr_ul_db: torch.Tensor      # mean post-eq SINR of the two PUSCH
    ul0_ok: torch.Tensor
    ul1_ok: torch.Tensor
    dl0_match: torch.Tensor       # UE0 symbol match fraction
    dl1_match: torch.Tensor
    dl0_ok: torch.Tensor
    dl1_ok: torch.Tensor
    pdcch_match: torch.Tensor
    dci_crc_ok: torch.Tensor
    ssb_match: torch.Tensor
    pss_corr: torch.Tensor
    pucch_ok: torch.Tensor
    pucch_metric: torch.Tensor
    prach_ok: torch.Tensor
    prach_metric: torch.Tensor
    csi_sinr_db: torch.Tensor
    sinr_ul0_db: torch.Tensor
    sinr_ul1_db: torch.Tensor
    sinr_dl0_db: torch.Tensor
    prach_ta_samples: torch.Tensor  # measured time of arrival (samples)


@functools.lru_cache(maxsize=8)
def _channels(device: torch.device):
    """(H_UL, H_DL, H1_UL, H2_UL) on `device`."""
    return tuple(torch.from_numpy(h).to(device)
                 for h in (H_UL, H_DL, H1_UL, H2_UL))


def _block_check(rx_blk: torch.Tensor, tx_blk: torch.Tensor,
                 seg: int = NRE) -> torch.Tensor:
    """Relative reconstruction error [B] of a contiguous grid block: one
    channel per (rx port, `seg`-subcarrier sub-block) from all non-zero tx
    REs of the sub-block, then Σ|y − ĥx|² / Σ|ĥx|².

    rx_blk: [B, nrx, nsym, nsc]; tx_blk: [B, nsym, nsc].
    """
    bsz, nrx, nsym, nsc = rx_blk.shape
    nb = nsc // seg
    rx = rx_blk[..., :nb * seg].reshape(bsz, nrx, nsym, nb, seg)
    tx = tx_blk[..., :nb * seg].reshape(bsz, nsym, nb, seg)
    occ = (tx.abs() > 1e-6).to(torch.float32)
    num = (rx * torch.conj(tx)[:, None]).sum(dim=(2, 4))        # [B, nrx, nb]
    den = torch.clamp((occ * tx.abs() ** 2).sum(dim=(1, 3)), min=1e-12)
    h = num / den[:, None]
    ref = h[:, :, None, :, None] * tx[:, None]
    err = ((rx - ref) * occ[:, None]).abs().pow(2).sum(dim=(1, 2, 3, 4))
    sig = torch.clamp((ref.abs() ** 2 * occ[:, None]).sum(dim=(1, 2, 3, 4)),
                      min=1e-12)
    return err / sig


@functools.lru_cache(maxsize=8)
def _pdcch_llr_perm(device: torch.device) -> torch.Tensor:
    """Offset-major ([off0 ×3, off2 ×3, off3 ×3] per REG) QPSK LLRs → the
    mapper's quad-major order."""
    perm = [(o * 3 + q) * 2 + b for q in range(3) for o in range(3)
            for b in range(2)]
    return torch.tensor(perm, dtype=torch.int64, device=device)


def _pdcch_check(rx_grid: torch.Tensor, tx_grid: torch.Tensor,
                 cfg: pdcch_proc.PdcchConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hard-QPSK match fraction [B] of the candidate's data REs after MRC
    with a per-REG channel from the REG's 3 DM-RS pilots, and the
    candidate's LLRs [B, E] in mapping order.

    rx_grid: [B, nrx, 14, nsc]; tx_grid: [B, 14, nsc].
    """
    nregs = cfg.aggregation_level * 6
    lo = (cfg.coreset_start_prb + cfg.cce_index * 6) * NRE
    l = cfg.start_symbol
    bsz, nrx = rx_grid.shape[:2]
    y = rx_grid[:, :, l, lo:lo + nregs * NRE].reshape(bsz, nrx, nregs, 3, 4)
    x = tx_grid[:, l, lo:lo + nregs * NRE].reshape(bsz, nregs, 3, 4)
    h = (y[..., 1] * torch.conj(x[:, None, ..., 1])).mean(dim=-1)  # [B,nrx,r]
    y_d = torch.cat([y[..., 0], y[..., 2], y[..., 3]], dim=-1)    # [B,nrx,r,9]
    x_d = torch.cat([x[..., 0], x[..., 2], x[..., 3]], dim=-1)    # [B, r, 9]
    num = (torch.conj(h)[..., None] * y_d).sum(dim=1)             # [B, r, 9]
    den = torch.clamp((h.abs() ** 2).sum(dim=1), min=1e-12)       # [B, r]
    d_hat = num / den[..., None]
    match = ((torch.sign(d_hat.real) == torch.sign(x_d.real))
             & (torch.sign(d_hat.imag) == torch.sign(x_d.imag)))
    nv = torch.full(d_hat.shape, 0.1, dtype=torch.float32,
                    device=d_hat.device)
    llr_om = modulation.demodulate_soft(d_hat, nv, 2)            # [B, r, 18]
    llr = llr_om[..., _pdcch_llr_perm(d_hat.device)].reshape(bsz, -1)
    return match.to(torch.float32).mean(dim=(1, 2)), llr


@functools.lru_cache(maxsize=32)
def _prach_burst_np(cfg: MixedSlotConfig) -> np.ndarray:
    """Slot-length baseband of the RACH UE's burst: CP + prach_nof_symbols
    back-to-back nfft-sample repetitions, delayed by the injected delay."""
    pre = prach_ops.generate(cfg.prach_root, cfg.prach_preamble, 139,
                             cfg.prach_ncs)
    off = (cfg.prach_sc_start - cfg.nsc // 2) % cfg.nfft
    bins = np.zeros(cfg.nfft, np.complex64)
    bins[(np.arange(139) + off) % cfg.nfft] = pre
    rep = np.fft.ifft(bins).astype(np.complex64) * cfg.nfft
    burst = np.concatenate([rep[-cfg.prach_cp:],
                            np.tile(rep, cfg.prach_nof_symbols)])
    full = np.zeros(cfg.slot_samples, np.complex64)
    s0 = cfg.prach_start_sample + cfg.prach_delay
    if s0 + burst.size > cfg.slot_samples:
        raise ValueError("PRACH window beyond the slot")
    full[s0:s0 + burst.size] = burst
    return full


@functools.lru_cache(maxsize=8)
def _prach_burst(cfg: MixedSlotConfig, device: torch.device) -> torch.Tensor:
    """The RACH UE's burst [slot_samples] on `device`."""
    return torch.from_numpy(_prach_burst_np(cfg)).to(device)


@functools.lru_cache(maxsize=8)
def _prach_rx_ports(cfg: MixedSlotConfig,
                    device: torch.device) -> torch.Tensor:
    """The burst as the gNB's two rx ports see it through the flat
    channel: [2, slot_samples]."""
    return vecmix(_channels(device)[3], _prach_burst(cfg, device)[None])[0]


@functools.lru_cache(maxsize=8)
def _prach_preamble(cfg: MixedSlotConfig,
                    device: torch.device) -> torch.Tensor:
    """The frequency-domain preamble [139] of the grid-level occasion."""
    return torch.from_numpy(prach_ops.generate(
        cfg.prach_root, cfg.prach_preamble, 139, cfg.prach_ncs)).to(device)


def _prach_rx_window(rx_ul: torch.Tensor, cfg: MixedSlotConfig
                     ) -> torch.Tensor:
    """gNB-side PRACH occasion demodulation from baseband [..., samples] →
    [..., 139]: the repetitions are averaged in time (each one full nfft
    period of the same waveform), then one FFT."""
    n, nrep = cfg.nfft, cfg.prach_nof_symbols
    w0 = cfg.prach_start_sample + cfg.prach_cp
    body = rx_ul[..., w0:w0 + nrep * n]
    reps = body.reshape(*body.shape[:-1], nrep, n).mean(dim=-2)
    bins = torch.fft.fft(reps, dim=-1) / n
    off = (cfg.prach_sc_start - cfg.nsc // 2) % n
    if off + 139 <= n:
        return bins[..., off:off + 139]
    return torch.cat([bins[..., off:], bins[..., :off + 139 - n]], dim=-1)


@functools.lru_cache(maxsize=8)
def _pss(cfg: ssb_proc.SsbConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        ssb_proc.pss_sequence(cfg.nid2).astype(np.complex64)).to(device)


def _db(x: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(x, min=1e-12))


# --------------------------------------------------------------------------
# front half: assembly → channels → OFDM → demodulation → pre-decode checks
# --------------------------------------------------------------------------
def _dl_checks(ue_grid: torch.Tensor, g2d: torch.Tensor,
               cfg: MixedSlotConfig) -> dict:
    """The UE side's control checks: the PDCCH candidate (match and LLRs),
    the SSB block and its PSS, the CSI-RS SINR."""
    ssb_lo = cfg.ssb_prb_start * NRE
    pdcch_match, pdcch_llr = _pdcch_check(ue_grid, g2d, cfg.pdcch_dl)
    # SSB: whole-block relative error (pilots + PBCH + PSS/SSS)
    ssb_err = _block_check(ue_grid[:, :, 2:6, ssb_lo:ssb_lo + 240],
                           g2d[:, 2:6, ssb_lo:ssb_lo + 240])
    pss = _pss(cfg.ssb, ue_grid.device)
    y_pss = ue_grid[:, :, 2, ssb_lo + 56:ssb_lo + 183]          # [B, nrx, 127]
    num = (y_pss * torch.conj(pss)).sum(dim=-1).abs() ** 2
    den = (y_pss.abs() ** 2).sum(dim=-1) * (pss.abs() ** 2).sum()
    # CSI-RS: UE measurement → CSI SINR (one RE per PRB)
    cr = cfg.csi_rs
    clo = cr.prb_start * NRE
    chi = clo + cr.nof_prb * NRE
    y_csi = ue_grid[:, :, cr.symbol, clo:chi][..., cr.subcarrier_offset::NRE]
    x_csi = g2d[:, cr.symbol, clo:chi][..., cr.subcarrier_offset::NRE]
    h_csi = (y_csi * torch.conj(x_csi)[:, None]).mean(dim=-1)      # [B, nrx]
    resid = y_csi - h_csi[..., None] * x_csi[:, None]
    return {
        "pdcch_match": pdcch_match, "pdcch_llr": pdcch_llr,
        "ssb_match": 1.0 - torch.clamp(ssb_err, max=1.0),
        "pss_corr": (num / torch.clamp(den, min=1e-12)).amax(dim=-1),
        "csi_sinr_db": _db((h_csi.abs() ** 2).sum(dim=-1) / torch.clamp(
            (resid.abs() ** 2).mean(dim=(1, 2)), min=1e-12))}


def _mixed_front(payloads: dict, noise_dl: torch.Tensor,
                 noise_ul: torch.Tensor, cfg: MixedSlotConfig) -> dict:
    dev = noise_dl.device
    bsz = noise_dl.shape[0]
    nsc = cfg.nsc
    h_ul, h_dl, h1_ul, h2_ul = _channels(dev)
    selective = bool(cfg.tdl_delays)

    def tdl(x: torch.Tensor) -> torch.Tensor:
        return tdl_apply(x, cfg.tdl_delays, cfg.tdl_gains)

    # ---------------------------------------------------------- downlink
    cw0 = sch._encode_sch(payloads["tb_dl0"], cfg.pdsch0)
    cw1 = sch._encode_sch(payloads["tb_dl1"], cfg.pdsch1)
    grid_dl = sch._scramble_modulate_map(
        cw0, cfg.pdsch0,
        torch.zeros((bsz, 2, 14, nsc), dtype=torch.complex64, device=dev))
    g2d = sch._scramble_modulate_map(
        cw1, cfg.pdsch1,
        torch.zeros((bsz, 14, nsc), dtype=torch.complex64, device=dev))
    # the PDCCH rides symbol 0, ahead of both PDSCH (which start at 1)
    g2d = pdcch_proc.pdcch_transmit(payloads["dci_dl"], cfg.pdcch_dl, g2d)
    g2d = pdcch_proc.pdcch_transmit(payloads["dci_ul"], cfg.pdcch_ul, g2d)
    # the SSB overwrites symbols 2-5 of its 20 PRBs
    ssb_lo = cfg.ssb_prb_start * NRE
    g2d[:, 2:6, ssb_lo:ssb_lo + ssb_proc.SSB_NSC] = ssb_proc.ssb_assemble(
        payloads["pbch"], cfg.ssb)
    g2d = csi_rs_proc.generate(cfg.csi_rs, g2d)
    # added onto port 0: pdsch0 reserves the CSI-RS RE (symbol 5, offset 0)
    grid_dl[:, 0] = grid_dl[:, 0] + g2d

    if selective:
        bb_dl = channel_mix(h_dl, tdl(ofdm.modulate_slot(grid_dl, cfg.mu,
                                                         cfg.nfft)))
    else:
        bb_dl = ofdm.modulate_slot(channel_mix(h_dl, grid_dl), cfg.mu,
                                   cfg.nfft)
    ue_grid = ofdm.demodulate_slot(bb_dl + noise_dl, nsc, cfg.mu, cfg.nfft)

    # UE side: by default estimate + equalise each PDSCH as a receiver
    # would and require every equalised data RE to hard-decide to the sent
    # symbol; ue_decode_dl demodulates both for the LDPC decode instead
    evm_gate = (3.0 if selective else 1.5) * 10 ** (-cfg.snr_db / 20)
    true_b = torch.ones(bsz, dtype=torch.bool, device=dev)
    d0 = d1 = None
    if not cfg.verify_dl_sch:
        dl0_match = dl1_match = torch.ones(bsz, device=dev)
        dl0_pre = dl1_pre = true_b
        nv_dl0 = torch.full((bsz,), 10 ** (-cfg.snr_db / 10), device=dev)
    elif cfg.ue_decode_dl:
        d0 = sch.pusch_demodulate(ue_grid, cfg.pdsch0)
        d1 = sch.pusch_demodulate(ue_grid, cfg.pdsch1)
        dl0_match = sch.symbol_check(d0, cw0)
        dl1_match = sch.symbol_check(d1, cw1)
        dl0_pre = dl1_pre = true_b
        nv_dl0 = d0.post_noise_var
    else:
        dl0_match, evm0, nv_dl0 = sch.symbol_verify(ue_grid, grid_dl,
                                                    cfg.pdsch0)
        dl1_match, evm1, _ = sch.symbol_verify(ue_grid, grid_dl[:, 0],
                                               cfg.pdsch1)
        gate0 = symbol_gate(cfg.pdsch0.qm, cfg.snr_db)
        gate1 = symbol_gate(cfg.pdsch1.qm, cfg.snr_db)
        if selective:
            gate0, gate1 = min(gate0, 0.88), min(gate1, 0.88)
        dl0_pre = (dl0_match > gate0) & (evm0 < evm_gate)
        dl1_pre = (dl1_match > gate1) & (evm1 < evm_gate)

    if cfg.verify_dl_ctrl:
        ctrl = _dl_checks(ue_grid, g2d, cfg)
    else:
        one = torch.ones(bsz, device=dev)
        ctrl = {"pdcch_match": one, "ssb_match": one, "pss_corr": one,
                "csi_sinr_db": torch.full((bsz,), float(cfg.snr_db),
                                          device=dev),
                "pdcch_llr": torch.zeros((bsz, cfg.pdcch_dl.e), device=dev)}

    # ------------------------------------------------------------ uplink
    grid_u0 = sch.pusch_transmit(
        payloads["tb_ul0"], cfg.pusch0,
        torch.zeros((bsz, 2, 14, nsc), dtype=torch.complex64, device=dev))
    grid_u1 = sch.pusch_transmit(
        payloads["tb_ul1"], cfg.pusch1,
        torch.zeros((bsz, 14, nsc), dtype=torch.complex64, device=dev))
    grid_u2 = pucch_proc.pucch_f1_transmit(
        payloads["ack"], cfg.pucch,
        torch.zeros((bsz, 14, nsc), dtype=torch.complex64, device=dev))
    plo = cfg.prach_sc_start
    if not cfg.prach_time_domain:
        grid_u2[:, :cfg.prach_nof_symbols, plo:plo + 139] = _prach_preamble(
            cfg, dev)
    if selective:
        mod = lambda g: ofdm.modulate_slot(g, cfg.mu, cfg.nfft)
        bb_u2 = mod(grid_u2)
        if cfg.prach_time_domain:
            bb_u2 = bb_u2 + _prach_burst(cfg, dev)
        bb_ul = channel_mix(h_ul, tdl(mod(grid_u0)), (h1_ul, h2_ul),
                            (tdl(mod(grid_u1)), tdl(bb_u2)))
    else:
        combined = channel_mix(h_ul, grid_u0, (h1_ul, h2_ul),
                               (grid_u1, grid_u2))
        bb_ul = ofdm.modulate_slot(combined, cfg.mu, cfg.nfft)
        if cfg.prach_time_domain:
            bb_ul = bb_ul + _prach_rx_ports(cfg, dev)
    rx_ul = bb_ul + noise_ul
    gnb_grid = ofdm.demodulate_slot(rx_ul, nsc, cfg.mu, cfg.nfft)

    # gNB receive front: two PUSCH demods (one 2×2), PUCCH F1, PRACH
    u0 = sch.pusch_demodulate(gnb_grid, cfg.pusch0)
    u1 = sch.pusch_demodulate(gnb_grid, cfg.pusch1)
    pu = pucch_proc.pucch_f1_detect(gnb_grid, cfg.pucch)
    pucch_ok = pu.detected & torch.all(
        pu.bits[:, :cfg.pucch.nof_harq_bits] == payloads["ack"], dim=-1)

    if cfg.prach_time_domain:
        pre_rx = _prach_rx_window(rx_ul, cfg)
    else:
        pre_rx = gnb_grid[:, :, :cfg.prach_nof_symbols,
                          plo:plo + 139].mean(dim=2)
    metric, delay, _ = prach_ops.detect(pre_rx, cfg.prach_root, 139,
                                        cfg.prach_ncs)
    m = metric.mean(dim=1)                               # combine rx ports
    prach_metric = m[:, cfg.prach_preamble]
    prach_ta = delay.mean(dim=1)[:, cfg.prach_preamble] * (cfg.nfft / 139.0)
    prach_ok = ((torch.argmax(m, dim=-1) == cfg.prach_preamble)
                & (prach_metric > cfg.prach_threshold))
    if cfg.prach_time_domain:
        # the measured TA must recover the injected delay; under a
        # multi-tap channel the peaks of taps closer than one ZC chip merge,
        # so the composite peak may sit anywhere between the first and the
        # last tap
        ta_tol = 1.0 + (max(cfg.tdl_delays) if selective else 0.0)
        prach_ok = prach_ok & ((prach_ta - cfg.prach_delay).abs() <= ta_tol)

    return {
        "u0": u0, "u1": u1, "d0": d0, "d1": d1, "ue_grid": ue_grid,
        "dl0_match": dl0_match, "dl1_match": dl1_match,
        "dl0_pre": dl0_pre, "dl1_pre": dl1_pre, **ctrl,
        "dci_crc_ok": true_b, "pucch_ok": pucch_ok,
        "pucch_metric": pu.detection_metric, "prach_ok": prach_ok,
        "prach_metric": prach_metric, "prach_ta": prach_ta,
        "sinr_dl0": _db(1.0 / torch.clamp(nv_dl0, min=1e-12)),
    }


# --------------------------------------------------------------------------
# back half: decoded bits → CRC/desegment → verification verdicts
# --------------------------------------------------------------------------
def _tb_ok(dec: tuple[torch.Tensor, torch.Tensor], sh: sch.ShConfig,
           tb_ref: torch.Tensor) -> torch.Tensor:
    """[B] verdict of decoded codeblocks (bits [B, C, K], ok [B, C]): every
    codeblock converged, the TB CRC passes and the TB is the sent one."""
    bits, okc = dec
    tb, tb_crc, _ = segmentation.desegment_rx(bits, sh.segments)
    return tb_crc & okc.all(dim=-1) & torch.all(tb == tb_ref, dim=-1)


def _control_ok(front: dict, cfg: MixedSlotConfig) -> torch.Tensor:
    """[B] verdict of the slot's channels other than the four shared
    channels: PDCCH (per REG and the DCI), SSB, PSS, PUCCH and PRACH."""
    # ssb_match = 1 − relative error, whose floor at the SNR is
    # 10^(−snr/10): gate at 5× the floor.  Under delay spread the per-PRB
    # flat fit leaves the tap rotation within a PRB as residual, the PDCCH
    # check loses a little, and the flat PSS correlation decorrelates (a
    # UE's timing search would absorb it): those gates widen.
    floor = 5.0 * 10 ** (-cfg.snr_db / 10)
    if cfg.tdl_delays:
        floor = max(floor, 0.05)
    pdcch_gate = 0.95 if cfg.tdl_delays else 0.99
    pss_gate = 0.6 if cfg.tdl_delays else 0.8
    return ((front["pdcch_match"] > pdcch_gate) & front["dci_crc_ok"]
            & (front["ssb_match"] > 1.0 - floor)
            & (front["pss_corr"] > pss_gate)
            & front["pucch_ok"] & front["prach_ok"])


def _mixed_back(front: dict, payloads: dict, cfg: MixedSlotConfig,
                dec: dict) -> MixedSlotResult:
    ul0_ok = _tb_ok(dec["u0"], cfg.pusch0, payloads["tb_ul0"])
    ul1_ok = _tb_ok(dec["u1"], cfg.pusch1, payloads["tb_ul1"])
    if cfg.ue_decode_dl:
        dl0_ok = _tb_ok(dec["d0"], cfg.pdsch0, payloads["tb_dl0"])
        dl1_ok = _tb_ok(dec["d1"], cfg.pdsch1, payloads["tb_dl1"])
    else:
        dl0_ok, dl1_ok = front["dl0_pre"], front["dl1_pre"]
    sinr_u0 = _db(1.0 / torch.clamp(front["u0"].post_noise_var, min=1e-12))
    sinr_u1 = _db(1.0 / torch.clamp(front["u1"].post_noise_var, min=1e-12))
    ok = (ul0_ok & ul1_ok & dl0_ok & dl1_ok
          & _control_ok(front, cfg))
    return MixedSlotResult(
        ok=ok, sinr_ul_db=0.5 * (sinr_u0 + sinr_u1),
        ul0_ok=ul0_ok, ul1_ok=ul1_ok,
        dl0_match=front["dl0_match"], dl1_match=front["dl1_match"],
        dl0_ok=dl0_ok, dl1_ok=dl1_ok,
        pdcch_match=front["pdcch_match"], dci_crc_ok=front["dci_crc_ok"],
        ssb_match=front["ssb_match"], pss_corr=front["pss_corr"],
        pucch_ok=front["pucch_ok"], pucch_metric=front["pucch_metric"],
        prach_ok=front["prach_ok"], prach_metric=front["prach_metric"],
        csi_sinr_db=front["csi_sinr_db"], sinr_ul0_db=sinr_u0,
        sinr_ul1_db=sinr_u1, sinr_dl0_db=front["sinr_dl0"],
        prach_ta_samples=front["prach_ta"])


def _dci_recheck(pdcch_llr: torch.Tensor, dci_payload: torch.Tensor,
                 cfg: MixedSlotConfig) -> torch.Tensor:
    """Full DCI re-check of one slot: polar SSC decode + CRC24C/RNTI unmask
    + payload compare on the candidate LLRs [E] → bool scalar tensor (True
    when the downlink control checks are off)."""
    if not cfg.verify_dl_ctrl:
        return torch.ones((), dtype=torch.bool, device=pdcch_llr.device)
    dci = pdcch_proc.decode_dci_llr(pdcch_llr, cfg.pdcch_dl)
    return dci.crc_ok & torch.all(dci.payload == dci_payload)


def mixed_slot_batch(payloads: dict, noise_dl: torch.Tensor,
                     noise_ul: torch.Tensor,
                     cfg: MixedSlotConfig) -> MixedSlotResult:
    """A batch of B mixed slots: payloads {name: [B, n] int8}, noise
    [B, 2, slot_samples] complex64 per link.

    The full DCI re-check (a few hundred small ops) runs once per batch, on
    slot 0, and its verdict holds for the batch; every slot keeps its own
    per-REG PDCCH check.  Each decoded UE's [B, C, N] LLRs decode in one
    decoder launch of B·C rows (both PUSCH, and both PDSCH with
    ue_decode_dl).
    """
    front = _with_dci(_mixed_front(payloads, noise_dl, noise_ul, cfg),
                      payloads, cfg)
    return _mixed_back(front, payloads, cfg, decode_front(front, cfg))


def _with_dci(front: dict, payloads: dict, cfg: MixedSlotConfig) -> dict:
    """The front half with its batch's DCI verdict: the full re-check of
    slot 0, held for the batch."""
    bsz = front["prach_ok"].shape[0]
    front["dci_crc_ok"] = _dci_recheck(front["pdcch_llr"][0],
                                       payloads["dci_dl"][0],
                                       cfg).expand(bsz)
    return front


def decode_names(cfg: MixedSlotConfig) -> list[tuple[str, sch.ShConfig]]:
    """The decoded UEs of a batch and their configs: both PUSCH (u0, u1),
    then both PDSCH (d0, d1) with ue_decode_dl."""
    names = [("u0", cfg.pusch0), ("u1", cfg.pusch1)]
    if cfg.ue_decode_dl:
        names += [("d0", cfg.pdsch0), ("d1", cfg.pdsch1)]
    return names


def decode_front(front: dict, cfg: MixedSlotConfig) -> dict:
    """A batch's front half → {name: (codeblock bits [B, C, K], ok [B, C])}
    for each of ``decode_names(cfg)``, one decoder launch per UE."""
    return {name: sch.decode_cbs(front[name].llr_full, sh,
                                 cfg.nof_ldpc_iterations)
            for name, sh in decode_names(cfg)}


def mixed_slot(payloads: dict, noise_dl: torch.Tensor,
               noise_ul: torch.Tensor, cfg: MixedSlotConfig
               ) -> MixedSlotResult:
    """One mixed slot: payloads {name: [n]}, noise [2, slot_samples] per
    link → a result of scalar tensors."""
    res = mixed_slot_batch({k: v[None] for k, v in payloads.items()},
                           noise_dl[None], noise_ul[None], cfg)
    return MixedSlotResult(**{f.name: getattr(res, f.name)[0]
                              for f in dataclasses.fields(res)})


# --------------------------------------------------------------------------
# HARQ: a first transmission at rv=0, its retransmission, the soft combine
# --------------------------------------------------------------------------
def draw_harq_noise(cfg: MixedSlotConfig, batch: int,
                    generator: torch.Generator, ul_snr_db: float
                    ) -> tuple[torch.Tensor, ...]:
    """The channel noise of `batch` HARQ pairs, drawn in one call on the
    generator's device: (downlink, uplink) of the first transmission, then
    of the retransmission, each [batch, 2, slot_samples] complex64; the
    downlink at ``cfg.snr_db``, the uplink at `ul_snr_db`."""
    nz = torch.randn((4, batch, 2, 2, cfg.slot_samples), generator=generator,
                     device=generator.device, dtype=torch.float32)
    sd_dl = noise_sigma(cfg) / math.sqrt(2.0)
    sd_ul = noise_sigma(dataclasses.replace(cfg, snr_db=ul_snr_db)
                        ) / math.sqrt(2.0)
    return tuple(torch.complex(nz[i, :, 0], nz[i, :, 1]) * sd
                 for i, sd in enumerate((sd_dl, sd_ul, sd_dl, sd_ul)))


def _harq_fronts(payloads: dict, noise: tuple[torch.Tensor, ...],
                 cfg: MixedSlotConfig, retx_rv: int
                 ) -> tuple[dict, dict, MixedSlotConfig]:
    """Both transmissions' front halves, the first with both PUSCH at rv=0,
    the second at `retx_rv` → (front 1, front 2, the second's config)."""
    cfg2 = dataclasses.replace(
        cfg, pusch0=dataclasses.replace(cfg.pusch0, rv=retx_rv),
        pusch1=dataclasses.replace(cfg.pusch1, rv=retx_rv))
    return (_mixed_front(payloads, noise[0], noise[1], cfg),
            _mixed_front(payloads, noise[2], noise[3], cfg2), cfg2)


def _combined_decode(first: dict, second: dict, cfg2: MixedSlotConfig
                     ) -> dict:
    """Each PUSCH's softbuffer (the first transmission's full-buffer LLRs)
    combined with the retransmission's and decoded on the full graph →
    {"u0"/"u1": (codeblock bits [B, C, K], ok [B, C])}."""
    return {name: sch.decode_cbs(
                harq.soft_combine(second[name].llr_full,
                                  first[name].llr_full),
                sh, cfg2.nof_ldpc_iterations)
            for name, sh in (("u0", cfg2.pusch0), ("u1", cfg2.pusch1))}


@dataclasses.dataclass
class HarqPairResult:
    """Verdicts of a batch of B HARQ pairs.  ``first`` and ``second`` are
    the two transmissions' mixed slots: the first's PUSCH verdicts are
    those of its own rv=0 decode, the second's those of the combined
    decode (so ``second.ul0_ok`` is UE0's ``combined_ok``)."""
    ok: torch.Tensor              # [B] the pair as the link is set up
    first: MixedSlotResult
    second: MixedSlotResult
    combined: dict                # "u0"/"u1": (bits [B, C, K], ok [B, C])

    @property
    def first_ok(self) -> dict:
        return {"u0": self.first.ul0_ok, "u1": self.first.ul1_ok}

    @property
    def combined_ok(self) -> dict:
        return {"u0": self.second.ul0_ok, "u1": self.second.ul1_ok}


def harq_pair_batch(payloads: dict, noise: tuple[torch.Tensor, ...],
                    cfg: MixedSlotConfig, retx_rv: int = 2
                    ) -> HarqPairResult:
    """A batch of B HARQ pairs as a gNB receives them, both transmissions
    full mixed slots on the same payloads {name: [B, n] int8}: the first
    with both PUSCH at rv=0, decoded on the truncated graph, its full-buffer
    LLRs kept as each PUSCH's softbuffer; the retransmission at `retx_rv`,
    its LLRs combined with the softbuffer (``harq.soft_combine``) and the
    sum decoded on the full graph.  noise: (downlink, uplink) of the first
    transmission, then of the second, each [B, 2, slot_samples] (e.g.
    ``draw_harq_noise``).

    ``ok`` holds when every first transmission fails, every combination
    passes and every other verdict of both slots holds: the link set below
    the first transmission's cliff.  The tracer's span ``harq.pair`` covers
    the batch."""
    with tracer.span("harq.pair", "harq"):
        f1, f2, cfg2 = _harq_fronts(payloads, noise, cfg, retx_rv)
        first = _mixed_back(_with_dci(f1, payloads, cfg), payloads, cfg,
                            decode_front(f1, cfg))
        combined = _combined_decode(f1, f2, cfg2)
        dec2 = {name: sch.decode_cbs(f2[name].llr_full, sh,
                                     cfg.nof_ldpc_iterations)
                for name, sh in decode_names(cfg2) if name not in combined}
        second = _mixed_back(_with_dci(f2, payloads, cfg2), payloads, cfg2,
                             {**dec2, **combined})
        ok = (~first.ul0_ok & ~first.ul1_ok & first.dl0_ok & first.dl1_ok
              & _control_ok(f1, cfg) & second.ok)
        return HarqPairResult(ok=ok, first=first, second=second,
                              combined=combined)


def harq_retx_batch(payloads: dict, noise: tuple[torch.Tensor, ...],
                    cfg: MixedSlotConfig, snr1_db: float, retx_rv: int = 2,
                    device: torch.device | str | None = None) -> dict:
    """HARQ retransmission on the mixed-slot path, held against the JAX
    package: the first transmission carries both PUSCH at rv=0 at snr1_db,
    below the MCS cliff; the second retransmits the same TBs at rv=retx_rv;
    the gNB adds the two transmissions' full circular-buffer LLRs (the
    softbuffer combine) and decodes the sum on the full graph.  Besides,
    the retransmission is decoded alone (a check that it fails, which a
    gNB does not run).  The fronts and the combined decode are
    ``harq_pair_batch``'s.

    noise: (downlink, uplink) of the first transmission, then of the
    second, each [B, 2, slot_samples] with ``noise_sigma`` at snr1_db.
    Runs on `device` (default: the current CUDA device).  Returns
    {"u0"/"u1": {"first_ok", "retx_ok", "combined_ok"}}, each [B].
    """
    dev = resolve_device(device)
    payloads = {k: v.to(dev) for k, v in payloads.items()}
    noise = [n.to(dev) for n in noise]
    cfg1 = dataclasses.replace(cfg, snr_db=snr1_db)
    f1, f2, cfg2 = _harq_fronts(payloads, noise, cfg1, retx_rv)
    combined = _combined_decode(f1, f2, cfg2)
    iters = cfg.nof_ldpc_iterations
    out = {}
    for name, sh1, sh2, key in (("u0", cfg1.pusch0, cfg2.pusch0, "tb_ul0"),
                                ("u1", cfg1.pusch1, cfg2.pusch1, "tb_ul1")):
        sent = payloads[key]
        out[name] = {
            "first_ok": _tb_ok(sch.decode_cbs(f1[name].llr_full, sh1, iters),
                               sh1, sent),
            "retx_ok": _tb_ok(sch.decode_cbs(f2[name].llr_full, sh2, iters),
                              sh1, sent),
            "combined_ok": _tb_ok(combined[name], sh1, sent)}
    return out


def harq_batch_fn_for_pipeline(cfg: MixedSlotConfig,
                               ul_snr_db: float) -> tuple:
    """The ``SlotPipeline`` batch contract for HARQ pairs, a (run, draw)
    pair: run (payloads {name: [B, n]}, the four noise tensors of
    ``draw_harq_noise``) → (ok [B], sinr_ul_db [B], the mean of both
    slots'); draw is ``draw_harq_noise`` with the uplink at `ul_snr_db`.
    A pipeline slot is one pair (two mixed slots)."""
    def run(payloads: dict, *noise: torch.Tensor):
        res = harq_pair_batch(payloads, noise, cfg)
        return res.ok, 0.5 * (res.first.sinr_ul_db + res.second.sinr_ul_db)
    return run, lambda batch, generator: draw_harq_noise(
        cfg, batch, generator, ul_snr_db)


def mixed_slot_dict(payloads: dict, noise_dl: torch.Tensor,
                    noise_ul: torch.Tensor, cfg: MixedSlotConfig) -> dict:
    """``mixed_slot`` with its result as a dict of scalar tensors."""
    return dict(vars(mixed_slot(payloads, noise_dl, noise_ul, cfg)))


def _pipeline_fn(cfg: MixedSlotConfig, slot) -> tuple:
    def run(payloads: dict, noise_dl: torch.Tensor, noise_ul: torch.Tensor):
        res = slot(payloads, noise_dl, noise_ul, cfg)
        return res.ok, res.sinr_ul_db
    return run, lambda batch, generator: draw_noise(cfg, batch, generator)


def batch_fn_for_pipeline(cfg: MixedSlotConfig) -> tuple:
    """The ``SlotPipeline`` batch contract, a (run, draw) pair: run
    (payloads {name: [B, n]}, noise_dl, noise_ul [B, 2, slot_samples]) →
    (ok [B], sinr_ul_db [B]); draw is ``draw_noise``."""
    return _pipeline_fn(cfg, mixed_slot_batch)


def slot_fn_for_pipeline(cfg: MixedSlotConfig) -> tuple:
    """The ``SlotPipeline`` slot contract, a (run, draw) pair: run
    (payloads {name: [n]}, noise_dl, noise_ul [2, slot_samples]) → (ok,
    sinr_ul_db) scalars; the pipeline runs the B slots of a batch one
    after another."""
    return _pipeline_fn(cfg, mixed_slot)
