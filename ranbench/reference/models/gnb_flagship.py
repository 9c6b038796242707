"""Flagship model: the PDSCH→channel→PUSCH slot loopback of one carrier,
batched over carriers.

Copied from the port's
``srsran_project_23_5_tpu_torch/models/gnb_flagship.py`` (the carrier's
configuration, the transmit and receive order, the decoded-TB bit count),
without its default carrier, and except that it runs on the reference's
own stages: its OFDM (float64, TS 38.211 §5.3.1), constellation mapper,
exhaustive max-log demapper, DM-RS estimator and zero-forcing equaliser,
and the plain LDPC encoder and decoder; ``loopback_batch`` turns TF32 off
before it runs.  It runs every
carrier it is given unsharded: the port's carrier sharding splits the
carriers over ranks and gathers them back, which changes no carrier's
result.
"""
from __future__ import annotations

import dataclasses

import torch

from ..phy.lower import ofdm
from ..phy.upper import sch
from ..ran import numerology


@dataclasses.dataclass(frozen=True)
class CarrierConfig:
    """Static per-carrier configuration of the loopback."""
    mu: int
    nfft: int
    nof_prb: int
    sh: sch.ShConfig

    @property
    def nsc(self) -> int:
        return self.nof_prb * 12

    @property
    def slot_samples(self) -> int:
        return numerology.slot_num_samples(self.mu, self.nfft)


def default_carrier(nof_prb: int, qm: int, tbs: int) -> CarrierConfig:
    """A μ=1 carrier of `nof_prb` PRBs at the smallest nfft that holds it,
    one PDSCH/PUSCH allocation over all of them (DM-RS on symbols 2, 7 and
    11)."""
    return CarrierConfig(
        mu=1, nfft=numerology.min_nfft(nof_prb), nof_prb=nof_prb,
        sh=sch.ShConfig(rnti=0x4601, tbs=tbs, qm=qm, nof_prb=nof_prb,
                        dmrs_symbols=(2, 7, 11)))


def tx_batch(tb_bits: torch.Tensor, cfg: CarrierConfig) -> torch.Tensor:
    """Downlink slots: TB bits [B, A] int8 → baseband [B, slot_samples]."""
    grid = torch.zeros((tb_bits.shape[0], 14, cfg.nsc), dtype=torch.complex64,
                       device=tb_bits.device)
    grid = sch.pdsch_transmit(tb_bits, cfg.sh, grid)
    return ofdm.modulate_slot(grid, cfg.mu, cfg.nfft)


def rx_grid(tb_bits: torch.Tensor, noise: torch.Tensor,
            cfg: CarrierConfig) -> torch.Tensor:
    """The received grids [B, 1, 14, nsc] of the slots: baseband plus
    `noise` [B, slot_samples], OFDM-demodulated."""
    bb = tx_batch(tb_bits, cfg)
    return ofdm.demodulate_slot(bb + noise, cfg.nsc, cfg.mu, cfg.nfft)[:, None]


def loopback_batch(tb_bits: torch.Tensor, noise: torch.Tensor,
                   cfg: CarrierConfig, nof_ldpc_iterations: int = 6
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Batched DL+UL slots: TB [B, A] → baseband → +noise [B, slot_samples]
    → RX chain.  Returns (tb_ok [B], decoded bits [B, A], sinr_db [B],
    bit_errors [B] int32: the decoded bits that differ from the sent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    res = sch.pusch_receive(rx_grid(tb_bits, noise, cfg), cfg.sh,
                            nof_ldpc_iterations=nof_ldpc_iterations)
    errors = (res.tb_bits != tb_bits).sum(dim=-1, dtype=torch.int32)
    return res.tb_crc_ok, res.tb_bits, res.sinr_db, errors
