"""Flagship model: the full PDSCH→channel→PUSCH slot loopback.

Counterpart of ``srsran_project_23_5_tpu/models/gnb_flagship.py``.  For each
slot of a batch a transport block is encoded onto a downlink grid,
OFDM-modulated to baseband, passed through the channel (additive noise
given by the caller), OFDM-demodulated and received through the full PUSCH
chain.  The slot batch is the leading dimension of every tensor; carriers
batch along it too, and ``sharded_multi_carrier_step`` splits them over
the ranks of a mesh (``parallel/mesh.py``).

The default transport block is 40984 bits where the JAX module has 40976.
Both are TS 38.214 §5.1.3.2 sizes for N'_info = 40960: 40976 for code rates
above 1/4 (BG1, 5 codeblocks), 40984 for rates up to 1/4 (BG2, 11
codeblocks).  The flagship's rate is 0.19, which selects BG2, and 40976 + 24
CRC bits do not split into 11 codeblocks, so the JAX default cannot be
segmented; 40984 gives the intended 11 codeblocks of 3752 payload bits.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch

from ..parallel import mesh as mesh_lib
from ..phy.lower import ofdm
from ..phy.upper import sch
from ..ran import numerology
from ..utils import graphs
from ..utils.tracing import tracer

FLAGSHIP_TBS = 40984    # TS 38.214 TBS at R <= 1/4 (see the module note)


@dataclasses.dataclass(frozen=True)
class CarrierConfig:
    """Static per-carrier configuration of the loopback pipeline."""
    mu: int = 1
    nfft: int = 4096
    nof_prb: int = 273
    sh: sch.ShConfig = dataclasses.field(
        default_factory=lambda: sch.ShConfig(
            rnti=0x4601, tbs=FLAGSHIP_TBS, qm=6, nof_prb=273,
            dmrs_symbols=(2, 7, 11)))

    @property
    def nsc(self) -> int:
        return self.nof_prb * 12

    @property
    def slot_samples(self) -> int:
        return numerology.slot_num_samples(self.mu, self.nfft)


def default_carrier(nof_prb: int = 273, qm: int = 6,
                    tbs: int = FLAGSHIP_TBS) -> CarrierConfig:
    """The 100 MHz, μ=1 carrier (273 PRB, nfft 4096, 64QAM) by default."""
    return CarrierConfig(
        mu=1, nfft=numerology.min_nfft(nof_prb), nof_prb=nof_prb,
        sh=sch.ShConfig(rnti=0x4601, tbs=tbs, qm=qm, nof_prb=nof_prb,
                        dmrs_symbols=(2, 7, 11)))


def tiny_carrier() -> CarrierConfig:
    """Small shapes for dry runs and CI."""
    return CarrierConfig(
        mu=1, nfft=128, nof_prb=8,
        sh=sch.ShConfig(rnti=0x17, tbs=256, qm=2, nof_prb=8,
                        dmrs_symbols=(2, 7, 11)))


def tx_batch(tb_bits: torch.Tensor, cfg: CarrierConfig) -> torch.Tensor:
    """Downlink slots: TB bits [B, A] int8 → baseband [B, slot_samples]."""
    grid = torch.zeros((tb_bits.shape[0], 14, cfg.nsc), dtype=torch.complex64,
                       device=tb_bits.device)
    grid = sch.pdsch_transmit(tb_bits, cfg.sh, grid)
    return ofdm.modulate_slot(grid, cfg.mu, cfg.nfft)


def loopback_batch(tb_bits: torch.Tensor, noise: torch.Tensor,
                   cfg: CarrierConfig, nof_ldpc_iterations: int = 6
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched DL+UL slots: TB [B, A] → baseband → +noise [B, slot_samples]
    → RX chain.  Returns (tb_ok [B], decoded bits [B, A], sinr_db [B])."""
    bb = tx_batch(tb_bits, cfg)
    rx_grid = ofdm.demodulate_slot(bb + noise, cfg.nsc, cfg.mu, cfg.nfft)
    res = sch.pusch_receive(rx_grid[:, None], cfg.sh,
                            nof_ldpc_iterations=nof_ldpc_iterations)
    return res.tb_crc_ok, res.tb_bits, res.sinr_db


def tx_slot(tb_bits: torch.Tensor, cfg: CarrierConfig) -> torch.Tensor:
    """One downlink slot: TB bits [A] → baseband [slot_samples]."""
    return tx_batch(tb_bits[None], cfg)[0]


def loopback_slot(tb_bits: torch.Tensor, noise: torch.Tensor,
                  cfg: CarrierConfig, nof_ldpc_iterations: int = 6):
    """One DL+UL slot: TB [A], noise [slot_samples] → (tb_ok, decoded bits
    [A], sinr_db), as the JAX ``loopback_slot``."""
    ok, bits, sinr = loopback_batch(tb_bits[None], noise[None], cfg,
                                    nof_ldpc_iterations)
    return ok[0], bits[0], sinr[0]


def multi_carrier_step(cfg: CarrierConfig, nof_ldpc_iterations: int = 6):
    """The carrier-batched loopback step: ([C, A] bits, [C, slot_samples]
    noise) → (ok [C], sinr [C], bit_errors [C] int32), the carriers one
    batch; bit_errors counts the decoded TB bits that differ from the sent
    ones, so that a TB whose CRC passes with wrong bits shows."""
    def step(tb_batch: torch.Tensor, noise_batch: torch.Tensor):
        ok, bits, sinr = loopback_batch(tb_batch, noise_batch, cfg,
                                        nof_ldpc_iterations)
        return ok, sinr, (bits != tb_batch).sum(dim=-1, dtype=torch.int32)
    return step


def sharded_multi_carrier_step(mesh, cfg: CarrierConfig,
                               nof_ldpc_iterations: int = 6):
    """The multi-carrier step with the carrier axis split over `mesh`: every
    rank takes the global ([C, A], [C, slot_samples]) inputs, runs
    ``loopback_batch`` on its C / shards carriers on its own device and
    gathers the global (ok [C], sinr [C], bit_errors [C]).

    The rank's loopback is a captured program (``utils/graphs``) of its own
    pool: on a card its first call warms up and captures it, and every
    step after is one graph replay, so that the host's launches do not
    pace the card; on the CPU it runs eagerly.  A replay's outputs live
    until the next replay, and no longer need to: the gathers read them
    after the replay (NCCL waits on the rank's stream) and the next replay
    waits on the gathers (the stream waits on NCCL).

    Traced as ``mesh.step`` (request: the step's index, counted per
    returned function) around ``mesh.local``, ``mesh.loopback`` and
    ``mesh.gather``."""
    shard = mesh_lib.carrier_sharding(mesh)
    step = graphs.GraphPool(mesh_lib.mesh_device(mesh)).program(
        multi_carrier_step(cfg, nof_ldpc_iterations))
    index = itertools.count()

    def sharded(tb_batch: torch.Tensor, noise_batch: torch.Tensor):
        with tracer.span("mesh.step", "mesh", next(index)):
            with tracer.span("mesh.local", "mesh"):
                tb, noise = shard.local(tb_batch), shard.local(noise_batch)
            with tracer.span("mesh.loopback", "mesh"):
                ok, sinr, errors = step(tb, noise)
            with tracer.span("mesh.gather", "mesh"):
                return (shard.gather(ok), shard.gather(sinr),
                        shard.gather(errors))
    return sharded
