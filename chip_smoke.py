#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (srsran_project_23_5_tpu_torch) on one
NVIDIA GPU.

Phases, one line each:

1. device  — refuses to run without CUDA; prints the card's name and power
   limit as nvidia-smi gives them;
2. build   — builds the kernel library from ``csrc/`` (nvcc, sm_90a);
3. encoder — kernel vs ``encode_plain`` on the card, bit for bit, at the
   flagship shape (BG2 Z=384, 88 codeblocks), at the mixed slot's four
   shapes (BG1 Z=384 x128, x56, x136; BG1 Z=352 x64), at lifting sizes
   that 32 does not divide (Z=36, 208, 15, 104) and a batch that is not a
   multiple of 8;
4. decoder — kernel vs ``decode_plain`` on the card, bits and ok
   identical, at the flagship shape and the mixed slot's two shapes (BG1
   Z=384 n_used 35 x136, BG1 Z=352 n_used 36 x64), each converging and with
   mixed convergence, on truncated graphs, at Z=36, on the full BG1 graph at
   Z=320/352/384 and on the full BG2 graph at Z=352/384; the CTAs per SM at
   each main-path shape, and the phase split of one CTA (LLR load + c2v
   clear, sweeps, syndrome, bit write) from the kernel's diagnostic
   instance at x136 n_used 35 and on the full graph at Z=384 x8;
4b. pusch-llr — the PUSCH LLR kernel vs ``pusch_llr_plain`` on the card,
   bit for bit, and its EVM within rtol 1e-5 of ``evm_plain`` (the largest
   relative gap printed and in the kernels line), at the five PUSCH shapes
   of the benchmark cells (the mixed slot's two at B=64, the FAPI carrier's
   A and B at B=1, the flagship273.mesh4 carrier's QPSK PUSCH at B=128)
   with their own scrambling signs, each timed beside its bytes bound and
   the plain chain (LLRs and EVM);
4c. channel-mix — the channel mix kernel vs ``channel_mix_plain`` on the
   card within 1e-6 of the largest output magnitude, at the mixed slot's
   two mixes (DL: the 2×2 port mix; UL: the port mix plus the 1-port
   PUSCH and PUCCH/PRACH streams) of the [B, 2, 14, 3276] grid at the
   scan cells' B = 8 and B = 64, on the slot's own channels, each timed
   beside its bytes bound and the plain expression (einsum and adds);
5. slice   — ``SlotPipeline`` on the 273-PRB flagship carrier, 8 slots per
   batch, depth 2, 20 dB: warmup + submits + drain; every TB CRC ok, mean
   SINR within 1.5 dB of 20, every counted kernel but the channel mix
   launched in that run and the channel mix not at all; decoded bits equal
   the sent bits; a small slot on the card agrees with the same slot
   through the plain versions on the CPU; kernel and plain times at the
   flagship shapes;
6. profile — torch.profiler over two flagship batches: device busy share,
   the top kernels, each LDPC kernel's device time per launch;
7. mixed   — the 273-PRB mixed slot (2×PDSCH with 2-layer MIMO, PDCCH, SSB,
   CSI-RS, 2×PUSCH, PUCCH F1, PRACH) through ``SlotPipeline`` with
   ``gnb_mixed.batch_fn_for_pipeline``, 8 slots per batch, depth 2, 20 dB:
   warmup + submits + drain; every slot ok, mean UL SINR within 1.0 dB of
   20, 4 encoder, 2 decoder, 2 pusch_llr and 2 channel_mix launches per
   batch; how many slots passed each check; the wall time of each stage
   of a batch; kernel and plain times at the mixed shapes, and the
   decoder's phase split on the mixed slot's own LLRs;
8. mixed-cpu — a ``tiny_mixed`` batch of 2 on the card against the same
   payloads and noise through the plain versions on the CPU: every verdict
   and the decoded bits equal, SINRs within 0.1 dB;
9. mixed-profile — torch.profiler over two mixed batches, and over the
   once-per-batch DCI re-check alone (its device op count);
10. upper-phy — ``UpperPhy`` (FAPI DL_TTI/UL_TTI → grids → indications) on
   the 273-PRB carrier of ``models/fapi_carrier.py``, 4 rx ports, 20 dB,
   each slot one replay of its signature's captured CUDA graph
   (``utils/graphs.py``): 8 DL slots (SSB, 2×PDCCH, 2×PDSCH, CSI-RS; one
   slot a VRB-interleaved PDSCH over the BWP), each grid equal to the
   CPU's on two slots and each PDSCH passing ``symbol_verify`` after OFDM
   and AWGN; 8 UL slots rotating two mixes (4-layer PUSCH, PUSCH with UCI
   and time interpolation, PUCCH F1 and F2, a multi-root PRACH; or PUSCH B
   and F1): every CRC, payload, UCI bit, preamble and TA recovered, PUSCH
   B's SINR within 1 dB of 20, one decoder launch per decode group and
   replay (and the eager warm-up's where a slot captured), the first slot
   equal to the CPU's, and the kernel equal to ``decode_plain`` on the
   LLRs each decode group of that slot handed it (BG1 Z=384 x34 n_used 35,
   x8 n_used 33); two HARQ pairs at 14 dB (rv=0 fails, rv=2 combined on
   the full BG1 graph at Z=384 passes and releases the softbuffer; the
   second pair replays the first's graphs); every DL and UL slot's replay
   equal to its program's eager run on the same inputs (bits and verdicts
   exact, floats within 1e-5 of max|ref|); three UL programs for the two
   mixes and the retransmission, one capture per DL and UL signature;
   captures, capture seconds, pool bytes, launches per replay; ms per DL
   and UL slot (median, p90) and the programs alone, replay against eager
   body; the full-graph decoder against ``decode_plain`` and the truncated
   graph (both checked against ``decode_plain`` first), and its phase
   split;
11. upper-profile — torch.profiler over two DL slots and two full-mix UL
   slots of the upper PHY, and over one replay and one eager run of the
   DL and the full-mix UL program;
12. mixed-variants — the 273-PRB mixed slot's options through
   ``SlotPipeline``, 8 slots per batch: the TDL channel (``tdl_channel``
   at 30 dB; its verdicts at 20 dB are printed, not gated),
   the UE-side PDSCH decode (``ue_decode_dl``: 4 decoder and 4 pusch_llr
   launches per batch, 2 channel_mix launches a batch in each option;
   its two PDSCH decode shapes, BG1 Z=384 x128 and x56 n_used 34, held
   bit-exact against ``decode_plain`` first and timed) and the grid
   PRACH; every slot ok under the JAX slot's gates,
   µs/slot each;
13. harq — HARQ pairs at 273 PRB: ``harq_pair_batch`` swept over an
   uplink SNR of 11-14 dB in 0.5 dB steps (the downlink at 20 dB), 64
   pairs a batch, 32 batches on each of 3 seeds a point; the widest run
   of points where no first transmission passes and no combination fails
   (at least 1 dB) is printed, and its midpoint is snr1; at snr1, 8 pairs
   a batch, ``harq_pair_batch`` (8 encoder, 4 decoder, 4 pusch_llr and 4
   channel_mix launches, every pair ok) and ``harq_retx_batch`` (8, 6, 4
   and 4; first and retx fail, the combination passes), each driven once
   with the counts reset; the full-graph decodes of the combined LLRs at
   8 pairs (BG1 Z=384 x136, Z=352 x64) and 64 (x1088, x512) bit-exact
   against ``decode_plain``, timed, with CTAs per SM, waves and (x136,
   x64) the phase split;
14. receivers — on the flat mixed slot's UE grid (port 0):
   ``pdcch_blind_receive`` for each RNTI over CCEs {0, 4, 8, 12} at AL4
   (only the true candidate passes, with the sent DCI) and
   ``ssb_receive_pbch`` (the sent 32 bits); an ``UpperPhy`` DL slot with a
   DCI on an interleaved 2-symbol CORESET (48 PRB, R=2, shift = PCI)
   through OFDM and AWGN, received by ``pdcch_receive``;
15. lower — ``AsyncLowerPhy`` (μ=1, nfft 4096, 273 PRB, depth 2) streams 8
   FAPI-carrier DL grids out in odd-sized chunks and back in through AWGN;
   PDSCH A of each slot decodes through ``sch.pusch_receive``; tx stats
   and µs/slot; a format-0 long preamble (L=839, root 129, N_cs 13) at
   122.88 MHz (PRACH FFT 98,304, CP 12,672) whose window spans two slots,
   through ``PrachWindowAssembler``, detected with its delay; the same for
   restricted set A (root 201, N_cs 26);
16. scan — the 273-PRB mixed slot through ``SlotPipeline``'s scan mode
   (K = 8 batches per dispatch, one ``utils/graphs.Program``) at B = 8 and
   B = 64: first, under ``kernel_taps.tapped_kernels`` (a copy of each
   call's tensors, captured with the graph and copied out after each
   replay), every launch of one replay takes and gives, bit for bit, what
   the same launch of the eager K-batch loop on the same seed takes and
   gives, and every eager launch equals its plain version; at B = 64 the
   kernels' shapes there (BG1 Z=384 x1088 and x1024 and x448, Z=352 x512)
   are timed with their bounds.  Then, untapped: capture time and peak
   device memory; one replay against the eager K-batch loop on the same
   seed (all_ok equal, sinr_sum within 1e-6 relative, bit-equality
   reported); a replay with the static noise ×100 must fail; a window of
   several dispatches and one ``fetch_accumulated``, every slot ok, the
   launches per replay (4K encoder, 2K decoder, 2K pusch_llr, 2K
   channel_mix, counted by the capture and checked against the kernels the
   profiler sees the device run in one replay).  The benchmark's
   ``mixed273.*`` cells time the scan mode;
17. flagship-scan — the same for the flagship loopback at B = 8, K = 8
   (K encoder, K decoder and K pusch_llr launches per replay, no
   channel_mix), untimed;
18. accumulate — ``submit_accumulated`` over 3 eager mixed batches against
   the reduction of ``drain()`` of a pipeline with the same seed;
19. ops — the ops the port gained with the scan mode (bit packing, host
   CRC and encoder references, the table and π/2-BPSK mappers, LLR
   quantisation and hard decisions, the per-codeblock rate matcher,
   layer demapping and the one-layer codebook, MMSE 1×N and 2×2 ZF, the
   OFDM rx window offset, ``pdsch_transmit(w=)``) once each on the card at
   273 PRB against the same call on the CPU;
20. app — the gNB application (``apps.gnb.Gnb`` built with ``from_dict``)
   in its over-the-air loopback mode with ``configs/gnb_loopback.yml``'s
   settings at 273 PRB (μ=1, nfft 4096, TDD period 10 with 6 DL and 3 UL
   slots, 300 slots, 30 dB, 6+6 packets) on the card: CU-CP, CU-UP,
   DU-high, MAC and scheduler, FAPI, ``UpperPhy``, OFDM, AWGN and the UE.
   The UE must reach RRC ACTIVE with every packet delivered both ways,
   one RAR, at least 3 DL decodes, PRACH, PUCCH ACK and F2 CSI sent, a
   CQI > 0 at the scheduler, and every counted kernel but the channel
   mix launched.  Every
   LDPC launch the run made (gNB PDSCH encode and PUSCH decode, UE PUSCH
   encode and PDSCH decode; tapped in ``sch`` and ``slot_programs``) is
   bit-exact against its plain version, and each distinct shape is timed
   with its bound.
   Printed: ms per slot (median and p90 after attach, over all slots and
   over the slots with PHY work), slots/s, the split of a slot over the
   host stack, the gNB DL and UL PHY, OFDM + AWGN, the UE's DL side and
   its UL build; the device busy share of 20 slots under torch.profiler;
   the same run on the CPU gives the same report (but its wall clock) and
   the same uplink indications slot by slot.  The gNB's ``UpperPhy`` and
   the UE modem (CSI-RS SINR, blind DCI decode, PDSCH receive, PUSCH and
   PUCCH F1/F2 transmit) run as captured programs: their captures,
   capture seconds, replays and pool bytes are printed, and every launch
   of a replay is tapped and held against plain like the eager ones;
21. app-ta — the timing-advance closed loop of the JAX slow test
   ``test_gnb_app_ta_closed_loop`` at 273 PRB (FDD, 200 slots, 28 dB, a
   UE timing error of 12 samples): the UE attaches and its TA ends within
   2.5 samples of 12; its launches bit-exact against plain too;
22. fronthaul — the 273-PRB FAPI carrier (μ=1, nfft 4096, 4 rx ports, 20
   dB) driven by an SCF-speaking MAC and carried over the fronthaul.  Its
   DL and UL slots are built with ``fapi.builders`` and translated with
   ``fapi.scf`` (what differs from the carrier's own requests is printed:
   what SCF cannot express).  DL over split 7.2: ``UpperPhy`` →
   ``RuOfh`` (BFP w=9, 29 frames) → an RU-side ``OfhSector``: the rebuilt
   grid above 40 dB of SNR, the card's bytes and frames equal to the same
   grid's on the CPU at w = 9, 12, 14, 16, then OFDM + AWGN and every
   PDSCH, DCI and the PBCH recovered.  UL over split 7.2: the UEs' received
   grid leaves four RU-side sectors (one eAxC per rx port, every frame
   offered to each of four DU-side sectors), the rebuilt [4, 14, nsc] grid
   equals the CPU's, and ``UpperPhy`` returns every CRC, payload, UCI bit
   and the preamble (the PRACH window bypasses the OFH).  Split 8:
   ``RuGeneric`` over ``InMemoryRadio`` with AWGN as its channel (DL,
   every channel recovered) and without (the UL grid, every check), over
   ``TrxDriver`` (DL, PDSCH A), and over ``SocketRadio`` at 52 PRB, whose
   slot fits the socket's receive buffer.  Every LDPC launch is tapped and
   bit-exact against its plain version.  Printed with the card: µs per
   slot and eAxC for DL compress + frame and UL reassemble + decompress
   (synchronised, ``utils.benchmark`` percentiles, ``utils.tracing``
   spans), the device time of the slot's BFP pack and unpack, bytes per
   slot and eAxC, the BFP SNR at w = 9, 12, 14, and torch.profiler over
   5 DL and 5 UL slots;
23. scale-out — the carrier and slot meshes on ``torch.distributed``.
   (a) NCCL, a world of one rank in this process (``launch.world_of_one``):
   ``sharded_multi_carrier_step(make_mesh(1), default_carrier())`` over 8
   carriers of the 273-PRB flagship (TBS 40984, BG2 Z=384, 11 CBs; the
   rank's loopback captured, so the first step launches each kernel twice:
   the warm-up's and the replay's) at 20
   dB, every carrier ok and within 1.5 dB with no decoded TB bit wrong,
   verdicts and bit errors equal to ``multi_carrier_step`` on the same
   inputs and SINRs within 1e-3 dB;
   the halo on an axis of one shard is the slot's own tail; one 273-PRB
   mixed carrier through ``entry.mixed_carrier_step``.  (b) gloo, four
   spawned ranks that all use this card (NCCL cannot put two ranks on one
   GPU): ``entry.dryrun_multichip(4)``, one 273-PRB mixed carrier per rank
   verified in-program at 20 dB, ``global_verdict`` equal on every rank;
   (c) in the same ranks, the slot-sharded PRACH stream across the four
   ranks at the short geometry of ``tests/test_slot_stream.py`` and at the
   format-0 window at 122.88 MHz (110,976 samples against a 61,440-sample
   slot, begun in the previous rank's slot): windows equal to the
   unsharded demodulation within 1e-4 relative, the preamble detected on
   every slot that has one.  Every LDPC launch of every rank is tapped and
   bit-exact against its plain version on the card, each shape timed.
   Printed: ms per carrier step at one and at four ranks (four ranks share
   one card: not a scaling figure) and the halo's time.  The dry run
   ends with its weak-scaling curve, which phase 24 reads;
24. weak-scaling — the curve of phase 23's dry run,
   ``entry.weak_scaling(4, "gloo", "cuda:0")``: one 273-PRB mixed carrier
   per rank at 1, 2 and 4 gloo ranks that share this card (contention,
   not a scaling figure), each point one spawn, each rank timing 7 steps
   (step r on seeds + r, every carrier of every step ok), every carrier
   of the tapped step within 1.5 dB, one global verdict per point; every
   rank's LDPC launches held against plain on the card and each shape
   timed.  Printed: the curve (ms per step, the slowest rank's median,
   and t1/tn), each rank's median and min-max step time, spawn-and-run
   seconds and peak reserved MiB per rank;
25. examples — the four examples through their ``main`` with no
   ``--device`` (the card is their default): ``mixed_slot_demo --prb
   273`` (every channel ok; 4 encoder, 2 decoder, 2 pusch_llr and 2
   channel_mix launches; a
   warm second run, checked alike), ``phy_loopback`` at its defaults (52
   PRB, 16QAM, R=0.5, 15 dB) and at ``--prb 273 --qm 6 --rate 0.65
   --snr-db 20`` (8 slots each, every CRC ok, mean SINR within 1.5 dB,
   8 + 8 + 8 launches), ``radio_ssb``
   (SSBs at slots 0 and 20 detected, PBCH ok) and ``rrc_attach_demo``
   (ACTIVE, 8 messages); every LDPC launch bit-exact against its plain
   version and each shape timed with its bound.

Every timed shape prints the kernel's device time, its bound (the larger
of bytes over 3.35 TB/s and operations over 67 TFLOP/s) and the share of
it, and for the decoder the sweeps the inputs needed (counted by
``decode_plain``).  Then one JSON line with the kernels and, last, the
result line.  Any failure raises and exits non-zero.

    python3 chip_smoke.py          # from the repository root, one GPU
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import socket
import subprocess
import time
import types

import numpy as np
import torch

from ranbench.harness import roofline
from srsran_project_23_5_tpu_torch import entry, ofh, radio, ru
from srsran_project_23_5_tpu_torch.apps import gnb as app_gnb
from srsran_project_23_5_tpu_torch.examples import (mixed_slot_demo,
                                                    phy_loopback, radio_ssb,
                                                    rrc_attach_demo)
from srsran_project_23_5_tpu_torch.fapi import messages as fapi
from srsran_project_23_5_tpu_torch.fapi import scf, validators
from srsran_project_23_5_tpu_torch.models import (fapi_carrier, gnb_flagship,
                                                  gnb_mixed)
from srsran_project_23_5_tpu_torch.ofh import compression as bfp
from srsran_project_23_5_tpu_torch.ops import channel_mix, modulation
from srsran_project_23_5_tpu_torch.ops import prach as prach_ops
from srsran_project_23_5_tpu_torch.ops.ldpc import (decoder_cuda,
                                                    encoder_cuda, graphs,
                                                    segmentation)
from srsran_project_23_5_tpu_torch.parallel import launch
from srsran_project_23_5_tpu_torch.phy import pipeline
from srsran_project_23_5_tpu_torch.phy.lower import (lower_phy, ofdm,
                                                     prach_demod)
from srsran_project_23_5_tpu_torch.phy.upper import (pdcch, sch,
                                                     slot_programs, ssb,
                                                     upper_phy)
from srsran_project_23_5_tpu_torch.radio import trx as trx_mod
from srsran_project_23_5_tpu_torch.ran import numerology
from srsran_project_23_5_tpu_torch.utils import (benchmark, kernel_taps,
                                                 kernels, tracing)

FLAGSHIP_CBS = 88          # 8 slots x 11 codeblocks
SLICE_BATCH = 8
SLICE_SUBMITS = 8
MIXED_SUBMITS = 4
# the mixed slot's codeblocks per batch of SLICE_BATCH slots: encoder
# (bg, z, rows) of pdsch0, pdsch1, pusch0, pusch1; decoder (bg, z, rows,
# n_used) of pusch0, pusch1
MIXED_ENC = [(1, 384, 128), (1, 384, 56), (1, 384, 136), (1, 352, 64)]
MIXED_DEC = [(1, 384, 136, 35), (1, 352, 64, 36)]
UPPER_SLOTS = 8


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean device time of fn() over reps launches (CUDA events), warm.
    queued: hold the stream with a spin kernel while the host enqueues the
    launches, so that a kernel shorter than its launch's host cost is timed
    back to back on the device (fn must not synchronise)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)      # ~50 ms of SM clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time (ms) the card could take (the benchmark's roofline: the
    larger of bytes over the memory rate and operations over the float32
    rate), and which it is."""
    which = ("bytes" if nbytes / roofline.HBM_BYTES_PER_S
             >= ops / roofline.FP32_FLOPS else "operations")
    return roofline.least_seconds(nbytes, ops) * 1e3, which


def encoder_bound(bg: int, zc: int, batch: int) -> tuple[float, str]:
    """Message bytes in, codeword bytes out; one XOR per edge-lane."""
    g = graphs.lifted_graph(bg, zc)
    return _bound(batch * (g.nof_msg_blocks + g.nof_var_blocks) * zc,
                  batch * g.nof_edges * zc)


def decoder_bound(llr: torch.Tensor, bg: int, zc: int, **kw
                  ) -> tuple[float, str, torch.Tensor]:
    """LLRs of the used blocks in, hard bits and ok out; 12 float32 ops per
    edge-lane per sweep, for the sweeps each codeblock needs (counted by
    the plain version on the same LLRs)."""
    g, n, _, n_edges = decoder_cuda._schedule(bg, zc,
                                              kw.get("nof_used_blocks"))
    sweeps = decoder_cuda.sweeps_needed(llr, bg, zc, **kw).cpu()
    batch = llr.shape[0]
    ms, by = _bound(batch * (4 * n * zc + g.nof_msg_blocks * zc + 1),
                    roofline.OPS_PER_EDGE_LANE * n_edges * zc
                    * int(sweeps.sum()))
    return ms, by, sweeps


def _timed(kind: str, shape: str, fn, plain, reps: int, plain_reps: int,
           bound: tuple) -> dict:
    """One timed shape: the kernel (launches queued back to back) and its
    plain version, with the bound and, for the decoder, the sweeps."""
    rec = {"kind": kind, "shape": shape,
           "ms": _time_ms(fn, reps, queued=True),
           "plain_ms": _time_ms(plain, plain_reps),
           "bound_ms": bound[0], "bound_by": bound[1]}
    rec["share"] = rec["bound_ms"] / rec["ms"]
    if len(bound) > 2:
        rec["sweeps"] = [int(bound[2].min()), int(bound[2].max())]
    return rec


def _fmt(rec: dict) -> str:
    sweeps = (f", sweeps {rec['sweeps'][0]}-{rec['sweeps'][1]}"
              if "sweeps" in rec else "")
    return (f"{rec['kind']} {rec['shape']} {rec['ms'] * 1e3:.1f} us (plain "
            f"{rec['plain_ms']:.3f} ms; bound {rec['bound_ms'] * 1e3:.2f} us "
            f"by {rec['bound_by']}, {100 * rec['share']:.1f}% of it{sweeps})")


def _noisy_llr(rng, cw: torch.Tensor, snr_db, zc: int, device) -> torch.Tensor:
    """BPSK LLRs of codewords at per-row SNR (numpy noise), punctured 2Zc
    prefix zeroed."""
    cw = cw.cpu().numpy()
    sigma = np.broadcast_to(
        10 ** (-np.asarray(snr_db, np.float32) / 20), (cw.shape[0],))[:, None]
    llr = 2.0 * ((1 - 2 * cw.astype(np.float32))
                 + sigma * rng.standard_normal(cw.shape).astype(np.float32)
                 ) / sigma ** 2
    llr[:, :2 * zc] = 0.0
    return torch.from_numpy(llr.astype(np.float32)).to(device)


def phase_device() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    print(f"[device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return torch.device("cuda", 0), smi


def phase_build(card: str) -> dict:
    t0 = time.perf_counter()
    lib = kernels.library()
    wall = time.perf_counter() - t0
    # ptxas -v: registers of each kernel (decoder instances by row degree,
    # pusch_llr's by bits per symbol, channel_mix's by streams and width)
    regs = []
    for name, n in re.findall(r"Compiling entry function '(\w+)'.*?Used "
                              r"(\d+) registers", lib.build_log, flags=re.S):
        degree = re.search(r"ILi(\d+)E", name)
        label = ("pusch_llr" if "pusch_llr" in name else
                 "channel_mix" if "channel_mix" in name else
                 "encoder" if "encode" in name else "decoder")
        regs.append(f"{label}{'<%s>' % degree.group(1) if degree else ''} "
                    f"{n} regs")
    summary = ", ".join(regs)
    print(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.1f} s, "
          f"load {wall:.1f} s ({summary}) on {card}")
    return {"build_s": lib.build_seconds}


def phase_encoder(dev, card: str) -> float:
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = 0
    cases = [(2, 384, FLAGSHIP_CBS), *MIXED_ENC, (1, 384, 24), (2, 36, 16),
             (2, 384, 13), (1, 208, 5), (2, 15, 7), (2, 104, 9)]
    for bg, zc, batch in cases:
        k = graphs.lifted_graph(bg, zc).nof_msg_blocks * zc
        msg = torch.randint(0, 2, (batch, k), generator=gen, device=dev,
                            dtype=torch.int8)
        got = encoder_cuda.encode(msg, bg, zc)
        want = encoder_cuda.encode_plain(msg, bg, zc)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        _check(torch.equal(got, want),
               f"encoder kernel != plain at BG{bg} Z={zc} batch {batch}")
    print(f"[encoder] bit-exact vs encode_plain at "
          f"{', '.join(f'BG{b} Z={z} x{n}' for b, z, n in cases)} on {card}")
    return float(max_err)


def phase_decoder(dev, card: str) -> float:
    rng = np.random.default_rng(2)
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [
        # (label, bg, z, batch, snr_db per row, nof_used_blocks)
        ("flagship", 2, 384, FLAGSHIP_CBS, 2.0, 52),
        ("flagship-mixed", 2, 384, FLAGSHIP_CBS,
         np.linspace(-5.0, -1.0, FLAGSHIP_CBS), 52),
        *[(f"mixed-BG1-Z{z}{tag}", bg, z, rows, snr, n_used)
          for bg, z, rows, n_used in MIXED_DEC
          for tag, snr in (("", 6.0),
                           ("-mixed", np.linspace(2.0, 6.0, rows)))],
        ("BG1-truncated", 1, 384, 24, np.linspace(1.0, 5.0, 24), 40),
        ("BG2-truncated", 2, 384, 24, np.linspace(0.0, 4.0, 24), 20),
        ("Z36", 2, 36, 13, 3.0, None),
        # the full graphs of rv>0 and HARQ-combined decodes
        *[(f"full-BG1-Z{z}{tag}", 1, z, 64, snr, None)
          for z in (320, 352, 384)
          for tag, snr in (("", 1.5), ("-mixed", np.linspace(-1.0, 2.5,
                                                              64)))],
        *[(f"full-BG2-Z{z}{tag}", 2, z, 64, snr, None)
          for z in (352, 384)
          for tag, snr in (("", 2.0), ("-mixed", np.linspace(-5.0, -1.0,
                                                              64)))],
    ]
    max_err, notes, llrs = 0, [], {}
    for label, bg, zc, batch, snr, n_used in cases:
        k = graphs.lifted_graph(bg, zc).nof_msg_blocks * zc
        msg = torch.randint(0, 2, (batch, k), generator=gen, device=dev,
                            dtype=torch.int8)
        llr = _noisy_llr(rng, encoder_cuda.encode_plain(msg, bg, zc), snr,
                         zc, dev)
        if n_used is not None:
            llr[:, n_used * zc:] = 0.0
        llrs[label] = llr
        bits, ok = decoder_cuda.decode(llr, bg, zc, nof_used_blocks=n_used)
        w_bits, w_ok = decoder_cuda.decode_plain(llr, bg, zc,
                                                 nof_used_blocks=n_used)
        torch.cuda.synchronize()
        max_err = max(max_err, int((bits.int() - w_bits.int()).abs().max()))
        _check(torch.equal(ok, w_ok) and torch.equal(bits, w_bits),
               f"decoder kernel != plain for {label}")
        n_ok = int(ok.sum())
        if label in ("flagship", "mixed-BG1-Z384", "mixed-BG1-Z352") or (
                label.startswith("full-") and not label.endswith("-mixed")):
            _check(n_ok == batch and torch.equal(bits, msg),
                   f"{label} decode did not converge")
        if label.endswith("-mixed"):
            _check(0 < n_ok < batch, f"no mixed convergence for {label} "
                   f"({n_ok})")
        notes.append(f"{label} {n_ok}/{batch} ok")
    print(f"[decoder] bit-exact (bits, ok) vs decode_plain: "
          f"{'; '.join(notes)} on {card}")
    # CTAs per SM at the main paths' decoder shapes (BG, Z, n_used)
    occ = {f"BG{bg} Z={z} n_used {n}": decoder_cuda.ctas_per_sm(bg, z, n)
           for bg, z, n in ((1, 384, 35), (1, 352, 36), (1, 384, 33),
                            (2, 384, 52), (1, 384, None))}
    _check(occ["BG1 Z=384 n_used 35"] >= 2,
           f"the mixed slot's pusch0 shape holds < 2 CTAs per SM: {occ}")
    split = "; ".join(_phase_split(label, llrs[key][:rows], bg, zc, n_used)
                      for label, key, rows, bg, zc, n_used in (
                          ("BG1 Z=384 x136 n_used 35, 6 dB",
                           "mixed-BG1-Z384", 136, 1, 384, 35),
                          ("full BG1 Z=384 x8, 1.5 dB", "full-BG1-Z384", 8,
                           1, 384, None)))
    print(f"[decoder] CTAs per SM: "
          f"{', '.join(f'{k} {v}' for k, v in occ.items())}; phase split "
          f"per CTA: {split} on {card}")
    return float(max_err)


def pusch_llr_bound(batch: int, n_re: int, qm: int) -> tuple[float, str]:
    """Symbols (8 B) and noise variance (4 B) of every RE in, the sign
    (4·qm B per RE of one row, the same for every row) in once, 4·qm B of
    LLR per RE out; the arithmetic is far below the float32 rate."""
    return _bound(batch * n_re * (12 + 4 * qm) + n_re * 4 * qm, 0.0)


def phase_pusch_llr(dev, card: str) -> dict:
    """The PUSCH LLR kernel against the plain chain at the shapes the
    benchmark cells run (the mixed slot's two PUSCH at B=64, the FAPI
    carrier's PUSCH A and B at B=1, the flagship273.mesh4 carrier's QPSK
    PUSCH at a card's 128 carriers) on symbols around the constellation,
    with the configs' own scrambling signs: the LLRs bit-identical, the EVM
    within rtol 1e-5 of ``evm_plain`` (its largest relative gap kept), then
    timed beside its bytes bound and the plain chain (LLRs and EVM)."""
    mixed, car = gnb_mixed.default_mixed(), fapi_carrier.default_carrier()
    edge = gnb_flagship.default_carrier(273, 2, 17416)
    shapes = [("mixed pusch0", mixed.pusch0, 64),
              ("mixed pusch1", mixed.pusch1, 64),
              ("fapi pusch A", car.pusch_a, 1),
              ("fapi pusch B", car.pusch_b, 1),
              ("flagship edge", edge.sh, 128)]
    gen = torch.Generator(device=dev).manual_seed(17)
    times, max_err, evm_gap = [], 0.0, 0.0
    for label, cfg, batch in shapes:
        qm, layers = cfg.qm, cfg.nof_layers
        n_re = cfg.nof_bits // qm
        shape = (batch, n_re) if layers == 1 else (batch, layers,
                                                   n_re // layers)
        x = torch.complex(
            torch.randn(shape, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev)) * 0.8
        nv = 10 ** (torch.rand(shape, generator=gen, device=dev) * 3 - 2.5)
        _, sign = sch._scramble_seq(cfg.scrambling_cinit, cfg.nof_bits, dev)

        def plain():
            return (modulation.pusch_llr_plain(x, nv, sign, qm),
                    modulation.evm_plain(x.flatten(1), qm))

        got, got_evm = modulation.pusch_llr(x, nv, sign, qm)
        want, want_evm = plain()
        torch.cuda.synchronize()
        _check(torch.equal(got, want), f"pusch_llr kernel != plain at "
               f"{label} x{batch}")
        max_err = max(max_err, float((got - want).abs().max()))
        gap = float(((got_evm - want_evm).abs() / want_evm.abs()).max())
        _check(gap <= 1e-5, f"pusch_llr EVM {gap:.3g} from evm_plain at "
               f"{label} x{batch}")
        evm_gap = max(evm_gap, gap)
        times.append(_timed(
            "pusch_llr", f"{label} {qm}-bit L={layers} S={n_re // layers} "
            f"x{batch}", lambda: modulation.pusch_llr(x, nv, sign, qm),
            plain, 50, 5, pusch_llr_bound(batch, n_re, qm)))
    print(f"[pusch_llr] LLRs bit-identical to pusch_llr_plain, EVM within "
          f"{evm_gap:.3g} of evm_plain at "
          f"{', '.join(f'{l} x{b}' for l, _, b in shapes)}; "
          + "; ".join(_fmt(r) for r in times) + f" on {card}")
    return {"times": times, "max_err": max_err, "evm_gap": evm_gap}


def channel_mix_bound(batch: int, length: int, streams: int
                      ) -> tuple[float, str]:
    """The two-port signal (16 B an element) and each single-port stream
    (8 B) in once, the two-port result (16 B) out; the arithmetic (8 or 16
    float32 operations an element and port per product) is far below the
    float32 rate."""
    return _bound(batch * length * (32 + 8 * streams), 0.0)


def phase_channel_mix(dev, card: str) -> dict:
    """The channel mix kernel against the plain expression at the mixed
    slot's grid, the DL mix (no stream) and the UL mix (two streams), at
    the scan cells' B = 8 and B = 64 on the slot's own channels: within
    1e-6 of the largest output magnitude, then timed beside its bytes bound
    and the plain expression."""
    cfg = gnb_mixed.default_mixed()
    h_ul, h_dl, h1_ul, h2_ul = gnb_mixed._channels(dev)
    trail = (14, cfg.nsc)
    gen = torch.Generator(device=dev).manual_seed(22)
    times, max_err, max_rel = [], 0.0, 0.0
    for batch in (SLICE_BATCH, 64):
        def draw(*shape):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.complex64)
        g, x1, x2 = draw(batch, 2, *trail), draw(batch, *trail), draw(
            batch, *trail)
        for link, h, vecs, xs in (("DL", h_dl, (), ()),
                                  ("UL", h_ul, (h1_ul, h2_ul), (x1, x2))):
            def kernel(h=h, vecs=vecs, xs=xs):
                return channel_mix.channel_mix(h, g, vecs, xs)

            def plain(h=h, vecs=vecs, xs=xs):
                return channel_mix.channel_mix_plain(h, g, vecs, xs)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            _check(got.is_contiguous() and rel <= 1e-6,
                   f"channel_mix kernel {rel:.3g} of max|plain| from plain "
                   f"at {link} x{batch}")
            max_err, max_rel = max(max_err, err), max(max_rel, rel)
            times.append(_timed(
                "channel_mix", f"{link} {len(xs)} streams "
                f"[{batch}, 2, 14, {cfg.nsc}]", kernel, plain, 50, 5,
                channel_mix_bound(batch, 14 * cfg.nsc, len(xs))))
        del g, x1, x2
    print(f"[channel_mix] within {max_rel:.3g} of max|plain| of "
          f"channel_mix_plain (DL and UL mixes at B={SLICE_BATCH} and 64); "
          + "; ".join(_fmt(r) for r in times) + f" on {card}")
    return {"times": times, "max_err": max_err}


def _launched_every_kernel_but_the_mix(launches: dict[str, int]) -> bool:
    """Every counted kernel launched, but the channel mix, which only the
    mixed slot runs, and that not at all."""
    return launches["channel_mix"] == 0 and all(
        n for k, n in launches.items() if k != "channel_mix")


def _phase_split(label: str, llr: torch.Tensor, bg: int, zc: int,
                 n_used) -> str:
    """The decoder's per-CTA phase split from its diagnostic instance
    (clock64 per phase; the SM clock from globaltimer over the same CTA)."""
    diag, bits, ok = decoder_cuda.phase_split(llr, bg, zc,
                                              nof_used_blocks=n_used)
    want = decoder_cuda.decode_plain(llr, bg, zc, nof_used_blocks=n_used)
    torch.cuda.synchronize()
    _check(torch.equal(bits, want[0]) and torch.equal(ok, want[1]),
           f"diagnostic decoder instance != plain at {label}")
    d = diag.cpu().numpy().astype(np.float64)
    ghz = float(np.median(d[:, 4] / np.maximum(d[:, 7] - d[:, 6], 1)))
    span_us = (d[:, 7].max() - d[:, 6].min()) / 1e3
    mean = d[:, :5].mean(axis=0) / ghz / 1e3          # us per CTA
    names = ("load+clear", "sweeps", "syndrome", "bit write")
    parts = ", ".join(f"{n} {us:.2f} us ({100 * us / mean[4]:.0f}%)"
                      for n, us in zip(names, mean[:4]))
    starts = np.sort(d[:, 6])
    waves = 1 + int(((starts - starts[0]) > 0.5 * mean[4] * 1e3).any())
    return (f"{label}: CTA {mean[4]:.2f} us = {parts}; sweeps "
            f"{int(d[:, 5].min())}-{int(d[:, 5].max())}; kernel span "
            f"{span_us:.1f} us, {'one wave' if waves == 1 else '>1 wave'}; "
            f"SM clock {ghz:.2f} GHz")


def phase_slice(dev, card: str) -> dict:
    cfg = gnb_flagship.default_carrier()
    sh = cfg.sh
    seg = sh.segments
    pipe = pipeline.SlotPipeline(pipeline.PipelineConfig(
        carrier=cfg, slots_per_batch=SLICE_BATCH, depth=2, snr_db=20.0,
        nof_ldpc_iterations=6), device=dev, seed=3)
    gen = torch.Generator(device=dev).manual_seed(3)
    tb = torch.randint(0, 2, (SLICE_BATCH, sh.tbs), generator=gen,
                       device=dev, dtype=torch.int8)

    kernel_taps.reset_launch_counts()
    warm_s, ok0, sinr0 = pipe.warmup(tb)
    t0 = time.perf_counter()
    for _ in range(SLICE_SUBMITS):
        pipe.submit(tb)
    results = pipe.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_taps.launch_counts()

    oks = np.concatenate([ok0] + [ok for ok, _ in results])
    sinrs = np.concatenate([sinr0] + [s for _, s in results])
    _check(len(results) == SLICE_SUBMITS, "pipeline lost batches")
    _check(bool(oks.all()), f"TB CRC failed in {int((~oks).sum())} slots")
    _check(bool(np.isfinite(sinrs).all())
           and abs(float(sinrs.mean()) - 20.0) < 1.5,
           f"mean SINR {float(sinrs.mean())} dB not within 1.5 dB of 20")
    _check(_launched_every_kernel_but_the_mix(launches),
           f"main path did not launch every kernel but the channel mix: "
           f"{launches}")
    us_per_slot = wall / (SLICE_SUBMITS * SLICE_BATCH) * 1e6

    # decoded bits equal the sent bits (direct call of the batched step)
    noise = pipe.noise(SLICE_BATCH)
    ok, bits, _ = gnb_flagship.loopback_batch(tb, noise, cfg)
    _check(bool(ok.all()) and torch.equal(bits, tb),
           "flagship loopback bits differ from the sent TB")
    # a small slot on the card agrees with the plain versions on the CPU
    tiny = gnb_flagship.tiny_carrier()
    rng = np.random.default_rng(4)
    tb_t = torch.from_numpy(rng.integers(0, 2, size=(4, tiny.sh.tbs)
                                         ).astype(np.int8))
    sigma = np.sqrt(tiny.nfft) * 10 ** (-10.0 / 20) / np.sqrt(2)
    nz = (sigma * (rng.standard_normal((4, tiny.slot_samples))
                   + 1j * rng.standard_normal((4, tiny.slot_samples)))
          ).astype(np.complex64)
    ok_c, bits_c, sinr_c = gnb_flagship.loopback_batch(
        tb_t, torch.from_numpy(nz), tiny)
    ok_g, bits_g, sinr_g = gnb_flagship.loopback_batch(
        tb_t.to(dev), torch.from_numpy(nz).to(dev), tiny)
    _check(torch.equal(ok_g.cpu(), ok_c) and bool(ok_c.all())
           and torch.equal(bits_g.cpu(), bits_c)
           and float((sinr_g.cpu() - sinr_c).abs().max()) < 0.1,
           "tiny slot on the card differs from the CPU plain path")

    # kernel and plain times at the flagship shapes
    bg, zc = seg.base_graph, seg.lifting_size
    cbs = segmentation.segment_tx(tb, seg).reshape(-1, seg.segment_length)
    times = [_timed("encoder", f"BG{bg} Z={zc} x{cbs.shape[0]} (flagship)",
                    lambda: encoder_cuda.encode(cbs, bg, zc),
                    lambda: encoder_cuda.encode_plain(cbs, bg, zc), 200, 5,
                    encoder_bound(bg, zc, cbs.shape[0]))]
    bb = gnb_flagship.tx_batch(tb, cfg) + noise
    rx = ofdm.demodulate_slot(bb, cfg.nsc, cfg.mu, cfg.nfft)[:, None]
    llr = sch.pusch_demodulate(rx, sh).llr_full.reshape(cbs.shape[0], -1)
    n_used = decoder_cuda.used_blocks(bg, zc, max(sh.cb_lengths))
    dec = lambda: decoder_cuda.decode(llr, bg, zc, nof_used_blocks=n_used)
    dec_plain = lambda: decoder_cuda.decode_plain(llr, bg, zc,
                                                  nof_used_blocks=n_used)
    _check(all(torch.equal(a, b) for a, b in zip(dec(), dec_plain())),
           "decoder kernel != plain on the slice's LLRs")
    times.append(_timed(
        "decoder", f"BG{bg} Z={zc} x{llr.shape[0]} n_used {n_used} "
        f"(flagship)", dec, dec_plain, 200, 5,
        decoder_bound(llr, bg, zc, nof_used_blocks=n_used)))
    # the same shape when no codeblock converges: all 6 iterations run
    llr_bad = _noisy_llr(np.random.default_rng(5),
                         encoder_cuda.encode(cbs, bg, zc), -6.0, zc, dev)
    dec_bad_ms = _time_ms(
        lambda: decoder_cuda.decode(llr_bad, bg, zc, nof_used_blocks=n_used),
        50, queued=True)
    print(f"[slice] {cfg.nof_prb}-PRB loopback x{SLICE_SUBMITS} batches of "
          f"{SLICE_BATCH} slots (warmup {warm_s:.2f} s): "
          f"{us_per_slot:.1f} us/slot, all {oks.size} TB CRC ok, mean SINR "
          f"{float(sinrs.mean()):.2f} dB, launches {launches}; "
          f"{'; '.join(map(_fmt, times))}; decoder with no convergence, all 6"
          f" iterations: {dec_bad_ms * 1e3:.1f} us on {card}")
    return {"launches": launches, "times": times, "pipe": pipe, "tb": tb}


def _device_entries(prof) -> list:
    """The profiler's device-side entries that are device work: a CPU op's
    self device time repeats its kernels, and a ``record_function`` range
    (the program's spans while the profiler records) shows on the device
    as an annotation as long as the range, over the kernels inside it."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total
            and not getattr(e, "is_user_annotation", False)]


def _profiled(run, reps: int, unit: str, after=None) -> str:
    """torch.profiler over ``reps`` calls of ``run`` (then ``after()``):
    device busy share, the kernels that take the device time, and each LDPC
    kernel's device time per launch.  The profiler's own host cost
    lengthens the window, so the busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        if after is not None:
            after()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = _device_entries(prof)
    busy_us = sum(e.self_device_time_total for e in kern)
    _check(busy_us > 0, "profiler recorded no device time")
    launches = sum(e.count for e in kern)

    def per_launch(tag: str) -> str:
        hits = [e for e in kern if tag in e.key]
        n = sum(e.count for e in hits)
        us = sum(e.self_device_time_total for e in hits)
        return f"{us / n:.1f} us x{n}" if n else "not seen"

    top = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)
    top_s = "; ".join(
        f"{e.key[:48]} {100 * e.self_device_time_total / busy_us:.1f}%"
        for e in top[:6])
    return (f"wall {wall_us:.0f} us, device busy {busy_us:.0f} us "
            f"({100 * busy_us / wall_us:.1f}%), {launches / reps:.0f} device "
            f"ops per {unit}; encoder kernel {per_launch('ldpc_encode_kernel')}"
            f", decoder kernel {per_launch('ldpc_decode_kernel')}; top: "
            f"{top_s}")


def phase_profile(card: str, label: str, pipe, batch, nslots: int) -> None:
    """The profile of two pipeline batches (submits + drain)."""
    print(f"[{label}] 2 batches of {nslots} slots: "
          f"{_profiled(lambda: pipe.submit(batch), 2, 'batch', pipe.drain)}"
          f" on {card}")


_MIXED_FLAGS = ("ok", "ul0_ok", "ul1_ok", "dl0_ok", "dl1_ok", "dci_crc_ok",
                "pucch_ok", "prach_ok")


def phase_mixed(dev, card: str) -> dict:
    cfg = gnb_mixed.default_mixed()
    pipe = pipeline.SlotPipeline(
        pipeline.PipelineConfig(carrier=None, slots_per_batch=SLICE_BATCH,
                                depth=2),
        device=dev, seed=6, batch_fn=gnb_mixed.batch_fn_for_pipeline(cfg))
    payloads = gnb_mixed.make_payloads(cfg, np.random.default_rng(6),
                                       SLICE_BATCH, dev)

    kernel_taps.reset_launch_counts()
    warm_s, ok0, sinr0 = pipe.warmup(payloads)
    t0 = time.perf_counter()
    for _ in range(MIXED_SUBMITS):
        pipe.submit(payloads)
    results = pipe.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_taps.launch_counts()

    batches = MIXED_SUBMITS + 1
    oks = np.concatenate([ok0] + [ok for ok, _ in results])
    sinrs = np.concatenate([sinr0] + [s for _, s in results])
    _check(len(results) == MIXED_SUBMITS, "pipeline lost batches")
    _check(bool(oks.all()), f"mixed slot failed in {int((~oks).sum())} slots")
    _check(bool(np.isfinite(sinrs).all())
           and abs(float(sinrs.mean()) - 20.0) < 1.0,
           f"mean UL SINR {float(sinrs.mean())} dB not within 1.0 dB of 20")
    _check(launches == {"encoder": 4 * batches, "decoder": 2 * batches,
                        "pusch_llr": 2 * batches,
                        "channel_mix": 2 * batches},
           f"expected 4 encoder, 2 decoder, 2 pusch_llr and 2 channel_mix "
           f"launches per batch over {batches} batches, got {launches}")
    us_per_slot = wall / (MIXED_SUBMITS * SLICE_BATCH) * 1e6

    # how many slots pass each check (two more batches of the same function)
    counts = dict.fromkeys(_MIXED_FLAGS, 0)
    for _ in range(2):
        res = gnb_mixed.mixed_slot_batch(
            payloads, *gnb_mixed.draw_noise(cfg, SLICE_BATCH, pipe.generator),
            cfg)
        for f in _MIXED_FLAGS:
            counts[f] += int(getattr(res, f).sum())
    _check(all(n == 2 * SLICE_BATCH for n in counts.values()),
           f"mixed-slot checks failed: {counts}")

    # wall time of each stage of a batch, synchronised between stages
    def stages() -> list[float]:
        marks = [time.perf_counter()]
        noise = gnb_mixed.draw_noise(cfg, SLICE_BATCH, pipe.generator)
        front = gnb_mixed._mixed_front(payloads, *noise, cfg)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        front["dci_crc_ok"] = gnb_mixed._dci_recheck(
            front["pdcch_llr"][0], payloads["dci_dl"][0], cfg
        ).expand(SLICE_BATCH)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        dec = gnb_mixed.decode_front(front, cfg)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        res = gnb_mixed._mixed_back(front, payloads, cfg, dec)
        _check(bool(res.ok.all()), "mixed slot failed in the stage split")
        marks.append(time.perf_counter())
        return list(np.diff(marks) * 1e3)

    torch.cuda.synchronize()
    split = np.median([stages() for _ in range(5)], axis=0)
    split_s = ", ".join(f"{name} {ms:.2f}" for name, ms in zip(
        ("front", "DCI re-check", "decode", "back"), split))

    # kernel and plain times at the mixed shapes, on the main path's data
    noise = gnb_mixed.draw_noise(cfg, SLICE_BATCH, pipe.generator)
    front = gnb_mixed._mixed_front(payloads, *noise, cfg)
    times = []
    for key, sh in (("tb_dl0", cfg.pdsch0), ("tb_dl1", cfg.pdsch1),
                    ("tb_ul0", cfg.pusch0), ("tb_ul1", cfg.pusch1)):
        seg = sh.segments
        bg, zc = seg.base_graph, seg.lifting_size
        cbs = segmentation.segment_tx(payloads[key], seg).reshape(
            -1, seg.segment_length)
        times.append(_timed(
            "encoder", f"BG{bg} Z={zc} x{cbs.shape[0]} (mixed {key})",
            lambda: encoder_cuda.encode(cbs, bg, zc),
            lambda: encoder_cuda.encode_plain(cbs, bg, zc), 200, 3,
            encoder_bound(bg, zc, cbs.shape[0])))
    splits = []
    for name, sh in (("u0", cfg.pusch0), ("u1", cfg.pusch1)):
        seg = sh.segments
        bg, zc = seg.base_graph, seg.lifting_size
        llr = front[name].llr_full.reshape(-1, front[name].llr_full.shape[-1])
        n_used = decoder_cuda.used_blocks(bg, zc, max(sh.cb_lengths))
        dec = lambda: decoder_cuda.decode(llr, bg, zc, nof_used_blocks=n_used)
        dec_plain = lambda: decoder_cuda.decode_plain(llr, bg, zc,
                                                      nof_used_blocks=n_used)
        _check(all(torch.equal(a, b) for a, b in zip(dec(), dec_plain())),
               f"decoder kernel != plain on the mixed slot's {name} LLRs")
        shape = f"BG{bg} Z={zc} x{llr.shape[0]} n_used {n_used} (mixed {name})"
        times.append(_timed("decoder", shape, dec, dec_plain, 200, 3,
                            decoder_bound(llr, bg, zc,
                                          nof_used_blocks=n_used)))
        splits.append(_phase_split(shape, llr, bg, zc, n_used))
    shapes = "; ".join(map(_fmt, times))
    print(f"[mixed] {cfg.nof_prb}-PRB mixed slot x{MIXED_SUBMITS} batches of "
          f"{SLICE_BATCH} slots (warmup {warm_s:.2f} s): {us_per_slot:.1f} "
          f"us/slot, all {oks.size} slots ok, mean UL SINR "
          f"{float(sinrs.mean()):.2f} dB, launches {launches}; slots passing "
          f"each check (of {2 * SLICE_BATCH}): {counts}; stage wall ms per "
          f"batch (median of 5): {split_s}; {shapes} on {card}")
    print(f"[mixed] decoder phase split per CTA on the mixed slot's LLRs: "
          f"{'; '.join(splits)} on {card}")
    return {"launches": launches, "times": times, "pipe": pipe,
            "payloads": payloads, "cfg": cfg}


def phase_mixed_cpu(dev, card: str) -> None:
    """A tiny_mixed batch of 2 on the card against the same payloads and
    noise through the plain versions on the CPU."""
    cfg = gnb_mixed.tiny_mixed()
    rng = np.random.default_rng(7)
    pay = gnb_mixed.make_payloads(cfg, rng, 2, "cpu")
    noise = gnb_mixed.draw_noise(cfg, 2, torch.Generator().manual_seed(7))
    out = {}
    for where in ("cpu", dev):
        p = {k: v.to(where) for k, v in pay.items()}
        nz = [n.to(where) for n in noise]
        res = gnb_mixed.mixed_slot_batch(p, *nz, cfg)
        dec = gnb_mixed.decode_front(gnb_mixed._mixed_front(p, *nz, cfg),
                                     cfg)
        out[str(where)] = (res, {k: [t.cpu() for t in v]
                                 for k, v in dec.items()})
    (r_c, d_c), (r_g, d_g) = out["cpu"], out[str(dev)]
    _check(bool(r_c.ok.all()), "tiny mixed slot failed on the CPU")
    for f in _MIXED_FLAGS:
        _check(torch.equal(getattr(r_g, f).cpu(), getattr(r_c, f)),
               f"card and CPU disagree on {f}")
    for k in d_c:
        _check(all(torch.equal(a, b) for a, b in zip(d_g[k], d_c[k])),
               f"card and CPU decode different bits for {k}")
    diff = max(float((getattr(r_g, f).cpu() - getattr(r_c, f)).abs().max())
               for f in ("sinr_ul_db", "sinr_ul0_db", "sinr_ul1_db",
                         "sinr_dl0_db", "csi_sinr_db"))
    _check(diff < 0.1, f"card and CPU SINRs differ by {diff} dB")
    print(f"[mixed-cpu] tiny_mixed x2 on the card equals the plain CPU path: "
          f"{len(_MIXED_FLAGS)} verdicts and the decoded bits equal, SINRs "
          f"within {diff:.2e} dB on {card}")


def phase_dci_profile(card: str, cfg, pipe, payloads) -> None:
    """The once-per-batch DCI re-check (SSC polar decode, unrolled on the
    host into many small ops): its device ops and times, profiled alone."""
    from torch.profiler import ProfilerActivity, profile
    front = gnb_mixed._mixed_front(
        payloads, *gnb_mixed.draw_noise(cfg, SLICE_BATCH, pipe.generator), cfg)
    llr, dci = front["pdcch_llr"][0], payloads["dci_dl"][0]
    _check(bool(gnb_mixed._dci_recheck(llr, dci, cfg)), "DCI re-check failed")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ok = gnb_mixed._dci_recheck(llr, dci, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _check(bool(ok), "DCI re-check failed under the profiler")
    kern = _device_entries(prof)
    print(f"[mixed-profile] DCI re-check once per batch (SSC polar decode "
          f"K=64 N=512): {sum(e.count for e in kern)} device ops, "
          f"{sum(e.self_device_time_total for e in kern):.0f} us device, "
          f"{wall_us:.0f} us wall under the profiler on {card}")


def _same_indications(got: list, want: list, sinr_tol: float) -> bool:
    """Card and CPU indications: the same kinds, verdicts, bits and
    preambles; SINR and TA within sinr_tol (dB, samples)."""
    if [type(i) for i in got] != [type(i) for i in want]:
        return False
    for g, w in zip(got, want):
        for k, b in vars(w).items():
            a = getattr(g, k)
            if k in ("sinr_db", "ta_samples"):
                ok = abs(a - b) < sinr_tol
            elif k == "metric":
                ok = abs(a - b) <= 1e-3 * max(abs(b), 1.0)
            elif k == "preambles":
                ok = [p[0] for p in a] == [p[0] for p in b]
            elif isinstance(b, np.ndarray) or b is None:
                ok = (a is None) == (b is None) and (
                    b is None or np.array_equal(a, b))
            else:
                ok = a == b
            if not ok:
                return False
    return True


def _tree_leaves(tree, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _tree_diffs(got, want) -> list[str]:
    """Where two output trees differ: bits, flags and indices in any
    element, floats by more than 1e-5 of max|want|."""
    a, b = list(_tree_leaves(got)), list(_tree_leaves(want))
    if [p for p, _ in a] != [p for p, _ in b]:
        return ["the trees differ in shape"]
    bad = []
    for (path, x), (_, y) in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            bad.append(f"{path}: {x.dtype}{list(x.shape)} vs "
                       f"{y.dtype}{list(y.shape)}")
        elif x.dtype.is_floating_point or x.dtype.is_complex:
            ref = float(y.abs().max()) if y.numel() else 0.0
            err = float((x - y).abs().max()) if y.numel() else 0.0
            if err > 1e-5 * ref:
                bad.append(f"{path}: {err:.3e} of max|ref| {ref:.3e}")
        elif not torch.equal(x, y):
            bad.append(f"{path}: differs")
    return bad


def _no_launches() -> dict[str, int]:
    """A launch count of 0 for every counted kernel."""
    return dict.fromkeys(kernel_taps.launch_counts(), 0)


@contextlib.contextmanager
def _uncounted():
    """Kernel launches inside the block (comparisons, timings) leave the
    launch counts as they were."""
    saved = kernel_taps.launch_counts()
    try:
        yield
    finally:
        kernel_taps.reset_launch_counts(saved)


def _replay_vs_eager(label: str, prog, got=None) -> None:
    """The last replay of a captured program (its outputs, or `got`, a copy
    of them) against the program's body run eagerly on the same inputs."""
    with _uncounted():
        want = prog.eager(*prog.inputs)
    bad = _tree_diffs(prog.out if got is None else got, want)
    _check(not bad, f"{label}: replay != eager: {'; '.join(bad[:6])}")


def _program_ms(prog, reps: int) -> tuple[list[float], list[float]]:
    """Host ms (after synchronize) of ``reps`` replays and ``reps`` eager
    runs of a program on its last inputs, in turns."""
    inputs = prog.inputs
    replay, eager = [], []
    with _uncounted():
        for _ in range(reps):
            for fn, out in ((lambda: prog(*inputs), replay),
                            (lambda: prog.eager(*inputs), eager)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
    return replay, eager


def _ms(xs) -> str:
    return f"median {np.median(xs):.2f} p90 {np.percentile(xs, 90):.2f}"


def phase_upper_phy(dev, card: str) -> dict:
    """UpperPhy on the 273-PRB FAPI carrier: DL and UL slots, two HARQ
    pairs through the full BG1 graph, the programs as captured graphs, each
    replay held against the program's eager run on the same inputs."""
    car = fapi_carrier.default_carrier()
    phy = upper_phy.UpperPhy(car.upper_phy, dev)
    phy_cpu = upper_phy.UpperPhy(car.upper_phy, "cpu")
    gen = torch.Generator(device=dev).manual_seed(8)
    rng = np.random.default_rng(8)
    gate = gnb_mixed.symbol_gate(car.pdsch_a.qm, car.snr_db)
    ul_reqs, dl_reqs, matches, sinr_b = [], [], [], []
    dl_ms, ul_ms = {True: [], False: []}, {True: [], False: []}
    decode_grouped, group_inputs = slot_programs._decode_grouped, []

    def ul_slot(rx, req, slot_count, prach_rx=None):
        """One UL slot: its decoder launches (one per decode group and
        replay, the warm-up's on a capture) and its replay vs eager."""
        groups = slot_programs.decode_groups(
            slot_programs.signature(req)[0])
        n0, c0 = kernel_taps.launch_counts(), phy.graphs.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inds = phy.process_ul_slot(rx, req, slot_count=slot_count,
                                   prach_rx=prach_rx)
        torch.cuda.synchronize()
        new = phy.graphs.captures - c0
        ul_ms[bool(new)].append((time.perf_counter() - t0) * 1e3)
        prog = phy.ul_programs.get(slot_programs.signature(
            req if prach_rx is not None else dataclasses.replace(
                req, prach_pdus=[]))).program
        per_replay = {"encoder": 0, "decoder": len(groups),
                      "pusch_llr": len(req.pusch_pdus), "channel_mix": 0}
        ran = {k: n - n0[k] for k, n in kernel_taps.launch_counts().items()}
        _check(prog.captured_launches == per_replay
               and ran == {k: n * (1 + new) for k, n in per_replay.items()},
               f"UL slot {slot_count}: launches {ran} ({new} captures), "
               f"{prog.captured_launches} per replay, for {len(groups)} "
               f"decode groups and {len(req.pusch_pdus)} PUSCH PDUs")
        _replay_vs_eager(f"UL slot {slot_count}", prog)
        ul_reqs.append(req)
        return inds

    kernel_taps.reset_launch_counts()
    for slot in range(UPPER_SLOTS):
        # ---- downlink
        req, data = fapi_carrier.dl_request(car, slot, rng, vrb=slot == 5)
        c0 = phy.graphs.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = phy.process_dl_slot(req, data)
        torch.cuda.synchronize()
        dl_ms[phy.graphs.captures > c0].append((time.perf_counter() - t0)
                                              * 1e3)
        dl_reqs.append(req)
        _replay_vs_eager(f"DL slot {slot}", phy.dl_programs.get(
            slot_programs.dl_signature(req)).program, grid)
        if slot in (0, 5):
            want = phy_cpu.process_dl_slot(req, data)
            err = float((grid.cpu() - want).abs().max() / want.abs().max())
            _check(err < 1e-5, f"DL slot {slot}: card grid differs from the "
                   f"CPU's by {err:.2e} of max|ref|")
        ue = fapi_carrier.downlink(grid, car, gen)
        for p in req.pdsch_pdus:
            m, _, _ = sch.symbol_verify(ue[None], grid[None], p.config)
            matches.append(float(m[0]))
            _check(matches[-1] > gate, f"DL slot {slot} PDSCH {p.config.rnti:#x}"
                   f": symbol match {matches[-1]:.4f} <= {gate:.4f}")
        # ---- uplink, two mixes in turn
        ul = fapi_carrier.ul_request(car, slot, full=slot % 2 == 0)
        pay = fapi_carrier.ul_payloads(ul, rng)
        rx, prach_rx = fapi_carrier.uplink(ul, pay, car, gen)
        if slot == 0:
            # keep what each decode group hands the decoder in the eager
            # warm-up of the program's capture (the replay runs the same
            # inputs), to hold the kernel against decode_plain afterwards
            def keep(llrs, groups, iters):
                if not (group_inputs
                        or torch.cuda.is_current_stream_capturing()):
                    for (bg, zc, _, n_used), idxs in groups.items():
                        group_inputs.append((
                            torch.cat([llrs[i] for i in idxs]), bg, zc,
                            {"nof_iterations": iters,
                             "nof_used_blocks": n_used}))
                return decode_grouped(llrs, groups, iters)
            slot_programs._decode_grouped = keep
        try:
            inds = ul_slot(rx, ul, slot, prach_rx)
        finally:
            slot_programs._decode_grouped = decode_grouped
        checks = fapi_carrier.ul_checks(car, ul, pay, inds,
                                        phy.last_ul_slot["pusch"])
        _check(all(checks.values()), f"UL slot {slot} checks: {checks}")
        crc_b = [i for i in inds if isinstance(i, fapi.CrcIndication)][-1]
        sinr_b.append(crc_b.sinr_db)
        _check(abs(crc_b.sinr_db - car.snr_db) < 1.0,
               f"UL slot {slot}: PUSCH B SINR {crc_b.sinr_db:.2f} dB")
        if slot == 0:
            want = phy_cpu.process_ul_slot(rx.cpu(), ul, slot_count=slot,
                                           prach_rx=prach_rx.cpu())
            _check(_same_indications(inds, want, 0.1),
                   "UL slot 0: card and CPU indications differ")
            for a, b in zip(phy.last_ul_slot["pusch"],
                            phy_cpu.last_ul_slot["pusch"]):
                _check(all(np.array_equal(a[f], b[f]) for f in a
                           if f.endswith(("_bits", "_valid"))),
                       "UL slot 0: card and CPU UCI differ")
    launches = kernel_taps.launch_counts()
    _check(_launched_every_kernel_but_the_mix(launches),
           f"upper PHY run did not launch every kernel but the channel "
           f"mix: {launches}")

    # ---- each decode group of the full-mix slot 0: kernel vs plain on the
    # LLRs the program handed it (PUSCH A x34 n_used 35, PUSCH B x8 n_used 33)
    _check(len(group_inputs) == 2,
           f"{len(group_inputs)} decode groups in the full-mix slot, not 2")
    times = []
    for llr, bg, zc, kw in group_inputs:
        got = decoder_cuda.decode(llr, bg, zc, **kw)
        want = decoder_cuda.decode_plain(llr, bg, zc, **kw)
        torch.cuda.synchronize()
        shape = (f"BG{bg} Z={zc} x{llr.shape[0]} n_used "
                 f"{kw['nof_used_blocks']} (UpperPhy slot 0)")
        _check(all(torch.equal(a, b) for a, b in zip(got, want)),
               f"decoder kernel != plain on the UL slot's group {shape}")
        times.append(_timed(
            "decoder", shape, lambda: decoder_cuda.decode(llr, bg, zc, **kw),
            lambda: decoder_cuda.decode_plain(llr, bg, zc, **kw), 50, 3,
            decoder_bound(llr, bg, zc, **kw)))
    # the encoder at a DL slot's PDSCH shape (PDSCH A: BG1 Z=384 x8)
    cbs = torch.randint(0, 2, (8, 22 * 384), generator=gen, device=dev,
                        dtype=torch.int8)
    times.append(_timed("encoder", "BG1 Z=384 x8 (UpperPhy PDSCH A)",
                        lambda: encoder_cuda.encode(cbs, 1, 384),
                        lambda: encoder_cuda.encode_plain(cbs, 1, 384), 200,
                        3, encoder_bound(1, 384, 8)))
    kernel_taps.reset_launch_counts(launches)

    # ---- two HARQ pairs: rv=0 fails, rv=2 combines on the full graph and
    # passes; the second pair replays the graphs the first one captured,
    # on its own softbuffer
    harq = []
    for pid, slot in ((15, UPPER_SLOTS), (14, UPPER_SLOTS + 2)):
        first = fapi_carrier.ul_request(car, slot, full=False,
                                        harq_process=pid)
        pay = fapi_carrier.ul_payloads(first, rng)
        rx1, _ = fapi_carrier.uplink(first, pay, car, gen,
                                     snr_db=car.harq_snr_db)
        inds1 = ul_slot(rx1, first, slot)
        crc1 = [i for i in inds1 if isinstance(i, fapi.CrcIndication)][0]
        _check(not crc1.tb_crc_ok and len(phy.softbuffers) == 1,
               f"HARQ {pid} rv=0 at {car.harq_snr_db} dB: crc "
               f"{crc1.tb_crc_ok}, {len(phy.softbuffers)} softbuffers")
        rnti = first.pusch_pdus[0].config.rnti
        prior = phy.softbuffers.get(rnti, pid).clone()
        retx = fapi_carrier.ul_request(car, slot + 1, full=False,
                                       harq_process=pid, rv=2,
                                       new_data=False)
        rx2, _ = fapi_carrier.uplink(retx, pay, car, gen,
                                     snr_db=car.harq_snr_db)
        cfg2 = retx.pusch_pdus[0].config
        seg = cfg2.segments
        _check(sch.used_blocks(cfg2) is None
               and decoder_cuda.state_bytes(seg.base_graph, seg.lifting_size)
               <= 232_448, "the retransmission does not take the full graph "
               "in shared memory")
        c0 = phy.graphs.captures
        inds2 = ul_slot(rx2, retx, slot + 1)
        checks = fapi_carrier.ul_checks(car, retx, pay, inds2, None)
        _check(checks["crc"] and checks["payload"]
               and len(phy.softbuffers) == 0,
               f"HARQ {pid} rv=2 combined decode: {checks}, "
               f"{len(phy.softbuffers)} softbuffers")
        harq.append(phy.graphs.captures - c0)
    _check(harq == [1, 0], f"captures of the rv=2 slots {harq}: the second "
           f"pair must replay the first pair's graph")
    # the slot number is normalised out of the signature: the two mixes of
    # the eight slots and the retransmission (rv=2) make three; one capture
    # per distinct DL and UL signature
    sigs = {slot_programs.signature(r) for r in ul_reqs}
    dl_sigs = {slot_programs.dl_signature(r) for r in dl_reqs}
    _check(phy.ul_programs.nof_compiled == len(sigs) == 3
           and phy.graphs.captures == len(sigs) + len(dl_sigs),
           f"{phy.ul_programs.nof_compiled} UL programs for {len(sigs)} "
           f"signatures, not 3; {phy.graphs.captures} captures for "
           f"{len(sigs) + len(dl_sigs)} DL and UL signatures")

    # ---- the full-graph decoder on the last combined buffer: kernel vs
    # plain, and the same LLRs through the rv=0 truncated graph
    combined = (prior + sch.pusch_demodulate(rx2[None], cfg2).llr_full[0]
                ).contiguous()
    bg, zc = seg.base_graph, seg.lifting_size
    n_used = sch.used_blocks(dataclasses.replace(cfg2, rv=0))
    with _uncounted():
        full = lambda: decoder_cuda.decode(combined, bg, zc)
        plain = lambda: decoder_cuda.decode_plain(combined, bg, zc)
        got, want = full(), plain()
        torch.cuda.synchronize()
        _check(all(torch.equal(a, b) for a, b in zip(got, want))
               and bool(got[1].all()),
               "full-graph decoder != plain on the combined buffer")
        err = float((got[0].int() - want[0].int()).abs().max())
        shape = f"BG{bg} Z={zc} x{combined.shape[0]} full graph (HARQ rv=2)"
        times.append(_timed("decoder", shape, full, plain, 50, 3,
                            decoder_bound(combined, bg, zc)))
        full_split = _phase_split(shape, combined, bg, zc, None)
        trunc = lambda: decoder_cuda.decode(combined, bg, zc,
                                            nof_used_blocks=n_used)
        want = decoder_cuda.decode_plain(combined, bg, zc,
                                         nof_used_blocks=n_used)
        _check(all(torch.equal(a, b) for a, b in zip(trunc(), want)),
               f"truncated-graph decoder (n_used {n_used}) != plain on the "
               f"combined buffer")
        trunc_ms = _time_ms(trunc, 50, queued=True)
    launches = kernel_taps.launch_counts()

    # ---- the programs alone: replay vs eager body on their last inputs
    progs = {"DL": phy.dl_programs.get(slot_programs.dl_signature(
                 dl_reqs[0])).program,
             "UL full mix": phy.ul_programs.get(slot_programs.signature(
                 ul_reqs[0])).program,
             "UL PUSCH B + F1": phy.ul_programs.get(slot_programs.signature(
                 ul_reqs[1])).program,
             "UL HARQ rv=2": phy.ul_programs.get(slot_programs.signature(
                 ul_reqs[-1])).program}
    prog_ms = {k: _program_ms(p, 10) for k, p in progs.items()}
    g = phy.graphs
    print(f"[upper-phy] {car.nof_prb}-PRB FAPI carrier, 4 rx, "
          f"{car.snr_db:.0f} dB: {UPPER_SLOTS} DL slots, PDSCH symbol "
          f"match min {min(matches):.4f}; {UPPER_SLOTS} UL slots, every "
          f"CRC/payload/UCI/PUCCH/PRACH check ok, PUSCH B SINR "
          f"{np.mean(sinr_b):.2f} dB, launches {launches}; two HARQ pairs "
          f"rv=0 fail -> rv=2 combined pass at {car.harq_snr_db:.0f} dB;"
          f" {phy.ul_programs.nof_compiled} UL programs for {len(sigs)} "
          f"signatures; {_fmt(times[-1])}; the same LLRs on the truncated "
          f"graph n_used {n_used}: {trunc_ms * 1e3:.1f} us on {card}")
    print(f"[upper-phy] captured programs: every DL and UL slot's replay == "
          f"the program's eager run on the same inputs (bits and verdicts "
          f"exact, floats within 1e-5 of max|ref|), graphs replayed on later "
          f"slots' c_inits, payloads and HARQ state; {g.captures} captures "
          f"({phy.dl_programs.nof_compiled} DL + "
          f"{phy.ul_programs.nof_compiled} UL signatures) in "
          f"{g.capture_seconds:.2f} s, {g.replays} replays, pool "
          f"{g.reserved_bytes() / 2**20:.1f} MiB reserved; launches per "
          f"replay: "
          + ", ".join(f"{k} {p.captured_launches}" for k, p in progs.items())
          + f"; ms per slot through UpperPhy (host clock after synchronize, "
          f"slots whose signature was captured before): DL "
          f"{_ms(dl_ms[False])} over {len(dl_ms[False])}, UL "
          f"{_ms(ul_ms[False])} over {len(ul_ms[False])}; slots that "
          f"captured: DL {_ms(dl_ms[True])}, UL {_ms(ul_ms[True])}; the "
          f"programs alone, replay vs eager body on the same inputs (10 "
          f"each): "
          + "; ".join(f"{k} {_ms(r)} vs {_ms(e)}"
                      for k, (r, e) in prog_ms.items()) + f" on {card}")
    print(f"[upper-phy] the decode groups of UL slot 0 (kernel == plain on "
          f"the program's LLRs) and a DL slot's encoder shape: "
          f"{'; '.join(map(_fmt, times[:-1]))}; truncated "
          f"n_used {n_used} == plain on the combined buffer; full-graph phase "
          f"split per CTA: {full_split} on {card}")
    return {"launches": launches, "max_err": err, "times": times,
            "phy": phy, "car": car, "gen": gen, "rng": rng,
            "progs": progs}


def phase_upper_profile(card: str, u: dict) -> None:
    """torch.profiler over two DL slots and, apart, two full-mix UL slots of
    the upper PHY (replays of their programs), then over one replay and
    one eager run of the DL and the full-mix UL program alone."""
    phy, car, gen, rng = u["phy"], u["car"], u["gen"], u["rng"]
    req, data = fapi_carrier.dl_request(car, 0, rng)
    ul = fapi_carrier.ul_request(car, 0)
    pay = fapi_carrier.ul_payloads(ul, rng)
    rx, prach_rx = fapi_carrier.uplink(ul, pay, car, gen)
    dl = _profiled(lambda: phy.process_dl_slot(req, data), 2, "DL slot")
    ul_s = _profiled(lambda: phy.process_ul_slot(rx, ul, prach_rx=prach_rx),
                     2, "UL slot")
    alone = []
    for name in ("DL", "UL full mix"):
        prog = u["progs"][name]
        inputs = prog.inputs
        alone.append(f"{name} replay: "
                     f"{_profiled(lambda: prog(*inputs), 1, 'replay')}; "
                     f"eager: "
                     f"{_profiled(lambda: prog.eager(*inputs), 1, 'run')}")
    print(f"[upper-profile] 2 DL slots: {dl}; 2 full-mix UL slots: {ul_s}; "
          f"{'; '.join(alone)} on {card}")


def _waves(rows: int, bg: int, zc: int, n_used) -> tuple[int, int]:
    """(CTAs per SM, waves) of a decoder launch of `rows` codeblocks, one
    CTA each, on this card's SMs."""
    per_sm = decoder_cuda.ctas_per_sm(bg, zc, n_used)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return per_sm, -(-rows // (per_sm * sms))


def _timed_decoder(label: str, llr: torch.Tensor, bg: int, zc: int,
                   n_used, reps: int = 100) -> dict:
    """The decoder at one main-path shape: bit-exact against decode_plain
    on `llr` first, then timed with its bound, CTAs per SM and waves."""
    dec = lambda: decoder_cuda.decode(llr, bg, zc, nof_used_blocks=n_used)
    plain = lambda: decoder_cuda.decode_plain(llr, bg, zc,
                                              nof_used_blocks=n_used)
    got, want = dec(), plain()
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(got, want)),
           f"decoder kernel != plain at {label}")
    graph = f"n_used {n_used}" if n_used else "full graph"
    rec = _timed("decoder", f"BG{bg} Z={zc} x{llr.shape[0]} {graph} "
                 f"({label})", dec, plain, reps, 3,
                 decoder_bound(llr, bg, zc, nof_used_blocks=n_used))
    rec["ctas_per_sm"], rec["waves"] = _waves(llr.shape[0], bg, zc, n_used)
    return rec


def _pipeline_run(dev, cfg, seed: int, submits: int) -> dict:
    """The mixed slot `cfg` through SlotPipeline (warmup, submits, drain),
    with the kernel counts reset just before and read just after."""
    pipe = pipeline.SlotPipeline(
        pipeline.PipelineConfig(carrier=None, slots_per_batch=SLICE_BATCH,
                                depth=2),
        device=dev, seed=seed, batch_fn=gnb_mixed.batch_fn_for_pipeline(cfg))
    payloads = gnb_mixed.make_payloads(cfg, np.random.default_rng(seed),
                                       SLICE_BATCH, dev)
    kernel_taps.reset_launch_counts()
    warm_s, ok0, sinr0 = pipe.warmup(payloads)
    t0 = time.perf_counter()
    for _ in range(submits):
        pipe.submit(payloads)
    results = pipe.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_taps.launch_counts()
    _check(len(results) == submits, "pipeline lost batches")
    return {"launches": launches, "pipe": pipe, "payloads": payloads,
            "warm_s": warm_s, "batches": submits + 1,
            "oks": np.concatenate([ok0] + [ok for ok, _ in results]),
            "sinrs": np.concatenate([sinr0] + [s for _, s in results]),
            "us_per_slot": wall / (submits * SLICE_BATCH) * 1e6}


def phase_mixed_variants(dev, card: str) -> dict:
    """The mixed slot's options at 273 PRB through SlotPipeline."""
    # under the default TDL taps at 20 dB the 64QAM slot fails the JAX
    # slot's own gates (the symbol checks in the channel's fades, the
    # 2-layer PUSCH decode, the PSS correlation; the JAX slot does the
    # same): the TDL slot runs at 30 dB, and the 20 dB verdicts are
    # measured below and not gated
    variants = {
        "tdl 30 dB": gnb_mixed.tdl_channel(
            gnb_mixed.default_mixed(snr_db=30.0)),
        "ue_decode_dl": gnb_mixed.default_mixed(ue_decode_dl=True),
        "grid_prach": gnb_mixed.default_mixed(prach_time_domain=False)}
    # the two PDSCH decode shapes of ue_decode_dl, on the slot's own LLRs
    cfg = variants["ue_decode_dl"]
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(20),
                                  SLICE_BATCH, dev)
    front = gnb_mixed._mixed_front(
        pay, *gnb_mixed.draw_noise(
            cfg, SLICE_BATCH, torch.Generator(device=dev).manual_seed(20)),
        cfg)
    times = []
    for name, sh in (("d0", cfg.pdsch0), ("d1", cfg.pdsch1)):
        seg = sh.segments
        llr = front[name].llr_full.reshape(-1, front[name].llr_full.shape[-1])
        times.append(_timed_decoder(f"ue_decode_dl {name}", llr,
                                    seg.base_graph, seg.lifting_size,
                                    sch.used_blocks(sh)))
    _check([r["shape"].split(" (")[0] for r in times]
           == ["BG1 Z=384 x128 n_used 34", "BG1 Z=384 x56 n_used 34"],
           f"unexpected PDSCH decode shapes: {[r['shape'] for r in times]}")
    launches = _no_launches()
    notes = []
    for i, (name, cfg) in enumerate(variants.items()):
        r = _pipeline_run(dev, cfg, 21 + i, 2)
        oks, sinrs = r["oks"], r["sinrs"]
        n_dec = len(gnb_mixed.decode_names(cfg))
        _check(bool(oks.all()), f"{name}: {int((~oks).sum())} slots failed")
        _check(bool(np.isfinite(sinrs).all()), f"{name}: SINR not finite")
        if not cfg.tdl_delays:
            _check(abs(float(sinrs.mean()) - cfg.snr_db) < 1.0,
                   f"{name}: mean UL SINR {float(sinrs.mean()):.2f} dB")
        _check(r["launches"] == {"encoder": 4 * r["batches"],
                                 "decoder": n_dec * r["batches"],
                                 "pusch_llr": n_dec * r["batches"],
                                 "channel_mix": 2 * r["batches"]},
               f"{name}: launches {r['launches']} over {r['batches']} "
               f"batches, expected 4 encoder, {n_dec} decoder, {n_dec} "
               f"pusch_llr and 2 channel_mix per batch")
        for k in launches:
            launches[k] += r["launches"][k]
        notes.append(f"{name} {r['us_per_slot']:.1f} us/slot (warmup "
                     f"{r['warm_s']:.2f} s), all {oks.size} slots ok, mean "
                     f"UL SINR {float(sinrs.mean()):.2f} dB, launches "
                     f"{r['launches']}")
    # the TDL slot with the symbol check: how many slots pass each check
    cfg = gnb_mixed.tdl_channel(gnb_mixed.default_mixed())
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(24),
                                  SLICE_BATCH, dev)
    res = gnb_mixed.mixed_slot_batch(pay, *gnb_mixed.draw_noise(
        cfg, SLICE_BATCH, torch.Generator(device=dev).manual_seed(24)), cfg)
    counts = {f: int(getattr(res, f).sum()) for f in _MIXED_FLAGS}
    sym = (f"TDL at 20 dB (not gated): slots passing each check "
           f"(of {SLICE_BATCH}) {counts}, dl0/dl1 symbol match "
           f"{float(res.dl0_match.mean()):.3f}/{float(res.dl1_match.mean()):.3f}"
           f" against the gate {min(gnb_mixed.symbol_gate(6, cfg.snr_db), 0.88):.3f}"
           f", PSS correlation {float(res.pss_corr.min()):.3f} (gate 0.6), "
           f"UL SINR {float(res.sinr_ul_db.mean()):.2f} dB")
    print(f"[mixed-variants] {SLICE_BATCH} slots per batch, 273 PRB: "
          f"{'; '.join(notes)}; {sym}; {'; '.join(map(_fmt, times))} on "
          f"{card}")
    return {"launches": launches, "times": times}


# the snr1 sweep of the HARQ pairs: 11-14 dB in 0.5 dB steps, HARQ_SWEEP
# batches of 64 pairs on each of HARQ_SEEDS (6144 pairs a point)
HARQ_SNRS = tuple(11.0 + 0.5 * i for i in range(7))
HARQ_SWEEP = 32
HARQ_SEEDS = (30, 31, 32)
HARQ_PAIRS = 64


def harq_sweep(dev, cfg, snrs, batches: int, seeds, pairs: int) -> tuple:
    """``harq_pair_batch`` over the uplink SNRs `snrs` (the downlink at
    ``cfg.snr_db``), `batches` batches of `pairs` pairs on each seed →
    (per point {snr, pairs, first_passed, combined_failed, not_ok, false}
    in TBs and pairs, ``false`` the pairs with each other verdict false in
    either slot, the widest run of points where no first transmission
    passed and no combination failed as (low, high) or None)."""
    rows = []
    others = ("dl0_ok", "dl1_ok", "pucch_ok", "prach_ok", "dci_crc_ok")
    for snr in snrs:
        first = comb = bad = n = 0
        why = dict.fromkeys(others, 0)
        for seed in seeds:
            gen = torch.Generator(device=dev).manual_seed(seed)
            pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(seed),
                                          pairs, dev)
            for _ in range(batches):
                res = gnb_mixed.harq_pair_batch(pay, gnb_mixed.draw_harq_noise(
                    cfg, pairs, gen, snr), cfg)
                first += int(sum(v.sum() for v in res.first_ok.values()))
                comb += int(sum((~v).sum() for v in res.combined_ok.values()))
                bad += int((~res.ok).sum())
                for f in others:
                    why[f] += int((~(getattr(res.first, f)
                                     & getattr(res.second, f))).sum())
                n += pairs
        rows.append({"snr": snr, "pairs": n, "first_passed": first,
                     "combined_failed": comb, "not_ok": bad,
                     "false": {f: k for f, k in why.items() if k}})
    best, run = None, []
    for r in rows + [None]:
        if r is not None and not r["first_passed"] and not r["combined_failed"]:
            run.append(r["snr"])
            continue
        if run and (best is None or run[-1] - run[0] > best[1] - best[0]):
            best = (run[0], run[-1])
        run = []
    return rows, best


def phase_harq(dev, card: str) -> dict:
    """HARQ pairs at 273 PRB: the snr1 sweep of ``harq_pair_batch`` and the
    interval it sets; ``harq_pair_batch`` and ``harq_retx_batch`` driven
    at its midpoint with their launches counted; the full-graph decodes of
    the combined LLRs at 8 and at 64 pairs a batch held against
    ``decode_plain`` and timed."""
    cfg = gnb_mixed.default_mixed()
    t0 = time.perf_counter()
    rows, best = harq_sweep(dev, cfg, HARQ_SNRS, HARQ_SWEEP, HARQ_SEEDS,
                            HARQ_PAIRS)
    sweep_s = time.perf_counter() - t0
    sweep = "; ".join(
        f"{r['snr']:g} dB: first passed {r['first_passed']}, combined failed "
        f"{r['combined_failed']} of {2 * r['pairs']} TBs, pairs not ok "
        f"{r['not_ok']} of {r['pairs']} {r['false'] or ''}" for r in rows)
    _check(best is not None and best[1] - best[0] >= 1.0,
           f"no interval of 1 dB where every first transmission fails and "
           f"every combination passes: {sweep}")
    chosen = 0.5 * (best[0] + best[1])
    print(f"[harq] snr1 sweep of harq_pair_batch, {HARQ_PAIRS} pairs a batch "
          f"x {HARQ_SWEEP} batches x seeds {HARQ_SEEDS} ({sweep_s:.1f} s): "
          f"{sweep}; interval {best[0]:g}-{best[1]:g} dB "
          f"({best[1] - best[0]:g} dB), snr1 = its midpoint {chosen:g} dB "
          f"on {card}")
    launches = dict.fromkeys(kernel_taps.launch_counts(), 0)
    # the pair, as the cell runs it, at 8 pairs a batch
    gen = torch.Generator(device=dev).manual_seed(30)
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(30),
                                  SLICE_BATCH, dev)
    nz = gnb_mixed.draw_harq_noise(cfg, SLICE_BATCH, gen, chosen)
    kernel_taps.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pair = gnb_mixed.harq_pair_batch(pay, nz, cfg)
    torch.cuda.synchronize()
    pair_ms = (time.perf_counter() - t0) * 1e3
    got = kernel_taps.launch_counts()
    _check(got == {"encoder": 8, "decoder": 4, "pusch_llr": 4,
                   "channel_mix": 4},
           f"HARQ pair launches {got}, expected 8, 4, 4 and 4")
    _check(bool(pair.ok.all()), f"HARQ pairs at {chosen} dB: "
           f"first {pair.first_ok}, combined {pair.combined_ok}")
    launches = {k: launches[k] + n for k, n in got.items()}
    # the retransmission batch, the JAX parity path: the downlink at snr1
    nz = (*gnb_mixed.draw_noise(dataclasses.replace(cfg, snr_db=chosen),
                                SLICE_BATCH, gen),
          *gnb_mixed.draw_noise(dataclasses.replace(cfg, snr_db=chosen),
                                SLICE_BATCH, gen))
    kernel_taps.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gnb_mixed.harq_retx_batch(pay, nz, cfg, chosen, device=dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    got = kernel_taps.launch_counts()
    _check(got == {"encoder": 8, "decoder": 6, "pusch_llr": 4,
                   "channel_mix": 4},
           f"HARQ batch launches {got}, expected 8, 6, 4 and 4")
    _check(all(not o["first_ok"].any() and not o["retx_ok"].any()
               and bool(o["combined_ok"].all()) for o in out.values()),
           f"HARQ verdicts at {chosen} dB: {out}")
    launches = {k: launches[k] + n for k, n in got.items()}
    # the combined buffers: full-graph decodes, kernel vs plain, timed, at
    # 8 pairs (the retransmission batch's) and 64 (the cell's)
    times, splits = [], []
    for bsz in (SLICE_BATCH, HARQ_PAIRS):
        p = gnb_mixed.make_payloads(cfg, np.random.default_rng(33), bsz, dev)
        f1, f2, cfg2 = gnb_mixed._harq_fronts(p, gnb_mixed.draw_harq_noise(
            cfg, bsz, gen, chosen), cfg, 2)
        for name, sh in (("u0", cfg.pusch0), ("u1", cfg.pusch1)):
            seg = sh.segments
            comb = f1[name].llr_full + f2[name].llr_full
            llr = comb.reshape(-1, comb.shape[-1]).contiguous()
            rec = _timed_decoder(f"HARQ combined {name}, {bsz} pairs", llr,
                                 seg.base_graph, seg.lifting_size, None,
                                 reps=50 if bsz == SLICE_BATCH else 10)
            times.append(rec)
            if bsz == SLICE_BATCH:
                splits.append(_phase_split(rec["shape"], llr, seg.base_graph,
                                           seg.lifting_size, None))
        del f1, f2
    print(f"[harq] 273-PRB mixed slot x{SLICE_BATCH} at snr1 {chosen:g} dB: "
          f"harq_pair_batch {pair_ms:.1f} ms a batch of pairs, every first "
          f"transmission failed and every combination passed; "
          f"harq_retx_batch: first and retx fail, the combination passes "
          f"for both UEs, {wall_ms:.1f} ms per batch; launches {launches}; "
          + "; ".join(f"{_fmt(r)}, {r['ctas_per_sm']} CTA/SM, {r['waves']} "
                      f"waves" for r in times) + f" on {card}")
    print(f"[harq] full-graph phase split per CTA: {'; '.join(splits)} on "
          f"{card}")
    return {"launches": launches, "times": times, "snr1": chosen,
            "interval": best, "sweep": rows}


def phase_receivers(dev, card: str, u: dict) -> None:
    """The UE-side receivers on the flat mixed slot's UE grid, and an
    UpperPhy DL slot with an interleaved 2-symbol CORESET."""
    cfg = gnb_mixed.default_mixed()
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(40),
                                  SLICE_BATCH, dev)
    front = gnb_mixed._mixed_front(
        pay, *gnb_mixed.draw_noise(cfg, SLICE_BATCH, torch.Generator(
            device=dev).manual_seed(40)), cfg)
    ue = front["ue_grid"]                            # [B, 2, 14, nsc]
    cands = torch.tensor([0, 4, 8, 12], device=dev)
    for key, pc in (("dci_dl", cfg.pdcch_dl), ("dci_ul", cfg.pdcch_ul)):
        got, ok = pdcch.pdcch_blind_receive(ue, pc, cands)
        true = cands.tolist().index(pc.cce_index)
        want = torch.zeros_like(ok)
        want[:, true] = True
        _check(torch.equal(ok, want) and torch.equal(got[:, true], pay[key]),
               f"blind receive of {key}: crc {ok.tolist()}")
    lo = cfg.ssb_prb_start * 12
    bits, ok = ssb.ssb_receive_pbch(ue[:, 0, 2:6, lo:lo + 240], cfg.ssb)
    _check(bool(ok.all()) and torch.equal(bits, pay["pbch"]),
           f"PBCH of the UE grid: crc {ok.tolist()}")
    # UpperPhy: a DCI on an interleaved 2-symbol CORESET, with the SSB
    phy, car, gen, rng = u["phy"], u["car"], u["gen"], u["rng"]
    pc = pdcch.PdcchConfig(rnti=0x4601, payload_size=40, cce_index=4,
                           nof_symbols=2, interleaved=True,
                           coreset_nof_prb=48, shift=car.ssb.pci)
    dci = rng.integers(0, 2, 40).astype(np.int8)
    req = fapi.DlTtiRequest(0, 0, ssb_pdus=[fapi.SsbPdu(
        car.ssb, rng.integers(0, 2, 32).astype(np.int8), car.ssb_sc)],
        pdcch_pdus=[fapi.PdcchPdu(pc, dci)])
    grid = phy.process_dl_slot(req)
    res = pdcch.pdcch_receive(fapi_carrier.downlink(grid, car, gen), pc)
    _check(bool(res.crc_ok[0]) and np.array_equal(
        res.payload[0].cpu().numpy(), dci),
        "pdcch_receive lost the DCI of the interleaved CORESET")
    print(f"[receivers] {cfg.nof_prb}-PRB mixed slot UE grid x{SLICE_BATCH}:"
          f" pdcch_blind_receive over CCEs {cands.tolist()} at AL4, only the "
          f"true candidate passes for both RNTIs with the sent DCI; "
          f"ssb_receive_pbch returns every sent PBCH payload; UpperPhy DL "
          f"slot, DCI on an interleaved 2-symbol CORESET (48 PRB, R=2, shift "
          f"{car.ssb.pci}) at {car.snr_db:.0f} dB: pdcch_receive recovers it "
          f"on {card}")


def _long_prach(dev, gen, root: int, n_cs: int, restricted: str) -> str:
    """A format-0 long preamble at 122.88 MHz (a window over two 0.5 ms
    slots) through PrachWindowAssembler and detect: the preamble and its
    delay."""
    fs, length, k0, start = 122.88e6, 839, 12, 6000
    fft, nrep, cp = prach_demod.long_format_geometry("0", fs)
    _check((fft, nrep, cp) == (98304, 1, 12672), "format-0 geometry")
    cvs = (prach_ops.restricted_a_cv(length, n_cs, root)
           if restricted == "type_a"
           else prach_ops.unrestricted_cv(length, n_cs))
    v = 7 if restricted != "type_a" else len(cvs) // 2
    delay = 351                                        # ~3 ZC chips
    bins = torch.zeros(fft, dtype=torch.complex64, device=dev)
    bins[k0:k0 + length] = torch.from_numpy(prach_ops.generate_cv(
        root, cvs[v], length)).to(dev)
    period = torch.fft.ifft(bins) * (fft / np.sqrt(length))
    burst = torch.cat([period[-cp:], period])
    slot = 61440                                       # μ=1, nfft 4096
    stream = torch.zeros(3 * slot, dtype=torch.complex64, device=dev)
    stream[start + delay:start + delay + burst.shape[0]] = burst
    nz = torch.randn((2, stream.shape[0]), generator=gen, device=dev)
    stream = stream + torch.complex(nz[0], nz[1]) * float(
        np.sqrt(fft / length / 2))                    # 0 dB per sample
    asm = prach_demod.PrachWindowAssembler(start, fft, length, k0, cp)
    done = [s for s in range(3) if asm.feed(stream[s * slot:(s + 1) * slot])]
    _check(done[0] == 1, f"window of {asm.need} samples from {start} "
           f"completed in slot {done[0]}, not 1")
    m, d, _ = prach_ops.detect(asm.demodulate()[None], root, length, n_cs,
                               restricted_set=restricted)
    m, d = m[0].cpu().numpy(), d[0].cpu().numpy()
    want = delay * length / fft
    _check(int(np.argmax(m)) == v and m[v] > 16.0
           and abs(d[v] - want) < 0.5,
           f"{restricted} long PRACH: argmax {int(np.argmax(m))} (sent {v}),"
           f" metric {m[v]:.1f}, delay {d[v]:.2f} chips (sent {want:.2f})")
    return (f"{restricted} root {root} N_cs {n_cs}: preamble {v} of "
            f"{len(cvs)} detected, metric {m[v]:.1f}, delay {d[v]:.2f} "
            f"chips (sent {want:.2f})")


def phase_lower(dev, card: str, u: dict) -> dict:
    """AsyncLowerPhy streaming the FAPI carrier's DL grids, and the long
    PRACH through the window assembler."""
    phy, car, rng = u["phy"], u["car"], u["rng"]
    gen = torch.Generator(device=dev).manual_seed(50)
    cfg = lower_phy.LowerPhyConfig(mu=1, nfft=car.nfft, nof_prb=car.nof_prb)
    nslots = 8
    kernel_taps.reset_launch_counts()
    reqs = [fapi_carrier.dl_request(car, s, rng) for s in range(nslots)]
    c0 = phy.graphs.captures
    # eight grids kept at once: each is the slot's own, not the last replay's
    grids = [phy.process_dl_slot(req, data) for req, data in reqs]
    warmups = phy.graphs.captures - c0
    got = {}
    eng = lower_phy.AsyncLowerPhy(
        cfg, lambda s: grids[s] if s < nslots else None,
        lambda s, g: got.__setitem__(s, g), depth=2, device=dev)
    total = sum(eng.timeline.slot_size(s) for s in range(nslots))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pulled, chunks = 0, 0
    while pulled < total:
        n = min(7777 + 1000 * (chunks % 3), total - pulled)
        bb = eng.pull_tx(n)
        eng.push_rx(fapi_carrier.add_awgn(bb, car, car.snr_db, gen))
        pulled += n
        chunks += 1
    torch.cuda.synchronize()
    stream_us = (time.perf_counter() - t0) / nslots * 1e6
    _check(sorted(got) == list(range(nslots)), f"UL slots {sorted(got)}")
    for s, (req, data) in enumerate(reqs):
        sh = req.pdsch_pdus[0].config                 # PDSCH A of slot s
        res = sch.pusch_receive(got[s][None, None], sh)
        _check(bool(res.tb_crc_ok[0]) and np.array_equal(
            res.tb_bits[0].cpu().numpy(), data.transport_blocks[0]),
            f"lower-PHY slot {s}: PDSCH A did not decode")
    torch.cuda.synchronize()
    launches = kernel_taps.launch_counts()
    _check(launches == {"encoder": 2 * (nslots + warmups), "decoder": nslots,
                        "pusch_llr": nslots, "channel_mix": 0},
           f"lower-PHY run launches {launches} ({warmups} captures)")
    st = eng.tx_stats
    stats = (f"mean {float(st.mean_power_dbfs):.2f} dBFS, peak "
             f"{float(st.peak_power_dbfs):.2f} dBFS, PAPR "
             f"{float(st.papr_db):.2f} dB, clipped "
             f"{float(st.clipped_ratio):.3f}")
    prach = [_long_prach(dev, gen, 129, 13, "unrestricted"),
             _long_prach(dev, gen, 201, 26, "type_a")]
    print(f"[lower] AsyncLowerPhy {car.nof_prb} PRB nfft {car.nfft} depth 2: "
          f"{nslots} FAPI-carrier DL grids streamed in {chunks} chunks of "
          f"7777-9777 samples through AWGN at {car.snr_db:.0f} dB, "
          f"{stream_us:.1f} us/slot (pull + push, host clock); every PDSCH A "
          f"decoded (sch.pusch_receive, BG1 Z=384 x8), launches {launches}; "
          f"tx_stats of the last slot: {stats}; format-0 PRACH at 122.88 MHz "
          f"(FFT 98304, CP 12672, window over slots 0-1): "
          f"{'; '.join(prach)} on {card}")
    return {"launches": launches, "times": []}


SCAN_K = 8                      # the mixed273 cells' K
SCAN_SHAPES = ((8, 4), (64, 2))  # (B, dispatches of the window)


def _replay_kernels(pipe, batch, seed: int) -> dict:
    """The counted kernels the device ran in one scan dispatch under
    torch.profiler, which must be the launches the capture counted."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipe.submit_scan(batch, seed)
        ok, _, _ = pipe.fetch_accumulated()
    _check(ok, "a slot failed in the profiled dispatch")
    kern = _device_entries(prof)
    ran = {kind: sum(e.count for e in kern if tag in e.key)
           for kind, tag in (("encoder", "ldpc_encode_kernel"),
                             ("decoder", "ldpc_decode_kernel"),
                             ("pusch_llr", "pusch_llr_kernel"),
                             ("channel_mix", "channel_mix_kernel"))}
    counted = pipe.program.captured_launches
    _check(ran == counted, f"the profiler saw {ran} kernels in one "
           f"replay, the capture counted {counted}")
    return ran


def _call_shape(rec: dict) -> str:
    bg, zc = rec["args"][:2]
    n_used = rec["kw"].get("nof_used_blocks")
    graph = ("" if rec["fn"] == "encode" else
             f" n_used {n_used}" if n_used else " full graph")
    return f"BG{bg} Z={zc} x{rec['x'].shape[0]}{graph}"


def _scan_kernels(card: str, label: str, pipe, batch,
                  timed: bool) -> list[dict]:
    """Both kernels inside a replay: on a pipeline whose kernel calls are
    tapped, every launch of one replay takes and gives what the same launch
    of the eager K-batch loop on the same seed takes and gives (LLRs and
    messages, bits, ok flags and codewords), and every eager launch gives
    what the plain version gives on its inputs.  timed: the kernel and its
    plain version are also timed at each shape of the first batch."""
    k = pipe.config.scan_batches
    with kernel_taps.tapped_kernels() as sink:
        pipe.warmup_scan(batch)
        noise = pipe.scan_noise(77)
        # a tapped replay copies its launches' taps into sink.eager
        sink.eager.clear()
        ok_r, sum_r = (t.clone() for t in pipe.replay_scan())
        graph = sink.eager[:]
        sink.eager.clear()
        ok_e, sum_e = pipe.scan_step(batch, noise)
        torch.cuda.synchronize()
    eager = sink.eager
    n = kernel_taps.tapped_launches(pipe.program.captured_launches)
    _check(len(graph) == len(eager) == n, f"{label}: {len(graph)} kernel "
           f"calls replayed, {len(eager)} eager, {n} launches counted")
    _check(bool(ok_r) and bool(ok_e) and torch.equal(sum_r, sum_e),
           f"{label}: tapped replay (ok {bool(ok_r)}, sum {float(sum_r)!r}) "
           f"!= eager (ok {bool(ok_e)}, sum {float(sum_e)!r})")
    for i, (g, e) in enumerate(zip(graph, eager)):
        what = f"{label}: launch {i} ({g['fn']} {_call_shape(g)})"
        _check(g["fn"] == e["fn"] and g["args"] == e["args"]
               and g["kw"] == e["kw"], f"{what}: the replay and the eager "
               f"loop called the kernels in another order")
        _check(torch.equal(g["x"], e["x"]), f"{what}: the replay's input "
               f"differs from the eager loop's")
        _check(all(torch.equal(a, b) for a, b in zip(g["out"], e["out"])),
               f"{what}: the replay's output differs from the eager loop's")
    plain = {"encode": encoder_cuda.encode_plain,
             "decode": decoder_cuda.decode_plain}
    for i, e in enumerate(eager):
        want = plain[e["fn"]](e["x"], *e["args"], **e["kw"])
        want = want if isinstance(want, tuple) else (want,)
        _check(all(torch.equal(a, b) for a, b in zip(e["out"], want)),
               f"{label}: launch {i} ({e['fn']} {_call_shape(e)}) != plain")
    shapes = sorted({f"{e['fn']}r {_call_shape(e)}" for e in eager})
    times = []
    for e in eager[:n // k] if timed else []:
        x, (bg, zc), kw = e["x"], e["args"][:2], e["kw"]
        if e["fn"] == "decode":
            times.append(_timed_decoder(f"{label}", x, bg, zc,
                                        kw.get("nof_used_blocks")))
            continue
        times.append(_timed(
            "encoder", f"{_call_shape(e)} ({label})",
            lambda x=x, bg=bg, zc=zc: encoder_cuda.encode(x, bg, zc),
            lambda x=x, bg=bg, zc=zc: encoder_cuda.encode_plain(x, bg, zc),
            200, 3, encoder_bound(bg, zc, x.shape[0])))
    print(f"[{label}] kernels inside one replay: all {n} launches took and "
          f"gave, bit for bit, what the eager K-batch loop's took and gave "
          f"on the same seed (sinr_sum {float(sum_r)!r} both); every eager "
          f"launch bit-exact against its plain version; shapes: "
          f"{', '.join(shapes)}"
          + "".join(f"; {_fmt(r)}" + (f", {r['ctas_per_sm']} CTA/SM, "
                                       f"{r['waves']} waves"
                                       if "waves" in r else "")
                    for r in times) + f" on {card}")
    return times


def _scan_run(dev, card: str, label: str, pipe, batch, per_batch: dict,
              dispatches: int, sinr_tol: float) -> dict:
    """The scan mode of one pipeline on the card: warmup_scan (the
    program's eager warm-up and capture), one replay against the eager
    K-batch loop on the same seed, a replay with the static noise ×100, a
    window of dispatches and one fetch (counts reset just before and read
    just after), and the kernels the device ran in one profiled dispatch."""
    k, b = pipe.config.scan_batches, pipe.config.slots_per_batch
    snr = pipe.config.snr_db if pipe.config.carrier else 20.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    warm_s, ok0, mean0 = pipe.warmup_scan(batch)
    # above what was allocated before: the eager warmup's peak, and what
    # the static buffers and the graph's pool keep reserved
    peak_gib = (torch.cuda.max_memory_allocated() - base[0]) / 2 ** 30
    held_gib = (torch.cuda.memory_reserved() - base[1]) / 2 ** 30
    _check(ok0 and abs(mean0 - snr) < sinr_tol,
           f"{label}: scan warmup ok {ok0}, mean SINR {mean0:.2f} dB")
    per_replay = pipe.program.captured_launches
    want = {kind: n * k for kind, n in per_batch.items()}
    _check(per_replay == want, f"{label}: the graph captured {per_replay} "
           f"launches, expected {want}")
    # one replay against the eager K-batch loop on the same noise
    noise = pipe.scan_noise(77)
    ok_r, sum_r = (t.clone() for t in pipe.replay_scan())
    ok_e, sum_e = pipe.scan_step(batch, noise)
    torch.cuda.synchronize()
    rel = abs(float(sum_r) - float(sum_e)) / abs(float(sum_e))
    bit_equal = torch.equal(sum_r, sum_e)
    _check(bool(ok_r) and bool(ok_e) and rel <= 1e-6,
           f"{label}: replay (ok {bool(ok_r)}, sum {float(sum_r)!r}) != "
           f"eager (ok {bool(ok_e)}, sum {float(sum_e)!r})")
    # the graph reads the static noise buffer: ×100 noise fails the slots
    for n in pipe.scan_noise(77):
        n.mul_(100.0)
    loud_ok = bool(pipe.replay_scan()[0])
    _check(not loud_ok, f"{label}: a replay on ×100 noise still passed")
    # a window: several dispatches, one fetch
    pipe.fetch_accumulated()
    kernel_taps.reset_launch_counts()
    for i in range(dispatches):
        pipe.submit_scan(batch, 1000 + i * k)
    all_ok, mean, nslots = pipe.fetch_accumulated()
    launches = kernel_taps.launch_counts()
    _check(all_ok and nslots == dispatches * k * b
           and abs(mean - snr) < sinr_tol,
           f"{label}: window ok {all_ok}, {nslots} slots, SINR {mean:.2f}")
    _check(launches == {kd: dispatches * v for kd, v in want.items()},
           f"{label}: window launches {launches}, expected {dispatches} x "
           f"{want}")
    ran = _replay_kernels(pipe, batch, 3000)
    pool = pipe.graphs
    print(f"[{label}] B={b} K={k} ({pipe.slots_per_dispatch} slots per "
          f"dispatch): warmup_scan {warm_s:.2f} s, {pool.captures} capture "
          f"in {pool.capture_seconds:.2f} s, device memory (max_memory_"
          f"allocated) {peak_gib:.2f} GiB over the baseline at its peak, "
          f"{held_gib:.2f} GiB more reserved after; replay vs eager loop on "
          f"one seed: all_ok equal, sinr_sum "
          f"{'bit-equal' if bit_equal else f'within {rel:.1e} relative'} "
          f"({float(sum_r)!r}); x100 noise replay all_ok {loud_ok}; "
          f"{dispatches} dispatches, one fetch: all {nslots} slots ok, mean "
          f"UL SINR {mean:.2f} dB, launches {launches} ({per_replay} per "
          f"replay; the profiler saw {ran} in one), {pool.replays} replays "
          f"on {card}")
    return {"launches": launches, "times": []}


def phase_scan(dev, card: str, cfg=None, shapes=SCAN_SHAPES,
               k: int = SCAN_K) -> list[dict]:
    """The mixed slot's scan mode (``warmup_scan``/``submit_scan``/
    ``fetch_accumulated``, one CUDA graph per dispatch) at the mixed273
    cells' B and K."""
    cfg = cfg or gnb_mixed.default_mixed()
    label = f"scan {cfg.nof_prb}-PRB mixed"
    runs = []
    for b, dispatches in shapes:
        def pipe():
            return pipeline.SlotPipeline(
                pipeline.PipelineConfig(carrier=None, slots_per_batch=b,
                                        scan_batches=k),
                device=dev, seed=9,
                batch_fn=gnb_mixed.batch_fn_for_pipeline(cfg))
        payloads = gnb_mixed.make_payloads(cfg, np.random.default_rng(9 + b),
                                           b, dev)
        # the kernels of a tapped replay; at B > 8 their shapes are new to
        # this script, and are timed
        times = _scan_kernels(card, f"{label} B={b}", pipe(), payloads,
                              timed=b > SLICE_BATCH)
        torch.cuda.empty_cache()
        per_batch = {"encoder": 4, "decoder": 2, "pusch_llr": 2,
                     "channel_mix": 2}
        runs.append(_scan_run(dev, card, label, pipe(), payloads, per_batch,
                              dispatches, 1.0) | {"times": times})
        del payloads
        torch.cuda.empty_cache()
    return runs


def phase_flagship_scan(dev, card: str, cfg=None, b: int = SLICE_BATCH,
                        k: int = SCAN_K) -> dict:
    """The flagship loopback's scan mode, its noise from the pipeline's
    own draw."""
    cfg = cfg or gnb_flagship.default_carrier()
    label = f"flagship-scan {cfg.nof_prb}-PRB"

    def pipe():
        return pipeline.SlotPipeline(pipeline.PipelineConfig(
            carrier=cfg, slots_per_batch=b, scan_batches=k), device=dev,
            seed=10)
    tb = torch.randint(0, 2, (b, cfg.sh.tbs), device=dev, dtype=torch.int8,
                       generator=torch.Generator(device=dev).manual_seed(10))
    _scan_kernels(card, f"{label} B={b}", pipe(), tb, timed=False)
    torch.cuda.empty_cache()
    return _scan_run(dev, card, label, pipe(), tb,
                     {"encoder": 1, "decoder": 1, "pusch_llr": 1,
                      "channel_mix": 0}, 4, 1.5)


def phase_accumulate(dev, card: str, cfg=None, b: int = SLICE_BATCH) -> dict:
    """Accumulate mode over eager submits against the reduction of
    ``drain()`` of a pipeline with the same seed."""
    cfg = cfg or gnb_mixed.default_mixed()
    payloads = gnb_mixed.make_payloads(cfg, np.random.default_rng(11), b, dev)

    def pipe():
        return pipeline.SlotPipeline(
            pipeline.PipelineConfig(carrier=None, slots_per_batch=b, depth=2),
            device=dev, seed=11, batch_fn=gnb_mixed.batch_fn_for_pipeline(cfg))
    ref = pipe()
    for _ in range(3):
        ref.submit(payloads)
    res = ref.drain()
    oks = np.concatenate([ok for ok, _ in res])
    sinrs = np.concatenate([s for _, s in res]).astype(np.float64)
    acc = pipe()
    kernel_taps.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(3):
        acc.submit_accumulated(payloads)
    ok, mean, n = acc.fetch_accumulated()
    wall = time.perf_counter() - t0
    launches = kernel_taps.launch_counts()
    rel = abs(mean - sinrs.mean()) / abs(sinrs.mean())
    _check(ok == bool(oks.all()) and ok and n == 3 * b and rel <= 1e-6,
           f"accumulate ({ok}, {mean!r}, {n}) != drain ({bool(oks.all())}, "
           f"{sinrs.mean()!r}, {oks.size})")
    _check(launches == {"encoder": 12, "decoder": 6, "pusch_llr": 6,
                        "channel_mix": 6},
           f"accumulate launches {launches}")
    print(f"[accumulate] {cfg.nof_prb}-PRB mixed slot, 3 eager submits of "
          f"{b}: fetch_accumulated ({ok}, {mean:.6f} dB, {n}) equals the "
          f"drain() reduction ({bool(oks.all())}, {sinrs.mean():.6f} dB, "
          f"{oks.size}) within {rel:.1e} relative; "
          f"{wall / n * 1e6:.1f} us/slot, launches {launches} on {card}")
    return {"launches": launches, "times": []}


def phase_ops(dev, card: str, cfg=None) -> None:
    """The ops of the JAX package that the port gained in this slice, once
    each on the card at the mixed slot's sizes, against the same call on
    the CPU (exact for bits, tables and hard decisions; floats within
    1e-5 of max|CPU|, the OFDM window within 4e-5)."""
    from srsran_project_23_5_tpu_torch.ops import (bits, crc, equalizer,
                                                   modulation, precoding)
    from srsran_project_23_5_tpu_torch.ops.ldpc import encoder, rate_match
    cfg = cfg or gnb_mixed.default_mixed()
    rng = np.random.default_rng(12)
    worst = {}

    def same(name: str, got, want, rel: float | None = None) -> None:
        got = got.cpu() if isinstance(got, torch.Tensor) else got
        if isinstance(want, np.ndarray):
            want = torch.from_numpy(want)
        if rel is None:
            _check(torch.equal(got, want.to(got.dtype)),
                   f"{name}: card != CPU")
            worst[name] = 0.0
            return
        err = float((got - want).abs().max() / want.abs().max())
        _check(err <= rel, f"{name}: card vs CPU {err:.2e} of max|CPU|")
        worst[name] = err

    def cplx(*shape):
        return torch.from_numpy((rng.standard_normal(shape)
                                 + 1j * rng.standard_normal(shape)
                                 ).astype(np.complex64))

    nsc, nre = cfg.nsc, cfg.nsc * 12
    tb = torch.from_numpy(rng.integers(0, 2, (SLICE_BATCH, 8 * (
        cfg.pdsch0.tbs // 8))).astype(np.int8))
    packed = bits.pack_bits(tb.to(dev))
    same("pack_bits", packed, bits.pack_bits_np(tb.numpy()))
    same("unpack_bits", bits.unpack_bits(packed), tb)
    same("crc (crc_np)", crc.crc(tb.to(dev), "crc24A"),
         crc.crc_np(tb.numpy(), "crc24A"))
    msg = rng.integers(0, 2, (4, 10 * 16)).astype(np.int8)
    same("encoder kernel (encode_np)",
         encoder_cuda.encode(torch.from_numpy(msg).to(dev), 2, 16),
         encoder.encode_np(msg, 2, 16))
    for qm in (1, 2, 4, 6, 8):
        b = torch.from_numpy(rng.integers(0, 2, (2, nre * qm)).astype(np.int8))
        same(f"modulate_lut qm {qm}", modulation.modulate_lut(b.to(dev), qm),
             modulation.modulate_lut(b, qm), 1e-5)
    b = torch.from_numpy(rng.integers(0, 2, (2, nre)).astype(np.int8))
    same("modulate_pi2_bpsk", modulation.modulate_pi2_bpsk(b.to(dev)),
         modulation.modulate_pi2_bpsk(b), 1e-5)
    llr = torch.from_numpy((40 * rng.standard_normal((2, nre))
                            ).astype(np.float32))
    same("quantize_llr", modulation.quantize_llr(llr.to(dev), 0.5),
         modulation.quantize_llr(llr, 0.5))
    same("hard_decision", modulation.hard_decision(llr.to(dev)),
         modulation.hard_decision(llr))
    # the per-codeblock rate matcher at pusch0's first codeblock
    sh = cfg.pusch0
    seg, e = sh.segments, sh.cb_lengths[0]
    key = (seg.base_graph, seg.lifting_size, sh.rv, seg.payload_length,
           seg.segment_length, e, sh.qm)
    cw = encoder_cuda.encode_plain(torch.from_numpy(rng.integers(
        0, 2, (2, seg.segment_length)).astype(np.int8)), *key[:2])
    bits_e = rate_match.match(cw, *key)
    same("rate_match.match", rate_match.match(cw.to(dev), *key), bits_e)
    same("interleave/deinterleave", rate_match.deinterleave(
        rate_match.interleave(bits_e.to(dev), sh.qm), sh.qm), bits_e)
    llr_e = torch.from_numpy(rng.standard_normal((2, e)).astype(np.float32))
    full = rate_match.dematch(llr_e, *key)
    same("rate_match.dematch", rate_match.dematch(llr_e.to(dev), *key), full,
         1e-5)
    same("combine_retransmission", rate_match.combine_retransmission(
        full.to(dev), full.to(dev), seg.payload_length, seg.lifting_size),
        rate_match.combine_retransmission(full, full, seg.payload_length,
                                          seg.lifting_size), 1e-5)
    lay = cplx(2, 2, nre // 2)
    same("layer_demap", precoding.layer_demap(lay.to(dev)),
         precoding.layer_demap(lay))
    w1 = precoding.one_layer_codebook(2, 1)
    same("apply_precoding (one_layer_codebook)",
         precoding.apply_precoding(lay[:, :1].to(dev), w1),
         precoding.apply_precoding(lay[:, :1], w1), 1e-5)
    y, h1, h2 = cplx(2, 2, nre), cplx(2, 2, nre), cplx(2, 2, 2, nre)
    for name, fn, h in (("mmse_1xn", equalizer.mmse_1xn, h1),
                        ("zf_2x2", equalizer.zf_2x2, h2)):
        got = fn(y.to(dev), h.to(dev), 0.05)
        want = fn(y, h, 0.05)
        for i, part in enumerate(("x_hat", "noise var")):
            same(f"{name} {part}", got[i], want[i], 1e-5)
    grid = cplx(2, 14, nsc)
    bb = ofdm.modulate_slot(grid, cfg.mu, cfg.nfft)
    for off in (0.25, 0.5):
        same(f"demodulate_slot rx_window_offset {off}",
             ofdm.demodulate_slot(bb.to(dev), nsc, cfg.mu, cfg.nfft,
                                  rx_window_offset=off),
             ofdm.demodulate_slot(bb, nsc, cfg.mu, cfg.nfft,
                                  rx_window_offset=off), 4e-5)
    q, _ = np.linalg.qr(rng.standard_normal((2, 2))
                        + 1j * rng.standard_normal((2, 2)))
    tb0 = torch.from_numpy(rng.integers(0, 2, (2, cfg.pdsch0.tbs)
                                        ).astype(np.int8))
    g0 = torch.zeros((2, 2, 14, nsc), dtype=torch.complex64)
    same("pdsch_transmit(w=unitary 2x2)",
         sch.pdsch_transmit(tb0.to(dev), cfg.pdsch0, g0.to(dev), w=q),
         sch.pdsch_transmit(tb0, cfg.pdsch0, g0, w=q), 1e-5)
    print(f"[ops] {len(worst)} ops at {cfg.nof_prb} PRB (nfft {cfg.nfft}), "
          f"card vs CPU, worst error over max|CPU|: "
          + ", ".join(f"{k} {v:.1e}" for k, v in worst.items())
          + f" on {card}")


# configs/gnb_loopback.yml's settings at the full width (built with
# from_dict: the card's Python may have no PyYAML)
APP_RAW = {"cell": {"pci": 1, "nof_prb": 273, "mu": 1,
                    "tdd": {"period": 10, "nof_dl": 6, "nof_ul": 3}},
           "phy": "loopback", "slots": 300, "snr_db": 30.0,
           "log": {"level": "warning"},
           "ue": {"enabled": True, "dl_packets": 6, "ul_packets": 6}}
# the JAX slow test test_gnb_app_ta_closed_loop, at 273 PRB
APP_TA_RAW = {"cell": {"nof_prb": 273}, "phy": "loopback", "slots": 200,
              "snr_db": 28.0, "ue": {"delay_samples": 12.0,
                                     "dl_packets": 2, "ul_packets": 2}}
APP_PROFILE_SLOTS = 20
# the parts of an app slot: (owner, attribute, part)
_APP_PARTS = (("du", "run_slot", "host"), ("mac_to_fapi", "translate", "host"),
              ("fapi_to_mac", "handle_indications", "host"),
              ("upper", "process_dl_slot", "gNB DL PHY"),
              ("upper", "process_ul_slot", "gNB UL PHY"),
              ("phy", "_ofdm_roundtrip", "OFDM+AWGN"),
              ("phy", "_ue_process_dl", "UE DL"),
              ("phy", "_ue_build_ul", "UE UL build"))


@contextlib.contextmanager
def _app_clock(gnb, sync):
    """Time each part of every app slot (``_APP_PARTS``, the validators as
    host, and the whole slot); each part calls ``sync`` before its clock
    stops, so its device work is inside its time.  Also keeps the uplink
    indications of each slot and the slot the UE reached RRC ACTIVE."""
    rec = types.SimpleNamespace(parts=[], slots=[], inds=[], attach=None,
                                slot=-1)
    owners = {"du": gnb.du, "mac_to_fapi": gnb.mac_to_fapi,
              "fapi_to_mac": gnb.fapi_to_mac, "upper": gnb._phy.upper,
              "phy": gnb._phy}
    targets = [(owners[o], a, part) for o, a, part in _APP_PARTS] + [
        (validators, a, "host") for a in ("validate_dl_tti",
                                          "validate_tx_data",
                                          "validate_ul_tti")]
    saved = [(owner, a, getattr(owner, a)) for owner, a, _ in targets]

    def clocked(fn, part):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            rec.parts.append((rec.slot, part, time.perf_counter() - t0))
            return out
        return call

    for owner, a, part in targets:
        setattr(owner, a, clocked(getattr(owner, a), part))
    handle = gnb.fapi_to_mac.handle_indications
    gnb.fapi_to_mac.handle_indications = lambda inds: (
        rec.inds.append((rec.slot, list(inds))), handle(inds))[1]
    one_slot = gnb._run_one_slot

    def run_one_slot(sfn, slot):
        rec.slot = slot
        t0 = time.perf_counter()
        one_slot(sfn, slot)
        sync()
        rec.slots.append(time.perf_counter() - t0)
        if rec.attach is None and gnb.ue.rrc.state == "active":
            rec.attach = slot
    gnb._run_one_slot = run_one_slot
    try:
        yield rec
    finally:
        for owner, a, fn in saved:
            setattr(owner, a, fn)
        del gnb._run_one_slot, gnb.fapi_to_mac.handle_indications


def _app_launches(card: str, label: str, sink) -> tuple[list[dict], str]:
    """Every kernel launch of an app run against its plain version on the
    same inputs (bit for bit), then each distinct shape timed with its
    bound.  Returns (times, "shape xN, ..." launches per shape)."""
    bad = kernel_taps.mismatches(sink.eager)
    _check(not bad, f"{label}: launches " + ", ".join(
        f"{i} ({sink.eager[i]['fn']} {_call_shape(sink.eager[i])})"
        for i in bad) + " != plain")
    shapes: dict[str, list[dict]] = {}
    for e in sink.eager:
        shapes.setdefault(f"{e['fn']}r {_call_shape(e)}", []).append(e)
    times = []
    for key, recs in sorted(shapes.items()):
        e = recs[0]
        x, (bg, zc), kw = e["x"], e["args"][:2], e["kw"]
        shape = f"{_call_shape(e)} ({label})"
        if e["fn"] == "encode":
            times.append(_timed(
                "encoder", shape,
                lambda x=x, bg=bg, zc=zc: encoder_cuda.encode(x, bg, zc),
                lambda x=x, bg=bg, zc=zc: encoder_cuda.encode_plain(x, bg,
                                                                   zc),
                200, 3, encoder_bound(bg, zc, x.shape[0])))
        else:
            times.append(_timed(
                "decoder", shape,
                lambda x=x, bg=bg, zc=zc, kw=kw: decoder_cuda.decode(
                    x, bg, zc, **kw),
                lambda x=x, bg=bg, zc=zc, kw=kw: decoder_cuda.decode_plain(
                    x, bg, zc, **kw),
                100, 3, decoder_bound(x, bg, zc, **kw)))
            times[-1]["ctas_per_sm"], times[-1]["waves"] = _waves(
                x.shape[0], bg, zc, kw.get("nof_used_blocks"))
        times[-1]["launches"] = len(recs)
    counts = ", ".join(f"{k} x{len(v)}" for k, v in sorted(shapes.items()))
    return times, counts


def _app_run(dev, card: str, label: str, raw: dict) -> dict:
    """One app run on the card, tapped and clocked, with the kernel counts
    set to 0 just before ``run()`` and read just after."""
    gnb = app_gnb.Gnb(app_gnb.GnbConfig.from_dict(raw))
    _check(gnb._phy.device == dev, f"{label}: the app runs on "
           f"{gnb._phy.device}, not {dev}")
    with kernel_taps.tapped_kernels() as sink, \
            _app_clock(gnb, torch.cuda.synchronize) as rec:
        kernel_taps.reset_launch_counts()
        t0 = time.perf_counter()
        rep = gnb.run()
        wall = time.perf_counter() - t0
        launches = kernel_taps.launch_counts()
    _check(_launched_every_kernel_but_the_mix(launches)
           and kernel_taps.tapped_launches(launches) == len(sink.eager),
           f"{label}: launches {launches}, {len(sink.eager)} tapped calls")
    times, counts = _app_launches(card, label, sink)
    return {"gnb": gnb, "rep": rep, "rec": rec, "wall": wall,
            "launches": launches, "times": times, "counts": counts}


def _app_gates(label: str, gnb, rep: dict) -> None:
    """test_gnb_app_phy_loopback_dci_over_grid's gates."""
    st, cfg = rep["phy_stats"], gnb.cfg
    _check(rep["ue_rrc_state"] == "active"
           and rep["ue_dl_rx_packets"] == cfg.ue_dl_packets
           and rep["core_ul_rx_packets"] == cfg.ue_ul_packets,
           f"{label}: the UE did not attach and exchange every packet: {rep}")
    _check(st["rar_decoded"] == 1 and st["dl_decoded"] >= 3
           and min(st["prach_tx"], st["pucch_ack_tx"], st["csi_f2_tx"]) >= 1,
           f"{label}: PHY counters {st}")
    _check(gnb.du.mac.scheduler.ues[rep["ue_rnti"]].cqi > 0,
           f"{label}: no CQI reached the scheduler")


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, q)) if xs else 0.0


def _strip_wall(rep: dict) -> dict:
    return {k: v for k, v in rep.items() if k not in ("wall_s", "slots_per_s")}


def phase_app(dev, card: str, raw: dict = APP_RAW) -> dict:
    """The gNB app's over-the-air loopback at full width on the card."""
    nprb = raw["cell"]["nof_prb"]
    label = f"app {nprb}-PRB"
    r = _app_run(dev, card, label, raw)
    gnb, rep, rec = r["gnb"], r["rep"], r["rec"]
    cfg = gnb.cfg
    _app_gates(label, gnb, rep)
    _check(rec.attach is not None, f"{label}: no attach slot")
    # ms per slot after attach: every slot, and the slots with PHY work
    busy = {s for s, part, _ in rec.parts if part not in ("host",)}
    after = range(rec.attach + 1, len(rec.slots))
    every = [rec.slots[s] for s in after]
    work = [rec.slots[s] for s in after if s in busy]
    split: dict[str, float] = {}
    for s, part, dt in rec.parts:
        if s > rec.attach:
            split[part] = split.get(part, 0.0) + dt
    total = sum(every)
    split_s = ", ".join(f"{k} {v / len(every) * 1e3:.3f} ms "
                        f"({100 * v / total:.1f}%)"
                        for k, v in sorted(split.items(),
                                           key=lambda kv: -kv[1]))

    # the same run on the CPU: the same report and uplink indications
    cpu = app_gnb.Gnb(app_gnb.GnbConfig.from_dict({**raw, "platform": "cpu"}))
    with _app_clock(cpu, lambda: None) as cpu_rec:
        cpu_rep = cpu.run()
    _check(_strip_wall(cpu_rep) == _strip_wall(rep),
           f"{label}: the card's report {rep} != the CPU's {cpu_rep}")
    _check([s for s, _ in rec.inds] == [s for s, _ in cpu_rec.inds]
           and all(_same_indications(g, w, 0.05) for (_, g), (_, w)
                   in zip(rec.inds, cpu_rec.inds)),
           f"{label}: the uplink indications differ between the card and "
           f"the CPU")
    n_inds = sum(len(i) for _, i in cpu_rec.inds)

    # the device busy share of slots with traffic, after the run
    bearer = next(iter(gnb.cu_up.ues.values()))[0]
    for i in range(cfg.ue_dl_packets):
        gnb.cu_up.handle_ngu_pdu(app_gnb.gtpu.encode(
            app_gnb.gtpu.GtpuHeader(bearer.dl_teid, qfi=9),
            b"dl-ip-%03d" % i * 40))
    for i in range(cfg.ue_ul_packets):
        gnb.ue.send_ip_packet(b"ul-ip-%03d" % i * 30)
    next_slot = iter(range(cfg.slots, cfg.slots + APP_PROFILE_SLOTS))
    cfg.slots += APP_PROFILE_SLOTS           # the validators' slot bound
    prof = _profiled(lambda: gnb._run_one_slot(0, next(next_slot)),
                     APP_PROFILE_SLOTS, "slot")

    st = rep["phy_stats"]
    pools = "; ".join(
        f"{who}: {p.captures} captures in {p.capture_seconds:.2f} s, "
        f"{p.replays} replays, pool {p.reserved_bytes() / 2**20:.1f} MiB"
        for who, p in (("gNB UpperPhy", gnb._phy.upper.graphs),
                       ("UE modem", gnb._phy.graphs)))
    print(f"[{label}] gnb_loopback settings, mu={cfg.mu}, nfft "
          f"{gnb._phy.nfft}, TDD {cfg.tdd}, {cfg.slots - APP_PROFILE_SLOTS} "
          f"slots at {cfg.snr_db:.0f} dB: RRC {rep['ue_rrc_state']} at slot "
          f"{rec.attach}, packets DL {rep['ue_dl_rx_packets']}/"
          f"{cfg.ue_dl_packets} UL {rep['core_ul_rx_packets']}/"
          f"{cfg.ue_ul_packets}, phy_stats {st}, CQI "
          f"{gnb.du.mac.scheduler.ues[rep['ue_rnti']].cqi}; "
          f"{r['wall']:.2f} s wall, {rep['slots_per_s']} slots/s; ms per "
          f"slot after attach: all {len(every)} slots median "
          f"{_pct(every, 50):.3f} p90 {_pct(every, 90):.3f}, the {len(work)} "
          f"with PHY work median {_pct(work, 50):.3f} p90 "
          f"{_pct(work, 90):.3f}; split per slot after attach: {split_s}; "
          f"launches {r['launches']}; captured programs (run and profile) "
          f"{pools} on {card}")
    print(f"[{label}] every launch bit-exact against its plain version; "
          f"launches per shape: {r['counts']}; "
          + "; ".join(f"{_fmt(t)} x{t['launches']}" for t in r["times"])
          + f"; the same run on the CPU: the same report and the same "
          f"{n_inds} uplink indications in {len(cpu_rec.inds)} slots; "
          f"{APP_PROFILE_SLOTS} slots with "
          f"{cfg.ue_dl_packets}+{cfg.ue_ul_packets} more packets under "
          f"torch.profiler: {prof} on {card}")
    return {"launches": r["launches"], "times": r["times"]}


def phase_app_ta(dev, card: str, raw: dict = APP_TA_RAW) -> dict:
    """The timing-advance closed loop through the app on the card."""
    label = f"app-ta {raw['cell']['nof_prb']}-PRB"
    r = _app_run(dev, card, label, raw)
    rep, delay = r["rep"], raw["ue"]["delay_samples"]
    # test_gnb_app_ta_closed_loop's gates
    _check(rep["ue_rrc_state"] == "active"
           and rep["phy_stats"]["rar_decoded"] == 1
           and abs(rep["ue_ta_samples"] - delay) <= 2.5,
           f"{label}: RRC {rep['ue_rrc_state']}, TA {rep['ue_ta_samples']} "
           f"vs delay {delay}, phy_stats {rep['phy_stats']}")
    print(f"[{label}] FDD, {rep['slots']} slots at {raw['snr_db']:.0f} dB, "
          f"UE timing error {delay} samples: RRC {rep['ue_rrc_state']}, TA "
          f"{rep['ue_ta_samples']} samples, phy_stats {rep['phy_stats']}, "
          f"{rep['slots_per_s']} slots/s, launches {r['launches']}, every "
          f"launch bit-exact against plain ({r['counts']}) on {card}")
    return {"launches": r["launches"], "times": []}


FRONTHAUL_REPS = 20          # timed slots per fronthaul measurement
SOCKET_PRB = 52              # SocketRadio: a slot its receive buffer holds


class _TrxSession(radio.RadioSession):
    """``TrxDriver`` as a radio session: a slot written at its timestamp
    and read back whole (host numpy, as the driver is)."""

    def __init__(self, trx, nof_samples: int) -> None:
        self.trx, self.nof_samples = trx, nof_samples

    def transmit(self, samples, timestamp: int) -> None:
        self.trx.write(samples.cpu().numpy(), timestamp)

    def receive(self):
        return self.trx.read(self.nof_samples)


def _dl_verdicts(ue: torch.Tensor, dl, data) -> dict[str, bool]:
    """The UE's receivers on its grid [1, 14, nsc]: each PDSCH decoded to
    its TB, each DCI to its payload, the PBCH to its 32 bits."""
    out = {}
    for p, tb in zip(dl.pdsch_pdus, data.transport_blocks):
        res = sch.pusch_receive(ue[None], p.config)
        out[f"pdsch {p.config.rnti:#x}"] = bool(res.tb_crc_ok[0]) and \
            np.array_equal(res.tb_bits[0].cpu().numpy(), tb)
    for p in dl.pdcch_pdus:
        res = pdcch.pdcch_receive(ue, p.config)
        out[f"dci {p.config.rnti:#x}"] = bool(res.crc_ok[0]) and \
            np.array_equal(res.payload[0].cpu().numpy(), p.payload_bits)
    for p in dl.ssb_pdus:
        lo = p.first_subcarrier
        bits, ok = ssb.ssb_receive_pbch(ue[:, 2:6, lo:lo + ssb.SSB_NSC],
                                        p.config)
        out["pbch"] = bool(ok[0]) and np.array_equal(
            bits[0].cpu().numpy(), p.payload_bits)
    return out


def _snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    return 10 * math.log10(float((ref.abs() ** 2).mean())
                           / float(((got - ref).abs() ** 2).mean()))


def _ofh_dl(dev, car, grid: torch.Tensor, ctx=(0, 0, 0)):
    """A DL grid through RuOfh to an RU-side sector: (frames, the rebuilt
    grid, the RU-side sector)."""
    frames, got = [], {}
    ru_dl = ru.RuOfh(ru.RuConfig(nof_prb=car.nof_prb, mu=car.mu),
                     frames.append, device=dev)
    ru_side = ofh.OfhSector(ofh.OfhSectorConfig(nof_prb=car.nof_prb,
                                                eaxc_ul=0),
                            lambda f: None, device=dev)
    ru_side.on_ul_slot = lambda key, g: got.update({key: g})
    ru_dl.handle_dl_grid(ctx, grid)
    for f in frames:
        ru_side.handle_rx_frame(f)
    return frames, got[ctx], ru_side


def _ul_frames(dev, car, rx: torch.Tensor, ctx=(0, 1, 0)) -> list[bytes]:
    """The frames of the UL grid [ports, 14, nsc] from one RU-side sector
    per rx port (eAxC = port)."""
    frames = []
    for p in range(rx.shape[0]):
        ofh.OfhSector(ofh.OfhSectorConfig(nof_prb=car.nof_prb, eaxc_dl=p),
                      frames.append, device=dev).transmit_dl_slot(
            *ctx, rx[p])
    return frames


def _du_receive(dev, car, frames: list[bytes], nof_ports: int):
    """The frames offered to every one of nof_ports DU-side sectors (eAxC
    = port): (rebuilt grid [ports, 14, nsc], the sectors)."""
    got, du = {}, []
    for p in range(nof_ports):
        s = ofh.OfhSector(ofh.OfhSectorConfig(nof_prb=car.nof_prb,
                                              eaxc_ul=p),
                          lambda f: None, device=dev)
        s.on_ul_slot = lambda key, g, p=p: got.update({p: g})
        du.append(s)
    for f in frames:
        for s in du:
            s.handle_rx_frame(f)
    return torch.stack([got[p] for p in range(nof_ports)]), du


def _ofh_ul(dev, car, rx: torch.Tensor):
    """The UL grid [ports, 14, nsc] from one RU-side sector per rx port to
    one DU-side sector per port: (frames, rebuilt grid, DU-side
    sectors)."""
    frames = _ul_frames(dev, car, rx)
    return (frames, *_du_receive(dev, car, frames, rx.shape[0]))


def _fronthaul_times(dev, card: str, car, grid: torch.Tensor,
                     rx: torch.Tensor) -> str:
    """µs per slot and eAxC of DL compress + frame and UL reassemble +
    decompress (each call ends synchronised; ``utils.benchmark``
    percentiles, ``utils.tracing`` spans), the device time of the slot's
    BFP pack and unpack (CUDA events, launches queued), bytes per slot and
    eAxC, and the BFP SNR of both grids at w = 9, 12, 14."""
    sync = torch.cuda.synchronize
    ru_dl = ru.RuOfh(ru.RuConfig(nof_prb=car.nof_prb, mu=car.mu),
                     lambda f: None, device=dev)
    ul_frames = _ul_frames(dev, car, rx[:1])
    ul4_frames = _ul_frames(dev, car, rx)
    tracing.tracer.clear()
    tracing.tracer.enabled = True

    def dl_slot():
        with tracing.tracer.span("dl compress + frame", "ofh"):
            ru_dl.handle_dl_grid((0, 0, 0), grid)
            sync()

    def ul_slot():
        with tracing.tracer.span("ul reassemble + decompress", "ofh"):
            du = ofh.OfhSector(ofh.OfhSectorConfig(nof_prb=car.nof_prb,
                                                   eaxc_ul=0),
                               lambda f: None, device=dev)
            for f in ul_frames:
                du.handle_rx_frame(f)
            sync()

    def ul4_slot():
        with tracing.tracer.span("ul 4 eAxCs reassemble + decompress",
                                 "ofh"):
            _du_receive(dev, car, ul4_frames, rx.shape[0])
            sync()
    bench = benchmark.Benchmarker(f"OFH {car.nof_prb} PRB, BFP w=9")
    m_dl = bench.run("DL compress + frame", dl_slot, reps=FRONTHAUL_REPS)
    m_ul = bench.run("UL reassemble + decompress", ul_slot,
                     reps=FRONTHAUL_REPS)
    m_ul4 = bench.run("UL 4 eAxCs reassemble + decompress", ul4_slot,
                      reps=FRONTHAUL_REPS)
    tracing.tracer.enabled = False
    # read before the profiled slots, whose spans the tracer keeps too
    spans = {}
    for r in tracing.tracer.records():
        spans.setdefault(r.name, []).append((r.end_ns - r.start_ns) / 1e3)
    prof_dl = _profiled(dl_slot, 5, "slot")
    prof_ul = _profiled(ul_slot, 5, "slot")
    tracing.tracer.clear()
    span_s = "; ".join(f"{k} {np.median(v[-FRONTHAUL_REPS:]):.1f} us "
                       f"(median tracer span of the {FRONTHAUL_REPS} timed "
                       f"slots)" for k, v in spans.items())
    g3 = grid.reshape(14, car.nof_prb, 12)
    wire = bfp.compress_slot(g3, 9)
    pack_ms = _time_ms(lambda: bfp.compress_slot(g3, 9), 50, queued=True)
    unpack_ms = _time_ms(lambda: bfp.decompress_slot(wire, 9), 50,
                         queued=True)
    snr = {w: (_snr_db(grid, bfp.decompress_slot(
        bfp.compress_slot(g3, w), w).reshape(grid.shape)),
        _snr_db(rx, bfp.decompress_slot(bfp.compress_slot(
            rx.reshape(-1, 14, car.nof_prb, 12), w), w).reshape(rx.shape)))
        for w in (9, 12, 14)}
    frame_b = sum(len(f) for f in ul_frames)
    return (f"{car.nof_prb} PRB, BFP w=9, per slot and eAxC: DL compress + "
            f"frame p50 {m_dl.median_us:.1f} p90 {m_dl.percentile_us(90):.1f}"
            f" us, UL reassemble + decompress p50 {m_ul.median_us:.1f} p90 "
            f"{m_ul.percentile_us(90):.1f} us ({FRONTHAUL_REPS} slots each, "
            f"synchronised); per slot, UL of {rx.shape[0]} eAxCs into "
            f"{rx.shape[0]} DU-side sectors, every frame offered to each, "
            f"reassemble + decompress p50 {m_ul4.median_us:.1f} p90 "
            f"{m_ul4.percentile_us(90):.1f} us ({FRONTHAUL_REPS} slots, "
            f"synchronised); {span_s}; device time of the slot's BFP pack "
            f"{pack_ms * 1e3:.1f} us and unpack {unpack_ms * 1e3:.1f} us "
            f"(queued); {len(ul_frames)} frames, {frame_b} B per slot and "
            f"eAxC ({wire.numel()} B of compressed IQ, "
            f"{grid.numel() * 8} B as complex64); BFP SNR DL/UL grid: "
            + ", ".join(f"w={w} {a:.1f}/{b:.1f} dB"
                        for w, (a, b) in snr.items())
            + f"; torch.profiler over 5 DL slots: {prof_dl}; over 5 UL "
            f"slots: {prof_ul} on {card}")


def _socket_slot(dev, gen) -> str:
    """Split 8 over the UDP virtual RF at SOCKET_PRB: one slot sent and
    received whole, without a receiver thread, because the slot's datagrams
    fit the receive buffer."""
    cfg = ru.RuConfig(nof_prb=SOCKET_PRB, mu=1)
    a, b = radio.create_radio("socket"), radio.create_radio("socket")
    try:
        a.peer = ("127.0.0.1", b.port)
        rcvbuf = b._sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
        tx = ru.RuGeneric(cfg, a, device=dev)
        rx = ru.RuGeneric(cfg, b, device=dev)
        got = []
        rx.on_ul_grid = lambda ctx, g: got.append(g)
        grid = torch.randn((2, 14, cfg.nof_prb * 12), generator=gen,
                           device=dev)
        grid = torch.complex(grid[0], grid[1])
        tx.handle_dl_grid((0, 0, 0), grid)
        nbytes = 8 * tx._ts
        _check(nbytes < rcvbuf, f"socket slot {nbytes} B >= receive buffer "
               f"{rcvbuf} B")
        rx.trigger_ul_slot((0, 0, 0))
    finally:
        a.stop()
        b.stop()
    _check(len(got) == 1, "SocketRadio lost the slot")
    err = float(((got[0] - grid).abs() ** 2).mean())
    _check(err < 1e-6, f"SocketRadio slot error {err:.2e}")
    return (f"SocketRadio at {SOCKET_PRB} PRB (nfft {cfg.nfft}): "
            f"{tx._ts} samples, {nbytes} B of I/Q in "
            f"{-(-tx._ts // radio.SocketRadio._CHUNK)} datagrams against a "
            f"{rcvbuf}-B receive buffer, mean |error|^2 {err:.1e}")


def phase_fronthaul(dev, card: str, car=None) -> dict:
    """The FAPI carrier driven through SCF and carried over split 7.2 and
    split 8, every LDPC launch tapped and held against its plain
    version."""
    car = car or fapi_carrier.default_carrier()
    label = f"fronthaul {car.nof_prb}-PRB"
    phy = upper_phy.UpperPhy(car.upper_phy, dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    rng = np.random.default_rng(22)
    ru_cfg = ru.RuConfig(nof_prb=car.nof_prb, mu=car.mu)
    _check(ru_cfg.nfft == car.nfft, f"RU nfft {ru_cfg.nfft} != {car.nfft}")

    # ---- SCF: the carrier's slots as an SCF-speaking MAC builds them
    sdl, data = fapi_carrier.scf_dl_request(car, 0,
                                            np.random.default_rng(220))
    dl = scf.dl_tti_to_processor_request(sdl)
    ul = scf.ul_tti_to_processor_request(fapi_carrier.scf_ul_request(car, 1))
    dl_native, _ = fapi_carrier.dl_request(car, 0, np.random.default_rng(220))
    ul_native = fapi_carrier.ul_request(car, 1)
    diffs = (fapi_carrier.request_differences(dl, dl_native)
             + fapi_carrier.request_differences(ul, ul_native))
    # the UEs send the preamble where the carrier has it: the translation
    # reads no PRACH sub-carrier from the SCF PDU
    ue_ul = dataclasses.replace(ul, prach_pdus=ul_native.prach_pdus)
    pay = fapi_carrier.ul_payloads(ul, rng)

    with kernel_taps.tapped_kernels() as sink:
        kernel_taps.reset_launch_counts()
        # ---- DL over split 7.2
        grid = phy.process_dl_slot(dl, data)
        frames, rebuilt, ru_side = _ofh_dl(dev, car, grid)
        dl_72 = _dl_verdicts(fapi_carrier.downlink(rebuilt, car, gen), dl,
                             data)
        # ---- UL over split 7.2, one eAxC per rx port
        rx, prach_rx = fapi_carrier.uplink(ue_ul, pay, car, gen)
        ul_frames, rx_72, du = _ofh_ul(dev, car, rx)
        inds_72 = phy.process_ul_slot(rx_72, ul, slot_count=1,
                                      prach_rx=prach_rx)
        ul_72 = fapi_carrier.ul_checks(car, ul, pay, inds_72,
                                       phy.last_ul_slot["pusch"])
        # ---- split 8: RuGeneric over the in-memory radio, with AWGN (DL)
        # and without (the UL grid), and over the TRX driver (DL)
        outs = []
        air = ru.RuGeneric(ru_cfg, radio.InMemoryRadio(
            lambda bb: fapi_carrier.add_awgn(bb, car, car.snr_db, gen)),
            device=dev)
        air.on_ul_grid = lambda ctx, g: outs.append(g)
        air.handle_dl_grid((0, 0, 0), grid)
        air.trigger_ul_slot((0, 0, 0))
        dl_8 = _dl_verdicts(outs[-1][None], dl, data)
        wire8 = ru.RuGeneric(ru_cfg, radio.create_radio("loopback"),
                             device=dev)
        wire8.on_ul_grid = lambda ctx, g: outs.append(g)
        wire8.handle_dl_grid((0, 1, 0), rx)
        wire8.trigger_ul_slot((0, 1, 0))
        inds_8 = phy.process_ul_slot(outs[-1], ul, slot_count=2,
                                     prach_rx=prach_rx)
        ul_8 = fapi_carrier.ul_checks(car, ul, pay, inds_8,
                                      phy.last_ul_slot["pusch"])
        trx_rng = np.random.default_rng(23)
        sigma = fapi_carrier.noise_sigma(car, car.snr_db)
        drv = trx_mod.TrxDriver(
            numerology.sample_rate_hz(car.mu, car.nfft),
            channel=lambda x: x + (sigma * (
                trx_rng.standard_normal(x.shape)
                + 1j * trx_rng.standard_normal(x.shape))).astype(
                    np.complex64))
        drv.start()
        trx_ru = ru.RuGeneric(ru_cfg, _TrxSession(
            drv, numerology.slot_num_samples(car.mu, car.nfft)),
            device=dev)
        trx_ru.on_ul_grid = lambda ctx, g: outs.append(g)
        trx_ru.handle_dl_grid((0, 0, 0), grid)
        trx_ru.trigger_ul_slot((0, 0, 0))
        drv.stop()
        res = sch.pusch_receive(outs[-1][None, None], dl.pdsch_pdus[0].config)
        dl_trx = bool(res.tb_crc_ok[0]) and np.array_equal(
            res.tb_bits[0].cpu().numpy(), data.transport_blocks[0])
        torch.cuda.synchronize()
        launches = kernel_taps.launch_counts()
    _check(_launched_every_kernel_but_the_mix(launches)
           and kernel_taps.tapped_launches(launches) == len(sink.eager),
           f"{label}: launches {launches}, {len(sink.eager)} tapped calls")

    # ---- the verdicts
    _check(len(frames) == 1 + 14 * -(-car.nof_prb // 255)
           and ru_side.rx_no_cplane == 0, f"{label}: {len(frames)} DL "
           f"frames, rx_no_cplane {ru_side.rx_no_cplane}")
    snr_dl, snr_ul = _snr_db(grid, rebuilt), _snr_db(rx, rx_72)
    _check(snr_dl > 40 and snr_ul > 40, f"{label}: BFP w=9 SNR DL "
           f"{snr_dl:.1f} dB, UL {snr_ul:.1f} dB")
    _check(all(dl_72.values()), f"{label}: DL over split 7.2 {dl_72}")
    _check(all(ul_72.values()), f"{label}: UL over split 7.2 {ul_72}")
    _check([s.rx_filtered for s in du] == [len(ul_frames) * 3 // 4] * 4,
           f"{label}: eAxC filter {[s.rx_filtered for s in du]}")
    _check(all(dl_8.values()) and all(ul_8.values()) and dl_trx,
           f"{label}: split 8 DL {dl_8}, UL {ul_8}, TRX PDSCH A {dl_trx}")
    # the card's bytes are the CPU's: the slot's wire bytes at every width,
    # the DL frames, and the UL grids the DU-side sectors rebuild
    g3 = grid.reshape(14, car.nof_prb, 12)
    for w in (9, 12, 14, 16):
        _check(torch.equal(bfp.compress_slot(g3, w).cpu(),
                           bfp.compress_slot(g3.cpu(), w)),
               f"{label}: the card's BFP bytes at w={w} != the CPU's")
    frames_cpu, _, _ = _ofh_dl(torch.device("cpu"), car, grid.cpu())
    ul_cpu, rx_cpu, _ = _ofh_ul(torch.device("cpu"), car, rx.cpu())
    _check(frames_cpu == frames and ul_cpu == ul_frames
           and torch.equal(rx_cpu, rx_72.cpu()),
           f"{label}: the card's frames or rebuilt UL grid != the CPU's")
    times, counts = _app_launches(card, label, sink)
    sock = _socket_slot(dev, gen)
    perf = _fronthaul_times(dev, card, car, grid, rx)
    print(f"[{label}] SCF-built slots translated by fapi.scf; what differs "
          f"from the carrier's own requests: {'; '.join(diffs)}")
    print(f"[{label}] split 7.2: DL {len(frames)} frames, BFP w=9 SNR "
          f"{snr_dl:.1f} dB, UE after OFDM + AWGN {dl_72}; UL 4 eAxCs x "
          f"{len(ul_frames) // 4} frames, SNR {snr_ul:.1f} dB, every DU-side "
          f"sector filtered {du[0].rx_filtered} foreign frames, UpperPhy "
          f"{ul_72}; the card's BFP bytes (w = 9, 12, 14, 16), DL frames and "
          f"rebuilt UL grid equal the CPU's; split 8: RuGeneric over "
          f"InMemoryRadio with AWGN, DL {dl_8}; over InMemoryRadio, the UL "
          f"grid {ul_8}; over TrxDriver with AWGN, PDSCH A {dl_trx}; {sock}; "
          f"launches {launches} on {card}")
    print(f"[{label}] every launch bit-exact against its plain version; "
          f"launches per shape: {counts}; "
          + "; ".join(f"{_fmt(t)} x{t['launches']}" for t in times)
          + f" on {card}")
    print(f"[{label}] {perf}")
    return {"launches": launches, "times": times}


SCALE_OUT_CARRIERS = 8
SCALE_OUT_HALO = 4096
SCALE_OUT_RANKS = 4         # gloo ranks of the dry run, all on this card


def _host_calls(dev, calls: list[dict]) -> list[dict]:
    """Tapped calls a rank returned (on the host), back on the card."""
    return [dict(c, x=c["x"].to(dev), out=[o.to(dev) for o in c["out"]])
            for c in calls]


def _rank_launches(label: str, results: list[dict]) -> dict:
    """The summed launch counts of mixed carrier steps, one per rank
    result, each 4 encoder, 2 decoder (all tapped), 2 pusch_llr and 2
    channel_mix launches."""
    launches = _no_launches()
    for res in results:
        _check(res["launches"] == {"encoder": 4, "decoder": 2, "pusch_llr": 2,
                                   "channel_mix": 2}
               and len(res["calls"]) == 6, f"{label}: mixed carrier "
               f"launches {res['launches']}, {len(res['calls'])} tapped")
        for k in launches:
            launches[k] += res["launches"][k]
    return launches


def phase_scale_out(dev, card: str, car=None, mixed=None) -> dict:
    """The flagship carrier step on NCCL at one rank, the mixed dry run on
    gloo at SCALE_OUT_RANKS ranks sharing this card, and the slot-sharded
    PRACH stream in the same ranks; every LDPC launch tapped and held
    against its plain version.  Returns the dry run's weak-scaling curve
    too (its launches are phase 24's)."""
    car = car or gnb_flagship.default_carrier()
    mixed = mixed or gnb_mixed.default_mixed()
    c = SCALE_OUT_CARRIERS
    gen = torch.Generator(device=dev).manual_seed(23)
    tb = torch.randint(0, 2, (c, car.sh.tbs), generator=gen, device=dev,
                       dtype=torch.int8)
    sigma = float(np.sqrt(car.nfft) * 10 ** (-20.0 / 20))
    nz = torch.randn((2, c, car.slot_samples), generator=gen, device=dev)
    noise = torch.complex(nz[0], nz[1]) * (sigma / math.sqrt(2.0))
    pay1 = gnb_mixed.make_payloads(mixed, np.random.default_rng(23), 1, dev)
    x = torch.randn((1, mixed.slot_samples), generator=gen, device=dev)

    # ---- (a) NCCL, a world of one rank
    with launch.world_of_one("nccl", dev) as d:
        a = entry.carrier_step_check(0, d, car, tb, noise)
        a1 = entry.mixed_step_check(0, d, mixed, pay1, torch.arange(1))
        halo = entry.mesh_report(0, d, x.cpu().numpy(), SCALE_OUT_HALO)
    _check(bool(a["ok"].all()) and bool(
        ((a["sinr"] - 20.0).abs() < 1.5).all()),
        f"scale-out nccl x1: ok {a['ok'].tolist()}, sinr "
        f"{a['sinr'].tolist()}")
    _check(not bool(a["bit_errors"].any()),
           f"scale-out nccl x1: decoded TB bit errors "
           f"{a['bit_errors'].tolist()}")
    _check(torch.equal(a["ok"], a["ok_ref"]) and torch.equal(
        a["bit_errors"], a["bit_errors_ref"]) and float(
        (a["sinr"] - a["sinr_ref"]).abs().max()) <= 1e-3,
        f"scale-out nccl x1: sharded {a['sinr'].tolist()} != unsharded "
        f"{a['sinr_ref'].tolist()}")
    _check(torch.equal(halo["halo"], torch.cat(
        [x[:, -SCALE_OUT_HALO:], x], dim=-1)),
        "scale-out: the halo of one shard is not its own tail")
    _check(bool(a1["ok"].all()) and a1["verdict"][0],
           f"scale-out nccl x1: mixed carrier {a1['ok'].tolist()}")

    # ---- (b) + (c) gloo, spawned ranks on this card
    torch.cuda.empty_cache()
    geom = entry.format0_prach(mixed.mu, mixed.nfft)
    _check(geom[:5] == (61440, 98304, 839, 12672, -55296),
           f"format-0 geometry at 122.88 MHz: {geom}")
    n = SCALE_OUT_RANKS
    t0 = time.perf_counter()
    ranks, curve = entry.dryrun_multichip(n, backend="gloo", device=str(dev),
                                          cfg=mixed)
    secs = time.perf_counter() - t0
    curve_s = sum(p["spawn_s"] for p in curve)
    b = [r[0] for r in ranks]
    mixed_launches = _rank_launches("scale-out", [a1, *b])
    launches = {k: a["launches"][k] + mixed_launches[k]
                for k in mixed_launches}
    # the sharded step's first call warms up eagerly and captures: one
    # launch of each kernel from each
    _check(a["launches"] == {"encoder": 2, "decoder": 2, "pusch_llr": 2,
                             "channel_mix": 0},
           f"scale-out nccl x1: flagship launches {a['launches']}")
    times_a, counts_a = _app_launches(card, "scale-out nccl x1",
                                      types.SimpleNamespace(
                                          eager=a["calls"] + a1["calls"]))
    times_b, counts_b = _app_launches(card, f"scale-out gloo x{n}",
                                      types.SimpleNamespace(eager=[
                                          call for r in b for call in
                                          _host_calls(dev, r["calls"])]))
    print(f"[scale-out] (a) NCCL, 1 rank: flagship {c} carriers at "
          f"{car.nof_prb} PRB all ok, SINR {float(a['sinr'].min()):.2f}-"
          f"{float(a['sinr'].max()):.2f} dB, = multi_carrier_step (max "
          f"|dSINR| {float((a['sinr'] - a['sinr_ref']).abs().max()):.1e} "
          f"dB), {a['step_ms']:.2f} ms per step "
          f"({a['step_ms'] / c:.2f} ms per carrier); mixed carrier "
          f"{a1['step_ms']:.2f} ms per step; the halo of one shard is its "
          f"own tail; launches {counts_a} on {card}")
    print(f"[scale-out] (b) gloo, {n} ranks on one card ({dev}; NCCL cannot "
          f"put two ranks on one GPU): mixed {mixed.nof_prb} PRB, 1 carrier "
          f"per rank, ok {b[0]['ok'].tolist()}, SINR "
          f"{[round(v, 2) for v in b[0]['sinr'].tolist()]} dB, "
          f"global verdict {b[0]['verdict']} on every rank; ms per carrier "
          f"step per rank {[round(r['step_ms'], 2) for r in b]} ({n} ranks "
          f"share one card, not a scaling figure; 1 rank: "
          f"{a1['step_ms']:.2f}); spawn + run {secs - curve_s:.1f} s, then "
          f"the curve {curve_s:.1f} s; launches {counts_b} on {card}")
    print(f"[scale-out] every launch bit-exact against its plain version; "
          + "; ".join(f"{_fmt(t)} x{t['launches']}"
                      for t in times_a + times_b) + f" on {card}")
    return {"launches": launches, "times": times_a + times_b,
            "curve": curve}


def phase_weak_scaling(dev, card: str, curve: list[dict], cfg=None) -> dict:
    """The weak-scaling curve of phase 23's dry run
    (``entry.weak_scaling(SCALE_OUT_RANKS, "gloo", dev)``): 1, 2 and 4 gloo
    ranks sharing this card, one mixed carrier per rank; every rank's LDPC
    launches held against their plain versions again here, each shape
    timed."""
    cfg = cfg or gnb_mixed.default_mixed()
    secs = sum(p["spawn_s"] for p in curve)
    _check([p["ranks"] for p in curve] == [1, 2, SCALE_OUT_RANKS],
           f"weak-scaling points {[p['ranks'] for p in curve]}")
    results = [m for p in curve for m in p["results"]]
    launches = _rank_launches("weak-scaling", results)
    times, counts = _app_launches(card, "weak-scaling", types.SimpleNamespace(
        eager=[c for r in results for c in _host_calls(dev, r["calls"])]))
    points = []
    for p in curve:
        ms = [round(m["step_ms"], 2) for m in p["results"]]
        spread = [(round(min(m["step_times"]), 2),
                   round(max(m["step_times"]), 2)) for m in p["results"]]
        mib = [round(m["peak_reserved"] / 2**20) for m in p["results"]]
        points.append(f"{p['ranks']} ranks {p['s_per_step'] * 1e3:.2f} ms "
                      f"per step (efficiency {p['efficiency']:.3f}; median "
                      f"ms per rank {ms}, min-max {spread}; spawn + run "
                      f"{p['spawn_s']:.1f} s; peak reserved MiB per rank "
                      f"{mib})")
    print(f"[weak-scaling] {cfg.nof_prb} PRB mixed carrier per rank, gloo "
          f"ranks sharing {dev} (contention, not a scaling figure), "
          f"{entry.CURVE_STEPS} steps per rank: "
          + ", ".join(points)
          + f"; phase {secs:.1f} s; launches {counts} on {card}")
    print("[weak-scaling] every launch bit-exact against its plain version; "
          + "; ".join(f"{_fmt(t)} x{t['launches']}" for t in times)
          + f" on {card}")
    return {"launches": launches, "times": times}


def _example(label: str, main, argv: list[str]) -> dict:
    """One example's ``main(argv)`` with its output kept and every LDPC
    launch tapped; the counts set to 0 just before and read just after."""
    out = io.StringIO()
    with kernel_taps.tapped_kernels() as sink, \
            contextlib.redirect_stdout(out):
        kernel_taps.reset_launch_counts()
        t0 = time.perf_counter()
        res = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_taps.launch_counts()
    _check(kernel_taps.tapped_launches(launches) == len(sink.eager),
           f"{label}: launches {launches}, {len(sink.eager)} tapped calls")
    return {"res": res, "lines": out.getvalue().splitlines(), "wall": wall,
            "sink": sink, "launches": launches}


EXAMPLE_FULL_WIDTH = ["--prb", "273", "--qm", "6", "--rate", "0.65",
                      "--snr-db", "20"]


def phase_examples(dev, card: str, mixed_prb: int = 273,
                   loopback_full=EXAMPLE_FULL_WIDTH) -> dict:
    """The four examples through their ``main`` on the card (no --device:
    the card is their default): the mixed slot demo at `mixed_prb`, the
    PHY loopback at its defaults and at full width, the SSB radio and the
    RRC attach; every verdict checked, every LDPC launch held against its
    plain version and each shape timed."""
    runs, launches, times = {}, _no_launches(), []
    mixed_argv = ["--prb", str(mixed_prb)]
    for label, main, argv in (
            ("mixed_slot_demo", mixed_slot_demo.main, mixed_argv),
            ("phy_loopback", phy_loopback.main, []),
            ("phy_loopback full", phy_loopback.main, loopback_full),
            ("radio_ssb", radio_ssb.main, []),
            ("rrc_attach_demo", rrc_attach_demo.main, [])):
        r = runs[label] = _example(label, main, argv)
        if r["sink"].eager:
            t, r["counts"] = _app_launches(card, label, r["sink"])
            times += t
        for k in launches:
            launches[k] += r["launches"][k]
    m = runs["mixed_slot_demo"]
    _check(m["res"]["device"] == str(dev) and bool(m["res"]["out"]["ok"])
           and m["launches"] == {"encoder": 4, "decoder": 2, "pusch_llr": 2,
                                 "channel_mix": 2},
           f"mixed_slot_demo: ok {m['res']['out']['ok']} on "
           f"{m['res']['device']}, launches {m['launches']}")
    warm = _example("mixed_slot_demo warm", mixed_slot_demo.main, mixed_argv)
    _check(bool(warm["res"]["out"]["ok"])
           and warm["launches"] == {"encoder": 4, "decoder": 2,
                                    "pusch_llr": 2, "channel_mix": 2},
           f"mixed_slot_demo warm: ok {warm['res']['out']['ok']}, launches "
           f"{warm['launches']}")
    t, warm["counts"] = _app_launches(card, "mixed_slot_demo warm",
                                      warm["sink"])
    times += t
    for k in launches:
        launches[k] += warm["launches"][k]
    for label in ("phy_loopback", "phy_loopback full"):
        r = runs[label]["res"]
        snr = 15.0 if label == "phy_loopback" else 20.0
        sinr = [s for _, s, _ in r["slots"]]
        _check(r["device"] == str(dev) and all(ok for ok, _, _ in r["slots"])
               and abs(float(np.mean(sinr)) - snr) < 1.5
               and runs[label]["launches"] == {"encoder": 8, "decoder": 8,
                                               "pusch_llr": 8,
                                               "channel_mix": 0},
               f"{label}: slots {r['slots']} on {r['device']}, launches "
               f"{runs[label]['launches']}")
    ssb_run = runs["radio_ssb"]["res"]
    _check(ssb_run["device"] == str(dev) and ssb_run["tx_slots"] == [0, 20]
           and [s for s, _, ok in ssb_run["found"] if ok] == [0, 20],
           f"radio_ssb: sent {ssb_run['tx_slots']}, found "
           f"{ssb_run['found']} on {ssb_run['device']}")
    rrc_run = runs["rrc_attach_demo"]["res"]
    _check(rrc_run["gnb_state"] == "active"
           and len(rrc_run["messages"]) == 8,
           f"rrc_attach_demo: {rrc_run['gnb_state']}, "
           f"{len(rrc_run['messages'])} messages")
    _check(runs["radio_ssb"]["launches"] == _no_launches()
           and runs["rrc_attach_demo"]["launches"] == _no_launches(),
           "an example without a shared channel launched a kernel")
    loops = [f"{label}: {runs[label]['lines'][0]}, "
             f"{len(runs[label]['res']['slots'])} slots CRC ok, SINR "
             f"{min(s for _, s, _ in runs[label]['res']['slots']):.2f}-"
             f"{max(s for _, s, _ in runs[label]['res']['slots']):.2f} dB, "
             f"host ms per slot median "
             f"{float(np.median(runs[label]['res']['ms'][1:])):.2f} (first "
             f"{runs[label]['res']['ms'][0]:.1f}), launches "
             f"{runs[label]['counts']}"
             for label in ("phy_loopback", "phy_loopback full")]
    print(f"[examples] mixed_slot_demo: {m['lines'][0]}; every channel ok, "
          f"UL SINR {float(m['res']['out']['sinr_ul_db']):.2f} dB, first "
          f"run {m['res']['run_s'] * 1e3:.1f} ms, warm "
          f"{warm['res']['run_s'] * 1e3:.1f} ms; launches {m['counts']}, "
          f"warm {warm['counts']} on {card}")
    print("[examples] " + "; ".join(loops) + f" on {card}")
    print(f"[examples] radio_ssb: SSBs sent at {ssb_run['tx_slots']}, "
          f"detected with PSS corr "
          f"{[round(c, 3) for _, c, _ in ssb_run['found']]} and PBCH ok, "
          f"{runs['radio_ssb']['wall']:.2f} s for 40 slots; "
          f"rrc_attach_demo: gNB {rrc_run['gnb_state']}, "
          f"{len(rrc_run['messages'])} messages, "
          f"{runs['rrc_attach_demo']['wall'] * 1e3:.1f} ms on {card}")
    print("[examples] every launch bit-exact against its plain version; "
          + "; ".join(f"{_fmt(t)} x{t['launches']}" for t in times)
          + f" on {card}")
    return {"launches": launches, "times": times}


def _kernel_entry(name: str, kind: str, paths: list[dict],
                  max_err: float, timed: list[dict] | None = None) -> dict:
    """One kernels-JSON entry: launches of every driven path (each counted
    from 0 over its own run); times and bounds of one launch at each shape
    of the timed phases (by default the same paths), added up.  No single
    PyTorch call computes an LDPC encode, a layered min-sum decode or the
    PUSCH LLR stage, so library_ms is null; the channel mix's plain version
    is PyTorch's own einsum and adds, timed as plain_ms."""
    recs = [r for p in timed or paths for r in p["times"]
            if r["kind"] == kind]
    ms = sum(r["ms"] for r in recs)
    bound = sum(r["bound_ms"] for r in recs)
    by = [r["bound_by"] for r in recs]
    return {"name": name, "route": "cuda",
            "source": f"srsran_project_23_5_tpu_torch/csrc/{name}.cu",
            "replaces": {"encoder": "srsran_project_23_5_tpu/ops/ldpc/"
                                    "encoder_pallas.py:84",
                         "decoder": "srsran_project_23_5_tpu/ops/ldpc/"
                                    "decoder_pallas.py:195",
                         "pusch_llr": None, "channel_mix": None}[kind],
            "launches": sum(p["launches"][kind] for p in paths),
            "max_abs_err": max_err, "ms": ms,
            "plain_ms": sum(r["plain_ms"] for r in recs),
            "bound_ms": bound, "bound_by": max(set(by), key=by.count),
            "library_ms": None, "share": bound / ms,
            "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "share",
                                          "sweeps", "ctas_per_sm", "waves")
                        if k in r} for r in recs]}


def main() -> None:
    dev, card = phase_device()
    phase_build(card)
    enc_err = phase_encoder(dev, card)
    dec_err = phase_decoder(dev, card)
    llr = phase_pusch_llr(dev, card)
    mix = phase_channel_mix(dev, card)
    s = phase_slice(dev, card)
    phase_profile(card, "profile", s["pipe"], s["tb"], SLICE_BATCH)
    m = phase_mixed(dev, card)
    phase_mixed_cpu(dev, card)
    phase_profile(card, "mixed-profile", m["pipe"], m["payloads"],
                  SLICE_BATCH)
    phase_dci_profile(card, m["cfg"], m["pipe"], m["payloads"])
    u = phase_upper_phy(dev, card)
    phase_upper_profile(card, u)
    v = phase_mixed_variants(dev, card)
    h = phase_harq(dev, card)
    phase_receivers(dev, card, u)
    lo = phase_lower(dev, card, u)
    scans = phase_scan(dev, card)
    fs = phase_flagship_scan(dev, card)
    acc = phase_accumulate(dev, card)
    phase_ops(dev, card)
    app = phase_app(dev, card)
    app_ta = phase_app_ta(dev, card)
    fh = phase_fronthaul(dev, card)
    so = phase_scale_out(dev, card)
    ws = phase_weak_scaling(dev, card, so["curve"])
    ex = phase_examples(dev, card)
    paths = [s, m, u, v, h, lo, *scans, fs, acc, app, app_ta, fh, so, ws, ex]
    print(json.dumps({"kernels": [
        _kernel_entry("ldpc_encoder", "encoder", paths, enc_err),
        _kernel_entry("ldpc_decoder", "decoder", paths,
                      max(dec_err, u["max_err"])),
        {**_kernel_entry("pusch_llr", "pusch_llr", paths, llr["max_err"],
                         timed=[llr]),
         "evm_max_rel_gap": llr["evm_gap"]},
        _kernel_entry("channel_mix", "channel_mix", paths, mix["max_err"],
                      timed=[mix])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
