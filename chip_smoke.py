#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (srsran_project_23_5_tpu_torch) on one
NVIDIA GPU.

Phases, one line each:

1. device  — refuses to run without CUDA; prints the card's name and power
   limit as nvidia-smi gives them;
2. build   — builds both LDPC kernels from ``csrc/`` (nvcc, sm_90a);
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
5. slice   — ``SlotPipeline`` on the 273-PRB flagship carrier, 8 slots per
   batch, depth 2, 20 dB: warmup + submits + drain; every TB CRC ok, mean
   SINR within 1.5 dB of 20, both kernels launched in that run; decoded bits
   equal the sent bits; a small slot on the card agrees with the same slot
   through the plain versions on the CPU; kernel and plain times at the
   flagship shapes;
6. profile — torch.profiler over two flagship batches: device busy share,
   the top kernels, each LDPC kernel's device time per launch;
7. mixed   — the 273-PRB mixed slot (2×PDSCH with 2-layer MIMO, PDCCH, SSB,
   CSI-RS, 2×PUSCH, PUCCH F1, PRACH) through ``SlotPipeline`` with
   ``gnb_mixed.batch_fn_for_pipeline``, 8 slots per batch, depth 2, 20 dB:
   warmup + submits + drain; every slot ok, mean UL SINR within 1.0 dB of
   20, 4 encoder and 2 decoder launches per batch; how many slots passed
   each check; the wall time of each stage of a batch; kernel and plain
   times at the mixed shapes, and the decoder's phase split on the mixed
   slot's own LLRs;
8. mixed-cpu — a ``tiny_mixed`` batch of 2 on the card against the same
   payloads and noise through the plain versions on the CPU: every verdict
   and the decoded bits equal, SINRs within 0.1 dB;
9. mixed-profile — torch.profiler over two mixed batches, and over the
   once-per-batch DCI re-check alone (its device op count);
10. upper-phy — ``UpperPhy`` (FAPI DL_TTI/UL_TTI → grids → indications) on
   the 273-PRB carrier of ``models/fapi_carrier.py``, 4 rx ports, 20 dB:
   8 DL slots (SSB, 2×PDCCH, 2×PDSCH, CSI-RS; one slot a VRB-interleaved
   PDSCH over the BWP), each grid equal to the CPU's on two slots and each
   PDSCH passing ``symbol_verify`` after OFDM and AWGN; 8 UL slots rotating
   two mixes (4-layer PUSCH, PUSCH with UCI and time interpolation, PUCCH
   F1 and F2, a multi-root PRACH; or PUSCH B and F1): every CRC, payload,
   UCI bit, preamble and TA recovered, PUSCH B's SINR within 1 dB of 20,
   one decoder launch per decode group, the first slot equal to the CPU's,
   and the kernel equal to ``decode_plain`` on the LLRs each decode group
   of that slot handed it (BG1 Z=384 x34 n_used 35, x8 n_used 33);
   a HARQ pair at 14 dB (rv=0 fails, rv=2 combined on the full BG1 graph at
   Z=384 passes and releases the softbuffer); three programs for the two
   mixes and the retransmission; ms per DL and UL slot, and the
   full-graph decoder against ``decode_plain`` and the truncated graph
   (both checked against ``decode_plain`` first), and its phase split;
11. upper-profile — torch.profiler over two DL slots and two full-mix UL
   slots of the upper PHY;
12. mixed-variants — the 273-PRB mixed slot's options through
   ``SlotPipeline``, 8 slots per batch: the TDL channel (``tdl_channel``
   at 30 dB; its verdicts at 20 dB are printed, not gated),
   the UE-side PDSCH decode (``ue_decode_dl``: 4 decoder launches per
   batch; its two PDSCH decode shapes, BG1 Z=384 x128 and x56 n_used 34,
   held bit-exact against ``decode_plain`` first and timed) and the grid
   PRACH; every slot ok under the JAX slot's gates, µs/slot each;
13. harq — ``harq_retx_batch`` at 273 PRB, 8 slots: a sweep of snr1 over
   11-14 dB, the first point where every first and retx verdict fails and
   every combination passes for both UEs, driven once with the counts
   reset (8 encoder and 6 decoder launches); the full-graph decodes of the
   combined LLRs (BG1 Z=384 x136, Z=352 x64) bit-exact against
   ``decode_plain``, timed, with CTAs per SM, waves and the phase split;
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
   (K = 8 batches per dispatch, one captured CUDA graph) at B = 8 and
   B = 64: first, on a pipeline whose kernel calls are tapped (a copy of
   each call's tensors, captured with the graph), every launch of one
   replay takes and gives, bit for bit, what the same launch of the eager
   K-batch loop on the same seed takes and gives, and every eager launch
   equals its plain version; at B = 64 the kernels' shapes there (BG1
   Z=384 x1088 and x1024 and x448, Z=352 x512) are timed with their
   bounds.  Then, on an untapped pipeline: capture time and peak device
   memory; one replay against the eager K-batch loop on the same seed
   (all_ok equal, sinr_sum within 1e-6 relative, bit-equality reported); a
   replay with the static noise ×100 must fail; µs/slot over a window of
   several dispatches and one ``fetch_accumulated``, every slot ok, the
   launches per replay (4K encoder, 2K decoder, counted by the capture
   and checked against the LDPC kernels the profiler sees the device run
   in one replay); ``dispatch_latency``; one dispatch under torch.profiler
   (busy share, device span);
17. flagship-scan — the same for the flagship loopback at B = 8, K = 8
   (K encoder and K decoder launches per replay), untimed;
18. accumulate — ``submit_accumulated`` over 3 eager mixed batches against
   the reduction of ``drain()`` of a pipeline with the same seed;
19. ops — the ops the port gained with the scan mode (bit packing, host
   CRC and encoder references, the table and π/2-BPSK mappers, LLR
   quantisation and hard decisions, the per-codeblock rate matcher,
   layer demapping and the one-layer codebook, MMSE 1×N and 2×2 ZF, the
   OFDM rx window offset, ``pdsch_transmit(w=)``) once each on the card at
   273 PRB against the same call on the CPU.

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
import json
import re
import subprocess
import time
import types

import numpy as np
import torch

from srsran_project_23_5_tpu_torch.fapi import messages as fapi
from srsran_project_23_5_tpu_torch.models import (fapi_carrier, gnb_flagship,
                                                  gnb_mixed)
from srsran_project_23_5_tpu_torch.ops import prach as prach_ops
from srsran_project_23_5_tpu_torch.ops.ldpc import (decoder_cuda,
                                                    encoder_cuda, graphs,
                                                    segmentation)
from srsran_project_23_5_tpu_torch.phy import pipeline
from srsran_project_23_5_tpu_torch.phy.lower import (lower_phy, ofdm,
                                                     prach_demod)
from srsran_project_23_5_tpu_torch.phy.upper import (pdcch, sch,
                                                     slot_programs, ssb,
                                                     upper_phy)
from srsran_project_23_5_tpu_torch.utils import kernels

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


# published H100 SXM peaks at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
DEC_OPS_PER_EDGE_LANE = 12      # float32 ops per edge-lane per sweep


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and operations over the float32 rate, and which it is."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def encoder_bound(bg: int, zc: int, batch: int) -> tuple[float, str]:
    """Message bytes in, codeword bytes out; one XOR per edge-lane."""
    g = graphs.lifted_graph(bg, zc)
    edges = sum(len(c) for c in g.row_cols)
    return _bound(batch * (g.nof_msg_blocks + g.nof_var_blocks) * zc,
                  batch * edges * zc)


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
                    DEC_OPS_PER_EDGE_LANE * n_edges * zc * int(sweeps.sum()))
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
    # ptxas -v: registers of each kernel (decoder instances by row degree)
    regs = []
    for name, n in re.findall(r"Compiling entry function '(\w+)'.*?Used "
                              r"(\d+) registers", lib.build_log, flags=re.S):
        degree = re.search(r"ILi(\d+)E", name)
        label = "encoder" if "encode" in name else "decoder"
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

    encoder_cuda.encode.launches = 0
    decoder_cuda.decode.launches = 0
    warm_s, ok0, sinr0 = pipe.warmup(tb)
    t0 = time.perf_counter()
    for _ in range(SLICE_SUBMITS):
        pipe.submit(tb)
    results = pipe.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"encoder": encoder_cuda.encode.launches,
                "decoder": decoder_cuda.decode.launches}

    oks = np.concatenate([ok0] + [ok for ok, _ in results])
    sinrs = np.concatenate([sinr0] + [s for _, s in results])
    _check(len(results) == SLICE_SUBMITS, "pipeline lost batches")
    _check(bool(oks.all()), f"TB CRC failed in {int((~oks).sum())} slots")
    _check(bool(np.isfinite(sinrs).all())
           and abs(float(sinrs.mean()) - 20.0) < 1.5,
           f"mean SINR {float(sinrs.mean())} dB not within 1.5 dB of 20")
    _check(launches["encoder"] > 0 and launches["decoder"] > 0,
           f"main path did not launch both kernels: {launches}")
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


def _profiled(run, reps: int, unit: str, after=None) -> str:
    """torch.profiler over ``reps`` calls of ``run`` (then ``after()``):
    device busy share, the kernels that take the device time, and each LDPC
    kernel's device time per launch.  The profiler's own host cost
    lengthens the window, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
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
    # device-side entries only: a CPU op's self device time repeats its kernels
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
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

    encoder_cuda.encode.launches = 0
    decoder_cuda.decode.launches = 0
    warm_s, ok0, sinr0 = pipe.warmup(payloads)
    t0 = time.perf_counter()
    for _ in range(MIXED_SUBMITS):
        pipe.submit(payloads)
    results = pipe.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"encoder": encoder_cuda.encode.launches,
                "decoder": decoder_cuda.decode.launches}

    batches = MIXED_SUBMITS + 1
    oks = np.concatenate([ok0] + [ok for ok, _ in results])
    sinrs = np.concatenate([sinr0] + [s for _, s in results])
    _check(len(results) == MIXED_SUBMITS, "pipeline lost batches")
    _check(bool(oks.all()), f"mixed slot failed in {int((~oks).sum())} slots")
    _check(bool(np.isfinite(sinrs).all())
           and abs(float(sinrs.mean()) - 20.0) < 1.0,
           f"mean UL SINR {float(sinrs.mean())} dB not within 1.0 dB of 20")
    _check(launches == {"encoder": 4 * batches, "decoder": 2 * batches},
           f"expected 4 encoder and 2 decoder launches per batch over "
           f"{batches} batches, got {launches}")
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
    from torch.autograd import DeviceType
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
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
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


def phase_upper_phy(dev, card: str) -> dict:
    """UpperPhy on the 273-PRB FAPI carrier: DL and UL slots, a HARQ pair
    through the full BG1 graph, the program cache."""
    car = fapi_carrier.default_carrier()
    phy = upper_phy.UpperPhy(car.upper_phy, dev)
    phy_cpu = upper_phy.UpperPhy(car.upper_phy, "cpu")
    gen = torch.Generator(device=dev).manual_seed(8)
    rng = np.random.default_rng(8)
    gate = gnb_mixed.symbol_gate(car.pdsch_a.qm, car.snr_db)
    ul_reqs, dl_ms, ul_ms, matches, sinr_b = [], [], [], [], []
    decode_grouped, group_inputs = slot_programs._decode_grouped, []

    encoder_cuda.encode.launches = 0
    decoder_cuda.decode.launches = 0
    for slot in range(UPPER_SLOTS):
        # ---- downlink
        req, data = fapi_carrier.dl_request(car, slot, rng, vrb=slot == 5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = phy.process_dl_slot(req, data)
        torch.cuda.synchronize()
        dl_ms.append((time.perf_counter() - t0) * 1e3)
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
        groups = slot_programs.decode_groups(
            slot_programs.signature(ul)[0])
        if slot == 0:
            # keep what each decode group hands the decoder, to hold the
            # kernel against decode_plain on those very inputs afterwards
            def keep(llrs, groups, iters):
                for (bg, zc, _, n_used), idxs in groups.items():
                    group_inputs.append((
                        torch.cat([llrs[i] for i in idxs]), bg, zc,
                        {"nof_iterations": iters, "nof_used_blocks": n_used}))
                return decode_grouped(llrs, groups, iters)
            slot_programs._decode_grouped = keep
        d0 = decoder_cuda.decode.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            inds = phy.process_ul_slot(rx, ul, slot_count=slot,
                                       prach_rx=prach_rx)
        finally:
            slot_programs._decode_grouped = decode_grouped
        ul_ms.append((time.perf_counter() - t0) * 1e3)
        ul_reqs.append(ul)
        _check(decoder_cuda.decode.launches - d0 == len(groups),
               f"UL slot {slot}: {decoder_cuda.decode.launches - d0} decoder "
               f"launches for {len(groups)} decode groups")
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
    launches = {"encoder": encoder_cuda.encode.launches,
                "decoder": decoder_cuda.decode.launches}
    _check(launches["encoder"] > 0 and launches["decoder"] > 0,
           f"upper PHY run did not launch both kernels: {launches}")

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

    # ---- HARQ pair: rv=0 fails, rv=2 combines on the full graph and passes
    first = fapi_carrier.ul_request(car, UPPER_SLOTS, full=False,
                                    harq_process=15)
    pay = fapi_carrier.ul_payloads(first, rng)
    rx1, _ = fapi_carrier.uplink(first, pay, car, gen,
                                 snr_db=car.harq_snr_db)
    inds1 = phy.process_ul_slot(rx1, first, slot_count=UPPER_SLOTS)
    crc1 = [i for i in inds1 if isinstance(i, fapi.CrcIndication)][0]
    _check(not crc1.tb_crc_ok and len(phy.softbuffers) == 1,
           f"HARQ rv=0 at {car.harq_snr_db} dB: crc {crc1.tb_crc_ok}, "
           f"{len(phy.softbuffers)} softbuffers")
    rnti = first.pusch_pdus[0].config.rnti
    prior = phy.softbuffers.get(rnti, 15).clone()
    retx = fapi_carrier.ul_request(car, UPPER_SLOTS + 1, full=False,
                                   harq_process=15, rv=2, new_data=False)
    rx2, _ = fapi_carrier.uplink(retx, pay, car, gen, snr_db=car.harq_snr_db)
    cfg2 = retx.pusch_pdus[0].config
    seg = cfg2.segments
    _check(sch.used_blocks(cfg2) is None
           and decoder_cuda.state_bytes(seg.base_graph, seg.lifting_size)
           <= 232_448,
           "the retransmission does not take the full graph in shared memory")
    d0 = decoder_cuda.decode.launches
    inds2 = phy.process_ul_slot(rx2, retx, slot_count=UPPER_SLOTS + 1)
    checks = fapi_carrier.ul_checks(car, retx, pay, inds2, None)
    _check(checks["crc"] and checks["payload"] and len(phy.softbuffers) == 0
           and decoder_cuda.decode.launches - d0 == 1,
           f"HARQ rv=2 combined decode: {checks}, "
           f"{len(phy.softbuffers)} softbuffers")
    ul_reqs += [first, retx]
    # the slot number is normalised out of the signature: the two mixes of
    # the eight slots and the retransmission (rv=2) make three
    sigs = {slot_programs.signature(r) for r in ul_reqs}
    _check(phy.ul_programs.nof_compiled == len(sigs) == 3,
           f"{phy.ul_programs.nof_compiled} UL programs for {len(sigs)} "
           f"signatures, not 3")

    # ---- the full-graph decoder on the combined buffer: kernel vs plain,
    # and the same LLRs through the rv=0 truncated graph
    combined = (prior + sch.pusch_demodulate(rx2[None], cfg2).llr_full[0]
                ).contiguous()
    bg, zc = seg.base_graph, seg.lifting_size
    n_used = sch.used_blocks(dataclasses.replace(cfg2, rv=0))
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
    want = decoder_cuda.decode_plain(combined, bg, zc, nof_used_blocks=n_used)
    _check(all(torch.equal(a, b) for a, b in zip(trunc(), want)),
           f"truncated-graph decoder (n_used {n_used}) != plain on the "
           f"combined buffer")
    trunc_ms = _time_ms(trunc, 50, queued=True)
    print(f"[upper-phy] {car.nof_prb}-PRB FAPI carrier, 4 rx, "
          f"{car.snr_db:.0f} dB: {UPPER_SLOTS} DL slots {np.median(dl_ms):.2f}"
          f" ms median ({min(dl_ms):.2f}-{max(dl_ms):.2f}), PDSCH symbol "
          f"match min {min(matches):.4f}; {UPPER_SLOTS} UL slots "
          f"{np.median(ul_ms):.2f} ms median ({min(ul_ms):.2f}-"
          f"{max(ul_ms):.2f}), every CRC/payload/UCI/PUCCH/PRACH check ok, "
          f"PUSCH B SINR {np.mean(sinr_b):.2f} dB, launches {launches}; "
          f"HARQ rv=0 fail -> rv=2 combined pass at {car.harq_snr_db:.0f} dB;"
          f" {phy.ul_programs.nof_compiled} UL programs for {len(sigs)} "
          f"signatures; {_fmt(times[-1])}; the same LLRs on the truncated "
          f"graph n_used {n_used}: {trunc_ms * 1e3:.1f} us on {card}")
    print(f"[upper-phy] the decode groups of UL slot 0 (kernel == plain on "
          f"the program's LLRs) and a DL slot's encoder shape: "
          f"{'; '.join(map(_fmt, times[:-1]))}; truncated "
          f"n_used {n_used} == plain on the combined buffer; full-graph phase "
          f"split per CTA: {full_split} on {card}")
    return {"launches": launches, "max_err": err, "times": times,
            "phy": phy, "car": car, "gen": gen, "rng": rng}


def phase_upper_profile(card: str, u: dict) -> None:
    """torch.profiler over two DL slots and, apart, two full-mix UL slots of
    the upper PHY."""
    phy, car, gen, rng = u["phy"], u["car"], u["gen"], u["rng"]
    req, data = fapi_carrier.dl_request(car, 0, rng)
    ul = fapi_carrier.ul_request(car, 0)
    pay = fapi_carrier.ul_payloads(ul, rng)
    rx, prach_rx = fapi_carrier.uplink(ul, pay, car, gen)
    dl = _profiled(lambda: phy.process_dl_slot(req, data), 2, "DL slot")
    ul_s = _profiled(lambda: phy.process_ul_slot(rx, ul, prach_rx=prach_rx),
                     2, "UL slot")
    print(f"[upper-profile] 2 DL slots: {dl}; 2 full-mix UL slots: {ul_s} "
          f"on {card}")


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
    encoder_cuda.encode.launches = 0
    decoder_cuda.decode.launches = 0
    warm_s, ok0, sinr0 = pipe.warmup(payloads)
    t0 = time.perf_counter()
    for _ in range(submits):
        pipe.submit(payloads)
    results = pipe.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"encoder": encoder_cuda.encode.launches,
                "decoder": decoder_cuda.decode.launches}
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
    launches = {"encoder": 0, "decoder": 0}
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
                                 "decoder": n_dec * r["batches"]},
               f"{name}: launches {r['launches']} over {r['batches']} "
               f"batches, expected 4 encoder and {n_dec} decoder per batch")
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


HARQ_SNRS = (11.0, 12.0, 12.5, 13.0, 13.5, 14.0)


def phase_harq(dev, card: str) -> dict:
    """harq_retx_batch at 273 PRB: the snr1 sweep, the driven run at the
    chosen point, and the full-graph decodes of its combined LLRs."""
    cfg = gnb_mixed.default_mixed()
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(30),
                                  SLICE_BATCH, dev)
    gen = torch.Generator(device=dev).manual_seed(30)

    def noise(snr1: float):
        c1 = dataclasses.replace(cfg, snr_db=snr1)
        return (*gnb_mixed.draw_noise(c1, SLICE_BATCH, gen),
                *gnb_mixed.draw_noise(c1, SLICE_BATCH, gen))

    sweep, chosen = [], None
    for snr1 in HARQ_SNRS:
        out = gnb_mixed.harq_retx_batch(pay, noise(snr1), cfg, snr1,
                                        device=dev)
        rates = {ue: {k: float(v.float().mean()) for k, v in o.items()}
                 for ue, o in out.items()}
        sweep.append(f"{snr1:g} dB " + " ".join(
            f"{ue} first {r['first_ok']:.2f} retx {r['retx_ok']:.2f} "
            f"comb {r['combined_ok']:.2f}" for ue, r in rates.items()))
        if chosen is None and all(
                r["first_ok"] == 0 and r["retx_ok"] == 0
                and r["combined_ok"] == 1 for r in rates.values()):
            chosen = snr1
    _check(chosen is not None, f"no snr1 where first and retx fail and the "
           f"combination passes: {sweep}")
    nz = noise(chosen)
    encoder_cuda.encode.launches = 0
    decoder_cuda.decode.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gnb_mixed.harq_retx_batch(pay, nz, cfg, chosen, device=dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {"encoder": encoder_cuda.encode.launches,
                "decoder": decoder_cuda.decode.launches}
    _check(launches == {"encoder": 8, "decoder": 6},
           f"HARQ batch launches {launches}, expected 8 and 6")
    _check(all(not o["first_ok"].any() and not o["retx_ok"].any()
               and bool(o["combined_ok"].all()) for o in out.values()),
           f"HARQ verdicts at {chosen} dB: {out}")
    # the combined buffers: full-graph decodes, kernel vs plain, timed
    cfg1 = dataclasses.replace(cfg, snr_db=chosen)
    cfg2 = dataclasses.replace(
        cfg1, pusch0=dataclasses.replace(cfg.pusch0, rv=2),
        pusch1=dataclasses.replace(cfg.pusch1, rv=2))
    f1 = gnb_mixed._mixed_front(pay, nz[0], nz[1], cfg1)
    f2 = gnb_mixed._mixed_front(pay, nz[2], nz[3], cfg2)
    times, splits = [], []
    for name, sh in (("u0", cfg.pusch0), ("u1", cfg.pusch1)):
        seg = sh.segments
        comb = f1[name].llr_full + f2[name].llr_full
        llr = comb.reshape(-1, comb.shape[-1]).contiguous()
        rec = _timed_decoder(f"HARQ combined {name}", llr, seg.base_graph,
                             seg.lifting_size, None, reps=50)
        times.append(rec)
        splits.append(_phase_split(rec["shape"], llr, seg.base_graph,
                                   seg.lifting_size, None))
    print(f"[harq] 273-PRB mixed slot x{SLICE_BATCH}, snr1 sweep: "
          f"{'; '.join(sweep)}; chosen {chosen:g} dB: first and retx fail, "
          f"the combination passes for both UEs, {wall_ms:.1f} ms per "
          f"batch, launches {launches}; "
          + "; ".join(f"{_fmt(r)}, {r['ctas_per_sm']} CTA/SM, {r['waves']} "
                      f"waves" for r in times) + f" on {card}")
    print(f"[harq] full-graph phase split per CTA: {'; '.join(splits)} on "
          f"{card}")
    return {"launches": launches, "times": times}


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
    encoder_cuda.encode.launches = 0
    decoder_cuda.decode.launches = 0
    reqs = [fapi_carrier.dl_request(car, s, rng) for s in range(nslots)]
    grids = [phy.process_dl_slot(req, data) for req, data in reqs]
    got = {}
    eng = lower_phy.AsyncLowerPhy(
        cfg, lambda s: grids[s] if s < nslots else None,
        lambda s, g: got.__setitem__(s, g), depth=2, device=dev)
    sigma = float(np.sqrt(car.nfft) * 10 ** (-car.snr_db / 20) / np.sqrt(2))
    total = sum(eng.timeline.slot_size(s) for s in range(nslots))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pulled, chunks = 0, 0
    while pulled < total:
        n = min(7777 + 1000 * (chunks % 3), total - pulled)
        bb = eng.pull_tx(n)
        nz = torch.randn((2, n), generator=gen, device=dev) * sigma
        eng.push_rx(bb + torch.complex(nz[0], nz[1]))
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
    launches = {"encoder": encoder_cuda.encode.launches,
                "decoder": decoder_cuda.decode.launches}
    _check(launches == {"encoder": 2 * nslots, "decoder": nslots},
           f"lower-PHY run launches {launches}")
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


SCAN_K = 8                      # bench.py's K
SCAN_SHAPES = ((8, 10), (64, 4))  # (B, dispatches of the sustained window)


def _kernel_counts() -> dict:
    return {"encoder": encoder_cuda.encode.launches,
            "decoder": decoder_cuda.decode.launches}


def _reset_counts() -> None:
    encoder_cuda.encode.launches = 0
    decoder_cuda.decode.launches = 0


def _replay_busy(pipe, batch, seed: int) -> tuple[str, float]:
    """One scan dispatch under torch.profiler: device busy share (kernel
    time over the host wall of the dispatch and its fetch), device ops per
    dispatch, the LDPC kernels the device ran in the replay (which must be
    the launches the capture counted) and the device span of the dispatch
    (CUDA events; the profiler lengthens it).  Returns (text, kernel time
    per slot in µs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        pipe.submit_scan(batch, seed)
        end.record()
        ok, _, n = pipe.fetch_accumulated()
        wall_us = (time.perf_counter() - t0) * 1e6
    _check(ok, "a slot failed in the profiled dispatch")
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_us = sum(e.self_device_time_total for e in kern)
    ran = {kind: sum(e.count for e in kern if tag in e.key)
           for kind, tag in (("encoder", "ldpc_encode_kernel"),
                             ("decoder", "ldpc_decode_kernel"))}
    counted = dict(zip(("encoder", "decoder"), pipe.captured_launches))
    _check(ran == counted, f"the profiler saw {ran} LDPC kernels in one "
           f"replay, the capture counted {counted}")
    span_us = start.elapsed_time(end) * 1e3
    top = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)
    seen = (f"device busy {busy_us:.0f} us ({100 * busy_us / wall_us:.1f}% "
            f"of the {wall_us:.0f} us wall), "
            f"{sum(e.count for e in kern)} device ops per dispatch; top: "
            + "; ".join(f"{e.key[:48]} "
                        f"{100 * e.self_device_time_total / busy_us:.1f}%"
                        for e in top[:6])
            if busy_us else "the profiler saw no kernel of the graph")
    return (f"{seen}; LDPC kernels the device ran in the replay {ran}; "
            f"device span {span_us:.0f} us "
            f"({100 * span_us / wall_us:.1f}% of the wall, "
            f"{span_us / n:.1f} us per slot)", busy_us / n)


class _ModuleTap:
    """Stands in for a kernel wrapper's module inside ``sch`` (the one
    caller of both wrappers on the scan paths): its kernel function keeps a
    copy of each call's tensors, in ``sink.graph`` while a CUDA graph is
    being captured (the copies are captured too, so after each replay they
    hold what that replay's kernel took and gave), else in ``sink.eager``.
    Every other name is the module's own."""

    def __init__(self, module, fn_name: str, sink) -> None:
        self._module = module
        fn = getattr(module, fn_name)

        def call(x, *args, **kw):
            out = fn(x, *args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            capturing = (torch.cuda.is_available()
                         and torch.cuda.is_current_stream_capturing())
            (sink.graph if capturing else sink.eager).append({
                "fn": fn_name, "x": x.clone(), "args": args, "kw": kw,
                "out": [o.clone() for o in outs]})
            return out
        setattr(self, fn_name, call)

    def __getattr__(self, name: str):
        return getattr(self._module, name)


@contextlib.contextmanager
def _tapped_kernels():
    sink = types.SimpleNamespace(graph=[], eager=[])
    saved = sch.encoder_cuda, sch.decoder_cuda
    sch.encoder_cuda = _ModuleTap(encoder_cuda, "encode", sink)
    sch.decoder_cuda = _ModuleTap(decoder_cuda, "decode", sink)
    try:
        yield sink
    finally:
        sch.encoder_cuda, sch.decoder_cuda = saved


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
    with _tapped_kernels() as sink:
        pipe.warmup_scan(batch)
        sink.eager.clear()
        noise = pipe.scan_noise(77)
        ok_r, sum_r = (t.clone() for t in pipe.replay_scan())
        ok_e, sum_e = pipe.scan_step(batch, noise)
        torch.cuda.synchronize()
    graph, eager = sink.graph, sink.eager
    n = sum(pipe.captured_launches)
    _check(len(graph) == len(eager) == n, f"{label}: {len(graph)} kernel "
           f"calls captured, {len(eager)} eager, {n} launches counted")
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


def _scan_run(dev, card: str, label: str, pipe, batch, per_batch: tuple,
              dispatches: int, sinr_tol: float) -> dict:
    """The scan mode of one pipeline on the card: warmup_scan (eager
    warmup, capture), one replay against the eager K-batch loop on the
    same seed, a replay with the static noise ×100, a sustained accumulate
    window (counts reset just before and read just after), the dispatch
    latency and the busy share of one dispatch."""
    k, b = pipe.config.scan_batches, pipe.config.slots_per_batch
    snr = pipe.config.snr_db if pipe.config.carrier else 20.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    warm_s, ok0, mean0 = pipe.warmup_scan(batch)
    # above what was allocated before: the eager warmup's peak, and what
    # the static buffers and the graph's private pool keep reserved
    peak_gib = (torch.cuda.max_memory_allocated() - base[0]) / 2 ** 30
    held_gib = (torch.cuda.memory_reserved() - base[1]) / 2 ** 30
    _check(ok0 and abs(mean0 - snr) < sinr_tol,
           f"{label}: scan warmup ok {ok0}, mean SINR {mean0:.2f} dB")
    per_replay = dict(zip(("encoder", "decoder"), pipe.captured_launches))
    want = {"encoder": per_batch[0] * k, "decoder": per_batch[1] * k}
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
    # sustained: several dispatches, one fetch
    pipe.fetch_accumulated()
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(dispatches):
        pipe.submit_scan(batch, 1000 + i * k)
    all_ok, mean, nslots = pipe.fetch_accumulated()
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    _check(all_ok and nslots == dispatches * k * b
           and abs(mean - snr) < sinr_tol,
           f"{label}: window ok {all_ok}, {nslots} slots, SINR {mean:.2f}")
    _check(launches == {kd: dispatches * v for kd, v in want.items()},
           f"{label}: window launches {launches}, expected {dispatches} x "
           f"{want}")
    lat = sorted(pipe.dispatch_latency(batch, 2000 + i) for i in range(5))
    busy, kernel_us = _replay_busy(pipe, batch, 3000)
    us_per_slot = wall / nslots * 1e6
    print(f"[{label}] B={b} K={k} ({pipe.slots_per_dispatch} slots per "
          f"dispatch): warmup_scan {warm_s:.2f} s, capture "
          f"{pipe.capture_seconds:.2f} s, device memory (max_memory_"
          f"allocated) {peak_gib:.2f} GiB over the baseline at its peak, "
          f"{held_gib:.2f} GiB more reserved after; replay vs eager loop on one seed: all_ok equal, sinr_sum "
          f"{'bit-equal' if bit_equal else f'within {rel:.1e} relative'} "
          f"({float(sum_r)!r}); x100 noise replay all_ok {loud_ok}; "
          f"sustained {dispatches} dispatches, one fetch: "
          f"{us_per_slot:.1f} us/slot, all {nslots} slots ok, mean UL SINR "
          f"{mean:.2f} dB, launches {launches} ({per_replay} per replay); "
          f"dispatch latency (median of 5) {lat[2] * 1e3:.2f} ms; one "
          f"dispatch profiled: {busy}; kernel time per slot over the "
          f"sustained us/slot: {100 * kernel_us / us_per_slot:.1f}% on "
          f"{card}")
    return {"launches": launches, "times": []}


def phase_scan(dev, card: str, cfg=None, shapes=SCAN_SHAPES,
               k: int = SCAN_K) -> list[dict]:
    """The mixed slot's scan mode (``warmup_scan``/``submit_scan``/
    ``fetch_accumulated``, one CUDA graph per dispatch) at bench.py's B and
    K."""
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
        runs.append(_scan_run(dev, card, label, pipe(), payloads, (4, 2),
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
    return _scan_run(dev, card, label, pipe(), tb, (1, 1), 10, 1.5)


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
    _reset_counts()
    t0 = time.perf_counter()
    for _ in range(3):
        acc.submit_accumulated(payloads)
    ok, mean, n = acc.fetch_accumulated()
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    rel = abs(mean - sinrs.mean()) / abs(sinrs.mean())
    _check(ok == bool(oks.all()) and ok and n == 3 * b and rel <= 1e-6,
           f"accumulate ({ok}, {mean!r}, {n}) != drain ({bool(oks.all())}, "
           f"{sinrs.mean()!r}, {oks.size})")
    _check(launches == {"encoder": 12, "decoder": 6},
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


def _kernel_entry(name: str, kind: str, paths: list[dict],
                  max_err: float) -> dict:
    """One kernels-JSON entry: launches of every driven path (each counted
    from 0 over its own run); times and bounds of one launch at each of
    their shapes, added up.  No single PyTorch call computes an LDPC encode
    or a layered min-sum decode, so library_ms is null."""
    recs = [r for p in paths for r in p["times"] if r["kind"] == kind]
    ms = sum(r["ms"] for r in recs)
    bound = sum(r["bound_ms"] for r in recs)
    by = [r["bound_by"] for r in recs]
    return {"name": name, "route": "cuda",
            "source": f"srsran_project_23_5_tpu_torch/csrc/{name}.cu",
            "replaces": {"encoder": "srsran_project_23_5_tpu/ops/ldpc/"
                                    "encoder_pallas.py:84",
                         "decoder": "srsran_project_23_5_tpu/ops/ldpc/"
                                    "decoder_pallas.py:195"}[kind],
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
    paths = [s, m, u, v, h, lo, *scans, fs, acc]
    print(json.dumps({"kernels": [
        _kernel_entry("ldpc_encoder", "encoder", paths, enc_err),
        _kernel_entry("ldpc_decoder", "decoder", paths,
                      max(dec_err, u["max_err"]))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
