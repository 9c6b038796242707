#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (srsran_project_23_5_tpu_torch) on one
NVIDIA GPU.

Phases, one line each:

1. device  — refuses to run without CUDA; prints the card's name and power
   limit as nvidia-smi gives them;
2. build   — builds both LDPC kernels from ``csrc/`` (nvcc, sm_90a);
3. encoder — kernel vs ``encode_plain`` on the card, bit for bit, at the
   flagship shape (BG2 Z=384, 88 codeblocks), BG1 Z=384, the tiny
   carrier's Z=36 and a batch that is not a multiple of 8;
4. decoder — kernel vs ``decode_plain`` on the card, bits and ok
   identical, at the flagship shape converging and with mixed convergence,
   on truncated graphs, at Z=36; an oversized state must be refused;
5. slice   — ``SlotPipeline`` on the 273-PRB flagship carrier, 8 slots per
   batch, depth 2, 20 dB: warmup + submits + drain; every TB CRC ok, mean
   SINR within 1.5 dB of 20, both kernels launched in that run; decoded bits
   equal the sent bits; a small slot on the card agrees with the same slot
   through the plain versions on the CPU; kernel and plain times at the
   flagship shapes;
6. profile — torch.profiler over two pipeline batches: device busy share,
   the top kernels, each LDPC kernel's device time per launch.

Then one JSON line with the kernels and, last, the result line.  Any
failure raises and exits non-zero.

    python3 chip_smoke.py          # from the repository root, one GPU
"""
from __future__ import annotations

import json
import re
import subprocess
import time

import numpy as np
import torch

from srsran_project_23_5_tpu_torch.models import gnb_flagship
from srsran_project_23_5_tpu_torch.ops.ldpc import (decoder_cuda,
                                                    encoder_cuda, graphs,
                                                    segmentation)
from srsran_project_23_5_tpu_torch.phy import pipeline
from srsran_project_23_5_tpu_torch.phy.lower import ofdm
from srsran_project_23_5_tpu_torch.phy.upper import sch
from srsran_project_23_5_tpu_torch.utils import kernels

FLAGSHIP_CBS = 88          # 8 slots x 11 codeblocks
SLICE_BATCH = 8
SLICE_SUBMITS = 8


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (CUDA events), warm."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    cases = [(2, 384, FLAGSHIP_CBS), (1, 384, 24), (2, 36, 16), (2, 384, 13)]
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
        ("BG1-truncated", 1, 384, 24, np.linspace(1.0, 5.0, 24), 40),
        ("BG2-truncated", 2, 384, 24, np.linspace(0.0, 4.0, 24), 20),
        ("Z36", 2, 36, 13, 3.0, None),
    ]
    max_err, notes = 0, []
    for label, bg, zc, batch, snr, n_used in cases:
        k = graphs.lifted_graph(bg, zc).nof_msg_blocks * zc
        msg = torch.randint(0, 2, (batch, k), generator=gen, device=dev,
                            dtype=torch.int8)
        llr = _noisy_llr(rng, encoder_cuda.encode_plain(msg, bg, zc), snr,
                         zc, dev)
        if n_used is not None:
            llr[:, n_used * zc:] = 0.0
        bits, ok = decoder_cuda.decode(llr, bg, zc, nof_used_blocks=n_used)
        w_bits, w_ok = decoder_cuda.decode_plain(llr, bg, zc,
                                                 nof_used_blocks=n_used)
        torch.cuda.synchronize()
        max_err = max(max_err, int((bits.int() - w_bits.int()).abs().max()))
        _check(torch.equal(ok, w_ok) and torch.equal(bits, w_bits),
               f"decoder kernel != plain for {label}")
        n_ok = int(ok.sum())
        if label == "flagship":
            _check(n_ok == batch and torch.equal(bits, msg),
                   "flagship decode did not converge")
        if label == "flagship-mixed":
            _check(0 < n_ok < batch, f"no mixed convergence ({n_ok})")
        notes.append(f"{label} {n_ok}/{batch} ok")
    try:
        decoder_cuda.decode(torch.zeros((2, 68 * 384), device=dev), 1, 384)
    except ValueError as exc:
        _check("294912 B" in str(exc), f"wrong refusal: {exc}")
    else:
        raise AssertionError("full BG1 Z=384 graph was not refused")
    print(f"[decoder] bit-exact (bits, ok) vs decode_plain: "
          f"{'; '.join(notes)}; full BG1 Z=384 refused on {card}")
    return float(max_err)


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
    enc_ms = _time_ms(lambda: encoder_cuda.encode(cbs, bg, zc), 200)
    enc_plain_ms = _time_ms(lambda: encoder_cuda.encode_plain(cbs, bg, zc), 5)
    bb = gnb_flagship.tx_batch(tb, cfg) + noise
    rx = ofdm.demodulate_slot(bb, cfg.nsc, cfg.mu, cfg.nfft)[:, None]
    llr = sch.pusch_demodulate(rx, sh).llr_full.reshape(cbs.shape[0], -1)
    n_used = decoder_cuda.used_blocks(bg, zc, max(sh.cb_lengths))
    dec = lambda: decoder_cuda.decode(llr, bg, zc, nof_used_blocks=n_used)
    dec_plain = lambda: decoder_cuda.decode_plain(llr, bg, zc,
                                                  nof_used_blocks=n_used)
    _check(all(torch.equal(a, b) for a, b in zip(dec(), dec_plain())),
           "decoder kernel != plain on the slice's LLRs")
    dec_ms = _time_ms(dec, 200)
    dec_plain_ms = _time_ms(dec_plain, 5)
    # the same shape when no codeblock converges: all 6 iterations run
    llr_bad = _noisy_llr(np.random.default_rng(5),
                         encoder_cuda.encode(cbs, bg, zc), -6.0, zc, dev)
    dec_bad_ms = _time_ms(
        lambda: decoder_cuda.decode(llr_bad, bg, zc, nof_used_blocks=n_used),
        50)
    print(f"[slice] {cfg.nof_prb}-PRB loopback x{SLICE_SUBMITS} batches of "
          f"{SLICE_BATCH} slots (warmup {warm_s:.2f} s): "
          f"{us_per_slot:.1f} us/slot, all {oks.size} TB CRC ok, mean SINR "
          f"{float(sinrs.mean()):.2f} dB, launches {launches}; encoder "
          f"{list(cbs.shape)} {enc_ms:.4f} ms (plain {enc_plain_ms:.3f} ms), "
          f"decoder {list(llr.shape)} {dec_ms:.4f} ms (plain "
          f"{dec_plain_ms:.3f} ms; no convergence, all 6 iterations: "
          f"{dec_bad_ms:.4f} ms) on {card}")
    return {"launches": launches, "enc_ms": enc_ms,
            "enc_plain_ms": enc_plain_ms, "dec_ms": dec_ms,
            "dec_plain_ms": dec_plain_ms, "pipe": pipe, "tb": tb}


def phase_profile(card: str, pipe, tb) -> None:
    """torch.profiler over two pipeline batches: device busy share, the
    kernels that take the device time, and each LDPC kernel's device time
    per launch on the main path's data.  The profiler's own host cost
    lengthens the window, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batches = 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            pipe.submit(tb)
        pipe.drain()
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
        for e in top[:5])
    print(f"[profile] {batches} batches of {tb.shape[0]} slots: wall "
          f"{wall_us:.0f} us, device busy {busy_us:.0f} us "
          f"({100 * busy_us / wall_us:.1f}%), {launches / batches:.0f} device "
          f"ops per batch; encoder kernel {per_launch('ldpc_encode_kernel')}, "
          f"decoder kernel {per_launch('ldpc_decode_kernel')}; top: {top_s} "
          f"on {card}")


def main() -> None:
    dev, card = phase_device()
    phase_build(card)
    enc_err = phase_encoder(dev, card)
    dec_err = phase_decoder(dev, card)
    s = phase_slice(dev, card)
    phase_profile(card, s["pipe"], s["tb"])
    print(json.dumps({"kernels": [
        {"name": "ldpc_encoder", "route": "cuda",
         "source": "srsran_project_23_5_tpu_torch/csrc/ldpc_encoder.cu",
         "replaces": "srsran_project_23_5_tpu/ops/ldpc/encoder_pallas.py:84",
         "launches": s["launches"]["encoder"], "max_abs_err": enc_err,
         "ms": s["enc_ms"], "plain_ms": s["enc_plain_ms"]},
        {"name": "ldpc_decoder", "route": "cuda",
         "source": "srsran_project_23_5_tpu_torch/csrc/ldpc_decoder.cu",
         "replaces": "srsran_project_23_5_tpu/ops/ldpc/decoder_pallas.py:195",
         "launches": s["launches"]["decoder"], "max_abs_err": dec_err,
         "ms": s["dec_ms"], "plain_ms": s["dec_plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
