"""Demo: one full mixed slot end-to-end (the flagship program).

Runs the complete per-slot channel mix — DL: PDCCH×2 + SSB + CSI-RS +
2×PDSCH (one 2-layer MIMO); UL: 2×PUSCH (one 2×2) + PUCCH F1 + PRACH —
through unitary channels at a calibrated SNR and prints every
verification output, as ``examples/mixed_slot_demo.py`` does.  The
payloads are its host draws (``default_rng(0)``); the noise is drawn on
the device (``gnb_mixed.draw_noise`` from a generator seeded with 0).

    python -m srsran_project_23_5_tpu_torch.examples.mixed_slot_demo \\
        [--prb 273] [--snr 20] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import gnb_mixed
from ..utils.device import resolve as resolve_device


def config(prb: int, snr_db: float) -> gnb_mixed.MixedSlotConfig:
    """QPSK at rate 1/2 below 100 PRB, else 64QAM at rate 0.6533."""
    qm, rate = (2, 0.5) if prb < 100 else (6, 0.6533)
    return gnb_mixed.default_mixed(nof_prb=prb, qm=qm, rate=rate,
                                   snr_db=snr_db)


def main(argv: list[str] | None = None) -> dict:
    """Run one slot; returns {"cfg", "out": {name: host array}, "run_s",
    "device"}.  Raises unless the slot verified every channel."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--prb", type=int, default=68)
    ap.add_argument("--snr", type=float, default=20.0)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config(args.prb, args.snr)
    name = (f"{dev} ({torch.cuda.get_device_name(dev)})"
            if dev.type == "cuda" else str(dev))
    print(f"{args.prb} PRB mixed slot on {name}: "
          f"DL TBs {cfg.pdsch0.tbs}+{cfg.pdsch1.tbs} b (UE0 2-layer), "
          f"UL TBs {cfg.pusch0.tbs}+{cfg.pusch1.tbs} b (UE0 2x2)")
    payloads = gnb_mixed.make_payloads(cfg, np.random.default_rng(0), 1, dev)
    noise_dl, noise_ul = gnb_mixed.draw_noise(
        cfg, 1, torch.Generator(device=dev).manual_seed(0))
    t0 = time.perf_counter()
    res = gnb_mixed.mixed_slot_dict({k: v[0] for k, v in payloads.items()},
                                    noise_dl[0], noise_ul[0], cfg)
    out = {k: v.cpu().numpy() for k, v in res.items()}
    run_s = time.perf_counter() - t0
    print(f"run: {run_s:.1f}s")
    for k in sorted(out):
        print(f"  {k:>14}: {out[k]}")
    if not bool(out["ok"]):
        raise AssertionError("mixed slot verification failed")
    print("all channels verified OK")
    return {"cfg": cfg, "out": out, "run_s": run_s, "device": str(dev)}


if __name__ == "__main__":
    main()
