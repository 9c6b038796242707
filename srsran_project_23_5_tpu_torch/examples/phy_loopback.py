"""Example: minimal full-chain PDSCH→AWGN→PUSCH loopback on one carrier.

The smallest end-to-end slice of the framework: build a transport block,
run the downlink slot, pass it through a calibrated AWGN channel, run the
uplink receiver, check the CRC.  The TBs are ``examples/phy_loopback.py``'s
host draws (``default_rng(0)``); the noise is drawn on the device from a
``torch.Generator`` seeded with 0 and handed to ``loopback``.

    python -m srsran_project_23_5_tpu_torch.examples.phy_loopback \\
        [--prb 52] [--qm 4] [--snr-db 15] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import fapi_carrier, gnb_flagship
from ..phy.lower import ofdm
from ..phy.upper import sch
from ..ran import numerology
from ..ran import tbs as tbs_mod
from ..utils.device import resolve as resolve_device

LDPC_ITERATIONS = 8


def carrier(prb: int, qm: int, rate: float) -> gnb_flagship.CarrierConfig:
    """One PUSCH over every PRB of a μ=1 carrier, one layer, DM-RS on
    symbols 2, 7 and 11, its TBS from TS 38.214 at `rate`."""
    tbs = tbs_mod.tbs_calculate(14, 36, 0, rate, qm, 1, prb)
    return gnb_flagship.CarrierConfig(
        mu=1, nfft=numerology.min_nfft(prb), nof_prb=prb,
        sh=sch.ShConfig(rnti=0x4601, tbs=tbs, qm=qm, nof_prb=prb,
                        dmrs_symbols=(2, 7, 11)))


def loopback(tb: torch.Tensor, noise: torch.Tensor,
             cfg: gnb_flagship.CarrierConfig
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One slot: TB bits [A] → DL baseband + noise [slot_samples] → OFDM
    demodulation → PUSCH receiver.  Returns (tb_crc_ok, sinr_db, evm)."""
    bb = gnb_flagship.tx_slot(tb, cfg)
    grid = ofdm.demodulate_slot((bb + noise)[None], cfg.nsc, cfg.mu,
                                cfg.nfft)
    r = sch.pusch_receive(grid[:, None], cfg.sh, LDPC_ITERATIONS)
    return r.tb_crc_ok[0], r.sinr_db[0], r.evm[0]


def main(argv: list[str] | None = None) -> dict:
    """Run the slots; returns {"tbs", "slots": [(crc_ok, sinr_db, evm)],
    "ms": [host ms per slot], "device"}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--prb", type=int, default=52)
    ap.add_argument("--qm", type=int, default=4, choices=(2, 4, 6, 8))
    ap.add_argument("--rate", type=float, default=0.5)
    ap.add_argument("--snr-db", type=float, default=15.0)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = carrier(args.prb, args.qm, args.rate)
    tbs = cfg.sh.tbs
    zeros = torch.zeros(cfg.slot_samples, dtype=torch.complex64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    print(f"carrier: {args.prb} PRB, Qm {args.qm}, TBS {tbs} bits, "
          f"SNR {args.snr_db} dB")
    slots, ms = [], []
    t0 = time.perf_counter()
    for i in range(args.slots):
        t = time.perf_counter()
        tb = torch.from_numpy(rng.integers(0, 2, size=tbs).astype(np.int8))
        noise = fapi_carrier.add_awgn(zeros, cfg, args.snr_db, gen)
        ok, sinr, evm = loopback(tb.to(dev), noise, cfg)
        slots.append((bool(ok), float(sinr), float(evm)))
        ms.append((time.perf_counter() - t) * 1e3)
        print(f"  slot {i}: crc_ok={slots[-1][0]} sinr={slots[-1][1]:.1f} "
              f"dB evm={slots[-1][2]:.3f}")
    print(f"{args.slots} slots in {time.perf_counter() - t0:.1f}s")
    return {"tbs": tbs, "slots": slots, "ms": ms, "device": str(dev)}


if __name__ == "__main__":
    main()
