"""Example: SSB-only transmitter over the async lower PHY + loopback
radio, with a receiver that detects PSS and decodes PBCH.

The apps/examples/phy/radio_ssb.cpp analogue: a lower PHY streaming
continuous baseband whose only content is a periodic SS/PBCH block.  The
payload and the channel noise are the host draws of
``examples/radio_ssb.py`` (``default_rng(0)``), so both see the same
samples.

    python -m srsran_project_23_5_tpu_torch.examples.radio_ssb \\
        [--slots 40] [--pci 123] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models import fapi_carrier
from ..phy.lower.lower_phy import AsyncLowerPhy, LowerPhyConfig
from ..phy.upper import ssb
from ..utils.device import resolve as resolve_device


def main(argv: list[str] | None = None) -> dict:
    """Stream the SSB slots out and back in; returns {"tx_slots",
    "found": [(slot, pss_corr, pbch_ok)], "device"}.  Raises unless every
    SSB sent is detected and its PBCH decodes to the payload sent."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--slots", type=int, default=40)
    ap.add_argument("--pci", type=int, default=123)
    ap.add_argument("--period", type=int, default=20, help="SSB period slots")
    ap.add_argument("--snr-db", type=float, default=10.0)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = LowerPhyConfig(mu=1, nfft=512, nof_prb=24)
    rng = np.random.default_rng(0)
    scfg = ssb.SsbConfig(pci=args.pci, ssb_idx=0, lmax=8, sfn=0)
    payload = rng.integers(0, 2, size=32).astype(np.int8)
    block = ssb.ssb_assemble(torch.from_numpy(payload).to(dev)[None],
                             scfg)[0]
    pss = ssb.pss_sequence(scfg.nid2)
    k0 = (cfg.nsc - 240) // 2
    tx_slots = []

    def dl_grid(slot):
        if slot >= args.slots or slot % args.period:
            return None
        tx_slots.append(slot)
        grid = torch.zeros((14, cfg.nsc), dtype=torch.complex64, device=dev)
        grid[2:6, k0:k0 + ssb.SSB_NSC] = block
        return grid

    found = []

    def ul_grid(slot, grid):
        # receiver: correlate PSS on symbol 2 on the host, decode PBCH on
        # a hit
        win = grid[2, k0 + 56:k0 + 183].cpu().numpy()
        corr = abs(np.vdot(pss, win)) / (np.linalg.norm(win)
                                         * np.linalg.norm(pss) + 1e-12)
        if corr > 0.6:
            bits, ok = ssb.ssb_receive_pbch(
                grid[None, 2:6, k0:k0 + ssb.SSB_NSC], scfg, noise_var=0.01)
            match = bool(ok[0]) and np.array_equal(bits[0].cpu().numpy(),
                                                   payload)
            found.append((slot, float(corr), match))

    eng = AsyncLowerPhy(cfg, dl_grid, ul_grid, depth=2, device=dev)
    sigma = fapi_carrier.noise_sigma(cfg, args.snr_db)
    total = sum(eng.timeline.slot_size(s) for s in range(args.slots))
    pulled = 0
    while pulled < total:
        n = min(4096, total - pulled)
        bb = eng.pull_tx(n)
        nz = sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        eng.push_rx(bb + torch.from_numpy(nz.astype(np.complex64)).to(dev))
        pulled += n

    print(f"transmitted SSBs at slots {tx_slots}")
    for slot, corr, ok in found:
        print(f"  slot {slot:3d}: PSS corr {corr:.2f}  PBCH ok={ok}")
    if [s for s, _, _ in found] != tx_slots:
        raise AssertionError("missed SSBs")
    if not all(ok for _, _, ok in found):
        raise AssertionError("PBCH decode failed")
    print("radio_ssb example: all SSBs detected and decoded")
    return {"tx_slots": tx_slots, "found": found, "device": str(dev)}


if __name__ == "__main__":
    main()
