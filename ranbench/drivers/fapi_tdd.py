"""Traffic kind ``fapi_tdd``: the FAPI-driven carrier through ``UpperPhy``,
one slot at a time (B = 1), on srsRAN's default TDD period.

Set-up makes a ring of `periods` TDD periods on the host and the card from
the seed: each DL slot's SCF DL_TTI and TX_Data requests, and each UL
slot's SCF UL_TTI request with the UEs' payloads and the received grid and
PRACH window (the reference's UE side, channels, OFDM and AWGN).  It builds
one ``UpperPhy`` and runs the ring once, which captures every DL and UL
signature.  The window walks the pattern slot after slot: a DL slot is its
SCF translation and ``process_dl_slot`` up to the grid on the card
(synchronised); an UL slot its translation and ``process_ul_slot`` up to the
indications on the host; a special slot carries no request.  After the
window, a sample of DL grids (kept on the card by seeded reservoir
sampling) and of UL slots drawn from the seed runs through the reference's
translation and per-PDU upper PHY on the same requests and grids; every UL
slot's indications are also held against what the UEs sent, and the slots
that miss it join the sample.

Traffic file keys: pattern (a string of D, S and U), full_ul (the UL
position in the period that carries the full mix), periods, sample_dl,
sample_ul, trace_slots, limits {verdicts_differ, sinr_gap_db,
ta_gap_samples, level_gap, dl_grid_gap}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch

from ranbench.harness import result, stats
from ranbench.harness.runner import Outcome
from ranbench.harness.spans import Spans
from ranbench.harness.trace import Stretch
from ranbench.reference import precision
from ranbench.reference.fapi import scf as ref_scf
from ranbench.reference.models import fapi_carrier as ref_carrier
from ranbench.reference.phy.upper.upper_phy import UpperPhy as RefUpperPhy


FAILED_SLOTS = 8   # UL slots that missed what was sent, joining the sample


def ref_config(cell):
    return ref_carrier.default_carrier(**cell.config["args"])


def make_ring(cell, seed: int, device: torch.device) -> list[dict]:
    """The slots of `periods` TDD periods: {"kind": "D", "req", "data"},
    {"kind": "U", "req", "payloads", "rx", "prach_rx", "proc"} or
    {"kind": "S"}, slot numbers running on through the frame."""
    tr = cell.traffic
    car = ref_config(cell)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ring, slot = [], 0
    for _ in range(tr["periods"]):
        for pos, kind in enumerate(tr["pattern"]):
            if kind == "D":
                req, data = ref_carrier.scf_dl_request(car, slot, rng)
                ring.append({"kind": "D", "slot": slot, "req": req,
                             "data": data})
            elif kind == "U":
                req = ref_carrier.scf_ul_request(car, slot,
                                                 full=pos == tr["full_ul"])
                proc = ref_scf.ul_tti_to_processor_request(req)
                # the SCF PRACH PDU has no subcarrier field: the RACH UE
                # sends on the carrier's own PRACH subcarriers
                proc.prach_pdus[:] = [dataclasses.replace(
                    q, sc_start=car.prach_sc) for q in proc.prach_pdus]
                payloads = ref_carrier.ul_payloads(proc, rng)
                rx, prach_rx = ref_carrier.uplink(proc, payloads, car, gen)
                ring.append({"kind": "U", "slot": slot, "req": req,
                             "proc": proc, "payloads": payloads, "rx": rx,
                             "prach_rx": prach_rx})
            else:
                ring.append({"kind": "S", "slot": slot})
            slot += 1
    return ring


def _ul_view(inds) -> dict:
    """The indications of an UL slot by kind: verdicts (compared exactly),
    SINRs (dB), timing advances (samples) and levels (compared
    relatively)."""
    crc, rxd = _kind(inds, "CrcIndication"), _kind(inds, "RxDataIndication")
    uci, rach = _kind(inds, "UciIndication"), _kind(inds, "RachIndication")
    verdicts = ([bool(c.tb_crc_ok) for c in crc]
                + [np.asarray(r.payload, np.int8).tobytes() for r in rxd]
                + [(bool(u.detected),
                    None if u.harq_bits is None
                    else np.asarray(u.harq_bits, np.int8).tobytes(),
                    None if u.uci_bits is None
                    else np.asarray(u.uci_bits, np.int8).tobytes())
                   for u in uci]
                + [[p[0] for p in r.preambles] for r in rach])
    # continuous levels only: a RACH delay is an argmax over delay bins,
    # which rounding may move by one; the preambles are verdicts.  A TA is
    # compared in samples: on a channel with no delay it is the angle of a
    # nearly real sum, a few thousandths of a sample, whose float32 rounding
    # is large beside it
    levels = ([u.metric for u in uci]
              + [p[1] for r in rach for p in r.preambles])
    return {"verdicts": verdicts,
            "sinr": np.asarray([c.sinr_db for c in crc], np.float64),
            "ta": np.asarray([c.ta_samples for c in crc], np.float64),
            "levels": np.asarray(levels, np.float64)}


def _kind(inds, name: str) -> list:
    return [i for i in inds if type(i).__name__ == name]


def sent_ok(car, proc, payloads, inds) -> bool:
    """An UL slot's indications against what the UEs sent: a passing CRC
    for every PUSCH, each RxData payload its TB, each PUCCH's bits
    detected, and the PRACH preamble alone with its injected delay (within
    one sample of the detector's 2048-point grid)."""
    crc, rxd = _kind(inds, "CrcIndication"), _kind(inds, "RxDataIndication")
    uci, rach = _kind(inds, "UciIndication"), _kind(inds, "RachIndication")
    ok = (len(crc) == len(proc.pusch_pdus) and all(c.tb_crc_ok for c in crc)
          and len(rxd) == len(proc.pusch_pdus)
          and all(np.array_equal(r.payload, p[0])
                  for r, p in zip(rxd, payloads["pusch"])))
    sent = [b for pair in payloads["pucch"] for b in pair if b is not None]
    ok = ok and len(uci) == len(sent) and all(
        u.detected and np.array_equal(
            u.harq_bits if u.harq_bits is not None else u.uci_bits, b)
        for u, b in zip(uci, sent))
    if proc.prach_pdus:
        got = rach[0].preambles if len(rach) == 1 else []
        ok = ok and [h[0] for h in got] == [car.prach_preamble] and abs(
            got[0][2] - car.prach_ta_samples) <= car.nfft / 2048
    return bool(ok)


def compare(port_dl, ref_dl, port_ul, ref_ul, limits) -> list:
    """Verdicts of UL slots that differ (count of slots), the widest SINR
    gap (dB), the widest TA gap (samples), the widest relative gap of the
    other UL levels (PUCCH and PRACH metrics), the widest relative gap of a
    DL grid."""
    differ, sinr, ta, level = 0, 0.0, 0.0, 0.0
    for p, r in zip(port_ul, ref_ul):
        differ += int(p["verdicts"] != r["verdicts"]
                      or p["sinr"].shape != r["sinr"].shape
                      or p["levels"].shape != r["levels"].shape)
        if p["sinr"].shape == r["sinr"].shape and p["sinr"].size:
            sinr = max(sinr, float(np.max(np.abs(p["sinr"] - r["sinr"]))))
            ta = max(ta, float(np.max(np.abs(p["ta"] - r["ta"]))))
        if p["levels"].shape == r["levels"].shape and p["levels"].size:
            level = max(level, float(np.max(
                np.abs(p["levels"] - r["levels"])
                / np.maximum(np.abs(r["levels"]), 1e-3))))
    grid = 0.0
    for p, r in zip(port_dl, ref_dl):
        grid = max(grid, float((p - r).abs().max() / r.abs().max()))
    return [result.Compared("verdicts_differ", float(differ),
                            float(limits["verdicts_differ"])),
            result.Compared("sinr_gap_db", sinr, float(limits["sinr_gap_db"])),
            result.Compared("ta_gap_samples", ta,
                            float(limits["ta_gap_samples"])),
            result.Compared("level_gap", level, float(limits["level_gap"])),
            result.Compared("dl_grid_gap", grid, float(limits["dl_grid_gap"]))]


def reference(cell, ring, dl_picks, ul_picks, device, lower=False):
    """The reference's DL grids and UL indications of the picked ring
    positions (each UL slot on a fresh upper PHY, as its HARQ processes all
    carry new data)."""
    car = ref_config(cell)
    cfg = car.upper_phy

    def fresh():
        return RefUpperPhy(cfg, device=device)

    grids, uls = [], []
    with precision.bfloat16() if lower else contextlib.nullcontext():
        for r in dl_picks:
            e = ring[r]
            req = ref_scf.dl_tti_to_processor_request(e["req"])
            grids.append(fresh().process_dl_slot(req, e["data"]))
        for r, slot_count in ul_picks:
            e = ring[r]
            req = ref_scf.ul_tti_to_processor_request(e["req"])
            uls.append(_ul_view(fresh().process_ul_slot(
                e["rx"], req, slot_count, e["prach_rx"])))
    return grids, uls


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str | None = None) -> Outcome:
    from srsran_project_23_5_tpu_torch.fapi import scf
    from srsran_project_23_5_tpu_torch.models import fapi_carrier
    from srsran_project_23_5_tpu_torch.phy.upper.upper_phy import UpperPhy
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = cell.traffic
    car = ref_config(cell)
    spans = Spans()
    ring = make_ring(cell, seed, dev)
    upper = UpperPhy(fapi_carrier.default_carrier(**cell.config["args"])
                     .upper_phy, device=dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def process(e, slot_count):
        if e["kind"] == "D":
            with spans.span("ranbench.translate"):
                req = scf.dl_tti_to_processor_request(e["req"])
            with spans.span("ranbench.dl_slot"):
                grid = upper.process_dl_slot(req, e["data"])
                sync()
            return grid
        with spans.span("ranbench.translate"):
            req = scf.ul_tti_to_processor_request(e["req"])
        with spans.span("ranbench.ul_slot"):
            return upper.process_ul_slot(e["rx"], req, slot_count,
                                         e["prach_rx"])

    work = [r for r, e in enumerate(ring) if e["kind"] != "S"]
    for n, r in enumerate(work):       # captures every signature
        process(ring[r], n)
    sync()
    spans.seconds.clear()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    rng = np.random.default_rng(seed)
    k_dl = tr["sample_dl"]
    reservoir: list[tuple[int, torch.Tensor]] = []
    n_dl = 0
    uls, per_slot = [], []
    stretch = None
    count = len(work)
    t_start = time.perf_counter()
    i = 0
    while True:
        if trace and stretch is None and \
                time.perf_counter() - t_start >= 0.25 * seconds:
            stretch = Stretch(cell.root / "build" / "ranbench" / "trace.json",
                              spans, i, tr["trace_slots"], sync)
        if stretch is not None:
            stretch.before(i)
        r = work[i % len(work)]
        e = ring[r]
        t = time.perf_counter()
        out = process(e, count)
        per_slot.append(time.perf_counter() - t)
        if e["kind"] == "D":
            if n_dl < k_dl:
                reservoir.append((r, out))
            else:
                j = int(rng.integers(0, n_dl + 1))
                if j < k_dl:
                    reservoir[j] = (r, out)
            n_dl += 1
        else:
            uls.append((r, count, out))
        if stretch is not None:
            stretch.after(i)
        i += 1
        count += 1
        if time.perf_counter() - t_start >= seconds and (
                not trace or (stretch is not None and stretch.done)):
            break
    window = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    failed = [k for k, (r, _, inds) in enumerate(uls)
              if not sent_ok(car, ring[r]["proc"], ring[r]["payloads"], inds)]
    # the sample, and the first UL slots whose indications missed what
    # was sent
    ul_sample = sorted(set(rng.choice(len(uls), size=min(tr["sample_ul"],
                                                         len(uls)),
                                      replace=False).tolist())
                       | set(failed[:FAILED_SLOTS]))
    dl_picks = [r for r, _ in reservoir]
    ul_picks = [(uls[k][0], uls[k][1]) for k in ul_sample]
    port_dl = [g for _, g in reservoir]
    port_ul = [_ul_view(uls[k][2]) for k in ul_sample]
    del upper
    t_ref = time.perf_counter()
    ref_dl, ref_ul = reference(cell, ring, dl_picks, ul_picks, dev)
    print(f"reference: {len(dl_picks)} DL and {len(ul_picks)} UL slots in "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    compared = compare(port_dl, ref_dl, port_ul, ref_ul, tr["limits"])
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    return Outcome(
        attempted=i, failed=len(failed),
        end_to_end={"fapi_slot_ms": 1e3 * window / i,
                    "fapi_slot_ms_p95": 1e3 * stats.percentile(per_slot, 95),
                    "setup_s": t_start - t0},
        compared=compared, device=device_info, spans=spans,
        trace=stretch.result if stretch is not None else None)


def control(cell, seed: int, dispatches: int = 2,
            device: str | None = None) -> list:
    """The control: the reference in bfloat16 in the program's place on a
    sample of the ring's DL and UL slots, judged against the float32
    reference by the cell's limits."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = cell.traffic
    ring = make_ring(cell, seed, dev)
    dl = [r for r, e in enumerate(ring) if e["kind"] == "D"][:tr["sample_dl"]]
    ul = [(r, r) for r, e in enumerate(ring)
          if e["kind"] == "U"][:tr["sample_ul"]]
    ref_dl, ref_ul = reference(cell, ring, dl, ul, dev)
    low_dl, low_ul = reference(cell, ring, dl, ul, dev, lower=True)
    return compare(low_dl, ref_dl, low_ul, ref_ul, tr["limits"])
