"""Traffic kind ``scan_mixed``: the mixed slot through ``SlotPipeline``'s
scan mode, a closed loop of dispatches back to back.

Set-up builds one pipeline on the program's ``gnb_mixed.mixed_slot_batch``
(B slots per batch, K batches per dispatch, one captured CUDA graph on the
card) and a ring of distinct payload sets made on the device from the seed.
The window submits dispatch after dispatch (``submit_scan``), each on the
next payload set and its own noise seed, at most ``DEPTH`` in flight, and
ends with the one ``fetch_accumulated``.  Each batch's per-slot verdicts and
measurements, and the count of bits by which each PUSCH's decoded TB (the
codeblocks that ``gnb_mixed.decode_front`` hands to the verdict) departs
from the sent TB, are copied into a record inside the graph; after the
window a sample of slots drawn from the seed (and every slot the program
failed or decoded wrong) is run through the reference on the same payloads
and noise and compared.

Traffic file keys: slots_per_batch, scan_batches, trace_dispatches, limits
{verdicts_differ, sinr_gap_db, rel_gap}, kernels {ldpc_dec, ldpc_enc:
{match, per_batch: [shape]}}.
"""
from __future__ import annotations

import collections
import contextlib
import math
import sys
import time

import numpy as np
import torch

from ranbench.harness import result
from ranbench.harness.runner import Outcome
from ranbench.harness.spans import Spans
from ranbench.harness.trace import Stretch
from ranbench.reference import precision
from ranbench.reference.models import gnb_mixed as ref_mixed
from ranbench.reference.phy.upper import ssb as ref_ssb

# per-slot outputs of the program that are compared, by kind
VERDICTS = ("ok", "ul0_ok", "ul1_ok", "dl0_ok", "dl1_ok", "pucch_ok",
            "prach_ok", "dci_crc_ok")
SINRS = ("sinr_ul0_db", "sinr_ul1_db", "sinr_dl0_db", "csi_sinr_db")
# continuous measurements only: the symbol match fractions and the PRACH
# delay are counts of hard decisions, which rounding may flip one RE or one
# delay bin at a time; their verdicts (dl*_ok, pdcch, prach_ok) are compared
LEVELS = ("ssb_match", "pss_corr", "pucch_metric", "prach_metric")
FLOATS = SINRS + LEVELS
# bits of each PUSCH's decoded TB that differ from the sent TB
ERRORS = ("ul0_bit_errors", "ul1_bit_errors")
DEPTH = 2           # dispatches in flight
PAYLOAD_SETS = 4    # distinct payload sets, cycled over the dispatches
SAMPLE_SLOTS = 24   # slots of a run held against the reference


def dispatch_seed(seed: int, i: int) -> int:
    """The noise seed of dispatch i of a run."""
    return (seed * 1_000_003 + 7_919 * (i + 1)) % (1 << 62)


def ref_config(cell) -> ref_mixed.MixedSlotConfig:
    return ref_mixed.default_mixed(**cell.config["args"])


def payload_sizes(rcfg) -> dict[str, int]:
    return {"tb_dl0": rcfg.pdsch0.tbs, "tb_dl1": rcfg.pdsch1.tbs,
            "tb_ul0": rcfg.pusch0.tbs, "tb_ul1": rcfg.pusch1.tbs,
            "dci_dl": rcfg.pdcch_dl.payload_size,
            "dci_ul": rcfg.pdcch_ul.payload_size,
            "pbch": ref_ssb.PBCH_A, "ack": rcfg.pucch.nof_harq_bits}


def payload_ring(rcfg, seed: int, sets: int, batch: int,
                 device: torch.device) -> list[dict]:
    """`sets` distinct payload sets {name: [batch, n] int8}, drawn on the
    device from the seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [{k: torch.randint(0, 2, (batch, n), generator=g, device=device,
                              dtype=torch.int8)
             for k, n in payload_sizes(rcfg).items()} for _ in range(sets)]


def draw(rcfg, batch: int, generator: torch.Generator):
    """The channel noise of `batch` slots: downlink and uplink [batch, 2,
    slot_samples] complex64 with sqrt(nfft)·10^(-snr/20) per sample, drawn
    in one call on the generator's device."""
    nz = torch.randn((2, batch, 2, 2, rcfg.slot_samples), generator=generator,
                     device=generator.device, dtype=torch.float32)
    nz = nz * (ref_mixed.noise_sigma(rcfg) / math.sqrt(2.0))
    return (torch.complex(nz[0, :, 0], nz[0, :, 1]),
            torch.complex(nz[1, :, 0], nz[1, :, 1]))


def dispatch_noise(rcfg, slots: int, seed: int, device: torch.device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return draw(rcfg, slots, g)


def reference_slots(rcfg, ring, seeds, picks, batch: int, scan: int,
                    device: torch.device, lower: bool = False) -> dict:
    """The reference on the picked slots [(dispatch i, batch k, slot b)],
    each run alone on its payload row and noise row → {field: [n] float}.
    `lower`: the reference one precision below (the control)."""
    out = {f: [] for f in VERDICTS + FLOATS + ERRORS}
    by_dispatch = collections.defaultdict(list)
    for n, (i, k, b) in enumerate(picks):
        by_dispatch[i].append((n, k, b))
    rows = [None] * len(picks)
    for i, members in by_dispatch.items():
        ndl, nul = dispatch_noise(rcfg, scan * batch, seeds[i], device)
        pay = ring[i % len(ring)]
        for n, k, b in members:
            one = {key: v[b:b + 1] for key, v in pay.items()}
            j = k * batch + b
            with precision.bfloat16() if lower else contextlib.nullcontext():
                res, dec = ref_mixed.mixed_slot_decoded(
                    one, ndl[j:j + 1], nul[j:j + 1], rcfg)
            rows[n] = {f: float(getattr(res, f)[0])
                       for f in VERDICTS + FLOATS}
            rows[n].update(zip(ERRORS, bit_errors(dec, one, rcfg)[:, 0]
                               .tolist()))
        del ndl, nul
    for r in rows:
        for f in out:
            out[f].append(r[f])
    return {f: np.asarray(v, np.float64) for f, v in out.items()}


def bit_errors(dec: dict, payloads: dict, rcfg) -> torch.Tensor:
    """[2, B] int32: the bits of each PUSCH's decoded TB (codeblock bits
    from ``decode_front``) that differ from the sent TB."""
    return torch.stack([
        ref_mixed.tb_bit_errors(dec["u0"][0], rcfg.pusch0,
                                payloads["tb_ul0"]),
        ref_mixed.tb_bit_errors(dec["u1"][0], rcfg.pusch1,
                                payloads["tb_ul1"])])


def compare(port: dict, ref: dict, limits: dict) -> list[result.Compared]:
    """The compared numbers of the sampled slots: slots whose verdicts or
    decoded-TB bit errors differ (count), the widest SINR gap (dB), the
    widest relative gap of the other measurements."""
    differ = np.zeros(len(port["ok"]), bool)
    for f in VERDICTS + ERRORS:
        differ |= port[f] != ref[f]
    sinr = max(float(np.max(np.abs(port[f] - ref[f]))) for f in SINRS)
    rel = max(float(np.max(np.abs(port[f] - ref[f])
                           / np.maximum(np.abs(ref[f]), 1e-6)))
              for f in LEVELS)
    return [result.Compared("verdicts_differ", float(differ.sum()),
                            float(limits["verdicts_differ"])),
            result.Compared("sinr_gap_db", sinr, float(limits["sinr_gap_db"])),
            result.Compared("rel_gap", rel, float(limits["rel_gap"]))]


class Program:
    """The system under test: one ``SlotPipeline`` in scan mode on the
    program's mixed slot, with each batch's per-slot outputs and the bit
    errors of its decoded TBs recorded."""

    def __init__(self, cell, rcfg, seed: int, device: torch.device) -> None:
        from srsran_project_23_5_tpu_torch.models import gnb_mixed
        from srsran_project_23_5_tpu_torch.phy.pipeline import (
            PipelineConfig, PipelineFn, SlotPipeline)
        tr = cell.traffic
        self.batch, self.scan = tr["slots_per_batch"], tr["scan_batches"]
        self.cfg = gnb_mixed.default_mixed(**cell.config["args"])
        for name, n in payload_sizes(rcfg).items():
            if name.startswith("tb_") and n != getattr(
                    self.cfg, {"tb_dl0": "pdsch0", "tb_dl1": "pdsch1",
                               "tb_ul0": "pusch0", "tb_ul1": "pusch1"}[name]).tbs:
                raise RuntimeError(f"the program sizes {name} otherwise")
        self.rec_v = torch.zeros((self.scan, len(VERDICTS), self.batch),
                                 dtype=torch.bool, device=device)
        self.rec_f = torch.zeros((self.scan, len(FLOATS), self.batch),
                                 dtype=torch.float32, device=device)
        self.rec_e = torch.zeros((self.scan, len(ERRORS), self.batch),
                                 dtype=torch.int32, device=device)
        self.rcfg = rcfg
        self.calls = 0
        self.pipe = SlotPipeline(
            PipelineConfig(carrier=None, slots_per_batch=self.batch,
                           scan_batches=self.scan, snr_db=rcfg.snr_db,
                           nof_ldpc_iterations=rcfg.nof_ldpc_iterations),
            device=device, seed=seed,
            batch_fn=PipelineFn(self._run, lambda b, g: draw(rcfg, b, g)))

    def _run(self, payloads, noise_dl, noise_ul):
        from srsran_project_23_5_tpu_torch.models import gnb_mixed
        # tap the decoded codeblocks on their way to the verdict
        taken, real = {}, gnb_mixed.decode_front

        def tap(front, cfg):
            taken["dec"] = real(front, cfg)
            return taken["dec"]
        gnb_mixed.decode_front = tap
        try:
            res = gnb_mixed.mixed_slot_batch(payloads, noise_dl, noise_ul,
                                             self.cfg)
        finally:
            gnb_mixed.decode_front = real
        if "dec" not in taken:
            raise RuntimeError("mixed_slot_batch decoded no codeblocks "
                               "through gnb_mixed.decode_front")
        k = self.calls % self.scan
        # a batch decoded short of its slots reads -1 for those it left out
        rows = taken["dec"]["u0"][0].shape[0]
        self.rec_e[k].fill_(-1)
        self.rec_e[k, :, :rows].copy_(bit_errors(
            taken["dec"], {n: v[:rows] for n, v in payloads.items()},
            self.rcfg))
        self.calls += 1
        torch.stack([getattr(res, f) for f in VERDICTS], out=self.rec_v[k])
        torch.stack([getattr(res, f).to(torch.float32) for f in FLOATS],
                    out=self.rec_f[k])
        return res.ok, res.sinr_ul_db


def _pick(rng, dispatches: int, scan: int, batch: int, count: int,
          failed) -> list[tuple[int, int, int]]:
    total = dispatches * scan * batch
    idx = set(rng.choice(total, size=min(count, total), replace=False)
              .tolist())
    idx |= set(failed[:count])
    return [(j // (scan * batch), (j // batch) % scan, j % batch)
            for j in sorted(idx)]


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str | None = None) -> Outcome:
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = cell.traffic
    rcfg = ref_config(cell)
    spans = Spans()
    prog = Program(cell, rcfg, seed, dev)
    batch, scan = prog.batch, prog.scan
    ring = payload_ring(rcfg, seed, PAYLOAD_SETS, batch, dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    prog.pipe.warmup_scan(ring[0])   # its verdict is judged in the window
    # a second dispatch, timed, sizes the record of the window's dispatches
    # so that nothing is allocated inside the window
    sync()
    t = time.perf_counter()
    prog.pipe.submit_scan(ring[1 % len(ring)], dispatch_seed(seed, -1))
    sync()
    capacity = int(2 * seconds / (time.perf_counter() - t)) + 16
    prog.pipe.fetch_accumulated()
    rec_v = torch.zeros((capacity, *prog.rec_v.shape), dtype=torch.bool,
                        device=dev)
    rec_f = torch.zeros((capacity, *prog.rec_f.shape), dtype=torch.float32,
                        device=dev)
    rec_e = torch.zeros((capacity, *prog.rec_e.shape), dtype=torch.int32,
                        device=dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    seeds, inflight = [], collections.deque()
    stretch = None
    t_start = time.perf_counter()
    i = 0
    while True:
        if trace and stretch is None and \
                time.perf_counter() - t_start >= 0.25 * seconds:
            stretch = Stretch(cell.root / "build" / "ranbench" / "trace.json",
                              spans, i, tr["trace_dispatches"], sync)
        if stretch is not None:
            stretch.before(i)
        seeds.append(dispatch_seed(seed, i))
        with spans.span("ranbench.enqueue"):
            prog.pipe.submit_scan(ring[i % len(ring)], seeds[-1])
        if i >= capacity:
            raise RuntimeError("more dispatches than the record holds")
        rec_v[i].copy_(prog.rec_v)
        rec_f[i].copy_(prog.rec_f)
        rec_e[i].copy_(prog.rec_e)
        if on_card:
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
            if len(inflight) >= DEPTH:
                with spans.span("ranbench.wait"):
                    inflight.popleft().synchronize()
        if stretch is not None:
            stretch.after(i)
        i += 1
        if time.perf_counter() - t_start >= seconds and (
                not trace or (stretch is not None and stretch.done)):
            break
    with spans.span("ranbench.fetch"):
        acc_ok, _, n_slots = prog.pipe.fetch_accumulated()
    t_end = time.perf_counter()
    window = t_end - t_start
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    verdicts = rec_v[:i].cpu().numpy()
    floats = rec_f[:i].cpu().numpy()
    errors = rec_e[:i].cpu().numpy()
    del prog, rec_v, rec_f, rec_e
    if on_card:
        torch.cuda.empty_cache()
    ok_flat = verdicts[:, :, 0, :].reshape(-1)         # [i, k, b] order
    wrong = (errors != 0).any(axis=2).reshape(-1)
    failed = np.flatnonzero(~ok_flat | wrong).tolist()

    picks = _pick(np.random.default_rng(seed), i, scan, batch,
                  SAMPLE_SLOTS, failed)
    port = {f: np.asarray([verdicts[a, k, j, b] for a, k, b in picks],
                          np.float64) for j, f in enumerate(VERDICTS)}
    port.update({f: np.asarray([floats[a, k, j, b] for a, k, b in picks],
                               np.float64) for j, f in enumerate(FLOATS)})
    port.update({f: np.asarray([errors[a, k, j, b] for a, k, b in picks],
                               np.float64) for j, f in enumerate(ERRORS)})
    t_ref = time.perf_counter()
    ref = reference_slots(rcfg, ring, seeds, picks, batch, scan, dev)
    print(f"reference: {len(picks)} slots in "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    # the one host read of the window against the slots it folded
    compared = compare(port, ref, tr["limits"]) + [result.Compared(
        "accumulator_differs",
        float(acc_ok != bool(ok_flat.all()) or n_slots != ok_flat.size),
        0.0)]

    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    return Outcome(
        attempted=n_slots, failed=len(failed),
        end_to_end={"mixed_slot_us": 1e6 * window / n_slots,
                    "setup_s": t_start - t0},
        compared=compared, device=device_info, spans=spans,
        trace=stretch.result if stretch is not None else None)


def kernel_shapes(cell, seed: int, device: str | None = None) -> dict:
    """The LDPC launches of one batch of this cell with the work they need:
    each shape's rows, lifting size, message and codeword bits, used
    variable blocks and edges, and for the decoder the mean layered
    min-sum sweeps that the reference's plain decoder needs on the cell's
    own seeded codeblocks (one batch of the first payload set and the first
    dispatch's noise).  Run once when the cell is defined; the result goes
    into the cell's traffic file."""
    from ranbench.reference.ops.ldpc import decoder
    from ranbench.reference.ops.ldpc.graphs import lifted_graph
    from ranbench.reference.phy.upper import sch as ref_sch
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    rcfg = ref_config(cell)
    batch = cell.traffic["slots_per_batch"]
    ring = payload_ring(rcfg, seed, 1, batch, dev)
    ndl, nul = dispatch_noise(rcfg, batch, dispatch_seed(seed, 0), dev)
    front = ref_mixed._mixed_front(ring[0], ndl, nul, rcfg)

    def shape(sh, llr=None):
        seg = sh.segments
        z, bg = seg.lifting_size, seg.base_graph
        g = lifted_graph(bg, z)
        used = ref_sch.used_blocks(sh)
        _, n, _, edges = decoder._schedule(bg, z, used)
        out = {"rows": batch * seg.nof_segments, "z": z, "base_graph": bg,
               "k": g.nof_msg_blocks * z, "n": g.nof_var_blocks * z,
               "used_blocks": n, "edges": edges}
        if llr is not None:
            sweeps = decoder.sweeps_needed(
                llr.reshape(-1, llr.shape[-1]), bg, z,
                nof_iterations=rcfg.nof_ldpc_iterations, nof_used_blocks=used)
            out["sweeps"] = float(sweeps.double().mean())
        return out

    return {"ldpc_dec": {"match": "ldpc_decode_kernel", "per_batch": [
                shape(rcfg.pusch0, front["u0"].llr_full),
                shape(rcfg.pusch1, front["u1"].llr_full)]},
            "ldpc_enc": {"match": "ldpc_encode_kernel", "per_batch": [
                shape(sh) for sh in (rcfg.pdsch0, rcfg.pdsch1, rcfg.pusch0,
                                     rcfg.pusch1)]}}


def control(cell, seed: int, dispatches: int = 4,
            device: str | None = None) -> list[result.Compared]:
    """The control of the comparison: the reference one precision below
    (bfloat16 at every stage boundary) put in the program's place, on the
    slots a run of `dispatches` dispatches would sample, judged against the
    float32 reference by the cell's limits."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = cell.traffic
    batch, scan = tr["slots_per_batch"], tr["scan_batches"]
    rcfg = ref_config(cell)
    ring = payload_ring(rcfg, seed, PAYLOAD_SETS, batch, dev)
    seeds = [dispatch_seed(seed, i) for i in range(dispatches)]
    picks = _pick(np.random.default_rng(seed), dispatches, scan, batch,
                  SAMPLE_SLOTS, [])
    ref = reference_slots(rcfg, ring, seeds, picks, batch, scan, dev)
    low = reference_slots(rcfg, ring, seeds, picks, batch, scan, dev,
                          lower=True)
    return compare(low, ref, tr["limits"])
