"""Traffic kind ``scan_harq``: HARQ pairs of the mixed slot through
``SlotPipeline``'s scan mode, a closed loop of dispatches back to back.

Every UL TB is sent twice: a first transmission at rv=0 below the MCS
cliff, then its retransmission at rv=2, whose LLRs the gNB adds to the
first's (the softbuffer) and decodes on the full graph.  Set-up builds one
pipeline on the program's ``gnb_mixed.harq_pair_batch`` (B pairs a batch, K
batches a dispatch, one captured CUDA graph on the card), with the
benchmark's own noise draw of both transmissions, and a ring of distinct payload sets made on the device from
the seed.  The window submits dispatch after dispatch, each on the next
payload set and its own noise seed, at most ``DEPTH`` in flight, and ends
with the one ``fetch_accumulated``.  Each batch's per-pair verdicts and
measurements of both slots, and the count of bits by which each PUSCH's
combined decode departs from the sent TB, are copied into a record inside
the graph; after the window a sample of pairs drawn from the seed (and
every pair the program got wrong) is run through the reference
(``reference/models/gnb_harq``) on the same payloads and noise and
compared.  The bits of a failed first decode are not compared: min-sum on a
codeblock that does not converge turns float32 rounding into other wrong
bits.

A program without ``gnb_mixed.harq_pair_batch`` is refused before anything
is put on the card.

Traffic file keys: pairs_per_batch, scan_batches, trace_dispatches, limits
{verdicts_differ, sinr_gap_db, rel_gap}, kernels {ldpc_dec, ldpc_dec_full:
{match, per_batch: [shape]}}.  Configuration keys: args (the carrier, as
``mixed273``'s), harq {rv, retransmissions, snr_db}.
"""
from __future__ import annotations

import collections
import contextlib
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ranbench.harness import result
from ranbench.harness.cell import load_module
from ranbench.harness.runner import Outcome
from ranbench.harness.spans import Spans
from ranbench.harness.trace import Stretch
from ranbench.reference import precision
from ranbench.reference.models import gnb_harq as ref_harq
from ranbench.reference.models import gnb_mixed as ref_mixed

mixed = load_module(Path(__file__).with_name("scan_mixed.py"))

SLOTS = ("first", "second")
# per pair: the pair's verdict, then each slot's verdicts and measurements
VERDICTS = ("ok",) + tuple(f"{s}.{f}" for s in SLOTS for f in mixed.VERDICTS)
SINRS = tuple(f"{s}.{f}" for s in SLOTS for f in mixed.SINRS)
LEVELS = tuple(f"{s}.{f}" for s in SLOTS for f in mixed.LEVELS)
FLOATS = SINRS + LEVELS
# bits of each PUSCH's combined decode that differ from the sent TB
ERRORS = ("ul0_bit_errors", "ul1_bit_errors")
DEPTH = 2           # dispatches in flight
PAYLOAD_SETS = 4    # distinct payload sets, cycled over the dispatches
SAMPLE_PAIRS = 24   # pairs of a run held against the reference


def ref_config(cell) -> ref_mixed.MixedSlotConfig:
    return ref_mixed.default_mixed(**cell.config["args"])


def harq_link(cell) -> tuple[float, int]:
    """(the uplink's SNR of both transmissions, the retransmission's rv)."""
    h = cell.config["harq"]
    rv = list(h["rv"])
    if rv[0] != 0 or len(rv) != 2 or h["retransmissions"] != 1:
        raise ValueError(f"one retransmission after rv=0, not {h}")
    return float(h["snr_db"]), int(rv[1])


def draw(rcfg, ul_snr_db: float, batch: int, generator: torch.Generator):
    """The channel noise of `batch` pairs: (downlink, uplink) of the first
    transmission, then of the retransmission, each [batch, 2, slot_samples]
    complex64, drawn in one call on the generator's device; the downlink
    at the carrier's SNR, the uplink at `ul_snr_db`."""
    nz = torch.randn((4, batch, 2, 2, rcfg.slot_samples), generator=generator,
                     device=generator.device, dtype=torch.float32)
    sd_dl = ref_mixed.noise_sigma(rcfg) / math.sqrt(2.0)
    sd_ul = math.sqrt(rcfg.nfft) * 10 ** (-ul_snr_db / 20) / math.sqrt(2.0)
    return tuple(torch.complex(nz[i, :, 0], nz[i, :, 1]) * sd
                 for i, sd in enumerate((sd_dl, sd_ul, sd_dl, sd_ul)))


def dispatch_noise(rcfg, ul_snr_db: float, pairs: int, seed: int,
                   device: torch.device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return draw(rcfg, ul_snr_db, pairs, g)


def _fields(res) -> dict[str, torch.Tensor]:
    """{field: [B]} of a pair batch's result (the program's or the
    reference's: both carry ok, first, second)."""
    out = {"ok": res.ok}
    for s in SLOTS:
        slot = getattr(res, s)
        out.update({f"{s}.{f}": getattr(slot, f)
                    for f in mixed.VERDICTS + mixed.FLOATS})
    return out


def reference_pairs(cell, ring, seeds, picks, batch: int, scan: int,
                    device: torch.device, lower: bool = False) -> dict:
    """The reference on the picked pairs [(dispatch i, batch k, pair b)],
    the picks of one dispatch as one batch → {field: [n] float}.
    `lower`: the reference one precision below (the control)."""
    rcfg = ref_config(cell)
    ul_snr, rv = harq_link(cell)
    rows = [None] * len(picks)
    by_dispatch = collections.defaultdict(list)
    for n, (i, k, b) in enumerate(picks):
        by_dispatch[i].append((n, k * batch + b))
    for i, members in by_dispatch.items():
        noise = dispatch_noise(rcfg, ul_snr, scan * batch, seeds[i], device)
        idx = torch.tensor([j for _, j in members], device=device)
        pay = ring[i % len(ring)]
        sel = {key: v[idx % batch] for key, v in pay.items()}
        with precision.bfloat16() if lower else contextlib.nullcontext():
            res = ref_harq.harq_pair(sel, tuple(nz[idx] for nz in noise),
                                     rcfg, rv)
        fields = _fields(res)
        errs = mixed.bit_errors(res.combined, sel, rcfg)
        for m, (n, _) in enumerate(members):
            rows[n] = {f: float(v[m]) for f, v in fields.items()}
            rows[n].update(zip(ERRORS, errs[:, m].tolist()))
        del noise
    return {f: np.asarray([r[f] for r in rows], np.float64)
            for f in VERDICTS + FLOATS + ERRORS}


def compare(port: dict, ref: dict, limits: dict) -> list[result.Compared]:
    """The compared numbers of the sampled pairs: pairs in which a verdict
    of either slot, a first or combined verdict, the pair's verdict or the
    combined decode's bit errors differ (count), the widest SINR gap (dB),
    the widest relative gap of the other measurements."""
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


def program_counts(verdicts: np.ndarray) -> str:
    """The program's own counts over a window's records [dispatch, batch,
    verdict, pair]: first transmissions that passed, combinations that
    failed, and each other verdict of either slot that was false."""
    v = {f: verdicts[:, :, j, :] for j, f in enumerate(VERDICTS)}
    first = int((v["first.ul0_ok"] | v["first.ul1_ok"]).sum())
    comb = int((~(v["second.ul0_ok"] & v["second.ul1_ok"])).sum())
    other = {f: int((~v[f]).sum()) for f in VERDICTS
             if f.split(".")[-1] not in ("ok", "ul0_ok", "ul1_ok")}
    return (f"program: {v['ok'].size} pairs, {int((~v['ok']).sum())} not ok;"
            f" first transmission passed in {first}, combination failed in "
            f"{comb}; other verdicts false: "
            f"{ {f: n for f, n in other.items() if n} }")


def _program_module():
    """The program's mixed-slot model, or a refusal where it runs no HARQ
    pairs (checked before anything goes to the card)."""
    from srsran_project_23_5_tpu_torch.models import gnb_mixed
    if not callable(getattr(gnb_mixed, "harq_pair_batch", None)):
        raise RuntimeError("the program has no gnb_mixed.harq_pair_batch: "
                           "it runs no HARQ pairs")
    return gnb_mixed


class Program:
    """The system under test: one ``SlotPipeline`` in scan mode on the
    program's HARQ pairs, with each batch's per-pair outputs and the bit
    errors of its combined decodes recorded."""

    def __init__(self, cell, rcfg, seed: int, device: torch.device) -> None:
        from srsran_project_23_5_tpu_torch.phy.pipeline import (
            PipelineConfig, PipelineFn, SlotPipeline)
        gnb_mixed = _program_module()
        tr = cell.traffic
        self.batch, self.scan = tr["pairs_per_batch"], tr["scan_batches"]
        self.cfg = gnb_mixed.default_mixed(**cell.config["args"])
        ul_snr, self.rv = harq_link(cell)
        for name, sh in (("pdsch0", rcfg.pdsch0), ("pdsch1", rcfg.pdsch1),
                         ("pusch0", rcfg.pusch0), ("pusch1", rcfg.pusch1)):
            if getattr(self.cfg, name).tbs != sh.tbs:
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
            batch_fn=PipelineFn(self._run, lambda b, g: draw(
                rcfg, ul_snr, b, g)))

    def _run(self, payloads, *noise):
        from srsran_project_23_5_tpu_torch.models import gnb_mixed
        res = gnb_mixed.harq_pair_batch(payloads, noise, self.cfg, self.rv)
        k = self.calls % self.scan
        self.calls += 1
        fields = _fields(res)
        torch.stack([fields[f] for f in VERDICTS], out=self.rec_v[k])
        torch.stack([fields[f].to(torch.float32) for f in FLOATS],
                    out=self.rec_f[k])
        self.rec_e[k].copy_(mixed.bit_errors(res.combined, payloads,
                                             self.rcfg))
        return res.ok, 0.5 * (res.first.sinr_ul_db + res.second.sinr_ul_db)


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str | None = None) -> Outcome:
    _program_module()
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
    ring = mixed.payload_ring(rcfg, seed, PAYLOAD_SETS, batch, dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # a traced run keeps the program's spans and counts of the capture,
    # which the per-layer readers hold the traced launches against
    from srsran_project_23_5_tpu_torch.utils.tracing import tracer
    was = tracer.enabled
    tracer.enabled = was or trace
    try:
        prog.pipe.warmup_scan(ring[0])   # its verdict is judged in the window
    finally:
        tracer.enabled = was
    # a second dispatch, timed, sizes the record of the window's dispatches
    # so that nothing is allocated inside the window
    sync()
    t = time.perf_counter()
    prog.pipe.submit_scan(ring[1 % len(ring)], mixed.dispatch_seed(seed, -1))
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
        seeds.append(mixed.dispatch_seed(seed, i))
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
        acc_ok, _, n_pairs = prog.pipe.fetch_accumulated()
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
    print(program_counts(verdicts), file=sys.stderr)

    picks = mixed._pick(np.random.default_rng(seed), i, scan, batch,
                        SAMPLE_PAIRS, failed)
    port = {f: np.asarray([verdicts[a, k, j, b] for a, k, b in picks],
                          np.float64) for j, f in enumerate(VERDICTS)}
    port.update({f: np.asarray([floats[a, k, j, b] for a, k, b in picks],
                               np.float64) for j, f in enumerate(FLOATS)})
    port.update({f: np.asarray([errors[a, k, j, b] for a, k, b in picks],
                               np.float64) for j, f in enumerate(ERRORS)})
    t_ref = time.perf_counter()
    ref = reference_pairs(cell, ring, seeds, picks, batch, scan, dev)
    print(f"reference: {len(picks)} pairs in "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    # the one host read of the window against the pairs it folded
    compared = compare(port, ref, tr["limits"]) + [result.Compared(
        "accumulator_differs",
        float(acc_ok != bool(ok_flat.all()) or n_pairs != ok_flat.size),
        0.0)]

    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    # both mixed slots of every pair count
    return Outcome(
        attempted=2 * n_pairs, failed=2 * len(failed),
        end_to_end={"mixed_slot_us": 1e6 * window / (2 * n_pairs),
                    "setup_s": t_start - t0},
        compared=compared, device=device_info, spans=spans,
        trace=stretch.result if stretch is not None else None)


def kernel_shapes(cell, seed: int, device: str | None = None) -> dict:
    """The LDPC decoder launches of one batch of pairs with the work they
    need: the two rv=0 launches on the truncated graph (``ldpc_dec``) and
    the two full-graph launches of the combined buffers
    (``ldpc_dec_full``), each shape's rows, lifting size, message and
    codeword bits, used variable blocks and edges, and the mean layered
    min-sum sweeps that the reference's plain decoder needs on the cell's
    own seeded buffers (one batch of the first payload set and the first
    dispatch's noise).  Run once when the cell is defined; the result goes
    into the cell's traffic file."""
    from ranbench.reference.ops.ldpc import decoder
    from ranbench.reference.ops.ldpc.graphs import lifted_graph
    from ranbench.reference.phy.upper import sch as ref_sch
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    rcfg = ref_config(cell)
    ul_snr, rv = harq_link(cell)
    batch = cell.traffic["pairs_per_batch"]
    ring = mixed.payload_ring(rcfg, seed, 1, batch, dev)
    noise = dispatch_noise(rcfg, ul_snr, batch,
                           mixed.dispatch_seed(seed, 0), dev)
    f1, f2 = ref_harq.fronts(ring[0], noise, rcfg, rv)
    comb = ref_harq.combined_llrs(f1, f2)
    cfg2 = ref_harq.retx_config(rcfg, rv)

    def shape(sh, llr):
        seg = sh.segments
        z, bg = seg.lifting_size, seg.base_graph
        g = lifted_graph(bg, z)
        used = ref_sch.used_blocks(sh)
        _, n, _, edges = decoder._schedule(bg, z, used)
        sweeps = decoder.sweeps_needed(
            llr.reshape(-1, llr.shape[-1]), bg, z,
            nof_iterations=rcfg.nof_ldpc_iterations, nof_used_blocks=used)
        return {"rows": batch * seg.nof_segments, "z": z, "base_graph": bg,
                "k": g.nof_msg_blocks * z, "n": g.nof_var_blocks * z,
                "used_blocks": n, "edges": edges,
                "sweeps": float(sweeps.double().mean())}

    match = "ldpc_decode_kernel"
    return {"ldpc_dec": {"match": match, "per_batch": [
                shape(rcfg.pusch0, f1["u0"].llr_full),
                shape(rcfg.pusch1, f1["u1"].llr_full)]},
            "ldpc_dec_full": {"match": match, "per_batch": [
                shape(cfg2.pusch0, comb["u0"]),
                shape(cfg2.pusch1, comb["u1"])]}}


def control(cell, seed: int, dispatches: int = 4,
            device: str | None = None) -> list[result.Compared]:
    """The control of the comparison: the reference one precision below
    (bfloat16 at every stage boundary) put in the program's place, on the
    pairs a run of `dispatches` dispatches would sample, judged against
    the float64 reference by the cell's limits."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = cell.traffic
    batch, scan = tr["pairs_per_batch"], tr["scan_batches"]
    rcfg = ref_config(cell)
    ring = mixed.payload_ring(rcfg, seed, PAYLOAD_SETS, batch, dev)
    seeds = [mixed.dispatch_seed(seed, i) for i in range(dispatches)]
    picks = mixed._pick(np.random.default_rng(seed), dispatches, scan, batch,
                        SAMPLE_PAIRS, [])
    ref = reference_pairs(cell, ring, seeds, picks, batch, scan, dev)
    low = reference_pairs(cell, ring, seeds, picks, batch, scan, dev,
                          lower=True)
    return compare(low, ref, tr["limits"])
