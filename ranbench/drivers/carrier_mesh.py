"""Traffic kind ``carrier_mesh``: the flagship loopback of many carriers
split over the cards of one server, one rank per card, through the
program's ``gnb_flagship.sharded_multi_carrier_step``.

The parent checks that the program's step returns its decoded-TB bit
errors (a one-carrier step on the CPU), builds the kernel library once and
spawns the ranks (``parallel.launch.spawn``: NCCL, a card each; gloo on the
CPU for the tests).  Each rank makes the same ``INPUT_SETS`` global input
sets (TB payloads and channel noise of every carrier) on its own device
from the seed, warms the step up, and times a few steps; rank 0 turns that
time into the window's step count and broadcasts it, so that every rank
runs the same steps.  The window runs the steps back to back on the input
sets in turn, at most ``DEPTH`` in flight; each step's gathered (ok, SINR,
bit errors) of every carrier lands in rank 0's record.  Rank 0's window
(its first timed step to its last step done) over the carrier-slots
completed on all ranks is the cell's ``mixed_slot_us``; set-up runs from
the first line of ``run.py`` to rank 0's first timed step (the parent's and
the ranks' ``time.perf_counter`` read one system-wide monotonic clock).

After the window the parent samples carriers from the seed (at least
``PER_RANK`` from each rank's share), joins every carrier the program got
wrong, and runs them through the reference on the same payloads and noise,
each at its global index: a mis-ordered gather reads another carrier's
SINR.

Traffic file keys: ranks, carriers, trace_steps, limits {verdicts_differ,
sinr_gap_db}, kernels {ldpc_dec, ldpc_enc: {match, per_batch: [shape]}}
(the shapes of one rank's step).
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
from ranbench.reference import precision
from ranbench.reference.models import gnb_flagship as ref_flagship

DEPTH = 2            # steps in flight
INPUT_SETS = 4       # distinct global input sets, cycled over the steps
SAMPLE_CARRIERS = 24  # carriers of a run held against the reference
PER_RANK = 4         # of them at least this many from each rank's share
WARMUP_STEPS = 2     # untimed steps of set-up
PROBE_STEPS = 4      # timed steps of set-up that size the window


def ref_config(cell) -> ref_flagship.CarrierConfig:
    return ref_flagship.default_carrier(**cell.config["args"])


def set_seed(seed: int, s: int) -> int:
    """The generator seed of input set s of a run."""
    return (seed * 1_000_003 + 7_919 * (s + 1)) % (1 << 62)


def input_set(rcfg, seed: int, s: int, carriers: int,
              snr_db: float, device: torch.device):
    """Input set s: TB payloads [carriers, A] int8 and channel noise
    [carriers, slot_samples] complex64 with sqrt(nfft)·10^(-snr/20) per
    sample (the per-RE SNR after the receiver's DFT), drawn in one
    generator on the device."""
    g = torch.Generator(device=device)
    g.manual_seed(set_seed(seed, s))
    tb = torch.randint(0, 2, (carriers, rcfg.sh.tbs), generator=g,
                       device=device, dtype=torch.int8)
    sigma = math.sqrt(rcfg.nfft) * 10.0 ** (-snr_db / 20.0)
    nz = torch.randn((2, carriers, rcfg.slot_samples), generator=g,
                     device=device, dtype=torch.float32)
    nz = nz * (sigma / math.sqrt(2.0))
    return tb, torch.complex(nz[0], nz[1])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_main(rank: int, device: torch.device, spec: dict) -> dict:
    """One rank of the cell (``launch.spawn``'s ``fn``): set-up, the step
    count from rank 0, the window.  Rank 0 returns the record of every
    step's gathered outputs, its window, set-up time, peak memory and, when
    traced, the reduction of its profiled stretch."""
    import torch.distributed as dist

    from ranbench.harness.trace import Stretch
    from srsran_project_23_5_tpu_torch.models import gnb_flagship
    from srsran_project_23_5_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device.type == "cuda"
    rcfg = ref_flagship.default_carrier(**spec["args"])
    cfg = gnb_flagship.default_carrier(**spec["args"])
    if (cfg.sh.tbs, cfg.slot_samples) != (rcfg.sh.tbs, rcfg.slot_samples):
        raise RuntimeError("the program sizes the carrier otherwise")
    carriers = spec["carriers"]
    mesh = mesh_lib.make_mesh(device=device)
    step = gnb_flagship.sharded_multi_carrier_step(
        mesh, cfg, spec["nof_ldpc_iterations"])
    sets = [input_set(rcfg, spec["seed"], s, carriers, spec["snr_db"],
                      device) for s in range(INPUT_SETS)]
    inflight = collections.deque()

    def run_step(i: int):
        out = step(*sets[i % INPUT_SETS])
        if on_card:
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
            if len(inflight) >= DEPTH:
                inflight.popleft().synchronize()
        return out

    for i in range(WARMUP_STEPS):
        run_step(i)
    _sync(device)
    t = time.perf_counter()
    for i in range(PROBE_STEPS):
        run_step(i)
    _sync(device)
    per_step = (time.perf_counter() - t) / PROBE_STEPS
    trace_steps = spec["trace_steps"] if spec["trace"] else 0
    count_dev = device if dist.get_backend() == "nccl" else torch.device(
        "cpu")
    count = torch.tensor([max(1, math.ceil(spec["seconds"] / per_step),
                              trace_steps + 2)], dtype=torch.int64,
                         device=count_dev)
    dist.broadcast(count, src=0)
    steps = int(count.item())

    record = rank == 0
    if record:
        rec_ok = torch.zeros((steps, carriers), dtype=torch.bool,
                             device=device)
        rec_sinr = torch.zeros((steps, carriers), dtype=torch.float32,
                               device=device)
        rec_err = torch.full((steps, carriers), -1, dtype=torch.int32,
                             device=device)
    stretch = None
    if record and trace_steps:
        first = min(steps // 4, steps - trace_steps - 1)
        stretch = Stretch(spec["trace_path"], Spans(), first, trace_steps,
                          lambda: _sync(device))
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    dist.barrier(**({"device_ids": [device.index]} if on_card else {}))
    _sync(device)
    t_start = time.perf_counter()
    for i in range(steps):
        if stretch is not None:
            stretch.before(i)
        ok, sinr, errors = run_step(i)
        if record:
            rec_ok[i].copy_(ok)
            rec_sinr[i].copy_(sinr)
            rec_err[i].copy_(errors)
        if stretch is not None:
            stretch.after(i)
    _sync(device)
    t_end = time.perf_counter()
    if not record:
        return {"steps": steps}
    return {"steps": steps, "window_s": t_end - t_start,
            "setup_s": t_start - spec["t0"], "ok": rec_ok,
            "sinr": rec_sinr, "bit_errors": rec_err,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
            if on_card else 0,
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "trace": stretch.result if stretch is not None else None}


def rank_program():
    """``rank_main`` under the name a spawned rank imports it by (the cell
    loads this file under another)."""
    from ranbench.drivers.carrier_mesh import rank_main
    return rank_main


def check_program() -> None:
    """Raise unless the program's carrier step returns its decoded-TB bit
    errors: one tiny carrier on the CPU, before any rank is spawned."""
    from srsran_project_23_5_tpu_torch.models import gnb_flagship
    cfg = gnb_flagship.tiny_carrier()
    tb, noise = input_set(cfg, 1, 0, 1, 20.0, torch.device("cpu"))
    out = gnb_flagship.multi_carrier_step(cfg, 1)(tb, noise)
    if len(out) != 3:
        raise RuntimeError("the program's multi_carrier_step returns no "
                           "per-carrier bit_errors")


def reference_carriers(rcfg, seed: int, picks, carriers: int, snr_db: float,
                       iterations: int, device: torch.device,
                       lower: bool = False) -> dict:
    """The reference on the picked carriers [(step i, carrier c)], each on
    its input set's row c → {ok, sinr, bit_errors: [n] float}.  `lower`: the
    reference one precision below (the control)."""
    rows = {}
    by_set = collections.defaultdict(set)
    for i, c in picks:
        by_set[i % INPUT_SETS].add(c)
    for s, cs in sorted(by_set.items()):
        cs = sorted(cs)
        tb, noise = input_set(rcfg, seed, s, carriers, snr_db, device)
        idx = torch.tensor(cs, device=device)
        with precision.bfloat16() if lower else contextlib.nullcontext():
            ok, _, sinr, err = ref_flagship.loopback_batch(
                tb[idx], noise[idx], rcfg, iterations)
        del tb, noise
        for j, c in enumerate(cs):
            rows[(s, c)] = (float(ok[j]), float(sinr[j]), float(err[j]))
    got = np.asarray([rows[(i % INPUT_SETS, c)] for i, c in picks],
                     np.float64).reshape(-1, 3)
    return {"ok": got[:, 0], "sinr": got[:, 1], "bit_errors": got[:, 2]}


def compare(port: dict, ref: dict, limits: dict) -> list[result.Compared]:
    """Carriers whose verdict or decoded-TB bit errors differ (count), and
    the widest SINR gap (dB)."""
    differ = (port["ok"] != ref["ok"]) | (port["bit_errors"]
                                          != ref["bit_errors"])
    sinr = float(np.max(np.abs(port["sinr"] - ref["sinr"])))
    return [result.Compared("verdicts_differ", float(differ.sum()),
                            float(limits["verdicts_differ"])),
            result.Compared("sinr_gap_db", sinr,
                            float(limits["sinr_gap_db"]))]


def pick(rng, steps: int, carriers: int, ranks: int, failed
         ) -> list[tuple[int, int]]:
    """(step, carrier) pairs: PER_RANK from each rank's share of the
    carriers, the rest of SAMPLE_CARRIERS from all, all from the seed's
    generator; then up to SAMPLE_CARRIERS of the `failed` flat indices."""
    share = carriers // ranks
    idx = set()
    for r in range(ranks):
        flat = rng.choice(steps * share, size=min(PER_RANK, steps * share),
                          replace=False)
        idx |= {int(f // share) * carriers + r * share + int(f % share)
                for f in flat}
    rest = SAMPLE_CARRIERS - len(idx)
    total = steps * carriers
    while rest > 0 and len(idx) < total:
        idx |= {int(j) for j in rng.choice(total, size=min(rest, total),
                                           replace=False)}
        rest = SAMPLE_CARRIERS - len(idx)
    idx |= set(failed[:SAMPLE_CARRIERS])
    return [(j // carriers, j % carriers) for j in sorted(idx)]


def _spec(cell, seed: int) -> dict:
    conf = cell.config
    return {"args": conf["args"], "snr_db": float(conf["snr_db"]),
            "nof_ldpc_iterations": int(conf["nof_ldpc_iterations"]),
            "carriers": int(cell.traffic["carriers"]), "seed": seed}


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str | None = None) -> Outcome:
    from srsran_project_23_5_tpu_torch.parallel import launch
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    on_card = dev.type == "cuda"
    tr = cell.traffic
    ranks = int(tr["ranks"])
    spec = _spec(cell, seed)
    if spec["carriers"] % ranks:
        raise ValueError(f"{spec['carriers']} carriers over {ranks} ranks")
    check_program()
    if on_card:
        from srsran_project_23_5_tpu_torch.utils import kernels
        kernels.library()       # built once here, loaded by every rank
    spec.update(seconds=seconds, trace=trace, t0=t0,
                trace_steps=int(tr["trace_steps"]),
                trace_path=str(cell.root / "build" / "ranbench"
                               / "trace.json"))
    got = launch.spawn(ranks, rank_program(), spec,
                       backend="nccl" if on_card else "gloo",
                       device=None if on_card else dev,
                       timeout_s=300.0 + 3.0 * seconds)
    r0 = got[0]
    steps, carriers = r0["steps"], spec["carriers"]
    if any(r["steps"] != steps for r in got):
        raise RuntimeError(f"ranks ran {[r['steps'] for r in got]} steps")
    if on_card:
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = r0["ok"].numpy()
    sinr = r0["sinr"].numpy()
    errors = r0["bit_errors"].numpy()
    failed = np.flatnonzero(~ok.reshape(-1)
                            | (errors.reshape(-1) != 0)).tolist()
    picks = pick(np.random.default_rng(seed), steps, carriers, ranks,
                 failed)
    port = {"ok": np.asarray([ok[i, c] for i, c in picks], np.float64),
            "sinr": np.asarray([sinr[i, c] for i, c in picks], np.float64),
            "bit_errors": np.asarray([errors[i, c] for i, c in picks],
                                     np.float64)}
    t_ref = time.perf_counter()
    rcfg = ref_config(cell)
    ref = reference_carriers(rcfg, seed, picks, carriers, spec["snr_db"],
                             spec["nof_ldpc_iterations"], dev)
    print(f"reference: {len(picks)} carriers in "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    compared = compare(port, ref, tr["limits"])
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": r0["kind"], "count": ranks,
                   "memory_peak_bytes": int(r0["memory_peak_bytes"])}
    return Outcome(
        attempted=steps * carriers, failed=len(failed),
        end_to_end={"mixed_slot_us": 1e6 * r0["window_s"]
                    / (steps * carriers),
                    "setup_s": r0["setup_s"]},
        compared=compared, device=device_info, spans=Spans(),
        trace=r0["trace"])


def kernel_shapes(cell, seed: int, device: str | None = None) -> dict:
    """The LDPC launches of one rank's step with the work they need: rows,
    lifting size, message and codeword bits, used variable blocks and
    edges, and for the decoder the mean layered min-sum sweeps that the
    reference's plain decoder needs on rank 0's carriers of the first input
    set.  Run once when the cell is defined; the result goes into the
    cell's traffic file."""
    from ranbench.reference.ops.ldpc import decoder
    from ranbench.reference.ops.ldpc.graphs import lifted_graph
    from ranbench.reference.phy.upper import sch as ref_sch
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = _spec(cell, seed)
    rcfg = ref_config(cell)
    per_rank = spec["carriers"] // int(cell.traffic["ranks"])
    tb, noise = input_set(rcfg, seed, 0, spec["carriers"], spec["snr_db"],
                          dev)
    sh = rcfg.sh
    seg = sh.segments
    z, bg = seg.lifting_size, seg.base_graph
    g = lifted_graph(bg, z)
    used = ref_sch.used_blocks(sh)
    _, n, _, edges = decoder._schedule(bg, z, used)
    shape = {"rows": per_rank * seg.nof_segments, "z": z, "base_graph": bg,
             "k": g.nof_msg_blocks * z, "n": g.nof_var_blocks * z}
    sweeps = []
    for lo in range(0, per_rank, 16):
        hi = min(lo + 16, per_rank)
        d = ref_sch.pusch_demodulate(
            ref_flagship.rx_grid(tb[lo:hi], noise[lo:hi], rcfg), sh)
        llr = d.llr_full
        sweeps.append(decoder.sweeps_needed(
            llr.reshape(-1, llr.shape[-1]), bg, z,
            nof_iterations=spec["nof_ldpc_iterations"],
            nof_used_blocks=used).double())
    dec = dict(shape, used_blocks=n, edges=edges,
               sweeps=float(torch.cat(sweeps).mean()))
    return {"ldpc_dec": {"match": "ldpc_decode_kernel", "per_batch": [dec]},
            "ldpc_enc": {"match": "ldpc_encode_kernel",
                         "per_batch": [shape]}}


def control(cell, seed: int, steps: int = 8,
            device: str | None = None) -> list[result.Compared]:
    """The control of the comparison: the reference one precision below
    (bfloat16 at every stage boundary) put in the program's place, on the
    carriers a run of `steps` steps would sample, judged against the
    float32 reference by the cell's limits."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = _spec(cell, seed)
    rcfg = ref_config(cell)
    picks = pick(np.random.default_rng(seed), steps, spec["carriers"],
                 int(cell.traffic["ranks"]), [])
    args = (rcfg, seed, picks, spec["carriers"], spec["snr_db"],
            spec["nof_ldpc_iterations"], dev)
    ref = reference_carriers(*args)
    low = reference_carriers(*args, lower=True)
    return compare(low, ref, cell.traffic["limits"])
