"""Entry points of the port: the forward step of the flagship slot,
the carrier-sharded mixed step, the multi-rank dry run and its
weak-scaling curve.

Counterpart of ``__graft_entry__.py`` at the repository root.  JAX runs the
mesh in one process; here ``dryrun_multichip`` spawns one rank per carrier
shard (``parallel/launch.py``).  The functions named ``*_check`` are rank
programs, ``fn(rank, device, ...)`` for ``launch.spawn`` (or rank 0 of
``launch.world_of_one``): each builds its mesh over the world, runs one
path and returns host-side results, with every LDPC kernel call tapped.

    python -m srsran_project_23_5_tpu_torch.entry 4 --backend gloo \\
        --device cuda:0        # four ranks sharing one card
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .models import gnb_flagship, gnb_mixed
from .ops import prach as prach_ops
from .parallel import launch
from .parallel import mesh as mesh_lib
from .parallel import slot_stream
from .phy.lower import ofdm, prach_demod
from .phy.upper import csi_rs as csi_rs_proc
from .phy.upper import pdcch as pdcch_proc
from .phy.upper import sch
from .phy.upper import ssb as ssb_proc
from .ran import numerology
from .ran.constants import NRE
from .utils import kernel_taps

TIMED_STEPS = 3          # synchronised repeats behind each step time
CURVE_STEPS = 7          # ... behind each point of the weak-scaling curve,
                         # as in the JAX dry run's curve


def entry(cfg: gnb_mixed.MixedSlotConfig | None = None,
          device: torch.device | str | None = None):
    """(fn, example_args): the forward step of the flagship pipeline.

    fn assembles a full mixed downlink slot (default: the 100 MHz, 273-PRB
    carrier of ``gnb_mixed.default_mixed``) — PDCCH (2 DCIs) + SSB +
    NZP-CSI-RS + a 2-layer MIMO PDSCH + a second PDSCH UE — onto a 2-port
    resource grid and OFDM-modulates it: payloads [B, n] → baseband
    [B, 2, slot_samples].  The example arguments are one slot's payloads
    on `device` (default: the current CUDA device).
    """
    cfg = cfg or gnb_mixed.default_mixed()
    p = gnb_mixed.make_payloads(cfg, np.random.default_rng(0), 1, device)

    def fn(tb0, tb1, dci_dl, dci_ul, pbch):
        bsz, dev = tb0.shape[0], tb0.device
        grid = torch.zeros((bsz, 2, 14, cfg.nsc), dtype=torch.complex64,
                           device=dev)
        grid = sch.pdsch_transmit(tb0, cfg.pdsch0, grid)
        g2d = torch.zeros((bsz, 14, cfg.nsc), dtype=torch.complex64,
                          device=dev)
        g2d = sch.pdsch_transmit(tb1, cfg.pdsch1, g2d)
        g2d = pdcch_proc.pdcch_transmit(dci_dl, cfg.pdcch_dl, g2d)
        g2d = pdcch_proc.pdcch_transmit(dci_ul, cfg.pdcch_ul, g2d)
        lo = cfg.ssb_prb_start * NRE
        g2d[:, 2:6, lo:lo + ssb_proc.SSB_NSC] = ssb_proc.ssb_assemble(
            pbch, cfg.ssb)
        g2d = csi_rs_proc.generate(cfg.csi_rs, g2d)
        grid[:, 0] += g2d
        return ofdm.modulate_slot(grid, cfg.mu, cfg.nfft)

    return fn, (p["tb_dl0"], p["tb_dl1"], p["dci_dl"], p["dci_ul"],
                p["pbch"])


def mixed_carrier_step(cfg: gnb_mixed.MixedSlotConfig, mesh):
    """The carrier-sharded full mixed slot step: (payloads {name: [C, n]},
    seeds [C], noise=None) → (ok [C], sinr [C]), every input global (each
    rank holds it) and the carrier axis split over `mesh`.

    Each rank runs its carriers one by one through
    ``gnb_mixed.slot_fn_for_pipeline(cfg)`` on its own device, each on the
    noise its seed draws from a ``torch.Generator``, or on noise=(dl, ul)
    [C, 2, slot_samples] when given, and the verdicts are gathered."""
    run, draw = gnb_mixed.slot_fn_for_pipeline(cfg)
    shard = mesh_lib.carrier_sharding(mesh)
    dev = mesh_lib.mesh_device(mesh)

    def step(payloads: dict, seeds: torch.Tensor, noise=None):
        local = {k: shard.local(v) for k, v in payloads.items()}
        if noise is None:
            draws = [draw(1, torch.Generator(device=dev).manual_seed(int(s)))
                     for s in shard.local(seeds).tolist()]
            nz_dl = torch.cat([d[0] for d in draws])
            nz_ul = torch.cat([d[1] for d in draws])
        else:
            nz_dl, nz_ul = shard.local(noise[0]), shard.local(noise[1])
        res = [run({k: v[c] for k, v in local.items()}, nz_dl[c], nz_ul[c])
               for c in range(nz_dl.shape[0])]
        ok = torch.stack([r[0] for r in res])
        sinr = torch.stack([r[1] for r in res])
        return shard.gather(ok), shard.gather(sinr)
    return step


def global_verdict(ok: torch.Tensor, sinr: torch.Tensor, mesh
                   ) -> tuple[bool, float]:
    """(all(ok), mean(sinr)) over the carriers of every rank on `mesh`'s
    carrier axis, from each rank's own (local) ok and sinr: one all-reduce,
    so every rank gets the same answer."""
    group = mesh.get_group(mesh_lib.CARRIER_AXIS)
    t = torch.stack([(~ok.bool()).sum().double(), sinr.double().sum(),
                     torch.tensor(float(ok.numel()), dtype=torch.float64,
                                  device=ok.device)])
    if mesh_lib.host_staged(group, t):
        t = t.cpu()
    dist.all_reduce(t, group=group)
    return bool(t[0] == 0), float(t[1] / t[2])


def _step_times(fn, device: torch.device, steps: int) -> list[float]:
    """Synchronised host times (ms) of fn(r) for r = 0 .. steps-1, each
    call begun by every rank together (a barrier), so that a collective
    inside fn does not time a late peer."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    times = []
    for r in range(steps):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        fn(r)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _step_ms(fn, device: torch.device) -> float:
    """Median of fn()'s ``_step_times`` over TIMED_STEPS calls."""
    return float(np.median(_step_times(lambda r: fn(), device, TIMED_STEPS)))


def _tapped(fn, device: torch.device) -> tuple:
    """fn() with every LDPC kernel call tapped and the launch counters
    set to 0 just before and read just after: (out, {"launches",
    "calls", "mismatches"}), the last the calls that differ from the
    plain version."""
    with kernel_taps.tapped_kernels() as sink:
        kernel_taps.reset_launch_counts()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        launches = kernel_taps.launch_counts()
    return out, {"launches": launches, "calls": sink.eager,
                 "mismatches": kernel_taps.mismatches(sink.eager)}


# ------------------------------------------------------------ rank programs

def mesh_report(rank: int, device: torch.device, stream: np.ndarray,
                halo: int) -> dict:
    """This rank's coordinates on ``make_mesh()`` and on the ("slot",
    "carrier") mesh of (world/2, 2) ranks (when the world is even), and
    ``halo_from_prev`` on its slot of `stream` [world, samples] over a
    slot mesh of every rank."""
    world = dist.get_world_size()
    out = {"coord_1d": mesh_lib.make_mesh(device=device).get_coordinate()}
    if world % 2 == 0:
        out["coord_2d"] = mesh_lib.make_mesh_2d(
            world // 2, 2, device).get_coordinate()
    smesh = mesh_lib.make_mesh_2d(world, 1, device)
    x = slot_stream.slot_stream_sharding(smesh).local(torch.from_numpy(stream))
    out["halo"] = mesh_lib.halo_from_prev(x, halo, smesh, mesh_lib.SLOT_AXIS)
    return out


def carrier_step_check(rank: int, device: torch.device,
                       cfg: gnb_flagship.CarrierConfig, tb: torch.Tensor,
                       noise: torch.Tensor, nof_ldpc_iterations: int = 6
                       ) -> dict:
    """``sharded_multi_carrier_step`` over every rank on global ([C, A],
    [C, slot_samples]) inputs (tapped, counted), the unsharded
    ``multi_carrier_step`` on the same inputs, and the sharded step's
    time."""
    mesh = mesh_lib.make_mesh(device=device)
    sharded = gnb_flagship.sharded_multi_carrier_step(mesh, cfg,
                                                      nof_ldpc_iterations)
    (ok, sinr, errors), taps = _tapped(lambda: sharded(tb, noise), device)
    ok_ref, sinr_ref, errors_ref = gnb_flagship.multi_carrier_step(
        cfg, nof_ldpc_iterations)(tb.to(device), noise.to(device))
    return {"ok": ok, "sinr": sinr, "bit_errors": errors, "ok_ref": ok_ref,
            "sinr_ref": sinr_ref, "bit_errors_ref": errors_ref, **taps,
            "step_ms": _step_ms(lambda: sharded(tb, noise), device)}


def mixed_step_check(rank: int, device: torch.device,
                     cfg: gnb_mixed.MixedSlotConfig, payloads: dict,
                     seeds: torch.Tensor, noise=None,
                     steps: int = TIMED_STEPS) -> dict:
    """``mixed_carrier_step`` over every rank (tapped, counted) and its
    ``global_verdict``, then `steps` timed steps, step r on seeds + r (as
    the JAX curve times them; `noise`, when given, is the same on each):
    their times (ms), their median, whether every carrier of every timed
    step was ok, and (on a card) the process's peak reserved device
    memory."""
    mesh = mesh_lib.make_mesh(device=device)
    step = mixed_carrier_step(cfg, mesh)
    (ok, sinr), taps = _tapped(lambda: step(payloads, seeds, noise),
                               device)
    shard = mesh_lib.carrier_sharding(mesh)
    verdict = global_verdict(shard.local(ok), shard.local(sinr), mesh)
    timed_ok = []
    times = _step_times(
        lambda r: timed_ok.append(step(payloads, seeds + r, noise)[0]),
        device, steps)
    return {"ok": ok, "sinr": sinr, **taps, "verdict": verdict,
            "step_times": times, "step_ms": float(np.median(times)),
            "steps_ok": all(bool(o.all()) for o in timed_ok),
            "peak_reserved": (torch.cuda.max_memory_reserved(device)
                              if device.type == "cuda" else None)}


class PrachGeometry(NamedTuple):
    """A PRACH occasion per slot of a baseband stream: the window begins at
    `start` (negative: in the previous slot)."""
    slot_samples: int
    prach_fft: int
    length: int
    cp: int
    start: int
    freq_offset: int
    root: int
    n_cs: int
    shift: int                  # the preamble sent (cyclic-shift index)


# the short case of tests/test_slot_stream.py
SHORT_PRACH = PrachGeometry(1024, 512, 139, 72, -40, 0, 22, 13, 4)
STREAM_SEED = 7


def format0_prach(mu: int, nfft: int) -> PrachGeometry:
    """The format-0 long preamble at the carrier's rate: the 0.9 ms window
    (prach_fft + cp samples) is longer than the 0.5 ms slot, so it begins
    at −0.9 slots, in the previous slot."""
    fft, _, cp = prach_demod.long_format_geometry(
        "0", numerology.sample_rate_hz(mu, nfft))
    slot = numerology.slot_num_samples(mu, nfft)
    return PrachGeometry(slot, fft, 839, cp, -(9 * slot) // 10, 12, 22, 13,
                         7)


def prach_stream(g: PrachGeometry, n_slots: int, seed: int) -> np.ndarray:
    """[n_slots, slot_samples] complex64 baseband: low noise from `seed` and
    one preamble per slot whose window begins at g.start (slot 0's window
    would begin before the stream and has none)."""
    rng = np.random.default_rng(seed)
    n = n_slots * g.slot_samples
    flat = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    bins = np.zeros(g.prach_fft, np.complex64)
    bins[g.freq_offset:g.freq_offset + g.length] = prach_ops.generate(
        g.root, g.shift, g.length, g.n_cs)
    pre_td = np.fft.ifft(bins).astype(np.complex64) * g.prach_fft
    burst = np.concatenate([pre_td[-g.cp:], pre_td])
    for i in range(n_slots):
        s0 = i * g.slot_samples + g.start
        if s0 >= 0:
            flat[s0:s0 + burst.size] += burst
    return flat.astype(np.complex64).reshape(n_slots, g.slot_samples)


def slot_stream_check(rank: int, device: torch.device, g: PrachGeometry
                      ) -> dict:
    """``sharded_prach_windows`` over a slot mesh of every rank, one slot
    each, on ``prach_stream(g, world, STREAM_SEED)``: the windows, their
    largest error relative to the unsharded ``demodulate`` of the flat
    stream (slot 0's window wraps around it, as the ring does), the
    detection on each, and the halo exchange's time."""
    world = dist.get_world_size()
    smesh = mesh_lib.make_mesh_2d(world, 1, device)
    stream = torch.from_numpy(prach_stream(g, world, STREAM_SEED))
    local = slot_stream.slot_stream_sharding(smesh).local(stream)
    wins = slot_stream.sharded_prach_windows(
        local, smesh, g.start, g.prach_fft, g.length, g.freq_offset, g.cp)
    need = g.cp + g.prach_fft
    first = rank * g.slot_samples + g.start
    idx = torch.arange(first, first + need) % stream.numel()
    ref = prach_demod.demodulate(stream.reshape(-1)[idx].to(device)[None],
                                 g.prach_fft, g.length, g.freq_offset, g.cp)
    metric, _, _ = prach_ops.detect(wins, g.root, g.length, g.n_cs)
    halo = -g.start
    return {"windows": wins,
            "rel_err": float((wins - ref).abs().max() / ref.abs().max()),
            "argmax": metric.argmax(dim=-1), "metric": metric[:, g.shift],
            "has_preamble": rank > 0,
            "halo_ms": _step_ms(lambda: mesh_lib.halo_from_prev(
                local.reshape(-1), halo, smesh, mesh_lib.SLOT_AXIS),
                device)}


def slot_stream_verdict(g: PrachGeometry, ranks: list[dict]) -> str:
    """Raises unless every rank's windows equal the unsharded ones (1e-4
    relative) and the preamble is detected on every slot that has one."""
    for r, res in enumerate(ranks):
        if res["rel_err"] > 1e-4:
            raise AssertionError(f"rank {r}: windows off the unsharded "
                                 f"demodulation by {res['rel_err']:.2e}")
        if res["has_preamble"] and not (int(res["argmax"][0]) == g.shift
                                        and float(res["metric"][0]) > 16.0):
            raise AssertionError(f"rank {r}: preamble {g.shift} sent, "
                                 f"argmax {int(res['argmax'][0])}, metric "
                                 f"{float(res['metric'][0]):.1f}")
    metric = min(float(r["metric"][0]) for r in ranks if r["has_preamble"])
    return (f"slot_stream_prach({len(ranks)} shards, L={g.length}, "
            f"window {g.cp + g.prach_fft} from {g.start}): boundary windows "
            f"detected, metric>={metric:.0f}, max rel err "
            f"{max(r['rel_err'] for r in ranks):.1e}; halo exchange ms per "
            f"rank {[round(r['halo_ms'], 3) for r in ranks]}")


def mixed_verdict(cfg: gnb_mixed.MixedSlotConfig, mixed: list[dict]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gathered (ok, sinr) of ``mixed_step_check``'s results, one per
    rank.  Raises unless the ranks gathered the same verdicts, every
    carrier is ok (on the tapped step and on every timed one), the mean SINR is within 1.5 dB of the SNR, every LDPC
    kernel launch equals its plain version and ``global_verdict`` is the
    same on every rank and agrees with the gathered verdicts."""
    ok, sinr = mixed[0]["ok"], mixed[0]["sinr"]
    if not all(torch.equal(m["ok"], ok) and torch.equal(m["sinr"], sinr)
               for m in mixed):
        raise AssertionError("the ranks gathered different verdicts")
    if not ok.all():
        raise AssertionError(f"mixed loopback failed on some carriers: {ok}")
    if not all(m["steps_ok"] for m in mixed):
        raise AssertionError("a timed step failed on some carriers")
    if abs(float(sinr.mean()) - cfg.snr_db) >= 1.5:
        raise AssertionError(f"mean SINR {float(sinr.mean()):.2f} dB at "
                             f"{cfg.snr_db} dB")
    bad = {r: m["mismatches"] for r, m in enumerate(mixed)
           if m["mismatches"]}
    if bad:
        raise AssertionError(f"LDPC launches that differ from the plain "
                             f"version (rank: calls): {bad}")
    verdicts = {m["verdict"] for m in mixed}
    if len(verdicts) != 1:
        raise AssertionError(f"the ranks' global verdicts differ: {verdicts}")
    all_ok, mean = verdicts.pop()
    if not all_ok or abs(mean - float(sinr.double().mean())) > 1e-9:
        raise AssertionError(f"global verdict ({all_ok}, {mean}) for "
                             f"ok={ok.tolist()}, sinr={sinr.tolist()}")
    return ok, sinr


def weak_scaling(n_devices: int, backend: str = "nccl",
                 device: torch.device | str | None = None,
                 cfg: gnb_mixed.MixedSlotConfig | None = None) -> list[dict]:
    """The weak-scaling curve of the carrier-sharded mixed step (the
    counterpart of the curve in ``__graft_entry__._dryrun_bonus``): one
    carrier per rank (default: the 273-PRB carrier of ``default_mixed``),
    payloads from ``make_payloads(cfg, default_rng(1), n)``, at n = 1,
    min(cards, n_devices), max(2, n_devices // 2) and n_devices ranks.
    "cards" counts the devices the ranks are spread over (``backend`` and
    ``device`` as for ``launch.spawn``: one ``cuda:i`` puts every gloo rank
    on that card).  Each point is one ``launch.spawn`` of
    ``mixed_step_check``, the points one after another; each rank times
    CURVE_STEPS synchronised steps after its tapped one, step r on seeds +
    r, as the JAX curve does.

    A point's time is the largest of its ranks' median step times (a step
    ends when its slowest rank does); the efficiency is t1 / tn.  Every
    point must pass ``mixed_verdict``.  Prints the curve in the JAX dry
    run's format with a note of the cards, the backend and the points that
    put several ranks on one device (contention, not a scaling figure),
    then for each point every rank's median and min-max step time, its
    spawn-and-run seconds and peak reserved memory per rank.

    Unlike the JAX curve there is no wall-clock budget and no point is
    skipped: ``launch.spawn``'s deadline bounds each point, and a point
    that fails, dies or times out raises.  Returns one dict per point:
    {"ranks", "s_per_step", "efficiency", "spawn_s", "results"}."""
    cfg = cfg or gnb_mixed.default_mixed()
    devices = launch.rank_devices(n_devices, backend, device)
    cards = len(set(devices))
    points = sorted(n for n in {1, min(cards, n_devices),
                                max(2, n_devices // 2), n_devices}
                    if n <= n_devices)
    curve = []
    for n in points:
        payloads = gnb_mixed.make_payloads(cfg, np.random.default_rng(1), n,
                                           "cpu")
        t0 = time.perf_counter()
        mixed = launch.spawn(n, mixed_step_check, cfg, payloads,
                             torch.arange(n), None, CURVE_STEPS,
                             backend=backend, device=device)
        spawn_s = time.perf_counter() - t0
        mixed_verdict(cfg, mixed)
        curve.append({"ranks": n, "spawn_s": spawn_s, "results": mixed,
                      "s_per_step": max(m["step_ms"] for m in mixed) / 1e3})
    for p in curve:
        p["efficiency"] = curve[0]["s_per_step"] / p["s_per_step"]
    # rank r of any point runs on devices[r]
    shared = [n for n in points if n > len(set(devices[:n]))]
    note = (f"points {shared} put several ranks on one device: contention, "
            f"not a scaling figure" if shared else "a device per rank")
    print("weak_scaling(ndev, s/step, efficiency): "
          + ", ".join(f"({p['ranks']}, {p['s_per_step']:.3f}, "
                      f"{p['efficiency']:.2f})" for p in curve)
          + f"  [{torch.cuda.device_count()} cards, ranks on "
          f"{', '.join(sorted({str(d) for d in devices}))}, backend "
          f"{backend}; {note}]", flush=True)
    def spread(m):
        return round(min(m["step_times"]), 2), round(max(m["step_times"]), 2)
    print(f"weak_scaling points ({CURVE_STEPS} steps per rank): " + "; ".join(
        f"{p['ranks']} ranks: step ms per rank median "
        f"{[round(m['step_ms'], 2) for m in p['results']]}, min-max "
        f"{[spread(m) for m in p['results']]}, spawn + run "
        f"{p['spawn_s']:.1f} s"
        + ("" if p["results"][0]["peak_reserved"] is None else
           f", peak reserved MiB per rank "
           f"{[round(m['peak_reserved'] / 2**20) for m in p['results']]}")
        for p in curve), flush=True)
    return curve


def dryrun_multichip(n_devices: int, backend: str = "nccl",
                     device: torch.device | str | None = None,
                     cfg: gnb_mixed.MixedSlotConfig | None = None
                     ) -> tuple[list, list[dict]]:
    """Run the FULL MIXED carrier step on `n_devices` ranks, one carrier
    each (default: the 273-PRB, 100 MHz carrier with 2×PDSCH (one 2-layer
    MIMO) + PDCCH×2 + SSB + CSI-RS down and 2×PUSCH (one 2×2) + PUCCH F1 +
    PRACH up), verified in-program at the config's SNR, then the slot-axis
    ring-halo PRACH at the short geometry and the format-0 long one, then
    the ``weak_scaling`` curve of the same step.

    Raises unless the mixed step passes ``mixed_verdict``, every boundary
    window is right and every point of the curve passes; prints one line
    for each, then the curve.  backend and device go to ``launch.spawn``
    (``backend="gloo", device="cuda:0"`` puts every rank on one card).
    Returns (each rank's results: ``mixed_step_check``'s, then
    ``slot_stream_check``'s for both geometries; the curve).
    """
    cfg = cfg or gnb_mixed.default_mixed()
    payloads = gnb_mixed.make_payloads(cfg, np.random.default_rng(0),
                                       n_devices, "cpu")
    seeds = torch.arange(n_devices)
    geoms = (SHORT_PRACH, format0_prach(cfg.mu, cfg.nfft))
    ranks = launch.spawn(
        n_devices, launch.run_all,
        [(mixed_step_check, (cfg, payloads, seeds))]
        + [(slot_stream_check, (g,)) for g in geoms],
        backend=backend, device=device)
    mixed = [r[0] for r in ranks]
    ok, sinr = mixed_verdict(cfg, mixed)
    print(f"dryrun_multichip({n_devices}): ok={ok.tolist()} "
          f"sinr={[round(v, 1) for v in sinr.tolist()]}; ms per carrier "
          f"step per rank {[round(m['step_ms'], 2) for m in mixed]}",
          flush=True)
    for i, g in enumerate(geoms):
        print(slot_stream_verdict(g, [r[1 + i] for r in ranks]), flush=True)
    return ranks, weak_scaling(n_devices, backend, device, cfg)


def main() -> None:
    ap = argparse.ArgumentParser(description=dryrun_multichip.__doc__)
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--backend", default="nccl", choices=launch.BACKENDS)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    dryrun_multichip(args.n, args.backend, args.device)


if __name__ == "__main__":
    main()
