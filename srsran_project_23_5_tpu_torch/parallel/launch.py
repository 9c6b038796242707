"""Start the ranks of a scale-out run (the counterpart of
``jax.distributed.initialize`` and ``tools/multihost_demo.py``'s
worker/main).

``spawn`` runs ``fn(rank, device, *args)`` in ``world_size`` processes
started with the ``spawn`` method (a process that holds a CUDA context must
not fork), each in one ``torch.distributed`` world, and returns what each
rank returned, on the host.  The ranks meet through a ``FileStore`` in a
temporary directory, never a fixed TCP port.  Every collective has a
timeout and the call a deadline: a rank that fails, dies or outlives the
deadline makes the call raise, and every rank still running is killed.

Each rank's device is the caller's choice, never switched silently:
``cuda:rank`` by default (one card per rank), one ``cuda:i`` for every rank
(gloo only: NCCL cannot put two ranks on one GPU), or ``cpu``.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0
BACKENDS = ("gloo", "nccl")


def rank_devices(world_size: int, backend: str,
                 device: torch.device | str | None = None
                 ) -> list[torch.device]:
    """Each rank's device.  device: None or "cuda" → cuda:rank, which needs
    a card per rank; "cuda:i" → cuda:i for every rank (gloo only, unless
    the world is one rank); "cpu" → the CPU (gloo only)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if world_size < 1:
        raise ValueError(f"world size {world_size}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs on CUDA devices, not the CPU")
        return [dev] * world_size
    if dev.type != "cuda":
        raise ValueError(f"device {dev} is neither CUDA nor the CPU")
    cards = torch.cuda.device_count()
    if dev.index is None:
        if world_size > cards:
            raise RuntimeError(
                f"{world_size} ranks need {world_size} CUDA devices, one "
                f"each, and {cards} are visible; under gloo, name one "
                f"device (\"cuda:0\") to put every rank on it")
        return [torch.device("cuda", r) for r in range(world_size)]
    if dev.index >= cards:
        raise RuntimeError(f"{dev} asked for, {cards} CUDA devices visible")
    if backend == "nccl" and world_size > 1:
        raise ValueError(f"NCCL cannot put {world_size} ranks on one GPU "
                         f"({dev}); use gloo or a card per rank")
    return [dev] * world_size


@contextlib.contextmanager
def _group(rank: int, world_size: int, store_path: str, backend: str,
           device: torch.device, timeout_s: float):
    """This process as `rank` of the default process group."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()       # so that DeviceMesh keeps this device
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world_size), rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def world_of_one(backend: str, device: torch.device | str | None = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
    """This process as the one rank of a world (no spawn); yields its
    device.  For a mesh of one shard, e.g. NCCL on a one-card machine."""
    dev = rank_devices(1, backend, device)[0]
    store = tempfile.mkdtemp(prefix="tpu_ran_store_")
    try:
        with _group(0, 1, os.path.join(store, "store"), backend, dev,
                    timeout_s):
            yield dev
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _worker(rank: int, world_size: int, store_path: str, backend: str,
            device: torch.device, timeout_s: float, fn, args: tuple,
            results) -> None:
    torch.set_num_threads(1)
    try:
        with _group(rank, world_size, store_path, backend, device,
                    timeout_s):
            out = _to_host(fn(rank, device, *args))
        msg = (rank, True, pickle.dumps(out))
    except Exception:       # the rank's boundary: report it to the parent
        msg = (rank, False, traceback.format_exc())
    results.put(msg)


def spawn(world_size: int, fn, *args, backend: str,
          device: torch.device | str | None = None,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(rank, device, *args)`` on `world_size` ranks and return
    each rank's result (tensors moved to the host), in rank order.

    fn and args are pickled by the ``spawn`` start method: fn must be a
    module-level function of an importable module (the children import
    it afresh).  timeout_s bounds each collective and the whole call.
    Raises RuntimeError with the rank's traceback when a rank fails or
    dies, TimeoutError at the deadline."""
    devices = rank_devices(world_size, backend, device)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="tpu_ran_store_")
    procs = [ctx.Process(
        target=_worker, daemon=True,
        args=(r, world_size, os.path.join(store, "store"), backend,
              devices[r], timeout_s, fn, args, results))
        for r in range(world_size)]
    deadline = time.monotonic() + timeout_s
    got: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world_size)) - set(got))} "
                    f"gave no result within {timeout_s:.0f} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"ranks died without a result "
                                       f"(rank, exit code): {dead}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{payload}")
            got[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 10.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10.0)
        results.close()
        shutil.rmtree(store, ignore_errors=True)
    return [got[r] for r in range(world_size)]


def run_all(rank: int, device: torch.device, programs: list) -> list:
    """Several rank programs in one world: ``programs`` is a list of
    (fn, args) pairs, each run as ``fn(rank, device, *args)`` in turn;
    returns their results in order."""
    return [fn(rank, device, *args) for fn, args in programs]
