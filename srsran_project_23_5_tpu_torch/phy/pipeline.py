"""Production slot pipeline: slot-batched, depth-bounded asynchronous submits,
an on-device result accumulator, and K batches per dispatch as one CUDA
graph.

Counterpart of ``srsran_project_23_5_tpu/phy/pipeline.py``: its default
single PDSCH→PUSCH loopback, the ``slot_fn`` and ``batch_fn`` overrides, the
accumulate mode and the scan mode (only the AOT program store,
``warmup_scan(store=...)``, is not ported).

- ``submit`` enqueues one batch of B slots on the current CUDA stream,
  records an event and returns; at most ``depth`` batches stay in flight,
  and results are read only when the caller drains.  The channel noise is
  drawn on the device from the pipeline's own ``torch.Generator``.
- ``submit_accumulated`` folds each batch's (ok, sinr) into an accumulator
  on the device, all(ok) and sum(sinr); ``fetch_accumulated`` is the one
  host read.
- ``submit_scan`` runs K = ``scan_batches`` batches (K·B slots) in one
  dispatch and folds its (all_ok, sinr_sum) into the same accumulator.
  The K-batch step is one ``utils/graphs.Program`` in a ``GraphPool`` of
  the pipeline's own, made by the first scan call (``warmup_scan``): one
  CUDA graph replay per dispatch on the card, the eager K-batch loop on
  the CPU, on the program's static payload and noise buffers.  A
  dispatch's noise is drawn from a generator reseeded from its seed,
  outside the graph, and copied into the program's static noise buffers,
  which the dispatch then passes to the program (a copy onto itself is
  free), so the result depends only on (payloads, seed) and a replay sees
  the draws of the eager loop.

A scan dispatch is the span ``pipeline.dispatch`` of ``utils/tracing``
(its request id the seed) over ``pipeline.noise``, ``pipeline.launch``
(the program's call: ``graphs.copy_in``, then ``graphs.replay`` or
``graphs.capture``) and ``pipeline.fold``; the one host read is
``pipeline.fetch``.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models import gnb_flagship
from ..utils import graphs
from ..utils.device import resolve as resolve_device
from ..utils.tracing import tracer


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    carrier: gnb_flagship.CarrierConfig | None   # None with a slot/batch fn
    slots_per_batch: int = 32
    depth: int = 3                    # in-flight batches (>= 1)
    snr_db: float = 20.0              # per-RE SNR of the loopback channel
    nof_ldpc_iterations: int = 6
    # K batches of B slots per scan dispatch (one CUDA graph on the card)
    scan_batches: int = 1


class PipelineFn(NamedTuple):
    """A model step on explicit channel noise, for ``SlotPipeline`` (any
    (run, draw) pair will do).

    run: as ``batch_fn``, (payloads {name: [B, n]}, *noise [B, ...]) →
    (ok [B], sinr_db [B]); as ``slot_fn``, (payloads {name: [n]},
    *noise [...]) → (ok, sinr_db) scalars.  draw: (batch, generator) → the
    noise tensors [batch, ...] of that many slots.
    """
    run: Callable
    draw: Callable


def _tensors(payloads) -> list[torch.Tensor]:
    return (list(payloads.values()) if isinstance(payloads, dict)
            else [payloads])


def _scan_step(run: Callable, batches: int, device: torch.device, batch,
               *noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``SlotPipeline.scan_step``: run on batch k of each noise input, for
    k < batches."""
    all_ok = torch.ones((), dtype=torch.bool, device=device)
    sinr_sum = torch.zeros((), dtype=torch.float32, device=device)
    for k in range(batches):
        ok, sinr = run(batch, *(n[k] for n in noise))
        all_ok = all_ok & ok.all()
        sinr_sum = sinr_sum + sinr.sum()
    return all_ok, sinr_sum


class SlotPipeline:
    """Slots in batches of ``slots_per_batch``, at most ``depth`` batches in
    flight, or ``scan_batches`` batches per dispatch.

    The default is the single PDSCH→PUSCH loopback of ``config.carrier``:
    a submit takes TB bits [B, A] int8, and its noise comes from
    ``noise``.  ``batch_fn`` or ``slot_fn``, each a (run, draw) pair as in
    ``PipelineFn``, replace it (e.g. ``gnb_mixed.batch_fn_for_pipeline(cfg)`` or
    ``gnb_mixed.slot_fn_for_pipeline(cfg)`` with payloads {name: [B, n]
    int8}); a ``slot_fn`` runs the B slots of a batch one after another.
    """

    def __init__(self, config: PipelineConfig,
                 device: torch.device | str | None = None, seed: int = 0,
                 batch_fn: PipelineFn | None = None,
                 slot_fn: PipelineFn | None = None) -> None:
        if config.depth < 1:
            raise ValueError(f"depth must be >= 1, got {config.depth}")
        if config.scan_batches < 1:
            raise ValueError(f"scan_batches must be >= 1, got "
                             f"{config.scan_batches}")
        if batch_fn is not None and slot_fn is not None:
            raise ValueError("give a batch_fn or a slot_fn, not both")
        if batch_fn is None and slot_fn is None and config.carrier is None:
            raise ValueError("the default loopback needs config.carrier")
        self.config = config
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._scan_generator = torch.Generator(device=self.device)
        if slot_fn is not None:
            run, draw = slot_fn
            self.fn = PipelineFn(self._per_slot(run), draw)
        elif batch_fn is not None:
            self.fn = PipelineFn(*batch_fn)
        else:
            cc = config.carrier
            # modulate_slot makes a unit-power RE an amplitude-1 subcarrier,
            # and demodulate_slot divides by nfft, so time-domain noise of
            # variance sigma^2 lands on each RE with variance sigma^2/nfft:
            # sigma = sqrt(nfft)*10^(-snr/20) gives a per-RE SNR of snr_db.
            self.sigma = math.sqrt(cc.nfft) * 10 ** (-config.snr_db / 20)
            self.fn = PipelineFn(self._loopback,
                                 lambda b, g: (self.noise(b, g),))
        self._inflight: collections.deque = collections.deque()
        self._results: list = []
        self.completion_times: list[float] = []
        self._acc: tuple[torch.Tensor, torch.Tensor] | None = None
        self._acc_slots = 0
        # scan mode: the K-batch step, made by the first scan call
        self.graphs = graphs.GraphPool(self.device)
        self.program: graphs.Program | None = None

    # ------------------------------------------------------------ the step
    def noise(self, batch: int,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """One batch of the loopback's channel noise [batch, slot_samples]
        complex64, drawn on the device from `generator` (default: the
        pipeline's)."""
        nz = torch.randn((batch, 2, self.config.carrier.slot_samples),
                         generator=generator or self.generator,
                         device=self.device,
                         dtype=torch.float32) * (self.sigma / math.sqrt(2.0))
        return torch.complex(nz[:, 0], nz[:, 1])

    def _loopback(self, tb: torch.Tensor, noise: torch.Tensor):
        ok, _, sinr = gnb_flagship.loopback_batch(
            tb, noise, self.config.carrier, self.config.nof_ldpc_iterations)
        return ok, sinr

    @staticmethod
    def _per_slot(run: Callable) -> Callable:
        """A slot function over a batch: the B slots one after another."""
        def batched(payloads, *noise):
            outs = [run({k: v[b] for k, v in payloads.items()},
                        *(n[b] for n in noise))
                    for b in range(noise[0].shape[0])]
            return (torch.stack([o[0] for o in outs]),
                    torch.stack([o[1] for o in outs]))
        return batched

    def _check_device(self, batch) -> None:
        for t in _tensors(batch):
            if t.device != self.device:
                raise ValueError(f"payload on {t.device}, pipeline on "
                                 f"{self.device}")

    def step(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Enqueue one batch (TB bits [B, A], or the payloads of the slot or
        batch function) → (ok [B], sinr_db [B]), still on the device."""
        self._check_device(batch)
        return self.fn.run(batch, *self.fn.draw(_tensors(batch)[0].shape[0],
                                                self.generator))

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------- submit / drain mode
    def warmup(self, batch) -> tuple[float, np.ndarray, np.ndarray]:
        """First batch (builds the kernels on first use) and verification;
        returns (seconds, ok, sinr_db)."""
        t0 = time.perf_counter()
        ok, sinr = self.step(batch)
        self._synchronize()
        return time.perf_counter() - t0, ok.cpu().numpy(), sinr.cpu().numpy()

    def submit(self, batch) -> None:
        """Enqueue one batch of slots; bounds the in-flight queue depth."""
        out = self.step(batch)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._inflight.append((event, out))
        while len(self._inflight) > self.config.depth:
            self._complete_oldest()

    def _complete_oldest(self) -> None:
        event, out = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        self.completion_times.append(time.perf_counter())
        self._results.append(out)

    def drain(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Block until every in-flight batch finishes; return all results
        since the last drain as (ok [B], sinr_db [B]) numpy pairs."""
        while self._inflight:
            self._complete_oldest()
        out = [(ok.cpu().numpy(), s.cpu().numpy()) for ok, s in self._results]
        self._results.clear()
        return out

    # ---------------------------------------------------- accumulate mode
    def _fold(self, all_ok: torch.Tensor, sinr_sum: torch.Tensor,
              nof_slots: int) -> None:
        """all_ok and sinr_sum into the device accumulator (no host read)."""
        if self._acc is None:
            self._acc = (torch.ones((), dtype=torch.bool, device=self.device),
                         torch.zeros((), dtype=torch.float32,
                                     device=self.device))
        self._acc = (self._acc[0] & all_ok, self._acc[1] + sinr_sum)
        self._acc_slots += nof_slots

    def submit_accumulated(self, batch) -> None:
        """Enqueue a batch and fold its results into the on-device
        accumulator; nothing is read back to the host."""
        ok, sinr = self.step(batch)
        self._fold(ok.all(), sinr.sum(), ok.shape[0])

    def fetch_accumulated(self) -> tuple[bool, float, int]:
        """The one host read: (all_ok, mean_sinr_db, nof_slots) since the
        last fetch; resets the accumulator."""
        if self._acc is None:
            return True, 0.0, 0
        with tracer.span("pipeline.fetch", "pipeline"):
            ok, ssum = bool(self._acc[0]), float(self._acc[1])
        n = self._acc_slots
        self._acc, self._acc_slots = None, 0
        return ok, ssum / n, n

    # ----------------------------------------------------------- scan mode
    @property
    def slots_per_dispatch(self) -> int:
        return self.config.slots_per_batch * self.config.scan_batches

    def scan_noise(self, seed: int) -> tuple[torch.Tensor, ...]:
        """The noise of one dispatch: the model's draw of K·B slots from a
        generator reseeded from `seed` → one [K, B, ...] tensor per noise
        input; once the program exists, its static noise buffers, which
        the draw is copied into."""
        k, b = self.config.scan_batches, self.config.slots_per_batch
        self._scan_generator.manual_seed(seed)
        draws = tuple(d.reshape(k, b, *d.shape[1:])
                      for d in self.fn.draw(k * b, self._scan_generator))
        if self.program is None:
            return draws
        static = self.program.inputs[1:]
        for dst, d in zip(static, draws):
            dst.copy_(d)
        return static

    def scan_step(self, batch, noise: tuple[torch.Tensor, ...]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """The K-batch step, eagerly: batch k runs on noise[i][k] →
        (all_ok, sinr_sum) over the K·B slots, on the device."""
        return _scan_step(self.fn.run, self.config.scan_batches, self.device,
                          batch, *noise)

    def replay_scan(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The program on its static buffers as they stand → its
        (all_ok, sinr_sum) outputs (on the card the graph's, valid until
        the next replay)."""
        if self.program is None:
            raise RuntimeError("warmup_scan makes the scan program first")
        return self.program(*self.program.inputs)

    def _dispatch(self, batch, seed: int) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
        """One K·B-slot dispatch through the program (made and, on the
        card, captured at the first call)."""
        self._check_device(batch)
        got = _tensors(batch)[0].shape[0]
        if got != self.config.slots_per_batch:
            raise ValueError(f"scan payloads hold {got} slots, the "
                             f"pipeline {self.config.slots_per_batch}")
        with tracer.span("pipeline.noise", "pipeline"):
            noise = self.scan_noise(seed)
        with tracer.span("pipeline.launch", "pipeline"):
            if self.program is None:
                # the program holds the model's run, not the pipeline
                self.program = self.graphs.program(
                    functools.partial(_scan_step, self.fn.run,
                                      self.config.scan_batches, self.device))
            return self.program(batch, *noise)

    def warmup_scan(self, batch) -> tuple[float, bool, float]:
        """Make the scan program (on CUDA: its eager warm-up and capture)
        and run it once with seed 0; returns (seconds, all_ok,
        mean_sinr_db)."""
        t0 = time.perf_counter()
        ok, ssum = self._dispatch(batch, 0)
        ok, ssum = bool(ok), float(ssum)
        return time.perf_counter() - t0, ok, ssum / self.slots_per_dispatch

    def submit_scan(self, batch, seed: int) -> None:
        """One K·B-slot dispatch folded into the on-device accumulator;
        nothing is read back to the host."""
        with tracer.span("pipeline.dispatch", "pipeline", req=seed):
            out = self._dispatch(batch, seed)
            with tracer.span("pipeline.fold", "pipeline"):
                self._fold(*out, self.slots_per_dispatch)

    def dispatch_latency(self, batch, seed: int) -> float:
        """Submission→result latency of one dispatch (seconds) on an idle
        queue: the dispatch, then the read of its two results."""
        self._synchronize()
        t0 = time.perf_counter()
        ok, ssum = self._dispatch(batch, seed)
        bool(ok), float(ssum)
        return time.perf_counter() - t0
