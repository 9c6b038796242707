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
  dispatch and folds its (all_ok, sinr_sum) into the same accumulator.  On
  CUDA the K-batch step is a ``torch.cuda.CUDAGraph`` captured once by
  ``warmup_scan`` on static payload, noise and output buffers, and each
  submit is a noise draw and one replay; on the CPU the same K-batch loop
  runs eagerly.  A dispatch's noise is drawn from a generator reseeded
  from its seed, outside the graph, so the result depends only on
  (payloads, seed) and a replay sees the draws of the eager loop.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models import gnb_flagship
from ..ops.ldpc import decoder_cuda, encoder_cuda
from ..utils.device import resolve as resolve_device

# the kernel wrappers whose ``launches`` count a replay adds to
_KERNELS = (encoder_cuda.encode, decoder_cuda.decode)


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
        # scan mode: static buffers, the graph and what it launches
        self._noise: tuple[torch.Tensor, ...] | None = None
        self._static_payloads = None
        self._payload_src = None
        self._graph: torch.cuda.CUDAGraph | None = None
        self._graph_out: tuple[torch.Tensor, torch.Tensor] | None = None
        self.captured_launches: tuple[int, ...] = (0,) * len(_KERNELS)
        self.capture_seconds = 0.0

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
        generator reseeded from `seed`, copied into the static buffers →
        one [K, B, ...] tensor per noise input."""
        k, b = self.config.scan_batches, self.config.slots_per_batch
        self._scan_generator.manual_seed(seed)
        draws = self.fn.draw(k * b, self._scan_generator)
        if self._noise is None:
            self._noise = tuple(torch.empty((k, b, *d.shape[1:]),
                                            dtype=d.dtype, device=self.device)
                                for d in draws)
        for dst, d in zip(self._noise, draws):
            dst.copy_(d.reshape(dst.shape))
        return self._noise

    def scan_step(self, batch, noise: tuple[torch.Tensor, ...]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """The K-batch step, eagerly: batch k runs on noise[i][k] →
        (all_ok, sinr_sum) over the K·B slots, on the device."""
        all_ok = torch.ones((), dtype=torch.bool, device=self.device)
        sinr_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for k in range(self.config.scan_batches):
            ok, sinr = self.fn.run(batch, *(n[k] for n in noise))
            all_ok = all_ok & ok.all()
            sinr_sum = sinr_sum + sinr.sum()
        return all_ok, sinr_sum

    def _set_payloads(self, batch) -> None:
        """Copy the payloads into the static buffers when they are other
        tensors than the last ones seen (in-place changes to the same
        tensors are not seen).  The CPU loop reads the same buffers, so
        the CPU tests reach this logic."""
        self._check_device(batch)
        src = _tensors(batch)
        if self._payload_src is not None and len(src) == len(
                self._payload_src) and all(
                a is b for a, b in zip(src, self._payload_src)):
            return
        got = _tensors(batch)[0].shape[0]
        if got != self.config.slots_per_batch:
            raise ValueError(f"scan payloads hold {got} slots, the "
                             f"pipeline {self.config.slots_per_batch}")
        if self._static_payloads is None:
            self._static_payloads = (
                {k: v.clone() for k, v in batch.items()}
                if isinstance(batch, dict) else batch.clone())
        else:
            for dst, src in zip(_tensors(self._static_payloads),
                                _tensors(batch)):
                dst.copy_(src)
        self._payload_src = src

    def replay_scan(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Replay the captured K-batch graph on the static buffers as they
        stand → its static (all_ok, sinr_sum) outputs; the launch counts
        of the kernel wrappers grow by what the graph captured."""
        if self._graph is None:
            raise RuntimeError("warmup_scan captures the graph first")
        self._graph.replay()
        for fn, n in zip(_KERNELS, self.captured_launches):
            fn.launches += n
        return self._graph_out

    def _dispatch(self, batch, seed: int) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
        """One K·B-slot dispatch on the static buffers: the graph on CUDA,
        the loop on the CPU."""
        self._set_payloads(batch)
        noise = self.scan_noise(seed)
        if self.device.type == "cuda":
            return self.replay_scan()
        return self.scan_step(self._static_payloads, noise)

    def _capture(self) -> None:
        """Eager passes on a side stream (kernel builds, cached device
        tables, cuFFT plans, cuBLAS workspaces), then the capture of the
        K-batch step on the static buffers.  A capture that fails raises."""
        noise = self._noise
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.scan_step(self._static_payloads, noise)
        torch.cuda.current_stream(self.device).wait_stream(side)
        before = tuple(fn.launches for fn in _KERNELS)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=side):
                out = self.scan_step(self._static_payloads, noise)
        finally:
            # capture launches nothing: the counts grow on each replay
            after = tuple(fn.launches for fn in _KERNELS)
            for fn, n in zip(_KERNELS, before):
                fn.launches = n
        self.capture_seconds = time.perf_counter() - t0
        self.captured_launches = tuple(a - b for a, b in zip(after, before))
        self._graph, self._graph_out = graph, out

    def warmup_scan(self, batch) -> tuple[float, bool, float]:
        """Build and verify the scan step (on CUDA: eager warmup and the
        capture of the graph) and run it once with seed 0; returns
        (seconds, all_ok, mean_sinr_db)."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            self._set_payloads(batch)
            self.scan_noise(0)
            self._capture()
        ok, ssum = self._dispatch(batch, 0)
        ok, ssum = bool(ok), float(ssum)
        return time.perf_counter() - t0, ok, ssum / self.slots_per_dispatch

    def submit_scan(self, batch, seed: int) -> None:
        """One K·B-slot dispatch folded into the on-device accumulator;
        nothing is read back to the host."""
        self._fold(*self._dispatch(batch, seed), self.slots_per_dispatch)

    def dispatch_latency(self, batch, seed: int) -> float:
        """Submission→result latency of one dispatch (seconds) on an idle
        queue: the dispatch, then the read of its two results."""
        self._synchronize()
        t0 = time.perf_counter()
        ok, ssum = self._dispatch(batch, seed)
        bool(ok), float(ssum)
        return time.perf_counter() - t0
