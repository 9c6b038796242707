"""Production slot pipeline: slot-batched, depth-bounded asynchronous submits.

Counterpart of ``srsran_project_23_5_tpu/phy/pipeline.py`` (its default
single PDSCH→PUSCH loopback and its ``batch_fn`` override; the scan-amortised
and accumulate modes and the AOT program store are not ported).  ``submit``
enqueues one batch of B slots on the current CUDA stream, records an event
and returns; at most ``depth`` batches stay in flight, and results are read
only when the caller drains.  Channel noise is drawn on the device from the
pipeline's own ``torch.Generator``, so nothing but the payloads rides each
submit.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch

from ..models import gnb_flagship
from ..utils.device import resolve as resolve_device


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    carrier: gnb_flagship.CarrierConfig | None   # None with a batch_fn
    slots_per_batch: int = 32
    depth: int = 3                    # in-flight batches (>= 1)
    snr_db: float = 20.0              # per-RE SNR of the loopback channel
    nof_ldpc_iterations: int = 6


class SlotPipeline:
    """Slots in batches of ``slots_per_batch``, at most ``depth`` batches in
    flight.

    The default is the single PDSCH→PUSCH loopback of ``config.carrier``:
    each submit takes TB bits [B, A] int8.  ``batch_fn`` replaces it:
    (payloads, generator) → (ok [B], sinr_db [B]), where the batch function
    draws its channel noise from the pipeline's generator, e.g.
    ``gnb_mixed.batch_fn_for_pipeline(cfg)`` with payloads
    {name: [B, n] int8}.
    """

    def __init__(self, config: PipelineConfig,
                 device: torch.device | str | None = None, seed: int = 0,
                 batch_fn: Callable | None = None) -> None:
        if config.depth < 1:
            raise ValueError(f"depth must be >= 1, got {config.depth}")
        if batch_fn is None and config.carrier is None:
            raise ValueError("the default loopback needs config.carrier")
        self.config = config
        self.batch_fn = batch_fn
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        if config.carrier is not None:
            # modulate_slot makes a unit-power RE an amplitude-1 subcarrier,
            # and demodulate_slot divides by nfft, so time-domain noise of
            # variance sigma^2 lands on each RE with variance sigma^2/nfft:
            # sigma = sqrt(nfft)*10^(-snr/20) gives a per-RE SNR of snr_db.
            self.sigma = (math.sqrt(config.carrier.nfft)
                          * 10 ** (-config.snr_db / 20))
        self._inflight: collections.deque = collections.deque()
        self._results: list = []
        self.completion_times: list[float] = []

    def noise(self, batch: int) -> torch.Tensor:
        """One batch of the loopback's channel noise [batch, slot_samples]
        complex64, drawn on the device from the pipeline's generator."""
        nz = torch.randn((batch, 2, self.config.carrier.slot_samples),
                         generator=self.generator, device=self.device,
                         dtype=torch.float32) * (self.sigma / math.sqrt(2.0))
        return torch.complex(nz[:, 0], nz[:, 1])

    def _check_device(self, t: torch.Tensor) -> None:
        if t.device != self.device:
            raise ValueError(f"payload on {t.device}, pipeline on "
                             f"{self.device}")

    def step(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Enqueue one batch (TB bits [B, A], or the batch function's
        payloads) → (ok [B], sinr_db [B]), still on the device."""
        if self.batch_fn is not None:
            for t in batch.values():
                self._check_device(t)
            return self.batch_fn(batch, self.generator)
        self._check_device(batch)
        ok, _, sinr = gnb_flagship.loopback_batch(
            batch, self.noise(batch.shape[0]), self.config.carrier,
            self.config.nof_ldpc_iterations)
        return ok, sinr

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
