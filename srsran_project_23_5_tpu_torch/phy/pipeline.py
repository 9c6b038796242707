"""Production slot pipeline: slot-batched, depth-bounded asynchronous submits.

Counterpart of ``srsran_project_23_5_tpu/phy/pipeline.py`` (its default
single PDSCH→PUSCH loopback; the scan-amortised and accumulate modes and the
AOT program store are not ported).  ``submit`` enqueues one batch of B slots
on the current CUDA stream, records an event and returns; at most ``depth``
batches stay in flight, and results are read only when the caller drains.
Channel noise is drawn on the device from the pipeline's own
``torch.Generator``, so nothing but the TB batch rides each submit.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np
import torch

from ..models import gnb_flagship


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    carrier: gnb_flagship.CarrierConfig
    slots_per_batch: int = 32
    depth: int = 3                    # in-flight batches (>= 1)
    snr_db: float = 20.0              # per-RE SNR of the loopback channel
    nof_ldpc_iterations: int = 6


class SlotPipeline:
    """Full DL+UL loopback slots of ``config.carrier`` in batches of
    ``slots_per_batch``, with at most ``depth`` batches in flight."""

    def __init__(self, config: PipelineConfig,
                 device: torch.device | str = "cpu", seed: int = 0) -> None:
        if config.depth < 1:
            raise ValueError(f"depth must be >= 1, got {config.depth}")
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        cc = config.carrier
        # modulate_slot makes a unit-power RE an amplitude-1 subcarrier, and
        # demodulate_slot divides by nfft, so time-domain noise of variance
        # sigma^2 lands on each RE with variance sigma^2/nfft:
        # sigma = sqrt(nfft)*10^(-snr/20) gives a per-RE SNR of snr_db.
        self.sigma = math.sqrt(cc.nfft) * 10 ** (-config.snr_db / 20)
        self._inflight: collections.deque = collections.deque()
        self._results: list = []
        self.completion_times: list[float] = []

    def noise(self, batch: int) -> torch.Tensor:
        """One batch of channel noise [batch, slot_samples] complex64, drawn
        on the device from the pipeline's generator."""
        nz = torch.randn((batch, 2, self.config.carrier.slot_samples),
                         generator=self.generator, device=self.device,
                         dtype=torch.float32) * (self.sigma / math.sqrt(2.0))
        return torch.complex(nz[:, 0], nz[:, 1])

    def step(self, tb_batch: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """Enqueue one batch: TB bits [B, A] int8 on the pipeline's device →
        (tb_crc_ok [B], sinr_db [B]), still on the device."""
        if tb_batch.device != self.device:
            raise ValueError(f"TB batch on {tb_batch.device}, pipeline on "
                             f"{self.device}")
        ok, _, sinr = gnb_flagship.loopback_batch(
            tb_batch, self.noise(tb_batch.shape[0]), self.config.carrier,
            self.config.nof_ldpc_iterations)
        return ok, sinr

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, tb_batch: torch.Tensor
               ) -> tuple[float, np.ndarray, np.ndarray]:
        """First batch (builds the kernels on first use) and verification;
        returns (seconds, ok, sinr_db)."""
        t0 = time.perf_counter()
        ok, sinr = self.step(tb_batch)
        self._synchronize()
        return time.perf_counter() - t0, ok.cpu().numpy(), sinr.cpu().numpy()

    def submit(self, tb_batch: torch.Tensor) -> None:
        """Enqueue one batch of slots; bounds the in-flight queue depth."""
        out = self.step(tb_batch)
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
