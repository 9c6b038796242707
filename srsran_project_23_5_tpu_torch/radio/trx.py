"""Amarisoft-TRX-style driver shim (reference utils/trx_srsran: a shim so
an external UE simulator can use this stack as its RF front end).

The TRX driver contract is a sample-clocked full-duplex interface:
``write(samples, timestamp)`` queues TX baseband at an absolute sample
time; ``read(count)`` returns the next RX samples with their timestamp.
This adapter binds that contract to any in-process radio with
``transmit/receive`` (radio.LoopbackRadio and friends), inserting zero
fill for gaps exactly like the reference shim's underflow handling.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TrxStats:
    tx_samples: int = 0
    rx_samples: int = 0
    tx_underflows: int = 0       # gaps zero-filled in the TX stream
    tx_late: int = 0             # writes behind the read cursor


class TrxDriver:
    """Sample-clocked TRX session over an in-memory float32 stream."""

    def __init__(self, sample_rate_hz: float, channel=None) -> None:
        self.sample_rate_hz = sample_rate_hz
        self._channel = channel or (lambda x: x)
        self._tx_cursor = 0          # absolute sample time of stream end
        self._rx_cursor = 0
        self._stream: list[np.ndarray] = []
        self.stats = TrxStats()
        self.tx_gain_db = 0.0
        self.rx_gain_db = 0.0
        self.started = False

    # ------------------------------------------------------------- control
    def start(self) -> None:
        self.started = True

    def stop(self) -> None:
        self.started = False

    def set_tx_gain(self, gain_db: float) -> None:
        self.tx_gain_db = gain_db

    def set_rx_gain(self, gain_db: float) -> None:
        self.rx_gain_db = gain_db

    # ---------------------------------------------------------------- data
    def write(self, samples: np.ndarray, timestamp: int) -> None:
        """Queue TX baseband at an absolute sample time."""
        assert self.started, "TRX not started"
        samples = np.asarray(samples, dtype=np.complex64)
        if timestamp < self._tx_cursor:
            # late write: drop the overlapping head (reference logs+drops)
            cut = self._tx_cursor - timestamp
            self.stats.tx_late += 1
            if cut >= len(samples):
                return
            samples = samples[cut:]
            timestamp = self._tx_cursor
        gap = timestamp - self._tx_cursor
        if gap > 0:
            self._stream.append(np.zeros(gap, np.complex64))
            self.stats.tx_underflows += 1
        g = np.complex64(10 ** (self.tx_gain_db / 20))
        self._stream.append(samples * g)
        self._tx_cursor = timestamp + len(samples)
        self.stats.tx_samples += len(samples)

    def read(self, count: int) -> tuple[np.ndarray, int]:
        """Next `count` RX samples and their first-sample timestamp."""
        assert self.started, "TRX not started"
        ts = self._rx_cursor
        if self._tx_cursor - self._rx_cursor < count:
            # not enough signal: zero-fill (receiver runs ahead of tx)
            fill = count - (self._tx_cursor - self._rx_cursor)
            self._stream.append(np.zeros(fill, np.complex64))
            self._tx_cursor += fill
        flat = np.concatenate(self._stream) if len(self._stream) > 1 \
            else self._stream[0]
        out = flat[:count]
        rest = flat[count:]
        self._stream = [rest] if len(rest) else []
        self._rx_cursor += count
        self.stats.rx_samples += count
        g = np.complex64(10 ** (self.rx_gain_db / 20))
        return self._channel(out) * g, ts
