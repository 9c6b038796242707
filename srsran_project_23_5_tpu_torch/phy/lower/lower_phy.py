"""Lower PHY engine: slot-clocked baseband processing over a radio gateway.

Counterpart of ``srsran_project_23_5_tpu/phy/lower/lower_phy.py`` (the
reference's lower_phy_baseband_processor.cpp:96-181).  ``LowerPhy`` is the
slot-synchronous engine: ``run_slot`` OFDM-modulates the DL grid handed
down by the upper PHY, pushes the baseband into the radio gateway, pulls
the UL baseband and demodulates it.  ``AsyncLowerPhy`` streams: it keeps
``depth`` slots modulated ahead of the DL read cursor (the reference's
max_processing_delay_slots) and demodulates each UL slot as its samples
complete.  Nothing here reads a device value on the host: the work is
queued on the device's stream in order, and the caller syncs when it
reads a result.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ...ran import numerology
from ...ran.constants import NRE
from ...utils.device import resolve as resolve_device
from . import amplitude, ofdm


@dataclasses.dataclass(frozen=True)
class LowerPhyConfig:
    mu: int = 1
    nfft: int = 2048
    nof_prb: int = 106
    center_freq_hz: float = 0.0
    tx_gain_db: float = 0.0

    @property
    def nsc(self) -> int:
        return self.nof_prb * NRE

    def slot_samples(self, slot_in_subframe: int = 0) -> int:
        return numerology.slot_num_samples(self.mu, self.nfft,
                                           slot_in_subframe)


class LoopbackRadio:
    """In-process radio gateway (the ZMQ virtual RF analogue): transmitted
    baseband comes back as received baseband after an optional channel
    function."""

    def __init__(self, channel: Optional[Callable] = None) -> None:
        self._channel = channel or (lambda x: x)
        self._queue: list[torch.Tensor] = []

    def transmit(self, samples: torch.Tensor) -> None:
        self._queue.append(self._channel(samples))

    def receive(self) -> Optional[torch.Tensor]:
        return self._queue.pop(0) if self._queue else None


class BasebandTimeline:
    """Sample timestamp → (slot count, symbol, offset) arithmetic
    (downlink_processor_baseband_impl.cpp:59-120): a subframe has a fixed
    sample count, so a timestamp decomposes as subframe → slot → symbol →
    offset through precomputed boundaries."""

    def __init__(self, mu: int, nfft: int) -> None:
        self.mu = mu
        self.nfft = nfft
        self.slots_per_sf = numerology.slots_per_subframe(mu)
        self.slot_sizes = [numerology.slot_num_samples(mu, nfft, s)
                           for s in range(self.slots_per_sf)]
        self.sf_samples = sum(self.slot_sizes)
        self.slot_starts = np.cumsum([0] + self.slot_sizes[:-1])
        # per slot of the subframe: symbol start offsets within the slot
        self.symbol_starts = [
            np.cumsum([0] + [int(c) + nfft
                             for c in numerology.cp_lengths(mu, nfft, s)[:-1]])
            for s in range(self.slots_per_sf)]

    def slot_size(self, slot_count: int) -> int:
        return self.slot_sizes[slot_count % self.slots_per_sf]

    def slot_start_sample(self, slot_count: int) -> int:
        sf, sis = divmod(slot_count, self.slots_per_sf)
        return sf * self.sf_samples + int(self.slot_starts[sis])

    def locate(self, timestamp: int) -> tuple[int, int, int]:
        """timestamp → (slot_count, symbol, offset into the symbol)."""
        sf, rem = divmod(timestamp, self.sf_samples)
        sis = int(np.searchsorted(self.slot_starts, rem, side="right")) - 1
        rem -= int(self.slot_starts[sis])
        sym = int(np.searchsorted(self.symbol_starts[sis], rem,
                                  side="right")) - 1
        return (sf * self.slots_per_sf + sis, sym,
                rem - int(self.symbol_starts[sis][sym]))


class AsyncLowerPhy:
    """Always-full baseband engine on one device (default: the current CUDA
    device; ``device="cpu"`` runs it on the CPU).

    TX: ``pull_tx(n)`` returns the next n samples of the continuous DL
    stream.  ``depth`` future slots stay modulated ahead of the read
    cursor: the grid of slot N + depth is requested (the upper-PHY
    callback, a [..., 14, nsc] grid or None for an empty slot) and its
    modulation and amplitude control queued while slot N streams out.

    RX: ``push_rx(chunk)`` takes UL baseband of any length; whenever a
    slot's samples are complete its demodulation is queued and
    ``notify_ul_grid(slot_count, grid)`` is called.
    """

    def __init__(self, config: LowerPhyConfig,
                 request_dl_grid: Callable[[int], Optional[torch.Tensor]],
                 notify_ul_grid: Callable[[int, torch.Tensor], None],
                 depth: int = 2, enable_clipping: bool = False,
                 ceiling_dbfs: float = 0.0,
                 device: torch.device | str | None = None) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.timeline = BasebandTimeline(config.mu, config.nfft)
        self.request_dl_grid = request_dl_grid
        self.notify_ul_grid = notify_ul_grid
        self.depth = depth
        self.enable_clipping = enable_clipping
        self.ceiling_dbfs = ceiling_dbfs
        self.tx_stats: amplitude.AmplitudeStats | None = None  # last slot's
        self._tx_slots: list[torch.Tensor] = []   # modulated, in slot order
        self._tx_next_slot = 0
        self._tx_offset = 0                        # cursor into _tx_slots[0]
        self._rx_buf: list[torch.Tensor] = []
        self._rx_have = 0
        self._rx_slot = 0

    # ------------------------------------------------------------ downlink
    def _fill_tx(self) -> None:
        c = self.config
        while len(self._tx_slots) < self.depth:
            slot = self._tx_next_slot
            self._tx_next_slot += 1
            grid = self.request_dl_grid(slot)
            if grid is None:
                bb = torch.zeros((self.timeline.slot_size(slot),),
                                 dtype=torch.complex64, device=self.device)
            else:
                bb = ofdm.modulate_slot(
                    grid.to(self.device), c.mu, c.nfft,
                    slot % self.timeline.slots_per_sf, c.center_freq_hz)
                bb, self.tx_stats = amplitude.control(
                    bb, c.tx_gain_db, self.enable_clipping,
                    self.ceiling_dbfs)
            self._tx_slots.append(bb)

    def pull_tx(self, nof_samples: int) -> torch.Tensor:
        """The next nof_samples of the continuous DL baseband stream."""
        out = []
        need = nof_samples
        while need > 0:
            self._fill_tx()
            cur = self._tx_slots[0]
            take = min(cur.shape[-1] - self._tx_offset, need)
            out.append(cur[..., self._tx_offset:self._tx_offset + take])
            self._tx_offset += take
            need -= take
            if self._tx_offset == cur.shape[-1]:
                self._tx_slots.pop(0)
                self._tx_offset = 0
        return out[0] if len(out) == 1 else torch.cat(out, dim=-1)

    # -------------------------------------------------------------- uplink
    def push_rx(self, chunk: torch.Tensor) -> None:
        """Take UL baseband; each completed slot's demodulation is queued
        and announced through notify_ul_grid."""
        c = self.config
        self._rx_buf.append(chunk)
        self._rx_have += int(chunk.shape[-1])
        while self._rx_have >= self.timeline.slot_size(self._rx_slot):
            size = self.timeline.slot_size(self._rx_slot)
            flat = (self._rx_buf[0] if len(self._rx_buf) == 1
                    else torch.cat(self._rx_buf, dim=-1))
            rest = flat[..., size:]
            self._rx_buf = [rest] if rest.shape[-1] else []
            self._rx_have -= size
            grid = ofdm.demodulate_slot(
                flat[..., :size], c.nsc, c.mu, c.nfft,
                self._rx_slot % self.timeline.slots_per_sf, c.center_freq_hz)
            self.notify_ul_grid(self._rx_slot, grid)
            self._rx_slot += 1


class LowerPhy:
    """Slot-synchronous lower PHY of one carrier on one device (default:
    the current CUDA device)."""

    def __init__(self, config: LowerPhyConfig, radio: LoopbackRadio,
                 device: torch.device | str | None = None) -> None:
        self.config = config
        self.radio = radio
        self.device = resolve_device(device)
        self.slot = numerology.SlotPoint(config.mu, 0, 0)

    def run_slot(self, dl_grid: Optional[torch.Tensor]
                 ) -> Optional[torch.Tensor]:
        """One slot: modulate and send the DL grid, receive and demodulate
        the UL baseband.  Returns the UL grid, or None when the radio had no
        samples."""
        c = self.config
        sis = self.slot.slot_in_subframe
        if dl_grid is not None:
            self.radio.transmit(ofdm.modulate_slot(
                dl_grid.to(self.device), c.mu, c.nfft, sis, c.center_freq_hz))
        rx = self.radio.receive()
        ul_grid = None
        if rx is not None:
            ul_grid = ofdm.demodulate_slot(rx, c.nsc, c.mu, c.nfft, sis,
                                           c.center_freq_hz)
        self.slot = self.slot + 1
        return ul_grid
