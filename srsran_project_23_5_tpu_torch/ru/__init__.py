"""RU abstraction (reference lib/ru): the upper PHY talks to a
radio_unit regardless of split — generic (lower PHY + radio, split 8)
or OFH (split 7.2).  Counterpart of ``srsran_project_23_5_tpu/ru``.

Both expose: handle_dl_grid(context, grid) downlink and an on_ul_grid
callback upward (ru_generic_impl.h:51-75 / ru_ofh_impl).  Each RU works on
a device (the current CUDA device unless the caller names another): the
OFDM of ``RuGeneric`` and the BFP compression of ``RuOfh``'s sector run
there, and the UL grids they hand up are tensors on it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..ofh import OfhSector, OfhSectorConfig
from ..phy.lower import ofdm
from ..radio import RadioSession
from ..ran import numerology
from ..utils.device import resolve as resolve_device


@dataclasses.dataclass
class RuConfig:
    nof_prb: int = 106
    mu: int = 1

    @property
    def nfft(self) -> int:
        return numerology.min_nfft(self.nof_prb)


class RadioUnit:
    """radio_unit interface: DL-plane handler + UL-plane notifications."""

    def __init__(self) -> None:
        self.on_ul_grid: Callable[[tuple, torch.Tensor], None] = \
            lambda ctx, grid: None

    def handle_dl_grid(self, ctx: tuple, grid) -> None:
        raise NotImplementedError

    def trigger_ul_slot(self, ctx: tuple) -> None:
        """Pull one UL slot from the underlying transport (loopback use)."""


class RuGeneric(RadioUnit):
    """Split 8: OFDM-modulates the grid [..., 14, nsc] and streams baseband
    [..., slot_samples] through a radio session; receives baseband and
    demodulates it to the UL grid."""

    def __init__(self, cfg: RuConfig, radio: RadioSession,
                 device: torch.device | str | None = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.radio = radio
        self.device = resolve_device(device)
        self._ts = 0

    def handle_dl_grid(self, ctx: tuple, grid) -> None:
        grid = torch.as_tensor(grid).to(self.device)
        bb = ofdm.modulate_slot(grid, self.cfg.mu, self.cfg.nfft)
        self.radio.transmit(bb, self._ts)
        self._ts += bb.shape[-1]

    def trigger_ul_slot(self, ctx: tuple) -> None:
        samples, _ts = self.radio.receive()
        if samples is not None:
            grid = ofdm.demodulate_slot(
                torch.as_tensor(samples).to(self.device),
                self.cfg.nof_prb * 12, self.cfg.mu, self.cfg.nfft)
            self.on_ul_grid(ctx, grid)


class RuOfh(RadioUnit):
    """Split 7.2: frequency-domain grids over eCPRI/Ethernet frames."""

    def __init__(self, cfg: RuConfig, send_frame: Callable[[bytes], None],
                 device: torch.device | str | None = None) -> None:
        super().__init__()
        self.cfg = cfg
        # loopback-symmetric eAxC: the sector's own DL stream id is also
        # accepted on receive (RU-to-DU UL rides the same id in tests)
        self.sector = OfhSector(OfhSectorConfig(nof_prb=cfg.nof_prb,
                                                eaxc_ul=0), send_frame,
                                device)
        self.sector.on_ul_slot = lambda key, grid: self.on_ul_grid(key,
                                                                   grid)

    def handle_dl_grid(self, ctx: tuple, grid) -> None:
        frame, subframe, slot = ctx
        self.sector.transmit_dl_slot(frame, subframe, slot, grid)

    def handle_rx_frame(self, frame: bytes) -> None:
        self.sector.handle_rx_frame(frame)
