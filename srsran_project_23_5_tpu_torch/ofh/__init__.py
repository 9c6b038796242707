"""O-RAN fronthaul (split 7.2): the port of ``srsran_project_23_5_tpu/ofh``.

Sector = transmitter (DL resource grid → C-plane + U-plane eCPRI/VLAN
frames) + receiver (frames → UL resource grid), with BFP IQ compression.
The frame transport is a byte-pipe callable (UDP/in-memory stand-in for
the raw AF_PACKET socket of ethernet_transmitter_impl.cpp).

The sector observes what the JAX sector observes (frames, counters,
sequence handling, eAxC filter, C-plane windows, the grids handed to
``on_ul_slot``), with the IQ work moved to whole slots on the device:

- ``transmit_dl_slot`` compresses the whole grid in one device call, copies
  the bytes to the host once, and slices them into the U-plane messages;
- ``handle_rx_frame`` parses headers on the host and keeps each U-plane
  payload until the slot is complete, then decompresses them all in one
  device call (one per width present) and writes them into the grid in
  arrival order before ``on_ul_slot`` fires.

One rule differs, where the JAX sector loses data.  The JAX sector calls a
slot complete once every symbol has been seen, which above 255 PRB (two
U-plane messages per symbol) is as soon as the first message of the last
symbol arrives: the second one then finds its C-plane window closed and is
dropped (``rx_no_cplane``), and the grid misses those PRBs of that symbol.
Here a slot is complete once every PRB of every symbol has been written, as
in the reference's uplink receiver, which counts the REs written.  Up to 255
PRB, where each symbol is one message, the two rules agree
(``tests/test_torch_fronthaul.py`` holds both at 24 and at 273 PRB).

A slot still incomplete when the C-plane window of another slot opens is
closed then (``rx_incomplete_slots``): if every symbol of it was seen it is
handed up with its missing PRBs zero, as the JAX sector hands up a slot that
lost a message above 255 PRB; otherwise it is dropped, as the JAX sector
never hands it up.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Callable

import numpy as np
import torch

from ..ran.constants import NRE
from ..utils.device import resolve as resolve_device
from . import compression, ecpri, ethernet, serdes

__all__ = ["compression", "ecpri", "ethernet", "serdes", "OfhSector",
           "OfhSectorConfig"]

_MAX_PRB_PER_MSG = 255


@dataclasses.dataclass
class OfhSectorConfig:
    nof_prb: int = 106
    eaxc_dl: int = 0
    eaxc_ul: int = 1
    comp_width: int = 9
    vlan: ethernet.VlanFrameParams = dataclasses.field(
        default_factory=ethernet.VlanFrameParams)


@dataclasses.dataclass
class _UlSlot:
    """A slot being received: its U-plane sections in arrival order
    (symbol, start PRB, PRBs, width, compressed payload) and the PRBs of
    each symbol written so far."""
    nof_symbols: int
    written: np.ndarray                  # [nof_symbols, nof_prb] bool
    sections: list = dataclasses.field(default_factory=list)


class OfhSector:
    """One OFH sector (ofh_sector_impl.cpp): DL handler + UL receiver.

    device: where the grids live and the IQ (de)compression runs (the
    current CUDA device unless the caller names another)."""

    def __init__(self, cfg: OfhSectorConfig,
                 send_frame: Callable[[bytes], None],
                 device: torch.device | str | None = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self._send = send_frame
        self._seq_dl = 0
        self._seq_cp = 0
        # UL reassembly: (frame, subframe, slot) -> sections received
        self._ul_slots: dict[tuple, _UlSlot] = {}
        self.on_ul_slot: Callable[[tuple, torch.Tensor], None] = \
            lambda key, grid: None
        # per-eAxC sequence tracking + C-plane reception windows
        self._rx_expected_seq: dict[tuple, int] = {}
        self._rx_last_seq: dict[tuple, int] = {}
        self._cp_windows: dict[tuple, int] = {}   # slot key -> nof symbols
        self.require_cplane = True
        # statistics
        self.tx_frames = 0
        self.rx_frames = 0
        self.rx_dropped = 0
        self.rx_filtered = 0          # foreign eAxC
        self.rx_duplicates = 0
        self.rx_seq_errors = 0        # sequence-number gaps
        self.rx_no_cplane = 0         # U-plane outside a C-plane window
        self.rx_incomplete_slots = 0  # closed before all PRBs arrived

    # --------------------------------------------------------------- DL
    def transmit_dl_slot(self, frame: int, subframe: int, slot: int,
                         grid) -> None:
        """grid: [nof_symbols, nof_prb*12] complex (a tensor on any device,
        or numpy) → one C-plane section + per-symbol U-plane messages
        (ofh_downlink_handler_impl.cpp:38-46)."""
        grid = torch.as_tensor(grid).to(self.device)
        nsym, nprb, width = grid.shape[0], self.cfg.nof_prb, \
            self.cfg.comp_width
        timing = serdes.TimingHeader(serdes.DIR_DL, frame, subframe, slot, 0)
        cp = serdes.cplane_encode(serdes.CplaneSection(
            timing, 0, 0, nprb, nsym))
        self._emit(ecpri.MSG_TYPE_RT_CONTROL, self.cfg.eaxc_dl,
                   self._seq_cp, cp)
        self._seq_cp = (self._seq_cp + 1) & 0xFFFF
        # one device pass over the slot, one copy of its bytes to the host
        wire = compression.compress_slot(grid.reshape(nsym, nprb, NRE),
                                         width).cpu().numpy()
        for sym in range(nsym):
            for start in range(0, nprb, _MAX_PRB_PER_MSG):
                n = min(_MAX_PRB_PER_MSG, nprb - start)
                hdr = serdes.uplane_header(serdes.UplaneMessage(
                    serdes.TimingHeader(serdes.DIR_DL, frame, subframe,
                                        slot, sym),
                    0, start, n, None, width))
                self._emit(ecpri.MSG_TYPE_IQ_DATA, self.cfg.eaxc_dl,
                           self._seq_dl,
                           hdr + wire[sym, start:start + n].tobytes())
                self._seq_dl = (self._seq_dl + 1) & 0xFFFF

    def _emit(self, msg_type: int, eaxc: int, seq: int,
              payload: bytes) -> None:
        pkt = ecpri.encode(ecpri.EcpriHeader(msg_type, eaxc, seq), payload)
        self._send(ethernet.encode(self.cfg.vlan, pkt))
        self.tx_frames += 1

    # --------------------------------------------------------------- UL
    def handle_rx_frame(self, frame_bytes: bytes,
                        nof_symbols: int = 14) -> None:
        """UL U-plane frame → the slot's sections; fires on_ul_slot with the
        grid [nof_symbols, nof_prb*12] complex64 on the sector's device when
        every PRB of every symbol arrived (receiver/uplink symbol manager
        equivalent)."""
        self.rx_frames += 1
        try:
            _vlan, pkt = ethernet.decode(frame_bytes)
            hdr, payload = ecpri.decode(pkt)
        except (AssertionError, IndexError, struct.error):
            self.rx_dropped += 1
            return
        # eAxC filtering (reference data_flow eAxC demux): only this
        # sector's UL stream is accepted
        if hdr.pc_id != self.cfg.eaxc_ul:
            self.rx_filtered += 1
            return
        # sequence-number handling per (eAxC, plane): duplicates dropped,
        # gaps counted and resynchronized (receiver sequence_id_checker)
        sk = (hdr.pc_id, hdr.msg_type)
        last = self._rx_last_seq.get(sk)
        if last is not None and hdr.seq_id == last:
            self.rx_duplicates += 1
            return
        expected = self._rx_expected_seq.get(sk)
        if expected is not None and hdr.seq_id != expected:
            self.rx_seq_errors += 1
        self._rx_last_seq[sk] = hdr.seq_id
        self._rx_expected_seq[sk] = (hdr.seq_id + 1) & 0xFFFF

        if hdr.msg_type == ecpri.MSG_TYPE_RT_CONTROL:
            # C-plane type 1: opens the slot's U-plane reception window
            sec = serdes.cplane_decode(payload)
            t = sec.timing
            key = (t.frame, t.subframe, t.slot)
            self._close_slots(key)
            self._cp_windows[key] = sec.nof_symbols
            return
        msg = serdes.uplane_decode_header(payload)
        t = msg.timing
        key = (t.frame, t.subframe, t.slot)
        nof_syms = self._cp_windows.get(key)
        if nof_syms is None:
            if self.require_cplane:
                self.rx_no_cplane += 1   # U-plane with no C-plane: drop
                return
            nof_syms = nof_symbols
        ul = self._ul_slots.get(key)
        if ul is None:
            ul = self._ul_slots[key] = _UlSlot(
                nof_syms, np.zeros((nof_syms, self.cfg.nof_prb), bool))
        size = compression.compressed_prb_size(msg.comp_width)
        if (t.symbol >= ul.nof_symbols
                or msg.start_prb + msg.nof_prb > self.cfg.nof_prb
                or len(msg.iq) < msg.nof_prb * size):
            raise ValueError(
                f"U-plane section (symbol {t.symbol}, PRBs {msg.start_prb}+"
                f"{msg.nof_prb}, {len(msg.iq)} B at width {msg.comp_width}) "
                f"does not fit the {ul.nof_symbols}x{self.cfg.nof_prb}-PRB "
                f"grid")
        ul.sections.append((t.symbol, msg.start_prb, msg.nof_prb,
                            msg.comp_width,
                            msg.iq[:msg.nof_prb * size]))
        ul.written[t.symbol, msg.start_prb:msg.start_prb + msg.nof_prb] = \
            True
        if ul.written.all():
            del self._ul_slots[key]
            self._cp_windows.pop(key, None)
            self.on_ul_slot(key, self._assemble(ul))

    def _close_slots(self, opening: tuple) -> None:
        """Closes every slot still being received but `opening`: handed up
        with its missing PRBs zero if each of its symbols was seen, else
        dropped."""
        for key in [k for k in self._ul_slots if k != opening]:
            ul = self._ul_slots.pop(key)
            self._cp_windows.pop(key, None)
            self.rx_incomplete_slots += 1
            if ul.written.any(axis=1).all():
                self.on_ul_slot(key, self._assemble(ul))

    def _assemble(self, ul: _UlSlot) -> torch.Tensor:
        """The slot's grid from its sections: each width's payloads
        decompressed in one device call, each PRB from the last section
        that carried it (as writing the sections in arrival order gives)."""
        nprb = self.cfg.nof_prb
        grid = torch.zeros((ul.nof_symbols * nprb, NRE),
                           dtype=torch.complex64, device=self.device)
        rows = np.concatenate([sym * nprb + np.arange(start, start + n)
                               for sym, start, n, _, _ in ul.sections])
        widths = np.concatenate([np.full(n, w)
                                 for _, _, n, w, _ in ul.sections])
        # the last arrival of each (symbol, PRB) wins
        _, last = np.unique(rows[::-1], return_index=True)
        keep = np.zeros(len(rows), bool)
        keep[len(rows) - 1 - last] = True
        for w in np.unique(widths):
            data = np.frombuffer(b"".join(
                s[4] for s in ul.sections if s[3] == w), np.uint8)
            size = compression.compressed_prb_size(int(w))
            wire = torch.from_numpy(data.reshape(-1, size).copy()).to(
                self.device)
            sel = keep[widths == w]
            iq = compression.decompress_slot(wire, int(w))
            dst = torch.from_numpy(rows[widths == w][sel]).to(self.device)
            src = torch.from_numpy(np.nonzero(sel)[0]).to(self.device)
            grid[dst] = iq[src]
        return grid.reshape(ul.nof_symbols, nprb * NRE)
