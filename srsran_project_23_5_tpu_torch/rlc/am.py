"""RLC AM: acknowledged mode (TS 38.322 §5.2.3; reference
lib/rlc/rlc_tx_am_entity.cpp / rlc_rx_am_entity.cpp).

One entity couples TX and RX halves (status PDUs ride the TX
opportunities). Covers: segmentation/resegmentation on retx, tx/rx
windows, polling (pollPDU/pollByte/t-PollRetransmit), STATUS PDUs with
NACK+SO, t-Reassembly, t-StatusProhibit, maxRetxThreshold → RLF
notification (the reference's protocol-failure hook,
rlc_tx_am_entity.cpp on max_retx).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

from ..support.timers import TimerManager
from . import pdu


@dataclasses.dataclass
class RlcAmConfig:
    sn_size: int = 12
    t_poll_retransmit: int = 45      # ticks (ms at 1 kHz)
    poll_pdu: int = 4
    poll_byte: int = 25000
    max_retx_threshold: int = 4
    t_reassembly: int = 35
    t_status_prohibit: int = 0


class _TxPdu:
    __slots__ = ("sdu", "retx_count", "retx_pending", "acked_bytes")

    def __init__(self, sdu: bytes) -> None:
        self.sdu = sdu
        self.retx_count = -1         # first transmission is not a retx
        self.retx_pending: list[tuple[int, int]] = []  # (so_start, so_end)
        self.acked_bytes = 0


class RlcAmEntity:
    def __init__(self, config: RlcAmConfig,
                 on_sdu: Callable[[bytes], None],
                 timers: Optional[TimerManager] = None,
                 on_max_retx: Optional[Callable[[], None]] = None,
                 on_delivered: Optional[Callable[[int], None]] = None
                 ) -> None:
        self.cfg = config
        self.mod = 1 << config.sn_size
        self.window = 1 << (config.sn_size - 1)
        self._on_sdu = on_sdu
        self._on_max_retx = on_max_retx or (lambda: None)
        self._on_delivered = on_delivered or (lambda n: None)

        # TX state
        self.tx_next = 0             # next new SN
        self.tx_next_ack = 0         # lowest unacked SN
        self._sdu_q: deque[bytes] = deque()
        self._tx_window: dict[int, _TxPdu] = {}
        self._seg: Optional[tuple[int, int]] = None   # (sn, next offset)
        self._retx_q: deque[int] = deque()
        self._pdu_without_poll = 0
        self._byte_without_poll = 0

        # RX state
        self.rx_next = 0             # lowest not yet delivered SN
        self._rx_segs: dict[int, dict[int, bytes]] = {}
        self._rx_total: dict[int, int] = {}
        self._rx_complete: dict[int, bytes] = {}
        self.rx_next_highest = 0     # highest received SN + 1
        self._status_required = False

        self._timers = timers
        self._t_poll = self._t_reassembly = self._t_prohibit = None
        if timers is not None:
            self._t_poll = timers.create_timer()
            self._t_poll.set(config.t_poll_retransmit,
                             self._on_poll_retransmit_expiry)
            self._t_reassembly = timers.create_timer()
            self._t_reassembly.set(config.t_reassembly,
                                   self._on_reassembly_expiry)
            if config.t_status_prohibit:
                self._t_prohibit = timers.create_timer()
                self._t_prohibit.set(config.t_status_prohibit)

    # ------------------------------------------------------------ helpers
    def _sn_lt(self, a: int, b: int) -> bool:
        """a < b modulo SN space, anchored at tx_next_ack/rx_next."""
        return ((a - self.rx_next) % self.mod) < ((b - self.rx_next)
                                                  % self.mod)

    def _hdr_len(self, segmented: bool) -> int:
        base = 2 if self.cfg.sn_size == 12 else 3
        return base + (2 if segmented else 0)

    # ----------------------------------------------------------------- TX
    def handle_sdu(self, sdu: bytes) -> None:
        self._sdu_q.append(bytes(sdu))

    def buffer_state(self) -> int:
        n = sum(len(s) + self._hdr_len(False) for s in self._sdu_q)
        for sn in self._retx_q:
            p = self._tx_window.get(sn)
            if p:
                n += len(p.sdu) + self._hdr_len(True)
        if self._seg is not None:
            sn, off = self._seg
            n += len(self._tx_window[sn].sdu) - off + self._hdr_len(True)
        if self._status_required:
            n += self._status_size()
        return n

    def _status_size(self) -> int:
        return 3 + 6 * len(self._missing_sns())

    def _tx_window_full(self) -> bool:
        return ((self.tx_next - self.tx_next_ack) % self.mod) >= self.window

    def pull_pdu(self, nof_bytes: int) -> bytes:
        # 1. control PDU has priority (rlc_tx_am_entity::pull_pdu order)
        if self._status_required and (
                self._t_prohibit is None
                or not self._t_prohibit.is_running()):
            status = self._build_status()
            if len(status) <= nof_bytes:
                self._status_required = False
                if self._t_prohibit is not None:
                    self._t_prohibit.run()
                return status
        # 2. retransmissions
        if self._retx_q:
            out = self._pull_retx(nof_bytes)
            if out:
                return out
        # 3. continue a segmented SDU
        if self._seg is not None:
            return self._pull_segment(nof_bytes)
        # 4. new SDU
        if not self._sdu_q or self._tx_window_full():
            return b""
        sdu = self._sdu_q[0]
        hdr = self._hdr_len(False)
        if len(sdu) + hdr <= nof_bytes:
            self._sdu_q.popleft()
            sn = self.tx_next
            self._tx_window[sn] = _TxPdu(sdu)
            self.tx_next = (self.tx_next + 1) % self.mod
            return self._emit(sn, pdu.SI_FULL, 0, sdu, nof_bytes)
        room = nof_bytes - self._hdr_len(False)
        if room <= 0:
            return b""
        self._sdu_q.popleft()
        sn = self.tx_next
        self._tx_window[sn] = _TxPdu(sdu)
        self.tx_next = (self.tx_next + 1) % self.mod
        self._seg = (sn, room)
        return self._emit(sn, pdu.SI_FIRST, 0, sdu[:room], nof_bytes)

    def _pull_segment(self, nof_bytes: int) -> bytes:
        sn, off = self._seg
        if sn not in self._tx_window:    # acked mid-segmentation
            self._seg = None
            return self.pull_pdu(nof_bytes)
        sdu = self._tx_window[sn].sdu
        room = nof_bytes - self._hdr_len(True)
        if room <= 0:
            return b""
        rest = len(sdu) - off
        if room >= rest:
            self._seg = None
            return self._emit(sn, pdu.SI_LAST, off, sdu[off:], nof_bytes)
        self._seg = (sn, off + room)
        return self._emit(sn, pdu.SI_MIDDLE, off, sdu[off:off + room],
                          nof_bytes)

    def _pull_retx(self, nof_bytes: int) -> bytes:
        # skip entries whose SN was acked since being queued
        while self._retx_q:
            sn = self._retx_q[0]
            p = self._tx_window.get(sn)
            if p is not None and p.retx_pending:
                break
            self._retx_q.popleft()
        if not self._retx_q:
            return b""
        so_start, so_end = p.retx_pending[0]
        so_end = min(so_end, len(p.sdu))
        seg = p.sdu[so_start:so_end]
        full_sdu = so_start == 0 and so_end == len(p.sdu)
        hdr = self._hdr_len(not full_sdu)
        room = nof_bytes - hdr
        if room <= 0:
            return b""
        if room >= len(seg):
            p.retx_pending.pop(0)
            if not p.retx_pending:
                self._retx_q.popleft()
            if full_sdu:
                return self._emit(sn, pdu.SI_FULL, 0, seg, nof_bytes)
            si = pdu.SI_LAST if so_end == len(p.sdu) else (
                pdu.SI_FIRST if so_start == 0 else pdu.SI_MIDDLE)
            return self._emit(sn, si, so_start, seg, nof_bytes)
        # partial retx of the requested range
        p.retx_pending[0] = (so_start + room, so_end)
        si = pdu.SI_FIRST if so_start == 0 else pdu.SI_MIDDLE
        return self._emit(sn, si, so_start, seg[:room], nof_bytes)

    def _emit(self, sn: int, si: int, so: int, payload: bytes,
              nof_bytes: int) -> bytes:
        self._pdu_without_poll += 1
        self._byte_without_poll += len(payload)
        poll = False
        if (self._pdu_without_poll >= self.cfg.poll_pdu
                or self._byte_without_poll >= self.cfg.poll_byte
                or (not self._sdu_q and self._seg is None
                    and not self._retx_q)
                or self._tx_window_full()):
            poll = True
            self._pdu_without_poll = 0
            self._byte_without_poll = 0
            if self._t_poll is not None:
                self._t_poll.run()
        h = pdu.AmHeader(si, sn, poll, so, self.cfg.sn_size)
        return pdu.am_encode(h) + payload

    def _on_poll_retransmit_expiry(self) -> None:
        """Retransmit the lowest unacked SN (§5.3.3.4)."""
        if self.tx_next_ack != self.tx_next:
            self._queue_retx(self.tx_next_ack, 0, 1 << 30)

    def _queue_retx(self, sn: int, so_start: int, so_end: int) -> None:
        p = self._tx_window.get(sn)
        if p is None:
            return
        if self._seg is not None and self._seg[0] == sn:
            # SDU still being segmented: only bytes already sent can be retx
            so_end = min(so_end, self._seg[1])
            if so_start >= so_end:
                return
        p.retx_count += 1
        if p.retx_count >= self.cfg.max_retx_threshold:
            self._on_max_retx()
            return
        p.retx_pending.append((so_start, min(so_end, len(p.sdu))))
        if sn not in self._retx_q:
            self._retx_q.append(sn)

    # ----------------------------------------------------------------- RX
    def handle_pdu(self, data: bytes) -> None:
        if not data:
            return
        if pdu.is_control_pdu(data):
            self._handle_status(pdu.status_decode(data, self.cfg.sn_size))
            return
        h, payload = pdu.am_decode(data, self.cfg.sn_size)
        if h.poll:
            self._status_required = True
        # outside rx window (already delivered) → duplicate, drop
        if ((h.sn - self.rx_next) % self.mod) >= self.window:
            return
        if h.sn in self._rx_complete:
            return
        if h.si == pdu.SI_FULL:
            self._rx_complete[h.sn] = payload
            self._rx_segs.pop(h.sn, None)
            self._rx_total.pop(h.sn, None)
        else:
            so = h.so if h.si != pdu.SI_FIRST else 0
            store = self._rx_segs.setdefault(h.sn, {})
            store[so] = payload
            if h.si == pdu.SI_LAST:
                self._rx_total[h.sn] = so + len(payload)
            self._try_complete(h.sn)
        nxt = (h.sn + 1) % self.mod
        if self._sn_lt(self.rx_next_highest, nxt):
            self.rx_next_highest = nxt
        self._deliver_in_order()
        if self._missing_sns():
            if (self._t_reassembly is not None
                    and not self._t_reassembly.is_running()):
                self._t_reassembly.run()
        elif self._t_reassembly is not None:
            self._t_reassembly.stop()

    def _try_complete(self, sn: int) -> None:
        if sn not in self._rx_total:
            return
        store = self._rx_segs.get(sn, {})
        out = bytearray()
        expect = 0
        for so in sorted(store):
            if so > expect:
                return
            piece = store[so]
            if so + len(piece) <= expect:
                continue              # fully-overlapping duplicate
            out += piece[expect - so:]
            expect = so + len(piece)
        if expect == self._rx_total[sn]:
            self._rx_complete[sn] = bytes(out)
            del self._rx_segs[sn]
            del self._rx_total[sn]

    def _deliver_in_order(self) -> None:
        while self.rx_next in self._rx_complete:
            self._on_sdu(self._rx_complete.pop(self.rx_next))
            self.rx_next = (self.rx_next + 1) % self.mod

    def _missing_sns(self) -> list[int]:
        out = []
        sn = self.rx_next
        while sn != self.rx_next_highest:
            if sn not in self._rx_complete:
                out.append(sn)
            sn = (sn + 1) % self.mod
        return out

    def _on_reassembly_expiry(self) -> None:
        self._status_required = True

    def _build_status(self) -> bytes:
        nacks = []
        for sn in self._missing_sns():
            if sn in self._rx_segs:
                # NACK the holes of a partially-received SDU
                store = self._rx_segs[sn]
                expect = 0
                for so in sorted(store):
                    if so > expect:
                        nacks.append(pdu.StatusNack(
                            sn, expect, so - 1, has_so=True))
                    expect = max(expect, so + len(store[so]))
                total = self._rx_total.get(sn)
                if total is None or expect < total:
                    nacks.append(pdu.StatusNack(sn, expect, 0xFFFF,
                                                has_so=True))
            else:
                nacks.append(pdu.StatusNack(sn))
        return pdu.status_encode(
            pdu.StatusPdu(self.rx_next_highest, nacks, self.cfg.sn_size))

    # ---------------------------------------------------------- TX status
    def _handle_status(self, status: pdu.StatusPdu) -> None:
        nacked = {n.sn for n in status.nacks}
        # ack everything below ACK_SN that is not NACKed
        sn = self.tx_next_ack
        while sn != status.ack_sn and sn != self.tx_next:
            if sn not in nacked and sn in self._tx_window:
                self._tx_window.pop(sn)
                self._on_delivered(sn)
            sn = (sn + 1) % self.mod
        # advance tx_next_ack past contiguously-acked SNs
        while (self.tx_next_ack != self.tx_next
               and self.tx_next_ack not in self._tx_window):
            self.tx_next_ack = (self.tx_next_ack + 1) % self.mod
        for n in status.nacks:
            if n.sn not in self._tx_window:
                continue
            if n.has_so:
                end = len(self._tx_window[n.sn].sdu) if n.so_end == 0xFFFF \
                    else n.so_end + 1
                self._queue_retx(n.sn, n.so_start, end)
            else:
                for k in range(max(1, n.range or 1)):
                    self._queue_retx((n.sn + k) % self.mod, 0, 1 << 30)
        if self._t_poll is not None:
            if self.tx_next_ack == self.tx_next:
                self._t_poll.stop()          # everything acked
            elif not self._t_poll.is_running():
                self._t_poll.run()           # still outstanding: keep polling
