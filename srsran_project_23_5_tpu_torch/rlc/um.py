"""RLC UM: unacknowledged mode with segmentation (TS 38.322 §5.2.2;
reference lib/rlc/rlc_tx_um_entity.cpp / rlc_rx_um_entity.cpp).

TX assigns a SN only to segmented SDUs; RX reassembles out-of-order
segments within a window of UM_Window_Size = 2^(snLen-1) and runs
t-Reassembly against holes.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Optional

from ..support.timers import TimerManager
from . import pdu


class RlcUmTx:
    def __init__(self, sn_size: int = 6) -> None:
        self.sn_size = sn_size
        self.mod = 1 << sn_size
        self.tx_next = 0
        self._q: deque[bytes] = deque()
        self._seg: Optional[tuple[bytes, int]] = None  # (sdu, next offset)

    def handle_sdu(self, sdu: bytes) -> None:
        self._q.append(bytes(sdu))

    def buffer_state(self) -> int:
        n = sum(len(s) + 1 for s in self._q)
        if self._seg is not None:
            sdu, off = self._seg
            n += len(sdu) - off + 5
        return n

    def pull_pdu(self, nof_bytes: int) -> bytes:
        """Serve at most nof_bytes; segments across opportunities."""
        if self._seg is not None:
            sdu, off = self._seg
            hdr_len = 3 if self.sn_size == 6 else 4
            room = nof_bytes - hdr_len
            if room <= 0:
                return b""
            rest = len(sdu) - off
            if room >= rest:
                h = pdu.UmHeader(pdu.SI_LAST, self.tx_next, off, self.sn_size)
                self._seg = None
                self.tx_next = (self.tx_next + 1) % self.mod
                return pdu.um_encode(h) + sdu[off:]
            h = pdu.UmHeader(pdu.SI_MIDDLE, self.tx_next, off, self.sn_size)
            self._seg = (sdu, off + room)
            return pdu.um_encode(h) + sdu[off:off + room]
        if not self._q:
            return b""
        sdu = self._q[0]
        if len(sdu) + 1 <= nof_bytes:
            self._q.popleft()
            return pdu.um_encode(pdu.UmHeader(pdu.SI_FULL,
                                              sn_size=self.sn_size)) + sdu
        hdr_len = 1 if self.sn_size == 6 else 2
        room = nof_bytes - hdr_len
        if room <= 0:
            return b""
        self._q.popleft()
        h = pdu.UmHeader(pdu.SI_FIRST, self.tx_next, 0, self.sn_size)
        self._seg = (sdu, room)
        return pdu.um_encode(h) + sdu[:room]


class RlcUmRx:
    def __init__(self, on_sdu: Callable[[bytes], None], sn_size: int = 6,
                 timers: Optional[TimerManager] = None,
                 t_reassembly: int = 35) -> None:
        self._on_sdu = on_sdu
        self.sn_size = sn_size
        self.mod = 1 << sn_size
        self.window = 1 << (sn_size - 1)
        # per-SN segment store: sn -> {so: bytes}, and last-seg total size
        self._segs: dict[int, dict[int, bytes]] = {}
        self._total: dict[int, int] = {}
        self.rx_next_reassembly = 0
        self._timers = timers
        self._t_reassembly = None
        if timers is not None:
            self._t_reassembly = timers.create_timer()
            self._t_reassembly.set(t_reassembly, self._on_reassembly_expiry)

    def handle_pdu(self, data: bytes) -> None:
        h, payload = pdu.um_decode(data, self.sn_size)
        if h.si == pdu.SI_FULL:
            self._on_sdu(payload)
            return
        so = h.so if h.si != pdu.SI_FIRST else 0
        store = self._segs.setdefault(h.sn, {})
        store[so] = payload
        if h.si == pdu.SI_LAST:
            self._total[h.sn] = so + len(payload)
        self._try_reassemble(h.sn)
        if (self._t_reassembly is not None and self._segs
                and not self._t_reassembly.is_running()):
            self._t_reassembly.run()

    def _try_reassemble(self, sn: int) -> None:
        if sn not in self._total:
            return
        store = self._segs.get(sn, {})
        out = bytearray()
        expect = 0
        for so in sorted(store):
            if so != expect:
                return            # hole
            out += store[so]
            expect += len(store[so])
        if expect == self._total[sn]:
            del self._segs[sn]
            del self._total[sn]
            self._on_sdu(bytes(out))

    def _on_reassembly_expiry(self) -> None:
        """Discard stale partial SDUs (simplified §5.2.2.2.4 action)."""
        self._segs.clear()
        self._total.clear()
