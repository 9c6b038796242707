"""RLC TM: transparent mode (TS 38.322 §5.2.1; reference
lib/rlc/rlc_tx_tm_entity.cpp) — no header, no segmentation; used for
SRB0 / broadcast."""
from __future__ import annotations

from collections import deque
from typing import Callable, Optional


class RlcTmTx:
    def __init__(self) -> None:
        self._q: deque[bytes] = deque()

    def handle_sdu(self, sdu: bytes) -> None:
        self._q.append(bytes(sdu))

    def buffer_state(self) -> int:
        return sum(len(s) for s in self._q)

    def pull_pdu(self, nof_bytes: int) -> bytes:
        """TM cannot segment: only serves the front SDU if it fits."""
        if not self._q or len(self._q[0]) > nof_bytes:
            return b""
        return self._q.popleft()


class RlcTmRx:
    def __init__(self, on_sdu: Callable[[bytes], None]) -> None:
        self._on_sdu = on_sdu

    def handle_pdu(self, pdu: bytes) -> None:
        self._on_sdu(bytes(pdu))
