"""PDCP layer (TS 38.323; reference lib/pdcp).

TX/RX entity pair per radio bearer: SN/COUNT maintenance, header
(de)serialization, ciphering + integrity via the security module,
t-Reordering with in-order delivery — the reference's
pdcp_entity_tx/pdcp_entity_rx re-expressed compactly.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Callable, Optional

from .. import security as sec
from ..support.timers import TimerManager


@dataclasses.dataclass
class PdcpConfig:
    sn_size: int = 12                 # 12 or 18
    is_srb: bool = False
    integrity: bool = False           # always True for SRBs in practice
    ciphering: bool = True
    t_reordering: int = 100           # ticks; 0 = infinity/disabled
    bearer_id: int = 1                # BEARER for the security algorithms
    direction: int = 1                # tx direction (1 = downlink for gNB)


class PdcpTx:
    def __init__(self, cfg: PdcpConfig, ctx: Optional[sec.SecurityContext],
                 on_pdu: Callable[[bytes], None]) -> None:
        self.cfg = cfg
        self.ctx = ctx
        self._on_pdu = on_pdu
        self.tx_next = 0              # COUNT of next SDU

    @property
    def _sn_mask(self) -> int:
        return (1 << self.cfg.sn_size) - 1

    def _header(self, sn: int) -> bytes:
        if self.cfg.sn_size == 12:
            first = (0 if self.cfg.is_srb else 0x80) | ((sn >> 8) & 0x0F)
            return bytes([first, sn & 0xFF])
        return bytes([0x80 | ((sn >> 16) & 0x03), (sn >> 8) & 0xFF,
                      sn & 0xFF])

    def handle_sdu(self, sdu: bytes) -> None:
        count = self.tx_next
        sn = count & self._sn_mask
        hdr = self._header(sn)
        pdu = bytes(sdu)
        if self.ctx is not None and self.cfg.integrity:
            key = self.ctx.k_rrc_int if self.cfg.is_srb else self.ctx.k_up_int
            mac = sec.integrity_mac(self.ctx.integrity, key, count,
                                    self.cfg.bearer_id - 1,
                                    self.cfg.direction, hdr + pdu)
            pdu += mac
        if self.ctx is not None and self.cfg.ciphering:
            key = self.ctx.k_rrc_enc if self.cfg.is_srb else self.ctx.k_up_enc
            pdu = sec.cipher(self.ctx.ciphering, key, count,
                             self.cfg.bearer_id - 1, self.cfg.direction, pdu)
        self.tx_next += 1
        self._on_pdu(hdr + pdu)


class PdcpRx:
    def __init__(self, cfg: PdcpConfig, ctx: Optional[sec.SecurityContext],
                 on_sdu: Callable[[bytes], None],
                 timers: Optional[TimerManager] = None,
                 on_integrity_failure: Optional[Callable[[int], None]] = None
                 ) -> None:
        self.cfg = cfg
        self.ctx = ctx
        self._on_sdu = on_sdu
        self._on_integrity_failure = on_integrity_failure or (lambda c: None)
        self.rx_deliv = 0             # COUNT of first not-delivered SDU
        self.rx_next = 0              # COUNT following highest received
        self._store: dict[int, bytes] = {}
        self._t_reordering = None
        self._rx_reord = 0
        if timers is not None and cfg.t_reordering:
            self._t_reordering = timers.create_timer()
            self._t_reordering.set(cfg.t_reordering, self._on_reordering)
        # the peer transmits with the opposite direction bit
        self._rx_direction = 1 - cfg.direction

    @property
    def _window(self) -> int:
        return 1 << (self.cfg.sn_size - 1)

    def _rcvd_count(self, rcvd_sn: int) -> int:
        """TS 38.323 §5.2.2.1 HFN inference."""
        sn_mod = 1 << self.cfg.sn_size
        deliv_sn = self.rx_deliv & (sn_mod - 1)
        deliv_hfn = self.rx_deliv >> self.cfg.sn_size
        if rcvd_sn < deliv_sn - self._window:
            hfn = deliv_hfn + 1
        elif rcvd_sn >= deliv_sn + self._window:
            hfn = deliv_hfn - 1
        else:
            hfn = deliv_hfn
        return (hfn << self.cfg.sn_size) | rcvd_sn

    def handle_pdu(self, data: bytes) -> None:
        if self.cfg.sn_size == 12:
            sn = ((data[0] & 0x0F) << 8) | data[1]
            hdr, payload = data[:2], data[2:]
        else:
            sn = ((data[0] & 0x03) << 16) | (data[1] << 8) | data[2]
            hdr, payload = data[:3], data[3:]
        count = self._rcvd_count(sn)
        if self.ctx is not None and self.cfg.ciphering:
            key = self.ctx.k_rrc_enc if self.cfg.is_srb else self.ctx.k_up_enc
            payload = sec.cipher(self.ctx.ciphering, key, count,
                                 self.cfg.bearer_id - 1, self._rx_direction,
                                 payload)
        if self.ctx is not None and self.cfg.integrity:
            key = self.ctx.k_rrc_int if self.cfg.is_srb else self.ctx.k_up_int
            mac, payload = payload[-4:], payload[:-4]
            exp = sec.integrity_mac(self.ctx.integrity, key, count,
                                    self.cfg.bearer_id - 1,
                                    self._rx_direction, hdr + payload)
            if mac != exp:
                self._on_integrity_failure(count)
                return
        if count < self.rx_deliv or count in self._store:
            return                    # duplicate / already delivered
        self._store[count] = payload
        if count >= self.rx_next:
            self.rx_next = count + 1
        # in-order delivery
        while self.rx_deliv in self._store:
            self._on_sdu(self._store.pop(self.rx_deliv))
            self.rx_deliv += 1
        if self._t_reordering is not None:
            if self.rx_deliv < self.rx_next:
                if not self._t_reordering.is_running():
                    self._rx_reord = self.rx_next
                    self._t_reordering.run()
            else:
                self._t_reordering.stop()

    def _on_reordering(self) -> None:
        """t-Reordering expiry: deliver everything below RX_REORD, then
        any in-order continuation (§5.2.2.2)."""
        for c in sorted(k for k in self._store if k < self._rx_reord):
            self._on_sdu(self._store.pop(c))
        self.rx_deliv = max(self.rx_deliv, self._rx_reord)
        while self.rx_deliv in self._store:
            self._on_sdu(self._store.pop(self.rx_deliv))
            self.rx_deliv += 1
        if self.rx_deliv < self.rx_next:
            self._rx_reord = self.rx_next
            self._t_reordering.run()


class PdcpEntity:
    """Bidirectional PDCP bearer = TX + RX pair sharing config/keys."""

    def __init__(self, cfg: PdcpConfig, ctx: Optional[sec.SecurityContext],
                 on_tx_pdu: Callable[[bytes], None],
                 on_rx_sdu: Callable[[bytes], None],
                 timers: Optional[TimerManager] = None, **rx_kw) -> None:
        self.tx = PdcpTx(cfg, ctx, on_tx_pdu)
        rx_cfg = dataclasses.replace(cfg)
        self.rx = PdcpRx(rx_cfg, ctx, on_rx_sdu, timers, **rx_kw)

    def handle_sdu(self, sdu: bytes) -> None:
        self.tx.handle_sdu(sdu)

    def handle_pdu(self, pdu: bytes) -> None:
        self.rx.handle_pdu(pdu)
