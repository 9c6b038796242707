"""E2 agent (O-RAN E2AP; reference lib/e2): RIC interface with E2 Setup,
RIC Subscription and periodic KPM-style indications fed from the
scheduler UE metrics (e2_impl.cpp + procedures/)."""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Optional

from .. import asn1


@asn1.message(0x501)
class E2SetupRequest:
    gnb_id: int = 1
    ran_functions: list = dataclasses.field(
        default_factory=lambda: ["ORAN-E2SM-KPM"])


@asn1.message(0x502)
class E2SetupResponse:
    accepted_functions: list = dataclasses.field(default_factory=list)


@asn1.message(0x503)
class RicSubscriptionRequest:
    request_id: int = 1
    ran_function: str = "ORAN-E2SM-KPM"
    report_period_slots: int = 100


@asn1.message(0x504)
class RicSubscriptionResponse:
    request_id: int = 1
    admitted: bool = True


@asn1.message(0x505)
class RicIndication:
    request_id: int = 1
    sn: int = 0
    payload: bytes = b""              # JSON KPM report


class E2Agent:
    """gNB-side agent: answers subscriptions and pushes periodic metric
    indications when ticked by the slot loop."""

    def __init__(self, send: Callable[[bytes], None], scheduler) -> None:
        self._send = send
        self._scheduler = scheduler
        self.setup_done = False
        self._subs: dict[int, int] = {}      # request_id -> period
        self._sn = 0

    def start(self) -> None:
        self._send(asn1.encode(E2SetupRequest()))

    def handle_message(self, data: bytes) -> None:
        msg = asn1.decode(data)
        if isinstance(msg, E2SetupResponse):
            self.setup_done = True
        elif isinstance(msg, RicSubscriptionRequest):
            self._subs[msg.request_id] = msg.report_period_slots
            self._send(asn1.encode(RicSubscriptionResponse(msg.request_id,
                                                           True)))

    def on_slot(self, slot: int) -> None:
        for req_id, period in self._subs.items():
            if slot % period == 0 and slot:
                report = {str(rnti): {
                    "dl_bytes": ue.dl_bytes, "ul_bytes": ue.ul_bytes,
                    "dl_ok": ue.dl_nof_ok, "dl_ko": ue.dl_nof_ko,
                    "ul_ok": ue.ul_nof_ok, "ul_ko": ue.ul_nof_ko}
                    for rnti, ue in self._scheduler.ues.items()}
                self._sn += 1
                self._send(asn1.encode(RicIndication(
                    req_id, self._sn, json.dumps(report).encode())))


class RicStub:
    """Near-RT RIC double for tests."""

    def __init__(self, send: Callable[[bytes], None]) -> None:
        self._send = send
        self.indications: list[dict] = []

    def handle_message(self, data: bytes) -> None:
        msg = asn1.decode(data)
        if isinstance(msg, E2SetupRequest):
            self._send(asn1.encode(E2SetupResponse(msg.ran_functions)))
            self._send(asn1.encode(RicSubscriptionRequest(1,
                                                          msg.ran_functions[0]
                                                          if msg.ran_functions
                                                          else "KPM", 50)))
        elif isinstance(msg, RicIndication):
            self.indications.append(json.loads(msg.payload.decode()))
