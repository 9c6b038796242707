"""E1AP (TS 38.463; reference lib/e1ap): CU-CP ↔ CU-UP control plane.

Procedures: CU-UP E1 Setup, Bearer Context Setup/Modification/Release.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from .. import asn1


@asn1.message(0x401, proc=3)
class CuUpE1SetupRequest:
    cu_up_id: int = 1
    cu_up_name: str = "tpu-cu-up"


@asn1.message(0x402, proc=3, kind="successful")
class CuUpE1SetupResponse:
    cu_cp_name: str = "tpu-cu-cp"


@asn1.message(0x403, proc=8)
class BearerContextSetupRequest:
    cu_cp_ue_id: int = 0
    security_key: bytes = b""
    pdu_sessions: list = dataclasses.field(default_factory=list)
    # each entry: encoded BearerSessionItem


@asn1.message(0x404, proc=8, kind="successful")
class BearerContextSetupResponse:
    cu_cp_ue_id: int = 0
    cu_up_ue_id: int = 0
    ng_dl_teids: list = dataclasses.field(default_factory=list)


@asn1.message(0x405, proc=11)
class BearerContextReleaseCommand:
    cu_cp_ue_id: int = 0
    cu_up_ue_id: int = 0


@asn1.message(0x406, proc=11, kind="successful")
class BearerContextReleaseComplete:
    cu_cp_ue_id: int = 0
    cu_up_ue_id: int = 0


@asn1.message(0x407, proc=200)
class BearerSessionItem:
    session_id: int = 1
    drb_id: int = 1
    qfi: int = 9
    ul_teid: int = 0        # core NG-U TEID (for UL data to the core)


class E1apCuCp:
    def __init__(self, send: Callable[[bytes], None]) -> None:
        self._send = send
        self.setup_done = False
        self.on_bearer_setup_response: Callable[
            [BearerContextSetupResponse], None] = lambda m: None

    def handle_message(self, data: bytes) -> None:
        msg = asn1.decode(data)
        if isinstance(msg, CuUpE1SetupRequest):
            self.setup_done = True
            self._send(asn1.encode(CuUpE1SetupResponse()))
        elif isinstance(msg, BearerContextSetupResponse):
            self.on_bearer_setup_response(msg)

    def bearer_setup(self, cu_cp_ue_id: int, key: bytes,
                     sessions: list) -> None:
        self._send(asn1.encode(BearerContextSetupRequest(
            cu_cp_ue_id, key, [asn1.encode(s) for s in sessions])))

    def bearer_release(self, cu_cp_ue_id: int, cu_up_ue_id: int) -> None:
        self._send(asn1.encode(BearerContextReleaseCommand(
            cu_cp_ue_id, cu_up_ue_id)))


class E1apCuUp:
    def __init__(self, send: Callable[[bytes], None]) -> None:
        self._send = send
        self.on_bearer_setup: Callable[[BearerContextSetupRequest], tuple] \
            = lambda m: (0, [])
        self.on_bearer_release: Callable[[int], None] = lambda uid: None

    def e1_setup(self) -> None:
        self._send(asn1.encode(CuUpE1SetupRequest()))

    def handle_message(self, data: bytes) -> None:
        msg = asn1.decode(data)
        if isinstance(msg, BearerContextSetupRequest):
            cu_up_ue_id, dl_teids = self.on_bearer_setup(msg)
            self._send(asn1.encode(BearerContextSetupResponse(
                msg.cu_cp_ue_id, cu_up_ue_id, dl_teids)))
        elif isinstance(msg, BearerContextReleaseCommand):
            self.on_bearer_release(msg.cu_up_ue_id)
            self._send(asn1.encode(BearerContextReleaseComplete(
                msg.cu_cp_ue_id, msg.cu_up_ue_id)))
