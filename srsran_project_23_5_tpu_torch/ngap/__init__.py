"""NGAP (TS 38.413; reference lib/ngap): CU-CP ↔ AMF control plane.

Procedures: NG Setup, Initial UE Message, DL/UL NAS Transport, Initial
Context Setup, PDU Session Resource Setup, UE Context Release.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from .. import asn1


@asn1.message(0x301, proc=21)
class NgSetupRequest:
    gnb_id: int = 1
    ran_node_name: str = "tpu-gnb"
    plmn: int = 100101
    tac: int = 7


@asn1.message(0x302, proc=21, kind="successful")
class NgSetupResponse:
    amf_name: str = "amf"
    served_guami: int = 0
    relative_capacity: int = 255


@asn1.message(0x303, proc=15)
class InitialUeMessage:
    ran_ue_id: int = 0
    nas_pdu: bytes = b""
    establishment_cause: str = "mo-Data"
    tac: int = 7


@asn1.message(0x304, proc=4)
class DownlinkNasTransport:
    amf_ue_id: int = 0
    ran_ue_id: int = 0
    nas_pdu: bytes = b""


@asn1.message(0x305, proc=46)
class UplinkNasTransport:
    amf_ue_id: int = 0
    ran_ue_id: int = 0
    nas_pdu: bytes = b""


@asn1.message(0x306, proc=14)
class InitialContextSetupRequest:
    amf_ue_id: int = 0
    ran_ue_id: int = 0
    security_key: bytes = b""         # K_gNB (32 bytes)
    pdu_sessions: list = dataclasses.field(default_factory=list)
    nas_pdu: bytes = b""


@asn1.message(0x307, proc=14, kind="successful")
class InitialContextSetupResponse:
    amf_ue_id: int = 0
    ran_ue_id: int = 0


@asn1.message(0x308, proc=29)
class PduSessionResourceSetupRequest:
    amf_ue_id: int = 0
    ran_ue_id: int = 0
    sessions: list = dataclasses.field(default_factory=list)  # PduSessionItem


@asn1.message(0x309, proc=29, kind="successful")
class PduSessionResourceSetupResponse:
    amf_ue_id: int = 0
    ran_ue_id: int = 0
    sessions_setup: list = dataclasses.field(default_factory=list)


@asn1.message(0x30A, proc=41)
class UeContextReleaseCommand:
    amf_ue_id: int = 0
    ran_ue_id: int = 0
    cause: str = "normal"


@asn1.message(0x30B, proc=41, kind="successful")
class UeContextReleaseComplete:
    amf_ue_id: int = 0
    ran_ue_id: int = 0


@asn1.message(0x30C, proc=200)
class PduSessionItem:
    session_id: int = 1
    qfi: int = 9
    ul_teid: int = 0                  # core's NG-U tunnel endpoint
    dl_teid: int = 0                  # gNB's (filled in response)
    session_ambr: int = 10 ** 9


class NgapCuCp:
    """CU-CP side NGAP endpoint (lib/ngap/ngap_impl.cpp)."""

    def __init__(self, send: Callable[[bytes], None]) -> None:
        self._send = send
        self.setup_done = False
        self.on_dl_nas: Callable[[int, bytes], None] = lambda rid, nas: None
        self.on_initial_ctx: Callable[[InitialContextSetupRequest], None] = \
            lambda m: None
        self.on_pdu_session_setup: Callable[
            [PduSessionResourceSetupRequest], None] = lambda m: None
        self.on_release: Callable[[int], None] = lambda rid: None

    def ng_setup(self) -> None:
        self._send(asn1.encode(NgSetupRequest()))

    def initial_ue_message(self, ran_ue_id: int, nas: bytes) -> None:
        self._send(asn1.encode(InitialUeMessage(ran_ue_id, nas)))

    def ul_nas(self, amf_ue_id: int, ran_ue_id: int, nas: bytes) -> None:
        self._send(asn1.encode(UplinkNasTransport(amf_ue_id, ran_ue_id,
                                                  nas)))

    def initial_ctx_response(self, amf_ue_id: int, ran_ue_id: int) -> None:
        self._send(asn1.encode(InitialContextSetupResponse(amf_ue_id,
                                                           ran_ue_id)))

    def pdu_session_response(self, amf_ue_id: int, ran_ue_id: int,
                             sessions: list) -> None:
        self._send(asn1.encode(PduSessionResourceSetupResponse(
            amf_ue_id, ran_ue_id, [asn1.encode(s) for s in sessions])))

    def handle_message(self, data: bytes) -> None:
        msg = asn1.decode(data)
        if isinstance(msg, NgSetupResponse):
            self.setup_done = True
        elif isinstance(msg, DownlinkNasTransport):
            self.on_dl_nas(msg.ran_ue_id, msg.nas_pdu)
        elif isinstance(msg, InitialContextSetupRequest):
            self.on_initial_ctx(msg)
        elif isinstance(msg, PduSessionResourceSetupRequest):
            self.on_pdu_session_setup(msg)
        elif isinstance(msg, UeContextReleaseCommand):
            self.on_release(msg.ran_ue_id)
            self._send(asn1.encode(UeContextReleaseComplete(
                msg.amf_ue_id, msg.ran_ue_id)))


class AmfStub:
    """Minimal AMF for integration tests (the reference e2e tests run
    against open5gs/amarisoft cores; this is the in-framework double):
    accepts NG Setup, answers registration NAS, orders Initial Context
    Setup + PDU Session Resource Setup."""

    def __init__(self, send: Callable[[bytes], None],
                 k_gnb: bytes = b"\x07" * 32) -> None:
        self._send = send
        self._next_amf_id = 100
        self.k_gnb = k_gnb
        self.ues: dict[int, int] = {}       # ran_ue_id -> amf_ue_id
        self.sessions_granted: list[int] = []

    def handle_message(self, data: bytes) -> None:
        msg = asn1.decode(data)
        if isinstance(msg, NgSetupRequest):
            self._send(asn1.encode(NgSetupResponse()))
        elif isinstance(msg, InitialUeMessage):
            amf_id = self._next_amf_id
            self._next_amf_id += 1
            self.ues[msg.ran_ue_id] = amf_id
            # registration accept NAS + security context + one PDU session
            self._send(asn1.encode(InitialContextSetupRequest(
                amf_id, msg.ran_ue_id, self.k_gnb,
                [asn1.encode(PduSessionItem(1, 9, ul_teid=0xC0DE))],
                b"nas-registration-accept")))
        elif isinstance(msg, InitialContextSetupResponse):
            pass
        elif isinstance(msg, PduSessionResourceSetupResponse):
            self.sessions_granted.extend(
                asn1.decode(s).session_id for s in msg.sessions_setup)
        elif isinstance(msg, UplinkNasTransport):
            self._send(asn1.encode(DownlinkNasTransport(
                msg.amf_ue_id, msg.ran_ue_id, b"nas-echo:" + msg.nas_pdu)))
