"""F1AP (TS 38.473; reference lib/f1ap): DU ↔ CU-CP control plane.

Procedures covered (the ones the reference exercises in cu_du
integration tests): F1 Setup, Initial UL RRC Message Transfer, DL/UL RRC
Message Transfer, UE Context Setup, UE Context Release.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .. import asn1


@asn1.message(0x201, proc=1)
class F1SetupRequest:
    gnb_du_id: int = 0
    gnb_du_name: str = "du"
    served_cells: list = dataclasses.field(default_factory=list)  # pci list


@asn1.message(0x202, proc=1, kind="successful")
class F1SetupResponse:
    gnb_cu_name: str = "cu-cp"
    cells_to_activate: list = dataclasses.field(default_factory=list)


@asn1.message(0x203, proc=11)
class InitialUlRrcMessageTransfer:
    gnb_du_ue_id: int = 0
    c_rnti: int = 0
    pci: int = 0
    rrc_container: bytes = b""        # CCCH (RRCSetupRequest)
    # DUtoCURRCContainer (TS 38.473 §9.3.1.25): the DU's CellGroupConfig
    # (incl. its PUCCH resource allocation) for the CU to embed in
    # RRCSetup's masterCellGroup
    du_to_cu_rrc_container: bytes = b""


@asn1.message(0x204, proc=12)
class DlRrcMessageTransfer:
    gnb_cu_ue_id: int = 0
    gnb_du_ue_id: int = 0
    srb_id: int = 0
    rrc_container: bytes = b""


@asn1.message(0x205, proc=13)
class UlRrcMessageTransfer:
    gnb_cu_ue_id: int = 0
    gnb_du_ue_id: int = 0
    srb_id: int = 1
    rrc_container: bytes = b""


@asn1.message(0x206, proc=5)
class UeContextSetupRequest:
    gnb_cu_ue_id: int = 0
    gnb_du_ue_id: int = 0
    srbs_to_setup: list = dataclasses.field(default_factory=list)
    drbs_to_setup: list = dataclasses.field(default_factory=list)  # DrbItem


@asn1.message(0x207, proc=5, kind="successful")
class UeContextSetupResponse:
    gnb_cu_ue_id: int = 0
    gnb_du_ue_id: int = 0
    drbs_setup: list = dataclasses.field(default_factory=list)


@asn1.message(0x208, proc=6)
class UeContextReleaseCommand:
    gnb_cu_ue_id: int = 0
    gnb_du_ue_id: int = 0
    cause: str = "normal"


@asn1.message(0x209, proc=6, kind="successful")
class UeContextReleaseComplete:
    gnb_cu_ue_id: int = 0
    gnb_du_ue_id: int = 0


@asn1.message(0x20A, proc=200)
class DrbItem:
    drb_id: int = 1
    lcid: int = 4
    rlc_mode: str = "am"
    qfi: int = 9


class F1apDu:
    """DU-side F1AP endpoint (lib/f1ap/du/f1ap_du_impl.cpp)."""

    def __init__(self, send: Callable[[bytes], None], gnb_du_id: int = 1
                 ) -> None:
        self._send = send
        self.gnb_du_id = gnb_du_id
        self._next_due_id = 1
        self.ue_ids: dict[int, int] = {}        # du_ue_id -> cu_ue_id
        self.on_dl_rrc: Callable[[int, int, bytes], None] = \
            lambda due, srb, cont: None
        self.on_ue_context_setup: Callable[[UeContextSetupRequest], list] = \
            lambda req: []
        self.on_ue_release: Callable[[int], None] = lambda due: None
        self.setup_done = False

    def f1_setup(self, served_cells: list[int]) -> None:
        self._send(asn1.encode(F1SetupRequest(self.gnb_du_id, "tpu-du",
                                              served_cells)))

    def allocate_due_id(self) -> int:
        due = self._next_due_id
        self._next_due_id += 1
        return due

    def initial_ul_rrc(self, due: int, c_rnti: int, pci: int,
                       rrc_container: bytes,
                       du_to_cu_rrc_container: bytes = b"") -> None:
        """due must come from allocate_due_id() — the CU may answer
        synchronously, so the caller's UE context must exist first."""
        self._send(asn1.encode(InitialUlRrcMessageTransfer(
            due, c_rnti, pci, rrc_container, du_to_cu_rrc_container)))

    def ul_rrc(self, due: int, srb_id: int, container: bytes) -> None:
        cue = self.ue_ids.get(due, 0)
        self._send(asn1.encode(UlRrcMessageTransfer(cue, due, srb_id,
                                                    container)))

    def handle_message(self, data: bytes) -> None:
        msg = asn1.decode(data)
        if isinstance(msg, F1SetupResponse):
            self.setup_done = True
        elif isinstance(msg, DlRrcMessageTransfer):
            self.ue_ids[msg.gnb_du_ue_id] = msg.gnb_cu_ue_id
            self.on_dl_rrc(msg.gnb_du_ue_id, msg.srb_id, msg.rrc_container)
        elif isinstance(msg, UeContextSetupRequest):
            self.ue_ids[msg.gnb_du_ue_id] = msg.gnb_cu_ue_id
            drbs = self.on_ue_context_setup(msg)
            self._send(asn1.encode(UeContextSetupResponse(
                msg.gnb_cu_ue_id, msg.gnb_du_ue_id, drbs)))
        elif isinstance(msg, UeContextReleaseCommand):
            self.on_ue_release(msg.gnb_du_ue_id)
            self._send(asn1.encode(UeContextReleaseComplete(
                msg.gnb_cu_ue_id, msg.gnb_du_ue_id)))


class F1apCu:
    """CU-side F1AP endpoint (lib/f1ap/cu_cp/f1ap_cu_impl.cpp)."""

    def __init__(self, send: Callable[[bytes], None]) -> None:
        self._send = send
        self._next_cue_id = 1
        self.on_f1_setup: Callable[[F1SetupRequest], None] = lambda m: None
        self.on_initial_ul_rrc: Callable[
            [int, InitialUlRrcMessageTransfer], None] = lambda cue, m: None
        self.on_ul_rrc: Callable[[int, int, bytes], None] = \
            lambda cue, srb, cont: None
        self.on_ue_context_setup_response: Callable[
            [UeContextSetupResponse], None] = lambda m: None
        self.cue_to_due: dict[int, int] = {}

    def handle_message(self, data: bytes) -> None:
        msg = asn1.decode(data)
        if isinstance(msg, F1SetupRequest):
            self.on_f1_setup(msg)
            self._send(asn1.encode(F1SetupResponse(
                "tpu-cu", msg.served_cells)))
        elif isinstance(msg, InitialUlRrcMessageTransfer):
            cue = self._next_cue_id
            self._next_cue_id += 1
            self.cue_to_due[cue] = msg.gnb_du_ue_id
            self.on_initial_ul_rrc(cue, msg)
        elif isinstance(msg, UlRrcMessageTransfer):
            self.on_ul_rrc(msg.gnb_cu_ue_id, msg.srb_id, msg.rrc_container)
        elif isinstance(msg, UeContextSetupResponse):
            self.on_ue_context_setup_response(msg)
        elif isinstance(msg, UeContextReleaseComplete):
            self.cue_to_due.pop(msg.gnb_cu_ue_id, None)

    def dl_rrc(self, cue: int, srb_id: int, container: bytes) -> None:
        self._send(asn1.encode(DlRrcMessageTransfer(
            cue, self.cue_to_due.get(cue, 0), srb_id, container)))

    def ue_context_setup(self, cue: int, srbs: list, drbs: list) -> None:
        self._send(asn1.encode(UeContextSetupRequest(
            cue, self.cue_to_due.get(cue, 0), srbs,
            [asn1.encode(d) for d in drbs])))

    def ue_release(self, cue: int, cause: str = "normal") -> None:
        self._send(asn1.encode(UeContextReleaseCommand(
            cue, self.cue_to_due.get(cue, 0), cause)))
