"""RRC (TS 38.331; reference lib/rrc): message set + gNB-side UE FSM.

Messages carry the IEs the procedures actually consume (cause values,
transaction ids, security algorithms, radio-bearer configs); serialization
via the asn1 codec runtime. The CU-CP drives RrcUe through the connection
setup / security / reconfiguration procedures exactly like the
reference's rrc_ue_impl procedures.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .. import asn1
from .. import security as sec


# ------------------------------------------------------------- messages
@asn1.message(0x101)
class RrcSetupRequest:
    ue_identity: bytes = b""          # 39-bit random / 5G-S-TMSI part
    establishment_cause: str = "mo-Data"


@asn1.message(0x102)
class RrcSetup:
    transaction_id: int = 0
    srb1_config: bytes = b""          # opaque radioBearerConfig


@asn1.message(0x103)
class RrcSetupComplete:
    transaction_id: int = 0
    selected_plmn: int = 1
    dedicated_nas_message: bytes = b""


@asn1.message(0x104)
class RrcSecurityModeCommand:
    transaction_id: int = 0
    ciphering_algorithm: int = 2      # NEA2
    integrity_algorithm: int = 2      # NIA2


@asn1.message(0x105)
class RrcSecurityModeComplete:
    transaction_id: int = 0


@asn1.message(0x106)
class RrcReconfiguration:
    transaction_id: int = 0
    drb_configs: list = dataclasses.field(default_factory=list)
    nas_messages: list = dataclasses.field(default_factory=list)


@asn1.message(0x107)
class RrcReconfigurationComplete:
    transaction_id: int = 0


@asn1.message(0x108)
class RrcDlInformationTransfer:
    nas_message: bytes = b""


@asn1.message(0x109)
class RrcUlInformationTransfer:
    nas_message: bytes = b""


@asn1.message(0x10A)
class RrcRelease:
    transaction_id: int = 0


@asn1.message(0x10B)
class DrbConfig:
    drb_id: int = 1
    lcid: int = 4
    pdcp_sn_size: int = 12
    qfi: int = 9


# ------------------------------------------------- 38.331 wire codec
# The dataclasses above are the in-framework API; on the wire every
# message is the EXACT TS 38.331 UNALIGNED-PER encoding produced by
# `messages_38331` (CCCH on SRB0, DCCH on SRB1) — e.g. the
# RRCSetupRequest below is the canonical 6-octet Msg3 payload.
from . import messages_38331 as m38331  # noqa: E402


def _id39(identity: bytes) -> tuple[int, int]:
    return (int.from_bytes(identity, "big") & ((1 << 39) - 1), 39)


def encode_setup_request(msg: RrcSetupRequest) -> bytes:
    return m38331.encode_ul_ccch("rrcSetupRequest", {
        "rrcSetupRequest": {
            "ue-Identity": ("randomValue", _id39(msg.ue_identity)),
            "establishmentCause": msg.establishment_cause,
            "spare": (0, 1)}})


def decode_setup_request(data: bytes) -> RrcSetupRequest:
    alt, body = m38331.decode_ul_ccch(data)
    if alt != "rrcSetupRequest":
        raise ValueError(f"unexpected UL-CCCH message {alt}")
    ies = body["rrcSetupRequest"]
    val, _n = ies["ue-Identity"][1]
    return RrcSetupRequest(val.to_bytes(5, "big"),
                           ies["establishmentCause"])


def _drb_to_add_mod(d: DrbConfig, default: bool) -> dict:
    sn = f"len{d.pdcp_sn_size}bits"
    return {
        "cnAssociation": ("sdap-Config", {
            "pdu-Session": 1, "sdap-HeaderDL": "absent",
            "sdap-HeaderUL": "absent", "defaultDRB": default,
            "mappedQoS-FlowsToAdd": [d.qfi]}),
        "drb-Identity": d.drb_id,
        "pdcp-Config": {"drb": {
            "pdcp-SN-SizeUL": sn, "pdcp-SN-SizeDL": sn,
            "headerCompression": ("notUsed", {})}},
    }


def _drb_from_add_mod(item: dict, cell_group: dict) -> DrbConfig:
    drb_id = item["drb-Identity"]
    lcid = next(
        (b["logicalChannelIdentity"]
         for b in cell_group.get("rlc-BearerToAddModList", ())
         if b.get("servedRadioBearer") == ("drb-Identity", drb_id)),
        4)
    qfi = 9
    if item.get("cnAssociation", ("", 0))[0] == "sdap-Config":
        qfi = item["cnAssociation"][1].get("mappedQoS-FlowsToAdd", [9])[0]
    sn = item.get("pdcp-Config", {}).get("drb", {}).get(
        "pdcp-SN-SizeUL", "len12bits")
    return DrbConfig(drb_id=drb_id, lcid=lcid,
                     pdcp_sn_size=int(sn[3:-4]), qfi=qfi)


# -------------------------------------------------------------- gNB FSM
class RrcUeState:
    IDLE = "idle"
    SETUP_SENT = "setup-sent"
    CONNECTED = "connected"
    SMC_SENT = "smc-sent"
    SECURE = "secure"
    RECONFIG_SENT = "reconfig-sent"
    ACTIVE = "active"


class RrcUe:
    """gNB (CU-CP) side RRC state machine for one UE
    (reference lib/rrc/ue/rrc_ue_impl.cpp procedures)."""

    def __init__(self, ue_index: int,
                 send_dl: Callable[[bytes], None],
                 on_nas_ul: Optional[Callable[[bytes], None]] = None,
                 on_active: Optional[Callable[["RrcUe"], None]] = None
                 ) -> None:
        self.ue_index = ue_index
        self.state = RrcUeState.IDLE
        self._send_dl = send_dl           # DL-DCCH/CCCH via F1AP→RLC SRB
        self._on_nas_ul = on_nas_ul or (lambda nas: None)
        self._on_active = on_active or (lambda ue: None)
        self._transaction = 0
        self.security_ctx: Optional[sec.SecurityContext] = None
        self.ue_identity = b""
        self.pending_drbs: list = []
        self.setup_complete_nas: bytes = b""

    def _next_transaction(self) -> int:
        self._transaction = (self._transaction + 1) & 3
        return self._transaction

    # -------------------------------------------------------- procedures
    def handle_setup_request(self, msg: RrcSetupRequest,
                             du_cell_group: bytes = b"") -> None:
        self.ue_identity = msg.ue_identity
        # DL-CCCH RRCSetup: SRB1 with default PDCP + the CellGroupConfig
        # container binding SRB1 to LCID 1 (38.331 §5.3.3.4).  When the
        # DU provided its CellGroupConfig (F1AP DUtoCURRCContainer, incl.
        # the DU-allocated dedicated PUCCH resources) it is embedded
        # VERBATIM — the CU does not re-derive DU-owned configuration.
        cg = du_cell_group or m38331.encode_cell_group({
            "cellGroupId": 0,
            "rlc-BearerToAddModList": [{
                "logicalChannelIdentity": 1,
                "servedRadioBearer": ("srb-Identity", 1)}]})
        self._send_dl(m38331.encode_dl_ccch("rrcSetup", {
            "rrc-TransactionIdentifier": self._next_transaction(),
            "criticalExtensions": ("ies", {
                "radioBearerConfig": {
                    "srb-ToAddModList": [{"srb-Identity": 1}]},
                "masterCellGroup": cg})}))
        self.state = RrcUeState.SETUP_SENT

    def start_security(self, k_gnb: bytes, ciphering: int = 2,
                       integrity: int = 2) -> None:
        self.security_ctx = sec.SecurityContext(
            k_gnb, sec.CipheringAlgorithm(ciphering),
            sec.IntegrityAlgorithm(integrity))
        self._send_dl(m38331.encode_dl_dcch("securityModeCommand", {
            "rrc-TransactionIdentifier": self._next_transaction(),
            "criticalExtensions": ("ies", {
                "securityConfigSMC": {"securityAlgorithmConfig": {
                    "cipheringAlgorithm": f"nea{ciphering}",
                    "integrityProtAlgorithm": f"nia{integrity}"}}})}))
        self.state = RrcUeState.SMC_SENT

    def reconfigure(self, drbs: list, nas: list | None = None) -> None:
        self.pending_drbs = drbs
        cg = m38331.encode_cell_group({
            "cellGroupId": 0,
            "rlc-BearerToAddModList": [{
                "logicalChannelIdentity": d.lcid,
                "servedRadioBearer": ("drb-Identity", d.drb_id)}
                for d in drbs]})
        ext: dict = {"masterCellGroup": cg}
        if nas:
            ext["dedicatedNAS-MessageList"] = list(nas)
        self._send_dl(m38331.encode_dl_dcch("rrcReconfiguration", {
            "rrc-TransactionIdentifier": self._next_transaction(),
            "criticalExtensions": ("ies", {
                "radioBearerConfig": {"drb-ToAddModList": [
                    _drb_to_add_mod(d, i == 0)
                    for i, d in enumerate(drbs)]},
                "nonCriticalExtension": ext})}))
        self.state = RrcUeState.RECONFIG_SENT

    def send_dl_nas(self, nas: bytes) -> None:
        self._send_dl(m38331.encode_dl_dcch("dlInformationTransfer", {
            "rrc-TransactionIdentifier": self._next_transaction(),
            "criticalExtensions": ("ies", {
                "dedicatedNAS-Message": nas})}))

    def handle_ul_message(self, data: bytes) -> None:
        alt, body = m38331.decode_ul_dcch(data)
        if alt == "rrcSetupComplete":
            _, ies = body["criticalExtensions"]
            self.state = RrcUeState.CONNECTED
            self.setup_complete_nas = ies["dedicatedNAS-Message"]
            self._on_nas_ul(self.setup_complete_nas)
        elif alt == "securityModeComplete":
            self.state = RrcUeState.SECURE
        elif alt == "rrcReconfigurationComplete":
            self.state = RrcUeState.ACTIVE
            self._on_active(self)
        elif alt == "ulInformationTransfer":
            _, ies = body["criticalExtensions"]
            self._on_nas_ul(ies.get("dedicatedNAS-Message", b""))


class RrcUeSide:
    """UE-side mini RRC used in loopback/integration tests (the reference
    tests against srsUE / test doubles; this is the in-framework double)."""

    def __init__(self, send_ul: Callable[[bytes], None]) -> None:
        self._send_ul = send_ul
        self.state = RrcUeState.IDLE
        self.drbs: list = []
        self.ciphering = 0
        self.integrity = 0
        self.nas_rx: list[bytes] = []
        # dedicated PUCCH resources from RRCSetup's masterCellGroup
        # (sr, csi) dicts — see m38331.parse_sp_cell_config
        self.pucch_cfg: tuple | None = None

    def connect(self, ue_identity: bytes, nas: bytes = b"") -> bytes:
        """Returns the CCCH RRCSetupRequest payload for Msg3 — the
        canonical 6-octet 38.331 UPER encoding."""
        self._pending_nas = nas
        return encode_setup_request(RrcSetupRequest(ue_identity, "mo-Data"))

    def handle_dl_message(self, data: bytes) -> None:
        # SRB0 (pre-connection) carries DL-CCCH; SRB1 carries DL-DCCH
        if self.state == RrcUeState.IDLE:
            alt, body = m38331.decode_dl_ccch(data)
            if alt != "rrcSetup":
                return
            _, setup_ies = body["criticalExtensions"]
            cg = m38331.decode_cell_group(setup_ies["masterCellGroup"])
            if "spCellConfig" in cg:
                self.pucch_cfg = m38331.parse_sp_cell_config(
                    cg["spCellConfig"])
            self.state = RrcUeState.CONNECTED
            self._send_ul(m38331.encode_ul_dcch("rrcSetupComplete", {
                "rrc-TransactionIdentifier":
                    body["rrc-TransactionIdentifier"],
                "criticalExtensions": ("ies", {
                    "selectedPLMN-Identity": 1,
                    "dedicatedNAS-Message":
                        getattr(self, "_pending_nas", b"")})}))
            return
        alt, body = m38331.decode_dl_dcch(data)
        if alt == "securityModeCommand":
            _, ies = body["criticalExtensions"]
            alg = ies["securityConfigSMC"]["securityAlgorithmConfig"]
            self.ciphering = int(alg["cipheringAlgorithm"][3:])
            self.integrity = int(alg["integrityProtAlgorithm"][3:])
            self.state = RrcUeState.SECURE
            self._send_ul(m38331.encode_ul_dcch("securityModeComplete", {
                "rrc-TransactionIdentifier":
                    body["rrc-TransactionIdentifier"],
                "criticalExtensions": ("ies", {})}))
        elif alt == "rrcReconfiguration":
            _, ies = body["criticalExtensions"]
            ext = ies.get("nonCriticalExtension", {})
            cg = m38331.decode_cell_group(ext["masterCellGroup"]) \
                if "masterCellGroup" in ext else {}
            self.drbs = [
                _drb_from_add_mod(item, cg)
                for item in ies.get("radioBearerConfig", {}).get(
                    "drb-ToAddModList", ())]
            self.nas_rx.extend(ext.get("dedicatedNAS-MessageList", ()))
            self.state = RrcUeState.ACTIVE
            self._send_ul(m38331.encode_ul_dcch(
                "rrcReconfigurationComplete", {
                    "rrc-TransactionIdentifier":
                        body["rrc-TransactionIdentifier"],
                    "criticalExtensions": ("ies", {})}))
        elif alt == "dlInformationTransfer":
            _, ies = body["criticalExtensions"]
            self.nas_rx.append(ies.get("dedicatedNAS-Message", b""))
