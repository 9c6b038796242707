"""TS 38.331 RRC message schemas — exact UNALIGNED-PER encodings.

Hand-written ASN.1 schemas (over `asn1.schema` / `asn1.per`) for the
RRC messages the attach flow exchanges, structured field-for-field as
38.331 §6.2/§6.3 declares them (reference: the generated
lib/asn1/rrc_nr.cpp codec): every CHOICE arm, OPTIONAL presence bit,
extension marker and value range below follows the Rel-15 ASN.1, so the
emitted bits are what a third-party 38.331 UPER decoder expects —
e.g. an RRCSetupRequest encodes to exactly 6 octets.

Types that the flow never populates (measConfig, suspendConfig, ROHC
profiles, …) are declared as `_Stub` placeholders: they occupy their
exact position in the presence bitmap but raise if used — declared
scope cut, not silent mis-encoding.

Channel framing (§6.2.1): UL-CCCH / DL-CCCH / UL-DCCH / DL-DCCH
message-type CHOICE wrappers are encoded here as well, so the byte
strings are complete PDCP SDUs for SRB0/SRB1.
"""
from __future__ import annotations

from ..asn1 import schema as S
from ..asn1.per import PerError

UNALIGNED = False   # the RRC transfer syntax is BASIC-PER UNALIGNED


class _Stub(S.Type):
    """Declared-but-unimplemented ASN.1 type: keeps the OPTIONAL bitmap
    layout exact; encoding/decoding a present value is a hard error."""

    def __init__(self, name: str) -> None:
        self.name = name

    def encode(self, w, v):
        raise PerError(f"{self.name}: not implemented in this subset")

    def decode(self, r):
        raise PerError(f"{self.name}: not implemented in this subset")


_true = S.Enumerated(["true"])
EMPTY_SEQ = S.Sequence([])

# ---------------------------------------------------------------- common
RRC_TRANSACTION_ID = S.Integer(0, 3)
DEDICATED_NAS = S.OctetString()

CIPHERING_ALGORITHM = S.Enumerated(
    ["nea0", "nea1", "nea2", "nea3",
     "spare4", "spare3", "spare2", "spare1"], ext=True)
INTEGRITY_ALGORITHM = S.Enumerated(
    ["nia0", "nia1", "nia2", "nia3",
     "spare4", "spare3", "spare2", "spare1"], ext=True)

SECURITY_ALGORITHM_CONFIG = S.Sequence([
    S.Field("cipheringAlgorithm", CIPHERING_ALGORITHM),
    S.Field("integrityProtAlgorithm", INTEGRITY_ALGORITHM, optional=True),
], ext=True)

# ------------------------------------------------------ RadioBearerConfig
PDCP_DISCARD_TIMER = S.Enumerated(
    ["ms10", "ms20", "ms30", "ms40", "ms50", "ms60", "ms75", "ms100",
     "ms150", "ms200", "ms250", "ms300", "ms500", "ms750", "ms1500",
     "infinity"])
PDCP_SN_SIZE = S.Enumerated(["len12bits", "len18bits"])
T_REORDERING = S.Enumerated(
    ["ms0", "ms1", "ms2", "ms4", "ms5", "ms8", "ms10", "ms15", "ms20",
     "ms30", "ms40", "ms50", "ms60", "ms80", "ms100", "ms120", "ms140",
     "ms160", "ms180", "ms200", "ms220", "ms240", "ms260", "ms280",
     "ms300", "ms500", "ms750", "ms1000", "ms1250", "ms1500", "ms1750",
     "ms2000", "ms2250", "ms2500", "ms2750", "ms3000"]
    + [f"spare{i}" for i in range(28, 0, -1)])

PDCP_CONFIG = S.Sequence([
    S.Field("drb", S.Sequence([
        S.Field("discardTimer", PDCP_DISCARD_TIMER, optional=True),
        S.Field("pdcp-SN-SizeUL", PDCP_SN_SIZE, optional=True),
        S.Field("pdcp-SN-SizeDL", PDCP_SN_SIZE, optional=True),
        S.Field("headerCompression", S.Choice([
            ("notUsed", EMPTY_SEQ),
            ("rohc", _Stub("rohc")),
            ("uplinkOnlyROHC", _Stub("uplinkOnlyROHC")),
        ], ext=True)),
        S.Field("integrityProtection", _true, optional=True),
        S.Field("statusReportRequired", _true, optional=True),
        S.Field("outOfOrderDelivery", _true, optional=True),
    ]), optional=True),
    S.Field("moreThanOneRLC", _Stub("moreThanOneRLC"), optional=True),
    S.Field("t-Reordering", T_REORDERING, optional=True),
], ext=True)

SRB_TO_ADD_MOD = S.Sequence([
    S.Field("srb-Identity", S.Integer(1, 3)),
    S.Field("reestablishPDCP", _true, optional=True),
    S.Field("discardOnPDCP", _true, optional=True),
    S.Field("pdcp-Config", PDCP_CONFIG, optional=True),
], ext=True)

SDAP_HEADER = S.Enumerated(["present", "absent"])
SDAP_CONFIG = S.Sequence([
    S.Field("pdu-Session", S.Integer(0, 255)),
    S.Field("sdap-HeaderDL", SDAP_HEADER),
    S.Field("sdap-HeaderUL", SDAP_HEADER),
    S.Field("defaultDRB", S.Boolean()),
    S.Field("mappedQoS-FlowsToAdd",
            S.SequenceOf(S.Integer(0, 63), 1, 64), optional=True),
    S.Field("mappedQoS-FlowsToRelease",
            S.SequenceOf(S.Integer(0, 63), 1, 64), optional=True),
], ext=True)

DRB_TO_ADD_MOD = S.Sequence([
    S.Field("cnAssociation", S.Choice([
        ("eps-BearerIdentity", S.Integer(0, 15)),
        ("sdap-Config", SDAP_CONFIG)]), optional=True),
    S.Field("drb-Identity", S.Integer(1, 32)),
    S.Field("reestablishPDCP", _true, optional=True),
    S.Field("recoverPDCP", _true, optional=True),
    S.Field("pdcp-Config", PDCP_CONFIG, optional=True),
], ext=True)

SECURITY_CONFIG = S.Sequence([
    S.Field("securityAlgorithmConfig", SECURITY_ALGORITHM_CONFIG,
            optional=True),
    S.Field("keyToUse", S.Enumerated(["master", "secondary"]),
            optional=True),
], ext=True)

RADIO_BEARER_CONFIG = S.Sequence([
    S.Field("srb-ToAddModList", S.SequenceOf(SRB_TO_ADD_MOD, 1, 2),
            optional=True),
    S.Field("srb3-ToRelease", _true, optional=True),
    S.Field("drb-ToAddModList", S.SequenceOf(DRB_TO_ADD_MOD, 1, 29),
            optional=True),
    S.Field("drb-ToReleaseList", S.SequenceOf(S.Integer(1, 32), 1, 29),
            optional=True),
    S.Field("securityConfig", SECURITY_CONFIG, optional=True),
], ext=True)

# ----------------------------------------- UE-dedicated uplink config
# The chain SpCellConfig -> ServingCellConfig -> UplinkConfig ->
# BWP-UplinkDedicated -> PUCCH-Config carries the DU-manager-allocated
# PUCCH resources (SR + periodic CSI) to the UE — the field layouts
# below follow 38.331 §6.3.2 (Rel-15) member for member.


def _setup_release(t: S.Type) -> S.Type:
    return S.Choice([("release", EMPTY_SEQ), ("setup", t)])


PUCCH_FORMAT1 = S.Sequence([
    S.Field("initialCyclicShift", S.Integer(0, 11)),
    S.Field("nrofSymbols", S.Integer(4, 14)),
    S.Field("startingSymbolIndex", S.Integer(0, 10)),
    S.Field("timeDomainOCC", S.Integer(0, 6)),
])

PUCCH_FORMAT2 = S.Sequence([
    S.Field("nrofPRBs", S.Integer(1, 16)),
    S.Field("nrofSymbols", S.Integer(1, 2)),
    S.Field("startingSymbolIndex", S.Integer(0, 13)),
])

PUCCH_RESOURCE = S.Sequence([
    S.Field("pucch-ResourceId", S.Integer(0, 127)),
    S.Field("startingPRB", S.Integer(0, 274)),
    S.Field("intraSlotFrequencyHopping", _true, optional=True),
    S.Field("secondHopPRB", S.Integer(0, 274), optional=True),
    S.Field("format", S.Choice([
        ("format0", _Stub("PUCCH-format0")),
        ("format1", PUCCH_FORMAT1),
        ("format2", PUCCH_FORMAT2),
        ("format3", _Stub("PUCCH-format3")),
        ("format4", _Stub("PUCCH-format4"))])),
])

SR_PERIODICITY_AND_OFFSET = S.Choice([
    ("sym2", EMPTY_SEQ), ("sym6or7", EMPTY_SEQ), ("sl1", EMPTY_SEQ),
    ("sl2", S.Integer(0, 1)), ("sl4", S.Integer(0, 3)),
    ("sl5", S.Integer(0, 4)), ("sl8", S.Integer(0, 7)),
    ("sl10", S.Integer(0, 9)), ("sl16", S.Integer(0, 15)),
    ("sl20", S.Integer(0, 19)), ("sl40", S.Integer(0, 39)),
    ("sl80", S.Integer(0, 79)), ("sl160", S.Integer(0, 159)),
    ("sl320", S.Integer(0, 319)), ("sl640", S.Integer(0, 639)),
])

SCHEDULING_REQUEST_RESOURCE = S.Sequence([
    S.Field("schedulingRequestResourceId", S.Integer(1, 8)),
    S.Field("schedulingRequestID", S.Integer(0, 7)),
    S.Field("periodicityAndOffset", SR_PERIODICITY_AND_OFFSET,
            optional=True),
    S.Field("resource", S.Integer(0, 127), optional=True),
])

PUCCH_FORMAT_CONFIG = S.Sequence([
    S.Field("interslotFrequencyHopping", _true, optional=True),
    S.Field("additionalDMRS", _true, optional=True),
    S.Field("maxCodeRate", S.Enumerated(
        ["zeroDot08", "zeroDot15", "zeroDot25", "zeroDot35", "zeroDot45",
         "zeroDot60", "zeroDot80", "spare1"]), optional=True),
    S.Field("nrofSlots", S.Enumerated(["n2", "n4", "n8", "spare1"]),
            optional=True),
    S.Field("pi2BPSK", _true, optional=True),
    S.Field("simultaneousHARQ-ACK-CSI", _true, optional=True),
])

PUCCH_CONFIG = S.Sequence([
    S.Field("resourceSetToAddModList",
            S.SequenceOf(_Stub("PUCCH-ResourceSet"), 1, 4), optional=True),
    S.Field("resourceSetToReleaseList",
            S.SequenceOf(S.Integer(0, 3), 1, 4), optional=True),
    S.Field("resourceToAddModList",
            S.SequenceOf(PUCCH_RESOURCE, 1, 128), optional=True),
    S.Field("resourceToReleaseList",
            S.SequenceOf(S.Integer(0, 127), 1, 128), optional=True),
    S.Field("format1", _setup_release(PUCCH_FORMAT_CONFIG), optional=True),
    S.Field("format2", _setup_release(PUCCH_FORMAT_CONFIG), optional=True),
    S.Field("format3", _setup_release(PUCCH_FORMAT_CONFIG), optional=True),
    S.Field("format4", _setup_release(PUCCH_FORMAT_CONFIG), optional=True),
    S.Field("schedulingRequestResourceToAddModList",
            S.SequenceOf(SCHEDULING_REQUEST_RESOURCE, 1, 8), optional=True),
    S.Field("schedulingRequestResourceToReleaseList",
            S.SequenceOf(S.Integer(1, 8), 1, 8), optional=True),
    S.Field("multi-CSI-PUCCH-ResourceList",
            S.SequenceOf(S.Integer(0, 127), 1, 2), optional=True),
    S.Field("dl-DataToUL-ACK",
            S.SequenceOf(S.Integer(0, 15), 1, 8), optional=True),
    S.Field("spatialRelationInfoToAddModList",
            S.SequenceOf(_Stub("PUCCH-SpatialRelationInfo"), 1, 8),
            optional=True),
    S.Field("spatialRelationInfoToReleaseList",
            S.SequenceOf(S.Integer(1, 8), 1, 8), optional=True),
    S.Field("pucch-PowerControl", _Stub("PUCCH-PowerControl"),
            optional=True),
], ext=True)

CSI_REPORT_PERIODICITY_AND_OFFSET = S.Choice([
    ("slots4", S.Integer(0, 3)), ("slots5", S.Integer(0, 4)),
    ("slots8", S.Integer(0, 7)), ("slots10", S.Integer(0, 9)),
    ("slots16", S.Integer(0, 15)), ("slots20", S.Integer(0, 19)),
    ("slots40", S.Integer(0, 39)), ("slots80", S.Integer(0, 79)),
    ("slots160", S.Integer(0, 159)), ("slots320", S.Integer(0, 319)),
])

PUCCH_CSI_RESOURCE = S.Sequence([
    S.Field("uplinkBandwidthPartId", S.Integer(0, 4)),
    S.Field("pucch-Resource", S.Integer(0, 127)),
])

CSI_REPORT_CONFIG = S.Sequence([
    S.Field("reportConfigId", S.Integer(0, 47)),
    S.Field("carrier", S.Integer(0, 31), optional=True),
    S.Field("resourcesForChannelMeasurement", S.Integer(0, 111)),
    S.Field("csi-IM-ResourcesForInterference", S.Integer(0, 111),
            optional=True),
    S.Field("nzp-CSI-RS-ResourcesForInterference", S.Integer(0, 111),
            optional=True),
    S.Field("reportConfigType", S.Choice([
        ("periodic", S.Sequence([
            S.Field("reportSlotConfig", CSI_REPORT_PERIODICITY_AND_OFFSET),
            S.Field("pucch-CSI-ResourceList",
                    S.SequenceOf(PUCCH_CSI_RESOURCE, 1, 4))])),
        ("semiPersistentOnPUCCH", _Stub("semiPersistentOnPUCCH")),
        ("semiPersistentOnPUSCH", _Stub("semiPersistentOnPUSCH")),
        ("aperiodic", _Stub("aperiodic"))])),
    S.Field("reportQuantity", S.Choice([
        ("none", EMPTY_SEQ), ("cri-RI-PMI-CQI", EMPTY_SEQ),
        ("cri-RI-i1", EMPTY_SEQ),
        ("cri-RI-i1-CQI", S.Sequence([
            S.Field("pdsch-BundleSizeForCSI",
                    S.Enumerated(["n2", "n4"]), optional=True)])),
        ("cri-RI-CQI", EMPTY_SEQ), ("cri-RSRP", EMPTY_SEQ),
        ("ssb-Index-RSRP", EMPTY_SEQ), ("cri-RI-LI-PMI-CQI", EMPTY_SEQ)])),
    S.Field("reportFreqConfiguration", S.Sequence([
        S.Field("cqi-FormatIndicator", S.Enumerated(
            ["widebandCQI", "subbandCQI"]), optional=True),
        S.Field("pmi-FormatIndicator", S.Enumerated(
            ["widebandPMI", "subbandPMI"]), optional=True),
        S.Field("csi-ReportingBand", _Stub("csi-ReportingBand"),
                optional=True)]), optional=True),
    S.Field("timeRestrictionForChannelMeasurements",
            S.Enumerated(["configured", "notConfigured"])),
    S.Field("timeRestrictionForInterferenceMeasurements",
            S.Enumerated(["configured", "notConfigured"])),
    S.Field("codebookConfig", _Stub("CodebookConfig"), optional=True),
    S.Field("dummy", S.Enumerated(["n1", "n2"]), optional=True),
    S.Field("groupBasedBeamReporting", S.Choice([
        ("enabled", EMPTY_SEQ),
        ("disabled", S.Sequence([
            S.Field("nrofReportedRS", S.Enumerated(
                ["n1", "n2", "n3", "n4"]), optional=True)]))])),
    S.Field("cqi-Table", S.Enumerated(
        ["table1", "table2", "table3", "spare1"]), optional=True),
    S.Field("subbandSize", S.Enumerated(["value1", "value2"])),
    S.Field("non-PMI-PortIndication",
            S.SequenceOf(_Stub("PortIndexFor8Ranks"), 1, 128),
            optional=True),
], ext=True)

CSI_MEAS_CONFIG = S.Sequence([
    S.Field("nzp-CSI-RS-ResourceToAddModList",
            S.SequenceOf(_Stub("NZP-CSI-RS-Resource"), 1, 192),
            optional=True),
    S.Field("nzp-CSI-RS-ResourceToReleaseList",
            S.SequenceOf(S.Integer(0, 191), 1, 192), optional=True),
    S.Field("nzp-CSI-RS-ResourceSetToAddModList",
            S.SequenceOf(_Stub("NZP-CSI-RS-ResourceSet"), 1, 64),
            optional=True),
    S.Field("nzp-CSI-RS-ResourceSetToReleaseList",
            S.SequenceOf(S.Integer(0, 63), 1, 64), optional=True),
    S.Field("csi-IM-ResourceToAddModList",
            S.SequenceOf(_Stub("CSI-IM-Resource"), 1, 32), optional=True),
    S.Field("csi-IM-ResourceToReleaseList",
            S.SequenceOf(S.Integer(0, 31), 1, 32), optional=True),
    S.Field("csi-IM-ResourceSetToAddModList",
            S.SequenceOf(_Stub("CSI-IM-ResourceSet"), 1, 64),
            optional=True),
    S.Field("csi-IM-ResourceSetToReleaseList",
            S.SequenceOf(S.Integer(0, 63), 1, 64), optional=True),
    S.Field("csi-SSB-ResourceSetToAddModList",
            S.SequenceOf(_Stub("CSI-SSB-ResourceSet"), 1, 64),
            optional=True),
    S.Field("csi-SSB-ResourceSetToReleaseList",
            S.SequenceOf(S.Integer(0, 63), 1, 64), optional=True),
    S.Field("csi-ResourceConfigToAddModList",
            S.SequenceOf(_Stub("CSI-ResourceConfig"), 1, 112),
            optional=True),
    S.Field("csi-ResourceConfigToReleaseList",
            S.SequenceOf(S.Integer(0, 111), 1, 112), optional=True),
    S.Field("csi-ReportConfigToAddModList",
            S.SequenceOf(CSI_REPORT_CONFIG, 1, 48), optional=True),
    S.Field("csi-ReportConfigToReleaseList",
            S.SequenceOf(S.Integer(0, 47), 1, 48), optional=True),
    S.Field("reportTriggerSize", S.Integer(0, 6), optional=True),
    S.Field("aperiodicTriggerStateList",
            _setup_release(_Stub("CSI-AperiodicTriggerStateList")),
            optional=True),
    S.Field("semiPersistentOnPUSCH-TriggerStateList",
            _setup_release(_Stub("CSI-SP-TriggerStateList")),
            optional=True),
], ext=True)

BWP_UPLINK_DEDICATED = S.Sequence([
    S.Field("pucch-Config", _setup_release(PUCCH_CONFIG), optional=True),
    S.Field("pusch-Config", _setup_release(_Stub("PUSCH-Config")),
            optional=True),
    S.Field("configuredGrantConfig",
            _setup_release(_Stub("ConfiguredGrantConfig")), optional=True),
    S.Field("srs-Config", _setup_release(_Stub("SRS-Config")),
            optional=True),
    S.Field("beamFailureRecoveryConfig",
            _setup_release(_Stub("BeamFailureRecoveryConfig")),
            optional=True),
], ext=True)

UPLINK_CONFIG = S.Sequence([
    S.Field("initialUplinkBWP", BWP_UPLINK_DEDICATED, optional=True),
    S.Field("uplinkBWP-ToReleaseList",
            S.SequenceOf(S.Integer(0, 4), 1, 4), optional=True),
    S.Field("uplinkBWP-ToAddModList",
            S.SequenceOf(_Stub("BWP-Uplink"), 1, 4), optional=True),
    S.Field("firstActiveUplinkBWP-Id", S.Integer(0, 4), optional=True),
    S.Field("pusch-ServingCellConfig",
            _setup_release(_Stub("PUSCH-ServingCellConfig")),
            optional=True),
    S.Field("carrierSwitching",
            _setup_release(_Stub("SRS-CarrierSwitching")), optional=True),
], ext=True)

SERVING_CELL_CONFIG = S.Sequence([
    S.Field("tdd-UL-DL-ConfigurationDedicated",
            _Stub("TDD-UL-DL-ConfigDedicated"), optional=True),
    S.Field("initialDownlinkBWP", _Stub("BWP-DownlinkDedicated"),
            optional=True),
    S.Field("downlinkBWP-ToReleaseList",
            S.SequenceOf(S.Integer(0, 4), 1, 4), optional=True),
    S.Field("downlinkBWP-ToAddModList",
            S.SequenceOf(_Stub("BWP-Downlink"), 1, 4), optional=True),
    S.Field("firstActiveDownlinkBWP-Id", S.Integer(0, 4), optional=True),
    S.Field("bwp-InactivityTimer", S.Enumerated(
        ["ms2", "ms3", "ms4", "ms5", "ms6", "ms8", "ms10", "ms20",
         "ms30", "ms40", "ms50", "ms60", "ms80", "ms100", "ms200",
         "ms300", "ms500", "ms750", "ms1280", "ms1920", "ms2560",
         "spare10", "spare9", "spare8", "spare7", "spare6", "spare5",
         "spare4", "spare3", "spare2", "spare1"]), optional=True),
    S.Field("defaultDownlinkBWP-Id", S.Integer(0, 4), optional=True),
    S.Field("uplinkConfig", UPLINK_CONFIG, optional=True),
    S.Field("supplementaryUplink", UPLINK_CONFIG, optional=True),
    S.Field("pdcch-ServingCellConfig",
            _setup_release(_Stub("PDCCH-ServingCellConfig")),
            optional=True),
    S.Field("pdsch-ServingCellConfig",
            _setup_release(_Stub("PDSCH-ServingCellConfig")),
            optional=True),
    S.Field("csi-MeasConfig", _setup_release(CSI_MEAS_CONFIG),
            optional=True),
    S.Field("sCellDeactivationTimer", S.Enumerated(
        ["ms20", "ms40", "ms80", "ms160", "ms200", "ms240", "ms320",
         "ms400", "ms480", "ms520", "ms640", "ms720", "ms840", "ms1280",
         "spare2", "spare1"]), optional=True),
    S.Field("crossCarrierSchedulingConfig",
            _Stub("CrossCarrierSchedulingConfig"), optional=True),
    S.Field("tag-Id", S.Integer(0, 3)),
    S.Field("dummy", _true, optional=True),
    S.Field("pathlossReferenceLinking",
            S.Enumerated(["spCell", "sCell"]), optional=True),
    S.Field("servingCellMO", S.Integer(1, 64), optional=True),
], ext=True)

SP_CELL_CONFIG = S.Sequence([
    S.Field("servCellIndex", S.Integer(0, 31), optional=True),
    S.Field("reconfigurationWithSync", _Stub("ReconfigurationWithSync"),
            optional=True),
    S.Field("rlf-TimersAndConstants",
            _setup_release(_Stub("RLF-TimersAndConstants")),
            optional=True),
    S.Field("rlmInSyncOutOfSyncThreshold", S.Enumerated(["n1"]),
            optional=True),
    S.Field("spCellConfigDedicated", SERVING_CELL_CONFIG, optional=True),
], ext=True)

# ----------------------------------------------------- CellGroupConfig
# carried as OCTET STRING (CONTAINING CellGroupConfig) in RRCSetup /
# RRCReconfiguration; the subset encodes the RLC bearer <-> logical
# channel binding the DU actually consumes.
RLC_BEARER_CONFIG = S.Sequence([
    S.Field("logicalChannelIdentity", S.Integer(1, 32)),
    S.Field("servedRadioBearer", S.Choice([
        ("srb-Identity", S.Integer(1, 3)),
        ("drb-Identity", S.Integer(1, 32))]), optional=True),
    S.Field("reestablishRLC", _true, optional=True),
    S.Field("rlc-Config", S.Choice([
        ("am", _Stub("rlc-Config.am")),
        ("um-Bi-Directional", _Stub("um-Bi-Directional")),
        ("um-Uni-Directional-UL", _Stub("um-Uni-Directional-UL")),
        ("um-Uni-Directional-DL", _Stub("um-Uni-Directional-DL")),
    ], ext=True), optional=True),
    S.Field("mac-LogicalChannelConfig", _Stub("LogicalChannelConfig"),
            optional=True),
], ext=True)

CELL_GROUP_CONFIG = S.Sequence([
    S.Field("cellGroupId", S.Integer(0, 3)),
    S.Field("rlc-BearerToAddModList",
            S.SequenceOf(RLC_BEARER_CONFIG, 1, 32), optional=True),
    S.Field("rlc-BearerToReleaseList",
            S.SequenceOf(S.Integer(1, 32), 1, 32), optional=True),
    S.Field("mac-CellGroupConfig", _Stub("MAC-CellGroupConfig"),
            optional=True),
    S.Field("physicalCellGroupConfig", _Stub("PhysicalCellGroupConfig"),
            optional=True),
    S.Field("spCellConfig", SP_CELL_CONFIG, optional=True),
], ext=True)


def _crit_ext(ies: S.Type) -> S.Type:
    """criticalExtensions CHOICE {<ies>, criticalExtensionsFuture {}}"""
    return S.Choice([("ies", ies), ("criticalExtensionsFuture", EMPTY_SEQ)])


# ------------------------------------------------------------- UL-CCCH
ESTABLISHMENT_CAUSE = S.Enumerated(
    ["emergency", "highPriorityAccess", "mt-Access", "mo-Signalling",
     "mo-Data", "mo-VoiceCall", "mo-VideoCall", "mo-SMS",
     "mps-PriorityAccess", "mcs-PriorityAccess",
     "spare6", "spare5", "spare4", "spare3", "spare2", "spare1"])

RRC_SETUP_REQUEST = S.Sequence([
    S.Field("ue-Identity", S.Choice([
        ("ng-5G-S-TMSI-Part1", S.BitString(39, 39)),
        ("randomValue", S.BitString(39, 39))])),
    S.Field("establishmentCause", ESTABLISHMENT_CAUSE),
    S.Field("spare", S.BitString(1, 1)),
])

RESUME_CAUSE = S.Enumerated(
    ["emergency", "highPriorityAccess", "mt-Access", "mo-Signalling",
     "mo-Data", "mo-VoiceCall", "mo-VideoCall", "mo-SMS",
     "rna-Update", "mps-PriorityAccess", "mcs-PriorityAccess",
     "spare1", "spare2", "spare3", "spare4", "spare5"])

RRC_RESUME_REQUEST = S.Sequence([
    S.Field("resumeIdentity", S.BitString(24, 24)),
    S.Field("resumeMAC-I", S.BitString(16, 16)),
    S.Field("resumeCause", RESUME_CAUSE),
    S.Field("spare", S.BitString(1, 1)),
])

RRC_REESTABLISHMENT_REQUEST = S.Sequence([
    S.Field("ue-Identity", S.Sequence([
        S.Field("c-RNTI", S.Integer(0, 65535)),
        S.Field("physCellId", S.Integer(0, 1007)),
        S.Field("shortMAC-I", S.BitString(16, 16))])),
    S.Field("reestablishmentCause", S.Enumerated(
        ["reconfigurationFailure", "handoverFailure", "otherFailure",
         "spare1"])),
    S.Field("spare", S.BitString(1, 1)),
])

RRC_SYSTEM_INFO_REQUEST = S.Sequence([
    S.Field("requested-SI-List", S.BitString(32, 32)),
    S.Field("spare", S.BitString(12, 12)),
])

UL_CCCH_MESSAGE = S.Choice([
    ("c1", S.Choice([
        ("rrcSetupRequest", S.Sequence(
            [S.Field("rrcSetupRequest", RRC_SETUP_REQUEST)])),
        ("rrcResumeRequest", S.Sequence(
            [S.Field("rrcResumeRequest", RRC_RESUME_REQUEST)])),
        ("rrcReestablishmentRequest", S.Sequence(
            [S.Field("rrcReestablishmentRequest",
                     RRC_REESTABLISHMENT_REQUEST)])),
        ("rrcSystemInfoRequest", S.Sequence(
            [S.Field("rrcSystemInfoRequest",
                     _crit_ext(RRC_SYSTEM_INFO_REQUEST))])),
    ])),
    ("messageClassExtension", EMPTY_SEQ),
])

# ------------------------------------------------------------- DL-CCCH
RRC_REJECT_IES = S.Sequence([
    S.Field("waitTime", S.Integer(1, 16), optional=True),
    S.Field("lateNonCriticalExtension", S.OctetString(), optional=True),
    S.Field("nonCriticalExtension", EMPTY_SEQ, optional=True),
])

RRC_SETUP_IES = S.Sequence([
    S.Field("radioBearerConfig", RADIO_BEARER_CONFIG),
    S.Field("masterCellGroup", S.OctetString()),   # CONTAINING CellGroupConfig
    S.Field("lateNonCriticalExtension", S.OctetString(), optional=True),
    S.Field("nonCriticalExtension", EMPTY_SEQ, optional=True),
])

DL_CCCH_MESSAGE = S.Choice([
    ("c1", S.Choice([
        ("rrcReject", S.Sequence(
            [S.Field("criticalExtensions", _crit_ext(RRC_REJECT_IES))])),
        ("rrcSetup", S.Sequence([
            S.Field("rrc-TransactionIdentifier", RRC_TRANSACTION_ID),
            S.Field("criticalExtensions", _crit_ext(RRC_SETUP_IES))])),
        ("spare2", _Stub("spare2")),
        ("spare1", _Stub("spare1")),
    ])),
    ("messageClassExtension", EMPTY_SEQ),
])

# ------------------------------------------------------------- DL-DCCH
SMC_IES = S.Sequence([
    S.Field("securityConfigSMC", S.Sequence([
        S.Field("securityAlgorithmConfig", SECURITY_ALGORITHM_CONFIG),
    ], ext=True)),
    S.Field("lateNonCriticalExtension", S.OctetString(), optional=True),
    S.Field("nonCriticalExtension", EMPTY_SEQ, optional=True),
])

RECONFIG_V1530_IES = S.Sequence([
    S.Field("masterCellGroup", S.OctetString(), optional=True),
    S.Field("fullConfig", _true, optional=True),
    S.Field("dedicatedNAS-MessageList",
            S.SequenceOf(DEDICATED_NAS, 1, 29), optional=True),
    S.Field("masterKeyUpdate", _Stub("MasterKeyUpdate"), optional=True),
    S.Field("dedicatedSIB1-Delivery", S.OctetString(), optional=True),
    S.Field("dedicatedSystemInformationDelivery", S.OctetString(),
            optional=True),
    S.Field("otherConfig", _Stub("OtherConfig"), optional=True),
    S.Field("nonCriticalExtension", _Stub("v1540-IEs"), optional=True),
])

RECONFIG_IES = S.Sequence([
    S.Field("radioBearerConfig", RADIO_BEARER_CONFIG, optional=True),
    S.Field("secondaryCellGroup", S.OctetString(), optional=True),
    S.Field("measConfig", _Stub("MeasConfig"), optional=True),
    S.Field("lateNonCriticalExtension", S.OctetString(), optional=True),
    S.Field("nonCriticalExtension", RECONFIG_V1530_IES, optional=True),
])

DL_INFO_TRANSFER_IES = S.Sequence([
    S.Field("dedicatedNAS-Message", DEDICATED_NAS, optional=True),
    S.Field("lateNonCriticalExtension", S.OctetString(), optional=True),
    S.Field("nonCriticalExtension", EMPTY_SEQ, optional=True),
])

RRC_RELEASE_IES = S.Sequence([
    S.Field("redirectedCarrierInfo", _Stub("RedirectedCarrierInfo"),
            optional=True),
    S.Field("cellReselectionPriorities", _Stub("CellReselectionPriorities"),
            optional=True),
    S.Field("suspendConfig", _Stub("SuspendConfig"), optional=True),
    S.Field("deprioritisationReq", _Stub("DeprioritisationReq"),
            optional=True),
    S.Field("lateNonCriticalExtension", S.OctetString(), optional=True),
    S.Field("nonCriticalExtension", EMPTY_SEQ, optional=True),
])


def _with_tid(ies: S.Type) -> S.Type:
    return S.Sequence([
        S.Field("rrc-TransactionIdentifier", RRC_TRANSACTION_ID),
        S.Field("criticalExtensions", _crit_ext(ies))])


DL_DCCH_MESSAGE = S.Choice([
    ("c1", S.Choice([
        ("rrcReconfiguration", _with_tid(RECONFIG_IES)),
        ("rrcResume", _Stub("RRCResume")),
        ("rrcRelease", _with_tid(RRC_RELEASE_IES)),
        ("rrcReestablishment", _Stub("RRCReestablishment")),
        ("securityModeCommand", _with_tid(SMC_IES)),
        ("dlInformationTransfer", _with_tid(DL_INFO_TRANSFER_IES)),
        ("ueCapabilityEnquiry", _Stub("UECapabilityEnquiry")),
        ("counterCheck", _Stub("CounterCheck")),
        ("mobilityFromNRCommand", _Stub("MobilityFromNRCommand")),
        ("spare7", _Stub("spare")), ("spare6", _Stub("spare")),
        ("spare5", _Stub("spare")), ("spare4", _Stub("spare")),
        ("spare3", _Stub("spare")), ("spare2", _Stub("spare")),
        ("spare1", _Stub("spare")),
    ])),
    ("messageClassExtension", EMPTY_SEQ),
])

# ------------------------------------------------------------- UL-DCCH
SETUP_COMPLETE_IES = S.Sequence([
    S.Field("selectedPLMN-Identity", S.Integer(1, 12)),
    S.Field("registeredAMF", _Stub("RegisteredAMF"), optional=True),
    S.Field("guami-Type", S.Enumerated(["native", "mapped"]),
            optional=True),
    S.Field("s-NSSAI-List", S.SequenceOf(S.Choice([
        ("sst", S.BitString(8, 8)),
        ("sst-SD", S.BitString(32, 32))]), 1, 8), optional=True),
    S.Field("dedicatedNAS-Message", DEDICATED_NAS),
    S.Field("ng-5G-S-TMSI-Value", S.Choice([
        ("ng-5G-S-TMSI", S.BitString(48, 48)),
        ("ng-5G-S-TMSI-Part2", S.BitString(9, 9))]), optional=True),
    S.Field("lateNonCriticalExtension", S.OctetString(), optional=True),
    S.Field("nonCriticalExtension", EMPTY_SEQ, optional=True),
])

_COMPLETE_IES = S.Sequence([
    S.Field("lateNonCriticalExtension", S.OctetString(), optional=True),
    S.Field("nonCriticalExtension", EMPTY_SEQ, optional=True),
])

UL_INFO_TRANSFER = S.Sequence([
    S.Field("criticalExtensions", _crit_ext(DL_INFO_TRANSFER_IES))])

UL_DCCH_MESSAGE = S.Choice([
    ("c1", S.Choice([
        ("measurementReport", _Stub("MeasurementReport")),
        ("rrcReconfigurationComplete", _with_tid(_COMPLETE_IES)),
        ("rrcSetupComplete", _with_tid(SETUP_COMPLETE_IES)),
        ("rrcReestablishmentComplete", _Stub("RRCReestablishmentComplete")),
        ("rrcResumeComplete", _Stub("RRCResumeComplete")),
        ("securityModeComplete", _with_tid(_COMPLETE_IES)),
        ("securityModeFailure", _with_tid(_COMPLETE_IES)),
        ("ulInformationTransfer", UL_INFO_TRANSFER),
        ("locationMeasurementIndication", _Stub("LocationMeasurement")),
        ("ueCapabilityInformation", _Stub("UECapabilityInformation")),
        ("counterCheckResponse", _Stub("CounterCheckResponse")),
        ("ueAssistanceInformation", _Stub("UEAssistanceInformation")),
        ("failureInformation", _Stub("FailureInformation")),
        ("ulInformationTransferMRDC", _Stub("ULInformationTransferMRDC")),
        ("scgFailureInformation", _Stub("SCGFailureInformation")),
        ("scgFailureInformationEUTRA", _Stub("SCGFailureInfoEUTRA")),
    ])),
    ("messageClassExtension", EMPTY_SEQ),
])


# --------------------------------------------------------------- helpers
def encode_ul_ccch(alt: str, value) -> bytes:
    return UL_CCCH_MESSAGE.to_bytes(("c1", (alt, value)), UNALIGNED)


def decode_ul_ccch(data: bytes):
    kind, inner = UL_CCCH_MESSAGE.from_bytes(data, UNALIGNED)
    if kind != "c1":
        raise PerError("messageClassExtension not in use")
    return inner


def encode_dl_ccch(alt: str, value) -> bytes:
    return DL_CCCH_MESSAGE.to_bytes(("c1", (alt, value)), UNALIGNED)


def decode_dl_ccch(data: bytes):
    kind, inner = DL_CCCH_MESSAGE.from_bytes(data, UNALIGNED)
    if kind != "c1":
        raise PerError("messageClassExtension not in use")
    return inner


def encode_dl_dcch(alt: str, value) -> bytes:
    return DL_DCCH_MESSAGE.to_bytes(("c1", (alt, value)), UNALIGNED)


def decode_dl_dcch(data: bytes):
    kind, inner = DL_DCCH_MESSAGE.from_bytes(data, UNALIGNED)
    if kind != "c1":
        raise PerError("messageClassExtension not in use")
    return inner


def encode_ul_dcch(alt: str, value) -> bytes:
    return UL_DCCH_MESSAGE.to_bytes(("c1", (alt, value)), UNALIGNED)


def decode_ul_dcch(data: bytes):
    kind, inner = UL_DCCH_MESSAGE.from_bytes(data, UNALIGNED)
    if kind != "c1":
        raise PerError("messageClassExtension not in use")
    return inner


def encode_cell_group(value: dict) -> bytes:
    return CELL_GROUP_CONFIG.to_bytes(value, UNALIGNED)


def decode_cell_group(data: bytes) -> dict:
    return CELL_GROUP_CONFIG.from_bytes(data, UNALIGNED)


# ------------------------------- dedicated PUCCH config build / parse
def build_sp_cell_config(sr: dict, csi: dict) -> dict:
    """SpCellConfig carrying the DU-allocated dedicated PUCCH resources.

    sr: {res_id, prb, cs, period_slots, offset}
    csi: {res_id, prb, nof_prb, period_slots, offset}
    """
    pucch = {
        "resourceToAddModList": [
            {"pucch-ResourceId": sr["res_id"], "startingPRB": sr["prb"],
             "format": ("format1", {
                 "initialCyclicShift": sr["cs"], "nrofSymbols": 14,
                 "startingSymbolIndex": 0, "timeDomainOCC": 0})},
            {"pucch-ResourceId": csi["res_id"],
             "startingPRB": csi["prb"],
             "format": ("format2", {
                 "nrofPRBs": csi.get("nof_prb", 1), "nrofSymbols": 1,
                 "startingSymbolIndex": 13})},
        ],
        "schedulingRequestResourceToAddModList": [{
            "schedulingRequestResourceId": 1,
            "schedulingRequestID": 0,
            "periodicityAndOffset": (f"sl{sr['period_slots']}",
                                     sr["offset"]),
            "resource": sr["res_id"]}],
    }
    csi_meas = {"csi-ReportConfigToAddModList": [{
        "reportConfigId": 0,
        "resourcesForChannelMeasurement": 0,
        "reportConfigType": ("periodic", {
            "reportSlotConfig": (f"slots{csi['period_slots']}",
                                 csi["offset"]),
            "pucch-CSI-ResourceList": [{
                "uplinkBandwidthPartId": 0,
                "pucch-Resource": csi["res_id"]}]}),
        "reportQuantity": ("cri-RI-PMI-CQI", {}),
        "timeRestrictionForChannelMeasurements": "notConfigured",
        "timeRestrictionForInterferenceMeasurements": "notConfigured",
        "groupBasedBeamReporting": ("disabled", {}),
        "subbandSize": "value1"}]}
    return {"spCellConfigDedicated": {
        "uplinkConfig": {"initialUplinkBWP": {
            "pucch-Config": ("setup", pucch)}},
        "csi-MeasConfig": ("setup", csi_meas),
        "tag-Id": 0}}


def parse_sp_cell_config(sp: dict) -> tuple[dict, dict] | None:
    """Inverse of build_sp_cell_config: (sr, csi) dicts, or None."""
    ded = sp.get("spCellConfigDedicated")
    if not ded:
        return None
    kind, pucch = ded.get("uplinkConfig", {}).get(
        "initialUplinkBWP", {}).get("pucch-Config", ("release", None))
    if kind != "setup":
        return None
    res = {r["pucch-ResourceId"]: r
           for r in pucch.get("resourceToAddModList", ())}
    srr = pucch["schedulingRequestResourceToAddModList"][0]
    arm, off = srr["periodicityAndOffset"]
    f1 = res[srr["resource"]]
    sr = {"res_id": srr["resource"], "prb": f1["startingPRB"],
          "cs": f1["format"][1]["initialCyclicShift"],
          "period_slots": int(arm[2:]), "offset": off}
    kind, meas = ded.get("csi-MeasConfig", ("release", None))
    rep = meas["csi-ReportConfigToAddModList"][0]
    _, periodic = rep["reportConfigType"]
    slots_arm, csi_off = periodic["reportSlotConfig"]
    csi_id = periodic["pucch-CSI-ResourceList"][0]["pucch-Resource"]
    f2 = res[csi_id]
    csi = {"res_id": csi_id, "prb": f2["startingPRB"],
           "nof_prb": f2["format"][1]["nrofPRBs"],
           "period_slots": int(slots_arm[5:]), "offset": csi_off}
    return sr, csi
