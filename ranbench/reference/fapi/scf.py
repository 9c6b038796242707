"""SCF-222 (FAPI) full-surface PDU definitions + processor translation.

Copied from the port's ``srsran_project_23_5_tpu_torch/fapi/scf.py``,
unchanged.

Field-for-field Python mirrors of the reference's FAPI PDU structs
(include/srsran/fapi/messages.h: dl_pdsch_pdu:272, dl_pdcch_pdu:174,
dl_ssb_pdu:395, dl_csi_rs_pdu:340, ul_pusch_pdu:578, ul_pucch_pdu:639,
ul_prach_pdu:470) with the SCF wire conventions (DM-RS symbol-position
bitmasks, RB start/size vs type-0 bitmaps, codeword sub-structs,
maintenance-v3 parameters).

The translation functions at the bottom turn these wire-shaped PDUs
into this framework's static processor configurations (ShConfig /
PdcchConfig / PucchF*Config) — the analogue of the reference's
fapi_adaptor PDU-to-processor conversion (fapi_to_phy_translator.cpp).
`fapi.builders` provides the message_builders.h-style fluent builders
that produce these PDUs.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from ..phy.upper.pdcch import PdcchConfig
from ..phy.upper.pucch import PucchF1Config, PucchF2Config
from ..phy.upper.sch import ShConfig


# ------------------------------------------------------------------ enums
class DmrsCfgType(enum.IntEnum):
    TYPE_1 = 0
    TYPE_2 = 1


class ResourceAllocationType(enum.IntEnum):
    TYPE_0 = 0
    TYPE_1 = 1


class VrbToPrbMappingType(enum.IntEnum):
    NON_INTERLEAVED = 0
    INTERLEAVED_RB_SIZE2 = 1
    INTERLEAVED_RB_SIZE4 = 2


class LowPaprDmrsType(enum.IntEnum):
    INDEPENDENT_CDM_GROUP = 0
    DEPENDENT_CDM_GROUP = 1


class PdschRefPointType(enum.IntEnum):
    POINT_A = 0
    SUBCARRIER_0 = 1


class InlineTbCrcType(enum.IntEnum):
    DATA_PAYLOAD = 0
    CONTROL_MESSAGE = 1


class NzpCsiRsEpreToSsb(enum.IntEnum):
    DB_MINUS_3 = 0
    DB0 = 1
    DB3 = 2
    DB6 = 3
    L1_USE_PROFILE_SSS = 255


class CceToRegMappingType(enum.IntEnum):
    NON_INTERLEAVED = 0
    INTERLEAVED = 1


class PdcchCoresetType(enum.IntEnum):
    PBCH_OR_CORESET0 = 0
    OTHER = 1


class BchPayloadType(enum.IntEnum):
    MAC_FULL = 0
    PHY_TIMING_INFO = 1
    PHY_FULL = 2


class BetaPssProfileType(enum.IntEnum):
    DB_0 = 0
    DB_3 = 1
    BETA_PSS_PROFILE_SSS = 255


class DmrsTypeAPos(enum.IntEnum):
    POS2 = 0
    POS3 = 1


class PucchFormatType(enum.IntEnum):
    F0 = 0
    F1 = 1
    F2 = 2
    F3 = 3
    F4 = 4


class PrachFormatType(enum.IntEnum):
    F0 = 0
    F1 = 1
    F2 = 2
    F3 = 3
    A1 = 4
    A2 = 5
    A3 = 6
    B1 = 7
    B4 = 8


# ----------------------------------------------------------- common parts
@dataclasses.dataclass
class TxPrecodingAndBeamformingPdu:
    """messages.h:135 — PM index + digital beam indexes per PRG."""
    trp_scheme: int = 0
    prg_size: int = 0
    dig_bf_interfaces: int = 0
    prgs: list = dataclasses.field(default_factory=list)  # [(pm_index, beams)]


# ------------------------------------------------------------------ PDSCH
@dataclasses.dataclass
class DlPdschCodeword:
    """messages.h:254."""
    target_code_rate: int = 0        # R x 1024 x 10 (SCF units)
    qam_mod_order: int = 2
    mcs_index: int = 0
    mcs_table: int = 0
    rv_index: int = 0
    tb_size_bytes: int = 0


@dataclasses.dataclass
class DlPdschMaintenanceV3:
    """messages.h:204 (subset the PHY consumes)."""
    trans_type: int = 0
    coreset_start_point: int = 0
    initial_dl_bwp_size: int = 0
    ldpc_base_graph: int = 1
    tb_size_lbrm_bytes: int = 0
    tb_crc_required: int = 0
    ssb_pdus_for_rate_matching: list = dataclasses.field(
        default_factory=list)
    ssb_config_for_rate_matching: int = 0
    prb_sym_rm_pattern_bitmap_size: int = 0
    prb_sym_rm_patterns: list = dataclasses.field(default_factory=list)
    num_prb_sym_rm_patts_by_value: int = 0
    max_num_cbg_per_tb: int = 0


@dataclasses.dataclass
class DlPdschPdu:
    """messages.h:272 — full SCF field surface."""
    pdu_bitmap: int = 0
    rnti: int = 0
    pdu_index: int = 0
    bwp_size: int = 0
    bwp_start: int = 0
    scs: int = 1
    cyclic_prefix: int = 0
    cws: list = dataclasses.field(default_factory=list)  # DlPdschCodeword
    nid_pdsch: int = 0
    num_layers: int = 1
    transmission_scheme: int = 0
    ref_point: PdschRefPointType = PdschRefPointType.POINT_A
    dl_dmrs_symb_pos: int = 0        # 14-bit mask, bit i = symbol i
    pdsch_dmrs_scrambling_id: int = 0
    dmrs_type: DmrsCfgType = DmrsCfgType.TYPE_1
    pdsch_dmrs_scrambling_id_compl: int = 0
    low_papr_dmrs: LowPaprDmrsType = LowPaprDmrsType.INDEPENDENT_CDM_GROUP
    nscid: int = 0
    num_dmrs_cdm_grps_no_data: int = 2
    dmrs_ports: int = 0b1            # bitmask of DM-RS ports
    resource_alloc: ResourceAllocationType = ResourceAllocationType.TYPE_1
    rb_bitmap: bytes = b"\0" * 36
    rb_start: int = 0
    rb_size: int = 0
    vrb_to_prb_mapping: VrbToPrbMappingType = \
        VrbToPrbMappingType.NON_INTERLEAVED
    start_symbol_index: int = 0
    nr_of_symbols: int = 14
    precoding_and_beamforming: TxPrecodingAndBeamformingPdu = \
        dataclasses.field(default_factory=TxPrecodingAndBeamformingPdu)
    power_control_offset_profile_nr: int = 0
    power_control_offset_ss_profile_nr: NzpCsiRsEpreToSsb = \
        NzpCsiRsEpreToSsb.DB0
    is_last_cb_present: int = 0
    is_inline_tb_crc: InlineTbCrcType = InlineTbCrcType.DATA_PAYLOAD
    dl_tb_crc_cw: tuple = (0, 0)
    pdsch_maintenance_v3: DlPdschMaintenanceV3 = dataclasses.field(
        default_factory=DlPdschMaintenanceV3)


# ------------------------------------------------------------------ PDCCH
@dataclasses.dataclass
class DlDciPdu:
    """messages.h:155."""
    rnti: int = 0
    nid_pdcch_data: int = 0
    nrnti_pdcch_data: int = 0
    cce_index: int = 0
    aggregation_level: int = 4
    precoding_and_beamforming: TxPrecodingAndBeamformingPdu = \
        dataclasses.field(default_factory=TxPrecodingAndBeamformingPdu)
    beta_pdcch_1_0: int = 0
    power_control_offset_ss_profile_nr: int = 0
    payload: bytes = b""             # DCI payload bits packed MSB-first
    payload_size_bits: int = 0


@dataclasses.dataclass
class DlPdcchPdu:
    """messages.h:174."""
    coreset_bwp_size: int = 0
    coreset_bwp_start: int = 0
    scs: int = 1
    cyclic_prefix: int = 0
    start_symbol_index: int = 0
    duration_symbols: int = 1
    freq_domain_resource: bytes = b"\0" * 6   # 45-bit CORESET bitmap
    cce_reg_mapping_type: CceToRegMappingType = \
        CceToRegMappingType.NON_INTERLEAVED
    reg_bundle_size: int = 6
    interleaver_size: int = 2
    coreset_type: PdcchCoresetType = PdcchCoresetType.OTHER
    shift_index: int = 0
    precoder_granularity: int = 0
    dl_dci: list = dataclasses.field(default_factory=list)  # DlDciPdu


# -------------------------------------------------------------------- SSB
@dataclasses.dataclass
class DlSsbPhyMibPdu:
    """messages.h:363."""
    dmrs_typeA_position: DmrsTypeAPos = DmrsTypeAPos.POS2
    pdcch_config_sib1: int = 0
    cell_barred: bool = False
    intrafreq_reselection: bool = False


@dataclasses.dataclass
class DlSsbPdu:
    """messages.h:395."""
    phys_cell_id: int = 0
    beta_pss_profile_nr: BetaPssProfileType = BetaPssProfileType.DB_0
    ssb_block_index: int = 0
    ssb_subcarrier_offset: int = 0
    ssb_offset_pointA: int = 0
    bch_payload_flag: BchPayloadType = BchPayloadType.MAC_FULL
    bch_payload: int = 0             # 24/32-bit payload or phy_mib
    phy_mib: Optional[DlSsbPhyMibPdu] = None
    ssb_maintenance_v3_case: int = 0
    ssb_maintenance_v3_scs: int = 1
    ssb_maintenance_v3_lmax: int = 8


# ----------------------------------------------------------------- CSI-RS
@dataclasses.dataclass
class DlCsiRsPdu:
    """messages.h:340."""
    subcarrier_spacing: int = 1
    cyclic_prefix: int = 0
    start_rb: int = 0
    num_rbs: int = 0
    csi_type: int = 1                # 0=TRS, 1=NZP, 2=ZP
    row: int = 2
    freq_domain: int = 0             # bitmap per row table
    symb_l0: int = 0
    symb_l1: int = 0
    cdm_type: int = 0
    freq_density: int = 1
    scramb_id: int = 0
    power_control_offset_profile_nr: int = 0
    power_control_offset_ss_profile_nr: NzpCsiRsEpreToSsb = \
        NzpCsiRsEpreToSsb.DB0


# ------------------------------------------------------------------ PUSCH
@dataclasses.dataclass
class UlPuschData:
    """messages.h:487."""
    rv_index: int = 0
    harq_process_id: int = 0
    new_data: bool = True
    tb_size_bytes: int = 0
    num_cb: int = 0
    cb_present_and_position: bytes = b""


@dataclasses.dataclass
class UlPuschUci:
    """messages.h:501."""
    harq_ack_bit_length: int = 0
    csi_part1_bit_length: int = 0
    flags_csi_part2: int = 0
    alpha_scaling: int = 0
    beta_offset_harq_ack: int = 0
    beta_offset_csi1: int = 0
    beta_offset_csi2: int = 0


@dataclasses.dataclass
class UlPuschPdu:
    """messages.h:578 — full SCF field surface."""
    pdu_bitmap: int = 0b1            # bit0 = pusch_data present
    rnti: int = 0
    handle: int = 0
    bwp_size: int = 0
    bwp_start: int = 0
    scs: int = 1
    cyclic_prefix: int = 0
    target_code_rate: int = 0
    qam_mod_order: int = 2
    mcs_index: int = 0
    mcs_table: int = 0
    transform_precoding: bool = False
    nid_pusch: int = 0
    num_layers: int = 1
    ul_dmrs_symb_pos: int = 0
    dmrs_type: DmrsCfgType = DmrsCfgType.TYPE_1
    pusch_dmrs_scrambling_id: int = 0
    pusch_dmrs_scrambling_id_complement: int = 0
    low_papr_dmrs: LowPaprDmrsType = LowPaprDmrsType.INDEPENDENT_CDM_GROUP
    pusch_dmrs_identity: int = 0
    nscid: int = 0
    num_dmrs_cdm_grps_no_data: int = 2
    dmrs_ports: int = 0b1
    resource_alloc: ResourceAllocationType = ResourceAllocationType.TYPE_1
    rb_bitmap: bytes = b"\0" * 36
    rb_start: int = 0
    rb_size: int = 0
    vrb_to_prb_mapping: VrbToPrbMappingType = \
        VrbToPrbMappingType.NON_INTERLEAVED
    intra_slot_frequency_hopping: bool = False
    tx_direct_current_location: int = 0
    uplink_frequency_shift_7p5kHz: bool = False
    start_symbol_index: int = 0
    nr_of_symbols: int = 14
    pusch_data: UlPuschData = dataclasses.field(default_factory=UlPuschData)
    pusch_uci: UlPuschUci = dataclasses.field(default_factory=UlPuschUci)


# ------------------------------------------------------------------ PUCCH
@dataclasses.dataclass
class UlPucchPdu:
    """messages.h:639 — full SCF field surface."""
    rnti: int = 0
    handle: int = 0
    bwp_size: int = 0
    bwp_start: int = 0
    scs: int = 1
    cyclic_prefix: int = 0
    format_type: PucchFormatType = PucchFormatType.F1
    multi_slot_tx_indicator: int = 0
    pi2_bpsk: bool = False
    prb_start: int = 0
    prb_size: int = 1
    start_symbol_index: int = 0
    nr_of_symbols: int = 14
    intra_slot_frequency_hopping: bool = False
    second_hop_prb: int = 0
    pucch_grp_hopping: int = 0
    nid_pucch_hopping: int = 0
    initial_cyclic_shift: int = 0
    nid_pucch_scrambling: int = 0
    time_domain_occ_index: int = 0
    pre_dft_occ_idx: int = 0
    pre_dft_occ_len: int = 0
    add_dmrs_flag: bool = False
    nid0_pucch_dmrs_scrambling: int = 0
    m0_pucch_dmrs_cyclic_shift: int = 0
    sr_bit_len: int = 0
    bit_len_harq: int = 0
    csi_part1_bit_length: int = 0
    max_code_rate: int = 0
    ul_bwp_id: int = 0


# ------------------------------------------------------------------ PRACH
@dataclasses.dataclass
class UlPrachPdu:
    """messages.h:470."""
    phys_cell_id: int = 0
    num_prach_ocas: int = 1
    prach_format: PrachFormatType = PrachFormatType.F0
    index_fd_ra: int = 0
    prach_start_symbol: int = 0
    num_cs: int = 0
    maintenance_v3_handle: int = 0
    maintenance_v3_prach_config_scope: int = 0
    maintenance_v3_prach_res_config_index: int = 0
    maintenance_v3_num_fd_ra: int = 1
    maintenance_v3_start_preamble_index: int = 0
    maintenance_v3_num_preamble_indices: int = 64


# --------------------------------------------- SCF -> processor configs
def dmrs_mask_to_symbols(mask: int) -> tuple:
    return tuple(i for i in range(14) if (mask >> i) & 1)


def symbols_to_dmrs_mask(symbols) -> int:
    out = 0
    for s in symbols:
        out |= 1 << s
    return out


def pdsch_to_config(pdu: DlPdschPdu, slot_in_frame: int = 0) -> ShConfig:
    """dl_pdsch_pdu -> ShConfig (fapi_to_phy_translator PDSCH path)."""
    cw = pdu.cws[0]
    return ShConfig(
        rnti=pdu.rnti,
        tbs=cw.tb_size_bytes * 8,
        qm=cw.qam_mod_order,
        rv=cw.rv_index,
        nof_layers=pdu.num_layers,
        prb_start=pdu.bwp_start + pdu.rb_start,
        nof_prb=pdu.rb_size,
        first_symbol=pdu.start_symbol_index,
        nof_symbols=pdu.nr_of_symbols,
        dmrs_symbols=dmrs_mask_to_symbols(pdu.dl_dmrs_symb_pos),
        dmrs_cdm_groups_without_data=pdu.num_dmrs_cdm_grps_no_data,
        nid=pdu.nid_pdsch,
        nid_dmrs=pdu.pdsch_dmrs_scrambling_id,
        n_scid=pdu.nscid,
        slot_in_frame=slot_in_frame,
        vrb_to_prb_interleaved=(pdu.vrb_to_prb_mapping
                                != VrbToPrbMappingType.NON_INTERLEAVED),
        bwp_nof_prb=pdu.bwp_size if pdu.vrb_to_prb_mapping
        != VrbToPrbMappingType.NON_INTERLEAVED else 0,
    )


# TS 38.213 Table 9.3-1 (HARQ-ACK beta offsets) and 9.3-2 (CSI), the
# SCF beta_offset_* indices resolve through these
_BETA_HARQ = (1.0, 2.0, 2.5, 3.125, 4.0, 5.0, 6.25, 8.0, 10.0, 12.625,
              15.875, 20.0, 31.0, 50.0, 80.0, 126.0)
_BETA_CSI = (1.125, 1.25, 1.375, 1.625, 1.75, 2.0, 2.25, 2.5, 2.875,
             3.125, 3.5, 4.0, 5.0, 6.25, 8.0, 10.0, 12.625, 15.875, 20.0)
_ALPHA = (0.5, 0.65, 0.8, 1.0)


def pusch_to_config(pdu: UlPuschPdu, slot_in_frame: int = 0) -> ShConfig:
    """ul_pusch_pdu -> ShConfig (fapi_to_phy_translator PUSCH path),
    including the UCI-on-PUSCH G computation from the SCF beta-offset
    indices (uci_allocator beta tables, TS 38.213 §9.3)."""
    import dataclasses as _dc

    from ..phy.upper import ulsch

    cfg = ShConfig(
        rnti=pdu.rnti,
        tbs=pdu.pusch_data.tb_size_bytes * 8,
        qm=pdu.qam_mod_order,
        rv=pdu.pusch_data.rv_index,
        nof_layers=pdu.num_layers,
        prb_start=pdu.bwp_start + pdu.rb_start,
        nof_prb=pdu.rb_size,
        first_symbol=pdu.start_symbol_index,
        nof_symbols=pdu.nr_of_symbols,
        dmrs_symbols=dmrs_mask_to_symbols(pdu.ul_dmrs_symb_pos),
        dmrs_cdm_groups_without_data=pdu.num_dmrs_cdm_grps_no_data,
        nid=pdu.nid_pusch,
        nid_dmrs=pdu.pusch_dmrs_scrambling_id,
        n_scid=pdu.nscid,
        slot_in_frame=slot_in_frame,
    )
    u = pdu.pusch_uci
    if ((pdu.pdu_bitmap >> 1) & 1) and (u.harq_ack_bit_length
                                        or u.csi_part1_bit_length):
        m_uci_sc = int(cfg.data_re_indices[0].shape[0])
        sum_kr = cfg.tbs + 24
        alpha = _ALPHA[u.alpha_scaling % len(_ALPHA)]
        o_ack = u.harq_ack_bit_length
        g_ack = ulsch.uci_encoded_bits(
            o_ack, 0, _BETA_HARQ[u.beta_offset_harq_ack % len(_BETA_HARQ)],
            alpha, sum_kr, m_uci_sc, cfg.qm,
            cfg.nof_layers) if o_ack else 0
        o_csi = u.csi_part1_bit_length
        g_csi = ulsch.uci_encoded_bits(
            o_csi, 0, _BETA_CSI[u.beta_offset_csi1 % len(_BETA_CSI)],
            alpha, sum_kr, m_uci_sc, cfg.qm,
            cfg.nof_layers) if o_csi else 0
        uci = ulsch.UciOnPusch(
            nof_harq_ack_bits=o_ack, nof_csi_part1_bits=o_csi,
            g_harq_ack=g_ack if o_ack > 2 else 0,
            g_harq_ack_rvd=g_ack if 0 < o_ack <= 2 else 0,
            g_csi_part1=g_csi)
        cfg = _dc.replace(cfg, uci=uci)
    return cfg


def pucch_to_config(pdu: UlPucchPdu, slot_in_frame: int = 0):
    """ul_pucch_pdu -> PucchF1Config / PucchF2Config."""
    if pdu.format_type == PucchFormatType.F1:
        return PucchF1Config(
            prb=pdu.bwp_start + pdu.prb_start,
            initial_cyclic_shift=pdu.initial_cyclic_shift,
            n_id=pdu.nid_pucch_hopping,
            start_symbol=pdu.start_symbol_index,
            nof_symbols=pdu.nr_of_symbols,
            occ_index=pdu.time_domain_occ_index,
            nof_harq_bits=max(1, pdu.bit_len_harq),
            slot_in_frame=slot_in_frame)
    if pdu.format_type == PucchFormatType.F2:
        return PucchF2Config(
            prb_start=pdu.bwp_start + pdu.prb_start,
            nof_prb=pdu.prb_size,
            rnti=pdu.rnti,
            n_id=pdu.nid_pucch_scrambling,
            n_id0=pdu.nid0_pucch_dmrs_scrambling,
            nof_uci_bits=pdu.bit_len_harq + pdu.sr_bit_len
            + pdu.csi_part1_bit_length,
            start_symbol=pdu.start_symbol_index,
            nof_symbols=pdu.nr_of_symbols,
            slot_in_frame=slot_in_frame)
    raise ValueError(f"PUCCH format {pdu.format_type} not in 23.5 scope "
                     f"(F0/F3/F4 absent upstream too)")


def pdcch_to_configs(pdu: DlPdcchPdu) -> list[PdcchConfig]:
    """dl_pdcch_pdu -> one PdcchConfig per DCI."""
    out = []
    for dci in pdu.dl_dci:
        out.append(PdcchConfig(
            rnti=dci.rnti,
            payload_size=dci.payload_size_bits,
            aggregation_level=dci.aggregation_level,
            cce_index=dci.cce_index,
            coreset_start_prb=pdu.coreset_bwp_start,
            start_symbol=pdu.start_symbol_index,
            nof_symbols=pdu.duration_symbols,
            n_id=dci.nid_pdcch_data,
            n_rnti=dci.nrnti_pdcch_data,
            interleaved=(pdu.cce_reg_mapping_type
                         == CceToRegMappingType.INTERLEAVED),
            coreset_nof_prb=pdu.coreset_bwp_size,
            interleaver_rows=pdu.interleaver_size,
            shift=pdu.shift_index))
    return out


# ------------------------------------- SCF requests -> processor requests
def ul_tti_to_processor_request(req, slot_in_frame: int | None = None):
    """builders.ScfUlTtiRequest -> messages.UlTtiRequest: the adaptor
    step that lets an SCF-speaking MAC drive the bucketed fused UL slot
    programs (fapi_to_phy_translator.cpp ul path)."""
    from . import messages as msgs

    sif = req.slot if slot_in_frame is None else slot_in_frame
    out = msgs.UlTtiRequest(sfn=req.sfn, slot=req.slot)
    for p in req.pusch_pdus:
        out.pusch_pdus.append(msgs.PuschPdu(
            config=pusch_to_config(p, sif),
            harq_process=p.pusch_data.harq_process_id,
            new_data=p.pusch_data.new_data))
    for p in req.pucch_pdus:
        cfg = pucch_to_config(p, sif)
        if p.format_type == PucchFormatType.F1:
            out.pucch_pdus.append(msgs.PucchPdu(
                format1=cfg, rnti=p.rnti,
                is_sr=(p.sr_bit_len > 0 and p.bit_len_harq == 0)))
        else:
            out.pucch_pdus.append(msgs.PucchPdu(format2=cfg, rnti=p.rnti))
    for p in req.prach_pdus:
        out.prach_pdus.append(msgs.PrachPdu(
            root_sequence_index=p.maintenance_v3_prach_res_config_index,
            length=839 if p.prach_format in (PrachFormatType.F0,
                                             PrachFormatType.F1,
                                             PrachFormatType.F2,
                                             PrachFormatType.F3) else 139,
            zero_correlation_zone=p.num_cs, occasion=p.index_fd_ra,
            nof_preambles=p.maintenance_v3_num_preamble_indices))
    return out


def dl_tti_to_processor_request(req, slot_in_frame: int | None = None):
    """builders.ScfDlTtiRequest -> messages.DlTtiRequest (DL path).

    SSB/CSI-RS PDUs still carry framework processor configs at the SCF
    layer boundary in this build; PDSCH/PDCCH translate from the full
    SCF surfaces."""
    import numpy as np

    from . import messages as msgs

    sif = req.slot if slot_in_frame is None else slot_in_frame
    out = msgs.DlTtiRequest(sfn=req.sfn, slot=req.slot)
    for p in req.pdsch_pdus:
        out.pdsch_pdus.append(msgs.PdschPdu(pdsch_to_config(p, sif)))
    for p in req.pdcch_pdus:
        for cfg, dci in zip(pdcch_to_configs(p), p.dl_dci):
            bits = np.unpackbits(
                np.frombuffer(dci.payload, np.uint8))[:dci.payload_size_bits]
            out.pdcch_pdus.append(msgs.PdcchPdu(cfg, bits.astype(np.int8)))
    out.ssb_pdus.extend(req.ssb_pdus)
    out.csi_rs_pdus.extend(req.csi_rs_pdus)
    return out
