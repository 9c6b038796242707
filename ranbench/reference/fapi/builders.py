"""FAPI message builders — the message_builders.h analogue.

Copied from the port's ``srsran_project_23_5_tpu_torch/fapi/builders.py``,
unchanged.

Fluent builders that assemble full-surface SCF PDUs (`fapi.scf`) into
slot request messages, mirroring the reference's builder API
(include/srsran/fapi/message_builders.h: dl_tti_request_message_builder
with add_pdsch_pdu()->dl_pdsch_pdu_builder::set_basic/codeword/dmrs/
rb/symbol setters; ul_tti_request_message_builder likewise).  build()
returns the SCF-level request plus the translated processor-config
request (`fapi.messages`) that the rest of the PHY consumes.
"""
from __future__ import annotations

import dataclasses

from . import scf
from . import messages as msgs


@dataclasses.dataclass
class ScfDlTtiRequest:
    sfn: int
    slot: int
    pdcch_pdus: list = dataclasses.field(default_factory=list)
    pdsch_pdus: list = dataclasses.field(default_factory=list)
    csi_rs_pdus: list = dataclasses.field(default_factory=list)
    ssb_pdus: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ScfUlTtiRequest:
    sfn: int
    slot: int
    prach_pdus: list = dataclasses.field(default_factory=list)
    pusch_pdus: list = dataclasses.field(default_factory=list)
    pucch_pdus: list = dataclasses.field(default_factory=list)


class PdschPduBuilder:
    """dl_pdsch_pdu_builder (message_builders.h)."""

    def __init__(self) -> None:
        self.pdu = scf.DlPdschPdu()

    def set_basic_parameters(self, rnti: int, pdu_index: int = 0):
        self.pdu.rnti = rnti
        self.pdu.pdu_index = pdu_index
        return self

    def set_bwp_parameters(self, bwp_size: int, bwp_start: int,
                           scs: int = 1, cp: int = 0):
        self.pdu.bwp_size = bwp_size
        self.pdu.bwp_start = bwp_start
        self.pdu.scs = scs
        self.pdu.cyclic_prefix = cp
        return self

    def add_codeword(self, target_code_rate: int, qam_mod_order: int,
                     mcs_index: int, mcs_table: int, rv_index: int,
                     tb_size_bytes: int):
        self.pdu.cws.append(scf.DlPdschCodeword(
            target_code_rate, qam_mod_order, mcs_index, mcs_table,
            rv_index, tb_size_bytes))
        return self

    def set_codeword_information_parameters(self, nid_pdsch: int,
                                            num_layers: int,
                                            transmission_scheme: int = 0,
                                            ref_point: scf.
                                            PdschRefPointType = scf.
                                            PdschRefPointType.POINT_A):
        self.pdu.nid_pdsch = nid_pdsch
        self.pdu.num_layers = num_layers
        self.pdu.transmission_scheme = transmission_scheme
        self.pdu.ref_point = ref_point
        return self

    def set_dmrs_parameters(self, dmrs_symbol_mask: int,
                            dmrs_type: scf.DmrsCfgType,
                            scrambling_id: int, nscid: int,
                            num_cdm_grps_no_data: int, dmrs_ports: int):
        self.pdu.dl_dmrs_symb_pos = dmrs_symbol_mask
        self.pdu.dmrs_type = dmrs_type
        self.pdu.pdsch_dmrs_scrambling_id = scrambling_id
        self.pdu.nscid = nscid
        self.pdu.num_dmrs_cdm_grps_no_data = num_cdm_grps_no_data
        self.pdu.dmrs_ports = dmrs_ports
        return self

    def set_pdsch_allocation_in_frequency_type_1(
            self, rb_start: int, rb_size: int,
            vrb_to_prb: scf.VrbToPrbMappingType = scf.
            VrbToPrbMappingType.NON_INTERLEAVED):
        self.pdu.resource_alloc = scf.ResourceAllocationType.TYPE_1
        self.pdu.rb_start = rb_start
        self.pdu.rb_size = rb_size
        self.pdu.vrb_to_prb_mapping = vrb_to_prb
        return self

    def set_pdsch_allocation_in_time_parameters(self, start_symbol: int,
                                                nof_symbols: int):
        self.pdu.start_symbol_index = start_symbol
        self.pdu.nr_of_symbols = nof_symbols
        return self


class PuschPduBuilder:
    """ul_pusch_pdu_builder (message_builders.h)."""

    def __init__(self) -> None:
        self.pdu = scf.UlPuschPdu()

    def set_basic_parameters(self, rnti: int, handle: int = 0):
        self.pdu.rnti = rnti
        self.pdu.handle = handle
        return self

    def set_bwp_parameters(self, bwp_size: int, bwp_start: int,
                           scs: int = 1, cp: int = 0):
        self.pdu.bwp_size = bwp_size
        self.pdu.bwp_start = bwp_start
        self.pdu.scs = scs
        self.pdu.cyclic_prefix = cp
        return self

    def set_information_parameters(self, target_code_rate: int,
                                   qam_mod_order: int, mcs_index: int,
                                   mcs_table: int,
                                   transform_precoding: bool,
                                   nid_pusch: int, num_layers: int):
        p = self.pdu
        p.target_code_rate = target_code_rate
        p.qam_mod_order = qam_mod_order
        p.mcs_index = mcs_index
        p.mcs_table = mcs_table
        p.transform_precoding = transform_precoding
        p.nid_pusch = nid_pusch
        p.num_layers = num_layers
        return self

    def set_dmrs_parameters(self, dmrs_symbol_mask: int,
                            dmrs_type: scf.DmrsCfgType,
                            scrambling_id: int, pusch_dmrs_identity: int,
                            nscid: int, num_cdm_grps_no_data: int,
                            dmrs_ports: int):
        p = self.pdu
        p.ul_dmrs_symb_pos = dmrs_symbol_mask
        p.dmrs_type = dmrs_type
        p.pusch_dmrs_scrambling_id = scrambling_id
        p.pusch_dmrs_identity = pusch_dmrs_identity
        p.nscid = nscid
        p.num_dmrs_cdm_grps_no_data = num_cdm_grps_no_data
        p.dmrs_ports = dmrs_ports
        return self

    def set_allocation_in_frequency_type_1_parameters(
            self, rb_start: int, rb_size: int,
            intra_slot_hopping: bool = False):
        self.pdu.resource_alloc = scf.ResourceAllocationType.TYPE_1
        self.pdu.rb_start = rb_start
        self.pdu.rb_size = rb_size
        self.pdu.intra_slot_frequency_hopping = intra_slot_hopping
        return self

    def set_allocation_in_time_parameters(self, start_symbol: int,
                                          nof_symbols: int):
        self.pdu.start_symbol_index = start_symbol
        self.pdu.nr_of_symbols = nof_symbols
        return self

    def add_optional_pusch_data(self, rv_index: int, harq_process_id: int,
                                new_data: bool, tb_size_bytes: int,
                                num_cb: int = 0):
        self.pdu.pdu_bitmap |= 1
        self.pdu.pusch_data = scf.UlPuschData(
            rv_index, harq_process_id, new_data, tb_size_bytes, num_cb)
        return self

    def add_optional_pusch_uci(self, harq_ack_bits: int, csi1_bits: int,
                               alpha_scaling: int = 0,
                               beta_offset_harq_ack: int = 9,
                               beta_offset_csi1: int = 13):
        self.pdu.pdu_bitmap |= 2
        self.pdu.pusch_uci = scf.UlPuschUci(
            harq_ack_bits, csi1_bits, 0, alpha_scaling,
            beta_offset_harq_ack, beta_offset_csi1, 0)
        return self


class PucchPduBuilder:
    def __init__(self) -> None:
        self.pdu = scf.UlPucchPdu()

    def set_basic_parameters(self, rnti: int,
                             format_type: scf.PucchFormatType,
                             handle: int = 0):
        self.pdu.rnti = rnti
        self.pdu.format_type = format_type
        self.pdu.handle = handle
        return self

    def set_allocation_in_frequency_parameters(self, prb_start: int,
                                               prb_size: int = 1):
        self.pdu.prb_start = prb_start
        self.pdu.prb_size = prb_size
        return self

    def set_allocation_in_time_parameters(self, start_symbol: int,
                                          nof_symbols: int):
        self.pdu.start_symbol_index = start_symbol
        self.pdu.nr_of_symbols = nof_symbols
        return self

    def set_format1_parameters(self, initial_cyclic_shift: int,
                               time_domain_occ: int = 0,
                               nid_hopping: int = 0):
        self.pdu.initial_cyclic_shift = initial_cyclic_shift
        self.pdu.time_domain_occ_index = time_domain_occ
        self.pdu.nid_pucch_hopping = nid_hopping
        return self

    def set_uci_bit_lengths(self, harq_bits: int, sr_bits: int = 0,
                            csi1_bits: int = 0):
        self.pdu.bit_len_harq = harq_bits
        self.pdu.sr_bit_len = sr_bits
        self.pdu.csi_part1_bit_length = csi1_bits
        return self

    def set_scrambling(self, nid_scrambling: int, nid0_dmrs: int = 0):
        self.pdu.nid_pucch_scrambling = nid_scrambling
        self.pdu.nid0_pucch_dmrs_scrambling = nid0_dmrs
        return self


class DlTtiRequestBuilder:
    """dl_tti_request_message_builder."""

    def __init__(self, sfn: int, slot: int) -> None:
        self.req = ScfDlTtiRequest(sfn, slot)

    def add_pdsch_pdu(self) -> PdschPduBuilder:
        b = PdschPduBuilder()
        self.req.pdsch_pdus.append(b.pdu)
        return b

    def add_pdcch_pdu(self, pdu: scf.DlPdcchPdu) -> "DlTtiRequestBuilder":
        self.req.pdcch_pdus.append(pdu)
        return self

    def add_ssb_pdu(self, pdu: scf.DlSsbPdu) -> "DlTtiRequestBuilder":
        self.req.ssb_pdus.append(pdu)
        return self

    def add_csi_rs_pdu(self, pdu: scf.DlCsiRsPdu) -> "DlTtiRequestBuilder":
        self.req.csi_rs_pdus.append(pdu)
        return self

    def build(self) -> ScfDlTtiRequest:
        return self.req


class UlTtiRequestBuilder:
    """ul_tti_request_message_builder."""

    def __init__(self, sfn: int, slot: int) -> None:
        self.req = ScfUlTtiRequest(sfn, slot)

    def add_pusch_pdu(self) -> PuschPduBuilder:
        b = PuschPduBuilder()
        self.req.pusch_pdus.append(b.pdu)
        return b

    def add_pucch_pdu(self) -> PucchPduBuilder:
        b = PucchPduBuilder()
        self.req.pucch_pdus.append(b.pdu)
        return b

    def add_prach_pdu(self, pdu: scf.UlPrachPdu) -> "UlTtiRequestBuilder":
        self.req.prach_pdus.append(pdu)
        return self

    def build(self) -> ScfUlTtiRequest:
        return self.req
