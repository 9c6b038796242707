"""FAPI message validators (reference lib/fapi/message_validators.cpp +
validators/*.cpp): field-range and cross-field checks applied to slot
requests before they reach the PHY.

Each validator returns a list of error strings (empty = valid);
`validate_or_raise` wraps any validator for the strict path.  The checks
mirror the reference's per-PDU validators: range checks on sfn/slot,
allocation-in-carrier checks, modulation/rv ranges, payload-size
consistency between TX_Data.request and the DL_TTI PDUs, and
PRACH/PUCCH geometry bounds.
"""
from __future__ import annotations

from ..ran.constants import NRE
from . import messages as fapi

MAX_SFN = 1024
NSYM = 14
VALID_QM = (1, 2, 4, 6, 8)
VALID_PRACH_LENGTHS = (139, 839)


class FapiValidationError(ValueError):
    pass


def _check_timing(msg, nof_slots_per_frame: int, errors: list) -> None:
    if not 0 <= msg.sfn < MAX_SFN:
        errors.append(f"sfn {msg.sfn} out of range [0, {MAX_SFN})")
    if not 0 <= msg.slot < nof_slots_per_frame:
        errors.append(
            f"slot {msg.slot} out of range [0, {nof_slots_per_frame})")


def _check_sh(cfg, nof_prb: int, what: str, errors: list) -> None:
    if not 1 <= cfg.rnti <= 0xFFFF:
        errors.append(f"{what}: rnti {cfg.rnti:#x} out of range")
    if cfg.qm not in VALID_QM:
        errors.append(f"{what}: invalid modulation order {cfg.qm}")
    if not 0 <= cfg.rv <= 3:
        errors.append(f"{what}: rv {cfg.rv} out of range [0, 3]")
    if cfg.nof_layers not in (1, 2, 4):
        errors.append(f"{what}: nof_layers {cfg.nof_layers} unsupported")
    if cfg.prb_start < 0 or cfg.nof_prb < 1 \
            or cfg.prb_start + cfg.nof_prb > nof_prb:
        errors.append(
            f"{what}: allocation [{cfg.prb_start}, "
            f"{cfg.prb_start + cfg.nof_prb}) outside carrier 0..{nof_prb}")
    if cfg.first_symbol < 0 or cfg.nof_symbols < 1 \
            or cfg.first_symbol + cfg.nof_symbols > NSYM:
        errors.append(
            f"{what}: symbols [{cfg.first_symbol}, "
            f"{cfg.first_symbol + cfg.nof_symbols}) outside the slot")
    if cfg.tbs <= 0:
        errors.append(f"{what}: tbs {cfg.tbs} must be positive")
    elif cfg.tbs > cfg.nof_bits:
        errors.append(
            f"{what}: tbs {cfg.tbs} exceeds allocation capacity "
            f"{cfg.nof_bits} (code rate > 1)")
    for l in cfg.dmrs_symbols:
        if not cfg.first_symbol <= l < cfg.first_symbol + cfg.nof_symbols:
            errors.append(f"{what}: DM-RS symbol {l} outside allocation")


def validate_dl_tti(req: fapi.DlTtiRequest, nof_prb: int,
                    nof_slots_per_frame: int = 20) -> list[str]:
    errors: list[str] = []
    _check_timing(req, nof_slots_per_frame, errors)
    for i, pdu in enumerate(req.pdsch_pdus):
        _check_sh(pdu.config, nof_prb, f"pdsch[{i}]", errors)
    for i, pdu in enumerate(req.pdcch_pdus):
        cfg = pdu.config
        if cfg.aggregation_level not in (1, 2, 4, 8, 16):
            errors.append(f"pdcch[{i}]: aggregation level "
                          f"{cfg.aggregation_level} invalid")
        if cfg.payload_size < 1 or cfg.payload_size > 140:
            errors.append(f"pdcch[{i}]: DCI payload size "
                          f"{cfg.payload_size} out of range [1, 140]")
        if len(pdu.payload_bits) != cfg.payload_size:
            errors.append(
                f"pdcch[{i}]: payload has {len(pdu.payload_bits)} bits, "
                f"config says {cfg.payload_size}")
        # CCE-to-PRB mapping: each CCE spans 6 REGs spread over
        # nof_symbols rows, so both the candidate's offset (cce_index)
        # and span (aggregation_level) scale by 6/nof_symbols PRBs
        # (matches PdcchConfig.re_indices bundle math).
        last_prb = (cfg.coreset_start_prb
                    + (cfg.cce_index + cfg.aggregation_level) * 6
                    // cfg.nof_symbols)
        if last_prb > nof_prb:
            errors.append(f"pdcch[{i}]: candidate extends to PRB "
                          f"{last_prb} outside carrier 0..{nof_prb}")
        if not 0 <= cfg.start_symbol <= 2 or not 1 <= cfg.nof_symbols <= 3:
            errors.append(f"pdcch[{i}]: CORESET symbols invalid")
    for i, pdu in enumerate(req.ssb_pdus):
        if not 0 <= pdu.config.pci < 1008:
            errors.append(f"ssb[{i}]: pci {pdu.config.pci} out of range")
        if len(pdu.payload_bits) != 32:
            errors.append(f"ssb[{i}]: PBCH payload must be 32 bits, got "
                          f"{len(pdu.payload_bits)}")
        if pdu.first_subcarrier < 0 \
                or pdu.first_subcarrier + 240 > nof_prb * NRE:
            errors.append(f"ssb[{i}]: SSB at subcarrier "
                          f"{pdu.first_subcarrier} outside the carrier")
    for i, pdu in enumerate(req.csi_rs_pdus):
        cfg = pdu.config
        if cfg.row not in (1, 2, 4):
            errors.append(f"csi_rs[{i}]: row {cfg.row} unsupported")
        if cfg.prb_start < 0 or cfg.prb_start + cfg.nof_prb > nof_prb:
            errors.append(f"csi_rs[{i}]: allocation outside carrier")
        if not 0 <= cfg.symbol < NSYM:
            errors.append(f"csi_rs[{i}]: symbol {cfg.symbol} invalid")
        if not 0 <= cfg.subcarrier_offset < NRE:
            errors.append(f"csi_rs[{i}]: k0 {cfg.subcarrier_offset} "
                          f"out of range")
    return errors


def validate_tx_data(req: fapi.TxDataRequest, dl: fapi.DlTtiRequest
                     ) -> list[str]:
    errors: list[str] = []
    if len(req.transport_blocks) != len(dl.pdsch_pdus):
        errors.append(
            f"TX_Data carries {len(req.transport_blocks)} TBs for "
            f"{len(dl.pdsch_pdus)} PDSCH PDUs")
    for i, (tb, pdu) in enumerate(zip(req.transport_blocks,
                                      dl.pdsch_pdus)):
        if len(tb) != pdu.config.tbs:
            errors.append(f"tb[{i}]: {len(tb)} bits != tbs "
                          f"{pdu.config.tbs}")
    if (req.sfn, req.slot) != (dl.sfn, dl.slot):
        errors.append("TX_Data timing differs from DL_TTI")
    return errors


def validate_ul_tti(req: fapi.UlTtiRequest, nof_prb: int,
                    nof_slots_per_frame: int = 20) -> list[str]:
    errors: list[str] = []
    _check_timing(req, nof_slots_per_frame, errors)
    for i, pdu in enumerate(req.pusch_pdus):
        _check_sh(pdu.config, nof_prb, f"pusch[{i}]", errors)
        if not 0 <= pdu.harq_process < 16:
            errors.append(f"pusch[{i}]: harq process {pdu.harq_process} "
                          f"out of range [0, 16)")
    for i, pdu in enumerate(req.pucch_pdus):
        if pdu.format1 is None and pdu.format2 is None:
            errors.append(f"pucch[{i}]: no format payload")
        if pdu.format1 is not None:
            f1 = pdu.format1
            if not 0 <= f1.prb < nof_prb:
                errors.append(f"pucch[{i}]: F1 PRB {f1.prb} outside "
                              f"carrier")
            if not 4 <= f1.nof_symbols <= 14:
                errors.append(f"pucch[{i}]: F1 length {f1.nof_symbols} "
                              f"out of range [4, 14]")
            if f1.nof_harq_bits not in (1, 2):
                errors.append(f"pucch[{i}]: F1 carries "
                              f"{f1.nof_harq_bits} HARQ bits (1-2 valid)")
            if not 0 <= f1.initial_cyclic_shift < 12:
                errors.append(f"pucch[{i}]: F1 cyclic shift "
                              f"{f1.initial_cyclic_shift} out of range")
        if pdu.format2 is not None:
            f2 = pdu.format2
            if f2.prb_start < 0 or f2.prb_start + f2.nof_prb > nof_prb:
                errors.append(f"pucch[{i}]: F2 allocation outside carrier")
            if not 3 <= f2.nof_uci_bits <= 11:
                errors.append(f"pucch[{i}]: F2 carries {f2.nof_uci_bits} "
                              f"UCI bits (3-11 valid for short block)")
    for i, pdu in enumerate(req.prach_pdus):
        if pdu.length not in VALID_PRACH_LENGTHS:
            errors.append(f"prach[{i}]: length {pdu.length} invalid "
                          f"(139/839)")
        if not 0 <= pdu.root_sequence_index < pdu.length:
            errors.append(f"prach[{i}]: root {pdu.root_sequence_index} "
                          f"out of range [0, {pdu.length})")
        if not 0 <= pdu.zero_correlation_zone < pdu.length:
            errors.append(f"prach[{i}]: N_cs "
                          f"{pdu.zero_correlation_zone} out of range")
    return errors


def validate_or_raise(errors: list[str], what: str = "FAPI slot message"
                      ) -> None:
    if errors:
        raise FapiValidationError(
            f"{what}: {len(errors)} error(s): " + "; ".join(errors))
