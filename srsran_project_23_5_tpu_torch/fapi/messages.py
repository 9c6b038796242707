"""FAPI-style slot messages (SCF-FAPI shape) for the port's upper PHY.

Counterpart of ``srsran_project_23_5_tpu/fapi/messages.py``: the same
dataclasses, in the same order and with the same fields, carrying the
DL_TTI / UL_TTI / TX_Data requests and the uplink indications (CRC,
RxData, UCI, RACH) between the MAC/scheduler and the PHY.  PDU payloads
reference the port's static processor configs (``phy.upper.sch.ShConfig``
etc.); payload bits are numpy arrays, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..phy.upper.csi_rs import CsiRsConfig
from ..phy.upper.pdcch import PdcchConfig
from ..phy.upper.pucch import PucchF1Config, PucchF2Config
from ..phy.upper.sch import ShConfig
from ..phy.upper.ssb import SsbConfig


@dataclasses.dataclass
class SsbPdu:
    config: SsbConfig
    payload_bits: np.ndarray          # 32-bit PBCH payload
    first_subcarrier: int = 0         # SSB offset within the grid


@dataclasses.dataclass
class PdcchPdu:
    config: PdcchConfig
    payload_bits: np.ndarray          # DCI payload


@dataclasses.dataclass
class PdschPdu:
    config: ShConfig


@dataclasses.dataclass
class CsiRsPdu:
    config: CsiRsConfig


@dataclasses.dataclass
class DlTtiRequest:
    """DL_TTI.request (messages.h:424)."""
    sfn: int
    slot: int
    ssb_pdus: list[SsbPdu] = dataclasses.field(default_factory=list)
    pdcch_pdus: list[PdcchPdu] = dataclasses.field(default_factory=list)
    pdsch_pdus: list[PdschPdu] = dataclasses.field(default_factory=list)
    csi_rs_pdus: list[CsiRsPdu] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class UlDciRequest:
    """UL_DCI.request (messages.h ul_dci_request_message): PDCCH PDUs
    carrying UL grants (DCI 0_0), transmitted in this slot's DL control
    region for PUSCH landing at slot + k2."""
    sfn: int
    slot: int
    pdcch_pdus: list[PdcchPdu] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TxDataRequest:
    """TX_Data.request (messages.h:841): transport blocks for the PDSCH
    PDUs of the same slot, in order."""
    sfn: int
    slot: int
    transport_blocks: list[np.ndarray] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PrachPdu:
    root_sequence_index: int
    length: int = 839                 # 839 long / 139 short
    zero_correlation_zone: int = 13   # N_cs
    occasion: int = 0
    # in-grid short-format geometry (139-subcarrier window repeated over
    # nof_symbols OFDM symbols; the lower PHY slices these REs out of the
    # demodulated UL grid)
    sc_start: int = 0
    nof_symbols: int = 12
    nof_preambles: int = 64


@dataclasses.dataclass
class PuschPdu:
    config: ShConfig
    harq_process: int = 0
    new_data: bool = True


@dataclasses.dataclass
class PucchPdu:
    format1: Optional[PucchF1Config] = None
    format2: Optional[PucchF2Config] = None
    rnti: int = 0
    harq_pid: int = 0                 # DL HARQ the F1 ACK closes
    is_sr: bool = False               # F1 resource is an SR opportunity


@dataclasses.dataclass
class UlTtiRequest:
    """UL_TTI.request (messages.h:774)."""
    sfn: int
    slot: int
    prach_pdus: list[PrachPdu] = dataclasses.field(default_factory=list)
    pusch_pdus: list[PuschPdu] = dataclasses.field(default_factory=list)
    pucch_pdus: list[PucchPdu] = dataclasses.field(default_factory=list)


# ------------------------------------------------------------- indications
@dataclasses.dataclass
class CrcIndication:
    sfn: int
    slot: int
    rnti: int
    harq_process: int
    tb_crc_ok: bool
    sinr_db: float
    # PUSCH time-alignment estimate (samples at the carrier rate) — the
    # MAC turns residual error into a TA command CE
    ta_samples: float = 0.0


@dataclasses.dataclass
class RxDataIndication:
    sfn: int
    slot: int
    rnti: int
    harq_process: int
    payload: np.ndarray               # decoded TB bits


@dataclasses.dataclass
class UciIndication:
    sfn: int
    slot: int
    rnti: int
    harq_bits: Optional[np.ndarray]
    uci_bits: Optional[np.ndarray]
    detected: bool
    metric: float
    harq_pid: int = -1                # DL HARQ the F1 ACK closes
    is_sr: bool = False


@dataclasses.dataclass
class CsiIndication:
    """CSI measurement report (UCI.indication CSI part 1 distilled to the
    wideband CQI the scheduler's link adaptation consumes)."""
    sfn: int
    slot: int
    rnti: int
    cqi: int
    sinr_db: float


@dataclasses.dataclass
class RachIndication:
    sfn: int
    slot: int
    occasion: int
    preambles: list[tuple[int, float, float]]  # (index, metric, delay_chips)


@dataclasses.dataclass
class SlotIndication:
    sfn: int
    slot: int
