"""Per-UE scheduler context (reference lib/scheduler/ue_scheduling/ue.h,
dl_logical_channel_manager, ul_bsr)."""
from __future__ import annotations

import dataclasses

from .harq import HarqEntity


@dataclasses.dataclass
class UeContext:
    rnti: int
    dl_harqs: HarqEntity
    ul_harqs: HarqEntity
    dl_buffer_bytes: dict[int, int] = dataclasses.field(default_factory=dict)
    ul_buffer_bytes: int = 0              # from BSR
    pending_conres: bool = False          # send ConRes CE on next DL grant
    dl_ko_streak: int = 0                 # for RLF detection
    ul_ko_streak: int = 0
    # link adaptation state (reference ue_link_adaptation_controller)
    cqi: int = 0                          # last wideband CQI (0 = none)
    ul_sinr_db: float | None = None       # smoothed PUSCH SINR
    # timing advance maintenance (uplink time alignment,
    # port_channel_estimator TA -> MAC TA command CE)
    ta_samples: float = 0.0               # smoothed PUSCH TA estimate
    pending_ta_cmd: int | None = None     # sample delta to send as TA CE
    # metrics (scheduler_ue_metrics surface)
    dl_bytes: int = 0
    ul_bytes: int = 0
    dl_nof_ok: int = 0
    dl_nof_ko: int = 0
    ul_nof_ok: int = 0
    ul_nof_ko: int = 0
    # pooled SR/CSI PUCCH resources from the DU resource manager
    # (du_manager.ran_resources.UePucchAlloc); None = pool was exhausted
    pucch_alloc: object = None

    @classmethod
    def create(cls, rnti: int, nof_harqs: int = 16,
               max_retx: int = 4) -> "UeContext":
        return cls(rnti, HarqEntity(nof_harqs, max_retx),
                   HarqEntity(nof_harqs, max_retx))

    def total_dl_buffer(self) -> int:
        return sum(self.dl_buffer_bytes.values())

    def update_dl_buffer(self, lcid: int, nof_bytes: int) -> None:
        if nof_bytes:
            self.dl_buffer_bytes[lcid] = nof_bytes
        else:
            self.dl_buffer_bytes.pop(lcid, None)
