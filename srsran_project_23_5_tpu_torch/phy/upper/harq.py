"""HARQ receive softbuffer pool — LLR soft-combining across retransmissions.

Counterpart of ``srsran_project_23_5_tpu/phy/upper/harq.py`` (the reference's
rx_softbuffer_pool): per-(rnti, harq) buffers of full-codeword LLRs,
reserved on the first transmission, combined on retransmission, released on
CRC pass or on slot expiry.  The buffers are tensors on the device of the
receiver ([C, N_full*Zc] float32 per process); the pool never moves them to
the host.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class _Entry:
    llr: torch.Tensor           # [C, N_full*Zc] accumulated LLRs
    expiry_slot: int


class SoftbufferPool:
    def __init__(self, expiry_slots: int = 100) -> None:
        self._buffers: dict[tuple[int, int], _Entry] = {}
        self._expiry = expiry_slots

    def combine(self, rnti: int, harq: int, llr: torch.Tensor,
                new_data: bool, slot_count: int) -> torch.Tensor:
        """Return combined LLRs, updating the stored buffer."""
        key = (rnti, harq)
        if not new_data and key in self._buffers:
            stored = self._buffers[key].llr
            if stored.shape == llr.shape:
                llr = stored + llr
        self._buffers[key] = _Entry(llr=llr,
                                    expiry_slot=slot_count + self._expiry)
        return llr

    # raw storage for the fused slot programs: the combine itself runs on the
    # device inside the program; the pool only holds the results between
    # slots (slot_programs.py)
    def get(self, rnti: int, harq: int) -> torch.Tensor | None:
        e = self._buffers.get((rnti, harq))
        return e.llr if e is not None else None

    def put(self, rnti: int, harq: int, llr: torch.Tensor,
            slot_count: int) -> None:
        self._buffers[(rnti, harq)] = _Entry(
            llr=llr, expiry_slot=slot_count + self._expiry)

    def release(self, rnti: int, harq: int) -> None:
        self._buffers.pop((rnti, harq), None)

    def run_slot(self, slot_count: int) -> None:
        """Expire stale reservations (the upper PHY's timing-handler duty)."""
        dead = [k for k, e in self._buffers.items()
                if e.expiry_slot <= slot_count]
        for k in dead:
            del self._buffers[k]

    def __len__(self) -> int:
        return len(self._buffers)
