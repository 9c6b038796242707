"""Cell scheduler: the per-slot scheduling pipeline (reference
lib/scheduler/cell_scheduler.cpp:83-137 and ue_scheduling/).

run_slot(slot) executes SSB → SIB1 → PRACH → RA → UE DL (retx first,
then round-robin new transmissions) → UE UL, allocating PRBs first-fit
on a per-slot bitmap and returning a SlotResult for the MAC to turn into
FAPI messages.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

from ..ran import mcs_tables, tbs as tbs_mod
from . import config as cell_cfg
from .config import CellConfig
from .harq import HarqState
from .pdcch_alloc import PdcchSlotAllocator
from .results import DlGrant, PucchGrant, RarInfo, SlotResult, UlGrant
from .ue_context import UeContext

SI_RNTI = 0xFFFF
P_RNTI = 0xFFFE
MAX_CONSECUTIVE_KO = 100      # RLF threshold (reference rlf_detector.h)


class _PrbAllocator:
    def __init__(self, nof_prb: int, reserved_edge: int = 0) -> None:
        self.nof_prb = nof_prb
        self.next_free = reserved_edge
        self.limit = nof_prb - reserved_edge

    def alloc(self, nof: int) -> Optional[tuple[int, int]]:
        nof = min(nof, self.limit - self.next_free)
        if nof <= 0:
            return None
        start = self.next_free
        self.next_free += nof
        return (start, nof)


class CellScheduler:
    def __init__(self, cfg: CellConfig) -> None:
        from ..du_manager.ran_resources import PucchResourceManager
        self.cfg = cfg
        # pooled per-UE SR/CSI resources (du_manager ran-resource layer):
        # allocated at UE creation, delivered to the UE over RRC, freed
        # on UE removal — no formula re-derivation on either side
        self.pucch_mgr = PucchResourceManager(cfg)
        self.ues: dict[int, UeContext] = {}
        self._rr_dl = 0                     # round-robin cursors
        self._rr_ul = 0
        self._pending_ul: dict[int, list[UlGrant]] = {}
        self._pending_pucch: dict[int, list[PucchGrant]] = {}
        self._pending_rach: deque = deque() # (slot, occasion, preamble, ta)
        self._next_tc_rnti = 0x4601
        self.rlf_ues: list[int] = []        # RNTIs that hit RLF
        self._last_slot: Optional[int] = None
        self.nof_skipped_slots = 0
        self._pending_paging: list[bytes] = []   # UE identities to page

    # ----------------------------------------------------------- UE mgmt
    def add_ue(self, rnti: int) -> UeContext:
        from ..du_manager.ran_resources import ResourceExhausted
        ue = UeContext.create(rnti, self.cfg.nof_harqs, self.cfg.max_dl_retx)
        try:
            ue.pucch_alloc = self.pucch_mgr.alloc_ue(rnti)
        except ResourceExhausted:
            ue.pucch_alloc = None       # UE runs without SR/CSI resources
        self.ues[rnti] = ue
        return ue

    def remove_ue(self, rnti: int) -> None:
        if rnti in self.ues:
            self.pucch_mgr.free_ue(rnti)
        self.ues.pop(rnti, None)

    # ----------------------------------------------------- event handlers
    def handle_rach_indication(self, slot: int, occasion: int,
                               preamble: int, ta: int = 0) -> None:
        self._pending_rach.append((slot, occasion, preamble, ta))

    def handle_dl_buffer_state(self, rnti: int, lcid: int,
                               nof_bytes: int) -> None:
        if rnti in self.ues:
            self.ues[rnti].update_dl_buffer(lcid, nof_bytes)

    def handle_bsr(self, rnti: int, nof_bytes: int) -> None:
        if rnti in self.ues:
            self.ues[rnti].ul_buffer_bytes = nof_bytes

    def handle_paging_request(self, ue_identity: bytes) -> None:
        """Queue a paging record for the next paging occasion
        (paging_scheduler.cpp)."""
        self._pending_paging.append(bytes(ue_identity))

    def handle_sr_indication(self, rnti: int) -> None:
        """Positive SR: the UE has UL data but no grant — seed a minimal
        buffer estimate so the UL scheduler issues one
        (ue_scheduling sr handling)."""
        if rnti in self.ues and self.ues[rnti].ul_buffer_bytes <= 0:
            self.ues[rnti].ul_buffer_bytes = 16

    def handle_csi_report(self, rnti: int, cqi: int) -> None:
        """Wideband CQI → DL link adaptation (csi_report handling in
        lib/scheduler/ue_scheduling/ue_cell.cpp)."""
        if rnti in self.ues:
            self.ues[rnti].cqi = max(0, min(int(cqi), 15))

    def handle_crc_indication(self, rnti: int, harq_pid: int,
                              ok: bool, sinr_db: float | None = None,
                              ta_samples: float | None = None) -> None:
        """PUSCH decode outcome → UL HARQ (+ UL link adaptation from the
        measured SINR, IIR-smoothed; + uplink time-alignment maintenance:
        a residual PUSCH timing error beyond the threshold queues a TA
        command CE for the UE's next DL PDU)."""
        ue = self.ues.get(rnti)
        if ue is None:
            return
        if sinr_db is not None:
            prev = ue.ul_sinr_db
            ue.ul_sinr_db = (sinr_db if prev is None
                             else 0.7 * prev + 0.3 * sinr_db)
        if ok and ta_samples is not None:
            ue.ta_samples = 0.5 * ue.ta_samples + 0.5 * ta_samples
            if (abs(ue.ta_samples) >= self.cfg.ta_cmd_threshold_samples
                    and ue.pending_ta_cmd is None):
                ue.pending_ta_cmd = int(round(ue.ta_samples))
                ue.ta_samples = 0.0
        p = ue.ul_harqs.processes[harq_pid]
        dropped = p.handle_ack(ok)
        if ok:
            ue.ul_nof_ok += 1
            ue.ul_ko_streak = 0
            ue.ul_buffer_bytes = max(0, ue.ul_buffer_bytes - p.tbs_bytes)
        else:
            ue.ul_nof_ko += 1
            ue.ul_ko_streak += 1
            if ue.ul_ko_streak >= MAX_CONSECUTIVE_KO:
                self._declare_rlf(rnti)
        del dropped

    def handle_harq_ack(self, rnti: int, harq_pid: int, ack: bool) -> None:
        """PUCCH/UCI HARQ-ACK → DL HARQ."""
        ue = self.ues.get(rnti)
        if ue is None:
            return
        p = ue.dl_harqs.processes[harq_pid]
        p.handle_ack(ack)
        if ack:
            ue.dl_nof_ok += 1
            ue.dl_ko_streak = 0
        else:
            ue.dl_nof_ko += 1
            ue.dl_ko_streak += 1
            if ue.dl_ko_streak >= MAX_CONSECUTIVE_KO:
                self._declare_rlf(rnti)

    def _declare_rlf(self, rnti: int) -> None:
        if rnti not in self.rlf_ues:
            self.rlf_ues.append(rnti)

    # -------------------------------------------------------- TBS helpers
    def _dl_tbs_bytes(self, mcs: int, nof_prb: int) -> tuple[int, int, float]:
        return cell_cfg.dl_tbs_bytes(self.cfg, mcs, nof_prb)

    def _ul_tbs_bytes(self, mcs: int, nof_prb: int) -> tuple[int, int, float]:
        return cell_cfg.ul_tbs_bytes(self.cfg, mcs, nof_prb)

    def _prbs_for_bytes(self, nof_bytes: int, mcs: int, dl: bool) -> int:
        fn = self._dl_tbs_bytes if dl else self._ul_tbs_bytes
        lo, hi = 1, self.cfg.nof_prb
        while lo < hi:
            mid = (lo + hi) // 2
            if fn(mcs, mid)[0] >= nof_bytes:
                hi = mid
            else:
                lo = mid + 1
        return self._bucket(lo)

    def _bucket(self, nof_prb: int) -> int:
        """Round up to the nearest compiled-shape bucket."""
        for b in self.cfg.prb_buckets:
            if b >= nof_prb and b <= self.cfg.nof_prb:
                return b
        return min(nof_prb, self.cfg.nof_prb)

    # ------------------------------------------------------------- pipeline
    def run_slot(self, slot: int) -> SlotResult:
        res = SlotResult(slot)
        # skipped-slot healing (cell_scheduler.cpp:86-94): when the slot
        # clock jumps (late wake-up / overload), advance the state the
        # missed slots would have driven — HARQ timeouts and deferred
        # allocations that can no longer be honored — before scheduling.
        if self._last_slot is not None and slot > self._last_slot + 1:
            for missed in range(self._last_slot + 1, slot):
                self.nof_skipped_slots += 1
                for ue in self.ues.values():
                    ue.dl_harqs.handle_timeouts(missed)
                    ue.ul_harqs.handle_timeouts(missed)
                self._pending_ul.pop(missed, None)
                self._pending_pucch.pop(missed, None)
        self._last_slot = slot
        for ue in self.ues.values():
            ue.dl_harqs.handle_timeouts(slot)
            ue.ul_harqs.handle_timeouts(slot)
        # deferred allocations landing in this slot
        res.ul_grants.extend(self._pending_ul.pop(slot, []))
        res.pucch.extend(self._pending_pucch.pop(slot, []))

        dl_ok = self.cfg.is_dl_slot(slot)
        ul_ok = self.cfg.is_ul_slot(slot)
        if ul_ok:
            # SR opportunities + periodic CSI on PUCCH F2 for connected
            # UEs (bottom-edge guard PRBs; F1 HARQ resources ride the top
            # edge — uci_allocator_impl.cpp resource partitioning)
            for rnti in sorted(self.ues):
                alloc = getattr(self.ues[rnti], "pucch_alloc", None)
                if alloc is None:
                    continue
                if alloc.sr.is_opportunity(self.cfg, slot):
                    res.pucch.append(PucchGrant(
                        rnti, alloc.sr.resource.prb, format=1,
                        initial_cyclic_shift=
                        alloc.sr.resource.initial_cyclic_shift,
                        harq_pid=-1))          # -1 marks an SR resource
                if alloc.csi.is_opportunity(self.cfg, slot):
                    res.pucch.append(PucchGrant(
                        rnti, alloc.csi.resource.prb_start, format=2,
                        nof_uci_bits=self.cfg.csi_report_bits))
        dl_alloc = _PrbAllocator(self.cfg.nof_prb)
        used_ul = sum(g.prb_len for g in res.ul_grants)
        ul_alloc = _PrbAllocator(self.cfg.nof_prb, self.cfg.pucch_prbs)
        ul_alloc.next_free += used_ul
        # per-slot CCE bitmap: every DCI competes for the CORESET's CCEs
        # (pdcch_resource_allocator_impl.cpp)
        self._pdcch = PdcchSlotAllocator(self.cfg.nof_cces)

        if dl_ok:
            # 1. SSB
            if slot % self.cfg.ssb_period_slots == 0:
                res.ssb = True
                # keep PDSCH out of the SSB's PRB/symbol footprint
                dl_alloc.alloc(self.cfg.ssb_prbs)
            # 1b. periodic NZP-CSI-RS (common_scheduling/csi_rs_scheduler)
            if (slot % self.cfg.csi_rs_period_slots
                    == self.cfg.csi_rs_slot_offset):
                res.csi_rs = True
            # 2. SIB1
            if slot % self.cfg.sib1_period_slots == 2:
                cce = self._alloc_cce(SI_RNTI, slot)
                prbs = dl_alloc.alloc(4) if cce is not None else None
                if prbs:
                    tbs, qm, r = self._dl_tbs_bytes(5, prbs[1])
                    res.sib1 = DlGrant(SI_RNTI, 0, prbs[0], prbs[1], 5, qm,
                                       r, tbs, 0, False, 0, is_sib=True,
                                       cce_index=cce,
                                       aggregation_level=self._al)
            # 2b. paging occasion
            if (self._pending_paging
                    and slot % self.cfg.paging_period_slots
                    == self.cfg.paging_slot_offset):
                cce = self._alloc_cce(P_RNTI, slot)
                need = sum(1 + len(i) for i in self._pending_paging)
                want = self._prbs_for_bytes(need, 2, dl=True)
                prbs = dl_alloc.alloc(want) if cce is not None else None
                if prbs:
                    tbs, qm, r = self._dl_tbs_bytes(2, prbs[1])
                    if tbs >= need:
                        res.paging = DlGrant(
                            P_RNTI, 0, prbs[0], prbs[1], 2, qm, r, tbs, 0,
                            False, 0, is_paging=True, cce_index=cce,
                            aggregation_level=self._al)
                        res.paging_records = self._pending_paging
                        self._pending_paging = []
            # 4. RA: serve pending RACH with RAR + Msg3 grant
            self._schedule_ra(slot, res, dl_alloc)
            # 6a. UE DL
            self._schedule_ue_dl(slot, res, dl_alloc)
        # 3. PRACH occasion marker
        if ul_ok and slot % self.cfg.prach_period_slots == \
                self.cfg.prach_slot_offset % self.cfg.prach_period_slots:
            res.prach_occasion = True
        # 6b. UE UL (DCI now, PUSCH at slot+k2)
        if dl_ok:
            self._schedule_ue_ul(slot, res)
        return res

    # ---------------------------------------------------- link adaptation
    def _mcs_bucket(self, mcs: int) -> int:
        """Largest mcs_bucket ≤ the CQI-ideal MCS (never exceeds the
        channel's rate; bounds the compiled PHY shape set)."""
        out = self.cfg.mcs_buckets[0]
        for b in self.cfg.mcs_buckets:
            if b <= mcs:
                out = b
        return out

    def _dl_mcs(self, ue: UeContext) -> int:
        """CQI-driven MCS; fixed config value until the first report."""
        if ue.cqi:
            return self._mcs_bucket(
                mcs_tables.cqi_to_mcs(ue.cqi, self.cfg.mcs_table))
        return self.cfg.fixed_dl_mcs

    def _ul_mcs(self, ue: UeContext) -> int:
        if ue.ul_sinr_db is not None:
            cqi = mcs_tables.sinr_to_cqi(ue.ul_sinr_db)
            if cqi:
                return self._mcs_bucket(
                    mcs_tables.cqi_to_mcs(cqi, self.cfg.mcs_table))
        return self.cfg.fixed_ul_mcs

    # ------------------------------------------------------------- PDCCH
    @property
    def _al(self) -> int:
        return self.cfg.pdcch_aggregation_level

    def _alloc_cce(self, rnti: int, slot: int) -> Optional[int]:
        return self._pdcch.allocate(rnti, slot, self._al,
                                    self.cfg.pdcch_candidates)

    # --------------------------------------------------------------- RA
    def _schedule_ra(self, slot: int, res: SlotResult,
                     dl_alloc: _PrbAllocator) -> None:
        while self._pending_rach:
            rach_slot, occasion, preamble, ta = self._pending_rach[0]
            if slot - rach_slot > self.cfg.ra_window_slots:
                self._pending_rach.popleft()       # window expired
                continue
            ra_rnti = 1 + occasion
            cce = self._alloc_cce(ra_rnti, slot)
            if cce is None:
                return
            prbs = dl_alloc.alloc(2)
            if prbs is None:
                return
            self._pending_rach.popleft()
            tc_rnti = self._next_tc_rnti
            self._next_tc_rnti += 1
            msg3_slot = self._next_ul_slot(slot + self.cfg.k2)
            # Msg3 must fit the CCCH RRC container (~64 B here)
            msg3_prbs = self._prbs_for_bytes(64, 2, dl=False)
            tbs, qm, r = self._ul_tbs_bytes(2, msg3_prbs)
            ue = self.add_ue(tc_rnti)
            p = ue.ul_harqs.processes[0]
            msg3 = UlGrant(tc_rnti, 0, self.cfg.pucch_prbs, msg3_prbs, 2,
                           qm, r, tbs, 0, True, is_msg3=True)
            p.new_tx(tbs, 2, (msg3.prb_start, msg3_prbs), msg3_slot)
            self._pending_ul.setdefault(msg3_slot, []).append(msg3)
            rar_tbs, qm_r, r_r = self._dl_tbs_bytes(2, prbs[1])
            res.rars.append(RarInfo(ra_rnti, preamble, tc_rnti, ta,
                                    msg3_slot, msg3))
            res.dl_grants.append(DlGrant(ra_rnti, 0, prbs[0], prbs[1], 2,
                                         qm_r, r_r, rar_tbs, 0, False, 0,
                                         is_rar=True, cce_index=cce,
                                         aggregation_level=self._al))

    def _next_ul_slot(self, slot: int) -> int:
        for _ in range(self.cfg.slots_per_frame):
            if self.cfg.is_ul_slot(slot):
                return slot
            slot += 1
        return slot

    def _next_dl_slot(self, slot: int) -> int:
        for _ in range(self.cfg.slots_per_frame):
            if self.cfg.is_dl_slot(slot):
                return slot
            slot += 1
        return slot

    # ------------------------------------------------------------- UE DL
    def _schedule_ue_dl(self, slot: int, res: SlotResult,
                        alloc: _PrbAllocator) -> None:
        rntis = sorted(self.ues)
        if not rntis:
            return
        order = rntis[self._rr_dl % len(rntis):] + \
            rntis[: self._rr_dl % len(rntis)]
        self._rr_dl += 1
        for rnti in order:
            ue = self.ues[rnti]
            # retransmissions first (same PRB count, rv cycling)
            p = ue.dl_harqs.find_pending_retx()
            if p is not None:
                cce = self._alloc_cce(rnti, slot)
                if cce is None:
                    continue                # PDCCH blocked this slot
                prbs = alloc.alloc(p.prbs[1])
                if prbs is None:
                    continue
                ack_slot = self._next_ul_slot(slot + self.cfg.k1)
                p.new_retx(ack_slot)
                qm, r = mcs_tables.mcs_to_qm_rate(p.mcs, self.cfg.mcs_table)
                pri = self._reserve_pucch(rnti, ack_slot, p.pid)
                res.dl_grants.append(DlGrant(
                    rnti, p.pid, prbs[0], prbs[1], p.mcs, qm, r,
                    p.tbs_bytes, p.rv, p.ndi, self.cfg.k1, cce_index=cce,
                    aggregation_level=self._al, pucch_pri=pri or 0))
                continue
            demand = ue.total_dl_buffer()
            if demand == 0 and not ue.pending_conres:
                continue
            p = ue.dl_harqs.find_empty()
            if p is None:
                continue
            cce = self._alloc_cce(rnti, slot)
            if cce is None:
                continue
            mcs = self._dl_mcs(ue)
            want = self._prbs_for_bytes(max(demand + 8, 16), mcs, dl=True)
            if self.cfg.max_prb_per_ue:
                want = min(want, self.cfg.max_prb_per_ue)
            prbs = alloc.alloc(want)
            if prbs is None:
                continue
            tbs, qm, r = self._dl_tbs_bytes(mcs, prbs[1])
            ack_slot = self._next_ul_slot(slot + self.cfg.k1)
            p.new_tx(tbs, mcs, prbs, ack_slot)
            pri = self._reserve_pucch(rnti, ack_slot, p.pid)
            res.dl_grants.append(DlGrant(
                rnti, p.pid, prbs[0], prbs[1], mcs, qm, r, tbs, 0, p.ndi,
                self.cfg.k1, is_conres=ue.pending_conres, cce_index=cce,
                aggregation_level=self._al, pucch_pri=pri or 0))
            ue.dl_bytes += tbs

    #: F1 initial cyclic shifts multiplexed in one PRB (orthogonal at
    #: CS spacing 3; reference pucch_resource_manager cell resource list)
    _PUCCH_F1_SHIFTS = (0, 3, 6, 9)

    def pucch_f1_resource(self, idx: int) -> tuple[int, int]:
        return cell_cfg.pucch_f1_resource(self.cfg, idx)

    def _reserve_pucch(self, rnti: int, ack_slot: int,
                       harq_pid: int = 0) -> Optional[int]:
        """Collision-free PUCCH F1 resource; returns the resource index
        (the DCI's PRI) or None when the slot's PUCCH capacity is
        exhausted (the caller's grant then still stands — HARQ falls back
        to retransmission on DTX — but no two UEs ever share (prb, cs))."""
        lst = self._pending_pucch.setdefault(ack_slot, [])
        npkt = max(1, self.cfg.pucch_prbs)
        capacity = npkt * len(self._PUCCH_F1_SHIFTS)
        idx = len([p for p in lst if p.format == 1])
        if idx >= capacity:
            return None
        prb, cs = self.pucch_f1_resource(idx)
        lst.append(PucchGrant(rnti, prb, format=1,
                              initial_cyclic_shift=cs, harq_pid=harq_pid))
        return idx

    # ------------------------------------------------------------- UE UL
    def _schedule_ue_ul(self, slot: int, res: SlotResult) -> None:
        rntis = sorted(self.ues)
        if not rntis:
            return
        pusch_slot = self._next_ul_slot(slot + self.cfg.k2)
        pending = self._pending_ul.setdefault(pusch_slot, [])
        # PRACH-occasion slots carve the 139-subcarrier region out of the
        # PUSCH space (prach_scheduler reserved RBs in the reference)
        width = (self.cfg.prach_prb_start
                 if self.cfg.is_prach_slot(pusch_slot)
                 else self.cfg.nof_prb)
        alloc = _PrbAllocator(width, self.cfg.pucch_prbs)
        alloc.limit = width - (0 if self.cfg.is_prach_slot(pusch_slot)
                               else self.cfg.pucch_prbs)
        alloc.next_free += sum(g.prb_len for g in pending)
        order = rntis[self._rr_ul % len(rntis):] + \
            rntis[: self._rr_ul % len(rntis)]
        self._rr_ul += 1
        for rnti in order:
            ue = self.ues[rnti]
            p = ue.ul_harqs.find_pending_retx()
            if p is not None:
                cce = self._alloc_cce(rnti, slot)
                if cce is None:
                    continue
                prbs = alloc.alloc(p.prbs[1])
                if prbs is None:
                    continue
                p.new_retx(pusch_slot)
                qm, r = mcs_tables.mcs_to_qm_rate(p.mcs, self.cfg.mcs_table)
                g = UlGrant(rnti, p.pid, prbs[0], prbs[1], p.mcs,
                            qm, r, p.tbs_bytes, p.rv, p.ndi, cce_index=cce,
                            aggregation_level=self._al)
                pending.append(g)
                res.ul_dcis.append(g)
                continue
            if ue.ul_buffer_bytes <= 0:
                continue
            p = ue.ul_harqs.find_empty()
            if p is None:
                continue
            cce = self._alloc_cce(rnti, slot)
            if cce is None:
                continue
            mcs = self._ul_mcs(ue)
            want = self._prbs_for_bytes(ue.ul_buffer_bytes + 8, mcs,
                                        dl=False)
            prbs = alloc.alloc(want)
            if prbs is None:
                continue
            tbs, qm, r = self._ul_tbs_bytes(mcs, prbs[1])
            p.new_tx(tbs, mcs, prbs, pusch_slot)
            g = UlGrant(rnti, p.pid, prbs[0], prbs[1], mcs, qm,
                        r, tbs, 0, p.ndi, cce_index=cce,
                        aggregation_level=self._al)
            pending.append(g)
            res.ul_dcis.append(g)
            ue.ul_bytes += tbs
