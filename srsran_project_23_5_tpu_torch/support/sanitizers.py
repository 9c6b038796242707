"""Debug-mode sanitizers: resource-grid write-overlap + executor races.

The reference catches concurrent resource-grid writes and executor
misuse with ThreadSanitizer CI jobs and per-processor assertions
(resource_grid_impl asserts, tests run under -DENABLE_TSAN).  In this
framework a slot's channels are composed FUNCTIONALLY inside one XLA
program, so a "data race" appears as two channel processors CLAIMING
the same resource elements — which silently adds their symbols instead
of corrupting memory, and is just as wrong on the air interface.

`SlotGridSanitizer` recomputes each PDU's RE footprint from its static
config (the same indices the mappers use) and raises on any pairwise
overlap.  `ExecutorRaceDetector` instruments task begin/end windows on
named resources for the host-side async engine (support/executors),
flagging overlapping critical sections the way TSAN flags unlocked
concurrent access.

Enabled in tests and in the gnb app with `--sanitize` (config
`sanitize: true`); off on the bench hot path.
"""
from __future__ import annotations

import threading
from typing import Iterable

import numpy as np

from ..ran.constants import NRE


class GridOverlapError(AssertionError):
    pass


class RaceError(AssertionError):
    pass


class SlotGridSanitizer:
    """Collects (port, symbol, subcarrier) claims per channel; raises on
    the first RE claimed twice."""

    def __init__(self, nof_ports: int, nof_symbols: int,
                 nof_sc: int) -> None:
        self._claimed = np.zeros((nof_ports, nof_symbols, nof_sc),
                                 dtype=bool)
        self._owner: dict[tuple[int, int, int], str] = {}

    def claim(self, name: str, port: int, symbols: np.ndarray,
              subcarriers: np.ndarray) -> None:
        symbols = np.asarray(symbols, dtype=np.int64).ravel()
        subcarriers = np.asarray(subcarriers, dtype=np.int64).ravel()
        clash = self._claimed[port, symbols, subcarriers]
        if clash.any():
            i = int(np.argmax(clash))
            key = (port, int(symbols[i]), int(subcarriers[i]))
            raise GridOverlapError(
                f"{name} claims RE (port={key[0]}, l={key[1]}, "
                f"k={key[2]}) already written by "
                f"{self._owner.get(key, '?')}")
        self._claimed[port, symbols, subcarriers] = True
        for l, k in zip(symbols.tolist(), subcarriers.tolist()):
            self._owner[(port, l, k)] = name

    # ---------------------------------------------- per-channel claims
    def claim_sch(self, name: str, cfg, ports: Iterable[int] = (0,)
                  ) -> None:
        """PDSCH/PUSCH: data REs + DM-RS symbols' allocation span."""
        dsym, dsc = cfg.data_re_indices
        lo = cfg.prb_start * NRE
        hi = (cfg.prb_start + cfg.nof_prb) * NRE
        msym = np.asarray([l for l in cfg.dmrs_symbols
                           if cfg.first_symbol <= l
                           < cfg.first_symbol + cfg.nof_symbols])
        if cfg.dmrs_cdm_groups_without_data >= 2:
            # whole symbol belongs to DM-RS/reserved: data REs exclude it
            span = np.arange(lo, hi)
        else:
            # CDM group 0 comb: even subcarriers; data rides the rest
            span = np.arange(lo, hi, 2)
        for port in ports:
            self.claim(name, port, dsym, dsc)
            if msym.size:
                self.claim(name + ".dmrs", port,
                           np.repeat(msym, span.size),
                           np.tile(span, msym.size))

    def claim_pdcch(self, name: str, cfg, port: int = 0) -> None:
        dsym, dsc, msym, msc = cfg.re_indices
        self.claim(name, port, dsym, dsc)
        self.claim(name + ".dmrs", port, msym, msc)

    def claim_ssb(self, name: str, cfg, first_subcarrier: int,
                  port: int = 0, ssb_nsc: int = 240,
                  first_symbol: int = 2) -> None:
        sym = np.repeat(np.arange(first_symbol, first_symbol + 4), ssb_nsc)
        sc = np.tile(np.arange(first_subcarrier,
                               first_subcarrier + ssb_nsc), 4)
        self.claim(name, port, sym, sc)

    def claim_csi_rs(self, name: str, cfg, port: int = 0) -> None:
        # row 1/2: one RE per PRB at k0; row 4: 4 REs per PRB
        per_prb = {1: (0,), 2: (0,), 4: (0, 1, 2, 3)}[cfg.row]
        ks = np.asarray([(p * NRE) + cfg.subcarrier_offset + o
                         for p in range(cfg.prb_start,
                                        cfg.prb_start + cfg.nof_prb)
                         for o in per_prb])
        self.claim(name, port, np.full(ks.size, cfg.symbol), ks)


def check_dl_slot(dl_req, nof_ports: int, nof_sc: int) -> None:
    """Sanitize one DL_TTI.request's PDU list (fapi.messages shapes)."""
    san = SlotGridSanitizer(nof_ports, 14, nof_sc)
    for i, pdu in enumerate(getattr(dl_req, "pdsch_pdus", ())):
        c = pdu.config
        ports = range(c.nof_layers) if c.nof_layers > 1 else (0,)
        san.claim_sch(f"pdsch[{i}]", c, ports)
    for i, pdu in enumerate(getattr(dl_req, "pdcch_pdus", ())):
        san.claim_pdcch(f"pdcch[{i}]", pdu.config)
    for i, pdu in enumerate(getattr(dl_req, "ssb_pdus", ())):
        san.claim_ssb(f"ssb[{i}]", pdu.config, pdu.first_subcarrier)
    for i, pdu in enumerate(getattr(dl_req, "csi_rs_pdus", ())):
        san.claim_csi_rs(f"csi_rs[{i}]", pdu.config)


class ExecutorRaceDetector:
    """Tracks named-resource critical sections across threads; raises if
    two tasks hold the same resource concurrently (the TSAN analogue
    for the host-side async engine)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._holders: dict[str, tuple[int, str]] = {}
        self.races: list[str] = []

    def enter(self, resource: str, task: str) -> None:
        me = threading.get_ident()
        with self._lock:
            held = self._holders.get(resource)
            if held is not None and held[0] != me:
                msg = (f"race on '{resource}': task '{task}' "
                       f"(thread {me}) while '{held[1]}' holds it "
                       f"(thread {held[0]})")
                self.races.append(msg)
                raise RaceError(msg)
            self._holders[resource] = (me, task)

    def leave(self, resource: str) -> None:
        with self._lock:
            self._holders.pop(resource, None)

    class _Section:
        def __init__(self, det, resource, task):
            self.det, self.resource, self.task = det, resource, task

        def __enter__(self):
            self.det.enter(self.resource, self.task)
            return self

        def __exit__(self, *exc):
            self.det.leave(self.resource)
            return False

    def section(self, resource: str, task: str) -> "_Section":
        return self._Section(self, resource, task)
