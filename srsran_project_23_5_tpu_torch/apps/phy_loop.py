"""PHY-in-the-loop data path for the gnb app's loopback-UE mode.

Counterpart of ``srsran_project_23_5_tpu/apps/phy_loop.py``.  Every
gNB↔UE exchange crosses the air interface:

DL: upper-PHY grid assembly (SSB/PDCCH/CSI-RS/PDSCH) → OFDM → AWGN →
    UE OFDM demodulate → UE blind-decodes its DCIs (C-RNTI, RA-RNTI
    while RACHing, SI-RNTI on SIB occasions) → PDSCH decode (RAR, SIB1
    and dedicated PDUs alike) → HARQ-ACK queued for PUCCH.
UL: UE transmits PRACH (in-grid 139-subcarrier short preamble), PUSCH
    (from DCI-0_0/RAR grants the UE decoded itself), PUCCH F1 HARQ-ACK
    (resource from the DCI's PRI), SR opportunities, and periodic CSI on
    PUCCH F2 — all onto one UL grid with the UE's timing error applied —
    → AWGN → gNB upper-PHY processing → CRC/UCI/RACH indications.

Timing closed loop: a configurable UE timing error (`ue_delay_samples`)
rides every UL transmission as a frequency-domain phase ramp; the gNB's
PRACH detector measures it → RAR TA; residual PUSCH timing error → TA
command CE → the UE updates `timing_advance_samples` until the residual
vanishes.

Grids live on the ``UpperPhy``'s device (the current CUDA device unless the
caller names the CPU).  The port's PHY functions take a leading slot batch:
the UE side calls them with B = 1.  The AWGN is a host numpy draw from
``default_rng(1234)``, copied to the device, so the port and the JAX
package add the same noise and one app run can be compared with the
other's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..fapi import messages as fapi
from ..fapi_adaptor import _bits, _bytes
from ..mac import MacCellProcessor, pdu as mac_pdu
from ..ops import dmrs as dmrs_ops
from ..ops import prach as prach_ops
from ..phy.lower import ofdm
from ..phy.upper import csi_rs as csi_rs_proc
from ..phy.upper import pdcch as pdcch_proc
from ..phy.upper import pucch as pucch_proc
from ..phy.upper import sch
from ..phy.upper.slot_programs import pusch_cinits
from ..phy.upper.upper_phy import UpperPhy, UpperPhyConfig
from ..ran import mcs_tables, numerology, tbs as tbs_mod
from ..scheduler import CellConfig, dci as dci_mod
from ..scheduler import config as cell_cfg
from ..scheduler.cell_scheduler import SI_RNTI
from ..scheduler.pdcch_alloc import PdcchSlotAllocator
from ..utils import graphs


def _pool(pool: graphs.GraphPool | None,
          device: torch.device) -> graphs.GraphPool:
    """The caller's graph pool, or one for this call alone."""
    return pool if pool is not None else graphs.GraphPool(device)


# The UE modem's programs, each the counterpart of one JAX jit of the JAX
# app: one captured program per static config, on the caller's graph pool
# (a CUDA graph replay on the card, eager on the CPU).  Their configs
# normalise slot_in_frame to 0 and take the slot's sequences (DM-RS pilots,
# PUCCH F1 sequences) as input tensors, so one program serves every slot of
# the frame.  Outputs that the caller keeps are copied out of the pool.
def _csi_sinr(rx: torch.Tensor, csi_cfg) -> torch.Tensor:
    ref = csi_rs_proc.generate(csi_cfg, torch.zeros_like(rx))
    mask = ref.abs() > 0
    err = torch.where(mask, rx - ref, 0.0)
    sig = torch.where(mask, ref.abs() ** 2, 0.0).sum()
    npow = torch.clamp((err.abs() ** 2).sum(), min=1e-12)
    return 10.0 * torch.log10(sig / npow)


def csi_sinr_db(rx: torch.Tensor, csi_cfg,
                pool: graphs.GraphPool | None = None) -> float:
    """SINR (dB) of the CSI-RS resource's REs in one received grid
    [14, nsc]: the resource's power over the power of rx − resource."""
    prog = _pool(pool, rx.device).cached(
        ("csi_sinr", csi_cfg), lambda: lambda g: _csi_sinr(g, csi_cfg))
    return float(prog(rx))


def ue_pdsch_receive(rx: torch.Tensor, cfg: sch.ShConfig,
                     pool: graphs.GraphPool | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """UE-side PDSCH decode (6 LDPC iterations) of one received grid
    [14, nsc]: (TB bits [A], TB CRC ok [])."""
    cfg0 = dataclasses.replace(cfg, slot_in_frame=0)

    def build():
        def fn(g, pil):
            res = sch.pusch_receive(g[None, None], cfg0, 6, tx_pilots=pil)
            return res.tb_bits[0], res.tb_crc_ok[0]
        return fn
    prog = _pool(pool, rx.device).cached(("pdsch_rx", cfg0), build)
    bits, ok = prog(rx, _pilots(cfg, rx.device))
    return bits.clone(), ok.clone()


def ue_pusch_transmit(bits: torch.Tensor, cfg: sch.ShConfig,
                      grid: torch.Tensor,
                      pool: graphs.GraphPool | None = None) -> torch.Tensor:
    """UE-side PUSCH of TB bits [A] onto a [14, nsc] grid."""
    cfg0 = dataclasses.replace(cfg, slot_in_frame=0)
    prog = _pool(pool, grid.device).cached(
        ("pusch_tx", cfg0), lambda: lambda b, g, pil: sch.pusch_transmit(
            b[None], cfg0, g[None], pilots=pil)[0])
    return prog(bits, grid, _pilots(cfg, grid.device)).clone()


def ue_pucch_f1_transmit(bits: torch.Tensor, cfg: pucch_proc.PucchF1Config,
                         grid: torch.Tensor,
                         pool: graphs.GraphPool | None = None
                         ) -> torch.Tensor:
    """UE-side PUCCH F1 of HARQ-ACK/SR bits [1] onto a [14, nsc] grid."""
    cfg0 = dataclasses.replace(cfg, slot_in_frame=0)
    prog = _pool(pool, grid.device).cached(
        ("pucch_f1_tx", cfg0),
        lambda: lambda b, g, data, dmrs: pucch_proc.pucch_f1_transmit(
            b[None], cfg0, g[None], seqs=(data, dmrs))[0])
    return prog(bits, grid,
                *pucch_proc.f1_slot_seqs_on(cfg, grid.device)).clone()


def ue_pucch_f2_transmit(bits: torch.Tensor, cfg: pucch_proc.PucchF2Config,
                         grid: torch.Tensor,
                         pool: graphs.GraphPool | None = None
                         ) -> torch.Tensor:
    """UE-side PUCCH F2 of UCI bits [O] onto a [14, nsc] grid."""
    cfg0 = dataclasses.replace(cfg, slot_in_frame=0)
    prog = _pool(pool, grid.device).cached(
        ("pucch_f2_tx", cfg0),
        lambda: lambda b, g, pil: pucch_proc.pucch_f2_transmit(
            b[None], cfg0, g[None], pilots=pil)[0])
    return prog(bits, grid,
                pucch_proc.f2_dmrs_pilots(cfg, grid.device)).clone()


def ue_blind_decode(rx: torch.Tensor, cfg: pdcch_proc.PdcchConfig,
                    candidates: torch.Tensor,
                    pool: graphs.GraphPool | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """The UE's blind decode of one received grid [14, nsc] over the
    candidate CCEs [M] (a tensor on the grid's device): (payloads [M, A],
    crc_ok [M]) on the host."""
    prog = _pool(pool, rx.device).cached(
        ("blind_decode", cfg), lambda: lambda g, c: tuple(
            t[0] for t in pdcch_proc.pdcch_blind_receive(g[None], cfg, c)))
    payloads, oks = prog(rx, candidates)
    return payloads.cpu().numpy(), oks.cpu().numpy()


def _pilots(cfg: sch.ShConfig, device: torch.device) -> torch.Tensor:
    """The DM-RS pilots of the config's slot (cached on `device`)."""
    return dmrs_ops.pilot_values(pusch_cinits(cfg), cfg.prb_start,
                                 cfg.nof_prb, device)


@dataclasses.dataclass
class _UeUlGrant:
    """UE-side uplink grant state (decoded from DCI 0_0 or the RAR)."""
    rnti: int
    harq_pid: int
    prb_start: int
    prb_len: int
    mcs: int
    rv: int
    tbs_bytes: int
    is_msg3: bool = False


class PhyLoop:
    def __init__(self, cell: CellConfig, snr_db: float = 30.0,
                 ue_delay_samples: float = 0.0,
                 sanitize: bool = True,
                 device: torch.device | str | None = None) -> None:
        self.cell = cell
        self.nfft = numerology.min_nfft(cell.nof_prb)
        # the app loop is not latency-critical: keep the grid overlap
        # sanitizer ON (support/sanitizers.py)
        self.upper = UpperPhy(UpperPhyConfig(nof_prb=cell.nof_prb,
                                             nfft=self.nfft,
                                             sanitize=sanitize), device)
        self.device = self.upper.device
        # the UE modem's programs (csi_sinr_db, ue_blind_decode,
        # ue_pdsch_receive and the UL transmitters) and their counters
        self.graphs = graphs.GraphPool(self.device)
        self.snr_db = snr_db
        self.ue_delay_samples = float(ue_delay_samples)
        self._rng = np.random.default_rng(1234)
        self._slot_count = 0
        # UE-side per-slot queues
        self._ue_ul_grants: dict[int, list[_UeUlGrant]] = {}
        self._ue_acks: dict[int, list[tuple[int, bool]]] = {}  # (pri, ack)
        self._prach_sent_slot: Optional[int] = None
        self.stats = {"prach_tx": 0, "rar_decoded": 0, "sib1_decoded": 0,
                      "pucch_ack_tx": 0, "sr_tx": 0, "csi_f2_tx": 0,
                      "dl_decoded": 0, "dl_failed": 0}

    # --------------------------------------------------------------- helpers
    def _awgn(self, samples: torch.Tensor) -> torch.Tensor:
        # per-RE SNR calibration (see phy.pipeline: sigma² of time-domain
        # noise lands on each RE as sigma²/nfft after demodulate_slot)
        sigma = np.sqrt(self.nfft) * 10 ** (-self.snr_db / 20)
        shape = tuple(samples.shape)
        n = (self._rng.standard_normal(shape)
             + 1j * self._rng.standard_normal(shape)) * sigma / 2**0.5
        return samples + torch.from_numpy(n.astype(np.complex64)).to(
            samples.device)

    def _ofdm_roundtrip(self, grid: torch.Tensor) -> torch.Tensor:
        bb = ofdm.modulate_slot(grid, self.cell.mu, self.nfft)
        bb = self._awgn(bb)
        return ofdm.demodulate_slot(bb, self.cell.nof_prb * 12,
                                    self.cell.mu, self.nfft)

    def _timing_ramp(self, residual_samples: float) -> np.ndarray:
        """Frequency-domain phase ramp of a `residual_samples` delay over
        the centered subcarrier frequencies (exact for delays within the
        CP, which is the regime TA maintenance operates in)."""
        nsc = self.cell.nof_prb * 12
        f = np.arange(nsc) - nsc // 2
        return np.exp(-2j * np.pi * f * residual_samples / self.nfft
                      ).astype(np.complex64)

    # ----------------------------------------------------- UE DCI decode
    def _ue_blind_decode_dci(self, rx_grid: torch.Tensor, rnti: int,
                             slot: int) -> dict:
        """Search-space blind decode (the candidates as one batch).
        Returns {(is_dl, prb_start): Dci}."""
        n = self.cell.nof_prb
        cfg = pdcch_proc.PdcchConfig(
            rnti=rnti, payload_size=dci_mod.dci_size(n),
            aggregation_level=self.cell.pdcch_aggregation_level,
            n_id=self.cell.pci, n_rnti=rnti)
        alloc = PdcchSlotAllocator(self.cell.nof_cces)
        cand = alloc._candidates(cfg.aggregation_level,
                                 self.cell.pdcch_candidates, rnti, slot)
        # dedupe, keep the batch width of the search space
        cand = sorted(set(cand))
        width = self.cell.pdcch_candidates
        cand = (cand + cand[:1] * width)[:width]
        payloads, oks = ue_blind_decode(
            rx_grid, cfg, torch.tensor(cand, dtype=torch.int32,
                                       device=rx_grid.device), self.graphs)
        out: dict = {}
        for i in range(len(cand)):
            if oks[i]:
                d = dci_mod.unpack(payloads[i], n)
                out[(d.is_dl, d.prb_start)] = d
        return out

    def _is_csi_slot(self, slot: int) -> bool:
        return (slot % self.cell.csi_rs_period_slots
                == self.cell.csi_rs_slot_offset)

    def _ue_sh_config(self, d, rnti: int, slot: int) -> sch.ShConfig:
        """Rebuild the PDSCH config from decoded DCI fields (the UE's
        view: TS 38.214 TBS determination from MCS + allocation)."""
        qm, r = mcs_tables.mcs_to_qm_rate(d.mcs, self.cell.mcs_table)
        bits = tbs_mod.tbs_calculate(
            self.cell.pdsch_symbols, self.cell.dl_dmrs_per_prb, 0, r, qm,
            1, d.prb_len)
        resv = (((self.cell.csi_rs_symbol, (0,)),)
                if self._is_csi_slot(slot) else ())
        return sch.ShConfig(
            rnti=rnti, tbs=(bits // 8) * 8, qm=qm, rv=d.rv,
            prb_start=d.prb_start, nof_prb=d.prb_len,
            first_symbol=2, nof_symbols=12, dmrs_symbols=(2, 7, 11),
            nid=self.cell.pci, nid_dmrs=self.cell.pci,
            slot_in_frame=slot % self.cell.slots_per_frame,
            reserved_patterns=resv)

    def _ue_ul_sh_config(self, g: _UeUlGrant, slot: int) -> sch.ShConfig:
        qm, _ = mcs_tables.mcs_to_qm_rate(g.mcs, self.cell.mcs_table)
        return sch.ShConfig(
            rnti=g.rnti, tbs=g.tbs_bytes * 8, qm=qm, rv=g.rv,
            prb_start=g.prb_start, nof_prb=g.prb_len,
            first_symbol=0, nof_symbols=14, dmrs_symbols=(2, 7, 11),
            nid=self.cell.pci, nid_dmrs=self.cell.pci,
            slot_in_frame=slot % self.cell.slots_per_frame)

    # --------------------------------------------------------- UE downlink
    def _ue_process_dl(self, rx, dl_req, ue, slot: int) -> None:
        monitored: list[int] = []
        if ue.rnti is not None:
            monitored.append(ue.rnti)
        if (ue.rnti is None and self._prach_sent_slot is not None
                and slot - self._prach_sent_slot
                <= self.cell.ra_window_slots):
            monitored.append(1)                   # RA-RNTI (occasion 0)
        if slot % self.cell.sib1_period_slots == 2:
            monitored.append(SI_RNTI)
        dcis: dict = {}
        for rnti in monitored:
            for k, d in self._ue_blind_decode_dci(rx, rnti, slot).items():
                dcis[(rnti,) + k] = d
        if self._is_csi_slot(slot) and dl_req.csi_rs_pdus:
            sinr_db = csi_sinr_db(rx, dl_req.csi_rs_pdus[0].config,
                                  self.graphs)
            ue.last_cqi = mcs_tables.sinr_to_cqi(sinr_db)

        for pdu in dl_req.pdsch_pdus:
            cfg = pdu.config
            d = dcis.get((cfg.rnti, True, cfg.prb_start))
            if d is None:
                continue                  # no DCI decoded → no PDSCH
            ue_cfg = self._ue_sh_config(d, cfg.rnti, slot)
            tb_bits, tb_ok = ue_pdsch_receive(rx, ue_cfg, self.graphs)
            ok = bool(tb_ok)
            if cfg.rnti == ue.rnti:
                ack_slot = cell_cfg.next_ul_slot(self.cell,
                                                 slot + self.cell.k1)
                self._ue_acks.setdefault(ack_slot, []).append(
                    (d.pri, ok))
                if ok:
                    self.stats["dl_decoded"] += 1
                    ue.consume_dl_pdu(_bytes(tb_bits.cpu().numpy()))
                else:
                    self.stats["dl_failed"] += 1
            elif cfg.rnti == 1 and ok:    # RAR on RA-RNTI
                self._ue_consume_rar(_bytes(tb_bits.cpu().numpy()), ue,
                                     slot)
            elif cfg.rnti == SI_RNTI and ok:
                ue.nof_sib1_decoded += 1
                self.stats["sib1_decoded"] += 1

        # UL grants the UE decoded (DCI 0_0) land at slot + k2
        for (rnti, is_dl, _), d in dcis.items():
            if is_dl or rnti != ue.rnti:
                continue
            tbs, _, _ = cell_cfg.ul_tbs_bytes(self.cell, d.mcs, d.prb_len)
            pusch_slot = cell_cfg.next_ul_slot(self.cell,
                                               slot + self.cell.k2)
            self._ue_ul_grants.setdefault(pusch_slot, []).append(
                _UeUlGrant(rnti, d.harq_pid, d.prb_start, d.prb_len,
                           d.mcs, d.rv, tbs))

    def _ue_consume_rar(self, wire: bytes, ue, slot: int) -> None:
        for g in mac_pdu.decode_rar_pdu(wire):
            if g.rapid != ue.preamble or ue.rnti is not None:
                continue
            ue.rnti = g.tc_rnti
            ue.timing_advance_samples = float(g.ta)
            self.stats["rar_decoded"] += 1
            prb_start, prb_len, mcs = MacCellProcessor.unpack_rar_ul_grant(
                g.ul_grant)
            tbs, _, _ = cell_cfg.ul_tbs_bytes(self.cell, mcs, prb_len)
            msg3_slot = cell_cfg.next_ul_slot(self.cell,
                                              slot + self.cell.k2)
            self._ue_ul_grants.setdefault(msg3_slot, []).append(
                _UeUlGrant(g.tc_rnti, 0, prb_start, prb_len, mcs, 0, tbs,
                           is_msg3=True))

    # ----------------------------------------------------------- UE uplink
    def _ue_build_ul(self, ul_req, ue, slot: int
                     ) -> tuple[Optional[torch.Tensor], bool]:
        """Assemble the UE's UL grid for this slot; returns (grid|None,
        prach_present)."""
        dev = self.device
        nsc = self.cell.nof_prb * 12
        grid = torch.zeros((14, nsc), dtype=torch.complex64, device=dev)
        active = False
        prach_now = False
        # ---- PRACH
        if ul_req.prach_pdus and ue.want_prach():
            pdu = ul_req.prach_pdus[0]
            ns = prach_ops.num_shifts(pdu.length,
                                      pdu.zero_correlation_zone)
            root = pdu.root_sequence_index + ue.preamble // ns
            pre = torch.as_tensor(prach_ops.generate(
                root, ue.preamble % ns, pdu.length,
                pdu.zero_correlation_zone), dtype=torch.complex64,
                device=dev)
            lo = pdu.sc_start
            grid[0:pdu.nof_symbols, lo:lo + pdu.length] = pre[None, :]
            self._prach_sent_slot = slot
            self.stats["prach_tx"] += 1
            active = prach_now = True
        one = torch.ones((1,), dtype=torch.int8, device=dev)
        # ---- PUSCH from UE-decoded grants
        for g in self._ue_ul_grants.pop(slot, []):
            wire = ue.build_ul_pdu(g)
            cfg = self._ue_ul_sh_config(g, slot)
            bits = torch.as_tensor(_bits(wire, cfg.tbs), device=dev)
            grid = ue_pusch_transmit(bits, cfg, grid, self.graphs)
            active = True
        # ---- PUCCH F1 HARQ-ACK (resource from the DCI's PRI)
        for pri, ack in self._ue_acks.pop(slot, []):
            if not ack:
                continue                  # NACK → DTX (gNB sees no ACK)
            prb, cs = cell_cfg.pucch_f1_resource(self.cell, pri)
            cfg = pucch_proc.PucchF1Config(
                prb=prb, initial_cyclic_shift=cs,
                slot_in_frame=slot % self.cell.slots_per_frame)
            grid = ue_pucch_f1_transmit(one, cfg, grid, self.graphs)
            self.stats["pucch_ack_tx"] += 1
            active = True
        pc = getattr(getattr(ue, "rrc", None), "pucch_cfg", None)
        if ue.rnti is not None and pc is not None:
            # dedicated PUCCH resources delivered over RRC (DU-manager
            # pool allocation; no formula re-derivation at the UE)
            sr_cfg, csi_cfg = pc
            # ---- SR opportunity: transmit when UL data waits w/o grant
            if (self.cell.is_ul_slot(slot)
                    and slot % sr_cfg["period_slots"] == sr_cfg["offset"]
                    and ue._ul_buffer() > 0
                    and not any(self._ue_ul_grants.values())):
                cfg = pucch_proc.PucchF1Config(
                    prb=sr_cfg["prb"],
                    initial_cyclic_shift=sr_cfg["cs"],
                    slot_in_frame=slot % self.cell.slots_per_frame)
                grid = ue_pucch_f1_transmit(one, cfg, grid, self.graphs)
                self.stats["sr_tx"] += 1
                active = True
            # ---- periodic CSI on PUCCH F2
            if (self.cell.is_ul_slot(slot)
                    and slot % csi_cfg["period_slots"]
                    == csi_cfg["offset"]):
                f2 = pucch_proc.PucchF2Config(
                    prb_start=csi_cfg["prb"],
                    nof_prb=csi_cfg["nof_prb"], rnti=ue.rnti,
                    nof_uci_bits=self.cell.csi_report_bits,
                    slot_in_frame=slot % self.cell.slots_per_frame)
                cqi_bits = torch.tensor(
                    [(ue.last_cqi >> (3 - i)) & 1 for i in range(4)],
                    dtype=torch.int8, device=dev)
                grid = ue_pucch_f2_transmit(cqi_bits, f2, grid, self.graphs)
                self.stats["csi_f2_tx"] += 1
                active = True
        if not active:
            return None, False
        # UE timing error: residual = true delay − applied TA
        residual = self.ue_delay_samples - ue.timing_advance_samples
        if abs(residual) > 1e-6:
            grid = grid * torch.from_numpy(self._timing_ramp(residual)).to(
                dev)
        return grid, prach_now

    # ------------------------------------------------------------- slot run
    def run_slot(self, dl_req: fapi.DlTtiRequest, tx_req: fapi.TxDataRequest,
                 ul_req: fapi.UlTtiRequest, mac_out, ue) -> list:
        """Returns uplink FAPI indications for the MAC."""
        inds: list = []
        self._slot_count += 1
        slot = dl_req.slot
        # ----------------------------------------------------------- DL
        if ue is not None and (dl_req.pdsch_pdus or dl_req.ssb_pdus
                               or dl_req.pdcch_pdus or dl_req.csi_rs_pdus):
            grid = self.upper.process_dl_slot(dl_req, tx_req)
            rx = self._ofdm_roundtrip(grid)
            self._ue_process_dl(rx, dl_req, ue, slot)
        # ----------------------------------------------------------- UL
        if ue is not None and (ul_req.pusch_pdus or ul_req.pucch_pdus
                               or ul_req.prach_pdus):
            ul_grid, _ = self._ue_build_ul(ul_req, ue, slot)
            if ul_grid is None:
                ul_grid = torch.zeros((14, self.cell.nof_prb * 12),
                                      dtype=torch.complex64,
                                      device=self.device)
            rx_ul = self._ofdm_roundtrip(ul_grid)
            prach_rx = None
            if ul_req.prach_pdus:
                pdu = ul_req.prach_pdus[0]
                lo = pdu.sc_start
                prach_rx = rx_ul[0:pdu.nof_symbols,
                                 lo:lo + pdu.length].mean(dim=0)[None]
            inds = self.upper.process_ul_slot(rx_ul[None], ul_req,
                                              self._slot_count, prach_rx)
        return inds
