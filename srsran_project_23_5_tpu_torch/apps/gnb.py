"""gnb: the monolithic gNB application (reference apps/gnb/gnb.cpp:506-916).

Counterpart of ``srsran_project_23_5_tpu/apps/gnb.py``: the same stack and
slot loop, with the loopback PHY (apps/phy_loop.py) on PyTorch.  It runs on
the current CUDA device unless the config names the CPU
(``platform: cpu``).

Wires the full stack from a YAML config: CU-CP + CU-UP + DU-high +
FAPI adaptors + upper PHY + lower PHY (OFDM) over a loopback radio,
against an in-process AMF stub (or an external NGAP address), and runs
the slot loop.

Loopback-UE demo mode (`ue.enabled`): an in-framework UE attaches and
exchanges user-plane traffic. In `phy: loopback` EVERY exchange crosses
the air interface: the UE transmits PRACH onto baseband and the gNB
detects it (TA from the detector → RAR), RAR/SIB1 are PDSCH-decoded by
the UE from its blind-decoded DCIs, HARQ-ACK rides PUCCH F1 selected by
the DCI's PRI, SR and periodic CSI ride PUCCH, and residual PUSCH timing
error closes through TA command CEs (apps/phy_loop.py).

Usage:  python -m srsran_project_23_5_tpu_torch.apps.gnb -c gnb.yml
            [--slots N] [--phy loopback] [--platform gpu|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

from .. import f1u, gtpu, ngap, rrc
from ..cu_cp import CuCp
from ..cu_up import CuUp
from ..du_high import DuHigh
from ..fapi_adaptor import FapiToMacTranslator, MacToFapiTranslator
from ..pcap import MacPcap
from ..scheduler import CellConfig, TddPattern
from ..support.srslog import get_logger, init_logging
from ..testing import UeEmulator
from ..utils.device import resolve as resolve_device
from ..utils.native import SlotTicker


# ----------------------------------------------------------- configuration
@dataclasses.dataclass
class GnbConfig:
    """Validated app config (gnb_appconfig.h / *_cli11_schema.cpp)."""
    pci: int = 1
    nof_prb: int = 52
    mu: int = 1
    tdd: Optional[dict] = None
    phy: str = "none"                  # none | loopback
    platform: str = "gpu"              # gpu (current CUDA device) | cpu
    realtime: bool = False
    slots: int = 400
    snr_db: float = 30.0
    ue_delay_samples: float = 0.0      # UE timing error the TA loop fixes
    validate_fapi: bool = True         # fapi.validators on every slot
    log_level: str = "warning"
    log_file: Optional[str] = None
    mac_pcap: Optional[str] = None
    ue_enabled: bool = True
    ue_dl_packets: int = 8
    ue_ul_packets: int = 8
    amf_external: Optional[tuple[str, int]] = None

    @classmethod
    def from_yaml(cls, path: str) -> "GnbConfig":
        import yaml
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "GnbConfig":
        cell = raw.get("cell", {})
        log = raw.get("log", {})
        ue = raw.get("ue", {})
        amf = raw.get("amf", {})
        cfg = cls(
            pci=cell.get("pci", 1),
            nof_prb=cell.get("nof_prb", 52),
            mu=cell.get("mu", 1),
            tdd=cell.get("tdd"),
            phy=raw.get("phy", "none"),
            platform=raw.get("platform", "gpu"),
            realtime=raw.get("realtime", False),
            slots=raw.get("slots", 400),
            snr_db=raw.get("snr_db", 30.0),
            ue_delay_samples=ue.get("delay_samples", 0.0),
            log_level=log.get("level", "warning"),
            log_file=log.get("file"),
            mac_pcap=raw.get("pcap", {}).get("mac"),
            ue_enabled=ue.get("enabled", True),
            ue_dl_packets=ue.get("dl_packets", 8),
            ue_ul_packets=ue.get("ul_packets", 8),
            amf_external=(amf["host"], amf["port"]) if amf else None,
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        """gnb_appconfig_validators.cpp equivalent."""
        if not 0 <= self.pci < 1008:
            raise ValueError(f"pci {self.pci} out of range [0,1008)")
        if self.nof_prb < 11 or self.nof_prb > 273:
            raise ValueError(f"nof_prb {self.nof_prb} out of range [11,273]")
        if self.mu not in (0, 1, 2):
            raise ValueError("mu must be 0/1/2 (FR1 15/30/60 kHz)")
        if self.phy not in ("none", "loopback"):
            raise ValueError(f"unknown phy mode {self.phy!r}")
        if self.platform not in ("gpu", "cpu"):
            raise ValueError(f"unknown platform {self.platform!r} "
                             f"(gpu | cpu)")
        if self.tdd is not None:
            p = self.tdd
            if p.get("nof_dl", 0) + p.get("nof_ul", 0) > p.get("period", 10):
                raise ValueError("tdd: dl+ul slots exceed period")

    def cell_config(self) -> CellConfig:
        tdd = None
        if self.tdd is not None:
            tdd = TddPattern(self.tdd.get("period", 10),
                             self.tdd.get("nof_dl", 7),
                             self.tdd.get("nof_ul", 2))
        return CellConfig(pci=self.pci, nof_prb=self.nof_prb, mu=self.mu,
                          tdd=tdd)


# ------------------------------------------------------------- metrics
class MetricsPlotter:
    """stdout scheduler-metrics plotter
    (apps/gnb/helpers/metrics_plotter_stdout.cpp)."""

    HEADER = (f"{'rnti':>6} {'dl_ok':>6} {'dl_ko':>6} {'dl_MB':>8} "
              f"{'ul_ok':>6} {'ul_ko':>6} {'ul_MB':>8}")

    def __init__(self, interval_slots: int = 100) -> None:
        self.interval = interval_slots
        self._printed_header = False

    def maybe_print(self, slot: int, sched) -> None:
        if slot % self.interval or not sched.ues:
            return
        if not self._printed_header:
            print(self.HEADER)
            self._printed_header = True
        for rnti, ue in sorted(sched.ues.items()):
            print(f"{rnti:#6x} {ue.dl_nof_ok:>6} {ue.dl_nof_ko:>6} "
                  f"{ue.dl_bytes / 1e6:>8.3f} {ue.ul_nof_ok:>6} "
                  f"{ue.ul_nof_ko:>6} {ue.ul_bytes / 1e6:>8.3f}")


# ------------------------------------------------------------------- gNB
class Gnb:
    """The assembled gNB (the wiring block of apps/gnb/gnb.cpp main)."""

    def __init__(self, cfg: GnbConfig) -> None:
        init_logging(cfg.log_file, level=cfg.log_level)
        self.log = get_logger("GNB", cfg.log_level)
        self.cfg = cfg
        self.cell = cfg.cell_config()
        self.core_rx: list[bytes] = []

        broker = f1u.LocalF1uBroker()
        self.cu_cp = CuCp(amf_send=self._to_amf,
                          f1_send=lambda m: self.du.handle_f1_message(m),
                          e1_send=lambda m: self.cu_up.handle_e1_message(m))
        self.cu_up = CuUp(
            e1_send=lambda m: self.cu_cp.handle_e1_message(m),
            ngu_send=self.core_rx.append)
        self.cu_up.create_f1u_bearer = broker.cu_side
        pcap = MacPcap(cfg.mac_pcap) if cfg.mac_pcap else None
        self.du = DuHigh(self.cell,
                         f1_send=lambda m: self.cu_cp.handle_f1_message(m),
                         f1u_broker=broker, mac_pcap=pcap)
        self.amf = ngap.AmfStub(self._to_cucp_ngap)
        self.mac_to_fapi = MacToFapiTranslator(self.cell)
        self.fapi_to_mac = FapiToMacTranslator(self.du.mac)
        self.metrics = MetricsPlotter()
        self._phy = None
        if cfg.phy == "loopback":
            from . import phy_loop
            # gpu: the current CUDA device (raises without one)
            self._phy = phy_loop.PhyLoop(
                self.cell, cfg.snr_db, cfg.ue_delay_samples,
                device=resolve_device("cpu" if cfg.platform == "cpu"
                                      else None))

        self.ue = UeEmulator() if cfg.ue_enabled else None
        self._ue_traffic_started = False

        # E2 agent against an in-process RIC double (lib/e2 equivalent)
        from .. import e2
        self.ric = e2.RicStub(lambda m: self.e2_agent.handle_message(m))
        self.e2_agent = e2.E2Agent(lambda m: self.ric.handle_message(m),
                                   self.du.mac.scheduler)

    def _to_amf(self, msg: bytes) -> None:
        self.amf.handle_message(msg)

    def _to_cucp_ngap(self, msg: bytes) -> None:
        self.cu_cp.handle_ngap_message(msg)

    def start(self) -> None:
        self.cu_cp.start()
        self.cu_up.start()
        self.du.start()
        self.e2_agent.start()
        assert self.cu_cp.ngap.setup_done and self.du.f1ap.setup_done

    # ------------------------------------------------------------ slot loop
    def run(self) -> dict:
        self.start()
        ticker = None
        if self.cfg.realtime:
            period_ns = int(1e6 / (1 << self.cfg.mu))   # slot duration
            ticker = SlotTicker(period_ns)
        t0 = time.perf_counter()
        sfn = 0
        for slot in range(self.cfg.slots):
            if ticker is not None:
                ticker.wait_next()
            self._run_one_slot(sfn, slot)
            self.e2_agent.on_slot(slot)
            self.metrics.maybe_print(slot, self.du.mac.scheduler)
        wall = time.perf_counter() - t0
        return self._report(wall)

    def _run_one_slot(self, sfn: int, slot: int) -> None:
        out = self.du.run_slot(slot)
        dl_req, tx_req, ul_req, _ul_dci = self.mac_to_fapi.translate(
            out, sfn, slot)
        if self.cfg.validate_fapi:
            from ..fapi import validators as fv
            # the app's slot field is the absolute slot counter (the
            # scheduler/PHY queues key off it); bound accordingly
            nslots = max(self.cell.slots_per_frame, self.cfg.slots + 1)
            errs = (fv.validate_dl_tti(dl_req, self.cell.nof_prb, nslots)
                    + fv.validate_tx_data(tx_req, dl_req)
                    + fv.validate_ul_tti(ul_req, self.cell.nof_prb,
                                         nslots))
            fv.validate_or_raise(errs, f"slot {slot}")
        ue = self.ue
        if self._phy is not None:
            if ue is not None:
                ue.timers.tick(1)
            inds = self._phy.run_slot(dl_req, tx_req, ul_req, out, ue)
            self.fapi_to_mac.handle_indications(inds)
        elif ue is not None:
            ue.step(self.du.mac, out, slot)
        if ue is not None:
            self._maybe_start_traffic()

    def _maybe_start_traffic(self) -> None:
        ue = self.ue
        if (not self._ue_traffic_started and ue.rrc.state ==
                rrc.RrcUeState.ACTIVE and ue.drb_pdcp and self.cu_up.ues):
            self._ue_traffic_started = True
            bearer = next(iter(self.cu_up.ues.values()))[0]
            for i in range(self.cfg.ue_dl_packets):
                self.cu_up.handle_ngu_pdu(gtpu.encode(
                    gtpu.GtpuHeader(bearer.dl_teid, qfi=9),
                    b"dl-ip-%03d" % i * 40))
            for i in range(self.cfg.ue_ul_packets):
                ue.send_ip_packet(b"ul-ip-%03d" % i * 30)

    def _report(self, wall: float) -> dict:
        rep = {
            "slots": self.cfg.slots,
            "wall_s": round(wall, 3),
            "slots_per_s": round(self.cfg.slots / wall, 1),
            "ng_setup": self.cu_cp.ngap.setup_done,
            "f1_setup": self.du.f1ap.setup_done,
            "e2_setup": self.e2_agent.setup_done,
            "e2_indications": len(self.ric.indications),
        }
        if self.ue is not None:
            rep.update({
                "ue_rnti": self.ue.rnti,
                "ue_rrc_state": self.ue.rrc.state,
                "ue_dl_rx_packets": len(self.ue.ip_rx),
                "core_ul_rx_packets": len(self.core_rx),
                "ue_ta_samples": self.ue.timing_advance_samples,
            })
        if self._phy is not None:
            rep["phy_stats"] = dict(self._phy.stats)
        return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tpu-ran gNB (PyTorch)")
    ap.add_argument("-c", "--config", help="YAML config file")
    ap.add_argument("--slots", type=int)
    ap.add_argument("--phy", choices=["none", "loopback"])
    ap.add_argument("--prb", type=int)
    ap.add_argument("--platform", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    cfg = GnbConfig.from_yaml(args.config) if args.config else GnbConfig()
    if args.slots:
        cfg.slots = args.slots
    if args.phy:
        cfg.phy = args.phy
    if args.prb:
        cfg.nof_prb = args.prb
    if args.platform:
        cfg.platform = args.platform
    cfg.validate()
    gnb = Gnb(cfg)
    rep = gnb.run()
    import json
    print(json.dumps(rep))
    ok = rep.get("ue_dl_rx_packets", 1) > 0 and rep["ng_setup"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
