"""HARQ pairs on the mixed slot, as a gNB receives them: the benchmark's own.

A pair is two full mixed slots on the same payloads.  The first carries
both PUSCH at rv=0, decoded on the truncated graph; its full-buffer LLRs are
each PUSCH's softbuffer.  The second retransmits both TBs at rv=2 (TS 38.212
§5.4.2.1, Table 5.4.2.1-2: its read starts at k0 and wraps the circular
buffer); its LLRs are added to the softbuffer and the sum is decoded on the
full graph.  Every receive stage is ``gnb_mixed``'s (the reference's own
float64 OFDM, estimators, equaliser, demapper and detectors), and so is the
plain layered min-sum decoder.

Copied from the port's ``srsran_project_23_5_tpu_torch/models/gnb_mixed.py``
(``harq_pair_batch``): the order of the pair, the second transmission's
configuration (both PUSCH at the retransmission's rv), the pair's verdict
(every first transmission fails, every combination passes, every other
verdict of both slots holds) and the gates of the slot's control channels
(``_control_ok``, the gates ``gnb_mixed._mixed_back`` applies); from the
port's ``phy/upper/harq.soft_combine``, the combine of a retransmission,
``llr + prior``.  The benchmark's: the DCI re-check of every pair, each on
its own row (the port re-checks row 0 of a batch and holds it for the
batch).
"""
from __future__ import annotations

import dataclasses

import torch

from . import gnb_mixed
from ..phy.upper import sch


@dataclasses.dataclass
class HarqPair:
    """Verdicts of a batch of B pairs: ``first`` and ``second`` are the two
    slots (the first's PUSCH verdicts its rv=0 decode's, the second's the
    combined decode's); ``combined`` {"u0"/"u1": (bits [B, C, K], ok [B,
    C])} the combined decode."""
    ok: torch.Tensor
    first: gnb_mixed.MixedSlotResult
    second: gnb_mixed.MixedSlotResult
    combined: dict


def _control_ok(front: dict, cfg: gnb_mixed.MixedSlotConfig) -> torch.Tensor:
    """[B] verdict of the PDCCH (per REG and the DCI), SSB, PSS, PUCCH and
    PRACH of a slot, under ``gnb_mixed._mixed_back``'s gates."""
    floor = 5.0 * 10 ** (-cfg.snr_db / 10)
    if cfg.tdl_delays:
        floor = max(floor, 0.05)
    pdcch_gate = 0.95 if cfg.tdl_delays else 0.99
    pss_gate = 0.6 if cfg.tdl_delays else 0.8
    return ((front["pdcch_match"] > pdcch_gate) & front["dci_crc_ok"]
            & (front["ssb_match"] > 1.0 - floor)
            & (front["pss_corr"] > pss_gate)
            & front["pucch_ok"] & front["prach_ok"])


def _with_dci(front: dict, payloads: dict,
              cfg: gnb_mixed.MixedSlotConfig) -> dict:
    """The front with every row's own DCI re-check."""
    front["dci_crc_ok"] = torch.stack([
        gnb_mixed._dci_recheck(front["pdcch_llr"][b], payloads["dci_dl"][b],
                               cfg)
        for b in range(front["prach_ok"].shape[0])])
    return front


def retx_config(cfg: gnb_mixed.MixedSlotConfig,
                retx_rv: int) -> gnb_mixed.MixedSlotConfig:
    """The retransmission's slot: both PUSCH at `retx_rv`."""
    return dataclasses.replace(
        cfg, pusch0=dataclasses.replace(cfg.pusch0, rv=retx_rv),
        pusch1=dataclasses.replace(cfg.pusch1, rv=retx_rv))


def fronts(payloads: dict, noise: tuple, cfg: gnb_mixed.MixedSlotConfig,
           retx_rv: int = 2) -> tuple[dict, dict]:
    """Both transmissions' front halves; noise (downlink, uplink) of the
    first, then of the second."""
    return (gnb_mixed._mixed_front(payloads, noise[0], noise[1], cfg),
            gnb_mixed._mixed_front(payloads, noise[2], noise[3],
                                   retx_config(cfg, retx_rv)))


def combined_llrs(first: dict, second: dict) -> dict:
    """Each PUSCH's softbuffer (the first's LLRs) plus the second's."""
    return {name: second[name].llr_full + first[name].llr_full
            for name in ("u0", "u1")}


def harq_pair(payloads: dict, noise: tuple, cfg: gnb_mixed.MixedSlotConfig,
              retx_rv: int = 2) -> HarqPair:
    """A batch of B pairs: payloads {name: [B, n] int8}; noise (downlink,
    uplink) of the first transmission, then of the second, each [B, 2,
    slot_samples] complex64."""
    cfg2 = retx_config(cfg, retx_rv)
    f1, f2 = fronts(payloads, noise, cfg, retx_rv)
    first = gnb_mixed._mixed_back(_with_dci(f1, payloads, cfg), payloads,
                                  cfg, gnb_mixed.decode_front(f1, cfg))
    llrs = combined_llrs(f1, f2)
    combined = {name: sch.decode_cbs(llrs[name], sh, cfg.nof_ldpc_iterations)
                for name, sh in (("u0", cfg2.pusch0), ("u1", cfg2.pusch1))}
    dec2 = {name: sch.decode_cbs(f2[name].llr_full, sh,
                                 cfg.nof_ldpc_iterations)
            for name, sh in gnb_mixed.decode_names(cfg2)
            if name not in combined}
    second = gnb_mixed._mixed_back(_with_dci(f2, payloads, cfg2), payloads,
                                   cfg2, {**dec2, **combined})
    ok = (~first.ul0_ok & ~first.ul1_ok & first.dl0_ok & first.dl1_ok
          & _control_ok(f1, cfg) & second.ok)
    return HarqPair(ok=ok, first=first, second=second, combined=combined)
