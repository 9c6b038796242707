"""Bucketed slot programs — one cached program per slot signature.

Counterpart of ``srsran_project_23_5_tpu/phy/upper/slot_programs.py``, the
production path of the upper PHY.  A slot's PDU list maps to a SIGNATURE,
the tuple of every PDU's static config with the slot number normalised
away, and one program per signature processes the whole slot.  PyTorch runs
eagerly, so a program here is a Python callable built once per signature:
its configs, its decoder grouping and (through the per-config caches of the
modules it calls) its index tables on the device are fixed at the first
slot, and every later slot of the signature only runs it.  An UL program
runs, for the whole slot:

- every PUSCH chain (estimate → equalize → demap → descramble → UCI demux
  → rate-dematch) with the slot's DM-RS, and the HARQ soft-combine
  ``where(new_data, llr, llr + prior)`` on the device;
- the LDPC decode with ONE decoder launch per (BG, Zc, N, graph span) group
  of PDUs;
- PUCCH F1 detection / F2 reception with the slot's sequences;
- PRACH detection over the occasion's root set;

and ends in one host transfer of every verdict, bit and metric of the slot
(the combined LLRs stay on the device for the softbuffer pool).  The slot's
sequences ride as data: PUSCH/PDSCH DM-RS c_init values (pilots cached per
value on the device), PUCCH F1 sequences and F2 DM-RS c_init values as
complex tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...fapi import messages as fapi
from ...ops import dmrs as dmrs_ops
from ...ops import prach as prach_ops
from ...ops.ldpc import decoder_cuda
from . import csi_rs as csi_rs_proc
from . import pdcch as pdcch_proc
from . import pucch as pucch_proc
from . import sch
from . import ssb as ssb_proc


def dl_signature(req: fapi.DlTtiRequest):
    """Static signature of a DL slot's PDU list (payloads are data; PDSCH
    slot_in_frame normalised — the slot's DM-RS c_init values ride as
    data, see signature())."""
    return (
        tuple((p.config, p.first_subcarrier) for p in req.ssb_pdus),
        tuple(p.config for p in req.pdcch_pdus),
        tuple(dataclasses.replace(p.config, slot_in_frame=0)
              for p in req.pdsch_pdus),
        tuple(p.config for p in req.csi_rs_pdus),
    )


class DlSlotPrograms:
    """Fused DL slot assembly: one program per slot signature builds the
    whole [14, nsc] grid (SSB + PDCCH + PDSCH + CSI-RS)."""

    def __init__(self, nsc: int) -> None:
        self.nsc = nsc
        self._progs: dict = {}

    @property
    def nof_compiled(self) -> int:
        return len(self._progs)

    def get(self, sig):
        fn = self._progs.get(sig)
        if fn is None:
            fn = self._build(sig)
            self._progs[sig] = fn
        return fn

    def _build(self, sig):
        ssb_sigs, pdcch_cfgs, pdsch_cfgs, csi_cfgs = sig
        nsc = self.nsc

        def fn(ssb_payloads, dci_payloads, tbs, cinits,
               device: torch.device) -> torch.Tensor:
            """Payloads: [n] int8 tensors on `device`; cinits: per PDSCH the
            slot's DM-RS c_init tuple.  Returns the [14, nsc] grid."""
            grid = torch.zeros((1, 14, nsc), dtype=torch.complex64,
                               device=device)
            for (cfg, k0), bits in zip(ssb_sigs, ssb_payloads):
                grid[:, 2:6, k0:k0 + ssb_proc.SSB_NSC] = ssb_proc.ssb_assemble(
                    bits[None], cfg)
            for cfg, bits in zip(pdcch_cfgs, dci_payloads):
                grid = pdcch_proc.pdcch_transmit(bits[None], cfg, grid)
            for cfg, tb, ci in zip(pdsch_cfgs, tbs, cinits):
                pil = dmrs_ops.pilot_values(ci, cfg.prb_start, cfg.nof_prb,
                                            device)
                grid = sch.pdsch_transmit(tb[None], cfg, grid, pilots=pil)
            # CSI-RS after PDSCH: its REs sit in the PDSCH reserved pattern
            for cfg in csi_cfgs:
                grid = csi_rs_proc.generate(cfg, grid)
            return grid[0]

        return fn


def signature(req: fapi.UlTtiRequest):
    """Static signature of a UL slot's PDU list.  Every field that shapes
    the program is a frozen dataclass, so the tuple is hashable; PUSCH and
    PUCCH configs are normalised to slot_in_frame=0 (the slot number only
    enters through sequences that the program takes as data), so one
    program serves every slot of the frame."""
    def norm(cfg):
        return (dataclasses.replace(cfg, slot_in_frame=0)
                if cfg is not None else None)

    return (
        tuple(dataclasses.replace(p.config, slot_in_frame=0)
              for p in req.pusch_pdus),
        tuple((norm(p.format1), norm(p.format2)) for p in req.pucch_pdus),
        tuple((p.root_sequence_index, p.length, p.zero_correlation_zone,
               p.nof_preambles) for p in req.prach_pdus),
    )


def pucch_slot_data(pdu: fapi.PucchPdu, device: torch.device) -> tuple:
    """The slot's sequence data of one PUCCH PDU: (F1 (data, DM-RS)
    sequences as complex tensors on `device` | None, F2 DM-RS c_init values
    | None)."""
    f1 = (pucch_proc.f1_slot_seqs_on(pdu.format1, device)
          if pdu.format1 is not None else None)
    f2 = (tuple(int(c) for c in pucch_proc.f2_dmrs_cinits(pdu.format2))
          if pdu.format2 is not None else None)
    return (f1, f2)


def pusch_cinits(cfg: sch.ShConfig) -> tuple[int, ...]:
    """DM-RS c_init values of a PUSCH/PDSCH config's slot, one per DM-RS
    symbol."""
    return tuple(cfg.dmrs_cinit(l) for l in cfg.dmrs_symbols)


def decode_groups(cfgs) -> dict:
    """{(BG, Zc, N, graph span): [PDU index, ...]} — the PDUs whose
    codeblocks share one decoder launch."""
    groups: dict = {}
    for i, cfg in enumerate(cfgs):
        seg = cfg.segments
        n = sch.llr_full_shape(cfg)[1]
        key = (seg.base_graph, seg.lifting_size, n, sch.used_blocks(cfg))
        groups.setdefault(key, []).append(i)
    return groups


def _decode_grouped(llrs: list[torch.Tensor], groups: dict, iters: int):
    """LDPC-decode each PDU's [C, N] LLRs, one decoder launch per group of
    ``decode_groups``.  Returns per PDU (bits [C, K], ok [C])."""
    out: list = [None] * len(llrs)
    for (bg, z, _n, n_used), idxs in groups.items():
        cat = torch.cat([llrs[i] for i in idxs], dim=0)
        bits, ok = decoder_cuda.decode(cat, bg, z, nof_iterations=iters,
                                       nof_used_blocks=n_used)
        off = 0
        for i in idxs:
            c = llrs[i].shape[0]
            out[i] = (bits[off:off + c], ok[off:off + c])
            off += c
    return out


def fetch(tree):
    """One device→host transfer of a nested dict/list of tensors: every
    tensor is flattened into one float32 vector, copied once, and split
    back into numpy arrays of the original dtypes and shapes."""
    leaves: list[torch.Tensor] = []

    def collect(node):
        if isinstance(node, dict):
            return {k: collect(v) for k, v in node.items()}
        if isinstance(node, list):
            return [collect(v) for v in node]
        leaves.append(node)
        return len(leaves) - 1

    shape = collect(tree)
    if not leaves:
        return shape
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
    host = flat.cpu().numpy()
    arrays, off = [], 0
    for t in leaves:
        n = t.numel()
        dtype = {torch.bool: np.bool_, torch.int8: np.int8,
                 torch.int64: np.int64}.get(t.dtype, np.float32)
        arrays.append(host[off:off + n].astype(dtype).reshape(t.shape))
        off += n

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        if isinstance(node, list):
            return [rebuild(v) for v in node]
        return arrays[node]

    return rebuild(shape)


class UlSlotPrograms:
    """Cache of fused UL slot programs keyed by slot signature."""

    def __init__(self, nof_ldpc_iterations: int = 6) -> None:
        self.nof_ldpc_iterations = nof_ldpc_iterations
        self._progs: dict = {}

    @property
    def nof_compiled(self) -> int:
        return len(self._progs)

    def get(self, sig):
        fn = self._progs.get(sig)
        if fn is None:
            fn = self._build(sig)
            self._progs[sig] = fn
        return fn

    def _build(self, sig):
        pusch_cfgs, pucch_cfgs, prach_sigs = sig
        iters = self.nof_ldpc_iterations
        groups = decode_groups(pusch_cfgs)

        def fn(rx_grid, priors, new_data, prach_rx, cinits, pucch_data):
            """rx_grid [nrx, 14, nsc]; priors [C, N] and new_data (bool
            tensor) per PUSCH; prach_rx [nrx, L]; cinits per PUSCH; pucch_data
            per PUCCH (``pucch_slot_data``).  Returns the slot's outputs as
            device tensors."""
            dev = rx_grid.device
            rx = rx_grid[None]                                  # B = 1
            # ---- PUSCH front halves + HARQ combine on the device
            demods = [
                sch.pusch_demodulate(
                    rx, cfg, tx_pilots=dmrs_ops.pilot_values(
                        ci, cfg.prb_start, cfg.nof_prb, dev))
                for cfg, ci in zip(pusch_cfgs, cinits)]
            llrs = [torch.where(nd, d.llr_full[0], d.llr_full[0] + p)
                    for d, p, nd in zip(demods, priors, new_data)]
            # ---- one decoder launch per (BG, Zc, N, span) group
            decoded = _decode_grouped(llrs, groups, iters)
            pusch_out = []
            for cfg, d, llr, (bits, okc) in zip(pusch_cfgs, demods, llrs,
                                                decoded):
                res = sch.pusch_finish(bits[None], okc[None], cfg,
                                       d.noise_var, d.rsrp, demod=d)
                o = {"tb_bits": res.tb_bits[0], "tb_crc_ok": res.tb_crc_ok[0],
                     "sinr_db": res.sinr_db[0], "combined_llr": llr,
                     "ta_norm": (res.ta_norm[0] if res.ta_norm is not None
                                 else res.sinr_db.new_zeros(()))}
                for f in ("ack_bits", "ack_valid", "csi1_bits",
                          "csi1_valid", "csi2_bits", "csi2_valid"):
                    v = getattr(res, f)
                    if v is not None:
                        o[f] = v[0]
                pusch_out.append(o)

            # ---- PUCCH with the slot's sequences
            pucch_out = []
            for (f1, f2), (s1, c2) in zip(pucch_cfgs, pucch_data):
                o = {}
                if f1 is not None:
                    r1 = pucch_proc.pucch_f1_detect(rx, f1, seqs=s1)
                    o["f1"] = {"bits": r1.bits[0], "detected": r1.detected[0],
                               "metric": r1.detection_metric[0]}
                if f2 is not None:
                    r2 = pucch_proc.pucch_f2_receive(rx, f2, dmrs_cinits=c2)
                    o["f2"] = {"uci_bits": r2.uci_bits[0],
                               "detected": r2.detected[0],
                               "metric": r2.metric[0]}
                pucch_out.append(o)

            # ---- PRACH occasions over the cell's root set
            prach_out = []
            for root, length, zcz, nof_pre in prach_sigs:
                metric, delay = prach_scan(prach_rx, root, length, zcz,
                                            nof_pre)
                prach_out.append({"metric": metric, "delay": delay})

            return {"pusch": pusch_out, "pucch": pucch_out,
                    "prach": prach_out}

        return fn


def prach_scan(prach_rx: torch.Tensor, root: int, length: int, zcz: int,
                nof_preambles: int):
    """Detect over as many roots as the preamble count needs: the global
    preamble index p maps to (root + p // n_shifts, shift p % n_shifts).
    Returns (metric, delay in chips), each [..., nof_preambles]."""
    ns = prach_ops.num_shifts(length, zcz)
    nroots = max(1, -(-nof_preambles // ns))
    ms, ds = [], []
    for ri in range(nroots):
        metric, delay, _ = prach_ops.detect(prach_rx, root + ri, length, zcz)
        ms.append(metric)
        ds.append(delay)
    return (torch.cat(ms, dim=-1)[..., :nof_preambles],
            torch.cat(ds, dim=-1)[..., :nof_preambles])
