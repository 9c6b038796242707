"""LDPC rate matching / dematching (TS 38.212 §5.4.2).

Counterpart of ``srsran_project_23_5_tpu/ops/ldpc/rate_match.py``.  The index
maps (``selection_indices``, ``inverse_selection_maps``, ``tb_maps``) are the
JAX package's numpy code re-hosted as it is; ``tb_maps`` fuses the
per-codeblock circular-buffer bit selection and the bit interleaver into
whole-TB tables, so matching is one gather and dematching one gather per
buffer wrap.  ``match``/``dematch`` do the same for one codeblock.

Buffer convention: the circular buffer is the full codeword minus its first
2*Zc punctured systematic columns.  Filler positions are skipped on
transmit and pinned to +LLR_INFTY (bit surely 0) on receive.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...ran import ldpc_params
from ...ran.constants import LLR_INFTY


@functools.lru_cache(maxsize=1024)
def selection_indices(base_graph: int, lifting_size: int, rv: int,
                      payload_length: int, segment_length: int, e: int,
                      ncb: int | None = None) -> np.ndarray:
    """Index into the circular buffer for each of the E selected bits."""
    n = (66 if base_graph == 1 else 50) * lifting_size
    ncb = n if ncb is None else ncb
    k0 = ldpc_params.rate_match_k0(base_graph, lifting_size, rv, ncb)
    f_begin = payload_length - 2 * lifting_size   # filler start in buffer
    f_end = segment_length - 2 * lifting_size     # filler end in buffer
    idx = np.empty(e, dtype=np.int32)
    k = k0
    for j in range(e):
        while f_begin <= (k % ncb) < f_end:
            k += 1
        idx[j] = k % ncb
        k += 1
    return idx


@functools.lru_cache(maxsize=1024)
def inverse_selection_maps(base_graph: int, lifting_size: int, rv: int,
                           payload_length: int, segment_length: int,
                           e: int) -> tuple[np.ndarray, ...]:
    """Per-wrap inverse maps: inv_r[i] = j of the r-th transmission of
    buffer bit i (or e, pointing at a zero pad slot)."""
    n = (66 if base_graph == 1 else 50) * lifting_size
    idx = selection_indices(base_graph, lifting_size, rv, payload_length,
                            segment_length, e)
    hits = np.zeros(n, dtype=np.int32)
    for i in idx:
        hits[i] += 1
    wraps = int(hits.max()) if len(idx) else 0
    inv = [np.full(n, e, dtype=np.int32) for _ in range(wraps)]
    count = np.zeros(n, dtype=np.int32)
    for j, i in enumerate(idx):
        inv[count[i]][i] = j
        count[i] += 1
    return tuple(inv)


@functools.lru_cache(maxsize=256)
def tb_maps(base_graph: int, lifting_size: int, rv: int,
            payload_length: int, segment_length: int,
            cb_lengths: tuple[int, ...], qm: int
            ) -> tuple[np.ndarray, tuple[np.ndarray, ...], np.ndarray]:
    """Whole-transport-block forward/inverse rate-match permutations.

    Returns:
      fwd  [G] int32 — TB codeword bit g comes from flat position fwd[g] of
                       the [C, N_full*Zc] codeword.
      invs tuple of [C*Nbuf] int32 — per-wrap inverse maps into the padded
                       TB LLR vector [G+1] (slot G is a zero pad); summing
                       the gathers soft-combines repeated bits.
      filler [Nbuf] bool — filler positions (same for every CB of a TB).
    """
    z = lifting_size
    nbuf = (66 if base_graph == 1 else 50) * z
    nfull = nbuf + 2 * z
    offs = np.concatenate([[0], np.cumsum(cb_lengths)]).astype(np.int64)
    g_total = int(offs[-1])

    fwd = np.empty(g_total, dtype=np.int32)
    wraps_max = 0
    per_cb = []
    for r, e in enumerate(cb_lengths):
        idx = selection_indices(base_graph, z, rv, payload_length,
                                segment_length, e)
        m = e // qm
        # fold §5.4.2.2 interleaving: output j*qm+q reads selected[q*m+j]
        inter = idx.reshape(qm, m).T.reshape(-1)
        fwd[offs[r]:offs[r + 1]] = r * nfull + 2 * z + inter
        invs_cb = inverse_selection_maps(base_graph, z, rv, payload_length,
                                         segment_length, e)
        wraps_max = max(wraps_max, len(invs_cb))
        per_cb.append((invs_cb, m, e))

    c = len(cb_lengths)
    invs = [np.full(c * nbuf, g_total, dtype=np.int32)
            for _ in range(wraps_max)]
    for r, (invs_cb, m, e) in enumerate(per_cb):
        for w, inv in enumerate(invs_cb):
            p = inv.astype(np.int64)
            valid = p < e
            raw = (p % m) * qm + (p // m)
            dst = invs[w][r * nbuf:(r + 1) * nbuf]
            dst[valid] = (offs[r] + raw[valid]).astype(np.int32)

    pos = np.arange(nbuf)
    filler = ((pos >= payload_length - 2 * z)
              & (pos < segment_length - 2 * z))
    return fwd, tuple(invs), filler


@functools.lru_cache(maxsize=256)
def _tb_maps_on(device: torch.device, *key):
    fwd, invs, filler = tb_maps(*key)
    return (torch.from_numpy(fwd.astype(np.int64)).to(device),
            tuple(torch.from_numpy(i.astype(np.int64)).to(device)
                  for i in invs),
            torch.from_numpy(filler).to(device))


def match_tb(codewords: torch.Tensor, base_graph: int, lifting_size: int,
             rv: int, payload_length: int, segment_length: int,
             cb_lengths: tuple[int, ...], qm: int) -> torch.Tensor:
    """Codeblocks [B, C, N_full*Zc] {0,1} → TB codeword bits [B, G]."""
    fwd, _, _ = _tb_maps_on(codewords.device, base_graph, lifting_size, rv,
                            payload_length, segment_length,
                            tuple(cb_lengths), qm)
    return codewords.reshape(codewords.shape[0], -1)[:, fwd]


def dematch_tb(llr: torch.Tensor, base_graph: int, lifting_size: int,
               rv: int, payload_length: int, segment_length: int,
               cb_lengths: tuple[int, ...], qm: int) -> torch.Tensor:
    """TB LLRs [B, G] → per-CB full-codeword LLRs [B, C, N_full*Zc].

    Repetitions soft-combine, fillers pin to +LLR_INFTY, the punctured 2Zc
    systematic positions get 0.
    """
    z = lifting_size
    c = len(cb_lengths)
    bsz = llr.shape[0]
    _, invs, filler = _tb_maps_on(llr.device, base_graph, lifting_size, rv,
                                  payload_length, segment_length,
                                  tuple(cb_lengths), qm)
    nbuf = (66 if base_graph == 1 else 50) * z
    llr_pad = torch.cat([llr, llr.new_zeros((bsz, 1))], dim=-1)
    buf = llr_pad[:, invs[0]]
    for inv in invs[1:]:
        buf = buf + llr_pad[:, inv]
    buf = buf.reshape(bsz, c, nbuf).masked_fill(filler, float(LLR_INFTY))
    punct = llr.new_zeros((bsz, c, 2 * z))
    return torch.cat([punct, buf], dim=-1)


def interleave(bits: torch.Tensor, qm: int) -> torch.Tensor:
    """Bit interleaver (TS 38.212 §5.4.2.2): [..., E] → [..., E]."""
    *lead, e = bits.shape
    return bits.reshape(*lead, qm, e // qm).transpose(-1, -2).reshape(*lead,
                                                                      e)


def deinterleave(bits: torch.Tensor, qm: int) -> torch.Tensor:
    *lead, e = bits.shape
    return bits.reshape(*lead, e // qm, qm).transpose(-1, -2).reshape(*lead,
                                                                      e)


@functools.lru_cache(maxsize=256)
def _cb_maps_on(device: torch.device, *key):
    """One codeblock's selection indices and inverse maps on `device`."""
    *sel_key, e = key
    idx = selection_indices(*sel_key, e)
    invs = inverse_selection_maps(*sel_key, e)
    return (torch.from_numpy(idx.astype(np.int64)).to(device),
            tuple(torch.from_numpy(i.astype(np.int64)).to(device)
                  for i in invs))


def match(codeword: torch.Tensor, base_graph: int, lifting_size: int,
          rv: int, payload_length: int, segment_length: int, e: int,
          qm: int) -> torch.Tensor:
    """One codeblock's full codeword [..., N_full*Zc] {0,1} → rate-matched
    bits [..., E]: bit selection from the circular buffer, then the bit
    interleaver."""
    idx, _ = _cb_maps_on(codeword.device, base_graph, lifting_size, rv,
                         payload_length, segment_length, e)
    return interleave(codeword[..., 2 * lifting_size:][..., idx], qm)


def dematch(llr: torch.Tensor, base_graph: int, lifting_size: int, rv: int,
            payload_length: int, segment_length: int, e: int, qm: int,
            llr_infty: float = float(LLR_INFTY)) -> torch.Tensor:
    """One codeblock's rate-matched LLRs [..., E] → full-codeword LLRs
    [..., N_full*Zc]: repeated transmissions of a buffer bit soft-combine,
    the punctured systematic LLRs are 0 and the fillers +llr_infty."""
    z = lifting_size
    _, invs = _cb_maps_on(llr.device, base_graph, lifting_size, rv,
                          payload_length, segment_length, e)
    de = deinterleave(llr, qm)
    de_pad = torch.cat([de, de.new_zeros((*de.shape[:-1], 1))], dim=-1)
    buf = de_pad[..., invs[0]]
    for inv in invs[1:]:
        buf = buf + de_pad[..., inv]
    pos = torch.arange(buf.shape[-1], device=llr.device)
    filler = (pos >= payload_length - 2 * z) & (pos < segment_length - 2 * z)
    buf = buf.masked_fill(filler, llr_infty)
    return torch.cat([de.new_zeros((*de.shape[:-1], 2 * z)), buf], dim=-1)


def combine_retransmission(acc_llr: torch.Tensor, new_llr: torch.Tensor,
                           payload_length: int, lifting_size: int,
                           llr_infty: float = float(LLR_INFTY)
                           ) -> torch.Tensor:
    """HARQ soft combining of two full-codeword LLR tensors, saturating at
    the filler sentinel so that known bits stay known."""
    return torch.clamp(acc_llr + new_llr, -llr_infty, llr_infty)
