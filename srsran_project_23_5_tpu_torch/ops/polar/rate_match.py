"""Polar rate matching / dematching (TS 38.212 §5.4.1).

Counterpart of ``srsran_project_23_5_tpu/ops/polar/rate_match.py``:
sub-block interleaving plus repetition, puncturing or shortening as static
gathers.  Dematching restores codeword LLRs with 0 (punctured) or +infinity
(shortened, known zero), then undoes the interleaver with its inverse
permutation, built once on the host.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .code import PolarCode, RateMatchMode, subblock_interleaver


@functools.lru_cache(maxsize=32)
def _maps(n: int, e: int, device: torch.device):
    """(J(n), its inverse, the repetition read index) on `device`."""
    jn = subblock_interleaver(n).astype(np.int64)
    inv = np.argsort(jn)
    rep = np.arange(e, dtype=np.int64) % n
    return tuple(torch.from_numpy(a).to(device) for a in (jn, inv, rep))


def match(codeword: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """[..., N] {0,1} → [..., E]."""
    jn, _, rep = _maps(code.n, code.e, codeword.device)
    y = codeword[..., jn]
    if code.mode == RateMatchMode.REPETITION:
        return y[..., rep]
    if code.mode == RateMatchMode.PUNCTURING:
        return y[..., code.n - code.e:]
    return y[..., :code.e]  # shortening


def dematch(llr: torch.Tensor, code: PolarCode,
            infty: float = 1e4) -> torch.Tensor:
    """[..., E] LLRs → [..., N] codeword LLRs (deinterleaved).

    Repetition soft-combines the copies with ``index_add_``; on CUDA its
    float summation order is not fixed.
    """
    _, inv, rep = _maps(code.n, code.e, llr.device)
    y = llr.new_zeros((*llr.shape[:-1], code.n))
    if code.mode == RateMatchMode.REPETITION:
        y.index_add_(-1, rep, llr)
    elif code.mode == RateMatchMode.PUNCTURING:
        y[..., code.n - code.e:] = llr
    else:  # shortening: untransmitted bits are known zeros
        y[..., :code.e] = llr
        y[..., code.e:] = infty
    return y[..., inv]
