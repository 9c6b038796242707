"""VRB-to-PRB mapping (TS 38.211 §7.3.1.6).

Copied from the port's ``srsran_project_23_5_tpu_torch/ran/vrb_prb.py``,
unchanged.

The port's copy of ``srsran_project_23_5_tpu/ran/vrb_prb.py`` (importing the
JAX ``ran`` package would load the JAX package). Interleaved mapping
permutes VRB bundles of size L (2 or 4) through an (R=2, C) block
interleaver across the BWP; the permutation is baked into the RE-mapping
gather indices."""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=256)
def interleaved_vrb_to_prb(n_bwp: int, bundle: int = 2) -> np.ndarray:
    """prb = map[vrb] over the whole BWP (coreset offset 0 variant).

    Bundles j = 0..Nb-1 (last bundle may be short); f(j) for j < Nb-1 via
    the R=2 block interleaver; the last (possibly partial) bundle maps to
    itself (TS 38.211 §7.3.1.6: f(Nb-1) = Nb-1).
    """
    nb = -(-n_bwp // bundle)
    r_rows = 2
    m = nb - 1                     # bundles 0..m-1 interleave; last fixed
    f = np.empty(nb, dtype=np.int64)
    f[nb - 1] = nb - 1
    if m > 0:
        c_cols = -(-m // r_rows)
        # column-write / row-read block interleaver, pruned to m entries —
        # a bijection on [0, m) for any m
        read = [c * r_rows + rr
                for rr in range(r_rows) for c in range(c_cols)
                if c * r_rows + rr < m]
        for i, j in enumerate(read):
            f[j] = i
    out = np.empty(n_bwp, dtype=np.int32)
    for j in range(nb):
        width = bundle if (j + 1) * bundle <= n_bwp else n_bwp - j * bundle
        for k in range(width):
            out[j * bundle + k] = int(f[j]) * bundle + k
    return out


def prb_to_vrb(n_bwp: int, bundle: int = 2) -> np.ndarray:
    """Inverse permutation (receiver side)."""
    fwd = interleaved_vrb_to_prb(n_bwp, bundle)
    inv = np.empty_like(fwd)
    inv[fwd] = np.arange(n_bwp, dtype=np.int32)
    return inv
