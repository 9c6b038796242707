"""Lifted LDPC base-graph construction (TS 38.212 §5.3.2).

Copied from the port's ``srsran_project_23_5_tpu_torch/ops/ldpc/graphs.py``,
except that it reads the tables from this folder's ``data/``.

The port's copy of ``srsran_project_23_5_tpu/ops/ldpc/graphs.py``: the spec
shift-coefficient tables are read from the JAX package's
``data/tables_38212.npz`` by path (loading nothing of that package's code),
and for a given (base graph, lifting size) the static edge structure that
specialises the encoder and decoder is materialised as plain tuples.
"""
from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np

from ...ran import ldpc_params

NO_EDGE = 0xFFFF

_TABLES_PATH = Path(__file__).resolve().parents[2] / "data" / "tables_38212.npz"

# (base rows M, base columns N_full, message columns K_b)
_GEOMETRY = {1: (46, 68, 22), 2: (42, 52, 10)}


@functools.lru_cache(maxsize=1)
def _tables() -> dict[str, np.ndarray]:
    with np.load(_TABLES_PATH) as f:
        return dict(f)


@dataclasses.dataclass(frozen=True)
class LiftedGraph:
    """Static description of one lifted Tanner graph."""
    base_graph: int
    lifting_size: int
    nof_check_blocks: int      # M  (base rows / layers)
    nof_var_blocks: int        # N_full (base columns incl. punctured)
    nof_msg_blocks: int        # K_b (message columns: 22 or 10)
    row_cols: tuple[tuple[int, ...], ...]    # columns with an edge, per row
    row_shifts: tuple[tuple[int, ...], ...]  # cyclic shift per edge (mod Zc)

    @property
    def nof_edges(self) -> int:
        return sum(len(c) for c in self.row_cols)


@functools.lru_cache(maxsize=64)
def lifted_graph(base_graph: int, lifting_size: int) -> LiftedGraph:
    if base_graph not in _GEOMETRY:
        raise ValueError(f"base graph {base_graph} not in (1, 2)")
    ils = ldpc_params.lifting_set_index(lifting_size)
    v = _tables()[f"ldpc_bg{base_graph}"][ils]
    m, n, k = _GEOMETRY[base_graph]
    row_cols, row_shifts = [], []
    for r in range(m):
        cols = np.nonzero(v[r] != NO_EDGE)[0]
        row_cols.append(tuple(int(c) for c in cols))
        row_shifts.append(tuple(int(v[r, c]) % lifting_size for c in cols))
    return LiftedGraph(base_graph=base_graph, lifting_size=lifting_size,
                       nof_check_blocks=m, nof_var_blocks=n,
                       nof_msg_blocks=k, row_cols=tuple(row_cols),
                       row_shifts=tuple(row_shifts))


def parity_check_dense(graph: LiftedGraph) -> np.ndarray:
    """Full lifted H as a dense {0,1} matrix — test helper only."""
    z = graph.lifting_size
    h = np.zeros((graph.nof_check_blocks * z, graph.nof_var_blocks * z),
                 dtype=np.uint8)
    eye = np.eye(z, dtype=np.uint8)
    for r, (cols, shifts) in enumerate(zip(graph.row_cols, graph.row_shifts)):
        for c, s in zip(cols, shifts):
            # circulant P^s: entry (i, (i+s) mod Z) = 1
            h[r * z:(r + 1) * z, c * z:(c + 1) * z] = np.roll(eye, s, axis=1)
    return h
