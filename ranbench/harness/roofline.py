"""Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at the
700 W power limit) and the least time of the LDPC kernels' work.

The work is reckoned from the cell's shapes and the sweep counts frozen in
the cell's file, never from counters of the kernel under test: input
soft bits or bits read once, output bits written once, and for the decoder
12 float32 operations per edge-lane per layered min-sum sweep.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
OPS_PER_EDGE_LANE = 12


def least_seconds(nbytes: float, flops: float = 0.0) -> float:
    """The larger of bytes over the HBM peak and operations over the
    float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def decoder_least_seconds(shape: dict) -> float:
    """One decoder launch: rows codeblocks of `used_blocks`·Z float32 LLRs
    in, K bits and a verdict out per row, `edges`·Z edge-lanes per sweep."""
    rows, z = shape["rows"], shape["z"]
    nbytes = rows * (4 * shape["used_blocks"] * z + shape["k"] + 1)
    flops = rows * OPS_PER_EDGE_LANE * shape["edges"] * z * shape["sweeps"]
    return least_seconds(nbytes, flops)


def encoder_least_seconds(shape: dict) -> float:
    """One encoder launch: rows × K message bits in (int8), rows × N_full·Z
    codeword bits out (int8).  Bytes bound it; the XORs are not counted."""
    return least_seconds(shape["rows"] * (shape["k"] + shape["n"]))


def share_pct(least: float, measured: float) -> float | None:
    """100·least/measured, or None when nothing was measured."""
    if measured <= 0.0:
        return None
    return 100.0 * least / measured
