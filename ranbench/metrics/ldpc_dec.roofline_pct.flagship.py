"""ldpc_dec.roofline_pct.flagship: the LDPC decoder kernel's least time at
rank 0's step shape (bytes over 3.35 TB/s or 12 float32 operations per
edge-lane per sweep over 67 TFLOP/s, sweeps frozen in the cell's file) over
its profiled time on rank 0."""
from ranbench.harness import kernels


def read(cell, out):
    return kernels.roofline_pct(cell, out, "ldpc_dec")
