"""ldpc_enc.roofline_pct.mixed: the LDPC encoder kernel's least time (message
bits in and codeword bits out over 3.35 TB/s) over its profiled time."""
from ranbench.harness import kernels


def read(cell, out):
    return kernels.roofline_pct(cell, out, "ldpc_enc")
