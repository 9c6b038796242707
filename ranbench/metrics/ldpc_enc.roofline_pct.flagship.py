"""ldpc_enc.roofline_pct.flagship: the LDPC encoder kernel's least time at
rank 0's step shape (message bits in and codeword bits out over 3.35 TB/s)
over its profiled time on rank 0."""
from ranbench.harness import kernels


def read(cell, out):
    return kernels.roofline_pct(cell, out, "ldpc_enc")
