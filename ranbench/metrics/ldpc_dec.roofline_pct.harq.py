"""ldpc_dec.roofline_pct.harq: the rv=0 LDPC decoder launches (the first
transmissions, on the truncated graph) at their least time (bytes over
3.35 TB/s or 12 float32 operations per edge-lane per sweep over 67 TFLOP/s,
shapes and sweeps frozen in the cell's file) over their profiled time."""
from ranbench.harness import decoder_launches


def read(cell, out):
    return decoder_launches.roofline_pct(cell, out, full=False)
