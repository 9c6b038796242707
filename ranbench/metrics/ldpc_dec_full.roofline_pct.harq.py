"""ldpc_dec_full.roofline_pct.harq: the full-graph LDPC decoder launches
(the combined buffers, every variable block) at their least time (bytes
over 3.35 TB/s or 12 float32 operations per edge-lane per sweep over 67
TFLOP/s, shapes and sweeps frozen in the cell's file) over their profiled
time; None unless each replay's full-graph rows equal what the program's
``ldpc.full_graph`` counted at capture."""
from ranbench.harness import decoder_launches


def read(cell, out):
    return decoder_launches.roofline_pct(cell, out, full=True)
