"""upper_phy.h2d_per_slot: host arrays the upper PHY makes into device
tensors per FAPI slot (its tracer's ``h2d`` count: payloads, new-data
flags), over the ``upper_phy.*_slot`` records of the traced stretch; from
the program's counter."""
from ranbench.harness import program_trace


def read(cell, out):
    pt = program_trace.load(cell, out)
    if pt is None:
        return None
    return program_trace.count_per(
        pt, {"upper_phy.ul_slot", "upper_phy.dl_slot"}, "h2d")
