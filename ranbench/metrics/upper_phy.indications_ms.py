"""upper_phy.indications_ms: host ms per UL slot of building the FAPI
indications from the slot's host outputs (``upper_phy.indications``), over
the ``upper_phy.ul_slot`` spans of the traced stretch; from the program's
spans."""
from ranbench.harness import program_trace


def read(cell, out):
    pt = program_trace.load(cell, out)
    if pt is None:
        return None
    return program_trace.ms_per(pt, ("upper_phy.indications",),
                                ("upper_phy.ul_slot",))
