"""upper_phy.prep_ms: host ms per FAPI slot of the upper PHY's preparation
of a slot program's inputs (``upper_phy.ul_prep`` or ``upper_phy.dl_prep``:
signature, priors, new-data flags and payloads made into device tensors,
c_init values, pilots) and of their copy into the program's static buffers
(``graphs.copy_in``), over the ``upper_phy.*_slot`` spans of the traced
stretch; from the program's spans."""
from ranbench.harness import program_trace

SLOTS = ("upper_phy.ul_slot", "upper_phy.dl_slot")
PREP = ("upper_phy.ul_prep", "upper_phy.dl_prep", "graphs.copy_in")


def read(cell, out):
    pt = program_trace.load(cell, out)
    if pt is None:
        return None
    return program_trace.ms_per(pt, PREP, SLOTS)
