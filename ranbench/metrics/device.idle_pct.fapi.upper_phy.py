"""device.idle_pct.fapi.upper_phy: the share of the traced stretch in which
no kernel, copy or set runs on the card while an ``upper_phy.*`` span of
the program is open (the part of ``device.idle_pct.fapi`` that falls inside
the upper PHY)."""
from ranbench.harness import program_trace


def read(cell, out):
    pt = program_trace.load(cell, out)
    if pt is None:
        return None
    return program_trace.idle_while_open_pct(pt, "upper_phy.")
