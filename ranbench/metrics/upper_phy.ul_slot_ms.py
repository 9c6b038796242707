"""upper_phy.ul_slot_ms: host ms of one ``process_ul_slot``, from the
received grid handed in to the indications on the host, the mean over the
window's UL slots; from the benchmark's span."""


def read(cell, out):
    return out.spans.mean_ms("ranbench.ul_slot")
