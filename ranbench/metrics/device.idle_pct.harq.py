"""device.idle_pct.harq: the share of the traced stretch in which no kernel,
copy or set ran on the card."""


def read(cell, out):
    t = out.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * t["idle_s"] / t["window_s"]
