"""SSB candidate-position patterns (TS 38.213 §4.1 cases A/B/C;
reference lib/ran/ssb_mapping.cpp / ssb_properties.h).

Returns the first-symbol index of each SS/PBCH block candidate within a
half-frame for the FR1 cases the 23.5 reference supports.
"""
from __future__ import annotations


def ssb_first_symbols(case: str, lmax: int) -> tuple[int, ...]:
    """Candidate first symbols within the half frame (case A/B/C, FR1).

    Case A (15 kHz): {2, 8} + 14 n,  n ∈ {0,1}   (f ≤ 3 GHz: L=4)
                                    n ∈ {0,1,2,3} (3-6 GHz: L=8)
    Case B (30 kHz): {4, 8, 16, 20} + 28 n, n ∈ {0} or {0,1}
    Case C (30 kHz): {2, 8} + 14 n, n ∈ {0,1} or {0,1,2,3}
    """
    case = case.upper()
    if case == "A" or case == "C":
        base = (2, 8)
        step = 14
        ns = range(2) if lmax == 4 else range(4)
    elif case == "B":
        base = (4, 8, 16, 20)
        step = 28
        ns = range(1) if lmax == 4 else range(2)
    else:
        raise ValueError(f"unsupported SSB case {case!r}")
    out = [b + step * n for n in ns for b in base]
    return tuple(sorted(out)[:lmax])


def ssb_case_for(mu: int, freq_hz: float, paired: bool) -> str:
    """Pattern case from numerology and carrier frequency (FR1)."""
    if mu == 0:
        return "A"
    return "B" if paired else "C"


def ssb_lmax(freq_hz: float) -> int:
    """L_max for FR1: 4 below 3 GHz, 8 between 3 and 6 GHz."""
    return 4 if freq_hz <= 3e9 else 8
