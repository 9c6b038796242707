"""NR operating-band helpers (TS 38.104 Tables 5.2-1, 5.4.2.1-1/2;
reference lib/ran/band_helper.cpp).

Covers the FR1 bands the 23.5 reference supports, with the standard
NR-ARFCN ↔ frequency raster and duplex-mode/SSB-SCS lookup.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BandInfo:
    band: int
    duplex: str                  # "FDD" | "TDD" | "SDL" | "SUL"
    ul_low_mhz: float
    ul_high_mhz: float
    dl_low_mhz: float
    dl_high_mhz: float
    ssb_scs_khz: int


# FR1 bands supported by the reference in 23.5 (CHANGELOG: "all FR1 bands")
# — the commonly-deployed subset with exact edges.
FR1_BANDS = (
    BandInfo(1, "FDD", 1920, 1980, 2110, 2170, 15),
    BandInfo(2, "FDD", 1850, 1910, 1930, 1990, 15),
    BandInfo(3, "FDD", 1710, 1785, 1805, 1880, 15),
    BandInfo(5, "FDD", 824, 849, 869, 894, 15),
    BandInfo(7, "FDD", 2500, 2570, 2620, 2690, 15),
    BandInfo(8, "FDD", 880, 915, 925, 960, 15),
    BandInfo(20, "FDD", 832, 862, 791, 821, 15),
    BandInfo(28, "FDD", 703, 748, 758, 803, 15),
    BandInfo(38, "TDD", 2570, 2620, 2570, 2620, 30),
    BandInfo(40, "TDD", 2300, 2400, 2300, 2400, 30),
    BandInfo(41, "TDD", 2496, 2690, 2496, 2690, 30),
    BandInfo(66, "FDD", 1710, 1780, 2110, 2200, 15),
    BandInfo(71, "FDD", 663, 698, 617, 652, 15),
    BandInfo(77, "TDD", 3300, 4200, 3300, 4200, 30),
    BandInfo(78, "TDD", 3300, 3800, 3300, 3800, 30),
    BandInfo(79, "TDD", 4400, 5000, 4400, 5000, 30),
)
_BY_NUM = {b.band: b for b in FR1_BANDS}


def nr_arfcn_to_freq_hz(arfcn: int) -> float:
    """Global frequency raster (TS 38.104 Table 5.4.2.1-1)."""
    if arfcn < 600_000:
        return 5e3 * arfcn
    if arfcn < 2_016_667:
        return 3e9 + 15e3 * (arfcn - 600_000)
    return 24_250.08e6 + 60e3 * (arfcn - 2_016_667)


def freq_hz_to_nr_arfcn(freq_hz: float) -> int:
    if freq_hz < 3e9:
        return round(freq_hz / 5e3)
    if freq_hz < 24_250.08e6:
        return 600_000 + round((freq_hz - 3e9) / 15e3)
    return 2_016_667 + round((freq_hz - 24_250.08e6) / 60e3)


def get_band(band: int) -> BandInfo:
    return _BY_NUM[band]


def band_from_dl_freq(freq_hz: float) -> int | None:
    """First band whose DL range contains the frequency."""
    mhz = freq_hz / 1e6
    for b in FR1_BANDS:
        if b.dl_low_mhz <= mhz <= b.dl_high_mhz:
            return b.band
    return None


def duplex_mode(band: int) -> str:
    return _BY_NUM[band].duplex


def ul_arfcn_from_dl(band: int, dl_arfcn: int) -> int:
    """Default UL ARFCN for a DL ARFCN (band duplex spacing; TDD: same)."""
    b = _BY_NUM[band]
    if b.duplex == "TDD":
        return dl_arfcn
    offset_hz = (b.dl_low_mhz - b.ul_low_mhz) * 1e6
    return freq_hz_to_nr_arfcn(nr_arfcn_to_freq_hz(dl_arfcn) - offset_hz)
