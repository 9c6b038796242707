"""MCS tables (TS 38.214 §5.1.3.1) — standard-defined constants.

Copied from the port's ``srsran_project_23_5_tpu_torch/ran/mcs_tables.py``,
unchanged.

Reference embeds the same tables in lib/ran/pdsch/pdsch_mcs.cpp /
lib/ran/pusch/pusch_mcs.cpp. Entries are (Qm, R*1024); spectral
efficiency = Qm * R.
"""
from __future__ import annotations

# Table 5.1.3.1-1: up to 64QAM
MCS_TABLE_QAM64 = (
    (2, 120), (2, 157), (2, 193), (2, 251), (2, 308), (2, 379), (2, 449),
    (2, 526), (2, 602), (2, 679), (4, 340), (4, 378), (4, 434), (4, 490),
    (4, 553), (4, 616), (4, 658), (6, 438), (6, 466), (6, 517), (6, 567),
    (6, 616), (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (6, 910),
    (6, 948),
)

# Table 5.1.3.1-2: up to 256QAM
MCS_TABLE_QAM256 = (
    (2, 120), (2, 193), (2, 308), (2, 449), (2, 602), (4, 378), (4, 434),
    (4, 490), (4, 553), (4, 616), (4, 658), (6, 466), (6, 517), (6, 567),
    (6, 616), (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (8, 682.5),
    (8, 711), (8, 754), (8, 797), (8, 841), (8, 885), (8, 916.5), (8, 948),
)


def mcs_to_qm_rate(mcs: int, table: str = "qam64") -> tuple[int, float]:
    """(modulation order, target code rate) for an MCS index."""
    tab = MCS_TABLE_QAM64 if table == "qam64" else MCS_TABLE_QAM256
    qm, r1024 = tab[mcs]
    return qm, r1024 / 1024.0


def max_mcs(table: str = "qam64") -> int:
    return (len(MCS_TABLE_QAM64) if table == "qam64"
            else len(MCS_TABLE_QAM256)) - 1


# ------------------------------------------------------------ link adaptation
# CQI → highest MCS whose spectral efficiency does not exceed the CQI's
# (TS 38.214 Table 5.2.2.1-2 efficiencies, qam64 CQI table), the shape of
# the reference's outer-loop-free mapping (lib/scheduler/support/mcs_calculator.cpp).
CQI_EFFICIENCY_QAM64 = (
    0.0, 0.1523, 0.2344, 0.3770, 0.6016, 0.8770, 1.1758, 1.4766,
    1.9141, 2.4063, 2.7305, 3.3223, 3.9023, 4.5234, 5.1152, 5.5547,
)


def cqi_to_mcs(cqi: int, table: str = "qam64") -> int:
    """Highest MCS with spectral efficiency ≤ the reported CQI's."""
    cqi = max(0, min(cqi, len(CQI_EFFICIENCY_QAM64) - 1))
    if cqi == 0:
        return 0
    target = CQI_EFFICIENCY_QAM64[cqi]
    best = 0
    for m in range(max_mcs(table) + 1):
        qm, r = mcs_to_qm_rate(m, table)
        if qm * r <= target + 1e-9:
            best = m
    return best


def sinr_to_cqi(sinr_db: float) -> int:
    """AWGN SINR → CQI: efficiency ≈ log2(1 + SINR) with a 2 dB
    implementation margin, quantized against the CQI efficiency table."""
    import math
    eff = math.log2(1.0 + 10 ** ((sinr_db - 2.0) / 10))
    cqi = 0
    for i, e in enumerate(CQI_EFFICIENCY_QAM64):
        if e <= eff:
            cqi = i
    return cqi
