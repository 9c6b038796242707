"""Amplitude control: gain and optional magnitude clipping, with statistics.

Counterpart of ``srsran_project_23_5_tpu/phy/lower/amplitude.py``
(amplitude_controller_clipping_impl.h:24-44).  The statistics stay on the
device as 0-d tensors: reading them is the caller's host sync.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class AmplitudeStats:
    mean_power_dbfs: torch.Tensor
    peak_power_dbfs: torch.Tensor
    papr_db: torch.Tensor
    clipped_ratio: torch.Tensor


def _db(x: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(x, min=1e-30))


def control(samples: torch.Tensor, gain_db: float = 0.0,
            enable_clipping: bool = False, ceiling_dbfs: float = 0.0
            ) -> tuple[torch.Tensor, AmplitudeStats]:
    """Apply the gain and, if enabled, clip magnitudes to the ceiling;
    statistics over all samples (before clipping)."""
    out = samples * (10.0 ** (gain_db / 20.0))
    power = out.abs() ** 2
    mean_p, peak_p = power.mean(), power.amax()
    if enable_clipping:
        mag = torch.sqrt(torch.clamp(power, min=1e-30))
        limit = 10.0 ** (ceiling_dbfs / 20.0)
        clipped = (mag > limit).to(torch.float32).mean()
        out = out * torch.clamp(limit / mag, max=1.0)
    else:
        clipped = power.new_zeros(())
    return out, AmplitudeStats(
        mean_power_dbfs=_db(mean_p), peak_power_dbfs=_db(peak_p),
        papr_db=_db(torch.clamp(peak_p / torch.clamp(mean_p, min=1e-30),
                                min=1.0)),
        clipped_ratio=clipped)
