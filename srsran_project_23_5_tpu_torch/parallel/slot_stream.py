"""Slot-axis (time) sharded stream processing: the consumer of the
ring-halo exchange.

Counterpart of ``srsran_project_23_5_tpu/parallel/slot_stream.py``.  A
baseband stream processed slot-parallel splits the slot axis over the
mesh's slot axis; windows that straddle a shard boundary (PRACH long
formats: a format-0 window is ~0.9 ms against the 0.5 ms μ=1 slot) take
their leading samples from the previous shard through ``halo_from_prev``
(the reference reads a contiguous host ring buffer:
prach_processor_worker.cpp, ofdm_prach_demodulator_impl.cpp).
"""
from __future__ import annotations

import torch

from ..phy.lower import prach_demod
from . import mesh as mesh_lib


def sharded_prach_windows(stream: torch.Tensor, mesh, start_sample: int,
                          prach_fft: int, length: int,
                          freq_offset_bins: int, cp_samples: int,
                          nof_repetitions: int = 1) -> torch.Tensor:
    """Demodulate one PRACH occasion per slot from this rank's shard of a
    slot-sharded baseband stream.

    stream: [local_slots, slot_samples] complex64, this rank's slots along
    `mesh`'s slot axis (``slot_stream_sharding(mesh).local`` gives them and
    refuses a slot count the axis does not divide).  Each slot's occasion
    window BEGINS at `start_sample` relative to its own slot start;
    negative values reach into the previous slot, which for the first
    local slot lies on the previous shard.  Returns [local_slots, length]
    frequency-domain windows (input to ``ops.prach.detect``).
    """
    local, slot_samples = stream.shape
    need = prach_demod.prach_window_samples(prach_fft, cp_samples,
                                            nof_repetitions)
    halo = max(0, -start_sample)
    if start_sample + need > slot_samples:
        raise ValueError(f"a window of {need} samples from {start_sample} "
                         f"exceeds the {slot_samples}-sample slot")
    if halo:
        # the previous shard's tail serves the first local slot; within
        # the shard, slot i-1's tail serves slot i directly
        ext = mesh_lib.halo_from_prev(stream.reshape(-1), halo, mesh,
                                      mesh_lib.SLOT_AXIS)
        w = torch.stack([ext[i * slot_samples + halo + start_sample:][:need]
                         for i in range(local)])
    else:
        w = stream[:, start_sample:start_sample + need]
    if nof_repetitions == 1:
        return prach_demod.demodulate(w, prach_fft, length,
                                      freq_offset_bins, cp_samples)
    return prach_demod.demodulate_long(w, prach_fft, length,
                                       freq_offset_bins, cp_samples,
                                       nof_repetitions)


def slot_stream_sharding(mesh) -> mesh_lib.Sharding:
    """A [nslots, slot_samples] stream split along the slot axis."""
    return mesh_lib.slot_sharding(mesh)
