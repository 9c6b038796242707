"""OFDM PRACH demodulator: baseband window → frequency-domain preamble.

Counterpart of ``srsran_project_23_5_tpu/phy/lower/prach_demod.py``
(ofdm_prach_demodulator_impl.cpp:31-113): the PRACH has its own
numerology (1.25 kHz long formats, 15·2^μ kHz short formats); a window of
the carrier baseband is transformed at the PRACH FFT size and the L_RA
preamble bins are taken at the configured frequency offset.  Long windows
(format 0: ~0.9 ms, more than one 0.5 ms slot at μ=1) span slot
boundaries, so ``PrachWindowAssembler`` buffers slot chunks until the
window is complete.
"""
from __future__ import annotations

import torch

# Long preamble formats (TS 38.211 Table 6.3.3.1-1), κ = 64: (subcarrier
# spacing Hz, sequence repetitions, N_CP in T_c units; the 16κ correction per
# 0.5 ms boundary is included in these totals)
LONG_FORMATS = {
    "0": (1250.0, 1, 3168 * 64),
    "1": (1250.0, 2, 21024 * 64),
    "2": (1250.0, 4, 4688 * 64),
    "3": (5000.0, 4, 3168 * 64),
}
_TC = 1.0 / (480e3 * 4096)          # the 3GPP basic time unit


def _bins(spectrum: torch.Tensor, length: int, freq_offset_bins: int
          ) -> torch.Tensor:
    """The preamble's `length` bins from `freq_offset_bins` on (cyclic)."""
    n = spectrum.shape[-1]
    idx = (torch.arange(length, device=spectrum.device)
           + freq_offset_bins) % n
    return spectrum[..., idx]


def demodulate(samples: torch.Tensor, prach_fft: int, length: int,
               freq_offset_bins: int, cp_samples: int) -> torch.Tensor:
    """[..., cp_samples + prach_fft] baseband at a rate with an integer
    number of samples per PRACH subcarrier (prach_fft = fs / prach_scs) →
    the frequency-domain window [..., length] (input to ``ops.prach.detect``);
    freq_offset_bins: first preamble subcarrier relative to DC."""
    body = samples[..., cp_samples:cp_samples + prach_fft]
    return _bins(torch.fft.fft(body, dim=-1) / prach_fft, length,
                 freq_offset_bins)


def prach_window_samples(prach_fft: int, cp_samples: int,
                         nof_repetitions: int = 1) -> int:
    return nof_repetitions * prach_fft + cp_samples


def long_format_geometry(fmt: str, fs_hz: float) -> tuple[int, int, int]:
    """(prach_fft, nof_repetitions, cp_samples) at the carrier rate fs_hz."""
    scs, nrep, cp_tc = LONG_FORMATS[fmt]
    return int(round(fs_hz / scs)), nrep, int(round(cp_tc * _TC * fs_hz))


def demodulate_long(samples: torch.Tensor, prach_fft: int, length: int,
                    freq_offset_bins: int, cp_samples: int,
                    nof_repetitions: int) -> torch.Tensor:
    """Repetition-accumulating demodulation (formats 1/2/3): the spectra
    of the nof_repetitions back-to-back prach_fft periods after the CP are
    averaged coherently, in one batched FFT."""
    body = samples[..., cp_samples:cp_samples + nof_repetitions * prach_fft]
    reps = body.reshape(*body.shape[:-1], nof_repetitions, prach_fft)
    spectrum = torch.fft.fft(reps, dim=-1).mean(dim=-2) / prach_fft
    return _bins(spectrum, length, freq_offset_bins)


class PrachWindowAssembler:
    """Multi-slot PRACH window (the prach_processor_worker analogue): each
    slot's baseband is fed in turn, the part inside the window
    [start_sample, start_sample + need) is kept, and the complete window is
    demodulated in one call."""

    def __init__(self, start_sample: int, prach_fft: int, length: int,
                 freq_offset_bins: int, cp_samples: int,
                 nof_repetitions: int = 1) -> None:
        self.start = start_sample
        self.prach_fft = prach_fft
        self.length = length
        self.freq_offset_bins = freq_offset_bins
        self.cp = cp_samples
        self.nrep = nof_repetitions
        self.need = prach_window_samples(prach_fft, cp_samples,
                                         nof_repetitions)
        self._buf: list[torch.Tensor] = []
        self._have = 0
        self._pos = 0               # absolute samples consumed

    @property
    def ready(self) -> bool:
        return self._have >= self.need

    def feed(self, slot_samples: torch.Tensor) -> bool:
        """Append one slot's baseband [..., n]; True once the window is
        complete."""
        n = int(slot_samples.shape[-1])
        lo, hi = self._pos, self._pos + n
        self._pos = hi
        w0, w1 = self.start, self.start + self.need
        if hi <= w0 or lo >= w1 or self.ready:
            return self.ready
        a, b = max(lo, w0) - lo, min(hi, w1) - lo
        self._buf.append(slot_samples[..., a:b])
        self._have += b - a
        return self.ready

    def demodulate(self) -> torch.Tensor:
        if not self.ready:
            raise RuntimeError("PRACH window incomplete")
        window = torch.cat(self._buf, dim=-1)
        if self.nrep == 1:
            return demodulate(window, self.prach_fft, self.length,
                              self.freq_offset_bins, self.cp)
        return demodulate_long(window, self.prach_fft, self.length,
                               self.freq_offset_bins, self.cp, self.nrep)
