"""Parity of the port's lower PHY with the JAX package (CPU): amplitude
control, the baseband timeline, the slot-synchronous and the streaming
lower-PHY engines, the PRACH demodulator (short, long with repetitions, the
multi-slot window assembler), the PRACH configuration tables and the slot
clock.

Inputs are made with numpy from a seed and handed to both sides.  Tables,
indices, verdicts and decoded bits are equal; floats agree within 1e-4 of
max|ref| (float32 FFTs in two frameworks), power statistics within 1e-4 dB.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srsran_project_23_5_tpu.ops import prach
from srsran_project_23_5_tpu.phy.lower import amplitude, lower_phy, prach_demod
from srsran_project_23_5_tpu.ran import numerology, prach_config
from srsran_project_23_5_tpu_torch.ops import prach as tprach
from srsran_project_23_5_tpu_torch.phy.lower import amplitude as tamplitude
from srsran_project_23_5_tpu_torch.phy.lower import lower_phy as tlower_phy
from srsran_project_23_5_tpu_torch.phy.lower import \
    prach_demod as tprach_demod
from srsran_project_23_5_tpu_torch.phy.upper import sch as tsch
from srsran_project_23_5_tpu_torch.ran import numerology as tnumerology
from srsran_project_23_5_tpu_torch.ran import prach_config as tprach_config

torch.set_num_threads(1)


def _cplx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _close(got, want, rel):
    """|got - want| <= rel · max|want| elementwise."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


# -------------------------------------------------------------- amplitude
@pytest.mark.parametrize("gain_db,clip,ceiling", [
    (0.0, False, 0.0), (6.0206, False, 0.0), (0.0, True, 0.0),
    (20.0, True, 10.0), (-3.0, True, -6.0)])
def test_amplitude_control_matches(gain_db, clip, ceiling):
    x = _cplx(np.random.default_rng(1), (2, 3000), 0.7)
    got, st = tamplitude.control(torch.from_numpy(x), gain_db, clip, ceiling)
    want, w_st = amplitude.control(jnp.asarray(x), gain_db, clip, ceiling)
    _close(got, want, 1e-6)
    for f in dataclasses.fields(w_st):
        assert abs(float(getattr(st, f.name))
                   - float(getattr(w_st, f.name))) < 1e-4, f.name
    if clip:
        assert float(got.abs().max()) <= 10 ** (ceiling / 20) * (1 + 1e-6)
        assert float(st.clipped_ratio) > 0.0


# --------------------------------------------------------------- timeline
@pytest.mark.parametrize("mu,nfft", [(0, 512), (1, 512), (1, 4096), (2, 256)])
def test_baseband_timeline_locate_matches(mu, nfft):
    tl, w_tl = (tlower_phy.BasebandTimeline(mu, nfft),
                lower_phy.BasebandTimeline(mu, nfft))
    assert tl.slot_sizes == w_tl.slot_sizes
    rng = np.random.default_rng(mu)
    stamps = [*range(0, 3 * tl.sf_samples, 997),
              *rng.integers(0, 50 * tl.sf_samples, 200).tolist()]
    for sc in range(9):
        ts = tl.slot_start_sample(sc)
        assert ts == w_tl.slot_start_sample(sc)
        assert tl.locate(ts) == (sc, 0, 0)
        stamps += [ts - 1, ts, ts + 1]
    for ts in stamps:
        if ts >= 0:
            assert tl.locate(ts) == w_tl.locate(ts), ts


def test_slot_point_matches():
    for mu in (0, 1, 3):
        p, w = tnumerology.SlotPoint(mu, 1023, 3), numerology.SlotPoint(
            mu, 1023, 3)
        for n in (0, 1, 7, 10 << mu, 12345):
            q, wq = p + n, w + n
            assert (q.sfn, q.slot_in_frame, q.count(), q.slot_in_subframe
                    ) == (wq.sfn, wq.slot_in_frame, wq.count(),
                          wq.slot_in_subframe)
        assert (tnumerology.slots_per_subframe(mu),
                tnumerology.slots_per_frame(mu)) == (
            numerology.slots_per_subframe(mu), numerology.slots_per_frame(mu))


# ---------------------------------------------------------------- engines
def test_lower_phy_run_slot_matches():
    """Two slots (slot 1 has the other CP layout at μ=1) through the
    loopback radio with a channel, at a centre frequency (phase
    compensation): the UL grids of both packages."""
    rng = np.random.default_rng(0)
    cfg = dict(mu=1, nfft=256, nof_prb=12, center_freq_hz=3.5e9)
    scale = lambda x: (0.5 - 0.25j) * x
    phy = tlower_phy.LowerPhy(tlower_phy.LowerPhyConfig(**cfg),
                              tlower_phy.LoopbackRadio(scale), "cpu")
    w_phy = lower_phy.LowerPhy(lower_phy.LowerPhyConfig(**cfg),
                               lower_phy.LoopbackRadio(scale))
    for _ in range(2):
        grid = _cplx(rng, (2, 14, 144))
        got = phy.run_slot(torch.from_numpy(grid))
        want = w_phy.run_slot(jnp.asarray(grid))
        _close(got, want, 1e-4)
        _close(got, 0.5 * (1 - 0.5j) * grid, 1e-4)
    assert phy.slot.count() == w_phy.slot.count() == 2
    assert phy.run_slot(None) is None


def test_full_stack_through_lower_phy():
    """A PDSCH through the lower PHY and a noisy loopback radio, back up
    through the PUSCH receiver (the decoder's plain version on the CPU)."""
    rng = np.random.default_rng(1)
    shc = tsch.ShConfig(rnti=0x55, tbs=1608, qm=2, nof_prb=24,
                        dmrs_symbols=(2, 7, 11))
    cfg = tlower_phy.LowerPhyConfig(mu=1, nfft=512, nof_prb=24)
    channel = lambda x: x + torch.from_numpy(_cplx(rng, tuple(x.shape),
                                                   0.02 / np.sqrt(2)))
    phy = tlower_phy.LowerPhy(cfg, tlower_phy.LoopbackRadio(channel), "cpu")
    tb = torch.from_numpy(rng.integers(0, 2, (1, shc.tbs)).astype(np.int8))
    grid = tsch.pdsch_transmit(tb, shc, torch.zeros((1, 14, 288),
                                                    dtype=torch.complex64))
    res = tsch.pusch_receive(phy.run_slot(grid[0])[None, None], shc,
                             nof_ldpc_iterations=8)
    assert bool(res.tb_crc_ok[0]) and torch.equal(res.tb_bits, tb)


@pytest.mark.parametrize("depth,chunk", [(2, 777), (1, 4096), (3, 100)])
def test_async_lower_phy_stream_matches(depth, chunk):
    """pull_tx slices the continuous stream across slot boundaries with
    `depth` slots modulated ahead; push_rx reassembles chunks of any size
    into slot grids: both packages give the same stream, UL grids and
    amplitude statistics, and the grids are the sent ones."""
    cfg = dict(mu=1, nfft=256, nof_prb=12, tx_gain_db=-3.0)
    rng = np.random.default_rng(depth)
    grids = [_cplx(rng, (14, 144)) for _ in range(4)]
    got, want = {}, {}
    eng = tlower_phy.AsyncLowerPhy(
        tlower_phy.LowerPhyConfig(**cfg),
        lambda s: torch.from_numpy(grids[s]) if s < 4 else None,
        lambda s, g: got.__setitem__(s, g), depth=depth, device="cpu")
    w_eng = lower_phy.AsyncLowerPhy(
        lower_phy.LowerPhyConfig(**cfg),
        lambda s: jnp.asarray(grids[s]) if s < 4 else None,
        lambda s, g: want.__setitem__(s, g), depth=depth)
    total = sum(eng.timeline.slot_size(s) for s in range(5))
    pulled = 0
    while pulled < total:
        n = min(chunk, total - pulled)
        bb, w_bb = eng.pull_tx(n), w_eng.pull_tx(n)
        _close(bb, w_bb, 1e-4)
        eng.push_rx(bb)
        w_eng.push_rx(w_bb)
        pulled += n
        if pulled <= sum(eng.timeline.slot_size(s) for s in range(3)):
            for f in dataclasses.fields(w_eng.tx_stats):
                assert abs(float(getattr(eng.tx_stats, f.name))
                           - float(getattr(w_eng.tx_stats, f.name))) < 1e-4
    assert sorted(got) == sorted(want) == [0, 1, 2, 3, 4]
    for s in range(4):
        _close(got[s], want[s], 1e-4)
        _close(got[s], grids[s] * 10 ** (-3.0 / 20), 1e-4)
    assert not got[4].abs().any()


def test_async_lower_phy_amplitude_clipping():
    cfg = tlower_phy.LowerPhyConfig(mu=1, nfft=256, nof_prb=12,
                                    tx_gain_db=20.0)
    g = torch.ones((14, 144), dtype=torch.complex64)
    eng = tlower_phy.AsyncLowerPhy(cfg, lambda s: g, lambda s, gr: None,
                                   depth=1, enable_clipping=True,
                                   ceiling_dbfs=10.0, device="cpu")
    bb = eng.pull_tx(1000)
    assert float(bb.abs().max()) <= 10 ** (10.0 / 20) * 1.001
    assert float(eng.tx_stats.clipped_ratio) > 0.0


# ------------------------------------------------------------------ PRACH
def _tx_long(root, cv, length, prach_fft, cp, nrep, rng, snr_db=10.0,
             k0=0):
    """Time-domain long preamble at delay 0: CP + nrep sequence periods."""
    y = prach.generate_cv(root, cv, length)
    bins = np.zeros(prach_fft, np.complex64)
    bins[(np.arange(length) + k0) % prach_fft] = y
    period = np.fft.ifft(bins) * prach_fft / np.sqrt(length)
    sig = np.concatenate([period[-cp:]] + [period] * nrep)
    sigma = np.sqrt(np.mean(np.abs(sig) ** 2)) * 10 ** (-snr_db / 20)
    return (sig + _cplx(rng, sig.shape, sigma / np.sqrt(2))
            ).astype(np.complex64)


@pytest.mark.parametrize("fmt", sorted(prach_demod.LONG_FORMATS))
@pytest.mark.parametrize("fs", [30.72e6, 122.88e6])
def test_long_format_geometry_matches(fmt, fs):
    assert tprach_demod.LONG_FORMATS == prach_demod.LONG_FORMATS
    assert (tprach_demod.long_format_geometry(fmt, fs)
            == prach_demod.long_format_geometry(fmt, fs))
    if (fmt, fs) == ("0", 122.88e6):
        assert tprach_demod.long_format_geometry(fmt, fs) == (98304, 1,
                                                              12672)


@pytest.mark.parametrize("nrep", [1, 2, 4])
def test_demodulate_long_matches(nrep):
    """Repetition-averaged 839-chip preambles at -3 dB: the same window on
    both sides, and the detector finds the shift at delay 0."""
    rng = np.random.default_rng(nrep)
    length, root, n_cs, prach_fft, cp, v, k0 = 839, 129, 13, 1024, 96, 7, 60
    sig = _tx_long(root, v * n_cs, length, prach_fft, cp, nrep, rng,
                   snr_db=-3.0, k0=k0)
    sig2 = np.stack([sig, sig[::-1].copy()])
    got = tprach_demod.demodulate_long(torch.from_numpy(sig2), prach_fft,
                                       length, k0, cp, nrep)
    _close(got, prach_demod.demodulate_long(jnp.asarray(sig2), prach_fft,
                                            length, k0, cp, nrep), 1e-4)
    if nrep == 1:
        _close(tprach_demod.demodulate(torch.from_numpy(sig2), prach_fft,
                                       length, k0, cp),
               prach_demod.demodulate(jnp.asarray(sig2), prach_fft, length,
                                      k0, cp), 1e-4)
    m, d, _ = tprach.detect(got[:1], root, length, n_cs)
    assert int(torch.argmax(m[0])) == v and float(m[0, v]) > 16.0
    assert abs(float(d[0, v])) < 1.5


@pytest.mark.parametrize("start,slot", [(1300, 1536), (0, 1536), (4000, 777)])
def test_prach_window_assembler_matches(start, slot):
    """A window starting inside one slot and completing in a later one: the
    assembler's window equals the contiguous extraction and the JAX
    assembler's, and completes at the same slot."""
    rng = np.random.default_rng(3)
    length, root, prach_fft, cp = 839, 201, 1024, 120
    sig = _tx_long(root, 0, length, prach_fft, cp, 1, rng, snr_db=20.0)
    stream = np.zeros(8 * slot, np.complex64)
    stream[start:start + len(sig)] = sig
    asm = tprach_demod.PrachWindowAssembler(start, prach_fft, length, 0, cp)
    w_asm = prach_demod.PrachWindowAssembler(start, prach_fft, length, 0, cp)
    assert asm.need == w_asm.need == tprach_demod.prach_window_samples(
        prach_fft, cp)
    with pytest.raises(RuntimeError, match="incomplete"):
        asm.demodulate()
    done = []
    for s in range(8):
        chunk = stream[s * slot:(s + 1) * slot]
        a = asm.feed(torch.from_numpy(chunk))
        assert a == w_asm.feed(jnp.asarray(chunk))
        if a:
            done.append(s)
    assert done[0] == (start + asm.need - 1) // slot
    rx = asm.demodulate()
    _close(rx, w_asm.demodulate(), 1e-4)
    _close(rx, prach_demod.demodulate(jnp.asarray(
        stream[start:start + asm.need]), prach_fft, length, 0, cp), 1e-4)
    m, d, _ = tprach.detect(rx[None], root, length, 0)
    assert float(m[0, 0]) > 30.0 and abs(float(d[0, 0])) < 1.0


# ------------------------------------------------------------ PRACH tables
def test_prach_config_tables_match():
    for name in ("FDD_CONFIGS", "TDD_CONFIGS", "NCS_LONG_UNRESTRICTED",
                 "NCS_LONG_RESTRICTED_A", "NCS_SHORT"):
        got, want = getattr(tprach_config, name), getattr(prach_config, name)
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            assert all(dataclasses.asdict(got[k]) == dataclasses.asdict(
                want[k]) for k in want)
        else:
            assert got == want
    for paired in (True, False):
        for index in range(-1, 257):
            try:
                want = prach_config.prach_configuration(index, paired)
            except ValueError as e:
                with pytest.raises(ValueError) as err:
                    tprach_config.prach_configuration(index, paired)
                assert str(err.value) == str(e)
                continue
            got = tprach_config.prach_configuration(index, paired)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            for sfn in range(17):
                for sf in range(10):
                    assert (tprach_config.prach_slot_match(got, sfn, sf)
                            == prach_config.prach_slot_match(want, sfn, sf))
    for zcz in range(16):
        for fmt in ("0", "3", "A1", "B4"):
            for rs in ("unrestricted", "type_a"):
                assert (tprach_config.ncs_from_zcz(zcz, fmt, rs)
                        == prach_config.ncs_from_zcz(zcz, fmt, rs))
