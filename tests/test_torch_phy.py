"""Parity of the port's symbol path with the JAX package (CPU).

Inputs are made with numpy from a seed and handed to both sides.  Gold
sequences and DM-RS pilots are exact; modulation, soft demapping, channel
estimation, equalisation and OFDM are float32 computations in two
frameworks, compared with the tolerance stated at each comparison.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srsran_project_23_5_tpu.ops import (dmrs, equalizer, estimator, gold,
                                         modulation)
from srsran_project_23_5_tpu.phy.lower import ofdm
from srsran_project_23_5_tpu_torch.ops import dmrs as tdmrs
from srsran_project_23_5_tpu_torch.ops import equalizer as tequalizer
from srsran_project_23_5_tpu_torch.ops import estimator as testimator
from srsran_project_23_5_tpu_torch.ops import gold as tgold
from srsran_project_23_5_tpu_torch.ops import modulation as tmodulation
from srsran_project_23_5_tpu_torch.phy.lower import ofdm as tofdm

torch.set_num_threads(1)


def _cplx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _close(got, want, rel):
    """|got - want| <= rel * max|want| elementwise (float32 across two
    frameworks: different FFT/reduction orders, ~1e-6 relative)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("cinit,length,offset", [
    (0, 64, 0), (1, 1000, 0), (0x4601 << 15, 216216, 0),
    ((1 << 31) - 1, 3276, 0), (123456, 200, 12 * 5)])
def test_gold_sequence_exact(cinit, length, offset):
    want = gold.gold_sequence_np(cinit, length, offset)
    got = tgold.gold_sequence_np(cinit, length, offset)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    dev = np.asarray(gold.gold_sequence(jnp.uint32(cinit), length, offset))
    assert np.array_equal(got, dev)


@pytest.mark.parametrize("prb_start,nof_prb", [(0, 8), (3, 24), (0, 273)])
def test_dmrs_pilots_exact(prb_start, nof_prb):
    cinits = tuple(dmrs.dmrs_cinit(slot, sym, 1, 0)
                   for slot, sym in [(0, 2), (0, 7), (3, 11)])
    assert cinits == tuple(tdmrs.dmrs_cinit(slot, sym, 1, 0)
                           for slot, sym in [(0, 2), (0, 7), (3, 11)])
    want = np.asarray(dmrs.pilot_values(jnp.asarray(cinits, jnp.uint32),
                                        prb_start, nof_prb))
    got = tdmrs.pilot_values(cinits, prb_start, nof_prb, torch.device("cpu"))
    assert got.dtype == torch.complex64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("qm", [2, 4, 6, 8])
def test_modulate_matches(qm):
    rng = np.random.default_rng(qm)
    bits = rng.integers(0, 2, size=(3, 240 * qm)).astype(np.int8)
    want = np.asarray(modulation.modulate(jnp.asarray(bits), qm))
    got = tmodulation.modulate(torch.from_numpy(bits), qm)
    assert got.dtype == torch.complex64
    _close(got, want, 1e-6)
    assert np.array_equal(tmodulation.pam_levels(qm),
                          modulation.pam_levels(qm))


@pytest.mark.parametrize("qm", [2, 4, 6, 8])
def test_demodulate_soft_matches(qm):
    rng = np.random.default_rng(10 + qm)
    bits = rng.integers(0, 2, size=(2, 300 * qm)).astype(np.int8)
    syms = np.asarray(modulation.modulate(jnp.asarray(bits), qm))
    y = (syms + _cplx(rng, syms.shape, 0.01)).astype(np.complex64)
    nv = rng.uniform(0.005, 0.02, size=syms.shape).astype(np.float32)
    want = np.asarray(modulation.demodulate_soft(jnp.asarray(y),
                                                 jnp.asarray(nv), qm))
    got = tmodulation.demodulate_soft(torch.from_numpy(y),
                                      torch.from_numpy(nv), qm)
    _close(got, want, 1e-5)
    assert np.array_equal(got.numpy() <= 0, want <= 0)
    assert np.array_equal(got.numpy()[:, :bits.shape[1]] <= 0, bits == 1)


@pytest.mark.parametrize("nrx,ndmrs", [(1, 3), (2, 3), (2, 1)])
def test_estimate_comb2_matches(nrx, ndmrs):
    rng = np.random.default_rng(20 + nrx + ndmrs)
    npil = 6 * 24
    tx = np.array(dmrs.pilot_values(
        jnp.asarray([dmrs.dmrs_cinit(0, s, 1, 0) for s in (2, 7, 11)][:ndmrs],
                    jnp.uint32), 0, 24))
    # a delayed, slowly varying channel per rx port
    sc = np.arange(npil) * 2
    h = (_cplx(rng, (nrx, 1)) * np.exp(-2j * np.pi * 3.0 * sc / 512)
         ).astype(np.complex64)
    rx = (h[:, None, :] * tx[None] + _cplx(rng, (nrx, ndmrs, npil), 0.05)
          ).astype(np.complex64)
    want = estimator.estimate_comb2(jnp.asarray(rx), jnp.asarray(tx))
    got = testimator.estimate_comb2(torch.from_numpy(rx), torch.from_numpy(tx))
    _close(got.h_alloc, want.h_alloc, 1e-5)
    for name in ("noise_var", "epre", "rsrp", "ta_norm"):
        _close(getattr(got, name), getattr(want, name), 1e-5)


def test_zf_1xn_matches():
    rng = np.random.default_rng(30)
    y = _cplx(rng, (3, 2, 500))
    h = _cplx(rng, (3, 2, 500))
    nv = np.asarray([0.01, 0.02, 0.05], np.float32)
    w_x, w_nv = equalizer.zf_1xn(jnp.asarray(y), jnp.asarray(h),
                                 jnp.asarray(nv))
    g_x, g_nv = tequalizer.zf_1xn(torch.from_numpy(y), torch.from_numpy(h),
                                  torch.from_numpy(nv))
    # per-element relative: x_hat and post_nv scale with 1/|h|^2
    np.testing.assert_allclose(g_x.numpy(), np.asarray(w_x), rtol=1e-5)
    np.testing.assert_allclose(g_nv.numpy(), np.asarray(w_nv), rtol=1e-5)


@pytest.mark.parametrize("nfft,nsc", [(128, 96), (512, 288)])
@pytest.mark.parametrize("fc", [0.0, 3.5e9])
def test_ofdm_matches(nfft, nsc, fc):
    rng = np.random.default_rng(nfft)
    mu = 1
    assert np.array_equal(tofdm.phase_compensation(mu, nfft, 0, fc),
                          ofdm.phase_compensation(mu, nfft, 0, fc))
    grid = _cplx(rng, (2, 14, nsc), np.sqrt(0.5))
    want = np.asarray(ofdm.modulate_slot(jnp.asarray(grid), mu, nfft, 0, fc))
    got = tofdm.modulate_slot(torch.from_numpy(grid), mu, nfft, 0, fc)
    _close(got, want, 1e-5)
    rx = (want + _cplx(rng, want.shape, 0.1)).astype(np.complex64)
    want_g = np.asarray(ofdm.demodulate_slot(jnp.asarray(rx), nsc, mu, nfft,
                                             0, fc))
    got_g = tofdm.demodulate_slot(torch.from_numpy(rx), nsc, mu, nfft, 0, fc)
    _close(got_g, want_g, 1e-5)
    # round trip without noise recovers the grid
    back = tofdm.demodulate_slot(got, nsc, mu, nfft, 0, fc)
    np.testing.assert_allclose(back.numpy(), grid, atol=1e-4)
