"""Parity of the port's control channels with the JAX package (CPU): TBS,
polar code construction and codec, sequences, PDCCH, SSB, CSI-RS, PUCCH F1
and PRACH.

Inputs are made with numpy from a seed and handed to both sides.  The host
tables, the polar codec and the coded bits are exact; grids and detector
metrics are float32 computations in two frameworks, compared with the
tolerance stated at each comparison, and their hard decisions must agree.
The port works on a leading slot batch, the JAX functions on one slot, so
every batched port call is held against the JAX function slot by slot.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srsran_project_23_5_tpu.ops import modulation, prach, sequences
from srsran_project_23_5_tpu.ops.polar import code as pcode
from srsran_project_23_5_tpu.ops.polar import decoder as pdec
from srsran_project_23_5_tpu.ops.polar import encoder as penc
from srsran_project_23_5_tpu.ops.polar import rate_match as prm
from srsran_project_23_5_tpu.phy.upper import csi_rs, pdcch, pucch, ssb
from srsran_project_23_5_tpu.ran import tbs
from srsran_project_23_5_tpu_torch.ops import modulation as tmodulation
from srsran_project_23_5_tpu_torch.ops import prach as tprach
from srsran_project_23_5_tpu_torch.ops import sequences as tsequences
from srsran_project_23_5_tpu_torch.ops.polar import code as tpcode
from srsran_project_23_5_tpu_torch.ops.polar import decoder as tpdec
from srsran_project_23_5_tpu_torch.ops.polar import encoder as tpenc
from srsran_project_23_5_tpu_torch.ops.polar import rate_match as tprm
from srsran_project_23_5_tpu_torch.phy.upper import csi_rs as tcsi_rs
from srsran_project_23_5_tpu_torch.phy.upper import pdcch as tpdcch
from srsran_project_23_5_tpu_torch.phy.upper import pucch as tpucch
from srsran_project_23_5_tpu_torch.phy.upper import ssb as tssb
from srsran_project_23_5_tpu_torch.ran import tbs as ttbs

torch.set_num_threads(1)

# (K, E): the PDCCH at AL4 (K = 40 + 24 CRC bits, puncturing) and the PBCH
# (repetition); (20, 40) adds shortening
_CODES = [(64, 432), (56, 864), (20, 40)]
# grids are float32 QAM/pilot values of magnitude ≤ 1 on both sides
_GRID_ATOL = 1e-6


def _bits(rng, shape):
    return rng.integers(0, 2, size=shape).astype(np.int8)


def _cplx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _grid_close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=_GRID_ATOL)
    for part in (np.real, np.imag):
        assert np.array_equal(np.sign(part(got)), np.sign(part(want)))


# ------------------------------------------------------------ host tables
def test_tbs_calculate_exact():
    rng = np.random.default_rng(0)
    cases = [(13, 12, 0, 0.6533, 6, 2, 136), (13, 0, 0, 0.6533, 6, 1, 117),
             (14, 36, 0, 0.5, 2, 2, 34), (12, 18, 6, 0.19, 4, 1, 273),
             (4, 6, 0, 0.1, 2, 1, 1)]
    cases += [(int(rng.integers(2, 15)), int(rng.integers(0, 24)),
               int(rng.integers(0, 3)) * 6, float(rng.uniform(0.05, 0.93)),
               int(rng.choice([2, 4, 6, 8])), int(rng.integers(1, 5)),
               int(rng.integers(1, 274))) for _ in range(200)]
    for c in cases:
        assert ttbs.tbs_calculate(*c) == tbs.tbs_calculate(*c), c
    assert ttbs.TBS_TABLE == tbs.TBS_TABLE


@pytest.mark.parametrize("k,e", _CODES + [(30, 100), (140, 200)])
def test_polar_code_exact(k, e):
    want = pcode.polar_code(k, e, nmax_log=9)
    got = tpcode.polar_code(k, e, nmax_log=9)
    for f in ("k", "e", "n", "mode", "info_set", "frozen_mask"):
        assert getattr(got, f) == getattr(want, f), f
    assert np.array_equal(tpcode.subblock_interleaver(got.n),
                          pcode.subblock_interleaver(want.n))
    assert np.array_equal(tpcode.reliability_sequence(got.n),
                          pcode.reliability_sequence(want.n))


@pytest.mark.parametrize("k", [25, 56, 64, 164])
def test_input_interleaver_exact(k):
    assert np.array_equal(tpcode.input_interleaver(k),
                          pcode.input_interleaver(k))


@pytest.mark.parametrize("m_zc", [6, 12, 24, 36, 72, 144])
def test_sequences_exact(m_zc):
    for u in range(30):
        for v in (0, 1):
            assert np.array_equal(tsequences.low_papr_sequence(u, v, m_zc),
                                  sequences.low_papr_sequence(u, v, m_zc))
        assert np.array_equal(tsequences.cyclic_shifted(u, 0, m_zc, 0.7),
                              sequences.cyclic_shifted(u, 0, m_zc, 0.7))
    assert (tsequences.prime_lower_than(m_zc)
            == sequences.prime_lower_than(m_zc))
    for root in (1, 22, 138):
        assert np.array_equal(tsequences.zadoff_chu(root, 139),
                              sequences.zadoff_chu(root, 139))


def test_bpsk_modulate_matches():
    bits = _bits(np.random.default_rng(1), (3, 40))
    want = np.asarray(modulation.modulate(jnp.asarray(bits), 1))
    got = tmodulation.modulate(torch.from_numpy(bits), 1).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- polar codec
@pytest.mark.parametrize("k,e", _CODES)
def test_polar_encode_match_exact(k, e):
    code = pcode.polar_code(k, e, nmax_log=9)
    rng = np.random.default_rng(k)
    info = _bits(rng, (4, k))
    u = np.asarray(penc.allocate(jnp.asarray(info), code.info_set, code.n))
    tu = tpenc.allocate(torch.from_numpy(info), code.info_set, code.n)
    assert np.array_equal(tu.numpy(), u)
    x = np.asarray(penc.encode(jnp.asarray(u)))
    tx = tpenc.encode(tu)
    assert np.array_equal(tx.numpy(), x)
    assert np.array_equal(tprm.match(tx, code).numpy(),
                          np.asarray(prm.match(jnp.asarray(x), code)))
    assert np.array_equal(tpenc.extract_message(tu, code.info_set).numpy(),
                          info)


@pytest.mark.parametrize("k,e", _CODES)
def test_polar_dematch_matches(k, e):
    code = pcode.polar_code(k, e, nmax_log=9)
    llr = np.random.default_rng(e).standard_normal((3, e)).astype(np.float32)
    want = np.asarray(prm.dematch(jnp.asarray(llr), code))
    got = tprm.dematch(torch.from_numpy(llr), code).numpy()
    # a set or a sum of at most three float32 copies
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k,e", _CODES)
@pytest.mark.parametrize("snr_db", [1.0, 4.0])
def test_polar_ssc_decode_bits_exact(k, e, snr_db):
    code = pcode.polar_code(k, e, nmax_log=9)
    rng = np.random.default_rng(int(10 * snr_db) + k)
    info = _bits(rng, (6, k))
    x = tpenc.encode(tpenc.allocate(torch.from_numpy(info), code.info_set,
                                    code.n))
    tx = tprm.match(x, code).numpy().astype(np.float32)
    sigma = 10 ** (-snr_db / 20)
    llr = (2 * ((1 - 2 * tx) + sigma * rng.standard_normal(tx.shape))
           / sigma ** 2).astype(np.float32)
    cw = np.asarray(prm.dematch(jnp.asarray(llr), code))
    want = np.asarray(jax.jit(lambda a: pdec.decode(a, code))(jnp.asarray(cw)))
    got = tpdec.decode(tprm.dematch(torch.from_numpy(llr), code), code)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)


# ------------------------------------------------------------------ PDCCH
_PDCCH = [pdcch.PdcchConfig(rnti=0x4601, payload_size=40, cce_index=0),
          pdcch.PdcchConfig(rnti=0x4602, payload_size=40, cce_index=4,
                            n_id=7, n_rnti=3),
          pdcch.PdcchConfig(rnti=0x17, payload_size=24, aggregation_level=2,
                            cce_index=1, coreset_start_prb=6)]


def _tpdcch(cfg):
    return tpdcch.PdcchConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(tpdcch.PdcchConfig)})


@pytest.mark.parametrize("idx", range(len(_PDCCH)))
def test_encode_dci_exact(idx):
    cfg = _PDCCH[idx]
    dci = _bits(np.random.default_rng(idx), (3, cfg.payload_size))
    got = tpdcch.encode_dci(torch.from_numpy(dci), _tpdcch(cfg)).numpy()
    for b in range(3):
        want = np.asarray(pdcch.encode_dci(jnp.asarray(dci[b]), cfg))
        assert np.array_equal(got[b], want)


@pytest.mark.parametrize("idx", range(len(_PDCCH)))
def test_pdcch_transmit_grid_matches(idx):
    cfg = _PDCCH[idx]
    rng = np.random.default_rng(10 + idx)
    dci = _bits(rng, (2, cfg.payload_size))
    base = _cplx(rng, (2, 14, 816))      # set, not add: the base is replaced
    got = tpdcch.pdcch_transmit(torch.from_numpy(dci), _tpdcch(cfg),
                                torch.from_numpy(base))
    for b in range(2):
        want = pdcch.pdcch_transmit(jnp.asarray(dci[b]), cfg,
                                    jnp.asarray(base[b]))
        _grid_close(got[b], want)


@pytest.mark.parametrize("snr_db", [-1.0, 2.0, 8.0])
def test_decode_dci_llr_matches(snr_db):
    cfg = _PDCCH[0]
    rng = np.random.default_rng(int(snr_db) + 50)
    dci = _bits(rng, (4, cfg.payload_size))
    tcfg = _tpdcch(cfg)
    seq = tpdcch._tables(tcfg, torch.device("cpu"))[0].numpy()
    coded = tpdcch.encode_dci(torch.from_numpy(dci), tcfg).numpy() ^ seq
    sigma = 10 ** (-snr_db / 20)
    llr = (2 * ((1 - 2 * coded.astype(np.float32))
                + sigma * rng.standard_normal(coded.shape)) / sigma ** 2
           ).astype(np.float32)
    got = tpdcch.decode_dci_llr(torch.from_numpy(llr), tcfg)
    dec = jax.jit(lambda a: tuple(vars(pdcch.decode_dci_llr(a, cfg))
                                  .values()))
    for b in range(4):
        payload, crc_ok = dec(jnp.asarray(llr[b]))
        assert np.array_equal(got.payload[b].numpy(), np.asarray(payload))
        assert bool(got.crc_ok[b]) == bool(crc_ok)
    if snr_db > 5:
        assert bool(got.crc_ok.all()) and np.array_equal(
            got.payload.numpy(), dci)


# -------------------------------------------------------------------- SSB
_SSB = [ssb.SsbConfig(pci=123), ssb.SsbConfig(pci=0, ssb_idx=3, sfn=6),
        ssb.SsbConfig(pci=1007, ssb_idx=1, lmax=4, hrf=1, sfn=5)]


def _tssb(cfg):
    return tssb.SsbConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("idx", range(len(_SSB)))
def test_pbch_encode_exact(idx):
    cfg = _SSB[idx]
    payload = _bits(np.random.default_rng(idx), (3, 32))
    got = tssb.pbch_encode(torch.from_numpy(payload), _tssb(cfg)).numpy()
    for b in range(3):
        assert np.array_equal(
            got[b], np.asarray(ssb.pbch_encode(jnp.asarray(payload[b]), cfg)))
    assert np.array_equal(tssb.pss_sequence(cfg.nid2),
                          ssb.pss_sequence(cfg.nid2))
    assert np.array_equal(tssb.sss_sequence(cfg.nid1, cfg.nid2),
                          ssb.sss_sequence(cfg.nid1, cfg.nid2))
    np.testing.assert_allclose(tssb.dmrs_pbch_pilots(_tssb(cfg), "cpu").numpy(),
                               np.asarray(ssb.dmrs_pbch_pilots(cfg)),
                               rtol=0, atol=_GRID_ATOL)


@pytest.mark.parametrize("idx", range(len(_SSB)))
def test_ssb_assemble_matches(idx):
    cfg = _SSB[idx]
    payload = _bits(np.random.default_rng(20 + idx), (2, 32))
    got = tssb.ssb_assemble(torch.from_numpy(payload), _tssb(cfg))
    for b in range(2):
        _grid_close(got[b], ssb.ssb_assemble(jnp.asarray(payload[b]), cfg))


# ----------------------------------------------------------------- CSI-RS
@pytest.mark.parametrize("row,offset,prb_start", [(1, 1, 0), (2, 0, 0),
                                                  (2, 3, 5), (4, 4, 2)])
def test_csi_rs_generate_matches(row, offset, prb_start):
    cfg = csi_rs.CsiRsConfig(row=row, prb_start=prb_start, nof_prb=20,
                             symbol=5, subcarrier_offset=offset,
                             scrambling_id=9, slot_in_frame=3)
    tcfg = tcsi_rs.CsiRsConfig(**dataclasses.asdict(cfg))
    base = _cplx(np.random.default_rng(row), (2, 14, 360))
    got = tcsi_rs.generate(tcfg, torch.from_numpy(base))
    for b in range(2):
        _grid_close(got[b], csi_rs.generate(cfg, jnp.asarray(base[b])))


# ---------------------------------------------------------------- PUCCH F1
_PUCCH = [pucch.PucchF1Config(prb=66, nof_harq_bits=1),
          pucch.PucchF1Config(prb=3, nof_harq_bits=2, initial_cyclic_shift=3,
                              occ_index=1, n_id=17, slot_in_frame=5),
          pucch.PucchF1Config(prb=10, start_symbol=4, nof_symbols=10,
                              nof_harq_bits=1, n_id=2)]


def _tpucch(cfg):
    return tpucch.PucchF1Config(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("idx", range(len(_PUCCH)))
def test_pucch_f1_transmit_matches(idx):
    cfg = _PUCCH[idx]
    rng = np.random.default_rng(30 + idx)
    ack = _bits(rng, (2, cfg.nof_harq_bits))
    base = _cplx(rng, (2, 14, 816))
    got = tpucch.pucch_f1_transmit(torch.from_numpy(ack), _tpucch(cfg),
                                   torch.from_numpy(base))
    for b in range(2):
        _grid_close(got[b], pucch.pucch_f1_transmit(
            jnp.asarray(ack[b]), cfg, jnp.asarray(base[b])))


@pytest.mark.parametrize("idx", range(len(_PUCCH)))
@pytest.mark.parametrize("amplitude", [1.0, 0.0])
def test_pucch_f1_detect_matches(idx, amplitude):
    """Two distinct slots, two rx ports, noisy: the port sums over the rx
    ports of each slot, the JAX function over axis 0 of one slot.  With
    amplitude 0 the grid is noise only (DTX)."""
    cfg = _PUCCH[idx]
    rng = np.random.default_rng(40 + idx)
    ack = _bits(rng, (2, cfg.nof_harq_bits))
    tx = tpucch.pucch_f1_transmit(
        torch.from_numpy(ack), _tpucch(cfg),
        torch.zeros((2, 14, 816), dtype=torch.complex64)).numpy()
    h = _cplx(rng, (2, 2, 1, 1), 0.7)
    rx = (amplitude * h * tx[:, None] + _cplx(rng, (2, 2, 14, 816), 0.2)
          ).astype(np.complex64)
    got = tpucch.pucch_f1_detect(torch.from_numpy(rx), _tpucch(cfg))
    for b in range(2):
        want = pucch.pucch_f1_detect(jnp.asarray(rx[b]), cfg)
        assert np.array_equal(got.bits[b].numpy(), np.asarray(want.bits))
        assert bool(got.detected[b]) == bool(want.detected)
        np.testing.assert_allclose(float(got.detection_metric[b]),
                                   float(want.detection_metric), rtol=1e-4)
        assert bool(got.detected[b]) == (amplitude > 0)
    if amplitude > 0:
        assert np.array_equal(got.bits.numpy(), ack)


# ------------------------------------------------------------------ PRACH
@pytest.mark.parametrize("root,ncs,preamble,delay", [
    (22, 13, 3, 2), (1, 0, 0, 5), (100, 26, 4, 10)])
def test_prach_detect_matches(root, ncs, preamble, delay):
    rng = np.random.default_rng(root)
    assert np.array_equal(tprach.root_sequence_freq(root, 139),
                          prach.root_sequence_freq(root, 139))
    pre = tprach.generate(root, preamble, 139, ncs)
    assert np.array_equal(pre, prach.generate(root, preamble, 139, ncs))
    assert tprach.unrestricted_cv(139, ncs) == prach.unrestricted_cv(139, ncs)
    k = np.arange(139)
    # two slots × two rx ports, a delay of `delay` chips on slot 1
    ramp = np.stack([np.ones(139), np.exp(-2j * np.pi * delay * k / 139)])
    rx = (pre * ramp[:, None, :] * np.asarray([1.0, 0.6 - 0.3j])[:, None]
          + _cplx(rng, (2, 2, 139), 0.3)).astype(np.complex64)
    metric, delays, rssi = tprach.detect(torch.from_numpy(rx), root, 139, ncs)
    w_metric, w_delays, w_rssi = prach.detect(jnp.asarray(rx), root, 139, ncs)
    np.testing.assert_allclose(metric.numpy(), np.asarray(w_metric),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(delays.numpy(), np.asarray(w_delays),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(rssi.numpy(), np.asarray(w_rssi), rtol=1e-5)
    m = metric.mean(dim=1)
    assert np.array_equal(torch.argmax(m, dim=-1).numpy(),
                          np.argmax(np.asarray(w_metric).mean(axis=1),
                                    axis=-1))
    assert (torch.argmax(m, dim=-1) == preamble).all()


def test_prach_refuses_restricted_set():
    """Restricted set A is ported; a root with no restricted-A shifts at
    N_cs and an unknown set name are refused."""
    rx = torch.zeros((1, 139), dtype=torch.complex64)
    metric, _, _ = tprach.detect(rx, 22, 139, 13, restricted_set="type_a")
    assert metric.shape == (1, len(prach.restricted_a_cv(139, 13, 22)))
    with pytest.raises(ValueError, match="no restricted-A shifts"):
        tprach.detect(rx, 1, 139, 13, restricted_set="type_a")
    with pytest.raises(ValueError, match="restricted set"):
        tprach.detect(rx, 22, 139, 13, restricted_set="type_b")
