"""Parity of the port's UCI-on-PUSCH, PUCCH F2, 4-layer, VRB-interleaved and
time-interpolated shared channel with the JAX package (CPU).

Every input is made with numpy from a seed and handed to both sides.  Bit
domains (tables, encoded fields, grids of bits) must be equal; float
outputs agree within the tolerance stated at each check.  The JAX receiver
on the CPU decodes with its XLA decoder, so decoded bits are compared where
every codeblock converges; the port's plain decoder is held bit-exact
against ``decoder_pallas.decode(interpret=True)`` on the full BG1 graph of
an rv=2 retransmission and of a HARQ-combined buffer.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srsran_project_23_5_tpu.ops import equalizer, estimator, short_block
from srsran_project_23_5_tpu.ops.ldpc import decoder_pallas
from srsran_project_23_5_tpu.phy.upper import pucch, sch, ulsch
from srsran_project_23_5_tpu.ran import numerology, tbs as tbs_mod, vrb_prb
from srsran_project_23_5_tpu_torch import convert
from srsran_project_23_5_tpu_torch.ops import equalizer as tequalizer
from srsran_project_23_5_tpu_torch.ops import estimator as testimator
from srsran_project_23_5_tpu_torch.ops import short_block as tshort_block
from srsran_project_23_5_tpu_torch.ops.ldpc import decoder_cuda
from srsran_project_23_5_tpu_torch.phy.upper import pucch as tpucch
from srsran_project_23_5_tpu_torch.phy.upper import sch as tsch
from srsran_project_23_5_tpu_torch.phy.upper import ulsch as tulsch
from srsran_project_23_5_tpu_torch.ran import vrb_prb as tvrb_prb

torch.set_num_threads(1)


def _awgn(rng, shape, sigma):
    return (sigma / np.sqrt(2) * (rng.standard_normal(shape)
                                  + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, want):
    """Max abs difference over max |reference|."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ short block
@pytest.mark.parametrize("k,e,qm", [(1, 20, 2), (1, 24, 4), (2, 18, 2),
                                    (2, 30, 6), (3, 40, 2), (7, 64, 4),
                                    (11, 100, 2), (11, 20, 2)])
def test_short_block_encode_matches(k, e, qm):
    rng = np.random.default_rng(k * 100 + e)
    bits = rng.integers(0, 2, size=(5, k)).astype(np.int8)
    want = np.asarray(short_block.encode(jnp.asarray(bits), e, qm))
    got = tshort_block.encode(_t(bits), e, qm).numpy()
    assert got.dtype == np.int8 and np.array_equal(got, want)


@pytest.mark.parametrize("k,e", [(3, 40), (7, 64), (11, 100), (11, 20)])
def test_short_block_detect_matches(k, e):
    rng = np.random.default_rng(k + e)
    bits = rng.integers(0, 2, size=(6, k)).astype(np.int8)
    cw = np.asarray(short_block.encode(jnp.asarray(bits), e))
    llr = ((1.0 - 2.0 * cw) * 3.0
           + 2.0 * rng.standard_normal(cw.shape)).astype(np.float32)
    w_bits, w_metric = short_block.detect(jnp.asarray(llr), k, e)
    bits_t, metric = tshort_block.detect(_t(llr), k, e)
    assert np.array_equal(bits_t.numpy(), np.asarray(w_bits))
    assert np.array_equal(bits_t.numpy(), bits)
    # float32 correlation sums in another order: 1e-6 relative
    np.testing.assert_allclose(metric.numpy(), np.asarray(w_metric),
                               rtol=1e-6, atol=1e-7)
    assert np.array_equal(tshort_block.codebook(k), short_block.codebook(k))


# ------------------------------------------------------------ UL-SCH + UCI
def _uci_cfg(qm=4, nof_prb=24, o_ack=2, o_csi1=4, csi2=0, **kw):
    g_ack = 12 * qm
    uci = ulsch.UciOnPusch(
        nof_harq_ack_bits=o_ack, nof_csi_part1_bits=o_csi1,
        nof_csi_part2_bits=csi2,
        g_harq_ack=g_ack if o_ack else 0,
        g_harq_ack_rvd=g_ack if o_ack and o_ack <= 2 else 0,
        g_csi_part1=32 * qm if o_csi1 else 0,
        g_csi_part2=16 * qm if csi2 else 0)
    return sch.ShConfig(rnti=0x4601, tbs=3824, qm=qm, nof_prb=nof_prb,
                        dmrs_symbols=(2, 7, 11), uci=uci, **kw)


@pytest.mark.parametrize("o_ack,o_csi1,csi2", [(2, 4, 0), (1, 0, 0),
                                               (4, 7, 5), (0, 11, 0)])
def test_demux_tables_and_mux_match(o_ack, o_csi1, csi2):
    """The host tables are equal; multiplex and demultiplex give the JAX
    streams bit for bit, punctured positions reading LLR 0."""
    cfg = _uci_cfg(o_ack=o_ack, o_csi1=o_csi1, csi2=csi2)
    tcfg = convert.from_jax_sh(cfg)
    assert tcfg.uci_maps_key == cfg.uci_maps_key
    assert tcfg.g_sch == cfg.g_sch and tcfg.cb_lengths == cfg.cb_lengths
    for f in ("sch", "ack", "csi1", "csi2"):
        assert np.array_equal(tcfg.uci_maps[f], cfg.uci_maps[f]), f
    assert tcfg.uci_maps["total_bits"] == cfg.uci_maps["total_bits"]
    maps = cfg.uci_maps
    rng = np.random.default_rng(1)
    fields = [rng.integers(0, 2, size=(2, len(maps[f]) if f != "sch"
                                       else cfg.g_sch)).astype(np.int8)
              for f in ("sch", "ack", "csi1", "csi2")]
    got = tulsch.multiplex(*(_t(x) for x in fields), tcfg.uci_maps_key)
    for b in range(2):
        want = ulsch.multiplex(*(jnp.asarray(x[b]) for x in fields),
                               cfg.uci_maps_key)
        assert np.array_equal(got[b].numpy(), np.asarray(want))
    llr = rng.standard_normal((2, maps["total_bits"])).astype(np.float32)
    got = tulsch.demultiplex(_t(llr), tcfg.uci_maps_key)
    for b in range(2):
        want = ulsch.demultiplex(jnp.asarray(llr[b]), maps)
        for g, w in zip(got, want):
            assert np.array_equal(g[b].numpy(), np.asarray(w))


@pytest.mark.parametrize("o,g,qm", [(1, 24, 2), (1, 36, 6), (2, 36, 2),
                                    (2, 48, 4), (5, 64, 2), (11, 96, 6)])
def test_uci_field_codec_matches(o, g, qm):
    rng = np.random.default_rng(o * 7 + g)
    bits = rng.integers(0, 2, size=(4, o)).astype(np.int8)
    enc = tulsch.encode_uci_field(_t(bits), o, g, qm).numpy()
    llr = ((1.0 - 2.0 * enc) * 2.0
           + 1.5 * rng.standard_normal(enc.shape)).astype(np.float32)
    got_bits, got_valid = tulsch.decode_uci_field(_t(llr), o, qm)
    for b in range(4):
        want = ulsch.encode_uci_field(jnp.asarray(bits[b]), o, g, qm)
        assert np.array_equal(enc[b], np.asarray(want))
        w_bits, w_valid = ulsch.decode_uci_field(jnp.asarray(llr[b]), o, qm)
        assert np.array_equal(got_bits[b].numpy(), np.asarray(w_bits))
        assert bool(got_valid[b]) == bool(w_valid)
    assert np.array_equal(got_bits.numpy(), bits)


def test_uci_encoded_bits_matches():
    for args in [(2, 0, 2.0, 0.5, 1000, 500, 2), (11, 6, 100.0, 0.1, 100,
                                                 100, 2),
                 (7, 0, 6.25, 1.0, 3824, 3000, 4, 2), (0, 0, 1.0, 1.0, 1, 1,
                                                       2)]:
        assert (tulsch.uci_encoded_bits(*args)
                == ulsch.uci_encoded_bits(*args)), args


@pytest.mark.parametrize("o_ack,o_csi1", [(2, 4), (1, 0), (2, 7), (0, 7)])
def test_uci_on_pusch_loopback_matches(o_ack, o_csi1):
    """Data + ACK + CSI part 1 through both chains on the same rx grid:
    grids equal, LLRs within 1e-5 of max|ref|, the same CRC, TB and UCI."""
    cfg = _uci_cfg(o_ack=o_ack, o_csi1=o_csi1)
    tcfg = convert.from_jax_sh(cfg)
    rng = np.random.default_rng(2)
    tb = rng.integers(0, 2, cfg.tbs).astype(np.int8)
    ack = rng.integers(0, 2, max(o_ack, 1)).astype(np.int8)
    csi1 = rng.integers(0, 2, max(o_csi1, 1)).astype(np.int8)
    nsc = cfg.nof_prb * 12
    want_grid = np.asarray(sch.pusch_transmit(
        jnp.asarray(tb), cfg, jnp.zeros((14, nsc), jnp.complex64),
        ack_bits=jnp.asarray(ack) if o_ack else None,
        csi1_bits=jnp.asarray(csi1) if o_csi1 else None))
    grid = tsch.pusch_transmit(
        _t(tb)[None], tcfg, torch.zeros((1, 14, nsc), dtype=torch.complex64),
        ack_bits=_t(ack)[None] if o_ack else None,
        csi1_bits=_t(csi1)[None] if o_csi1 else None)[0].numpy()
    np.testing.assert_allclose(grid, want_grid, rtol=0, atol=1e-6)

    rx = (want_grid + 0.02 * _cplx(rng, want_grid.shape))[None]
    want = sch.pusch_receive(jnp.asarray(rx), cfg, nof_ldpc_iterations=8)
    w_demod = sch.pusch_demodulate(jnp.asarray(rx), cfg)
    demod = tsch.pusch_demodulate(_t(rx)[None], tcfg)
    for f in ("llr_full", "ack_llr", "csi1_llr"):
        ref = np.asarray(getattr(w_demod, f))
        if ref.size:
            assert _rel(getattr(demod, f)[0].numpy(), ref) < 1e-5, f
    res = tsch.pusch_receive(_t(rx)[None], tcfg, nof_ldpc_iterations=8)
    assert bool(res.tb_crc_ok[0]) and bool(want.tb_crc_ok)
    assert np.array_equal(res.tb_bits[0].numpy(), np.asarray(want.tb_bits))
    assert np.array_equal(res.tb_bits[0].numpy(), tb)
    assert abs(float(res.sinr_db[0]) - float(want.sinr_db)) < 0.05
    for name, n, sent in (("ack", o_ack, ack), ("csi1", o_csi1, csi1)):
        if n:
            bits = getattr(res, f"{name}_bits")[0].numpy()
            assert np.array_equal(bits, np.asarray(getattr(want,
                                                           f"{name}_bits")))
            assert np.array_equal(bits, sent)
            assert bool(getattr(res, f"{name}_valid")[0])
        else:
            assert getattr(res, f"{name}_bits") is None


# ------------------------------------------------------------ PUCCH
@pytest.mark.parametrize("k", [3, 7, 11])
def test_pucch_f2_matches(k):
    rng = np.random.default_rng(3)
    cfg = pucch.PucchF2Config(prb_start=2, nof_prb=4, start_symbol=12,
                              nof_symbols=2, rnti=0x1234, nof_uci_bits=k,
                              slot_in_frame=5)
    tcfg = convert._CONFIGS["PucchF2Config"](cfg)
    assert np.array_equal(tpucch.f2_dmrs_cinits(tcfg),
                          pucch.f2_dmrs_cinits(cfg))
    bits = rng.integers(0, 2, size=(2, k)).astype(np.int8)
    grid = tpucch.pucch_f2_transmit(
        _t(bits), tcfg, torch.zeros((2, 14, 120), dtype=torch.complex64))
    rx = grid.numpy()[:, None] + _awgn(rng, (2, 2, 14, 120), 10 ** (-0.5))
    res = tpucch.pucch_f2_receive(_t(rx), tcfg)
    for b in range(2):
        want = np.asarray(pucch.pucch_f2_transmit(
            jnp.asarray(bits[b]), cfg, jnp.zeros((14, 120), jnp.complex64)))
        # pilots and QPSK points: a float32 rounding of 1/√2 at most
        np.testing.assert_allclose(grid[b].numpy(), want, rtol=0, atol=1e-7)
        w = pucch.pucch_f2_receive(jnp.asarray(rx[b]), cfg)
        assert np.array_equal(res.uci_bits[b].numpy(), np.asarray(w.uci_bits))
        assert np.array_equal(res.uci_bits[b].numpy(), bits[b])
        assert bool(res.detected[b]) == bool(w.detected) and bool(w.detected)
        assert abs(float(res.metric[b]) - float(w.metric)) < 1e-5


def test_pucch_f1_slot_sequences_match():
    rng = np.random.default_rng(4)
    cfg = pucch.PucchF1Config(prb=3, initial_cyclic_shift=5, occ_index=1,
                              n_id=17, slot_in_frame=7, nof_harq_bits=2)
    tcfg = convert._CONFIGS["PucchF1Config"](cfg)
    for a, b in zip(tpucch.f1_slot_seqs(tcfg), pucch.f1_slot_seqs(cfg)):
        assert np.array_equal(a, b)
    # the slot-7 sequences passed to a slot-0 config act as the slot-7 config
    norm = dataclasses.replace(tcfg, slot_in_frame=0)
    seqs = tpucch.f1_slot_seqs_on(tcfg, torch.device("cpu"))
    bits = _t(np.array([[1, 0]], np.int8))
    z = torch.zeros((1, 14, 72), dtype=torch.complex64)
    grid = tpucch.pucch_f1_transmit(bits, norm, z, seqs=seqs)
    assert torch.equal(grid, tpucch.pucch_f1_transmit(bits, tcfg, z))
    want = np.asarray(pucch.pucch_f1_transmit(
        jnp.asarray([1, 0], jnp.int8), cfg, jnp.zeros((14, 72),
                                                      jnp.complex64)))
    np.testing.assert_allclose(grid[0].numpy(), want, rtol=0, atol=1e-6)
    rx = grid.numpy()[:, None] + _awgn(rng, (1, 1, 14, 72), 0.3)
    r = tpucch.pucch_f1_detect(_t(rx), norm, seqs=seqs)
    w = pucch.pucch_f1_detect(jnp.asarray(rx[0]), cfg)
    assert np.array_equal(r.bits[0].numpy(), np.asarray(w.bits))
    assert abs(float(r.detection_metric[0]) - float(w.detection_metric)) \
        < 1e-4 * float(w.detection_metric)


# ------------------------------------------------------------ estimators
def test_estimate_port_matches():
    rng = np.random.default_rng(5)
    sc = np.arange(25, 73, 3)                      # F2 DM-RS comb
    rx, tx = _cplx(rng, (2, 2, len(sc))), _cplx(rng, (2, len(sc)))
    want = estimator.estimate_port(jnp.asarray(rx), jnp.asarray(tx), sc,
                                   120, 14)
    got = testimator.estimate_port(_t(rx), _t(tx), sc, 120, 14)
    # linear interpolation and extrapolation in float32: 1e-5 of max|ref|
    assert _rel(got.h.numpy(), want.h) < 1e-5
    for f in ("noise_var", "epre", "rsrp"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5)


def test_estimate_comb2_time_interp_matches():
    rng = np.random.default_rng(6)
    rx, tx = _cplx(rng, (2, 3, 60)), _cplx(rng, (3, 60))
    want = estimator.estimate_comb2(jnp.asarray(rx), jnp.asarray(tx),
                                    time_interp=True)
    got = testimator.estimate_comb2(_t(rx), _t(tx), time_interp=True)
    assert got.h_dmrs.shape == (2, 3, 120)
    # derotation phases in float32: 1e-5 of max|ref|
    assert _rel(got.h_dmrs.numpy(), want.h_dmrs) < 1e-5
    assert _rel(got.h_alloc.numpy(), want.h_alloc) < 1e-5


def test_estimate_comb2_occ2_cdm_group1_matches():
    rng = np.random.default_rng(7)
    rx, tx = _cplx(rng, (4, 3, 48)), _cplx(rng, (3, 48))
    want = estimator.estimate_comb2_occ2(jnp.asarray(rx), jnp.asarray(tx),
                                         sc_offset=1)
    got = testimator.estimate_comb2_occ2(_t(rx), _t(tx), sc_offset=1)
    assert _rel(got.h_alloc.numpy(), want.h_alloc) < 1e-5
    np.testing.assert_allclose(got.noise_var.numpy(),
                               np.asarray(want.noise_var), rtol=1e-5)


def test_zf_nx4_matches():
    rng = np.random.default_rng(8)
    y, h = _cplx(rng, (6, 500)), _cplx(rng, (6, 4, 500))
    want_x, want_nv = equalizer.zf_nx4(jnp.asarray(y), jnp.asarray(h), 0.1)
    x, nv = tequalizer.zf_nx4(_t(y)[None], _t(h)[None], torch.tensor([0.1]))
    # Schur-block inverse in float32 on random (some ill-conditioned) REs
    assert _rel(x[0].numpy(), want_x) < 1e-4
    assert _rel(nv[0].numpy(), want_nv) < 1e-4
    # against the exact solve on the well-conditioned REs
    g = np.einsum("rlk,rmk->klm", h.conj(), h)
    cond = np.linalg.cond(g)
    exact = np.linalg.solve(g, np.einsum("rlk,rk->kl", h.conj(), y)[..., None])
    good = cond < 100
    np.testing.assert_allclose(x[0].numpy().T[good], exact[good, :, 0],
                               rtol=1e-3, atol=1e-4)


# ------------------------------------------------------------ 4 layers
def _mimo_cfg(nof_layers, nof_prb=24, qm=4, rate=0.4):
    tbs = tbs_mod.tbs_calculate(14, 36, 0, rate, qm, nof_layers, nof_prb)
    return sch.ShConfig(rnti=0x4601, tbs=tbs, qm=qm, nof_prb=nof_prb,
                        nof_layers=nof_layers, dmrs_symbols=(2, 7, 11))


@pytest.mark.parametrize("nrx", [4, 6])
def test_four_layer_loopback_matches(nrx):
    cfg = _mimo_cfg(4)
    tcfg = convert.from_jax_sh(cfg)
    rng = np.random.default_rng(9)
    tb = rng.integers(0, 2, size=cfg.tbs).astype(np.int8)
    nsc = cfg.nof_prb * 12
    want_grid = np.asarray(sch.pdsch_transmit(
        jnp.asarray(tb), cfg, jnp.zeros((4, 14, nsc), jnp.complex64)))
    grid = tsch.pdsch_transmit(
        _t(tb)[None], tcfg, torch.zeros((1, 4, 14, nsc),
                                        dtype=torch.complex64))[0].numpy()
    np.testing.assert_allclose(grid, want_grid, rtol=0, atol=1e-6)
    h = np.linalg.qr(_cplx(rng, (nrx, 4)))[0].astype(np.complex64)
    rx = (np.einsum("rt,tsk->rsk", h, want_grid)
          + _awgn(rng, (nrx, 14, nsc), 0.05)).astype(np.complex64)
    w_demod = sch.pusch_demodulate(jnp.asarray(rx), cfg)
    demod = tsch.pusch_demodulate(_t(rx)[None], tcfg)
    assert _rel(demod.llr_full[0].numpy(), w_demod.llr_full) < 1e-4
    want = sch.pusch_receive(jnp.asarray(rx), cfg, nof_ldpc_iterations=8)
    res = tsch.pusch_receive(_t(rx)[None], tcfg, nof_ldpc_iterations=8)
    assert bool(res.tb_crc_ok[0]) and bool(want.tb_crc_ok)
    assert np.array_equal(res.tb_bits[0].numpy(), tb)
    assert np.array_equal(res.tb_bits[0].numpy(), np.asarray(want.tb_bits))
    assert abs(float(res.sinr_db[0]) - float(want.sinr_db)) < 0.05
    if nrx == 4:
        # a unitary channel keeps post-ZF SINR at the per-RE SNR (~26 dB)
        assert abs(float(res.sinr_db[0]) - 26.0) < 2.0


# ------------------------------------------------------------ VRB → PRB
def test_vrb_prb_tables_match():
    for n in (24, 51, 52, 106, 273):
        assert np.array_equal(tvrb_prb.interleaved_vrb_to_prb(n, 2),
                              vrb_prb.interleaved_vrb_to_prb(n, 2))
        assert np.array_equal(tvrb_prb.prb_to_vrb(n, 2),
                              vrb_prb.prb_to_vrb(n, 2))
    cfg = sch.ShConfig(rnti=1, tbs=4096, qm=4, prb_start=4, nof_prb=20,
                       vrb_to_prb_interleaved=True, bwp_nof_prb=52)
    tcfg = convert.from_jax_sh(cfg)
    for a, b in zip(tcfg.vrb_sc_maps, cfg.vrb_sc_maps):
        assert np.array_equal(a, b)


def test_vrb_interleaved_loopback_matches():
    rng = np.random.default_rng(10)
    kw = dict(rnti=0x4601, tbs=4096, qm=4, nof_prb=52,
              dmrs_symbols=(2, 7, 11))
    cfg = sch.ShConfig(**kw, vrb_to_prb_interleaved=True)
    tcfg = convert.from_jax_sh(cfg)
    tcfg_n = convert.from_jax_sh(sch.ShConfig(**kw))
    tb = rng.integers(0, 2, size=4096).astype(np.int8)
    want_grid = np.asarray(sch.pdsch_transmit(
        jnp.asarray(tb), cfg, jnp.zeros((14, 624), jnp.complex64)))
    grid = tsch.pdsch_transmit(
        _t(tb)[None], tcfg, torch.zeros((1, 14, 624),
                                        dtype=torch.complex64))[0].numpy()
    np.testing.assert_allclose(grid, want_grid, rtol=0, atol=1e-6)
    rx = (want_grid + _awgn(rng, (14, 624), 0.03))[None]
    want = sch.pusch_receive(jnp.asarray(rx), cfg, 6)
    res = tsch.pusch_receive(_t(rx)[None], tcfg, 6)
    assert bool(res.tb_crc_ok[0]) and bool(want.tb_crc_ok)
    assert np.array_equal(res.tb_bits[0].numpy(), tb)
    assert abs(float(res.sinr_db[0]) - float(want.sinr_db)) < 0.05
    # a receiver that skips the de-interleave does not decode
    assert not bool(tsch.pusch_receive(_t(rx)[None], tcfg_n, 6).tb_crc_ok[0])
    # the UE-side symbol check de-interleaves both grids
    match, _, _ = tsch.symbol_verify(_t(rx)[None], _t(want_grid)[None], tcfg)
    assert float(match[0]) > 0.99


# ------------------------------------------------------------ time interp
def test_time_interp_pusch_matches_under_phase_drift():
    """A 300 Hz phase drift: per-symbol interpolation decodes in both
    packages with LLRs within 1e-4 of max|ref|; the average estimator of the
    port fails like the JAX one."""
    nof_prb, qm = 52, 6
    tbs = tbs_mod.tbs_calculate(14, 36, 0, 0.65, qm, 1, nof_prb)
    cfg = sch.ShConfig(rnti=0x4601, tbs=tbs, qm=qm, nof_prb=nof_prb,
                       dmrs_symbols=(2, 7, 11), time_interp=True)
    tcfg = convert.from_jax_sh(cfg)
    rng = np.random.default_rng(11)
    tb = rng.integers(0, 2, size=tbs).astype(np.int8)
    grid = np.asarray(sch.pdsch_transmit(
        jnp.asarray(tb), cfg, jnp.zeros((14, nof_prb * 12), jnp.complex64)))
    nfft = numerology.min_nfft(nof_prb)
    fs = numerology.sample_rate_hz(1, nfft)
    starts = np.cumsum([0] + [nfft + int(c) for c in
                              numerology.cp_lengths(1, nfft, 0)])
    rot = np.exp(2j * np.pi * 300.0 * starts[:14] / fs).astype(np.complex64)
    rx = (grid * rot[:, None]
          + _awgn(rng, grid.shape, 10 ** (-22.0 / 20)))[None]
    w_demod = sch.pusch_demodulate(jnp.asarray(rx), cfg)
    demod = tsch.pusch_demodulate(_t(rx)[None], tcfg)
    assert _rel(demod.llr_full[0].numpy(), w_demod.llr_full) < 1e-4
    want = sch.pusch_receive(jnp.asarray(rx), cfg, 8)
    res = tsch.pusch_receive(_t(rx)[None], tcfg, 8)
    assert bool(res.tb_crc_ok[0]) and bool(want.tb_crc_ok)
    assert np.array_equal(res.tb_bits[0].numpy(), tb)
    assert abs(float(res.sinr_db[0]) - float(want.sinr_db)) < 0.05
    avg = dataclasses.replace(tcfg, time_interp=False)
    assert not bool(tsch.pusch_receive(_t(rx)[None], avg, 8).tb_crc_ok[0])


# ------------------------------------------------------------ full graph
def test_decode_plain_full_bg1_graph_rv2_matches_pallas_interpret():
    """rv=2 and rv=0+rv=2 combined buffers read the whole circular buffer:
    the decoder runs the full BG1 graph (68 blocks, 316 edges), the shape
    the CUDA kernel keeps c2v in device memory for at Z > 302."""
    cfg = sch.ShConfig(rnti=7, tbs=480, qm=2, nof_prb=2, rv=2,
                       dmrs_symbols=(2, 7, 11))
    seg = cfg.segments
    assert (seg.base_graph, seg.lifting_size) == (1, 24)
    tcfg = convert.from_jax_sh(cfg)
    assert tsch.used_blocks(tcfg) is None
    rng = np.random.default_rng(12)
    tb = torch.from_numpy(rng.integers(0, 2, size=(1, 480)).astype(np.int8))
    llrs = []
    for rv in (0, 2):
        c = dataclasses.replace(tcfg, rv=rv)
        g = tsch.pdsch_transmit(tb, c, torch.zeros((1, 14, 24),
                                                   dtype=torch.complex64))
        rx = g.numpy() + _awgn(rng, g.shape, 10 ** (-4.0 / 20))
        llrs.append(tsch.pusch_demodulate(_t(rx)[:, None], c).llr_full[0])
    combined = llrs[0] + llrs[1]
    llr = torch.cat([llrs[1], combined]).contiguous()       # [2, 68*24]
    assert llr.shape == (2, 68 * 24)
    w_bits, w_ok = decoder_pallas.decode(jnp.asarray(llr.numpy()), 1, 24, 6,
                                         interpret=True)
    bits, ok = decoder_cuda.decode_plain(llr, 1, 24, 6)
    assert np.array_equal(ok.numpy(), np.asarray(w_ok))
    assert np.array_equal(bits.numpy(), np.asarray(w_bits))
