"""Parity of the port's receive side with the JAX package (CPU): the PDCCH
on interleaved and 1-3-symbol CORESETs (mapping, static receive, blind
receive over candidate CCEs), the PBCH decode and the SSB receiver, and the
PRACH restricted set A and the 839-chip long sequence.

Inputs are made with numpy from a seed and handed to both sides; the port
takes a leading slot batch, so every batched port call is held against the
JAX function slot by slot.  Bits, indices and verdicts are equal; grids
within 1e-6 (QAM and pilot values of magnitude ≤ 1); detector metrics,
LLRs and delays within 1e-4 of max|ref|.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srsran_project_23_5_tpu.ops import prach
from srsran_project_23_5_tpu.phy.upper import pdcch, ssb
from srsran_project_23_5_tpu_torch import convert
from srsran_project_23_5_tpu_torch.ops import prach as tprach
from srsran_project_23_5_tpu_torch.phy.upper import pdcch as tpdcch
from srsran_project_23_5_tpu_torch.phy.upper import ssb as tssb

torch.set_num_threads(1)

B = 2


def _bits(rng, shape):
    return rng.integers(0, 2, size=shape).astype(np.int8)


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


# ------------------------------------------------------------------ PDCCH
_BASE = dict(rnti=0x4601, payload_size=40, n_id=7, n_rnti=0x4601)
# name: (JAX config, nsc of the grid)
_CORESETS = {
    "1sym-interleaved": (pdcch.PdcchConfig(
        **_BASE, aggregation_level=4, cce_index=2, interleaved=True,
        coreset_nof_prb=48, shift=7), 48 * 12),
    "2sym": (pdcch.PdcchConfig(
        **_BASE, aggregation_level=2, cce_index=1, nof_symbols=2,
        coreset_start_prb=4), 60 * 12),
    "2sym-interleaved-pci": (pdcch.PdcchConfig(
        **_BASE, aggregation_level=4, cce_index=4, nof_symbols=2,
        interleaved=True, coreset_nof_prb=48, shift=123), 48 * 12),
    "3sym": (pdcch.PdcchConfig(
        **_BASE, aggregation_level=8, cce_index=0, nof_symbols=3,
        start_symbol=0), 52 * 12),
    "3sym-interleaved-R3": (pdcch.PdcchConfig(
        **_BASE, aggregation_level=2, cce_index=5, nof_symbols=3,
        interleaved=True, coreset_nof_prb=48, interleaver_rows=3,
        shift=2, coreset_start_prb=2), 52 * 12),
    "1sym": (pdcch.PdcchConfig(
        **_BASE, aggregation_level=4, cce_index=4), 52 * 12),
}


@pytest.mark.parametrize("name", sorted(_CORESETS))
def test_pdcch_re_indices_match(name):
    jcfg, _ = _CORESETS[name]
    tcfg = convert.from_jax_pdcch(jcfg)
    for a, b in zip(tcfg.re_indices, jcfg.re_indices):
        assert np.array_equal(a, b)


def test_pdcch_interleaver_refuses_a_partial_row():
    """48 PRB × 2 symbols = 16 bundles do not fill 3 interleaver rows."""
    jcfg = pdcch.PdcchConfig(**_BASE, nof_symbols=2, interleaved=True,
                             interleaver_rows=3)
    with pytest.raises(AssertionError):
        jcfg.re_indices
    with pytest.raises(ValueError, match="interleaver rows"):
        convert.from_jax_pdcch(jcfg).re_indices


@pytest.mark.parametrize("ports", [0, 2])
@pytest.mark.parametrize("name", sorted(_CORESETS))
def test_pdcch_transmit_matches(name, ports):
    """Set, not add: the base grid is replaced at the candidate's REs, on
    every port of a multi-port grid."""
    jcfg, nsc = _CORESETS[name]
    rng = np.random.default_rng(len(name) + ports)
    dci = _bits(rng, (B, jcfg.payload_size))
    shape = (B, ports, 14, nsc) if ports else (B, 14, nsc)
    base = _cplx(rng, shape)
    got = tpdcch.pdcch_transmit(torch.from_numpy(dci),
                                convert.from_jax_pdcch(jcfg),
                                torch.from_numpy(base))
    for b in range(B):
        want = np.asarray(pdcch.pdcch_transmit(jnp.asarray(dci[b]), jcfg,
                                               jnp.asarray(base[b])))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0, atol=1e-6)


def _pdcch_rx(jcfg, nsc, rng, sigma=0.05):
    """B noisy receptions [B, 14, nsc] of the JAX transmitter's grids."""
    dci = _bits(rng, (B, jcfg.payload_size))
    tx = np.stack([np.asarray(pdcch.pdcch_transmit(
        jnp.asarray(dci[b]), jcfg, jnp.zeros((14, nsc), jnp.complex64)))
        for b in range(B)])
    return dci, (0.8 * tx + _cplx(rng, tx.shape, sigma)).astype(np.complex64)


@pytest.mark.parametrize("name", sorted(_CORESETS))
def test_pdcch_receive_matches(name):
    jcfg, nsc = _CORESETS[name]
    tcfg = convert.from_jax_pdcch(jcfg)
    dci, rx = _pdcch_rx(jcfg, nsc, np.random.default_rng(20))
    got = tpdcch.pdcch_receive(torch.from_numpy(rx), tcfg)
    # port 0 of a two-port grid is the same reception
    two = tpdcch.pdcch_receive(torch.from_numpy(np.stack([rx, 0 * rx], 1)),
                               tcfg)
    wrong = tpdcch.pdcch_receive(torch.from_numpy(rx),
                                 dataclasses.replace(tcfg, rnti=0x1234))
    for b in range(B):
        want = pdcch.pdcch_receive(jnp.asarray(rx[b]), jcfg)
        assert np.array_equal(got.payload[b].numpy(),
                              np.asarray(want.payload))
        assert bool(got.crc_ok[b]) == bool(want.crc_ok)
    assert got.crc_ok.all() and np.array_equal(got.payload.numpy(), dci)
    assert torch.equal(two.payload, got.payload) and two.crc_ok.all()
    assert not wrong.crc_ok.any()


@pytest.mark.parametrize("al,cce,cands", [
    (2, 4, [0, 2, 4, 6]),
    # the last candidate's span ends past the grid: its start is clamped
    (4, 0, [0, 4, 8, 12]), (1, 7, [7, 3, 100])])
def test_pdcch_blind_receive_matches(al, cce, cands):
    nsc = 52 * 12
    jcfg = pdcch.PdcchConfig(rnti=0x17, payload_size=24, aggregation_level=al,
                             cce_index=cce, n_id=3, n_rnti=0x17)
    tcfg = convert.from_jax_pdcch(jcfg)
    dci, rx = _pdcch_rx(jcfg, nsc, np.random.default_rng(al))
    rx2 = np.stack([rx, _cplx(np.random.default_rng(0), rx.shape)], 1)
    c = np.asarray(cands, np.int32)
    payloads, ok = tpdcch.pdcch_blind_receive(torch.from_numpy(rx2), tcfg,
                                              torch.from_numpy(c))
    assert payloads.shape == (B, len(cands), 24) and ok.shape == (B, len(c))
    blind = jax.jit(lambda g, k: pdcch.pdcch_blind_receive(g, jcfg, k))
    for b in range(B):
        w_pay, w_ok = blind(jnp.asarray(rx2[b]), jnp.asarray(c))
        assert np.array_equal(ok[b].numpy(), np.asarray(w_ok))
        assert np.array_equal(payloads[b].numpy(), np.asarray(w_pay))
        assert ok[b].tolist() == [x == cce for x in cands]
        assert np.array_equal(payloads[b, cands.index(cce)].numpy(), dci[b])
    other = dataclasses.replace(tcfg, rnti=0x99, n_rnti=0x99)
    assert not tpdcch.pdcch_blind_receive(torch.from_numpy(rx), other,
                                          torch.from_numpy(c))[1].any()
    with pytest.raises(ValueError, match="one-symbol"):
        tpdcch.pdcch_blind_receive(torch.from_numpy(rx), dataclasses.replace(
            tcfg, nof_symbols=2), torch.from_numpy(c))


# ------------------------------------------------------------------- PBCH
_SSB = [ssb.SsbConfig(pci=123, ssb_idx=2, lmax=8, sfn=100),
        ssb.SsbConfig(pci=77, ssb_idx=1, lmax=4, sfn=42, hrf=1),
        ssb.SsbConfig(pci=1000, ssb_idx=37, lmax=64, sfn=7)]


def _tssb(cfg):
    return tssb.SsbConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("idx", range(len(_SSB)))
def test_pbch_decode_matches(idx):
    """Decodable LLRs give the sent payload on both sides; noise-only LLRs
    fail the CRC on both."""
    cfg = _SSB[idx]
    rng = np.random.default_rng(30 + idx)
    payload = _bits(rng, (B, 32))
    coded = tssb.pbch_encode(torch.from_numpy(payload), _tssb(cfg)).numpy()
    llr = (8.0 * (1.0 - 2.0 * coded) + 3.0 * rng.standard_normal(coded.shape)
           ).astype(np.float32)
    noise = (8.0 * rng.standard_normal(coded.shape)).astype(np.float32)
    for x, good in ((llr, True), (noise, False)):
        got, ok = tssb.pbch_decode(torch.from_numpy(x), _tssb(cfg))
        for b in range(B):
            w_got, w_ok = ssb.pbch_decode(jnp.asarray(x[b]), cfg)
            assert bool(ok[b]) == bool(w_ok) == good
            if good:
                assert np.array_equal(got[b].numpy(), np.asarray(w_got))
                assert np.array_equal(got[b].numpy(), payload[b])
    assert np.array_equal(tssb._data_positions(_tssb(cfg))[1],
                          ssb._data_positions(cfg)[1])
    for a, b in zip(tssb._dmrs_positions(_tssb(cfg)),
                    ssb._dmrs_positions(cfg)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("idx", range(len(_SSB)))
def test_ssb_receive_pbch_matches(idx):
    cfg = _SSB[idx]
    rng = np.random.default_rng(40 + idx)
    payload = _bits(rng, (B, 32))
    block = np.stack([np.asarray(ssb.ssb_assemble(jnp.asarray(p), cfg))
                      for p in payload])
    rx = (0.7 * block + _cplx(rng, block.shape, 0.1)).astype(np.complex64)
    got, ok = tssb.ssb_receive_pbch(torch.from_numpy(rx), _tssb(cfg),
                                    noise_var=0.01)
    for b in range(B):
        w_got, w_ok = ssb.ssb_receive_pbch(jnp.asarray(rx[b]), cfg,
                                           noise_var=0.01)
        assert bool(ok[b]) == bool(w_ok)
        assert np.array_equal(got[b].numpy(), np.asarray(w_got))
    assert ok.all() and np.array_equal(got.numpy(), payload)
    wrong = dataclasses.replace(_tssb(cfg), pci=cfg.pci + 1)
    assert not tssb.ssb_receive_pbch(torch.from_numpy(rx), wrong)[1].any()


# ------------------------------------------------------------------ PRACH
@pytest.mark.parametrize("length", [139, 839])
def test_restricted_a_cv_matches(length):
    for root in (1, 3, 22, 55, 129, 201, 400, 700):
        if root >= length:
            continue
        for n_cs in (2, 13, 15, 26, 46, 93, 167):
            want = prach.restricted_a_cv(length, n_cs, root)
            got = tprach.restricted_a_cv(length, n_cs, root)
            assert got == want, (root, n_cs)
            assert len(set(got)) == len(got)
            assert all(0 <= c < length for c in got)
    assert np.array_equal(tprach.generate_cv(201, 117, length),
                          prach.generate_cv(201, 117, length))


@pytest.mark.parametrize("restricted,root,n_cs", [
    ("type_a", 201, 26), ("type_a", 129, 13), ("unrestricted", 129, 13),
    ("unrestricted", 22, 0)])
def test_long_preamble_detect_matches(restricted, root, n_cs):
    """839-chip preambles at a few shifts (and a delay of 2 chips on slot
    1), two rx ports: the metrics, delays and peaks of both sides."""
    rng = np.random.default_rng(root + n_cs)
    length = 839
    cvs = (prach.restricted_a_cv(length, n_cs, root)
           if restricted == "type_a" else prach.unrestricted_cv(length, n_cs))
    k = np.arange(length)
    for v in sorted({0, len(cvs) // 2, len(cvs) - 1}):
        pre = tprach.generate_cv(root, cvs[v], length)
        ramp = np.stack([np.ones(length),
                         np.exp(-2j * np.pi * 2 * k / length)])
        rx = (pre * ramp[:, None, :] * np.asarray([1.0, 0.6 - 0.3j])[:, None]
              + _cplx(rng, (B, 2, length), 0.5)).astype(np.complex64)
        metric, delay, rssi = tprach.detect(torch.from_numpy(rx), root,
                                            length, n_cs,
                                            restricted_set=restricted)
        w_m, w_d, w_r = prach.detect(jnp.asarray(rx), root, length, n_cs,
                                     restricted_set=restricted)
        _close(metric, w_m, 1e-4)
        _close(delay, w_d, 1e-4)
        _close(rssi, w_r, 1e-5)
        m = metric.mean(dim=1)
        assert (torch.argmax(m, dim=-1) == v).all(), (v, m)
        assert abs(float(delay[1, 0, v]) - 2.0) < 1.0


@pytest.mark.parametrize("bucketed", [True, False])
def test_upper_phy_dl_slot_with_interleaved_coreset_matches(bucketed):
    """UpperPhy's DL slot with an SSB (PCI 123) and a DCI on an interleaved
    2-symbol CORESET (48 PRB, R = 2, shift = PCI): the port's grid within
    1e-5 of max|ref| of the JAX grid, and the port's receivers take the DCI
    and the PBCH payload back off a noisy copy of it."""
    from srsran_project_23_5_tpu.fapi import messages as fapi
    from srsran_project_23_5_tpu.phy.upper import upper_phy
    from srsran_project_23_5_tpu_torch.phy.upper import upper_phy as tupper
    rng = np.random.default_rng(50)
    cfg = pdcch.PdcchConfig(rnti=0x4601, payload_size=40, cce_index=4,
                            nof_symbols=2, interleaved=True,
                            coreset_nof_prb=48, shift=123)
    scfg = ssb.SsbConfig(pci=123)
    dci, pbch = _bits(rng, 40), _bits(rng, 32)
    req = fapi.DlTtiRequest(0, 0, ssb_pdus=[fapi.SsbPdu(scfg, pbch, 360)],
                            pdcch_pdus=[fapi.PdcchPdu(cfg, dci)])
    jcfg = upper_phy.UpperPhyConfig(nof_prb=52, bucketed=bucketed)
    want = np.asarray(upper_phy.UpperPhy(jcfg).process_dl_slot(req))
    got = tupper.UpperPhy(convert.from_jax_upper_phy(jcfg),
                          "cpu").process_dl_slot(convert.from_jax_message(req))
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-5
    rx = got[None] + torch.from_numpy(_cplx(rng, (1, 14, 624), 0.05))
    res = tpdcch.pdcch_receive(rx, convert.from_jax_pdcch(cfg))
    assert bool(res.crc_ok[0]) and np.array_equal(res.payload[0].numpy(), dci)
    payload, ok = tssb.ssb_receive_pbch(rx[:, 2:6, 360:600], _tssb(scfg))
    assert bool(ok[0]) and np.array_equal(payload[0].numpy(), pbch)
