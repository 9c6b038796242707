"""Parity of the port's LDPC bit path with the JAX package (CPU).

Every input is made with numpy from a seed and handed to both sides.  The
bit path is exact: graphs, CRC, segmentation, rate (de)matching, the plain
encoder against ``encoder.encode`` and ``encoder_pallas.encode`` (interpret
mode), and the plain decoder against ``decoder_pallas.decode`` (interpret
mode) — bits and ``ok`` identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srsran_project_23_5_tpu.ops import crc as jcrc
from srsran_project_23_5_tpu.ops.ldpc import (decoder_pallas, encoder,
                                              encoder_pallas, graphs,
                                              rate_match, segmentation)
from srsran_project_23_5_tpu.ran import ldpc_params, numerology
from srsran_project_23_5_tpu_torch.ops import crc as tcrc
from srsran_project_23_5_tpu_torch.ops.ldpc import decoder_cuda, encoder_cuda
from srsran_project_23_5_tpu_torch.ops.ldpc import encoder as tencoder
from srsran_project_23_5_tpu_torch.ops.ldpc import graphs as tgraphs
from srsran_project_23_5_tpu_torch.ops.ldpc import rate_match as trm
from srsran_project_23_5_tpu_torch.ops.ldpc import segmentation as tseg
from srsran_project_23_5_tpu_torch.ran import ldpc_params as tparams
from srsran_project_23_5_tpu_torch.ran import numerology as tnum

torch.set_num_threads(1)


def _bits(rng, shape):
    return rng.integers(0, 2, size=shape).astype(np.int8)


def _noisy_llr(rng, cw, snr_db, zc):
    """BPSK LLRs of codewords at per-row SNR, punctured 2Zc prefix zeroed."""
    sigma = np.broadcast_to(
        10 ** (-np.asarray(snr_db, np.float32) / 20), (cw.shape[0],))[:, None]
    llr = 2.0 * ((1 - 2 * cw.astype(np.float32))
                 + sigma * rng.standard_normal(cw.shape).astype(np.float32)
                 ) / sigma ** 2
    llr[:, :2 * zc] = 0.0
    return llr.astype(np.float32)


# ---------------------------------------------------------------- ran/
@pytest.mark.parametrize("tbs", [24, 256, 1608, 3624, 3824, 8456, 40976,
                                 100000])
def test_segment_params_match(tbs):
    for rate in (0.1, 0.3, 0.7):
        bg = ldpc_params.base_graph(tbs, rate)
        assert tparams.base_graph(tbs, rate) == bg
        assert (dataclasses.asdict(tparams.segment_tb(tbs, bg))
                == dataclasses.asdict(ldpc_params.segment_tb(tbs, bg)))
    for bg in (1, 2):
        for rv in range(4):
            assert (tparams.rate_match_k0(bg, 384, rv, 19200)
                    == ldpc_params.rate_match_k0(bg, 384, rv, 19200))
    assert tparams.ALL_LIFTING_SIZES == ldpc_params.ALL_LIFTING_SIZES
    assert (tparams.rate_match_lengths(216216, 11, 6, 1)
            == ldpc_params.rate_match_lengths(216216, 11, 6, 1))


@pytest.mark.parametrize("mu,nfft", [(0, 128), (1, 512), (1, 4096), (2, 2048)])
def test_numerology_match(mu, nfft):
    for slot in range(1 << mu):
        assert np.array_equal(tnum.cp_lengths(mu, nfft, slot),
                              numerology.cp_lengths(mu, nfft, slot))
        assert (tnum.slot_num_samples(mu, nfft, slot)
                == numerology.slot_num_samples(mu, nfft, slot))
    assert tnum.sample_rate_hz(mu, nfft) == numerology.sample_rate_hz(mu, nfft)
    for prb in (8, 24, 52, 106, 273):
        assert tnum.min_nfft(prb) == numerology.min_nfft(prb)


# ------------------------------------------------------------ graphs
@pytest.mark.parametrize("bg", [1, 2])
@pytest.mark.parametrize("zc", [2, 24, 32, 36, 104, 384])
def test_lifted_graph_matches(bg, zc):
    assert (dataclasses.astuple(tgraphs.lifted_graph(bg, zc))
            == dataclasses.astuple(graphs.lifted_graph(bg, zc)))


@pytest.mark.parametrize("bg,zc", [(1, 8), (2, 12)])
def test_parity_check_dense_matches(bg, zc):
    assert np.array_equal(
        tgraphs.parity_check_dense(tgraphs.lifted_graph(bg, zc)),
        graphs.parity_check_dense(graphs.lifted_graph(bg, zc)))


# --------------------------------------------------------------- crc
@pytest.mark.parametrize("name", sorted(jcrc.POLYNOMIALS))
def test_crc_matches(name):
    rng = np.random.default_rng(1)
    for length in (1, 40, 3816, 40976):
        bits = _bits(rng, (3, length))
        assert np.array_equal(tcrc.remainder_matrix(name, length),
                              jcrc.remainder_matrix(name, length))
        want = np.asarray(jcrc.crc(jnp.asarray(bits), name))
        got = tcrc.crc(torch.from_numpy(bits), name).numpy()
        assert got.dtype == np.int8 and np.array_equal(got, want)
    attached = tcrc.crc_attach(torch.from_numpy(bits), name)
    assert tcrc.crc_check(attached, name).all()
    attached[1, 7] ^= 1
    assert tcrc.crc_check(attached, name).tolist() == [True, False, True]


# ------------------------------------------------------ segmentation
@pytest.mark.parametrize("tbs,bg", [(256, 2), (3624, 2), (40984, 2),
                                    (40976, 1)])
def test_segmentation_matches(tbs, bg):
    rng = np.random.default_rng(2)
    seg = ldpc_params.segment_tb(tbs, bg)
    tb = _bits(rng, (2, tbs))
    want = np.asarray(segmentation.segment_tx(jnp.asarray(tb), seg))
    got = tseg.segment_tx(torch.from_numpy(tb), tparams.segment_tb(tbs, bg))
    assert np.array_equal(got.numpy(), want)
    # flip one payload bit of the first TB's last codeblock
    cbs = want.copy()
    cbs[0, -1, 3] ^= 1
    w_tb, w_ok, w_cb = segmentation.desegment_rx(jnp.asarray(cbs), seg)
    g_tb, g_ok, g_cb = tseg.desegment_rx(torch.from_numpy(cbs), seg)
    assert np.array_equal(g_tb.numpy(), np.asarray(w_tb))
    assert np.array_equal(g_ok.numpy(), np.asarray(w_ok))
    assert np.array_equal(g_cb.numpy(), np.asarray(w_cb))
    assert g_ok.tolist() == [False, True]


def test_tbs_40976_does_not_segment_on_bg2():
    """The JAX flagship default (TBS 40976 at rate 0.19 → BG2, 11 CBs) does
    not split into codeblocks on either side; 40984 is the TS 38.214 size
    at that rate (the port's flagship default)."""
    seg = ldpc_params.segment_tb(40976, 2)
    with pytest.raises(AssertionError):
        segmentation.segment_tx(jnp.zeros(40976, jnp.int8), seg)
    with pytest.raises(ValueError, match="does not match"):
        tseg.segment_tx(torch.zeros((1, 40976), dtype=torch.int8),
                        tparams.segment_tb(40976, 2))
    seg = tparams.segment_tb(40984, 2)
    assert (seg.nof_segments, seg.payload_length) == (11, 3752)


# --------------------------------------------------------- rate match
@pytest.mark.parametrize("tbs,qm,nof_bits,rv", [
    (40976, 6, 216216, 0),      # flagship: 11 CBs, BG2 Z=384
    (256, 2, 2112, 0),          # tiny carrier
    (3624, 4, 12672, 2),
    (1608, 2, 30000, 3),        # E > Ncb: repetitions soft-combine
])
def test_rate_match_matches(tbs, qm, nof_bits, rv):
    rng = np.random.default_rng(3)
    bg = ldpc_params.base_graph(tbs, tbs / nof_bits)
    seg = ldpc_params.segment_tb(tbs, bg)
    c, z = seg.nof_segments, seg.lifting_size
    cbl = tuple(ldpc_params.rate_match_lengths(nof_bits, c, qm, 1))
    key = (bg, z, rv, seg.payload_length, seg.segment_length, cbl, qm)
    fwd, invs, filler = trm.tb_maps(*key)
    w_fwd, w_invs, w_filler = rate_match.tb_maps(*key)
    assert np.array_equal(fwd, w_fwd) and np.array_equal(filler, w_filler)
    assert len(invs) == len(w_invs)
    assert all(np.array_equal(a, b) for a, b in zip(invs, w_invs))
    nfull = seg.full_codeblock_length + 2 * z
    cw = _bits(rng, (c, nfull))
    want = np.asarray(rate_match.match_tb(jnp.asarray(cw), *key))
    got = trm.match_tb(torch.from_numpy(cw)[None], *key)[0]
    assert np.array_equal(got.numpy(), want)
    llr = rng.standard_normal(nof_bits).astype(np.float32) * 10
    want = np.asarray(rate_match.dematch_tb(jnp.asarray(llr), *key))
    got = trm.dematch_tb(torch.from_numpy(llr)[None], *key)[0]
    assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------------ encoder
@pytest.mark.parametrize("bg,zc", [(1, 32), (1, 384), (2, 24), (2, 36),
                                   (2, 384)])
def test_encode_plain_matches_xla_encoder(bg, zc):
    rng = np.random.default_rng(4)
    k = tgraphs.lifted_graph(bg, zc).nof_msg_blocks * zc
    msg = _bits(rng, (5, k))
    want = np.asarray(encoder.encode(jnp.asarray(msg), bg, zc))
    got = encoder_cuda.encode_plain(torch.from_numpy(msg), bg, zc)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bg,zc", [pytest.param(1, 32, marks=pytest.mark.slow),
                                   (2, 24), (2, 36)])
def test_encode_plain_matches_pallas_interpret(bg, zc):
    rng = np.random.default_rng(5)
    k = tgraphs.lifted_graph(bg, zc).nof_msg_blocks * zc
    msg = _bits(rng, (5, k))                          # not a multiple of 8
    want = np.asarray(encoder_pallas.encode(jnp.asarray(msg), bg, zc,
                                            interpret=True))
    got = encoder_cuda.encode_plain(torch.from_numpy(msg), bg, zc)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bg,zc", [(1, 8), (2, 12)])
def test_encode_plain_satisfies_parity_checks(bg, zc):
    rng = np.random.default_rng(6)
    g = tgraphs.lifted_graph(bg, zc)
    cw = tencoder.encode(torch.from_numpy(_bits(rng, (4, g.nof_msg_blocks
                                                       * zc))), bg, zc)
    h = tgraphs.parity_check_dense(g).astype(np.int64)
    assert not ((h @ cw.numpy().astype(np.int64).T) % 2).any()


def test_encode_wrapper_takes_plain_on_cpu():
    rng = np.random.default_rng(7)
    msg = torch.from_numpy(_bits(rng, (3, 360)))
    before = encoder_cuda.encode.launches
    assert torch.equal(encoder_cuda.encode(msg, 2, 36),
                       encoder_cuda.encode_plain(msg, 2, 36))
    assert encoder_cuda.encode.launches == before


# ------------------------------------------------------------ decoder
_DECODE_CASES = {
    # name: (batch, snr_db per row, iterations, decode kwargs)
    "bg2_z32_4db": (6, 4.0, 4, {}),
    "mixed_convergence": (8, np.linspace(-5.0, -1.0, 8), 6, {}),
    "truncated_graph": (8, np.linspace(0.0, 4.0, 8), 6,
                        {"nof_used_blocks": 20}),
    "check_period_2": (8, np.linspace(-5.0, -1.0, 8), 5,
                       {"check_period": 2}),
}


@pytest.mark.parametrize("case", sorted(_DECODE_CASES))
def test_decode_plain_matches_pallas_interpret(case):
    batch, snr, iters, kw = _DECODE_CASES[case]
    bg, zc = 2, 32
    rng = np.random.default_rng(8)
    msg = _bits(rng, (batch, 10 * zc))
    cw = encoder_cuda.encode_plain(torch.from_numpy(msg), bg, zc).numpy()
    llr = _noisy_llr(rng, cw, snr, zc)
    if "nof_used_blocks" in kw:
        llr[:, kw["nof_used_blocks"] * zc:] = 0.0     # untransmitted tail
    w_bits, w_ok = decoder_pallas.decode(jnp.asarray(llr), bg, zc, iters,
                                         interpret=True, **kw)
    bits, ok = decoder_cuda.decode_plain(torch.from_numpy(llr), bg, zc,
                                         iters, **kw)
    assert bits.dtype == torch.int8 and ok.dtype == torch.bool
    assert np.array_equal(ok.numpy(), np.asarray(w_ok))
    assert np.array_equal(bits.numpy(), np.asarray(w_bits))
    ok = ok.numpy()
    if case == "bg2_z32_4db":
        assert ok.all() and np.array_equal(bits.numpy(), msg)
    else:
        assert ok.any() and not ok.all(), ok           # mixed convergence


def test_decode_wrapper_takes_plain_on_cpu():
    rng = np.random.default_rng(9)
    cw = encoder_cuda.encode_plain(torch.from_numpy(_bits(rng, (3, 360))),
                                   2, 36).numpy()
    llr = torch.from_numpy(_noisy_llr(rng, cw, 3.0, 36))
    before = decoder_cuda.decode.launches
    bits, ok = decoder_cuda.decode(llr, 2, 36)
    w_bits, w_ok = decoder_cuda.decode_plain(llr, 2, 36)
    assert torch.equal(bits, w_bits) and torch.equal(ok, w_ok)
    assert decoder_cuda.decode.launches == before


def test_decoder_layers_and_state_bytes():
    for bg, zc, n_used in [(1, 384, None), (1, 384, 30), (2, 384, 52),
                           (2, 36, 20)]:
        g_t, g_j = tgraphs.lifted_graph(bg, zc), graphs.lifted_graph(bg, zc)
        assert (decoder_cuda._layers(g_t, n_used)
                == decoder_pallas._layers(g_j, n_used))
    for bits in (2112, 12672, 19656):
        assert (decoder_cuda.used_blocks(2, 384, bits)
                == decoder_pallas.used_blocks(2, 384, bits))
    # flagship: BG2 Z=384, 52 blocks, 197 edges in bf16
    assert decoder_cuda.state_bytes(2, 384, 52) == 191_232
    assert decoder_cuda.state_bytes(2, 384, 52) <= decoder_cuda.SMEM_LIMIT
    # full BG1 graph at Z=384 (68 blocks, 316 edges) does not fit
    assert decoder_cuda.state_bytes(1, 384) == 294_912
    assert decoder_cuda.state_bytes(1, 384) > decoder_cuda.SMEM_LIMIT
