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
    # state in shared memory: app in bf16 + 8 B of compressed c2v per
    # (check row, lane).  Flagship = the full BG2 graph: 42 rows, 52 blocks
    assert decoder_cuda.state_bytes(2, 384, 52) == 168_960
    assert decoder_cuda.state_bytes(2, 384) == 168_960
    # the full BG1 graph at Z=384 (46 rows, 68 blocks) now fits the
    # 232,448 B a block may hold
    assert decoder_cuda.state_bytes(1, 384) == 193_536 <= 232_448
    # the mixed slot's pusch0: 13 rows, 35 blocks; two CTAs share an SM
    assert decoder_cuda.state_bytes(1, 384, 35) == 66_816


def _bits_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 bit patterns (tells -0.0 from +0.0)."""
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("deg", list(range(3, 20)))
def test_c2v_compression_is_exact(deg):
    """The decoder kernel stores a check row's messages as bf16(0.8·m1),
    bf16(0.8·m2), the argmin edge and one sign per edge; expanding them
    gives bit for bit the bf16 messages the plain layer step stores, with
    forced ties |t| == m1 on several edges, ±0 inputs, and the zero
    state."""
    rng = np.random.default_rng(deg)
    b, z = 64, 16
    t = (rng.standard_normal((b, deg, z)) * 30).astype(np.float32)
    t[rng.random(t.shape) < 0.2] = 0.0                       # +0
    t[rng.random(t.shape) < 0.2] = -0.0                      # -0
    # ties: copy a row's smallest |t| (with either sign) onto other edges
    for r in range(0, b, 2):
        a = np.abs(t[r])
        low = a.min(axis=0)
        for e in rng.choice(deg, size=rng.integers(2, deg + 1),
                            replace=False):
            t[r, e] = np.where(rng.random(z) < 0.5, low, -low)
    t[-1] = 0.0                                              # all +0
    t[-2] = -0.0                                             # all -0
    t = torch.from_numpy(t)
    scale = torch.tensor(decoder_cuda.SCALE, dtype=torch.float32)
    want = decoder_cuda._bf16(decoder_cuda._messages(t, scale))
    got = decoder_cuda.c2v_expand(*decoder_cuda.c2v_compress(t), deg)
    assert torch.equal(_bits_i32(got), _bits_i32(want))
    # the decoder's initial state (all words zero) is +0 on every edge
    zero = torch.zeros((b, z), dtype=torch.int64)
    assert not _bits_i32(decoder_cuda.c2v_expand(zero, zero, deg)).any()


@pytest.mark.parametrize("zc", [2, 36, 208, 320, 352, 384])
def test_doubled_block_rotation_matches_roll(zc):
    """The encoder kernel's rotation: a Z-bit block stored twice back to
    back in 32-bit words, lanes 32w.. of P^s x read as one funnel shift at
    bit 32w + s, the last word masked; equal to torch.roll(x, -s)."""
    rng = np.random.default_rng(zc)
    x = torch.from_numpy(rng.integers(0, 2, size=(5, zc)).astype(np.int8))
    doubled = encoder_cuda.pack_doubled(x)
    assert doubled.shape == (5, encoder_cuda.doubled_words(zc))
    nw = -(-zc // 32)
    lane = torch.arange(32 * nw)
    for s in sorted({0, 1, zc // 2, zc - 1, 31 % zc, 32 % zc,
                     int(rng.integers(zc))}):
        words = encoder_cuda.rotated_words(doubled, s, zc)
        bits = (words[..., lane // 32] >> (lane % 32)) & 1
        assert not bits[:, zc:].any(), (zc, s)                # masked tail
        assert torch.equal(bits[:, :zc].to(torch.int8),
                           torch.roll(x, -s, dims=-1)), (zc, s)


def _words_to_bits(words: torch.Tensor, z: int) -> torch.Tensor:
    lane = torch.arange(z)
    return ((words[..., lane // 32] >> (lane % 32)) & 1).to(torch.int8)


@pytest.mark.parametrize("bg,zc", [(1, 36), (2, 36), (1, 208), (2, 15),
                                   (1, 384), (2, 384)])
def test_encoder_schedule_on_doubled_blocks_matches_plain(bg, zc):
    """The encoder kernel's algorithm on its storage: doubled bit blocks,
    the four core steps with their rolls folded into the edge shifts (and
    cancelling p0 edges dropped), then every extension row from columns
    < k+4; the codeword equals encode_plain's."""
    g = tgraphs.lifted_graph(bg, zc)
    k, m = g.nof_msg_blocks, g.nof_check_blocks
    rng = np.random.default_rng(zc + bg)
    msg = torch.from_numpy(_bits(rng, (3, k * zc)))
    steps = encoder_cuda._core_steps(g, zc)
    assert len(steps) == m
    blocks = list(msg.reshape(3, k, zc).unbind(1))
    doubled = [encoder_cuda.pack_doubled(b) for b in blocks]

    def row(edges):
        acc = 0
        for c, s in edges:
            acc = acc ^ encoder_cuda.rotated_words(doubled[c], s, zc)
        return _words_to_bits(acc, zc)

    for r in range(4):                               # p0..p3, in order
        blocks.append(row(steps[r]))
        doubled.append(encoder_cuda.pack_doubled(blocks[-1]))
    blocks += [row(edges) for edges in steps[4:]]
    got = torch.stack(blocks, dim=1).reshape(3, -1)
    assert torch.equal(got, encoder_cuda.encode_plain(msg, bg, zc))


def _decode_compressed(llr, bg, zc, iters, check_period, n_used):
    """decode_plain's schedule with c2v kept only in the kernel's
    compressed form (mag, sgn) per (row, lane)."""
    _, n, _, _ = decoder_cuda._schedule(bg, zc, n_used)
    layers = decoder_cuda._layer_index(bg, zc, n_used, llr.device)
    scale = torch.tensor(decoder_cuda.SCALE, dtype=torch.float32)
    app = decoder_cuda._bf16(llr[:, :n * zc]).contiguous()
    b = llr.shape[0]
    state = [(torch.zeros((b, zc), dtype=torch.int64),) * 2 for _ in layers]
    done = torch.zeros(b, dtype=torch.bool)
    for _ in range(decoder_cuda._steps(iters, check_period)):
        if bool(done.all()):
            break
        for _ in range(check_period):
            for li, (_, deg, idx) in enumerate(layers):
                v = app[:, idx]
                t = v - decoder_cuda.c2v_expand(*state[li], deg)
                msg = decoder_cuda._messages(t, scale)
                new = decoder_cuda.c2v_compress(t)
                state[li] = tuple(torch.where(done[:, None], o, w)
                                  for o, w in zip(state[li], new))
                app[:, idx] = torch.where(done[:, None, None], v,
                                          decoder_cuda._bf16(t + msg))
        ok = torch.ones(b, dtype=torch.bool)
        for _, _, idx in layers:
            ok &= ~((((app[:, idx] <= 0.0).sum(dim=1) % 2) == 1).any(dim=1))
        done |= ok
    k = tgraphs.lifted_graph(bg, zc).nof_msg_blocks
    return (app[:, :k * zc] <= 0.0).to(torch.int8), done


@pytest.mark.parametrize("case", sorted(_DECODE_CASES))
def test_decode_with_compressed_c2v_matches_plain(case):
    """The whole decode with c2v stored compressed, as the kernel stores it,
    gives decode_plain's bits and ok, mixed convergence included."""
    batch, snr, iters, kw = _DECODE_CASES[case]
    bg, zc = 2, 32
    rng = np.random.default_rng(18)
    msg = _bits(rng, (batch, 10 * zc))
    cw = encoder_cuda.encode_plain(torch.from_numpy(msg), bg, zc).numpy()
    llr = _noisy_llr(rng, cw, snr, zc)
    if "nof_used_blocks" in kw:
        llr[:, kw["nof_used_blocks"] * zc:] = 0.0
    llr = torch.from_numpy(np.round(llr))       # exact ties and zeros
    want = decoder_cuda.decode_plain(llr, bg, zc, iters, **kw)
    got = _decode_compressed(llr, bg, zc, iters, kw.get("check_period", 1),
                             kw.get("nof_used_blocks"))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
