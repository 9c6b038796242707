"""Parity of the ops the port gained with the scan mode against the JAX
package (CPU): bit packing, the host CRC and LDPC encoder references, the
constellation table and its mapper, π/2-BPSK, LLR quantisation and hard
decisions, the per-codeblock LDPC rate matcher, layer demapping and the
one-layer codebook, MMSE 1×N and 2×2 zero-forcing, the OFDM rx window
offset, and ``pdsch_transmit`` with a precoding matrix.

Inputs are made with numpy from a seed.  Bits, tables and hard decisions
are exact; float ops agree within 1e-5 of max|ref| (float32 in two
frameworks), the OFDM window within 4e-5 (FFT orders).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srsran_project_23_5_tpu.models import gnb_mixed
from srsran_project_23_5_tpu.ops import (bits, crc, equalizer, modulation,
                                         precoding)
from srsran_project_23_5_tpu.ops.ldpc import encoder, rate_match
from srsran_project_23_5_tpu.phy.lower import ofdm
from srsran_project_23_5_tpu.phy.upper import sch
from srsran_project_23_5_tpu_torch import convert
from srsran_project_23_5_tpu_torch.models import gnb_mixed as tgnb_mixed
from srsran_project_23_5_tpu_torch.ops import bits as tbits
from srsran_project_23_5_tpu_torch.ops import channel_mix as tchannel_mix
from srsran_project_23_5_tpu_torch.ops import crc as tcrc
from srsran_project_23_5_tpu_torch.ops import equalizer as tequalizer
from srsran_project_23_5_tpu_torch.ops import modulation as tmodulation
from srsran_project_23_5_tpu_torch.ops import precoding as tprecoding
from srsran_project_23_5_tpu_torch.ops.ldpc import encoder as tencoder
from srsran_project_23_5_tpu_torch.ops.ldpc import rate_match as trate_match
from srsran_project_23_5_tpu_torch.phy.lower import ofdm as tofdm
from srsran_project_23_5_tpu_torch.phy.upper import sch as tsch

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


def _bits(rng, shape):
    return rng.integers(0, 2, size=shape).astype(np.int8)


# ----------------------------------------------------------------- bits
@pytest.mark.parametrize("shape", [(8,), (3, 64), (2, 2, 40)])
def test_bit_packing_exact(shape):
    b = _bits(np.random.default_rng(len(shape)), shape)
    packed = np.asarray(bits.pack_bits(jnp.asarray(b)))
    got = tbits.pack_bits(torch.from_numpy(b))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), packed)
    assert np.array_equal(tbits.pack_bits_np(b), bits.pack_bits_np(b))
    unpacked = tbits.unpack_bits(got)
    assert unpacked.dtype == torch.int8
    assert np.array_equal(unpacked.numpy(),
                          np.asarray(bits.unpack_bits(jnp.asarray(packed))))
    assert np.array_equal(tbits.unpack_bits_np(packed),
                          bits.unpack_bits_np(packed))
    assert np.array_equal(unpacked.numpy(), b)
    with pytest.raises(ValueError, match="whole bytes"):
        tbits.pack_bits(torch.zeros(7, dtype=torch.int8))


@pytest.mark.parametrize("name,length", [
    ("crc24A", 40), ("crc24B", 3816), ("crc16", 100), ("crc24C", 64),
    ("crc11", 20), ("crc6", 15)])
def test_crc_np_exact(name, length):
    b = _bits(np.random.default_rng(length), (3, length))
    want = crc.crc_np(b, name)
    got = tcrc.crc_np(b, name)
    assert np.array_equal(got, want)
    assert np.array_equal(tcrc.crc(torch.from_numpy(b), name).numpy(), got)


@pytest.mark.parametrize("bg,z", [(1, 8), (2, 16), (2, 5)])
def test_encode_np_exact(bg, z):
    k = (22 if bg == 1 else 10) * z
    msg = _bits(np.random.default_rng(z), (3, k))
    want = encoder.encode_np(msg, bg, z)
    got = tencoder.encode_np(msg, bg, z)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    # the port's encoder gives the same codeword
    assert np.array_equal(tencoder.encode(torch.from_numpy(msg), bg, z
                                          ).numpy(), got)


# ------------------------------------------------------------ modulation
@pytest.mark.parametrize("qm", [1, 2, 4, 6, 8])
def test_constellation_and_lut_mapper(qm):
    assert np.array_equal(tmodulation.constellation(qm),
                          modulation.constellation(qm))
    b = _bits(np.random.default_rng(40 + qm), (3, 60 * qm))
    want = np.asarray(modulation.modulate_lut(jnp.asarray(b), qm))
    got = tmodulation.modulate_lut(torch.from_numpy(b), qm)
    assert got.dtype == torch.complex64 and np.array_equal(got.numpy(), want)
    if qm > 1:
        # the arithmetic mapper and the table agree
        _close(tmodulation.modulate(torch.from_numpy(b), qm), want, 1e-6)


def test_modulate_pi2_bpsk():
    b = _bits(np.random.default_rng(50), (2, 301))
    want = np.asarray(modulation.modulate_pi2_bpsk(jnp.asarray(b)))
    got = tmodulation.modulate_pi2_bpsk(torch.from_numpy(b))
    assert got.dtype == torch.complex64
    _close(got, want, 1e-5)


def _llr_stage_inputs(rng, qm, layers, batch, nsym):
    """Symbols [B, S] (one layer) or [B, L, S], post noise variance of the
    same shape, a ±1 sign [L·S·qm]."""
    shape = (batch, nsym) if layers == 1 else (batch, layers, nsym)
    x = _cplx(rng, shape, 0.8)
    nv = (10 ** rng.uniform(-2.5, 0.5, shape)).astype(np.float32)
    sign = (1 - 2 * rng.integers(0, 2, layers * nsym * qm)).astype(np.float32)
    return x, nv, sign


@pytest.mark.parametrize("layers", [1, 2, 4])
@pytest.mark.parametrize("qm", [2, 4, 6, 8])
def test_pusch_llr_plain_is_the_stage(qm, layers):
    """``pusch_llr_plain`` is the chain ``pusch_demodulate`` ran before the
    kernel (demap, layer demap for several layers, × sign, clip), exactly,
    and the JAX package's demap and layer demap within float32."""
    rng = np.random.default_rng(60 + 10 * qm + layers)
    x, nv, sign = _llr_stage_inputs(rng, qm, layers, 3, 41)
    xt, nvt, st = (torch.from_numpy(a) for a in (x, nv, sign))
    llr = tmodulation.demodulate_soft(xt, nvt, qm)
    if layers > 1:
        llr = tprecoding.layer_demap_llr(llr, qm)
    old = torch.clamp(llr * st, -120.0, 120.0)
    got = tmodulation.pusch_llr_plain(xt, nvt, st, qm)
    assert got.shape == (3, layers * 41 * qm) and torch.equal(got, old)
    ref = modulation.demodulate_soft(jnp.asarray(x), jnp.asarray(nv), qm)
    if layers > 1:
        ref = precoding.layer_demap_llr(ref, qm)
    _close(got, np.clip(np.asarray(ref) * sign, -120.0, 120.0), 1e-5)


def _evm_old(x_hat, qm):
    """``sch.evm_calculate`` as the port had it before the kernel took the
    EVM."""
    levels = torch.from_numpy(
        (modulation.pam_levels(qm) if qm > 2
         else np.array([1, -1], np.float32) / np.sqrt(2.0)).astype(np.float32))

    def nearest(axis_vals):
        return levels[(axis_vals[..., None] - levels).abs().argmin(dim=-1)]

    hard = torch.complex(nearest(x_hat.real), nearest(x_hat.imag))
    return ((x_hat - hard).abs() ** 2).mean(dim=-1).sqrt()


@pytest.mark.parametrize("layers", [1, 2, 4])
@pytest.mark.parametrize("qm", [2, 4, 6, 8])
def test_evm_plain_is_the_stage(qm, layers):
    """``evm_plain`` is the EVM ``pusch_demodulate`` took before the kernel
    (the old ``evm_calculate`` over each row's L·S symbols), exactly, and the
    JAX package's ``evm_calculate`` row by row within 1e-6; ``sch`` keeps
    the JAX name for it."""
    rng = np.random.default_rng(80 + 10 * qm + layers)
    x, _, _ = _llr_stage_inputs(rng, qm, layers, 3, 41)
    xt = torch.from_numpy(x).flatten(1)
    got = tmodulation.evm_plain(xt, qm)
    assert got.shape == (3,) and torch.equal(got, _evm_old(xt, qm))
    assert tsch.evm_calculate is tmodulation.evm_plain
    want = [float(sch.evm_calculate(jnp.asarray(row), qm))
            for row in x.reshape(3, -1)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.fixture
def traced():
    """The process tracer on, inside one open span; off and empty after."""
    from srsran_project_23_5_tpu_torch.utils.tracing import tracer
    tracer.clear()
    tracer.enabled = True
    try:
        with tracer.span("test.stage", "test") as span:
            yield span
    finally:
        tracer.enabled = False
        tracer.clear()


def test_pusch_llr_takes_the_plain_path_on_the_cpu(traced):
    """On the CPU ``pusch_llr`` is (``pusch_llr_plain``, ``evm_plain`` over
    each row's L·S symbols), counted as the plain path, no launch."""
    rng = np.random.default_rng(70)
    before = tmodulation.pusch_llr.launches
    for layers in (1, 2):
        x, nv, sign = _llr_stage_inputs(rng, 6, layers, 2, 17)
        args = tuple(torch.from_numpy(a) for a in (x, nv, sign))
        llr, evm = tmodulation.pusch_llr(*args, 6)
        assert torch.equal(llr, tmodulation.pusch_llr_plain(*args, 6))
        assert torch.equal(evm, tmodulation.evm_plain(args[0].flatten(1), 6))
    assert traced.counts == {"pusch.llr_plain": 2}
    assert tmodulation.pusch_llr.launches == before


@pytest.mark.parametrize("case", ["qm", "qm1", "nv_shape", "sign_len",
                                  "rank"])
def test_pusch_llr_refuses_what_does_not_fit(case):
    rng = np.random.default_rng(71)
    x, nv, sign = (torch.from_numpy(a)
                   for a in _llr_stage_inputs(rng, 4, 2, 2, 9))
    qm = {"qm": 5, "qm1": 1}.get(case, 4)
    if case == "nv_shape":
        nv = nv[:, :, :-1]
    elif case == "sign_len":
        sign = sign[:-4]
    elif case == "rank":
        x, nv = x[None], nv[None]
    with pytest.raises(ValueError):
        tmodulation.pusch_llr(x, nv, sign, qm)


def _mix_inputs(rng, batch: int, trail: tuple, streams: int):
    """Random (h [2, 2], g [batch, 2, *trail], columns, streams)."""
    h = torch.from_numpy(_cplx(rng, (2, 2)))
    g = torch.from_numpy(_cplx(rng, (batch, 2, *trail)))
    vecs = [torch.from_numpy(_cplx(rng, (2,))) for _ in range(streams)]
    xs = [torch.from_numpy(_cplx(rng, (batch, *trail)))
          for _ in range(streams)]
    return h, g, vecs, xs


# the tiny mixed slot's grid and its time-domain slot (15360 samples; one
# more makes the length odd)
_MIX_SHAPES = {"grid": (2, (14, tgnb_mixed.tiny_mixed().nsc)),
               "time": (3, (tgnb_mixed.tiny_mixed().slot_samples + 1,))}


@pytest.mark.parametrize("streams", [0, 1, 2])
@pytest.mark.parametrize("shape", sorted(_MIX_SHAPES))
def test_channel_mix_on_the_cpu_is_the_slots_expression(shape, streams):
    """On the CPU ``channel_mix`` is the expression the mixed slot used
    before the kernel (``_mix2`` plus a ``_vecmix`` per stream), bit for
    bit, with the slot's own channels and with random ones; no launch."""
    rng = np.random.default_rng(72 + streams)
    batch, trail = _MIX_SHAPES[shape]
    h_ul, _, h1_ul, h2_ul = tgnb_mixed._channels(torch.device("cpu"))
    rand = _mix_inputs(rng, batch, trail, streams)
    before = tchannel_mix.channel_mix.launches
    for h, vecs in ((h_ul, (h1_ul, h2_ul)[:streams]), (rand[0], rand[2])):
        g, xs = rand[1], rand[3]
        want = torch.einsum("pq,bq...->bp...", h, g)
        for v, x in zip(vecs, xs):
            want = want + v.reshape(1, 2, *(1,) * (x.dim() - 1)) * x[:, None]
        assert torch.equal(tchannel_mix.channel_mix(h, g, vecs, xs), want)
    assert tchannel_mix.channel_mix.launches == before


@pytest.mark.parametrize("selective", [False, True], ids=["flat", "tdl"])
def test_mixed_front_counts_the_plain_mix_per_call(traced, selective):
    """The tiny mixed slot's front half on the CPU mixes its DL and its UL
    through ``channel_mix``: ``mixed.mix_plain`` ticks once per call (two a
    batch, flat and TDL), ``mixed.mix_kernel`` never."""
    cfg = tgnb_mixed.tiny_mixed()
    if selective:
        cfg = tgnb_mixed.tdl_channel(cfg)
    pay = tgnb_mixed.make_payloads(cfg, np.random.default_rng(73), 1, "cpu")
    noise = tgnb_mixed.draw_noise(cfg, 1, torch.Generator().manual_seed(73))
    tgnb_mixed._mixed_front(pay, *noise, cfg)
    assert traced.counts["mixed.mix_plain"] == 2
    assert "mixed.mix_kernel" not in traced.counts


@pytest.mark.parametrize("case", ["three_streams", "column_count", "h_shape",
                                  "ports", "stream_shape", "column_shape"])
def test_channel_mix_refuses_what_does_not_fit(case):
    rng = np.random.default_rng(74)
    h, g, vecs, xs = _mix_inputs(rng, 2, (5,), 2)
    if case == "three_streams":
        vecs, xs = vecs + vecs[:1], xs + xs[:1]
    elif case == "column_count":
        vecs = vecs[:1]
    elif case == "h_shape":
        h = h[:, :1]
    elif case == "ports":
        g = torch.cat([g, g[:, :1]], dim=1)
    elif case == "stream_shape":
        xs = [xs[0][:, :-1], xs[1]]
    else:
        vecs = [vecs[0][None], vecs[1]]
    with pytest.raises(ValueError):
        tchannel_mix.channel_mix(h, g, vecs, xs)


def test_channel_mix_imports_with_no_cuda():
    """``ops/channel_mix`` imports, registers its wrapper and runs its
    plain path in an interpreter that sees no CUDA device, building and
    loading no kernel library."""
    code = (
        "import torch\n"
        "from srsran_project_23_5_tpu_torch.ops import channel_mix as m\n"
        "from srsran_project_23_5_tpu_torch.utils import graphs, kernels\n"
        "assert not torch.cuda.is_available()\n"
        "assert graphs.KERNELS['channel_mix'] is m.channel_mix\n"
        "h = torch.eye(2, dtype=torch.complex64)\n"
        "g = torch.ones((1, 2, 3), dtype=torch.complex64)\n"
        "assert torch.equal(m.channel_mix(h, g), g)\n"
        "assert kernels.library.cache_info().currsize == 0\n"
        "print('ok')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("scale", [1.0, 0.37, 4.0])
def test_quantize_llr_and_hard_decision(scale):
    rng = np.random.default_rng(int(scale * 100))
    llr = (60 * rng.standard_normal((3, 500))).astype(np.float32)
    llr[0, :4] = [0.0, -0.0, 0.5, -0.5]
    want = np.array(modulation.quantize_llr(jnp.asarray(llr), scale))
    got = tmodulation.quantize_llr(torch.from_numpy(llr), scale)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    for x in (llr, want):
        hd = tmodulation.hard_decision(torch.from_numpy(x))
        assert hd.dtype == torch.int8
        assert np.array_equal(hd.numpy(), np.asarray(
            modulation.hard_decision(jnp.asarray(x))))


# ----------------------------------------------------------- rate matcher
# (bg, z, rv, payload_length, segment_length, e, qm): fillers or none,
# every rv, e over one buffer wrap (repetitions) and punctured
_RM = [(1, 16, 0, 300, 352, 600, 2), (1, 16, 2, 352, 352, 3000, 4),
       (2, 24, 1, 200, 240, 480, 6), (2, 24, 3, 240, 240, 1500, 2),
       (1, 8, 0, 150, 176, 96, 8)]


@pytest.mark.parametrize("key", _RM)
def test_codeblock_rate_match(key):
    bg, z, rv, pl, sl, e, qm = key
    rng = np.random.default_rng(e)
    n_full = (68 if bg == 1 else 52) * z
    cw = _bits(rng, (2, n_full))
    want = np.asarray(rate_match.match(jnp.asarray(cw), *key))
    got = trate_match.match(torch.from_numpy(cw), *key)
    assert np.array_equal(got.numpy(), want)
    x = _bits(rng, (2, e))
    assert np.array_equal(
        trate_match.interleave(torch.from_numpy(x), qm).numpy(),
        np.asarray(rate_match.interleave(jnp.asarray(x), qm)))
    assert np.array_equal(
        trate_match.deinterleave(torch.from_numpy(x), qm).numpy(),
        np.asarray(rate_match.deinterleave(jnp.asarray(x), qm)))
    llr = rng.standard_normal((2, e)).astype(np.float32)
    want = np.asarray(rate_match.dematch(jnp.asarray(llr), *key))
    got = trate_match.dematch(torch.from_numpy(llr), *key)
    _close(got, want, 1e-5)
    comb = trate_match.combine_retransmission(got, got * 3, pl, z)
    _close(comb, np.asarray(rate_match.combine_retransmission(
        jnp.asarray(want), jnp.asarray(want) * 3, pl, z)), 1e-5)


# ------------------------------------------------- precoding, equalisers
def test_layer_demap_and_codebook():
    rng = np.random.default_rng(60)
    for v in (1, 2, 4):
        lay = _cplx(rng, (3, v, 24))
        want = np.asarray(precoding.layer_demap(jnp.asarray(lay)))
        got = tprecoding.layer_demap(torch.from_numpy(lay))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(
            tprecoding.layer_map(got, v).numpy(), lay)
    for ports in (1, 2, 4):
        for pmi in range(4):
            w = tprecoding.one_layer_codebook(ports, pmi)
            assert np.array_equal(w, precoding.one_layer_codebook(ports, pmi))
            lay = _cplx(rng, (2, 1, 30))
            _close(tprecoding.apply_precoding(torch.from_numpy(lay), w),
                   np.stack([np.asarray(precoding.apply_precoding(
                       jnp.asarray(l), w)) for l in lay]), 1e-6)


@pytest.mark.parametrize("scaling", [1.0, 0.5])
def test_mmse_1xn_matches(scaling):
    rng = np.random.default_rng(61)
    y, h = _cplx(rng, (3, 2, 400)), _cplx(rng, (3, 2, 400))
    nv = np.asarray([0.01, 0.1, 1.0], np.float32)
    w_x, w_nv = equalizer.mmse_1xn(jnp.asarray(y), jnp.asarray(h),
                                   jnp.asarray(nv), scaling)
    x, post = tequalizer.mmse_1xn(torch.from_numpy(y), torch.from_numpy(h),
                                  torch.from_numpy(nv), scaling)
    _close(x, w_x, 1e-5)
    _close(post, w_nv, 1e-5)
    # a Python number as the noise variance
    w_x, w_nv = equalizer.mmse_1xn(jnp.asarray(y), jnp.asarray(h), 0.05,
                                   scaling)
    x, post = tequalizer.mmse_1xn(torch.from_numpy(y), torch.from_numpy(h),
                                  0.05, scaling)
    _close(x, w_x, 1e-5)
    _close(post, w_nv, 1e-5)
    x, post = tequalizer.zf_1xn(torch.from_numpy(y), torch.from_numpy(h),
                                0.05, scaling)
    w_x, w_nv = equalizer.zf_1xn(jnp.asarray(y), jnp.asarray(h), 0.05,
                                 scaling)
    _close(x, w_x, 1e-5)
    _close(post, w_nv, 1e-5)


def test_zf_2x2_matches():
    rng = np.random.default_rng(62)
    y, h = _cplx(rng, (3, 2, 400)), _cplx(rng, (3, 2, 2, 400))
    h[0, :, :, 0] = [[1.0, 2.0], [0.5, 1.0]]          # a singular RE
    nv = np.asarray([0.01, 0.1, 1.0], np.float32)
    for noise_var in (nv, 0.2):
        w_x, w_nv = equalizer.zf_2x2(jnp.asarray(y), jnp.asarray(h),
                                     jnp.asarray(noise_var))
        x, post = tequalizer.zf_2x2(
            torch.from_numpy(y), torch.from_numpy(h),
            torch.from_numpy(noise_var) if isinstance(noise_var, np.ndarray)
            else noise_var)
        # the singular RE's 1e-12 determinant makes it huge on both sides:
        # compare it on its own, relative to itself
        _close(x[..., 1:], np.asarray(w_x)[..., 1:], 1e-5)
        _close(post[..., 1:], np.asarray(w_nv)[..., 1:], 1e-5)
        _close(x[..., :1], np.asarray(w_x)[..., :1], 1e-5)


# ------------------------------------------------------------------ OFDM
MU, NFFT, NSC = 1, 1024, 52 * 12


@pytest.mark.parametrize("offset", [0.25, 0.5])
def test_rx_window_offset_matches(offset):
    """The window advanced into the CP and the per-bin phase undone, as in
    tests/test_ofdm_rx_window.py: against the JAX demodulator, and exact
    enough to give the grid back without a channel."""
    rng = np.random.default_rng(int(offset * 8))
    grid = (_cplx(rng, (2, 14, NSC)) / np.sqrt(2)).astype(np.complex64)
    bb = tofdm.modulate_slot(torch.from_numpy(grid), MU, NFFT)
    got = tofdm.demodulate_slot(bb, NSC, MU, NFFT, rx_window_offset=offset)
    for b in range(2):
        want = np.asarray(ofdm.demodulate_slot(
            jnp.asarray(bb[b].numpy()), NSC, MU, NFFT,
            rx_window_offset=offset))
        _close(got[b], want, 4e-5)
    np.testing.assert_allclose(got.numpy(), grid, atol=2e-4)


def test_rx_window_offset_absorbs_early_arrival():
    """A signal 30 samples early leaks the next symbol into every
    zero-offset window; half a CP of advance leaves the clean timing ramp."""
    rng = np.random.default_rng(3)
    grid = (_cplx(rng, (14, NSC)) / np.sqrt(2)).astype(np.complex64)
    bb = tofdm.modulate_slot(torch.from_numpy(grid)[None], MU, NFFT)[0]
    d = 30
    early = torch.cat([bb[d:], torch.zeros(d, dtype=bb.dtype)])
    ramp = np.exp(2j * np.pi * (np.arange(NSC) - NSC // 2) * d / NFFT)

    def err(out):
        return float(np.mean(np.abs(out.numpy() * np.conj(ramp) - grid) ** 2))

    clean = err(tofdm.demodulate_slot(early, NSC, MU, NFFT,
                                      rx_window_offset=0.5))
    isi = err(tofdm.demodulate_slot(early, NSC, MU, NFFT))
    assert clean < 1e-7 and isi > 100 * max(clean, 1e-12)
    assert torch.equal(tofdm.demodulate_slot(bb, NSC, MU, NFFT),
                       tofdm.demodulate_slot(bb, NSC, MU, NFFT,
                                             rx_window_offset=0.0))


# ---------------------------------------------------- precoded transmit
@pytest.fixture(scope="module")
def pdsch0():
    jsh = gnb_mixed.tiny_mixed().pdsch0          # 2 layers, 34 PRB, 68 PRB
    return jsh, convert.from_jax_sh(jsh)


def test_pdsch_transmit_with_unitary_precoder(pdsch0):
    """Two layers precoded onto two ports by a random unitary matrix."""
    jsh, tsh = pdsch0
    rng = np.random.default_rng(70)
    q, _ = np.linalg.qr(rng.standard_normal((2, 2))
                        + 1j * rng.standard_normal((2, 2)))
    w = q.astype(np.complex64)
    tb = _bits(rng, (2, jsh.tbs))
    grid = torch.zeros((2, 2, 14, 816), dtype=torch.complex64)
    got = tsch.pdsch_transmit(torch.from_numpy(tb), tsh, grid, w=w)
    tx = jax.jit(lambda t: sch.pdsch_transmit(
        t, jsh, jnp.zeros((2, 14, 816), jnp.complex64), w=w))
    for b in range(2):
        _close(got[b], np.asarray(tx(jnp.asarray(tb[b]))), 1e-5)
    # not the identity mapping
    plain = tsch.pdsch_transmit(torch.from_numpy(tb), tsh, grid)
    assert not torch.allclose(plain, got)


@pytest.mark.parametrize("pmi", [0, 1, 2, 3])
def test_pdsch_transmit_one_layer_codebook(pmi):
    """One layer with a one-layer codebook entry: the layer is mapped as
    it is (as in the JAX function), and precoding its grid onto the two
    ports gives the JAX ports."""
    jsh = gnb_mixed.tiny_mixed().pdsch1
    tsh = convert.from_jax_sh(jsh)
    w = tprecoding.one_layer_codebook(2, pmi)
    tb = _bits(np.random.default_rng(80 + pmi), (2, jsh.tbs))
    grid = torch.zeros((2, 14, 816), dtype=torch.complex64)
    got = tsch.pdsch_transmit(torch.from_numpy(tb), tsh, grid, w=w)
    tx = jax.jit(lambda t: sch.pdsch_transmit(
        t, jsh, jnp.zeros((14, 816), jnp.complex64), w=w))
    ports = tprecoding.apply_precoding(got.reshape(2, 1, -1), w)
    for b in range(2):
        want = np.asarray(tx(jnp.asarray(tb[b])))
        _close(got[b], want, 1e-5)
        _close(ports[b].reshape(2, 14, 816),
               np.asarray(precoding.apply_precoding(
                   jnp.asarray(want).reshape(1, -1), w)).reshape(2, 14, 816),
               1e-5)
