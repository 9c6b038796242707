"""Parity of the port's mixed slot with the JAX package (CPU): the MIMO
stages (layer mapping, precoding, the two-layer estimator and equaliser,
two-layer PUSCH transmit and receive, reserved REs, the UE-side symbol
check), the slot's own checks, the whole ``tiny_mixed`` slot with the JAX
noise draws and its options (the TDL channel, the UE-side decode, the grid
PRACH, the checks off), the slot pipeline, the configuration conversion,
and the port's independence from JAX.

Inputs are made with numpy from a seed.  The port works on a leading slot
batch; every batched port call is made with two distinct slots and held
against the JAX function slot by slot, which pins each reduction that the
JAX code makes over the rx-port axis 0 to the right axis under the batch.
The JAX slot decodes with its XLA decoder on the CPU and the port with the
Pallas semantics, so the whole slot is compared where every codeblock
converges (``tiny_mixed`` at 20 dB).
"""
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srsran_project_23_5_tpu.models import gnb_mixed
from srsran_project_23_5_tpu.ops import equalizer, estimator, precoding
from srsran_project_23_5_tpu.phy.upper import sch, ulsch
from srsran_project_23_5_tpu.testing import channels
from srsran_project_23_5_tpu_torch import convert
from srsran_project_23_5_tpu_torch.models import gnb_mixed as tmixed
from srsran_project_23_5_tpu_torch.ops import equalizer as tequalizer
from srsran_project_23_5_tpu_torch.ops import estimator as testimator
from srsran_project_23_5_tpu_torch.ops import precoding as tprecoding
from srsran_project_23_5_tpu_torch.ops.ldpc import decoder_cuda
from srsran_project_23_5_tpu_torch.phy import pipeline as tpipeline
from srsran_project_23_5_tpu_torch.phy.upper import sch as tsch
from srsran_project_23_5_tpu_torch.ran.constants import LLR_MAX
from srsran_project_23_5_tpu_torch.testing import channels as tchannels

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B = 2
_BOOL_FIELDS = ("ok", "ul0_ok", "ul1_ok", "dl0_ok", "dl1_ok", "dci_crc_ok",
                "pucch_ok", "prach_ok")


def _cplx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _close(got, want, rel):
    """|got - want| <= rel · max|want| elementwise (float32 in two
    frameworks: other reduction and FFT orders)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _jax_noise(key, sigma, slot_samples):
    """The JAX slot's draws: (downlink, uplink) noise [2 rx, samples]."""
    k_dl, k_ul = jax.random.split(key)
    out = []
    for k in (k_dl, k_ul):
        nz = (sigma / np.sqrt(2)) * jax.random.normal(
            k, (2, 2, slot_samples), jnp.float32)
        out.append(jax.lax.complex(nz[0], nz[1]))
    return out


@pytest.fixture(scope="module")
def tiny():
    """The JAX ``tiny_mixed`` slot for B distinct slots (one compile), with
    its payloads and noise draws."""
    jax.clear_caches()     # XLA:CPU faults on accumulated giant compiles
    jcfg = gnb_mixed.tiny_mixed()
    tcfg = convert.from_jax_mixed(jcfg)
    payloads = gnb_mixed.make_payloads(jcfg, np.random.default_rng(0),
                                       batch=B)
    keys = [jax.random.PRNGKey(7 + b) for b in range(B)]
    fn = jax.jit(lambda p, k: gnb_mixed.mixed_slot_dict(p, k, jcfg))
    want = [{k: np.asarray(v) for k, v in fn(
        {n: x[b] for n, x in payloads.items()}, keys[b]).items()}
        for b in range(B)]
    sigma = tmixed.noise_sigma(tcfg)
    noise = [[np.asarray(x) for x in _jax_noise(k, sigma, jcfg.slot_samples)]
             for k in keys]
    return {
        "jcfg": jcfg, "tcfg": tcfg, "want": want,
        "payloads": {k: torch.from_numpy(np.array(v))
                     for k, v in payloads.items()},
        "noise_dl": torch.from_numpy(np.stack([n[0] for n in noise])),
        "noise_ul": torch.from_numpy(np.stack([n[1] for n in noise])),
        "keys": keys}


# ---------------------------------------------------------- configuration
def test_default_mixed_shapes():
    """273 PRB, nfft 4096, 64QAM: every UE at BG1; the decoder state of
    each codeblock takes under half the shared memory a block may hold, so
    two CTAs share an SM."""
    cfg = tmixed.default_mixed()
    assert (cfg.nfft, cfg.nsc, cfg.slot_samples) == (4096, 3276, 61440)
    want = {  # name: (PRBs, layers, TBS, Z, CBs, rv0 n_used, state B)
        "pdsch0": (136, 2, 127080, 384, 16, 34, 62_976),
        "pdsch1": (117, 1, 55304, 384, 7, 34, 62_976),
        "pusch0": (136, 2, 139376, 384, 17, 35, 66_816),
        "pusch1": (119, 1, 61480, 352, 8, 36, 64_768)}
    for name, (nprb, layers, tbs, z, c, n_used, state) in want.items():
        sh = getattr(cfg, name)
        seg = sh.segments
        assert (sh.nof_prb, sh.nof_layers, sh.tbs) == (nprb, layers, tbs)
        assert (seg.base_graph, seg.lifting_size, seg.nof_segments) == (
            1, z, c), name
        assert decoder_cuda.used_blocks(1, z, max(sh.cb_lengths)) == n_used
        assert decoder_cuda.state_bytes(1, z, n_used) == state
        assert 2 * state <= 232_448
    assert cfg.pdsch0.reserved_patterns == ((5, (0,)),)


@pytest.mark.parametrize("name", ["tiny", "default"])
def test_from_jax_mixed_round_trip(name):
    jcfg = gnb_mixed.tiny_mixed() if name == "tiny" else \
        gnb_mixed.default_mixed()
    tcfg = convert.from_jax_mixed(jcfg)
    assert tcfg == (tmixed.tiny_mixed() if name == "tiny"
                    else tmixed.default_mixed())
    for ue in ("pdsch0", "pdsch1", "pusch0", "pusch1"):
        jsh, tsh = getattr(jcfg, ue), getattr(tcfg, ue)
        fields = dataclasses.asdict(tsh)
        fields["uci"] = ulsch.UciOnPusch(**fields["uci"])
        assert sch.ShConfig(**fields) == jsh
        for attr in ("nof_bits", "cb_lengths", "symbol_plan",
                     "reserved_keep_offsets", "nof_data_re"):
            assert getattr(tsh, attr) == getattr(jsh, attr), (ue, attr)
        for a, b in zip(tsh.data_re_indices, jsh.data_re_indices):
            assert np.array_equal(a, b)
    for sub in ("pdcch_dl", "pdcch_ul", "ssb", "csi_rs", "pucch"):
        for f in dataclasses.fields(getattr(tcfg, sub)):
            assert (getattr(getattr(tcfg, sub), f.name)
                    == getattr(getattr(jcfg, sub), f.name)), (sub, f.name)
    assert (dataclasses.asdict(tcfg.pdcch_dl.code)
            == dataclasses.asdict(jcfg.pdcch_dl.code))
    for f in ("nsc", "slot_samples", "prach_cp", "prach_delay"):
        assert getattr(tcfg, f) == getattr(jcfg, f)


@pytest.mark.parametrize("over,field", [
    (lambda c: gnb_mixed.tdl_channel(c), "tdl_delays"),
    (lambda c: dataclasses.replace(c, prach_time_domain=False),
     "prach_time_domain"),
    (lambda c: dataclasses.replace(c, ue_decode_dl=True), "ue_decode_dl"),
    (lambda c: dataclasses.replace(c, verify_dl_sch=False), "verify_dl_sch"),
    (lambda c: dataclasses.replace(c, verify_dl_ctrl=False),
     "verify_dl_ctrl"),
    (lambda c: dataclasses.replace(
        c, pdcch_ul=dataclasses.replace(c.pdcch_ul, interleaved=True)),
     "interleaved"),
    (lambda c: dataclasses.replace(
        c, pdcch_dl=dataclasses.replace(c.pdcch_dl, nof_symbols=2)),
     "nof_symbols"),
    (lambda c: dataclasses.replace(
        c, pusch0=dataclasses.replace(c.pusch0, nof_layers=3)), "nof_layers"),
    pytest.param(lambda c: dataclasses.replace(c, tdl_gains=(1.0, 0.5)),
                 "tdl_gains", id="tdl_gains"),
    pytest.param(lambda c: dataclasses.replace(
        c, pdcch_dl=dataclasses.replace(c.pdcch_dl, interleaved=True)),
        "interleaved", id="pdcch_dl-interleaved"),
    pytest.param(lambda c: dataclasses.replace(
        c, pdcch_ul=dataclasses.replace(c.pdcch_ul, nof_symbols=3)),
        "nof_symbols", id="pdcch_ul-nof_symbols")])
def test_from_jax_mixed_refuses_unported_fields(over, field):
    """Every field of the JAX mixed slot is carried over, field by field,
    the TDL channel, both PRACH occasions, the UE-side decode, the check
    switches and interleaved or multi-symbol CORESETs among them; only a
    3-layer shared channel is still refused."""
    jcfg = over(gnb_mixed.tiny_mixed())
    if field == "nof_layers":
        with pytest.raises(NotImplementedError, match=f"\\.{field}"):
            convert.from_jax_mixed(jcfg)
        return
    tcfg = convert.from_jax_mixed(jcfg)
    assert_carried(tcfg, jcfg)
    assert tcfg != tmixed.tiny_mixed()


def assert_carried(tcfg, jcfg) -> None:
    """The port's config holds every field of the JAX one, equal value for
    value (nested configs field by field)."""
    assert ([f.name for f in dataclasses.fields(tcfg)]
            == [f.name for f in dataclasses.fields(jcfg)])
    for f in dataclasses.fields(tcfg):
        t, j = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(t):
            assert_carried(t, j)
        else:
            assert t == j, f.name


# -------------------------------------------------------------------- MIMO
@pytest.mark.parametrize("layers,qm", [(1, 2), (2, 2), (2, 6), (4, 4)])
def test_layer_map_and_demap_exact(layers, qm):
    rng = np.random.default_rng(layers * 10 + qm)
    syms = _cplx(rng, (B, 24 * layers))
    want = np.asarray(precoding.layer_map(jnp.asarray(syms), layers))
    got = tprecoding.layer_map(torch.from_numpy(syms), layers)
    assert np.array_equal(got.numpy(), want)
    llr = rng.standard_normal((B, layers, 12 * qm)).astype(np.float32)
    assert np.array_equal(
        tprecoding.layer_demap_llr(torch.from_numpy(llr), qm).numpy(),
        np.asarray(precoding.layer_demap_llr(jnp.asarray(llr), qm)))


def test_apply_precoding_matches():
    rng = np.random.default_rng(3)
    lay = _cplx(rng, (B, 2, 300))
    w = np.asarray([[1, 1], [1j, -1j], [0.5, 0]], np.complex64) / np.sqrt(2)
    want = np.asarray(precoding.apply_precoding(jnp.asarray(lay), w))
    _close(tprecoding.apply_precoding(torch.from_numpy(lay), w), want, 1e-6)
    assert np.array_equal(tprecoding.identity_precoder(4, 2),
                          precoding.identity_precoder(4, 2))


@pytest.mark.parametrize("nof_prb,ndmrs", [(34, 3), (136, 3), (8, 1)])
def test_estimate_comb2_occ2_matches(nof_prb, ndmrs):
    rng = np.random.default_rng(nof_prb)
    npil = 6 * nof_prb
    tx = _cplx(rng, (ndmrs, npil)) / np.float32(np.sqrt(2))
    rx = _cplx(rng, (B, 2, ndmrs, npil))
    got = testimator.estimate_comb2_occ2(torch.from_numpy(rx),
                                         torch.from_numpy(tx))
    for b in range(B):
        want = estimator.estimate_comb2_occ2(jnp.asarray(rx[b]),
                                             jnp.asarray(tx))
        _close(got.h_alloc[b], want.h_alloc, 1e-6)
        for f in ("noise_var", "epre", "rsrp"):
            np.testing.assert_allclose(getattr(got, f)[b].numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-5)


def test_zf_nx2_matches():
    rng = np.random.default_rng(5)
    y = _cplx(rng, (B, 2, 500))
    # the slot's unitary channel, estimated with errors: well conditioned
    h = (gnb_mixed.H_UL[None, :, :, None] + _cplx(rng, (B, 2, 2, 500), 0.2)
         ).astype(np.complex64)
    nv = np.asarray([0.01, 0.2], np.float32)
    x, pnv = tequalizer.zf_nx2(torch.from_numpy(y), torch.from_numpy(h),
                               torch.from_numpy(nv))
    for b in range(B):
        wx, wnv = equalizer.zf_nx2(jnp.asarray(y[b]), jnp.asarray(h[b]),
                                   jnp.float32(nv[b]))
        _close(x[b], wx, 1e-5)
        np.testing.assert_allclose(pnv[b].numpy(), np.asarray(wnv),
                                   rtol=1e-5)


# ---------------------------------------------------- two-layer shared channel
@functools.lru_cache(maxsize=None)
def _jax_fns(ue):
    """Jitted JAX transmit (one slot's TB onto a [2, 14, nsc] or [14, nsc]
    grid), receive front half and symbol check of one tiny_mixed UE."""
    cfg = getattr(gnb_mixed.tiny_mixed(), ue)
    shape = (2, 14, 816) if cfg.nof_layers == 2 else (14, 816)
    tx = jax.jit(lambda t: sch.pusch_transmit(
        t, cfg, jnp.zeros(shape, jnp.complex64)))
    demod = jax.jit(lambda g: sch.pusch_demodulate(g, cfg))
    verify = jax.jit(lambda r, t: sch.symbol_verify(r, t, cfg))
    return tx, demod, verify


def _jax_tx(ue, tb):
    return np.asarray(_jax_fns(ue)[0](jnp.asarray(tb)))


@pytest.mark.parametrize("ue", ["pusch0", "pdsch0", "pusch1", "pdsch1"])
def test_pusch_transmit_matches(ue):
    """Two-layer transmit (pusch0; pdsch0 with its reserved RE) and the
    single-layer UEs of the slot."""
    jsh = getattr(gnb_mixed.tiny_mixed(), ue)
    tsh = convert.from_jax_sh(jsh)
    rng = np.random.default_rng(6)
    tb = rng.integers(0, 2, size=(B, jsh.tbs)).astype(np.int8)
    shape = (B, 2, 14, 816) if jsh.nof_layers == 2 else (B, 14, 816)
    got = tsch.pusch_transmit(torch.from_numpy(tb), tsh,
                              torch.zeros(shape, dtype=torch.complex64))
    for b in range(B):
        want = _jax_tx(ue, tb[b])
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0, atol=1e-6)
        for part in (np.real, np.imag):
            assert np.array_equal(np.sign(part(got[b].numpy())),
                                  np.sign(part(want)))
    if ue == "pdsch0":   # the reserved RE (symbol 5, offset 0) stays empty
        assert not got[..., 5, 0:816:12].abs().any()


def _rx_grids(ue, rng, snr_db=15.0):
    """B distinct noisy two-port receptions of one UE's transmission."""
    jsh = getattr(gnb_mixed.tiny_mixed(), ue)
    tb = rng.integers(0, 2, size=(B, jsh.tbs)).astype(np.int8)
    tx = np.stack([_jax_tx(ue, tb[b]) for b in range(B)])
    if jsh.nof_layers == 1:
        tx = tx[:, None]
    h = gnb_mixed.H_UL if jsh.nof_layers == 2 else gnb_mixed.H1_UL[:, None]
    sigma = 10 ** (-snr_db / 20) / np.sqrt(2)
    rx = (np.einsum("pq,bqsk->bpsk", h, tx)
          + _cplx(rng, (B, 2, 14, 816), sigma)).astype(np.complex64)
    return tb, tx, rx


@pytest.mark.parametrize("ue", ["pusch0", "pusch1", "pdsch0"])
def test_pusch_demodulate_matches(ue):
    jsh = getattr(gnb_mixed.tiny_mixed(), ue)
    tsh = convert.from_jax_sh(jsh)
    tb, _, rx = _rx_grids(ue, np.random.default_rng(7))
    got = tsch.pusch_demodulate(torch.from_numpy(rx), tsh)
    codeword = tsch._encode_sch(torch.from_numpy(tb), tsh)
    check = tsch.symbol_check(got, codeword)
    assert float(check.min()) > 0.99
    for b in range(B):
        want = _jax_fns(ue)[1](jnp.asarray(rx[b]))
        assert abs(float(check[b]) - float(sch.symbol_check(
            want, jnp.asarray(codeword[b].numpy())))) <= 2.0 / tsh.nof_bits
        w_llr = np.asarray(want.llr_full)
        # float32 estimate/ZF/demap chain: 1e-4 of the LLR clip
        np.testing.assert_allclose(got.llr_full[b].numpy(), w_llr, rtol=0,
                                   atol=1e-4 * LLR_MAX)
        assert np.array_equal(got.llr_full[b].numpy() <= 0, w_llr <= 0)
        assert np.array_equal(got.sch_llr[b].numpy() < 0,
                              np.asarray(want.sch_llr) < 0)
        for f in ("noise_var", "rsrp", "evm", "post_noise_var"):
            np.testing.assert_allclose(getattr(got, f)[b].numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-4, atol=1e-7)
    assert (got.ta_norm is None) == (jsh.nof_layers == 2)


@pytest.mark.parametrize("ue", ["pdsch0", "pdsch1"])
def test_symbol_verify_matches(ue):
    """The UE-side check at tiny_mixed's pdsch0 (two layers, reserved RE)
    and pdsch1, on B distinct slots; tx_grid[:2] / [:1] of the JAX code
    are port slices under the batch."""
    jsh = getattr(gnb_mixed.tiny_mixed(), ue)
    tsh = convert.from_jax_sh(jsh)
    _, tx, rx = _rx_grids(ue, np.random.default_rng(8), snr_db=12.0)
    # the transmitted grid of the one-layer UE rides a two-port grid
    tx_t = torch.from_numpy(tx if jsh.nof_layers == 2 else tx[:, 0])
    got = tsch.symbol_verify(torch.from_numpy(rx), tx_t, tsh)
    for b in range(B):
        want = _jax_fns(ue)[2](jnp.asarray(rx[b]), jnp.asarray(
            tx[b] if jsh.nof_layers == 2 else tx[b, 0]))
        n_re = jsh.nof_data_re * jsh.nof_layers
        assert abs(float(got[0][b]) - float(want[0])) <= 2.0 / n_re
        np.testing.assert_allclose(float(got[1][b]), float(want[1]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(got[2][b]), float(want[2]),
                                   rtol=1e-4)
    assert float(got[0].min()) > 0.95


# ------------------------------------------------------ the slot's checks
def test_block_and_pdcch_checks_match(tiny):
    """_block_check and _pdcch_check on B distinct received grids."""
    jcfg, tcfg = tiny["jcfg"], tiny["tcfg"]
    rng = np.random.default_rng(9)
    tx = _cplx(rng, (B, 14, 816), 0.7)
    tx[..., ::5] = 0                         # unoccupied REs
    rx = (gnb_mixed.H_DL[None, :, 0, None, None] * tx[:, None]
          + _cplx(rng, (B, 2, 14, 816), 0.1)).astype(np.complex64)
    got = tmixed._block_check(torch.from_numpy(rx[:, :, 2:6, 60:300]),
                              torch.from_numpy(tx[:, 2:6, 60:300]))
    match, llr = tmixed._pdcch_check(torch.from_numpy(rx),
                                     torch.from_numpy(tx), tcfg.pdcch_dl)
    for b in range(B):
        want = gnb_mixed._block_check(jnp.asarray(rx[b, :, 2:6, 60:300]),
                                      jnp.asarray(tx[b, 2:6, 60:300]))
        np.testing.assert_allclose(float(got[b]), float(want), rtol=1e-4)
        w_match, w_llr = gnb_mixed._pdcch_check(
            jnp.asarray(rx[b]), jnp.asarray(tx[b]), jcfg.pdcch_dl)
        assert abs(float(match[b]) - float(w_match)) <= 2.0 / (24 * 9)
        _close(llr[b], w_llr, 1e-5)
        assert np.array_equal(llr[b].numpy() <= 0, np.asarray(w_llr) <= 0)


def test_prach_rx_window_matches(tiny):
    jcfg, tcfg = tiny["jcfg"], tiny["tcfg"]
    assert np.array_equal(tmixed._prach_burst_np(tcfg),
                          gnb_mixed._prach_burst_np(jcfg))
    rx = _cplx(np.random.default_rng(10), (B, 2, jcfg.slot_samples))
    got = tmixed._prach_rx_window(torch.from_numpy(rx), tcfg)
    for b in range(B):
        _close(got[b], gnb_mixed._prach_rx_window(jnp.asarray(rx[b]), jcfg),
               1e-5)


def test_vmapped_keys_give_the_same_draws(tiny):
    """The noise of a batch drawn under vmap equals the per-slot draws."""
    jcfg, tcfg = tiny["jcfg"], tiny["tcfg"]
    sigma = tmixed.noise_sigma(tcfg)
    keys = jnp.stack(tiny["keys"])
    dl, ul = jax.vmap(lambda k: _jax_noise(k, sigma, jcfg.slot_samples))(keys)
    assert np.array_equal(np.asarray(dl), tiny["noise_dl"].numpy())
    assert np.array_equal(np.asarray(ul), tiny["noise_ul"].numpy())
    assert not np.array_equal(np.asarray(dl[0]), np.asarray(dl[1]))


# --------------------------------------------------------------- the slot
def test_mixed_slot_matches_jax_with_same_noise(tiny):
    res = tmixed.mixed_slot_batch(tiny["payloads"], tiny["noise_dl"],
                                  tiny["noise_ul"], tiny["tcfg"])
    jcfg = tiny["jcfg"]
    re_counts = {"dl0_match": jcfg.pdsch0.nof_data_re * 2,
                 "dl1_match": jcfg.pdsch1.nof_data_re,
                 "pdcch_match": jcfg.pdcch_dl.aggregation_level * 6 * 9}
    for b, want in enumerate(tiny["want"]):
        for f in _BOOL_FIELDS:
            assert bool(getattr(res, f)[b]) == bool(want[f]), (b, f)
        assert bool(want["ok"])
        for f, n in re_counts.items():
            assert abs(float(getattr(res, f)[b]) - float(want[f])) <= 2.0 / n
        for f in ("sinr_ul_db", "sinr_ul0_db", "sinr_ul1_db", "sinr_dl0_db",
                  "csi_sinr_db"):
            assert abs(float(getattr(res, f)[b]) - float(want[f])) < 0.05, f
        assert abs(float(res.prach_ta_samples[b])
                   - float(want["prach_ta_samples"])) < 0.01
        for f in ("pucch_metric", "prach_metric", "ssb_match", "pss_corr"):
            np.testing.assert_allclose(float(getattr(res, f)[b]),
                                       float(want[f]), rtol=1e-3)


# the slot's options, each against the JAX slot with the JAX noise draws:
# the JAX test's TDL slot (symbol checks, time-domain PRACH through the
# taps); the TDL slot with the UE-side decode and the grid PRACH; the
# downlink checks off
_VARIANTS = {
    "tdl": lambda: gnb_mixed.tdl_channel(
        gnb_mixed.tiny_mixed(snr_db=25.0), delays=(0, 3, 7),
        gains_db=(0.0, -4.0, -8.0)),
    "tdl-ue_decode-grid_prach": lambda: gnb_mixed.tdl_channel(
        gnb_mixed.tiny_mixed(ue_decode_dl=True, prach_time_domain=False)),
    "checks_off": lambda: gnb_mixed.tiny_mixed(verify_dl_sch=False,
                                               verify_dl_ctrl=False),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_mixed_slot_variant_matches_jax_with_same_noise(variant):
    jax.clear_caches()     # XLA:CPU faults on accumulated giant compiles
    jcfg = _VARIANTS[variant]()
    tcfg = convert.from_jax_mixed(jcfg)
    assert_carried(tcfg, jcfg)
    payloads = gnb_mixed.make_payloads(jcfg, np.random.default_rng(5),
                                       batch=B)
    keys = [jax.random.PRNGKey(2 + b) for b in range(B)]
    fn = jax.jit(lambda p, k: gnb_mixed.mixed_slot_dict(p, k, jcfg))
    sigma = tmixed.noise_sigma(tcfg)
    noise = [_jax_noise(k, sigma, jcfg.slot_samples) for k in keys]
    res = tmixed.mixed_slot_batch(
        {k: torch.from_numpy(np.array(v)) for k, v in payloads.items()},
        *(torch.from_numpy(np.stack([np.asarray(n[i]) for n in noise]))
          for i in range(2)), tcfg)
    dl_bits = {"dl0_match": jcfg.pdsch0.nof_bits,
               "dl1_match": jcfg.pdsch1.nof_bits}
    for b in range(B):
        want = {k: np.asarray(v) for k, v in fn(
            {n: x[b] for n, x in payloads.items()}, keys[b]).items()}
        assert bool(want["ok"]), (variant, want)
        for f in _BOOL_FIELDS:
            assert bool(getattr(res, f)[b]) == bool(want[f]), (b, f)
        for f, n in dl_bits.items():
            # symbol-check fraction (per RE) or hard-bit fraction (per bit)
            assert abs(float(getattr(res, f)[b]) - float(want[f])) <= 2.0 / n
        for f in ("sinr_ul_db", "sinr_ul0_db", "sinr_ul1_db", "sinr_dl0_db",
                  "csi_sinr_db"):
            assert abs(float(getattr(res, f)[b]) - float(want[f])) < 0.01, f
        assert abs(float(res.prach_ta_samples[b])
                   - float(want["prach_ta_samples"])) < 0.01
        for f in ("pdcch_match", "pucch_metric", "prach_metric", "ssb_match",
                  "pss_corr"):
            np.testing.assert_allclose(float(getattr(res, f)[b]),
                                       float(want[f]), rtol=1e-3)


@pytest.mark.parametrize("delays,gains", [
    ((0, 3, 7), (0.0, -4.0, -8.0)), ((0, 4, 9), (0.0, -3.0, -6.0)),
    ((2,), (0.0,)), ((), ())])
def test_tdl_apply_matches(delays, gains):
    """Taps at integer delays (pad + slice) over the last axis, real and
    complex gains; no taps is the identity."""
    rng = np.random.default_rng(len(delays))
    x = _cplx(rng, (B, 2, 500))
    d, g = tchannels.normalize_taps(delays, gains)
    assert (d, g) == channels.normalize_taps(delays, gains)
    for gg in (g, tuple(complex(v) * np.exp(0.3j * i)
                        for i, v in enumerate(g))):
        got = tchannels.tdl_apply(torch.from_numpy(x), d, gg)
        want = np.asarray(channels.tdl_apply(jnp.asarray(x), d, gg))
        _close(got, want, 1e-6)
    assert tmixed.tdl_channel(tmixed.tiny_mixed()) == convert.from_jax_mixed(
        gnb_mixed.tdl_channel(gnb_mixed.tiny_mixed()))


def test_mixed_slot_batch_equals_per_slot(tiny):
    cfg = tiny["tcfg"]
    batch = tmixed.mixed_slot_batch(tiny["payloads"], tiny["noise_dl"],
                                    tiny["noise_ul"], cfg)
    for b in range(B):
        one = tmixed.mixed_slot({k: v[b] for k, v in tiny["payloads"].items()},
                                tiny["noise_dl"][b], tiny["noise_ul"][b], cfg)
        for f in dataclasses.fields(batch):
            got, want = getattr(one, f.name), getattr(batch, f.name)[b]
            assert got.shape == () and torch.equal(got, want), f.name


def test_mixed_slot_checks_are_not_vacuous(tiny):
    """Uplink noise 20 dB up on slot 0 fails both PUSCH there; downlink
    noise 20 dB up on slot 1 fails its PDSCH and control checks; the other
    slot of each batch still passes.  The DCI re-check fails on noise."""
    cfg, pay = tiny["tcfg"], tiny["payloads"]
    loud = torch.tensor([10.0, 1.0])[:, None, None]
    res = tmixed.mixed_slot_batch(pay, tiny["noise_dl"],
                                  tiny["noise_ul"] * loud, cfg)
    assert res.ul0_ok.tolist() == [False, True]
    assert res.ul1_ok.tolist() == [False, True]
    assert res.ok.tolist() == [False, True]
    assert res.dl0_ok.all() and res.pdcch_match.min() > 0.99
    res = tmixed.mixed_slot_batch(pay, tiny["noise_dl"] * loud.flip(0),
                                  tiny["noise_ul"], cfg)
    assert res.dl0_ok.tolist() == [True, False]
    assert res.dl1_ok.tolist() == [True, False]
    assert res.ok.tolist() == [True, False]
    assert bool(res.ul0_ok.all() and res.ul1_ok.all() and res.prach_ok.all())
    noise = torch.from_numpy(np.random.default_rng(13).standard_normal(
        cfg.pdcch_dl.e).astype(np.float32))
    assert not bool(tmixed._dci_recheck(noise, pay["dci_dl"][0], cfg))


def test_slot_pipeline_mixed_cpu(tiny):
    cfg = tiny["tcfg"]
    pipe = tpipeline.SlotPipeline(
        tpipeline.PipelineConfig(carrier=None, slots_per_batch=B, depth=2),
        device="cpu", seed=1, batch_fn=tmixed.batch_fn_for_pipeline(cfg))
    payloads = tmixed.make_payloads(cfg, np.random.default_rng(11), B, "cpu")
    _, ok, sinr = pipe.warmup(payloads)
    assert ok.all() and abs(float(sinr.mean()) - cfg.snr_db) < 1.0
    for _ in range(2):
        pipe.submit(payloads)
    results = pipe.drain()
    assert len(results) == 2 and all(ok.all() for ok, _ in results)
    with pytest.raises(ValueError, match="needs config.carrier"):
        tpipeline.SlotPipeline(tpipeline.PipelineConfig(carrier=None),
                               device="cpu")


def test_make_payloads_match_jax():
    jcfg = gnb_mixed.tiny_mixed()
    want = gnb_mixed.make_payloads(jcfg, np.random.default_rng(12), batch=3)
    got = tmixed.make_payloads(convert.from_jax_mixed(jcfg),
                               np.random.default_rng(12), 3, "cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.int8
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    assert tmixed.symbol_gate(6, 20.0) == gnb_mixed.symbol_gate(6, 20.0)
    assert tmixed.hard_match_gate(2, 20.0) == gnb_mixed.hard_match_gate(2, 20.0)


def test_gnb_mixed_imports_no_jax():
    """The mixed slot, the pipeline and the conversion load neither JAX nor
    anything of the JAX package."""
    code = ("import sys\n"
            "import srsran_project_23_5_tpu_torch.models.gnb_mixed\n"
            "import srsran_project_23_5_tpu_torch.phy.pipeline\n"
            "import srsran_project_23_5_tpu_torch.convert\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m.split('.')[0] == 'srsran_project_23_5_tpu')\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
