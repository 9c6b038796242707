"""Parity of the port's fronthaul path with the JAX package (CPU): BFP
compression, eCPRI/VLAN/U-plane/C-plane serdes, the OFH sector, the RUs, the
radio sessions and the TRX driver, the ``ran`` helpers, the tracing and
benchmark harnesses, and the public names the ported modules gained.

- ``compress_prbs`` gives JAX's bytes at w ∈ {9, 12, 14, 16}, 24 and 273
  PRB, on seeded inputs with ties at .5 LSB (both round half to even).  The
  exponent is exact here (``torch.frexp``) where JAX's float32
  ``ceil(log2(·))`` is one too small next to powers of two; the PRBs of the
  edge set where the two differ are listed (``EDGE_PRBS``), and JAX's
  mantissas there sit on the clip.  Every other PRB is byte-equal.
- The sector's frames are JAX's byte for byte; its UL grids and counters are
  JAX's, on every case of ``tests/test_ofh_ru.py``.  At 273 PRB (two
  U-plane messages per symbol) the JAX sector closes the slot at the first
  message of the last symbol and drops the second (``rx_no_cplane`` 1, 18
  PRBs of symbol 13 missing); the port completes the slot on its PRBs: that
  section is the one listed difference.
- Floats: grids after OFDM within 1e-5 of max|ref|; everything else equal.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srsran_project_23_5_tpu import ofh as jofh
from srsran_project_23_5_tpu import radio as jradio
from srsran_project_23_5_tpu import ru as jru
from srsran_project_23_5_tpu.ofh import compression as jcomp
from srsran_project_23_5_tpu.ofh import ecpri as jecpri
from srsran_project_23_5_tpu.ofh import ethernet as jethernet
from srsran_project_23_5_tpu.ofh import serdes as jserdes
from srsran_project_23_5_tpu.ops import dmrs as jdmrs
from srsran_project_23_5_tpu.ops import gold as jgold
from srsran_project_23_5_tpu.ops.ldpc import graphs as jgraphs
from srsran_project_23_5_tpu.phy.upper import sch as jsch
from srsran_project_23_5_tpu.radio import trx as jtrx
from srsran_project_23_5_tpu.ran import band_helper as jband
from srsran_project_23_5_tpu.ran import ldpc_params as jldpc_params
from srsran_project_23_5_tpu.ran import numerology as jnum
from srsran_project_23_5_tpu.ran import prach_config as jprach_config
from srsran_project_23_5_tpu.ran import sliv as jsliv
from srsran_project_23_5_tpu.ran import ssb_patterns as jssb
from srsran_project_23_5_tpu.utils import benchmark as jbenchmark
from srsran_project_23_5_tpu.utils import tracing as jtracing
from srsran_project_23_5_tpu_torch import convert
from srsran_project_23_5_tpu_torch import ofh as tofh
from srsran_project_23_5_tpu_torch import radio as tradio
from srsran_project_23_5_tpu_torch import ru as tru
from srsran_project_23_5_tpu_torch.fapi import scf
from srsran_project_23_5_tpu_torch.models import fapi_carrier
from srsran_project_23_5_tpu_torch.ofh import compression as tcomp
from srsran_project_23_5_tpu_torch.ofh import ecpri, ethernet, serdes
from srsran_project_23_5_tpu_torch.ops import dmrs as tdmrs
from srsran_project_23_5_tpu_torch.ops import gold as tgold
from srsran_project_23_5_tpu_torch.ops.ldpc import graphs as tgraphs
from srsran_project_23_5_tpu_torch.phy.upper import sch as tsch
from srsran_project_23_5_tpu_torch.phy.upper import upper_phy as tupper_phy
from srsran_project_23_5_tpu_torch.radio import trx as ttrx
from srsran_project_23_5_tpu_torch.ran import band_helper as tband
from srsran_project_23_5_tpu_torch.ran import ldpc_params as tldpc_params
from srsran_project_23_5_tpu_torch.ran import numerology as tnum
from srsran_project_23_5_tpu_torch.ran import prach_config as tprach_config
from srsran_project_23_5_tpu_torch.ran import sliv as tsliv
from srsran_project_23_5_tpu_torch.ran import ssb_patterns as tssb
from srsran_project_23_5_tpu_torch.utils import benchmark as tbenchmark
from srsran_project_23_5_tpu_torch.utils import tracing as ttracing

torch.set_num_threads(1)

CPU = "cpu"


def _rand_iq(nof_prb, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nof_prb, 12))
            + 1j * rng.standard_normal((nof_prb, 12))
            ).astype(np.complex64) * scale / np.sqrt(2)


def _rand_grid(nof_prb, seed, scale=0.2, nsym=14):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nsym, nof_prb * 12))
            + 1j * rng.standard_normal((nsym, nof_prb * 12))
            ).astype(np.complex64) * scale


def _snr_db(ref, got):
    return 10 * np.log10(np.mean(np.abs(ref) ** 2)
                         / np.mean(np.abs(np.asarray(got) - ref) ** 2))


# -------------------------------------------------------------- compression
def _tie_iq(nof_prb, seed):
    """Seeded IQ with PRBs whose mantissas fall on .5 LSB (exponent 0: the
    PRB's max stays below 2^(w-1) - 1), and an all-zero PRB."""
    iq = _rand_iq(nof_prb, seed)
    half = (np.arange(12) - 5.5).astype(np.float32) / np.float32(32767.0)
    iq[1] = half + 1j * (half * 3)
    iq[2] = (half * 5) + 1j * (-half * 7)
    iq[3] = 0
    return iq


@pytest.mark.parametrize("nof_prb", [24, 273])
@pytest.mark.parametrize("width", [9, 12, 14, 16])
def test_compress_prbs_bytes_equal_jax(width, nof_prb):
    iq = _tie_iq(nof_prb, seed=nof_prb + width)
    want = jcomp.compress_prbs(iq, width)
    got = tcomp.compress_prbs(iq, width)
    assert len(got) == nof_prb * tcomp.compressed_prb_size(width)
    assert got == want
    back = tcomp.decompress_prbs(got, nof_prb, width)
    np.testing.assert_array_equal(back, jcomp.decompress_prbs(want, nof_prb,
                                                              width))
    if width < 16:
        # the .5 ties round half to even: exponent 0, mantissa = round(x)
        scaled = np.float32(32767.0) * np.float32(iq[1].real)
        np.testing.assert_array_equal(back[1].real * np.float32(32767.0),
                                      np.round(scaled))
        assert set(np.abs(scaled) % 1) == {0.5}


def _edge_iq():
    """One PRB per value 2^k − 1 ± 0..3 float32 steps (k = 1..16, scaled to
    ±1): each PRB's largest magnitude; next to 2^k the float32 log2 rounds."""
    vals = []
    for k in range(1, 17):
        v0 = np.float32((2.0 ** k - 1) / 32767.0)
        for d in range(-3, 4):
            v = v0
            for _ in range(abs(d)):
                v = np.nextafter(v, np.float32(np.sign(d) * np.inf))
            vals.append(v)
    vals = np.asarray(vals, np.float32)
    rng = np.random.default_rng(7)
    iq = (rng.uniform(-0.5, 0.5, (len(vals), 12))
          + 1j * rng.uniform(-0.5, 0.5, (len(vals), 12))).astype(np.complex64)
    iq *= (vals / 2)[:, None]
    iq[:, 5] = vals * np.where(np.arange(len(vals)) % 2, 1, -1)
    return iq


# PRBs of _edge_iq() where JAX's jnp.ceil(jnp.log2(max + 1)) is one below
# the exact ceil(log2(·)): each one gives JAX a mantissa on the clip
EDGE_PRBS = {9: [54, 55, 61, 62, 68, 69, 75, 76, 82, 83, 96, 97, 109, 110,
                 111],
             12: [75, 76, 82, 83, 96, 97, 109, 110, 111],
             14: [96, 97, 109, 110, 111]}


@pytest.mark.parametrize("width", sorted(EDGE_PRBS))
def test_bfp_exponent_edges(width):
    iq = _edge_iq()
    flat = np.empty((len(iq), 24), np.float32)
    flat[:, 0::2], flat[:, 1::2] = iq.real, iq.imag
    jexp, jmant = (np.asarray(a) for a in jcomp.bfp_params(
        jnp.asarray(flat), width))
    texp, tmant = (a.numpy() for a in tcomp.bfp_params(
        torch.from_numpy(flat), width))
    # the exact rule, in float64 on the float32 value max(max|x|, 1) + 1
    y = np.maximum(np.abs(flat * np.float32(32767.0)).max(-1),
                   np.float32(1.0)) + np.float32(1.0)
    exact = np.maximum(np.ceil(np.log2(y.astype(np.float64))) - (width - 1),
                       0)
    np.testing.assert_array_equal(texp, exact)
    edge = list(np.nonzero(jexp != texp)[0])
    assert edge == EDGE_PRBS[width]
    np.testing.assert_array_equal(texp[edge] - jexp[edge], 1)
    lim = 2 ** (width - 1)
    assert all(np.abs(jmant[p]).max() in (lim - 1, lim) for p in edge)
    # every other PRB: the same exponent, mantissas and bytes
    rest = [p for p in range(len(iq)) if p not in edge]
    np.testing.assert_array_equal(tmant[rest], jmant[rest])
    size = tcomp.compressed_prb_size(width)
    want = jcomp.compress_prbs(iq, width)
    got = tcomp.compress_prbs(iq, width)
    assert [p for p in range(len(iq))
            if got[p * size:(p + 1) * size] != want[p * size:(p + 1) * size]
            ] == edge


@pytest.mark.parametrize("width", [9, 12, 14, 16])
def test_slot_functions_are_the_prb_functions(width):
    grid = _rand_grid(273, seed=width).reshape(14, 273, 12)
    wire = tcomp.compress_slot(torch.from_numpy(grid), width)
    assert wire.dtype == torch.uint8 and tuple(wire.shape) == (
        14, 273, tcomp.compressed_prb_size(width))
    for s in (0, 6, 13):
        assert wire[s].numpy().tobytes() == tcomp.compress_prbs(grid[s],
                                                                width)
    back = tcomp.decompress_slot(wire, width)
    np.testing.assert_array_equal(
        back[6].numpy(), tcomp.decompress_prbs(wire[6].numpy().tobytes(),
                                               273, width))
    assert _snr_db(grid, back.numpy()) > 40 + 6 * (width - 9)


def test_bfp_params_and_reconstruct_match_jax():
    flat = np.random.default_rng(5).standard_normal((3, 40, 24)).astype(
        np.float32)
    jexp, jmant = jcomp.bfp_params(jnp.asarray(flat), 9)
    texp, tmant = tcomp.bfp_params(torch.from_numpy(flat), 9)
    np.testing.assert_array_equal(texp.numpy(), np.asarray(jexp))
    np.testing.assert_array_equal(tmant.numpy(), np.asarray(jmant))
    np.testing.assert_array_equal(
        tcomp.bfp_reconstruct(texp, tmant).numpy(),
        np.asarray(jcomp.bfp_reconstruct(jexp, jmant)))


@pytest.mark.parametrize("width", [9, 12, 14])
def test_bfp_roundtrip_snr(width):
    iq = _rand_iq(24)
    wire = tcomp.compress_prbs(iq, width)
    assert wire == jcomp.compress_prbs(iq, width)
    back = tcomp.decompress_prbs(wire, 24, width)
    assert _snr_db(iq, back) > 40 + 6 * (width - 9)


def test_none_compression_is_16bit_exact():
    iq = _rand_iq(8)
    back = tcomp.decompress_prbs(tcomp.compress_prbs(iq, 16), 8, 16)
    assert np.max(np.abs(back - iq)) < 1.0 / 32767
    # native little-endian int16, I and Q interleaved
    raw = np.frombuffer(tcomp.compress_prbs(iq, 16), "<i2")
    assert raw[1] == np.round(np.float32(iq[0, 0].imag) * np.float32(32767))


# ------------------------------------------------------------------- serdes
def test_ecpri_roundtrip():
    pkt = ecpri.encode(ecpri.EcpriHeader(ecpri.MSG_TYPE_IQ_DATA, 0x12, 7),
                       b"abc")
    assert pkt == jecpri.encode(jecpri.EcpriHeader(0, 0x12, 7), b"abc")
    h, payload = ecpri.decode(pkt)
    assert (h.msg_type, h.pc_id, h.seq_id, payload) == (0, 0x12, 7, b"abc")


def test_vlan_roundtrip():
    p = ethernet.VlanFrameParams(b"\x01" * 6, b"\x02" * 6, vlan_id=5, pcp=3)
    frame = ethernet.encode(p, b"ecpri-bytes")
    assert frame == jethernet.encode(jethernet.VlanFrameParams(
        b"\x01" * 6, b"\x02" * 6, vlan_id=5, pcp=3), b"ecpri-bytes")
    back, payload = ethernet.decode(frame)
    assert back.vlan_id == 5 and back.pcp == 3 and payload == b"ecpri-bytes"


@pytest.mark.parametrize("width", [9, 16])
def test_uplane_roundtrip(width):
    iq = _rand_iq(16, scale=0.2)        # within int16 full scale at w=16
    msg = serdes.UplaneMessage(
        serdes.TimingHeader(serdes.DIR_UL, 37, 5, 1, 9), 3, 32, 16, iq, width)
    data = serdes.uplane_encode(msg)
    assert data == jserdes.uplane_encode(jserdes.UplaneMessage(
        jserdes.TimingHeader(jserdes.DIR_UL, 37, 5, 1, 9), 3, 32, 16, iq,
        width))
    back = serdes.uplane_decode(data)
    want = jserdes.uplane_decode(data)
    t = back.timing
    assert (t.frame, t.subframe, t.slot, t.symbol) == (37, 5, 1, 9)
    assert (back.section_id, back.start_prb, back.nof_prb,
            back.comp_width) == (3, 32, 16, width)
    np.testing.assert_array_equal(back.iq, want.iq)
    assert _snr_db(iq, back.iq) > 40
    # the header alone: the payload stays compressed
    hdr = serdes.uplane_decode_header(data)
    assert hdr.iq == data[10:] and hdr.comp_width == width


def test_uplane_width_and_prb_count_rules():
    """width 0 on the wire is 16 (the 4-bit field), nprb 0 is 256."""
    iq = _rand_iq(256)
    data = serdes.uplane_encode(serdes.UplaneMessage(
        serdes.TimingHeader(serdes.DIR_DL, 1, 2, 3, 4), 0, 0, 256, iq, 16))
    assert data[7] == 0 and data[8] >> 4 == 0
    back, want = serdes.uplane_decode(data), jserdes.uplane_decode(data)
    assert (back.nof_prb, back.comp_width) == (want.nof_prb,
                                               want.comp_width) == (256, 16)
    np.testing.assert_array_equal(back.iq, want.iq)


def test_cplane_roundtrip():
    s = serdes.CplaneSection(
        serdes.TimingHeader(serdes.DIR_DL, 2, 3, 1, 0), 1, 0, 106, 14)
    data = serdes.cplane_encode(s)
    assert data == jserdes.cplane_encode(jserdes.CplaneSection(
        jserdes.TimingHeader(jserdes.DIR_DL, 2, 3, 1, 0), 1, 0, 106, 14))
    back = serdes.cplane_decode(data)
    assert (back.start_prb, back.nof_prb, back.nof_symbols) == (0, 106, 14)


# ------------------------------------------------------------------ sector
_COUNTERS = ("tx_frames", "rx_frames", "rx_dropped", "rx_filtered",
             "rx_duplicates", "rx_seq_errors", "rx_no_cplane")


def _sectors(mod, nof_prb, **kw):
    frames = []
    tx = mod.OfhSector(mod.OfhSectorConfig(nof_prb=nof_prb), frames.append,
                       **kw)
    rx = mod.OfhSector(mod.OfhSectorConfig(nof_prb=nof_prb, eaxc_ul=0),
                       lambda f: None, **kw)
    got = {}
    rx.on_ul_slot = lambda key, grid: got.update({key: np.asarray(grid)})
    return frames, tx, rx, got


def _run_pair(nof_prb, grid, deliver, key=(1, 0, 0)):
    """The same slot through the JAX and the port sector pairs, frames
    delivered by deliver(frames, rx) → per package (frames, grids,
    counters of both sectors)."""
    out = []
    for mod, kw in ((jofh, {}), (tofh, {"device": CPU})):
        frames, tx, rx, got = _sectors(mod, nof_prb, **kw)
        tx.transmit_dl_slot(*key, grid)
        sent = list(frames)
        deliver(sent, rx)
        out.append((sent, got, {c: getattr(s, c) for s in (tx, rx)
                                for c in _COUNTERS}))
    return out


def _assert_same(pair):
    (jframes, jgot, jcnt), (tframes, tgot, tcnt) = pair
    assert tframes == jframes
    assert tgot.keys() == jgot.keys()
    for k in jgot:
        np.testing.assert_array_equal(tgot[k], jgot[k])
    assert tcnt == jcnt


def _in_order(frames, rx):
    for f in frames:
        rx.handle_rx_frame(f)


def test_ofh_sector_slot_roundtrip():
    grid = _rand_grid(24, seed=3)
    pair = _run_pair(24, grid, _in_order, key=(7, 2, 1))
    _assert_same(pair)
    frames, got, cnt = pair[1]
    assert len(frames) == 15 and (7, 2, 1) in got   # 1 C-plane + 14 U-plane
    assert _snr_db(grid, got[(7, 2, 1)]) > 40
    # the port's sector hands up a tensor on its device
    _, tx, rx, _ = _sectors(tofh, 24, device=CPU)
    seen = []
    rx.on_ul_slot = lambda key, g: seen.append(g)
    tx.transmit_dl_slot(0, 0, 0, torch.from_numpy(grid))
    assert seen == []
    tx._send = rx.handle_rx_frame
    tx.transmit_dl_slot(0, 0, 1, torch.from_numpy(grid))
    assert isinstance(seen[0], torch.Tensor) and seen[0].device.type == CPU


def test_ofh_slot_273_prb_round_trip():
    """At 273 PRB each symbol is two U-plane messages (255 + 18 PRB): 29
    frames per slot, JAX's bytes.  The listed difference: the JAX sector
    drops the last symbol's second message (rx_no_cplane 1), the port's
    completes the slot on every PRB."""
    grid = _rand_grid(273, seed=11)
    (jframes, jgot, jcnt), (tframes, tgot, tcnt) = _run_pair(273, grid,
                                                            _in_order)
    assert tframes == jframes and len(tframes) == 29
    jg, tg = jgot[(1, 0, 0)], tgot[(1, 0, 0)]
    lost = np.zeros((14, 273), bool)
    lost[13, 255:] = True
    per_prb = np.abs(jg - tg).reshape(14, 273, 12).max(-1) > 0
    np.testing.assert_array_equal(per_prb, lost)
    assert not jg.reshape(14, 273, 12)[lost].any()
    np.testing.assert_array_equal(
        tg.reshape(14, 273, 12)[~lost], jg.reshape(14, 273, 12)[~lost])
    assert _snr_db(grid, tg) > 40
    assert jcnt.pop("rx_no_cplane") == 1 and tcnt.pop("rx_no_cplane") == 0
    assert tcnt == jcnt


def _two_slots_one_lost(nof_prb, grid, lost):
    """Slots (1, 0, 0) and (1, 0, 1) of the same grid through the JAX and
    the port sector pairs, frame `lost` of the first slot dropped → per
    package (grids handed up, counters of both sectors, the receiver)."""
    out = []
    for mod, kw in ((jofh, {}), (tofh, {"device": CPU})):
        frames, tx, rx, got = _sectors(mod, nof_prb, **kw)
        tx.transmit_dl_slot(1, 0, 0, grid)
        del frames[lost]
        tx.transmit_dl_slot(1, 0, 1, grid)
        _in_order(frames, rx)
        out.append((got, {c: getattr(s, c) for s in (tx, rx)
                          for c in _COUNTERS}, rx))
    return out


def test_ofh_slot_273_prb_lost_section_is_handed_up_zeroed():
    """At 273 PRB a lost 18-PRB message (symbol 4) leaves the slot short of
    those PRBs: the port's sector hands it up, with them zero, when the next
    slot's C-plane window opens; the JAX sector hands it up at the last
    symbol's first message, short of that symbol's 18 PRBs as well."""
    grid = _rand_grid(273, seed=13)
    (jgot, jcnt, _), (tgot, tcnt, rx) = _two_slots_one_lost(
        273, grid, 1 + 2 * 4 + 1)
    assert jgot.keys() == tgot.keys() == {(1, 0, 0), (1, 0, 1)}
    per_prb = lambda a, b: np.abs(a - b).reshape(14, 273, 12).max(-1) > 0
    lost, last = np.zeros((14, 273), bool), np.zeros((14, 273), bool)
    lost[4, 255:] = last[13, 255:] = True
    t0, t1 = tgot[(1, 0, 0)], tgot[(1, 0, 1)]
    assert _snr_db(grid, t1) > 40
    np.testing.assert_array_equal(per_prb(t0, t1), lost)
    assert not t0.reshape(14, 273, 12)[lost].any()
    np.testing.assert_array_equal(per_prb(jgot[(1, 0, 0)], t0), last)
    np.testing.assert_array_equal(per_prb(jgot[(1, 0, 1)], t1), last)
    assert rx.rx_incomplete_slots == 1 and not rx._ul_slots
    assert jcnt.pop("rx_no_cplane") == 2 and tcnt.pop("rx_no_cplane") == 0
    assert tcnt == jcnt and tcnt["rx_seq_errors"] == 1


def test_ofh_rx_lost_symbol_loses_the_slot():
    """Up to 255 PRB a lost U-plane message is a whole symbol: neither
    sector hands the slot up; the port's drops it when the next slot's
    C-plane window opens and keeps nothing of it."""
    grid = _rand_grid(24, seed=14)
    (jgot, jcnt, _), (tgot, tcnt, rx) = _two_slots_one_lost(24, grid, 5)
    assert jgot.keys() == tgot.keys() == {(1, 0, 1)}
    np.testing.assert_array_equal(tgot[(1, 0, 1)], jgot[(1, 0, 1)])
    assert tcnt == jcnt
    assert rx.rx_incomplete_slots == 1 and not rx._ul_slots
    assert list(rx._cp_windows) == []


def test_ofh_sector_drops_garbage():
    for mod, kw in ((jofh, {}), (tofh, {"device": CPU})):
        sector = mod.OfhSector(mod.OfhSectorConfig(nof_prb=24),
                               lambda f: None, **kw)
        sector.handle_rx_frame(b"\x00" * 10)
        assert sector.rx_dropped == 1


def test_ofh_rx_filters_foreign_eaxc():
    def deliver(frames, rx):
        rx.cfg.eaxc_ul = 9                 # expect a different stream
        _in_order(frames, rx)
    pair = _run_pair(24, _rand_grid(24, seed=11), deliver)
    _assert_same(pair)
    frames, got, cnt = pair[1]
    assert not got and cnt["rx_filtered"] == len(frames)


def test_ofh_rx_duplicate_frames_dropped():
    def deliver(frames, rx):
        for f in frames:
            rx.handle_rx_frame(f)
            rx.handle_rx_frame(f)          # exact duplicate of every frame
    grid = _rand_grid(24, seed=11)
    pair = _run_pair(24, grid, deliver)
    _assert_same(pair)
    frames, got, cnt = pair[1]
    assert cnt["rx_duplicates"] == len(frames)
    assert _snr_db(grid, got[(1, 0, 0)]) > 40


def test_ofh_rx_out_of_order_counts_seq_errors_but_completes():
    def deliver(frames, rx):
        frames[3], frames[4] = frames[4], frames[3]
        _in_order(frames, rx)
    pair = _run_pair(24, _rand_grid(24, seed=11), deliver)
    _assert_same(pair)
    assert (1, 0, 0) in pair[1][1] and pair[1][2]["rx_seq_errors"] >= 1


def test_ofh_rx_uplane_without_cplane_dropped():
    def deliver(frames, rx):
        _in_order(frames[1:], rx)          # drop the C-plane frame
    pair = _run_pair(24, _rand_grid(24, seed=11), deliver)
    _assert_same(pair)
    frames, got, cnt = pair[1]
    assert not got and cnt["rx_no_cplane"] == len(frames) - 1

    def late(frames, rx):                  # late C-plane, re-sent U-plane
        _in_order(frames[1:], rx)
        _in_order(frames, rx)
    pair = _run_pair(24, _rand_grid(24, seed=11), late)
    _assert_same(pair)
    assert (1, 0, 0) in pair[1][1]


def test_ofh_rx_without_cplane_window_when_not_required():
    def deliver(frames, rx):
        rx.require_cplane = False
        _in_order(frames[1:], rx)
    pair = _run_pair(24, _rand_grid(24, seed=12), deliver)
    _assert_same(pair)
    assert (1, 0, 0) in pair[1][1] and pair[1][2]["rx_no_cplane"] == 0


def test_ofh_rx_refuses_a_section_outside_the_grid():
    frames = []
    tx = tofh.OfhSector(tofh.OfhSectorConfig(nof_prb=24), frames.append,
                        device=CPU)
    tx.transmit_dl_slot(1, 0, 0, _rand_grid(24, seed=1))
    small = tofh.OfhSector(tofh.OfhSectorConfig(nof_prb=12, eaxc_ul=0),
                           lambda f: None, device=CPU)
    small.handle_rx_frame(frames[0])
    with pytest.raises(ValueError):
        small.handle_rx_frame(frames[1])


# ---------------------------------------------------------------------- RU
def test_ru_generic_ofdm_loopback():
    grid = _rand_grid(24, seed=5, scale=1.0)
    cfg = tru.RuConfig(nof_prb=24, mu=1)
    assert cfg.nfft == jru.RuConfig(nof_prb=24, mu=1).nfft
    ru = tru.RuGeneric(cfg, tradio.create_radio("loopback"), device=CPU)
    got = {}
    ru.on_ul_grid = lambda ctx, g: got.update({ctx: g})
    ru.handle_dl_grid((0, 0, 0), grid)
    ru.trigger_ul_slot((0, 0, 0))
    back = got[(0, 0, 0)]
    assert isinstance(back, torch.Tensor)
    assert np.mean(np.abs(back.numpy() - grid) ** 2) < 1e-6
    jr = jru.RuGeneric(jru.RuConfig(nof_prb=24, mu=1),
                       jradio.create_radio("loopback"))
    jgot = {}
    jr.on_ul_grid = lambda ctx, g: jgot.update({ctx: g})
    jr.handle_dl_grid((0, 0, 0), jnp.asarray(grid))
    jr.trigger_ul_slot((0, 0, 0))
    want = np.asarray(jgot[(0, 0, 0)])
    assert np.abs(back.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    # nothing buffered: no grid, an underflow
    ru.trigger_ul_slot((0, 0, 1))
    assert (0, 0, 1) not in got and ru.radio.underflow_count == 1


def test_ru_generic_stays_on_its_device_through_a_channel():
    """A channel function of the in-memory radio gets the baseband tensor
    and can act on it where it lies; ports ride a leading dimension."""
    seen = []

    def channel(x):
        seen.append(x)
        return 2 * x
    ru = tru.RuGeneric(tru.RuConfig(nof_prb=12), tradio.InMemoryRadio(
        channel), device=CPU)
    got = []
    ru.on_ul_grid = lambda ctx, g: got.append(g)
    grid = torch.from_numpy(np.stack([_rand_grid(12, s) for s in (1, 2)]))
    ru.handle_dl_grid((0, 0, 0), grid)
    ru.trigger_ul_slot((0, 0, 0))
    assert isinstance(seen[0], torch.Tensor) and seen[0].shape[0] == 2
    assert ru._ts == seen[0].shape[-1]
    assert torch.allclose(got[0], 2 * grid, atol=1e-5)


def test_ru_ofh_wraps_sector():
    frames, jframes = [], []
    ru = tru.RuOfh(tru.RuConfig(nof_prb=24), frames.append, device=CPU)
    jr = jru.RuOfh(jru.RuConfig(nof_prb=24), jframes.append)
    got, jgot = {}, {}
    ru.on_ul_grid = lambda ctx, g: got.update({ctx: g})
    jr.on_ul_grid = lambda ctx, g: jgot.update({ctx: g})
    grid = np.full((14, 24 * 12), 0.1 + 0.1j, dtype=np.complex64)
    ru.handle_dl_grid((1, 2, 3), torch.from_numpy(grid))
    jr.handle_dl_grid((1, 2, 3), grid)
    assert frames == jframes and frames
    for f in frames:
        ru.handle_rx_frame(f)
        jr.handle_rx_frame(f)
    np.testing.assert_array_equal(got[(1, 2, 3)].numpy(),
                                  np.asarray(jgot[(1, 2, 3)]))


# -------------------------------------------------------------------- radio
def test_in_memory_radio_overflow_and_underflow():
    for mod in (jradio, tradio):
        r = mod.InMemoryRadio()
        for i in range(12):
            r.transmit(np.full(4, i, np.complex64), i)
        assert r.overflow_count == 3
        got = [r.receive()[1] for _ in range(10)]
        assert got == [3, 4, 5, 6, 7, 8, 9, 10, 11, 0]
        assert r.underflow_count == 1


def test_socket_radio_pair():
    a = tradio.create_radio("socket")
    b = tradio.create_radio("socket")
    a.peer = ("127.0.0.1", b.port)
    b.peer = ("127.0.0.1", a.port)
    rng = np.random.default_rng(11)
    samples = (rng.standard_normal(5000)
               + 1j * rng.standard_normal(5000)).astype(np.complex64)
    try:
        a.transmit(torch.from_numpy(samples), timestamp=1234)
        rx, ts = b.receive()
        assert ts == 1234 and isinstance(rx, np.ndarray)
        np.testing.assert_array_equal(rx, samples)
    finally:
        a.stop()
        b.stop()


def test_socket_radio_datagrams_equal_jax():
    """The same datagrams (header, chunking, planes) as the JAX session,
    received by the JAX session."""
    rx = jradio.SocketRadio()
    tx = tradio.SocketRadio(peer=("127.0.0.1", rx.port))
    samples = _rand_iq(400).reshape(-1).astype(np.complex64)  # 3 chunks
    try:
        tx.transmit(samples, timestamp=77)
        got, ts = rx.receive()
        assert ts == 77
        np.testing.assert_array_equal(got, samples)
    finally:
        tx.stop()
        rx.stop()


def test_ru_generic_over_socket_radio():
    """Split 8 over the UDP virtual RF at 52 PRB (nfft 1024): a slot is
    15,360 samples, 8 datagrams, 122,880 B of I/Q, which the socket's
    receive buffer holds until the receiver reads."""
    a, b = tradio.SocketRadio(), tradio.SocketRadio()
    a.peer = ("127.0.0.1", b.port)
    cfg = tru.RuConfig(nof_prb=52)
    tx = tru.RuGeneric(cfg, a, device=CPU)
    rx = tru.RuGeneric(cfg, b, device=CPU)
    got = []
    rx.on_ul_grid = lambda ctx, g: got.append(g)
    grid = _rand_grid(52, seed=4, scale=1.0)
    try:
        tx.handle_dl_grid((0, 0, 0), grid)
        rx.trigger_ul_slot((0, 0, 0))
    finally:
        a.stop()
        b.stop()
    assert tx._ts == 15360
    assert np.mean(np.abs(got[0].numpy() - grid) ** 2) < 1e-6


@pytest.mark.parametrize("kind", ["loopback", "zmq", "socket", "udp", "uhd",
                                  "bogus"])
def test_create_radio(kind):
    for mod in (jradio, tradio):
        if kind == "uhd":
            with pytest.raises(RuntimeError):
                mod.create_radio(kind)
        elif kind == "bogus":
            with pytest.raises(ValueError):
                mod.create_radio(kind)
        else:
            r = mod.create_radio(kind)
            assert type(r).__name__ == {"loopback": "InMemoryRadio",
                                        "zmq": "InMemoryRadio",
                                        "socket": "SocketRadio",
                                        "udp": "SocketRadio"}[kind]
            r.stop()


# ------------------------------------------------------------ TRX driver
def test_trx_driver_stream_and_timestamps():
    a = (np.arange(100) + 1j).astype(np.complex64)
    out = []
    for mod in (jtrx, ttrx):
        trx = mod.TrxDriver(sample_rate_hz=1e6)
        trx.start()
        trx.write(a, timestamp=0)
        r1 = trx.read(60)
        trx.write(a, timestamp=250)
        r2 = trx.read(300)
        trx.write(a, timestamp=trx._rx_cursor - 30)
        out.append((r1, r2, dataclasses.asdict(trx.stats)))
    (j1, j2, js), (t1, t2, ts) = out
    assert t1[1] == 0 and np.array_equal(t1[0], a[:60])
    assert t2[1] == 60 and not t2[0][40:190].any()
    assert ts == js and ts["tx_underflows"] == 1 and ts["tx_late"] == 1
    for (x, tx_), (y, ty) in ((j1, t1), (j2, t2)):
        assert tx_ == ty and np.array_equal(x, y)


def test_trx_gains():
    for mod in (jtrx, ttrx):
        trx = mod.TrxDriver(1e6)
        trx.start()
        trx.set_tx_gain(20.0)
        trx.set_rx_gain(-20.0)
        trx.write(np.ones(10, np.complex64), 0)
        out, _ = trx.read(10)
        np.testing.assert_allclose(np.abs(out), 1.0, rtol=1e-5)


# ------------------------------------------------------------- ran helpers
def test_sliv_roundtrip_exhaustive():
    for n in (14, 12, 7):
        for s in range(n):
            for length in range(1, n - s + 1):
                v = tsliv.sliv_encode(n, s, length)
                assert v == jsliv.sliv_encode(n, s, length)
                assert tsliv.sliv_decode(n, v) == (s, length)


def test_sliv_unique():
    seen = {tsliv.sliv_encode(14, s, length) for s in range(14)
            for length in range(1, 15 - s)}
    assert len(seen) == 14 * 15 // 2


@pytest.mark.parametrize("arfcn", [0, 176_300, 599_999, 600_000, 632_628,
                                   2_016_666, 2_016_667, 2_100_000])
def test_nr_arfcn_raster(arfcn):
    f = tband.nr_arfcn_to_freq_hz(arfcn)
    assert f == jband.nr_arfcn_to_freq_hz(arfcn)
    assert tband.freq_hz_to_nr_arfcn(f) == jband.freq_hz_to_nr_arfcn(f) \
        == arfcn


def test_band_lookup_and_duplex():
    assert tband.FR1_BANDS == tuple(tband.BandInfo(**dataclasses.asdict(b))
                                    for b in jband.FR1_BANDS)
    for b in tband.FR1_BANDS:
        assert tband.duplex_mode(b.band) == jband.duplex_mode(b.band)
        dl = tband.freq_hz_to_nr_arfcn(b.dl_low_mhz * 1e6 + 1e6)
        assert tband.ul_arfcn_from_dl(b.band, dl) == \
            jband.ul_arfcn_from_dl(b.band, dl)
    for f in (617e6, 1.842e9, 2.6e9, 3.6e9, 4.5e9, 6.1e9):
        assert tband.band_from_dl_freq(f) == jband.band_from_dl_freq(f)
    assert tband.duplex_mode(78) == "TDD" and tband.duplex_mode(3) == "FDD"
    dl = tband.freq_hz_to_nr_arfcn(1842.5e6)
    ul = tband.ul_arfcn_from_dl(3, dl)
    assert abs(tband.nr_arfcn_to_freq_hz(ul) - 1747.5e6) < 1e3


def test_prach_configuration_table():
    for idx in (0, 16, 27, 31, 47):
        assert dataclasses.asdict(tprach_config.prach_configuration(idx)) \
            == dataclasses.asdict(jprach_config.prach_configuration(idx))
    c16 = tprach_config.prach_configuration(16)
    assert c16.format == "0" and c16.x == 1 and c16.subframes == (1,)
    assert tprach_config.prach_slot_match(c16, sfn=5, subframe=1)
    assert not tprach_config.prach_slot_match(c16, sfn=5, subframe=2)
    assert tprach_config.ncs_from_zcz(13, "0", "type_a") == 202


@pytest.mark.parametrize("case", ["A", "B", "C", "c"])
@pytest.mark.parametrize("lmax", [4, 8])
def test_ssb_patterns(case, lmax):
    assert tssb.ssb_first_symbols(case, lmax) == jssb.ssb_first_symbols(
        case, lmax)
    for mu, f, paired in ((0, 2.1e9, True), (1, 3.5e9, False),
                          (1, 1.9e9, True)):
        assert tssb.ssb_case_for(mu, f, paired) == jssb.ssb_case_for(
            mu, f, paired)
    assert tssb.ssb_lmax(2.6e9) == jssb.ssb_lmax(2.6e9) == 4
    with pytest.raises(ValueError):
        tssb.ssb_first_symbols("D", lmax)


# ---------------------------------------------------- tracing and benchmark
def test_event_tracer(tmp_path):
    tr = ttracing.EventTracer()
    with tr.span("off", "ofh"):
        tr.add("n")
    assert tr.records() == []
    tr.enabled = True
    with tr.span("dl", "ofh", req=(1, 2)):
        tr.add("n", 3)
    path = tmp_path / "trace.json"
    tr.write(str(path))
    got = json.loads(path.read_text())
    ev = got["traceEvents"]
    assert [(e["name"], e["ph"]) for e in ev] == [("dl", "X")]
    assert ev[0]["cat"] == "ofh" and ev[0]["dur"] >= 0 and ev[0]["ts"] == 0
    assert ev[0]["args"]["req"] == [1, 2]
    assert ev[0]["args"]["counts"] == {"n": 3}
    assert got["baseTimeNanoseconds"] == tr.records()[0].start_ns
    assert not hasattr(tr, "instant")
    tr.clear()
    assert tr.records() == []
    assert isinstance(ttracing.tracer, ttracing.EventTracer)
    assert not ttracing.tracer.enabled


def test_benchmarker_percentiles_match_jax():
    m = tbenchmark.Measurement("x", [1e-6, 2e-6, 3e-6, 10e-6], 1000.0)
    j = jbenchmark.Measurement("x", [1e-6, 2e-6, 3e-6, 10e-6], 1000.0)
    for q in (50, 90, 99):
        assert m.percentile_us(q) == j.percentile_us(q)
    assert m.median_us == 2.5 and m.throughput_mbps() == j.throughput_mbps()
    calls = []
    b = tbenchmark.Benchmarker("t")
    got = b.run("f", lambda: calls.append(1), reps=5, warmup=2)
    assert len(calls) == 7 and len(got.times_s) == 5
    assert b.report().splitlines()[0] == "== t =="


# ------------------------------------------------ public names of the port
def test_dmrs_type1_helpers_match_jax():
    for args in ((0, 10, 0), (7, 25, 1), (100, 173, 0)):
        np.testing.assert_array_equal(tdmrs.type1_sc_indices(*args),
                                      jdmrs.type1_sc_indices(*args))
        np.testing.assert_array_equal(
            tdmrs.type1_sequence_indices(*args[:2]),
            jdmrs.type1_sequence_indices(*args[:2]))
    rng = np.random.default_rng(2)
    grid = (rng.standard_normal((2, 14, 120))
            + 1j * rng.standard_normal((2, 14, 120))).astype(np.complex64)
    pil = (rng.standard_normal((3, 30))
           + 1j * rng.standard_normal((3, 30))).astype(np.complex64)
    sc = tdmrs.type1_sc_indices(2, 5, 1)
    got = tdmrs.map_onto_symbols(torch.from_numpy(grid),
                                 torch.from_numpy(pil), (2, 7, 11), sc, 0.5)
    want = np.asarray(jdmrs.map_onto_symbols(jnp.asarray(grid),
                                             jnp.asarray(pil), (2, 7, 11),
                                             sc, 0.5))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(grid, want)          # the input is not written
    np.testing.assert_array_equal(
        tdmrs.extract_from_symbols(got, (2, 7, 11), sc).numpy(),
        np.asarray(jdmrs.extract_from_symbols(jnp.asarray(want), (2, 7, 11),
                                              sc)))


@pytest.mark.parametrize("length,offset", [(100, 0), (1000, 37),
                                           (3276, 12 * 136)])
def test_gold_sequence_matches_jax(length, offset):
    cinit = np.array([[0, 1, 12345], [2 ** 31 - 1, 77, 1 << 30]], np.uint32)
    want = np.asarray(jgold.gold_sequence(jnp.asarray(cinit), length,
                                          offset))
    got = tgold.gold_sequence(torch.from_numpy(cinit.astype(np.int64)),
                              length, offset)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_config_properties_match_jax():
    jcfg = jsch.ShConfig(rnti=1, tbs=1000, qm=4, prb_start=3, nof_prb=20)
    tcfg = convert.from_jax_sh(jcfg)
    np.testing.assert_array_equal(tcfg.dmrs_sc_indices, jcfg.dmrs_sc_indices)
    for bg, z in ((1, 384), (2, 52), (1, 36)):
        assert tgraphs.lifted_graph(bg, z).nof_edges == \
            jgraphs.lifted_graph(bg, z).nof_edges
    for tbs, bg in ((40984, 1), (1000, 2), (200, 2)):
        assert tldpc_params.segment_tb(tbs, bg).nof_message_blocks == \
            jldpc_params.segment_tb(tbs, bg).nof_message_blocks
    for mu in range(4):
        assert tnum.slot_duration_s(mu) == jnum.slot_duration_s(mu)
        for slot in range(0, tnum.slots_per_frame(mu), 3):
            assert tnum.SlotPoint(mu, 5, slot).subframe == \
                jnum.SlotPoint(mu, 5, slot).subframe


# ------------------------------------------------- the fronthaul as a path
def test_fapi_carrier_over_split_7_2_cpu():
    """Phase 22 of chip_smoke.py at 68 PRB on the CPU: the carrier's
    SCF-built DL slot through UpperPhy and RuOfh to an RU-side sector, PDSCH
    A decoded from the rebuilt grid; its SCF-built full-mix UL slot from
    four RU-side sectors (one eAxC per rx port, every frame offered to every
    DU-side sector) into UpperPhy: every check passes."""
    car = fapi_carrier.tiny_carrier()
    phy = tupper_phy.UpperPhy(car.upper_phy, CPU)
    gen = torch.Generator().manual_seed(22)
    rng = np.random.default_rng(22)
    # ---- downlink
    sreq, data = fapi_carrier.scf_dl_request(car, 0, rng)
    grid = phy.process_dl_slot(scf.dl_tti_to_processor_request(sreq), data)
    frames, got = [], {}
    ru = tru.RuOfh(tru.RuConfig(nof_prb=car.nof_prb, mu=car.mu),
                   frames.append, device=CPU)
    ru_side = tofh.OfhSector(tofh.OfhSectorConfig(nof_prb=car.nof_prb,
                                                  eaxc_ul=0),
                             lambda f: None, device=CPU)
    ru_side.on_ul_slot = lambda key, g: got.update({key: g})
    ru.handle_dl_grid((0, 0, 0), grid)
    for f in frames:
        ru_side.handle_rx_frame(f)
    rebuilt = got[(0, 0, 0)]
    assert _snr_db(grid.numpy(), rebuilt.numpy()) > 40
    ue = fapi_carrier.downlink(rebuilt, car, gen)
    pdsch_a = scf.dl_tti_to_processor_request(sreq).pdsch_pdus[0].config
    res = tsch.pusch_receive(ue[None], pdsch_a)
    assert bool(res.tb_crc_ok[0]) and np.array_equal(
        res.tb_bits[0].numpy(), data.transport_blocks[0])
    # ---- uplink, 4 eAxCs
    ul = scf.ul_tti_to_processor_request(fapi_carrier.scf_ul_request(car, 2))
    native = fapi_carrier.ul_request(car, 2)
    pay = fapi_carrier.ul_payloads(ul, rng)
    rx, prach_rx = fapi_carrier.uplink(
        dataclasses.replace(ul, prach_pdus=native.prach_pdus), pay, car, gen)
    frames, ports = [], {}
    for p in range(rx.shape[0]):
        tofh.OfhSector(tofh.OfhSectorConfig(nof_prb=car.nof_prb, eaxc_dl=p),
                       frames.append, device=CPU).transmit_dl_slot(
            0, 1, 0, rx[p])
    du = []
    for p in range(rx.shape[0]):
        s = tofh.OfhSector(tofh.OfhSectorConfig(nof_prb=car.nof_prb,
                                                eaxc_ul=p),
                           lambda f: None, device=CPU)
        s.on_ul_slot = lambda key, g, p=p: ports.update({p: g})
        du.append(s)
    for f in frames:
        for s in du:
            s.handle_rx_frame(f)
    assert [s.rx_filtered for s in du] == [3 * 15] * 4
    rebuilt = torch.stack([ports[p] for p in range(rx.shape[0])])
    assert _snr_db(rx.numpy(), rebuilt.numpy()) > 40
    inds = phy.process_ul_slot(rebuilt, ul, slot_count=2, prach_rx=prach_rx)
    checks = fapi_carrier.ul_checks(car, ul, pay, inds,
                                    phy.last_ul_slot["pusch"])
    assert all(checks.values()), checks
