"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere (the kernels have no
CPU mode).  The file imports neither JAX nor the JAX package, so it also
runs on a machine without them:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -q \\
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from srsran_project_23_5_tpu_torch import entry
from srsran_project_23_5_tpu_torch.fapi import messages as fapi
from srsran_project_23_5_tpu_torch.models import (fapi_carrier, gnb_flagship,
                                                  gnb_mixed)
from srsran_project_23_5_tpu_torch.ops.ldpc import (decoder_cuda,
                                                    encoder_cuda, graphs)
from srsran_project_23_5_tpu_torch.ops import channel_mix, modulation, prach
from srsran_project_23_5_tpu_torch.parallel import launch
from srsran_project_23_5_tpu_torch.phy import pipeline
from srsran_project_23_5_tpu_torch.phy.lower import lower_phy, prach_demod
from srsran_project_23_5_tpu_torch.phy.upper import (harq, pdcch, sch,
                                                     slot_programs, ssb,
                                                     upper_phy)
from srsran_project_23_5_tpu_torch.utils import graphs as capture
from srsran_project_23_5_tpu_torch.utils import kernel_taps

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    """The card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _noisy_llr(rng, cw, snr_db, zc):
    sigma = np.broadcast_to(
        10 ** (-np.asarray(snr_db, np.float32) / 20), (cw.shape[0],))[:, None]
    llr = 2.0 * ((1 - 2 * cw.astype(np.float32))
                 + sigma * rng.standard_normal(cw.shape).astype(np.float32)
                 ) / sigma ** 2
    llr[:, :2 * zc] = 0.0
    return llr.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("bg,zc,batch", [
    (2, 384, 88), (1, 384, 16), (2, 36, 13), (1, 2, 3),
    # lifting sizes that 32 (or 16) does not divide: masked last word,
    # byte-wise I/O; several codeblocks per CTA
    (1, 208, 5), (2, 15, 7), (1, 36, 19), (2, 104, 9), (1, 320, 9),
    # the 273-PRB mixed slot at 8 slots per batch: pdsch0, pdsch1, pusch0,
    # pusch1
    (1, 384, 128), (1, 384, 56), (1, 384, 136), (1, 352, 64),
    # a card's step of the flagship273.mesh4 cell: 128 carriers x 5 CBs
    (2, 352, 640)])
def test_encoder_kernel_matches_plain(cuda, bg, zc, batch):
    gen = torch.Generator(device=cuda).manual_seed(10)
    k = graphs.lifted_graph(bg, zc).nof_msg_blocks * zc
    msg = torch.randint(0, 2, (batch, k), generator=gen, device=cuda,
                        dtype=torch.int8)
    before = encoder_cuda.encode.launches
    got = encoder_cuda.encode(msg, bg, zc)
    torch.cuda.synchronize()
    assert encoder_cuda.encode.launches == before + 1
    assert torch.equal(got, encoder_cuda.encode_plain(msg, bg, zc))


@pytest.mark.cuda
@pytest.mark.parametrize("bg,zc,batch,snr,n_used", [
    (2, 384, 88, 2.0, 52), (2, 384, 88, np.linspace(-5, -1, 88), 52),
    (1, 384, 16, np.linspace(1, 5, 16), 40), (2, 36, 13, 3.0, None),
    # the mixed slot's two PUSCH at 8 slots per batch
    (1, 384, 136, 6.0, 35), (1, 384, 136, np.linspace(2, 6, 136), 35),
    (1, 352, 64, 6.0, 36), (1, 352, 64, np.linspace(2, 6, 64), 36),
    # its two PDSCH decoded on the UE side (ue_decode_dl)
    (1, 384, 128, 6.0, 34), (1, 384, 128, np.linspace(2, 6, 128), 34),
    (1, 384, 56, 6.0, 34), (1, 384, 56, np.linspace(2, 6, 56), 34),
    # a card's step of the flagship273.mesh4 cell (BG2, Z=352, 43 blocks)
    (2, 352, 640, 2.0, 43), (2, 352, 640, np.linspace(-5, -1, 640), 43)])
def test_decoder_kernel_matches_plain(cuda, bg, zc, batch, snr, n_used):
    rng = np.random.default_rng(11)
    g = graphs.lifted_graph(bg, zc)
    msg = rng.integers(0, 2, size=(batch, g.nof_msg_blocks * zc)
                       ).astype(np.int8)
    cw = encoder_cuda.encode_plain(torch.from_numpy(msg), bg, zc).numpy()
    llr = _noisy_llr(rng, cw, snr, zc)
    if n_used is not None:
        llr[:, n_used * zc:] = 0.0
    llr = torch.from_numpy(llr).to(cuda)
    for kw in ({}, {"check_period": 2}):
        bits, ok = decoder_cuda.decode(llr, bg, zc, nof_used_blocks=n_used,
                                       **kw)
        w_bits, w_ok = decoder_cuda.decode_plain(llr, bg, zc,
                                                 nof_used_blocks=n_used, **kw)
        torch.cuda.synchronize()
        assert torch.equal(ok, w_ok) and torch.equal(bits, w_bits), kw


def _full_graph_matches_plain(cuda, bg, zc, snr):
    """The full graph (rv>0 and HARQ-combined decodes) on 24 codeblocks:
    bits and ok equal the plain version's; every codeblock converges at
    one SNR, some of them over an SNR sweep."""
    assert decoder_cuda.state_bytes(bg, zc) <= 232_448   # fits on chip
    rng = np.random.default_rng(zc + bg)
    g = graphs.lifted_graph(bg, zc)
    msg = rng.integers(0, 2, size=(24, g.nof_msg_blocks * zc)).astype(np.int8)
    cw = encoder_cuda.encode_plain(torch.from_numpy(msg), bg, zc).numpy()
    llr = torch.from_numpy(_noisy_llr(rng, cw, snr, zc)).to(cuda)
    before = decoder_cuda.decode.launches
    bits, ok = decoder_cuda.decode(llr, bg, zc)
    w_bits, w_ok = decoder_cuda.decode_plain(llr, bg, zc)
    torch.cuda.synchronize()
    assert decoder_cuda.decode.launches == before + 1
    assert torch.equal(ok, w_ok) and torch.equal(bits, w_bits)
    n_ok = int(ok.sum())
    if np.ndim(snr) == 0:
        assert n_ok == 24 and np.array_equal(bits.cpu().numpy(), msg)
    else:
        assert 0 < n_ok < 24, f"{n_ok} of 24 converge: no mixed convergence"


# the flagship273.mesh4 cell's carrier: 273 PRB, QPSK, TBS 17416 (BG2)
EDGE_CARRIER = (273, 2, 17416)


def _cell_pusch(name: str):
    """A PUSCH config of a benchmark cell's carrier and the batch its cell
    runs it at."""
    mixed = gnb_mixed.default_mixed()
    car = fapi_carrier.default_carrier()
    edge = gnb_flagship.default_carrier(*EDGE_CARRIER)
    return {"mixed_pusch0": (mixed.pusch0, 64),
            "mixed_pusch1": (mixed.pusch1, 64),
            "fapi_pusch_a": (car.pusch_a, 1),
            "fapi_pusch_b": (car.pusch_b, 1),
            "flagship_edge": (edge.sh, 128)}[name]


def _llr_stage_inputs(dev, seed, qm, layers, batch, nsym, sign=None):
    """Symbols around the constellation with a few far outside it, a NaN
    symbol, noise variances over six decades with 1e-30, 1e30 and 0 among
    them, a ±1 sign (or the given one)."""
    rng = np.random.default_rng(seed)
    shape = (batch, nsym) if layers == 1 else (batch, layers, nsym)
    x = (0.8 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
         ).astype(np.complex64)
    nv = (10 ** rng.uniform(-3, 3, shape)).astype(np.float32)
    xf, nf = x.reshape(-1), nv.reshape(-1)
    edge = [(5.0 - 3.0j, None), (-40.0 + 1e3j, None), (1e17 + 0.2j, None),
            (np.nan + 0.5j, None), (0.3 + 0.3j, 1e-30), (-0.7 + 0.1j, 1e30),
            (0.1 - 0.9j, 0.0), (0j, 0.0)]
    for k, (sym, var) in enumerate(edge[:xf.size]):
        pos = (k * 7919) % xf.size
        xf[pos] = sym
        if var is not None:
            nf[pos] = var
    if sign is None:
        sign = torch.from_numpy((1 - 2 * rng.integers(
            0, 2, layers * nsym * qm)).astype(np.float32)).to(dev)
    return torch.from_numpy(x).to(dev), torch.from_numpy(nv).to(dev), sign


_LLR_CASES = ([(qm, layers, batch, 1531) for qm in (2, 4, 6, 8)
               for layers in (1, 2, 4) for batch in (1, 3, 64)]
              + [(6, 2, 64, 0), (6, 1, 0, 77), (8, 4, 2, 1), (4, 1, 5, 33),
                 # more rows than the first ticket buffer holds
                 (4, 1, 1500, 3)]
              + ["mixed_pusch0", "mixed_pusch1", "fapi_pusch_a",
                 "fapi_pusch_b", "flagship_edge"])


def _tickets_all_zero() -> bool:
    """Every per-row ticket of the kernel is back at 0 (read after a
    synchronise)."""
    return all(int(t.count_nonzero()) == 0
               for held in modulation._TICKETS.values() for t in held)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _LLR_CASES, ids=str)
def test_pusch_llr_kernel_matches_plain(cuda, case):
    """The PUSCH LLR kernel is bit-identical to the plain chain on the card
    (NaN where it gives NaN), at odd S and at the four PUSCH shapes the
    benchmark cells run, with their own scrambling signs; its EVM is the
    plain EVM of each row's L·S symbols within rtol 1e-5 (the sum's order);
    B = 0 and S = 0 give an empty output and launch nothing (S = 0: the
    plain EVM's NaN); each call with REs is one launch, and leaves every
    row's ticket at 0."""
    if isinstance(case, str):
        cfg, batch = _cell_pusch(case)
        qm, layers = cfg.qm, cfg.nof_layers
        nsym = cfg.nof_bits // (qm * layers)
        _, sign = sch._scramble_seq(cfg.scrambling_cinit, cfg.nof_bits, cuda)
        x, nv, sign = _llr_stage_inputs(cuda, 3, qm, layers, batch, nsym,
                                        sign)
    else:
        qm, layers, batch, nsym = case
        x, nv, sign = _llr_stage_inputs(cuda, qm + layers + batch, qm,
                                        layers, batch, nsym)
    before = modulation.pusch_llr.launches
    got, evm = modulation.pusch_llr(x, nv, sign, qm)
    torch.cuda.synchronize()
    assert got.shape == (batch, layers * nsym * qm) and evm.shape == (batch,)
    assert modulation.pusch_llr.launches == before + (got.numel() > 0)
    assert _tickets_all_zero()
    if got.numel():         # the plain chain cannot reshape an empty batch
        torch.testing.assert_close(
            got, modulation.pusch_llr_plain(x, nv, sign, qm), rtol=0, atol=0,
            equal_nan=True)
    torch.testing.assert_close(evm, modulation.evm_plain(x.flatten(1), qm),
                               rtol=1e-5, atol=0, equal_nan=True)


def _axis_values(qm: int) -> np.ndarray:
    """Per-axis values for the EVM's nearest point: each level, each
    midpoint of two neighbouring levels (a tie where the float32 distances
    come out equal), just beyond the outermost levels, 0 and -0, ±1e17,
    ±inf and NaN."""
    lv = np.sort(modulation.pam_levels(qm))
    mid = ((lv[:-1] + lv[1:]) / np.float32(2)).astype(np.float32)
    edge = np.array([lv[0] * 1.5, lv[-1] * 1.5, lv[0] - 1e-7, lv[-1] + 1e-7,
                     0.0, -0.0, 1e17, -1e17, np.inf, -np.inf, np.nan],
                    np.float32)
    return np.concatenate([lv, mid, np.nextafter(mid, np.float32(np.inf)),
                           edge]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("qm", [2, 4, 6, 8])
def test_pusch_llr_kernel_evm_of_one_re(cuda, qm):
    """Rows of a single RE make the EVM that RE's error magnitude: the
    kernel's is bit-identical to ``evm_plain`` for every pair of axis values
    of ``_axis_values`` (levels, midpoints, beyond the outermost levels,
    1e17, ±inf, NaN), and so are its LLRs to the plain chain's."""
    v = _axis_values(qm)
    re, im = np.meshgrid(v, v, indexing="ij")
    x = torch.from_numpy((re + 1j * im).astype(np.complex64).reshape(-1, 1)
                         ).to(cuda)
    nv = torch.ones(x.shape, device=cuda)
    sign = torch.ones(qm, device=cuda)
    got, evm = modulation.pusch_llr(x, nv, sign, qm)
    torch.cuda.synchronize()
    torch.testing.assert_close(evm, modulation.evm_plain(x, qm), rtol=0,
                               atol=0, equal_nan=True)
    torch.testing.assert_close(got, modulation.pusch_llr_plain(x, nv, sign, qm),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,nsym", [(8, 1531), (64, 17952)])
def test_pusch_llr_kernel_in_a_graph(cuda, batch, nsym):
    """A captured launch replays to the eager call's output on new inputs
    in the same buffers, the EVM to the same bits in each of three replays
    (no float atomics; each launch leaves the row tickets at 0), with one RE
    a thread and (at the mixed slot's pusch0 shape) four; the capture counts
    its one launch; a CPU-side input or a non-contiguous one is refused."""
    qm, layers = 6, 2
    x, nv, sign = _llr_stage_inputs(cuda, 5, qm, layers, batch, nsym)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        modulation.pusch_llr(x, nv, sign, qm)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = modulation.pusch_llr.launches
    with torch.cuda.graph(graph):
        out, evm = modulation.pusch_llr(x, nv, sign, qm)
    assert modulation.pusch_llr.launches == before + 1
    x2, nv2, _ = _llr_stage_inputs(cuda, 6, qm, layers, batch, nsym)
    x.copy_(x2)
    nv.copy_(nv2)
    evms = []
    for _ in range(3):
        graph.replay()
        evms.append(evm.clone())
    torch.cuda.synchronize()
    assert _tickets_all_zero()
    eager, eager_evm = modulation.pusch_llr(x2, nv2, sign, qm)
    torch.testing.assert_close(out, eager, rtol=0, atol=0, equal_nan=True)
    for e in evms:
        torch.testing.assert_close(e, eager_evm, rtol=0, atol=0,
                                   equal_nan=True)
    with pytest.raises(ValueError):
        modulation.pusch_llr(x, nv, sign.cpu(), qm)
    with pytest.raises(ValueError):
        modulation.pusch_llr(x.transpose(1, 2).contiguous().transpose(1, 2),
                             nv, sign, qm)


# the 273-PRB mixed slot's grid, and an odd time-domain length (its slot
# has 61440 samples)
_MIX_TRAILS = {"grid": (14, 273 * 12), "time": (61441,)}


def _mix_inputs(dev, seed, batch, trail, streams):
    """Random (h [2, 2], g [batch, 2, *trail], columns [2], streams)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.complex64)
    return (draw(2, 2), draw(batch, 2, *trail),
            [draw(2) for _ in range(streams)],
            [draw(batch, *trail) for _ in range(streams)])


def _assert_mix_close(got, want):
    """The kernel's mix against the plain expression on the card (cuBLAS
    sums the einsum its own way): within 1e-6 of the largest output
    magnitude, a few float32 steps; contiguous [B, 2, ...]."""
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert got.is_contiguous()
    if want.numel():
        err = float((got - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(_MIX_TRAILS))
@pytest.mark.parametrize("streams", [0, 1, 2])
@pytest.mark.parametrize("batch", [0, 1, 3, 8, 64])
def test_channel_mix_kernel_matches_plain(cuda, batch, streams, shape):
    """The channel mix kernel against ``channel_mix_plain`` at the mixed
    slot's grid and an odd time-domain length, with 0, 1 and 2 single-port
    streams; one launch a call, none for an empty batch."""
    h, g, vecs, xs = _mix_inputs(cuda, 40 + batch + streams, batch,
                                 _MIX_TRAILS[shape], streams)
    before = channel_mix.channel_mix.launches
    got = channel_mix.channel_mix(h, g, vecs, xs)
    torch.cuda.synchronize()
    assert channel_mix.channel_mix.launches == before + (batch > 0)
    _assert_mix_close(got, channel_mix.channel_mix_plain(h, g, vecs, xs))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["sliced", "permuted", "offset_g",
                                    "offset_stream", "conj"])
def test_channel_mix_kernel_takes_any_layout(cuda, layout):
    """A sliced or permuted two-port input, a view one element past an
    aligned start (8-B aligned only), a conjugate view: each mixes as the
    plain expression does on the same views."""
    batch, trail = 3, (14, 273 * 12)
    h, g, vecs, xs = _mix_inputs(cuda, 50, batch, trail, 2)
    if layout == "sliced":
        g = _mix_inputs(cuda, 51, batch, (14, 273 * 12 + 4), 0)[1][..., 2:-2]
    elif layout == "permuted":
        g = g.transpose(0, 1).contiguous().transpose(0, 1)
    elif layout == "offset_g":
        g = torch.cat([g.new_zeros(1), g.reshape(-1)])[1:].view(g.shape)
    elif layout == "offset_stream":
        flat = torch.cat([g.new_zeros(1), xs[0].reshape(-1)])
        xs = [flat[1:].view(xs[0].shape), xs[1]]
    else:
        g, xs = g.conj(), [xs[0], xs[1].conj()]
    if layout.startswith("offset"):
        assert (g.data_ptr() if layout == "offset_g"
                else xs[0].data_ptr()) % 16 == 8
    got = channel_mix.channel_mix(h, g, vecs, xs)
    torch.cuda.synchronize()
    _assert_mix_close(got, channel_mix.channel_mix_plain(h, g, vecs, xs))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 64])
def test_channel_mix_kernel_in_a_program(cuda, batch):
    """The slot's two mixes (DL: no stream; UL: two) captured in a
    ``graphs.Program`` at the mixed slot's grid: the capture counts two
    launches, each replay adds two, and a replay on new inputs equals the
    eager call on them bit for bit and the plain expression within its
    rounding."""
    trail = _MIX_TRAILS["grid"]

    def both(h, g, v1, v2, x1, x2):
        return (channel_mix.channel_mix(h, g),
                channel_mix.channel_mix(h, g, (v1, v2), (x1, x2)))

    def inputs(seed):
        h, g, vecs, xs = _mix_inputs(cuda, seed, batch, trail, 2)
        return (h, g, *vecs, *xs)
    prog = capture.GraphPool(cuda).program(both)
    prog(*inputs(60))
    assert prog.captured_launches["channel_mix"] == 2
    new = inputs(61)
    before = channel_mix.channel_mix.launches
    for _ in range(2):
        dl, ul = prog(*new)
    torch.cuda.synchronize()
    assert channel_mix.channel_mix.launches == before + 4
    h, g, v1, v2, x1, x2 = new
    want_dl, want_ul = prog.eager(*new)
    assert torch.equal(dl, want_dl) and torch.equal(ul, want_ul)
    _assert_mix_close(dl, channel_mix.channel_mix_plain(h, g))
    _assert_mix_close(ul, channel_mix.channel_mix_plain(h, g, (v1, v2),
                                                        (x1, x2)))


@pytest.mark.cuda
@pytest.mark.parametrize("zc", [320, 352, 384])
@pytest.mark.parametrize("snr", [1.5, np.linspace(-1.0, 2.5, 24)])
def test_decoder_kernel_full_bg1_graph_matches_plain(cuda, zc, snr):
    _full_graph_matches_plain(cuda, 1, zc, snr)


@pytest.mark.cuda
@pytest.mark.parametrize("zc", [352, 384])
@pytest.mark.parametrize("snr", [2.0, np.linspace(-5.0, -1.0, 24)])
def test_decoder_kernel_full_bg2_graph_matches_plain(cuda, zc, snr):
    _full_graph_matches_plain(cuda, 2, zc, snr)


@pytest.mark.cuda
@pytest.mark.parametrize("zc,batch", [(384, 136), (352, 64)])
@pytest.mark.parametrize("snr", [1.5, "sweep"])
def test_decoder_kernel_full_graph_harq_batch_shapes(cuda, zc, batch, snr):
    """The HARQ batch's rv=2 and combined decodes of a 273-PRB mixed slot
    at 8 slots per batch: the full BG1 graph, one CTA per SM, so x136 is a
    second wave on 132 SMs."""
    rng = np.random.default_rng(zc)
    g = graphs.lifted_graph(1, zc)
    msg = rng.integers(0, 2, size=(batch, g.nof_msg_blocks * zc)
                       ).astype(np.int8)
    cw = encoder_cuda.encode_plain(torch.from_numpy(msg), 1, zc).numpy()
    snr_db = np.linspace(-1.0, 2.5, batch) if snr == "sweep" else snr
    llr = torch.from_numpy(_noisy_llr(rng, cw, snr_db, zc)).to(cuda)
    bits, ok = decoder_cuda.decode(llr, 1, zc)
    w_bits, w_ok = decoder_cuda.decode_plain(llr, 1, zc)
    torch.cuda.synchronize()
    assert torch.equal(ok, w_ok) and torch.equal(bits, w_bits)
    n_ok = int(ok.sum())
    assert n_ok == batch if snr != "sweep" else 0 < n_ok < batch
    assert decoder_cuda.ctas_per_sm(1, zc, None) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("zc,n_used", [(384, 33), (384, 35), (352, 36)])
def test_decoder_two_ctas_per_sm_at_main_path_shapes(cuda, zc, n_used):
    """At the main path's truncated BG1 graphs two 384-thread CTAs share an
    SM, so the mixed slot's 136 codeblocks are one wave on 132 SMs."""
    assert decoder_cuda.ctas_per_sm(1, zc, n_used) >= 2


@pytest.mark.cuda
def test_upper_phy_ul_slot_with_uci_and_harq_on_card_matches_cpu(cuda):
    """The tiny FAPI carrier's full UL slot (4-layer PUSCH, PUSCH with UCI,
    PUCCH F1/F2, PRACH) and a HARQ pair (rv=0 fails, rv=2 combined passes)
    on the card and on the CPU: the same indications and UCI."""
    car = fapi_carrier.tiny_carrier()
    gen = torch.Generator().manual_seed(14)
    rng = np.random.default_rng(14)
    reqs = [fapi_carrier.ul_request(car, 0),
            fapi_carrier.ul_request(car, 1, full=False, harq_process=15),
            fapi_carrier.ul_request(car, 2, full=False, harq_process=15,
                                    rv=2, new_data=False)]
    pays = [fapi_carrier.ul_payloads(r, rng) for r in reqs[:2]]
    pays.append(pays[1])
    slots = [fapi_carrier.uplink(r, p, car, gen,
                                 snr_db=None if i == 0 else car.harq_snr_db)
             for i, (r, p) in enumerate(zip(reqs, pays))]
    phys = {d: upper_phy.UpperPhy(car.upper_phy, d) for d in ("cpu", cuda)}
    out = {}
    for d, phy in phys.items():
        out[d] = []
        for i, (req, (rx, prach_rx)) in enumerate(zip(reqs, slots)):
            d0, c0 = decoder_cuda.decode.launches, phy.graphs.captures
            inds = phy.process_ul_slot(
                rx.to(d), req, slot_count=i,
                prach_rx=None if prach_rx is None else prach_rx.to(d))
            if d == cuda:
                # one launch per decode group and replay, and the eager
                # warm-up's where the slot captured its program
                groups = slot_programs.decode_groups(
                    slot_programs.signature(req)[0])
                assert decoder_cuda.decode.launches - d0 == len(groups) * (
                    1 + phy.graphs.captures - c0)
            out[d].append((inds, phy.last_ul_slot["pusch"]))
    for i, ((g, g_o), (c, c_o)) in enumerate(zip(out[cuda], out["cpu"])):
        assert [type(x) for x in g] == [type(x) for x in c]
        for a, b in zip(g, c):
            for k, v in vars(b).items():
                if k in ("sinr_db", "ta_samples"):
                    assert abs(getattr(a, k) - v) < 0.1, (i, k)
                elif k == "metric":
                    assert abs(getattr(a, k) - v) <= 1e-3 * max(abs(v), 1.0)
                elif k == "preambles":
                    assert [p[0] for p in getattr(a, k)] == [p[0] for p in v]
                elif isinstance(v, np.ndarray):
                    assert np.array_equal(getattr(a, k), v), (i, k)
                else:
                    assert getattr(a, k) == v, (i, k)
        for a, b in zip(g_o, c_o):
            # the bits of a TB that fails its CRC depend on float rounding
            for f in a:
                if (f.endswith(("_bits", "_valid", "_crc_ok"))
                        and (f != "tb_bits" or b["tb_crc_ok"])):
                    assert np.array_equal(a[f], b[f]), (i, f)
    checks = fapi_carrier.ul_checks(car, reqs[0], pays[0], out[cuda][0][0],
                                    out[cuda][0][1])
    assert all(checks.values()), checks
    crc = [[x.tb_crc_ok for x in inds if isinstance(x, fapi.CrcIndication)]
           for inds, _ in out[cuda][1:]]
    assert crc == [[False], [True]]
    assert len(phys[cuda].softbuffers) == 0


@pytest.mark.cuda
def test_loopback_on_card_matches_cpu_and_uses_both_kernels(cuda):
    cfg = gnb_flagship.tiny_carrier()
    rng = np.random.default_rng(5)
    tb = torch.from_numpy(rng.integers(0, 2, size=(4, cfg.sh.tbs)
                                       ).astype(np.int8))
    sigma = np.sqrt(cfg.nfft) * 10 ** (-10.0 / 20) / np.sqrt(2)
    noise = torch.from_numpy((sigma * (
        rng.standard_normal((4, cfg.slot_samples))
        + 1j * rng.standard_normal((4, cfg.slot_samples)))
    ).astype(np.complex64))
    enc0, dec0 = encoder_cuda.encode.launches, decoder_cuda.decode.launches
    ok, bits, sinr = gnb_flagship.loopback_batch(tb.to(cuda), noise.to(cuda),
                                                 cfg)
    torch.cuda.synchronize()
    assert encoder_cuda.encode.launches == enc0 + 1
    assert decoder_cuda.decode.launches == dec0 + 1
    w_ok, w_bits, w_sinr = gnb_flagship.loopback_batch(tb, noise, cfg)
    assert bool(ok.all()) and torch.equal(ok.cpu(), w_ok)
    assert torch.equal(bits.cpu(), w_bits) and torch.equal(w_bits, tb)
    # cuFFT vs pocketfft: float32 rounding only
    assert float((sinr.cpu() - w_sinr).abs().max()) < 0.1


@pytest.mark.cuda
def test_slot_pipeline_on_card(cuda):
    cfg = gnb_flagship.tiny_carrier()
    pipe = pipeline.SlotPipeline(pipeline.PipelineConfig(
        carrier=cfg, slots_per_batch=4, depth=2), device="cuda", seed=0)
    tb = torch.randint(0, 2, (4, cfg.sh.tbs), device="cuda",
                       dtype=torch.int8)
    _, ok, sinr = pipe.warmup(tb)
    assert ok.all() and abs(float(sinr.mean()) - 20.0) < 1.5
    for _ in range(3):
        pipe.submit(tb)
    results = pipe.drain()
    assert len(results) == 3 and all(ok.all() for ok, _ in results)


_MIXED_FLAGS = ("ok", "ul0_ok", "ul1_ok", "dl0_ok", "dl1_ok", "dci_crc_ok",
                "pucch_ok", "prach_ok")


@pytest.mark.cuda
def test_tiny_mixed_on_card_matches_cpu(cuda):
    cfg = gnb_mixed.tiny_mixed()
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(12), 2, "cpu")
    noise = gnb_mixed.draw_noise(cfg, 2, torch.Generator().manual_seed(12))
    want = gnb_mixed.mixed_slot_batch(pay, *noise, cfg)
    w_dec = gnb_mixed.decode_front(gnb_mixed._mixed_front(pay, *noise, cfg),
                                   cfg)
    g_pay = {k: v.to(cuda) for k, v in pay.items()}
    g_noise = [n.to(cuda) for n in noise]
    enc0, dec0 = encoder_cuda.encode.launches, decoder_cuda.decode.launches
    mix0 = channel_mix.channel_mix.launches
    got = gnb_mixed.mixed_slot_batch(g_pay, *g_noise, cfg)
    torch.cuda.synchronize()
    assert encoder_cuda.encode.launches == enc0 + 4
    assert decoder_cuda.decode.launches == dec0 + 2
    assert channel_mix.channel_mix.launches == mix0 + 2
    assert bool(want.ok.all())
    for f in _MIXED_FLAGS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for f in ("sinr_ul_db", "sinr_dl0_db", "csi_sinr_db"):
        assert float((getattr(got, f).cpu() - getattr(want, f)).abs().max()
                     ) < 0.1, f
    g_dec = gnb_mixed.decode_front(
        gnb_mixed._mixed_front(g_pay, *g_noise, cfg), cfg)
    for k in w_dec:
        assert all(torch.equal(a.cpu(), b) for a, b in zip(g_dec[k], w_dec[k]))


@pytest.mark.cuda
def test_mixed_slot_pipeline_on_card(cuda):
    cfg = gnb_mixed.tiny_mixed()
    pipe = pipeline.SlotPipeline(
        pipeline.PipelineConfig(carrier=None, slots_per_batch=2, depth=2),
        device="cuda", seed=0, batch_fn=gnb_mixed.batch_fn_for_pipeline(cfg))
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(13), 2, "cuda")
    _, ok, sinr = pipe.warmup(pay)
    assert ok.all() and abs(float(sinr.mean()) - 20.0) < 1.0
    for _ in range(3):
        pipe.submit(pay)
    results = pipe.drain()
    assert len(results) == 3 and all(ok.all() for ok, _ in results)


def _replay_vs_eager(pipe, batch, seed: int):
    """One replay of the captured K-batch graph and the eager K-batch loop
    on the same noise: ((ok, sum) replayed, (ok, sum) eager)."""
    noise = pipe.scan_noise(seed)
    ok_r, sum_r = (t.clone() for t in pipe.replay_scan())
    ok_e, sum_e = pipe.scan_step(batch, noise)
    torch.cuda.synchronize()
    return (bool(ok_r), float(sum_r)), (bool(ok_e), float(sum_e))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 64])
def test_mixed_scan_replay_equals_eager(cuda, b):
    """The 273-PRB mixed slot's scan step captured as one CUDA graph at the
    cells' batch sizes, the channel mix kernel in it: a replay equals the
    eager K-batch loop on the same noise (the same kernels on the same
    buffers), each replay counts the launches it captured, and a replay on
    ×100 noise fails (the graph reads the static noise)."""
    cfg = gnb_mixed.default_mixed()
    k = 2
    pipe = pipeline.SlotPipeline(
        pipeline.PipelineConfig(carrier=None, slots_per_batch=b,
                                scan_batches=k),
        device="cuda", seed=0, batch_fn=gnb_mixed.batch_fn_for_pipeline(cfg))
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(31), b, "cuda")
    _, ok, mean = pipe.warmup_scan(pay)
    assert ok and abs(mean - 20.0) < 1.0
    assert pipe.program.captured_launches == {
        "encoder": 4 * k, "decoder": 2 * k, "pusch_llr": 2 * k,
        "channel_mix": 2 * k}
    assert (pipe.graphs.captures, pipe.graphs.replays) == (1, 1)
    replay, eager = _replay_vs_eager(pipe, pay, 5)
    assert replay[0] and replay[0] == eager[0]
    assert abs(replay[1] - eager[1]) <= 1e-6 * abs(eager[1])
    enc0, dec0 = encoder_cuda.encode.launches, decoder_cuda.decode.launches
    mix0 = channel_mix.channel_mix.launches
    for seed in (7, 9):
        pipe.submit_scan(pay, seed)
    all_ok, mean, n = pipe.fetch_accumulated()
    assert all_ok and n == 2 * k * b and abs(mean - 20.0) < 1.0
    assert encoder_cuda.encode.launches == enc0 + 2 * 4 * k
    assert decoder_cuda.decode.launches == dec0 + 2 * 2 * k
    assert channel_mix.channel_mix.launches == mix0 + 2 * 2 * k
    # the noise is drawn into the buffers the graph reads
    assert [t.data_ptr() for t in pipe.scan_noise(5)] == [
        t.data_ptr() for t in pipe.program.inputs[1:]]
    for n in pipe.scan_noise(5):
        n.mul_(100.0)
    assert not bool(pipe.replay_scan()[0])


@pytest.mark.cuda
def test_flagship_scan_capture(cuda):
    """The default loopback in scan mode on the card: capture, replay equal
    to eager, accumulate over two dispatches."""
    cfg = gnb_flagship.tiny_carrier()
    b, k = 4, 3
    pipe = pipeline.SlotPipeline(pipeline.PipelineConfig(
        carrier=cfg, slots_per_batch=b, scan_batches=k), device="cuda",
        seed=1)
    tb = torch.randint(0, 2, (b, cfg.sh.tbs), device="cuda",
                       dtype=torch.int8)
    _, ok, mean = pipe.warmup_scan(tb)
    assert ok and abs(mean - 20.0) < 1.5
    assert pipe.program.captured_launches == {"encoder": k, "decoder": k,
                                              "pusch_llr": k,
                                              "channel_mix": 0}
    replay, eager = _replay_vs_eager(pipe, tb, 3)
    assert replay[0] and replay[0] == eager[0]
    assert abs(replay[1] - eager[1]) <= 1e-6 * abs(eager[1])
    for seed in (4, 5):
        pipe.submit_scan(tb, seed)
    all_ok, _, n = pipe.fetch_accumulated()
    assert all_ok and n == 2 * k * b
    assert pipe.dispatch_latency(tb, 6) > 0.0


@pytest.mark.cuda
def test_accumulate_on_card_equals_drain(cuda):
    cfg = gnb_mixed.tiny_mixed()
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(32), 2, "cuda")

    def pipe():
        return pipeline.SlotPipeline(
            pipeline.PipelineConfig(carrier=None, slots_per_batch=2),
            device="cuda", seed=2,
            batch_fn=gnb_mixed.batch_fn_for_pipeline(cfg))
    ref, acc = pipe(), pipe()
    for _ in range(3):
        ref.submit(pay)
        acc.submit_accumulated(pay)
    res = ref.drain()
    sinrs = np.concatenate([s for _, s in res]).astype(np.float64)
    ok, mean, n = acc.fetch_accumulated()
    assert ok and all(o.all() for o, _ in res) and n == 6
    assert abs(mean - sinrs.mean()) <= 1e-6 * abs(sinrs.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tdl", "ue_decode_dl", "grid_prach"])
def test_tiny_mixed_variant_on_card_matches_cpu(cuda, variant):
    """The slot's options on the card and on the CPU (same payloads and
    noise): every verdict equal; ue_decode_dl adds two decoder launches."""
    cfg = {"tdl": gnb_mixed.tdl_channel(gnb_mixed.tiny_mixed()),
           "ue_decode_dl": gnb_mixed.tiny_mixed(ue_decode_dl=True),
           "grid_prach": gnb_mixed.tiny_mixed(prach_time_domain=False)
           }[variant]
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(15), 2, "cpu")
    noise = gnb_mixed.draw_noise(cfg, 2, torch.Generator().manual_seed(15))
    want = gnb_mixed.mixed_slot_batch(pay, *noise, cfg)
    dec0 = decoder_cuda.decode.launches
    got = gnb_mixed.mixed_slot_batch({k: v.to(cuda) for k, v in pay.items()},
                                     *(n.to(cuda) for n in noise), cfg)
    torch.cuda.synchronize()
    assert decoder_cuda.decode.launches == dec0 + len(
        gnb_mixed.decode_names(cfg))
    assert bool(want.ok.all())
    for f in _MIXED_FLAGS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.cuda
def test_harq_retx_batch_on_card_matches_cpu(cuda):
    cfg = gnb_mixed.tiny_mixed()
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(16), 2, "cpu")
    gen = torch.Generator().manual_seed(16)
    c1 = gnb_mixed.tiny_mixed(snr_db=1.5)
    noise = (*gnb_mixed.draw_noise(c1, 2, gen), *gnb_mixed.draw_noise(c1, 2,
                                                                     gen))
    want = gnb_mixed.harq_retx_batch(pay, noise, cfg, 1.5, device="cpu")
    dec0 = decoder_cuda.decode.launches
    got = gnb_mixed.harq_retx_batch(pay, noise, cfg, 1.5, device=cuda)
    torch.cuda.synchronize()
    assert decoder_cuda.decode.launches == dec0 + 6
    for ue in want:
        for v in want[ue]:
            assert torch.equal(got[ue][v].cpu(), want[ue][v]), (ue, v)
        assert want[ue]["combined_ok"].all()
        assert not (want[ue]["first_ok"].any() or want[ue]["retx_ok"].any())


# the uplink SNR of the harq273.b64 cell (ranbench/configs/harq273.json)
HARQ_SNR1 = 12.5


@pytest.fixture(scope="module")
def harq_buffers():
    """The combined buffers of 64 HARQ pairs of the 273-PRB mixed slot at
    the cell's uplink SNR, as ``harq_pair_batch`` forms them: {"u0"
    (BG1 Z=384, x1088), "u1" (Z=352, x512)} [rows, N] float32 on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = gnb_mixed.default_mixed()
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(23), 64, dev)
    noise = gnb_mixed.draw_harq_noise(
        cfg, 64, torch.Generator(device=dev).manual_seed(23), HARQ_SNR1)
    f1, f2, _ = gnb_mixed._harq_fronts(pay, noise, cfg, 2)
    out = {}
    for name in ("u0", "u1"):
        comb = harq.soft_combine(f2[name].llr_full, f1[name].llr_full)
        out[name] = comb.reshape(-1, comb.shape[-1]).contiguous()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name,zc,rows", [("u0", 384, 1088),
                                          ("u1", 352, 512)])
def test_decoder_kernel_full_graph_harq_cell_rows(cuda, harq_buffers, name,
                                                  zc, rows):
    """The harq273.b64 cell's full-graph launches (one CTA an SM: x1088 is
    9 waves on 132 SMs) on the cell's combined buffers: bit-exact against
    the plain version, eagerly and replayed from a captured graph, and
    every codeblock converges."""
    llr = harq_buffers[name]
    assert llr.shape[0] == rows
    w_bits, w_ok = decoder_cuda.decode_plain(llr, 1, zc)
    bits, ok = decoder_cuda.decode(llr, 1, zc)
    prog = capture.GraphPool(cuda).program(
        lambda x: decoder_cuda.decode(x, 1, zc))
    prog(llr)                                     # warm-up and capture
    r_bits, r_ok = (t.clone() for t in prog(llr))  # a replay
    torch.cuda.synchronize()
    assert torch.equal(ok, w_ok) and torch.equal(bits, w_bits)
    assert torch.equal(r_ok, w_ok) and torch.equal(r_bits, w_bits)
    assert bool(w_ok.all())
    assert decoder_cuda.ctas_per_sm(1, zc, None) == 1


def _pair_tree(res):
    return {"ok": res.ok, "first": vars(res.first),
            "second": vars(res.second), "combined": res.combined}


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 64])
def test_harq_pair_program_replay_equals_eager(cuda, b):
    """``harq_pair_batch`` as one ``graphs.Program`` at 8 and 64 pairs a
    batch: a replay on new noise equals the eager run on the same inputs,
    every pair ok; the capture ticks ``ldpc.full_graph`` with the batch's
    full-graph rows (1088 + 512 at 64 pairs) and ``harq.combined`` with
    2·b TBs in each of its two passes (eager warm-up, capture), a replay
    nothing; 4 decoder launches a replay."""
    from srsran_project_23_5_tpu_torch.utils.tracing import tracer
    cfg = gnb_mixed.default_mixed()
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(b), b, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(b)
    prog = capture.GraphPool(cuda).program(lambda p, nz: _pair_tree(
        gnb_mixed.harq_pair_batch(p, nz, cfg)))
    tracer.clear()
    tracer.enabled = True
    try:
        prog(pay, gnb_mixed.draw_harq_noise(cfg, b, gen, HARQ_SNR1))
        captured = [r for r in tracer.records() if r.name == "harq.pair"]
        dec0 = decoder_cuda.decode.launches
        out = prog(pay, gnb_mixed.draw_harq_noise(cfg, b, gen, HARQ_SNR1))
        torch.cuda.synchronize()
        replayed = [r for r in tracer.records() if r.name == "harq.pair"]
    finally:
        tracer.enabled = False
    rows = b * (cfg.pusch0.segments.nof_segments
                + cfg.pusch1.segments.nof_segments)
    assert rows == (1088 + 512) * b // 64
    assert len(captured) == 2 and replayed == captured
    for r in captured:
        assert r.counts["ldpc.full_graph"] == rows
        assert r.counts["harq.combined"] == 2 * b
    assert prog.captured_launches["decoder"] == 4
    assert decoder_cuda.decode.launches == dec0 + 4
    assert bool(out["ok"].all())
    _assert_replay_equals_eager(prog)


@pytest.mark.cuda
def test_receivers_on_card_match_cpu(cuda):
    """pdcch_blind_receive, pbch_decode and a long-PRACH detect on CUDA
    tensors give the CPU's results."""
    rng = np.random.default_rng(17)
    cfg = pdcch.PdcchConfig(rnti=0x17, payload_size=24, aggregation_level=2,
                            cce_index=4, n_id=3, n_rnti=0x17)
    grid = pdcch.pdcch_transmit(
        torch.from_numpy(rng.integers(0, 2, (2, 24)).astype(np.int8)), cfg,
        torch.zeros((2, 14, 52 * 12), dtype=torch.complex64))
    grid = grid + 0.05 * torch.randn(grid.shape, dtype=torch.complex64,
                                     generator=torch.Generator().manual_seed(1))
    cands = torch.tensor([0, 2, 4, 6])
    want = pdcch.pdcch_blind_receive(grid, cfg, cands)
    got = pdcch.pdcch_blind_receive(grid.to(cuda), cfg, cands.to(cuda))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert want[1].tolist() == [[False, False, True, False]] * 2

    scfg = ssb.SsbConfig(pci=123, ssb_idx=2, sfn=100)
    pay = torch.from_numpy(rng.integers(0, 2, (2, 32)).astype(np.int8))
    coded = ssb.pbch_encode(pay, scfg).to(torch.float32)
    llr = 8.0 * (1.0 - 2.0 * coded) + 3.0 * torch.from_numpy(
        rng.standard_normal(coded.shape).astype(np.float32))
    want = ssb.pbch_decode(llr, scfg)
    got = ssb.pbch_decode(llr.to(cuda), scfg)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert want[1].all() and torch.equal(want[0], pay)

    fft, cp = prach_demod.long_format_geometry("0", 30.72e6)[::2]
    y = prach.generate_cv(129, 7 * 13, 839)
    bins = np.zeros(fft, np.complex64)
    bins[:839] = y
    period = np.fft.ifft(bins) * fft / np.sqrt(839)
    sig = np.concatenate([period[-cp:], period]).astype(np.complex64)
    sig = torch.from_numpy(sig + (0.3 * (rng.standard_normal(sig.shape) + 1j
                                         * rng.standard_normal(sig.shape))
                                  ).astype(np.complex64))
    out = []
    for dev in ("cpu", cuda):
        rx = prach_demod.demodulate(sig.to(dev), fft, 839, 0, cp)
        out.append(prach.detect(rx[None], 129, 839, 13))
    for a, b in zip(out[1], out[0]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))
    assert int(out[1][0][0].argmax()) == 7


@pytest.mark.cuda
def test_async_lower_phy_on_card_matches_cpu(cuda):
    cfg = lower_phy.LowerPhyConfig(mu=1, nfft=512, nof_prb=24)
    rng = np.random.default_rng(18)
    grids = [torch.from_numpy((rng.standard_normal((14, 288)) + 1j
                               * rng.standard_normal((14, 288))
                               ).astype(np.complex64)) for _ in range(3)]
    out = {}
    for dev in ("cpu", cuda):
        got = {}
        eng = lower_phy.AsyncLowerPhy(
            cfg, lambda s: grids[s] if s < 3 else None,
            lambda s, g: got.__setitem__(s, g.cpu()), depth=2, device=dev)
        total = sum(eng.timeline.slot_size(s) for s in range(3))
        while total > 0:
            n = min(1001, total)
            eng.push_rx(eng.pull_tx(n))
            total -= n
        out[str(dev)] = got
    for s in range(3):
        a, b = out[str(cuda)][s], out["cpu"][s]
        assert float((a - b).abs().max()) < 1e-4 * float(b.abs().max())
        assert float((b - grids[s]).abs().max()) < 1e-3


@pytest.mark.cuda
def test_gnb_app_loopback_on_card(cuda):
    """The gNB app's over-the-air loopback on the card (52 PRB, 160 slots,
    28 dB, 2+2 packets, the app's default platform): the UE reaches RRC
    ACTIVE with every packet delivered, both LDPC kernels and the PUSCH LLR
    kernel ran, and every LDPC launch (eager, or of a replay of a captured
    program) equals its plain version on the same inputs."""
    from srsran_project_23_5_tpu_torch.apps import gnb as app_gnb
    gnb = app_gnb.Gnb(app_gnb.GnbConfig(
        slots=160, phy="loopback", ue_dl_packets=2, ue_ul_packets=2,
        snr_db=28.0, nof_prb=52))
    assert gnb._phy.device.type == "cuda"
    with kernel_taps.tapped_kernels() as sink:
        kernel_taps.reset_launch_counts()
        rep = gnb.run()
        launches = kernel_taps.launch_counts()
    assert rep["ue_rrc_state"] == "active", rep
    assert rep["ue_dl_rx_packets"] == rep["core_ul_rx_packets"] == 2, rep
    assert rep["phy_stats"]["rar_decoded"] == 1, rep
    assert {c["fn"] for c in sink.eager} == {"encode", "decode"}
    assert kernel_taps.tapped_launches(launches) == len(sink.eager)
    assert launches["pusch_llr"] > 0
    assert all(c["x"].is_cuda for c in sink.eager)
    assert kernel_taps.mismatches(sink.eager) == []
    assert gnb._phy.graphs.replays > 0 and gnb._phy.upper.graphs.replays > 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _assert_replay_equals_eager(prog, got=None):
    """The last replay of a program against its eager run on the same
    inputs: bits and verdicts exact, floats within 1e-5 of max|ref|."""
    got = _leaves(prog.out if got is None else got)
    want = _leaves(prog.eager(*prog.inputs))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype.is_floating_point or a.dtype.is_complex:
            assert float((a - b).abs().max()) <= 1e-5 * float(
                b.abs().max())
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_upper_phy_replays_equal_eager(cuda):
    """The tiny FAPI carrier's DL slots and both UL mixes through captured
    programs: each replay equals the program's eager run on the same
    inputs, on the slot that captured it and on later slots' data; the
    launch counts grow by what the capture saw per replay; the DL grids
    kept together are each their own slot's."""
    car = fapi_carrier.tiny_carrier()
    phy = upper_phy.UpperPhy(car.upper_phy, cuda)
    cpu = upper_phy.UpperPhy(car.upper_phy, "cpu")
    gen = torch.Generator(device=cuda).manual_seed(19)
    rng = np.random.default_rng(19)
    grids = []
    for slot in range(4):
        req, data = fapi_carrier.dl_request(car, slot, rng)
        e0, c0 = encoder_cuda.encode.launches, phy.graphs.captures
        grids.append((phy.process_dl_slot(req, data),
                      cpu.process_dl_slot(req, data)))
        prog = phy.dl_programs.get(slot_programs.dl_signature(req)).program
        assert prog.captured_launches == {
            "encoder": len(req.pdsch_pdus), "decoder": 0, "pusch_llr": 0,
            "channel_mix": 0}
        assert encoder_cuda.encode.launches - e0 == len(req.pdsch_pdus) * (
            1 + phy.graphs.captures - c0)
        _assert_replay_equals_eager(prog, grids[-1][0])
        ul = fapi_carrier.ul_request(car, slot, full=slot % 2 == 0)
        pay = fapi_carrier.ul_payloads(ul, rng)
        rx, prach_rx = fapi_carrier.uplink(ul, pay, car, gen)
        d0, r0 = decoder_cuda.decode.launches, phy.graphs.replays
        inds = phy.process_ul_slot(rx, ul, slot_count=slot,
                                   prach_rx=prach_rx)
        prog = phy.ul_programs.get(slot_programs.signature(ul)).program
        groups = slot_programs.decode_groups(slot_programs.signature(ul)[0])
        assert prog.captured_launches == {
            "encoder": 0, "decoder": len(groups),
            "pusch_llr": len(ul.pusch_pdus), "channel_mix": 0}
        assert phy.graphs.replays == r0 + 1
        if slot >= 2:           # a replay of the graph slot - 2 captured
            assert decoder_cuda.decode.launches - d0 == len(groups)
        _assert_replay_equals_eager(prog)
        checks = fapi_carrier.ul_checks(car, ul, pay, inds,
                                        phy.last_ul_slot["pusch"])
        assert all(checks.values()), (slot, checks)
    assert phy.graphs.captures == 3 and phy.graphs.reserved_bytes() > 0
    for got, want in grids:
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


@pytest.mark.cuda
def test_softbuffer_survives_other_replays_on_card(cuda):
    """A HARQ softbuffer kept across another UE's slot (another replay on
    the same graph pool) is unchanged, and its rv=2 combine passes."""
    car = fapi_carrier.tiny_carrier()
    phy = upper_phy.UpperPhy(car.upper_phy, cuda)
    gen = torch.Generator(device=cuda).manual_seed(20)
    rng = np.random.default_rng(20)
    first = fapi_carrier.ul_request(car, 1, full=False, harq_process=15)
    pay = fapi_carrier.ul_payloads(first, rng)
    rx, _ = fapi_carrier.uplink(first, pay, car, gen, snr_db=car.harq_snr_db)
    phy.process_ul_slot(rx, first, slot_count=1)
    rnti = first.pusch_pdus[0].config.rnti
    kept = phy.softbuffers.get(rnti, 15).clone()
    other = fapi_carrier.ul_request(car, 2, full=True)
    opay = fapi_carrier.ul_payloads(other, rng)
    orx, oprach = fapi_carrier.uplink(other, opay, car, gen)
    phy.process_ul_slot(orx, other, slot_count=2, prach_rx=oprach)
    assert torch.equal(phy.softbuffers.get(rnti, 15), kept)
    retx = fapi_carrier.ul_request(car, 3, full=False, harq_process=15, rv=2,
                                   new_data=False)
    rx2, _ = fapi_carrier.uplink(retx, pay, car, gen, snr_db=car.harq_snr_db)
    inds = phy.process_ul_slot(rx2, retx, slot_count=3)
    assert fapi_carrier.ul_checks(car, retx, pay, inds, None)["crc"]


@pytest.mark.cuda
def test_ue_programs_replay_on_card_equal_the_cpu(cuda):
    """The UE modem's programs on the card, on two slots (the second
    replays the first's graphs on its own DM-RS and sequences): each
    replay equals its eager run, and the outputs equal the same calls on
    the CPU."""
    from srsran_project_23_5_tpu_torch.apps import phy_loop
    from srsran_project_23_5_tpu_torch.phy.upper import pucch, sch
    from srsran_project_23_5_tpu_torch.utils import graphs as prog_graphs
    pools = {d: prog_graphs.GraphPool(torch.device(d))
             for d in ("cpu", "cuda")}
    rng = np.random.default_rng(21)
    nsc = 52 * 12
    for slot in (3, 4):
        pdsch = sch.ShConfig(rnti=0x4601, tbs=3240, qm=4, prb_start=4,
                             nof_prb=20, dmrs_symbols=(2, 7, 11),
                             slot_in_frame=slot)
        f1 = pucch.PucchF1Config(prb=51, initial_cyclic_shift=3,
                                 slot_in_frame=slot)
        f2 = pucch.PucchF2Config(prb_start=40, nof_prb=2, rnti=0x4601,
                                 nof_uci_bits=4, slot_in_frame=slot)
        tb = torch.from_numpy(rng.integers(0, 2, 3240).astype(np.int8))
        g = sch.pdsch_transmit(tb[None], pdsch,
                               torch.zeros((1, 14, nsc),
                                           dtype=torch.complex64))[0]
        rx = g + torch.from_numpy(_noise(rng, (14, nsc), 0.05))
        outs = {}
        for d, pool in pools.items():
            bits, ok = phy_loop.ue_pdsch_receive(rx.to(d), pdsch, pool)
            grid = torch.zeros((14, nsc), dtype=torch.complex64, device=d)
            grid = phy_loop.ue_pusch_transmit(tb[:3240].to(d), pdsch, grid,
                                              pool)
            grid = phy_loop.ue_pucch_f1_transmit(
                torch.ones(1, dtype=torch.int8, device=d), f1, grid, pool)
            grid = phy_loop.ue_pucch_f2_transmit(
                torch.tensor([1, 0, 1, 1], dtype=torch.int8, device=d), f2,
                grid, pool)
            outs[d] = (bits.cpu(), bool(ok), grid.cpu())
            if d == "cuda":
                for prog in pool._cached.values():
                    _assert_replay_equals_eager(prog)
        assert outs["cuda"][1] and outs["cpu"][1]
        assert torch.equal(outs["cuda"][0], outs["cpu"][0])
        assert torch.equal(outs["cuda"][0], tb)
        ref = outs["cpu"][2]
        assert float((outs["cuda"][2] - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())
    assert pools["cuda"].captures == 4


def _noise(rng, shape, sigma):
    return (sigma / np.sqrt(2) * (rng.standard_normal(shape) + 1j
                                  * rng.standard_normal(shape))
            ).astype(np.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [9, 12, 14, 16])
def test_bfp_slot_bytes_on_the_card_equal_the_cpu(cuda, width):
    """The slot-level BFP pack and unpack give on the card the bytes and
    IQ they give on the CPU (273 PRB, 4 ports at once)."""
    from srsran_project_23_5_tpu_torch.ofh import compression
    gen = torch.Generator(device=cuda).manual_seed(width)
    g = torch.randn((2, 4, 14, 273, 12), generator=gen, device=cuda) * 0.3
    iq = torch.complex(g[0], g[1])
    wire = compression.compress_slot(iq, width)
    assert torch.equal(wire.cpu(), compression.compress_slot(iq.cpu(),
                                                             width))
    assert torch.equal(compression.decompress_slot(wire, width).cpu(),
                       compression.decompress_slot(wire.cpu(), width))


@pytest.mark.cuda
def test_ofh_sector_slot_on_the_card_equals_the_cpu(cuda):
    """A 273-PRB slot through a sector pair on the card: the frames and the
    rebuilt grid equal those of a pair on the CPU, every PRB arrives."""
    from srsran_project_23_5_tpu_torch import ofh
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = torch.randn((2, 14, 273 * 12), generator=gen, device=cuda) * 0.2
    grid = torch.complex(g[0], g[1])
    out = {}
    for dev in (cuda, torch.device("cpu")):
        frames, got = [], {}
        tx = ofh.OfhSector(ofh.OfhSectorConfig(nof_prb=273), frames.append,
                           device=dev)
        rx = ofh.OfhSector(ofh.OfhSectorConfig(nof_prb=273, eaxc_ul=0),
                           lambda f: None, device=dev)
        rx.on_ul_slot = lambda key, grid_: got.update({key: grid_})
        tx.transmit_dl_slot(1, 2, 3, grid.to(dev))
        for f in frames:
            rx.handle_rx_frame(f)
        out[dev.type] = (frames, got[(1, 2, 3)], rx.rx_no_cplane)
    assert out["cuda"][0] == out["cpu"][0] and len(out["cpu"][0]) == 29
    assert out["cuda"][1].is_cuda
    assert torch.equal(out["cuda"][1].cpu(), out["cpu"][1])
    assert out["cuda"][2] == out["cpu"][2] == 0


@pytest.mark.cuda
def test_sharded_flagship_nccl_world_of_one(cuda):
    """The carrier-sharded flagship step on a one-rank NCCL world equals the
    unsharded step; the captured step's warm-up and replay launch each
    kernel once, bit-exact."""
    car = gnb_flagship.tiny_carrier()
    gen = torch.Generator(device=cuda).manual_seed(4)
    tb = torch.randint(0, 2, (4, car.sh.tbs), generator=gen, device=cuda,
                       dtype=torch.int8)
    sigma = float(np.sqrt(car.nfft) * 10 ** (-25.0 / 20))
    nz = torch.randn((2, 4, car.slot_samples), generator=gen, device=cuda)
    noise = torch.complex(nz[0], nz[1]) * (sigma / np.sqrt(2.0))
    with launch.world_of_one("nccl", cuda) as dev:
        res = entry.carrier_step_check(0, dev, car, tb, noise, 4)
    assert res["ok"].all() and torch.equal(res["ok"], res["ok_ref"])
    assert res["bit_errors"].dtype == torch.int32
    assert not res["bit_errors"].any()
    assert torch.equal(res["bit_errors"], res["bit_errors_ref"])
    assert float((res["sinr"] - res["sinr_ref"]).abs().max()) <= 1e-3
    # the step's first call: the eager warm-up's launch of each kernel,
    # then the capture's, which its replay adds
    assert res["launches"] == {"encoder": 2, "decoder": 2, "pusch_llr": 2,
                               "channel_mix": 0}
    assert len(res["calls"]) == 4 and res["mismatches"] == []


@pytest.mark.cuda
def test_sharded_cell_edge_nccl_world_of_one(cuda):
    """A card's share of the flagship273.mesh4 cell, 128 cell-edge carriers
    at 5 dB, on a one-rank NCCL world: every TB decoded with no bit wrong,
    equal to the unsharded step; the captured step's warm-up and replay
    launch each kernel once, bit-exact."""
    car = gnb_flagship.default_carrier(*EDGE_CARRIER)
    gen = torch.Generator(device=cuda).manual_seed(18)
    tb = torch.randint(0, 2, (128, car.sh.tbs), generator=gen, device=cuda,
                       dtype=torch.int8)
    sigma = float(np.sqrt(car.nfft) * 10 ** (-5.0 / 20))
    nz = torch.randn((2, 128, car.slot_samples), generator=gen, device=cuda)
    noise = torch.complex(nz[0], nz[1]) * (sigma / np.sqrt(2.0))
    with launch.world_of_one("nccl", cuda) as dev:
        res = entry.carrier_step_check(0, dev, car, tb, noise)
    assert res["ok"].all() and torch.equal(res["ok"], res["ok_ref"])
    assert not res["bit_errors"].any()
    assert torch.equal(res["bit_errors"], res["bit_errors_ref"])
    assert float((res["sinr"] - res["sinr_ref"]).abs().max()) <= 1e-3
    assert res["launches"] == {"encoder": 2, "decoder": 2, "pusch_llr": 2,
                               "channel_mix": 0}
    assert len(res["calls"]) == 4 and res["mismatches"] == []


@pytest.mark.cuda
def test_dryrun_two_gloo_ranks_share_the_card(cuda):
    """Two spawned gloo ranks on cuda:0 run one tiny mixed carrier each and
    the slot-sharded PRACH stream; each rank launched 4 encodes, 2
    decodes (every one bit-exact) and 2 PUSCH LLR stages."""
    ranks, _ = entry.dryrun_multichip(2, backend="gloo", device="cuda:0",
                                      cfg=gnb_mixed.tiny_mixed())
    for mixed, short, long_ in ranks:
        assert mixed["launches"] == {"encoder": 4, "decoder": 2,
                                     "pusch_llr": 2, "channel_mix": 2}
        assert len(mixed["calls"]) == 6 and mixed["mismatches"] == []
        assert short["rel_err"] <= 1e-4 and long_["rel_err"] <= 1e-4
