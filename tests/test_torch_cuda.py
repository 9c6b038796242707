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
from srsran_project_23_5_tpu_torch.ops import prach
from srsran_project_23_5_tpu_torch.parallel import launch
from srsran_project_23_5_tpu_torch.phy import pipeline
from srsran_project_23_5_tpu_torch.phy.lower import lower_phy, prach_demod
from srsran_project_23_5_tpu_torch.phy.upper import (pdcch, slot_programs, ssb,
                                                     upper_phy)
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
    (1, 384, 128), (1, 384, 56), (1, 384, 136), (1, 352, 64)])
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
    (1, 384, 56, 6.0, 34), (1, 384, 56, np.linspace(2, 6, 56), 34)])
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
    got = gnb_mixed.mixed_slot_batch(g_pay, *g_noise, cfg)
    torch.cuda.synchronize()
    assert encoder_cuda.encode.launches == enc0 + 4
    assert decoder_cuda.decode.launches == dec0 + 2
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
def test_mixed_scan_replay_equals_eager(cuda):
    """The mixed slot's scan step captured as one CUDA graph: a replay
    equals the eager K-batch loop on the same noise (the same kernels on
    the same buffers), each replay counts the launches it captured, and a
    replay on ×100 noise fails (the graph reads the static noise)."""
    cfg = gnb_mixed.tiny_mixed()
    b, k = 2, 2
    pipe = pipeline.SlotPipeline(
        pipeline.PipelineConfig(carrier=None, slots_per_batch=b,
                                scan_batches=k),
        device="cuda", seed=0, batch_fn=gnb_mixed.batch_fn_for_pipeline(cfg))
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(31), b, "cuda")
    _, ok, mean = pipe.warmup_scan(pay)
    assert ok and abs(mean - 20.0) < 1.0
    assert pipe.captured_launches == (4 * k, 2 * k)
    replay, eager = _replay_vs_eager(pipe, pay, 5)
    assert replay[0] and replay[0] == eager[0]
    assert abs(replay[1] - eager[1]) <= 1e-6 * abs(eager[1])
    enc0, dec0 = encoder_cuda.encode.launches, decoder_cuda.decode.launches
    for seed in (7, 9):
        pipe.submit_scan(pay, seed)
    all_ok, mean, n = pipe.fetch_accumulated()
    assert all_ok and n == 2 * k * b and abs(mean - 20.0) < 1.0
    assert encoder_cuda.encode.launches == enc0 + 2 * 4 * k
    assert decoder_cuda.decode.launches == dec0 + 2 * 2 * k
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
    assert pipe.captured_launches == (k, k)
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
    ACTIVE with every packet delivered, both kernels ran, and every launch
    (eager, or of a replay of a captured program) equals its plain version
    on the same inputs."""
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
    assert sum(launches.values()) == len(sink.eager)
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
        assert prog.captured_launches == (len(req.pdsch_pdus), 0)
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
        assert prog.captured_launches == (0, len(groups))
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
    unsharded step; one launch of each kernel, bit-exact."""
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
    assert float((res["sinr"] - res["sinr_ref"]).abs().max()) <= 1e-3
    assert res["launches"] == {"encoder": 1, "decoder": 1}
    assert len(res["calls"]) == 2 and res["mismatches"] == []


@pytest.mark.cuda
def test_dryrun_two_gloo_ranks_share_the_card(cuda):
    """Two spawned gloo ranks on cuda:0 run one tiny mixed carrier each and
    the slot-sharded PRACH stream; each rank launched 4 encodes and 2
    decodes, every one bit-exact."""
    ranks, _ = entry.dryrun_multichip(2, backend="gloo", device="cuda:0",
                                      cfg=gnb_mixed.tiny_mixed())
    for mixed, short, long_ in ranks:
        assert mixed["launches"] == {"encoder": 4, "decoder": 2}
        assert len(mixed["calls"]) == 6 and mixed["mismatches"] == []
        assert short["rel_err"] <= 1e-4 and long_["rel_err"] <= 1e-4
