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

from srsran_project_23_5_tpu_torch.models import gnb_flagship
from srsran_project_23_5_tpu_torch.ops.ldpc import (decoder_cuda,
                                                    encoder_cuda, graphs)
from srsran_project_23_5_tpu_torch.phy import pipeline

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
@pytest.mark.parametrize("bg,zc,batch", [(2, 384, 88), (1, 384, 16),
                                         (2, 36, 13), (1, 2, 3)])
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
    (1, 384, 16, np.linspace(1, 5, 16), 40), (2, 36, 13, 3.0, None)])
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


@pytest.mark.cuda
def test_decoder_kernel_refuses_oversized_state(cuda):
    llr = torch.zeros((2, 68 * 384), device=cuda)
    with pytest.raises(ValueError, match="294912 B"):
        decoder_cuda.decode(llr, 1, 384)


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
