"""Parity of the port's shared-channel slice with the JAX package (CPU):
PDSCH TX, PUSCH front half, the full loopback slot with the same numpy
noise on both sides, the slot pipeline, the config conversion, and the
port's independence from JAX.

The JAX receiver on the CPU decodes with its XLA decoder (float32 store,
whole-batch early stop) while the port has the Pallas semantics, so the
loopback comparisons are made where every codeblock converges.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srsran_project_23_5_tpu.models import gnb_flagship, gnb_mixed
from srsran_project_23_5_tpu.phy.upper import sch, ulsch, upper_phy
from srsran_project_23_5_tpu.ran import numerology
from srsran_project_23_5_tpu_torch import convert
from srsran_project_23_5_tpu_torch.models import gnb_flagship as tflagship
from srsran_project_23_5_tpu_torch.ops.ldpc import decoder_cuda
from srsran_project_23_5_tpu_torch.phy import pipeline as tpipeline
from srsran_project_23_5_tpu_torch.phy.upper import sch as tsch
from srsran_project_23_5_tpu_torch.ran.constants import LLR_MAX

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

# (JAX carrier, SNR in dB): tiny = 8 PRB, BG2 Z=36; small = 24 PRB,
# nfft 512, 16QAM, one BG2 Z=384 codeblock
_CARRIERS = {
    "tiny": (gnb_flagship.tiny_carrier, 10.0),
    "small": (lambda: gnb_flagship.default_carrier(nof_prb=24, qm=4,
                                                   tbs=3624), 14.0),
}


def _tb(rng, cfg):
    return rng.integers(0, 2, size=cfg.sh.tbs).astype(np.int8)


def _noise(rng, n, snr_db, nfft):
    sigma = np.sqrt(nfft) * 10 ** (-snr_db / 20)
    return (sigma / np.sqrt(2) * (rng.standard_normal(n)
                                  + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


@pytest.mark.parametrize("name", sorted(_CARRIERS))
def test_pdsch_transmit_matches(name):
    jcfg = _CARRIERS[name][0]()
    tcfg = convert.from_jax_carrier(jcfg)
    rng = np.random.default_rng(1)
    tb = _tb(rng, jcfg)
    want = np.asarray(sch.pdsch_transmit(
        jnp.asarray(tb), jcfg.sh, jnp.zeros((14, jcfg.nsc), jnp.complex64)))
    got = tsch.pdsch_transmit(
        torch.from_numpy(tb)[None], tcfg.sh,
        torch.zeros((1, 14, tcfg.nsc), dtype=torch.complex64))[0].numpy()
    # QAM levels are a few float32 operations on both sides
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for part in (np.real, np.imag):
        assert np.array_equal(np.sign(part(got)), np.sign(part(want)))


@pytest.mark.parametrize("name", sorted(_CARRIERS))
def test_pusch_demodulate_matches(name):
    jcfg, snr = _CARRIERS[name][0](), _CARRIERS[name][1]
    tcfg = convert.from_jax_carrier(jcfg)
    rng = np.random.default_rng(2)
    tb = _tb(rng, jcfg)
    grid = np.asarray(sch.pdsch_transmit(
        jnp.asarray(tb), jcfg.sh, jnp.zeros((14, jcfg.nsc), jnp.complex64)))
    sigma = 10 ** (-snr / 20) / np.sqrt(2)
    rx = (grid[None] + sigma * (rng.standard_normal((2, 14, jcfg.nsc))
                                + 1j * rng.standard_normal((2, 14, jcfg.nsc)))
          ).astype(np.complex64)                       # two rx ports
    want = sch.pusch_demodulate(jnp.asarray(rx), jcfg.sh)
    got = tsch.pusch_demodulate(torch.from_numpy(rx)[None], tcfg.sh)
    w_llr = np.asarray(want.llr_full)
    g_llr = got.llr_full[0].numpy()
    assert g_llr.shape == w_llr.shape
    # float32 estimate/ZF/demap chain: 1e-4 of the LLR clip
    np.testing.assert_allclose(g_llr, w_llr, rtol=0, atol=1e-4 * LLR_MAX)
    assert np.array_equal(g_llr <= 0, w_llr <= 0)
    for name_ in ("noise_var", "rsrp", "evm", "post_noise_var", "ta_norm"):
        np.testing.assert_allclose(getattr(got, name_)[0].numpy(),
                                   np.asarray(getattr(want, name_)),
                                   rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("name", sorted(_CARRIERS))
def test_loopback_slot_matches_with_same_noise(name):
    jcfg, snr = _CARRIERS[name][0](), _CARRIERS[name][1]
    tcfg = convert.from_jax_carrier(jcfg)
    rng = np.random.default_rng(3)
    tb = _tb(rng, jcfg)
    noise = _noise(rng, numerology.slot_num_samples(jcfg.mu, jcfg.nfft), snr,
                   jcfg.nfft)
    step = jax.jit(gnb_flagship.loopback_slot, static_argnums=(2, 3))
    w_ok, w_bits, w_sinr = step(jnp.asarray(tb), jnp.asarray(noise), jcfg, 6)
    ok, bits, sinr = tflagship.loopback_slot(
        torch.from_numpy(tb), torch.from_numpy(noise), tcfg, 6)
    assert bool(ok) == bool(w_ok) and bool(ok)
    assert np.array_equal(bits.numpy(), np.asarray(w_bits))
    assert np.array_equal(bits.numpy(), tb)
    assert abs(float(sinr) - float(w_sinr)) < 0.1
    assert abs(float(sinr) - snr) < 1.5


def test_slot_pipeline_tiny_cpu():
    cfg = tflagship.tiny_carrier()
    pipe = tpipeline.SlotPipeline(tpipeline.PipelineConfig(
        carrier=cfg, slots_per_batch=4, depth=2, snr_db=20.0,
        nof_ldpc_iterations=6), device="cpu", seed=0)
    rng = np.random.default_rng(4)
    tb = torch.from_numpy(rng.integers(0, 2, size=(4, cfg.sh.tbs)
                                       ).astype(np.int8))
    _, ok, sinr = pipe.warmup(tb)
    assert ok.all() and abs(float(sinr.mean()) - 20.0) < 1.5
    for _ in range(5):
        pipe.submit(tb)
    results = pipe.drain()
    assert len(results) == 5 and len(pipe.completion_times) == 5
    assert all(ok.all() for ok, _ in results)
    assert abs(float(np.mean([s for _, s in results])) - 20.0) < 1.5


def test_flagship_shapes():
    """273 PRB, nfft 4096, 64QAM: 216216 coded bits, BG2 Z=384, 11
    codeblocks of 19656 bits, the full 52-block graph in the decoder."""
    cfg = tflagship.default_carrier()
    sh = cfg.sh
    assert (cfg.nfft, cfg.nsc, sh.nof_bits) == (4096, 3276, 216216)
    seg = sh.segments
    assert (seg.base_graph, seg.lifting_size, seg.nof_segments) == (2, 384, 11)
    assert sh.cb_lengths == [19656] * 11
    assert decoder_cuda.used_blocks(2, 384, 19656) == 52


@pytest.mark.parametrize("name", ["tiny", "small", "flagship"])
def test_convert_round_trip(name):
    jcfg = (_CARRIERS[name][0]() if name in _CARRIERS
            else gnb_flagship.default_carrier(tbs=tflagship.FLAGSHIP_TBS))
    tcfg = convert.from_jax_carrier(jcfg)
    assert (tcfg.mu, tcfg.nfft, tcfg.nof_prb, tcfg.nsc) == (
        jcfg.mu, jcfg.nfft, jcfg.nof_prb, jcfg.nsc)
    # back to the JAX class from the port's fields gives the original
    fields = dataclasses.asdict(tcfg.sh)
    fields["uci"] = ulsch.UciOnPusch(**fields["uci"])
    assert sch.ShConfig(**fields) == jcfg.sh
    for attr in ("nof_bits", "code_rate", "cb_lengths", "scrambling_cinit",
                 "symbol_plan", "sc_bounds"):
        assert getattr(tcfg.sh, attr) == getattr(jcfg.sh, attr), attr
    assert (dataclasses.asdict(tcfg.sh.segments)
            == dataclasses.asdict(jcfg.sh.segments))
    assert [tcfg.sh.dmrs_cinit(l) for l in range(14)] == [
        jcfg.sh.dmrs_cinit(l) for l in range(14)]


def _unported(cls, field, value):
    """A JAX object with one field set, and its converter."""
    if cls == "ShConfig":
        return (dataclasses.replace(gnb_flagship.tiny_carrier().sh,
                                    **{field: value}), convert.from_jax_sh)
    if cls == "MixedSlotConfig":
        return (dataclasses.replace(gnb_mixed.tiny_mixed(), **{field: value}),
                convert.from_jax_mixed)
    if cls == "PdcchConfig":
        return (dataclasses.replace(gnb_mixed.tiny_mixed().pdcch_dl,
                                    **{field: value}), convert.from_jax_pdcch)
    return (upper_phy.UpperPhyConfig(**{field: value}),
            convert.from_jax_upper_phy)


@pytest.mark.parametrize("cls,field,value", [
    ("ShConfig", "nof_layers", 3), ("MixedSlotConfig", "tdl_delays", (0, 3)),
    ("MixedSlotConfig", "ue_decode_dl", True),
    ("PdcchConfig", "interleaved", True), ("PdcchConfig", "nof_symbols", 2),
    ("UpperPhyConfig", "sanitize", True)])
def test_convert_refuses_unported_fields(cls, field, value):
    """A 3-layer shared channel is refused, naming the field; the TDL
    channel, the UE-side decode, interleaved or multi-symbol CORESETs and
    the upper PHY's sanitize mode are carried over field by field."""
    obj, conv = _unported(cls, field, value)
    if (cls, field) == ("ShConfig", "nof_layers"):
        with pytest.raises(NotImplementedError, match=f"{cls}.{field}"):
            conv(obj)
        return
    got = conv(obj)
    assert getattr(got, field) == value
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(obj)])
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(obj, f.name)
        if dataclasses.is_dataclass(g):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), f.name
        else:
            assert g == w, f.name


def test_port_imports_no_jax():
    """Every module of the port (found by walking the package, the apps
    and the examples among them) and chip_smoke.py's imports load neither
    JAX nor anything of the JAX package, and importing them prints
    nothing."""
    code = ("import importlib, pkgutil, sys\n"
            "import srsran_project_23_5_tpu_torch as pkg\n"
            "mods = [m.name for m in pkgutil.walk_packages(\n"
            "    pkg.__path__, pkg.__name__ + '.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "assert {'srsran_project_23_5_tpu_torch.apps.gnb',\n"
            "        'srsran_project_23_5_tpu_torch.apps.phy_loop',\n"
            "        'srsran_project_23_5_tpu_torch.examples.phy_loopback',\n"
            "        'srsran_project_23_5_tpu_torch.examples.mixed_slot_demo',\n"
            "        'srsran_project_23_5_tpu_torch.examples.radio_ssb',\n"
            "        'srsran_project_23_5_tpu_torch.examples.rrc_attach_demo',\n"
            "        } <= set(mods)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m.split('.')[0] == 'srsran_project_23_5_tpu')\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("entry", ["SlotPipeline", "UpperPhy",
                                   "make_payloads", "harq_retx_batch",
                                   "LowerPhy", "AsyncLowerPhy", "apps.gnb",
                                   "apps.phy_loop", "entry"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without a device argument the entry points run on the current CUDA
    device; where there is none they raise instead of falling back to the
    CPU.  device="cpu" still runs the plain versions."""
    from srsran_project_23_5_tpu_torch import entry as tentry
    from srsran_project_23_5_tpu_torch.apps import gnb as tgnb
    from srsran_project_23_5_tpu_torch.apps import phy_loop as tphy_loop
    from srsran_project_23_5_tpu_torch.models import gnb_mixed as tmixed
    from srsran_project_23_5_tpu_torch.phy.lower import lower_phy as tlower
    from srsran_project_23_5_tpu_torch.scheduler import CellConfig
    from srsran_project_23_5_tpu_torch.phy.upper import upper_phy as tupper
    tiny = tmixed.tiny_mixed()
    lcfg = tlower.LowerPhyConfig(mu=1, nfft=256, nof_prb=12)

    def harq(**kw):
        pay = tmixed.make_payloads(tiny, np.random.default_rng(0), 1, "cpu")
        gen = torch.Generator().manual_seed(0)
        noise = (*tmixed.draw_noise(tiny, 1, gen),
                 *tmixed.draw_noise(tiny, 1, gen))
        out = tmixed.harq_retx_batch(pay, noise, tiny, 20.0, **kw)
        assert all(bool(v["first_ok"][0] and v["combined_ok"][0])
                   for v in out.values())
        return out["u0"]["combined_ok"].device

    calls = {
        "SlotPipeline": lambda **kw: tpipeline.SlotPipeline(
            tpipeline.PipelineConfig(carrier=tflagship.tiny_carrier()),
            **kw).device,
        "UpperPhy": lambda **kw: tupper.UpperPhy(
            tupper.UpperPhyConfig(nof_prb=24), **kw).device,
        "make_payloads": lambda **kw: tmixed.make_payloads(
            tmixed.tiny_mixed(), np.random.default_rng(0), 2,
            **kw)["tb_ul0"].device,
        "harq_retx_batch": harq,
        "LowerPhy": lambda **kw: tlower.LowerPhy(
            lcfg, tlower.LoopbackRadio(), **kw).device,
        "AsyncLowerPhy": lambda **kw: tlower.AsyncLowerPhy(
            lcfg, lambda s: None, lambda s, g: None, **kw).device,
        # the app's platform: "gpu" by default, "cpu" where the config says
        "apps.gnb": lambda device=None: tgnb.Gnb(tgnb.GnbConfig(
            nof_prb=24, phy="loopback",
            **({} if device is None else {"platform": device})
        ))._phy.device,
        "apps.phy_loop": lambda **kw: tphy_loop.PhyLoop(
            CellConfig(nof_prb=24), **kw).device,
        "entry": lambda **kw: tentry.entry(tiny, **kw)[1][0].device,
    }
    assert calls[entry](device="cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
