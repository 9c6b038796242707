"""The port's ``SlotPipeline`` accumulate and scan modes and its slot
contract (CPU).

On the CPU the scan step is the eager K-batch loop that the card captures
as one CUDA graph (``tests/test_torch_cuda.py`` holds a replay against that
loop).  Here it is held against K eager steps on the same noise, against
the JAX ``mixed_slot_batch`` on the noise of the JAX scan's keys
(``srsran_project_23_5_tpu/phy/pipeline.py``: ``fold_in(PRNGKey(0), seed +
k)``, then one ``fold_in`` per slot), and the accumulate mode against the
reduction of ``submit``/``drain``.  A toy batch function whose results are
a plain function of its payloads and noise pins the pipeline's own logic
(static payload buffers, counts, the slot contract).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srsran_project_23_5_tpu.models import gnb_mixed
from srsran_project_23_5_tpu_torch import convert
from srsran_project_23_5_tpu_torch.models import gnb_flagship as tflagship
from srsran_project_23_5_tpu_torch.models import gnb_mixed as tmixed
from srsran_project_23_5_tpu_torch.phy import pipeline as tpipeline
from test_torch_mixed import _jax_noise

torch.set_num_threads(1)

B, K = 2, 2


@pytest.fixture(scope="module")
def tiny():
    cfg = tmixed.tiny_mixed()
    return cfg, tmixed.make_payloads(cfg, np.random.default_rng(21), B, "cpu")


def _mixed_pipe(cfg, scan_batches=1, seed=3, slots=B, **fn):
    fn = fn or {"batch_fn": tmixed.batch_fn_for_pipeline(cfg)}
    return tpipeline.SlotPipeline(
        tpipeline.PipelineConfig(carrier=None, slots_per_batch=slots, depth=2,
                                 scan_batches=scan_batches),
        device="cpu", seed=seed, **fn)


def _eager_scan(run, payloads, noise):
    """K eager batch steps on noise[i][k]: (all_ok, sinr_sum)."""
    oks, sums = [], []
    for k in range(noise[0].shape[0]):
        ok, sinr = run(payloads, *(n[k] for n in noise))
        oks.append(bool(ok.all()))
        sums.append(sinr.sum())
    return all(oks), float(torch.stack(sums).sum())


# a toy model: ok unless the noise is loud, the "SINR" a sum that changes
# with every payload bit and noise sample
_TOY = tpipeline.PipelineFn(
    run=lambda p, nz: (nz.real.sum(-1) < 50.0,
                       p["x"].float().sum(-1) + nz.real.sum(-1)),
    draw=lambda b, g: (torch.randn((b, 5), generator=g,
                                   dtype=torch.complex64),))


def _toy_pipe(**over):
    cfg = dict(carrier=None, slots_per_batch=3, scan_batches=4)
    cfg.update(over)
    return tpipeline.SlotPipeline(tpipeline.PipelineConfig(**cfg),
                                  device="cpu", seed=0, batch_fn=_TOY)


def _toy_payloads(seed, slots=3):
    return {"x": torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2, (slots, 7)).astype(np.int8))}


# ------------------------------------------------------- accumulate mode
def test_accumulate_equals_submit_drain(tiny):
    """Three batches folded on the device equal the reduction of the same
    three batches through submit/drain (same seed, same noise)."""
    cfg, pay = tiny
    ref = _mixed_pipe(cfg)
    for _ in range(3):
        ref.submit(pay)
    res = ref.drain()
    oks = np.concatenate([ok for ok, _ in res])
    sinrs = np.concatenate([s for _, s in res]).astype(np.float64)
    acc = _mixed_pipe(cfg)
    for _ in range(3):
        acc.submit_accumulated(pay)
    ok, mean, n = acc.fetch_accumulated()
    assert oks.all() and ok == bool(oks.all())
    assert n == 3 * B
    assert abs(mean - sinrs.mean()) <= 1e-6 * abs(sinrs.mean())
    assert abs(mean - cfg.snr_db) < 1.0
    # the fetch resets the accumulator
    assert acc.fetch_accumulated() == (True, 0.0, 0)


def test_eager_submit_draws_as_before(tiny):
    """An eager batch_fn step runs mixed_slot_batch on draw_noise from the
    pipeline's generator, as before the noise became an argument of the
    step."""
    cfg, pay = tiny
    pipe = _mixed_pipe(cfg, seed=5)
    ok, sinr = pipe.step(pay)
    res = tmixed.mixed_slot_batch(pay, *tmixed.draw_noise(
        cfg, B, torch.Generator().manual_seed(5)), cfg)
    assert torch.equal(ok, res.ok) and torch.equal(sinr, res.sinr_ul_db)


# ------------------------------------------------------------ scan mode
def test_scan_equals_eager_steps(tiny):
    """Each dispatch equals K eager steps of the batch function on that
    dispatch's noise; n counts submits·K·B; the same seed draws the same
    noise."""
    cfg, pay = tiny
    pipe = _mixed_pipe(cfg, scan_batches=K)
    assert pipe.slots_per_dispatch == K * B
    _, ok0, mean0 = pipe.warmup_scan(pay)
    assert ok0 and abs(mean0 - cfg.snr_db) < 1.0
    want_ok, want_sum = [], 0.0
    for seed in (11, 13):
        noise = [n.clone() for n in pipe.scan_noise(seed)]
        assert noise[0].shape == (K, B, 2, cfg.slot_samples)
        ok, s = _eager_scan(pipe.fn.run, pay, noise)
        want_ok.append(ok)
        want_sum += s
        pipe.submit_scan(pay, seed)
        assert all(torch.equal(a, b)
                   for a, b in zip(pipe.scan_noise(seed), noise))
    ok, mean, n = pipe.fetch_accumulated()
    assert n == 2 * K * B
    assert ok == all(want_ok) and ok
    assert abs(mean * n - want_sum) <= 1e-6 * abs(want_sum)


def test_scan_matches_jax_keys(tiny):
    """The scan body on the JAX scan's draws (per-dispatch keys fold_in(
    PRNGKey(0), seed + k), per-slot keys fold_in(base, b)) against the JAX
    mixed_slot_batch on the same keys, reduced in numpy: all_ok equal, mean
    SINR within 0.05 dB."""
    jax.clear_caches()     # XLA:CPU faults on accumulated giant compiles
    jcfg = gnb_mixed.tiny_mixed()
    tcfg = convert.from_jax_mixed(jcfg)
    payloads = gnb_mixed.make_payloads(jcfg, np.random.default_rng(22),
                                       batch=B)
    step = jax.jit(lambda p, keys: gnb_mixed.batch_fn_for_pipeline(jcfg)(
        p, keys))
    seed, sigma = 40, tmixed.noise_sigma(tcfg)
    want_ok, want_sinr, noise = [], [], ([], [])
    for k in range(K):
        base = jax.random.fold_in(jax.random.PRNGKey(0), jnp.uint32(seed + k))
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            base, jnp.arange(B, dtype=jnp.uint32))
        ok, sinr = step(payloads, keys)
        want_ok.append(np.asarray(ok))
        want_sinr.append(np.asarray(sinr))
        draws = [_jax_noise(keys[b], sigma, jcfg.slot_samples)
                 for b in range(B)]
        for i in range(2):
            noise[i].append(np.stack([np.asarray(d[i]) for d in draws]))
    pipe = _mixed_pipe(tcfg, scan_batches=K)
    all_ok, sinr_sum = pipe.scan_step(
        {k: torch.from_numpy(np.array(v)) for k, v in payloads.items()},
        tuple(torch.from_numpy(np.stack(n)) for n in noise))
    assert bool(np.all(want_ok))
    assert bool(all_ok) == bool(np.all(want_ok))
    mean = float(sinr_sum) / (K * B)
    assert abs(mean - float(np.mean(want_sinr))) < 0.05


def test_scan_new_payload_tensors():
    """Payload tensors other than the last ones seen are copied into the
    static buffers: each dispatch gives the results of its own payloads."""
    pipe = _toy_pipe()
    first, second = _toy_payloads(1), _toy_payloads(2)
    pipe.warmup_scan(first)
    pipe.fetch_accumulated()
    noise = pipe.scan_noise(7)
    assert (_eager_scan(_TOY.run, first, noise)
            != _eager_scan(_TOY.run, second, noise))
    for pay in (second, first, second):
        want_ok, want_sum = _eager_scan(_TOY.run, pay, pipe.scan_noise(7))
        pipe.submit_scan(pay, 7)
        ok, mean, n = pipe.fetch_accumulated()
        assert ok == want_ok and mean * n == pytest.approx(want_sum,
                                                          rel=1e-6)
    with pytest.raises(ValueError, match="hold 2 slots"):
        pipe.submit_scan(_toy_payloads(3, slots=2), 0)


def test_scan_reused_dict_new_tensor():
    """A caller that keeps one payload dict and assigns a new tensor to a
    key between dispatches gets the results of the new tensor."""
    pipe = _toy_pipe()
    pay = _toy_payloads(1)
    pipe.warmup_scan(pay)
    pipe.fetch_accumulated()
    for seed in (2, 3):
        pay["x"] = _toy_payloads(seed)["x"]
        want_ok, want_sum = _eager_scan(_TOY.run, pay, pipe.scan_noise(7))
        pipe.submit_scan(pay, 7)
        ok, mean, n = pipe.fetch_accumulated()
        assert ok == want_ok and mean * n == pytest.approx(want_sum,
                                                          rel=1e-6)


def test_scan_counts_and_latency():
    pipe = _toy_pipe()
    pay = _toy_payloads(4)
    pipe.warmup_scan(pay)
    for seed in range(5):
        pipe.submit_scan(pay, seed)
    pipe.submit_accumulated(pay)
    _, _, n = pipe.fetch_accumulated()
    assert n == 5 * 4 * 3 + 3
    assert pipe.dispatch_latency(pay, 9) > 0.0


def test_flagship_scan_cpu():
    """The default loopback in scan mode: a dispatch's noise is the
    pipeline's own draw of K·B slots from a generator seeded with the
    dispatch's seed; a dispatch equals K eager loopback steps on it."""
    cfg = tflagship.tiny_carrier()
    pipe = tpipeline.SlotPipeline(tpipeline.PipelineConfig(
        carrier=cfg, slots_per_batch=B, scan_batches=K), device="cpu", seed=0)
    (got,) = pipe.scan_noise(5)
    want = pipe.noise(K * B, torch.Generator().manual_seed(5))
    assert torch.equal(got, want.reshape(K, B, cfg.slot_samples))
    tb = torch.from_numpy(np.random.default_rng(23).integers(
        0, 2, (B, cfg.sh.tbs)).astype(np.int8))
    _, ok0, mean0 = pipe.warmup_scan(tb)
    assert ok0 and abs(mean0 - 20.0) < 1.5
    noise = [n.clone() for n in pipe.scan_noise(5)]
    want = _eager_scan(pipe.fn.run, tb, noise)
    pipe.submit_scan(tb, 5)
    ok, mean, n = pipe.fetch_accumulated()
    assert n == K * B and ok == want[0]
    assert abs(mean * n - want[1]) <= 1e-6 * abs(want[1])


# ------------------------------------------------------- slot contract
def test_slot_fn_pipeline_matches_batch_fn(tiny):
    """slot_fn_for_pipeline through the pipeline runs the B slots one after
    another and gives the batch function's results on the same noise."""
    cfg, pay = tiny
    pipe = _mixed_pipe(cfg, slot_fn=tmixed.slot_fn_for_pipeline(cfg))
    noise = tmixed.draw_noise(cfg, B, torch.Generator().manual_seed(8))
    ok, sinr = pipe.fn.run(pay, *noise)
    res = tmixed.mixed_slot_batch(pay, *noise, cfg)
    assert ok.shape == (B,) and torch.equal(ok, res.ok) and bool(ok.all())
    torch.testing.assert_close(sinr, res.sinr_ul_db, rtol=1e-6, atol=0)


def test_slot_fn_one_slot_per_batch(tiny):
    """slots_per_batch == 1 with a slot function, eager and in scan mode."""
    cfg, pay = tiny
    one = {k: v[:1] for k, v in pay.items()}
    pipe = _mixed_pipe(cfg, scan_batches=K, slots=1,
                       slot_fn=tmixed.slot_fn_for_pipeline(cfg))
    _, ok, sinr = pipe.warmup(one)
    assert ok.shape == (1,) and ok.all() and abs(sinr[0] - cfg.snr_db) < 1.0
    _, ok, mean = pipe.warmup_scan(one)
    assert ok and abs(mean - cfg.snr_db) < 1.0
    pipe.submit_scan(one, 3)
    assert pipe.fetch_accumulated()[2] == K


def test_mixed_slot_dict_fields(tiny):
    cfg, pay = tiny
    one = {k: v[0] for k, v in pay.items()}
    noise = [n[0] for n in tmixed.draw_noise(
        cfg, 1, torch.Generator().manual_seed(9))]
    got = tmixed.mixed_slot_dict(one, *noise, cfg)
    res = tmixed.mixed_slot(one, *noise, cfg)
    assert list(got) == [f.name for f in dataclasses.fields(res)]
    for name, value in got.items():
        assert value.shape == () and torch.equal(value, getattr(res, name))


def test_pipeline_config_checks():
    with pytest.raises(ValueError, match="scan_batches"):
        _toy_pipe(scan_batches=0)
    with pytest.raises(ValueError, match="not both"):
        tpipeline.SlotPipeline(
            tpipeline.PipelineConfig(carrier=None), device="cpu",
            batch_fn=_TOY, slot_fn=_TOY)
    pipe = _toy_pipe()
    with pytest.raises(ValueError, match="payload on"):
        pipe.submit_scan({"x": torch.zeros((3, 7), dtype=torch.int8,
                                           device="meta")}, 0)
