"""Parity of the port's scale-out layer with the JAX package (CPU).

JAX runs its meshes on the conftest's 8 virtual CPU devices, as its own
tests do; the port runs real ranks, gloo on the CPU, spawned by
``parallel.launch`` (six spawns in this file, most serving several
tests).  The same numpy inputs go through both:

- the mesh coordinates of ``make_mesh(4)`` and ``make_mesh_2d(2, 2)``;
- ``halo_from_prev`` at 4 ranks against the ``shard_map`` ring of
  ``tests/test_pipeline.py``: exact, rank 0 circular;
- ``sharded_prach_windows`` at 4 ranks (short and format-0 windows):
  within 1e-4 relative, detection argmax equal;
- ``sharded_multi_carrier_step(tiny_carrier)``, 8 carriers over 4 ranks,
  against the JAX step over the 8-device mesh: ok equal, SINR within 1e-3
  dB; and against the port's own ``multi_carrier_step``, bit errors too;
- the same step at 68 PRB, QPSK MCS 3 (BG2), 4 carriers over 2 ranks,
  against the benchmark's reference flagship (``ranbench/reference``,
  float64 receive stages): ok and decoded-TB bit errors equal, SINR within
  ``REF_SINR_DB``;
- ``mixed_carrier_step(tiny_mixed)``, 2 ranks × 1 carrier, on the JAX
  ``PRNGKey(s)`` draws against JAX ``slot_fn_for_pipeline`` per carrier: ok
  equal, SINR within 0.05 dB; ``global_verdict`` equal on both ranks;
- ``dryrun_multichip`` at 2 ranks on ``tiny_mixed``, with its weak-scaling
  curve at 1 and 2 ranks (two more spawns) in the JAX dry run's format; a
  point that fails or times out raises;
- ``entry(tiny_mixed)``'s baseband against the same JAX op sequence,
  within 1e-5 of its largest sample (the OFDM tolerance);
- the refusals: NCCL with more ranks than cards, an indivisible carrier
  count, a window that exceeds the slot, a mesh without a process group.

The JAX receiver on the CPU decodes with its XLA decoder, so the loopback
comparisons are made where every codeblock converges.
"""
import contextlib
import io
import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from srsran_project_23_5_tpu.models import gnb_flagship, gnb_mixed
from srsran_project_23_5_tpu.ops import prach as prach_ops
from srsran_project_23_5_tpu.parallel import mesh as mesh_lib
from srsran_project_23_5_tpu.parallel import slot_stream
from srsran_project_23_5_tpu.phy.lower import ofdm
from srsran_project_23_5_tpu.phy.upper import csi_rs, pdcch, sch, ssb
from srsran_project_23_5_tpu.ran.constants import NRE
from srsran_project_23_5_tpu_torch import convert
from srsran_project_23_5_tpu_torch import entry as tentry
from srsran_project_23_5_tpu_torch.models import gnb_flagship as tflagship
from srsran_project_23_5_tpu_torch.models import gnb_mixed as tmixed
from srsran_project_23_5_tpu_torch.parallel import launch
from srsran_project_23_5_tpu_torch.parallel import mesh as tmesh
from srsran_project_23_5_tpu_torch.parallel import slot_stream as tstream
from ranbench.reference.models import gnb_flagship as ref_flagship
from test_torch_mixed import _jax_noise

torch.set_num_threads(1)

RANKS = 4
HALO_STREAM = (RANKS, 256)
HALO = 64
CARRIERS = 8
ITERS = 4
GEOMETRIES = {"short": tentry.SHORT_PRACH,
              "format0": tentry.format0_prach(
                  gnb_mixed.tiny_mixed().mu, gnb_mixed.tiny_mixed().nfft)}


def _slot_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), (mesh_lib.SLOT_AXIS,))


@pytest.fixture(scope="module")
def four():
    """One spawn of 4 gloo ranks: the mesh report, both slot streams and
    the sharded tiny-carrier step, with the inputs they were given."""
    rng = np.random.default_rng(1)
    jcar = gnb_flagship.tiny_carrier()
    car = convert.from_jax_carrier(jcar)
    tb = rng.integers(0, 2, size=(CARRIERS, car.sh.tbs)).astype(np.int8)
    sigma = float(np.sqrt(car.nfft) * 10 ** (-25.0 / 20))
    noise = (sigma / np.sqrt(2) * (
        rng.standard_normal((CARRIERS, car.slot_samples))
        + 1j * rng.standard_normal((CARRIERS, car.slot_samples)))
    ).astype(np.complex64)
    stream = rng.standard_normal(HALO_STREAM).astype(np.float32)
    ranks = launch.spawn(
        RANKS, launch.run_all,
        [(tentry.mesh_report, (stream, HALO)),
         (tentry.carrier_step_check, (car, torch.from_numpy(tb),
                                      torch.from_numpy(noise), ITERS))]
        + [(tentry.slot_stream_check, (g,)) for g in GEOMETRIES.values()],
        backend="gloo", device="cpu")
    return {"jcar": jcar, "tb": tb, "noise": noise, "stream": stream,
            "mesh": [r[0] for r in ranks], "carrier": [r[1] for r in ranks],
            "prach": {name: [r[2 + i] for r in ranks]
                      for i, name in enumerate(GEOMETRIES)}}


def test_mesh_coordinates_follow_jax_layout(four):
    """Rank r sits where JAX's make_mesh / make_mesh_2d put device r."""
    devs = jax.devices()
    m1 = mesh_lib.make_mesh(RANKS)
    m2 = mesh_lib.make_mesh_2d(2, 2)
    for r, rep in enumerate(four["mesh"]):
        assert rep["coord_1d"] == tuple(
            int(i) for i in np.argwhere(m1.devices == devs[r])[0])
        assert rep["coord_2d"] == tuple(
            int(i) for i in np.argwhere(m2.devices == devs[r])[0])
    assert m2.axis_names == (tmesh.SLOT_AXIS, tmesh.CARRIER_AXIS)
    assert m1.axis_names == (tmesh.CARRIER_AXIS,)


def test_halo_matches_jax_ring(four):
    """halo_from_prev on each rank equals the JAX shard_map ring's shard
    bit for bit; rank 0 receives the last shard's tail."""
    mesh = _slot_mesh(RANKS)
    spec = P(mesh_lib.SLOT_AXIS, None)
    ring = shard_map(
        lambda x: mesh_lib.halo_from_prev(x, HALO, mesh_lib.SLOT_AXIS,
                                          RANKS),
        mesh=mesh, in_specs=spec, out_specs=spec)
    want = np.asarray(jax.jit(ring)(jnp.asarray(four["stream"])))
    for r, rep in enumerate(four["mesh"]):
        got = rep["halo"].numpy()
        assert got.shape == (1, HALO_STREAM[1] + HALO)
        assert np.array_equal(got[0], want[r])
    assert np.array_equal(four["mesh"][0]["halo"][0, :HALO].numpy(),
                          four["stream"][-1, -HALO:])


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_sharded_prach_windows_match_jax(four, name):
    """The windows of 4 slot-sharded ranks equal JAX's sharded_prach_windows
    on the same stream (1e-4 relative) and detect the same preamble."""
    g = GEOMETRIES[name]
    stream = tentry.prach_stream(g, RANKS, tentry.STREAM_SEED)
    mesh = _slot_mesh(RANKS)
    xs = jax.device_put(jnp.asarray(stream),
                        slot_stream.slot_stream_sharding(mesh))
    with mesh:
        want = np.asarray(jax.jit(lambda s: slot_stream.sharded_prach_windows(
            s, mesh, g.start, g.prach_fft, g.length, g.freq_offset,
            g.cp))(xs))
    ranks = four["prach"][name]
    got = np.concatenate([r["windows"].numpy() for r in ranks])
    assert got.shape == (RANKS, g.length)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
    m, _, _ = prach_ops.detect(jnp.asarray(want), g.root, g.length, g.n_cs)
    assert np.array_equal(np.asarray(m).argmax(axis=-1),
                          np.concatenate([r["argmax"].numpy()
                                          for r in ranks]))
    tentry.slot_stream_verdict(g, ranks)


def test_sharded_carrier_step_matches_jax(four):
    """8 tiny carriers over 4 ranks against the JAX carrier-sharded step
    over the 8-device mesh, and against the port's unsharded step."""
    mesh = mesh_lib.make_mesh(CARRIERS)
    step = gnb_flagship.sharded_multi_carrier_step(mesh, four["jcar"],
                                                   nof_ldpc_iterations=ITERS)
    with mesh:
        ok, sinr = step(jnp.asarray(four["tb"]), jnp.asarray(four["noise"]))
    ok, sinr = np.asarray(ok), np.asarray(sinr)
    assert ok.all()
    for rep in four["carrier"]:
        assert rep["ok"].tolist() == ok.tolist()
        np.testing.assert_allclose(rep["sinr"].numpy(), sinr, rtol=0,
                                   atol=1e-3)
        assert torch.equal(rep["ok_ref"], rep["ok"])
        np.testing.assert_allclose(rep["sinr_ref"].numpy(),
                                   rep["sinr"].numpy(), rtol=0, atol=1e-3)
        assert rep["bit_errors"].dtype == torch.int32
        assert rep["bit_errors"].tolist() == [0] * CARRIERS
        assert torch.equal(rep["bit_errors_ref"], rep["bit_errors"])
        # each rank ran one encode and one decode of its own 2 carriers
        assert [(c["fn"], c["x"].shape[0]) for c in rep["calls"]] == [
            ("encode", 2), ("decode", 2)]


# the benchmark cell's link at 68 PRB: QPSK, TS 38.214 MCS 3 (R = 251/1024),
# TBS 4360 by TS 38.214 5.1.3.2, LDPC base graph 2 with 2 codeblocks at
# Z = 224, 5 dB per RE
EDGE_PRB, EDGE_TBS, EDGE_SNR_DB, EDGE_CARRIERS = 68, 4360, 5.0, 4
# The port's receive chain runs in float32, the reference's in float64 (its
# own OFDM, estimator, ZF and demapper).  One float32 step of a 5 dB SINR
# is 4.8e-7 dB, and the mean post-equalisation noise variance behind it,
# summed over 8976 REs in float32, drifts by a few 1e-7 relative (~1e-6
# dB): 1e-4 dB leaves that room a hundredfold and lies 24x under the gap of
# the reference rounded to bfloat16 at this size (2.4e-3 dB or more).
REF_SINR_DB = 1e-4


@pytest.fixture(scope="module")
def edge_two():
    """One spawn of 2 gloo ranks: the sharded step at the cell edge, on
    the inputs given, with the reference flagship on the same inputs."""
    car = tflagship.default_carrier(EDGE_PRB, 2, EDGE_TBS)
    gen = torch.Generator().manual_seed(18)
    tb = torch.randint(0, 2, (EDGE_CARRIERS, EDGE_TBS), generator=gen,
                       dtype=torch.int8)
    sigma = float(np.sqrt(car.nfft) * 10 ** (-EDGE_SNR_DB / 20))
    nz = torch.randn((2, EDGE_CARRIERS, car.slot_samples), generator=gen)
    noise = torch.complex(nz[0], nz[1]) * (sigma / np.sqrt(2.0))
    ranks = launch.spawn(2, tentry.carrier_step_check, car, tb, noise,
                         backend="gloo", device="cpu")
    rcar = ref_flagship.default_carrier(EDGE_PRB, 2, EDGE_TBS)
    ok, _, sinr, errors = ref_flagship.loopback_batch(tb, noise, rcar)
    return {"car": car, "ranks": ranks,
            "ref": {"ok": ok, "sinr": sinr, "bit_errors": errors}}


def test_sharded_cell_edge_step_matches_reference(edge_two):
    """4 carriers at 68 PRB over 2 ranks: each rank's gathered ok and bit
    errors equal the reference flagship's, SINR within REF_SINR_DB."""
    sh = edge_two["car"].sh
    assert (sh.segments.base_graph, sh.segments.nof_segments,
            sh.segments.lifting_size) == (2, 2, 224)
    ref = edge_two["ref"]
    assert ref["ok"].all() and not ref["bit_errors"].any()
    for rep in edge_two["ranks"]:
        assert rep["ok"].tolist() == ref["ok"].tolist()
        assert rep["bit_errors"].tolist() == ref["bit_errors"].tolist()
        assert torch.equal(rep["bit_errors_ref"], rep["bit_errors"])
        np.testing.assert_allclose(rep["sinr"].numpy(),
                                   ref["sinr"].numpy(), rtol=0,
                                   atol=REF_SINR_DB)
        # each rank ran one encode and one decode of its 2 carriers' CBs
        assert [(c["fn"], c["x"].shape[0]) for c in rep["calls"]] == [
            ("encode", 4), ("decode", 4)]


# ------------------------------------------------------------- mixed slot

@pytest.fixture(scope="module")
def mixed_two():
    """2 gloo ranks × 1 tiny_mixed carrier on the JAX draws of PRNGKey(s),
    and the JAX slot_fn_for_pipeline per carrier."""
    jax.clear_caches()     # XLA:CPU faults on accumulated giant compiles
    jcfg = gnb_mixed.tiny_mixed()
    tcfg = convert.from_jax_mixed(jcfg)
    payloads = gnb_mixed.make_payloads(jcfg, np.random.default_rng(3),
                                       batch=2)
    seeds = [5, 6]
    slot = jax.jit(lambda p, s: gnb_mixed.slot_fn_for_pipeline(jcfg)(
        p, jax.random.PRNGKey(s)))
    want = [slot({k: v[c] for k, v in payloads.items()}, s)
            for c, s in enumerate(seeds)]
    sigma = tmixed.noise_sigma(tcfg)
    draws = [[np.asarray(x) for x in _jax_noise(
        jax.random.PRNGKey(s), sigma, jcfg.slot_samples)] for s in seeds]
    noise = tuple(torch.from_numpy(np.stack([d[i] for d in draws]))
                  for i in range(2))
    ranks = launch.spawn(
        2, tentry.mixed_step_check, tcfg,
        {k: torch.from_numpy(np.array(v)) for k, v in payloads.items()},
        torch.tensor(seeds), noise, backend="gloo", device="cpu")
    return {"ok": [bool(np.asarray(w[0])) for w in want],
            "sinr": [float(np.asarray(w[1])) for w in want], "ranks": ranks}


def test_mixed_carrier_step_matches_jax(mixed_two):
    assert all(mixed_two["ok"])
    for rep in mixed_two["ranks"]:
        assert rep["ok"].tolist() == mixed_two["ok"]
        np.testing.assert_allclose(rep["sinr"].numpy(), mixed_two["sinr"],
                                   rtol=0, atol=0.05)
        # one carrier per rank: 4 encodes (2 PDSCH, 2 PUSCH), 2 decodes
        assert [c["fn"] for c in rep["calls"]] == ["encode"] * 4 + [
            "decode"] * 2


def test_global_verdict_equal_on_both_ranks(mixed_two):
    """The cross-process reduction: (all ok, mean SINR) identical on both
    ranks and equal to the reduction of the gathered verdicts."""
    a, b = (r["verdict"] for r in mixed_two["ranks"])
    assert a == b
    assert a[0] is True
    assert abs(a[1] - float(np.mean(mixed_two["ranks"][0]["sinr"].numpy(),
                                    dtype=np.float64))) < 1e-9


@pytest.fixture(scope="module")
def dryrun_two():
    """``dryrun_multichip`` at 2 ranks on tiny_mixed, its printed lines, and
    the curve it returned (points 1 and 2: two more spawns)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ranks, curve = tentry.dryrun_multichip(2, backend="gloo",
                                               device="cpu",
                                               cfg=tmixed.tiny_mixed())
    return {"ranks": ranks, "out": out.getvalue().splitlines(),
            "curve": curve}


def test_dryrun_multichip_two_ranks(dryrun_two):
    """The dry run's verdict lines at 2 ranks on tiny_mixed, then the
    curve; every rank returns its tapped kernel calls, no launch on the
    CPU."""
    out = dryrun_two["out"]
    assert out[0].startswith("dryrun_multichip(2): ok=[True, True]")
    assert out[1].startswith("slot_stream_prach(2 shards, L=139")
    assert out[2].startswith("slot_stream_prach(2 shards, L=839")
    assert out[3].startswith("weak_scaling(ndev, s/step, efficiency): ")
    assert out[4].startswith("weak_scaling points (7 steps per rank): 1 "
                             "ranks: step ms per rank median [")
    for rank in dryrun_two["ranks"]:
        mixed, short, long_ = rank
        assert mixed["launches"] == {"encoder": 0, "decoder": 0,
                                     "pusch_llr": 0, "channel_mix": 0}
        assert len(mixed["calls"]) == 6 and mixed["step_ms"] > 0
        assert len(mixed["step_times"]) == tentry.TIMED_STEPS
        assert mixed["peak_reserved"] is None
        assert short["halo_ms"] > 0 and long_["rel_err"] <= 1e-4


# the JAX dry run's line (__graft_entry__._dryrun_bonus)
JAX_CURVE = re.compile(r"weak_scaling\(ndev, s/step, efficiency\): "
                       r"((?:\(\d+, \d+\.\d{3}, \d+\.\d{2}\)(?:, )?)+)  \[")


def test_weak_scaling_curve_two_ranks(dryrun_two):
    """Points 1 and 2 (gloo ranks on the CPU, one device): every point ok
    under ``mixed_verdict``, each rank's time the median of the JAX
    curve's 7 steps (all ok), the point's the slowest rank's, efficiency
    t1 / tn, and the line in the JAX dry run's format whose note marks the
    2-rank point as contention."""
    curve = dryrun_two["curve"]
    assert [p["ranks"] for p in curve] == [1, 2]
    for p in curve:
        assert len(p["results"]) == p["ranks"] and p["spawn_s"] > 0
        assert all(bool(m["ok"].all()) and m["verdict"][0] and m["steps_ok"]
                   and not m["mismatches"] for m in p["results"])
        for m in p["results"]:
            assert len(m["step_times"]) == tentry.CURVE_STEPS == 7
            assert m["step_ms"] == float(np.median(m["step_times"]))
        assert p["s_per_step"] == max(m["step_ms"]
                                      for m in p["results"]) / 1e3
        assert p["efficiency"] == curve[0]["s_per_step"] / p["s_per_step"]
    line = dryrun_two["out"][3]
    m = JAX_CURVE.match(line)
    assert m, line
    got = re.findall(r"\((\d+), ([\d.]+), ([\d.]+)\)", m.group(1))
    assert got == [(str(p["ranks"]), f"{p['s_per_step']:.3f}",
                    f"{p['efficiency']:.2f}") for p in curve]
    assert "backend gloo" in line and "points [2] put several ranks" in line


def _point(ok=True):
    """A rank's ``mixed_step_check`` result, as a stand-in spawn returns."""
    return {"ok": torch.tensor([ok]), "sinr": torch.tensor([20.0]),
            "mismatches": [], "verdict": (ok, 20.0), "steps_ok": ok,
            "step_times": [5.0] * 7, "step_ms": 5.0, "peak_reserved": None}


@pytest.mark.parametrize("fault", ["rank", "deadline", "carrier"])
def test_weak_scaling_failed_point_raises(fault, monkeypatch, capsys):
    """A point whose rank fails, whose spawn times out or whose carrier is
    not ok raises: it never drops out of the curve, and no curve prints."""
    def spawn(n, fn, *args, backend, device):
        assert fn is tentry.mixed_step_check and backend == "gloo"
        assert args[-1] == tentry.CURVE_STEPS
        if n == 1:
            return [_point()]
        if fault == "rank":
            raise RuntimeError("rank 1 of 2 failed")
        if fault == "deadline":
            raise TimeoutError("ranks [1] gave no result within 300 s")
        return [_point(), _point(ok=False)]
    monkeypatch.setattr(tentry.launch, "spawn", spawn)
    with pytest.raises({"rank": RuntimeError, "deadline": TimeoutError,
                        "carrier": AssertionError}[fault]):
        tentry.weak_scaling(2, "gloo", "cpu", tmixed.tiny_mixed())
    assert "weak_scaling" not in capsys.readouterr().out


# ----------------------------------------------------------------- entry

def test_entry_baseband_matches_jax():
    """entry(tiny_mixed)'s DL slot against the JAX op sequence of
    __graft_entry__.entry on the same payloads."""
    jcfg = gnb_mixed.tiny_mixed()
    fn, args = tentry.entry(convert.from_jax_mixed(jcfg), device="cpu")
    got = fn(*args)
    tb0, tb1, dci_dl, dci_ul, pbch = (jnp.asarray(a[0].numpy())
                                      for a in args)
    grid = sch.pdsch_transmit(tb0, jcfg.pdsch0,
                              jnp.zeros((2, 14, jcfg.nsc), jnp.complex64))
    g2d = sch.pdsch_transmit(tb1, jcfg.pdsch1,
                             jnp.zeros((14, jcfg.nsc), jnp.complex64))
    g2d = pdcch.pdcch_transmit(dci_dl, jcfg.pdcch_dl, g2d)
    g2d = pdcch.pdcch_transmit(dci_ul, jcfg.pdcch_ul, g2d)
    lo = jcfg.ssb_prb_start * NRE
    g2d = g2d.at[2:6, lo:lo + ssb.SSB_NSC].set(ssb.ssb_assemble(pbch,
                                                                jcfg.ssb))
    g2d = csi_rs.generate(jcfg.csi_rs, g2d)
    want = np.asarray(ofdm.modulate_slot(grid.at[0].add(g2d), jcfg.mu,
                                         jcfg.nfft))
    assert got.shape == (1, *want.shape)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


# -------------------------------------------------------------- refusals

def test_nccl_refuses_more_ranks_than_cards():
    """No card here: NCCL's card per rank is refused before any spawn, as
    are NCCL on the CPU and two NCCL ranks on one card."""
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA devices"):
        launch.spawn(2, tentry.mesh_report, backend="nccl")
    with pytest.raises(ValueError, match="NCCL runs on CUDA"):
        launch.rank_devices(1, "nccl", "cpu")
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA devices"):
        launch.rank_devices(2, "gloo")
    assert launch.rank_devices(3, "gloo", "cpu") == [torch.device("cpu")] * 3


def test_indivisible_carrier_count_is_refused():
    """6 carriers do not split over 4 shards (a mesh stand-in at rank 1
    of 4)."""
    stub = types.SimpleNamespace(
        device_type="cpu", mesh_dim_names=(tmesh.CARRIER_AXIS,),
        size=lambda dim: 4, get_local_rank=lambda axis: 1)
    shard = tmesh.carrier_sharding(stub)
    assert shard.local(torch.arange(8)).tolist() == [2, 3]
    with pytest.raises(ValueError, match="6 rows do not split over the 4"):
        shard.local(torch.arange(6))


def test_window_exceeding_the_slot_is_refused():
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh(device="cpu")
    with launch.world_of_one("gloo", "cpu") as dev:
        smesh = tmesh.make_mesh_2d(1, 1, dev)
        stream = torch.zeros((1, 1024), dtype=torch.complex64)
        with pytest.raises(ValueError, match="exceeds the 1024-sample slot"):
            tstream.sharded_prach_windows(stream, smesh, -40, 1024, 139, 0,
                                          72)
        # a window that fits: the halo at axis size 1 is the slot's tail
        ext = tmesh.halo_from_prev(torch.arange(6.0), 2, smesh,
                                   tmesh.SLOT_AXIS)
        assert ext.tolist() == [4.0, 5.0, 0, 1, 2, 3, 4, 5]
