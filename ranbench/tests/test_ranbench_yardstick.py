"""The yardstick's arithmetic on synthetic inputs: percentiles and spreads,
the trace reduction (busy, idle, top operations, gaps by host span), the
roofline, and the import guard's whole-name comparison."""
import statistics

import numpy as np
import pytest

from ranbench.harness import guard, roofline, stats, trace


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_matches_numpy(q):
    xs = np.random.default_rng(q).exponential(size=257)
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_spread_is_iqr_over_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def test_reduce_trace_busy_gaps_and_owners():
    ops = [("k1", 10, 20), ("k2", 15, 30), ("k1", 50, 60), ("k3", 95, 130)]
    host = [("ranbench.enqueue", 25, 45), ("ranbench.wait", 60, 200)]
    r = trace.reduce_trace(ops, host, (0, 100))
    assert r["busy_s"] == pytest.approx(35e-6)      # 10-30, 50-60, 95-100
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["idle_s"] == pytest.approx(65e-6)
    gaps = dict(r["idle_gaps"])
    # 0-10 and 30-50: the first before any span, the second in enqueue;
    # 60-95 in wait
    assert gaps["between_spans"] == pytest.approx(10e-6)
    assert gaps["ranbench.enqueue"] == pytest.approx(20e-6)
    assert gaps["ranbench.wait"] == pytest.approx(35e-6)
    assert dict(r["device_ops"])["k1"] == pytest.approx(20e-6)
    assert r["count"] == {"k1": 2, "k2": 1, "k3": 1}
    assert r["whole"]["k3"] == pytest.approx(35e-6)  # whole, not clipped


def test_reduce_trace_idle_window():
    r = trace.reduce_trace([], [], (0, 50))
    assert r["busy_s"] == 0
    assert r["idle_gaps"][0][0] == "between_spans"
    assert r["idle_gaps"][0][1] == pytest.approx(50e-6)
    with pytest.raises(ValueError):
        trace.reduce_trace([], [], (5, 5))


def test_roofline_bounds():
    # 1 GB over the HBM peak; a compute-bound decoder shape
    assert roofline.least_seconds(3.35e9) == pytest.approx(1e-3)
    dec = {"rows": 1000, "z": 384, "used_blocks": 35, "k": 8448,
           "edges": 200, "sweeps": 3.0}
    flops = 1000 * 12 * 200 * 384 * 3.0
    nbytes = 1000 * (4 * 35 * 384 + 8448 + 1)
    assert roofline.decoder_least_seconds(dec) == pytest.approx(
        max(nbytes / 3.35e12, flops / 67e12))
    enc = {"rows": 10, "k": 8448, "n": 68 * 384}
    assert roofline.encoder_least_seconds(enc) == pytest.approx(
        10 * (8448 + 68 * 384) / 3.35e12)
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(1.0, 0.0) is None


def test_guard_compares_whole_top_level_names():
    mods = {"srsran_project_23_5_tpu_torch.ops": 0, "jaxtyping": 0,
            "numpy": 0}
    assert guard.forbidden_loaded(mods) == []
    mods.update({"jax.numpy": 0, "srsran_project_23_5_tpu.ops": 0})
    assert guard.forbidden_loaded(mods) == ["jax", "srsran_project_23_5_tpu"]
