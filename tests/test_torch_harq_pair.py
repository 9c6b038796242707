"""HARQ pairs of the port's mixed slot on the CPU (68 PRB, 64QAM R=0.6533,
seeded): ``gnb_mixed.harq_pair_batch`` against the benchmark's plain
reference (``ranbench/reference/models/gnb_harq.py``, the reference's own
float64 receive stages) on the same payloads and noise; the softbuffer
combine that the upper PHY's slot programs share; the tracer's counts of a
pair; and the pair through ``SlotPipeline``'s scan mode.

At 12.5 dB on the uplink (the downlink at 20 dB) every first transmission
fails on the truncated graph and every combination passes on the full one,
as in the ``harq273.b64`` cell.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ranbench.reference.models import gnb_harq as ref_harq
from ranbench.reference.models import gnb_mixed as ref_mixed
from srsran_project_23_5_tpu_torch.models import gnb_mixed
from srsran_project_23_5_tpu_torch.phy import pipeline
from srsran_project_23_5_tpu_torch.phy.upper import harq, sch, slot_programs
from srsran_project_23_5_tpu_torch.utils.tracing import tracer

torch.set_num_threads(1)

B = 3
UL_SNR_DB = 12.5
SLOT_VERDICTS = ("ok", "ul0_ok", "ul1_ok", "dl0_ok", "dl1_ok", "pucch_ok",
                 "prach_ok", "dci_crc_ok")
SLOT_SINRS = ("sinr_ul0_db", "sinr_ul1_db", "sinr_dl0_db", "csi_sinr_db")
# the port's receive stages in float32 against the reference's in float64:
# the gap of a SINR is float32 rounding (~2e-6 dB at 12.5 dB); the limit is
# the one the benchmark's CPU test of the mixed cell gives its SINRs
SINR_TOL_DB = 1e-3


@pytest.fixture(scope="module")
def pairs():
    """The port's and the reference's results on the same B pairs."""
    cfg = gnb_mixed.default_mixed(nof_prb=68)
    rcfg = ref_mixed.default_mixed(nof_prb=68)
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(23), B, "cpu")
    noise = gnb_mixed.draw_harq_noise(
        cfg, B, torch.Generator().manual_seed(23), UL_SNR_DB)
    return (gnb_mixed.harq_pair_batch(pay, noise, cfg),
            ref_harq.harq_pair(pay, noise, rcfg), cfg)


def test_pairs_fail_first_and_pass_combined(pairs):
    port, _, _ = pairs
    assert port.ok.all()
    for ue in ("u0", "u1"):
        assert not port.first_ok[ue].any()
        assert port.combined_ok[ue].all()
        assert port.combined[ue][1].all()
    assert not port.first.ok.any() and port.second.ok.all()


@pytest.mark.parametrize("slot", ["first", "second"])
def test_slot_verdicts_match_reference(pairs, slot):
    port, ref, _ = pairs
    for f in SLOT_VERDICTS:
        assert torch.equal(getattr(getattr(port, slot), f),
                           getattr(getattr(ref, slot), f)), f


def test_pair_verdict_matches_reference(pairs):
    port, ref, _ = pairs
    assert torch.equal(port.ok, ref.ok)


@pytest.mark.parametrize("slot", ["first", "second"])
def test_slot_sinrs_match_reference(pairs, slot):
    port, ref, _ = pairs
    for f in SLOT_SINRS:
        gap = (getattr(getattr(port, slot), f).double()
               - getattr(getattr(ref, slot), f).double()).abs().max()
        assert float(gap) <= SINR_TOL_DB, (f, float(gap))


@pytest.mark.parametrize("ue", ["u0", "u1"])
def test_combined_bits_match_reference(pairs, ue):
    port, ref, cfg = pairs
    bits, ok = port.combined[ue]
    assert torch.equal(bits, ref.combined[ue][0])
    assert torch.equal(ok, ref.combined[ue][1])
    sh = {"u0": cfg.pusch0, "u1": cfg.pusch1}[ue]
    assert bits.shape[:2] == (B, sh.segments.nof_segments)


@pytest.mark.parametrize("new_data", [None, False, True])
def test_soft_combine(new_data):
    llr = torch.randn(2, 3, 5, 7)
    prior = torch.randn(2, 3, 5, 7)
    nd = None if new_data is None else torch.tensor(new_data)
    tracer.clear()
    tracer.enabled = True
    try:
        with tracer.span("t", "test"):
            got = harq.soft_combine(llr, prior, nd)
    finally:
        tracer.enabled = False
    want = llr if new_data else llr + prior
    assert torch.equal(got, want)
    # only a retransmission known on the host counts its 2 × 3 TBs
    assert tracer.records()[-1].counts == (
        {"harq.combined": 6} if new_data is None else None)


def test_slot_programs_combine_through_soft_combine():
    # the upper PHY's in-graph combine is the same function as the pair's
    assert slot_programs.harq.soft_combine is harq.soft_combine
    assert gnb_mixed.harq.soft_combine is harq.soft_combine


def test_tracer_counts_one_pair_batch():
    cfg = gnb_mixed.default_mixed(nof_prb=68)
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(5), 2, "cpu")
    noise = gnb_mixed.draw_harq_noise(cfg, 2, torch.Generator().manual_seed(5),
                                      UL_SNR_DB)
    tracer.clear()
    gnb_mixed.harq_pair_batch(pay, noise, cfg)
    assert tracer.records() == []          # nothing kept while off
    tracer.enabled = True
    try:
        gnb_mixed.harq_pair_batch(pay, noise, cfg)
    finally:
        tracer.enabled = False
    recs = [r for r in tracer.records() if r.name == "harq.pair"]
    assert len(recs) == 1 and recs[0].cat == "harq"
    rows = 2 * (cfg.pusch0.segments.nof_segments
                + cfg.pusch1.segments.nof_segments)
    assert recs[0].counts["ldpc.full_graph"] == rows
    assert recs[0].counts["harq.combined"] == 2 * 2


@pytest.mark.parametrize("rv,full", [(0, False), (2, True)])
def test_decode_cbs_counts_full_graph_rows(rv, full):
    cfg = gnb_mixed.default_mixed(nof_prb=68)
    sh = dataclasses.replace(cfg.pusch1, rv=rv)
    c, n = sch.llr_full_shape(sh)
    tracer.clear()
    tracer.enabled = True
    try:
        with tracer.span("t", "test"):
            sch.decode_cbs(torch.zeros((2, c, n)), sh, 1)
    finally:
        tracer.enabled = False
    counts = tracer.records()[-1].counts or {}
    assert counts.get("ldpc.full_graph", 0) == (2 * c if full else 0)


def test_pairs_through_the_scan_pipeline():
    cfg = gnb_mixed.default_mixed(nof_prb=68)
    k, b = 2, 2
    run, draw = gnb_mixed.harq_batch_fn_for_pipeline(cfg, UL_SNR_DB)
    pipe = pipeline.SlotPipeline(
        pipeline.PipelineConfig(carrier=None, slots_per_batch=b,
                                scan_batches=k),
        device="cpu", seed=0, batch_fn=pipeline.PipelineFn(run, draw))
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(9), b, "cpu")
    _, ok, mean = pipe.warmup_scan(pay)
    assert ok and abs(mean - UL_SNR_DB) < 1.0
    pipe.submit_scan(pay, 3)
    all_ok, _, n = pipe.fetch_accumulated()
    assert all_ok and n == k * b
    # batch 1 of a dispatch's noise, eagerly, against the pipeline's step
    noise = pipe.scan_noise(3)
    res = gnb_mixed.harq_pair_batch(pay, tuple(x[1] for x in noise), cfg)
    got_ok, got_sinr = run(pay, *(x[1] for x in noise))
    assert torch.equal(got_ok, res.ok) and res.ok.all()
    assert torch.equal(got_sinr, 0.5 * (res.first.sinr_ul_db
                                        + res.second.sinr_ul_db))
