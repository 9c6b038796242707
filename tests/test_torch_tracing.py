"""The port's tracer (``utils/tracing``) and its spans on the CPU: nothing
kept and no ``record_function`` made while tracing is off; parents,
request ids and counts while it is on; the in-memory times on the clock of
``torch.profiler``'s exported trace; the span trees of a bucketed
``UpperPhy`` DL and UL slot, of a captured program and of a scan
dispatch, and of a carrier-sharded step on two spawned gloo ranks."""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from srsran_project_23_5_tpu_torch.models import fapi_carrier, gnb_flagship
from srsran_project_23_5_tpu_torch.parallel import launch
from srsran_project_23_5_tpu_torch.parallel import mesh as tmesh
from srsran_project_23_5_tpu_torch.phy import pipeline as tpipeline
from srsran_project_23_5_tpu_torch.phy.upper import upper_phy as tupper_phy
from srsran_project_23_5_tpu_torch.utils import graphs, tracing

torch.set_num_threads(1)

# an exported range and the in-memory span of the same name agree within
# this many µs
CLOCK_US = 50.0


@pytest.fixture
def tracer():
    """The process-global tracer, on and empty; off and empty after."""
    tr = tracing.tracer
    tr.clear()
    tr.enabled = True
    yield tr
    tr.enabled = False
    tr.clear()


@pytest.fixture
def ranges(monkeypatch):
    """The names of the ``record_function`` ranges the tracer makes."""
    made = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        made.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return made


def _tree(records, root: str) -> list:
    """[(root record, [names of its children in the order they began])]
    of each record named `root`."""
    kids: dict = {}
    for r in sorted(records, key=lambda r: r.start_ns):
        kids.setdefault(r.parent, []).append(r)
    return [(r, [c.name for c in kids.get(r.id, [])])
            for r in records if r.name == root]


def test_off_keeps_nothing_and_makes_no_range(ranges):
    tr = tracing.EventTracer()
    with tr.span("a", "x", req=1):
        tr.add("n")
        with tr.span("b", "x"):
            tr.add("n", 2)
    assert tr.records() == [] and ranges == []
    # one shared do-nothing context: nothing is made per span
    assert tr.span("a", "x") is tr.span("b", "y", req=3)


def test_on_keeps_parents_requests_and_counts(ranges):
    tr = tracing.EventTracer()
    tr.enabled = True
    tr.add("dropped")            # no open span
    with tr.span("slot", "t", req=(7, 3)):
        tr.add("h2d")
        with tr.span("prep", "t"):
            tr.add("h2d", 2)
            with tr.span("inner", "t", req="own"):
                pass
        with tr.span("out", "t"):
            pass
    with tr.span("next", "t"):
        pass
    got = {r.name: r for r in tr.records()}
    assert [r.name for r in tr.records()] == ["inner", "prep", "out", "slot",
                                             "next"]
    assert got["slot"].parent is None and got["next"].parent is None
    assert got["prep"].parent == got["out"].parent == got["slot"].id
    assert got["inner"].parent == got["prep"].id
    assert got["prep"].req == got["out"].req == (7, 3)
    assert got["inner"].req == "own" and got["next"].req is None
    assert got["slot"].counts == {"h2d": 1}
    assert got["prep"].counts == {"h2d": 2}
    assert got["out"].counts is None
    assert all(r.start_ns <= r.end_ns for r in got.values())
    assert got["slot"].start_ns <= got["prep"].start_ns
    assert got["prep"].end_ns <= got["out"].start_ns <= got["slot"].end_ns
    assert got["slot"].cat == "t" and ranges == []   # no profiler running


def test_each_thread_has_its_own_parents():
    tr = tracing.EventTracer()
    tr.enabled = True
    seen = threading.Event()

    def other():
        with tr.span("other", "t"):
            seen.set()
    with tr.span("main", "t"):
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive() and seen.is_set()
    got = {r.name: r for r in tr.records()}
    assert got["other"].parent is None and got["other"].tid != got[
        "main"].tid


def test_profiler_turns_spans_on_on_its_clock(tmp_path, ranges):
    """With ``enabled`` off, a recording profiler keeps the spans and makes
    each a ``record_function`` range; the exported range and the kept span
    agree on the Unix-epoch clock."""
    tr = tracing.EventTracer()
    x = torch.ones(64, 64)
    # the first profile of a process, and the first range of each profile,
    # pay the profiler's own set-up (100-200 µs) inside the range's start
    for _ in range(2):
        tr.clear()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tr.span("warm-up", "t"):
                pass
            for i in range(3):
                with tr.span("tracing.outer", "t", req=i):
                    with tr.span("tracing.inner", "t"):
                        x = (x @ x).clamp(-1, 1)
    with tr.span("after", "t"):
        pass
    assert ranges == (["warm-up"] + ["tracing.outer", "tracing.inner"] * 3) * 2
    records = [r for r in tr.records() if r.name != "warm-up"]
    assert [r.name for r in records] == ["tracing.inner",
                                         "tracing.outer"] * 3
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc["baseTimeNanoseconds"])
    exported = sorted((e for e in doc["traceEvents"]
                       if e.get("ph") == "X" and e["name"].startswith(
                           "tracing.")), key=lambda e: float(e["ts"]))
    kept = sorted(records, key=lambda r: r.start_ns)
    assert [e["name"] for e in exported] == [r.name for r in kept]
    for e, r in zip(exported, kept):
        start = base + 1e3 * float(e["ts"])
        end = start + 1e3 * float(e["dur"])
        assert abs(r.start_ns - start) <= CLOCK_US * 1e3, (e, r)
        assert abs(r.end_ns - end) <= CLOCK_US * 1e3, (e, r)


def test_program_spans_capture_then_replay(tracer):
    prog = graphs.GraphPool("cpu").program(lambda x: x * 2)
    for _ in range(3):
        with tracer.span("call", "t"):
            prog(torch.ones(3))
    trees = [kids for _, kids in _tree(tracer.records(), "call")]
    assert trees == [["graphs.copy_in", "graphs.capture"]] + [
        ["graphs.copy_in", "graphs.replay"]] * 2


def _slot_tree(tracer, root):
    [(rec, kids)] = _tree(tracer.records(), root)
    return rec, kids


def test_upper_phy_dl_slot_spans(tracer):
    car = fapi_carrier.tiny_carrier()
    phy = tupper_phy.UpperPhy(car.upper_phy, "cpu")
    rng = np.random.default_rng(3)
    for slot, program in ((0, "graphs.capture"), (1, "graphs.replay")):
        tracer.clear()
        req, data = fapi_carrier.dl_request(car, slot, rng)
        phy.process_dl_slot(req, data)
        rec, kids = _slot_tree(tracer, "upper_phy.dl_slot")
        assert kids == ["upper_phy.dl_prep", "graphs.copy_in", program,
                        "upper_phy.dl_out"]
        assert rec.req == (req.sfn, req.slot) and rec.parent is None
        assert {r.req for r in tracer.records()} == {(req.sfn, req.slot)}
        # each payload made into a device tensor
        h2d = sum((r.counts or {}).get("h2d", 0) for r in tracer.records())
        assert h2d == len(req.ssb_pdus) + len(req.pdcch_pdus) + len(
            data.transport_blocks) > 0
        prep = [r for r in tracer.records()
                if r.name == "upper_phy.dl_prep"][0]
        assert prep.counts == {"h2d": h2d}


def test_upper_phy_ul_slot_spans(tracer):
    car = fapi_carrier.tiny_carrier()
    phy = tupper_phy.UpperPhy(car.upper_phy, "cpu")
    rng = np.random.default_rng(4)
    gen = torch.Generator().manual_seed(4)
    want = ["upper_phy.ul_prep", "graphs.copy_in", None,
            "upper_phy.softbuffer_put", "upper_phy.fetch",
            "upper_phy.indications"]
    for slot, program in ((7, "graphs.capture"), (17, "graphs.replay")):
        req = fapi_carrier.ul_request(car, slot, full=True)
        pay = fapi_carrier.ul_payloads(req, rng)
        rx, prach_rx = fapi_carrier.uplink(req, pay, car, gen)
        tracer.clear()
        inds = phy.process_ul_slot(rx, req, slot_count=slot,
                                   prach_rx=prach_rx)
        assert inds
        rec, kids = _slot_tree(tracer, "upper_phy.ul_slot")
        assert kids == [program if k is None else k for k in want]
        assert {r.req for r in tracer.records()} == {(req.sfn, req.slot)}
        prep = [r for r in tracer.records()
                if r.name == "upper_phy.ul_prep"][0]
        # a new-data flag per PUSCH
        assert prep.counts == {"h2d": len(req.pusch_pdus)} and req.pusch_pdus
        body = [r for r in tracer.records() if r.name == program][0]
        # the PUSCH LLR stage (with its EVM) once per PUSCH, on its plain
        # path on the CPU
        assert body.counts == {"pusch.llr_plain": len(req.pusch_pdus)}
        assert all(r.counts is None for r in tracer.records()
                   if r is not prep and r is not body)


def test_per_pdu_path_has_no_spans(tracer):
    car = fapi_carrier.tiny_carrier()
    phy = tupper_phy.UpperPhy(
        dataclasses.replace(car.upper_phy, bucketed=False), "cpu")
    req, data = fapi_carrier.dl_request(car, 0, np.random.default_rng(5))
    phy.process_dl_slot(req, data)
    assert tracer.records() == []


# a toy model for the pipeline: ok unless the noise is loud
_TOY = tpipeline.PipelineFn(
    run=lambda p, nz: (nz.real.sum(-1) < 50.0,
                       p["x"].float().sum(-1) + nz.real.sum(-1)),
    draw=lambda b, g: (torch.randn((b, 5), generator=g,
                                   dtype=torch.complex64),))


def test_scan_dispatch_spans(tracer):
    pipe = tpipeline.SlotPipeline(
        tpipeline.PipelineConfig(carrier=None, slots_per_batch=3,
                                 scan_batches=2),
        device="cpu", seed=0, batch_fn=_TOY)
    x = {"x": torch.ones((3, 7), dtype=torch.int8)}
    pipe.warmup_scan(x)
    tracer.clear()
    for seed in (11, 2**40 + 3):
        pipe.submit_scan(x, seed)
    ok, _, n = pipe.fetch_accumulated()
    assert ok and n == 12
    trees = _tree(tracer.records(), "pipeline.dispatch")
    assert [kids for _, kids in trees] == [[
        "pipeline.noise", "pipeline.launch", "pipeline.fold"]] * 2
    # the launch is the scan program's call: its copy-in, then its replay
    assert [kids for _, kids in _tree(tracer.records(),
                                      "pipeline.launch")] == [[
        "graphs.copy_in", "graphs.replay"]] * 2
    assert [rec.req for rec, _ in trees] == [11, 2**40 + 3]
    for rec, _ in trees:
        assert {r.req for r in tracer.records() if r.parent == rec.id} == {
            rec.req}
    assert [r.name for r in tracer.records()
            if r.parent is None] == ["pipeline.dispatch"] * 2 + [
        "pipeline.fetch"]


MESH_CARRIERS = 4


def traced_mesh_steps(rank: int, device: torch.device, tb, noise) -> list:
    """A rank program: two sharded tiny-carrier steps with the tracer on;
    (name, id, parent, request, counts) of each record kept."""
    tr = tracing.tracer
    tr.clear()
    tr.enabled = True
    step = gnb_flagship.sharded_multi_carrier_step(
        tmesh.make_mesh(device=device), gnb_flagship.tiny_carrier(), 2)
    for _ in range(2):
        step(tb, noise)
    tr.enabled = False
    return [(r.name, r.id, r.parent, r.req, dict(r.counts or {}))
            for r in tr.records()]


def test_mesh_step_spans_on_two_ranks():
    """On each of two ranks a sharded step is ``mesh.step`` (request: the
    step's index) over ``mesh.local``, ``mesh.loopback`` and ``mesh.gather``
    in that order, and ``mesh.gather_bytes`` on the gather is what the rank
    sends: its 2 carriers' ok (1 byte), SINR (4) and bit errors (4)."""
    car = gnb_flagship.tiny_carrier()
    gen = torch.Generator().manual_seed(5)
    tb = torch.randint(0, 2, (MESH_CARRIERS, car.sh.tbs), generator=gen,
                       dtype=torch.int8)
    noise = torch.complex(*torch.randn((2, MESH_CARRIERS, car.slot_samples),
                                       generator=gen)) * 0.05
    ranks = launch.spawn(2, traced_mesh_steps, tb, noise, backend="gloo",
                         device="cpu")
    for recs in ranks:
        by_id = {r[1]: r for r in recs}
        steps = [r for r in recs if r[0] == "mesh.step"]
        assert [r[3] for r in steps] == [0, 1]
        for s in steps:
            kids = sorted((r for r in recs if r[2] == s[1]),
                          key=lambda r: r[1])
            assert [k[0] for k in kids] == ["mesh.local", "mesh.loopback",
                                            "mesh.gather"]
            assert all(k[3] == s[3] for k in kids)
            gather = kids[-1]
            assert gather[4] == {"mesh.gather_bytes": (MESH_CARRIERS // 2)
                                 * (1 + 4 + 4)}
            assert s[2] is None and by_id[gather[2]] is s
