"""The port's captured programs (``utils/graphs.py``) on the CPU: the upper
PHY's slot programs and the app's UE modem programs against the JAX
package's jitted programs.

On the CPU a program runs its body eagerly on its static input buffers, so
these tests reach the copy-in that a CUDA graph replays on: a program
built on one slot must give the JAX package's results on later slots, with
other slot numbers, sequences, payloads, PRACH presence and HARQ state.
Tolerances: bits, verdicts and preambles exact; SINR within 0.05 dB, TA
within 0.05 samples, detection metrics within 1e-4 relative (as
``test_torch_upper_phy.py``); grids within 1e-5 of max|ref|; CSI-RS SINR
within 1e-4 relative.  A guard over the bodies (a torch function mode)
holds every program to what a CUDA graph capture allows: no host read of a
device value, no tensor made from host data, once the warm-up has filled
the per-config caches.  ``tests/test_torch_cuda.py`` holds replays against
eager runs on the card.
"""
import contextlib
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax.numpy as jnp

from srsran_project_23_5_tpu.apps import phy_loop as jphy_loop
from srsran_project_23_5_tpu.fapi import messages as fapi
from srsran_project_23_5_tpu.ops import prach as prach_ops
from srsran_project_23_5_tpu.phy.upper import csi_rs, pdcch, pucch, sch, ulsch
from srsran_project_23_5_tpu.ran import tbs as tbs_mod
from srsran_project_23_5_tpu_torch import convert
from srsran_project_23_5_tpu_torch.apps import gnb as tapp_gnb
from srsran_project_23_5_tpu_torch.apps import phy_loop as tphy_loop
from srsran_project_23_5_tpu_torch.fapi import messages as tfapi
from srsran_project_23_5_tpu_torch.models import fapi_carrier
from srsran_project_23_5_tpu_torch.ops.ldpc import decoder_cuda, encoder_cuda
from srsran_project_23_5_tpu_torch.phy.upper import \
    upper_phy as tupper_phy
from srsran_project_23_5_tpu_torch.utils import graphs
from test_torch_upper_phy import (_assert_same_indications, _awgn,
                                  _dl_request, _phys, _ul)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NOF_PRB = 68
NSC = NOF_PRB * 12
CPU = torch.device("cpu")


# ------------------------------------------------------------ programs
def test_program_copies_inputs_every_call():
    """Every call copies its inputs into the static buffers: a tensor
    changed in place and passed again is seen; inputs keep their shapes;
    eager runs on the inputs themselves."""
    pool = graphs.GraphPool(CPU)
    prog = pool.program(lambda x, pair: {"s": x.sum() + pair[0] * pair[1]})
    x = torch.arange(4.0)
    two, three = torch.tensor(2.0), torch.tensor(3.0)
    assert float(prog(x, (two, three))["s"]) == 12.0
    static = prog.inputs[0]
    assert static is not x and torch.equal(static, x)
    x.mul_(2)
    assert float(prog(x, (two, three))["s"]) == 18.0
    assert prog.inputs[0] is static and torch.equal(static, x)
    assert float(prog.eager(torch.ones(2), (two, two))["s"]) == 6.0
    assert pool.cached("k", lambda: prog.fn) is pool.cached("k", None)
    # the CPU's first call stands for the capture, the second for a replay
    assert pool.captures == pool.replays == 1
    assert pool.reserved_bytes() == 0
    with pytest.raises(ValueError, match="shapes"):
        prog(torch.ones(3), (two, three))
    with pytest.raises(TypeError, match="tensor"):
        prog(x, (2.0, three))


def test_graphs_imports_no_ops():
    """The capture layer depends on nothing it captures: importing
    ``utils.graphs`` in a fresh interpreter loads no module of ``ops``
    (each kernel wrapper registers itself in ``graphs.KERNELS``)."""
    code = ("import sys\n"
            "from srsran_project_23_5_tpu_torch.utils import graphs\n"
            "ops = sorted(m for m in sys.modules\n"
            "             if m.startswith('srsran_project_23_5_tpu_torch.ops'))\n"
            "assert not ops and not graphs.KERNELS, (ops, graphs.KERNELS)\n"
            "from srsran_project_23_5_tpu_torch.phy.upper import sch\n"
            "assert sorted(graphs.KERNELS) == ['decoder', 'encoder', "
            "'pusch_llr']\n"
            "from srsran_project_23_5_tpu_torch.models import gnb_mixed\n"
            "assert sorted(graphs.KERNELS) == ['channel_mix', 'decoder', "
            "'encoder', 'pusch_llr']\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ------------------------------------------------------------ UL programs
def _sh(rnti, prb_start, nof_prb, slot, qm=2, rate=0.5, **kw):
    bits = tbs_mod.tbs_calculate(14, 36, 0, rate, qm, 1, nof_prb)
    return sch.ShConfig(rnti=rnti, tbs=bits, qm=qm, prb_start=prb_start,
                        nof_prb=nof_prb, dmrs_symbols=(2, 7, 11),
                        slot_in_frame=slot, **kw)


_UCI = ulsch.UciOnPusch(nof_harq_ack_bits=2, nof_csi_part1_bits=7,
                        g_harq_ack=16, g_harq_ack_rvd=16, g_csi_part1=64)
PRACH_ROOT = 22


def _full_slot(rng, slot, preamble):
    """A PUSCH with UCI, a 16QAM PUSCH, PUCCH F1 and F2 at `slot`, and a
    short-format PRACH window with `preamble` (None: no window)."""
    cfgs = [_sh(0x20, 0, 8, slot, uci=_UCI),
            _sh(0x21, 8, 16, slot, qm=4, rate=0.4, time_interp=True)]
    f1 = pucch.PucchF1Config(prb=NOF_PRB - 1, slot_in_frame=slot)
    f2 = pucch.PucchF2Config(prb_start=60, nof_prb=2, rnti=0x22,
                             nof_uci_bits=5, slot_in_frame=slot)
    req = fapi.UlTtiRequest(
        0, slot, pusch_pdus=[fapi.PuschPdu(c, harq_process=slot % 8)
                             for c in cfgs],
        pucch_pdus=[fapi.PucchPdu(format1=f1, rnti=0x66, harq_pid=2),
                    fapi.PucchPdu(format2=f2)],
        prach_pdus=[fapi.PrachPdu(root_sequence_index=PRACH_ROOT,
                                  length=139)])
    ack = rng.integers(0, 2, 2).astype(np.int8)
    csi1 = rng.integers(0, 2, 7).astype(np.int8)
    grid = jnp.zeros((14, NSC), jnp.complex64)
    grid = sch.pusch_transmit(
        jnp.asarray(rng.integers(0, 2, cfgs[0].tbs).astype(np.int8)),
        cfgs[0], grid, ack_bits=jnp.asarray(ack), csi1_bits=jnp.asarray(csi1))
    grid = sch.pusch_transmit(
        jnp.asarray(rng.integers(0, 2, cfgs[1].tbs).astype(np.int8)),
        cfgs[1], grid)
    grid = pucch.pucch_f1_transmit(jnp.asarray([slot % 2], jnp.int8), f1,
                                   grid)
    grid = pucch.pucch_f2_transmit(
        jnp.asarray(rng.integers(0, 2, 5).astype(np.int8)), f2, grid)
    rx = (np.asarray(grid)[None] + _awgn(rng, (1, 14, NSC), 0.02)
          ).astype(np.complex64)
    prach_rx = None
    if preamble is not None:
        ns = prach_ops.num_shifts(139, 13)
        pre = prach_ops.generate(PRACH_ROOT + preamble // ns, preamble % ns,
                                 139, 13)
        prach_rx = (pre[None] + _awgn(rng, (1, 139), 0.07)).astype(
            np.complex64)
    return req, rx, prach_rx


def _harq_slot(rng, slot, rnti, tb, rv, new_data):
    """One QPSK PUSCH (TBS 1608, 24 PRB) at -2 dB: rv=0 fails alone, and
    the rv=2 retransmission passes combined."""
    cfg = sch.ShConfig(rnti=rnti, tbs=1608, qm=2, nof_prb=24, rv=rv,
                       dmrs_symbols=(2, 7, 11), slot_in_frame=slot)
    req = fapi.UlTtiRequest(0, slot, pusch_pdus=[
        fapi.PuschPdu(cfg, harq_process=3, new_data=new_data)])
    clean = np.asarray(sch.pusch_transmit(
        jnp.asarray(tb), cfg, jnp.zeros((14, NSC), jnp.complex64)))
    rx = (clean[None] + _awgn(rng, (1, 14, NSC), 10 ** (2 / 20))
          ).astype(np.complex64)
    return req, rx


def _crc(inds):
    return [i.tb_crc_ok for i in inds if isinstance(i, tfapi.CrcIndication)]


def test_ul_programs_serve_later_slots():
    """Slot 1 builds the full-mix program (2 PUSCH, one with UCI, PUCCH
    F1/F2, PRACH); slots 2 and 6 reuse it with other slot numbers (DM-RS,
    F1 hopping, F2 DM-RS), payloads, HARQ-ACK and preambles; slot 3 builds
    the same mix without a PRACH window and slot 7 reuses it; a HARQ pair
    (rv=0 fails, rv=2 combined passes) runs in between.  Every slot's
    indications equal the JAX UpperPhy's; four programs in each package."""
    rng = np.random.default_rng(31)
    jphy, tphy = _phys(NOF_PRB)
    tb = rng.integers(0, 2, 1608).astype(np.int8)
    slots = [(1, 5), (2, 40), (3, None), "rv0", "rv2", (6, 17), (7, None)]
    for s in slots:
        if s == "rv0":
            req, rx = _harq_slot(rng, 4, 0x200, tb, 0, True)
            prach_rx, slot = None, 4
        elif s == "rv2":
            req, rx = _harq_slot(rng, 5, 0x200, tb, 2, False)
            prach_rx, slot = None, 5
        else:
            slot, pre = s
            req, rx, prach_rx = _full_slot(rng, slot, pre)
        want, got = _ul(jphy, tphy, rx, req, slot_count=slot,
                        prach_rx=prach_rx)
        _assert_same_indications(got, want)
        if s == "rv0":
            assert _crc(got) == [False] and len(tphy.softbuffers) == 1
        elif s == "rv2":
            assert _crc(got) == [True] and len(tphy.softbuffers) == 0
        else:
            assert _crc(got) == [True, True]
            rach = [i for i in got if isinstance(i, tfapi.RachIndication)]
            assert ([[p[0] for p in r.preambles] for r in rach]
                    == ([] if s[1] is None else [[s[1]]]))
            uci = [i for i in got if isinstance(i, tfapi.UciIndication)]
            assert all(u.detected for u in uci)
            assert uci[0].harq_bits.ravel()[0] == slot % 2
    assert tphy.ul_programs.nof_compiled == jphy.ul_programs.nof_compiled == 4


def test_dl_grids_kept_across_slots():
    """Three DL slots of one signature (SSB, PDCCH, two PDSCH, CSI-RS), the
    grids kept together: each equals the JAX grid of its own slot."""
    rng = np.random.default_rng(32)
    jphy, tphy = _phys(52)
    kept = []
    for slot in (0, 3, 7):
        req, data = _dl_request(rng, slot)
        kept.append((np.asarray(jphy.process_dl_slot(req, data)),
                     tphy.process_dl_slot(convert.from_jax_message(req),
                                          convert.from_jax_message(data))))
    assert tphy.dl_programs.nof_compiled == 1
    for want, got in kept:
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-5, err
    assert not torch.equal(kept[0][1], kept[1][1])


def test_softbuffer_unchanged_by_another_ue():
    """UE A's rv=0 softbuffer stays as it was through UE B's slot (another
    program on the same graph pool), then A's rv=2 combines it and
    passes; every indication equals the JAX UpperPhy's."""
    rng = np.random.default_rng(33)
    jphy, tphy = _phys(NOF_PRB)
    tb_a = rng.integers(0, 2, 1608).astype(np.int8)
    tb_b = rng.integers(0, 2, 1608).astype(np.int8)
    req, rx = _harq_slot(rng, 1, 0x200, tb_a, 0, True)
    want, got = _ul(jphy, tphy, rx, req, slot_count=1)
    _assert_same_indications(got, want)
    kept = tphy.softbuffers.get(0x200, 3).clone()
    req, rx = _harq_slot(rng, 2, 0x201, tb_b, 0, True)
    want, got = _ul(jphy, tphy, rx, req, slot_count=2)
    _assert_same_indications(got, want)
    assert _crc(got) == [False] and len(tphy.softbuffers) == 2
    assert torch.equal(tphy.softbuffers.get(0x200, 3), kept)
    prior_j = np.asarray(jphy.softbuffers.get(0x200, 3))
    assert (np.abs(kept.numpy() - prior_j).max()
            <= 1e-4 * np.abs(prior_j).max())
    req, rx = _harq_slot(rng, 3, 0x200, tb_a, 2, False)
    want, got = _ul(jphy, tphy, rx, req, slot_count=3)
    _assert_same_indications(got, want)
    assert _crc(got) == [True] and len(tphy.softbuffers) == 1


# ------------------------------------------------------------ UE modem
UE_PRB, UE_RNTI = 52, 0x4601


def _ue_configs(slot):
    pdsch = _sh(UE_RNTI, 4, 20, slot, qm=4, rate=0.5)
    pusch = _sh(UE_RNTI, 10, 12, slot)
    f1 = pucch.PucchF1Config(prb=UE_PRB - 1, initial_cyclic_shift=3,
                             slot_in_frame=slot)
    f2 = pucch.PucchF2Config(prb_start=40, nof_prb=2, rnti=UE_RNTI,
                             nof_uci_bits=4, slot_in_frame=slot)
    csi = csi_rs.CsiRsConfig(row=2, prb_start=0, nof_prb=UE_PRB, symbol=4,
                             slot_in_frame=slot)
    dci = pdcch.PdcchConfig(rnti=UE_RNTI, payload_size=39,
                            aggregation_level=4, n_id=1, n_rnti=UE_RNTI,
                            cce_index=4)
    return pdsch, pusch, f1, f2, csi, dci


def _t(cfg):
    return convert._CONFIGS[type(cfg).__name__](cfg)


def test_ue_programs_match_jax_jits():
    """Each UE modem program on one graph pool against its JAX jit on the
    same inputs, on two slots (the second replays the programs the first
    built, on its own DM-RS, PUCCH sequences and candidates): PDSCH
    receive (bits, CRC), the blind DCI decode, the CSI-RS SINR, PUSCH and
    PUCCH F1/F2 transmit."""
    rng = np.random.default_rng(34)
    pool = graphs.GraphPool(CPU)
    nsc = UE_PRB * 12
    for slot in (3, 4):
        pdsch, pusch, f1, f2, csi, dci = _ue_configs(slot)
        tb = rng.integers(0, 2, pdsch.tbs).astype(np.int8)
        payload = rng.integers(0, 2, dci.payload_size).astype(np.int8)
        grid = sch.pdsch_transmit(jnp.asarray(tb), pdsch,
                                  jnp.zeros((14, nsc), jnp.complex64))
        grid = pdcch.pdcch_transmit(jnp.asarray(payload), dci, grid)
        grid = csi_rs.generate(csi, grid)
        rx = (np.asarray(grid) + _awgn(rng, (14, nsc), 0.05)).astype(
            np.complex64)
        trx = torch.from_numpy(rx)

        jbits, jok = jphy_loop._ue_pdsch_rx_fn(pdsch)(jnp.asarray(rx)[None])
        tbits, tok = tphy_loop.ue_pdsch_receive(trx, _t(pdsch), pool)
        assert bool(tok) and bool(jok)
        assert np.array_equal(tbits.numpy(), np.asarray(jbits))

        cands = [0, 4, 8, 12 + slot]
        jpay, jcrc = jphy_loop._blind_decode_fn(dci)(
            jnp.asarray(rx), jnp.asarray(cands, jnp.int32))
        tpay, tcrc = tphy_loop.ue_blind_decode(
            trx, _t(dci), torch.tensor(cands, dtype=torch.int32), pool)
        assert np.array_equal(tcrc, np.asarray(jcrc))
        assert np.array_equal(tpay, np.asarray(jpay))
        assert tcrc.tolist() == [False, True, False, False]
        assert np.array_equal(tpay[1], payload)

        want = float(np.asarray(jphy_loop._csi_meas(csi)(jnp.asarray(rx))))
        got = tphy_loop.csi_sinr_db(trx, _t(csi), pool)
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)

        ul = rng.standard_normal((14, nsc)).astype(np.float32) * 0.1
        ul = ul.astype(np.complex64)
        bits = rng.integers(0, 2, pusch.tbs).astype(np.int8)
        cqi = rng.integers(0, 2, 4).astype(np.int8)
        one = np.ones(1, np.int8)
        for jfn, tfn, b in (
                (jphy_loop._ue_pusch_tx_fn(pusch),
                 lambda b, g: tphy_loop.ue_pusch_transmit(b, _t(pusch), g,
                                                          pool), bits),
                (jphy_loop._ue_pucch_f1_tx_fn(f1),
                 lambda b, g: tphy_loop.ue_pucch_f1_transmit(b, _t(f1), g,
                                                             pool), one),
                (jphy_loop._ue_pucch_f2_tx_fn(f2),
                 lambda b, g: tphy_loop.ue_pucch_f2_transmit(b, _t(f2), g,
                                                             pool), cqi)):
            want = np.asarray(jfn(jnp.asarray(b), jnp.asarray(ul)))
            got = tfn(torch.from_numpy(b), torch.from_numpy(ul)).numpy()
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err < 1e-5, err
    # slot_in_frame is normalised out: one program per static config
    # (the CSI-RS config keeps its slot, as in the JAX app)
    assert len(pool._cached) == 7


# ------------------------------------------------------------ capture rules
_T = torch.Tensor
# what a CUDA graph capture cannot take: a host read of a device value, a
# data-dependent shape, a tensor made from host data (a host-to-device copy)
_BANNED = {_T.item, _T.__bool__, _T.__float__, _T.__int__, _T.__index__,
           _T.tolist, _T.cpu, _T.numpy, torch.nonzero, _T.nonzero,
           torch.masked_select, _T.masked_select, torch.tensor,
           torch.as_tensor, torch.unique, _T.unique, torch.argwhere,
           _T.argwhere}


class _CaptureGuard(TorchFunctionMode):
    """Records the calls of a program body that a capture refuses."""

    def __init__(self, hits: list) -> None:
        super().__init__()
        self.hits = hits
        self.exempt = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if not self.exempt:
            bad = func in _BANNED
            if func in (_T.__getitem__, _T.__setitem__):
                idx = args[1] if isinstance(args[1], tuple) else (args[1],)
                bad = any(isinstance(i, torch.Tensor)
                          and i.dtype == torch.bool for i in idx)
            if bad:
                self.hits.append(getattr(func, "__qualname__", str(func)))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _guarded(monkeypatch):
    """Every program call inside the block runs its body twice: once as
    the warm-up (first call of the program only), then under the guard.
    The LDPC wrappers are exempt: on the card they launch a kernel; their
    plain versions run here.  Yields the list of refused calls."""
    hits: list = []
    guard = _CaptureGuard(hits)
    warmed: set = set()
    from_numpy, call = torch.from_numpy, graphs.Program.__call__

    def guarded_from_numpy(a):
        if guard.active and not guard.exempt:
            hits.append("from_numpy")
        return from_numpy(a)

    def exempt(fn):
        def run(*a, **k):
            guard.exempt += 1
            try:
                return fn(*a, **k)
            finally:
                guard.exempt -= 1
        run.launches = fn.launches
        return run

    def guarded_call(prog, *inputs):
        fn, first = prog.fn, id(prog) not in warmed
        warmed.add(id(prog))

        def body(*a):
            if first:
                fn(*a)
            guard.active = True
            try:
                with guard:
                    return fn(*a)
            finally:
                guard.active = False
        prog.fn = body
        try:
            return call(prog, *inputs)
        finally:
            prog.fn = fn

    guard.active = False
    monkeypatch.setattr(torch, "from_numpy", guarded_from_numpy)
    monkeypatch.setattr(decoder_cuda, "decode", exempt(decoder_cuda.decode))
    monkeypatch.setattr(encoder_cuda, "encode", exempt(encoder_cuda.encode))
    monkeypatch.setattr(graphs.Program, "__call__", guarded_call)
    yield hits


def test_capture_guard_catches_host_reads(monkeypatch):
    """The guard itself: a body that reads a value, makes a tensor from
    host data or indexes with a mask is refused on every call."""
    prog = graphs.GraphPool(CPU).program(
        lambda x: (x.sum().item(), torch.from_numpy(np.zeros(2)), x[x > 0],
                   torch.as_tensor([1]), x * 2))
    with _guarded(monkeypatch) as hits:
        prog(torch.ones(3))
        prog(torch.ones(3))
    assert len(hits) == 8 and set(hits) >= {"from_numpy"}


def test_upper_phy_programs_are_capture_safe(monkeypatch):
    """The FAPI carrier's DL slots and UL mixes (4-layer PUSCH, UCI on
    PUSCH, PUCCH F1/F2, multi-root PRACH) and a HARQ pair: after the
    warm-up, no program body reads a device value or copies host data,
    and every slot still passes its checks."""
    car = fapi_carrier.tiny_carrier()
    phy = tupper_phy.UpperPhy(car.upper_phy, "cpu")
    gen = torch.Generator().manual_seed(35)
    rng = np.random.default_rng(35)
    with _guarded(monkeypatch) as hits:
        for slot in range(3):
            req, data = fapi_carrier.dl_request(car, slot, rng)
            phy.process_dl_slot(req, data)
            ul = fapi_carrier.ul_request(car, slot, full=slot % 2 == 0)
            pay = fapi_carrier.ul_payloads(ul, rng)
            rx, prach_rx = fapi_carrier.uplink(ul, pay, car, gen)
            inds = phy.process_ul_slot(rx, ul, slot_count=slot,
                                       prach_rx=prach_rx)
            checks = fapi_carrier.ul_checks(car, ul, pay, inds,
                                            phy.last_ul_slot["pusch"])
            assert all(checks.values()), (slot, checks)
        first = fapi_carrier.ul_request(car, 3, full=False, harq_process=15)
        retx = fapi_carrier.ul_request(car, 4, full=False, harq_process=15,
                                       rv=2, new_data=False)
        pay = fapi_carrier.ul_payloads(first, rng)
        for i, req in enumerate((first, retx)):
            rx, _ = fapi_carrier.uplink(req, pay, car, gen,
                                        snr_db=car.harq_snr_db)
            phy.process_ul_slot(rx, req, slot_count=3 + i)
    assert hits == []
    assert len(phy.softbuffers) == 0
    assert (phy.ul_programs.nof_compiled, phy.dl_programs.nof_compiled) == (
        3, 1)


def test_sharded_flagship_step_is_capture_safe(monkeypatch):
    """The carrier-sharded flagship step at the cell edge (68 PRB, QPSK MCS
    3, LDPC base graph 2) on a one-rank gloo world: after the warm-up its
    program body reads no device value and copies no host data, and every
    carrier decodes with no bit wrong on both steps."""
    from srsran_project_23_5_tpu_torch.models import gnb_flagship
    from srsran_project_23_5_tpu_torch.parallel import launch
    from srsran_project_23_5_tpu_torch.parallel import mesh as tmesh
    car = gnb_flagship.default_carrier(68, 2, 4360)
    gen = torch.Generator().manual_seed(18)
    tb = torch.randint(0, 2, (2, car.sh.tbs), generator=gen,
                       dtype=torch.int8)
    sigma = float(np.sqrt(car.nfft) * 10 ** (-5.0 / 20))
    nz = torch.randn((2, 2, car.slot_samples), generator=gen)
    noise = torch.complex(nz[0], nz[1]) * (sigma / np.sqrt(2.0))
    with launch.world_of_one("gloo", CPU) as dev, \
            _guarded(monkeypatch) as hits:
        step = gnb_flagship.sharded_multi_carrier_step(
            tmesh.make_mesh(device=dev), car)
        for _ in range(2):
            ok, _, errors = step(tb, noise)
            assert ok.all() and not errors.any()
    assert hits == []


def test_app_programs_are_capture_safe(monkeypatch):
    """The whole loopback app at 52 PRB (gNB slot programs and the UE
    modem's): no program body reads a device value or copies host data;
    the UE attaches and every packet arrives."""
    raw = {"cell": {"pci": 1, "nof_prb": 52, "mu": 1,
                    "tdd": {"period": 10, "nof_dl": 6, "nof_ul": 3}},
           "phy": "loopback", "slots": 200, "snr_db": 30.0,
           "platform": "cpu", "log": {"level": "warning"},
           "ue": {"enabled": True, "dl_packets": 2, "ul_packets": 2}}
    gnb = tapp_gnb.Gnb(tapp_gnb.GnbConfig.from_dict(raw))
    with _guarded(monkeypatch) as hits:
        rep = gnb.run()
    assert hits == []
    assert rep["ue_rrc_state"] == "active"
    assert rep["ue_dl_rx_packets"] == rep["core_ul_rx_packets"] == 2
    # one program per static config on each side
    ue_keys = [k[0] for k in gnb._phy.graphs._cached]
    assert {"csi_sinr", "blind_decode", "pdsch_rx", "pusch_tx",
            "pucch_f1_tx", "pucch_f2_tx"} <= set(ue_keys)


def test_programs_module_imports_no_jax():
    code = ("import sys\n"
            "import srsran_project_23_5_tpu_torch.utils.graphs\n"
            "import srsran_project_23_5_tpu_torch.phy.upper.slot_programs\n"
            "import srsran_project_23_5_tpu_torch.apps.phy_loop\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m.split('.')[0] == 'srsran_project_23_5_tpu')\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
