"""Parity of the port's gNB app with the JAX package (CPU): the held copies
of the JAX-free host stack, the FAPI validators, the grid sanitizer,
``apps/phy_loop``'s UE side and the whole over-the-air loopback app.

- Each copied module equals its original line for line, apart from the
  replacements listed in ``REPLACEMENTS`` with their reasons (the two
  native loaders, which build into ``build/native/``, and two docstring
  paths of the ASN.1 codec).
- The MAC-level app and the stack's attach and user-plane runs give the
  same reports, packets and counters in both packages.
- The validators and the sanitizer give the same verdicts and messages on
  the requests of ``tests/test_fapi_validators.py`` and
  ``tests/test_sanitizers.py``, carried over with
  ``convert.from_jax_message``.
- The UE side of ``PhyLoop`` (blind DCI decode, PDSCH decode, CSI SINR,
  the UL grid with PRACH, PUSCH, PUCCH F1 and F2 and the timing ramp) is
  held against the JAX ``PhyLoop`` on the same grids: bits and verdicts
  equal, floats within 1e-4 relative.
- The whole loopback app (52 PRB, 160 slots, 28 dB, 2+2 packets) runs in
  both packages: the reports are equal apart from the wall-clock fields,
  and the uplink indications are equal slot by slot (floats within 1e-4
  relative).  Both packages draw the same AWGN from ``default_rng(1234)``.
  The JAX receiver on the CPU decodes with its XLA decoder; at 28 dB every
  codeblock the UE sends converges, where the two decoders agree.
"""
import dataclasses
import difflib
import json
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srsran_project_23_5_tpu import asn1 as jasn1
from srsran_project_23_5_tpu import f1ap as jf1ap
from srsran_project_23_5_tpu import f1u as jf1u
from srsran_project_23_5_tpu import gtpu as jgtpu
from srsran_project_23_5_tpu import ngap as jngap
from srsran_project_23_5_tpu import rrc as jrrc
from srsran_project_23_5_tpu.apps import gnb as jgnb
from srsran_project_23_5_tpu.apps import phy_loop as jphy_loop
from srsran_project_23_5_tpu.cu_cp import CuCp as JCuCp
from srsran_project_23_5_tpu.cu_up import CuUp as JCuUp
from srsran_project_23_5_tpu.du_high import DuHigh as JDuHigh
from srsran_project_23_5_tpu.fapi import messages as fapi
from srsran_project_23_5_tpu.fapi import validators as jval
from srsran_project_23_5_tpu.gateways import LocalConnector as JLocal
from srsran_project_23_5_tpu.phy.upper.csi_rs import CsiRsConfig
from srsran_project_23_5_tpu.phy.upper.pdcch import PdcchConfig
from srsran_project_23_5_tpu.phy.upper.pucch import (PucchF1Config,
                                                     PucchF2Config)
from srsran_project_23_5_tpu.phy.upper.sch import ShConfig
from srsran_project_23_5_tpu.phy.upper.ssb import SsbConfig
from srsran_project_23_5_tpu.scheduler import CellConfig as JCell
from srsran_project_23_5_tpu.scheduler import config as jcell_cfg
from srsran_project_23_5_tpu.support import sanitizers as jsan
from srsran_project_23_5_tpu.testing import UeEmulator as JUe
from srsran_project_23_5_tpu_torch import (asn1, convert, f1ap, f1u, gtpu,
                                           ngap, rrc)
from srsran_project_23_5_tpu_torch import security
from srsran_project_23_5_tpu_torch.apps import gnb as tgnb
from srsran_project_23_5_tpu_torch.apps import phy_loop as tphy_loop
from srsran_project_23_5_tpu_torch.cu_cp import CuCp
from srsran_project_23_5_tpu_torch.cu_up import CuUp
from srsran_project_23_5_tpu_torch.du_high import DuHigh
from srsran_project_23_5_tpu_torch.fapi import validators as tval
from srsran_project_23_5_tpu_torch.gateways import LocalConnector
from srsran_project_23_5_tpu_torch.phy.upper import sch as tsch
from srsran_project_23_5_tpu_torch.phy.upper import upper_phy as tupper_phy
from srsran_project_23_5_tpu_torch.scheduler import CellConfig
from srsran_project_23_5_tpu_torch.support import sanitizers as tsan
from srsran_project_23_5_tpu_torch.testing import UeEmulator
from srsran_project_23_5_tpu_torch.utils import host_build
from srsran_project_23_5_tpu_torch.utils import native as tnative

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "srsran_project_23_5_tpu"
PORT_PKG = REPO / "srsran_project_23_5_tpu_torch"
REL = 1e-4                      # float tolerance, relative (PERF.md §7)

# ------------------------------------------------------------ copy manifest
COPIES = [
    "apps/__init__.py",
    "support/__init__.py", "support/srslog.py", "support/timers.py",
    "support/executors.py", "support/sanitizers.py", "support/io_broker.py",
    "ran/mcs_tables.py",
    "asn1/__init__.py", "asn1/per.py", "asn1/schema.py",
    "security/__init__.py",
    "rlc/__init__.py", "rlc/pdu.py", "rlc/tm.py", "rlc/um.py", "rlc/am.py",
    "pdcp/__init__.py", "sdap/__init__.py",
    "rrc/__init__.py", "rrc/messages_38331.py",
    "scheduler/__init__.py", "scheduler/config.py", "scheduler/harq.py",
    "scheduler/results.py", "scheduler/ue_context.py",
    "scheduler/pdcch_alloc.py", "scheduler/dci.py",
    "scheduler/cell_scheduler.py",
    "mac/__init__.py", "mac/pdu.py",
    "du_manager/__init__.py", "du_manager/ran_resources.py",
    "f1ap/__init__.py", "f1u/__init__.py", "e1ap/__init__.py",
    "ngap/__init__.py", "gtpu/__init__.py", "e2/__init__.py",
    "pcap/__init__.py", "cu_cp/__init__.py", "cu_up/__init__.py",
    "du_high/__init__.py", "gateways/__init__.py",
    "testing/__init__.py", "testing/ue_emulator.py",
    "utils/native.py",
    "fapi/validators.py", "fapi_adaptor/__init__.py",
]

_NATIVE_BUILD_WHY = (
    "the JAX package builds native/*.cc into native/*.so with g++ writing "
    "the library in place, so a process can load a half-written file; the "
    "port builds the same source into build/native/ under a temporary "
    "name that is renamed into place (utils/host_build)")

_REF_PATH_WHY = ("the original names the reference's checkout by an "
                 "absolute path on one machine; the copy keeps the path "
                 "inside the reference tree, as the rest of the docstring "
                 "does")

# per copy: (text in the original, text in the copy, why)
# (a pattern in place of the text: it is replaced once)
_REF_PATH = re.compile(r"/\w+/reference/(?=lib/asn1/)")
REPLACEMENTS = {
    "asn1/per.py": [(_REF_PATH, "", _REF_PATH_WHY)],
    "asn1/schema.py": [(_REF_PATH, "", _REF_PATH_WHY)],
    "security/__init__.py": [
        ("import os\nimport subprocess\n", "import os\n",
         "subprocess is used by the build, which moved to utils/host_build"),
        ('import numpy as np\n\n_HERE',
         'import numpy as np\n\nfrom ..utils import host_build\n\n_HERE',
         _NATIVE_BUILD_WHY),
        ('_SO = os.path.join(_HERE, "..", "..", "native", "tpuran_crypto.so")'
         '\n_TABLES = os.path.join(_HERE, "..", "data", '
         '"tables_security.npz")\n',
         '_TABLES = os.path.join(_HERE, "..", "..", '
         '"srsran_project_23_5_tpu", "data",\n'
         '                       "tables_security.npz")\n',
         "no library path next to the source; the cipher tables are read "
         "by path from the JAX package's data/, as ops/ldpc/graphs.py "
         "reads the 38.212 tables"),
        ('''    if os.path.exists(_SRC) and (
            not os.path.exists(_SO)
            or os.path.getmtime(_SRC) > os.path.getmtime(_SO)):
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
                 "-o", _SO], check=True, capture_output=True)
        except Exception:
            _lib = False
            return _lib
    try:
        lib = ctypes.CDLL(_SO)
''', '''    so = host_build.build(_SRC)
    if so is None:
        _lib = False
        return _lib
    try:
        lib = ctypes.CDLL(so)
''', _NATIVE_BUILD_WHY),
    ],
    "utils/native.py": [
        ("Builds the shared library on first use (g++ -O3) and caches it "
         "next to the\nsource; every entry point has a numpy fallback so "
         "the package works without\n",
         "Builds the shared library on first use (g++ -O3) into "
         "build/native/;\nevery entry point has a numpy fallback so the "
         "package works without\n",
         "the docstring names where the library is built"),
        ("import os\nimport subprocess\n", "import os\n",
         "subprocess is used by the build, which moved to utils/host_build"),
        ('import numpy as np\n\n_HERE',
         'import numpy as np\n\nfrom . import host_build\n\n_HERE',
         _NATIVE_BUILD_WHY),
        ('_SO = os.path.join(_HERE, "..", "..", "native", "tpuran_host.so")'
         '\n', '', "no library path next to the source"),
        ('''    if not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)):
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
                 "-o", _SO], check=True, capture_output=True)
        except Exception:
            _lib = False
            return _lib
    try:
        lib = ctypes.CDLL(_SO)
''', '''    so = host_build.build(_SRC)
    if so is None:
        _lib = False
        return _lib
    try:
        lib = ctypes.CDLL(so)
''', _NATIVE_BUILD_WHY),
    ],
}


@pytest.mark.parametrize("path", COPIES)
def test_copy_equals_original(path):
    """A held copy equals its original line for line, apart from the
    replacements listed for it."""
    want = (JAX_PKG / path).read_text()
    for old, new, why in REPLACEMENTS.get(path, ()):
        if isinstance(old, re.Pattern):
            want, n = old.subn(new, want)
        else:
            n = want.count(old)
            want = want.replace(old, new)
        assert why and n == 1, (path, old)
    got = (PORT_PKG / path).read_text()
    diff = list(difflib.unified_diff(want.splitlines(), got.splitlines(),
                                     "original+replacements", "copy",
                                     lineterm="", n=1))
    assert not diff, "\n".join(diff[:40])


def test_native_loaders_build_under_build_dir():
    """The port's native loaders build into build/native/, under a name
    that hashes the source, and load from there."""
    so = Path(host_build.build(security._SRC))
    assert so.parent == REPO / "build" / "native" and so.exists()
    assert so.name.startswith("tpuran_crypto-") and so.suffix == ".so"
    assert not hasattr(security, "_SO") and not hasattr(tnative, "_SO")
    assert security.available() and tnative.available()
    # a missing source builds nothing
    assert host_build.build(str(REPO / "native" / "missing.cc")) is None


# ------------------------------------------------------- host stack parity
def _strip_wall(rep: dict) -> dict:
    return {k: v for k, v in rep.items() if k not in ("wall_s", "slots_per_s")}


def _ue_counters(gnb) -> dict:
    return {rnti: (u.dl_nof_ok, u.dl_nof_ko, u.dl_bytes, u.ul_nof_ok,
                   u.ul_nof_ko, u.ul_bytes, u.cqi)
            for rnti, u in gnb.du.mac.scheduler.ues.items()}


def test_mac_level_run_matches_jax():
    """The app with phy: none (test_gnb_app_mac_level_run's scenario): the
    same report, KPM indications and scheduler counters."""
    kw = dict(slots=250, phy="none", ue_dl_packets=4, ue_ul_packets=4)
    jg, tg = jgnb.Gnb(jgnb.GnbConfig(**kw)), tgnb.Gnb(tgnb.GnbConfig(**kw))
    jrep, trep = jg.run(), tg.run()
    assert _strip_wall(trep) == _strip_wall(jrep)
    assert trep["ue_rrc_state"] == rrc.RrcUeState.ACTIVE
    assert trep["ue_dl_rx_packets"] == trep["core_ul_rx_packets"] == 4
    assert tg.ric.indications == jg.ric.indications
    assert _ue_counters(tg) == _ue_counters(jg)


def _build_stack(m):
    """tests/test_gnb_stack.py's co-located gNB, from the modules of one
    package (m.CuCp, m.CuUp, ...)."""
    core_rx = []
    f1_link, e1_link, ng_link = m.Local(), m.Local(), m.Local()
    broker = m.f1u.LocalF1uBroker()
    cu_cp = m.CuCp(amf_send=ng_link.a.send, f1_send=f1_link.a.send,
                   e1_send=e1_link.a.send)
    cu_up = m.CuUp(e1_send=e1_link.b.send, ngu_send=core_rx.append)
    cu_up.create_f1u_bearer = broker.cu_side
    du = m.DuHigh(m.Cell(), f1_send=f1_link.b.send, f1u_broker=broker)
    amf = m.ngap.AmfStub(ng_link.b.send)
    ng_link.b.on_rx = amf.handle_message
    ng_link.a.on_rx = cu_cp.handle_ngap_message
    f1_link.b.on_rx = du.handle_f1_message
    f1_link.a.on_rx = cu_cp.handle_f1_message
    e1_link.b.on_rx = cu_up.handle_e1_message
    e1_link.a.on_rx = cu_cp.handle_e1_message
    cu_cp.start()
    cu_up.e1ap.e1_setup()
    du.start()
    return cu_cp, cu_up, du, amf, core_rx


def _stack_run(m, user_plane: bool) -> dict:
    """test_gnb_stack's attach (and user-plane) run; what it observed."""
    cu_cp, cu_up, du, amf, core_rx = _build_stack(m)
    ue = m.Ue()
    settle = None
    for slot in range(120):
        out = du.run_slot(slot)
        ue.step(du.mac, out, slot)
        if (settle is None and ue.rrc.state == m.rrc.RrcUeState.ACTIVE
                and ue.drb_pdcp):
            settle = slot + 20
        if settle is not None and slot >= settle:
            break
    seen = {"slot": slot, "rnti": ue.rnti, "conres": ue.conres_ok,
            "state": ue.rrc.state, "cipher": ue.rrc.ciphering,
            "integrity": ue.rrc.integrity, "nas": list(ue.rrc.nas_rx),
            "sessions": list(amf.sessions_granted),
            "cu_cp": [c.state for c in cu_cp.ues.values()],
            "cu_up": len(cu_up.ues), "setup": (
                cu_cp.ngap.setup_done, du.f1ap.setup_done,
                cu_cp.f1_setup_done, cu_cp.e1ap.setup_done)}
    if user_plane:
        bearer = next(iter(cu_up.ues.values()))[0]
        dl = [b"dl-ip-%03d" % i * 20 for i in range(5)]
        for pkt in dl:
            cu_up.handle_ngu_pdu(m.gtpu.encode(
                m.gtpu.GtpuHeader(bearer.dl_teid, qfi=9), pkt))
        for i in range(5):
            ue.send_ip_packet(b"ul-ip-%03d" % i * 15)
        for s in range(slot + 1, slot + 200):
            out = du.run_slot(s)
            ue.step(du.mac, out, s)
            if ue.ip_rx == dl and len(core_rx) >= 5:
                break
        seen.update(end=s, ip_rx=list(ue.ip_rx), core_rx=list(core_rx))
    return seen


_JAX_STACK = types.SimpleNamespace(
    CuCp=JCuCp, CuUp=JCuUp, DuHigh=JDuHigh, Cell=JCell, Local=JLocal,
    Ue=JUe, f1u=jf1u, ngap=jngap, rrc=jrrc, gtpu=jgtpu)
_PORT_STACK = types.SimpleNamespace(
    CuCp=CuCp, CuUp=CuUp, DuHigh=DuHigh, Cell=CellConfig,
    Local=LocalConnector, Ue=UeEmulator, f1u=f1u, ngap=ngap, rrc=rrc,
    gtpu=gtpu)


@pytest.mark.parametrize("user_plane", [False, True],
                         ids=["attach", "user_plane"])
def test_stack_runs_match_jax(user_plane):
    """tests/test_gnb_stack.py's attach to RRC ACTIVE and its user-plane
    run: the same slots, states, NAS, sessions and packets (GTP-U wire
    bytes included)."""
    want = _stack_run(_JAX_STACK, user_plane)
    got = _stack_run(_PORT_STACK, user_plane)
    assert got == want
    assert got["state"] == rrc.RrcUeState.ACTIVE
    if user_plane:
        assert len(got["ip_rx"]) == len(got["core_rx"]) == 5


def test_asn1_codec_matches_jax():
    """test_gnb_stack's F1AP message: the same wire bytes, decoded back."""
    def wire(a, f):
        return a.encode(f.UeContextSetupRequest(3, 4, [1], [a.encode(
            f.DrbItem(1, 4, "am", 9))]))
    got, want = wire(asn1, f1ap), wire(jasn1, jf1ap)
    assert got == want
    dec = asn1.decode(got)
    assert (dec.gnb_cu_ue_id, dec.gnb_du_ue_id) == (3, 4)
    assert asn1.decode(dec.drbs_to_setup[0]).lcid == 4


# ------------------------------------------------------------- validators
NOF_PRB = 52


def _sh(**over):
    base = dict(rnti=0x4601, tbs=1024, qm=4, prb_start=0, nof_prb=24,
                first_symbol=0, nof_symbols=14, dmrs_symbols=(2, 7, 11))
    base.update(over)
    return ShConfig(**base)


def _good_dl():
    req = fapi.DlTtiRequest(sfn=10, slot=3)
    req.pdsch_pdus.append(fapi.PdschPdu(_sh()))
    req.pdcch_pdus.append(fapi.PdcchPdu(
        PdcchConfig(rnti=0x4601, payload_size=40), np.zeros(40, np.int8)))
    req.ssb_pdus.append(fapi.SsbPdu(SsbConfig(pci=123),
                                    np.zeros(32, np.int8),
                                    first_subcarrier=6))
    req.csi_rs_pdus.append(fapi.CsiRsPdu(CsiRsConfig(
        row=2, prb_start=0, nof_prb=NOF_PRB, symbol=5)))
    return req


def _good_ul():
    req = fapi.UlTtiRequest(sfn=10, slot=3)
    req.pusch_pdus.append(fapi.PuschPdu(_sh()))
    req.pucch_pdus.append(fapi.PucchPdu(format1=PucchF1Config(prb=50)))
    req.prach_pdus.append(fapi.PrachPdu(root_sequence_index=22, length=139,
                                        zero_correlation_zone=13))
    return req


def _dl(**kw):
    return fapi.DlTtiRequest(10, 3, **kw)


def _ul(**kw):
    return fapi.UlTtiRequest(10, 3, **kw)


def _timing(**mut):
    req = _good_dl()
    for k, v in mut.items():
        setattr(req, k, v)
    return ("dl", req)


# tests/test_fapi_validators.py's cases: (validator, JAX request[, DL_TTI])
_VALIDATOR_CASES = {
    "valid_dl": lambda: ("dl", _good_dl()),
    "valid_ul": lambda: ("ul", _good_ul()),
    "valid_tx": lambda: ("tx", fapi.TxDataRequest(
        10, 3, [np.zeros(1024, np.int8)]), _good_dl()),
    "sfn": lambda: _timing(sfn=1024),
    "slot": lambda: _timing(slot=20),
    **{f"pdsch_{name}": (lambda o=o: ("dl", _dl(
        pdsch_pdus=[fapi.PdschPdu(_sh(**o))])))
       for name, o in [
           ("rnti", dict(rnti=0)), ("qm", dict(qm=5)), ("rv", dict(rv=4)),
           ("layers", dict(nof_layers=3)),
           ("outside", dict(prb_start=40, nof_prb=24)),
           ("symbols", dict(first_symbol=6, nof_symbols=10,
                            dmrs_symbols=(7, 11))),
           ("tbs_neg", dict(tbs=-8)), ("tbs_big", dict(tbs=10 ** 6)),
           ("dmrs", dict(dmrs_symbols=(2, 7, 13), nof_symbols=12))]},
    "pdcch_payload": lambda: ("dl", _dl(pdcch_pdus=[fapi.PdcchPdu(
        PdcchConfig(rnti=1, payload_size=40), np.zeros(39, np.int8))])),
    "pdcch_outside": lambda: ("dl", _dl(pdcch_pdus=[fapi.PdcchPdu(
        PdcchConfig(rnti=1, payload_size=40, aggregation_level=8,
                    cce_index=6), np.zeros(40, np.int8))])),
    "ssb": lambda: ("dl", _dl(ssb_pdus=[fapi.SsbPdu(
        SsbConfig(pci=2000), np.zeros(31, np.int8),
        first_subcarrier=NOF_PRB * 12 - 100)])),
    "csi_rs_row": lambda: ("dl", _dl(csi_rs_pdus=[
        fapi.CsiRsPdu(CsiRsConfig(row=3))])),
    "tx_count": lambda: ("tx", fapi.TxDataRequest(10, 3, []), _good_dl()),
    "tx_size": lambda: ("tx", fapi.TxDataRequest(
        10, 3, [np.zeros(100, np.int8)]), _good_dl()),
    "tx_timing": lambda: ("tx", fapi.TxDataRequest(
        9, 3, [np.zeros(1024, np.int8)]), _good_dl()),
    **{f"pucch_{name}": (lambda p=p: ("ul", _ul(pucch_pdus=[p()])))
       for name, p in [
           ("none", lambda: fapi.PucchPdu()),
           ("f1_prb", lambda: fapi.PucchPdu(format1=PucchF1Config(prb=99))),
           ("f1_len", lambda: fapi.PucchPdu(format1=PucchF1Config(
               prb=1, nof_symbols=2))),
           ("f1_harq", lambda: fapi.PucchPdu(format1=PucchF1Config(
               prb=1, nof_harq_bits=3))),
           ("f1_cs", lambda: fapi.PucchPdu(format1=PucchF1Config(
               prb=1, initial_cyclic_shift=12))),
           ("f2_outside", lambda: fapi.PucchPdu(format2=PucchF2Config(
               prb_start=50, nof_prb=4))),
           ("f2_bits", lambda: fapi.PucchPdu(format2=PucchF2Config(
               prb_start=0, nof_prb=1, nof_uci_bits=12)))]},
    **{f"prach_{name}": (lambda p=p: ("ul", _ul(prach_pdus=[p])))
       for name, p in [
           ("length", fapi.PrachPdu(root_sequence_index=1, length=100)),
           ("root", fapi.PrachPdu(root_sequence_index=839, length=839)),
           ("ncs", fapi.PrachPdu(root_sequence_index=1, length=139,
                                 zero_correlation_zone=200))]},
    "harq_process": lambda: ("ul", _ul(pusch_pdus=[
        fapi.PuschPdu(_sh(), harq_process=16)])),
}


@pytest.mark.parametrize("case", sorted(_VALIDATOR_CASES))
def test_validators_match_jax(case):
    """The port's validators give the JAX validators' error list, string
    for string, on the same request.  A 3-layer PDSCH, which the JAX
    validator flags, cannot be built in the port: its ShConfig refuses
    nof_layers=3 (the port's PHY has no 3-layer path)."""
    kind, req, *dl = _VALIDATOR_CASES[case]()
    if case == "pdsch_layers":
        want = jval.validate_dl_tti(req, NOF_PRB)
        assert any("nof_layers 3" in e for e in want), want
        with pytest.raises(ValueError, match="nof_layers 3"):
            convert._carry(tsch.ShConfig, req.pdsch_pdus[0].config)
        return
    if kind == "dl":
        want = jval.validate_dl_tti(req, NOF_PRB)
        got = tval.validate_dl_tti(convert.from_jax_message(req), NOF_PRB)
    elif kind == "ul":
        want = jval.validate_ul_tti(req, NOF_PRB)
        got = tval.validate_ul_tti(convert.from_jax_message(req), NOF_PRB)
    else:
        want = jval.validate_tx_data(req, dl[0])
        got = tval.validate_tx_data(convert.from_jax_message(req),
                                    convert.from_jax_message(dl[0]))
    assert got == want
    assert bool(want) == (not case.startswith("valid")), want
    with pytest.raises(tval.FapiValidationError) if want else \
            _no_raise():
        tval.validate_or_raise(got, case)


class _no_raise:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# --------------------------------------------------------------- sanitizer
def _pdsch(prb_start, nof_prb, first_symbol=2, nof_symbols=12, layers=1,
           reserved=()):
    return ShConfig(rnti=0x4601, tbs=128, qm=2, prb_start=prb_start,
                    nof_prb=nof_prb, first_symbol=first_symbol,
                    nof_symbols=nof_symbols, nof_layers=layers,
                    reserved_patterns=reserved)


_CSI = CsiRsConfig(row=2, prb_start=0, nof_prb=20, symbol=5)
# tests/test_sanitizers.py's slots: (request, nof_ports)
_SANITIZER_CASES = {
    "disjoint": lambda: (fapi.DlTtiRequest(
        0, 0, pdsch_pdus=[fapi.PdschPdu(_pdsch(0, 20)),
                          fapi.PdschPdu(_pdsch(24, 20, layers=2))],
        pdcch_pdus=[fapi.PdcchPdu(PdcchConfig(
            rnti=0x4601, payload_size=39, cce_index=0), np.zeros(39))],
        csi_rs_pdus=[fapi.CsiRsPdu(CsiRsConfig(
            row=2, prb_start=0, nof_prb=48, symbol=1))]), 2),
    "pdsch_overlap": lambda: (fapi.DlTtiRequest(
        0, 0, pdsch_pdus=[fapi.PdschPdu(_pdsch(0, 20)),
                          fapi.PdschPdu(_pdsch(16, 20))]), 1),
    "csi_rs_collision": lambda: (fapi.DlTtiRequest(
        0, 0, pdsch_pdus=[fapi.PdschPdu(_pdsch(0, 20))],
        csi_rs_pdus=[fapi.CsiRsPdu(_CSI)]), 1),
    "csi_rs_reserved": lambda: (fapi.DlTtiRequest(
        0, 0, pdsch_pdus=[fapi.PdschPdu(_pdsch(0, 20,
                                               reserved=((5, (0,)),)))],
        csi_rs_pdus=[fapi.CsiRsPdu(_CSI)]), 1),
    "ssb_overlap": lambda: (fapi.DlTtiRequest(
        0, 0, pdsch_pdus=[fapi.PdschPdu(_pdsch(0, 21))],
        ssb_pdus=[fapi.SsbPdu(SsbConfig(pci=1), np.zeros(32, np.int8),
                              first_subcarrier=0)]), 1),
}


def _verdict(fn, *args):
    try:
        fn(*args)
    except AssertionError as e:     # GridOverlapError of either package
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(_SANITIZER_CASES))
def test_sanitizer_matches_jax(case):
    """check_dl_slot flags the same RE with the same message in both
    packages, and the port's UpperPhy in sanitize mode refuses the slots
    the sanitizer flags (one tx port: the single-port cases)."""
    req, ports = _SANITIZER_CASES[case]()
    treq = convert.from_jax_message(req)
    want = _verdict(jsan.check_dl_slot, req, ports, NOF_PRB * 12)
    got = _verdict(tsan.check_dl_slot, treq, ports, NOF_PRB * 12)
    assert got == want
    assert (want is None) == (case in ("disjoint", "csi_rs_reserved"))
    if want is not None:
        phy = tupper_phy.UpperPhy(tupper_phy.UpperPhyConfig(
            nof_prb=NOF_PRB, sanitize=True), "cpu")
        with pytest.raises(tsan.GridOverlapError) as err:
            phy.process_dl_slot(treq)
        assert str(err.value) == want[1]


def test_executor_race_detector_copy():
    """The copied ExecutorRaceDetector flags a cross-thread hold."""
    import threading
    det = tsan.ExecutorRaceDetector()
    with det.section("grid0", "dl_assemble"):
        pass
    hold, release = threading.Event(), threading.Event()

    def holder():
        det.enter("grid0", "slow_task")
        hold.set()
        release.wait(5)
        det.leave("grid0")

    t = threading.Thread(target=holder)
    t.start()
    assert hold.wait(5)
    with pytest.raises(tsan.RaceError):
        det.enter("grid0", "intruder")
    release.set()
    t.join(5)
    assert not t.is_alive() and "grid0" in det.races[0]


# ---------------------------------------------------------- the app config
def test_gnb_config_platform():
    """platform is gpu (default) or cpu; anything else is refused, as is
    every field JAX's validator refuses."""
    assert tgnb.GnbConfig().platform == "gpu"
    assert tgnb.GnbConfig.from_dict({"platform": "cpu"}).platform == "cpu"
    for raw in ({"platform": "tpu"}, {"cell": {"pci": 5000}},
                {"cell": {"nof_prb": 5}}, {"phy": "quantum"},
                {"cell": {"tdd": {"period": 5, "nof_dl": 4, "nof_ul": 3}}}):
        with pytest.raises(ValueError):
            tgnb.GnbConfig.from_dict(raw)
    cfg = tgnb.GnbConfig.from_dict({"cell": {"nof_prb": 106, "tdd": {
        "period": 10, "nof_dl": 6, "nof_ul": 3}}})
    jcfg = jgnb.GnbConfig.from_dict({"cell": {"nof_prb": 106, "tdd": {
        "period": 10, "nof_dl": 6, "nof_ul": 3}}})
    assert jcfg.platform == "cpu" and cfg.platform == "gpu"
    assert convert.from_jax_gnb_config(jcfg) == cfg
    assert convert.from_jax_cell(jcfg.cell_config()) == cfg.cell_config()


def test_gnb_main_prints_report(capsys):
    """main() keeps the JAX CLI (plus --platform) and prints its report."""
    assert tgnb.main(["--slots", "120", "--phy", "none",
                      "--platform", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["slots"] == 120 and rep["ng_setup"] and rep["f1_setup"]


# -------------------------------------------------- the loopback app, both
APP = dict(slots=160, phy="loopback", platform="cpu", ue_dl_packets=2,
           ue_ul_packets=2, snr_db=28.0, nof_prb=52)


def _run_app(gnb_mod, capture_dl: bool = False, **over):
    """Run one package's app; record the uplink indications of each slot
    (and, for the JAX app, what the UE side received each DL slot)."""
    g = gnb_mod.Gnb(gnb_mod.GnbConfig(**{**APP, **over}))
    inds, dl = [], []
    handle = g.fapi_to_mac.handle_indications
    g.fapi_to_mac.handle_indications = lambda i: (inds.append(list(i)),
                                                  handle(i))[1]
    if capture_dl:
        phy = g._phy
        process = phy._ue_process_dl

        def keep(rx, dl_req, ue, slot):
            dl.append({"rx": np.array(rx), "req": dl_req, "slot": slot,
                       "rnti": ue.rnti, "prach": phy._prach_sent_slot})
            return process(rx, dl_req, ue, slot)
        phy._ue_process_dl = keep
    rep = g.run()
    return types.SimpleNamespace(gnb=g, rep=rep, inds=inds, dl=dl)


@pytest.fixture(scope="module")
def jax_app():
    return _run_app(jgnb, capture_dl=True)


@pytest.fixture(scope="module")
def port_app():
    return _run_app(tgnb)


def _close(a, b) -> bool:
    return abs(a - b) <= REL * max(abs(b), 1.0)


def _same_indication(got, want) -> bool:
    if type(got).__name__ != type(want).__name__:
        return False
    for k, w in vars(want).items():
        g = getattr(got, k)
        if isinstance(w, float):
            ok = _close(g, w)
        elif k == "preambles":
            ok = len(g) == len(w) and all(
                a[0] == b[0] and _close(a[1], b[1]) and _close(a[2], b[2])
                for a, b in zip(g, w))
        elif isinstance(w, np.ndarray) or w is None:
            ok = (g is None) == (w is None) and (
                w is None or np.array_equal(np.asarray(g), w))
        else:
            ok = g == w
        if not ok:
            return False
    return True


def test_loopback_app_matches_jax(jax_app, port_app):
    """The whole loopback app: the reports equal apart from the wall-clock
    fields (RNTI, RRC state, packets both ways, every phy_stats counter,
    TA), the scheduler's CQI, and the uplink indications slot by slot."""
    jrep, trep = jax_app.rep, port_app.rep
    assert _strip_wall(trep) == _strip_wall(jrep)
    assert trep["ue_rrc_state"] == rrc.RrcUeState.ACTIVE
    assert trep["ue_dl_rx_packets"] == trep["core_ul_rx_packets"] == 2
    st = trep["phy_stats"]
    assert st["prach_tx"] >= 1 and st["rar_decoded"] == 1
    assert st["pucch_ack_tx"] >= 1 and st["csi_f2_tx"] >= 1
    assert st["dl_decoded"] >= 3
    assert _ue_counters(port_app.gnb) == _ue_counters(jax_app.gnb)
    assert port_app.gnb.du.mac.scheduler.ues[trep["ue_rnti"]].cqi > 0
    assert len(port_app.inds) == len(jax_app.inds)
    for slot, (got, want) in enumerate(zip(port_app.inds, jax_app.inds)):
        assert len(got) == len(want), slot
        for g, w in zip(got, want):
            assert _same_indication(g, w), (slot, g, w)
    # the indications carry host numpy, not tensors (the FAPI-to-MAC
    # translator reads them with np.asarray)
    arrays = [v for slot in port_app.inds for i in slot
              for v in vars(i).values() if not isinstance(
                  v, (int, float, bool, str, list, type(None)))]
    assert arrays and all(isinstance(a, np.ndarray) for a in arrays)


def _dl_slots(jax_app, limit=12):
    """Captured DL slots in which the UE decoded something: a DCI for one
    of its RNTIs or a CSI-RS."""
    phy = jax_app.gnb._phy
    out = []
    for d in jax_app.dl:
        rntis = [r for r in (d["rnti"],) if r is not None]
        if (d["rnti"] is None and d["prach"] is not None
                and d["slot"] - d["prach"] <= phy.cell.ra_window_slots):
            rntis.append(1)
        if d["slot"] % phy.cell.sib1_period_slots == 2:
            rntis.append(jphy_loop.SI_RNTI)
        if d["req"].pdsch_pdus or d["req"].csi_rs_pdus:
            out.append((d, rntis))
    return out[:limit]


def test_ue_dl_pieces_match_jax(jax_app):
    """On the JAX app's own received grids: the blind DCI decode (every
    DCI field), the UE PDSCH decode (bits and CRC verdict) and the CSI-RS
    SINR (1e-4 relative) equal the JAX PhyLoop's."""
    jphy = jax_app.gnb._phy
    tphy = tphy_loop.PhyLoop(convert.from_jax_cell(jphy.cell), 28.0,
                             device="cpu")
    decoded = csi = 0
    slots = _dl_slots(jax_app)
    assert slots
    for d, rntis in slots:
        rx, slot = d["rx"], d["slot"]
        trx = torch.from_numpy(rx)
        for rnti in rntis:
            want = jphy._ue_blind_decode_dci(jnp.asarray(rx), rnti, slot)
            got = tphy._ue_blind_decode_dci(trx, rnti, slot)
            assert ({k: vars(v) for k, v in got.items()}
                    == {k: vars(v) for k, v in want.items()}), (slot, rnti)
            for (is_dl, prb), dci in want.items():
                if not is_dl:
                    continue
                jcfg = jphy._ue_sh_config(dci, rnti, slot)
                tcfg = tphy._ue_sh_config(got[(is_dl, prb)], rnti, slot)
                assert tcfg == convert.from_jax_sh(jcfg)
                jbits, jok = jphy_loop._ue_pdsch_rx_fn(jcfg)(
                    jnp.asarray(rx)[None])
                tbits, tok = tphy_loop.ue_pdsch_receive(trx, tcfg)
                assert bool(tok) == bool(jok), (slot, rnti)
                if bool(jok):
                    assert np.array_equal(tbits.numpy(), np.asarray(jbits))
                    decoded += 1
        if jphy._is_csi_slot(slot) and d["req"].csi_rs_pdus:
            cfg = d["req"].csi_rs_pdus[0].config
            want = float(np.asarray(jphy_loop._csi_meas(cfg)(
                jnp.asarray(rx))))
            got = tphy_loop.csi_sinr_db(trx, convert._CONFIGS[
                "CsiRsConfig"](cfg))
            assert abs(got - want) <= REL * abs(want), (got, want)
            csi += 1
    assert decoded >= 3 and csi >= 1, (decoded, csi)


class _StubUe:
    """What PhyLoop._ue_build_ul reads of a UE, fixed."""

    def __init__(self, rrc_ns):
        self.preamble, self.rnti, self.last_cqi = 23, 0x4601, 11
        self.timing_advance_samples = 3.0
        self.rrc = rrc_ns

    def want_prach(self):
        return True

    def _ul_buffer(self):
        return 40

    def build_ul_pdu(self, g):
        return bytes(i % 256 for i in range(g.tbs_bytes))


# the stub UE applies a TA of 3 samples: aligned at 3, a 9-sample ramp at 12
@pytest.mark.parametrize("delay", [3.0, 12.0], ids=["aligned", "ramp"])
def test_ue_ul_grid_matches_jax(delay):
    """The UE's UL grid with PRACH, a PUSCH grant, a HARQ ACK and a NACK on
    PUCCH F1, an SR and CSI on PUCCH F2 (and a timing ramp of 9 samples):
    the same grid within 1e-4 of max|ref|, the same counters."""
    cell = JCell(nof_prb=52)
    rrc_ns = types.SimpleNamespace(pucch_cfg=(
        {"period_slots": 1, "offset": 0, "prb": 50, "cs": 3},
        {"period_slots": 1, "offset": 0, "prb": 49, "nof_prb": 1}))
    slot = 7
    req = fapi.UlTtiRequest(0, slot, prach_pdus=[fapi.PrachPdu(
        root_sequence_index=cell.prach_root_sequence, length=139,
        zero_correlation_zone=cell.prach_zero_correlation_zone,
        sc_start=cell.prach_prb_start * 12,
        nof_preambles=cell.prach_nof_preambles)])
    tbs_bytes = jcell_cfg.ul_tbs_bytes(cell, 9, 8)[0]
    grids = []
    for pkg, cell_ in ((jphy_loop, cell), (tphy_loop,
                                           convert.from_jax_cell(cell))):
        kw = {} if pkg is jphy_loop else {"device": "cpu"}
        phy = pkg.PhyLoop(cell_, 28.0, ue_delay_samples=delay, **kw)
        phy._ue_ul_grants[slot] = [pkg._UeUlGrant(0x4601, 2, 10, 8, 9, 0,
                                                  tbs_bytes)]
        phy._ue_acks[slot] = [(0, True), (1, False), (2, True)]
        grid, prach_now = phy._ue_build_ul(
            req if pkg is jphy_loop else convert.from_jax_message(req),
            _StubUe(rrc_ns), slot)
        grids.append((np.asarray(grid), prach_now, dict(phy.stats)))
    (want, jp, jst), (got, tp, tst) = grids
    assert jp and tp and tst == jst
    assert jst["prach_tx"] == jst["sr_tx"] == jst["csi_f2_tx"] == 1
    assert jst["pucch_ack_tx"] == 2
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= REL, err


def test_port_ta_closed_loop():
    """The timing-advance loop at 52 PRB, FDD (the JAX slow test
    test_gnb_app_ta_closed_loop, on the port only): a 12-sample UE timing
    error is measured by the PRACH detector and closed by TA commands."""
    r = _run_app(tgnb, slots=200, ue_delay_samples=12.0)
    assert r.rep["ue_rrc_state"] == rrc.RrcUeState.ACTIVE
    assert abs(r.rep["ue_ta_samples"] - 12.0) <= 2.5, r.rep
    assert r.rep["phy_stats"]["rar_decoded"] == 1
