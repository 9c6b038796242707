"""Taps and launch counts of the LDPC kernels, for runs that hold every
launch against its plain version.

``tapped_kernels`` swaps the kernel wrappers' modules inside ``sch`` (the
one caller of both wrappers on the slot paths) and ``slot_programs`` (the
upper PHY's grouped PUSCH decode) for stand-ins that keep a copy of each
call's tensors, and ``mismatches`` holds each against the plain version.
A captured program (``utils/graphs.py``: the upper PHY's slot programs,
the UE modem, the mesh step, ``SlotPipeline``'s scan step) launches no
Python when it replays: the copies its capture recorded are refreshed by
each replay and copied out right after it, so every launch of the block is
in ``sink.eager``.
``launch_counts`` reads the counters of every counted kernel wrapper
(``graphs.KERNELS``: the two LDPC kernels, which are tapped, and the
PUSCH LLR stage and the mixed slot's channel mix, which are not), which
count kernel launches only (a CPU tensor runs the plain version).
"""
from __future__ import annotations

import contextlib
import types

import torch

from ..ops.ldpc import decoder_cuda, encoder_cuda
from ..phy.upper import sch, slot_programs
from . import graphs


class _ModuleTap:
    """Stands in for a kernel wrapper's module: its kernel function keeps a
    copy of each call's tensors, in ``sink.graph`` while a CUDA graph is
    being captured (the copies are captured too, so after each replay they
    hold what that replay's kernel took and gave), else in ``sink.eager``.
    Every other name is the module's own."""

    def __init__(self, module, fn_name: str, sink) -> None:
        self._module = module
        fn = getattr(module, fn_name)

        def call(x, *args, **kw):
            out = fn(x, *args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            capturing = (torch.cuda.is_available()
                         and torch.cuda.is_current_stream_capturing())
            (sink.graph if capturing else sink.eager).append({
                "fn": fn_name, "x": x.clone(), "args": args, "kw": kw,
                "out": [o.clone() for o in outs]})
            return out
        setattr(self, fn_name, call)

    def __getattr__(self, name: str):
        return getattr(self._module, name)


def _copy(call: dict) -> dict:
    return {**call, "x": call["x"].clone(),
            "out": [o.clone() for o in call["out"]]}


@contextlib.contextmanager
def tapped_kernels():
    """Every LDPC kernel launch inside the block is recorded in the yielded
    sink's ``sink.eager``: {"fn", "x", "args", "kw", "out"} per launch,
    eager or of a replay of a program captured inside the block (a call
    made while a graph is captured is kept in ``sink.graph``, for the
    replays to copy out)."""
    sink = types.SimpleNamespace(graph=[], eager=[])
    saved = sch.encoder_cuda, sch.decoder_cuda, slot_programs.decoder_cuda
    capture, replay = graphs.Program._capture, graphs.Program._replay
    spans: dict[int, tuple[int, int]] = {}

    def tapped_capture(prog):
        n0 = len(sink.graph)
        capture(prog)
        spans[id(prog)] = (n0, len(sink.graph))

    def tapped_replay(prog):
        # the graph shares its pool: its copies are read before the next
        # replay of any program can overwrite them
        out = replay(prog)
        a, b = spans.get(id(prog), (0, 0))
        sink.eager.extend(_copy(c) for c in sink.graph[a:b])
        return out

    sch.encoder_cuda = _ModuleTap(encoder_cuda, "encode", sink)
    sch.decoder_cuda = _ModuleTap(decoder_cuda, "decode", sink)
    slot_programs.decoder_cuda = _ModuleTap(decoder_cuda, "decode", sink)
    graphs.Program._capture = tapped_capture
    graphs.Program._replay = tapped_replay
    try:
        yield sink
    finally:
        (sch.encoder_cuda, sch.decoder_cuda,
         slot_programs.decoder_cuda) = saved
        graphs.Program._capture, graphs.Program._replay = capture, replay


launch_counts = graphs.launch_counts


def reset_launch_counts(counts: dict[str, int] | None = None) -> None:
    """Every counter to 0, or to what `counts` (``launch_counts()``)
    held."""
    graphs.set_launch_counts(counts)


def tapped_launches(counts: dict[str, int]) -> int:
    """The launches of `counts` that ``tapped_kernels`` records."""
    return counts["encoder"] + counts["decoder"]


_PLAIN = {"encode": encoder_cuda.encode_plain,
          "decode": decoder_cuda.decode_plain}


def mismatches(calls: list[dict]) -> list[int]:
    """The indices of the tapped calls whose outputs differ, in any bit,
    from the plain version's on the same inputs (on their device)."""
    bad = []
    for i, c in enumerate(calls):
        want = _PLAIN[c["fn"]](c["x"], *c["args"], **c["kw"])
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(o, w) for o, w in zip(c["out"], want)):
            bad.append(i)
    return bad
