"""Taps and launch counts of the LDPC kernels, for runs that hold every
launch against its plain version.

``tapped_kernels`` swaps the kernel wrappers' modules inside ``sch`` (the
one caller of both wrappers on the slot paths) and ``slot_programs`` (the
upper PHY's grouped PUSCH decode) for stand-ins that keep a copy of each
call's tensors, and ``mismatches`` holds each against the plain version.
``launch_counts`` reads the wrappers' counters, which count kernel
launches only (a CPU tensor runs the plain version).
"""
from __future__ import annotations

import contextlib
import types

import torch

from ..ops.ldpc import decoder_cuda, encoder_cuda
from ..phy.upper import sch, slot_programs


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


@contextlib.contextmanager
def tapped_kernels():
    """Every LDPC kernel call inside the block is recorded in the yielded
    sink: {"fn", "x", "args", "kw", "out"} per call."""
    sink = types.SimpleNamespace(graph=[], eager=[])
    saved = sch.encoder_cuda, sch.decoder_cuda, slot_programs.decoder_cuda
    sch.encoder_cuda = _ModuleTap(encoder_cuda, "encode", sink)
    sch.decoder_cuda = _ModuleTap(decoder_cuda, "decode", sink)
    slot_programs.decoder_cuda = _ModuleTap(decoder_cuda, "decode", sink)
    try:
        yield sink
    finally:
        (sch.encoder_cuda, sch.decoder_cuda,
         slot_programs.decoder_cuda) = saved


def launch_counts() -> dict[str, int]:
    return {"encoder": encoder_cuda.encode.launches,
            "decoder": decoder_cuda.decode.launches}


def reset_launch_counts() -> None:
    encoder_cuda.encode.launches = 0
    decoder_cuda.decode.launches = 0


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
