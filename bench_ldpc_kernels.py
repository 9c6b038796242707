#!/usr/bin/env python3
"""Time the port's two LDPC CUDA kernels at the main path's shapes on one
NVIDIA GPU: device time (CUDA events, launches queued back to back), the
bound (``chip_smoke.encoder_bound`` / ``decoder_bound``) and the share of
it, the decoder's CTAs per SM and its phase split; every launch is first
held bit-exact against the plain version.

With ``--parent DIR`` it also builds the kernels of another ``csrc/``
(the interface of commit 463f939: ``ldpc_encode`` over row/col/shift arrays,
``ldpc_decode`` with a c2v scratch argument), e.g. an older commit's
unpacked into the gitignored ``build/``, and times both on the same inputs
in turns: parent, current, current, parent.

    git archive 463f939 srsran_project_23_5_tpu_torch/csrc | tar -x -C build/parent
    python3 bench_ldpc_kernels.py --parent build/parent/srsran_project_23_5_tpu_torch/csrc

Prints one line per shape and writes ``ldpc_kernel_bench.json`` into
``--out`` (default: the gitignored ``build/``).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from srsran_project_23_5_tpu_torch.models import gnb_mixed
from srsran_project_23_5_tpu_torch.ops.ldpc import (decoder_cuda,
                                                    encoder_cuda, graphs,
                                                    segmentation)
from srsran_project_23_5_tpu_torch.ops.ldpc.encoder import _core_p0_shift
from srsran_project_23_5_tpu_torch.utils import kernels

REPO = Path(__file__).resolve().parent
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SMEM_LIMIT = 232_448


class Parent:
    """An older kernel library with the C interface of commit 463f939."""

    def __init__(self, csrc: Path):
        out = REPO / "build" / "parent"
        out.mkdir(parents=True, exist_ok=True)
        srcs = sorted(csrc.glob("*.cu"))
        tag = hashlib.sha256(b"".join(s.read_bytes() for s in srcs))
        lib = out / f"libparent_{tag.hexdigest()[:12]}.so"
        if not lib.exists():
            subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                            str(lib), *map(str, srcs)], check=True,
                           capture_output=True, timeout=900)
        self.lib = ctypes.CDLL(str(lib))
        self.lib.ldpc_encode.argtypes = (_P, _P, _I, _P, _P, _P) + (_I,) * 8 \
            + (_P,)
        self.lib.ldpc_decode.argtypes = (
            (_P, ctypes.c_longlong, _P, _P, _I, _P, _P, _P) + (_I,) * 8
            + (ctypes.c_float, _P, _P))

    @functools.lru_cache(maxsize=None)
    def _arrays(self, dev, *rows):
        return [torch.from_numpy(np.asarray(a, np.int32)).to(dev)
                for a in rows]

    def encode(self, msg, bg, zc):
        g = graphs.lifted_graph(bg, zc)
        k, n = g.nof_msg_blocks, g.nof_var_blocks
        row_off = np.concatenate([[0], np.cumsum([len(c) for c in g.row_cols])])
        arrs = self._arrays(msg.device, tuple(row_off),
                            tuple(np.concatenate(g.row_cols)),
                            tuple(np.concatenate(g.row_shifts)))
        s_new = [dict(zip(g.row_cols[r], g.row_shifts[r]))[k + 1 + r]
                 for r in range(3)]
        out = torch.empty((msg.shape[0], n * zc), dtype=torch.int8,
                          device=msg.device)
        kernels.check(self.lib.ldpc_encode(
            msg.data_ptr(), out.data_ptr(), msg.shape[0],
            *(a.data_ptr() for a in arrs), zc, k, g.nof_check_blocks, n,
            _core_p0_shift(g), *s_new,
            torch.cuda.current_stream().cuda_stream), "parent encode")
        return out, arrs

    def decode(self, llr, bg, zc, nof_used_blocks=None):
        g, n, layers, n_edges = decoder_cuda._schedule(bg, zc,
                                                       nof_used_blocks)
        k = g.nof_msg_blocks
        off = [e0 for e0, _, _ in layers] + [n_edges]
        arrs = self._arrays(llr.device, tuple(off),
                            tuple(np.concatenate([c for _, c, _ in layers])),
                            tuple(np.concatenate([s for _, _, s in layers])))
        d_max = max(len(c) for _, c, _ in layers)
        batch = llr.shape[0]
        bits = torch.empty((batch, k * zc), dtype=torch.int8,
                           device=llr.device)
        ok = torch.empty((batch,), dtype=torch.bool, device=llr.device)
        glob = 2 * (n + n_edges) * zc > PARENT_SMEM_LIMIT
        c2v = (torch.empty((batch, n_edges * zc), dtype=torch.bfloat16,
                           device=llr.device) if glob else None)
        kernels.check(self.lib.ldpc_decode(
            llr.data_ptr(), llr.stride(0), bits.data_ptr(), ok.data_ptr(),
            batch, *(a.data_ptr() for a in arrs), len(layers), zc, n, k,
            n_edges, d_max, 6, 1, decoder_cuda.SCALE,
            None if c2v is None else c2v.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "parent decode")
        return bits, ok, arrs, c2v


def _inputs(dev):
    """(encoder cases, decoder cases): the mixed slot's own payloads and
    LLRs at 20 dB, 8 slots; synthetic BPSK inputs at the other main-path
    shapes."""
    cfg = gnb_mixed.default_mixed()
    pay = gnb_mixed.make_payloads(cfg, np.random.default_rng(6), 8, dev)
    front = gnb_mixed._mixed_front(
        pay, *gnb_mixed.draw_noise(cfg, 8,
                                   torch.Generator(device=dev).manual_seed(6)),
        cfg)
    enc, dec = [], []
    for key, sh in (("tb_dl0", cfg.pdsch0), ("tb_dl1", cfg.pdsch1),
                    ("tb_ul0", cfg.pusch0), ("tb_ul1", cfg.pusch1)):
        seg = sh.segments
        cbs = segmentation.segment_tx(pay[key], seg).reshape(
            -1, seg.segment_length).contiguous()
        enc.append((f"mixed {key}", seg.base_graph, seg.lifting_size, cbs))
    for name, sh in (("u0", cfg.pusch0), ("u1", cfg.pusch1)):
        seg = sh.segments
        bg, zc = seg.base_graph, seg.lifting_size
        llr = front[name].llr_full.reshape(
            -1, front[name].llr_full.shape[-1]).contiguous()
        dec.append((f"mixed {name} 20 dB", bg, zc, llr,
                    decoder_cuda.used_blocks(bg, zc, max(sh.cb_lengths))))
    gen = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.default_rng(9)
    for bg, zc, batch in ((2, 384, 88), (1, 384, 8), (1, 384, 7)):
        k = graphs.lifted_graph(bg, zc).nof_msg_blocks * zc
        enc.append((f"BG{bg} Z={zc} x{batch}", bg, zc,
                    torch.randint(0, 2, (batch, k), generator=gen, device=dev,
                                  dtype=torch.int8)))
    for label, bg, zc, batch, snr, n_used in (
            ("flagship 2 dB", 2, 384, 88, 2.0, 52),
            ("UpperPhy PUSCH A 6 dB", 1, 384, 34, 6.0, 35),
            ("UpperPhy PUSCH B 6 dB", 1, 384, 8, 6.0, 33),
            ("full graph 1.5 dB", 1, 384, 8, 1.5, None),
            ("full graph 3 dB", 1, 384, 8, 3.0, None),
            ("full BG2 graph 1.5 dB", 2, 384, 8, 1.5, None)):
        k = graphs.lifted_graph(bg, zc).nof_msg_blocks * zc
        msg = torch.randint(0, 2, (batch, k), generator=gen, device=dev,
                            dtype=torch.int8)
        llr = cs._noisy_llr(rng, encoder_cuda.encode_plain(msg, bg, zc), snr,
                            zc, dev)
        if n_used is not None:
            llr[:, n_used * zc:] = 0.0
        dec.append((label, bg, zc, llr, n_used))
    return enc, dec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a csrc/ directory with the kernel interface of "
                    "commit 463f939")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", type=Path, default=REPO / "build",
                    help="directory for ldpc_kernel_bench.json")
    args = ap.parse_args()
    dev, card = cs.phase_device()
    cs.phase_build(card)
    parent = Parent(args.parent) if args.parent else None
    enc, dec = _inputs(dev)
    rows = []

    def turns(new, old):
        """Times in turns parent, current, current, parent (ms)."""
        if old is None:
            return [cs._time_ms(new, args.reps, queued=True)] * 2, None
        o1 = cs._time_ms(old, args.reps, queued=True)
        n1 = cs._time_ms(new, args.reps, queued=True)
        n2 = cs._time_ms(new, args.reps, queued=True)
        o2 = cs._time_ms(old, args.reps, queued=True)
        return [n1, n2], [o1, o2]

    for label, bg, zc, msg in enc:
        want = encoder_cuda.encode_plain(msg, bg, zc)
        cs._check(torch.equal(encoder_cuda._launch(msg, bg, zc), want),
                  f"encoder != plain at {label}")
        old = None
        if parent:
            cs._check(torch.equal(parent.encode(msg, bg, zc)[0], want),
                      f"parent encoder != plain at {label}")
            old = lambda: parent.encode(msg, bg, zc)
        new_ms, old_ms = turns(lambda: encoder_cuda._launch(msg, bg, zc), old)
        bound, by = cs.encoder_bound(bg, zc, msg.shape[0])
        rows.append({"kernel": "encoder", "shape": f"{label} BG{bg} Z={zc} "
                     f"x{msg.shape[0]}", "ms": new_ms, "parent_ms": old_ms,
                     "bound_ms": bound, "bound_by": by,
                     "share": bound / min(new_ms)})
    for label, bg, zc, llr, n_used in dec:
        want = decoder_cuda.decode_plain(llr, bg, zc, nof_used_blocks=n_used)
        got = decoder_cuda._launch(llr, bg, zc, 6, 1, n_used)
        cs._check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"decoder != plain at {label}")
        old = None
        if parent:
            cs._check(all(torch.equal(a, b) for a, b in zip(
                parent.decode(llr, bg, zc, n_used)[:2], want)),
                f"parent decoder != plain at {label}")
            old = lambda: parent.decode(llr, bg, zc, n_used)
        new_ms, old_ms = turns(
            lambda: decoder_cuda._launch(llr, bg, zc, 6, 1, n_used), old)
        bound, by, sweeps = cs.decoder_bound(llr, bg, zc,
                                             nof_used_blocks=n_used)
        rows.append({
            "kernel": "decoder", "shape": f"{label} BG{bg} Z={zc} "
            f"x{llr.shape[0]} n_used {n_used}", "ms": new_ms,
            "parent_ms": old_ms, "bound_ms": bound, "bound_by": by,
            "share": bound / min(new_ms),
            "sweeps": [int(sweeps.min()), int(sweeps.max())],
            "ctas_per_sm": decoder_cuda.ctas_per_sm(bg, zc, n_used),
            "split": cs._phase_split(label, llr, bg, zc, n_used)})
    for r in rows:
        old = (f", parent kernel {r['parent_ms'][0] * 1e3:.1f} / "
               f"{r['parent_ms'][1] * 1e3:.1f} us" if r["parent_ms"] else "")
        extra = (f"; sweeps {r['sweeps'][0]}-{r['sweeps'][1]}, "
                 f"{r['ctas_per_sm']} CTAs/SM; {r['split']}"
                 if r["kernel"] == "decoder" else "")
        print(f"[bench] {r['kernel']} {r['shape']}: {r['ms'][0] * 1e3:.1f} / "
              f"{r['ms'][1] * 1e3:.1f} us{old}; bound {r['bound_ms'] * 1e3:.2f}"
              f" us ({r['bound_by']}), share {100 * r['share']:.1f}%{extra} "
              f"on {card}", flush=True)
    out = args.out
    out.mkdir(parents=True, exist_ok=True)
    (out / "ldpc_kernel_bench.json").write_text(json.dumps(
        {"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
