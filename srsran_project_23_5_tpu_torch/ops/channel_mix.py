"""The mixed slot's flat channel: a 2×2 port mix plus single-port streams.

``channel_mix(h, g, vecs, xs)`` is, for each batch row b and output port p,

    out[b, p, ...] = Σ_q h[p, q]·g[b, q, ...] + Σ_i vecs[i][p]·xs[i][b, ...]

over a two-port signal g [B, 2, ...] and 0, 1 or 2 single-port streams x_i
[B, ...] with their columns v_i [2]: the DL port mix of the mixed slot, and
its UL mix of the 2-port PUSCH with the 1-port PUSCH and PUCCH/PRACH.  On a
CUDA tensor it is one hand-written kernel, ``csrc/channel_mix.cu``, that
reads each input once in its own layout and writes a contiguous
[B, 2, ...] result; ``channel_mix_plain`` is the same function in plain
PyTorch (an einsum, then a broadcast product and an add per stream), which
the wrapper takes only for a CPU tensor.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from ..utils import graphs, kernels
from ..utils.tracing import tracer


def vecmix(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, 2, ...] = v[2] ⊗ x[B, ...]: one complex product."""
    return v.reshape(1, 2, *(1,) * (x.dim() - 1)) * x[:, None]


def channel_mix_plain(h: torch.Tensor, g: torch.Tensor,
                      vecs: Sequence[torch.Tensor] = (),
                      xs: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """h[2, 2] @ g[B, 2, ...] plus ``vecmix(vecs[i], xs[i])`` for each
    stream, added in order."""
    out = torch.einsum("pq,bq...->bp...", h, g)
    for v, x in zip(vecs, xs):
        out = out + vecmix(v, x)
    return out


def _check(h: torch.Tensor, g: torch.Tensor, vecs: Sequence[torch.Tensor],
           xs: Sequence[torch.Tensor]) -> None:
    """Raises where the inputs do not fit one mix."""
    if len(vecs) != len(xs) or len(xs) > 2:
        raise ValueError(f"0, 1 or 2 streams, each with its column: got "
                         f"{len(vecs)} columns for {len(xs)} streams")
    if h.shape != (2, 2) or g.dim() < 2 or g.shape[1] != 2:
        raise ValueError(f"h is [2, 2] and g [B, 2, ...], got "
                         f"{tuple(h.shape)} and {tuple(g.shape)}")
    for v, x in zip(vecs, xs):
        if v.shape != (2,) or x.shape != (g.shape[0], *g.shape[2:]):
            raise ValueError(f"a stream's column is [2] and the stream "
                             f"[B, ...] of g {tuple(g.shape)}, got "
                             f"{tuple(v.shape)} and {tuple(x.shape)}")


def _flat(t: torch.Tensor) -> torch.Tensor:
    """A plain contiguous copy of `t` where it is a conjugate or negative
    view or not contiguous; `t` itself otherwise."""
    return t.resolve_conj().resolve_neg().contiguous()


def _launch(h: torch.Tensor, g: torch.Tensor, vecs: Sequence[torch.Tensor],
            xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """One kernel launch over the batch (none for an empty one)."""
    ins = (h, g, *vecs, *xs)
    if any(t.dtype != torch.complex64 for t in ins):
        raise ValueError(f"channel_mix takes complex64, got "
                         f"{[t.dtype for t in ins]}")
    if any(t.device != g.device for t in ins):
        raise ValueError(f"channel_mix inputs on {[t.device for t in ins]}")
    out = torch.empty(g.shape, dtype=torch.complex64, device=g.device)
    if out.numel() == 0:
        return out
    h, g = _flat(h), _flat(g)
    vecs, xs = [_flat(v) for v in vecs], [_flat(x) for x in xs]
    ptr = [t.data_ptr() for t in xs] + [None] * (2 - len(xs))
    vptr = [t.data_ptr() for t in vecs] + [None] * (2 - len(vecs))
    err = kernels.library().lib.channel_mix(
        g.data_ptr(), ptr[0], ptr[1], out.data_ptr(), h.data_ptr(), vptr[0],
        vptr[1], g.shape[0], math.prod(g.shape[2:]), len(xs),
        torch.cuda.current_stream(g.device).cuda_stream)
    kernels.check(err, "channel_mix launch")
    return out


def channel_mix(h: torch.Tensor, g: torch.Tensor,
                vecs: Sequence[torch.Tensor] = (),
                xs: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """The channel mix [B, 2, ...] (``channel_mix_plain``): the CUDA kernel
    for a CUDA tensor, within a few float32 roundings of the plain
    expression there (cuBLAS sums the einsum its own way); the plain
    expression for a CPU tensor.  ``channel_mix.launches`` counts kernel
    launches; the tracer counts ``mixed.mix_kernel``, or
    ``mixed.mix_plain``, per call."""
    _check(h, g, vecs, xs)
    if g.device.type == "cpu":
        tracer.add("mixed.mix_plain")
        return channel_mix_plain(h, g, vecs, xs)
    if g.device.type != "cuda":
        raise ValueError(f"no channel mix kernel for device {g.device}")
    tracer.add("mixed.mix_kernel")
    out = _launch(h, g, vecs, xs)
    if out.numel():
        channel_mix.launches += 1
    return out


channel_mix.launches = 0
graphs.KERNELS["channel_mix"] = channel_mix
