"""Captured programs: a function of tensors run as one CUDA graph replay.

The port's counterpart of ``jax.jit`` on the production paths (the upper
PHY's slot programs, the UE modem of the app).  A ``Program`` holds static
input buffers; every call copies the caller's tensors into them with
``copy_`` (always, even when the caller passes the same tensor again, so a
tensor changed in place is seen) and then:

- on CUDA, the first call runs the function once eagerly on a side stream (kernel builds, the per-config tables on the device,
  cuFFT plans, cuBLAS workspaces), captures it into one
  ``torch.cuda.CUDAGraph`` and replays it; every later call is one replay.
  A capture that fails raises: nothing falls back to eager;
- on the CPU, the same function runs eagerly on the same static buffers,
  the first call counted as the pool's capture, each later one as a
  replay.

Everything the function reads that changes from call to call must be one
of its input tensors: a Python value it reads is fixed at capture.

A call is two spans of ``utils/tracing``: ``graphs.copy_in``, then
``graphs.replay``, or ``graphs.capture`` for the call that captures (on the
CPU, the first call).

All programs of one owner share one ``GraphPool``: one memory pool
(``torch.cuda.graph_pool_handle()``), so memory does not grow with the
number of programs, and the counters.  Programs replay in any order, so
the pool is shared safely only because an output is valid until the next
replay of ANY program of the pool: a caller consumes each output, or
copies it out, before it calls the next program.

The kernel wrappers count launches in Python (``<wrapper>.launches``)
and register themselves in ``KERNELS`` where they are defined; a replay
launches no Python, so each replay adds the launches its capture saw
(``captured_launches``, by kernel name, over the wrappers registered at
capture).  The eager warm-up's launches are real launches and stay
counted.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from .device import resolve as resolve_device
from .tracing import tracer

#: the kernel wrappers whose ``launches`` count a replay adds to, by name;
#: each wrapper's module adds it
KERNELS: dict[str, Callable] = {}


def _flatten(tree, leaves: list) -> object:
    """The tree's shape, with each tensor replaced by its leaf index."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    if isinstance(tree, dict):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if tree is None:
        return None
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"a program input is a tensor, not {type(tree)}")
    leaves.append(tree)
    return len(leaves) - 1


def _rebuild(shape, leaves: list):
    if isinstance(shape, (tuple, list)):
        return type(shape)(_rebuild(v, leaves) for v in shape)
    if isinstance(shape, dict):
        return {k: _rebuild(v, leaves) for k, v in shape.items()}
    return None if shape is None else leaves[shape]


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launch count, by name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def set_launch_counts(counts: dict[str, int] | None = None) -> None:
    """Set every wrapper's launch count to ``counts[name]`` (0 without
    `counts`)."""
    for name, fn in KERNELS.items():
        fn.launches = counts.get(name, 0) if counts else 0


def add_launches(counts: dict[str, int]) -> None:
    """Add what a replay launched (``counts[name]`` per kernel)."""
    for name, n in counts.items():
        KERNELS[name].launches += n


class GraphPool:
    """The memory pool and counters shared by the programs of one owner."""

    def __init__(self, device: torch.device | str) -> None:
        self.device = resolve_device(device)
        self.handle = (torch.cuda.graph_pool_handle()
                       if self.device.type == "cuda" else None)
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0
        self._cached: dict = {}

    def program(self, fn: Callable) -> "Program":
        return Program(fn, self)

    def cached(self, key, build: Callable[[], Callable]) -> "Program":
        """The program of `key` (a static config), made from ``build()`` at
        its first use."""
        prog = self._cached.get(key)
        if prog is None:
            prog = self._cached[key] = Program(build(), self)
        return prog

    def reserved_bytes(self) -> int:
        """Device memory the pool's segments hold (0 on the CPU)."""
        if self.handle is None:
            return 0
        pool = tuple(self.handle)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)


class Program:
    """``fn(*inputs)`` (inputs: tensors, or tuples, lists and dicts of
    them, of the same shapes on every call) on static buffers: one CUDA
    graph on the card, eager on the CPU.  Make one with
    ``GraphPool.program``.  ``inputs`` are the static buffers (the last
    call's values), ``out`` the graph's outputs."""

    def __init__(self, fn: Callable, pool: GraphPool) -> None:
        self.fn = fn
        self.pool = pool
        self._shape = None
        self._leaves: list[torch.Tensor] = []
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None
        self.captured_launches = dict.fromkeys(KERNELS, 0)

    @property
    def inputs(self) -> tuple:
        return _rebuild(self._shape, self._leaves)

    def __call__(self, *inputs):
        first = self._shape is None
        with tracer.span("graphs.copy_in", "graphs"):
            self._copy_in(inputs)
        cuda = self.pool.device.type == "cuda"
        # on the CPU the eager run on the static buffers stands for the
        # replay, and the first one, which fills the per-config caches, for
        # the capture
        capture = self.graph is None if cuda else first
        with tracer.span("graphs.capture" if capture else "graphs.replay",
                         "graphs"):
            if not cuda:
                self.pool.captures += capture
                self.pool.replays += not capture
                return self.fn(*self.inputs)
            if capture:
                self._capture()
            return self._replay()

    def _copy_in(self, inputs: tuple) -> None:
        """The inputs into the static buffers (made from the first call's
        inputs)."""
        leaves: list[torch.Tensor] = []
        shape = _flatten(inputs, leaves)
        if self._shape is None:
            for t in leaves:
                if t.device != self.pool.device:
                    raise ValueError(f"program input on {t.device}, its "
                                     f"pool on {self.pool.device}")
            self._shape, self._leaves = shape, [t.clone() for t in leaves]
        elif shape != self._shape or any(
                a.shape != b.shape or a.dtype != b.dtype
                for a, b in zip(leaves, self._leaves)):
            raise ValueError("a program's inputs keep their structure, "
                             "shapes and dtypes from call to call")
        else:
            for dst, src in zip(self._leaves, leaves):
                dst.copy_(src)

    def eager(self, *inputs):
        """``fn`` run eagerly on ``inputs`` themselves (no static buffer, no
        graph): what a replay is held against."""
        return self.fn(*inputs)

    def _capture(self) -> None:
        """The eager warm-up on a side stream, then the capture of ``fn``
        on the static buffers into the pool.  A capture that fails
        raises."""
        dev = self.pool.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn(*self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool.handle):
                out = self.fn(*self.inputs)
        finally:
            # capture launches nothing: the counts grow on each replay
            after = launch_counts()
            set_launch_counts(before)
        self.captured_launches = {k: n - before.get(k, 0)
                                  for k, n in after.items()}
        self.graph, self.out = graph, out
        self.pool.captures += 1
        self.pool.capture_seconds += time.perf_counter() - t0

    def _replay(self):
        self.graph.replay()
        add_launches(self.captured_launches)
        self.pool.replays += 1
        return self.out
