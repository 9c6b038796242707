"""The reference's working precision.

The reference hands float32 from stage to stage, as the configuration
states, and computes its receive stages in float64.  Inside ``bfloat16()``
it rounds what each stage hands on (the transmitted baseband, the received
grid and PRACH window, the equalised symbols and their noise variances, the
soft bits, the DL grid) to bfloat16: the control of the benchmark's
comparison, the chain one precision below what the configuration states.
"""
from __future__ import annotations

import contextlib

import torch

_LOWER = {"on": False}


@contextlib.contextmanager
def bfloat16():
    """Round every stage's output to bfloat16 inside the block."""
    _LOWER["on"] = True
    try:
        yield
    finally:
        _LOWER["on"] = False


def _round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def q(x: torch.Tensor) -> torch.Tensor:
    """x, or x rounded to bfloat16 (real and imaginary parts apart) inside
    ``bfloat16()``."""
    if not _LOWER["on"] or not x.is_floating_point() and not x.is_complex():
        return x
    if x.is_complex():
        return torch.complex(_round(x.real), _round(x.imag))
    return _round(x)
