"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point runs on: the current CUDA device unless the
    caller names another (``"cpu"`` runs the plain versions, as the tests
    do).  Without CUDA the default raises; it never falls back to the
    CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run its plain versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
