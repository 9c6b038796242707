"""What may not be loaded in a benchmark process: JAX, its libraries and the
JAX package, compared by whole top-level module name (the port's name
begins with the JAX package's, so a prefix match would be wrong)."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "srsran_project_23_5_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """Sorted top-level names of loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & FORBIDDEN)
