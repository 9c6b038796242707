"""Build the native host libraries for the port's copies of ``security`` and
``utils.native``.

The C++ sources are the repository's ``native/*.cc``, which the JAX package
builds next to themselves.  The port builds them with g++ into
``build/native/`` at the repository root instead, each library named by a
hash of its source and flags, so it never writes ``native/*.so`` and never
loads a library older than its source.  A build writes a temporary file and
renames it into place, so a process that loads the library (a test worker
beside another) never sees half a file.  Nothing is built at import time.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build(src: str) -> str | None:
    """Path of the shared library built from `src` (built now if missing),
    or None if the source is missing or g++ fails."""
    src_path = Path(src)
    if not src_path.exists():
        return None
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src_path.read_bytes())
    so = BUILD_DIR / f"{src_path.stem}-{h.hexdigest()[:16]}.so"
    if so.exists():
        return str(so)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(src_path), "-o", str(tmp)],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return str(so)
