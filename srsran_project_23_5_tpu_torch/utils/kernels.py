"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for sm_90a into one shared library
with a plain C interface, loaded with ``ctypes``.  The library is built at
first use into ``build/kernels/`` at the repository root and named by a hash
of the sources and flags, so a stale library is never loaded.  Nothing is
compiled or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# -fmad=false: the decoder's msg = scale·|m| followed by t + msg must round
# twice, as the plain version does (the kernels also use __fmul_rn/__fadd_rn).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point → argument types (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "ldpc_encode": (_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "ldpc_decode": (_P, ctypes.c_longlong, _I, _P, _P, _I, _P, _P, _I, _I,
                    _I, _I, _I, _I, _I, _I, ctypes.c_float, _P, _P),
    "ldpc_decode_ctas_per_sm": (_I, _I, _I, _P),
    "pusch_llr": (_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I,
                  _I, _P, ctypes.c_float, ctypes.c_float, _P),
    "pusch_llr_chunks": (ctypes.c_longlong, _I, _I),
    "channel_mix": (_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                    ctypes.c_longlong, _I, _P),
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """The loaded library, with how long its build took in this process."""
    lib: ctypes.CDLL
    path: Path
    build_seconds: float      # 0.0 when an up-to-date library was found
    build_log: str            # nvcc/ptxas output of the build that made it


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libtpu_ran_torch_{source_hash()}.so"
    log_path = path.with_suffix(".log")
    seconds = 0.0
    if path.exists():
        log = log_path.read_text() if log_path.exists() else ""
    else:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in _sources())]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, path)   # atomic: a concurrent build never loads half
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpu_ran_cuda_error_string.argtypes = (_I,)
    lib.tpu_ran_cuda_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib=lib, path=path, build_seconds=seconds,
                         build_log=log)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        text = library().lib.tpu_ran_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")
