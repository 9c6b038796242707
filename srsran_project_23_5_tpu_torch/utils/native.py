"""ctypes bindings to the native host runtime library (native/tpuran_host.cc).

Builds the shared library on first use (g++ -O3) into build/native/;
every entry point has a numpy fallback so the package works without
a toolchain.  Covers the host-side runtime duties the reference implements
in C++ (bit packing, CRC LUTs, Gold sequences, slot ticking) — the TPU owns
the compute path.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from . import host_build

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "..", "native", "tpuran_host.cc")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = host_build.build(_SRC)
    if so is None:
        _lib = False
        return _lib
    try:
        lib = ctypes.CDLL(so)
        lib.tpuran_pack_bits.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.tpuran_unpack_bits.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.tpuran_crc.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_uint32, ctypes.c_int]
        lib.tpuran_crc.restype = ctypes.c_uint32
        lib.tpuran_gold_sequence.argtypes = [
            ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.tpuran_wait_tick.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64]
        lib.tpuran_wait_tick.restype = ctypes.c_int64
        lib.tpuran_now_ns.restype = ctypes.c_int64
        _lib = lib
    except Exception:
        _lib = False
    return _lib


def available() -> bool:
    return bool(_load())


def pack_bits(bits: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    lib = _load()
    if not lib:
        return np.packbits(bits)
    out = np.empty((len(bits) + 7) // 8, dtype=np.uint8)
    lib.tpuran_pack_bits(bits.ctypes.data, out.ctypes.data, len(bits))
    return out


def unpack_bits(data: np.ndarray, nof_bits: int) -> np.ndarray:
    data = np.ascontiguousarray(data, dtype=np.uint8)
    lib = _load()
    if not lib:
        return np.unpackbits(data)[:nof_bits]
    out = np.empty(nof_bits, dtype=np.uint8)
    lib.tpuran_unpack_bits(data.ctypes.data, out.ctypes.data, nof_bits)
    return out


def crc(bits: np.ndarray, poly: int, width: int) -> int:
    """CRC of unpacked bits (MSB-first semantics)."""
    lib = _load()
    packed = np.packbits(np.ascontiguousarray(bits, dtype=np.uint8))
    if not lib:
        from ..ops import crc as crc_jnp
        name = {(24, 0x864CFB): "crc24A", (24, 0x800063): "crc24B",
                (24, 0xB2B117): "crc24C", (16, 0x1021): "crc16",
                (11, 0x621): "crc11", (6, 0x21): "crc6"}[(width, poly)]
        out_bits = crc_jnp.crc_np(np.asarray(bits), name)
        return int("".join(map(str, out_bits)), 2)
    return int(lib.tpuran_crc(packed.ctypes.data, len(bits), poly, width))


def gold_sequence(cinit: int, length: int, offset: int = 0) -> np.ndarray:
    lib = _load()
    if not lib:
        from ..ops import gold as gold_jnp
        return gold_jnp.gold_sequence_np(cinit, length, offset)
    out = np.empty(length, dtype=np.uint8)
    lib.tpuran_gold_sequence(cinit, offset, length, out.ctypes.data)
    return out


class SlotTicker:
    """Precise periodic slot clock (realtime_timing_worker analogue)."""

    def __init__(self, period_ns: int) -> None:
        self._lib = _load()
        self.period_ns = period_ns
        self._origin = (self._lib.tpuran_now_ns() if self._lib
                        else _py_now_ns())
        self.tick = -1

    def wait_next(self) -> int:
        if self._lib:
            self.tick = self._lib.tpuran_wait_tick(
                self._origin, self.period_ns, self.tick)
        else:
            import time
            due = self._origin + (self.tick + 1) * self.period_ns
            now = _py_now_ns()
            if due > now:
                time.sleep((due - now) / 1e9)
                self.tick += 1
            else:
                self.tick = (now - self._origin) // self.period_ns
        return self.tick


def _py_now_ns() -> int:
    import time
    return time.perf_counter_ns()
