"""5G NR security: ciphering & integrity (NEA/NIA) + key derivation.

TPU-native-framework equivalent of the reference's lib/security
(security.cpp, s3g.cpp, zuc.cpp): the cipher cores run in the native host
library (native/tpuran_crypto.cc) since they are bit-serial host-side work
on L2 PDUs (never on the TPU compute path); key derivation (TS 33.501
Annex A) uses HMAC-SHA-256 from the standard library.

Algorithms (TS 33.501 §5.11.1):
  NEA0/NIA0  null
  NEA1/NIA1  SNOW 3G (UEA2/UIA2)
  NEA2/NIA2  AES-128 CTR / CMAC
  NEA3/NIA3  ZUC (EEA3/EIA3)
"""
from __future__ import annotations

import ctypes
import enum
import hashlib
import hmac
import os

import numpy as np

from ..utils import host_build

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "..", "native", "tpuran_crypto.cc")
_TABLES = os.path.join(_HERE, "..", "..", "srsran_project_23_5_tpu", "data",
                       "tables_security.npz")

_lib = None


class SecurityDirection(enum.IntEnum):
    UPLINK = 0
    DOWNLINK = 1


class CipheringAlgorithm(enum.IntEnum):
    NEA0 = 0
    NEA1 = 1
    NEA2 = 2
    NEA3 = 3


class IntegrityAlgorithm(enum.IntEnum):
    NIA0 = 0
    NIA1 = 1
    NIA2 = 2
    NIA3 = 3


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
        u8p, u32, i64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int64
        lib.tpuran_crypto_init.argtypes = [u8p, u8p, u8p, u8p]
        lib.tpuran_crypto_ready.restype = ctypes.c_int
        for name in ("tpuran_nea1", "tpuran_nea2", "tpuran_nea3"):
            getattr(lib, name).argtypes = [u8p, u32, u32, u32, u8p, i64]
        for name in ("tpuran_nia1", "tpuran_nia2", "tpuran_nia3"):
            fn = getattr(lib, name)
            fn.argtypes = [u8p, u32, u32, u32, u8p, i64]
            fn.restype = u32
        lib.tpuran_aes128_encrypt.argtypes = [u8p, u8p, u8p]
        t = np.load(_TABLES)
        sq = np.ascontiguousarray(t["snow3g_sq"], dtype=np.uint8)
        s0 = np.ascontiguousarray(t["zuc_s0"], dtype=np.uint8)
        s1 = np.ascontiguousarray(t["zuc_s1"], dtype=np.uint8)
        ek = np.ascontiguousarray(t["zuc_ek_d"], dtype=np.uint32)
        lib.tpuran_crypto_init(sq.ctypes.data, s0.ctypes.data,
                               s1.ctypes.data, ek.ctypes.data)
        # keep table arrays alive for the lifetime of the lib
        lib._tables = (sq, s0, s1, ek)
        _lib = lib
    except Exception:
        _lib = False
    return _lib


def available() -> bool:
    return bool(_load())


def _check_key(key: bytes) -> bytes:
    key = bytes(key)
    if len(key) != 16:
        raise ValueError("128-bit key required")
    return key


def _run_cipher(fname: str, key: bytes, count: int, bearer: int,
                direction: int, data: bytes, length_bits: int) -> bytes:
    lib = _load()
    if not lib:
        raise RuntimeError("native crypto library unavailable")
    buf = np.frombuffer(bytes(data), dtype=np.uint8).copy()
    need = (length_bits + 7) // 8
    if len(buf) < need:
        raise ValueError("data shorter than length_bits")
    getattr(lib, fname)(
        np.frombuffer(_check_key(key), dtype=np.uint8).ctypes.data,
        count & 0xFFFFFFFF, bearer & 0x1F, direction & 1,
        buf.ctypes.data, length_bits)
    return buf.tobytes()


def _run_mac(fname: str, key: bytes, count: int, bearer: int,
             direction: int, data: bytes, length_bits: int) -> bytes:
    lib = _load()
    if not lib:
        raise RuntimeError("native crypto library unavailable")
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    mac = getattr(lib, fname)(
        np.frombuffer(_check_key(key), dtype=np.uint8).ctypes.data,
        count & 0xFFFFFFFF, bearer & 0x1F, direction & 1,
        buf.ctypes.data, length_bits)
    return int(mac).to_bytes(4, "big")


def _bitlen(data: bytes, length_bits: int | None) -> int:
    return 8 * len(data) if length_bits is None else length_bits


# ------------------------------------------------------------- public API
def nea1(key, count, bearer, direction, data, length_bits=None) -> bytes:
    return _run_cipher("tpuran_nea1", key, count, bearer, direction, data,
                       _bitlen(data, length_bits))


def nea2(key, count, bearer, direction, data, length_bits=None) -> bytes:
    return _run_cipher("tpuran_nea2", key, count, bearer, direction, data,
                       _bitlen(data, length_bits))


def nea3(key, count, bearer, direction, data, length_bits=None) -> bytes:
    return _run_cipher("tpuran_nea3", key, count, bearer, direction, data,
                       _bitlen(data, length_bits))


def nia1(key, count, bearer, direction, data, length_bits=None) -> bytes:
    return _run_mac("tpuran_nia1", key, count, bearer, direction, data,
                    _bitlen(data, length_bits))


def nia2(key, count, bearer, direction, data, length_bits=None) -> bytes:
    return _run_mac("tpuran_nia2", key, count, bearer, direction, data,
                    _bitlen(data, length_bits))


def nia3(key, count, bearer, direction, data, length_bits=None) -> bytes:
    return _run_mac("tpuran_nia3", key, count, bearer, direction, data,
                    _bitlen(data, length_bits))


_CIPHERS = {CipheringAlgorithm.NEA1: nea1, CipheringAlgorithm.NEA2: nea2,
            CipheringAlgorithm.NEA3: nea3}
_MACS = {IntegrityAlgorithm.NIA1: nia1, IntegrityAlgorithm.NIA2: nia2,
         IntegrityAlgorithm.NIA3: nia3}


def cipher(algo: CipheringAlgorithm, key, count, bearer, direction,
           data: bytes) -> bytes:
    """Apply (or remove — it is an XOR stream) NR ciphering."""
    if algo == CipheringAlgorithm.NEA0:
        return bytes(data)
    return _CIPHERS[CipheringAlgorithm(algo)](key, count, bearer, direction,
                                              data)


def integrity_mac(algo: IntegrityAlgorithm, key, count, bearer, direction,
                  data: bytes) -> bytes:
    """Compute the 32-bit MAC-I."""
    if algo == IntegrityAlgorithm.NIA0:
        return b"\x00" * 4
    return _MACS[IntegrityAlgorithm(algo)](key, count, bearer, direction,
                                           data)


def aes128_encrypt_block(key: bytes, block: bytes) -> bytes:
    lib = _load()
    if not lib:
        raise RuntimeError("native crypto library unavailable")
    out = np.zeros(16, dtype=np.uint8)
    lib.tpuran_aes128_encrypt(
        np.frombuffer(_check_key(key), dtype=np.uint8).ctypes.data,
        np.frombuffer(bytes(block), dtype=np.uint8).ctypes.data,
        out.ctypes.data)
    return out.tobytes()


# --------------------------------------------------- key derivation (KDF)
def kdf(key: bytes, fc: int, *params: bytes) -> bytes:
    """Generic TS 33.220 B.2 KDF: HMAC-SHA-256(key, FC||P0||L0||...)."""
    s = bytes([fc])
    for p in params:
        s += p + len(p).to_bytes(2, "big")
    return hmac.new(key, s, hashlib.sha256).digest()


def truncate_key(k256: bytes) -> bytes:
    """128 LSB of a 256-bit derived key (TS 33.501 A.13)."""
    return k256[16:]


_ALGO_TYPE = {"nas_enc": 0x01, "nas_int": 0x02, "rrc_enc": 0x03,
              "rrc_int": 0x04, "up_enc": 0x05, "up_int": 0x06}


def derive_algorithm_key(k_gnb: bytes, usage: str, algo_id: int) -> bytes:
    """TS 33.501 A.8: K_RRCenc / K_RRCint / K_UPenc / K_UPint from K_gNB."""
    k = kdf(k_gnb, 0x69, bytes([_ALGO_TYPE[usage]]), bytes([algo_id]))
    return truncate_key(k)


def derive_k_gnb(k_amf: bytes, nas_ul_count: int) -> bytes:
    """TS 33.501 A.9: K_gNB from K_AMF and uplink NAS COUNT."""
    return kdf(k_amf, 0x6E, nas_ul_count.to_bytes(4, "big"), bytes([0x01]))


class SecurityContext:
    """Per-UE AS security context (reference: security_context in
    include/srsran/security/security.h): holds K_gNB, selected algorithms,
    and the derived RRC/UP keys."""

    def __init__(self, k_gnb: bytes,
                 ciphering: CipheringAlgorithm = CipheringAlgorithm.NEA2,
                 integrity: IntegrityAlgorithm = IntegrityAlgorithm.NIA2):
        self.k_gnb = k_gnb
        self.ciphering = CipheringAlgorithm(ciphering)
        self.integrity = IntegrityAlgorithm(integrity)
        self.k_rrc_enc = derive_algorithm_key(k_gnb, "rrc_enc",
                                              int(self.ciphering))
        self.k_rrc_int = derive_algorithm_key(k_gnb, "rrc_int",
                                              int(self.integrity))
        self.k_up_enc = derive_algorithm_key(k_gnb, "up_enc",
                                             int(self.ciphering))
        self.k_up_int = derive_algorithm_key(k_gnb, "up_int",
                                             int(self.integrity))
