"""Declarative ASN.1 types encoded with X.691 PER (`asn1.per`).

Each type implements `encode(w, value)` / `decode(r)` against a
BitWriter/BitReader in either variant.  Supported: BOOLEAN, INTEGER
(constrained / semi-constrained / unconstrained, extensible),
ENUMERATED (extensible), BIT STRING, OCTET STRING, UTF8String/
PrintableString, SEQUENCE (OPTIONAL/DEFAULT preamble, extension
additions), SEQUENCE OF, CHOICE (extensible, open-type alternatives)
and OpenType — the working subset of what the reference's generated
codecs use (lib/asn1/asn1_utils.h: integer/enum/choice
packers, seq-of packers, bitstring packers).

Values are plain Python: dicts for SEQUENCE, (name, value) tuples for
CHOICE, str for ENUMERATED alternatives, bytes for OCTET STRING,
(value:int, length:int) for BIT STRING.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence as Seq

from .per import BitReader, BitWriter, PerError


class Type:
    def encode(self, w: BitWriter, v: Any) -> None:
        raise NotImplementedError

    def decode(self, r: BitReader) -> Any:
        raise NotImplementedError

    # top-level helpers
    def to_bytes(self, v: Any, aligned: bool) -> bytes:
        w = BitWriter(aligned)
        self.encode(w, v)
        return w.to_bytes()

    def from_bytes(self, data: bytes, aligned: bool) -> Any:
        return self.decode(BitReader(data, aligned))


class Boolean(Type):
    def encode(self, w, v):
        w.put_bit(1 if v else 0)

    def decode(self, r):
        return bool(r.get_bit())


class Integer(Type):
    def __init__(self, lb: int | None = None, ub: int | None = None,
                 ext: bool = False) -> None:
        self.lb, self.ub, self.ext = lb, ub, ext

    def encode(self, w, v):
        if self.ext:
            in_root = (self.lb is None or v >= self.lb) and \
                      (self.ub is None or v <= self.ub)
            w.put_bit(0 if in_root else 1)
            if not in_root:
                w.unconstrained(v)
                return
        if self.lb is not None and self.ub is not None:
            w.constrained_whole(v, self.lb, self.ub)
        elif self.lb is not None:
            w.semi_constrained(v, self.lb)
        else:
            w.unconstrained(v)

    def decode(self, r):
        if self.ext and r.get_bit():
            return r.unconstrained()
        if self.lb is not None and self.ub is not None:
            return r.constrained_whole(self.lb, self.ub)
        if self.lb is not None:
            return r.semi_constrained(self.lb)
        return r.unconstrained()


class Enumerated(Type):
    def __init__(self, names: Seq[str], ext: bool = False) -> None:
        self.names = list(names)
        self.ext = ext

    def encode(self, w, v):
        i = self.names.index(v)
        if self.ext:
            w.put_bit(0)
        w.constrained_whole(i, 0, len(self.names) - 1)

    def decode(self, r):
        if self.ext and r.get_bit():
            i = r.normally_small()
            return f"_ext_{i}"           # unknown extension value
        return self.names[r.constrained_whole(0, len(self.names) - 1)]


class BitString(Type):
    """Value is (int_value, nof_bits); MSB of int = first bit."""

    def __init__(self, lb: int = 0, ub: int | None = None) -> None:
        self.lb, self.ub = lb, ub

    def encode(self, w, v):
        val, n = v
        fixed = self.ub is not None and self.lb == self.ub
        if fixed and n != self.lb:
            raise PerError(f"bit string must be {self.lb} bits, got {n}")
        if not fixed:
            w.length_det(n, self.lb, self.ub if self.ub is not None
                         and self.ub < 65536 else None)
        if n == 0:
            return
        if w.aligned and n > 16:
            w.align()
        w.put_bits(val, n)

    def decode(self, r):
        fixed = self.ub is not None and self.lb == self.ub
        n = self.lb if fixed else r.length_det(
            self.lb, self.ub if self.ub is not None and self.ub < 65536
            else None)
        if n == 0:
            return (0, 0)
        if r.aligned and n > 16:
            r.align()
        return (r.get_bits(n), n)


class OctetString(Type):
    def __init__(self, lb: int = 0, ub: int | None = None) -> None:
        self.lb, self.ub = lb, ub

    def encode(self, w, v):
        v = bytes(v)
        fixed = self.ub is not None and self.lb == self.ub
        if fixed and len(v) != self.lb:
            raise PerError(f"octet string must be {self.lb} octets")
        if not fixed:
            if len(v) >= 16384 and (self.ub is None or self.ub >= 65536):
                for start, count, _last in w.fragments(len(v)):
                    if count:
                        w.align()
                        w.put_bytes(v[start:start + count])
                return
            w.length_det(len(v), self.lb,
                         self.ub if self.ub is not None and self.ub < 65536
                         else None)
        if len(v) == 0:
            return
        if w.aligned and (not fixed or len(v) > 2):
            w.align()
        w.put_bytes(v)

    def decode(self, r):
        fixed = self.ub is not None and self.lb == self.ub
        if fixed:
            n = self.lb
            if n == 0:
                return b""
            if r.aligned and n > 2:
                r.align()
            return r.get_bytes(n)
        if self.ub is not None and self.ub < 65536:
            n = r.length_det(self.lb, self.ub)
            if n == 0:
                return b""
            if r.aligned:
                r.align()
            return r.get_bytes(n)
        return r.read_fragmented_bytes()


class Utf8String(Type):
    """UTF8String — general length determinant in octets (X.691 §27)."""

    def encode(self, w, v):
        OctetString().encode(w, v.encode())

    def decode(self, r):
        return OctetString().decode(r).decode()


@dataclasses.dataclass
class Field:
    name: str
    type: Type
    optional: bool = False
    default: Any = None

    @property
    def has_default(self) -> bool:
        return self.default is not None


class Sequence(Type):
    """Value is a dict {field_name: value}; absent OPTIONALs omitted."""

    def __init__(self, fields: Seq[Field], ext: bool = False,
                 ext_fields: Seq[Field] = ()) -> None:
        self.fields = list(fields)
        self.ext = ext
        self.ext_fields = list(ext_fields)

    def encode(self, w, v: dict):
        ext_present = [f for f in self.ext_fields if f.name in v]
        if self.ext:
            w.put_bit(1 if ext_present else 0)
        elif ext_present:
            raise PerError("extension additions on a non-extensible SEQUENCE")
        for f in self.fields:
            if f.optional or f.has_default:
                present = f.name in v and (
                    not f.has_default or v[f.name] != f.default)
                w.put_bit(1 if present else 0)
        for f in self.fields:
            if (f.optional or f.has_default):
                if f.name not in v or (f.has_default
                                       and v[f.name] == f.default):
                    continue
            elif f.name not in v:
                raise PerError(f"missing mandatory field {f.name}")
            f.type.encode(w, v[f.name])
        if ext_present:
            # §18.8: normally-small count then presence bitmap, then each
            # addition as an open type
            n = len(self.ext_fields)
            w.normally_small(n - 1)
            for f in self.ext_fields:
                w.put_bit(1 if f.name in v else 0)
            for f in self.ext_fields:
                if f.name in v:
                    inner = BitWriter(w.aligned)
                    f.type.encode(inner, v[f.name])
                    w.open_type(inner)

    def decode(self, r) -> dict:
        has_ext = bool(self.ext and r.get_bit())
        present: dict[str, bool] = {}
        for f in self.fields:
            if f.optional or f.has_default:
                present[f.name] = bool(r.get_bit())
        out: dict[str, Any] = {}
        for f in self.fields:
            if f.optional or f.has_default:
                if not present[f.name]:
                    if f.has_default:
                        out[f.name] = f.default
                    continue
            out[f.name] = f.type.decode(r)
        if has_ext:
            n = r.normally_small() + 1
            bitmap = [r.get_bit() for _ in range(n)]
            for i, bit in enumerate(bitmap):
                if not bit:
                    continue
                blob = r.open_type()
                if i < len(self.ext_fields):
                    f = self.ext_fields[i]
                    out[f.name] = f.type.from_bytes(blob, r.aligned)
                # unknown additions are skipped (X.691 §18.9 note)
        return out


class SequenceOf(Type):
    def __init__(self, elem: Type, lb: int = 0,
                 ub: int | None = None) -> None:
        self.elem, self.lb, self.ub = elem, lb, ub

    def encode(self, w, v):
        w.length_det(len(v), self.lb,
                     self.ub if self.ub is not None and self.ub < 65536
                     else None)
        for item in v:
            self.elem.encode(w, item)

    def decode(self, r):
        n = r.length_det(self.lb,
                         self.ub if self.ub is not None
                         and self.ub < 65536 else None)
        return [self.elem.decode(r) for _ in range(n)]


class Choice(Type):
    """Value is (alternative_name, value)."""

    def __init__(self, alts: Seq[tuple[str, Type]], ext: bool = False,
                 ext_alts: Seq[tuple[str, Type]] = ()) -> None:
        self.alts = list(alts)
        self.ext = ext
        self.ext_alts = list(ext_alts)

    def encode(self, w, v):
        name, val = v
        root = [n for n, _ in self.alts]
        if name in root:
            if self.ext:
                w.put_bit(0)
            i = root.index(name)
            if len(root) > 1:
                w.constrained_whole(i, 0, len(root) - 1)
            self.alts[i][1].encode(w, val)
            return
        extn = [n for n, _ in self.ext_alts]
        if name not in extn:
            raise PerError(f"unknown CHOICE alternative {name}")
        w.put_bit(1)
        i = extn.index(name)
        w.normally_small(i)
        inner = BitWriter(w.aligned)
        self.ext_alts[i][1].encode(inner, val)
        w.open_type(inner)

    def decode(self, r):
        if self.ext and r.get_bit():
            i = r.normally_small()
            blob = r.open_type()
            if i < len(self.ext_alts):
                name, t = self.ext_alts[i]
                return (name, t.from_bytes(blob, r.aligned))
            return (f"_ext_{i}", blob)
        i = r.constrained_whole(0, len(self.alts) - 1) if len(
            self.alts) > 1 else 0
        name, t = self.alts[i]
        return (name, t.decode(r))


class OpenType(Type):
    """Contents as opaque octets wrapped with a general length (§10.2) —
    the IE-container value field of the RAN application protocols."""

    def __init__(self, inner: Type | None = None) -> None:
        self.inner = inner

    def encode(self, w, v):
        if self.inner is not None and not isinstance(v, (bytes, bytearray)):
            iw = BitWriter(w.aligned)
            self.inner.encode(iw, v)
            w.open_type(iw)
            return
        w.length_det(len(v))
        w.align()
        w.put_bytes(bytes(v))

    def decode(self, r):
        blob = r.open_type()
        if self.inner is not None:
            return self.inner.from_bytes(blob, r.aligned)
        return blob
