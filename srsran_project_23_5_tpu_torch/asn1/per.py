"""X.691 Packed Encoding Rules — bit-level engine (aligned + unaligned).

This is a real PER runtime (ITU-T X.691, the encoding 3GPP uses for its
RAN application protocols: BASIC-PER UNALIGNED for RRC, ALIGNED for
NGAP/F1AP/E1AP), replacing the round-1..4 TLV stand-in.  The schema
layer on top is `asn1.schema`; hand-written 3GPP message schemas live
with each protocol package.

Reference counterpart: the 480k-line generated codecs under
lib/asn1/{rrc_nr,ngap,f1ap,e1ap}.cpp all bottom out in
the primitives implemented here (srsasn bitref pack/unpack,
lib/asn1/asn1_utils.cpp: pack_constrained_whole_number,
pack_length, aligned padding) — re-implemented from X.691 clause by
clause, not translated.

Clauses implemented: 10.3 (non-negative-binary-integer), 10.5
(constrained whole number), 10.6 (normally small non-negative), 10.7
(semi-constrained), 10.8 (unconstrained), 10.9 (length determinants,
incl. 16K fragmentation on the general form), 10.2 (open type).
"""
from __future__ import annotations

_16K = 16384


class PerError(ValueError):
    pass


class BitWriter:
    def __init__(self, aligned: bool) -> None:
        self.aligned = aligned
        self._bits: bytearray = bytearray()   # one entry per bit (0/1)

    # -- raw bits ------------------------------------------------------
    def put_bit(self, b: int) -> None:
        self._bits.append(1 if b else 0)

    def put_bits(self, value: int, n: int) -> None:
        """n-bit non-negative binary integer, MSB first (X.691 §10.3)."""
        if n < 0 or (n and value >> n):
            raise PerError(f"value {value} does not fit in {n} bits")
        for i in range(n - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def put_bytes(self, data: bytes) -> None:
        for byte in data:
            self.put_bits(byte, 8)

    def align(self) -> None:
        """Pad to an octet boundary (aligned variant only)."""
        if self.aligned:
            while len(self._bits) % 8:
                self._bits.append(0)

    def to_bytes(self) -> bytes:
        out = bytearray()
        bits = self._bits
        for i in range(0, len(bits), 8):
            chunk = bits[i:i + 8]
            v = 0
            for b in chunk:
                v = (v << 1) | b
            v <<= 8 - len(chunk)
            out.append(v)
        return bytes(out) if out else b"\0"  # empty encoding = one zero octet

    @property
    def nof_bits(self) -> int:
        return len(self._bits)

    # -- whole numbers -------------------------------------------------
    def constrained_whole(self, value: int, lb: int, ub: int) -> None:
        """X.691 §10.5 constrained whole number in [lb, ub]."""
        if not lb <= value <= ub:
            raise PerError(f"{value} outside [{lb}, {ub}]")
        rng = ub - lb + 1
        v = value - lb
        if rng == 1:
            return
        if not self.aligned:
            self.put_bits(v, (rng - 1).bit_length())
            return
        if rng <= 255:
            self.put_bits(v, (rng - 1).bit_length())   # bit-field, no align
        elif rng == 256:
            self.align()
            self.put_bits(v, 8)
        elif rng <= 65536:
            self.align()
            self.put_bits(v, 16)
        else:
            n = max((v.bit_length() + 7) // 8, 1)
            max_n = ((ub - lb).bit_length() + 7) // 8
            self.constrained_whole(n, 1, max_n)
            self.align()
            self.put_bits(v, 8 * n)

    def normally_small(self, value: int) -> None:
        """X.691 §10.6 normally small non-negative whole number."""
        if value < 0:
            raise PerError("negative")
        if value <= 63:
            self.put_bit(0)
            self.put_bits(value, 6)
        else:
            self.put_bit(1)
            self.semi_constrained(value, 0)

    def semi_constrained(self, value: int, lb: int) -> None:
        """X.691 §10.7: offset as minimal octets with a length prefix."""
        v = value - lb
        if v < 0:
            raise PerError(f"{value} below lower bound {lb}")
        raw = v.to_bytes(max((v.bit_length() + 7) // 8, 1), "big")
        self.length_det(len(raw))
        self.align()
        self.put_bytes(raw)

    def unconstrained(self, value: int) -> None:
        """X.691 §10.8: 2's-complement minimal octets + length prefix."""
        n = max((value.bit_length() + 8) // 8, 1)   # +1 sign bit
        raw = value.to_bytes(n, "big", signed=True)
        self.length_det(len(raw))
        self.align()
        self.put_bytes(raw)

    # -- length determinants -------------------------------------------
    def length_det(self, n: int, lb: int = 0, ub: int | None = None) -> None:
        """X.691 §10.9 length determinant.

        Constrained (ub is not None and ub < 64K): constrained whole
        number.  Otherwise the general form (§10.9.3.6-8): one octet to
        127, two octets to 16383; counts >=16K must use `fragments()`.
        """
        if ub is not None and ub < 65536:
            self.constrained_whole(n, lb, ub)
            return
        self.align()
        if n <= 127:
            self.put_bits(n, 8)
        elif n < _16K:
            self.put_bits(0b10, 2)
            self.put_bits(n, 14)
        else:
            raise PerError("use fragments() for counts >= 16K")

    def fragments(self, total: int):
        """Yield (start, count, is_last) general-form fragments (§10.9.3.8):
        emits each fragment's length determinant; caller emits the items."""
        start = 0
        while True:
            rem = total - start
            if rem >= _16K:
                m = min(rem // _16K, 4)
                self.align()
                self.put_bits(0b11, 2)
                self.put_bits(m, 6)       # 16K multiplier 1..4
                yield start, m * _16K, False
                start += m * _16K
                if start == total:        # must end with a short fragment
                    self.length_det(0)
                    yield start, 0, True
                    return
            else:
                self.length_det(rem)
                yield start, rem, True
                return

    # -- open type (§10.2) ---------------------------------------------
    def open_type(self, inner: "BitWriter") -> None:
        blob = inner.to_bytes()
        self.length_det(len(blob))
        self.align()
        self.put_bytes(blob)


class BitReader:
    def __init__(self, data: bytes, aligned: bool) -> None:
        self.data = data
        self.aligned = aligned
        self.pos = 0                      # bit position

    def get_bit(self) -> int:
        byte = self.data[self.pos >> 3]
        b = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def get_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get_bit()
        return v

    def get_bytes(self, n: int) -> bytes:
        return bytes(self.get_bits(8) for _ in range(n))

    def align(self) -> None:
        if self.aligned:
            self.pos = (self.pos + 7) & ~7

    def constrained_whole(self, lb: int, ub: int) -> int:
        rng = ub - lb + 1
        if rng == 1:
            return lb
        if not self.aligned:
            return lb + self.get_bits((rng - 1).bit_length())
        if rng <= 255:
            return lb + self.get_bits((rng - 1).bit_length())
        if rng == 256:
            self.align()
            return lb + self.get_bits(8)
        if rng <= 65536:
            self.align()
            return lb + self.get_bits(16)
        max_n = ((ub - lb).bit_length() + 7) // 8
        n = self.constrained_whole(1, max_n)
        self.align()
        return lb + self.get_bits(8 * n)

    def normally_small(self) -> int:
        if self.get_bit() == 0:
            return self.get_bits(6)
        return self.semi_constrained(0)

    def semi_constrained(self, lb: int) -> int:
        n = self.length_det()
        self.align()
        return lb + int.from_bytes(self.get_bytes(n), "big")

    def unconstrained(self) -> int:
        n = self.length_det()
        self.align()
        return int.from_bytes(self.get_bytes(n), "big", signed=True)

    def length_det(self, lb: int = 0, ub: int | None = None) -> int:
        if ub is not None and ub < 65536:
            return self.constrained_whole(lb, ub)
        self.align()
        first = self.get_bits(8)
        if first < 128:
            return first
        if first >> 6 == 0b10:
            return ((first & 0x3F) << 8) | self.get_bits(8)
        raise PerError("fragmented length: use read_fragments()")

    def read_fragmented_bytes(self) -> bytes:
        """General-form possibly-fragmented OCTET STRING contents."""
        out = bytearray()
        while True:
            self.align()
            first = self.get_bits(8)
            if first < 128:
                out += self.get_bytes(first)
                return bytes(out)
            if first >> 6 == 0b10:
                n = ((first & 0x3F) << 8) | self.get_bits(8)
                out += self.get_bytes(n)
                return bytes(out)
            m = first & 0x3F
            if not 1 <= m <= 4:
                raise PerError(f"bad fragment multiplier {m}")
            out += self.get_bytes(m * _16K)

    def open_type(self) -> bytes:
        blob = self.read_fragmented_bytes()
        return blob
