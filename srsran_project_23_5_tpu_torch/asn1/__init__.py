"""ASN.1 PER codec for the RAN application protocols.

Rounds 1-4 carried a self-describing TLV stand-in; this package now
encodes with genuine X.691 Packed Encoding Rules (`asn1.per` — the
bit-level engine; `asn1.schema` — declarative types) in the shape the
3GPP RAN protocols use (reference: lib/asn1/{ngap,f1ap,e1ap,rrc_nr}):

- every registered message is carried as an AP-PDU:
  `CHOICE {initiatingMessage, successfulOutcome, unsuccessfulOutcome}`
  over `SEQUENCE {procedureCode INTEGER(0..255), criticality
  ENUMERATED {reject, ignore, notify}, value}` with the value an
  OPEN TYPE holding a ProtocolIE-Container
  (`SEQUENCE OF SEQUENCE {id INTEGER(0..65535), criticality, value}`),
  exactly as TS 38.413/38.473/37.483 define their PDU framing;
- IE *bodies* use a derived per-field schema (a universal value CHOICE
  over the Python field types) rather than the per-message hand ASN.1 —
  the declared, honest scope cut (the reference generates 480k lines
  for those bodies).  Exact hand schemas exist where they are small and
  load-bearing: the UL-CCCH/DL-CCCH RRC messages (`rrc.ccch`, UPER).
- one leading family octet stands in for the per-interface SCTP PPID
  that separates NGAP/F1AP/E1AP streams in the reference deployment.

ALIGNED PER is used (the variant of the NGAP/F1AP/E1AP transfer
syntax); RRC CCCH schemas encode UNALIGNED as TS 38.331 requires.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Type

from .per import BitReader, BitWriter, PerError
from . import schema as S

_CRIT = S.Enumerated(["reject", "ignore", "notify"])
_KINDS = ("initiating", "successful", "unsuccessful")

# registry: msg_id -> class, and (family, kind_idx, proc) -> class
_REGISTRY: dict[int, Type] = {}
_IDS: dict[Type, int] = {}
_PDU_KEY: dict[tuple[int, int, int], Type] = {}
_META: dict[Type, tuple[int, int, int]] = {}


def message(msg_id: int, proc: int | None = None,
            kind: str = "initiating") -> Callable[[Type], Type]:
    """Register a dataclass as an AP message.

    `proc` is the protocol's procedureCode (defaults to msg_id & 0xFF);
    `kind` selects the PDU CHOICE arm (initiating/successful/
    unsuccessful).  (family := msg_id >> 8) keeps the shared registry
    unambiguous across NGAP/F1AP/E1AP/RRC, standing in for the separate
    SCTP streams of a real deployment.
    """
    def wrap(cls: Type) -> Type:
        cls = dataclasses.dataclass(cls)
        assert msg_id not in _REGISTRY, f"duplicate msg id {msg_id}"
        _REGISTRY[msg_id] = cls
        _IDS[cls] = msg_id
        key = (msg_id >> 8, _KINDS.index(kind),
               proc if proc is not None else msg_id & 0xFF)
        assert key not in _PDU_KEY, f"duplicate (family,kind,proc) {key}"
        _PDU_KEY[key] = cls
        _META[cls] = key
        return cls
    return wrap


# ---------------------------------------------------------------- values
def _enc_value(w: BitWriter, v: Any) -> None:
    """Universal value CHOICE {null, bool, int, oct, str, seq, pdu}."""
    if v is None:
        w.constrained_whole(0, 0, 6)
    elif isinstance(v, bool):
        w.constrained_whole(1, 0, 6)
        w.put_bit(1 if v else 0)
    elif isinstance(v, int):
        w.constrained_whole(2, 0, 6)
        w.unconstrained(v)
    elif isinstance(v, (bytes, bytearray)):
        w.constrained_whole(3, 0, 6)
        S.OctetString().encode(w, v)
    elif isinstance(v, str):
        w.constrained_whole(4, 0, 6)
        S.Utf8String().encode(w, v)
    elif isinstance(v, (list, tuple)):
        w.constrained_whole(5, 0, 6)
        w.length_det(len(v))
        for item in v:
            _enc_value(w, item)
    elif dataclasses.is_dataclass(v):
        w.constrained_whole(6, 0, 6)
        S.OctetString().encode(w, encode(v))
    else:
        raise PerError(f"unsupported field type {type(v)}")


def _dec_value(r: BitReader) -> Any:
    alt = r.constrained_whole(0, 6)
    if alt == 0:
        return None
    if alt == 1:
        return bool(r.get_bit())
    if alt == 2:
        return r.unconstrained()
    if alt == 3:
        return S.OctetString().decode(r)
    if alt == 4:
        return S.Utf8String().decode(r)
    if alt == 5:
        n = r.length_det()
        return [_dec_value(r) for _ in range(n)]
    return decode(S.OctetString().decode(r))


# ------------------------------------------------------------------ PDU
def encode(msg: Any) -> bytes:
    """Message dataclass -> family octet + ALIGNED-PER AP-PDU bytes."""
    family, kind_idx, proc = _META[type(msg)]
    w = BitWriter(aligned=True)
    # PDU ::= CHOICE {initiating, successful, unsuccessful} (extensible)
    w.put_bit(0)
    w.constrained_whole(kind_idx, 0, 2)
    w.constrained_whole(proc, 0, 255)
    _CRIT.encode(w, "reject")
    # value ::= OPEN TYPE (ProtocolIE-Container)
    iw = BitWriter(aligned=True)
    fields = dataclasses.fields(msg)
    iw.length_det(len(fields), 0, 65535)
    for i, f in enumerate(fields):
        iw.constrained_whole(i, 0, 65535)       # protocolIE-ID
        _CRIT.encode(iw, "ignore")
        vw = BitWriter(aligned=True)
        _enc_value(vw, getattr(msg, f.name))
        iw.open_type(vw)
    w.open_type(iw)
    return bytes([family]) + w.to_bytes()


def decode(data: bytes) -> Any:
    family = data[0]
    r = BitReader(data[1:], aligned=True)
    if r.get_bit():
        raise PerError("extension PDU arm not in use")
    kind_idx = r.constrained_whole(0, 2)
    proc = r.constrained_whole(0, 255)
    _CRIT.decode(r)
    cls = _PDU_KEY.get((family, kind_idx, proc))
    if cls is None:
        raise PerError(f"unknown PDU (family={family}, kind={kind_idx}, "
                       f"proc={proc})")
    body = r.open_type()
    ir = BitReader(body, aligned=True)
    n = ir.length_det(0, 65535)
    flds = dataclasses.fields(cls)
    vals: dict[int, Any] = {}
    for _ in range(n):
        ie_id = ir.constrained_whole(0, 65535)
        _CRIT.decode(ir)
        blob = ir.open_type()
        if ie_id < len(flds):                    # unknown IEs are skipped
            vals[ie_id] = _dec_value(BitReader(blob, aligned=True))
    if len(vals) != len(flds):
        raise PerError(f"{cls.__name__}: missing IEs "
                       f"{sorted(set(range(len(flds))) - set(vals))}")
    return cls(*[vals[i] for i in range(len(flds))])
