"""The MongoDB wire format (counterpart of
gofr_tpu/datasource/mongo/mongoproto.py, the same bytes): a BSON codec
(``encode_document`` / ``decode_document``, ``Int64``, ``ObjectId``) and
OP_MSG framing (opcode 2013: ``encode_op_msg`` with a kind-0 body and
kind-1 document sequences, ``decode_op_msg``, ``read_message``). Shared
by the wire client (``wire.py``) and the in-process fake server
(``testutil/fakemongo.py``); written from the public BSON specification
and the wire-protocol documentation, as the Kafka and MQTT codecs are.

BSON types: double, string, document, array, binary (subtype 0), ObjectId,
bool, UTC datetime, null, int32, int64. Anything else raises.
"""

from __future__ import annotations

import datetime as _dt
import os
import struct
import threading
import time

__all__ = [
    "ObjectId",
    "Int64",
    "encode_document",
    "decode_document",
    "encode_op_msg",
    "decode_op_msg",
    "read_message",
    "OP_MSG",
]


class Int64(int):
    """Force BSON int64 ('long') encoding regardless of magnitude. Some
    server fields are type-checked, not just range-checked — getMore's
    cursor id must be a long even when it fits in 32 bits."""

OP_MSG = 2013

_MAX_DOC = 16 * 1024 * 1024  # server-side maxBsonObjectSize default


class ObjectId:
    """12-byte BSON ObjectId: 4-byte seconds + 5-byte random + 3-byte
    counter (the layout servers and drivers agree on)."""

    _counter = int.from_bytes(os.urandom(3), "big")
    _random = os.urandom(5)
    _lock = threading.Lock()

    __slots__ = ("raw",)

    def __init__(self, raw: bytes | str | None = None):
        if raw is None:
            with ObjectId._lock:
                ObjectId._counter = (ObjectId._counter + 1) & 0xFFFFFF
                counter = ObjectId._counter
            self.raw = (
                struct.pack(">I", int(time.time()))
                + ObjectId._random
                + counter.to_bytes(3, "big")
            )
        elif isinstance(raw, str):
            if len(raw) != 24:
                raise ValueError(f"ObjectId hex must be 24 chars, got {len(raw)}")
            self.raw = bytes.fromhex(raw)
        else:
            if len(raw) != 12:
                raise ValueError(f"ObjectId must be 12 bytes, got {len(raw)}")
            self.raw = bytes(raw)

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectId) and self.raw == other.raw

    def __hash__(self) -> int:
        return hash(self.raw)

    def __str__(self) -> str:
        return self.raw.hex()

    def __repr__(self) -> str:
        return f"ObjectId({self.raw.hex()!r})"


_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _encode_value(name: bytes, value) -> bytes:
    if isinstance(value, bool):  # before int: bool is an int subclass
        return b"\x08" + name + b"\x00" + (b"\x01" if value else b"\x00")
    if isinstance(value, float):
        return b"\x01" + name + b"\x00" + struct.pack("<d", value)
    if isinstance(value, str):
        raw = value.encode()
        return b"\x02" + name + b"\x00" + struct.pack("<i", len(raw) + 1) + raw + b"\x00"
    if isinstance(value, dict):
        return b"\x03" + name + b"\x00" + encode_document(value)
    if isinstance(value, (list, tuple)):
        inner = encode_document({str(i): v for i, v in enumerate(value)})
        return b"\x04" + name + b"\x00" + inner
    if isinstance(value, (bytes, bytearray)):
        return (
            b"\x05" + name + b"\x00" + struct.pack("<i", len(value)) + b"\x00" + bytes(value)
        )
    if isinstance(value, ObjectId):
        return b"\x07" + name + b"\x00" + value.raw
    if value is None:
        return b"\x0a" + name + b"\x00"
    if isinstance(value, int):
        if not isinstance(value, Int64) and -(2**31) <= value < 2**31:
            return b"\x10" + name + b"\x00" + struct.pack("<i", value)
        return b"\x12" + name + b"\x00" + struct.pack("<q", value)
    if isinstance(value, _dt.datetime):
        if value.tzinfo is None:
            value = value.replace(tzinfo=_dt.timezone.utc)
        ms = int((value - _EPOCH).total_seconds() * 1000)
        return b"\x09" + name + b"\x00" + struct.pack("<q", ms)
    raise TypeError(f"cannot BSON-encode {type(value).__name__}: {value!r}")


def encode_document(doc: dict) -> bytes:
    body = bytearray()
    for key, value in doc.items():
        name = str(key).encode()
        if b"\x00" in name:
            raise ValueError("BSON key may not contain NUL")
        body += _encode_value(name, value)
    return struct.pack("<i", len(body) + 5) + bytes(body) + b"\x00"


def _read_cstring(buf: bytes, at: int) -> tuple[str, int]:
    end = buf.index(b"\x00", at)
    return buf[at:end].decode(), end + 1


def _decode_value(tag: int, buf: bytes, at: int):
    if tag == 0x01:
        return struct.unpack_from("<d", buf, at)[0], at + 8
    if tag == 0x02:
        (n,) = struct.unpack_from("<i", buf, at)
        if n < 1 or at + 4 + n > len(buf):
            raise ValueError("BSON string length out of range")
        raw = buf[at + 4 : at + 4 + n - 1]
        if buf[at + 4 + n - 1] != 0:
            raise ValueError("BSON string missing terminator")
        return raw.decode(), at + 4 + n
    if tag in (0x03, 0x04):
        doc, end = _decode_document_at(buf, at)
        if tag == 0x04:
            return list(doc.values()), end
        return doc, end
    if tag == 0x05:
        (n,) = struct.unpack_from("<i", buf, at)
        if n < 0 or at + 5 + n > len(buf):
            raise ValueError("BSON binary length out of range")
        subtype = buf[at + 4]
        if subtype != 0x00:
            # legacy 0x02 carries an inner length prefix and typed subtypes
            # (UUID 0x04, ...) would be silently flattened to generic bytes
            # on re-encode — refuse rather than corrupt data shared with
            # other drivers
            raise ValueError(f"unsupported BSON binary subtype 0x{subtype:02x}")
        return bytes(buf[at + 5 : at + 5 + n]), at + 5 + n
    if tag == 0x07:
        return ObjectId(bytes(buf[at : at + 12])), at + 12
    if tag == 0x08:
        return buf[at] != 0, at + 1
    if tag == 0x09:
        (ms,) = struct.unpack_from("<q", buf, at)
        return _EPOCH + _dt.timedelta(milliseconds=ms), at + 8
    if tag == 0x0A:
        return None, at
    if tag == 0x10:
        return struct.unpack_from("<i", buf, at)[0], at + 4
    if tag == 0x12:
        return struct.unpack_from("<q", buf, at)[0], at + 8
    raise ValueError(f"unsupported BSON type 0x{tag:02x}")


def _decode_document_at(buf: bytes, at: int) -> tuple[dict, int]:
    (size,) = struct.unpack_from("<i", buf, at)
    if size < 5 or size > _MAX_DOC or at + size > len(buf):
        raise ValueError(f"BSON document size {size} out of range")
    end = at + size
    if buf[end - 1] != 0:
        raise ValueError("BSON document missing terminator")
    doc: dict = {}
    pos = at + 4
    while pos < end - 1:
        tag = buf[pos]
        name, pos = _read_cstring(buf, pos + 1)
        doc[name], pos = _decode_value(tag, buf, pos)
    if pos != end - 1:
        raise ValueError("BSON document overruns its declared size")
    return doc, end


def decode_document(buf: bytes) -> dict:
    doc, end = _decode_document_at(buf, 0)
    if end != len(buf):
        raise ValueError("trailing bytes after BSON document")
    return doc


# ---------------------------------------------------------------------------
# OP_MSG framing
# ---------------------------------------------------------------------------


def encode_op_msg(
    body: dict,
    *,
    request_id: int,
    response_to: int = 0,
    sequences: dict[str, list[dict]] | None = None,
) -> bytes:
    """One OP_MSG: kind-0 body section plus optional kind-1 document
    sequences (the framing insert uses for its documents)."""
    payload = bytearray(struct.pack("<I", 0))  # flagBits
    payload += b"\x00" + encode_document(body)
    for ident, docs in (sequences or {}).items():
        seq = bytearray()
        seq += ident.encode() + b"\x00"
        for d in docs:
            seq += encode_document(d)
        payload += b"\x01" + struct.pack("<i", len(seq) + 4) + bytes(seq)
    header = struct.pack(
        "<iiii", 16 + len(payload), request_id, response_to, OP_MSG
    )
    return header + bytes(payload)


def decode_op_msg(frame: bytes) -> tuple[int, int, dict]:
    """Parse a full wire message -> (request_id, response_to, body).
    Kind-1 sequences are folded into the body under their identifier,
    matching server semantics (a sequence is equivalent to a body array)."""
    if len(frame) < 21:
        raise ValueError("OP_MSG frame too short")
    length, request_id, response_to, opcode = struct.unpack_from("<iiii", frame, 0)
    if opcode != OP_MSG:
        raise ValueError(f"unsupported opcode {opcode} (only OP_MSG/2013)")
    if length != len(frame):
        raise ValueError("OP_MSG length mismatch")
    (flags,) = struct.unpack_from("<I", frame, 16)
    pos = 20
    end = length - 4 if flags & 0x1 else length  # checksumPresent
    body: dict | None = None
    sequences: dict[str, list[dict]] = {}
    while pos < end:
        kind = frame[pos]
        pos += 1
        if kind == 0:
            doc, pos = _decode_document_at(frame, pos)
            if body is not None:
                raise ValueError("OP_MSG with multiple body sections")
            body = doc
        elif kind == 1:
            (size,) = struct.unpack_from("<i", frame, pos)
            seq_end = pos + size
            if size < 5 or seq_end > end:
                raise ValueError("OP_MSG sequence size out of range")
            ident, p = _read_cstring(frame, pos + 4)
            docs = []
            while p < seq_end:
                d, p = _decode_document_at(frame, p)
                docs.append(d)
            sequences[ident] = docs
            pos = seq_end
        else:
            raise ValueError(f"unsupported OP_MSG section kind {kind}")
    if body is None:
        raise ValueError("OP_MSG without body section")
    for ident, docs in sequences.items():
        if ident in body:
            raise ValueError(f"OP_MSG sequence {ident!r} duplicates body field")
        body[ident] = docs
    return request_id, response_to, body


def read_message(recv_exact) -> bytes:
    """Read one wire message via recv_exact(n) -> n bytes."""
    head = recv_exact(4)
    (length,) = struct.unpack("<i", head)
    if length < 16 or length > _MAX_DOC + 16 * 1024:
        raise ValueError(f"wire message length {length} out of range")
    return head + recv_exact(length - 4)
