"""Kafka wire protocol codec (counterpart of
gofr_tpu/datasource/pubsub/kafkaproto.py, byte for byte).

The subset of the Kafka binary protocol a producer and a consumer group
with durable offsets need: framing, the primitive types, and both record
formats, the pre-KIP-98 MessageSet v1 and the v2 record batch (zigzag
varints, headers, tombstones, control batches, CRC32C):

  Produce v2/v3, Fetch v2/v4, ListOffsets v1, Metadata v1,
  OffsetCommit v2, OffsetFetch v1, FindCoordinator v0, CreateTopics v0,
  DeleteTopics v0, ApiVersions v0, SaslHandshake v1, SaslAuthenticate v0.

The client negotiates through ApiVersions: a broker advertising
Produce>=3 / Fetch>=4 gets v2 record batches, an older one v1 message
sets. Shared by the client (kafka.py) and the in-process fake broker
(testutil/fakekafka.py). CRC32C is the table-driven software version
only: no C extension is assumed on the machines the port runs on.

The codec follows the public protocol specification
(kafka.apache.org/protocol).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

# api_keys
PRODUCE = 0
FETCH = 1
LIST_OFFSETS = 2
METADATA = 3
OFFSET_COMMIT = 8
OFFSET_FETCH = 9
FIND_COORDINATOR = 10
SASL_HANDSHAKE = 17
API_VERSIONS = 18
CREATE_TOPICS = 19
DELETE_TOPICS = 20
SASL_AUTHENTICATE = 36

# error codes (subset)
NONE = 0
OFFSET_OUT_OF_RANGE = 1
UNKNOWN_TOPIC_OR_PARTITION = 3
NOT_LEADER_FOR_PARTITION = 6
REQUEST_TIMED_OUT = 7
UNSUPPORTED_SASL_MECHANISM = 33
ILLEGAL_SASL_STATE = 34
UNSUPPORTED_VERSION = 35
TOPIC_ALREADY_EXISTS = 36
SASL_AUTHENTICATION_FAILED = 58

EARLIEST = -2
LATEST = -1


class Writer:
    """Big-endian primitive writer."""

    def __init__(self):
        self._parts: list[bytes] = []

    def i8(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">b", v))
        return self

    def i16(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">h", v))
        return self

    def i32(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">i", v))
        return self

    def u32(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">I", v))
        return self

    def i64(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">q", v))
        return self

    def string(self, s: str | None) -> "Writer":
        if s is None:
            return self.i16(-1)
        b = s.encode()
        self.i16(len(b))
        self._parts.append(b)
        return self

    def bytes_(self, b: bytes | None) -> "Writer":
        if b is None:
            return self.i32(-1)
        self.i32(len(b))
        self._parts.append(b)
        return self

    def raw(self, b: bytes) -> "Writer":
        self._parts.append(b)
        return self

    def array(self, items, enc) -> "Writer":
        self.i32(len(items))
        for it in items:
            enc(self, it)
        return self

    def build(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    """Big-endian primitive reader."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) < n:
            raise EOFError("short kafka frame")
        self.pos += n
        return b

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def string(self) -> str | None:
        n = self.i16()
        if n < 0:
            return None
        return self._take(n).decode()

    def bytes_(self) -> bytes | None:
        n = self.i32()
        if n < 0:
            return None
        return self._take(n)

    def array(self, dec) -> list:
        return [dec(self) for _ in range(self.i32())]

    def remaining(self) -> int:
        return len(self.data) - self.pos


# ---------------------------------------------------------------------------
# Framing: [i32 size][i16 api_key][i16 api_version][i32 correlation][str client]
# ---------------------------------------------------------------------------


def encode_request(api_key: int, api_version: int, corr_id: int, client_id: str,
                   body: bytes) -> bytes:
    w = Writer().i16(api_key).i16(api_version).i32(corr_id).string(client_id).raw(body)
    payload = w.build()
    return struct.pack(">i", len(payload)) + payload


def encode_response(corr_id: int, body: bytes) -> bytes:
    payload = struct.pack(">i", corr_id) + body
    return struct.pack(">i", len(payload)) + payload


# ---------------------------------------------------------------------------
# MessageSet v1 (magic=1): offset i64 | size i32 | crc u32 | magic i8 |
# attrs i8 | timestamp i64 | key bytes | value bytes. CRC covers magic..end.
# ---------------------------------------------------------------------------


@dataclass
class Record:
    key: bytes | None
    value: bytes | None  # None = tombstone (compaction delete marker)
    timestamp: int = -1
    offset: int = 0
    headers: dict = field(default_factory=dict)  # carried out-of-band (not in v1 wire)


def encode_message_set(records: list[Record]) -> bytes:
    w = Writer()
    for r in records:
        inner = (
            Writer().i8(1).i8(0).i64(r.timestamp).bytes_(r.key).bytes_(r.value).build()
        )
        crc = zlib.crc32(inner) & 0xFFFFFFFF
        msg = Writer().u32(crc).raw(inner).build()
        w.i64(r.offset).i32(len(msg)).raw(msg)
    return w.build()


def decode_message_set(data: bytes) -> list[Record]:
    """Tolerates a trailing partial message (brokers may truncate at
    max_bytes mid-message; the spec says discard the tail)."""
    out: list[Record] = []
    r = Reader(data)
    while r.remaining() >= 12:
        try:
            offset = r.i64()
            size = r.i32()
            if r.remaining() < size:
                break
            msg = Reader(r._take(size))
            crc = msg.u32()
            rest = msg.data[msg.pos :]
            if zlib.crc32(rest) & 0xFFFFFFFF != crc:
                raise ValueError("kafka message CRC mismatch")
            magic = msg.i8()
            msg.i8()  # attributes (no compression support)
            ts = msg.i64() if magic >= 1 else -1
            key = msg.bytes_()
            value = msg.bytes_()
            # value=None is a TOMBSTONE (compaction delete marker) — distinct
            # from an empty value on the wire; preserve the difference
            out.append(Record(key=key, value=value, timestamp=ts, offset=offset))
        except EOFError:
            break
    return out


# ---------------------------------------------------------------------------
# Record batch v2 (KIP-98, magic=2): the modern on-disk/wire format.
#   baseOffset i64 | batchLength i32 | partitionLeaderEpoch i32 | magic i8 |
#   crc u32 (CRC32C of everything after it) | attributes i16 |
#   lastOffsetDelta i32 | baseTimestamp i64 | maxTimestamp i64 |
#   producerId i64 | producerEpoch i16 | baseSequence i32 | count i32 |
#   records (each: zigzag-varint length-prefixed, with per-record headers)
# ---------------------------------------------------------------------------

# CRC32C (Castagnoli, reflected poly 0x82F63B78) — zlib.crc32 is the IEEE
# polynomial and does NOT match; table built once at import.
_CRC32C_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC32C_TABLE.append(_c)
del _i, _c


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C by table, a byte at a time: no C extension is assumed."""
    crc ^= 0xFFFFFFFF
    tbl = _CRC32C_TABLE
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def enc_varint(v: int) -> bytes:
    u = _zigzag(v) & 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def dec_varint(data: bytes, pos: int) -> tuple[int, int]:
    shift = u = 0
    while True:
        if pos >= len(data):
            raise EOFError("short varint")
        b = data[pos]
        pos += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            return _unzigzag(u), pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def encode_record_batch(records: list[Record], base_offset: int = 0) -> bytes:
    """One v2 batch carrying all `records` (no compression, attributes 0)."""
    if not records:
        return b""
    base_ts = min(r.timestamp for r in records)
    max_ts = max(r.timestamp for r in records)
    recs = bytearray()
    for i, r in enumerate(records):
        body = bytearray()
        body += b"\x00"  # record attributes
        body += enc_varint(r.timestamp - base_ts)
        body += enc_varint(i)  # offset delta
        if r.key is None:
            body += enc_varint(-1)
        else:
            body += enc_varint(len(r.key)) + r.key
        if r.value is None:
            body += enc_varint(-1)
        else:
            body += enc_varint(len(r.value)) + r.value
        body += enc_varint(len(r.headers))
        for hk, hv in r.headers.items():
            hkb = hk.encode() if isinstance(hk, str) else hk
            body += enc_varint(len(hkb)) + hkb
            if hv is None:
                body += enc_varint(-1)
            else:
                hvb = hv.encode() if isinstance(hv, str) else hv
                body += enc_varint(len(hvb)) + hvb
        recs += enc_varint(len(body)) + body
    after_crc = (
        Writer()
        .i16(0)  # attributes: no compression, create-time timestamps
        .i32(len(records) - 1)  # lastOffsetDelta
        .i64(base_ts)
        .i64(max_ts)
        .i64(-1)  # producerId
        .i16(-1)  # producerEpoch
        .i32(-1)  # baseSequence
        .i32(len(records))
        .raw(bytes(recs))
        .build()
    )
    crc = crc32c(after_crc)
    tail = Writer().i32(0).i8(2).u32(crc).raw(after_crc).build()  # epoch|magic|crc|...
    return Writer().i64(base_offset).i32(len(tail)).raw(tail).build()


def decode_record_batches(data: bytes) -> list[Record]:
    """Every complete v2 batch in `data` (a fetch may return several,
    and may truncate the last one — the spec says discard the tail)."""
    out: list[Record] = []
    pos = 0
    while len(data) - pos >= 17:
        base_offset = struct.unpack_from(">q", data, pos)[0]
        batch_len = struct.unpack_from(">i", data, pos + 8)[0]
        if pos + 12 + batch_len > len(data):
            break  # truncated trailing batch
        magic = data[pos + 16]
        if magic != 2:
            raise ValueError(f"not a v2 record batch (magic {magic})")
        crc = struct.unpack_from(">I", data, pos + 17)[0]
        body = data[pos + 21 : pos + 12 + batch_len]
        if crc32c(body) != crc:
            raise ValueError("record batch CRC32C mismatch")
        r = Reader(body)
        attrs = r.i16()
        if attrs & 0x07:
            raise ValueError("compressed record batches not supported")
        if attrs & 0x20:
            # control batch (transaction COMMIT/ABORT markers): not
            # application data — skip, or consumers would surface the
            # marker bytes as messages
            pos += 12 + batch_len
            continue
        r.i32()  # lastOffsetDelta
        base_ts = r.i64()
        r.i64()  # maxTimestamp
        r.i64()  # producerId
        r.i16()  # producerEpoch
        r.i32()  # baseSequence
        count = r.i32()
        raw = r.data
        p = r.pos
        for _ in range(count):
            length, p = dec_varint(raw, p)
            end = p + length
            p += 1  # record attributes
            ts_delta, p = dec_varint(raw, p)
            off_delta, p = dec_varint(raw, p)
            klen, p = dec_varint(raw, p)
            key = None
            if klen >= 0:
                key = raw[p : p + klen]
                p += klen
            vlen, p = dec_varint(raw, p)
            value = None
            if vlen >= 0:
                value = raw[p : p + vlen]
                p += vlen
            nh, p = dec_varint(raw, p)
            headers = {}
            for _h in range(nh):
                hklen, p = dec_varint(raw, p)
                hk = raw[p : p + hklen].decode()
                p += hklen
                hvlen, p = dec_varint(raw, p)
                if hvlen < 0:
                    headers[hk] = None
                else:
                    headers[hk] = raw[p : p + hvlen]
                    p += hvlen
            if p != end:
                raise ValueError("record length mismatch")
            out.append(
                Record(
                    key=key, value=value, timestamp=base_ts + ts_delta,
                    offset=base_offset + off_delta, headers=headers,
                )
            )
        pos += 12 + batch_len
    return out


def decode_records(data: bytes) -> list[Record]:
    """Dispatch on the record format. Both formats place `magic` at byte
    16 of the buffer (by design, for exactly this sniff): MessageSet
    entries are offset(8)+size(4)+crc(4)+magic; v2 batches are
    baseOffset(8)+length(4)+leaderEpoch(4)+magic."""
    if len(data) < 17:
        return []
    return decode_record_batches(data) if data[16] >= 2 else decode_message_set(data)


# ---------------------------------------------------------------------------
# Request/response bodies. Encoders build the client->broker body; decoders
# parse the broker->client body. The fake broker uses the mirror pair.
# ---------------------------------------------------------------------------


def enc_api_versions_req() -> bytes:
    return b""  # v0 request is empty


def enc_api_versions_resp(versions: dict[int, tuple[int, int]], error: int = NONE) -> bytes:
    w = Writer().i16(error)
    w.array(
        sorted(versions.items()),
        lambda w, kv: w.i16(kv[0]).i16(kv[1][0]).i16(kv[1][1]),
    )
    return w.build()


def dec_api_versions_resp(r: Reader) -> tuple[int, dict[int, tuple[int, int]]]:
    err = r.i16()
    out: dict[int, tuple[int, int]] = {}
    for _ in range(r.i32()):
        key = r.i16()
        out[key] = (r.i16(), r.i16())
    return err, out


def enc_sasl_handshake_req(mechanism: str) -> bytes:
    return Writer().string(mechanism).build()


def dec_sasl_handshake_req(r: Reader) -> str:
    return r.string()


def enc_sasl_handshake_resp(error: int, mechanisms: list[str]) -> bytes:
    return Writer().i16(error).array(mechanisms, lambda w, m: w.string(m)).build()


def dec_sasl_handshake_resp(r: Reader) -> tuple[int, list[str]]:
    return r.i16(), r.array(Reader.string)


def enc_sasl_authenticate_req(auth_bytes: bytes) -> bytes:
    return Writer().bytes_(auth_bytes).build()


def dec_sasl_authenticate_req(r: Reader) -> bytes:
    return r.bytes_() or b""


def enc_sasl_authenticate_resp(
    error: int, message: str | None, auth_bytes: bytes
) -> bytes:
    return Writer().i16(error).string(message).bytes_(auth_bytes).build()


def dec_sasl_authenticate_resp(r: Reader) -> tuple[int, str | None, bytes]:
    return r.i16(), r.string(), r.bytes_() or b""


def enc_metadata_req(topics: list[str] | None) -> bytes:
    w = Writer()
    if topics is None:
        w.i32(-1)  # all topics
    else:
        w.array(topics, lambda w, t: w.string(t))
    return w.build()


def dec_metadata_req(r: Reader) -> list[str] | None:
    n = r.i32()
    if n < 0:
        return None
    return [r.string() for _ in range(n)]


def enc_metadata_resp(brokers, controller_id: int, topics) -> bytes:
    """brokers: [(node_id, host, port)]; topics: [(err, name, [(perr, pid, leader)])]"""
    w = Writer()
    w.array(brokers, lambda w, b: w.i32(b[0]).string(b[1]).i32(b[2]).string(None))
    w.i32(controller_id)

    def enc_part(w, p):
        w.i16(p[0]).i32(p[1]).i32(p[2]).array([p[2]], Writer.i32).array([p[2]], Writer.i32)

    w.array(
        topics,
        lambda w, t: w.i16(t[0]).string(t[1]).i8(0).array(t[2], enc_part),
    )
    return w.build()


def dec_metadata_resp(r: Reader) -> dict:
    brokers = r.array(lambda r: (r.i32(), r.string(), r.i32(), r.string()))
    controller = r.i32()

    def dec_part(r):
        err, pid, leader = r.i16(), r.i32(), r.i32()
        r.array(Reader.i32)  # replicas
        r.array(Reader.i32)  # isr
        return {"error": err, "id": pid, "leader": leader}

    topics = r.array(
        lambda r: {
            "error": r.i16(),
            "name": r.string(),
            "internal": r.i8(),
            "partitions": r.array(dec_part),
        }
    )
    return {
        "brokers": {b[0]: (b[1], b[2]) for b in brokers},
        "controller": controller,
        "topics": {t["name"]: t for t in topics},
    }


def enc_produce_req(acks: int, timeout_ms: int,
                    topics: dict[str, dict[int, bytes]]) -> bytes:
    w = Writer().i16(acks).i32(timeout_ms)
    w.array(
        list(topics.items()),
        lambda w, kv: w.string(kv[0]).array(
            list(kv[1].items()), lambda w, pv: w.i32(pv[0]).bytes_(pv[1])
        ),
    )
    return w.build()


def dec_produce_req(r: Reader) -> tuple[int, int, dict[str, dict[int, bytes]]]:
    acks, timeout = r.i16(), r.i32()
    topics: dict[str, dict[int, bytes]] = {}
    for _ in range(r.i32()):
        name = r.string()
        parts = {}
        for _ in range(r.i32()):
            pid = r.i32()
            parts[pid] = r.bytes_() or b""
        topics[name] = parts
    return acks, timeout, topics


def enc_produce_resp(topics: dict[str, dict[int, tuple[int, int]]]) -> bytes:
    """topics: {name: {pid: (error, base_offset)}}"""
    w = Writer()
    w.array(
        list(topics.items()),
        lambda w, kv: w.string(kv[0]).array(
            list(kv[1].items()),
            lambda w, pv: w.i32(pv[0]).i16(pv[1][0]).i64(pv[1][1]).i64(-1),
        ),
    )
    w.i32(0)  # throttle
    return w.build()


def dec_produce_resp(r: Reader) -> dict[str, dict[int, tuple[int, int]]]:
    out: dict[str, dict[int, tuple[int, int]]] = {}
    for _ in range(r.i32()):
        name = r.string()
        parts = {}
        for _ in range(r.i32()):
            pid, err, base = r.i32(), r.i16(), r.i64()
            r.i64()  # log_append_time
            parts[pid] = (err, base)
        out[name] = parts
    return out


def enc_produce_req_v3(acks: int, timeout_ms: int,
                       topics: dict[str, dict[int, bytes]],
                       transactional_id: str | None = None) -> bytes:
    """v3 = v2 body prefixed with a nullable transactional_id; the record
    sets are v2 record batches."""
    return Writer().string(transactional_id).raw(
        enc_produce_req(acks, timeout_ms, topics)
    ).build()


def dec_produce_req_v3(r: Reader) -> tuple[int, int, dict[str, dict[int, bytes]]]:
    r.string()  # transactional_id
    return dec_produce_req(r)


def enc_fetch_req(max_wait_ms: int, min_bytes: int,
                  topics: dict[str, dict[int, tuple[int, int]]]) -> bytes:
    """topics: {name: {pid: (offset, max_bytes)}}"""
    w = Writer().i32(-1).i32(max_wait_ms).i32(min_bytes)
    w.array(
        list(topics.items()),
        lambda w, kv: w.string(kv[0]).array(
            list(kv[1].items()),
            lambda w, pv: w.i32(pv[0]).i64(pv[1][0]).i32(pv[1][1]),
        ),
    )
    return w.build()


def dec_fetch_req(r: Reader) -> dict[str, dict[int, tuple[int, int]]]:
    r.i32()  # replica_id
    r.i32()  # max_wait
    r.i32()  # min_bytes
    topics: dict[str, dict[int, tuple[int, int]]] = {}
    for _ in range(r.i32()):
        name = r.string()
        parts = {}
        for _ in range(r.i32()):
            pid = r.i32()
            parts[pid] = (r.i64(), r.i32())
        topics[name] = parts
    return topics


def enc_fetch_resp(topics: dict[str, dict[int, tuple[int, int, bytes]]]) -> bytes:
    """topics: {name: {pid: (error, high_watermark, record_set)}}"""
    w = Writer().i32(0)  # throttle
    w.array(
        list(topics.items()),
        lambda w, kv: w.string(kv[0]).array(
            list(kv[1].items()),
            lambda w, pv: w.i32(pv[0]).i16(pv[1][0]).i64(pv[1][1]).bytes_(pv[1][2]),
        ),
    )
    return w.build()


def dec_fetch_resp(r: Reader) -> dict[str, dict[int, dict]]:
    r.i32()  # throttle
    out: dict[str, dict[int, dict]] = {}
    for _ in range(r.i32()):
        name = r.string()
        parts = {}
        for _ in range(r.i32()):
            pid = r.i32()
            parts[pid] = {
                "error": r.i16(),
                "high_watermark": r.i64(),
                "records": r.bytes_() or b"",
            }
        out[name] = parts
    return out


def enc_fetch_req_v4(max_wait_ms: int, min_bytes: int, max_bytes: int,
                     topics: dict[str, dict[int, tuple[int, int]]]) -> bytes:
    """v4 adds max_bytes (v3) and isolation_level (v4, READ_UNCOMMITTED)."""
    w = Writer().i32(-1).i32(max_wait_ms).i32(min_bytes).i32(max_bytes).i8(0)
    w.array(
        list(topics.items()),
        lambda w, kv: w.string(kv[0]).array(
            list(kv[1].items()),
            lambda w, pv: w.i32(pv[0]).i64(pv[1][0]).i32(pv[1][1]),
        ),
    )
    return w.build()


def dec_fetch_req_v4(r: Reader) -> dict[str, dict[int, tuple[int, int]]]:
    r.i32()  # replica_id
    r.i32()  # max_wait
    r.i32()  # min_bytes
    r.i32()  # max_bytes
    r.i8()  # isolation_level
    topics: dict[str, dict[int, tuple[int, int]]] = {}
    for _ in range(r.i32()):
        name = r.string()
        parts = {}
        for _ in range(r.i32()):
            pid = r.i32()
            parts[pid] = (r.i64(), r.i32())
        topics[name] = parts
    return topics


def enc_fetch_resp_v4(topics: dict[str, dict[int, tuple[int, int, bytes]]]) -> bytes:
    """topics: {name: {pid: (error, high_watermark, record_set)}} — v4 adds
    last_stable_offset + aborted_transactions per partition."""
    w = Writer().i32(0)  # throttle
    w.array(
        list(topics.items()),
        lambda w, kv: w.string(kv[0]).array(
            list(kv[1].items()),
            lambda w, pv: w.i32(pv[0]).i16(pv[1][0]).i64(pv[1][1])
            .i64(pv[1][1]).i32(0).bytes_(pv[1][2]),
        ),
    )
    return w.build()


def dec_fetch_resp_v4(r: Reader) -> dict[str, dict[int, dict]]:
    r.i32()  # throttle
    out: dict[str, dict[int, dict]] = {}
    for _ in range(r.i32()):
        name = r.string()
        parts = {}
        for _ in range(r.i32()):
            pid = r.i32()
            err, hw = r.i16(), r.i64()
            r.i64()  # last_stable_offset
            for _a in range(r.i32()):  # aborted_transactions
                r.i64(), r.i64()
            parts[pid] = {
                "error": err,
                "high_watermark": hw,
                "records": r.bytes_() or b"",
            }
        out[name] = parts
    return out


def enc_list_offsets_req(topics: dict[str, dict[int, int]]) -> bytes:
    """topics: {name: {pid: timestamp}} (EARLIEST/LATEST)"""
    w = Writer().i32(-1)
    w.array(
        list(topics.items()),
        lambda w, kv: w.string(kv[0]).array(
            list(kv[1].items()), lambda w, pv: w.i32(pv[0]).i64(pv[1])
        ),
    )
    return w.build()


def dec_list_offsets_req(r: Reader) -> dict[str, dict[int, int]]:
    r.i32()
    topics: dict[str, dict[int, int]] = {}
    for _ in range(r.i32()):
        name = r.string()
        parts = {}
        for _ in range(r.i32()):
            pid = r.i32()
            parts[pid] = r.i64()
        topics[name] = parts
    return topics


def enc_list_offsets_resp(topics: dict[str, dict[int, tuple[int, int]]]) -> bytes:
    """topics: {name: {pid: (error, offset)}}"""
    w = Writer()
    w.array(
        list(topics.items()),
        lambda w, kv: w.string(kv[0]).array(
            list(kv[1].items()),
            lambda w, pv: w.i32(pv[0]).i16(pv[1][0]).i64(-1).i64(pv[1][1]),
        ),
    )
    return w.build()


def dec_list_offsets_resp(r: Reader) -> dict[str, dict[int, tuple[int, int]]]:
    out: dict[str, dict[int, tuple[int, int]]] = {}
    for _ in range(r.i32()):
        name = r.string()
        parts = {}
        for _ in range(r.i32()):
            pid, err = r.i32(), r.i16()
            r.i64()  # timestamp
            parts[pid] = (err, r.i64())
        out[name] = parts
    return out


def enc_offset_commit_req(group: str, topics: dict[str, dict[int, int]]) -> bytes:
    """v2, group-less 'simple consumer' commit: generation -1, member ''."""
    w = Writer().string(group).i32(-1).string("").i64(-1)
    w.array(
        list(topics.items()),
        lambda w, kv: w.string(kv[0]).array(
            list(kv[1].items()),
            lambda w, pv: w.i32(pv[0]).i64(pv[1]).string(None),
        ),
    )
    return w.build()


def dec_offset_commit_req(r: Reader) -> tuple[str, dict[str, dict[int, int]]]:
    group = r.string()
    r.i32()  # generation
    r.string()  # member
    r.i64()  # retention
    topics: dict[str, dict[int, int]] = {}
    for _ in range(r.i32()):
        name = r.string()
        parts = {}
        for _ in range(r.i32()):
            pid = r.i32()
            parts[pid] = r.i64()
            r.string()  # metadata
        topics[name] = parts
    return group, topics


def enc_offset_commit_resp(topics: dict[str, dict[int, int]]) -> bytes:
    """topics: {name: {pid: error}}"""
    w = Writer()
    w.array(
        list(topics.items()),
        lambda w, kv: w.string(kv[0]).array(
            list(kv[1].items()), lambda w, pv: w.i32(pv[0]).i16(pv[1])
        ),
    )
    return w.build()


def dec_offset_commit_resp(r: Reader) -> dict[str, dict[int, int]]:
    out: dict[str, dict[int, int]] = {}
    for _ in range(r.i32()):
        name = r.string()
        parts = {}
        for _ in range(r.i32()):
            pid = r.i32()
            parts[pid] = r.i16()
        out[name] = parts
    return out


def enc_offset_fetch_req(group: str, topics: dict[str, list[int]]) -> bytes:
    w = Writer().string(group)
    w.array(
        list(topics.items()),
        lambda w, kv: w.string(kv[0]).array(kv[1], Writer.i32),
    )
    return w.build()


def dec_offset_fetch_req(r: Reader) -> tuple[str, dict[str, list[int]]]:
    group = r.string()
    topics: dict[str, list[int]] = {}
    for _ in range(r.i32()):
        name = r.string()
        topics[name] = r.array(Reader.i32)
    return group, topics


def enc_offset_fetch_resp(topics: dict[str, dict[int, tuple[int, int]]]) -> bytes:
    """topics: {name: {pid: (offset, error)}} — offset -1 = none committed"""
    w = Writer()
    w.array(
        list(topics.items()),
        lambda w, kv: w.string(kv[0]).array(
            list(kv[1].items()),
            lambda w, pv: w.i32(pv[0]).i64(pv[1][0]).string(None).i16(pv[1][1]),
        ),
    )
    return w.build()


def dec_offset_fetch_resp(r: Reader) -> dict[str, dict[int, tuple[int, int]]]:
    out: dict[str, dict[int, tuple[int, int]]] = {}
    for _ in range(r.i32()):
        name = r.string()
        parts = {}
        for _ in range(r.i32()):
            pid, off = r.i32(), r.i64()
            r.string()  # metadata
            parts[pid] = (off, r.i16())
        out[name] = parts
    return out


def enc_find_coordinator_req(group: str) -> bytes:
    return Writer().string(group).build()


def dec_find_coordinator_req(r: Reader) -> str:
    return r.string()


def enc_find_coordinator_resp(error: int, node_id: int, host: str, port: int) -> bytes:
    return Writer().i16(error).i32(node_id).string(host).i32(port).build()


def dec_find_coordinator_resp(r: Reader) -> tuple[int, int, str, int]:
    return r.i16(), r.i32(), r.string(), r.i32()


def enc_create_topics_req(topics: dict[str, int], timeout_ms: int = 5000) -> bytes:
    """topics: {name: num_partitions}"""
    w = Writer()
    w.array(
        list(topics.items()),
        lambda w, kv: w.string(kv[0]).i32(kv[1]).i16(1).i32(0).i32(0),
    )
    w.i32(timeout_ms)
    return w.build()


def dec_create_topics_req(r: Reader) -> dict[str, int]:
    topics: dict[str, int] = {}
    for _ in range(r.i32()):
        name = r.string()
        nparts = r.i32()
        r.i16()  # replication
        r.i32()  # assignments (empty)
        r.i32()  # configs (empty)
        topics[name] = nparts
    r.i32()  # timeout
    return topics


def enc_create_topics_resp(topics: dict[str, int]) -> bytes:
    """topics: {name: error}"""
    w = Writer()
    w.array(list(topics.items()), lambda w, kv: w.string(kv[0]).i16(kv[1]))
    return w.build()


def dec_create_topics_resp(r: Reader) -> dict[str, int]:
    return {name: err for name, err in (
        (r.string(), r.i16()) for _ in range(r.i32())
    )}


def enc_delete_topics_req(topics: list[str], timeout_ms: int = 5000) -> bytes:
    return Writer().array(topics, lambda w, t: w.string(t)).i32(timeout_ms).build()


def dec_delete_topics_req(r: Reader) -> list[str]:
    topics = r.array(Reader.string)
    r.i32()
    return topics


def enc_delete_topics_resp(topics: dict[str, int]) -> bytes:
    w = Writer()
    w.array(list(topics.items()), lambda w, kv: w.string(kv[0]).i16(kv[1]))
    return w.build()


def dec_delete_topics_resp(r: Reader) -> dict[str, int]:
    return {name: err for name, err in (
        (r.string(), r.i16()) for _ in range(r.i32())
    )}
