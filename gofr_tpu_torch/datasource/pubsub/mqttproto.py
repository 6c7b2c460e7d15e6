"""MQTT 3.1.1 wire codec (counterpart of
gofr_tpu/datasource/pubsub/mqttproto.py, byte for byte; OASIS spec sections
2-3).

Shared by the client backend (mqtt.py) and the in-process fake broker
(testutil/fakemqtt.py). The packets the framework needs: CONNECT/CONNACK,
PUBLISH/PUBACK (QoS 0/1), SUBSCRIBE/SUBACK, UNSUBSCRIBE/UNSUBACK,
PINGREQ/PINGRESP, DISCONNECT; ``read_packet_from`` bounds the size of a
packet it will read.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

__all__ = [
    "CONNECT", "CONNACK", "PUBLISH", "PUBACK", "SUBSCRIBE", "SUBACK",
    "UNSUBSCRIBE", "UNSUBACK", "PINGREQ", "PINGRESP", "DISCONNECT",
    "Packet", "encode_remaining_length", "read_packet_from",
    "connect_packet", "connack_packet", "publish_packet", "puback_packet",
    "subscribe_packet", "suback_packet", "unsubscribe_packet",
    "unsuback_packet", "pingreq_packet", "pingresp_packet",
    "disconnect_packet", "parse_connect", "parse_connack", "parse_publish",
    "parse_packet_id", "parse_subscribe", "parse_suback", "parse_unsubscribe",
    "topic_matches",
]

CONNECT, CONNACK, PUBLISH, PUBACK = 1, 2, 3, 4
SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK = 8, 9, 10, 11
PINGREQ, PINGRESP, DISCONNECT = 12, 13, 14


@dataclass
class Packet:
    type: int
    flags: int
    body: bytes = b""

    @property
    def qos(self) -> int:  # PUBLISH fixed-header QoS bits
        return (self.flags >> 1) & 0x3

    @property
    def retain(self) -> bool:
        return bool(self.flags & 0x1)

    @property
    def dup(self) -> bool:
        return bool(self.flags & 0x8)


def _str(s: str | bytes) -> bytes:
    b = s.encode() if isinstance(s, str) else s
    return struct.pack(">H", len(b)) + b


def encode_remaining_length(n: int) -> bytes:
    """Spec 2.2.3 variable-length encoding (7 bits per byte, MSB=continue)."""
    out = bytearray()
    while True:
        d, n = n % 128, n // 128
        out.append(d | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _frame(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + encode_remaining_length(len(body)) + body


def read_packet_from(recv_exact, max_size: int = 16 << 20) -> Packet:
    """Read one packet using recv_exact(n) -> bytes (socket or buffer).

    max_size caps the declared body (default 16 MiB): the spec's varint
    admits 256 MB, and a malicious/corrupt peer must not be able to make
    the reader attempt that allocation."""
    h = recv_exact(1)[0]
    mult, n, i = 1, 0, 0
    while True:
        d = recv_exact(1)[0]
        n += (d & 0x7F) * mult
        mult *= 128
        i += 1
        if not d & 0x80:
            break
        if i > 3:
            raise ValueError("malformed MQTT remaining length")
    if n > max_size:
        raise ValueError(f"MQTT packet of {n} bytes exceeds cap {max_size}")
    return Packet(type=h >> 4, flags=h & 0xF, body=recv_exact(n) if n else b"")


# -- packet builders --------------------------------------------------------

def connect_packet(
    client_id: str, *, keepalive: int = 60, clean_session: bool = True,
    username: str = "", password: str = "",
) -> bytes:
    flags = 0x02 if clean_session else 0
    # [MQTT-3.1.2-22]: the password flag requires the username flag, so a
    # password-only config still carries an (empty) username field.
    has_user = bool(username) or bool(password)
    if has_user:
        flags |= 0x80
    if password:
        flags |= 0x40
    body = _str("MQTT") + bytes([4, flags]) + struct.pack(">H", keepalive)
    body += _str(client_id)
    if has_user:
        body += _str(username)
    if password:
        body += _str(password)
    return _frame(CONNECT, 0, body)


def connack_packet(session_present: bool = False, code: int = 0) -> bytes:
    return _frame(CONNACK, 0, bytes([1 if session_present else 0, code]))


def publish_packet(
    topic: str, payload: bytes, *, qos: int = 0, packet_id: int = 0,
    retain: bool = False, dup: bool = False,
) -> bytes:
    flags = (0x8 if dup else 0) | (qos << 1) | (0x1 if retain else 0)
    body = _str(topic)
    if qos > 0:
        body += struct.pack(">H", packet_id)
    return _frame(PUBLISH, flags, body + payload)


def puback_packet(packet_id: int) -> bytes:
    return _frame(PUBACK, 0, struct.pack(">H", packet_id))


def subscribe_packet(packet_id: int, topics: list[tuple[str, int]]) -> bytes:
    body = struct.pack(">H", packet_id)
    for t, qos in topics:
        body += _str(t) + bytes([qos])
    return _frame(SUBSCRIBE, 0x2, body)  # spec 3.8.1: reserved flags 0010


def suback_packet(packet_id: int, codes: list[int]) -> bytes:
    return _frame(SUBACK, 0, struct.pack(">H", packet_id) + bytes(codes))


def unsubscribe_packet(packet_id: int, topics: list[str]) -> bytes:
    body = struct.pack(">H", packet_id)
    for t in topics:
        body += _str(t)
    return _frame(UNSUBSCRIBE, 0x2, body)


def unsuback_packet(packet_id: int) -> bytes:
    return _frame(UNSUBACK, 0, struct.pack(">H", packet_id))


def pingreq_packet() -> bytes:
    return _frame(PINGREQ, 0, b"")


def pingresp_packet() -> bytes:
    return _frame(PINGRESP, 0, b"")


def disconnect_packet() -> bytes:
    return _frame(DISCONNECT, 0, b"")


# -- packet parsers ---------------------------------------------------------

class _Cursor:
    def __init__(self, b: bytes):
        self.b, self.i = b, 0

    def take(self, n: int) -> bytes:
        out = self.b[self.i : self.i + n]
        if len(out) < n:
            raise ValueError("truncated MQTT packet")
        self.i += n
        return out

    def u16(self) -> int:
        return struct.unpack(">H", self.take(2))[0]

    def string(self) -> str:
        return self.take(self.u16()).decode()

    def rest(self) -> bytes:
        out = self.b[self.i :]
        self.i = len(self.b)
        return out


@dataclass
class ConnectInfo:
    client_id: str
    keepalive: int
    clean_session: bool
    username: str = ""
    password: str = ""


def parse_connect(p: Packet) -> ConnectInfo:
    c = _Cursor(p.body)
    proto = c.string()
    level = c.take(1)[0]
    if proto not in ("MQTT", "MQIsdp") or level not in (3, 4):
        raise ValueError(f"unsupported MQTT protocol {proto!r} level {level}")
    flags = c.take(1)[0]
    keepalive = c.u16()
    client_id = c.string()
    username = c.string() if flags & 0x80 else ""
    password = c.string() if flags & 0x40 else ""
    return ConnectInfo(client_id, keepalive, bool(flags & 0x02), username, password)


def parse_connack(p: Packet) -> tuple[bool, int]:
    return bool(p.body[0] & 1), p.body[1]


@dataclass
class PublishInfo:
    topic: str
    payload: bytes
    qos: int
    packet_id: int = 0
    retain: bool = False
    dup: bool = False


def parse_publish(p: Packet) -> PublishInfo:
    c = _Cursor(p.body)
    topic = c.string()
    pid = c.u16() if p.qos > 0 else 0
    return PublishInfo(topic, c.rest(), p.qos, pid, p.retain, p.dup)


def parse_packet_id(p: Packet) -> int:
    return struct.unpack(">H", p.body[:2])[0]


@dataclass
class SubscribeInfo:
    packet_id: int
    topics: list[tuple[str, int]] = field(default_factory=list)


def parse_subscribe(p: Packet) -> SubscribeInfo:
    c = _Cursor(p.body)
    info = SubscribeInfo(c.u16())
    while c.i < len(p.body):
        t = c.string()
        info.topics.append((t, c.take(1)[0]))
    return info


def parse_suback(p: Packet) -> tuple[int, list[int]]:
    return struct.unpack(">H", p.body[:2])[0], list(p.body[2:])


def parse_unsubscribe(p: Packet) -> tuple[int, list[str]]:
    c = _Cursor(p.body)
    pid = c.u16()
    topics = []
    while c.i < len(p.body):
        topics.append(c.string())
    return pid, topics


def topic_matches(filter_: str, topic: str) -> bool:
    """MQTT topic filter match: '+' one level, '#' trailing multi-level."""
    fparts, tparts = filter_.split("/"), topic.split("/")
    for i, fp in enumerate(fparts):
        if fp == "#":
            return True
        if i >= len(tparts):
            return False
        if fp != "+" and fp != tparts[i]:
            return False
    return len(fparts) == len(tparts)
