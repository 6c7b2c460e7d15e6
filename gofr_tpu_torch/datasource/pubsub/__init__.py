"""Pub/sub datasource (counterpart of gofr_tpu/datasource/pubsub/__init__.py).

A transport-agnostic :class:`Message` whose :class:`SubscribeContextRequest`
gives subscribers the handler's request shape (``ctx.bind()`` reads the
payload), commit-on-success offsets, and the ``PUBSUB_BACKEND`` switch:

- MEMORY: in-process topics (delivery pops the record; commit is a no-op);
- FILE: an append-only JSONL log per topic, ``<dir>/<topic>.jsonl`` (one
  ``{"ts": ..., "value": ...}`` object a line), and the committed read
  position of a consumer group in ``<dir>/<topic>.<group>.offset``:
  durable, resumable, shared by the processes of one host, at least once
  (a record is served again until ``Message.commit()`` advances the
  offset). The files are the JAX package's, so a log written by either
  package is read by the other from its committed offset;
- KAFKA: a Kafka wire client (kafka.py): batched producer, consumer-group
  committed offsets, topic admin, SASL PLAIN/SCRAM and TLS;
- MQTT: an MQTT 3.1.1 client (mqtt.py): QoS 0/1, PUBACK on commit, a
  persistent session at QoS 1, reconnect with re-subscribe;
- GOOGLE: a Google Pub/Sub v1 client over gRPC (google.py): topic and
  subscription get-or-create, streaming or unary pull, ack on commit. It
  needs grpcio, imported when the client is built.
"""

from __future__ import annotations

import asyncio
import collections
import json
import os
import threading
import time
from typing import Any, Callable

from .. import STATUS_DOWN, STATUS_UP, health

__all__ = ["Message", "SubscribeContextRequest", "MemoryPubSub", "FilePubSub", "new_pubsub"]


class Message:
    """One delivered record; ``commit()`` acknowledges it."""

    def __init__(self, topic: str, value: bytes, *, metadata: dict | None = None,
                 committer: Callable[[], None] | None = None):
        self.topic = topic
        self.value = value if isinstance(value, bytes) else str(value).encode()
        self.metadata = metadata or {}
        self._committer = committer
        self.committed = False

    def commit(self) -> None:
        if self._committer is not None and not self.committed:
            self._committer()
        self.committed = True

    def __repr__(self) -> str:
        return f"Message(topic={self.topic!r}, {len(self.value)}B)"


class SubscribeContextRequest:
    """A Message in the handler's request shape, so a subscriber's Context
    reads it as an HTTP handler reads its request: ``bind()`` the payload,
    ``param`` / ``header`` the metadata, ``path_param("topic")``."""

    def __init__(self, msg: Message):
        self.msg = msg
        self.context: dict = {}

    def param(self, key: str) -> str:
        return self.msg.metadata.get(key, "")

    def params(self, key: str) -> list[str]:
        v = self.param(key)
        return [v] if v else []

    def path_param(self, key: str) -> str:
        return self.msg.topic if key == "topic" else ""

    def bind(self, target: Any = None) -> Any:
        data = json.loads(self.msg.value)
        if target is not None and hasattr(target, "__annotations__"):
            for k, v in data.items():
                if k in target.__annotations__:
                    setattr(target, k, v)
            return target
        return data

    def header(self, key: str) -> str:
        return self.msg.metadata.get(key, "")

    def host_name(self) -> str:
        return self.msg.topic


class _BasePubSub:
    """The publish counters and log line every backend shares."""

    # whether a consumer serves a record it handed out again while the
    # record stays uncommitted (FILE re-reads its committed offset)
    redelivers_uncommitted = True

    def __init__(self, logger=None, metrics=None):
        self.logger = logger
        self.metrics = metrics

    def _log_pub(self, topic: str, value: bytes, ok: bool) -> None:
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_total_count", topic=topic)
            if ok:
                self.metrics.increment_counter("app_pubsub_publish_success_count", topic=topic)
        if self.logger is not None:
            self.logger.debug({"mode": "PUB", "topic": topic, "bytes": len(value)})


class MemoryPubSub(_BasePubSub):
    """In-process topics. Thread-safe; ``subscribe`` waits on an executor
    thread, so a publisher on any thread wakes a subscriber on the app's
    loop."""

    def __init__(self, logger=None, metrics=None):
        super().__init__(logger, metrics)
        self._queues: dict[str, collections.deque] = {}
        self._cond = threading.Condition()
        self._closed = False

    async def publish(self, topic: str, value: bytes | str) -> None:
        self.publish_sync(topic, value)

    def publish_sync(self, topic: str, value: bytes | str) -> None:
        value = value if isinstance(value, bytes) else str(value).encode()
        with self._cond:
            self._queues.setdefault(topic, collections.deque()).append(value)
            self._cond.notify_all()
        self._log_pub(topic, value, True)

    def _pop_blocking(self, topic: str, timeout: float) -> bytes | None:
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                q = self._queues.setdefault(topic, collections.deque())
                if q:
                    return q.popleft()
                if self._closed:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)

    async def subscribe(self, topic: str, timeout: float = 0.5) -> Message | None:
        value = await asyncio.get_running_loop().run_in_executor(None, self._pop_blocking, topic, timeout)
        if value is None:
            return None
        return Message(topic, value)  # commit is a no-op: the pop consumed it

    def create_topic(self, topic: str) -> None:
        with self._cond:
            self._queues.setdefault(topic, collections.deque())

    def delete_topic(self, topic: str) -> None:
        with self._cond:
            self._queues.pop(topic, None)

    def health(self) -> dict:
        with self._cond:
            depths = {t: len(q) for t, q in self._queues.items()}
        return health(STATUS_UP, backend="MEMORY", topics=depths)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class FilePubSub(_BasePubSub):
    """A durable single-host log: ``<dir>/<topic>.jsonl`` plus
    ``<dir>/<topic>.<group>.offset`` holding the committed read position.
    ``subscribe`` returns the record at the committed offset; only
    ``Message.commit()`` advances it (consumer-group semantics)."""

    def __init__(self, directory: str, group: str = "default", logger=None, metrics=None):
        super().__init__(logger, metrics)
        self.dir = directory
        self.group = group
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        # {topic: (line offset, byte offset)}: seek straight to the
        # committed record instead of re-reading the log
        self._seek: dict[str, tuple[int, int]] = {}

    def _log_path(self, topic: str) -> str:
        return os.path.join(self.dir, f"{topic}.jsonl")

    def _offset_path(self, topic: str) -> str:
        return os.path.join(self.dir, f"{topic}.{self.group}.offset")

    def _committed(self, topic: str) -> int:
        try:
            with open(self._offset_path(topic)) as f:
                return int(f.read().strip() or 0)
        except FileNotFoundError:
            return 0

    def _commit(self, topic: str, offset: int) -> None:
        with self._lock:
            with open(self._offset_path(topic), "w") as f:
                f.write(str(offset))

    async def publish(self, topic: str, value: bytes | str) -> None:
        self.publish_sync(topic, value)

    def publish_sync(self, topic: str, value: bytes | str) -> None:
        raw = value if isinstance(value, bytes) else str(value).encode()
        rec = json.dumps({"ts": time.time(), "value": raw.decode("utf-8", "replace")})
        with self._lock:
            with open(self._log_path(topic), "a") as f:
                f.write(rec + "\n")
        self._log_pub(topic, raw, True)

    def _read_at(self, topic: str, offset: int) -> str | None:
        """The line at `offset`: read on from the cached byte position when
        the line is at or after it, else rescan once."""
        line_off, byte_off = self._seek.get(topic, (0, 0))
        if offset < line_off:
            line_off, byte_off = 0, 0
        try:
            with open(self._log_path(topic)) as f:
                f.seek(byte_off)
                while line_off < offset:
                    if not f.readline():
                        return None
                    line_off += 1
                pos = f.tell()
                line = f.readline()
                self._seek[topic] = (line_off, pos)
                return line if line else None
        except FileNotFoundError:
            return None

    async def subscribe(self, topic: str, timeout: float = 0.5) -> Message | None:
        deadline = time.monotonic() + timeout
        while True:
            offset = self._committed(topic)
            line = self._read_at(topic, offset)
            if line:
                rec = json.loads(line)
                return Message(topic, rec["value"].encode(), metadata={"offset": str(offset)},
                               committer=lambda: self._commit(topic, offset + 1))
            if time.monotonic() >= deadline:
                return None
            await asyncio.sleep(0.05)

    def create_topic(self, topic: str) -> None:
        open(self._log_path(topic), "a").close()

    def delete_topic(self, topic: str) -> None:
        for p in (self._log_path(topic), self._offset_path(topic)):
            try:
                os.remove(p)
            except FileNotFoundError:
                pass

    def health(self) -> dict:
        topics = {}
        try:
            for name in os.listdir(self.dir):
                if name.endswith(".jsonl"):
                    t = name[:-6]
                    with open(os.path.join(self.dir, name)) as f:
                        total = sum(1 for _ in f)
                    topics[t] = {"messages": total, "committed": self._committed(t)}
            return health(STATUS_UP, backend="FILE", dir=self.dir, topics=topics)
        except Exception as e:  # noqa: BLE001
            return health(STATUS_DOWN, backend="FILE", error=str(e))

    def close(self) -> None:
        pass


def new_pubsub(backend: str, config, logger=None, metrics=None):
    """The PUBSUB_BACKEND switch: MEMORY (or INMEM), FILE (PUBSUB_FILE_DIR,
    default ./pubsub-data; PUBSUB_GROUP, default "default"), KAFKA
    (``KafkaConfig``'s keys), MQTT (``MQTTConfig``'s keys) and GOOGLE
    (``GooglePubSub``'s keys)."""
    backend = backend.upper()
    if backend in ("MEMORY", "INMEM"):
        return MemoryPubSub(logger, metrics)
    if backend == "FILE":
        return FilePubSub(
            config.get_or_default("PUBSUB_FILE_DIR", "./pubsub-data"),
            group=config.get_or_default("PUBSUB_GROUP", "default"),
            logger=logger,
            metrics=metrics,
        )
    if backend == "KAFKA":
        from .kafka import KafkaConfig, KafkaPubSub

        return KafkaPubSub(KafkaConfig(config), logger=logger, metrics=metrics)
    if backend == "MQTT":
        from .mqtt import MQTTConfig, MQTTPubSub

        return MQTTPubSub(MQTTConfig(config), logger=logger, metrics=metrics)
    if backend == "GOOGLE":
        from .google import GooglePubSub

        return GooglePubSub(config, logger=logger, metrics=metrics)
    raise RuntimeError(f"unknown PUBSUB_BACKEND {backend!r}")
