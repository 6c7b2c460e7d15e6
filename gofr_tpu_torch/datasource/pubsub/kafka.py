"""Kafka pub/sub backend: a protocol client over TCP (counterpart of
gofr_tpu/datasource/pubsub/kafka.py, the same config keys, defaults, errors
and metric names).

- **Batched producer**: messages buffer until KAFKA_BATCH_SIZE messages /
  KAFKA_BATCH_BYTES bytes / KAFKA_BATCH_TIMEOUT ms (defaults 100 / 1 MiB /
  1000 ms), then flush as one Produce request per partition leader; a
  failed produce is requeued, and KAFKA_MAX_BUFFER caps the buffer.
- **Consumer with committed offsets**: a reader per (group, topic), made
  at the first subscribe; its start comes from OffsetFetch, else
  KAFKA_START_OFFSET (earliest/latest); ``Message.commit()`` commits
  offset+1 through OffsetCommit, so an uncommitted record is redelivered.
- **create_topic / delete_topic** against the controller; publish creates
  an unknown topic once (auto-create), with KAFKA_PARTITIONS partitions.
- **Health**: a metadata round trip to the bootstrap broker.
- **Auth**: SASL PLAIN / SCRAM-SHA-256 / SCRAM-SHA-512
  (KAFKA_SASL_MECHANISM, _USERNAME, _PASSWORD) and TLS (KAFKA_TLS,
  KAFKA_TLS_CA_CERT, KAFKA_TLS_INSECURE); every new socket negotiates
  ApiVersions and authenticates before any request rides it.

Transport: blocking sockets and a lock per broker, driven from worker
threads; the async publish/subscribe facade runs them in the executor.
One consumer per group ("simple consumer": commits with generation -1);
group rebalancing is not implemented.
"""

from __future__ import annotations

import collections
import socket
import struct
import threading
import time

from .. import STATUS_DOWN, STATUS_UP, health
from . import Message, _BasePubSub
from . import kafkaproto as kp

__all__ = ["KafkaPubSub", "KafkaConfig"]

_FETCH_BACKOFF_S = 0.005  # the least time between two fetches of one topic that found nothing


class KafkaError(Exception):
    def __init__(self, code: int, what: str = ""):
        super().__init__(f"kafka error {code}{f' ({what})' if what else ''}")
        self.code = code


class KafkaConfig:
    def __init__(self, config):
        self.brokers = [
            hp.strip()
            for hp in (config.get("PUBSUB_BROKER") or "localhost:9092").split(",")
        ]
        # SASL (PLAIN / SCRAM-SHA-256 / SCRAM-SHA-512) and TLS
        self.sasl_mechanism = config.get("KAFKA_SASL_MECHANISM") or None
        self.sasl_username = config.get("KAFKA_SASL_USERNAME") or None
        self.sasl_password = config.get("KAFKA_SASL_PASSWORD") or None
        from .. import tls_from_config

        self.tls = tls_from_config(config, "KAFKA")
        self.group = config.get_or_default("KAFKA_CONSUMER_GROUP", "gofr-consumer")
        self.batch_size = int(config.get_or_default("KAFKA_BATCH_SIZE", "100"))
        self.batch_bytes = int(config.get_or_default("KAFKA_BATCH_BYTES", str(1 << 20)))
        self.batch_timeout_ms = int(config.get_or_default("KAFKA_BATCH_TIMEOUT", "1000"))
        self.start_offset = config.get_or_default("KAFKA_START_OFFSET", "earliest")
        self.partitions = int(config.get_or_default("KAFKA_PARTITIONS", "1"))
        self.client_id = config.get_or_default("APP_NAME", "gofr-tpu")
        # producer-buffer cap: with all brokers down, retries must not grow
        # the buffer unboundedly (OOM); publish raises once it is full
        self.max_buffer = int(config.get_or_default("KAFKA_MAX_BUFFER", "10000"))


class _Broker:
    """One TCP connection to one broker, request/response under a lock.
    On (re)connect: optional TLS wrap, ApiVersions negotiation, then the
    configured SASL exchange — so every fresh socket is authenticated
    before any caller's request rides it."""

    def __init__(
        self,
        host: str,
        port: int,
        client_id: str,
        timeout: float = 10.0,
        *,
        tls=None,
        sasl: tuple[str, str, str] | None = None,  # (mechanism, user, pass)
    ):
        self.host, self.port = host, port
        self.client_id = client_id
        self.timeout = timeout
        self.tls = tls
        self.sasl = sasl
        self.api_versions: dict[int, tuple[int, int]] = {}
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self._corr = 0

    def _connect(self) -> None:
        if self._sock is not None:
            return
        s = socket.create_connection((self.host, self.port), timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        from .. import wrap_tls

        s = wrap_tls(s, self.tls, self.host)
        self._sock = s
        try:
            self._handshake()
        except BaseException:
            # never cache a half-initialized (unauthenticated) socket
            try:
                s.close()
            finally:
                self._sock = None
            raise

    def _raw_call(self, api_key: int, api_version: int, body: bytes) -> kp.Reader:
        """Request/response on the freshly dialed socket, used only from
        _connect (the caller already holds the lock)."""
        self._corr += 1
        corr = self._corr
        self._sock.sendall(
            kp.encode_request(api_key, api_version, corr, self.client_id, body)
        )
        size = struct.unpack(">i", self._recv_exact(4))[0]
        r = kp.Reader(self._recv_exact(size))
        got = r.i32()
        if got != corr:
            raise ConnectionError(f"kafka correlation mismatch {got} != {corr}")
        return r

    def _handshake(self) -> None:
        _err, self.api_versions = kp.dec_api_versions_resp(
            self._raw_call(kp.API_VERSIONS, 0, kp.enc_api_versions_req())
        )
        if self.sasl is None:
            return
        mechanism, user, password = self.sasl
        err, offered = kp.dec_sasl_handshake_resp(
            self._raw_call(
                kp.SASL_HANDSHAKE, 1, kp.enc_sasl_handshake_req(mechanism)
            )
        )
        if err != kp.NONE:
            raise KafkaError(err, f"sasl handshake ({mechanism} not in {offered})")

        def auth_round(payload: bytes) -> bytes:
            aerr, msg, out = kp.dec_sasl_authenticate_resp(
                self._raw_call(
                    kp.SASL_AUTHENTICATE, 0, kp.enc_sasl_authenticate_req(payload)
                )
            )
            if aerr != kp.NONE:
                raise KafkaError(aerr, f"sasl authenticate: {msg}")
            return out

        if mechanism == "PLAIN":
            auth_round(b"\x00" + user.encode() + b"\x00" + password.encode())
        elif mechanism in ("SCRAM-SHA-256", "SCRAM-SHA-512"):
            from ..scram import ScramClient

            client = ScramClient(mechanism, user, password)
            server_first = auth_round(client.first_message().encode())
            server_final = auth_round(
                client.process_server_first(server_first.decode()).encode()
            )
            client.verify_server_final(server_final.decode())
        else:
            raise KafkaError(
                kp.UNSUPPORTED_SASL_MECHANISM, f"unsupported {mechanism!r}"
            )

    def supports(self, api_key: int, version: int) -> bool:
        lo_hi = self.api_versions.get(api_key)
        return lo_hi is not None and lo_hi[0] <= version <= lo_hi[1]

    def uses_v2_records(self) -> bool:
        """Modern record batches need Produce>=3 and Fetch>=4. An empty
        api_versions map (socket not yet dialed) resolves on first call."""
        return self.supports(kp.PRODUCE, 3) and self.supports(kp.FETCH, 4)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("kafka broker closed connection")
            buf += chunk
        return buf

    def ensure_connected(self) -> None:
        """Dial (and negotiate versions / authenticate) if needed, so
        api_versions is populated before a caller picks a wire format."""
        with self._lock:
            self._connect()

    def call(self, api_key: int, api_version: int, body: bytes) -> kp.Reader:
        with self._lock:
            try:
                self._connect()
                self._corr += 1
                corr = self._corr
                self._sock.sendall(
                    kp.encode_request(api_key, api_version, corr, self.client_id, body)
                )
                size = struct.unpack(">i", self._recv_exact(4))[0]
                payload = self._recv_exact(size)
            except (OSError, ConnectionError):
                self._drop()
                raise
        r = kp.Reader(payload)
        got = r.i32()
        if got != corr:
            self.close()
            raise ConnectionError(f"kafka correlation mismatch {got} != {corr}")
        return r

    def close(self) -> None:
        with self._lock:
            self._drop()

    def _drop(self) -> None:
        """Close the socket; the caller holds the lock."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class KafkaPubSub(_BasePubSub):
    # the fetch position moves past what was handed out: an uncommitted
    # record comes back only to the group's next consumer
    redelivers_uncommitted = False

    def __init__(self, cfg: KafkaConfig, logger=None, metrics=None):
        super().__init__(logger, metrics)
        self.cfg = cfg
        self._brokers: dict[tuple[str, int], _Broker] = {}
        self._meta: dict[str, dict[int, int]] = {}  # topic -> {pid: leader node}
        self._nodes: dict[int, tuple[str, int]] = {}
        self._controller: int | None = None
        self._meta_lock = threading.Lock()
        # producer batch buffer
        self._buf: list[tuple[str, bytes]] = []
        self._buf_bytes = 0
        self._inflight_flush = 0  # popped for sending, still counted vs cap
        self._buf_lock = threading.Lock()
        # one flush at a time: a flush that returns has seen every message
        # published before it either acknowledged by the broker or raised,
        # never still in another thread's send
        self._flush_lock = threading.Lock()
        self._flush_evt = threading.Event()
        self._closed = False
        self._rr = 0  # partition round-robin cursor
        # consumer state: {topic: {pid: next_offset}} + locally buffered records
        self._offsets: dict[str, dict[int, int]] = {}
        self._pending: dict[str, collections.deque] = {}
        self._sub_lock = threading.Lock()
        # the commit watermark per (topic, pid): offsets handed out and not
        # committed, the end of what was handed out, the position last
        # committed; commits are sent in order under _commit_lock
        self._outstanding: dict[tuple[str, int], set[int]] = {}
        self._handed: dict[tuple[str, int], int] = {}
        self._committed: dict[tuple[str, int], int] = {}
        self._commit_lock = threading.Lock()
        self._coord: _Broker | None = None
        self._flusher = threading.Thread(
            target=self._flush_loop, name="kafka-flusher", daemon=True
        )
        self._flusher.start()

    # -- connections / metadata -------------------------------------------
    def _broker_at(self, host: str, port: int) -> _Broker:
        key = (host, port)
        with self._meta_lock:  # one _Broker (one socket) an address
            b = self._brokers.get(key)
            if b is None:
                sasl = None
                if self.cfg.sasl_mechanism:
                    sasl = (
                        self.cfg.sasl_mechanism,
                        self.cfg.sasl_username or "",
                        self.cfg.sasl_password or "",
                    )
                b = self._brokers[key] = _Broker(
                    host, port, self.cfg.client_id, tls=self.cfg.tls, sasl=sasl
                )
            return b

    def _bootstrap(self) -> _Broker:
        last: Exception | None = None
        for hp in self.cfg.brokers:
            host, _, port = hp.partition(":")
            try:
                b = self._broker_at(host, int(port or 9092))
                # under the broker's lock: JAX's client dials here without
                # it, and consumers starting together interleave their
                # handshakes on one socket (mismatched correlation ids, or a
                # read that waits out the 10 s timeout: ROADMAP queue 3
                # item 48)
                b.ensure_connected()
                return b
            except OSError as e:
                last = e
        raise ConnectionError(f"no kafka broker reachable: {last}")

    def _refresh_metadata(self, topics: list[str] | None = None) -> None:
        r = self._bootstrap().call(kp.METADATA, 1, kp.enc_metadata_req(topics))
        meta = kp.dec_metadata_resp(r)
        with self._meta_lock:
            self._nodes.update(meta["brokers"])
            self._controller = meta["controller"]
            for name, t in meta["topics"].items():
                if t["error"] == kp.NONE:
                    self._meta[name] = {
                        p["id"]: p["leader"] for p in t["partitions"]
                    }

    def _leader(self, topic: str, pid: int) -> _Broker:
        with self._meta_lock:
            node = self._meta.get(topic, {}).get(pid)
            addr = self._nodes.get(node)
        if addr is None:
            self._refresh_metadata([topic])
            with self._meta_lock:
                node = self._meta.get(topic, {}).get(pid)
                addr = self._nodes.get(node)
            if addr is None:
                raise KafkaError(kp.UNKNOWN_TOPIC_OR_PARTITION, f"{topic}/{pid}")
        return self._broker_at(*addr)

    def _partitions(self, topic: str, create: bool = True) -> list[int]:
        with self._meta_lock:
            parts = self._meta.get(topic)
        if parts is None:
            self._refresh_metadata([topic])
            with self._meta_lock:
                parts = self._meta.get(topic)
        if parts is None and create:
            self.create_topic(topic)
            self._refresh_metadata([topic])
            with self._meta_lock:
                parts = self._meta.get(topic)
        if parts is None:
            raise KafkaError(kp.UNKNOWN_TOPIC_OR_PARTITION, topic)
        return sorted(parts)

    # -- producer ----------------------------------------------------------
    async def publish(self, topic: str, value: bytes | str) -> None:
        import asyncio

        await asyncio.get_running_loop().run_in_executor(
            None, self.publish_sync, topic, value
        )

    def publish_sync(self, topic: str, value: bytes | str) -> None:
        """Buffer the message for the batched producer. The publish-total
        counter increments here; publish-SUCCESS increments only when the
        produce response confirms delivery (_flush) — counting success at
        buffer time would report messages a dead broker later drops."""
        raw = value if isinstance(value, bytes) else str(value).encode()
        with self._buf_lock:
            if len(self._buf) + self._inflight_flush >= self.cfg.max_buffer:
                if self.metrics is not None:
                    self.metrics.increment_counter(
                        "app_pubsub_publish_total_count", topic=topic
                    )
                raise KafkaError(
                    kp.REQUEST_TIMED_OUT,
                    f"producer buffer full ({self.cfg.max_buffer} messages) — "
                    "brokers unreachable?",
                )
            self._buf.append((topic, raw))
            self._buf_bytes += len(raw)
            full = (
                len(self._buf) >= self.cfg.batch_size
                or self._buf_bytes >= self.cfg.batch_bytes
            )
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_total_count", topic=topic)
        if self.logger is not None:
            self.logger.debug({"mode": "PUB", "topic": topic, "bytes": len(raw)})
        if full:
            self._flush()

    def _flush_loop(self) -> None:
        interval = max(0.01, self.cfg.batch_timeout_ms / 1000.0)
        while not self._closed:
            self._flush_evt.wait(interval)
            self._flush_evt.clear()
            try:
                self._flush()
            except Exception as e:  # noqa: BLE001
                if self.logger is not None:
                    self.logger.error(f"kafka flush failed: {e!r}")

    def flush(self) -> None:
        """Drain the producer buffer: on return every message published
        before the call is on the broker, or this raised (it is then back
        in the buffer). The batch tier calls it before committing a job."""
        self._flush()

    def _flush(self) -> None:
        with self._flush_lock:
            with self._buf_lock:
                batch, self._buf = self._buf, []
                self._buf_bytes = 0
                # messages popped for sending still occupy cap space: a
                # publish arriving mid-flush must not fill the room a failed
                # send will reclaim via _requeue (accepted messages are
                # never dropped)
                self._inflight_flush += len(batch)
            if not batch:
                return
            try:
                self._flush_batch(batch)
            finally:
                with self._buf_lock:
                    self._inflight_flush -= len(batch)

    def _flush_batch(self, batch: list[tuple[str, bytes]]) -> None:
        # group by (leader broker) -> {topic: {pid: [(topic, raw)]}}
        by_tp: dict[str, dict[int, list[tuple[str, bytes]]]] = {}
        try:
            for topic, raw in batch:
                parts = self._partitions(topic)
                pid = parts[self._rr % len(parts)]
                self._rr += 1
                by_tp.setdefault(topic, {}).setdefault(pid, []).append((topic, raw))
        except Exception:
            self._requeue(batch)  # metadata failure: nothing sent yet
            raise
        by_leader: dict[_Broker, dict[str, dict[int, list[tuple[str, bytes]]]]] = {}
        for topic, parts in by_tp.items():
            for pid, originals in parts.items():
                try:
                    broker = self._leader(topic, pid)
                except Exception:
                    self._requeue(originals)
                    raise
                by_leader.setdefault(broker, {}).setdefault(topic, {})[pid] = originals
        first_err: Exception | None = None
        for broker, topics in by_leader.items():
            try:
                broker.ensure_connected()  # api_versions drives the format
            except (OSError, ConnectionError, KafkaError) as e:
                for parts in topics.values():
                    for originals in parts.values():
                        self._requeue(originals)
                first_err = first_err or e
                continue
            use_v2 = broker.uses_v2_records()
            now_ms = int(time.time() * 1000)

            def to_wire(originals):
                records = [
                    kp.Record(key=None, value=raw, timestamp=now_ms)
                    for _t, raw in originals
                ]
                return (
                    kp.encode_record_batch(records)
                    if use_v2
                    else kp.encode_message_set(records)
                )

            wire = {
                t: {pid: to_wire(originals) for pid, originals in parts.items()}
                for t, parts in topics.items()
            }
            try:
                # KafkaError included: broker.call can redial and re-run
                # the SASL handshake mid-flush (another thread closed the
                # shared socket); an auth failure there must requeue too
                if use_v2:
                    r = broker.call(
                        kp.PRODUCE, 3, kp.enc_produce_req_v3(1, 5000, wire)
                    )
                else:
                    r = broker.call(kp.PRODUCE, 2, kp.enc_produce_req(1, 5000, wire))
                resp = kp.dec_produce_resp(r)
                for topic, parts in resp.items():
                    for pid, (err, _base) in parts.items():
                        if err != kp.NONE:
                            if err == kp.NOT_LEADER_FOR_PARTITION:
                                self._refresh_metadata([topic])
                            # requeue just this partition's messages for retry
                            self._requeue(topics[topic][pid])
                            first_err = first_err or KafkaError(
                                err, f"produce {topic}/{pid}"
                            )
                        elif self.metrics is not None:
                            # delivery confirmed: NOW count success
                            self.metrics.increment_counter(
                                "app_pubsub_publish_success_count",
                                by=len(topics[topic][pid]), topic=topic,
                            )
            except (OSError, ConnectionError, KafkaError) as e:
                # transport failure: requeue everything aimed at this broker;
                # other leaders' sends proceed (at-least-once, never drop)
                for topic, parts in topics.items():
                    for originals in parts.values():
                        self._requeue(originals)
                first_err = first_err or e
        if first_err is not None:
            raise first_err

    def _requeue(self, originals: list[tuple[str, bytes]]) -> None:
        """Put unsent messages back at the head. Never drops: the cap is
        enforced at publish time against buffered + in-flight counts, so a
        requeue can at most restore the buffer to its pre-flush size."""
        with self._buf_lock:
            self._buf = list(originals) + self._buf
            self._buf_bytes = sum(len(raw) for _t, raw in self._buf)

    # -- consumer ----------------------------------------------------------
    def _init_offsets(self, topic: str) -> None:
        """Lazy reader init: committed offsets for the
        group, else earliest/latest per KAFKA_START_OFFSET."""
        parts = self._partitions(topic)
        b = self._coordinator()
        r = b.call(kp.OFFSET_FETCH, 1, kp.enc_offset_fetch_req(self.cfg.group, {topic: parts}))
        fetched = kp.dec_offset_fetch_resp(r).get(topic, {})
        missing = [p for p in parts if fetched.get(p, (-1, 0))[0] < 0]
        offsets = {p: off for p, (off, err) in fetched.items() if off >= 0 and err == 0}
        if missing:
            ts = kp.EARLIEST if self.cfg.start_offset == "earliest" else kp.LATEST
            for pid in missing:
                lr = self._leader(topic, pid).call(
                    kp.LIST_OFFSETS, 1, kp.enc_list_offsets_req({topic: {pid: ts}})
                )
                err, off = kp.dec_list_offsets_resp(lr)[topic][pid]
                if err != kp.NONE:
                    raise KafkaError(err, f"list_offsets {topic}/{pid}")
                offsets[pid] = off
        with self._sub_lock:
            self._offsets[topic] = offsets
            self._pending.setdefault(topic, collections.deque())
            for pid, off in offsets.items():
                self._committed[(topic, pid)] = self._handed[(topic, pid)] = off
                self._outstanding[(topic, pid)] = set()

    def _coordinator(self) -> _Broker:
        # cached — FindCoordinator per commit would double the hot-path RPCs;
        # invalidated on commit failure (_next_pending's committer)
        if self._coord is not None:
            return self._coord
        r = self._bootstrap().call(
            kp.FIND_COORDINATOR, 0, kp.enc_find_coordinator_req(self.cfg.group)
        )
        err, _node, host, port = kp.dec_find_coordinator_resp(r)
        if err != kp.NONE:
            raise KafkaError(err, "find_coordinator")
        self._coord = self._broker_at(host, port)
        return self._coord

    def _fetch_once(self, topic: str, max_wait_ms: int = 200) -> None:
        with self._sub_lock:
            offsets = dict(self._offsets.get(topic, {}))
        if not offsets:
            return
        req: dict[int, tuple[int, int]] = {p: (o, 1 << 20) for p, o in offsets.items()}
        # partitions may have different leaders; fetch from each
        by_leader: dict[_Broker, dict[int, tuple[int, int]]] = {}
        for pid, po in req.items():
            by_leader.setdefault(self._leader(topic, pid), {})[pid] = po
        for broker, parts in by_leader.items():
            broker.ensure_connected()
            if broker.uses_v2_records():
                r = broker.call(
                    kp.FETCH, 4,
                    kp.enc_fetch_req_v4(max_wait_ms, 1, 1 << 25, {topic: parts}),
                )
                resp = kp.dec_fetch_resp_v4(r).get(topic, {})
            else:
                r = broker.call(
                    kp.FETCH, 2, kp.enc_fetch_req(max_wait_ms, 1, {topic: parts})
                )
                resp = kp.dec_fetch_resp(r).get(topic, {})
            for pid, p in resp.items():
                if p["error"] == kp.OFFSET_OUT_OF_RANGE:
                    # log truncated under us: restart from the configured edge
                    ts = kp.EARLIEST if self.cfg.start_offset == "earliest" else kp.LATEST
                    lr = broker.call(
                        kp.LIST_OFFSETS, 1, kp.enc_list_offsets_req({topic: {pid: ts}})
                    )
                    _e, off = kp.dec_list_offsets_resp(lr)[topic][pid]
                    with self._sub_lock:
                        self._offsets[topic][pid] = off
                    continue
                if p["error"] != kp.NONE:
                    raise KafkaError(p["error"], f"fetch {topic}/{pid}")
                records = kp.decode_records(p["records"])  # sniffs v1 vs v2
                # brokers may return records below the requested offset
                # (message-set alignment); drop them
                records = [rec for rec in records if rec.offset >= offsets[pid]]
                if records:
                    with self._sub_lock:
                        self._offsets[topic][pid] = records[-1].offset + 1
                        self._pending[topic].extend((pid, rec) for rec in records)

    def _next_pending(self, topic: str) -> Message | None:
        with self._sub_lock:
            q = self._pending.get(topic)
            if not q:
                return None
            pid, rec = q.popleft()
            key = (topic, pid)
            self._outstanding.setdefault(key, set()).add(rec.offset)
            self._handed[key] = max(self._handed.get(key, 0), rec.offset + 1)
        group = self.cfg.group

        def committer() -> None:
            # Kafka commits a position, not a record: commit the lowest
            # offset still handed out (else the end of what was handed
            # out), and only forward. Committing offset+1 as each record
            # completes, as JAX's client does, moves the position back when
            # records complete out of order and past records still running
            # (ROADMAP queue 3 item 43).
            with self._commit_lock:
                with self._sub_lock:
                    out = self._outstanding.setdefault(key, set())
                    out.discard(rec.offset)
                    pos = min(out) if out else self._handed[key]
                if pos <= self._committed.get(key, -1):
                    return
                try:
                    b = self._coordinator()
                    r = b.call(
                        kp.OFFSET_COMMIT, 2,
                        kp.enc_offset_commit_req(group, {topic: {pid: pos}}),
                    )
                    errs = kp.dec_offset_commit_resp(r).get(topic, {})
                    if errs.get(pid, 0) != kp.NONE:
                        raise KafkaError(errs[pid], f"offset_commit {topic}/{pid}")
                except Exception:
                    self._coord = None  # coordinator may have moved; re-resolve
                    raise
                self._committed[key] = pos

        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_pubsub_subscribe_total_count", topic=topic
            )
            self.metrics.increment_counter(
                "app_pubsub_subscribe_success_count", topic=topic
            )
        if self.logger is not None:
            self.logger.debug(
                {"mode": "SUB", "topic": topic, "partition": pid, "offset": rec.offset}
            )
        meta = {"partition": str(pid), "offset": str(rec.offset)}
        if rec.value is None:
            meta["tombstone"] = "true"  # compaction delete marker
        return Message(
            topic, rec.value if rec.value is not None else b"",
            metadata=meta,
            committer=committer,
        )

    def subscribe_sync(self, topic: str, timeout: float = 0.5) -> Message | None:
        deadline = time.monotonic() + timeout
        with self._sub_lock:
            ready = topic in self._offsets
        if not ready:
            self._init_offsets(topic)
        while True:
            msg = self._next_pending(topic)
            if msg is not None:
                return msg
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            t0 = time.monotonic()
            self._fetch_once(topic, max_wait_ms=int(min(remaining, 0.2) * 1000))
            if not self._pending.get(topic) and time.monotonic() - t0 < _FETCH_BACKOFF_S:
                # an empty fetch answered at once (a broker that does not
                # hold it for max_wait_ms): back off instead of spinning on
                # the connection's lock, which starves the producer and the
                # commits behind it (ROADMAP queue 3 item 47)
                time.sleep(min(_FETCH_BACKOFF_S, max(0.0, deadline - time.monotonic())))

    async def subscribe(self, topic: str, timeout: float = 0.5) -> Message | None:
        import asyncio

        return await asyncio.get_running_loop().run_in_executor(
            None, self.subscribe_sync, topic, timeout
        )

    # -- admin / lifecycle -------------------------------------------------
    def _controller_broker(self) -> _Broker:
        if self._controller is None:
            self._refresh_metadata()
        with self._meta_lock:
            addr = self._nodes.get(self._controller)
        if addr is None:
            raise ConnectionError("kafka controller unknown")
        return self._broker_at(*addr)

    def create_topic(self, topic: str) -> None:
        r = self._controller_broker().call(
            kp.CREATE_TOPICS, 0, kp.enc_create_topics_req({topic: self.cfg.partitions})
        )
        err = kp.dec_create_topics_resp(r).get(topic, 0)
        if err not in (kp.NONE, kp.TOPIC_ALREADY_EXISTS):
            raise KafkaError(err, f"create_topic {topic}")
        self._refresh_metadata([topic])

    def delete_topic(self, topic: str) -> None:
        r = self._controller_broker().call(
            kp.DELETE_TOPICS, 0, kp.enc_delete_topics_req([topic])
        )
        err = kp.dec_delete_topics_resp(r).get(topic, 0)
        if err not in (kp.NONE, kp.UNKNOWN_TOPIC_OR_PARTITION):
            raise KafkaError(err, f"delete_topic {topic}")
        with self._meta_lock:
            self._meta.pop(topic, None)
        with self._sub_lock:
            self._offsets.pop(topic, None)
            self._pending.pop(topic, None)
            for d in (self._outstanding, self._handed, self._committed):
                for key in [k for k in d if k[0] == topic]:
                    del d[key]

    def health(self) -> dict:
        try:
            t0 = time.perf_counter()
            self._refresh_metadata()
            with self._meta_lock:
                n_topics = len(self._meta)
                brokers = list(self._nodes.values())
            return health(
                STATUS_UP, backend="KAFKA",
                brokers=[f"{h}:{p}" for h, p in brokers],
                topics=n_topics,
                metadata_ms=round((time.perf_counter() - t0) * 1e3, 2),
            )
        except Exception as e:  # noqa: BLE001
            return health(
                STATUS_DOWN, backend="KAFKA",
                brokers=self.cfg.brokers, error=str(e),
            )

    def close(self) -> None:
        self._closed = True
        self._flush_evt.set()
        try:
            self._flush()
        except Exception:  # noqa: BLE001
            pass
        for b in self._brokers.values():
            b.close()
