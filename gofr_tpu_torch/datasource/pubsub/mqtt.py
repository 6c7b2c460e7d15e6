"""MQTT pub/sub backend: a 3.1.1 client over TCP (counterpart of
gofr_tpu/datasource/pubsub/mqtt.py, the same config keys, defaults and
metric names).

- connect options: host/port/client id/user/password/keepalive/QoS
  (MQTT_* keys, PUBSUB_BROKER as the fallback address; the session is
  clean by default at QoS 0 and persistent at QoS 1)
- publish with the configured QoS and the publish counters and logs
- subscribe: a queue per topic filled by a reader loop; the framework's
  ``App.subscribe`` runs on top of it
- unsubscribe, close, health
- commit on success: an inbound QoS 1 PUBACK is sent by
  ``Message.commit()``, so an uncommitted message is redelivered (at least
  once, as Kafka's OffsetCommit)

Transport: one socket; a reader thread dispatches inbound packets
(PUBLISH to the topic queues; SUBACK/UNSUBACK/PUBACK to the packet-id
waiters; PINGRESP), a keepalive thread sends PINGREQ at half the keepalive
interval, and writes go through a lock. On a socket failure the client
reconnects with backoff and subscribes its topics again.
"""

from __future__ import annotations

import collections
import os
import socket
import threading
import time

from .. import STATUS_DOWN, STATUS_UP, health
from . import Message, _BasePubSub
from . import mqttproto as mp

__all__ = ["MQTTPubSub", "MQTTConfig"]

# waiter sentinel: ack expected but result discarded (fire-and-forget
# subscribe) — the pid stays reserved until the ack arrives, then _handle
# pops it without waking anyone
_DISCARD = object()


class MQTTConfig:
    def __init__(self, config):
        broker = config.get("MQTT_HOST") or ""
        if not broker:
            # PUBSUB_BROKER host[:port] also accepted
            broker = (config.get("PUBSUB_BROKER") or "localhost").split(",")[0]
        if ":" in broker:
            broker, _, bport = broker.partition(":")
            port = int(bport)
        else:
            port = int(config.get_or_default("MQTT_PORT", "1883"))
        self.host, self.port = broker, port
        self.client_id = config.get_or_default(
            "MQTT_CLIENT_ID", f"gofr-tpu-{os.getpid()}"
        )
        self.username = config.get_or_default("MQTT_USER", "")
        self.password = config.get_or_default("MQTT_PASSWORD", "")
        self.qos = int(config.get_or_default("MQTT_QOS", "1"))
        self.keepalive = int(config.get_or_default("MQTT_KEEPALIVE", "30"))
        self.timeout = float(config.get_or_default("MQTT_TIMEOUT", "10"))
        # QoS 1 needs a persistent session (clean_session=False + stable
        # client id) for the broker to redeliver unacked messages after a
        # reconnect — the at-least-once half of commit-on-success.
        self.clean_session = (
            config.get_or_default("MQTT_CLEAN_SESSION", "") .lower() in ("1", "true")
            if config.get("MQTT_CLEAN_SESSION")
            else self.qos == 0
        )
        # TLS (mqtts, typically port 8883): MQTT_TLS / _TLS_CA_CERT /
        # _TLS_INSECURE env convention, or assign an SSLContext directly
        from .. import tls_from_config

        self.tls = tls_from_config(config, "MQTT")


class MQTTPubSub(_BasePubSub):
    # the broker sends an unacknowledged QoS 1 message again only when the
    # session reconnects
    redelivers_uncommitted = False

    def __init__(self, cfg: MQTTConfig, logger=None, metrics=None):
        super().__init__(logger, metrics)
        self.cfg = cfg
        self._sock: socket.socket | None = None
        self._wlock = threading.Lock()  # serializes writes to the socket
        self._conn_lock = threading.Lock()  # serializes (re)connect attempts
        self._cond = threading.Condition()  # guards queues/waiters/state
        self._queues: dict[str, collections.deque] = {}
        self._subscribed: dict[str, int] = {}  # topic -> granted qos
        self._waiters: dict[int, mp.Packet | None] = {}
        self._pid = 0
        self._closed = False
        self._connected = False
        self._last_error: str | None = None
        self._reader: threading.Thread | None = None
        self._pinger: threading.Thread | None = None
        try:
            self._connect()
        except OSError as e:
            # construction succeeds, health reports DOWN, and calls retry
            # the connection
            self._last_error = str(e)
            if self.logger is not None:
                self.logger.error(
                    f"could not connect to MQTT at {cfg.host}:{cfg.port}: {e}"
                )

    # -- connection management -------------------------------------------
    def _connect(self) -> None:
        with self._conn_lock:
            self._connect_locked()

    def _connect_locked(self) -> None:
        with self._cond:
            if self._connected or self._closed:
                return
        s = socket.create_connection((self.cfg.host, self.cfg.port), timeout=self.cfg.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        from .. import wrap_tls

        s = wrap_tls(s, self.cfg.tls, self.cfg.host)
        s.sendall(
            mp.connect_packet(
                self.cfg.client_id, keepalive=self.cfg.keepalive,
                clean_session=self.cfg.clean_session,
                username=self.cfg.username, password=self.cfg.password,
            )
        )
        p = mp.read_packet_from(lambda n: self._recv_exact_on(s, n))
        if p.type != mp.CONNACK:
            s.close()
            raise ConnectionError(f"expected CONNACK, got type {p.type}")
        _, code = mp.parse_connack(p)
        if code != 0:
            s.close()
            raise ConnectionError(f"MQTT CONNACK refused (code {code})")
        s.settimeout(None)
        with self._cond:
            self._sock = s
            self._connected = True
            self._last_error = None
        if self._reader is None or not self._reader.is_alive():
            self._reader = threading.Thread(
                target=self._read_loop, name="mqtt-reader", daemon=True
            )
            self._reader.start()
        if self._pinger is None or not self._pinger.is_alive():
            self._pinger = threading.Thread(
                target=self._ping_loop, name="mqtt-pinger", daemon=True
            )
            self._pinger.start()
        if self.logger is not None:
            self.logger.info(
                f"connected to MQTT at {self.cfg.host}:{self.cfg.port} "
                f"with clientID {self.cfg.client_id}"
            )
        # Resume existing subscriptions after a reconnect (SetResumeSubs).
        # wait=False: _connect may run ON the reader thread (reconnect
        # path), and blocking there for a SUBACK only the reader can read
        # would deadlock.
        for topic, qos in list(self._subscribed.items()):
            try:
                self._send_subscribe(topic, qos, wait=False)
            except OSError:
                break

    @staticmethod
    def _recv_exact_on(s: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("MQTT broker closed connection")
            buf += chunk
        return buf

    def _ensure_connected(self) -> None:
        with self._cond:
            if self._connected or self._closed:
                return
        self._connect()

    def _drop_connection(self, err: Exception) -> None:
        with self._cond:
            self._connected = False
            self._last_error = str(err)
            sock, self._sock = self._sock, None
            # unblock anything waiting for an ack; discard-marked waiters
            # have no waiting thread to pop them — release their pids here
            for pid in list(self._waiters):
                if self._waiters[pid] is _DISCARD:
                    self._waiters.pop(pid)
                else:
                    self._waiters[pid] = None
            self._cond.notify_all()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _read_loop(self) -> None:
        backoff = 0.2
        while True:
            with self._cond:
                if self._closed:
                    return
                sock = self._sock
            if sock is None:
                time.sleep(backoff)
                backoff = min(backoff * 2, 5.0)
                try:
                    self._connect()
                    backoff = 0.2
                except OSError:
                    pass
                continue
            try:
                p = mp.read_packet_from(lambda n: self._recv_exact_on(sock, n))
            except (OSError, ConnectionError, ValueError) as e:
                if not self._closed:
                    self._drop_connection(e)
                continue
            self._handle(p)

    def _handle(self, p: mp.Packet) -> None:
        if p.type == mp.PUBLISH:
            info = mp.parse_publish(p)
            msg = Message(
                info.topic, info.payload,
                metadata={"qos": str(info.qos), "retain": str(info.retain).lower()},
                # commit-on-success: the framework's subscriber runtime acks
                # (PUBACK) only after the handler succeeds
                committer=(lambda pid=info.packet_id: self._send(mp.puback_packet(pid)))
                if info.qos > 0
                else None,
            )
            with self._cond:
                for filt in self._subscribed:
                    if mp.topic_matches(filt, info.topic):
                        self._queues.setdefault(filt, collections.deque()).append(msg)
                self._cond.notify_all()
            # receive counters are incremented by the app's subscriber
            # runtime (app.py:268), not per-backend — no double counting
        elif p.type in (mp.SUBACK, mp.UNSUBACK, mp.PUBACK):
            pid = mp.parse_packet_id(p)
            with self._cond:
                if self._waiters.get(pid) is _DISCARD:
                    self._waiters.pop(pid)  # fire-and-forget ack: release pid
                elif self._waiters.get(pid) is ...:
                    # only fill an EMPTY slot: a late duplicate must not
                    # clobber a delivered ack the waiter hasn't consumed yet
                    self._waiters[pid] = p
                    self._cond.notify_all()
        elif p.type == mp.PINGRESP:
            pass

    def _ping_loop(self) -> None:
        interval = max(1.0, self.cfg.keepalive / 2)
        while True:
            time.sleep(interval)
            with self._cond:
                if self._closed:
                    return
                if not self._connected:
                    continue
            try:
                self._send(mp.pingreq_packet())
            except OSError:
                pass

    # -- wire helpers -----------------------------------------------------
    def _send(self, frame: bytes) -> None:
        with self._wlock:
            with self._cond:
                sock = self._sock
            if sock is None:
                raise ConnectionError("MQTT not connected")
            try:
                sock.sendall(frame)
            except OSError as e:
                self._drop_connection(e)
                raise

    def _next_pid(self) -> int:
        with self._cond:
            # skip pids with a waiter still outstanding (slow broker):
            # reusing one would mis-pair its ack or orphan the old waiter
            for _ in range(65535):
                self._pid = self._pid % 65535 + 1
                if self._pid not in self._waiters:
                    break
            else:
                raise ConnectionError("MQTT: all 65535 packet ids in flight")
            pid = self._pid
            self._waiters[pid] = ...  # placeholder: "waiting"
            return pid

    def _request_ack(self, build, what: str) -> mp.Packet:
        """Allocate a pid, send build(pid), await its ack. The waiter is
        popped on EVERY exit — send failure, builder error, ack timeout,
        or success — so _waiters never accumulates dead entries (a leaked
        pid would be skipped by _next_pid forever)."""
        pid = self._next_pid()
        try:
            self._send(build(pid))
        except BaseException:
            with self._cond:
                self._waiters.pop(pid, None)
            raise
        return self._await_ack(pid, what)

    _ACK_TYPES = {"SUBACK": mp.SUBACK, "UNSUBACK": mp.UNSUBACK, "PUBACK": mp.PUBACK}

    def _await_ack(self, pid: int, what: str) -> mp.Packet:
        expected = self._ACK_TYPES[what]
        deadline = time.monotonic() + self.cfg.timeout
        with self._cond:
            while True:
                v = self._waiters.get(pid)
                if v is ...:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._closed:
                        self._waiters.pop(pid, None)
                        raise TimeoutError(f"MQTT {what} timed out (pid {pid})")
                    self._cond.wait(remaining)
                    continue
                if v is not None and v.type != expected:
                    # late duplicate ack from an earlier life of this pid
                    # (e.g. a rebroadcast SUBACK) — discard, keep waiting
                    self._waiters[pid] = ...
                    continue
                p = self._waiters.pop(pid)
                break
        if p is None:
            raise ConnectionError(f"MQTT connection lost awaiting {what}")
        return p

    def _send_subscribe(self, topic: str, qos: int, *, wait: bool = True) -> None:
        if not wait:
            # fire-and-forget (reader-thread resubscribe can't block), but
            # the pid stays RESERVED until its SUBACK arrives: releasing it
            # now would let a following publish reuse the pid and mis-pair
            # the late SUBACK. _handle pops discard-marked waiters.
            pid = self._next_pid()
            with self._cond:
                self._waiters[pid] = _DISCARD
            try:
                self._send(mp.subscribe_packet(pid, [(topic, qos)]))
            except BaseException:
                with self._cond:
                    self._waiters.pop(pid, None)
                raise
            with self._cond:
                self._subscribed.setdefault(topic, qos)
                self._queues.setdefault(topic, collections.deque())
            return
        p = self._request_ack(
            lambda pid: mp.subscribe_packet(pid, [(topic, qos)]), "SUBACK"
        )
        _, codes = mp.parse_suback(p)
        if codes and codes[0] >= 0x80:
            raise ConnectionError(f"MQTT subscription to {topic!r} refused")
        with self._cond:
            self._subscribed[topic] = codes[0] if codes else qos
            self._queues.setdefault(topic, collections.deque())

    # -- Publisher / Subscriber interface ---------------------------------
    async def publish(self, topic: str, value: bytes | str) -> None:
        import asyncio

        await asyncio.get_running_loop().run_in_executor(
            None, self.publish_sync, topic, value
        )

    def publish_sync(self, topic: str, value: bytes | str) -> None:
        raw = value if isinstance(value, bytes) else str(value).encode()
        ok = False
        try:
            self._ensure_connected()
            if self.cfg.qos == 0:
                self._send(mp.publish_packet(topic, raw, qos=0))
            else:
                self._request_ack(
                    lambda pid: mp.publish_packet(topic, raw, qos=1, packet_id=pid),
                    "PUBACK",
                )
            ok = True
        finally:
            self._log_pub(topic, raw, ok)

    def _pop_blocking(self, topic: str, timeout: float) -> Message | None:
        deadline = time.monotonic() + timeout
        while True:
            with self._cond:
                if topic in self._subscribed:
                    q = self._queues.setdefault(topic, collections.deque())
                    if q:
                        return q.popleft()
                    if self._closed:
                        return None
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(min(remaining, 0.1))
                    continue
            # not yet subscribed: do it outside the condition (round trip)
            try:
                self._ensure_connected()
                self._send_subscribe(topic, self.cfg.qos)
            except (OSError, TimeoutError, ConnectionError):
                if time.monotonic() >= deadline:
                    return None
                time.sleep(0.1)

    async def subscribe(self, topic: str, timeout: float = 0.5) -> Message | None:
        import asyncio

        return await asyncio.get_running_loop().run_in_executor(
            None, self._pop_blocking, topic, timeout
        )

    def unsubscribe(self, topic: str) -> None:
        with self._cond:
            known = topic in self._subscribed
        if known:
            self._request_ack(
                lambda pid: mp.unsubscribe_packet(pid, [topic]), "UNSUBACK"
            )
        with self._cond:
            self._subscribed.pop(topic, None)
            self._queues.pop(topic, None)

    # MQTT has no broker-side topic admin: topics exist while subscribed,
    # so create_topic subscribes.
    def create_topic(self, topic: str) -> None:
        self._ensure_connected()
        self._send_subscribe(topic, self.cfg.qos)

    def delete_topic(self, topic: str) -> None:
        self.unsubscribe(topic)

    def health(self) -> dict:
        with self._cond:
            up = self._connected
            depths = {t: len(q) for t, q in self._queues.items()}
            err = self._last_error
        details = {
            "backend": "MQTT",
            "host": f"{self.cfg.host}:{self.cfg.port}",
            "client_id": self.cfg.client_id,
            "qos": self.cfg.qos,
            "topics": depths,
        }
        if err:
            details["error"] = err
        return health(STATUS_UP if up else STATUS_DOWN, **details)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            sock = self._sock
            self._cond.notify_all()
        if sock is not None:
            try:
                with self._wlock:
                    sock.sendall(mp.disconnect_packet())
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
