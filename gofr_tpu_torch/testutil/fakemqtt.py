"""In-process fake MQTT 3.1.1 broker speaking the real wire protocol
(counterpart of gofr_tpu/testutil/fakemqtt.py).

CONNECT/CONNACK, PUBLISH QoS 0/1 routed to the matching subscribers
('+'/'#' filters), PUBACK bookkeeping, SUBSCRIBE/SUBACK,
UNSUBSCRIBE/UNSUBACK, PINGREQ/PINGRESP, DISCONNECT; ``inject`` delivers a
publish from the broker itself; ``tls=True`` serves the self-signed test
certificate.

Persistent sessions (CONNECT with clean_session=0), which JAX's fake does
not keep: the broker holds a client id's subscriptions and its QoS 1
messages not yet acknowledged across connections, queues QoS 1 messages
routed while the client is away, and on the reconnect answers
session_present=1 and sends the held messages again with the DUP flag
(MQTT 3.1.1 sections 3.1.2.4 and 4.4). That is the broker half of the
client's at-least-once delivery, and what lets a test show it.
"""

from __future__ import annotations

import socket
import threading

from ..datasource.pubsub import mqttproto as mp

__all__ = ["FakeMQTTBroker"]


class _Session:
    def __init__(self, conn: socket.socket | None, client_id: str, persistent: bool = False):
        self.conn = conn
        self.client_id = client_id
        self.persistent = persistent
        self.subs: dict[str, int] = {}  # filter -> qos
        self.unacked: dict[int, tuple[str, bytes]] = {}  # pid -> (topic, payload), QoS 1 sent
        self.wlock = threading.Lock()
        self.next_pid = 0

    def send(self, frame: bytes) -> None:
        conn = self.conn
        if conn is None:
            raise ConnectionError("client away")
        with self.wlock:
            conn.sendall(frame)


class FakeMQTTBroker:
    def __init__(
        self,
        host: str = "127.0.0.1",
        *,
        password: str | None = None,
        tls: bool = False,
    ):
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(16)
        self.host = host
        self.port = self._sock.getsockname()[1]
        self.password = password  # when set, CONNECT must carry it
        self.tls = tls  # serve over testutil.self_signed_cert()
        self._sessions: list[_Session] = []
        self._held: dict[str, _Session] = {}  # client id -> persistent session while away
        self._lock = threading.Lock()
        self._closed = False
        # observability for tests
        self.published: list[tuple[str, bytes, int]] = []  # (topic, payload, qos)
        self.acked: list[int] = []  # packet ids PUBACKed by subscribers
        self.redelivered: list[tuple[str, bytes]] = []  # (topic, payload) sent again with DUP
        self.connects: list[mp.ConnectInfo] = []
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            for s in self._sessions:
                try:
                    s.conn.close()
                except OSError:
                    pass
            self._sessions.clear()

    def inject(self, topic: str, payload: bytes, qos: int = 0) -> None:
        """Broker-originated message delivery (tests publish without a
        second client)."""
        self._route(topic, payload, qos)

    # -- internals ---------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _maybe_tls(self, conn: socket.socket) -> socket.socket | None:
        """Per-connection TLS wrap (in the connection thread, like
        fakekafka — a stalled handshake must not freeze the accept loop)."""
        if not self.tls:
            return conn
        from . import server_tls_context

        try:
            return server_tls_context().wrap_socket(conn, server_side=True)
        except OSError:
            return None

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client closed")
            buf += chunk
        return buf

    def _serve_conn(self, conn: socket.socket) -> None:
        conn = self._maybe_tls(conn)
        if conn is None:
            return
        sess: _Session | None = None
        try:
            p = mp.read_packet_from(lambda n: self._recv_exact(conn, n))
            if p.type != mp.CONNECT:
                conn.close()
                return
            info = mp.parse_connect(p)
            self.connects.append(info)
            if self.password is not None and info.password != self.password:
                conn.sendall(mp.connack_packet(False, 5))  # not authorized
                conn.close()
                return
            with self._lock:
                held = self._held.pop(info.client_id, None)
                if info.clean_session or held is None:
                    sess = _Session(conn, info.client_id, persistent=not info.clean_session)
                else:
                    sess, sess.conn = held, conn
                self._sessions.append(sess)
                resend = sorted(sess.unacked.items())
            conn.sendall(mp.connack_packet(sess is held, 0))
            for pid, (topic, payload) in resend:
                self.redelivered.append((topic, payload))
                sess.send(mp.publish_packet(topic, payload, qos=1, packet_id=pid, dup=True))
            while not self._closed:
                p = mp.read_packet_from(lambda n: self._recv_exact(conn, n))
                if p.type == mp.PUBLISH:
                    pub = mp.parse_publish(p)
                    self.published.append((pub.topic, pub.payload, pub.qos))
                    if pub.qos > 0:
                        sess.send(mp.puback_packet(pub.packet_id))
                    self._route(pub.topic, pub.payload, pub.qos)
                elif p.type == mp.SUBSCRIBE:
                    sub = mp.parse_subscribe(p)
                    for t, qos in sub.topics:
                        sess.subs[t] = min(qos, 1)
                    sess.send(
                        mp.suback_packet(sub.packet_id, [min(q, 1) for _, q in sub.topics])
                    )
                elif p.type == mp.UNSUBSCRIBE:
                    pid, topics = mp.parse_unsubscribe(p)
                    for t in topics:
                        sess.subs.pop(t, None)
                    sess.send(mp.unsuback_packet(pid))
                elif p.type == mp.PUBACK:
                    pid = mp.parse_packet_id(p)
                    self.acked.append(pid)
                    with self._lock:
                        sess.unacked.pop(pid, None)
                elif p.type == mp.PINGREQ:
                    sess.send(mp.pingresp_packet())
                elif p.type == mp.DISCONNECT:
                    break
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            if sess is not None:
                with self._lock:
                    if sess in self._sessions:
                        self._sessions.remove(sess)
                    if sess.persistent and not self._closed:
                        sess.conn = None
                        self._held[sess.client_id] = sess
            try:
                conn.close()
            except OSError:
                pass

    def _route(self, topic: str, payload: bytes, qos: int) -> None:
        with self._lock:
            sessions = list(self._sessions) + list(self._held.values())
        for s in sessions:
            grant = max(
                (g for f, g in s.subs.items() if mp.topic_matches(f, topic)),
                default=None,
            )
            if grant is None:
                continue
            eff = min(qos, grant)
            if eff > 0:
                with self._lock:
                    s.next_pid = s.next_pid % 65535 + 1
                    pid = s.next_pid
                    if s.persistent:
                        s.unacked[pid] = (topic, payload)  # until PUBACK, across reconnects
                    conn = s.conn
                if conn is None:
                    continue  # away: held for the reconnect
                frame = mp.publish_packet(topic, payload, qos=1, packet_id=pid)
            else:
                if s.conn is None:
                    continue  # QoS 0 is not held for an absent client
                frame = mp.publish_packet(topic, payload, qos=0)
            try:
                s.send(frame)
            except OSError:
                pass
