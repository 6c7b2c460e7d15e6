"""In-process fake Kafka broker speaking the real wire protocol
(counterpart of gofr_tpu/testutil/fakekafka.py).

A single-node broker on an ephemeral TCP port, so the Kafka client runs
end to end without an external service. The API subset the client uses:
Produce v2/v3, Fetch v2/v4 (v2 record batches and v1 message sets),
ListOffsets v1, Metadata v1, OffsetCommit v2, OffsetFetch v1,
FindCoordinator v0, CreateTopics v0, DeleteTopics v0, ApiVersions v0,
SaslHandshake v1, SaslAuthenticate v0 (PLAIN and SCRAM). ``legacy=True``
advertises only the old Produce/Fetch versions (the v1 message-set path);
``users=`` enforces SASL; ``tls=True`` serves the self-signed test
certificate.
"""

from __future__ import annotations

import socket
import struct
import threading

from ..datasource.pubsub import kafkaproto as kp

__all__ = ["FakeKafkaBroker"]


class FakeKafkaBroker:
    """Single-node broker (node_id 0). Topics live in memory as
    {topic: {partition: [Record]}}; group offsets as {(group, topic, pid)}."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        *,
        legacy: bool = False,
        users: dict[str, str] | None = None,
        tls: bool = False,
    ):
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(16)
        self.host = host
        self.port = self._sock.getsockname()[1]
        self.node_id = 0
        self.legacy = legacy  # advertise pre-KIP-98 Produce/Fetch only
        self.users = users  # SASL required when set
        self.tls = tls
        self._topics: dict[str, dict[int, list[kp.Record]]] = {}
        self._group_offsets: dict[tuple[str, str, int], int] = {}
        self._lock = threading.Lock()
        self._closed = False
        # knobs for failure-injection tests
        self.fail_next_produce: int | None = None
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def api_versions(self) -> dict[int, tuple[int, int]]:
        produce_fetch = {
            kp.PRODUCE: (0, 2), kp.FETCH: (0, 2),
        } if self.legacy else {
            kp.PRODUCE: (0, 3), kp.FETCH: (0, 4),
        }
        return {
            **produce_fetch,
            kp.LIST_OFFSETS: (0, 1), kp.METADATA: (0, 1),
            kp.OFFSET_COMMIT: (0, 2), kp.OFFSET_FETCH: (0, 1),
            kp.FIND_COORDINATOR: (0, 0), kp.SASL_HANDSHAKE: (0, 1),
            kp.API_VERSIONS: (0, 0), kp.CREATE_TOPICS: (0, 0),
            kp.DELETE_TOPICS: (0, 0), kp.SASL_AUTHENTICATE: (0, 0),
        }

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- message log helpers (tests assert against these) ------------------
    def records(self, topic: str, pid: int = 0) -> list[kp.Record]:
        with self._lock:
            return list(self._topics.get(topic, {}).get(pid, []))

    def committed(self, group: str, topic: str, pid: int = 0) -> int | None:
        with self._lock:
            return self._group_offsets.get((group, topic, pid))

    def seed(self, topic: str, values: list[bytes], pid: int = 0,
             partitions: int = 1) -> None:
        with self._lock:
            parts = self._topics.setdefault(
                topic, {p: [] for p in range(partitions)}
            )
            log = parts.setdefault(pid, [])
            base = len(log)
            for i, v in enumerate(values):
                log.append(kp.Record(key=None, value=v, offset=base + i))

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass

    # -- server loop -------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _recv_exact(self, conn: socket.socket, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def _serve_conn(self, conn: socket.socket) -> None:
        if self.tls:
            from . import server_tls_context

            try:
                conn = server_tls_context().wrap_socket(conn, server_side=True)
            except OSError:
                return
        # per-connection SASL state, like a real broker's SASL listener
        state = {"authed": self.users is None, "scram": None, "mech": None}
        with conn:
            while not self._closed:
                head = self._recv_exact(conn, 4)
                if head is None:
                    return
                size = struct.unpack(">i", head)[0]
                payload = self._recv_exact(conn, size)
                if payload is None:
                    return
                r = kp.Reader(payload)
                api_key, api_ver, corr = r.i16(), r.i16(), r.i32()
                r.string()  # client_id
                if not state["authed"] and api_key not in (
                    kp.API_VERSIONS, kp.SASL_HANDSHAKE, kp.SASL_AUTHENTICATE
                ):
                    return  # real brokers cut unauthenticated connections
                try:
                    body = self._dispatch(api_key, api_ver, r, state)
                except Exception:  # noqa: BLE001 — a broken frame kills the conn
                    return
                try:
                    conn.sendall(kp.encode_response(corr, body))
                except OSError:
                    return

    def _dispatch(self, api_key: int, api_ver: int, r: kp.Reader, state: dict) -> bytes:
        if api_key == kp.API_VERSIONS:
            return kp.enc_api_versions_resp(self.api_versions())
        if api_key == kp.SASL_HANDSHAKE:
            return self._sasl_handshake(kp.dec_sasl_handshake_req(r), state)
        if api_key == kp.SASL_AUTHENTICATE:
            return self._sasl_authenticate(kp.dec_sasl_authenticate_req(r), state)
        if api_key == kp.METADATA:
            return self._metadata(kp.dec_metadata_req(r))
        if api_key == kp.PRODUCE:
            if api_ver >= 3:
                return self._produce(*kp.dec_produce_req_v3(r), api_ver=api_ver)
            return self._produce(*kp.dec_produce_req(r), api_ver=api_ver)
        if api_key == kp.FETCH:
            if api_ver >= 4:
                return self._fetch(kp.dec_fetch_req_v4(r), api_ver=api_ver)
            return self._fetch(kp.dec_fetch_req(r), api_ver=api_ver)
        if api_key == kp.LIST_OFFSETS:
            return self._list_offsets(kp.dec_list_offsets_req(r))
        if api_key == kp.OFFSET_COMMIT:
            return self._offset_commit(*kp.dec_offset_commit_req(r))
        if api_key == kp.OFFSET_FETCH:
            return self._offset_fetch(*kp.dec_offset_fetch_req(r))
        if api_key == kp.FIND_COORDINATOR:
            kp.dec_find_coordinator_req(r)
            return kp.enc_find_coordinator_resp(kp.NONE, self.node_id, self.host, self.port)
        if api_key == kp.CREATE_TOPICS:
            return self._create_topics(kp.dec_create_topics_req(r))
        if api_key == kp.DELETE_TOPICS:
            return self._delete_topics(kp.dec_delete_topics_req(r))
        raise ValueError(f"unsupported api_key {api_key}")

    def _sasl_handshake(self, mechanism: str, state: dict) -> bytes:
        # what real brokers offer (no SHA-1 in Kafka)
        offered = ["PLAIN", "SCRAM-SHA-256", "SCRAM-SHA-512"]
        if self.users is None or mechanism not in offered:
            return kp.enc_sasl_handshake_resp(
                kp.UNSUPPORTED_SASL_MECHANISM, offered
            )
        state["mech"] = mechanism
        return kp.enc_sasl_handshake_resp(kp.NONE, offered)

    def _sasl_authenticate(self, auth: bytes, state: dict) -> bytes:
        from ..datasource.scram import ScramError, ScramServer

        mech = state.get("mech")
        if mech is None:
            return kp.enc_sasl_authenticate_resp(
                kp.ILLEGAL_SASL_STATE, "handshake first", b""
            )
        if mech == "PLAIN":
            try:
                _authzid, user, password = auth.split(b"\x00", 2)
            except ValueError:
                return kp.enc_sasl_authenticate_resp(
                    kp.SASL_AUTHENTICATION_FAILED, "malformed PLAIN", b""
                )
            if self.users.get(user.decode()) == password.decode():
                state["authed"] = True
                return kp.enc_sasl_authenticate_resp(kp.NONE, None, b"")
            return kp.enc_sasl_authenticate_resp(
                kp.SASL_AUTHENTICATION_FAILED, "bad credentials", b""
            )
        try:
            if state["scram"] is None:
                state["scram"] = ScramServer(mech, self.users)
                first = state["scram"].process_client_first(auth.decode())
                return kp.enc_sasl_authenticate_resp(kp.NONE, None, first.encode())
            final = state["scram"].process_client_final(auth.decode())
            state["authed"] = True
            state["scram"] = None
            return kp.enc_sasl_authenticate_resp(kp.NONE, None, final.encode())
        except ScramError as e:
            state["scram"] = None
            return kp.enc_sasl_authenticate_resp(
                kp.SASL_AUTHENTICATION_FAILED, str(e), b""
            )

    def _metadata(self, want: list[str] | None) -> bytes:
        with self._lock:
            names = list(self._topics) if want is None else want
            topics = []
            for name in names:
                parts = self._topics.get(name)
                if parts is None:
                    topics.append((kp.UNKNOWN_TOPIC_OR_PARTITION, name, []))
                else:
                    topics.append(
                        (kp.NONE, name, [(kp.NONE, pid, self.node_id) for pid in sorted(parts)])
                    )
        return kp.enc_metadata_resp(
            [(self.node_id, self.host, self.port)], self.node_id, topics
        )

    def _produce(self, acks: int, _timeout: int,
                 topics: dict[str, dict[int, bytes]], api_ver: int = 2) -> bytes:
        resp: dict[str, dict[int, tuple[int, int]]] = {}
        with self._lock:
            for name, parts in topics.items():
                resp[name] = {}
                for pid, record_set in parts.items():
                    if self.fail_next_produce is not None:
                        code, self.fail_next_produce = self.fail_next_produce, None
                        resp[name][pid] = (code, -1)
                        continue
                    tparts = self._topics.get(name)
                    if tparts is None or pid not in tparts:
                        resp[name][pid] = (kp.UNKNOWN_TOPIC_OR_PARTITION, -1)
                        continue
                    log = tparts[pid]
                    base = len(log)
                    # decode_records sniffs v1 MessageSet vs v2 batch, so
                    # one store serves clients on either format
                    for i, rec in enumerate(kp.decode_records(record_set)):
                        rec.offset = base + i
                        log.append(rec)
                    resp[name][pid] = (kp.NONE, base)
        return kp.enc_produce_resp(resp)

    def _fetch(self, topics: dict[str, dict[int, tuple[int, int]]],
               api_ver: int = 2) -> bytes:
        resp: dict[str, dict[int, tuple[int, int, bytes]]] = {}
        with self._lock:
            for name, parts in topics.items():
                resp[name] = {}
                tparts = self._topics.get(name)
                for pid, (offset, max_bytes) in parts.items():
                    if tparts is None or pid not in tparts:
                        resp[name][pid] = (kp.UNKNOWN_TOPIC_OR_PARTITION, -1, b"")
                        continue
                    log = tparts[pid]
                    hw = len(log)
                    if offset > hw:
                        resp[name][pid] = (kp.OFFSET_OUT_OF_RANGE, hw, b"")
                        continue
                    out, size = [], 0
                    for rec in log[offset:]:
                        out.append(rec)
                        # value=None is a tombstone (0 payload bytes on wire)
                        size += len(rec.value or b"") + 34
                        if size >= max_bytes:
                            break
                    if not out:
                        wire = b""
                    elif api_ver >= 4:
                        # v2 batch offsets are base+delta: rebase on the
                        # first record's absolute offset
                        wire = kp.encode_record_batch(out, base_offset=out[0].offset)
                    else:
                        wire = kp.encode_message_set(out)
                    resp[name][pid] = (kp.NONE, hw, wire)
        if api_ver >= 4:
            return kp.enc_fetch_resp_v4(resp)
        return kp.enc_fetch_resp(resp)

    def _list_offsets(self, topics: dict[str, dict[int, int]]) -> bytes:
        resp: dict[str, dict[int, tuple[int, int]]] = {}
        with self._lock:
            for name, parts in topics.items():
                resp[name] = {}
                tparts = self._topics.get(name)
                for pid, ts in parts.items():
                    if tparts is None or pid not in tparts:
                        resp[name][pid] = (kp.UNKNOWN_TOPIC_OR_PARTITION, -1)
                    elif ts == kp.EARLIEST:
                        resp[name][pid] = (kp.NONE, 0)
                    else:  # LATEST
                        resp[name][pid] = (kp.NONE, len(tparts[pid]))
        return kp.enc_list_offsets_resp(resp)

    def _offset_commit(self, group: str,
                       topics: dict[str, dict[int, int]]) -> bytes:
        resp: dict[str, dict[int, int]] = {}
        with self._lock:
            for name, parts in topics.items():
                resp[name] = {}
                for pid, off in parts.items():
                    self._group_offsets[(group, name, pid)] = off
                    resp[name][pid] = kp.NONE
        return kp.enc_offset_commit_resp(resp)

    def _offset_fetch(self, group: str, topics: dict[str, list[int]]) -> bytes:
        resp: dict[str, dict[int, tuple[int, int]]] = {}
        with self._lock:
            for name, pids in topics.items():
                resp[name] = {
                    pid: (self._group_offsets.get((group, name, pid), -1), kp.NONE)
                    for pid in pids
                }
        return kp.enc_offset_fetch_resp(resp)

    def _create_topics(self, topics: dict[str, int]) -> bytes:
        resp: dict[str, int] = {}
        with self._lock:
            for name, nparts in topics.items():
                if name in self._topics:
                    resp[name] = kp.TOPIC_ALREADY_EXISTS
                else:
                    self._topics[name] = {p: [] for p in range(max(1, nparts))}
                    resp[name] = kp.NONE
        return kp.enc_create_topics_resp(resp)

    def _delete_topics(self, topics: list[str]) -> bytes:
        resp: dict[str, int] = {}
        with self._lock:
            for name in topics:
                if name in self._topics:
                    del self._topics[name]
                    resp[name] = kp.NONE
                else:
                    resp[name] = kp.UNKNOWN_TOPIC_OR_PARTITION
        return kp.enc_delete_topics_resp(resp)
