"""Google Cloud Pub/Sub backend speaking the v1 gRPC surface (counterpart
of gofr_tpu/datasource/pubsub/google.py).

A hand-rolled protobuf codec (``pb``: varints, tag/length framing, the few
message shapes used) over ``grpc`` generic calls, against the Pub/Sub
emulator (PUBSUB_EMULATOR_HOST), the real service, or any server speaking
the same methods (testutil/fakegooglepubsub.py):
- topic get-or-create on publish;
- a subscription per topic, get-or-create, named with the
  GOOGLE_SUBSCRIPTION_NAME prefix;
- publish with the publish counters and logs;
- a receive loop into a queue per topic, by StreamingPull where the
  server offers it, else unary Pull; ``Message.commit()`` acks;
- health: the endpoint and the project's reachability.

Against the real service, GOOGLE_CREDENTIALS_FILE (a service-account JSON
key) makes every call carry ``authorization: Bearer <RS256 JWT>`` from
googleauth.ServiceAccountAuth, over TLS (GOOGLE_TLS).

``grpc`` is imported when the client is built: a process without grpcio
imports this module but cannot build the client, and that fails loudly,
naming grpcio. The card's machine has no grpcio, so this backend is held
on the CPU only.
"""

from __future__ import annotations

import collections
import os
import struct
import threading
import time

from .. import STATUS_DOWN, STATUS_UP, health
from . import Message, _BasePubSub

__all__ = ["GooglePubSub", "pb"]


# ---------------------------------------------------------------------------
# Minimal protobuf wire codec (proto3): varints, length-delimited fields.
# ---------------------------------------------------------------------------


class pb:
    """Encode helpers emit (tag, value) chunks; decode() returns
    {field_number: [raw values]} with length-delimited fields as bytes and
    varint fields as ints — callers pick the interpretation."""

    @staticmethod
    def varint(n: int) -> bytes:
        out = bytearray()
        while True:
            b = n & 0x7F
            n >>= 7
            out.append(b | (0x80 if n else 0))
            if not n:
                return bytes(out)

    @staticmethod
    def tag(field: int, wire: int) -> bytes:
        return pb.varint((field << 3) | wire)

    @staticmethod
    def str_field(field: int, s: str | bytes) -> bytes:
        b = s.encode() if isinstance(s, str) else s
        return pb.tag(field, 2) + pb.varint(len(b)) + b

    @staticmethod
    def int_field(field: int, n: int) -> bytes:
        return pb.tag(field, 0) + pb.varint(n)

    @staticmethod
    def bool_field(field: int, v: bool) -> bytes:
        return pb.int_field(field, 1 if v else 0)

    @staticmethod
    def map_entry(field: int, key: str, value: str) -> bytes:
        entry = pb.str_field(1, key) + pb.str_field(2, value)
        return pb.str_field(field, entry)

    @staticmethod
    def decode(data: bytes) -> dict[int, list]:
        out: dict[int, list] = {}
        i, n = 0, len(data)

        def varint_at(i: int) -> tuple[int, int]:
            shift = v = 0
            while True:
                b = data[i]
                v |= (b & 0x7F) << shift
                i += 1
                if not b & 0x80:
                    return v, i
                shift += 7

        while i < n:
            key, i = varint_at(i)
            field, wire = key >> 3, key & 0x7
            if wire == 0:
                v, i = varint_at(i)
            elif wire == 2:
                ln, i = varint_at(i)
                v = data[i : i + ln]
                i += ln
            elif wire == 5:
                v = struct.unpack("<I", data[i : i + 4])[0]
                i += 4
            elif wire == 1:
                v = struct.unpack("<Q", data[i : i + 8])[0]
                i += 8
            else:
                raise ValueError(f"unsupported protobuf wire type {wire}")
            out.setdefault(field, []).append(v)
        return out

    @staticmethod
    def first(msg: dict[int, list], field: int, default=None):
        vals = msg.get(field)
        return vals[0] if vals else default


_PUBLISHER = "/google.pubsub.v1.Publisher/"
_SUBSCRIBER = "/google.pubsub.v1.Subscriber/"
_ident = lambda b: b  # noqa: E731 — bytes in, bytes out
_UNIMPLEMENTED = object()  # sentinel: server lacks StreamingPull


class _StreamPull:
    """One StreamingPull bidi stream for one subscription. The request
    side is a queue-fed iterator (initial subscribe message, then ack
    batches); a receiver thread buffers ReceivedMessage frames for
    next(). Stream death flips `dead` — the owner redials lazily."""

    def __init__(self, owner: "GooglePubSub", sub: str):
        import queue as _queue

        self.sub = sub
        self.dead = False
        self.unimplemented = False
        self._send_q: "_queue.Queue[bytes | None]" = _queue.Queue()
        self._msgs: collections.deque = collections.deque()
        self._cv = threading.Condition()
        # StreamingPullRequest: subscription=1, stream_ack_deadline_seconds=5
        self._send_q.put(pb.str_field(1, sub) + pb.int_field(5, 10))
        fn = owner._channel.stream_stream(
            _SUBSCRIBER + "StreamingPull",
            request_serializer=_ident, response_deserializer=_ident,
        )
        metadata = owner._auth.metadata() if owner._send_auth else None
        self._call = fn(self._requests(), metadata=metadata)
        self._grpc = owner._grpc
        threading.Thread(
            target=self._recv_loop, name="gpubsub-stream", daemon=True
        ).start()

    def _requests(self):
        while True:
            item = self._send_q.get()
            if item is None:
                return
            yield item

    def _recv_loop(self) -> None:
        try:
            for frame in self._call:
                decoded = pb.decode(frame)
                with self._cv:
                    self._msgs.extend(decoded.get(1, []))
                    self._cv.notify_all()
        except Exception as e:  # noqa: BLE001 — stream death is a state, not a crash
            code = getattr(e, "code", lambda: None)()
            if code == self._grpc.StatusCode.UNIMPLEMENTED:
                self.unimplemented = True
        finally:
            with self._cv:
                self.dead = True
                self._cv.notify_all()

    def next(self, timeout: float) -> bytes | None:
        deadline = time.monotonic() + timeout
        with self._cv:
            while not self._msgs and not self.dead:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)
            return self._msgs.popleft() if self._msgs else None

    def ack(self, ack_id: str) -> None:
        # StreamingPullRequest.ack_ids = 2, riding the same stream
        self._send_q.put(pb.str_field(1, self.sub) + pb.str_field(2, ack_id))

    def close(self) -> None:
        self._send_q.put(None)
        try:
            self._call.cancel()
        except Exception:  # noqa: BLE001
            pass


class GooglePubSub(_BasePubSub):
    def __init__(self, config, logger=None, metrics=None):
        super().__init__(logger, metrics)
        self.project = config.get_or_default("GOOGLE_PROJECT_ID", "gofr-tpu")
        self.sub_name = config.get_or_default("GOOGLE_SUBSCRIPTION_NAME", "gofr-sub")
        self.endpoint = (
            config.get("PUBSUB_EMULATOR_HOST")
            or os.environ.get("PUBSUB_EMULATOR_HOST")
            or config.get("GOOGLE_ENDPOINT")
            or ""
        )
        self._auth = None
        creds_file = config.get("GOOGLE_CREDENTIALS_FILE")
        ambient = None if creds_file else os.environ.get(
            "GOOGLE_APPLICATION_CREDENTIALS"
        )
        if creds_file:
            from .googleauth import ServiceAccountAuth

            # explicit config: a bad key file is a loud startup error
            self._auth = ServiceAccountAuth(creds_file)
        elif ambient:
            # ambient ADC env var: may be an authorized_user file from
            # `gcloud auth application-default login`, a stale path, etc. —
            # never a startup crash for an app that ran fine without it
            from .googleauth import ServiceAccountAuth

            try:
                self._auth = ServiceAccountAuth(ambient)
            except Exception as e:  # noqa: BLE001 — any malformed key shape
                if logger is not None:
                    logger.warn(
                        f"ignoring GOOGLE_APPLICATION_CREDENTIALS "
                        f"({ambient!r}): not a usable service-account key: {e}"
                    )
        if self._auth is not None:
            self.endpoint = self.endpoint or "pubsub.googleapis.com:443"
        if not self.endpoint:
            raise RuntimeError(
                "GOOGLE pub/sub backend needs PUBSUB_EMULATOR_HOST / "
                "GOOGLE_ENDPOINT, or GOOGLE_CREDENTIALS_FILE for the "
                "authenticated cloud service"
            )
        try:
            import grpc
        except ImportError as e:
            # no quiet fallback to another backend: the app asked for GOOGLE
            raise RuntimeError(
                "PUBSUB_BACKEND=GOOGLE needs grpcio (the grpc module), which is not installed"
            ) from e

        self._grpc = grpc
        # TLS iff talking to the real Google service (or explicitly asked):
        # a plaintext GOOGLE_ENDPOINT proxy/emulator must not get a TLS
        # handshake just because credentials happen to be present
        use_tls = config.get_or_default("GOOGLE_TLS", "").lower() in ("1", "true") or (
            "googleapis.com" in self.endpoint
        )
        if use_tls:
            self._channel = grpc.secure_channel(
                self.endpoint, grpc.ssl_channel_credentials()
            )
        else:
            self._channel = grpc.insecure_channel(self.endpoint)
            if self._auth is not None:
                # never send a bearer credential in cleartext — it would be
                # replayable against the REAL service for its whole lifetime
                # (standard gRPC clients refuse call creds on insecure
                # channels for the same reason)
                if logger is not None:
                    logger.warn(
                        "Google Pub/Sub: plaintext channel — bearer auth "
                        "metadata will NOT be attached"
                    )
        self._send_auth = self._auth is not None and use_tls
        self._calls: dict[str, object] = {}  # cached unary_unary multicallables
        self._lock = threading.Lock()
        self._topics: set[str] = set()
        self._subs: set[str] = set()
        self._last_error: str | None = None
        # StreamingPull: messages push over one bidi stream instead
        # of paying a unary Pull round trip each; acks ride the same
        # stream. Default on, with automatic permanent fallback to unary
        # Pull when the server doesn't implement it.
        self._streaming = config.get_or_default(
            "GOOGLE_STREAMING_PULL", "true"
        ).lower() not in ("0", "false")
        self._streams: dict[str, _StreamPull] = {}

    # -- call plumbing -----------------------------------------------------
    def _call(self, service: str, method: str, body: bytes, timeout: float = 10.0) -> bytes:
        path = service + method
        fn = self._calls.get(path)
        if fn is None:
            fn = self._calls[path] = self._channel.unary_unary(
                path, request_serializer=_ident, response_deserializer=_ident
            )
        try:
            metadata = self._auth.metadata() if self._send_auth else None
            resp = fn(body, timeout=timeout, metadata=metadata)
            self._last_error = None
            return resp
        except Exception as e:  # noqa: BLE001 — surfaced via health + reraise
            self._last_error = str(e)
            raise

    def _topic_path(self, topic: str) -> str:
        return f"projects/{self.project}/topics/{topic}"

    def _sub_path(self, topic: str) -> str:
        # one subscription per topic, prefixed by the configured name
        return f"projects/{self.project}/subscriptions/{self.sub_name}-{topic}"

    def _ensure_topic(self, topic: str) -> None:
        with self._lock:
            if topic in self._topics:
                return
        body = pb.str_field(1, self._topic_path(topic))
        try:
            self._call(_PUBLISHER, "CreateTopic", body)
        except self._grpc.RpcError as e:
            if e.code() != self._grpc.StatusCode.ALREADY_EXISTS:
                raise
        with self._lock:
            self._topics.add(topic)

    def _ensure_subscription(self, topic: str) -> None:
        with self._lock:
            if topic in self._subs:
                return
        self._ensure_topic(topic)
        body = (
            pb.str_field(1, self._sub_path(topic))
            + pb.str_field(2, self._topic_path(topic))
            + pb.int_field(5, 10)  # ack_deadline_seconds
        )
        try:
            self._call(_SUBSCRIBER, "CreateSubscription", body)
        except self._grpc.RpcError as e:
            if e.code() != self._grpc.StatusCode.ALREADY_EXISTS:
                raise
        with self._lock:
            self._subs.add(topic)

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
            self._ensure_topic(topic)
            msg = pb.str_field(1, raw)  # PubsubMessage.data
            body = pb.str_field(1, self._topic_path(topic)) + pb.str_field(2, msg)
            self._call(_PUBLISHER, "Publish", body)
            ok = True
        finally:
            self._log_pub(topic, raw, ok)

    def _rm_to_message(self, topic: str, rm_raw: bytes, acker) -> Message:
        """ReceivedMessage bytes -> framework Message (shared by the unary
        and streaming pull paths). `acker(ack_id)` performs the ack."""
        rm = pb.decode(rm_raw)
        ack_id = pb.first(rm, 1, b"").decode()
        pm = pb.decode(pb.first(rm, 2, b""))
        data = pb.first(pm, 1, b"")
        attrs = {}
        for entry in pm.get(2, []):
            kv = pb.decode(entry)
            attrs[pb.first(kv, 1, b"").decode()] = pb.first(kv, 2, b"").decode()
        return Message(
            topic, data, metadata=attrs, committer=lambda: acker(ack_id)
        )

    def _pull_blocking(self, topic: str, timeout: float) -> Message | None:
        deadline = time.monotonic() + timeout
        try:
            self._ensure_subscription(topic)
        except Exception:  # noqa: BLE001 — endpoint down; report None
            return None
        sub = self._sub_path(topic)
        while self._streaming:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            got = self._stream_next(topic, sub, remaining)
            if got is _UNIMPLEMENTED:
                # server has no StreamingPull (old emulator): permanent
                # unary fallback, same semantics at higher latency
                self._streaming = False
                if self.logger is not None:
                    self.logger.warn(
                        "Google Pub/Sub: StreamingPull unimplemented by "
                        "server; falling back to unary Pull"
                    )
                break
            if got is not None:
                return got
            # None inside the window means the stream died mid-wait (a
            # timeout exits via `remaining` above). Pace the redial so a
            # flapping endpoint doesn't get hot-looped with fresh streams;
            # un-fetched messages of the dead stream redeliver after the
            # ack deadline.
            time.sleep(min(0.05, max(deadline - time.monotonic(), 0)))
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            # return_immediately=False lets the server hold ONE Pull for the
            # window instead of the client poll-spinning; servers that
            # answer empty early (the fake) are covered by the short sleep.
            body = pb.str_field(1, sub) + pb.int_field(3, 1)
            try:
                resp = pb.decode(self._call(_SUBSCRIBER, "Pull", body, timeout=max(remaining, 0.5)))
            except Exception:  # noqa: BLE001
                return None
            received = resp.get(1, [])
            if received:
                return self._rm_to_message(
                    topic, received[0], lambda ack_id: self._ack(sub, ack_id)
                )
            time.sleep(min(0.05, max(deadline - time.monotonic(), 0)))

    def _stream_next(self, topic: str, sub: str, timeout: float):
        """One message via the topic's StreamingPull stream (creating or
        re-creating it as needed). Returns a Message, None (timeout /
        transient stream death — next call redials), or _UNIMPLEMENTED."""
        with self._lock:
            st = self._streams.get(topic)
        if st is None or st.dead:
            if st is not None and st.unimplemented:
                return _UNIMPLEMENTED
            try:
                st = _StreamPull(self, sub)
            except Exception as e:  # noqa: BLE001
                self._last_error = str(e)
                return None
            with self._lock:
                old, self._streams[topic] = self._streams.get(topic), st
            if old is not None:
                old.close()
        rm_raw = st.next(timeout)
        if rm_raw is None:
            if st.unimplemented:
                return _UNIMPLEMENTED
            return None
        return self._rm_to_message(topic, rm_raw, st.ack)

    def _ack(self, sub: str, ack_id: str) -> None:
        self._call(
            _SUBSCRIBER, "Acknowledge",
            pb.str_field(1, sub) + pb.str_field(2, ack_id),
        )

    async def subscribe(self, topic: str, timeout: float = 0.5) -> Message | None:
        import asyncio

        return await asyncio.get_running_loop().run_in_executor(
            None, self._pull_blocking, topic, timeout
        )

    def create_topic(self, topic: str) -> None:
        self._ensure_topic(topic)

    def delete_topic(self, topic: str) -> None:
        # delete the paired subscription too: against the real service a
        # surviving subscription detaches to _deleted-topic_ and silently
        # starves any future subscriber after the topic is recreated
        try:
            self._call(
                _SUBSCRIBER, "DeleteSubscription", pb.str_field(1, self._sub_path(topic))
            )
        except self._grpc.RpcError as e:
            if e.code() != self._grpc.StatusCode.NOT_FOUND:
                raise
        try:
            self._call(_PUBLISHER, "DeleteTopic", pb.str_field(1, self._topic_path(topic)))
        except self._grpc.RpcError as e:
            if e.code() != self._grpc.StatusCode.NOT_FOUND:
                raise
        with self._lock:
            self._topics.discard(topic)
            self._subs.discard(topic)
            stream = self._streams.pop(topic, None)
        if stream is not None:
            stream.close()

    def health(self) -> dict:
        try:
            # GetTopic on a probe topic path answers "is the endpoint alive"
            self._call(
                _PUBLISHER, "GetTopic",
                pb.str_field(1, self._topic_path("gofr-health-probe")),
                timeout=2.0,
            )
            up = True
        except self._grpc.RpcError as e:
            up = e.code() in (
                self._grpc.StatusCode.NOT_FOUND,
                self._grpc.StatusCode.ALREADY_EXISTS,
            )
        except Exception:  # noqa: BLE001
            up = False
        details = {
            "backend": "GOOGLE",
            "endpoint": self.endpoint,
            "project": self.project,
            "subscription_prefix": self.sub_name,
        }
        if not up and self._last_error:
            details["error"] = self._last_error
        return health(STATUS_UP if up else STATUS_DOWN, **details)

    def close(self) -> None:
        with self._lock:
            streams, self._streams = list(self._streams.values()), {}
        for s in streams:
            s.close()
        self._channel.close()
