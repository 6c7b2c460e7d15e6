"""In-process fake Google Pub/Sub emulator (counterpart of
gofr_tpu/testutil/fakegooglepubsub.py): a grpcio server with bytes-level
handlers speaking the client's protobuf codec (datasource/pubsub/google.py).
The google.pubsub.v1 subset the framework uses: CreateTopic, GetTopic,
DeleteTopic, Publish, CreateSubscription, DeleteSubscription, Pull,
StreamingPull (off with ``no_streaming=True``), Acknowledge;
``redeliver_unacked`` hands unacked messages out again.
"""

from __future__ import annotations

import collections
import itertools
import threading
from concurrent.futures import ThreadPoolExecutor

import grpc

from ..datasource.pubsub.google import pb

__all__ = ["FakeGooglePubSub"]


class _State:
    def __init__(self):
        self.topics: set[str] = set()
        self.subs: dict[str, str] = {}  # sub path -> topic path
        self.queues: dict[str, collections.deque] = {}  # sub -> deque[(ack, data, attrs)]
        self.unacked: dict[str, tuple] = {}  # ack_id -> (sub, record)
        self.acked: list[str] = []
        self.lock = threading.Lock()
        self.arrived = threading.Condition(lock=self.lock)  # publish signal
        self.ids = itertools.count(1)


class FakeGooglePubSub:
    def __init__(self, host: str = "127.0.0.1", *, no_streaming: bool = False):
        # no_streaming simulates an old emulator without StreamingPull, so
        # tests can cover the client's permanent unary-Pull fallback
        self.state = _State()
        self._server = grpc.server(ThreadPoolExecutor(max_workers=8))
        handlers = {
            "CreateTopic": self._create_topic,
            "GetTopic": self._get_topic,
            "DeleteTopic": self._delete_topic,
            "Publish": self._publish,
        }
        sub_handlers = {
            "CreateSubscription": self._create_subscription,
            "DeleteSubscription": self._delete_subscription,
            "Pull": self._pull,
            "Acknowledge": self._acknowledge,
        }
        stream_handlers = (
            {} if no_streaming else {"StreamingPull": self._streaming_pull}
        )
        self._server.add_generic_rpc_handlers(
            (
                _Generic("google.pubsub.v1.Publisher", handlers),
                _Generic(
                    "google.pubsub.v1.Subscriber", sub_handlers, stream_handlers
                ),
            )
        )
        self.port = self._server.add_insecure_port(f"{host}:0")
        self.host = host
        self._server.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        self._server.stop(grace=None)

    # -- handlers (bytes in, bytes out) ------------------------------------
    def _create_topic(self, body: bytes, ctx) -> bytes:
        name = pb.first(pb.decode(body), 1, b"").decode()
        with self.state.lock:
            if name in self.state.topics:
                ctx.abort(grpc.StatusCode.ALREADY_EXISTS, "topic exists")
            self.state.topics.add(name)
        return pb.str_field(1, name)

    def _get_topic(self, body: bytes, ctx) -> bytes:
        name = pb.first(pb.decode(body), 1, b"").decode()
        with self.state.lock:
            if name not in self.state.topics:
                ctx.abort(grpc.StatusCode.NOT_FOUND, "no such topic")
        return pb.str_field(1, name)

    def _delete_topic(self, body: bytes, ctx) -> bytes:
        name = pb.first(pb.decode(body), 1, b"").decode()
        with self.state.lock:
            if name not in self.state.topics:
                ctx.abort(grpc.StatusCode.NOT_FOUND, "no such topic")
            self.state.topics.discard(name)
            for sub, t in list(self.state.subs.items()):
                if t == name:
                    del self.state.subs[sub]
                    self.state.queues.pop(sub, None)
        return b""

    def _publish(self, body: bytes, ctx) -> bytes:
        msg = pb.decode(body)
        topic = pb.first(msg, 1, b"").decode()
        out_ids = b""
        with self.state.lock:
            if topic not in self.state.topics:
                ctx.abort(grpc.StatusCode.NOT_FOUND, "no such topic")
            for raw in msg.get(2, []):
                pm = pb.decode(raw)
                data = pb.first(pm, 1, b"")
                attrs = {}
                for entry in pm.get(2, []):
                    kv = pb.decode(entry)
                    attrs[pb.first(kv, 1, b"").decode()] = pb.first(kv, 2, b"").decode()
                mid = str(next(self.state.ids))
                for sub, t in self.state.subs.items():
                    if t == topic:
                        ack = f"ack-{mid}-{sub}"
                        self.state.queues.setdefault(sub, collections.deque()).append(
                            (ack, data, attrs, mid)
                        )
                out_ids += pb.str_field(1, mid)
            self.state.arrived.notify_all()  # wake StreamingPull senders
        return out_ids

    def _create_subscription(self, body: bytes, ctx) -> bytes:
        msg = pb.decode(body)
        name = pb.first(msg, 1, b"").decode()
        topic = pb.first(msg, 2, b"").decode()
        with self.state.lock:
            if name in self.state.subs:
                ctx.abort(grpc.StatusCode.ALREADY_EXISTS, "subscription exists")
            if topic not in self.state.topics:
                ctx.abort(grpc.StatusCode.NOT_FOUND, "no such topic")
            self.state.subs[name] = topic
        return body

    def _delete_subscription(self, body: bytes, ctx) -> bytes:
        name = pb.first(pb.decode(body), 1, b"").decode()
        with self.state.lock:
            if name not in self.state.subs:
                ctx.abort(grpc.StatusCode.NOT_FOUND, "no such subscription")
            del self.state.subs[name]
            self.state.queues.pop(name, None)
        return b""

    def _pull(self, body: bytes, ctx) -> bytes:
        msg = pb.decode(body)
        sub = pb.first(msg, 1, b"").decode()
        maxn = pb.first(msg, 3, 1)
        out = b""
        with self.state.lock:
            if sub not in self.state.subs:
                ctx.abort(grpc.StatusCode.NOT_FOUND, "no such subscription")
            q = self.state.queues.setdefault(sub, collections.deque())
            for _ in range(min(maxn, len(q))):
                ack, data, attrs, mid = q.popleft()
                self.state.unacked[ack] = (sub, (ack, data, attrs, mid))
                pm = pb.str_field(1, data) + pb.str_field(3, mid)
                for k, v in attrs.items():
                    pm += pb.map_entry(2, k, v)
                rm = pb.str_field(1, ack) + pb.str_field(2, pm)
                out += pb.str_field(1, rm)
        return out

    def _streaming_pull(self, request_iterator, ctx):
        """Bidi StreamingPull: first request names the subscription; later
        requests carry ack_ids; responses push message batches as they
        arrive (no client round trip per message)."""
        first = pb.decode(next(request_iterator))
        sub = pb.first(first, 1, b"").decode()
        with self.state.lock:
            if sub not in self.state.subs:
                ctx.abort(grpc.StatusCode.NOT_FOUND, "no such subscription")

        def ack_loop():
            try:
                for req in request_iterator:
                    msg = pb.decode(req)
                    with self.state.lock:
                        for ack in msg.get(2, []):
                            a = ack.decode()
                            self.state.unacked.pop(a, None)
                            self.state.acked.append(a)
            except Exception:  # noqa: BLE001 — stream teardown
                pass

        threading.Thread(target=ack_loop, daemon=True).start()
        while ctx.is_active():
            with self.state.lock:
                q = self.state.queues.setdefault(sub, collections.deque())
                batch = []
                while q:
                    rec = q.popleft()
                    self.state.unacked[rec[0]] = (sub, rec)
                    batch.append(rec)
                if not batch:
                    self.state.arrived.wait(timeout=0.2)
                    continue
            out = b""
            for ack, data, attrs, mid in batch:
                pm = pb.str_field(1, data) + pb.str_field(3, mid)
                for k, v in attrs.items():
                    pm += pb.map_entry(2, k, v)
                out += pb.str_field(1, pb.str_field(1, ack) + pb.str_field(2, pm))
            yield out

    def _acknowledge(self, body: bytes, ctx) -> bytes:
        msg = pb.decode(body)
        with self.state.lock:
            for ack in msg.get(2, []):
                a = ack.decode()
                self.state.unacked.pop(a, None)
                self.state.acked.append(a)
        return b""

    # test helper: redeliver everything pulled but never acked
    def redeliver_unacked(self) -> int:
        with self.state.lock:
            n = 0
            for ack, (sub, rec) in list(self.state.unacked.items()):
                self.state.queues.setdefault(sub, collections.deque()).append(rec)
                del self.state.unacked[ack]
                n += 1
            return n


class _Generic(grpc.GenericRpcHandler):
    def __init__(self, service: str, methods: dict, streams: dict | None = None):
        self._service = service
        self._methods = methods
        self._streams = streams or {}

    def service(self, handler_call_details):
        # path: /package.Service/Method
        _, svc, method = handler_call_details.method.split("/")
        if svc != self._service:
            return None
        if method in self._streams:
            fn = self._streams[method]
            return grpc.stream_stream_rpc_method_handler(
                lambda it, ctx: fn(it, ctx),
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b,
            )
        if method not in self._methods:
            return None
        fn = self._methods[method]
        return grpc.unary_unary_rpc_method_handler(
            lambda body, ctx: fn(body, ctx),
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        )
