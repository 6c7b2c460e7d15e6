"""Distributed tracing: spans, W3C trace-context propagation, exporters
(a copy of gofr_tpu/tracing/__init__.py: the port imports nothing of the
JAX package; the span and exporter wire forms are the same).

Parity: reference tracing glue (gofr.go:288-338 TracerProvider + exporter
switch jaeger|zipkin|gofr; exporter.go:36-100 custom JSON exporter;
middleware/tracer.go:15-32 traceparent extraction; service/new.go:158
injection; context.go:45-51 user spans via ctx.trace()).

Self-contained implementation: spans are plain objects, the active span lives
in a contextvar (works across asyncio tasks), and a batch exporter thread
ships finished spans. When TRACE_EXPORTER is unset the cost per span is one
object + two clock reads — cheap enough for the serving hot path.
"""

from __future__ import annotations

import contextvars
import json
import os
import queue
import threading
import time
import urllib.request
from typing import Any

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar("gofr_current_span", default=None)

_TRACEPARENT_RE_VERSION = "00"


def _rand_hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start_ns", "end_ns", "attributes", "status", "links", "_token", "_tracer")

    def __init__(self, name: str, trace_id: str, span_id: str, parent_id: str | None, tracer: "Tracer | None"):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.attributes: dict[str, Any] = {}
        self.status = "OK"
        self.links: list[tuple[str, str]] | None = None
        self._token = None
        self._tracer = tracer

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_link(self, trace_id: str, span_id: str) -> None:
        """Causal link to another span (possibly in another trace) — the
        OTel span-link: a failover continuation links the original request
        span so a multi-hop journey reads as one object even if a seam
        ever re-roots the trace."""
        if self.links is None:
            self.links = []
        self.links.append((trace_id, span_id))

    def set_status(self, status: str) -> None:
        self.status = status

    def end(self) -> None:
        if self.end_ns:
            return
        self.end_ns = time.time_ns()
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        if self._tracer is not None:
            self._tracer._on_end(self)

    # context-manager sugar: `with ctx.trace("name"):`
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.status = "ERROR"
            self.attributes.setdefault("error", repr(exc))
        self.end()

    @property
    def traceparent(self) -> str:
        return f"{_TRACEPARENT_RE_VERSION}-{self.trace_id}-{self.span_id}-01"

    @property
    def duration_us(self) -> int:
        end = self.end_ns or time.time_ns()
        return (end - self.start_ns) // 1000


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """-> (trace_id, parent_span_id) or None. W3C: version-traceid-spanid-flags."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if int(trace_id, 16) == 0:
        return None
    return trace_id.lower(), span_id.lower()


class Exporter:
    def export(self, spans: list[Span]) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class InMemoryExporter(Exporter):
    def __init__(self):
        self.spans: list[Span] = []

    def export(self, spans: list[Span]) -> None:
        self.spans.extend(spans)


class ConsoleExporter(Exporter):
    def __init__(self, logger=None):
        self._logger = logger

    def export(self, spans: list[Span]) -> None:
        for s in spans:
            line = f"trace={s.trace_id} span={s.span_id} name={s.name} dur={s.duration_us}us"
            if self._logger:
                self._logger.debug(line)


class ZipkinExporter(Exporter):
    """POSTs Zipkin-v2 JSON spans. Parity: reference exporter.go:36-100
    (its custom 'gofr' exporter is zipkin-shaped JSON)."""

    def __init__(self, endpoint: str, service_name: str):
        self.endpoint = endpoint
        self.service_name = service_name

    def export(self, spans: list[Span]) -> None:
        payload = [
            {
                "traceId": s.trace_id,
                "id": s.span_id,
                "parentId": s.parent_id,
                "name": s.name,
                "timestamp": s.start_ns // 1000,
                "duration": s.duration_us,
                "localEndpoint": {"serviceName": self.service_name},
                "tags": {
                    **{str(k): str(v) for k, v in s.attributes.items()},
                    **(
                        {
                            f"link.{i}": f"{t}/{sp}"
                            for i, (t, sp) in enumerate(s.links)
                        }
                        if s.links
                        else {}
                    ),
                },
            }
            for s in spans
        ]
        req = urllib.request.Request(
            self.endpoint,
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=5):  # noqa: S310
            pass


class OTLPHTTPExporter(Exporter):
    """POSTs OTLP/HTTP JSON (the protocol's documented JSON encoding) to a
    collector — Jaeger natively ingests OTLP, so this is the build's
    TRACE_EXPORTER=jaeger path (reference gofr.go:305-311 uses OTLP-gRPC;
    OTLP/HTTP carries the same payload without a generated-proto dependency)."""

    def __init__(self, endpoint: str, service_name: str):
        self.endpoint = endpoint  # e.g. http://host:4318/v1/traces
        self.service_name = service_name

    def export(self, spans: list[Span]) -> None:
        payload = {
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": [
                            {
                                "key": "service.name",
                                "value": {"stringValue": self.service_name},
                            }
                        ]
                    },
                    "scopeSpans": [
                        {
                            "scope": {"name": "gofr-tpu"},
                            "spans": [
                                {
                                    "traceId": s.trace_id,
                                    "spanId": s.span_id,
                                    **(
                                        {"parentSpanId": s.parent_id}
                                        if s.parent_id
                                        else {}
                                    ),
                                    "name": s.name,
                                    "kind": 2,  # SPAN_KIND_SERVER
                                    "startTimeUnixNano": str(s.start_ns),
                                    "endTimeUnixNano": str(s.end_ns or s.start_ns),
                                    "attributes": [
                                        {
                                            "key": str(k),
                                            "value": {"stringValue": str(v)},
                                        }
                                        for k, v in s.attributes.items()
                                    ],
                                    "status": {
                                        "code": 2 if s.status == "ERROR" else 1
                                    },
                                    **(
                                        {
                                            "links": [
                                                {
                                                    "traceId": t,
                                                    "spanId": sp,
                                                }
                                                for t, sp in s.links
                                            ]
                                        }
                                        if s.links
                                        else {}
                                    ),
                                }
                                for s in spans
                            ],
                        }
                    ],
                }
            ]
        }
        req = urllib.request.Request(
            self.endpoint,
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=5):  # noqa: S310
            pass


def span_to_dict(s: Span) -> dict:
    """Wire/debug form of a finished span — what the journey ring stores
    and `GET /.well-known/debug/traces` serves."""
    d = {
        "trace_id": s.trace_id,
        "span_id": s.span_id,
        "parent_id": s.parent_id,
        "name": s.name,
        "start_ns": s.start_ns,
        "end_ns": s.end_ns or s.start_ns,
        "duration_us": s.duration_us,
        "status": s.status,
        "attributes": {str(k): v for k, v in s.attributes.items()},
    }
    if s.links:
        d["links"] = [{"trace_id": t, "span_id": sp} for t, sp in s.links]
    return d


class RingExporter:
    """Bounded per-process span store: the last `capacity` finished spans,
    queryable by trace id, served at GET /.well-known/debug/traces.

    Unlike the push exporters this is not fed through the BatchProcessor
    thread — Tracer._on_end appends synchronously (one deque append under
    a small lock), so it tees alongside ANY configured exporter, including
    none, and a journey is queryable the instant its spans end. The fleet
    aggregator (the front router) fans the same query over every backend
    and stitches the fragments: p99 spike -> exemplar trace id -> full
    cross-process timeline with zero external infra."""

    def __init__(self, capacity: int = 2048, service_name: str = ""):
        from collections import deque

        self.capacity = int(capacity)
        self.service_name = service_name
        self._lock = threading.Lock()
        self._spans: "deque[dict]" = deque(maxlen=max(1, self.capacity))

    def on_end(self, span: Span) -> None:
        d = span_to_dict(span)
        if self.service_name:
            d["service"] = self.service_name
        with self._lock:
            self._spans.append(d)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def query(self, trace_id: str) -> list[dict]:
        tid = (trace_id or "").strip().lower()
        with self._lock:
            return [s for s in self._spans if s["trace_id"] == tid]

    def trace_ids(self, limit: int = 64) -> list[dict]:
        """Most-recent-first summary of distinct trace ids in the ring."""
        with self._lock:
            spans = list(self._spans)
        seen: dict[str, dict] = {}
        for s in spans:  # oldest -> newest; newest wins the root name
            e = seen.setdefault(
                s["trace_id"],
                {"trace_id": s["trace_id"], "spans": 0, "root": s["name"]},
            )
            e["spans"] += 1
            if not s.get("parent_id"):
                e["root"] = s["name"]
        out = list(seen.values())[::-1]
        return out[: max(0, int(limit))]

    def dump(self, limit: int = 512) -> list[dict]:
        """Last `limit` finished spans, oldest -> newest: the trace
        section of a black-box incident bundle (flightrec) —
        the raw material a post-mortem re-stitches journeys from after
        the process that held the ring is gone."""
        with self._lock:
            spans = list(self._spans)
        return spans[-max(0, int(limit)):]

    def clear(self) -> int:
        """Flush the ring (shutdown path — the dead-engine-gauge rule:
        no stale journey fragments survive the process's serving life)."""
        with self._lock:
            n = len(self._spans)
            self._spans.clear()
        return n

    def stats(self) -> dict:
        with self._lock:
            return {"spans": len(self._spans), "capacity": self.capacity}


def stitch_spans(spans: list[dict]) -> dict:
    """Stitch span fragments (possibly from many processes) into one
    parent-linked journey tree. Children sort by start time; spans whose
    parent is absent from the set become roots (the fragment boundary).
    A well-threaded journey — router hop -> llm.request -> phases, with
    continuations parented under the original request span — yields
    exactly ONE root."""
    by_id: dict[str, dict] = {}
    nodes: list[dict] = []
    for s in sorted(spans, key=lambda s: s.get("start_ns", 0)):
        node = dict(s)
        node["children"] = []
        # keep first occurrence on span-id collision (dup fan-in replies)
        if node.get("span_id") in by_id:
            continue
        by_id[node["span_id"]] = node
        nodes.append(node)
    roots: list[dict] = []
    for node in nodes:
        parent = by_id.get(node.get("parent_id") or "")
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    trace_ids = sorted({n["trace_id"] for n in nodes})
    processes = sorted(
        {str(n.get("process") or n.get("service") or "") for n in nodes} - {""}
    )
    return {
        "trace_id": trace_ids[0] if len(trace_ids) == 1 else trace_ids,
        "span_count": len(nodes),
        "processes": processes,
        "roots": roots,
    }


class BatchProcessor:
    """Queues ended spans; a daemon thread flushes batches to the exporter.
    Parity: reference batch span processor (gofr.go:318)."""

    def __init__(self, exporter: Exporter, max_batch: int = 512, interval_s: float = 2.0):
        self._exporter = exporter
        self._queue: queue.Queue[Span] = queue.Queue(maxsize=8192)
        self._max_batch = max_batch
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="gofr-trace-export")
        self._thread.start()

    def on_end(self, span: Span) -> None:
        try:
            self._queue.put_nowait(span)
        except queue.Full:
            pass  # drop rather than block the hot path

    def _drain(self) -> list[Span]:
        batch: list[Span] = []
        while len(batch) < self._max_batch:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return batch

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._flush()
        self._flush()

    def _flush(self) -> None:
        batch = self._drain()
        if batch:
            try:
                self._exporter.export(batch)
            except Exception:  # noqa: BLE001 - exporter failures must not kill serving
                pass

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self._flush()
        self._exporter.shutdown()


class Tracer:
    """Factory for spans; owns the processor. One per app."""

    def __init__(self, service_name: str = "gofr-tpu-app", processor: BatchProcessor | None = None, ring: RingExporter | None = None):
        self.service_name = service_name
        self._processor = processor
        self.ring = ring

    def start_span(self, name: str, *, traceparent: str | None = None, attributes: dict | None = None) -> Span:
        parent = _current_span.get()
        if parent is not None and parent.end_ns == 0:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            ctx = parse_traceparent(traceparent)
            if ctx:
                trace_id, parent_id = ctx
            else:
                trace_id, parent_id = _rand_hex(16), None
        span = Span(name, trace_id, _rand_hex(8), parent_id, self)
        if attributes:
            span.attributes.update(attributes)
        span._token = _current_span.set(span)
        return span

    def start_detached_span(
        self, name: str, *, parent: tuple[str, str] | None = None,
        attributes: dict | None = None,
    ) -> Span:
        """A span that does NOT become the active contextvar span. For work
        that outlives the submitting call and ends on another thread (the
        LLM engine's scheduler/collector): the caller captures its trace
        context once — (trace_id, span_id) — and every later phase span is
        parented explicitly instead of through the contextvar, which does
        not flow across plain threads. end() still ships to the exporter."""
        trace_id, parent_id = parent if parent else (_rand_hex(16), None)
        span = Span(name, trace_id, _rand_hex(8), parent_id, self)
        if attributes:
            span.attributes.update(attributes)
        return span

    def record_span(
        self, name: str, *, trace_id: str, parent_id: str | None,
        start_ns: int, end_ns: int, attributes: dict | None = None,
        status: str = "OK", links: list[tuple[str, str]] | None = None,
    ) -> Span:
        """Record an already-elapsed interval as a finished span — the
        retrospective form the engine uses for phases it only measures
        after the fact (a decode chunk's dispatch->fetch window is known
        when the fetch completes, on a different thread from dispatch)."""
        span = Span(name, trace_id, _rand_hex(8), parent_id, None)
        span.start_ns = start_ns
        span.end_ns = max(end_ns, start_ns)
        if attributes:
            span.attributes.update(attributes)
        if links:
            span.links = list(links)
        span.status = status
        self._on_end(span)
        return span

    def _on_end(self, span: Span) -> None:
        if self.ring is not None:
            self.ring.on_end(span)
        if self._processor is not None:
            self._processor.on_end(span)

    def shutdown(self) -> None:
        if self._processor is not None:
            self._processor.shutdown()
        if self.ring is not None:
            self.ring.clear()


def current_span() -> Span | None:
    return _current_span.get()


def new_tracer(config, logger=None) -> Tracer:
    """Build tracer from config. TRACE_EXPORTER switch matches the
    reference's jaeger|zipkin|gofr (gofr.go:305-316) plus console|memory
    dev exporters: jaeger/otlp -> OTLP/HTTP JSON, zipkin -> Zipkin-v2 JSON,
    gofr -> the reference's hosted zipkin-shaped endpoint (exporter.go:36)."""
    name = (config.get("APP_NAME") or "gofr-tpu-app") if config else "gofr-tpu-app"
    exporter_kind = (config.get("TRACE_EXPORTER") or "").lower() if config else ""
    exporter: Exporter | None = None
    if exporter_kind == "zipkin":
        host = config.get_or_default("TRACER_HOST", "localhost")
        port = config.get_or_default("TRACER_PORT", "9411")
        url = config.get_or_default("TRACER_URL", f"http://{host}:{port}/api/v2/spans")
        exporter = ZipkinExporter(url, name)
    elif exporter_kind in ("jaeger", "otlp"):
        host = config.get_or_default("TRACER_HOST", "localhost")
        port = config.get_or_default("TRACER_PORT", "4318")
        url = config.get_or_default(
            "TRACER_URL", f"http://{host}:{port}/v1/traces"
        )
        exporter = OTLPHTTPExporter(url, name)
    elif exporter_kind == "gofr":
        url = config.get_or_default(
            "TRACER_URL", "https://tracer-api.gofr.dev/api/spans"
        )
        exporter = ZipkinExporter(url, name)
    elif exporter_kind == "console":
        exporter = ConsoleExporter(logger)
    elif exporter_kind == "memory":
        exporter = InMemoryExporter()
    # Journey ring: on by default (it IS the zero-infra trace store the
    # debug/traces endpoint and the fleet stitcher read); TRACE_RING_SPANS=0
    # opts out, any other value sizes the ring.
    try:
        ring_cap = int(
            config.get_or_default("TRACE_RING_SPANS", "2048") if config else 2048
        )
    except (TypeError, ValueError):
        ring_cap = 2048
    ring = RingExporter(ring_cap, name) if ring_cap > 0 else None
    if exporter is None:
        return Tracer(name, None, ring)
    proc = BatchProcessor(exporter)
    t = Tracer(name, proc, ring)
    t.exporter = exporter  # type: ignore[attr-defined] - exposed for tests
    return t
