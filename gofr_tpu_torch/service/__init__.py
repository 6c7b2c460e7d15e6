"""Outbound HTTP service client (counterpart of gofr_tpu/service).

``new_http_service(address, logger, metrics, *options)`` builds an
``HTTPService``; the App's ``add_http_service`` registers one on the
container under a name (``ctx.get_http_service(name)``). Every verb goes
through one instrumented path: the circuit breaker's check, W3C
``traceparent`` injection from the active span, the
``app_http_service_response`` histogram (path, method, status) and a
debug log line.

The sync verbs (``get``, ``post``, ``put``, ``patch``, ``delete``) run
urllib; the async ones (``aget``, ``apost``, ``aput``, ``adelete``) run
them in the loop's executor, so an async handler never blocks its loop.
``astream`` is asyncio-native over a keep-alive pool (``_AsyncConnPool``)
and returns a ``ServiceStream`` as soon as the upstream's head arrives:
the proxy path for token streams.

Options decorate the service: ``BasicAuth``, ``APIKeyAuth``, ``OAuth``
(client credentials), ``CustomHeaders``, ``HealthConfig`` (the health
endpoint, ``.well-known/alive`` by default), ``TLSConfig`` (a CA bundle,
a context, or verification off) and ``CircuitBreaker``: after
``threshold`` consecutive failures (transport errors and 5xx answers) it
opens and calls fail fast with ``CircuitOpenError``; a background thread
probes the health endpoint every ``interval`` seconds and closes it on
success. ``close()`` stops the probe and drops the pooled sockets.
"""

from __future__ import annotations

import asyncio
import base64
import json as jsonlib
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, AsyncIterator, Callable

from ..datasource import STATUS_DOWN, STATUS_UP, health

__all__ = [
    "HTTPService",
    "new_http_service",
    "Response",
    "ServiceStream",
    "BasicAuth",
    "APIKeyAuth",
    "OAuth",
    "CustomHeaders",
    "HealthConfig",
    "TLSConfig",
    "CircuitBreaker",
    "CircuitOpenError",
]


class Response:
    def __init__(self, status: int, headers: dict, body: bytes):
        self.status_code = status
        self.headers = headers
        self.body = body

    def json(self) -> Any:
        return jsonlib.loads(self.body)

    def text(self) -> str:
        return self.body.decode("utf-8", "replace")


class CircuitOpenError(Exception):
    def __init__(self, address: str):
        super().__init__(f"circuit breaker open for {address}")

    def status_code(self) -> int:
        return 503


class _AsyncConnPool:
    """Keep-alive connection pool for the streaming client (:meth:`HTTPService.astream`).

    One pool per service (one upstream address). Idle ``(reader, writer)``
    pairs are stacked LIFO — the hottest connection is reused first, so a
    steady request stream runs on O(concurrency) sockets instead of a
    dial per request (a per-request TCP+TLS handshake would dominate the
    hop cost of a proxy tier). Pairs are
    loop-bound: asyncio streams only work on the loop that created them,
    so a pool observed from a different running loop is flushed rather
    than handing out unusable sockets (multi-loop apps each re-dial).

    ``hits``/``dials`` counters verify reuse (the router exports them as
    ``app_http_service_conn_pool_total``).
    """

    def __init__(self, max_idle: int = 64, idle_ttl_s: float = 60.0):
        self.max_idle = max_idle
        self.idle_ttl_s = idle_ttl_s
        self._idle: list[tuple] = []  # (reader, writer, t_idle)
        self._loop = None
        self.hits = 0
        self.dials = 0

    def _flush(self) -> None:
        for _r, w, _t in self._idle:
            try:
                w.close()
            except Exception:  # noqa: BLE001 — teardown
                pass
        self._idle.clear()

    def acquire(self):
        """Pop a live idle pair for the CURRENT loop, or None (caller
        dials). Never blocks."""
        loop = asyncio.get_running_loop()
        if self._loop is not loop:
            self._flush()
            self._loop = loop
            return None
        now = time.monotonic()
        while self._idle:
            reader, writer, t = self._idle.pop()
            if now - t > self.idle_ttl_s or reader.at_eof() or (
                writer.transport is None or writer.transport.is_closing()
            ):
                try:
                    writer.close()
                except Exception:  # noqa: BLE001
                    pass
                continue
            return reader, writer
        return None

    def release(self, reader, writer) -> None:
        if (
            self._loop is not asyncio.get_running_loop()
            or len(self._idle) >= self.max_idle
            or reader.at_eof()
            or writer.transport is None
            or writer.transport.is_closing()
        ):
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass
            return
        self._idle.append((reader, writer, time.monotonic()))

    def close(self) -> None:
        """Close idle sockets, from any thread. asyncio transports may
        only be touched from their owning loop, so a cross-thread close
        (the fleet poll thread reaping a backend) marshals the flush
        onto the pool's loop; a closed loop's transports died with it."""
        loop = self._loop
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if loop is None or loop is running:
            self._flush()
            return
        idle, self._idle = self._idle, []

        def _close_all() -> None:
            for _r, w, _t in idle:
                try:
                    w.close()
                except Exception:  # noqa: BLE001 — teardown
                    pass

        try:
            loop.call_soon_threadsafe(_close_all)
        except RuntimeError:  # loop already closed
            pass

    def stats(self) -> dict:
        return {
            "idle": len(self._idle), "hits": self.hits, "dials": self.dials,
        }


class ServiceStream:
    """One in-flight streamed exchange from :meth:`HTTPService.astream`:
    status/headers up front, body chunks as the upstream produces them.

    The connection returns to the keep-alive pool only when the body is
    read to completion; :meth:`aclose` before that point ABORTS the
    socket, which is the disconnect signal a streaming LLM backend needs
    to cancel the abandoned generation."""

    def __init__(self, svc: "HTTPService", reader, writer, status: int,
                 headers: dict[str, str], *, method: str, reused: bool,
                 timeout: float):
        self._svc = svc
        self._reader = reader
        self._writer = writer
        self.status_code = status
        self.headers = headers
        self.reused = reused
        self._timeout = timeout
        self._method = method
        self._done = False
        self._closed = False
        te = headers.get("transfer-encoding", "").lower()
        self._chunked = "chunked" in te
        cl = headers.get("content-length", "")
        self._remaining = int(cl) if cl.isdigit() else None
        if method == "HEAD" or status in (204, 304):
            self._chunked = False
            self._remaining = 0
        # reusable: HTTP/1.1 keep-alive with a delimited body
        self._reusable = (
            headers.get("connection", "").lower() != "close"
            and (self._chunked or self._remaining is not None)
        )

    @property
    def streamed(self) -> bool:
        """True when the upstream did not pre-commit a length — the
        proxy must forward chunk-by-chunk rather than buffer."""
        return self._chunked

    async def _read(self, coro):
        return await asyncio.wait_for(coro, timeout=self._timeout)

    async def aiter_raw(self, max_chunk: int = 65536) -> AsyncIterator[bytes]:
        """Yield body bytes as the upstream produces them (chunked
        framing decoded). Releases the connection to the pool at EOF."""
        try:
            if self._chunked:
                while True:
                    size_line = await self._read(self._reader.readline())
                    hexpart = size_line.strip().split(b";")[0]
                    if not hexpart:
                        raise ConnectionError("bad chunk size from upstream")
                    size = int(hexpart, 16)
                    if size == 0:
                        while (await self._read(self._reader.readline())).strip():
                            pass  # trailers
                        break
                    while size > 0:
                        data = await self._read(
                            self._reader.read(min(size, max_chunk))
                        )
                        if not data:
                            raise ConnectionError("upstream closed mid-chunk")
                        size -= len(data)
                        yield data
                    await self._read(self._reader.readexactly(2))  # CRLF
            elif self._remaining is not None:
                while self._remaining > 0:
                    data = await self._read(
                        self._reader.read(min(self._remaining, max_chunk))
                    )
                    if not data:
                        raise ConnectionError("upstream closed mid-body")
                    self._remaining -= len(data)
                    yield data
            else:  # close-delimited: read to EOF, connection not reusable
                while True:
                    data = await self._read(self._reader.read(max_chunk))
                    if not data:
                        break
                    yield data
            self._done = True
        finally:
            await self.aclose()

    async def aread(self) -> bytes:
        return b"".join([c async for c in self.aiter_raw()])

    async def aclose(self) -> None:
        """Release (body fully read) or abort (mid-body) the connection.
        Idempotent — the proxy's finally path and aiter_raw's EOF path
        both land here."""
        if self._closed:
            return
        self._closed = True
        if self._done and self._reusable:
            self._svc._pool.release(self._reader, self._writer)
        else:
            try:
                self._writer.close()
            except Exception:  # noqa: BLE001 — teardown must not mask
                pass


class HTTPService:
    """Core client; options decorate it (options.go pattern: each option's
    apply() mutates/wraps behavior)."""

    def __init__(self, address: str, logger=None, metrics=None, tracer=None):
        self.address = address.rstrip("/")
        self.logger = logger
        self.metrics = metrics
        self.tracer = tracer
        self._pool = _AsyncConnPool()
        self.static_headers: dict[str, str] = {}
        self.auth_header: Callable[[], dict[str, str]] | None = None
        self.health_endpoint = ".well-known/alive"
        self.circuit: CircuitBreaker | None = None
        # TLS for https addresses: None uses urllib's default verification;
        # an ssl.SSLContext (e.g. with a private CA) overrides it — the
        # reference's TLSConfig seam on its http.Client (service/new.go:68-89)
        self.tls_context = None

    # -- request path (new.go:135-195) ------------------------------------
    def _headers(self, headers: dict | None) -> dict:
        out = dict(self.static_headers)
        if self.auth_header is not None:
            out.update(self.auth_header())
        if headers:
            out.update(headers)
        # traceparent injection (new.go:158)
        try:
            from ..tracing import current_span

            span = current_span()
            if span is not None:
                out.setdefault(
                    "traceparent", f"00-{span.trace_id}-{span.span_id}-01"
                )
        except Exception:  # noqa: BLE001
            pass
        return out

    def request(
        self,
        method: str,
        path: str,
        *,
        params: dict | None = None,
        json: Any = None,
        body: bytes | None = None,
        headers: dict | None = None,
        timeout: float = 10.0,
        _health_probe: bool = False,
    ) -> Response:
        if self.circuit is not None and not _health_probe:
            self.circuit.precheck(self)
        url = f"{self.address}/{path.lstrip('/')}"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        data = jsonlib.dumps(json).encode() if json is not None else body
        hdrs = self._headers(headers)
        if json is not None:
            hdrs.setdefault("Content-Type", "application/json")
        req = urllib.request.Request(url, method=method, data=data, headers=hdrs)
        t0 = time.perf_counter()
        status = 0
        try:
            with urllib.request.urlopen(
                req, timeout=timeout, context=self.tls_context
            ) as resp:
                out = Response(resp.status, dict(resp.headers), resp.read())
        except urllib.error.HTTPError as e:
            out = Response(e.code, dict(e.headers), e.read())
        except Exception:
            if self.circuit is not None and not _health_probe:
                self.circuit.record_failure(self)
            self._observe(method, path, 0, t0)
            raise
        status = out.status_code
        if self.circuit is not None and not _health_probe:
            if status >= 500:
                self.circuit.record_failure(self)
            else:
                self.circuit.record_success()
        self._observe(method, path, status, t0)
        return out

    def _observe(self, method: str, path: str, status: int, t0: float) -> None:
        dt = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.record_histogram(
                "app_http_service_response", dt,
                path=path, method=method, status=str(status),
            )
        if self.logger is not None:
            self.logger.debug(
                {
                    "type": "http-service", "method": method,
                    "uri": f"{self.address}/{path.lstrip('/')}",
                    "response_code": status,
                    "response_time_us": round(dt * 1e6),
                }
            )

    # -- verbs ------------------------------------------------------------
    def get(self, path: str, **kw) -> Response:
        return self.request("GET", path, **kw)

    def post(self, path: str, **kw) -> Response:
        return self.request("POST", path, **kw)

    def put(self, path: str, **kw) -> Response:
        return self.request("PUT", path, **kw)

    def patch(self, path: str, **kw) -> Response:
        return self.request("PATCH", path, **kw)

    def delete(self, path: str, **kw) -> Response:
        return self.request("DELETE", path, **kw)

    # -- async facades ----------------------------------------------------
    async def aget(self, path: str, **kw) -> Response:
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.get(path, **kw)
        )

    async def apost(self, path: str, **kw) -> Response:
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.post(path, **kw)
        )

    async def aput(self, path: str, **kw) -> Response:
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.put(path, **kw)
        )

    async def adelete(self, path: str, **kw) -> Response:
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.delete(path, **kw)
        )

    # -- pooled keep-alive streaming --------------------------------------
    def pool_stats(self) -> dict:
        return self._pool.stats()

    def close(self) -> None:
        """Drop pooled keep-alive sockets and stop the breaker's probe
        loop. Safe from any thread — the pool marshals transport
        teardown onto its owning loop."""
        self._pool.close()
        if self.circuit is not None:
            self.circuit.close()

    def _hostport(self) -> tuple[str, int, bool]:
        parts = urllib.parse.urlsplit(self.address)
        tls = parts.scheme == "https"
        return parts.hostname or "", parts.port or (443 if tls else 80), tls

    async def _dial(self, timeout: float):
        host, port, tls = self._hostport()
        ssl_ctx = None
        if tls:
            import ssl

            ssl_ctx = self.tls_context or ssl.create_default_context()
        return await asyncio.wait_for(
            asyncio.open_connection(host, port, ssl=ssl_ctx), timeout=timeout
        )

    def _count_pool(self, result: str) -> None:
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_http_service_conn_pool_total",
                result=result, address=self.address,
            )

    async def astream(
        self,
        method: str,
        path: str,
        *,
        params: dict | None = None,
        json: Any = None,
        body: bytes | None = None,
        headers: dict | None = None,
        timeout: float = 30.0,
        metric_path: str | None = None,
    ) -> ServiceStream:
        """Asyncio-native request over a pooled keep-alive connection,
        returning status+headers as soon as the upstream sends them and
        the body as a chunk stream (:class:`ServiceStream`).

        This is the streaming/proxy hot path: unlike the urllib verbs it
        never parks a thread per in-flight request (a proxy tier carries
        thousands), reuses pooled sockets (``pool_stats()`` /
        ``app_http_service_conn_pool_total`` verify), and hands the
        caller the unread body so chunks can be forwarded as they
        arrive. Circuit breaker, traceparent injection, and the
        app_http_service_response histogram behave exactly like
        :meth:`request`. A reused socket that turns out stale (upstream
        closed it while idle) is redialed once, transparently."""
        if self.circuit is not None:
            self.circuit.precheck(self)
        target = "/" + path.lstrip("/")
        if params:
            target += "?" + urllib.parse.urlencode(params)
        # histogram label: `path` here may be CLIENT-controlled (the
        # router proxies the inbound target verbatim) — as a metric
        # label every distinct URL+query would mint a new series, an
        # unbounded-cardinality leak any scanner can drive. Callers
        # with attacker-reachable paths pass a fixed metric_path; the
        # query is stripped for everyone else.
        mpath = metric_path if metric_path is not None else path.split("?", 1)[0]
        data = jsonlib.dumps(json).encode() if json is not None else body
        hdrs = self._headers(headers)
        if json is not None:
            hdrs.setdefault("Content-Type", "application/json")
        host, port, _tls = self._hostport()
        t0 = time.perf_counter()
        pooled = self._pool.acquire()
        attempt_reuse = pooled is not None
        try:
            if pooled is None:
                pooled = await self._dial(timeout)
                self._pool.dials += 1
                self._count_pool("dial")
            else:
                self._pool.hits += 1
                self._count_pool("hit")
            try:
                stream = await self._exchange(
                    pooled, method, target, hdrs, data,
                    host=f"{host}:{port}", timeout=timeout,
                    reused=attempt_reuse,
                )
            except (ConnectionError, asyncio.IncompleteReadError) as e:
                # NOT OSError: on 3.11+ TimeoutError subclasses OSError,
                # and a response-header timeout is a SLOW backend, not a
                # stale socket — re-sending a non-idempotent request
                # there would run the work twice. Likewise any PARTIAL
                # response bytes prove the backend accepted the request
                # and began work before the connection died mid-reply.
                partial = getattr(e, "partial", b"")
                if isinstance(e, TimeoutError) or partial or not attempt_reuse:
                    raise
                # stale keep-alive socket: redial once and retry whole-
                # request (nothing of the response had arrived, and the
                # request body is bytes, so the resend is identical)
                try:
                    pooled[1].close()
                except Exception:  # noqa: BLE001
                    pass
                pooled = await self._dial(timeout)
                self._pool.dials += 1
                self._count_pool("dial")
                stream = await self._exchange(
                    pooled, method, target, hdrs, data,
                    host=f"{host}:{port}", timeout=timeout, reused=False,
                )
        except CircuitOpenError:
            raise
        except Exception:
            # a failed exchange must not leak the socket: the transport
            # would stay registered with the loop (fd build-up against a
            # sick backend), and the upstream would never see the
            # disconnect — an abandoned generation would decode to
            # completion behind a timeout.
            if pooled is not None:
                try:
                    pooled[1].close()
                except Exception:  # noqa: BLE001 — teardown
                    pass
            if self.circuit is not None:
                self.circuit.record_failure(self)
            self._observe(method, mpath, 0, t0)
            raise
        if self.circuit is not None:
            if stream.status_code >= 500:
                self.circuit.record_failure(self)
            else:
                self.circuit.record_success()
        self._observe(method, mpath, stream.status_code, t0)
        return stream

    async def _exchange(
        self, pooled, method: str, target: str, hdrs: dict, data: bytes | None,
        *, host: str, timeout: float, reused: bool,
    ) -> ServiceStream:
        reader, writer = pooled
        head = [f"{method} {target} HTTP/1.1\r\nHost: {host}\r\n"]
        lower = {k.lower() for k in hdrs}
        if "content-length" not in lower:
            head.append(f"Content-Length: {len(data) if data else 0}\r\n")
        for k, v in hdrs.items():
            head.append(f"{k}: {v}\r\n")
        head.append("\r\n")
        writer.write("".join(head).encode("latin-1") + (data or b""))
        await asyncio.wait_for(writer.drain(), timeout=timeout)
        block = await asyncio.wait_for(
            reader.readuntil(b"\r\n\r\n"), timeout=timeout
        )
        lines = block.decode("latin-1").split("\r\n")
        status_parts = lines[0].split(" ", 2)
        if len(status_parts) < 2 or not status_parts[1].isdigit():
            raise ConnectionError(f"malformed status line: {lines[0]!r}")
        status = int(status_parts[1])
        resp_headers: dict[str, str] = {}
        for line in lines[1:]:
            if not line or ":" not in line:
                continue
            k, _, v = line.partition(":")
            resp_headers[k.strip().lower()] = v.strip()
        if not status_parts[0].startswith("HTTP/1.1"):
            resp_headers.setdefault("connection", "close")
        return ServiceStream(
            self, reader, writer, status, resp_headers,
            method=method, reused=reused, timeout=timeout,
        )

    # -- health (service/health.go:18-49) ----------------------------------
    def health_check_sync(self) -> dict:
        try:
            t0 = time.perf_counter()
            resp = self.request("GET", self.health_endpoint, timeout=5.0, _health_probe=True)
            ok = resp.status_code < 400
            return health(
                STATUS_UP if ok else STATUS_DOWN,
                host=self.address,
                status_code=resp.status_code,
                latency_ms=round((time.perf_counter() - t0) * 1e3, 2),
                **(
                    {"circuit": self.circuit.state}
                    if self.circuit is not None
                    else {}
                ),
            )
        except Exception as e:  # noqa: BLE001
            return health(STATUS_DOWN, host=self.address, error=str(e))


# -- options (decorator pattern, options.go) --------------------------------


class BasicAuth:
    def __init__(self, user: str, password: str):
        self.user, self.password = user, password

    def apply(self, svc: HTTPService) -> None:
        token = base64.b64encode(f"{self.user}:{self.password}".encode()).decode()
        svc.auth_header = lambda: {"Authorization": f"Basic {token}"}


class APIKeyAuth:
    def __init__(self, key: str):
        self.key = key

    def apply(self, svc: HTTPService) -> None:
        svc.auth_header = lambda: {"X-API-KEY": self.key}


class OAuth:
    """Client-credentials flow (oauth.go:233-...): fetch + cache a bearer
    token from token_url, refresh when expired."""

    def __init__(self, client_id: str, client_secret: str, token_url: str, scopes: list[str] | None = None):
        self.client_id = client_id
        self.client_secret = client_secret
        self.token_url = token_url
        self.scopes = scopes or []
        self._token: str | None = None
        self._expiry = 0.0
        self._lock = threading.Lock()

    def _fetch(self) -> None:
        data = urllib.parse.urlencode(
            {
                "grant_type": "client_credentials",
                "client_id": self.client_id,
                "client_secret": self.client_secret,
                **({"scope": " ".join(self.scopes)} if self.scopes else {}),
            }
        ).encode()
        req = urllib.request.Request(self.token_url, method="POST", data=data)
        with urllib.request.urlopen(req, timeout=10) as resp:
            payload = jsonlib.loads(resp.read())
        self._token = payload["access_token"]
        self._expiry = time.time() + float(payload.get("expires_in", 3600)) - 30

    def token(self) -> str:
        with self._lock:
            if self._token is None or time.time() >= self._expiry:
                self._fetch()
            assert self._token is not None
            return self._token

    def apply(self, svc: HTTPService) -> None:
        svc.auth_header = lambda: {"Authorization": f"Bearer {self.token()}"}


class CustomHeaders:
    def __init__(self, headers: dict[str, str]):
        self.headers = headers

    def apply(self, svc: HTTPService) -> None:
        svc.static_headers.update(self.headers)


class HealthConfig:
    def __init__(self, endpoint: str):
        self.endpoint = endpoint

    def apply(self, svc: HTTPService) -> None:
        svc.health_endpoint = endpoint_strip(self.endpoint)


class TLSConfig:
    """Option: TLS settings for https addresses — a ready SSLContext, a
    private CA bundle, or (dev only) verification off. Mirrors the
    reference's TLSConfig on its http.Client (service/new.go:68-89)."""

    def __init__(self, context=None, *, ca_cert: str | None = None,
                 insecure: bool = False):
        import ssl

        if context is None:
            context = ssl.create_default_context(cafile=ca_cert)
            if insecure:
                context.check_hostname = False
                context.verify_mode = ssl.CERT_NONE
        self.context = context

    def apply(self, svc: HTTPService) -> None:
        svc.tls_context = self.context


def endpoint_strip(e: str) -> str:
    return e.lstrip("/")


class CircuitBreaker:
    """Open after `threshold` consecutive 5xx/transport failures; while open,
    requests fail fast with CircuitOpenError and a background thread probes
    the health endpoint every `interval` seconds, closing on success
    (circuit_breaker.go:24-158)."""

    def __init__(self, threshold: int = 5, interval: float = 10.0):
        self.threshold = threshold
        self.interval = interval
        self.failures = 0
        self.state = "closed"
        self._lock = threading.Lock()
        self._probe_thread: threading.Thread | None = None
        self._closed = False
        self._stop = threading.Event()  # wakes the probe's wait at close()

    def close(self) -> None:
        """Stop the probe loop: a breaker whose service was torn down
        must not keep dialing a dead address."""
        with self._lock:
            self._closed = True
        self._stop.set()

    def apply(self, svc: HTTPService) -> None:
        svc.circuit = self

    def precheck(self, svc: HTTPService) -> None:
        with self._lock:
            if self.state == "open":
                raise CircuitOpenError(svc.address)

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self.state = "closed"

    def record_failure(self, svc: HTTPService) -> None:
        with self._lock:
            self.failures += 1
            if self.failures >= self.threshold and self.state != "open":
                self.state = "open"
                self._start_probe(svc)

    def _start_probe(self, svc: HTTPService) -> None:
        if self._probe_thread is not None and self._probe_thread.is_alive():
            return

        def probe():
            while True:
                self._stop.wait(self.interval)
                with self._lock:
                    if self._closed or self.state != "open":
                        return
                h = svc.health_check_sync()
                if h["status"] == STATUS_UP:
                    self.record_success()
                    if svc.logger is not None:
                        svc.logger.info(f"circuit closed for {svc.address}")
                    return

        self._probe_thread = threading.Thread(target=probe, daemon=True, name="gofr-breaker-probe")
        self._probe_thread.start()


def new_http_service(address: str, logger=None, metrics=None, *options, tracer=None) -> HTTPService:
    """NewHTTPService (new.go:68-89): construct + apply option decorators."""
    if metrics is not None:
        from ..metrics import HTTP_BUCKETS

        metrics.new_histogram(
            "app_http_service_response", "outbound http call time s", HTTP_BUCKETS
        )
        metrics.new_counter(
            "app_http_service_conn_pool_total",
            "streaming-path connections by result (hit=keep-alive reuse, dial=new socket)",
        )
    svc = HTTPService(address, logger, metrics, tracer)
    for opt in options:
        opt.apply(svc)
    return svc
