"""Front router: horizontal scale-out over independent engine processes
(counterpart of gofr_tpu/router/__init__.py).

A stateless process that load-balances over N engine processes through
the framework's own outbound client (``service``: pooled keep-alive
sockets, a circuit breaker per backend). It holds no CUDA context: the
engines own the card, each in its own process, so a process that dies (a
kill, a sticky device fault) takes only its own streams with it. Per
request, in order:

1. **Fleet admission**: the predicted queue wait pooled across processes
   (queued tokens over summed measured throughput) sheds with a
   Retry-After priced from the fleet's throughput
   (``TPU_ROUTER_SHED_WAIT_S``); front-door tenant quotas
   (``TPU_ROUTER_TENANT_QUOTA_TOK_S``) shed a tenant over its fleet-wide
   token rate, read from every backend's usage route (TTL-cached).
2. **Routing**: an ``X-GoFr-Session`` request goes to its rendezvous-ring
   owner (the process holding the conversation's KV blocks), anything
   else to the backend with the fewest queued tokens.
3. **Dispatch**: headers forwarded (traceparent re-stamped to the
   ``router.proxy`` span, ``X-GoFr-*`` identity through to the engine's
   fair ledger, ``X-Forwarded-For`` appended), bodies streamed chunk by
   chunk, a client disconnect aborting the upstream socket so the engine
   retires the request.
4. **Recovery**: a transport error, an open breaker or a 5xx re-dispatches
   to another backend under a retry budget; a 503 sets a local cooldown
   from its Retry-After and falls through (surfacing only when no other
   backend can take the request); a 429 surfaces with the backend's
   Retry-After; an upstream timeout surfaces and is never re-dispatched
   (the slow backend may still be running the request).

``TPU_ROUTER_ENGINE_CMD`` turns on the autoscaler (``autoscaler.py``),
which launches and drains engine processes between
``TPU_ROUTER_{MIN,MAX}_REPLICAS``. Run it with ``python -m
gofr_tpu_torch.router``.
"""

from __future__ import annotations

import asyncio
import os
import threading
import time

from ..http.errors import ErrorServiceUnavailable, ErrorTooManyRequests
from ..http.responder import Response
from ..resilience.overload import OverloadController, RetryBudget
from ..service import CircuitOpenError
from .autoscaler import DEFAULT_ENGINE_CMD, Autoscaler, ProcessLauncher, free_port
from .fleet import Backend, FleetView
from .ring import HashRing

__all__ = [
    "FrontRouter",
    "new_router_app",
    "FleetView",
    "Backend",
    "HashRing",
    "Autoscaler",
    "ProcessLauncher",
    "DEFAULT_ENGINE_CMD",
    "free_port",
]

# hop-by-hop headers (RFC 9110 §7.6.1), the framing the proxy re-derives,
# the traceparent (re-stamped to the hop's span) and X-Forwarded-For
# (appended to, not forwarded twice)
_STRIP_REQUEST = frozenset((
    "connection", "keep-alive", "proxy-connection", "transfer-encoding", "te", "trailer", "upgrade", "host",
    "content-length", "expect", "traceparent", "x-forwarded-for",
))
_STRIP_RESPONSE = frozenset(("connection", "keep-alive", "transfer-encoding", "content-length"))


class _GuardedStream:
    """A body iterator whose cleanup runs exactly once, at exhaustion,
    failure or close, even if iteration never began. Not an async
    generator: ``aclose()`` on an un-started generator skips its
    ``finally``, and a client that leaves before the first chunk closes
    the stream un-started; the proxy parks the upstream abort, the load
    decrement and the in-flight slot here."""

    def __init__(self, inner, cleanup):
        self._inner = inner
        self._cleanup = cleanup
        self._done = False

    def __aiter__(self):
        return self

    async def __anext__(self):
        if self._done:
            raise StopAsyncIteration
        try:
            return await self._inner.__anext__()
        except BaseException:
            # exhaustion and upstream failure alike free the resources now
            await self.aclose()
            raise

    async def aclose(self) -> None:
        if self._done:
            return
        self._done = True
        aclose = getattr(self._inner, "aclose", None)  # a started generator's own finally
        if aclose is not None:
            try:
                await aclose()
            except Exception:  # noqa: BLE001 — the cleanup below must still run
                pass
        await self._cleanup()


class FrontRouter:
    """The routing core: fleet view, admission, retry policy and the
    autoscaler, shared by every proxied request."""

    def __init__(self, config, *, logger=None, metrics=None, now_fn=time.monotonic, service_factory=None):
        self.logger = logger
        self.metrics = metrics
        self._now = now_fn
        g = config.get_float
        self.fleet = FleetView(
            logger=logger, metrics=metrics,
            poll_interval_s=g("TPU_ROUTER_POLL_INTERVAL_S", 0.5),
            breaker_failures=config.get_int("TPU_ROUTER_BREAKER_FAILURES", 3),
            breaker_interval_s=g("TPU_ROUTER_BREAKER_INTERVAL_S", 1.0),
            now_fn=now_fn,
            service_factory=service_factory,
        )
        self.admission = OverloadController(
            shed_wait_s=g("TPU_ROUTER_SHED_WAIT_S", 0.0),
            min_retry_after=g("TPU_ROUTER_MIN_RETRY_AFTER_S", 0.5),
            now_fn=now_fn,
        )
        self.retry_budget = RetryBudget(
            rate=g("TPU_ROUTER_RETRY_BUDGET_PER_S", 2.0),
            burst=g("TPU_ROUTER_RETRY_BUDGET_BURST", 20.0),
            now_fn=now_fn,
        )
        self.upstream_timeout_s = g("TPU_ROUTER_UPSTREAM_TIMEOUT_S", 120.0)
        self.max_inflight = config.get_int("TPU_ROUTER_MAX_INFLIGHT", 0)
        self._sem: tuple | None = None  # (loop, semaphore), bound lazily
        self.sheds = 0
        self.proxied = 0
        self.retries = 0
        # front-door tenant quotas (opt-in): a tenant's fleet-wide token
        # rate from the usage route of every backend, TTL-cached
        from ..goodput import parse_quota_spec

        self.tenant_quotas = parse_quota_spec(config.get("TPU_ROUTER_TENANT_QUOTA_TOK_S") or "")
        self.quota_refresh_s = g("TPU_ROUTER_QUOTA_REFRESH_S", 2.0)
        self.quota_sheds = 0
        self._usage_cache: tuple[float, dict] | None = None
        self._usage_lock = threading.Lock()
        self._live_pid = os.getpid()
        self._pid_lock = threading.Lock()
        self.autoscaler: Autoscaler | None = None
        engine_cmd = config.get("TPU_ROUTER_ENGINE_CMD") or ""
        if engine_cmd:
            self.autoscaler = Autoscaler(
                self.fleet,
                ProcessLauncher(engine_cmd, logger=logger),
                min_replicas=config.get_int("TPU_ROUTER_MIN_REPLICAS", 1),
                max_replicas=config.get_int("TPU_ROUTER_MAX_REPLICAS", 4),
                up_wait_s=g("TPU_ROUTER_SCALE_UP_WAIT_S", 2.0),
                down_wait_s=g("TPU_ROUTER_SCALE_DOWN_WAIT_S", 0.25),
                hold_s=g("TPU_ROUTER_SCALE_HOLD_S", 3.0),
                cooldown_s=g("TPU_ROUTER_SCALE_COOLDOWN_S", 10.0),
                now_fn=now_fn,
                shed_count_fn=lambda: self.sheds,
                metrics=metrics, logger=logger,
            )
        for addr in (config.get("TPU_ROUTER_BACKENDS") or "").split(","):
            addr = addr.strip()
            if addr:
                self.fleet.add(addr)
        if metrics is not None:
            from ..metrics import HTTP_BUCKETS

            metrics.new_counter("app_router_requests_total", "proxied requests by outcome")
            metrics.new_counter("app_router_retries_total", "re-dispatches by reason")
            metrics.new_counter("app_router_sheds_total", "fleet-admission 429s")
            metrics.new_counter("app_router_affinity_total", "session routing by result")
            metrics.new_histogram("app_router_proxy_seconds", "router hop time to upstream response headers s",
                                  HTTP_BUCKETS)
            metrics.new_gauge("app_router_backends", "fleet membership by state")
            metrics.new_gauge("app_router_fleet_load_tokens", "fleet queued-token total")
            metrics.new_gauge("app_router_predicted_wait_s", "pooled predicted queue wait s")
            metrics.new_gauge("app_router_replicas", "autoscaler-visible replica count")
            metrics.new_counter("app_router_autoscale_total", "scale events by direction")
            metrics.new_counter("app_router_journey_queries_total",
                                "fleet journey stitches by outcome (ok|partial|empty)")
            metrics.new_counter("app_router_blackbox_queries_total",
                                "fleet black-box listings by outcome (ok|partial|empty)")
            metrics.new_counter("app_router_usage_queries_total",
                                "fleet usage-meter fans by outcome (ok|partial|empty)")
            metrics.new_counter("app_router_quota_sheds_total", "front-door 429s for tenants over token-rate quota")

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.ensure_min()
            self.fleet.add_tick_hook(self.autoscaler.tick)
        self.fleet.poll_once()
        self.fleet.start()
        self._live_pid = os.getpid()

    def _ensure_process_local(self) -> None:
        """A forked worker restarts the fleet poll in its own process on its
        first request; the autoscaler stays with the original process."""
        pid = os.getpid()
        if pid == self._live_pid:
            return
        with self._pid_lock:
            if pid == self._live_pid:
                return
            self.fleet.restart_after_fork()
            self._live_pid = pid

    def drain(self) -> None:
        """Stop scaling and leave the managed engines serving; proxied
        streams finish on their own connections."""
        if self.autoscaler is not None:
            self.autoscaler.close(reap_managed=False)

    def close(self) -> None:
        # the poll thread runs the autoscaler's ticks: it stops first, so no
        # launch lands after the reap
        self.fleet.close()
        if self.autoscaler is not None:
            self.autoscaler.close(reap_managed=True)

    def snapshot(self) -> dict:
        return {
            "fleet": self.fleet.snapshot(),
            "admission": self.admission.snapshot(),
            "retry_budget_remaining": round(self.retry_budget.remaining(), 2),
            "proxied": self.proxied,
            "sheds": self.sheds,
            "retries": self.retries,
            "autoscaler": self.autoscaler.snapshot() if self.autoscaler is not None else None,
            "tenant_quotas": dict(self.tenant_quotas),
            "quota_sheds": self.quota_sheds,
        }

    # -- front-door tenant quotas -------------------------------------------
    def fleet_usage(self) -> dict:
        """Per-tenant usage pooled over the fleet, cached for
        TPU_ROUTER_QUOTA_REFRESH_S: each process meters only what it
        served, so the tenants' windows are summed."""
        now = self._now()
        with self._usage_lock:
            cached = self._usage_cache
            if cached is not None and cached[0] > now:
                return cached[1]
            tenants: dict[str, dict] = {}
            failures = polled = 0
            for b in self.fleet.backends():
                polled += 1
                try:
                    out = b.svc.request("GET", "/.well-known/debug/usage",
                                        timeout=max(self.quota_refresh_s, 1.0)).json()
                except Exception:  # noqa: BLE001 — a dead shard is partial data
                    failures += 1
                    continue
                frag = out.get("data", out) if isinstance(out, dict) else {}
                for m in (frag.get("models") or {}).values():
                    win = m.get("window_s")
                    for tenant, row in (m.get("tenants") or {}).items():
                        agg = tenants.setdefault(tenant, {"tokens": 0, "tok_s": 0.0, "chip_s_total": 0.0,
                                                          "window_s": win})
                        agg["tokens"] += row.get("tokens", 0)
                        agg["tok_s"] += row.get("tok_s", 0.0)
                        agg["chip_s_total"] += row.get("chip_s_total", 0.0)
            if polled:
                outcome = "empty" if not tenants else ("partial" if failures else "ok")
                self._count("app_router_usage_queries_total", outcome=outcome)
            self._usage_cache = (now + self.quota_refresh_s, tenants)
            return tenants

    def quota_check(self, tenant: str) -> float | None:
        """None when the tenant may proceed, else the priced Retry-After:
        the time the trailing window needs, with no new admissions, for
        the tenant's fleet rate to decay under its quota."""
        if not self.tenant_quotas or not tenant:
            return None
        quota = self.tenant_quotas.get(tenant)
        if quota is None:
            quota = self.tenant_quotas.get("*")
        if quota is None:
            return None
        row = self.fleet_usage().get(tenant)
        if row is None:
            return None
        rate = row.get("tok_s", 0.0)
        if rate <= quota:
            return None
        win = row.get("window_s") or 60.0
        return max(0.5, (rate - quota) * win / quota)

    # -- routing -----------------------------------------------------------
    def pick(self, session_id: str, exclude: set[str]) -> tuple[Backend | None, str]:
        """-> (backend, affinity result). A session goes to its ring owner;
        a draining, dead or excluded owner falls through the rendezvous
        ranking, then to the least loaded backend."""
        now = self._now()
        if session_id:
            ring = self.fleet.ring  # an atomic snapshot
            for rank, addr in enumerate(ring.owners(session_id)):
                if addr in exclude:
                    continue
                b = self.fleet.get(addr)
                if b is not None and b.accepting(now):
                    return b, ("hit" if rank == 0 else "fallthrough")
        candidates = [b for b in self.fleet.accepting() if b.address not in exclude]
        if not candidates:
            return None, "miss" if session_id else "none"
        b = min(candidates, key=lambda b: b.effective_load())
        return b, ("miss" if session_id else "none")

    def _count(self, name: str, **labels) -> None:
        if self.metrics is not None:
            self.metrics.increment_counter(name, **labels)

    def _acquire_sem(self):
        if self.max_inflight <= 0:
            return None
        loop = asyncio.get_running_loop()
        if self._sem is None or self._sem[0] is not loop:
            self._sem = (loop, asyncio.Semaphore(self.max_inflight))
        return self._sem[1]

    # -- the proxy ---------------------------------------------------------
    async def proxy(self, ctx) -> Response:
        self._ensure_process_local()
        req = ctx.request
        # fleet admission before any backend work: Retry-After is the time
        # the pooled backlog needs to drain under the threshold
        wait = self.fleet.pooled_predicted_wait_s()
        self.admission.observe(wait)
        retry_after = self.admission.should_shed(wait)
        if retry_after is not None:
            self.sheds += 1
            self._count("app_router_sheds_total")
            self._count("app_router_requests_total", outcome="shed")
            raise ErrorTooManyRequests(f"fleet saturated (predicted wait {wait:.1f}s)", retry_after=retry_after)
        fwd = {k: v for k, v in req.headers.items() if k not in _STRIP_REQUEST}
        peer = (req.remote_addr or "").rsplit(":", 1)[0]
        prior = req.headers.get("x-forwarded-for", "")
        fwd["X-Forwarded-For"] = f"{prior}, {peer}" if prior else peer
        if not fwd.get("x-gofr-client"):
            # the end client's fairness identity: at the engine the peer is
            # this router for every request
            from ..handler import llm_request_kwargs

            fwd["X-GoFr-Client"] = llm_request_kwargs(ctx)["client"]
        if self.tenant_quotas:
            tenant = fwd.get("x-gofr-client") or fwd.get("X-GoFr-Client") or ""
            quota_retry = self.quota_check(tenant)
            if quota_retry is not None:
                self.quota_sheds += 1
                self._count("app_router_quota_sheds_total", tenant=tenant)
                self._count("app_router_requests_total", outcome="quota_shed")
                raise ErrorTooManyRequests(f"tenant {tenant!r} over token-rate quota (TPU_ROUTER_TENANT_QUOTA_TOK_S)",
                                           retry_after=quota_retry)
        session_id = req.headers.get("x-gofr-session", "")
        sem = self._acquire_sem()
        if sem is not None:
            await sem.acquire()
        handed_off = False
        try:
            with ctx.trace("router.proxy") as span:
                fwd["traceparent"] = span.traceparent
                resp = await self._dispatch(req, fwd, session_id, span)
            if sem is not None and resp.stream is not None:
                # the cap bounds streamed proxies too: the slot is released
                # when the body completes or the client leaves

                async def _free():
                    sem.release()

                resp.stream = _GuardedStream(resp.stream, _free)
                handed_off = True
            return resp
        finally:
            if sem is not None and not handed_off:
                sem.release()

    async def _dispatch(self, req, fwd: dict, session_id: str, span) -> Response:
        t0 = time.perf_counter()
        exclude: set[str] = set()
        last_error: BaseException | None = None
        last_503: tuple | None = None  # (headers, body, backend, status)
        while True:
            backend, affinity = self.pick(session_id, exclude)
            if session_id and not exclude:
                self._count("app_router_affinity_total", result=affinity)
            if backend is None:
                if last_503 is not None:
                    return self._surface(last_503, outcome="upstream_503")
                self._count("app_router_requests_total", outcome="no_backend")
                raise ErrorServiceUnavailable("no live backend",
                                              retry_after=2 * self.fleet.poll_interval_s) from last_error
            span.set_attribute("backend", backend.address)
            backend.outstanding += 1
            dispatched = False
            try:
                stream = await backend.svc.astream(
                    req.method, req.target, body=req.body, headers=fwd,
                    timeout=self.upstream_timeout_s,
                    # the client's target would mint a series per URL
                    metric_path="proxy",
                )
            except CircuitOpenError as e:
                last_error = e
                reason = "breaker_open"
            except (TimeoutError, asyncio.TimeoutError) as e:
                # a slow backend, not a dead one: the request may still run
                # there, so a re-dispatch would run it twice
                self._count("app_router_requests_total", outcome="upstream_timeout")
                raise ErrorServiceUnavailable(f"upstream timed out after {self.upstream_timeout_s:.0f}s",
                                              retry_after=2 * self.fleet.poll_interval_s) from e
            except Exception as e:  # noqa: BLE001 — transport failure
                last_error = e
                reason = "transport"
            else:
                status = stream.status_code
                if status in (429, 503):
                    if status == 503:
                        # leaving (a drain) or refusing: its Retry-After is a
                        # local cooldown, and the rest of the fleet is tried
                        try:
                            ra = float(stream.headers.get("retry-after", ""))
                        except ValueError:
                            ra = 0.0
                        if ra > 0:
                            backend.cooldown_until = max(backend.cooldown_until, self._now() + min(ra, 30.0))
                    body = await self._read_or_none(stream)
                    if body is None:
                        # the upstream died mid-body: a transport failure
                        last_error = ConnectionError(f"upstream {status} body truncated")
                        reason = "transport"
                    elif status == 429:
                        # the backend priced its own backoff: re-dispatching a
                        # shed starts retry storms
                        return self._surface((stream.headers, body, backend, status), outcome="upstream_429")
                    else:
                        last_503 = (stream.headers, body, backend, status)
                        reason = "unavailable"
                elif status >= 500:
                    await stream.aclose()  # abort; a 5xx body is not read
                    last_error = ErrorServiceUnavailable(f"upstream {status} from {backend.address}")
                    reason = "5xx"
                else:
                    dispatched = True
                    self.proxied += 1
                    if self.metrics is not None:
                        self.metrics.record_histogram("app_router_proxy_seconds", time.perf_counter() - t0)
                    self._count("app_router_requests_total", outcome="ok")
                    return await self._respond(stream, backend)
            finally:
                if not dispatched:
                    backend.outstanding = max(0, backend.outstanding - 1)
            exclude.add(backend.address)
            if not self.retry_budget.take():
                # the budget is dry: surface the original failure
                if last_503 is not None:
                    return self._surface(last_503, outcome="upstream_503")
                self._count("app_router_requests_total", outcome="retry_exhausted")
                raise last_error  # type: ignore[misc]
            self.retries += 1
            self._count("app_router_retries_total", reason=reason)

    @staticmethod
    async def _read_or_none(stream) -> bytes | None:
        """A small upstream body (a 429/503 envelope), or None when the
        upstream dies under the read."""
        try:
            return await stream.aread()
        except Exception:  # noqa: BLE001 — the socket died under the read
            try:
                await stream.aclose()
            except Exception:  # noqa: BLE001
                pass
            return None

    def _surface(self, saved: tuple, *, outcome: str) -> Response:
        headers, body, _backend, status = saved
        self._count("app_router_requests_total", outcome=outcome)
        out = [(k.title(), v) for k, v in headers.items() if k not in _STRIP_RESPONSE]
        return Response(status, out, body)

    async def _respond(self, stream, backend: Backend) -> Response:
        out_headers = [(k.title(), v) for k, v in stream.headers.items() if k not in _STRIP_RESPONSE]
        if not stream.streamed:
            # length-delimited (a JSON envelope): buffered
            try:
                body = await stream.aread()
            finally:
                backend.outstanding = max(0, backend.outstanding - 1)
            return Response(stream.status_code, out_headers, body)

        # chunk by chunk: a token is on the client's socket as the engine
        # emits it. A client disconnect closes this stream (started or
        # not), the teardown aborts the upstream socket, and the engine's
        # disconnect path retires the request
        async def _teardown():
            backend.outstanding = max(0, backend.outstanding - 1)
            await stream.aclose()

        return Response(stream.status_code, out_headers, b"", stream=_GuardedStream(stream.aiter_raw(), _teardown))


def _fan(ctx, path: str, params: dict | None, collect) -> tuple[list[dict], int]:
    """GET `path` from every backend of the front router, handing each
    answer's payload to ``collect(address, payload) -> count``. -> (the
    per-backend report, failures); a backend that cannot answer is
    partial data, not a failure of the fan."""
    fr = getattr(ctx.container, "front_router", None)
    polled: list[dict] = []
    failures = 0
    if fr is None:
        return polled, failures
    try:
        timeout = ctx.container.config.get_float("TPU_ROUTER_JOURNEY_TIMEOUT_S", 5.0)
    except Exception:  # noqa: BLE001 — a malformed config reads the default
        timeout = 5.0
    for b in fr.fleet.backends():
        try:
            out = b.svc.request("GET", path, params=params, timeout=timeout).json()
        except Exception as e:  # noqa: BLE001 — a dead shard is partial data
            failures += 1
            polled.append({"address": b.address, "ok": False, "error": repr(e)})
            continue
        frag = out.get("data", out) if isinstance(out, dict) else {}
        polled.append({"address": b.address, "ok": True, **collect(b.address, frag)})
    return polled, failures


def journey_handler(ctx):
    """GET /.well-known/debug/journey?trace_id=<32 hex>: the fleet
    stitcher. Fans the trace query over every backend's span ring (each
    process keeps only its own fragment), folds in this router's hop
    spans, and assembles one parent-linked journey tree."""
    from ..http.errors import ErrorInvalidParam
    from ..tracing import stitch_spans

    tid = (ctx.param("trace_id") or "").strip().lower()
    if len(tid) != 32:
        raise ErrorInvalidParam("trace_id")
    spans: list[dict] = []
    ring = getattr(getattr(ctx.container, "tracer", None), "ring", None)
    if ring is not None:  # the router's own spans first: router.proxy is the top hop
        for s in ring.query(tid):
            spans.append({**s, "process": "router"})

    def collect(address, frag):
        got = frag.get("spans") or []
        spans.extend({**s, "process": address} for s in got if isinstance(s, dict))
        return {"spans": len(got)}

    polled, failures = _fan(ctx, "/.well-known/debug/traces", {"trace_id": tid}, collect)
    fr = getattr(ctx.container, "front_router", None)
    if fr is not None:
        fr._count("app_router_journey_queries_total",
                  outcome="empty" if not spans else ("partial" if failures else "ok"))
    return {"trace_id": tid, "backends": polled, "journey": stitch_spans(spans)}


def blackbox_fleet_handler(ctx):
    """GET /.well-known/debug/blackbox: the fleet incident view, every
    backend's bundle listing merged newest first."""
    bundles: dict[str, dict] = {}
    recorders: dict[str, dict] = {}

    def collect(address, frag):
        got = frag.get("bundles") or []
        for m in got:
            if isinstance(m, dict):
                bundles.setdefault(m.get("bundle") or m.get("path", ""), {**m, "backend": address})
        for label, rec in (frag.get("recorders") or {}).items():
            recorders[f"{address}:{label}"] = rec
        return {"bundles": len(got)}

    polled, failures = _fan(ctx, "/.well-known/debug/blackbox", None, collect)
    fr = getattr(ctx.container, "front_router", None)
    if fr is not None:
        fr._count("app_router_blackbox_queries_total",
                  outcome="empty" if not bundles else ("partial" if failures else "ok"))
    merged = sorted(bundles.values(), key=lambda m: m.get("ts") or 0, reverse=True)
    return {"bundles": merged, "count": len(merged), "recorders": recorders, "backends": polled}


def usage_fleet_handler(ctx):
    """GET /.well-known/debug/usage: the fleet chargeback view, every
    backend's usage meter merged per model and per tenant."""
    from ..goodput import pool_goodput

    models: dict[str, dict] = {}

    def collect(_address, frag):
        got = frag.get("models") or {}
        for name, m in got.items():
            if not isinstance(m, dict):
                continue
            agg = models.setdefault(name, {"window_s": m.get("window_s"), "tenants": {}, "goodput": None,
                                           "quota_sheds": 0})
            gp = [s for s in (agg["goodput"], m.get("goodput")) if s]
            agg["goodput"] = pool_goodput(gp) if gp else None
            agg["quota_sheds"] += m.get("quota_sheds", 0) or 0
            for tenant, row in (m.get("tenants") or {}).items():
                if not isinstance(row, dict):
                    continue
                t = agg["tenants"].setdefault(tenant, {"chip_s": {}, "chip_s_total": 0.0, "tokens": 0, "tok_s": 0.0})
                for cls, v in (row.get("chip_s") or {}).items():
                    t["chip_s"][cls] = round(t["chip_s"].get(cls, 0.0) + v, 6)
                t["chip_s_total"] = round(t["chip_s_total"] + row.get("chip_s_total", 0.0), 6)
                t["tokens"] += row.get("tokens", 0)
                t["tok_s"] = round(t["tok_s"] + row.get("tok_s", 0.0), 3)
        return {"models": len(got)}

    polled, failures = _fan(ctx, "/.well-known/debug/usage", None, collect)
    fr = getattr(ctx.container, "front_router", None)
    if fr is not None:
        fr._count("app_router_usage_queries_total",
                  outcome="empty" if not models else ("partial" if failures else "ok"))
    return {
        "models": models,
        "count": len(models),
        "backends": polled,
        "quotas": dict(fr.tenant_quotas) if fr is not None else {},
        "quota_sheds": fr.quota_sheds if fr is not None else 0,
    }


def router_debug_handler(ctx):
    """GET /.well-known/router: the live fleet view (per-backend health,
    load and breaker, the ring, admission, the autoscaler, the retry
    budget). Read-only."""
    fr = getattr(ctx.container, "front_router", None)
    if fr is None:
        return {"note": "front router not initialized"}
    return fr.snapshot()


def new_router_app(config=None, *, configs_dir: str = "./configs"):
    """The front-router App: catch-all proxy routes over the FrontRouter
    core plus the router's debug and fleet routes (TPU_ROUTER_* config).
    The well-known routes stay this process's own (health, liveness and
    the drain are the router's); everything else goes to the fleet."""
    from ..app import App

    app = App(config=config, configs_dir=configs_dir)
    fr = FrontRouter(app.config, logger=app.logger, metrics=app.container.metrics)
    app.container.front_router = fr  # container.close() tears it down
    app.front_router = fr

    async def proxy_handler(ctx):
        return await fr.proxy(ctx)

    proxy_timeout = app.config.get_float("TPU_ROUTER_PROXY_TIMEOUT_S", 300.0)
    app.get("/.well-known/router", router_debug_handler)
    # the fleet views answer from this process, ahead of the catch-all
    app.get("/.well-known/debug/journey", journey_handler)
    app.get("/.well-known/debug/blackbox", blackbox_fleet_handler)
    app.get("/.well-known/debug/usage", usage_fleet_handler)
    # HEAD rides along so probes against proxied paths answer as direct
    # access would; the CORS middleware answers every preflight
    for method in ("GET", "HEAD", "POST", "PUT", "PATCH", "DELETE"):
        app._add(method, "/{proxy_path...}", proxy_handler, timeout_s=proxy_timeout)
    fr.start()
    return app
