"""App: the composition root (counterpart of gofr_tpu/app.py: HTTP and gRPC).

``new(config)`` builds the App: config (``EnvConfig`` over ``./configs``
unless one is passed), the container and its logger, the router behind
the default chain (tracer -> request log -> CORS -> metrics; the CORS
headers take ``ACCESS_CONTROL_ALLOW_ORIGIN`` / ``_HEADERS`` /
``_CREDENTIALS`` overrides), the HTTP server on ``HTTP_PORT`` (default
8000; 0 binds an ephemeral port, read back from ``app.http_server.port``;
HTTPS when ``HTTP_TLS_CERT_FILE`` and ``HTTP_TLS_KEY_FILE`` name PEM
files) and the metrics server on
``METRICS_PORT`` (default 2121; 0 binds an ephemeral port, read back from
``app.metrics_server.port``; a failed bind raises), which starts and
stops with the HTTP server. The HTTP server is ``NativeHTTPServer`` (the
C++ wire codec, ``native/httpcore.cc``, built with g++ at the first
start) unless ``GOFR_HTTP_NATIVE=0``; when the codec cannot be built the
App logs a warning and serves through the asyncio ``AsyncHTTPServer``
(one conformance suite holds both). Handlers registered with ``get`` / ``post`` /
``put`` / ``patch`` / ``delete`` (``{name}`` and trailing ``{rest...}``
path segments; ``ctx.path_param``) run under ``REQUEST_TIMEOUT`` seconds
(default 5; 408 past it). ``use_middleware`` and the auth enables
(``enable_basic_auth[_with_func]``, ``enable_api_key_auth[_with_func]``,
``enable_oauth``) append to the chain in the order called.
``add_http_service`` registers an outbound ``service.HTTPService``;
``add_cron_job`` and ``add_background_task`` run on the serving loop and
are cancelled at shutdown, as are the loops of ``subscribe`` (a handler
per topic of the container's pub/sub backend, ``PUBSUB_BACKEND``:
commit on success, a raising handler recovered); ``add_static_files`` serves a directory;
``register_model`` is ``ctx.tpu().register_model``. ``migrate`` runs data
migrations over the container's SQL and Redis datasources (``migration``),
``add_rest_handlers`` registers an entity's CRUD routes (``crud``). ``run()`` serves
until SIGINT (at once) or SIGTERM (the graceful drain); with
``HTTP_WORKERS`` = N > 1 it first forks N - 1 workers that share the HTTP
and metrics ports through SO_REUSEPORT (the kernel balances accepts),
and at exit SIGTERMs and reaps them (SIGKILL after 10 s). It refuses, logs
a warning and serves in one process when torch is already imported (an
app that serves a model: a CUDA context does not survive a fork; scale
such an app with engine replicas), when a port is 0, or without
SO_REUSEPORT; ``REMOTE_LOG_URL``'s level poller then runs in the parent
only;
``run_in_background()`` serves from a daemon thread and returns once the
socket listens; ``shutdown()`` stops the servers and closes the
registered engines and services.

The graceful drain (``begin_drain``, ``POST /.well-known/debug/drain``,
SIGTERM; JAX app.py:427-470): health answers 503 with a Retry-After at
once (liveness stays 200), the engines close admission
(``EngineDraining``: 503) and finish the work in flight, and the server
stops once they are drained or ``GOFR_DRAIN_DEADLINE_S`` (30) has passed,
after a grace of at least 0.5 s. The route answers loopback callers only
unless ``GOFR_DRAIN_REMOTE=1``.

gRPC: ``grpc_unary`` / ``grpc_server_stream`` register framework-native
JSON-over-gRPC methods with the same ``handler(ctx)`` shape as the HTTP
routes, ``register_service`` a generated-proto servicer; the first
registration builds a ``grpcx.GRPCServer`` on ``GRPC_PORT`` (default 9000;
0 binds an ephemeral port, read back from ``app.grpc_server.port``), which
starts and stops with the HTTP server. ``grpcx`` (and with it ``grpc``) is
imported only then.

Always registered: ``/.well-known/health``, ``/.well-known/alive``, the
404 catch-all, 405 for a known path under another method, the CORS
preflight, the drain route, the rollout routes (``GET`` /
``POST /.well-known/debug/rollout``: a model's versions, and a rollout
staged from a checkpoint; the POST loopback-only unless
``GOFR_ROLLOUT_REMOTE=1``), and the flight recorder's and the usage
meter's (``GET /.well-known/debug/blackbox``: the incident bundles;
``GET /.well-known/debug/usage``: per-tenant chip time and tokens;
``POST /.well-known/debug/replay``: re-execute a flight record, under its
own timeout, loopback-only unless ``GOFR_REPLAY_REMOTE=1``), and device
observability's (``GET /.well-known/debug/engine``, with ``?serving=1``
the router's summary; ``GET /.well-known/debug/compiles``: the capture
registry; ``GET /.well-known/debug/traces``: the span ring;
``POST /.well-known/debug/profile``: a ``torch.profiler`` capture under
its own timeout). The App builds one tracer from the config
(``tracing.new_tracer``: ``TRACE_EXPORTER``, ``TRACE_RING_SPANS``), opens
a span per HTTP request and per RPC (parented by an incoming
``traceparent``) and hands the tracer to every engine; ``/favicon.ico``,
and ``/.well-known/openapi.json`` with the swagger page when
``./static/openapi.json`` exists. ``add_mongo`` wires a user-built Mongo
provider into the container (``ctx.mongo``).
"""

from __future__ import annotations

import asyncio
import signal
import threading
import time
from typing import Any, Callable

from .config import Config, EnvConfig
from .container import Container
from .handler import (
    _require_loopback,
    debug_blackbox_handler,
    debug_compiles_handler,
    debug_engine_handler,
    debug_profile_handler,
    debug_traces_handler,
    debug_usage_handler,
    favicon_wire_handler,
    health_handler,
    live_handler,
    replay_handler,
    rollout_handler,
    rollout_status_handler,
    wrap_handler,
)
from .http.middleware import (
    apikey_auth_middleware,
    basic_auth_middleware,
    cors_middleware,
    logging_middleware,
    metrics_middleware,
    oauth_middleware,
    tracer_middleware,
)
from .http.router import Router
from .http.server import AsyncHTTPServer
from .metrics.server import MetricsServer
from .tracing import new_tracer


class App:
    def __init__(self, config: Config | None = None, configs_dir: str = "./configs"):
        self.config: Config = config if config is not None else EnvConfig(configs_dir)
        self.container = Container.create(self.config)
        self.logger = self.container.logger
        self.tracer = new_tracer(self.config, self.logger)
        self.container.tracer = self.tracer
        self.http_port = self.config.get_int("HTTP_PORT", 8000)
        self.metrics_port = self.config.get_int("METRICS_PORT", 2121)
        self.request_timeout = self.config.get_float("REQUEST_TIMEOUT", 5.0)
        self.router = Router()
        self.router.use(tracer_middleware(self.tracer))  # outermost: the log line carries the trace id
        self.router.use(logging_middleware(self.logger))
        self.router.use(cors_middleware(self._cors_overrides()))
        self.router.use(metrics_middleware(self.container.metrics))
        self.http_server = self._make_http_server()
        self.metrics_server = MetricsServer(self.container.metrics, self.metrics_port)
        self._subscriptions: dict[str, Callable] = {}  # subscribe: topic -> handler
        self._bg_factories: list[Callable] = []  # add_background_task
        self._bg_tasks: list[asyncio.Task] = []
        self._cron = None  # built at the first add_cron_job
        self._static_dirs: list[tuple[str, str]] = []
        self._jwks = None  # enable_oauth's key refresher, closed at shutdown
        self.grpc_port = self.config.get_int("GRPC_PORT", 9000)
        self.grpc_server = None  # built at the first gRPC registration
        self._grpc_registered = False
        self._shutdown_event: asyncio.Event | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        # the drain flag lives on the container, where the health handler reads it
        self._draining = False
        self.container.draining = False
        self.drain_deadline_s = self.config.get_float("GOFR_DRAIN_DEADLINE_S", 30.0)

    def _make_http_server(self):
        """The native-codec server when the C++ extension builds, the
        asyncio one otherwise or under ``GOFR_HTTP_NATIVE=0`` (JAX
        app.py:93-110)."""
        tls = self._server_tls()
        if self.config.get_or_default("GOFR_HTTP_NATIVE", "1") != "0":
            from .http.nativeserver import NativeHTTPServer

            if NativeHTTPServer.available():
                return NativeHTTPServer(self.router.dispatch, self.http_port, logger=self.logger, tls=tls)
            self.logger.warn("native HTTP codec unavailable; using pure-Python server")
        return AsyncHTTPServer(self.router.dispatch, self.http_port, logger=self.logger, tls=tls)

    def _server_tls(self):
        """HTTPS when HTTP_TLS_CERT_FILE and HTTP_TLS_KEY_FILE name PEM files."""
        cert = self.config.get("HTTP_TLS_CERT_FILE")
        key = self.config.get("HTTP_TLS_KEY_FILE")
        if not cert or not key:
            return None
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, key)
        return ctx

    def _cors_overrides(self) -> dict[str, str]:
        """ACCESS_CONTROL_ALLOW_* config keys -> CORS header names."""
        out = {}
        for key in ("ACCESS_CONTROL_ALLOW_ORIGIN", "ACCESS_CONTROL_ALLOW_HEADERS", "ACCESS_CONTROL_ALLOW_CREDENTIALS"):
            v = self.config.get(key)
            if v:
                out["-".join(w.capitalize() for w in key.split("_"))] = v
        return out

    def _add(self, method: str, path: str, handler: Callable, timeout_s: float | None = None) -> None:
        self.router.add(
            method, path,
            wrap_handler(handler, self.container, timeout_s if timeout_s is not None else self.request_timeout),
        )

    def get(self, path: str, handler: Callable) -> None:
        self._add("GET", path, handler)

    def post(self, path: str, handler: Callable) -> None:
        self._add("POST", path, handler)

    def put(self, path: str, handler: Callable) -> None:
        self._add("PUT", path, handler)

    def patch(self, path: str, handler: Callable) -> None:
        self._add("PATCH", path, handler)

    def delete(self, path: str, handler: Callable) -> None:
        self._add("DELETE", path, handler)

    def use_middleware(self, *mws) -> None:
        for mw in mws:
            self.router.use(mw)

    # -- auth (JAX app.py:157-178) -------------------------------------------
    def enable_basic_auth(self, *user_pass: str) -> None:
        if len(user_pass) % 2 != 0:
            self.logger.warn("enable_basic_auth: odd argument count; ignoring trailing username")
        self.router.use(basic_auth_middleware(users=dict(zip(user_pass[::2], user_pass[1::2]))))

    def enable_basic_auth_with_func(self, validate_func) -> None:
        self.router.use(basic_auth_middleware(validate_func=validate_func))

    def enable_api_key_auth(self, *keys: str) -> None:
        self.router.use(apikey_auth_middleware(keys=list(keys)))

    def enable_api_key_auth_with_func(self, validate_func) -> None:
        self.router.use(apikey_auth_middleware(validate_func=validate_func))

    def enable_oauth(self, jwks_url: str, refresh_interval_s: float = 300.0) -> None:
        from .http.middleware.auth import JWKSProvider

        self._jwks = JWKSProvider(jwks_url, refresh_interval_s)
        self.router.use(oauth_middleware(self._jwks))

    # -- outbound services, models, tasks, cron, static files ------------------
    def add_mongo(self, provider) -> None:
        """Wire a user-built Mongo provider (``datasource.mongo``): the
        container injects the logger and the metrics, connects it and
        exposes it as ``ctx.mongo``."""
        self.container.add_mongo(provider)

    def add_http_service(self, name: str, address: str, *options) -> None:
        from .service import new_http_service

        if name in self.container.services:
            self.logger.warn(f"service {name} already registered, overwriting")
        self.container.services[name] = new_http_service(address, self.logger, self.container.metrics, *options)

    def register_model(self, name: str, *args, **kwargs):
        return self.container.tpu().register_model(name, *args, **kwargs)

    # -- pub/sub (JAX app.py:206-210) -------------------------------------------
    def subscribe(self, topic: str, handler: Callable) -> None:
        """Run ``handler(ctx)`` for every message of `topic` from
        ``serve()`` on (``ctx.bind()`` reads the payload); the message is
        committed only when the handler returns None without raising."""
        if self.container.pubsub is None:
            self.logger.error("subscriber not initialized in the container (set PUBSUB_BACKEND)")
            return
        self._subscriptions[topic] = handler

    async def _run_subscriber(self, topic: str, handler: Callable) -> None:
        """One topic's loop (JAX app.py:374-409): receive, build a Context,
        run the handler (a sync one on the executor), commit on success. A
        raising handler is logged and its message left uncommitted, as is
        one that returns an error; the loop goes on."""
        from .context import Context
        from .datasource.pubsub import SubscribeContextRequest

        pubsub = self.container.pubsub
        metrics = self.container.metrics
        while self._shutdown_event is not None and not self._shutdown_event.is_set():
            try:
                msg = await pubsub.subscribe(topic)
            except asyncio.CancelledError:
                return
            except Exception as e:  # noqa: BLE001 — a broker hiccup
                self.logger.error(f"error while reading from topic {topic}: {e!r}")
                await asyncio.sleep(1.0)
                continue
            if msg is None:
                continue
            metrics.increment_counter("app_pubsub_subscribe_total_count", topic=topic)
            ctx = Context(SubscribeContextRequest(msg), self.container)
            try:
                if asyncio.iscoroutinefunction(handler):
                    err = await handler(ctx)
                else:
                    err = await asyncio.get_running_loop().run_in_executor(None, handler, ctx)
            except Exception as e:  # noqa: BLE001 — the handler's panic is recovered
                self.logger.error(f"error in subscriber handler for {topic}: {e!r}")
                continue
            if err is not None:
                self.logger.error(f"subscriber handler for {topic} returned error: {err!r}")
                continue
            msg.commit()
            metrics.increment_counter("app_pubsub_subscribe_success_count", topic=topic)

    # -- migrations and CRUD (JAX app.py:229-250) --------------------------------
    def migrate(self, migrations: dict[int, Any]) -> None:
        """Run the pending ``migrations`` ({version: up}) now, logging and
        re-raising a failure (``migration.run``)."""
        from .migration import run as run_migrations

        try:
            run_migrations(migrations, self.container)
        except Exception as e:  # noqa: BLE001 — logged, then raised
            self.logger.error(f"migration failed: {e!r}")
            raise

    def add_rest_handlers(self, entity_cls) -> None:
        """POST / GET / GET by id / PUT / DELETE routes for an entity class
        over the SQL datasource (``crud.register_crud_handlers``)."""
        from .crud import register_crud_handlers

        register_crud_handlers(self, entity_cls)

    def add_background_task(self, coro_factory: Callable) -> None:
        """Run ``coro_factory()`` as a task on the serving loop from
        ``serve()`` on, cancelled at shutdown. Pass the coroutine function,
        not a coroutine: it is called on the serving loop."""
        self._bg_factories.append(coro_factory)

    def add_cron_job(self, schedule: str, job_name: str, job: Callable) -> None:
        from .cron import Cron

        if self._cron is None:
            self._cron = Cron(self.container)
        self._cron.add_job(schedule, job_name, job)

    def add_static_files(self, route: str, directory: str) -> None:
        self._static_dirs.append((route, directory))

    # -- gRPC (JAX app.py:252-276) ------------------------------------------
    def _ensure_grpc(self):
        from .grpcx import GRPCServer

        if self.grpc_server is None:
            self.grpc_server = GRPCServer(self.container, self.grpc_port, self.tracer)
        return self.grpc_server

    def register_service(self, add_servicer_fn, servicer) -> None:
        """add_servicer_fn: generated add_XServicer_to_server(servicer, server)."""
        self._ensure_grpc().register(add_servicer_fn, servicer)
        self._grpc_registered = True

    def grpc_unary(self, service: str, method: str, handler: Callable) -> None:
        """Framework-native RPC: handler(ctx) -> result, JSON over gRPC."""
        self._ensure_grpc().add_unary(service, method, handler)
        self._grpc_registered = True

    def grpc_server_stream(self, service: str, method: str, handler: Callable) -> None:
        """handler(ctx) -> iterator of chunks (sync generator, async
        generator, or a coroutine returning an iterable): e.g. tokens."""
        self._ensure_grpc().add_server_stream(service, method, handler)
        self._grpc_registered = True

    def _register_well_known(self) -> None:
        self.get("/.well-known/health", health_handler)
        self.get("/.well-known/alive", live_handler)
        # device observability (JAX app.py:286-295); a profile costs its
        # window (<= 30 s) plus the trace's readback, so its route has its
        # own budget instead of REQUEST_TIMEOUT
        self.get("/.well-known/debug/engine", debug_engine_handler)
        self.get("/.well-known/debug/compiles", debug_compiles_handler)
        self.get("/.well-known/debug/traces", debug_traces_handler)
        self._add("POST", "/.well-known/debug/profile", debug_profile_handler,
                  timeout_s=max(60.0, self.request_timeout))
        self.post("/.well-known/debug/drain", self._drain_handler)
        # the model lifecycle: GET the versions and rollout view; POST
        # stages a rollout from a checkpoint path, under its own timeout
        # (loading a multi-GB checkpoint can outlast REQUEST_TIMEOUT; the
        # shift itself runs on the controller's thread)
        self.get("/.well-known/debug/rollout", rollout_status_handler)
        self._add("POST", "/.well-known/debug/rollout", rollout_handler, timeout_s=max(120.0, self.request_timeout))
        # the flight recorder and the usage meter (JAX app.py:313-333): the
        # bundles and the chargeback view read what runs; the replay
        # re-decodes a recorded request on the card, under its own timeout.
        # The front router binds its fleet-wide views to the blackbox and
        # usage paths first (router.new_router_app): the built-ins yield
        if not self.router.has("GET", "/.well-known/debug/blackbox"):
            self.get("/.well-known/debug/blackbox", debug_blackbox_handler)
        if not self.router.has("GET", "/.well-known/debug/usage"):
            self.get("/.well-known/debug/usage", debug_usage_handler)
        self._add("POST", "/.well-known/debug/replay", replay_handler, timeout_s=max(120.0, self.request_timeout))
        self.router.add("GET", "/favicon.ico", favicon_wire_handler)
        from .staticfiles import register_static_route
        from .swagger import register_swagger_routes

        register_swagger_routes(self)
        for route, directory in self._static_dirs:
            register_static_route(self, route, directory)

    # -- the graceful drain (JAX app.py:427-510) -------------------------------
    def _drain_handler(self, ctx) -> dict:
        """POST /.well-known/debug/drain: begin the drain (idempotent).
        Loopback-only unless GOFR_DRAIN_REMOTE=1: it takes the instance
        out of rotation and closes it."""
        _require_loopback(ctx, "GOFR_DRAIN_REMOTE")
        started = self.begin_drain()
        return {"draining": True, "started": started, "deadline_s": self.drain_deadline_s}

    def begin_drain(self, deadline_s: float | None = None) -> bool:
        """Readiness down, engine admission closed, then a waiter thread
        stops the server once the engines are drained or the deadline has
        passed. False when a drain is already running. Safe from any
        thread."""
        if self._draining:
            return False
        self._draining = True
        self.container.draining = True
        deadline_s = deadline_s if deadline_s is not None else self.drain_deadline_s
        self.logger.info(f"drain: readiness down, admission closed; finishing in-flight work (deadline {deadline_s:.0f}s)")
        rt = self.container.tpu_runtime  # never build the runtime here
        if rt is not None:
            try:
                rt.drain()
            except Exception as e:  # noqa: BLE001 — the drain must reach the shutdown
                self.logger.error(f"drain: engine drain failed: {e!r}")
        fr = self.container.front_router
        if fr is not None:
            # a router's drain stops its autoscaler and leaves the managed
            # engines serving (container.close() reaps them at exit)
            try:
                fr.drain()
            except Exception as e:  # noqa: BLE001 — the drain must reach the shutdown
                self.logger.error(f"drain: front-router drain failed: {e!r}")
        threading.Thread(target=self._drain_then_stop, args=(deadline_s,), name="app-drain", daemon=True).start()
        return True

    def _drain_then_stop(self, deadline_s: float) -> None:
        # a grace floor: the drain's own response and one readiness probe
        # at 503 go out before the listener closes
        time.sleep(min(0.5, deadline_s))
        t0 = time.monotonic()
        while time.monotonic() - t0 < deadline_s:
            rt = self.container.tpu_runtime
            try:
                if rt is None or rt.drained():
                    break
            except Exception:  # noqa: BLE001 — a sick engine must not wedge the exit
                break
            time.sleep(0.05)
        else:
            self.logger.warn(f"drain: deadline {deadline_s:.0f}s elapsed with work still in flight; shutting down anyway")
        self.shutdown()

    async def serve(self) -> None:
        """Start the server and block until shutdown()."""
        self._loop = asyncio.get_running_loop()
        self._shutdown_event = asyncio.Event()
        self._register_well_known()
        self.router.build()
        self.metrics_server.start()
        self.logger.info(f"Starting metrics server on :{self.metrics_server.port}")
        try:
            await self.http_server.start()
            if self._grpc_registered and self.grpc_server is not None:
                self.grpc_server.start()
                self.logger.info(f"gRPC server listening on :{self.grpc_server.port}")
            self._bg_tasks = [asyncio.ensure_future(self._run_subscriber(topic, handler))
                              for topic, handler in self._subscriptions.items()]
            self._bg_tasks += [asyncio.ensure_future(factory()) for factory in self._bg_factories]
            if self._cron is not None:
                self._bg_tasks.append(asyncio.ensure_future(self._cron.run()))
            await self._shutdown_event.wait()
        finally:
            for t in self._bg_tasks:
                t.cancel()
            await asyncio.gather(*self._bg_tasks, return_exceptions=True)
            self._bg_tasks = []
            await self.http_server.shutdown()
            if self.grpc_server is not None:
                self.grpc_server.shutdown()
            self.metrics_server.shutdown()
            if self._jwks is not None:
                self._jwks.close()
            self.container.close()
            self.tracer.shutdown()
            self.logger.info("Server shutdown complete")

    def shutdown(self) -> None:
        """Stop serving (safe from any thread, and after the server stopped)."""
        if self._loop is not None and self._shutdown_event is not None and not self._loop.is_closed():
            try:
                self._loop.call_soon_threadsafe(self._shutdown_event.set)
            except RuntimeError:  # the loop closed meanwhile: nothing left to stop
                pass

    def run(self) -> None:
        """Blocking entry point; SIGINT stops the server, SIGTERM (a rolling
        deploy) runs the graceful drain. ``HTTP_WORKERS`` > 1 forks the
        workers first (``_fork_workers``) and reaps them at exit."""
        workers = self.config.get_int("HTTP_WORKERS", 1)
        child_pids = self._fork_workers(workers) if workers > 1 else []

        async def main():
            loop = asyncio.get_running_loop()
            for sig, handler in ((signal.SIGINT, self.shutdown), (signal.SIGTERM, self.begin_drain)):
                try:
                    loop.add_signal_handler(sig, handler)
                except (NotImplementedError, RuntimeError):
                    pass
            await self.serve()

        try:
            asyncio.run(main())
        finally:
            if child_pids:
                self._reap_workers(child_pids)

    @staticmethod
    def _reap_workers(pids: list[int], grace: float = 10.0) -> None:
        """SIGTERM each worker, wait up to ``grace`` seconds, then SIGKILL
        any survivor: a worker wedged in a C call must not hold the
        parent's exit."""
        import os

        for pid in pids:
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + grace
        remaining = list(pids)
        while remaining and time.monotonic() < deadline:
            for pid in list(remaining):
                try:
                    done, _ = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    done = pid
                if done:
                    remaining.remove(pid)
            if remaining:
                time.sleep(0.05)
        for pid in remaining:
            try:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
            except (ProcessLookupError, ChildProcessError):
                pass

    def _fork_workers(self, workers: int) -> list[int]:
        """Fork ``workers`` - 1 children that share the HTTP and metrics
        ports through SO_REUSEPORT (JAX app.py:581-632). The child pids in
        the parent; [] in a child, or when prefork is refused: without
        SO_REUSEPORT, once torch is imported (device state does not
        survive a fork), or on an ephemeral port."""
        import os
        import socket
        import sys

        if not hasattr(socket, "SO_REUSEPORT"):
            self.logger.warn("HTTP_WORKERS: SO_REUSEPORT unsupported; single worker")
            return []
        if "torch" in sys.modules:
            self.logger.warn(
                "HTTP_WORKERS>1 ignored: torch already imported and device "
                "state does not survive fork — use engine replicas to scale"
            )
            return []
        if self.http_port == 0 or self.metrics_port == 0:
            # SO_REUSEPORT on port 0 gives every worker a port of its own,
            # which no client knows
            self.logger.warn(
                "HTTP_WORKERS>1 ignored: ephemeral port 0 cannot be shared "
                "across workers; set fixed HTTP_PORT/METRICS_PORT"
            )
            return []
        if self.config.get("REMOTE_LOG_URL"):
            # threads do not survive a fork: only the parent's poller runs
            self.logger.warn("HTTP_WORKERS>1: remote log-level polling runs in the parent worker only")
        # datasource sockets opened before run() would be shared by every
        # worker; the framework's datasources connect lazily per process
        self.http_server.reuse_port = True
        self.metrics_server.reuse_port = True
        pids: list[int] = []
        try:
            for _ in range(workers - 1):
                pid = os.fork()
                if pid == 0:
                    return []  # a child serves like a single process
                pids.append(pid)
        except OSError:
            # a partial fork failure: never orphan the workers already alive
            self._reap_workers(pids)
            raise
        self.logger.info(f"HTTP multi-worker: {workers} processes on :{self.http_port}")
        return pids

    def run_in_background(self) -> threading.Thread:
        """Serve from a daemon thread; returns once the sockets listen."""
        started = threading.Event()

        async def main():
            task = asyncio.ensure_future(self.serve())
            while not task.done() and (
                self.http_server._server is None
                or (self._grpc_registered and not self.grpc_server._started)
            ):
                await asyncio.sleep(0.005)
            started.set()
            await task

        t = threading.Thread(target=lambda: asyncio.run(main()), daemon=True)
        t.start()
        if not started.wait(timeout=30):
            raise RuntimeError("app failed to start")
        return t


def new(config: Config | None = None, configs_dir: str = "./configs") -> App:
    return App(config=config, configs_dir=configs_dir)
