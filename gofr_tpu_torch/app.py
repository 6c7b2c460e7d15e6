"""App: the composition root (counterpart of gofr_tpu/app.py: HTTP and gRPC).

``new(config)`` builds the App: config (``EnvConfig`` over ``./configs``
unless one is passed), the container and its logger, the router behind
the request-log and CORS middleware, and the asyncio HTTP server on
``HTTP_PORT`` (default 8000; 0 binds an ephemeral port, read back from
``app.http_server.port``). Handlers registered with ``get`` / ``post`` run
under ``REQUEST_TIMEOUT`` seconds (default 5; 408 past it). ``run()``
serves until SIGINT (at once) or SIGTERM (the graceful drain);
``run_in_background()`` serves from a daemon thread and returns once the
socket listens; ``shutdown()`` stops the server and closes the registered
engines.

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
``traceparent``) and hands the tracer to every engine. Left out of the
port: the metrics server, cron, pub/sub, auth, static files and swagger.
"""

from __future__ import annotations

import asyncio
import signal
import threading
import time
from typing import Callable

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
    health_handler,
    live_handler,
    replay_handler,
    rollout_handler,
    rollout_status_handler,
    wrap_handler,
)
from .http.middleware import cors_middleware, logging_middleware, tracer_middleware
from .http.router import Router
from .http.server import AsyncHTTPServer
from .tracing import new_tracer


class App:
    def __init__(self, config: Config | None = None, configs_dir: str = "./configs"):
        self.config: Config = config if config is not None else EnvConfig(configs_dir)
        self.container = Container.create(self.config)
        self.logger = self.container.logger
        self.tracer = new_tracer(self.config, self.logger)
        self.container.tracer = self.tracer
        self.http_port = self.config.get_int("HTTP_PORT", 8000)
        self.request_timeout = self.config.get_float("REQUEST_TIMEOUT", 5.0)
        self.router = Router()
        self.router.use(tracer_middleware(self.tracer))  # outermost: the log line carries the trace id
        self.router.use(logging_middleware(self.logger))
        self.router.use(cors_middleware())
        self.http_server = AsyncHTTPServer(self.router.dispatch, self.http_port, logger=self.logger)
        self.grpc_port = self.config.get_int("GRPC_PORT", 9000)
        self.grpc_server = None  # built at the first gRPC registration
        self._grpc_registered = False
        self._shutdown_event: asyncio.Event | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        # the drain flag lives on the container, where the health handler reads it
        self._draining = False
        self.container.draining = False
        self.drain_deadline_s = self.config.get_float("GOFR_DRAIN_DEADLINE_S", 30.0)

    def _add(self, method: str, path: str, handler: Callable, timeout_s: float | None = None) -> None:
        self.router.add(
            method, path,
            wrap_handler(handler, self.container, timeout_s if timeout_s is not None else self.request_timeout),
        )

    def get(self, path: str, handler: Callable) -> None:
        self._add("GET", path, handler)

    def post(self, path: str, handler: Callable) -> None:
        self._add("POST", path, handler)

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
        # re-decodes a recorded request on the card, under its own timeout
        self.get("/.well-known/debug/blackbox", debug_blackbox_handler)
        self.get("/.well-known/debug/usage", debug_usage_handler)
        self._add("POST", "/.well-known/debug/replay", replay_handler, timeout_s=max(120.0, self.request_timeout))

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
        await self.http_server.start()
        if self._grpc_registered and self.grpc_server is not None:
            self.grpc_server.start()
            self.logger.info(f"gRPC server listening on :{self.grpc_server.port}")
        try:
            await self._shutdown_event.wait()
        finally:
            await self.http_server.shutdown()
            if self.grpc_server is not None:
                self.grpc_server.shutdown()
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
        deploy) runs the graceful drain."""

        async def main():
            loop = asyncio.get_running_loop()
            for sig, handler in ((signal.SIGINT, self.shutdown), (signal.SIGTERM, self.begin_drain)):
                try:
                    loop.add_signal_handler(sig, handler)
                except (NotImplementedError, RuntimeError):
                    pass
            await self.serve()

        asyncio.run(main())

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
