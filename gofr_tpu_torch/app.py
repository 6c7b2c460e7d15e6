"""App: the composition root (counterpart of gofr_tpu/app.py: HTTP and gRPC).

``new(config)`` builds the App: config (``EnvConfig`` over ``./configs``
unless one is passed), the container and its logger, the router behind
the request-log and CORS middleware, and the asyncio HTTP server on
``HTTP_PORT`` (default 8000; 0 binds an ephemeral port, read back from
``app.http_server.port``). Handlers registered with ``get`` / ``post`` run
under ``REQUEST_TIMEOUT`` seconds (default 5; 408 past it). ``run()``
serves until SIGINT or SIGTERM; ``run_in_background()`` serves from a
daemon thread and returns once the socket listens; ``shutdown()`` stops
the server and closes the registered engines.

gRPC: ``grpc_unary`` / ``grpc_server_stream`` register framework-native
JSON-over-gRPC methods with the same ``handler(ctx)`` shape as the HTTP
routes, ``register_service`` a generated-proto servicer; the first
registration builds a ``grpcx.GRPCServer`` on ``GRPC_PORT`` (default 9000;
0 binds an ephemeral port, read back from ``app.grpc_server.port``), which
starts and stops with the HTTP server. ``grpcx`` (and with it ``grpc``) is
imported only then.

Always registered: ``/.well-known/health``, ``/.well-known/alive``, the
404 catch-all, 405 for a known path under another method, and the CORS
preflight. Left out of the port: the metrics server, cron, pub/sub, auth,
static files, swagger and the graceful drain.
"""

from __future__ import annotations

import asyncio
import signal
import threading
from typing import Callable

from .config import Config, EnvConfig
from .container import Container
from .handler import health_handler, live_handler, wrap_handler
from .http.middleware import cors_middleware, logging_middleware
from .http.router import Router
from .http.server import AsyncHTTPServer


class App:
    def __init__(self, config: Config | None = None, configs_dir: str = "./configs"):
        self.config: Config = config if config is not None else EnvConfig(configs_dir)
        self.container = Container.create(self.config)
        self.logger = self.container.logger
        self.http_port = self.config.get_int("HTTP_PORT", 8000)
        self.request_timeout = self.config.get_float("REQUEST_TIMEOUT", 5.0)
        self.router = Router()
        self.router.use(logging_middleware(self.logger))
        self.router.use(cors_middleware())
        self.http_server = AsyncHTTPServer(self.router.dispatch, self.http_port, logger=self.logger)
        self.grpc_port = self.config.get_int("GRPC_PORT", 9000)
        self.grpc_server = None  # built at the first gRPC registration
        self._grpc_registered = False
        self._shutdown_event: asyncio.Event | None = None
        self._loop: asyncio.AbstractEventLoop | None = None

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
            self.grpc_server = GRPCServer(self.container, self.grpc_port)
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
            self.logger.info("Server shutdown complete")

    def shutdown(self) -> None:
        """Stop serving (safe from any thread)."""
        if self._loop is not None and self._shutdown_event is not None:
            self._loop.call_soon_threadsafe(self._shutdown_event.set)

    def run(self) -> None:
        """Blocking entry point; SIGINT and SIGTERM stop the server."""

        async def main():
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                try:
                    loop.add_signal_handler(sig, self.shutdown)
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
