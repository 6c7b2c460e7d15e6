"""gRPC server: framework-native JSON-over-gRPC methods (counterpart of
gofr_tpu/grpcx.py, without tracing spans).

``GRPCServer.add_unary`` / ``add_server_stream`` register handlers with the
same ``handler(ctx) -> result`` signature as the HTTP routes, carried over
generic JSON method handlers (no protoc needed; generated-proto services
still register via ``register``). Server-streaming handlers return or
yield chunks: the token-streaming path of LLM decode. gRPC metadata
surfaces through ``ctx.header``, so the X-GoFr-* identity headers
(priority, client, session, adapter) work over gRPC as over HTTP.

One interceptor wraps every method with panic recovery (INTERNAL) and an
RPC log line; an exception carrying a mappable ``status_code`` aborts with
its gRPC status instead: 429 -> RESOURCE_EXHAUSTED with a ``retry-after``
trailer (seconds), 503 -> UNAVAILABLE. Port 0 binds an ephemeral port,
read back from ``GRPCServer.port`` after ``start()``.

Imports ``grpc`` (grpcio): a process without it cannot import this module;
``app.App`` imports it lazily.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import time
import uuid
from concurrent import futures
from typing import Any, Callable, Iterator

import grpc

from .context import Context

__all__ = ["GRPCServer", "GRPCRequest", "json_server_stream", "json_unary"]


class GRPCRequest:
    """Adapts a generic JSON request + metadata to the Request interface."""

    def __init__(self, payload: bytes, invocation_context, method: str):
        self.payload = payload
        self._grpc_ctx = invocation_context
        self.method = method
        self.context: dict = {}
        self._meta = dict(invocation_context.invocation_metadata() or [])

    def param(self, key: str) -> str:
        # gRPC metadata keys are lowercase on the wire; mirror the HTTP
        # request's case-insensitive lookup so shared handlers work
        return str(self._meta.get(key.lower(), ""))

    def params(self, key: str) -> list[str]:
        v = self.param(key)
        return [v] if v else []

    def path_param(self, key: str) -> str:
        return self.method if key == "method" else ""

    def bind(self, target: Any = None) -> Any:
        data = json.loads(self.payload) if self.payload else {}
        if target is not None and hasattr(target, "__annotations__"):
            for k, v in data.items():
                if k in target.__annotations__:
                    setattr(target, k, v)
            return target
        return data

    def header(self, key: str) -> str:
        return self.param(key)

    def host_name(self) -> str:
        return self._grpc_ctx.peer() or ""


def _json_bytes(result: Any) -> bytes:
    return json.dumps(result).encode()


# HTTP-status seam -> gRPC status, for exceptions carrying status_code:
# overload maps to RESOURCE_EXHAUSTED and unavailability to UNAVAILABLE,
# the two codes gRPC client retry policies key on; a ``retry-after``
# trailer (seconds, decimal string) mirrors the HTTP Retry-After header
_STATUS_TO_GRPC = {
    429: grpc.StatusCode.RESOURCE_EXHAUSTED,
    503: grpc.StatusCode.UNAVAILABLE,
}


def _abort_mapped(ctx, e: BaseException) -> bool:
    """Abort the RPC with the mapped gRPC status when ``e`` carries a
    mappable status_code; False when the caller should fall through to its
    INTERNAL recovery path. abort() raises, so on a mapping this never
    returns."""
    code = _STATUS_TO_GRPC.get(getattr(e, "status_code", None))
    if code is None:
        return False
    retry_after = getattr(e, "retry_after", None)
    if isinstance(retry_after, (int, float)) and 0 < retry_after < float("inf"):
        ctx.set_trailing_metadata((("retry-after", f"{retry_after:.3f}"),))
    ctx.abort(code, str(e) or e.__class__.__name__)
    return True  # pragma: no cover — abort raises


class _Interceptor(grpc.ServerInterceptor):
    """Recovery + logging + tracing in one chain link: every behavior runs
    under panic recovery (INTERNAL), inside a per-RPC span parented by the
    caller's ``traceparent`` metadata, and logs one RPC line."""

    def __init__(self, container, tracer=None):
        self.container = container
        self.tracer = tracer

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None:
            return None
        method = handler_call_details.method

        def wrap_unary(behavior):
            def wrapped(request, ctx):
                return self._observed(behavior, request, ctx, method)

            return wrapped

        def wrap_stream(behavior):
            def wrapped(request, ctx):
                yield from self._observed_stream(behavior, request, ctx, method)

            return wrapped

        if handler.unary_unary is not None:
            return grpc.unary_unary_rpc_method_handler(
                wrap_unary(handler.unary_unary),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        if handler.unary_stream is not None:
            return grpc.unary_stream_rpc_method_handler(
                wrap_stream(handler.unary_stream),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        return handler  # client-streaming passthrough

    def _span(self, method: str, grpc_ctx=None):
        """The RPC's span (JAX grpcx.py:148-157): W3C trace context rides
        the metadata, so engine spans join the caller's trace."""
        if self.tracer is None:
            return None
        traceparent = None
        if grpc_ctx is not None:
            traceparent = dict(grpc_ctx.invocation_metadata() or []).get("traceparent")
        return self.tracer.start_span(f"grpc{method}", traceparent=traceparent)

    def _log(self, method: str, t0: float, code: str, rpc_id: str) -> None:
        logger = getattr(self.container, "logger", None)
        if logger is not None:
            logger.info({
                "rpc_id": rpc_id,
                "method": method,
                "status_code": code,
                "response_time_us": round((time.perf_counter() - t0) * 1e6),
            })

    def _recover(self, ctx, e: Exception, method: str, t0: float, rpc_id: str) -> None:
        code = _STATUS_TO_GRPC.get(getattr(e, "status_code", None))
        if code is not None:
            # overload / unavailability: a TYPED rejection, not a panic
            self._log(method, t0, code.name, rpc_id)
            _abort_mapped(ctx, e)
        logger = getattr(self.container, "logger", None)
        if logger is not None:
            logger.error(f"panic in gRPC handler {method}: {e!r}")
        self._log(method, t0, "INTERNAL", rpc_id)
        ctx.abort(grpc.StatusCode.INTERNAL, "internal error")

    def _observed(self, behavior, request, ctx, method: str):
        t0 = time.perf_counter()
        rpc_id = uuid.uuid4().hex[:16]
        span = self._span(method, ctx)
        try:
            out = behavior(request, ctx)
            self._log(method, t0, "OK", rpc_id)
            return out
        except grpc.RpcError:
            self._log(method, t0, "RPC_ERROR", rpc_id)
            raise
        except Exception as e:  # noqa: BLE001 — recovery interceptor
            self._recover(ctx, e, method, t0, rpc_id)
        finally:
            if span is not None:
                span.end()

    def _observed_stream(self, behavior, request, ctx, method: str):
        t0 = time.perf_counter()
        rpc_id = uuid.uuid4().hex[:16]
        span = self._span(method, ctx)
        try:
            yield from behavior(request, ctx)
            self._log(method, t0, "OK", rpc_id)
        except grpc.RpcError:
            self._log(method, t0, "RPC_ERROR", rpc_id)
            raise
        except Exception as e:  # noqa: BLE001
            self._recover(ctx, e, method, t0, rpc_id)
        finally:
            if span is not None:
                span.end()


def _run_handler(handler: Callable, ctx: Context) -> Any:
    """Sync or async handlers, as over HTTP."""
    if inspect.iscoroutinefunction(handler):
        return asyncio.run(handler(ctx))
    return handler(ctx)


def _iter_stream_handler(handler: Callable, ctx: Context) -> Iterator[Any]:
    """Stream handlers in every natural shape: sync generator, async
    generator (driven on a private loop so each chunk yields as produced),
    or a coroutine returning an iterable."""
    if inspect.isasyncgenfunction(handler):
        agen = handler(ctx)
        loop = asyncio.new_event_loop()
        try:
            while True:
                try:
                    yield loop.run_until_complete(agen.__anext__())
                except StopAsyncIteration:
                    return
        finally:
            loop.run_until_complete(agen.aclose())
            # closing the handler's generator abandons any async generator
            # it was iterating (GenRequest.astream): those finalize through
            # the loop's asyncgen hooks, which must run before the loop
            # closes, or their disconnect cancel never runs
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.close()
    else:
        yield from _run_handler(handler, ctx)


class GRPCServer:
    def __init__(self, container, port: int, tracer=None, *, max_workers: int = 16):
        self.container = container
        self.port = port
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            interceptors=[_Interceptor(container, tracer)],
        )
        self._generic_methods: dict[str, dict[str, Any]] = {}
        self._started = False

    def register(self, add_servicer_fn: Callable, servicer: Any) -> None:
        """A generated-proto service: ``add_XServicer_to_server``."""
        add_servicer_fn(servicer, self._server)

    def add_unary(self, service: str, method: str, handler: Callable) -> None:
        """handler(ctx) -> JSON-serializable. Request payload: JSON bytes."""

        def behavior(request: bytes, grpc_ctx):
            ctx = Context(GRPCRequest(request, grpc_ctx, f"/{service}/{method}"), self.container)
            return _json_bytes(_run_handler(handler, ctx))

        self._generic_methods.setdefault(service, {})[method] = grpc.unary_unary_rpc_method_handler(
            behavior, request_deserializer=lambda b: b, response_serializer=lambda b: b,
        )

    def add_server_stream(self, service: str, method: str, handler: Callable) -> None:
        """handler(ctx) -> iterator of JSON-serializable chunks (token
        streaming: one chunk per token). The serving loop checks
        ``grpc_ctx.is_active()`` at every chunk and closes the handler's
        iterator once the peer is gone, on the serving thread, so its
        GeneratorExit path runs (an LLM stream's disconnect cancel: slot
        freed, finish_reason "disconnect")."""

        def behavior(request: bytes, grpc_ctx) -> Iterator[bytes]:
            ctx = Context(GRPCRequest(request, grpc_ctx, f"/{service}/{method}"), self.container)
            it = _iter_stream_handler(handler, ctx)
            try:
                for chunk in it:
                    if not grpc_ctx.is_active():
                        break  # peer gone: finally closes the handler
                    yield _json_bytes(chunk)
            finally:
                it.close()

        self._generic_methods.setdefault(service, {})[method] = grpc.unary_stream_rpc_method_handler(
            behavior, request_deserializer=lambda b: b, response_serializer=lambda b: b,
        )

    def start(self) -> None:
        for service, methods in self._generic_methods.items():
            self._server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(service, methods),))
        bound = self._server.add_insecure_port(f"[::]:{self.port}")
        if self.port == 0:
            self.port = bound
        self._server.start()
        self._started = True

    def shutdown(self, grace: float = 2.0) -> None:
        if self._started:
            self._server.stop(grace)
            self._started = False


# -- JSON-over-gRPC client helpers (tests and inter-service calls) ---------


def json_unary(target: str, service: str, method: str, payload: Any, timeout: float = 10.0) -> Any:
    with grpc.insecure_channel(target) as channel:
        fn = channel.unary_unary(
            f"/{service}/{method}", request_serializer=lambda b: b, response_deserializer=lambda b: b,
        )
        return json.loads(fn(_json_bytes(payload), timeout=timeout))


def json_server_stream(target: str, service: str, method: str, payload: Any, timeout: float = 30.0) -> Iterator[Any]:
    with grpc.insecure_channel(target) as channel:
        fn = channel.unary_stream(
            f"/{service}/{method}", request_serializer=lambda b: b, response_deserializer=lambda b: b,
        )
        for chunk in fn(_json_bytes(payload), timeout=timeout):
            yield json.loads(chunk)
