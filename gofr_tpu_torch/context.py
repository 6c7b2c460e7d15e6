"""Context: the per-request facade handed to every handler (counterpart of
gofr_tpu/context.py): the request's surface (``param``, ``params``,
``path_param``, ``bind``, ``header``, ``host_name``), the container's
(``logger``, ``metrics``, ``redis``, ``sql``, ``mongo``, ``tpu()``,
``get_http_service``, ``get_publisher``), the route's
deadline, what the auth middleware found (``authenticated_user``,
``jwt_claims``), and the request's trace through ``trace``, ``trace_id``
and ``traceparent``. HTTP, gRPC, CLI and cron handlers get the same
Context."""

from __future__ import annotations

from typing import Any

from .container import Container
from .tracing import Tracer, current_span


class Context:
    __slots__ = ("request", "container", "deadline", "_span")

    def __init__(self, request: Any, container: Container):
        self.request = request
        self.container = container
        # the request span the tracer middleware opened (HTTP), if any
        ctx = getattr(request, "context", None)
        self._span = ctx.get("span") if isinstance(ctx, dict) else None
        # absolute wall deadline (time.perf_counter timebase) when the
        # route has a timeout; handlers pass it to GenRequest(deadline=)
        self.deadline: float | None = None

    def param(self, key: str) -> str:
        return self.request.param(key)

    def params(self, key: str) -> list[str]:
        return self.request.params(key)

    def path_param(self, key: str) -> str:
        return self.request.path_param(key)

    def bind(self, target: Any = None) -> Any:
        return self.request.bind(target)

    def header(self, key: str) -> str:
        return self.request.header(key)

    def host_name(self) -> str:
        return self.request.host_name()

    @property
    def logger(self):
        return self.container.logger

    @property
    def metrics(self):
        return self.container.metrics

    @property
    def redis(self):
        return self.container.redis

    @property
    def sql(self):
        return self.container.sql

    @property
    def mongo(self):
        return self.container.mongo

    def get_publisher(self):
        """The container's pub/sub backend (PUBSUB_BACKEND), or None."""
        return self.container.get_publisher()

    def get_http_service(self, name: str):
        return self.container.get_http_service(name)

    # -- what the auth middleware found --
    @property
    def jwt_claims(self) -> dict | None:
        ctx = getattr(self.request, "context", None)
        return ctx.get("JWTClaims") if isinstance(ctx, dict) else None

    @property
    def authenticated_user(self) -> str | None:
        ctx = getattr(self.request, "context", None)
        return ctx.get("user") if isinstance(ctx, dict) else None

    # -- tracing (JAX context.py:78-113) --
    def trace(self, name: str):
        """A user span under the active span (else the request span), on
        the app's tracer (a container without one gets its own)."""
        parent = current_span()
        tracer = getattr(self.container, "tracer", None)
        if tracer is None:
            tracer = Tracer(self.container.app_name)
            self.container.tracer = tracer
        span = tracer.start_span(name)
        if parent is None and self._span is not None:
            span.trace_id = self._span.trace_id
            span.parent_id = self._span.span_id
        return span

    @property
    def trace_id(self) -> str:
        return self._span.trace_id if self._span is not None else ""

    @property
    def traceparent(self) -> str:
        """W3C traceparent of the active span (the contextvar first, the
        request span as fallback): attach it to work that crosses into
        threads the contextvar does not reach, e.g.
        ``GenRequest(traceparent=...)`` submitted from a custom thread, so
        the engine's spans land in this request's trace."""
        span = current_span()
        if span is not None and span.end_ns == 0:
            return span.traceparent
        return self._span.traceparent if self._span is not None else ""

    def tpu(self):
        """The accelerator datasource (the LLM registry), named as in the
        JAX package so handlers run unchanged."""
        return self.container.tpu()
