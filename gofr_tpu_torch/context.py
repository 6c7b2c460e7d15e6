"""Context: the per-request facade handed to every handler (counterpart of
gofr_tpu/context.py: the request, the container, the route's deadline, and
the request's trace through ``trace``, ``trace_id`` and ``traceparent``)."""

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

    def bind(self) -> Any:
        return self.request.bind()

    def header(self, key: str) -> str:
        return self.request.header(key)

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
