"""Context: the per-request facade handed to every handler (counterpart of
gofr_tpu/context.py, without tracing spans)."""

from __future__ import annotations

from typing import Any

from .container import Container


class Context:
    __slots__ = ("request", "container", "deadline")

    def __init__(self, request: Any, container: Container):
        self.request = request
        self.container = container
        # absolute wall deadline (time.perf_counter timebase) when the
        # route has a timeout; handlers pass it to GenRequest(deadline=)
        self.deadline: float | None = None

    def param(self, key: str) -> str:
        return self.request.param(key)

    def bind(self) -> Any:
        return self.request.bind()

    def header(self, key: str) -> str:
        return self.request.header(key)

    def tpu(self):
        """The accelerator datasource (the LLM registry), named as in the
        JAX package so handlers run unchanged."""
        return self.container.tpu()
