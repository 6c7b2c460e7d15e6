"""Request-log and CORS middleware (counterpart of
gofr_tpu/http/middleware/core.py, without the tracer and metrics
middleware: the port has no spans or metrics yet)."""

from __future__ import annotations

import time
import traceback

from ..logging import Logger
from .errors import ErrorPanicRecovery
from .request import Request
from .responder import Response, respond
from .router import WireHandler


def logging_middleware(logger: Logger):
    """One request log line per request, and panic recovery: an exception
    that escapes the handler chain answers the masked 500 envelope."""

    def mw(next_handler: WireHandler) -> WireHandler:
        async def h(req: Request) -> Response:
            start = time.perf_counter()
            try:
                resp = await next_handler(req)
            except Exception:  # noqa: BLE001 - recovery boundary
                logger.error(f"panic recovered: {traceback.format_exc()}")
                resp = respond(None, ErrorPanicRecovery(), req.method)
            log = {
                "start_time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                "response_time": int((time.perf_counter() - start) * 1e6),  # microseconds
                "method": req.method,
                "uri": req.target,
                "response_code": resp.status,
                "remote_addr": req.remote_addr,
            }
            if resp.status >= 500:
                logger.error(log)
            else:
                logger.info(log)
            return resp

        return h

    return mw


def cors_middleware():
    """Wildcard CORS headers on every answer, and the preflight (OPTIONS)
    answered here with 200."""
    headers = {
        "Access-Control-Allow-Origin": "*",
        "Access-Control-Allow-Headers": "Authorization, Content-Type, x-requested-with, origin, true-client-ip, X-Correlation-ID",
    }

    def mw(next_handler: WireHandler) -> WireHandler:
        async def h(req: Request) -> Response:
            if req.method == "OPTIONS":
                hs = [*headers.items(), ("Access-Control-Allow-Methods", "GET, POST, PUT, PATCH, DELETE, OPTIONS")]
                return Response(200, hs, b"")
            resp = await next_handler(req)
            resp.headers.extend(headers.items())
            return resp

        return h

    return mw
