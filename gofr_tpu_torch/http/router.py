"""Router: method + path dispatch behind a middleware chain (counterpart of
gofr_tpu/http/router.py, static routes only: the edge registers no
``{param}`` route).

An unknown path answers 404, a known path under another method 405. Both
answers pass through the middleware chain too, so the CORS middleware
answers a preflight (OPTIONS) on any path and the request log sees every
request.
"""

from __future__ import annotations

from typing import Awaitable, Callable

from .errors import ErrorInvalidRoute, ErrorMethodNotAllowed
from .request import Request
from .responder import Response, respond

# A wire handler: async (Request) -> Response
WireHandler = Callable[[Request], Awaitable[Response]]
# Middleware: (WireHandler) -> WireHandler
Middleware = Callable[[WireHandler], WireHandler]

async def _default_404(req: Request) -> Response:
    return respond(None, ErrorInvalidRoute(), req.method)


async def _default_405(req: Request) -> Response:
    return respond(None, ErrorMethodNotAllowed(), req.method)


def _norm(path: str) -> str:
    return "/" + path.strip("/") if path.strip("/") else "/"


class Router:
    def __init__(self):
        self._routes: dict[tuple[str, str], WireHandler] = {}
        self._paths: set[str] = set()
        self._middleware: list[Middleware] = []
        self._built = False
        self.not_found: WireHandler = _default_404
        self.method_not_allowed: WireHandler = _default_405

    def use(self, mw: Middleware) -> None:
        """Append middleware; applied outermost-first in registration order."""
        if self._built:
            raise RuntimeError("cannot add middleware after server start")
        self._middleware.append(mw)

    def add(self, method: str, path: str, handler: WireHandler) -> None:
        if self._built:
            raise RuntimeError("cannot add routes after server start")
        if "{" in path:
            raise ValueError(f"path parameters are not supported: {path}")
        path = _norm(path)
        self._routes[(method.upper(), path)] = handler
        self._paths.add(path)

    def build(self) -> None:
        """Wrap every handler (and the 404/405 answers) in the middleware
        chain once, at start-up."""
        if self._built:
            return
        self._built = True

        def wrap(h: WireHandler) -> WireHandler:
            for mw in reversed(self._middleware):
                h = mw(h)
            return h

        self._routes = {k: wrap(h) for k, h in self._routes.items()}
        self.not_found = wrap(self.not_found)
        self.method_not_allowed = wrap(self.method_not_allowed)

    async def dispatch(self, req: Request) -> Response:
        if not self._built:
            self.build()
        handler = self._routes.get((req.method, req.path))
        if handler is not None:
            return await handler(req)
        if req.method == "OPTIONS" or req.path not in self._paths:
            return await self.not_found(req)
        return await self.method_not_allowed(req)
