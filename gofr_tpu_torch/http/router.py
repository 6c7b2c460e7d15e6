"""Router: method + path dispatch behind a middleware chain (counterpart of
gofr_tpu/http/router.py).

Static routes live in a hash; templates with ``{name}`` segments (e.g.
``/users/{id}``) and a trailing ``{rest...}`` catch-all in a segment trie.
A static route wins over a template that also matches. The matched
template, not the URL, is set on the request as ``route_template`` before
the middleware chain runs, so the metrics middleware labels by template
(a URL label would mint a series per id); a request that matches nothing
carries ``UNMATCHED``.

An unknown path answers 404, a known path under another method 405. Both
answers pass through the middleware chain too, so the CORS middleware
answers a preflight (OPTIONS) on any path and the request log and the
metrics see every request.
"""

from __future__ import annotations

import asyncio
from typing import Any, Awaitable, Callable

from .errors import ErrorInvalidRoute, ErrorMethodNotAllowed
from .request import Request
from .responder import Response, respond

# A wire handler: async (Request) -> Response
WireHandler = Callable[[Request], Awaitable[Response]]
# Middleware: (WireHandler) -> WireHandler
Middleware = Callable[[WireHandler], WireHandler]

# route_template label for requests that matched no route (cardinality guard)
UNMATCHED = "/__unmatched__"


class _Route:
    """One registered (method, template) endpoint."""

    __slots__ = ("handler", "template", "param_names")

    def __init__(self, handler: WireHandler, template: str, param_names: list[str]):
        self.handler = handler
        self.template = template
        self.param_names = param_names


class _Node:
    __slots__ = ("children", "param_child", "wild_routes", "routes")

    def __init__(self):
        self.children: dict[str, _Node] = {}
        self.param_child: _Node | None = None
        self.wild_routes: dict[str, _Route] = {}  # method -> catch-all route
        self.routes: dict[str, _Route] = {}  # method -> route


async def _default_404(req: Request) -> Response:
    return respond(None, ErrorInvalidRoute(), req.method)


async def _default_405(req: Request) -> Response:
    return respond(None, ErrorMethodNotAllowed(), req.method)


def _norm(path: str) -> str:
    return "/" + path.strip("/") if path.strip("/") else "/"


class Router:
    def __init__(self):
        self._static: dict[tuple[str, str], _Route] = {}
        self._static_paths: set[str] = set()
        self._root = _Node()
        self._middleware: list[Middleware] = []
        self._built = False
        self.not_found: WireHandler = _default_404
        self.method_not_allowed: WireHandler = _default_405

    def use(self, mw: Middleware) -> None:
        """Append middleware; applied outermost-first in registration order."""
        if self._built:
            raise RuntimeError("cannot add middleware after server start")
        self._middleware.append(mw)

    def has(self, method: str, template: str) -> bool:
        """Is a handler already bound to this exact static route?"""
        return (method.upper(), _norm(template)) in self._static

    def add(self, method: str, template: str, handler: WireHandler) -> None:
        if self._built:
            raise RuntimeError("cannot add routes after server start")
        method = method.upper()
        template = _norm(template)
        if "{" not in template:
            self._static[(method, template)] = _Route(handler, template, [])
            self._static_paths.add(template)
            return
        param_names: list[str] = []
        node = self._root
        segs = template.strip("/").split("/")
        for i, seg in enumerate(segs):
            if seg.startswith("{") and seg.endswith("...}"):
                if i != len(segs) - 1:
                    raise ValueError(f"catch-all segment must be last: {template}")
                param_names.append(seg[1:-4])
                node.wild_routes[method] = _Route(handler, template, param_names)
                return
            if seg.startswith("{") and seg.endswith("}"):
                param_names.append(seg[1:-1])
                if node.param_child is None:
                    node.param_child = _Node()
                node = node.param_child
            else:
                node = node.children.setdefault(seg, _Node())
        node.routes[method] = _Route(handler, template, param_names)

    def _nodes(self):
        stack = [self._root]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())
            if n.param_child:
                stack.append(n.param_child)

    def routes(self) -> list[tuple[str, str]]:
        out = list(self._static)
        for n in self._nodes():
            out.extend((m, r.template) for m, r in n.routes.items())
            out.extend((m, r.template) for m, r in n.wild_routes.items())
        return sorted(out)

    def _match(self, method: str, path: str) -> tuple[_Route | None, list[str], bool]:
        """-> (route, param values, whether the path exists under any method)."""
        r = self._static.get((method, path))
        if r is not None:
            return r, [], True
        path_exists = path in self._static_paths
        node = self._root
        values: list[str] = []
        segs = path.strip("/").split("/") if path != "/" else [""]
        for i, seg in enumerate(segs):
            if node.wild_routes:
                wr = node.wild_routes.get(method)
                if wr is not None:
                    return wr, [*values, "/".join(segs[i:])], True
                return None, [], True
            nxt = node.children.get(seg)
            if nxt is None and node.param_child is not None and seg != "":
                values.append(seg)
                nxt = node.param_child
            if nxt is None:
                return None, [], path_exists
            node = nxt
        if node.routes:
            r = node.routes.get(method)
            if r is None:
                return None, [], True
            return r, values, True
        if node.wild_routes:
            wr = node.wild_routes.get(method)
            if wr is not None:
                return wr, [*values, ""], True
            return None, [], True
        return None, [], path_exists

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

        for r in self._static.values():
            r.handler = wrap(r.handler)
        for n in self._nodes():
            for r in (*n.routes.values(), *n.wild_routes.values()):
                r.handler = wrap(r.handler)
        self.not_found = wrap(self.not_found)
        self.method_not_allowed = wrap(self.method_not_allowed)

    async def dispatch(self, req: Request) -> Response:
        if not self._built:
            self.build()
        route, values, path_exists = self._match(req.method, req.path)
        if route is None:
            req.route_template = UNMATCHED
            if req.method == "OPTIONS" or not path_exists:
                return await self.not_found(req)
            return await self.method_not_allowed(req)
        req.path_params = dict(zip(route.param_names, values))
        req.route_template = route.template
        return await route.handler(req)


def ensure_async(fn: Callable[..., Any]) -> Callable[..., Awaitable[Any]]:
    """Adapt a sync callable to async by running it in the default executor."""
    if asyncio.iscoroutinefunction(fn):
        return fn

    async def runner(*args, **kwargs):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, lambda: fn(*args, **kwargs))

    return runner
