"""Transport-level request object with JSON binding (counterpart of
gofr_tpu/http/request.py, without multipart, zip and dataclass binding)."""

from __future__ import annotations

import json
from typing import Any
from urllib.parse import parse_qs, unquote, urlsplit

from .errors import ErrorInvalidParam

_UNPARSED = object()  # json() cache sentinel (a body may be JSON null)


class Request:
    """Incoming HTTP request handed to handlers through the Context."""

    __slots__ = ("method", "target", "path", "query", "headers", "body", "remote_addr", "_json_cache")

    def __init__(
        self,
        method: str,
        target: str,
        headers: dict[str, str],
        body: bytes = b"",
        remote_addr: str = "",
    ):
        self.method = method
        self.target = target
        split = urlsplit(target)
        self.path = unquote(split.path) or "/"
        self.query: dict[str, list[str]] = parse_qs(split.query, keep_blank_values=True)
        self.headers = headers  # keys lower-cased by the server
        self.body = body
        self.remote_addr = remote_addr
        self._json_cache: Any = _UNPARSED

    def param(self, key: str) -> str:
        """First query-string value, '' when absent."""
        vals = self.query.get(key)
        return vals[0] if vals else ""

    def header(self, key: str) -> str:
        return self.headers.get(key.lower(), "")

    def bind(self) -> Any:
        """The body parsed as JSON; 400 when it is empty or not JSON."""
        if self._json_cache is _UNPARSED:
            if not self.body:
                raise ErrorInvalidParam("body")
            try:
                self._json_cache = json.loads(self.body)
            except (ValueError, UnicodeDecodeError) as e:
                raise ErrorInvalidParam("body") from e
        return self._json_cache
