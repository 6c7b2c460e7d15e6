"""Transport-level request object and binding (counterpart of
gofr_tpu/http/request.py).

``bind`` deserializes the body by content type: JSON, or
``multipart/form-data`` (a minimal RFC 7578 parser). Given a dataclass it
instantiates it, coercing ``int``/``float``/``bool`` fields from strings;
a field typed ``UploadedFile`` binds an uploaded part, one typed
``fileutil.Zip`` unpacks an uploaded zip in memory; a field's ``file``
metadata names its part when the name differs.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, get_origin, get_type_hints
from urllib.parse import parse_qs, unquote, urlsplit

from .errors import ErrorInvalidParam

_UNPARSED = object()  # json() cache sentinel (a body may be JSON null)


class UploadedFile:
    """One part of a multipart upload."""

    __slots__ = ("filename", "content", "content_type", "headers")

    def __init__(self, filename: str, content: bytes, content_type: str = "", headers: dict | None = None):
        self.filename = filename
        self.content = content
        self.content_type = content_type
        self.headers = headers or {}

    def __len__(self) -> int:
        return len(self.content)


def _parse_multipart(body: bytes, content_type: str) -> tuple[dict[str, str], dict[str, UploadedFile]]:
    """Minimal RFC 7578 multipart/form-data parser."""
    boundary = None
    for piece in content_type.split(";"):
        piece = piece.strip()
        if piece.startswith("boundary="):
            boundary = piece[len("boundary="):].strip('"')
    if not boundary:
        raise ErrorInvalidParam("multipart boundary")
    delim = b"--" + boundary.encode()
    fields: dict[str, str] = {}
    files: dict[str, UploadedFile] = {}
    for raw_part in body.split(delim):
        part = raw_part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" in part:
            head, _, content = part.partition(b"\r\n\r\n")
        else:
            head, content = part, b""
        headers: dict[str, str] = {}
        for line in head.decode("utf-8", "replace").split("\r\n"):
            if ":" in line:
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
        name, filename = None, None
        for attr in headers.get("content-disposition", "").split(";"):
            attr = attr.strip()
            if attr.startswith("name="):
                name = attr[5:].strip('"')
            elif attr.startswith("filename="):
                filename = attr[9:].strip('"')
        if name is None:
            continue
        if filename is not None:
            files[name] = UploadedFile(filename, content, headers.get("content-type", ""), headers)
        else:
            fields[name] = content.decode("utf-8", "replace")
    return fields, files


class Request:
    """Incoming HTTP request handed to handlers through the Context."""

    __slots__ = (
        "method", "target", "path", "query", "headers", "body",
        "path_params", "remote_addr", "route_template", "context", "_json_cache",
    )

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
        self.path_params: dict[str, str] = {}  # set by the router
        self.remote_addr = remote_addr
        self.route_template = self.path  # the router sets the matched template
        self.context: dict[str, Any] = {}  # middleware-populated (the span, auth's user or claims)
        self._json_cache: Any = _UNPARSED

    def param(self, key: str) -> str:
        """First query-string value, '' when absent."""
        vals = self.query.get(key)
        return vals[0] if vals else ""

    def params(self, key: str) -> list[str]:
        return self.query.get(key, [])

    def path_param(self, key: str) -> str:
        return self.path_params.get(key, "")

    def header(self, key: str) -> str:
        return self.headers.get(key.lower(), "")

    def host_name(self) -> str:
        host = self.headers.get("host", "")
        proto = self.headers.get("x-forwarded-proto", "http")
        return f"{proto}://{host}" if host else ""

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "")

    def json(self) -> Any:
        """The body parsed as JSON; 400 when it is empty or not JSON."""
        if self._json_cache is _UNPARSED:
            if not self.body:
                raise ErrorInvalidParam("body")
            try:
                self._json_cache = json.loads(self.body)
            except (ValueError, UnicodeDecodeError) as e:
                raise ErrorInvalidParam("body") from e
        return self._json_cache

    def bind(self, target: Any = None) -> Any:
        """Without a target: the parsed JSON, or the multipart fields and
        files in one dict. With a dataclass type: an instance of it. With
        a dict: the JSON object merged into it."""
        ct = self.content_type.split(";")[0].strip().lower()
        if ct == "multipart/form-data":
            fields, files = _parse_multipart(self.body, self.content_type)
            if target is None:
                return {**fields, **files}
            return _bind_dataclass(target, fields, files)
        data = self.json()
        if target is None:
            return data
        if dataclasses.is_dataclass(target):
            if not isinstance(data, dict):
                raise ErrorInvalidParam("body")
            return _bind_dataclass(target, data, {})
        if isinstance(target, dict) and isinstance(data, dict):
            target.update(data)
            return target
        raise ErrorInvalidParam("bind target")


def _bind_dataclass(cls: Any, fields: dict[str, Any], files: dict[str, UploadedFile]) -> Any:
    from ..fileutil import Zip

    if not dataclasses.is_dataclass(cls):
        raise ErrorInvalidParam("bind target")
    hints = get_type_hints(cls)
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        part_name = f.metadata.get("file", f.name) if f.metadata else f.name
        ftype = hints.get(f.name, str)
        if ftype is UploadedFile:
            if part_name in files:
                kwargs[f.name] = files[part_name]
        elif ftype is Zip:
            if part_name in files:
                kwargs[f.name] = Zip.from_bytes(files[part_name].content)
        elif part_name in fields:
            kwargs[f.name] = _coerce(fields[part_name], ftype)
    try:
        return cls(**kwargs)
    except TypeError as e:
        missing = [f.name for f in dataclasses.fields(cls) if f.name not in kwargs
                   and f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING]
        raise ErrorInvalidParam(*missing) from e


def _coerce(value: Any, ftype: Any) -> Any:
    if ftype in (str, Any) or get_origin(ftype) is not None:
        return value
    try:
        if ftype is bool and isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        if ftype in (int, float) and not isinstance(value, ftype):
            return ftype(value)
    except (TypeError, ValueError) as e:
        raise ErrorInvalidParam(str(value)) from e
    return value
