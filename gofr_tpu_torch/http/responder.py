"""Response serialization (counterpart of gofr_tpu/http/responder.py,
without redirect responses): the success envelope
``{"data": ...}`` (POST answers 201, DELETE 204), the error envelope
``{"error": {"message": ...}}`` with the status from the error, chunked
streaming bodies and raw file bodies (``FileResponse``: a profile
archive)."""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, AsyncIterator

from .errors import status_from_error


class Response:
    """Wire-level response: status, headers, body bytes or async chunk iterator."""

    __slots__ = ("status", "headers", "body", "stream")

    def __init__(
        self,
        status: int = 200,
        headers: list[tuple[str, str]] | None = None,
        body: bytes = b"",
        stream: AsyncIterator[bytes] | None = None,
    ):
        self.status = status
        self.headers = headers or []
        self.body = body
        self.stream = stream


class StreamingResponse:
    """A chunked body: an async iterator of byte chunks (token streams)."""

    __slots__ = ("chunks", "content_type")

    def __init__(self, chunks: AsyncIterator[bytes], content_type: str = "text/event-stream"):
        self.chunks = chunks
        self.content_type = content_type


class FileResponse:
    """Bytes with a content type, sent as they are (200)."""

    __slots__ = ("content", "content_type")

    def __init__(self, content: bytes, content_type: str = "application/octet-stream"):
        self.content = content
        self.content_type = content_type


def _default_json(o: Any) -> Any:
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return dataclasses.asdict(o)
    if hasattr(o, "tolist"):  # numpy arrays and tensors returned by handlers
        return o.tolist()
    if hasattr(o, "item") and getattr(o, "ndim", None) == 0:
        return o.item()
    if isinstance(o, bytes):
        return o.decode("utf-8", "replace")
    return str(o)


def to_json_bytes(payload: Any) -> bytes:
    return json.dumps(payload, default=_default_json, separators=(",", ":")).encode("utf-8")


_METHOD_SUCCESS = {"POST": 201, "DELETE": 204}


def respond(result: Any, err: BaseException | None, method: str = "GET") -> Response:
    """Map a handler's (result, error) to a wire Response."""
    if err is not None:
        status = status_from_error(err)
        msg = getattr(err, "message", None) or str(err) or err.__class__.__name__
        headers = [("Content-Type", "application/json")]
        retry_after = getattr(err, "retry_after", None)
        if (
            isinstance(retry_after, (int, float))
            and retry_after == retry_after  # not NaN
            and 0 < retry_after < float("inf")
            and status in (429, 503)
        ):
            headers.append(("Retry-After", str(max(1, math.ceil(retry_after)))))
        return Response(status, headers, to_json_bytes({"error": {"message": msg}}))
    if isinstance(result, Response):
        return result
    if isinstance(result, FileResponse):
        return Response(200, [("Content-Type", result.content_type)], result.content)
    if isinstance(result, StreamingResponse):
        return Response(200, [("Content-Type", result.content_type)], b"", stream=result.chunks)
    status = _METHOD_SUCCESS.get(method, 200)
    if status == 204 and result is None:
        return Response(204, [], b"")
    return Response(status, [("Content-Type", "application/json")], to_json_bytes({"data": result}))
