"""HTTP plumbing of the serving edge (counterpart of gofr_tpu/http):
request and responder, router and middleware, errors, and the asyncio
HTTP/1.1 server."""

from .errors import (
    ErrorInvalidParam,
    ErrorInvalidRoute,
    ErrorMethodNotAllowed,
    ErrorPanicRecovery,
    ErrorRequestTimeout,
    ErrorServiceUnavailable,
    HTTPError,
)
from .request import Request
from .responder import Response, StreamingResponse

__all__ = [
    "ErrorInvalidParam",
    "ErrorInvalidRoute",
    "ErrorMethodNotAllowed",
    "ErrorPanicRecovery",
    "ErrorRequestTimeout",
    "ErrorServiceUnavailable",
    "HTTPError",
    "Request",
    "Response",
    "StreamingResponse",
]
