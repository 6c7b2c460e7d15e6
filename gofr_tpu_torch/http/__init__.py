"""HTTP plumbing of the serving edge (counterpart of gofr_tpu/http):
request and responder, router and middleware, errors, and the asyncio
HTTP/1.1 server."""

from .errors import (
    ErrorEntityNotFound,
    ErrorInvalidParam,
    ErrorInvalidRoute,
    ErrorMethodNotAllowed,
    ErrorMissingParam,
    ErrorPanicRecovery,
    ErrorRequestTimeout,
    ErrorServiceUnavailable,
    ErrorTooManyRequests,
    HTTPError,
)
from .request import Request, UploadedFile
from .responder import FileResponse, Raw, Redirect, Response, StreamingResponse

__all__ = [
    "ErrorEntityNotFound",
    "ErrorInvalidParam",
    "ErrorInvalidRoute",
    "ErrorMethodNotAllowed",
    "ErrorMissingParam",
    "ErrorPanicRecovery",
    "ErrorRequestTimeout",
    "ErrorServiceUnavailable",
    "ErrorTooManyRequests",
    "FileResponse",
    "HTTPError",
    "Raw",
    "Redirect",
    "Request",
    "Response",
    "StreamingResponse",
    "UploadedFile",
]
