"""HTTP error taxonomy with status codes (counterpart of
gofr_tpu/http/errors.py). Any exception with an integer ``status_code``
maps to that status (``status_from_error``); ``retry_after`` on a 429 or
503 becomes the Retry-After header (``responder.respond``)."""

from __future__ import annotations


class HTTPError(Exception):
    status_code = 500

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message or self.__class__.__name__


class ErrorInvalidParam(HTTPError):
    status_code = 400

    def __init__(self, *params: str):
        self.params = list(params)
        super().__init__(f"'{len(self.params)}' invalid parameter(s): {', '.join(self.params)}")


class ErrorMissingParam(HTTPError):
    status_code = 400

    def __init__(self, *params: str):
        self.params = list(params)
        super().__init__(f"'{len(self.params)}' missing parameter(s): {', '.join(self.params)}")


class ErrorEntityNotFound(HTTPError):
    status_code = 404

    def __init__(self, name: str = "", value: str = ""):
        self.name, self.value = name, value
        super().__init__(f"No entity found with {name}: {value}" if name else "entity not found")


class ErrorInvalidRoute(HTTPError):
    status_code = 404

    def __init__(self):
        super().__init__("route not registered")


class ErrorMethodNotAllowed(HTTPError):
    status_code = 405

    def __init__(self):
        super().__init__("method not allowed")


class ErrorRequestTimeout(HTTPError):
    """408: the handler outlived REQUEST_TIMEOUT."""

    status_code = 408

    def __init__(self):
        super().__init__("request timed out")


class ErrorPanicRecovery(HTTPError):
    """500: an unexpected exception in a handler (its text is not sent)."""

    status_code = 500

    def __init__(self):
        super().__init__("some unexpected error has occurred")


class ErrorServiceUnavailable(HTTPError):
    status_code = 503
    retry_after: float | None = None

    def __init__(self, message: str = "service unavailable", retry_after: float | None = None):
        super().__init__(message)
        if retry_after is not None:
            self.retry_after = retry_after


class ErrorTooManyRequests(HTTPError):
    """429: a handler shedding its own work; ``retry_after`` becomes the
    Retry-After header."""

    status_code = 429
    retry_after: float | None = None

    def __init__(self, message: str = "too many requests", retry_after: float | None = None):
        super().__init__(message)
        if retry_after is not None:
            self.retry_after = retry_after


def status_from_error(err: BaseException) -> int:
    code = getattr(err, "status_code", None)
    if isinstance(code, int) and 100 <= code <= 599:
        return code
    return 500
