"""The default chain and the auth middleware (counterpart of
gofr_tpu/http/middleware): tracer, request log with panic recovery, CORS
and metrics in ``core``; basic, API-key and OAuth auth in ``auth``."""

from .auth import apikey_auth_middleware, basic_auth_middleware, oauth_middleware
from .core import cors_middleware, logging_middleware, metrics_middleware, tracer_middleware

__all__ = [
    "apikey_auth_middleware",
    "basic_auth_middleware",
    "cors_middleware",
    "logging_middleware",
    "metrics_middleware",
    "oauth_middleware",
    "tracer_middleware",
]
