"""Datasource seams wired into the Container (counterpart of
gofr_tpu/datasource/__init__.py): the health statuses and ``health``,
``ErrorDB`` (a datasource failure: HTTP 500), and the TLS convention of the
wire clients (``wrap_tls``, ``tls_from_config``)."""

from __future__ import annotations

STATUS_UP = "UP"
STATUS_DOWN = "DOWN"


class ErrorDB(Exception):
    """Datasource failure: maps to HTTP 500."""

    def __init__(self, message: str, cause: Exception | None = None):
        super().__init__(message)
        self.message = message
        self.cause = cause

    def status_code(self) -> int:
        return 500


def health(status: str, **details) -> dict:
    return {"status": status, "details": details}


def wrap_tls(sock, tls, host: str):
    """Wrap a connected socket in TLS when enabled. ``tls`` is None or
    False (off), True (a default verifying context) or an
    ``ssl.SSLContext``."""
    if tls is None or tls is False:
        return sock
    import ssl

    ctx = ssl.create_default_context() if tls is True else tls
    return ctx.wrap_socket(sock, server_hostname=host)


def tls_from_config(config, prefix: str):
    """The config's TLS for a wire client: ``{PREFIX}_TLS=true`` enables
    it, ``{PREFIX}_TLS_CA_CERT`` names a PEM bundle to trust, and
    ``{PREFIX}_TLS_INSECURE=true`` skips verification (development only).
    None when TLS is off."""
    if str(config.get(f"{prefix}_TLS") or "").lower() not in ("1", "true", "yes"):
        return None
    import ssl

    ca = config.get(f"{prefix}_TLS_CA_CERT")
    ctx = ssl.create_default_context(cafile=ca or None)
    if str(config.get(f"{prefix}_TLS_INSECURE") or "").lower() in ("1", "true", "yes"):
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx
