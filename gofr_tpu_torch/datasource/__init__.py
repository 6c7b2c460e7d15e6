"""Datasource seams wired into the Container (counterpart of
gofr_tpu/datasource/__init__.py, health helpers only)."""

from __future__ import annotations

STATUS_UP = "UP"
STATUS_DOWN = "DOWN"


def health(status: str, **details) -> dict:
    return {"status": status, "details": details}
