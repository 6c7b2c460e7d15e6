"""Small shared helpers (counterpart of gofr_tpu/utils/__init__.py,
``snake_case`` only: the JAX package's other two helpers configure JAX's
compilation cache and platform, which the port has no use for)."""

from __future__ import annotations

import re

_SNAKE_RE = re.compile(r"(?<!^)(?=[A-Z])")


def snake_case(name: str) -> str:
    """CamelCase -> snake_case; shared by the SQL datasource's column
    mapping (``DB.select``) and the CRUD table and path names (``crud``),
    so the two never diverge."""
    return _SNAKE_RE.sub("_", name).lower()
