"""Configuration: env-file loading with environment-specific overrides
(counterpart of gofr_tpu/config/__init__.py).

``EnvConfig`` loads ``<configs_dir>/.env``, then overrides it with
``.{APP_ENV}.env`` (or ``.local.env`` when APP_ENV is unset); the process
environment always wins. ``MapConfig`` / ``new_mock_config`` are the
dict-backed config tests use.
"""

from __future__ import annotations

import os
from typing import Mapping


class Config:
    """Read-only config facade: get / get_or_default and typed helpers."""

    def get(self, key: str) -> str | None:
        raise NotImplementedError

    def get_or_default(self, key: str, default: str) -> str:
        v = self.get(key)
        return v if v not in (None, "") else default

    def get_int(self, key: str, default: int) -> int:
        v = self.get(key)
        if v in (None, ""):
            return default
        try:
            return int(v)  # type: ignore[arg-type]
        except ValueError:
            return default

    def get_float(self, key: str, default: float) -> float:
        v = self.get(key)
        if v in (None, ""):
            return default
        try:
            return float(v)  # type: ignore[arg-type]
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v in (None, ""):
            return default
        return str(v).strip().lower() in ("1", "true", "yes", "on")


def _parse_env_file(path: str) -> dict[str, str]:
    out: dict[str, str] = {}
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if line.startswith("export "):
                    line = line[len("export ") :]
                if "=" not in line:
                    continue
                k, _, v = line.partition("=")
                k, v = k.strip(), v.strip()
                if len(v) >= 2 and v[0] == v[-1] and v[0] in ("'", '"'):
                    v = v[1:-1]
                out[k] = v
    except FileNotFoundError:
        pass
    return out


class EnvConfig(Config):
    """Layered env config. Precedence (highest wins): process env >
    .{APP_ENV}.env / .local.env > .env."""

    def __init__(self, configs_dir: str = "./configs", environ: Mapping[str, str] | None = None):
        self._environ = environ if environ is not None else os.environ
        base = _parse_env_file(os.path.join(configs_dir, ".env"))
        app_env = self._environ.get("APP_ENV", "") or base.get("APP_ENV", "")
        override_file = f".{app_env}.env" if app_env else ".local.env"
        override = _parse_env_file(os.path.join(configs_dir, override_file))
        self._values = {**base, **override}

    def get(self, key: str) -> str | None:
        if key in self._environ:
            return self._environ[key]
        return self._values.get(key)


class MapConfig(Config):
    """Dict-backed config for tests."""

    def __init__(self, values: dict[str, str] | None = None):
        self._values = dict(values or {})

    def get(self, key: str) -> str | None:
        return self._values.get(key)


def new_mock_config(values: dict[str, str] | None = None) -> MapConfig:
    return MapConfig(values)
