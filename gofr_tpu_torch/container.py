"""Container: the dependency hub handed to every handler (counterpart of
gofr_tpu/container/__init__.py: config, logger, the metrics manager and
the lazily built runtime behind ``tpu()``; no SQL, Redis, Mongo or
pub/sub). The manager carries the series the runtime and its engines
write; ``tracer`` (set by the App) is handed to the runtime, which passes
it to every engine; the metrics server is ROADMAP ID 16."""

from __future__ import annotations

import threading
import time
from typing import Any

from . import logging as gl
from .config import Config
from .metrics import Manager

# The framework version the health route reports: the JAX package's, whose
# wire format this edge keeps.
FRAMEWORK = "0.4.0"


class Container:
    def __init__(self, config: Config | None = None, logger: gl.Logger | None = None):
        self.config = config
        self.logger: gl.Logger = logger or gl.new_logger()
        self.metrics_manager = Manager(self.logger)
        self.app_name = "gofr-tpu-app"
        self.app_version = "dev"
        self.tpu_runtime = None
        self.tracer = None  # the App's tracing.Tracer
        self.start_time = time.time()
        self._lock = threading.Lock()

    @classmethod
    def create(cls, config: Config) -> "Container":
        c = cls(config=config, logger=gl.new_logger(config.get("LOG_LEVEL")))
        c.app_name = config.get_or_default("APP_NAME", "gofr-tpu-app")
        c.app_version = config.get_or_default("APP_VERSION", "dev")
        return c

    def tpu(self):
        """The GPU runtime (LLM registry), built on first use: an app that
        registers no model never touches the device."""
        with self._lock:
            if self.tpu_runtime is None:
                from .datasource.gpu import GPURuntime

                # engines registered before the App set its tracer serve untraced
                self.tpu_runtime = GPURuntime(self.config, self.logger, metrics=self.metrics_manager,
                                              tracer=self.tracer)
            return self.tpu_runtime

    def health(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.tpu_runtime is not None:
            out["tpu"] = self.tpu_runtime.health_check()
        out["app"] = {
            "status": "UP",
            "details": {
                "name": self.app_name,
                "version": self.app_version,
                "framework": FRAMEWORK,
                "uptime_s": round(time.time() - self.start_time, 3),
            },
        }
        return out

    def close(self) -> None:
        if self.tpu_runtime is not None:
            self.tpu_runtime.close()
