"""The port's counterparts of the JAX package's framework examples, one
module each, run as ``python -m gofr_tpu_torch.examples.<name>``:
``http_server``, ``using_http_service``, ``sample_cmd``,
``using_cron_jobs``, ``using_custom_metrics``, ``using_file_bind``,
``http_server_using_redis``, ``using_migrations``,
``using_add_rest_handlers``, ``using_publisher``, ``using_subscriber``,
``kafka_batch_inference``, ``grpc_server``, ``secure_server`` and
``train_lm`` (a CLI app that trains on the card). Each has a
``build_app(config=None)``; without a config it reads the process
environment over the example's own defaults (``DEFAULTS``: the keys of the JAX example's ``configs/.env``:
its ports, name, log level and datasources)."""

from __future__ import annotations

import os

from ..config import Config


class DefaultsConfig(Config):
    """The process environment over an example's defaults."""

    def __init__(self, defaults: dict[str, str]):
        self._defaults = dict(defaults)

    def get(self, key: str) -> str | None:
        return os.environ.get(key, self._defaults.get(key))
