"""An in-process cron counter (counterpart of
examples/using-cron-jobs/main.py).

    python -m gofr_tpu_torch.examples.using_cron_jobs

The job ``counter`` runs every minute (``* * * * *``) and adds one to a
counter that ``GET /count`` reads. HTTP on 9122, metrics on 9123.
"""

from __future__ import annotations

import threading

from ..app import App, new
from ..config import Config
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "using-cron-jobs", "HTTP_PORT": "9122", "METRICS_PORT": "9123", "LOG_LEVEL": "INFO"}

_count = 0
_mu = threading.Lock()


def count(ctx):
    global _count
    with _mu:
        _count += 1
        n = _count
    ctx.logger.info(f"Count: {n}")


def get_count(ctx):
    with _mu:
        return {"count": _count}


def build_app(config: Config | None = None) -> App:
    app = new(config=config or DefaultsConfig(DEFAULTS))
    app.add_cron_job("* * * * *", "counter", count)
    app.get("/count", get_count)
    return app


if __name__ == "__main__":
    build_app().run()
