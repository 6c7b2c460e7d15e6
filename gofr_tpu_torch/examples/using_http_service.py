"""An outbound HTTP service behind a circuit breaker (counterpart of
examples/using-http-service/main.py).

    SERVICE_ADDRESS=http://host:port python -m gofr_tpu_torch.examples.using_http_service

``fact-service`` is registered on SERVICE_ADDRESS (default
http://localhost:9000) with ``CircuitBreaker(threshold=4, interval=1.0)``
and the health endpoint ``breeds``; ``GET /fact?max=N`` forwards ``GET
fact?max_length=N`` and answers the upstream's JSON, or an error with the
upstream's status. HTTP on 9128, metrics on 9129.
"""

from __future__ import annotations

import json

from ..app import App, new
from ..config import Config
from ..http.errors import HTTPError
from ..service import CircuitBreaker, HealthConfig
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "using-http-service", "HTTP_PORT": "9128", "METRICS_PORT": "9129", "LOG_LEVEL": "INFO",
            "SERVICE_ADDRESS": "http://localhost:9000"}


def fact_handler(ctx):
    svc = ctx.get_http_service("fact-service")
    resp = svc.get("fact", params={"max_length": ctx.param("max") or "100"})
    if resp.status_code != 200:
        err = HTTPError(f"upstream returned {resp.status_code}")
        err.status_code = resp.status_code
        raise err
    return json.loads(resp.body)


def build_app(config: Config | None = None) -> App:
    app = new(config=config or DefaultsConfig(DEFAULTS))
    address = app.config.get_or_default("SERVICE_ADDRESS", "http://localhost:9000")
    app.add_http_service("fact-service", address, CircuitBreaker(threshold=4, interval=1.0), HealthConfig("breeds"))
    app.get("/fact", fact_handler)
    return app


if __name__ == "__main__":
    build_app().run()
