"""A publish-only app (counterpart of examples/using-publisher/main.py).

    PUBSUB_BACKEND=KAFKA PUBSUB_BROKER=host:9092 python -m gofr_tpu_torch.examples.using_publisher

``POST /publish-order`` and ``POST /publish-product`` put the request body
on the topics ``order-logs`` and ``products`` through
``ctx.get_publisher()``. The backend is PUBSUB_BACKEND's: MEMORY by
default, FILE for a durable log on one host, KAFKA, MQTT or GOOGLE against
a broker. HTTP on 9134, metrics on 9135.
"""

from __future__ import annotations

import json

from ..app import App, new
from ..config import Config
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "using-publisher", "HTTP_PORT": "9134", "METRICS_PORT": "9135", "LOG_LEVEL": "INFO",
            "PUBSUB_BACKEND": "MEMORY"}


async def publish_order(ctx):
    await ctx.get_publisher().publish("order-logs", json.dumps(ctx.bind()))
    return "Published"


async def publish_product(ctx):
    await ctx.get_publisher().publish("products", json.dumps(ctx.bind()))
    return "Published"


def build_app(config: Config | None = None) -> App:
    app = new(config=config or DefaultsConfig(DEFAULTS))
    app.post("/publish-order", publish_order)
    app.post("/publish-product", publish_product)
    return app


if __name__ == "__main__":
    build_app().run()
