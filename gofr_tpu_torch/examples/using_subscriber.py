"""A subscriber of the topic ``order-logs`` (counterpart of
examples/using-subscriber/main.py).

    PUBSUB_BACKEND=MQTT MQTT_HOST=host python -m gofr_tpu_torch.examples.using_subscriber

``App.subscribe`` hands every message of ``order-logs`` to ``on_order``,
which logs it and keeps it (``GET /seen`` lists them); its success commits
the message. ``POST /publish-order`` publishes the request body on the same
topic, so the flow can be driven end to end. The backend is
PUBSUB_BACKEND's (MEMORY by default). HTTP on 9104, metrics on 9105.
"""

from __future__ import annotations

from ..app import App, new
from ..config import Config
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "sample-subscriber", "HTTP_PORT": "9104", "METRICS_PORT": "9105", "LOG_LEVEL": "INFO",
            "PUBSUB_BACKEND": "MEMORY"}

RECEIVED: list = []


def on_order(ctx):
    order = ctx.bind()
    ctx.logger.info(f"received order {order}")
    RECEIVED.append(order)
    return None  # success: commit


async def publish_order(ctx):
    body = ctx.bind()
    await ctx.get_publisher().publish("order-logs", ctx.request.body)
    return {"published": body}


def seen(ctx):
    return RECEIVED


def build_app(config: Config | None = None) -> App:
    app = new(config=config or DefaultsConfig(DEFAULTS))
    app.subscribe("order-logs", on_order)
    app.post("/publish-order", publish_order)
    app.get("/seen", seen)
    return app


if __name__ == "__main__":
    build_app().run()
