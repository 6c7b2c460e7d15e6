"""REST handlers beside the framework routes (counterpart of
examples/http-server/main.py).

    python -m gofr_tpu_torch.examples.http_server

``GET /greet`` answers ``{"data": "Hello World!"}``; ``GET /hello?name=x``
answers ``Hello x!``, 400 without a name; with ``REDIS_HOST`` set, ``GET
/redis`` answers the value of the key ``test``, 404 when it is absent.
HTTP on 9100, metrics on 9101.
"""

from __future__ import annotations

from ..app import App, new
from ..config import Config
from ..http.errors import ErrorEntityNotFound, ErrorMissingParam
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "sample-api", "APP_VERSION": "1.0.0", "HTTP_PORT": "9100", "METRICS_PORT": "9101",
            "LOG_LEVEL": "INFO", "REQUEST_TIMEOUT": "5"}


def greet(ctx):
    return "Hello World!"


def hello(ctx):
    name = ctx.param("name")
    if not name:
        raise ErrorMissingParam("name")
    ctx.logger.info(f"greeting {name}")
    return f"Hello {name}!"


async def redis_handler(ctx):
    value = await ctx.redis.get("test")
    if value is None:
        raise ErrorEntityNotFound("key", "test")
    return value


def build_app(config: Config | None = None) -> App:
    app = new(config=config or DefaultsConfig(DEFAULTS))
    app.get("/greet", greet)
    app.get("/hello", hello)
    if app.container.redis is not None:
        app.get("/redis", redis_handler)
    return app


if __name__ == "__main__":
    build_app().run()
