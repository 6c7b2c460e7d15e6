"""Redis-backed key/value routes (counterpart of
examples/http-server-using-redis/main.py).

    REDIS_HOST=host REDIS_PORT=port python -m gofr_tpu_torch.examples.http_server_using_redis

``POST /redis`` stores each key/value of its JSON object for 5 minutes
("Successful", 201); ``GET /redis/{key}`` answers ``{key: value}``, 404
for a missing key; ``GET /redis-pipeline`` sets two keys and reads both
back on one connection (``{"values": ["one", "two"]}``). HTTP on 9132,
metrics on 9133, Redis at localhost:6379 unless the environment says
otherwise.
"""

from __future__ import annotations

from ..app import App, new
from ..config import Config
from ..http.errors import ErrorEntityNotFound, ErrorInvalidParam
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "http-server-using-redis", "HTTP_PORT": "9132", "METRICS_PORT": "9133", "LOG_LEVEL": "INFO",
            "REDIS_HOST": "localhost", "REDIS_PORT": "6379"}
REDIS_EXPIRY_S = 5 * 60


async def redis_set(ctx):
    data = ctx.bind()
    if not isinstance(data, dict):
        raise ErrorInvalidParam("body")
    for key, value in data.items():
        await ctx.redis.set(key, value, ex=REDIS_EXPIRY_S)
    return "Successful"


async def redis_get(ctx):
    key = ctx.path_param("key")
    value = await ctx.redis.get(key)
    if value is None:
        raise ErrorEntityNotFound("key", key)
    return {key: value.decode()}


async def redis_pipeline(ctx):
    # several commands in sequence on one connection
    await ctx.redis.set("pipeline-1", "one", ex=REDIS_EXPIRY_S)
    await ctx.redis.set("pipeline-2", "two", ex=REDIS_EXPIRY_S)
    values = [await ctx.redis.get(k) for k in ("pipeline-1", "pipeline-2")]
    return {"values": [v.decode() if v else None for v in values]}


def build_app(config: Config | None = None) -> App:
    app = new(config=config or DefaultsConfig(DEFAULTS))
    app.post("/redis", redis_set)
    app.get("/redis/{key}", redis_get)
    app.get("/redis-pipeline", redis_pipeline)
    return app


if __name__ == "__main__":
    build_app().run()
