"""Every security surface in one app (counterpart of
examples/secure-server/main.py).

    python -m gofr_tpu_torch.examples.secure_server

HTTPS (``HTTP_TLS_CERT_FILE`` / ``HTTP_TLS_KEY_FILE``), basic auth on every
route (admin / change-me), Redis with a password over TLS and MongoDB with
SCRAM-SHA-256 over TLS. ``POST /secrets`` stores each key/value of its JSON
object in Redis and writes an audit entry to Mongo ("stored", 201);
``GET /secrets/{key}`` answers ``{key: value}`` and audits the read, 404
for a missing key; ``GET /audit`` lists the audit entries. HTTPS on 9140,
metrics on 9141.

Demo mode (the default; ``SECURE_DEMO=0`` turns it off) starts in-process
stand-ins speaking the real wire protocols, ``testutil.MiniRedis``
enforcing AUTH over TLS and ``testutil.fakemongo.FakeMongoServer``
enforcing SCRAM over TLS, both serving ``testutil.self_signed_cert()``,
and wires the app through the same environment a deployment sets:
``REDIS_HOST`` / ``_PORT`` / ``_PASSWORD`` / ``_TLS`` / ``_TLS_CA_CERT`` and
``SECURE_MONGO_HOST`` / ``_PORT`` / ``_USER`` / ``_PASSWORD`` / ``_TLS`` /
``_TLS_CA_CERT`` (read with ``datasource.tls_from_config``). Demo mode
needs the ``cryptography`` package for the certificate.
"""

from __future__ import annotations

import os

from ..app import App, new
from ..config import Config
from ..datasource import tls_from_config
from ..datasource.mongo.wire import WireMongo
from ..http.errors import ErrorEntityNotFound, ErrorInvalidParam
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "secure-server", "HTTP_PORT": "9140", "METRICS_PORT": "9141", "LOG_LEVEL": "INFO"}
BASIC_USER, BASIC_PASS = "admin", "change-me"


async def store_secret(ctx):
    body = ctx.bind()
    if not isinstance(body, dict):
        raise ErrorInvalidParam("body")
    for key, value in body.items():
        await ctx.redis.set(f"secret:{key}", value)
        ctx.mongo.insert_one("audit", {"action": "store", "key": key})
    return "stored"


async def read_secret(ctx):
    key = ctx.path_param("key")
    value = await ctx.redis.get(f"secret:{key}")
    if value is None:
        raise ErrorEntityNotFound("secret", key)
    ctx.mongo.insert_one("audit", {"action": "read", "key": key})
    return {key: value.decode()}


async def audit_log(ctx):
    return {"entries": [{"action": e["action"], "key": e["key"]} for e in ctx.mongo.find("audit")]}


def _start_demo_backends():
    """The authenticated TLS stand-ins, published through the environment
    a deployment sets, so the app below is wired as in production."""
    from ..testutil import MiniRedis, self_signed_cert, server_tls_context
    from ..testutil.fakemongo import FakeMongoServer

    cert, key = self_signed_cert()
    redis = MiniRedis(password="redis-demo-pw", tls=server_tls_context()).start()
    mongo = FakeMongoServer(users={"svc": "mongo-demo-pw"}, tls=True)
    os.environ.setdefault("HTTP_TLS_CERT_FILE", cert)
    os.environ.setdefault("HTTP_TLS_KEY_FILE", key)
    os.environ.update({
        "REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(redis.port), "REDIS_PASSWORD": "redis-demo-pw",
        "REDIS_TLS": "true", "REDIS_TLS_CA_CERT": cert,
        "SECURE_MONGO_HOST": "127.0.0.1", "SECURE_MONGO_PORT": str(mongo.port), "SECURE_MONGO_USER": "svc",
        "SECURE_MONGO_PASSWORD": "mongo-demo-pw", "SECURE_MONGO_TLS": "true", "SECURE_MONGO_TLS_CA_CERT": cert,
    })
    return redis, mongo


def build_app(config: Config | None = None) -> App:
    demo = os.environ.get("SECURE_DEMO", "1").lower() not in ("0", "false", "no", "off")
    backends = _start_demo_backends() if demo else None

    app = new(config=config or DefaultsConfig(DEFAULTS))
    app._secure_demo_backends = backends  # kept alive with the app

    # a provider the app builds itself, with SCRAM and TLS from SECURE_MONGO_*
    app.add_mongo(WireMongo(
        app.config.get_or_default("SECURE_MONGO_HOST", "localhost"),
        int(app.config.get_or_default("SECURE_MONGO_PORT", "27017")),
        "securedb",
        username=app.config.get("SECURE_MONGO_USER"),
        password=app.config.get("SECURE_MONGO_PASSWORD"),
        tls=tls_from_config(app.config, "SECURE_MONGO"),
    ))

    app.enable_basic_auth(BASIC_USER, BASIC_PASS)
    app.post("/secrets", store_secret)
    app.get("/secrets/{key}", read_secret)
    app.get("/audit", audit_log)
    return app


if __name__ == "__main__":
    build_app().run()
