"""JSON-over-gRPC handlers with the HTTP handlers' Context (counterpart of
examples/grpc-server/main.py).

    python -m gofr_tpu_torch.examples.grpc_server

``Hello/SayHello`` answers ``{"greeting": "Hello <name>!"}`` (name from
the request, "World" by default) and ``Hello/Squares`` streams ``{"i": i,
"square": i*i}`` for i < n (n from the request, 5 by default): the unary
and the server-streaming shapes. It needs grpcio (the machine with the
card has none). gRPC on 9108, HTTP on 9106, metrics on 9107.
"""

from __future__ import annotations

from ..app import App, new
from ..config import Config
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "grpc-sample", "HTTP_PORT": "9106", "METRICS_PORT": "9107", "GRPC_PORT": "9108",
            "LOG_LEVEL": "INFO"}


def say_hello(ctx):
    name = ctx.bind().get("name", "World")
    return {"greeting": f"Hello {name}!"}


def stream_squares(ctx):
    n = int(ctx.bind().get("n", 5))
    for i in range(n):
        yield {"i": i, "square": i * i}


def build_app(config: Config | None = None) -> App:
    app = new(config=config or DefaultsConfig(DEFAULTS))
    app.grpc_unary("Hello", "SayHello", say_hello)
    app.grpc_server_stream("Hello", "Squares", stream_squares)
    return app


if __name__ == "__main__":
    build_app().run()
