"""A CLI app with two sub-commands (counterpart of
examples/sample-cmd/main.py).

    python -m gofr_tpu_torch.examples.sample_cmd hello
    python -m gofr_tpu_torch.examples.sample_cmd params -name=Vikash
"""

from __future__ import annotations

import sys

from .. import new_cmd
from ..cmd import CMDApp
from ..config import Config
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "sample-cmd", "LOG_LEVEL": "ERROR"}


def hello(ctx):
    return "Hello World!"


def params(ctx):
    return f"Hello {ctx.param('name')}!"


def build_app(config: Config | None = None) -> CMDApp:
    app = new_cmd(config=config or DefaultsConfig(DEFAULTS))
    app.sub_command("hello", hello, description="print a friendly greeting")
    app.sub_command("params", params, description="greet -name=<who>")
    return app


if __name__ == "__main__":
    sys.exit(build_app().run())
