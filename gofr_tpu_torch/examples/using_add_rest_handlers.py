"""Generated CRUD routes with a verb override (counterpart of
examples/using-add-rest-handlers/main.py).

    python -m gofr_tpu_torch.examples.using_add_rest_handlers

Migration 1 creates the ``user`` table; ``add_rest_handlers(User)``
registers ``POST /user``, ``GET /user``, ``GET /user/{id}``, ``PUT
/user/{id}`` and ``DELETE /user/{id}``, where ``User.get_all`` replaces
the default ``GET /user`` ("user GetAll called"). sqlite at ./users.db,
HTTP on 9130, metrics on 9131.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..app import App, new
from ..config import Config
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "using-add-rest-handlers", "HTTP_PORT": "9130", "METRICS_PORT": "9131", "LOG_LEVEL": "INFO",
            "DB_DIALECT": "sqlite", "DB_NAME": "./users.db"}

CREATE_TABLE = """CREATE TABLE IF NOT EXISTS user
(
    id          int not null primary key,
    name        varchar(50),
    age         int,
    is_employed bool
)"""


@dataclass
class User:
    id: int = 0
    name: str = ""
    age: int = 0
    is_employed: bool = False

    # replaces the generated GET /user
    @staticmethod
    def get_all(ctx):
        return "user GetAll called"


def build_app(config: Config | None = None) -> App:
    app = new(config=config or DefaultsConfig(DEFAULTS))
    app.migrate({1: lambda ds: ds.sql.exec(CREATE_TABLE)})
    app.add_rest_handlers(User)
    return app


if __name__ == "__main__":
    build_app().run()
