"""Schema migrations and employee routes over SQL (counterpart of
examples/using-migrations/main.py).

    python -m gofr_tpu_torch.examples.using_migrations

At start-up ``migrate`` applies migration 1708322067 once (it creates the
``employee`` table, inserts employee 1 and adds a ``dob`` column; a later
start finds it recorded in ``gofr_migrations`` and runs nothing). ``GET
/employee?name=x`` answers the employee (404 when none, 400 without a
name); ``POST /employee`` inserts one (201). sqlite at ./employee.db,
HTTP on 9120, metrics on 9121.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..app import App, new
from ..config import Config
from ..http.errors import ErrorEntityNotFound, ErrorMissingParam
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "using-migrations", "HTTP_PORT": "9120", "METRICS_PORT": "9121", "LOG_LEVEL": "INFO",
            "DB_DIALECT": "sqlite", "DB_NAME": "./employee.db"}

CREATE_TABLE = """CREATE TABLE IF NOT EXISTS employee
(
    id             int         not null primary key,
    name           varchar(50) not null,
    gender         varchar(6)  not null,
    contact_number varchar(10) not null
)"""


def create_table_employee(ds):
    ds.sql.exec(CREATE_TABLE)
    ds.sql.exec(
        "INSERT INTO employee (id, name, gender, contact_number) VALUES (?, ?, ?, ?)",
        1, "Umang", "M", "0987654321",
    )
    ds.sql.exec("ALTER TABLE employee ADD dob varchar(11) NULL")


def all_migrations() -> dict:
    # timestamped versions, applied in order
    return {1708322067: create_table_employee}


@dataclass
class Employee:
    id: int = 0
    name: str = ""
    gender: str = ""
    contact_number: str = ""
    dob: str = ""


def get_employee(ctx):
    name = ctx.param("name")
    if not name:
        raise ErrorMissingParam("name")
    row = ctx.sql.query_row("SELECT id, name, gender, contact_number, dob FROM employee WHERE name = ?", name)
    if row is None:
        raise ErrorEntityNotFound("employee", name)
    return Employee(**row)


def post_employee(ctx):
    emp = ctx.bind(Employee)
    ctx.sql.exec(
        "INSERT INTO employee (id, name, gender, contact_number, dob) VALUES (?, ?, ?, ?, ?)",
        emp.id, emp.name, emp.gender, emp.contact_number, emp.dob,
    )
    return "successfully posted entity"


def build_app(config: Config | None = None) -> App:
    app = new(config=config or DefaultsConfig(DEFAULTS))
    app.migrate(all_migrations())
    app.get("/employee", get_employee)
    app.post("/employee", post_employee)
    return app


if __name__ == "__main__":
    build_app().run()
