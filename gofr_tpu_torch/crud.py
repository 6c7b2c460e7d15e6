"""CRUD handler generation (counterpart of gofr_tpu/crud.py).

``register_crud_handlers(app, Entity)`` (``App.add_rest_handlers``): the
entity's first annotated field is its primary key; its table and REST
path are ``snake_case`` of the class name unless it defines
``table_name()`` / ``rest_path()``. Registers ``POST /{path}``, ``GET
/{path}``, ``GET /{path}/{id}``, ``PUT /{path}/{id}`` and ``DELETE
/{path}/{id}`` over the SQL datasource's query builder; an entity method
``create`` / ``get_all`` / ``get`` / ``update`` / ``delete`` replaces the
default of its verb. A missing row answers 404.
"""

from __future__ import annotations

from .http.errors import ErrorEntityNotFound, ErrorInvalidParam
from .utils import snake_case as _snake


def _entity_info(entity_cls: type) -> tuple[str, str, list[str], str]:
    fields = list(getattr(entity_cls, "__annotations__", {}))
    if not fields:
        raise ValueError(f"{entity_cls.__name__} has no annotated fields")
    primary = fields[0]
    table = (
        entity_cls.table_name()
        if hasattr(entity_cls, "table_name")
        else _snake(entity_cls.__name__)
    )
    path = (
        entity_cls.rest_path()
        if hasattr(entity_cls, "rest_path")
        else _snake(entity_cls.__name__)
    )
    return table, path.strip("/"), fields, primary


def register_crud_handlers(app, entity_cls: type) -> None:
    table, path, fields, primary = _entity_info(entity_cls)
    qb_cols = [f for f in fields]

    def _sql(ctx):
        if ctx.sql is None:
            raise ErrorInvalidParam("no SQL datasource configured")
        return ctx.sql

    # -- default implementations (crud_handlers.go:139-278) ----------------
    def create(ctx):
        if hasattr(entity_cls, "create"):
            return entity_cls.create(ctx)
        db = _sql(ctx)
        data = ctx.bind()
        values = [data.get(f) for f in qb_cols]
        db.exec(db.builder.insert(table, qb_cols), *values)
        return f"{entity_cls.__name__} successfully created with id: {data.get(primary)}"

    def get_all(ctx):
        if hasattr(entity_cls, "get_all"):
            return entity_cls.get_all(ctx)
        db = _sql(ctx)
        return db.query(db.builder.select_all(table))

    def get_one(ctx):
        if hasattr(entity_cls, "get"):
            return entity_cls.get(ctx)
        db = _sql(ctx)
        row = db.query_row(db.builder.select_by(table, primary), ctx.path_param("id"))
        if row is None:
            raise ErrorEntityNotFound(primary, ctx.path_param("id"))
        return row

    def update(ctx):
        if hasattr(entity_cls, "update"):
            return entity_cls.update(ctx)
        db = _sql(ctx)
        data = ctx.bind()
        cols = [f for f in qb_cols if f != primary and f in data]
        if not cols:
            raise ErrorInvalidParam("no updatable fields in body")
        args = [data[f] for f in cols] + [ctx.path_param("id")]
        n = db.exec(db.builder.update_by(table, cols, primary), *args)
        if n == 0:
            raise ErrorEntityNotFound(primary, ctx.path_param("id"))
        return f"{entity_cls.__name__} successfully updated with id: {ctx.path_param('id')}"

    def delete(ctx):
        if hasattr(entity_cls, "delete"):
            return entity_cls.delete(ctx)
        db = _sql(ctx)
        n = db.exec(db.builder.delete_by(table, primary), ctx.path_param("id"))
        if n == 0:
            raise ErrorEntityNotFound(primary, ctx.path_param("id"))
        return f"{entity_cls.__name__} successfully deleted with id: {ctx.path_param('id')}"

    app.post(f"/{path}", create)
    app.get(f"/{path}", get_all)
    app.get(f"/{path}/{{id}}", get_one)
    app.put(f"/{path}/{{id}}", update)
    app.delete(f"/{path}/{{id}}", delete)
