"""Data migrations (counterpart of gofr_tpu/migration/__init__.py).

``run(migrations, container)`` (``App.migrate``): the migrations are
``{version: up}`` (a callable, ``{"up": fn}`` or a ``Migration``), every
one needs an UP; versions run in ascending order. Applied versions are
tracked in the SQL table ``gofr_migrations`` (version, method,
start_time, duration_ms) and, when Redis is configured, in the Redis
hash ``gofr_migrations``; the last applied version is the larger of the
two, and only later versions run. Each runs inside a SQL transaction,
committed with its record, rolled back (and re-raised) on failure. A
migration receives a ``Datasource``: ``sql`` (the transaction), ``redis``
and ``pubsub`` (None when not configured) and ``logger``.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Callable

__all__ = ["run", "Datasource", "Migration"]

_ENSURE_SQL = (
    "CREATE TABLE IF NOT EXISTS gofr_migrations ("
    " version INTEGER NOT NULL,"
    " method TEXT NOT NULL,"
    " start_time TEXT NOT NULL,"
    " duration_ms REAL,"
    " PRIMARY KEY (version, method))"
)


class Migration:
    """A migration: {"up": fn(datasource)} or a bare callable (UP)."""

    def __init__(self, up: Callable):
        self.up = up


class Datasource:
    """What a migration function receives (migration.go datasource facade):
    .sql is a transaction handle, .redis the live client, .pubsub for topic
    creation — only the configured ones are non-None."""

    def __init__(self, sql_tx=None, redis=None, pubsub=None, logger=None):
        self.sql = sql_tx
        self.redis = redis
        self.pubsub = pubsub
        self.logger = logger

    def redis_call(self, coro):
        """Run an async redis op from sync migration code."""
        return asyncio.run(coro)


def _normalize(migrations: dict[int, Any]) -> dict[int, Migration]:
    out: dict[int, Migration] = {}
    for version, m in migrations.items():
        if isinstance(m, Migration):
            out[int(version)] = m
        elif callable(m):
            out[int(version)] = Migration(m)
        elif isinstance(m, dict) and callable(m.get("up")):
            out[int(version)] = Migration(m["up"])
        else:
            raise ValueError(f"migration {version} has no UP function")
    return out


def _last_version_sql(db) -> int:
    row = db.query_row("SELECT MAX(version) AS v FROM gofr_migrations WHERE method = 'UP'")
    return int(row["v"]) if row and row["v"] is not None else 0


def _last_version_redis(redis) -> int:
    async def get():
        data = await redis.hgetall("gofr_migrations")
        return max((int(json.loads(v)["version"]) for v in data.values()), default=0)

    try:
        return asyncio.run(get())
    except Exception:  # noqa: BLE001
        return 0


def run(migrations: dict[int, Any], container) -> None:
    """app.Migrate entrypoint (gofr.go:281, migration.go:18)."""
    logger = container.logger
    ms = _normalize(migrations)
    versions = sorted(ms)
    db = container.sql
    redis = container.redis
    if db is None and redis is None:
        raise RuntimeError(
            "migrations need a datasource (configure DB_DIALECT or REDIS_HOST)"
        )

    last = 0
    if db is not None:
        db.exec(_ENSURE_SQL)
        last = max(last, _last_version_sql(db))
    if redis is not None:
        last = max(last, _last_version_redis(redis))

    ran = 0
    for version in versions:
        if version <= last:
            continue
        t0 = time.perf_counter()
        start_iso = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        tx = db.begin() if db is not None else None
        ds = Datasource(sql_tx=tx, redis=redis, pubsub=container.pubsub, logger=logger)
        try:
            ms[version].up(ds)
            duration_ms = round((time.perf_counter() - t0) * 1e3, 3)
            if tx is not None:
                bv = db.builder.bindvar
                tx.exec(
                    "INSERT INTO gofr_migrations (version, method, start_time, duration_ms)"
                    f" VALUES ({bv(1)}, {bv(2)}, {bv(3)}, {bv(4)})",
                    version, "UP", start_iso, duration_ms,
                )
                tx.commit()
            if redis is not None:
                async def record():
                    await redis.hset(
                        "gofr_migrations", str(version),
                        json.dumps({
                            "version": version, "method": "UP",
                            "start_time": start_iso, "duration_ms": duration_ms,
                        }),
                    )

                asyncio.run(record())
            logger.info(f"migration {version} ran successfully ({duration_ms}ms)")
            ran += 1
        except Exception as e:  # noqa: BLE001
            if tx is not None:
                tx.rollback()
            logger.error(f"migration {version} failed, rolled back: {e!r}")
            raise
    if ran == 0:
        logger.info("no new migrations to run")
