"""SQL datasource (counterpart of gofr_tpu/datasource/sql/__init__.py).

``new_sql`` builds a ``DB`` from the config (``DB_DIALECT``: sqlite,
mysql or postgres, default sqlite; ``DB_HOST``, ``DB_PORT``, ``DB_USER``,
``DB_PASSWORD``, ``DB_NAME``, ``DB_MAX_OPEN_CONNS``). The handle logs every
statement at debug level with its duration and records it in the
``app_sql_stats`` histogram (by type and database); a monitor thread pings
every ``MONITOR_INTERVAL_S`` (10 s), reconnects a lost database and sets
the ``app_sql_open_connections`` and ``app_sql_inuse_connections`` gauges.
A database that is down at start-up does not fail the app. ``select``
maps rows onto a class's annotated fields (snake_case field name ==
column); ``begin`` opens a ``Tx``; ``QueryBuilder`` writes the dialect's
statements with its database library's placeholders; ``health_check`` pings.
``new_sql_mocks`` is an in-memory sqlite database, the test seam.

sqlite is in the standard library. The mysql and postgres branches build
their connections through pymysql and psycopg2 as the JAX package's do;
without that library, construction raises ``ErrorDB`` naming it. Neither
library is installed where the port is tested or run on the card, so
only sqlite runs there.

Handlers may be sync (on the app's executor) or async: connections are
per thread (sqlite's are not thread-safe), with one lock for the pool.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable

from .. import STATUS_DOWN, STATUS_UP, ErrorDB, health
from ...utils import snake_case as _snake

__all__ = ["DB", "SQLConfig", "new_sql", "new_sql_mocks", "QueryBuilder"]


@dataclass
class SQLConfig:
    dialect: str = "sqlite"
    host: str = ""
    port: int = 0
    user: str = ""
    password: str = ""
    database: str = ""
    max_open_conns: int = 8

    @staticmethod
    def from_config(cfg) -> "SQLConfig":
        dialect = (cfg.get("DB_DIALECT") or "sqlite").lower()
        default_port = {"mysql": 3306, "postgres": 5432}.get(dialect, 0)
        return SQLConfig(
            dialect=dialect,
            host=cfg.get("DB_HOST") or "",
            port=cfg.get_int("DB_PORT", default_port),
            user=cfg.get("DB_USER") or "",
            password=cfg.get("DB_PASSWORD") or "",
            database=cfg.get("DB_NAME") or "",
            max_open_conns=cfg.get_int("DB_MAX_OPEN_CONNS", 8),
        )

    def dsn(self) -> str:
        """Human-readable DSN (reference sql.go:128-148 shape) for logs."""
        if self.dialect == "sqlite":
            return self.database or ":memory:"
        return f"{self.user}@{self.host}:{self.port}/{self.database}"


class QueryBuilder:
    """Dialect-aware statement builder (query_builder.go:8-70). Placeholders
    match the PEP-249 paramstyle of the wired driver: sqlite '?' (qmark),
    pymysql and psycopg2 both '%s' (format) — the reference's Go drivers use
    '?'/'$n' (bind.go:24-38) but Python's don't, and the builder exists to
    hide exactly that."""

    def __init__(self, dialect: str):
        self.dialect = dialect

    def bindvar(self, i: int) -> str:
        return "?" if self.dialect == "sqlite" else "%s"

    def quote(self, ident: str) -> str:
        return f'"{ident}"' if self.dialect == "postgres" else f"`{ident}`" if self.dialect == "mysql" else f'"{ident}"'

    def insert(self, table: str, columns: list[str]) -> str:
        binds = ", ".join(self.bindvar(i + 1) for i in range(len(columns)))
        cols = ", ".join(columns)
        return f"INSERT INTO {table} ({cols}) VALUES ({binds})"

    def select_all(self, table: str) -> str:
        return f"SELECT * FROM {table}"

    def select_by(self, table: str, column: str) -> str:
        return f"SELECT * FROM {table} WHERE {column} = {self.bindvar(1)}"

    def update_by(self, table: str, columns: list[str], where: str) -> str:
        sets = ", ".join(
            f"{c} = {self.bindvar(i + 1)}" for i, c in enumerate(columns)
        )
        return f"UPDATE {table} SET {sets} WHERE {where} = {self.bindvar(len(columns) + 1)}"

    def delete_by(self, table: str, column: str) -> str:
        return f"DELETE FROM {table} WHERE {column} = {self.bindvar(1)}"


class Tx:
    """Transaction facade over one pooled connection (db.go:117-175)."""

    def __init__(self, db: "DB", conn):
        self._db = db
        self._conn = conn

    def query(self, q: str, *args) -> list[dict]:
        return self._db._query_on(self._conn, q, args)

    def exec(self, q: str, *args) -> int:
        return self._db._exec_on(self._conn, q, args)

    def commit(self) -> None:
        self._conn.commit()

    def rollback(self) -> None:
        self._conn.rollback()


class DB:
    """Instrumented SQL handle: every op gets a debug query-log and an
    app_sql_stats histogram sample (db.go:19-58)."""

    # monitor cadence (reference pushes stats + retries every 10 s,
    # sql.go:91,150); overridable for tests
    MONITOR_INTERVAL_S = 10.0

    def __init__(self, cfg: SQLConfig, logger=None, metrics=None):
        self.cfg = cfg
        self.logger = logger
        self.metrics = metrics
        self.builder = QueryBuilder(cfg.dialect)
        self._local = threading.local()
        self._conns: list = []
        self._lock = threading.Lock()
        self._closed = False
        self.connected = False
        self._connect_factory = self._make_factory()
        self._inuse = 0
        # eager ping as the reference does at construction — but like the
        # reference, a down database does NOT fail app startup; the monitor
        # loop keeps retrying in the background (sql.go:91-115)
        try:
            self._ping(self._conn())
            self.connected = True
        except Exception as e:  # noqa: BLE001
            if self.logger is not None:
                self.logger.error(f"could not connect to SQL ({cfg.dsn()}): {e}")
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="sql-monitor", daemon=True
        )
        self._monitor_wake = threading.Event()
        self._monitor.start()

    def _monitor_loop(self) -> None:
        """Background ping/reconnect + connection-stats gauge pusher
        (parity: sql.go:91-115 retry loop and sql.go:150-163 pushDBMetrics)."""
        while not self._closed:
            self._monitor_wake.wait(self.MONITOR_INTERVAL_S)
            self._monitor_wake.clear()
            if self._closed:
                return
            try:
                self._ping(self._conn())
                if not self.connected and self.logger is not None:
                    self.logger.info(f"connected to SQL ({self.cfg.dsn()})")
                self.connected = True
            except Exception as e:  # noqa: BLE001
                if self.connected and self.logger is not None:
                    self.logger.error(f"SQL connection lost ({self.cfg.dsn()}): {e}")
                self.connected = False
                self._drop_local_conn()
            if self.metrics is not None:
                with self._lock:
                    n = len(self._conns)
                self.metrics.set_gauge(
                    "app_sql_open_connections", float(n if self.connected else 0)
                )
                # in-use = statements executing right now (db.Stats().InUse
                # semantics), not pool size
                self.metrics.set_gauge(
                    "app_sql_inuse_connections", float(self._inuse)
                )

    def _ping(self, conn) -> None:
        """Dialect-aware liveness probe (PEP-249 connections have no
        .execute; only sqlite3's do)."""
        if self.cfg.dialect == "sqlite":
            conn.execute("SELECT 1")
        else:
            self._cursor_exec(conn, "SELECT 1", ())

    def _drop_local_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._local.conn = None
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass

    # -- connection management -------------------------------------------
    def _make_factory(self) -> Callable:
        d = self.cfg.dialect
        if d == "sqlite":
            import sqlite3

            path = self.cfg.database or ":memory:"
            if path == ":memory:":
                # One shared in-memory DB across this instance's threads —
                # unique URI per instance so two DBs never alias.
                import uuid

                uri = f"file:gofr_mem_{uuid.uuid4().hex}?mode=memory&cache=shared"
                master = sqlite3.connect(uri, uri=True, check_same_thread=False)
                self._master = master  # keeps the shared cache alive

                def factory():
                    return sqlite3.connect(uri, uri=True, check_same_thread=False)

                return factory

            def factory():
                return sqlite3.connect(path, check_same_thread=False)

            return factory
        if d == "mysql":
            try:
                import pymysql  # type: ignore
            except ImportError as e:
                raise ErrorDB(
                    "mysql driver (pymysql) not available in this environment"
                ) from e

            def factory():
                return pymysql.connect(
                    host=self.cfg.host, port=self.cfg.port, user=self.cfg.user,
                    password=self.cfg.password, database=self.cfg.database,
                )

            return factory
        if d == "postgres":
            try:
                import psycopg2  # type: ignore
            except ImportError as e:
                raise ErrorDB(
                    "postgres driver (psycopg2) not available in this environment"
                ) from e

            def factory():
                return psycopg2.connect(
                    host=self.cfg.host, port=self.cfg.port, user=self.cfg.user,
                    password=self.cfg.password, dbname=self.cfg.database,
                )

            return factory
        raise ErrorDB(f"unsupported DB_DIALECT {d!r} (sqlite|mysql|postgres)")

    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._connect_factory()
            self._local.conn = conn
            with self._lock:
                self._conns.append(conn)
        return conn

    # -- instrumented ops -------------------------------------------------
    def _observe(self, op: str, q: str, t0: float) -> None:
        dt = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.record_histogram(
                "app_sql_stats", dt, type=op, database=self.cfg.database or ":memory:"
            )
        if self.logger is not None:
            self.logger.debug(
                {"type": op, "query": q, "duration_us": round(dt * 1e6)}
            )

    def _query_on(self, conn, q: str, args: tuple) -> list[dict]:
        t0 = time.perf_counter()
        with self._lock:
            self._inuse += 1
        try:
            cur = conn.execute(q, args) if self.cfg.dialect == "sqlite" else self._cursor_exec(conn, q, args)
            cols = [d[0] for d in cur.description] if cur.description else []
            rows = [dict(zip(cols, r)) for r in cur.fetchall()]
            return rows
        except Exception as e:  # noqa: BLE001
            self._invalidate_if_dead(conn)
            raise ErrorDB(str(e), e) from e
        finally:
            with self._lock:
                self._inuse -= 1
            self._observe("query", q, t0)

    def _exec_on(self, conn, q: str, args: tuple) -> int:
        t0 = time.perf_counter()
        with self._lock:
            self._inuse += 1
        try:
            cur = conn.execute(q, args) if self.cfg.dialect == "sqlite" else self._cursor_exec(conn, q, args)
            return cur.rowcount
        except Exception as e:  # noqa: BLE001
            self._invalidate_if_dead(conn)
            raise ErrorDB(str(e), e) from e
        finally:
            with self._lock:
                self._inuse -= 1
            self._observe("exec", q, t0)

    def _invalidate_if_dead(self, conn) -> None:
        """After an op failure, probe the connection; drop it if the probe
        fails too, so the NEXT call transparently reconnects (the statement
        error itself still propagates to the caller). Roll back first:
        on postgres an ordinary statement error aborts the transaction and
        would fail the probe on a perfectly healthy connection."""
        try:
            if self.cfg.dialect != "sqlite":
                try:
                    conn.rollback()
                except Exception:  # noqa: BLE001
                    pass
            self._ping(conn)
        except Exception:  # noqa: BLE001
            self.connected = False
            self._drop_local_conn()

    @staticmethod
    def _cursor_exec(conn, q: str, args: tuple):
        cur = conn.cursor()
        cur.execute(q, args)
        return cur

    def query(self, q: str, *args) -> list[dict]:
        """Rows as dicts (the reference returns *sql.Rows; dicts are the
        Python-idiomatic equivalent of its reflection Scan)."""
        return self._query_on(self._conn(), q, args)

    def query_row(self, q: str, *args) -> dict | None:
        rows = self.query(q, *args)
        return rows[0] if rows else None

    def exec(self, q: str, *args) -> int:
        n = self._exec_on(self._conn(), q, args)
        self._conn().commit()
        return n

    def select(self, cls: type, q: str, *args) -> list:
        """ORM-lite (db.go:200-318): map rows onto cls instances by
        snake_case(field) == column. cls may be a dataclass or any class
        with annotated fields."""
        rows = self.query(q, *args)
        fields = getattr(cls, "__annotations__", {})
        col_for = {_snake(f): f for f in fields}
        out = []
        for row in rows:
            obj = cls.__new__(cls)
            for col, val in row.items():
                f = col_for.get(col.lower())
                if f is not None:
                    setattr(obj, f, val)
            out.append(obj)
        return out

    def begin(self) -> Tx:
        return Tx(self, self._conn())

    # -- health (health.go:27-65) ----------------------------------------
    def health_check(self) -> dict:
        try:
            t0 = time.perf_counter()
            self._conn().execute("SELECT 1")
            return health(
                STATUS_UP,
                dialect=self.cfg.dialect,
                host=self.cfg.dsn(),
                ping_ms=round((time.perf_counter() - t0) * 1e3, 3),
                open_connections=len(self._conns),
            )
        except Exception as e:  # noqa: BLE001
            return health(STATUS_DOWN, dialect=self.cfg.dialect, error=str(e))

    @property
    def dialect(self) -> str:
        return self.cfg.dialect

    def close(self) -> None:
        self._closed = True
        self._monitor_wake.set()
        # join before clearing the pool: a monitor tick racing past its
        # _closed check could otherwise open (and leak) a fresh connection
        if self._monitor.is_alive() and threading.current_thread() is not self._monitor:
            self._monitor.join(timeout=5)
        with self._lock:
            for c in self._conns:
                try:
                    c.close()
                except Exception:  # noqa: BLE001
                    pass
            self._conns.clear()


def new_sql(config, logger=None, metrics=None) -> DB | None:
    """Container wiring (container.go:100). Returns None when the config
    doesn't describe a database — mirroring the reference's nil datasource."""
    cfg = SQLConfig.from_config(config)
    if not cfg.database and cfg.dialect != "sqlite" and not cfg.host:
        return None
    if metrics is not None:
        from ...metrics import DATASOURCE_BUCKETS

        metrics.new_histogram("app_sql_stats", "sql op time s", DATASOURCE_BUCKETS)
    try:
        db = DB(cfg, logger, metrics)
    except ErrorDB as e:
        if logger is not None:
            logger.error(f"could not connect to SQL ({cfg.dsn()}): {e.message}")
        return None
    if logger is not None:
        logger.info(f"connected to '{cfg.database or ':memory:'}' database ({cfg.dialect})")
    return db


def new_sql_mocks(logger=None, metrics=None) -> DB:
    """Test seam (sql_mock.go:12-31 analogue): a real in-memory sqlite DB —
    stronger than a statement-recording mock, same spirit as miniredis."""
    return DB(SQLConfig(dialect="sqlite", database=""), logger, metrics)
