"""The port's SQL and Redis datasources, migrations, CRUD routes and their
three examples against the JAX package's (CPU). The cases of
tests/test_sql.py, tests/test_redis.py and tests/test_migration_crud.py,
each run through both packages on the same inputs (one sqlite schema, one
MiniRedis): equal rows, results, errors, error envelopes over HTTP and
metric series. The port's MiniRedis answers a command script byte for
byte as the JAX package's does. The examples http-server-using-redis,
using-migrations and using-add-rest-handlers (and http-server's Redis
route) are booted from both packages and give equal status codes and
bodies. The new modules import no torch."""

from __future__ import annotations

import asyncio
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from pathlib import Path

import pytest

import gofr_tpu
from gofr_tpu.config import new_mock_config as jax_mock_config
from gofr_tpu.datasource import ErrorDB as JErrorDB
from gofr_tpu.datasource import redis as jredis
from gofr_tpu.datasource import sql as jsql
from gofr_tpu.metrics import new_metrics_manager as jax_metrics
from gofr_tpu.migration import run as jax_run_migrations
from gofr_tpu.testutil import MiniRedis as JMiniRedis
from gofr_tpu.testutil import client_tls_context, self_signed_cert, server_tls_context
from gofr_tpu.utils import snake_case as jax_snake_case
from gofr_tpu_torch import app as papp_mod
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.datasource import ErrorDB
from gofr_tpu_torch.datasource import redis as predis
from gofr_tpu_torch.datasource import sql as psql
from gofr_tpu_torch.metrics import new_metrics_manager as port_metrics
from gofr_tpu_torch.migration import run as port_run_migrations
from gofr_tpu_torch.testutil import MiniRedis
from gofr_tpu_torch.utils import snake_case

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SQL = {"jax": jsql, "port": psql}
REDIS = {"jax": jredis, "port": predis}
ERRORDB = {"jax": JErrorDB, "port": ErrorDB}
METRICS = {"jax": jax_metrics, "port": port_metrics}
BASE = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR", "GOFR_HTTP_NATIVE": "0"}


def _both(fn):
    """fn(package name) for the JAX package, then the port: (jax, port)."""
    return fn("jax"), fn("port")


def _instruments(m) -> dict:
    """name -> (kind, label names seen) of every registered instrument."""
    out = {}
    for inst in list(m._instruments.values()):
        if hasattr(inst, "collect_histogram"):
            labels = {k for key, _v in inst.collect_histogram() for k, _x in key}
        else:
            labels = {k for _n, lab, _v in inst.collect() for k in lab}
        out[inst.name] = (inst.kind, tuple(sorted(labels)))
    return out


def _observations(m, name: str) -> dict:
    """A histogram's sample count by label set."""
    return {key: cnt for key, (_c, _s, cnt) in m.histogram(name).collect_histogram()}


# ---------------------------------------------------------------------------
# SQL
# ---------------------------------------------------------------------------

@pytest.fixture()
def dbs():
    """An in-memory sqlite DB from each package, with the same table."""
    out = {}
    for pkg in SQL:
        d = SQL[pkg].new_sql_mocks()
        d.exec("CREATE TABLE employee (id INTEGER PRIMARY KEY, name TEXT, dept TEXT)")
        out[pkg] = d
    yield out
    for d in out.values():
        d.close()


def test_snake_case_equals_jax():
    for name in ("Employee", "firstName", "HTTPServer", "userID", "A", "", "already_snake", "BookTitleV2"):
        assert snake_case(name) == jax_snake_case(name)


def test_exec_and_query(dbs):
    def run(pkg):
        db = dbs[pkg]
        n = db.exec("INSERT INTO employee (name, dept) VALUES (?, ?)", "ada", "eng")
        return (n, db.query("SELECT * FROM employee"), db.query_row("SELECT name FROM employee WHERE id = ?", 1),
                db.query_row("SELECT name FROM employee WHERE id = ?", 99))

    j, p = _both(run)
    assert p == j == (1, [{"id": 1, "name": "ada", "dept": "eng"}], {"name": "ada"}, None)


def test_select_maps_to_class(dbs):
    @dataclass
    class Employee:
        id: int = 0
        name: str = ""
        dept: str = ""

    def run(pkg):
        dbs[pkg].exec("INSERT INTO employee (name, dept) VALUES (?, ?)", "grace", "navy")
        return [vars(e) for e in dbs[pkg].select(Employee, "SELECT * FROM employee")]

    j, p = _both(run)
    assert p == j == [{"id": 1, "name": "grace", "dept": "navy"}]


def test_snake_case_mapping(dbs):
    class Person:
        firstName: str

    def run(pkg):
        dbs[pkg].exec("CREATE TABLE t (first_name TEXT)")
        dbs[pkg].exec("INSERT INTO t VALUES (?)", "x")
        return [vars(o) for o in dbs[pkg].select(Person, "SELECT * FROM t")]

    j, p = _both(run)
    assert p == j == [{"firstName": "x"}]


def test_transaction_commit_and_rollback(dbs):
    def run(pkg):
        db, seen = dbs[pkg], []
        tx = db.begin()
        tx.exec("INSERT INTO employee (name, dept) VALUES (?, ?)", "t1", "a")
        seen.append(tx.query("SELECT name FROM employee"))
        tx.commit()
        seen.append(len(db.query("SELECT * FROM employee")))
        tx = db.begin()
        tx.exec("INSERT INTO employee (name, dept) VALUES (?, ?)", "t2", "b")
        tx.rollback()
        seen.append(len(db.query("SELECT * FROM employee")))
        return seen

    j, p = _both(run)
    assert p == j == [[{"name": "t1"}], 1, 1]


def test_bad_sql_raises_errordb(dbs):
    def run(pkg):
        with pytest.raises(ERRORDB[pkg]) as ei:
            dbs[pkg].query("SELECT * FROM nope")
        return ei.value.status_code(), ei.value.message, type(ei.value.cause).__name__

    j, p = _both(run)
    assert p == j and p[0] == 500 and "no such table" in p[1]


def test_threads_share_database(dbs):
    def run(pkg):
        dbs[pkg].exec("INSERT INTO employee (name, dept) VALUES (?, ?)", "main", "x")
        seen = []
        t = threading.Thread(target=lambda: seen.append(dbs[pkg].query("SELECT name FROM employee")))
        t.start()
        t.join()
        return seen

    j, p = _both(run)
    assert p == j == [[{"name": "main"}]]


def test_two_instances_isolated():
    def run(pkg):
        a, b = SQL[pkg].new_sql_mocks(), SQL[pkg].new_sql_mocks()
        try:
            a.exec("CREATE TABLE t (x INTEGER)")
            with pytest.raises(ERRORDB[pkg]) as ei:
                b.query("SELECT * FROM t")
            return ei.value.message
        finally:
            a.close()
            b.close()

    j, p = _both(run)
    assert p == j == "no such table: t"


def test_health(dbs):
    j, p = _both(lambda pkg: dbs[pkg].health_check())
    assert p["status"] == j["status"] == "UP"
    assert set(p["details"]) == set(j["details"]) and p["details"]["dialect"] == "sqlite"
    for key in ("dialect", "host", "open_connections"):
        assert p["details"][key] == j["details"][key]


@pytest.mark.parametrize("dialect,module", [("mysql", "pymysql"), ("postgres", "psycopg2"), ("oracle", None)])
def test_missing_db_library_or_dialect_raises_cleanly(dialect, module):
    """No pymysql or psycopg2 here (nor where the port runs on the card):
    construction raises ErrorDB naming the module, never an ImportError
    mid-request; an unknown dialect names the supported ones."""
    if module is not None:
        assert importlib.util.find_spec(module) is None

    def run(pkg):
        cfg = SQL[pkg].SQLConfig(dialect=dialect, host="127.0.0.1", port=1, database="x")
        with pytest.raises(ERRORDB[pkg]) as ei:
            SQL[pkg].DB(cfg)
        return str(ei.value)

    j, p = _both(run)
    assert p == j and (module or "sqlite|mysql|postgres") in p


class _Log:
    """A logger that keeps its lines: (level, message)."""

    def __init__(self):
        self.lines = []

    def __getattr__(self, level):
        return lambda msg, *a, **kw: self.lines.append((level, msg))


def test_new_sql_without_its_library_is_none_and_logged():
    """new_sql logs the failed connection and leaves no datasource, as the
    JAX package does (the app still starts)."""
    def run(pkg):
        log = _Log()
        cfg = (jax_mock_config if pkg == "jax" else new_mock_config)({"DB_DIALECT": "mysql", "DB_HOST": "h"})
        return SQL[pkg].new_sql(cfg, log), log.lines

    j, p = _both(run)
    assert p == j and p[0] is None and p[1][0][0] == "error" and "pymysql" in p[1][0][1]


def test_dead_connection_dropped_then_recovers(tmp_path):
    def run(pkg):
        d = SQL[pkg].DB(SQL[pkg].SQLConfig(dialect="sqlite", database=str(tmp_path / f"{pkg}.db")))
        try:
            d.exec("CREATE TABLE t (v INTEGER)")
            d.exec("INSERT INTO t (v) VALUES (?)", 1)
            d._conn().close()  # a killed server: the live connection closes under the handle
            with pytest.raises(ERRORDB[pkg]) as ei:
                d.query("SELECT v FROM t")
            return ei.value.message, d.query("SELECT v FROM t")  # the failed op dropped it: the next reconnects
        finally:
            d.close()

    j, p = _both(run)
    assert p == j and p[1] == [{"v": 1}]


def test_monitor_pushes_gauges_and_reconnects(tmp_path):
    def run(pkg):
        metrics = METRICS[pkg]()
        metrics.new_gauge("app_sql_open_connections", "t")
        metrics.new_gauge("app_sql_inuse_connections", "t")
        d = SQL[pkg].DB(SQL[pkg].SQLConfig(dialect="sqlite", database=str(tmp_path / f"m{pkg}.db")), metrics=metrics)
        d.MONITOR_INTERVAL_S = 0.01
        try:
            d._monitor_wake.set()
            deadline = time.time() + 5
            while time.time() < deadline and not any(
                    ln.startswith("app_sql_open_connections ") for ln in metrics.render_prometheus().splitlines()):
                time.sleep(0.02)
            text = metrics.render_prometheus()
            return d.connected, sorted(ln for ln in text.splitlines() if ln.startswith("app_sql_"))
        finally:
            d.close()

    j, p = _both(run)
    # the caller's connection and the monitor thread's own
    assert p == j and p[0] and p[1] == ["app_sql_inuse_connections 0", "app_sql_open_connections 2"]


@pytest.mark.parametrize("dialect", ["sqlite", "postgres", "mysql"])
def test_query_builder_equals_jax(dialect):
    def run(pkg):
        qb = SQL[pkg].QueryBuilder(dialect)
        return (qb.bindvar(1), qb.quote("c"), qb.insert("t", ["a", "b"]), qb.select_all("t"), qb.select_by("t", "id"),
                qb.update_by("t", ["a", "b"], "id"), qb.delete_by("t", "id"))

    j, p = _both(run)
    assert p == j
    if dialect == "sqlite":
        assert p[2] == "INSERT INTO t (a, b) VALUES (?, ?)" and p[5] == "UPDATE t SET a = ?, b = ? WHERE id = ?"
    else:  # psycopg2 and pymysql both take the '%s' (format) paramstyle
        assert p[2] == "INSERT INTO t (a, b) VALUES (%s, %s)" and p[5] == "UPDATE t SET a = %s, b = %s WHERE id = %s"


def test_config_and_dsn_equal_jax():
    env = {"DB_DIALECT": "Postgres", "DB_HOST": "db", "DB_USER": "u", "DB_PASSWORD": "p", "DB_NAME": "n",
           "DB_MAX_OPEN_CONNS": "3"}
    j = jsql.SQLConfig.from_config(jax_mock_config(env))
    p = psql.SQLConfig.from_config(new_mock_config(env))
    assert vars(p) == vars(j) and p.port == 5432 and p.dsn() == j.dsn() == "u@db:5432/n"
    assert psql.SQLConfig().dsn() == jsql.SQLConfig().dsn() == ":memory:"


def test_new_sql_from_config_and_metrics():
    def run(pkg):
        m = METRICS[pkg]()
        cfg = (jax_mock_config if pkg == "jax" else new_mock_config)({"DB_DIALECT": "sqlite", "DB_NAME": ""})
        db = SQL[pkg].new_sql(cfg, metrics=m)
        try:
            db.exec("CREATE TABLE t (x INTEGER)")
            db.query("SELECT * FROM t")
            return db.dialect, _instruments(m), _observations(m, "app_sql_stats")
        finally:
            db.close()

    j, p = _both(run)
    assert p == j and p[0] == "sqlite" and sum(p[2].values()) >= 2
    assert p[1]["app_sql_stats"] == ("histogram", ("database", "type"))


# ---------------------------------------------------------------------------
# Redis: both clients against one MiniRedis (the port's)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server():
    s = MiniRedis().start()
    yield s
    s.stop()


@pytest.fixture()
def clients(server):
    cs = {pkg: REDIS[pkg].Redis("127.0.0.1", server.port) for pkg in REDIS}
    yield cs
    for c in cs.values():
        asyncio.run(c.flushdb())
        c.close()


def _flow(clients, make):
    """Run ``make(client)``'s coroutine on each client in turn, flushing
    between: (jax result, port result)."""
    out = []
    for pkg in ("jax", "port"):
        out.append(asyncio.run(make(clients[pkg])))
        asyncio.run(clients[pkg].flushdb())
    return tuple(out)


def test_set_get_delete(clients):
    async def flow(c):
        return [await c.set("k", "v"), await c.get("k"), await c.exists("k"), await c.delete("k"), await c.get("k")]

    j, p = _flow(clients, flow)
    assert p == j == ["OK", b"v", 1, 1, None]


def test_expiry(clients):
    async def flow(c):
        await c.set("e", "x", ex=100)
        return [0 < await c.ttl("e") <= 100, await c.ttl("missing"), await c.expire("e", 5), await c.ttl("e"),
                await c.expire("missing", 5)]

    j, p = _flow(clients, flow)
    assert p == j == [True, -2, 1, 5, 0]


def test_incr(clients):
    async def flow(c):
        return [await c.incr("n"), await c.incr("n"), await c.get("n")]

    j, p = _flow(clients, flow)
    assert p == j == [1, 2, b"2"]


def test_hash_ops(clients):
    async def flow(c):
        return [await c.hset("h", "a", "1"), await c.hset("h", "b", "2"), await c.hset("h", "a", "3"),
                await c.hget("h", "a"), await c.hgetall("h"), await c.hget("nope", "a")]

    j, p = _flow(clients, flow)
    assert p == j == [1, 1, 0, b"3", {b"a": b"3", b"b": b"2"}, None]


def test_list_ops(clients):
    async def flow(c):
        return [await c.lpush("l", "x", "y"), await c.rpop("l"), await c.rpop("l"), await c.rpop("l")]

    j, p = _flow(clients, flow)
    assert p == j == [2, b"x", b"y", None]  # LPUSH prepends: y, x


def test_keys_pattern(clients):
    async def flow(c):
        for k, v in (("user:1", "a"), ("user:2", "b"), ("other", "c")):
            await c.set(k, v)
        return sorted(await c.keys("user:*")), await c.ping()

    j, p = _flow(clients, flow)
    assert p == j == ([b"user:1", b"user:2"], "PONG")


def test_server_error_raises_resperror(clients):
    def run(pkg):
        with pytest.raises(REDIS[pkg].RESPError) as ei:
            asyncio.run(clients[pkg].execute("NOPE"))
        return str(ei.value)

    j, p = _both(run)
    assert p == j == "ERR unknown command 'NOPE'"


def test_health(clients):
    j, p = _flow(clients, lambda c: c.health())
    assert p["status"] == j["status"] == "UP"
    assert p["details"]["stats"] == j["details"]["stats"] and set(p["details"]) == set(j["details"])


def test_health_down_when_unreachable():
    j, p = _both(lambda pkg: asyncio.run(REDIS[pkg].Redis("127.0.0.1", 1).health()))
    assert p["status"] == j["status"] == "DOWN" and p["details"]["host"] == j["details"]["host"] == "127.0.0.1:1"


def test_health_check_sync_facade(clients):
    j, p = _both(lambda pkg: clients[pkg].health_check())
    assert p["status"] == j["status"] == "UP"


def test_reconnects_after_connection_loss(clients):
    async def flow(c):
        await c.set("a", "1")
        state = c._conn_state()
        state.writer.close()  # a dropped connection
        await state.writer.wait_closed()
        return await c.get("a")  # reconnected transparently

    j, p = _flow(clients, flow)
    assert p == j == b"1"


def test_execute_sync(clients):
    j, p = _both(lambda pkg: (clients[pkg].execute_sync("SET", "sk", pkg), clients[pkg].execute_sync("GET", "sk")))
    assert j == ("OK", b"jax") and p == ("OK", b"port")


def test_new_client_wiring_and_metrics(server):
    assert predis.new_client(new_mock_config({})) is None and jredis.new_client(jax_mock_config({})) is None

    def run(pkg):
        m = METRICS[pkg]()
        cfg = (jax_mock_config if pkg == "jax" else new_mock_config)(
            {"REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(server.port), "REDIS_DB": "2"})
        c = REDIS[pkg].new_client(cfg, metrics=m)
        try:
            asyncio.run(c.set("k", "v"))
            asyncio.run(c.get("k"))
            return (c.host, c.port, c.db), _instruments(m), _observations(m, "app_redis_stats")
        finally:
            asyncio.run(c.flushdb())
            c.close()

    j, p = _both(run)
    assert p == j and p[0][2] == 2
    assert p[2] == {(("type", "get"),): 1, (("type", "set"),): 1}  # the handshake's SELECT is not a command


@pytest.fixture(scope="module")
def auth_server():
    s = MiniRedis(password="sekret").start()
    yield s
    s.stop()


def test_auth_password_only(auth_server):
    def run(pkg):
        c = REDIS[pkg].Redis("127.0.0.1", auth_server.port, password="sekret")
        try:
            return asyncio.run(c.set("k", pkg)), asyncio.run(c.get("k"))
        finally:
            c.close()

    assert _both(run) == (("OK", b"jax"), ("OK", b"port"))


def test_auth_with_username():
    s = MiniRedis(password="pw2", username="svc").start()
    try:
        def run(pkg):
            c = REDIS[pkg].Redis("127.0.0.1", s.port, username="svc", password="pw2")
            try:
                return asyncio.run(c.ping())
            finally:
                c.close()

        assert _both(run) == ("PONG", "PONG")
    finally:
        s.stop()


@pytest.mark.parametrize("password,match", [("nope", "WRONGPASS"), (None, "NOAUTH")])
def test_bad_or_missing_password_rejected(auth_server, password, match):
    def run(pkg):
        c = REDIS[pkg].Redis("127.0.0.1", auth_server.port, password=password)
        try:
            with pytest.raises(REDIS[pkg].RESPError, match=match) as ei:
                asyncio.run(c.ping())
            return str(ei.value)
        finally:
            c.close()

    j, p = _both(run)
    assert p == j


def test_failed_auth_not_cached(auth_server):
    """A connection whose AUTH failed is torn down: fixing the credential
    redoes the whole handshake."""
    def run(pkg):
        c = REDIS[pkg].Redis("127.0.0.1", auth_server.port, password="nope")
        try:
            with pytest.raises(REDIS[pkg].RESPError):
                asyncio.run(c.ping())
            c.password = "sekret"
            return asyncio.run(c.ping())
        finally:
            c.close()

    assert _both(run) == ("PONG", "PONG")


def test_tls_handshake_and_commands():
    s = MiniRedis(tls=server_tls_context()).start()
    try:
        def run(pkg):
            c = REDIS[pkg].Redis("127.0.0.1", s.port, tls=client_tls_context())
            try:
                return asyncio.run(c.set("tk", "tv")), asyncio.run(c.get("tk"))
            finally:
                c.close()

        assert _both(run) == (("OK", b"tv"), ("OK", b"tv"))
    finally:
        s.stop()


def test_tls_client_rejects_untrusted_cert():
    import ssl

    s = MiniRedis(tls=server_tls_context()).start()
    try:
        def run(pkg):
            c = REDIS[pkg].Redis("127.0.0.1", s.port, tls=True)  # the default trust store lacks the test CA
            try:
                with pytest.raises((ssl.SSLError, ConnectionError, OSError)) as ei:
                    asyncio.run(c.ping())
                return type(ei.value).__name__
            finally:
                c.close()

        j, p = _both(run)
        assert p == j
    finally:
        s.stop()


def test_tls_with_auth_and_config(tmp_path):
    """TLS and a password together, read from the config's REDIS_* keys
    (tls_from_config) as in the JAX package."""
    cert, _ = self_signed_cert()
    s = MiniRedis(password="envpw", tls=server_tls_context()).start()
    try:
        env = {"REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(s.port), "REDIS_PASSWORD": "envpw", "REDIS_TLS": "true",
               "REDIS_TLS_CA_CERT": cert}

        def run(pkg):
            c = REDIS[pkg].new_client((jax_mock_config if pkg == "jax" else new_mock_config)(env))
            try:
                return asyncio.run(c.ping()), c.password, c.tls.verify_mode, c.tls.check_hostname
            finally:
                c.close()

        j, p = _both(run)
        assert p == j and p[:2] == ("PONG", "envpw")
    finally:
        s.stop()


def test_tls_from_config_equals_jax():
    from gofr_tpu.datasource import tls_from_config as jax_tls
    from gofr_tpu_torch.datasource import tls_from_config

    for env in ({}, {"X_TLS": "false"}, {"X_TLS": "yes"}, {"X_TLS": "1", "X_TLS_INSECURE": "true"}):
        j, p = jax_tls(jax_mock_config(env), "X"), tls_from_config(new_mock_config(env), "X")
        assert (j is None) == (p is None)
        if p is not None:
            assert (p.verify_mode, p.check_hostname) == (j.verify_mode, j.check_hostname)


def _resp(port: int, script: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(script)
        s.shutdown(socket.SHUT_WR)
        out = b""
        while chunk := s.recv(65536):
            out += chunk
        return out


def test_miniredis_answers_as_jax_does():
    """A script of every command MiniRedis knows, sent raw to both
    packages' servers: the same bytes back."""
    cmds = [("PING",), ("SET", "a", "1"), ("GET", "a"), ("GET", "b"), ("SET", "e", "x", "EX", "100"), ("TTL", "e"),
            ("TTL", "a"), ("TTL", "none"), ("EXISTS", "a", "b", "e"), ("INCR", "n"), ("INCR", "n"), ("EXPIRE", "n", "9"),
            ("EXPIRE", "zz", "9"), ("HSET", "h", "f", "v"), ("HSET", "h", "f", "w"), ("HGET", "h", "f"),
            ("HGETALL", "h"), ("LPUSH", "l", "x", "y"), ("RPOP", "l"), ("KEYS", "*"), ("DEL", "a", "zz"),
            ("SELECT", "1"), ("INFO", "stats"), ("NOPE",), ("FLUSHDB",), ("KEYS", "*")]
    script = b"".join(predis._encode(c) for c in cmds)
    servers = [JMiniRedis().start(), MiniRedis().start()]
    try:
        j, p = (_resp(s.port, script) for s in servers)
    finally:
        for s in servers:
            s.stop()
    assert p == j and p.count(b"\r\n") > len(cmds)


# ---------------------------------------------------------------------------
# migrations
# ---------------------------------------------------------------------------

def _apps(extra=None):
    """A JAX App and a port App on the same config (sqlite in memory)."""
    cfg = {**BASE, "APP_NAME": "crud-test", "DB_DIALECT": "sqlite", **(extra or {})}
    return gofr_tpu.new(config=jax_mock_config(cfg)), papp_mod.new(config=new_mock_config(cfg))


def _close(*apps):
    for a in apps:
        a.container.close()


def test_migrations_run_in_order_and_record():
    def migs(order):
        return {20240102: lambda ds: (order.append(2), ds.sql.exec("CREATE TABLE b (x INT)"))[-1],
                20240101: lambda ds: (order.append(1), ds.sql.exec("CREATE TABLE a (x INT)"))[-1]}

    apps, out = _apps(), []
    try:
        for app in apps:
            order = []
            app.migrate(migs(order))
            rows = app.container.sql.query("SELECT version, method FROM gofr_migrations ORDER BY version")
            out.append((order, rows))
    finally:
        _close(*apps)
    assert out[1] == out[0] == ([1, 2], [{"version": 20240101, "method": "UP"}, {"version": 20240102, "method": "UP"}])


def test_migrations_rerun_skips_applied(capsys):
    apps, out = _apps({"LOG_LEVEL": "INFO"}), []
    try:
        capsys.readouterr()
        for app in apps:
            count = {"n": 0}

            def up(ds, count=count):
                count["n"] += 1
                ds.sql.exec("CREATE TABLE IF NOT EXISTS t (x INT)")

            app.migrate({1: up})
            app.migrate({1: up, 2: up})
            lines = [json.loads(ln)["message"] for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
            out.append((count["n"], [ln.split(" (")[0] for ln in lines if "migration" in ln]))
    finally:
        _close(*apps)
    assert out[1] == out[0] and out[1][0] == 2
    assert out[1][1] == ["migration 1 ran successfully", "migration 2 ran successfully"]


def test_migration_failure_rolls_back_and_raises():
    def bad(ds):
        ds.sql.exec("CREATE TABLE good (x INT)")
        raise RuntimeError("boom")

    apps, out = _apps(), []
    try:
        for app in apps:
            with pytest.raises(RuntimeError, match="boom"):
                app.migrate({5: bad})
            out.append(app.container.sql.query("SELECT * FROM gofr_migrations"))
    finally:
        _close(*apps)
    assert out == [[], []]


def test_migration_needs_a_datasource():
    cfg = {**BASE, "APP_NAME": "x"}
    apps, out = (gofr_tpu.new(config=jax_mock_config(cfg)), papp_mod.new(config=new_mock_config(cfg))), []
    try:
        for app in apps:
            with pytest.raises(Exception, match="datasource") as ei:
                app.migrate({1: lambda ds: None})
            out.append((type(ei.value).__name__, str(ei.value)))
    finally:
        _close(*apps)
    assert out[1] == out[0]


def test_invalid_migration_rejected():
    apps, out = _apps(), []
    try:
        for app, run in zip(apps, (jax_run_migrations, port_run_migrations)):
            with pytest.raises(ValueError, match="UP") as ei:
                run({1: {"down": lambda ds: None}}, app.container)
            out.append(str(ei.value))
    finally:
        _close(*apps)
    assert out[1] == out[0]


def test_migrations_over_redis_and_sql(server):
    """Both stores record the version; the last applied one is the larger
    of the two; a Redis-only app records in the hash alone."""
    out = []
    for pkg in ("jax", "port"):
        asyncio.run(REDIS[pkg].Redis("127.0.0.1", server.port).flushdb())
        apps = _apps({"REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(server.port)})
        app = apps[0] if pkg == "jax" else apps[1]
        _close(apps[1] if pkg == "jax" else apps[0])
        try:
            seen = []
            app.migrate({3: lambda ds: seen.append((ds.sql is not None, ds.redis is not None,
                                                    ds.redis_call(ds.redis.set("m3", "x"))))})
            app.migrate({2: lambda ds: seen.append("never"), 3: lambda ds: seen.append("never"),
                         4: lambda ds: seen.append(4)})
            rec = app.container.redis.execute_sync("HGETALL", "gofr_migrations")
            hashed = sorted((k, {kk: vv for kk, vv in json.loads(v).items() if kk in ("version", "method")})
                            for k, v in zip(rec[::2], rec[1::2]))
            sql_rows = app.container.sql.query("SELECT version FROM gofr_migrations ORDER BY version")
            out.append((seen, hashed, sql_rows))
        finally:
            asyncio.run(app.container.redis.flushdb())
            _close(app)
    assert out[1] == out[0]
    assert out[1][0] == [(True, True, "OK"), 4] and [v["version"] for _k, v in out[1][1]] == [3, 4]


# ---------------------------------------------------------------------------
# CRUD: one entity served by both Apps
# ---------------------------------------------------------------------------

@dataclass
class Book:
    id: int = 0
    title: str = ""
    author: str = ""


def _call(app, method, path, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{app.http_server.port}{path}", method=method, data=data,
                                 headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def crud_apps():
    apps = _apps()
    for app in apps:
        app.container.sql.exec("CREATE TABLE book (id INTEGER PRIMARY KEY, title TEXT, author TEXT)")
        app.add_rest_handlers(Book)

        def bad_sql(ctx):
            return ctx.sql.query("SELECT * FROM nope")

        app.get("/bad-sql", bad_sql)
    threads = [a.run_in_background() for a in apps]
    yield apps
    for a, th in zip(apps, threads):
        a.shutdown()
        th.join(timeout=10)


def _same(apps, method, path, payload=None):
    j, p = (_call(a, method, path, payload) for a in apps)
    assert p == j, (method, path)
    return p[0], json.loads(p[1] or b"null")


def test_crud_create_and_get(crud_apps):
    assert _same(crud_apps, "POST", "/book", {"id": 1, "title": "SICP", "author": "abelson"})[0] == 201
    status, body = _same(crud_apps, "GET", "/book/1")
    assert status == 200 and body["data"] == {"id": 1, "title": "SICP", "author": "abelson"}


def test_crud_get_all(crud_apps):
    _same(crud_apps, "POST", "/book", {"id": 2, "title": "TAPL", "author": "pierce"})
    status, body = _same(crud_apps, "GET", "/book")
    assert status == 200 and len(body["data"]) >= 2


def test_crud_update(crud_apps):
    _same(crud_apps, "POST", "/book", {"id": 3, "title": "SICP", "author": "abelson"})
    status, body = _same(crud_apps, "PUT", "/book/3", {"title": "SICP 2e"})
    assert status == 200 and body["data"] == "Book successfully updated with id: 3"
    assert _same(crud_apps, "GET", "/book/3")[1]["data"]["title"] == "SICP 2e"
    assert _same(crud_apps, "PUT", "/book/3", {"nothing": 1})[0] == 400  # no updatable field


def test_crud_delete(crud_apps):
    _same(crud_apps, "POST", "/book", {"id": 9, "title": "tmp", "author": "x"})
    assert _same(crud_apps, "DELETE", "/book/9")[0] == 204
    assert _same(crud_apps, "GET", "/book/9")[0] == 404


def test_crud_missing_id_404(crud_apps):
    for method, payload in (("GET", None), ("PUT", {"title": "x"}), ("DELETE", None)):
        status, body = _same(crud_apps, method, "/book/777", payload)
        assert status == 404 and body == {"error": {"message": "No entity found with id: 777"}}


def test_datasource_error_envelope(crud_apps):
    status, body = _same(crud_apps, "GET", "/bad-sql")
    assert status == 500 and "error" in body


def test_crud_overrides():
    class Tome:
        isbn: str = ""
        title: str = ""

        @staticmethod
        def table_name():
            return "tomes"

        @staticmethod
        def rest_path():
            return "library"

        @staticmethod
        def get(ctx):
            return {"custom": True, "isbn": ctx.path_param("id")}

    apps = _apps()
    for app in apps:
        app.container.sql.exec("CREATE TABLE tomes (isbn TEXT PRIMARY KEY, title TEXT)")
        app.add_rest_handlers(Tome)
    threads = [a.run_in_background() for a in apps]
    try:
        assert _same(apps, "GET", "/library/abc") == (200, {"data": {"custom": True, "isbn": "abc"}})
        assert _same(apps, "POST", "/library", {"isbn": "x1", "title": "t"})[0] == 201
        assert _same(apps, "GET", "/library") == (200, {"data": [{"isbn": "x1", "title": "t"}]})
    finally:
        for a, th in zip(apps, threads):
            a.shutdown()
            th.join(timeout=10)


def test_app_health_and_metrics_show_both_datasources(server):
    """/.well-known/health reports sql and redis UP; the metrics server's
    exposition carries app_sql_stats and app_redis_stats once used; the
    container registers the JAX container's datasource series."""
    extra = {"REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(server.port)}
    apps = _apps(extra)
    for app in apps:
        async def touch(ctx):
            await ctx.redis.set("touched", "1")
            return ctx.sql.query("SELECT 1 AS one")

        app.get("/touch", touch)
    threads = [a.run_in_background() for a in apps]
    try:
        assert _same(apps, "GET", "/touch") == (200, {"data": [{"one": 1}]})
        healths, series = [], []
        for app in apps:
            status, body = _call(app, "GET", "/.well-known/health")
            data = json.loads(body)["data"]
            healths.append((status, data["sql"]["status"], data["redis"]["status"], sorted(data["sql"]["details"])))
            with urllib.request.urlopen(f"http://127.0.0.1:{app.metrics_server.port}/metrics", timeout=10) as r:
                text = r.read().decode()
            series.append(sorted({ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
                                  if ln.startswith(("app_sql", "app_redis"))}))
        assert healths[1] == healths[0] and healths[1][:3] == (200, "UP", "UP")
        assert series[1] == series[0] and "app_sql_stats_count" in series[1] and "app_redis_stats_count" in series[1]
        jnames, pnames = (set(_instruments(a.container.metrics)) for a in apps)
        want = {"app_redis_stats", "app_sql_stats", "app_sql_open_connections", "app_sql_inuse_connections"}
        assert want <= pnames and want <= jnames
    finally:
        for a, th in zip(apps, threads):
            asyncio.run(a.container.redis.flushdb())
            a.shutdown()
            th.join(timeout=10)


# ---------------------------------------------------------------------------
# the examples, from both packages
# ---------------------------------------------------------------------------

def _load_jax(example: str):
    spec = importlib.util.spec_from_file_location(f"torch_ds_example_{example.replace('-', '_')}",
                                                  EXAMPLES / example / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_pair(name: str, monkeypatch, tmp_path, env: dict, db: bool = False):
    """Both packages' app of one example, serving, built from the process
    environment over the example's own config; a sqlite file each."""
    monkeypatch.chdir(EXAMPLES / name)
    for k, v in {**BASE, **env}.items():
        monkeypatch.setenv(k, v)
    apps = []
    for pkg in ("jax", "port"):
        if db:
            monkeypatch.setenv("DB_NAME", str(tmp_path / f"{pkg}.db"))
        mod = _load_jax(name) if pkg == "jax" else importlib.import_module(
            f"gofr_tpu_torch.examples.{name.replace('-', '_')}")
        apps.append(mod.build_app())
    threads = [a.run_in_background() for a in apps]
    return apps, threads


def _stop(apps, threads):
    for a, th in zip(apps, threads):
        a.shutdown()
        th.join(timeout=10)


def _framework_routes(apps):
    for path in ("/.well-known/alive", "/favicon.ico", "/definitely-not-a-route"):
        j, p = (_call(a, "GET", path) for a in apps)
        assert p == j and p[0] in (200, 404)


def test_example_using_migrations(monkeypatch, tmp_path):
    apps, threads = _example_pair("using-migrations", monkeypatch, tmp_path, {}, db=True)
    try:
        status, body = _same(apps, "GET", "/employee?name=Umang")
        assert status == 200 and body["data"] == {"id": 1, "name": "Umang", "gender": "M",
                                                  "contact_number": "0987654321", "dob": None}
        emp = {"id": 2, "name": "Ada", "gender": "F", "contact_number": "123", "dob": "1815-12-10"}
        assert _same(apps, "POST", "/employee", emp) == (201, {"data": "successfully posted entity"})
        assert _same(apps, "GET", "/employee?name=Ada") == (200, {"data": emp})
        assert _same(apps, "GET", "/employee")[0] == 400
        assert _same(apps, "GET", "/employee?name=Nobody")[0] == 404
        _framework_routes(apps)
        for app in apps:  # a second start finds the migration recorded and runs nothing
            app.migrate({1708322067: lambda ds: pytest.fail("ran twice")})
    finally:
        _stop(apps, threads)


def test_example_using_add_rest_handlers(monkeypatch, tmp_path):
    apps, threads = _example_pair("using-add-rest-handlers", monkeypatch, tmp_path, {}, db=True)
    try:
        assert _same(apps, "GET", "/user") == (200, {"data": "user GetAll called"})
        user = {"id": 1, "name": "ada", "age": 36, "is_employed": True}
        assert _same(apps, "POST", "/user", user) == (201, {"data": "User successfully created with id: 1"})
        assert _same(apps, "GET", "/user/1") == (200, {"data": {**user, "is_employed": 1}})
        assert _same(apps, "PUT", "/user/1", {"age": 37})[0] == 200
        assert _same(apps, "DELETE", "/user/1")[0] == 204
        assert _same(apps, "GET", "/user/1")[0] == 404
        _framework_routes(apps)
    finally:
        _stop(apps, threads)


def test_example_http_server_using_redis(monkeypatch, tmp_path, server):
    apps, threads = _example_pair("http-server-using-redis", monkeypatch, tmp_path,
                                  {"REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(server.port)})
    try:
        out = []
        for app in apps:
            seq = [_call(app, "POST", "/redis", {"greeting": "hello"}), _call(app, "GET", "/redis/greeting"),
                   _call(app, "GET", "/redis/absent-key"), _call(app, "GET", "/redis-pipeline"),
                   _call(app, "POST", "/redis", ["not", "a", "dict"])]
            out.append(seq)
            app.container.redis.execute_sync("FLUSHDB")
        assert out[1] == out[0]
        assert [s for s, _ in out[1]] == [201, 200, 404, 200, 400]
        assert json.loads(out[1][1][1])["data"] == {"greeting": "hello"}
        assert json.loads(out[1][3][1])["data"]["values"] == ["one", "two"]
        status, body = _call(apps[1], "GET", "/.well-known/health")
        assert status == 200 and json.loads(body)["data"]["redis"]["status"] == "UP"
        _framework_routes(apps)
    finally:
        _stop(apps, threads)


def test_example_http_server_redis_route(monkeypatch, tmp_path, server):
    apps, threads = _example_pair("http-server", monkeypatch, tmp_path,
                                  {"REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(server.port)})
    try:
        assert _same(apps, "GET", "/redis")[0] == 404
        apps[1].container.redis.execute_sync("SET", "test", "value")
        j, p = (_call(a, "GET", "/redis") for a in apps)
        assert p == j and p[0] == 200
        apps[1].container.redis.execute_sync("FLUSHDB")
    finally:
        _stop(apps, threads)


def test_new_modules_import_no_torch():
    """ROADMAP queue 3 item 39: the codec, the native server, the
    datasources, migrations, CRUD, MiniRedis, the App, the broker clients,
    SCRAM, the fake brokers, the broker examples, the Mongo datasource, its
    fake server, the mock container and the secure_server example load no
    torch in a fresh process."""
    code = ("import sys, gofr_tpu_torch.native, gofr_tpu_torch.http.nativeserver, gofr_tpu_torch.datasource.sql, "
            "gofr_tpu_torch.datasource.redis, gofr_tpu_torch.migration, gofr_tpu_torch.crud, "
            "gofr_tpu_torch.testutil, gofr_tpu_torch.utils, gofr_tpu_torch.app, gofr_tpu_torch.datasource.scram, "
            "gofr_tpu_torch.datasource.pubsub.kafkaproto, gofr_tpu_torch.datasource.pubsub.kafka, "
            "gofr_tpu_torch.datasource.pubsub.mqttproto, gofr_tpu_torch.datasource.pubsub.mqtt, "
            "gofr_tpu_torch.datasource.pubsub.google, gofr_tpu_torch.datasource.pubsub.googleauth, "
            "gofr_tpu_torch.testutil.fakekafka, gofr_tpu_torch.testutil.fakemqtt, "
            "gofr_tpu_torch.testutil.fakegooglepubsub, gofr_tpu_torch.datasource.mongo, "
            "gofr_tpu_torch.datasource.mongo.mongoproto, gofr_tpu_torch.datasource.mongo.wire, "
            "gofr_tpu_torch.testutil.fakemongo, gofr_tpu_torch.container_mock; "
            "from gofr_tpu_torch.examples import using_migrations, using_add_rest_handlers, "
            "http_server_using_redis, using_publisher, using_subscriber, kafka_batch_inference, grpc_server, "
            "secure_server; "
            "print(sorted(m for m in ('torch', 'jax', 'gofr_tpu') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=60,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
