"""gofr_tpu_torch's mock container (container_mock.py: ``new_mock_container``,
``Mocks``, ``MockGPU``) and its top-level exports, against the JAX package.

- Every case of tests/test_mock_container.py on both packages'
  ``new_mock_container``: real sqlite, the RESP client against MiniRedis,
  MEMORY and KAFKA pub/sub, the in-memory Mongo store, the runtime double's
  canned results, health, the context manager.
- ``MockGPU`` beside JAX's ``MockTPU``: the same calls recorded, the same
  answers and health.
- ``gofr_tpu_torch.__all__`` covers ``gofr_tpu.__all__``, each name resolves
  to the port's counterpart, and a fresh process runs
  ``gofr_tpu_torch.new()`` and ``new_mock_container()`` with neither torch,
  jax nor gofr_tpu loaded.
"""

import asyncio
import os
import subprocess
import sys
from pathlib import Path

import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu.datasource.tpu import MockTPU
from gofr_tpu_torch.container_mock import MockGPU

ROOT = Path(__file__).resolve().parents[1]
PKGS = ["port", "jax"]


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _new(pkg, **kw):
    return (gofr_tpu_torch if pkg == "port" else gofr_tpu).new_mock_container(**kw)


@pytest.mark.parametrize("pkg", PKGS)
def test_one_call_wires_everything(pkg):
    c, mocks = _new(pkg)
    try:
        assert c.sql is mocks.sql and c.sql is not None
        assert c.redis is mocks.redis and c.redis is not None
        assert c.pubsub is mocks.pubsub and c.pubsub is not None
        assert c.mongo is mocks.mongo and c.mongo is not None
        assert c.tpu_runtime is mocks.tpu
        assert c.metrics_manager is mocks.metrics
        assert c.config.get("APP_NAME") == "mock-app"
    finally:
        mocks.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_sql_is_real_sqlite(pkg):
    c, mocks = _new(pkg, redis=False, mongo=False, pubsub="none")
    try:
        c.sql.exec("CREATE TABLE t (id INTEGER, name TEXT)")
        c.sql.exec("INSERT INTO t VALUES (?, ?)", 1, "a")
        assert c.sql.query("SELECT name FROM t WHERE id = ?", 1) == [{"name": "a"}]
        assert (c.redis, c.pubsub, c.mongo) == (None, None, None)
    finally:
        mocks.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_redis_is_real_protocol(pkg):
    c, mocks = _new(pkg, sql=False, mongo=False, pubsub="none")
    try:
        run(c.redis.set("k", "v"))
        assert run(c.redis.get("k")) == b"v"
        assert b"k" in mocks.redis_server.data
    finally:
        mocks.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_pubsub_round_trip(pkg):
    c, mocks = _new(pkg, sql=False, redis=False, mongo=False)
    try:
        async def flow():
            await c.pubsub.publish("t", b"m")
            return await c.pubsub.subscribe("t", timeout=2)

        msg = run(flow())
        assert msg is not None and msg.value == b"m"
    finally:
        mocks.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_kafka_variant(pkg):
    c, mocks = _new(pkg, sql=False, redis=False, mongo=False, pubsub="kafka")
    try:
        assert mocks.kafka_broker is not None
        c.pubsub.publish_sync("orders", b"k1")
        msg = run(c.pubsub.subscribe("orders", timeout=5))
        assert msg is not None and msg.value == b"k1"
        assert [r.value for r in mocks.kafka_broker.records("orders")] == [b"k1"]
    finally:
        mocks.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_unknown_pubsub_backend_raises(pkg):
    with pytest.raises(ValueError, match="unknown mock pubsub backend"):
        _new(pkg, sql=False, redis=False, mongo=False, pubsub="carrier-pigeon")


@pytest.mark.parametrize("pkg", PKGS)
def test_mock_tpu_records_and_cans(pkg):
    c, mocks = _new(pkg, sql=False, redis=False, mongo=False, pubsub="none")
    try:
        mocks.tpu.results["mnist"] = [0.1, 0.9]
        assert c.tpu_runtime.infer("mnist", [0.0]) == [0.1, 0.9]
        assert ("infer", ("mnist", [0.0])) in mocks.tpu.calls
    finally:
        mocks.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_mongo_inmemory(pkg):
    c, mocks = _new(pkg, sql=False, redis=False, pubsub="none")
    try:
        c.mongo.insert_one("users", {"name": "ada"})
        doc = c.mongo.find_one("users", {"name": "ada"})
        assert doc is not None and doc["name"] == "ada"
        obs = c.metrics_manager.histogram("app_mongo_stats").collect_histogram()
        assert {dict(k)["operation"] for k, _ in obs} == {"insert_one", "find_one"}
    finally:
        mocks.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_health_aggregates_all_mocks(pkg):
    c, mocks = _new(pkg)
    try:
        h = c.health()
        assert {"sql", "redis", "pubsub", "mongo", "tpu"} <= set(h)
        assert h["tpu"] == {"status": "UP", "details": {"platform": "mock", "device_count": 0, "models": {}}}
        assert h["mongo"]["status"] == "UP"
    finally:
        mocks.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_context_manager(pkg):
    c, mocks = _new(pkg, sql=True, redis=False, mongo=False, pubsub="none")
    with mocks:
        c.sql.exec("CREATE TABLE x (a INTEGER)")
    with pytest.raises(Exception):  # noqa: B017 - the closed handle's own error
        c.sql.exec("CREATE TABLE y (a INTEGER)")


def test_mock_gpu_answers_as_mock_tpu():
    out = []
    for cls in (MockTPU, MockGPU):
        m = cls({"a": 1})
        m.register_model("b", object(), batch=4)
        got = [m.infer("a", 1, 2), run(m.infer_async("b", 3)), m.infer_one("a", 4, timeout=1.0), m.infer("zz"),
               m.health_check(), m.drained(), run(m.start_batchers()), run(m.stop_batchers()), m.drain(), m.close()]
        out.append((got, m.calls, m.results))
    assert out[1] == out[0]


def test_top_level_exports_cover_jax():
    assert set(gofr_tpu.__all__) <= set(gofr_tpu_torch.__all__)
    assert "resolve_device" in gofr_tpu_torch.__all__
    assert gofr_tpu_torch.__version__ == gofr_tpu.__version__
    from gofr_tpu_torch import app, container_mock, context, http

    want = {"App": app.App, "new": app.new, "Context": context.Context,
            "new_mock_container": container_mock.new_mock_container, "new_cmd": gofr_tpu_torch.new_cmd}
    for name in gofr_tpu.__all__:
        got = getattr(gofr_tpu_torch, name)
        assert got is want.get(name, getattr(http, name, None)), name
        assert got.__module__.startswith("gofr_tpu_torch"), name
    with pytest.raises(AttributeError):
        gofr_tpu_torch.no_such_name  # noqa: B018


def test_new_and_mock_container_load_no_torch(tmp_path):
    """In a fresh process, the top-level ``new()`` and ``new_mock_container()``
    load neither torch, jax nor gofr_tpu (ROADMAP queue 3 items 39 and 51)."""
    code = ("import sys, gofr_tpu_torch; from gofr_tpu_torch import *; "
            "app = gofr_tpu_torch.new(); c, mocks = gofr_tpu_torch.new_mock_container(pubsub='kafka'); "
            "c.mongo.insert_one('u', {'a': 1}); assert c.mongo.count_documents('u') == 1; mocks.close(); "
            "app.container.close(); assert isinstance(app, App) and gofr_tpu_torch.__version__; "
            "print(sorted(m for m in ('torch', 'jax', 'gofr_tpu') if m in sys.modules))")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=60,
                         env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
