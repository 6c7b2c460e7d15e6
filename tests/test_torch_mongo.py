"""gofr_tpu_torch's Mongo datasource (datasource/mongo/{__init__,mongoproto,wire}.py,
testutil/fakemongo.py, Container.add_mongo, ctx.mongo and the secure_server
example) against the JAX package's on the CPU.

- Byte identity of the BSON codec under a hypothesis strategy, each package
  decoding the other's bytes, and OP_MSG frames at a fixed request id.
- Every case of tests/test_mongo.py on both ``InMemoryMongo``s, the same
  operations giving the same answers (random ``uuid4`` ids stripped).
- Cross-wire CRUD in both directions: the port's ``WireMongo`` against JAX's
  ``FakeMongoServer`` and JAX's against the port's, over SCRAM-SHA-256 and
  SCRAM-SHA-1, with and without TLS, with a paged cursor; a wrong password
  refused by both with the same server error; both pools redial after a
  dropped socket.
- ``app_mongo_stats`` label sets and counts, ``health()["mongo"]`` up and
  with the server closed, and the framework series of both containers.
- The secure_server example beside examples/secure-server/main.py over HTTPS.
"""

import contextlib
import importlib
import importlib.util
import json
import ssl
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gofr_tpu import testutil as jtestutil
from gofr_tpu.app import App as JApp
from gofr_tpu.config import new_mock_config as jconfig
from gofr_tpu.container import Container as JContainer
from gofr_tpu.datasource import mongo as jmongo
from gofr_tpu.datasource.mongo import mongoproto as jmb
from gofr_tpu.datasource.mongo import wire as jwire
from gofr_tpu.logging import new_logger as jlogger
from gofr_tpu.metrics import new_metrics_manager as jmetrics
from gofr_tpu.testutil import fakemongo as jfake
from gofr_tpu_torch import testutil as ptestutil
from gofr_tpu_torch.app import App as PApp
from gofr_tpu_torch.config import new_mock_config as pconfig
from gofr_tpu_torch.container import Container as PContainer
from gofr_tpu_torch.datasource import mongo as pmongo
from gofr_tpu_torch.datasource.mongo import mongoproto as pmb
from gofr_tpu_torch.datasource.mongo import wire as pwire
from gofr_tpu_torch.logging import new_logger as plogger
from gofr_tpu_torch.metrics import new_metrics_manager as pmetrics
from gofr_tpu_torch.testutil import fakemongo as pfake

ROOT = Path(__file__).resolve().parents[1]
PKG = {
    "jax": SimpleNamespace(mb=jmb, mongo=jmongo, wire=jwire, Server=jfake.FakeMongoServer, testutil=jtestutil,
                           App=JApp, config=jconfig, Container=JContainer, logger=jlogger, metrics=jmetrics),
    "port": SimpleNamespace(mb=pmb, mongo=pmongo, wire=pwire, Server=pfake.FakeMongoServer, testutil=ptestutil,
                            App=PApp, config=pconfig, Container=PContainer, logger=plogger, metrics=pmetrics),
}
# (client, server): each package's client against the other's fake server
CROSS = [("port", "jax"), ("jax", "port")]
CROSS_IDS = [f"{c}-client-{s}-server" for c, s in CROSS]


# ---------------------------------------------------------------------------
# BSON and OP_MSG bytes
# ---------------------------------------------------------------------------

# an abstract document: ("oid", raw) and ("i64", n) become each package's
# ObjectId and Int64, everything else is a plain Python value
_INT_EDGES = [0, -1, 1, 2**31 - 1, 2**31, -(2**31), -(2**31) - 1, 2**63 - 1, -(2**63)]
_scalars = st.one_of(
    st.text(alphabet=st.characters(codec="utf-8"), max_size=12),
    st.booleans(),
    st.none(),
    st.sampled_from(_INT_EDGES),
    st.integers(-(2**63), 2**63 - 1),
    st.tuples(st.just("i64"), st.integers(-(2**63), 2**63 - 1)),
    st.floats(allow_nan=False),
    st.binary(max_size=16),
    st.tuples(st.just("oid"), st.binary(min_size=12, max_size=12)),
)
_keys = st.text(alphabet=st.characters(codec="utf-8", exclude_characters="\x00"), max_size=8)
_docs = st.recursive(
    st.dictionaries(_keys, _scalars, max_size=5),
    lambda inner: st.dictionaries(_keys, st.one_of(_scalars, inner, st.lists(st.one_of(_scalars, inner), max_size=4)),
                                  max_size=5),
    max_leaves=20,
)


def _concrete(pkg: str, v):
    mb = PKG[pkg].mb
    if isinstance(v, tuple):
        return mb.ObjectId(v[1]) if v[0] == "oid" else mb.Int64(v[1])
    if isinstance(v, dict):
        return {k: _concrete(pkg, x) for k, x in v.items()}
    if isinstance(v, list):
        return [_concrete(pkg, x) for x in v]
    return v


def _plain(v):
    """A decoded value with each package's ObjectId as ("oid", raw) and
    Int64 as the int it is, comparable across packages."""
    if isinstance(v, (jmb.ObjectId, pmb.ObjectId)):
        return ("oid", v.raw)
    if isinstance(v, tuple):
        if len(v) == 2 and v[0] in ("oid", "i64"):  # an abstract ObjectId or Int64
            return ("oid", v[1]) if v[0] == "oid" else v[1]
        return tuple(_plain(x) for x in v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


@settings(max_examples=150, deadline=None)
@given(doc=_docs)
def test_bson_bytes_equal_jax_and_decode_across(doc):
    jb = jmb.encode_document(_concrete("jax", doc))
    pb = pmb.encode_document(_concrete("port", doc))
    assert pb == jb
    want = _plain(doc)
    assert _plain(pmb.decode_document(jb)) == want
    assert _plain(jmb.decode_document(pb)) == want


@pytest.mark.parametrize("sequence", [False, True], ids=["body-only", "with-documents"])
def test_op_msg_frames_equal_jax(sequence):
    raw = bytes(range(12))
    for rid in (0, 7, 2**31 - 1):
        frames = {}
        for pkg in PKG:
            mb = PKG[pkg].mb
            body = {"insert": "c", "$db": "t", "ordered": True, "n": mb.Int64(5), "id": mb.ObjectId(raw)}
            seq = {"documents": [{"a": 1, "s": "héllo"}, {"b": [1.5, None, b"\x00"]}]} if sequence else None
            frames[pkg] = mb.encode_op_msg(body, request_id=rid, response_to=3, sequences=seq)
        assert frames["port"] == frames["jax"]
        for reader, writer in (("port", "jax"), ("jax", "port")):
            r, to, body = PKG[reader].mb.decode_op_msg(frames[writer])
            assert (r, to, body["insert"], body["n"], body["id"].raw) == (rid, 3, "c", 5, raw)
            assert ("documents" in body) == sequence


def test_codec_known_vectors_and_errors_equal_jax():
    for mb in (jmb, pmb):
        assert mb.encode_document({}) == b"\x05\x00\x00\x00\x00"
        assert mb.encode_document({"hello": "world"}) == b"\x16\x00\x00\x00\x02hello\x00\x06\x00\x00\x00world\x00\x00"
    bad = [b"\x05\x00\x00", b"\x06\x00\x00\x00\x00\x00", b"\x0d\x00\x00\x00\x05b\x00\x00\x00\x00\x00\x02\x00",
           b"\x0c\x00\x00\x00\x13v\x00\x00\x00\x00\x00\x00"]
    for raw in bad:
        errs = []
        for mb in (jmb, pmb):
            try:
                mb.decode_document(raw)
                errs.append(None)
            except Exception as e:  # noqa: BLE001 - the type and text are what is compared
                errs.append((type(e).__name__, str(e)))
        assert errs[0] == errs[1] and errs[0] is not None, raw
    for mb in (jmb, pmb):
        with pytest.raises(TypeError):
            mb.encode_document({"v": object()})
        with pytest.raises(ValueError, match="NUL"):
            mb.encode_document({"a\x00b": 1})


# ---------------------------------------------------------------------------
# the in-memory store: every case of tests/test_mongo.py on both packages
# ---------------------------------------------------------------------------

def _strip(v):
    """Drop ``_id`` (random uuid4 hex) from documents, recursively."""
    if isinstance(v, dict):
        return {k: _strip(x) for k, x in v.items() if k != "_id"}
    if isinstance(v, list):
        return [_strip(x) for x in v]
    return v


def _case_insert_and_find(db, pkg):
    db.insert_one("users", {"name": "ada", "age": 36})
    db.insert_one("users", {"name": "alan", "age": 41})
    assert db.count_documents("users") == 2
    found = db.find("users", {"name": "ada"})
    assert len(found) == 1 and found[0]["age"] == 36
    assert found[0]["_id"]
    return [db.count_documents("users"), _strip(found), _strip(db.find("users"))]


def _case_find_one_missing_returns_none(db, pkg):
    assert db.find_one("users", {"name": "nobody"}) is None
    return [db.find_one("users", {"name": "nobody"})]


def _case_insert_many(db, pkg):
    ids = db.insert_many("n", [{"v": i} for i in range(5)])
    assert len(ids) == 5 and len(set(ids)) == 5
    return [db.count_documents("n"), _strip(db.find("n"))]


def _case_query_operators(db, pkg):
    db.insert_many("t", [{"v": i} for i in range(10)] + [{"w": None}])
    filters = [{"v": {"$gt": 7}}, {"v": {"$gte": 7}}, {"v": {"$lt": 2}}, {"v": {"$lte": 2}}, {"v": {"$ne": 0}},
               {"v": {"$in": [1, 3, 99]}}, {"v": {"$nin": list(range(8))}}, {"w": {"$exists": False}},
               {"w": {"$exists": True}}, {"w": None}, {"v": {"$eq": 4}}, {"v": 4}, {"v": {"$gt": 2, "$lt": 6}},
               {"v": {"$gt": 100, "$regex": "x"}}]
    out = [db.count_documents("t", f) for f in filters]
    assert out[:8] == [2, 3, 2, 3, 10, 2, 3, 10]
    with pytest.raises(ValueError, match="unsupported"):
        db.find("t", {"v": {"$regex": "x"}})
    with pytest.raises(ValueError, match="unsupported mongo update operator"):
        db.update_one("t", {"v": 1}, {"$push": {"a": 1}})
    return out


def _case_update_one_set_and_inc(db, pkg):
    db.insert_one("c", {"k": "a", "n": 1})
    assert db.update_one("c", {"k": "a"}, {"$set": {"x": True}, "$inc": {"n": 2, "m": 5}}) == 1
    doc = db.find_one("c", {"k": "a"})
    assert doc["x"] is True and doc["n"] == 3
    assert db.update_one("c", {"k": "zz"}, {"$set": {"x": 1}}) == 0
    db.update_one("c", {"k": "a"}, {"$unset": {"x": ""}})
    return [_strip(db.find("c"))]


def _case_update_by_id_and_replacement(db, pkg):
    _id = db.insert_one("c", {"k": "a"})
    assert db.update_by_id("c", _id, {"k": "b", "new": 1}) == 1
    doc = db.find_one("c", {"_id": _id})
    assert doc["k"] == "b" and doc["new"] == 1 and doc["_id"] == _id
    given = db.insert_one("c", {"_id": "given", "k": "c"})
    return [given, _strip(doc), db.find_one("c", {"_id": "given"})]


def _case_update_many(db, pkg):
    db.insert_many("m", [{"g": 1}, {"g": 1}, {"g": 2}])
    assert db.update_many("m", {"g": 1}, {"$set": {"seen": True}}) == 2
    return [_strip(db.find("m"))]


def _case_delete_one_many(db, pkg):
    db.insert_many("d", [{"v": i % 2, "i": i} for i in range(6)])
    assert db.delete_one("d", {"v": 0}) == 1
    assert db.delete_many("d", {"v": 0}) == 2
    assert db.count_documents("d") == 3
    return [_strip(db.find("d")), db.delete_one("d", {"v": 7})]


def _case_drop_collection(db, pkg):
    db.insert_one("x", {"a": 1})
    db.drop_collection("x")
    assert db.count_documents("x") == 0
    db.drop_collection("never")
    return [db.count_documents("x")]


def _case_documents_never_alias_store(db, pkg):
    src = {"tags": ["a"]}
    db.insert_one("alias", src)
    src["tags"].append("leaked-in")
    doc = db.find_one("alias")
    assert doc["tags"] == ["a"]
    doc["tags"].append("leaked-out")
    assert db.find_one("alias")["tags"] == ["a"]
    return [_strip(db.find("alias")), "_id" in src]


def _case_health(db, pkg):
    db.insert_one("h", {})
    h = db.health_check()
    assert h["status"] == "UP" and h["details"]["collections"] == {"h": 1}
    cold = PKG[pkg].mongo.InMemoryMongo("cold").health_check()
    return [h, cold]


def _case_protocol_conformance(db, pkg):
    assert isinstance(db, PKG[pkg].mongo.MongoProvider)
    return [isinstance(object(), PKG[pkg].mongo.MongoProvider)]


def _case_metrics_and_logs_recorded(db, pkg):
    p = PKG[pkg]
    metrics = p.metrics()
    metrics.new_histogram("app_mongo_stats", "t", (0.001, 1))
    wrapped = p.mongo.InstrumentedMongo(db, p.logger(level_name="ERROR"), metrics)
    wrapped.insert_one("i", {"a": 1})
    assert wrapped.find("i")[0]["a"] == 1
    text = metrics.render_prometheus()
    assert "app_mongo_stats" in text and 'operation="insert_one"' in text
    return [sorted(_observations(metrics).items()), wrapped.database]


def _case_error_propagates(db, pkg):
    wrapped = PKG[pkg].mongo.InstrumentedMongo(db, None, None)
    wrapped.insert_one("i", {"v": 1})
    with pytest.raises(ValueError) as e:
        wrapped.find("i", {"v": {"$bogus": 1}})
    return [str(e.value)]


def _case_add_mongo_wires_ctx_and_health(db, pkg):
    p = PKG[pkg]
    app = p.App(config=p.config({"APP_NAME": "t", "LOG_LEVEL": "ERROR", "METRICS_PORT": "0", "HTTP_PORT": "0"}))
    try:
        provider = p.mongo.InMemoryMongo("appdb")
        app.add_mongo(provider)
        assert provider._connected
        c = app.container
        c.mongo.insert_one("things", {"a": 1})
        assert c.mongo.count_documents("things") == 1
        h = c.health()
        assert h["mongo"]["status"] == "UP"
        return [h["mongo"], sorted(_observations(c.metrics_manager).items())]
    finally:
        app.container.close()


CASES = {name[len("_case_"):]: fn for name, fn in sorted(globals().items()) if name.startswith("_case_")}


def _observations(m) -> dict:
    """app_mongo_stats' sample count by label set."""
    return {key: cnt for key, (_c, _s, cnt) in m.histogram("app_mongo_stats").collect_histogram()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_in_memory_case_equals_jax(case):
    out = {}
    for pkg in PKG:
        db = PKG[pkg].mongo.InMemoryMongo("testdb")
        db.connect()
        out[pkg] = CASES[case](db, pkg)
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# cross-wire
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _server(pkg: str, **kw):
    s = PKG[pkg].Server(**kw)
    try:
        yield s
    finally:
        s.close()


@contextlib.contextmanager
def _wire(cp: str, sp: str, server, tls: bool = False, **kw):
    tls_ctx = PKG[sp].testutil.client_tls_context() if tls else None
    c = PKG[cp].wire.WireMongo("127.0.0.1", server.port, "xdb", tls=tls_ctx, timeout=5, **kw)
    try:
        yield c
    finally:
        c.close()


def _crud(c, mb):
    """The CRUD surface through one client -> what it saw, in plain values."""
    oid = c.insert_one("users", {"name": "ada", "age": 36})
    assert isinstance(oid, mb.ObjectId)
    ids = c.insert_many("n", [{"v": i, "s": "é" * i} for i in range(10)])
    got = c.find("n")  # batch_size=3: the firstBatch and three getMores
    seen = [
        sorted((d["v"], d["s"]) for d in got), [d["_id"] for d in got] == ids,
        c.find_one("users", {"_id": oid})["age"], c.find_one("users", {"name": "nobody"}),
        c.count_documents("n", {"v": {"$gte": 4}}),
        c.update_by_id("users", oid, {"$set": {"age": 37}}), c.find_one("users", {"name": "ada"})["age"],
        c.update_one("n", {"v": 1}, {"$inc": {"v": 100}}), c.update_many("n", {"v": {"$lt": 5}}, {"$set": {"low": True}}),
        c.count_documents("n", {"low": True}), c.delete_one("n", {"v": 101}), c.delete_many("n", {"v": {"$gt": 7}}),
        c.count_documents("n"), c.find_one("users", {"_id": mb.Int64(5)}),
    ]
    c.drop_collection("n")
    c.drop_collection("never-existed")  # code 26: a no-op
    seen.append(c.count_documents("n"))
    with pytest.raises(_mongo_error(c)) as e:
        c.insert_one("users", {"_id": oid, "v": 2})
    seen.append((e.value.code, str(e.value)))
    return _plain(seen)


def _mongo_error(c):
    return importlib.import_module(type(c).__module__).MongoError


@pytest.mark.parametrize("tls", [False, True], ids=["plain", "tls"])
@pytest.mark.parametrize("mech", ["SCRAM-SHA-256", "SCRAM-SHA-1"])
@pytest.mark.parametrize("cross", CROSS, ids=CROSS_IDS)
def test_cross_wire_crud(cross, mech, tls):
    cp, sp = cross
    with _server(sp, batch_size=3, users={"svc": "hunter2"}, tls=tls) as s:
        with _wire(cp, sp, s, tls, username="svc", password="hunter2", auth_mechanism=mech) as c:
            c.connect()
            got = _crud(c, PKG[cp].mb)
            assert all(isinstance(conn.sock, ssl.SSLSocket) == tls for conn in c._idle)
    # the same calls, the JAX client against the JAX server, see the same
    with _server("jax", batch_size=3, users={"svc": "hunter2"}) as s:
        with _wire("jax", "jax", s, username="svc", password="hunter2", auth_mechanism=mech) as c:
            assert _crud(c, jmb) == got


@pytest.mark.parametrize("cross", CROSS, ids=CROSS_IDS)
def test_cross_wire_wrong_password_and_unauthenticated_refused(cross):
    cp, sp = cross
    errors = []
    for client, server in (cross, (sp, sp)):  # against the other's server, then the server's own client
        with _server(server, users={"svc": "hunter2"}) as s:
            for kw in ({"username": "svc", "password": "wrong"}, {"username": "ghost", "password": "hunter2"},
                       {"username": "svc", "password": "wrong", "auth_mechanism": "SCRAM-SHA-1"}):
                with _wire(client, server, s, pool_size=2, **kw) as c:
                    for _ in range(3):  # a refused dial gives its pool slot back
                        with pytest.raises(_mongo_error(c)) as e:
                            c.connect()
                        errors.append((e.value.code, str(e.value).split(":")[0]))
                    assert c._total == 0 and c._idle == []
            with _wire(client, server, s) as c:  # no credentials at all
                with pytest.raises(_mongo_error(c)) as e:
                    c.insert_one("docs", {"v": 1})
                errors.append((e.value.code, str(e.value)))
    half = len(errors) // 2
    assert errors[:half] == errors[half:]
    assert {code for code, _ in errors} == {18, 13}
    assert errors[0] == (18, "Authentication failed")


@pytest.mark.parametrize("cross", CROSS, ids=CROSS_IDS)
def test_cross_wire_pool_redials_after_a_dropped_socket(cross):
    cp, sp = cross
    with _server(sp, batch_size=3) as s, _wire(cp, sp, s) as c:
        c.connect()
        c.insert_one("rc", {"v": 1})
        for conn in c._idle:  # the server side drops every pooled socket
            conn.sock.close()
        with pytest.raises(ConnectionError):
            c.count_documents("rc")
        assert c.count_documents("rc") == 1  # the next command redials
        assert c._total == 1


@pytest.mark.parametrize("cross", CROSS, ids=CROSS_IDS)
def test_cross_wire_untrusted_certificate_refused(cross):
    cp, sp = cross
    with _server(sp, tls=True) as s:
        c = PKG[cp].wire.WireMongo("127.0.0.1", s.port, "db", tls=True, timeout=2)
        with pytest.raises((ssl.SSLError, ConnectionError, OSError)):
            c.connect()
        c.close()


# ---------------------------------------------------------------------------
# instrumentation, health and the framework series
# ---------------------------------------------------------------------------

def _container(pkg: str):
    p = PKG[pkg]
    c = p.Container(config=p.config({"APP_NAME": "m"}), logger=p.logger(level_name="ERROR"))
    if pkg == "jax":
        c.metrics_manager = p.metrics(c.logger)
    c.register_framework_metrics()
    return c


def _ops(mongo):
    mongo.insert_one("a", {"v": 1})
    mongo.insert_many("a", [{"v": 2}, {"v": 3}])
    mongo.find("a", {"v": {"$gt": 1}})
    mongo.find_one("b")
    mongo.update_many("a", {}, {"$inc": {"v": 1}})
    mongo.count_documents("a")
    with pytest.raises(Exception):  # noqa: B017 - either provider's own error type
        mongo.find("a", {"v": {"$bogus": 1}})
    mongo.delete_one("a", {"v": 2})
    mongo.drop_collection("b")


@pytest.mark.parametrize("provider", ["memory", "wire"])
def test_mongo_stats_and_health_equal_jax(provider):
    with _server("port") as s:
        out = {}
        containers = {}
        for pkg in PKG:
            c = containers[pkg] = _container(pkg)
            db = (PKG[pkg].mongo.InMemoryMongo("m") if provider == "memory"
                  else PKG[pkg].wire.WireMongo("127.0.0.1", s.port, f"db{pkg}", timeout=2))
            c.add_mongo(db)
            if provider == "wire":  # the fake's store is shared: give each its own collections
                c.mongo.drop_collection("a")
            _ops(c.mongo)
            obs = {k: v for k, v in _observations(c.metrics_manager).items()}
            out[pkg] = [sorted(obs.items()), c.health()["mongo"]["status"]]
            if provider == "wire":
                c.mongo.drop_collection("a")
        assert out["port"] == out["jax"]
        assert out["port"][1] == "UP"
        ops = {dict(k)["operation"] for k, _ in out["port"][0]}
        assert ops == {"insert_one", "insert_many", "find", "find_one", "update_many", "count_documents",
                       "delete_one", "drop_collection"}
    if provider == "wire":  # the server is gone: both report DOWN
        downs = {pkg: c.health()["mongo"] for pkg, c in containers.items()}
        assert downs["port"]["status"] == downs["jax"]["status"] == "DOWN"
        assert downs["port"]["details"]["backend"] == downs["jax"]["details"]["backend"] == "mongo-wire"
    for c in containers.values():
        c.close()


def test_instrumented_health_reports_down_on_a_raising_provider():
    class Broken(pmongo.InMemoryMongo):
        def health_check(self):
            raise RuntimeError("boom")

    class JBroken(jmongo.InMemoryMongo):
        def health_check(self):
            raise RuntimeError("boom")

    got = [m.InstrumentedMongo(b("x")).health_check() for m, b in ((pmongo, Broken), (jmongo, JBroken))]
    assert got[0] == got[1] == {"status": "DOWN", "details": {"backend": "mongo", "error": "boom"}}


def test_framework_series_equal_jax():
    names = {}
    for pkg in PKG:
        names[pkg] = {pkg + "-bare": set(_container(pkg).metrics_manager._instruments)}
        p = PKG[pkg]
        created = p.Container.create(p.config({"APP_NAME": "m", "LOG_LEVEL": "ERROR"}))
        names[pkg]["created"] = set(created.metrics_manager._instruments)
        created.close()
    assert names["port"]["port-bare"] == names["jax"]["jax-bare"]
    assert names["port"]["created"] == names["jax"]["created"]
    assert {"app_mongo_stats", "app_tpu_stats", "app_tpu_batch_size", "app_tpu_queue_wait"} <= names["port"]["created"]
    for pkg in PKG:  # descriptions and buckets too
        c = _container(pkg)
        names[pkg] = {n: (i.description, tuple(getattr(i, "buckets", ()))) for n, i in
                      c.metrics_manager._instruments.items()}
    assert names["port"] == names["jax"]


# ---------------------------------------------------------------------------
# the secure_server example beside examples/secure-server/main.py
# ---------------------------------------------------------------------------

SECURE_ENV = ("HTTP_TLS_CERT_FILE", "HTTP_TLS_KEY_FILE", "REDIS_HOST", "REDIS_PORT", "REDIS_PASSWORD", "REDIS_TLS",
              "REDIS_TLS_CA_CERT", "SECURE_MONGO_HOST", "SECURE_MONGO_PORT", "SECURE_MONGO_USER",
              "SECURE_MONGO_PASSWORD", "SECURE_MONGO_TLS", "SECURE_MONGO_TLS_CA_CERT", "SECURE_DEMO")


def _https(app, ctx, method, path, payload=None, auth=True):
    import base64

    headers = {"Content-Type": "application/json"} if payload is not None else {}
    if auth:
        headers["Authorization"] = "Basic " + base64.b64encode(b"admin:change-me").decode()
    req = urllib.request.Request(f"https://127.0.0.1:{app.http_server.port}{path}", method=method,
                                 data=json.dumps(payload).encode() if payload is not None else None, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=10, context=ctx) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def test_secure_server_example_answers_as_jax(monkeypatch):
    pytest.importorskip("cryptography")
    monkeypatch.chdir(ROOT / "examples" / "secure-server")
    for k in SECURE_ENV:  # set, then removed: the examples' own writes are undone at teardown
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    for k, v in {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR", "GOFR_HTTP_NATIVE": "0"}.items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location("torch_mongo_secure_server", ROOT / "examples/secure-server/main.py")
    jmain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmain)
    from gofr_tpu_torch.examples import secure_server

    apps, certs = [], []
    for mod in (jmain, secure_server):
        for k in ("HTTP_TLS_CERT_FILE", "HTTP_TLS_KEY_FILE"):  # each app serves its own package's certificate
            monkeypatch.delenv(k, raising=False)
        apps.append(mod.build_app())
        certs.append(apps[-1].config.get("HTTP_TLS_CERT_FILE"))
    ctxs = [ssl.create_default_context(cafile=cert) for cert in certs]  # one subject name: a store each
    threads = [a.run_in_background() for a in apps]
    try:
        seq = [("POST", "/secrets", {"api": "k-123", "db": "pw"}, False), ("POST", "/secrets", {"api": "k-123"}, True),
               ("POST", "/secrets", {"db": "pw"}, True), ("POST", "/secrets", ["not", "a", "dict"], True),
               ("GET", "/secrets/api", None, True), ("GET", "/secrets/db", None, True),
               ("GET", "/secrets/missing", None, True), ("GET", "/audit", None, False), ("GET", "/audit", None, True)]
        answers = [[_https(a, ctx, m, path, body, auth) for m, path, body, auth in seq] for a, ctx in zip(apps, ctxs)]
        assert answers[1] == answers[0]
        statuses = [s for s, _ in answers[1]]
        assert statuses == [401, 201, 201, 400, 200, 200, 404, 401, 200]
        assert answers[1][4][1] == {"data": {"api": "k-123"}}
        assert answers[1][-1][1]["data"]["entries"] == [{"action": "store", "key": "api"},
                                                        {"action": "store", "key": "db"},
                                                        {"action": "read", "key": "api"},
                                                        {"action": "read", "key": "db"}]
        # the audit went to Mongo over TLS, on sockets that passed SCRAM
        for app in apps:
            wire, (_redis, mongo_server) = app.container.mongo._provider, app._secure_demo_backends
            assert wire.username == "svc" and wire.auth_mechanism == "SCRAM-SHA-256"
            assert isinstance(wire.tls, ssl.SSLContext) and mongo_server.tls and mongo_server.users
            assert wire._idle and all(isinstance(conn.sock, ssl.SSLSocket) for conn in wire._idle)
            assert len(mongo_server.store.find("audit")) == 4
    finally:
        for a, th in zip(apps, threads):
            a.shutdown()
            th.join(timeout=10)
        for a in apps:
            a.container.close()
            redis, mongo = a._secure_demo_backends
            redis.stop()
            mongo.close()
