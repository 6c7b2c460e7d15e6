"""The port's broker examples (gofr_tpu_torch.examples.using_publisher,
using_subscriber, kafka_batch_inference, grpc_server) against the JAX
package's (examples/<name>/main.py), each booted in-process on ephemeral
ports and driven over real sockets: the same requests give the same
answers over MEMORY, KAFKA and MQTT, the JAX app against the port's fake
broker and the port's app against JAX's.

``kafka_batch_inference`` carries JAX's example parameters across
(``models.mlp.mlp_params_from_jax``), so its predictions equal JAX's and
the argmax of the registered model run directly on the same rows."""

import contextlib
import importlib
import importlib.util
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _load_jax(example: str):
    path = os.path.join(EXAMPLES, example, "main.py")
    spec = importlib.util.spec_from_file_location(f"torch_cmp_pubsub_{example.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_port(example: str):
    return importlib.import_module(f"gofr_tpu_torch.examples.{example.replace('-', '_')}")


@contextlib.contextmanager
def _broker(backend: str, pkg: str):
    """A fake broker of ``pkg`` and the env that points an app at it."""
    if backend == "MEMORY":
        yield None, {"PUBSUB_BACKEND": "MEMORY"}
        return
    if backend == "KAFKA":
        mod = "gofr_tpu.testutil.fakekafka" if pkg == "jax" else "gofr_tpu_torch.testutil.fakekafka"
        b = importlib.import_module(mod).FakeKafkaBroker()
        env = {"PUBSUB_BACKEND": "KAFKA", "PUBSUB_BROKER": b.address, "KAFKA_BATCH_TIMEOUT": "10"}
    else:
        mod = "gofr_tpu.testutil.fakemqtt" if pkg == "jax" else "gofr_tpu_torch.testutil.fakemqtt"
        b = importlib.import_module(mod).FakeMQTTBroker()
        env = {"PUBSUB_BACKEND": "MQTT", "MQTT_HOST": b.host, "MQTT_PORT": str(b.port)}
    try:
        yield b, env
    finally:
        b.close()


def _start(build, env: dict, monkeypatch):
    with monkeypatch.context() as m:
        for k, v in {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR", "GOFR_HTTP_NATIVE": "0",
                     "TORCH_DEVICE": "cpu", **env}.items():
            m.setenv(k, v)
        app = build()
    thread = app.run_in_background()
    return app, thread


def _stop(apps_threads):
    for app, thread in apps_threads:
        app.shutdown()
        thread.join(timeout=10)


def _call(app, method, path, body=None):
    url = f"http://127.0.0.1:{app.http_server.port}{path}"
    req = urllib.request.Request(url, data=body, method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait(pred, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _subscribed(broker, backend):
    """Whether an MQTT app's subscribe loop has subscribed (a QoS 1 message
    routed before that is not held for it)."""
    return backend != "MQTT" or any(s.subs for s in broker._sessions)


@pytest.fixture()
def example_dir(request, monkeypatch):
    monkeypatch.chdir(os.path.join(EXAMPLES, request.param))
    return request.param


# ---------------------------------------------------------------------------
# using-publisher
# ---------------------------------------------------------------------------

def _topic_values(backend, broker, app, topic):
    if backend == "KAFKA":
        return [r.value for r in broker.records(topic)]
    if backend == "MQTT":
        return [p for t, p, _ in broker.published if t == topic]
    return list(app.container.pubsub._queues.get(topic, []))


@pytest.mark.parametrize("example_dir", ["using-publisher"], indirect=True)
@pytest.mark.parametrize("backend", ["MEMORY", "KAFKA", "MQTT"])
def test_using_publisher(example_dir, backend, monkeypatch):
    jmod, pmod = _load_jax(example_dir), _load_port(example_dir)
    runs = []
    with _broker(backend, "port") as (jb, jenv), _broker(backend, "jax") as (pb, penv):
        try:
            runs.append(_start(jmod.build_app, jenv, monkeypatch))
            runs.append(_start(pmod.build_app, penv, monkeypatch))
            (japp, _), (papp, _) = runs
            order, product = json.dumps({"id": 7, "item": "tea"}).encode(), json.dumps({"sku": "x1"}).encode()
            for path, body in (("/publish-order", order), ("/publish-product", product)):
                answers = [_call(a, "POST", path, body) for a in (japp, papp)]
                assert answers[0] == answers[1] == (201, b'{"data":"Published"}')
            for topic, body in (("order-logs", order), ("products", product)):
                _wait(lambda t=topic: all(_topic_values(backend, b, a, t) for b, a in ((jb, japp), (pb, papp))),
                      what=f"{topic} on both brokers")
                j, p = (_topic_values(backend, b, a, topic) for b, a in ((jb, japp), (pb, papp)))
                assert j == p == [json.dumps(json.loads(body)).encode()]
            assert papp.container.health()["pubsub"]["status"] == "UP"
        finally:
            _stop(runs)


# ---------------------------------------------------------------------------
# using-subscriber
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("example_dir", ["using-subscriber"], indirect=True)
@pytest.mark.parametrize("backend", ["MEMORY", "KAFKA", "MQTT"])
def test_using_subscriber(example_dir, backend, monkeypatch):
    jmod, pmod = _load_jax(example_dir), _load_port(example_dir)
    jmod.RECEIVED.clear()
    pmod.RECEIVED.clear()
    runs = []
    with _broker(backend, "port") as (jb, jenv), _broker(backend, "jax") as (pb, penv):
        try:
            runs.append(_start(jmod.build_app, jenv, monkeypatch))
            runs.append(_start(pmod.build_app, penv, monkeypatch))
            (japp, _), (papp, _) = runs
            _wait(lambda: _subscribed(jb, backend) and _subscribed(pb, backend), what="the subscriptions")
            orders = [{"id": i, "item": f"item-{i}"} for i in range(3)]
            for o in orders:
                answers = [_call(a, "POST", "/publish-order", json.dumps(o).encode()) for a in (japp, papp)]
                assert answers[0] == answers[1] == (201, json.dumps({"data": {"published": o}},
                                                                    separators=(",", ":")).encode())
            _wait(lambda: len(jmod.RECEIVED) == len(pmod.RECEIVED) == 3, what="every order seen")
            seen = [_call(a, "GET", "/seen") for a in (japp, papp)]
            assert seen[0] == seen[1] and json.loads(seen[1][1])["data"] == orders
        finally:
            _stop(runs)


@pytest.mark.parametrize("backend", ["KAFKA", "MQTT"])
@pytest.mark.parametrize("publisher", ["port", "jax"])
def test_publisher_to_subscriber_over_a_broker(backend, publisher, monkeypatch):
    """using_publisher's orders reach using_subscriber through one broker
    of the port's, each exactly once."""
    pub_mod = _load_port("using-publisher") if publisher == "port" else _load_jax("using-publisher")
    sub_mod = _load_port("using-subscriber")
    sub_mod.RECEIVED.clear()
    runs = []
    with _broker(backend, "port") as (b, env):
        try:
            monkeypatch.chdir(os.path.join(EXAMPLES, "using-subscriber"))
            runs.append(_start(sub_mod.build_app, {**env, "MQTT_CLIENT_ID": "subscriber"}, monkeypatch))
            monkeypatch.chdir(os.path.join(EXAMPLES, "using-publisher"))
            runs.append(_start(pub_mod.build_app, {**env, "MQTT_CLIENT_ID": "publisher"}, monkeypatch))
            (sub_app, _), (pub_app, _) = runs
            _wait(lambda: _subscribed(b, backend), what="the subscription")
            orders = [{"id": i, "qty": i * 3} for i in range(8)]
            for o in orders:
                assert _call(pub_app, "POST", "/publish-order", json.dumps(o).encode())[0] == 201
            _wait(lambda: len(sub_mod.RECEIVED) >= len(orders), what="every order")
            time.sleep(0.3)  # a duplicate, were there one, would be here by now
            assert sorted(sub_mod.RECEIVED, key=lambda o: o["id"]) == orders
        finally:
            _stop(runs)


# ---------------------------------------------------------------------------
# kafka-batch-inference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("example_dir", ["kafka-batch-inference"], indirect=True)
@pytest.mark.parametrize("backend", ["MEMORY", "KAFKA"])
def test_kafka_batch_inference_predictions_equal_jax(example_dir, backend, monkeypatch):
    import jax
    import torch

    from gofr_tpu_torch.models import MLPConfig, mlp_params_from_jax

    jmod, pmod = _load_jax(example_dir), _load_port(example_dir)
    jmod.RESULTS.clear()
    pmod.RESULTS.clear()
    runs = []
    with _broker(backend, "port") as (_jb, jenv), _broker(backend, "jax") as (_pb, penv):
        try:
            runs.append(_start(jmod.build_app, jenv, monkeypatch))
            japp = runs[0][0]
            jparams = jax.tree.map(np.asarray, japp.container.tpu().model("mnist").params)
            params = mlp_params_from_jax(jparams, MLPConfig(16, (32,), 4, torch.float32), device="cpu")
            runs.append(_start(lambda: pmod.build_app(params=params), penv, monkeypatch))
            papp = runs[1][0]
            rng = np.random.default_rng(0)
            want = {}
            for i in range(6):
                xs = rng.normal(size=(4, 16)).astype(np.float32)
                body = json.dumps({"id": f"job-{i}", "xs": xs.tolist()}).encode()
                answers = [_call(a, "POST", "/enqueue", body) for a in (japp, papp)]
                assert answers[0] == answers[1] == (201, json.dumps({"data": {"queued": f"job-{i}", "rows": 4}},
                                                                    separators=(",", ":")).encode())
                direct = papp.container.tpu().infer("mnist", xs)
                want[f"job-{i}"] = np.argmax(np.asarray(direct), axis=-1).tolist()
            _wait(lambda: len(jmod.RESULTS) == len(pmod.RESULTS) == 6, 30, "every microbatch's predictions")
            got = [json.loads(_call(a, "GET", "/results")[1])["data"] for a in (japp, papp)]
            assert got[1] == got[0] == want
            assert len({p for preds in want.values() for p in preds}) > 1
        finally:
            _stop(runs)


# ---------------------------------------------------------------------------
# grpc-server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("example_dir", ["grpc-server"], indirect=True)
def test_grpc_server(example_dir, monkeypatch):
    pytest.importorskip("grpc")
    import gofr_tpu
    from gofr_tpu_torch.grpcx import json_server_stream, json_unary

    jmod, pmod = _load_jax(example_dir), _load_port(example_dir)
    built = []
    monkeypatch.setattr(gofr_tpu.App, "run", lambda self: built.append(self))

    def build_jax():
        jmod.main()  # the JAX example builds and runs its app in main()
        return built[-1]

    runs = []
    try:
        runs.append(_start(build_jax, {"GRPC_PORT": "0"}, monkeypatch))
        runs.append(_start(pmod.build_app, {"GRPC_PORT": "0"}, monkeypatch))
        targets = [f"127.0.0.1:{app.grpc_server.port}" for app, _ in runs]
        _wait(lambda: all(app.grpc_server._started for app, _ in runs), what="both gRPC servers")
        for payload in ({}, {"name": "ada"}):
            j, p = (json_unary(t, "Hello", "SayHello", payload) for t in targets)
            assert p == j == {"greeting": f"Hello {payload.get('name', 'World')}!"}
        for payload in ({}, {"n": 3}):
            j, p = (list(json_server_stream(t, "Hello", "Squares", payload)) for t in targets)
            assert p == j == [{"i": i, "square": i * i} for i in range(payload.get("n", 5))]
        assert [a.config.get("APP_NAME") for a, _ in runs] == ["grpc-sample", "grpc-sample"]
    finally:
        _stop(runs)
