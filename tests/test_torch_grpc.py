"""The port's gRPC half (gofr_tpu_torch.grpcx, App.grpc_unary /
grpc_server_stream, serve's Gemma/Generate and Gemma/Stream) against the
JAX app over real sockets on the CPU: the same tiny weights, the same
adapter and the same requests give the same answers and status codes. The
JAX side serves examples/grpc-gemma/main.py's own generate and stream
handlers (loaded by path, as tests/test_torch_edge.py does). Then the
port's copies of tests/test_grpc.py's framework cases, and serve without
grpc."""

import importlib.util
import pathlib
import sys

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gofr_tpu
from gofr_tpu import lora as JL
from gofr_tpu.config import new_mock_config as jax_mock_config
from gofr_tpu.grpcx import json_server_stream as jax_stream
from gofr_tpu.grpcx import json_unary as jax_unary
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch import serve
from gofr_tpu_torch.app import new
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.grpcx import json_server_stream, json_unary
from gofr_tpu_torch.models import transformer as TT

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLOTS, MAX_SEQ = 4, 256
COMMON = {"HTTP_PORT": "0", "METRICS_PORT": "0", "GRPC_PORT": "0", "REQUEST_TIMEOUT": "30", "LOG_LEVEL": "FATAL"}


def _example_module():
    spec = importlib.util.spec_from_file_location("grpc_gemma_main", ROOT / "examples/grpc-gemma/main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def apps():
    """The JAX app (the example's handlers on a LoRA engine) and the port's
    serve app, both with the adapter "tenant" loaded; ephemeral ports."""
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), TT.TransformerConfig.tiny(), device="cpu")
    adapter = jax.tree.map(np.asarray, JL.init_adapter(jax.random.PRNGKey(7), jcfg, rank=4, scale=1.0))
    example = _example_module()
    japp = gofr_tpu.new(config=jax_mock_config({**COMMON, "METRICS_PORT": "0", "TRACE_EXPORTER": "none"}))
    japp.container.tpu().register_llm(
        "gemma", jcfg, jp, warmup=False, kv_paged=True, lora_slots=2,
        slots=SLOTS, max_seq_len=MAX_SEQ, prefill_buckets=(16, 64, 128),
    )
    japp.grpc_unary("Gemma", "Generate", example.generate)
    japp.grpc_server_stream("Gemma", "Stream", example.stream)
    papp = serve.build_app(new_mock_config({
        **COMMON, "GEMMA_PRESET": "tiny", "TORCH_DEVICE": "cpu", "LLM_SLOTS": str(SLOTS),
        "LLM_MAX_SEQ": str(MAX_SEQ), "TPU_LLM_LORA_SLOTS": "2",
    }), params=tp)
    for app in (japp, papp):
        _engine(app).load_adapter("tenant", adapter)
    threads = [japp.run_in_background(), papp.run_in_background()]
    yield japp, papp
    for app, th in zip((japp, papp), threads):
        app.shutdown()
        th.join(timeout=10)
        assert not th.is_alive()


def _engine(app):
    h = app.container.tpu().llm("gemma")
    return getattr(h, "engine", h)


def _target(app) -> str:
    return f"127.0.0.1:{app.grpc_server.port}"


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 512, n).tolist()


def _raw_unary(app, method, payload: bytes, metadata=()):
    """One call without the JSON helper, so metadata can ride it; returns
    (status code, details, trailing metadata, answer)."""
    with grpc.insecure_channel(_target(app)) as ch:
        fn = ch.unary_unary(f"/Gemma/{method}", request_serializer=lambda b: b, response_deserializer=lambda b: b)
        try:
            out, call = fn.with_call(payload, metadata=metadata, timeout=60)
            return call.code(), None, dict(call.trailing_metadata() or ()), out
        except grpc.RpcError as e:
            return e.code(), e.details(), dict(e.trailing_metadata() or ()), None


def _raw_stream(app, payload: bytes, metadata=()):
    with grpc.insecure_channel(_target(app)) as ch:
        fn = ch.unary_stream("/Gemma/Stream", request_serializer=lambda b: b, response_deserializer=lambda b: b)
        it = fn(payload, metadata=metadata, timeout=60)
        try:
            return grpc.StatusCode.OK, [c for c in it]
        except grpc.RpcError as e:
            return e.code(), dict(e.trailing_metadata() or ())


@pytest.mark.parametrize("seed,n", [(1, 5), (2, 19), (3, 70)])
def test_generate_same_tokens(apps, seed, n):
    body = {"tokens": _prompt(seed, n), "max_new_tokens": 12}
    japp, papp = apps
    want = jax_unary(_target(japp), "Gemma", "Generate", body, timeout=60)
    got = json_unary(_target(papp), "Gemma", "Generate", body, timeout=60)
    assert got == want and len(got["tokens"]) == 12


@pytest.mark.parametrize("seed,n", [(4, 9), (5, 33)])
def test_stream_same_chunks(apps, seed, n):
    body = {"tokens": _prompt(seed, n), "max_new_tokens": 10}
    japp, papp = apps
    want = list(jax_stream(_target(japp), "Gemma", "Stream", body, timeout=60))
    got = list(json_server_stream(_target(papp), "Gemma", "Stream", body, timeout=60))
    assert got == want and len(got) == 10 and all(set(c) == {"token"} for c in got)


@pytest.mark.parametrize("method", ["Generate", "Stream"])
def test_adapter_metadata_same_tokens(apps, method):
    """x-gofr-adapter rides the metadata into ctx.header: the adapter's
    tokens on both apps, not the base's."""
    payload = b'{"tokens": [7, 3, 9, 11, 2], "max_new_tokens": 10}'
    meta = (("x-gofr-adapter", "tenant"),)
    run = (lambda app, m: _raw_unary(app, "Generate", payload, m)[3]) if method == "Generate" else (
        lambda app, m: _raw_stream(app, payload, m)[1])
    japp, papp = apps
    want, got = run(japp, meta), run(papp, meta)
    assert got == want and got is not None
    assert run(papp, ()) == run(japp, ()) != got


@pytest.mark.parametrize("method", ["Generate", "Stream"])
def test_overload_maps_to_resource_exhausted(apps, method):
    """A full queue (max_queue 0, admission frozen): RESOURCE_EXHAUSTED
    with a retry-after trailer on both apps."""
    payload = b'{"tokens": [1, 2, 3], "max_new_tokens": 4}'
    answers = []
    for app in apps:
        eng = _engine(app)
        eng._admit = lambda: False
        eng.max_queue = 0
        try:
            if method == "Generate":
                code, _details, trailer, _out = _raw_unary(app, "Generate", payload)
            else:
                code, trailer = _raw_stream(app, payload)
        finally:
            eng.max_queue = None
            del eng._admit
        answers.append((code, trailer))
    for code, trailer in answers:
        assert code == grpc.StatusCode.RESOURCE_EXHAUSTED, answers
        assert float(trailer["retry-after"]) > 0, answers


def test_unknown_adapter_same_status(apps):
    payload = b'{"tokens": [1, 2, 3], "max_new_tokens": 4}'
    codes = [_raw_unary(app, "Generate", payload, (("x-gofr-adapter", "ghost"),))[0] for app in apps]
    assert codes[0] == codes[1] != grpc.StatusCode.OK, codes


# -- the port's copies of tests/test_grpc.py's framework cases ----------------


@pytest.fixture(scope="module")
def grpc_app():
    app = new(config=new_mock_config({"APP_NAME": "grpc-test", "HTTP_PORT": "0", "METRICS_PORT": "0", "GRPC_PORT": "0",
                                      "LOG_LEVEL": "FATAL"}))

    def hello(ctx):
        body = ctx.bind()
        return {"greeting": f"Hello {body.get('name', 'World')}!", "meta": ctx.header("X-Meta")}

    async def async_hello(ctx):
        return {"greeting": "async"}

    def boom(ctx):
        raise ValueError("kaboom")

    def count_stream(ctx):
        for i in range(ctx.bind().get("n", 3)):
            yield {"i": i}

    async def async_count_stream(ctx):
        for i in range(ctx.bind().get("n", 3)):
            yield {"i": i}

    app.grpc_unary("Hello", "SayHello", hello)
    app.grpc_unary("Hello", "AsyncHello", async_hello)
    app.grpc_unary("Hello", "Boom", boom)
    app.grpc_server_stream("Hello", "Count", count_stream)
    app.grpc_server_stream("Hello", "AsyncCount", async_count_stream)
    th = app.run_in_background()
    yield app, f"127.0.0.1:{app.grpc_server.port}"
    app.shutdown()
    th.join(timeout=10)


def test_unary_roundtrip(grpc_app):
    _, target = grpc_app
    assert json_unary(target, "Hello", "SayHello", {"name": "GPU"}) == {"greeting": "Hello GPU!", "meta": ""}
    with grpc.insecure_channel(target) as ch:
        fn = ch.unary_unary("/Hello/SayHello", request_serializer=lambda b: b, response_deserializer=lambda b: b)
        assert b'"meta": "m1"' in fn(b"{}", metadata=(("x-meta", "m1"),), timeout=10)


def test_async_handler(grpc_app):
    _, target = grpc_app
    assert json_unary(target, "Hello", "AsyncHello", {}) == {"greeting": "async"}


def test_recovery_interceptor_maps_to_internal(grpc_app):
    _, target = grpc_app
    with pytest.raises(grpc.RpcError) as ei:
        json_unary(target, "Hello", "Boom", {})
    assert ei.value.code() == grpc.StatusCode.INTERNAL


def test_unknown_method_is_unimplemented(grpc_app):
    _, target = grpc_app
    with pytest.raises(grpc.RpcError) as ei:
        json_unary(target, "Hello", "Nope", {})
    assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED


def test_stream_yields_chunks_in_order(grpc_app):
    _, target = grpc_app
    assert list(json_server_stream(target, "Hello", "Count", {"n": 5})) == [{"i": i} for i in range(5)]


def test_async_generator_handler(grpc_app):
    _, target = grpc_app
    assert list(json_server_stream(target, "Hello", "AsyncCount", {"n": 4})) == [{"i": i} for i in range(4)]


# -- serve without grpc ----------------------------------------------------------


def test_serve_builds_without_grpc(monkeypatch):
    """With grpc unimportable, serve.build_app builds and serves HTTP with
    gRPC off; a GRPC_PORT set explicitly then raises."""
    import http.client
    import json

    monkeypatch.setitem(sys.modules, "grpc", None)
    base = {"HTTP_PORT": "0", "METRICS_PORT": "0", "GEMMA_PRESET": "tiny", "TORCH_DEVICE": "cpu", "LOG_LEVEL": "FATAL",
            "LLM_SLOTS": "2", "LLM_MAX_SEQ": "64"}
    app = serve.build_app(new_mock_config(base))
    th = app.run_in_background()
    try:
        assert app.grpc_server is None and not app._grpc_registered
        conn = http.client.HTTPConnection("127.0.0.1", app.http_server.port, timeout=60)
        conn.request("POST", "/generate", body=json.dumps({"tokens": [1, 2, 3], "max_new_tokens": 4}))
        resp = conn.getresponse()
        assert resp.status == 201 and len(json.loads(resp.read())["data"]["tokens"]) == 4
        conn.close()
    finally:
        app.shutdown()
        th.join(timeout=10)
    with pytest.raises(RuntimeError, match="GRPC_PORT is set but grpc"):
        serve.build_app(new_mock_config({**base, "GRPC_PORT": "0"}))
