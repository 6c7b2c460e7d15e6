"""The gateway of chip_smoke.py's gateway part on the CPU, built twice by
``chip_smoke.build_gateway``: over the JAX package in front of a JAX model
app, and over the port in front of the port's model app
(gofr_tpu_torch.serve), on the same tiny weights with an untied random
head. Auth answers, forwarded greedy tokens, the proxied SSE stream, the
circuit breaker and the outbound metrics must agree between the two."""

import base64
import http.client
import importlib.util
import json
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gofr_tpu
from chip_smoke import basic_auth, build_gateway, free_port
from gofr_tpu.config import new_mock_config as jax_mock_config
from gofr_tpu.models import transformer as JT
from gofr_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from gofr_tpu.openai_compat import register_openai_routes as jax_openai_routes
from gofr_tpu_torch import serve
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.models import transformer as TT

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLOTS, MAX_SEQ = 4, 256
COMMON = {"HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "30", "LOG_LEVEL": "ERROR"}


def _example_generate():
    """examples/grpc-gemma/main.py's /generate handler (the JAX model app's)."""
    spec = importlib.util.spec_from_file_location("grpc_gemma_main_gw", ROOT / "examples/grpc-gemma/main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.generate


@pytest.fixture(scope="module")
def stacks():
    """(JAX model app, JAX gateway), (port model app, port gateway), all serving."""
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), TT.TransformerConfig.tiny(), device="cpu")
    japp = gofr_tpu.new(config=jax_mock_config({**COMMON, "TRACE_EXPORTER": "none"}))
    japp.container.tpu().register_llm("gemma", jcfg, jp, warmup=False, kv_paged=True, slots=SLOTS,
                                      max_seq_len=MAX_SEQ, prefill_buckets=(16, 64, 128))
    japp.post("/generate", _example_generate())
    jax_openai_routes(japp, model="gemma", tokenizer=JByteTokenizer(jcfg.vocab_size))
    papp = serve.build_app(new_mock_config({**COMMON, "GEMMA_PRESET": "tiny", "TORCH_DEVICE": "cpu",
                                            "LLM_SLOTS": str(SLOTS), "LLM_MAX_SEQ": str(MAX_SEQ)}), params=tp)
    apps, threads = [], []
    for model, package in ((japp, "gofr_tpu"), (papp, "gofr_tpu_torch")):
        threads.append(model.run_in_background())
        gw = build_gateway(f"http://127.0.0.1:{model.http_server.port}", f"http://127.0.0.1:{free_port()}",
                           package=package)
        threads.append(gw.run_in_background())
        apps += [model, gw]
    yield (apps[0], apps[1]), (apps[2], apps[3])
    # the JAX container does not close its services at shutdown: close the
    # gateways' pools (keep-alive sockets to the model apps) on their loops
    for gw in (apps[1], apps[3]):
        for svc in gw.container.services.values():
            svc.close()
    for app in reversed(apps):
        app.shutdown()
    for th in threads:
        th.join(timeout=15)
        assert not th.is_alive()


def _call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _both(stacks, method, path, body=None, headers=None, which=1):
    return [_call(s[which].http_server.port, method, path, body, headers) for s in stacks]


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 512, n).tolist()


def _sse(raw):
    events = [ln[len("data: "):] for ln in raw.decode().split("\n") if ln.startswith("data: ")]
    assert events and events[-1] == "[DONE]"
    return [{k: v for k, v in json.loads(e).items() if k not in ("id", "created")} for e in events[:-1]]


@pytest.mark.parametrize("headers", [{}, basic_auth(password="wrong"),
                                     {"Authorization": "Basic " + base64.b64encode(b"nocolon").decode()}])
def test_auth_refusals_equal(stacks, headers):
    (js, jb), (ps, pb) = _both(stacks, "POST", "/ask/gemma", {"tokens": [1, 2, 3], "max_new_tokens": 4}, headers)
    assert js == ps == 401
    assert jb == pb == b'{"error":{"message":"Unauthorized"}}'


def test_health_needs_no_credentials(stacks):
    (js, jb), (ps, pb) = _both(stacks, "GET", "/.well-known/health")
    assert js == ps == 200
    jh, ph = json.loads(jb)["data"], json.loads(pb)["data"]
    for h in (jh, ph):
        assert h["gemma"]["status"] == "UP" and h["down"]["status"] == "DOWN"
        assert h["gemma"]["details"]["status_code"] == 200


@pytest.mark.parametrize("seed,n", [(1, 5), (2, 19), (3, 70)])
def test_forwarded_greedy_tokens_identical(stacks, seed, n):
    body = {"tokens": _prompt(seed, n), "max_new_tokens": 12}
    (js, jb), (ps, pb) = _both(stacks, "POST", "/ask/gemma", body, basic_auth())
    assert js == ps == 201
    jt, pt = json.loads(jb)["data"]["tokens"], json.loads(pb)["data"]["tokens"]
    assert jt == pt and len(pt) == 12
    # the gateway forwards the model app's answer as it is
    (ds, db), = [_call(stacks[1][0].http_server.port, "POST", "/generate", body)]
    assert ds == 201 and db == pb


def test_upstream_error_passes_through(stacks):
    # a body without tokens: both model apps answer the masked 500, and the
    # gateways pass it on as it is
    (js, jb), (ps, pb) = _both(stacks, "POST", "/ask/gemma", {"max_new_tokens": 4}, basic_auth())
    assert js == ps == 500
    assert jb == pb == b'{"error":{"message":"some unexpected error has occurred"}}'


def test_unknown_service_404(stacks):
    (js, jb), (ps, pb) = _both(stacks, "POST", "/ask/nope", {"tokens": [1]}, basic_auth())
    assert js == ps == 404 and jb == pb


def test_stream_proxied_through_astream(stacks):
    chat = {"model": "gemma", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 6, "stream": True}
    (js, jb), (ps, pb) = _both(stacks, "POST", "/ask/gemma/stream", chat, basic_auth())
    assert js == ps == 200
    assert _sse(jb) == _sse(pb)
    # through the gateway, the port's events are the model app's own
    ds, db = _call(stacks[1][0].http_server.port, "POST", "/v1/chat/completions", chat)
    assert ds == 200 and _sse(db) == _sse(pb)
    # a plain (non-streamed) answer passes through the stream route whole
    (js, jb), (ps, pb) = _both(stacks, "POST", "/ask/gemma/stream", {**chat, "stream": False}, basic_auth())
    assert js == ps == 200
    strip = lambda b: {k: v for k, v in json.loads(b).items() if k not in ("id", "created")}  # noqa: E731
    assert strip(jb) == strip(pb)


def test_breaker_opens_per_service(stacks):
    small = {"tokens": [5, 6, 7], "max_new_tokens": 3}
    got = []
    for (_model, gw) in stacks:
        down = gw.container.get_http_service("down")
        t0 = time.perf_counter()
        answers = [_call(gw.http_server.port, "POST", "/ask/down", small, basic_auth()) for _ in range(3)]
        assert time.perf_counter() - t0 < 5.0
        assert [a[0] for a in answers] == [503, 503, 503]
        msgs = [json.loads(a[1])["error"]["message"] for a in answers]
        assert msgs[:2] == ["service down unreachable"] * 2
        assert msgs[2] == f"circuit breaker open for {down.address}"
        assert down.circuit.state == "open"
        # breakers are per service: gemma keeps serving
        s, b = _call(gw.http_server.port, "POST", "/ask/gemma", small, basic_auth())
        assert s == 201 and gw.container.get_http_service("gemma").circuit.state == "closed"
        got.append((msgs[:2], json.loads(b)["data"]["tokens"]))
    assert got[0] == got[1]


def test_metrics_servers_count_the_forwards(stacks):
    body = {"tokens": _prompt(7, 9), "max_new_tokens": 4}
    series = []
    for (model, gw) in stacks:
        def scrape(app):
            return _call(app.metrics_server.port, "GET", "/metrics")[1].decode()

        before = scrape(model)
        for _ in range(2):
            assert _call(gw.http_server.port, "POST", "/ask/gemma", body, basic_auth())[0] == 201
        text, after = scrape(gw), scrape(model)
        line = 'app_http_service_response_count{method="POST",path="generate",status="201"}'
        svc = [ln for ln in text.splitlines() if ln.startswith(line)]
        model_line = 'app_http_response_count{method="POST",path="/generate",status="201"}'

        def count(t):
            return sum(float(ln.split()[-1]) for ln in t.splitlines() if ln.startswith(model_line))

        assert count(after) - count(before) == 2
        series.append(sorted(ln.split("{")[0] + "{" + ln.split("{", 1)[1].split("}")[0] + "}"
                             for ln in text.splitlines() if ln.startswith("app_http_service_response_bucket")))
        assert svc
    # the same series names and labels in both gateways
    assert set(series[0]) == set(series[1])
