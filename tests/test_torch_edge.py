"""The port's serving edge (gofr_tpu_torch.serve: /generate, the OpenAI
routes, the well-known routes) against the JAX app over real sockets on
the CPU: the same tiny weights, the same engine kwargs and the same
requests must give the same answers, ids and timestamps excepted. The JAX
side serves the grpc-gemma example's own /generate handler."""

import http.client
import importlib.util
import json
import pathlib
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gofr_tpu
from gofr_tpu.config import new_mock_config as jax_mock_config
from gofr_tpu.models import transformer as JT
from gofr_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from gofr_tpu.openai_compat import register_openai_routes as jax_openai_routes
from gofr_tpu_torch import serve
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.models import transformer as TT

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLOTS, MAX_SEQ = 4, 256
COMMON = {"HTTP_PORT": "0", "REQUEST_TIMEOUT": "30", "LOG_LEVEL": "ERROR"}
PORT_CONFIG = {**COMMON, "GEMMA_PRESET": "tiny", "TORCH_DEVICE": "cpu",
               "LLM_SLOTS": str(SLOTS), "LLM_MAX_SEQ": str(MAX_SEQ)}


def _example_module():
    """examples/grpc-gemma/main.py, loaded without running build_app (its
    gRPC half needs grpcio): the JAX side's /generate handler."""
    spec = importlib.util.spec_from_file_location("grpc_gemma_main", ROOT / "examples/grpc-gemma/main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights():
    jcfg = JT.TransformerConfig.tiny()  # vocabulary 512: byte-tokenizable
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    # untied random head: the tied tiny model repeats its input token
    jp = dict(jp, unembed=jax.random.normal(
        jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32
    ))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), TT.TransformerConfig.tiny(), device="cpu")
    return jcfg, jp, tp


@pytest.fixture(scope="module")
def apps(weights):
    jcfg, jp, tp = weights
    example = _example_module()
    japp = gofr_tpu.new(config=jax_mock_config({
        **COMMON, "METRICS_PORT": "0", "TRACE_EXPORTER": "none",
    }))
    japp.container.tpu().register_llm(
        "gemma", jcfg, jp, warmup=False, kv_paged=True,
        slots=SLOTS, max_seq_len=MAX_SEQ, prefill_buckets=(16, 64, 128),
    )
    japp.post("/generate", example.generate)
    japp.get("/stats", example.engine_stats)
    jax_openai_routes(japp, model="gemma", tokenizer=JByteTokenizer(jcfg.vocab_size))
    papp = serve.build_app(new_mock_config(PORT_CONFIG), params=tp)
    threads = [japp.run_in_background(), papp.run_in_background()]
    yield japp, papp
    for app, th in zip((japp, papp), threads):
        app.shutdown()
        th.join(timeout=10)
        assert not th.is_alive()


def _call(app, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", app.http_server.port, timeout=120)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _both(apps, method, path, body=None):
    (s1, b1), (s2, b2) = (_call(a, method, path, body) for a in apps)
    return (s1, b1), (s2, b2)


def _strip(obj):
    """Drop the per-answer id and timestamp."""
    return {k: v for k, v in obj.items() if k not in ("id", "created")}


def _engine(app):
    return app.container.tpu().llm("gemma")


def _wait(pred, seconds):
    t0 = time.perf_counter()
    while not pred() and time.perf_counter() - t0 < seconds:
        time.sleep(0.01)
    return pred()


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 512, n).tolist()


def test_generate_greedy_same_answer(apps):
    for seed, n in ((1, 5), (2, 19), (3, 70)):
        body = {"tokens": _prompt(seed, n), "max_new_tokens": 12}
        (js, jb), (ps, pb) = _both(apps, "POST", "/generate", body)
        assert (js, ps) == (201, 201)
        assert pb == jb
        assert len(json.loads(pb)["data"]["tokens"]) == 12


def test_generate_concurrent_same_answers(apps):
    """More requests than slots at once: prefill rows share steps with
    other requests' decode, on both sides."""
    import concurrent.futures

    bodies = [{"tokens": _prompt(10 + i, 3 + 7 * i), "max_new_tokens": 9} for i in range(6)]
    with concurrent.futures.ThreadPoolExecutor(12) as ex:
        futs = [[ex.submit(_call, app, "POST", "/generate", b) for b in bodies] for app in apps]
        jax_out, port_out = ([f.result(timeout=120) for f in fs] for fs in futs)
    assert port_out == jax_out


def test_chat_completion_plain(apps):
    body = {"model": "gemma", "messages": [{"role": "user", "content": "hello"}], "max_tokens": 8}
    (js, jb), (ps, pb) = _both(apps, "POST", "/v1/chat/completions", body)
    assert js == ps == 200
    j, p = json.loads(jb), json.loads(pb)
    assert _strip(p) == _strip(j)
    assert p["usage"]["completion_tokens"] == 8 and p["choices"][0]["finish_reason"] == "length"


def _sse_events(raw: bytes) -> list:
    events = [ln[len("data: "):] for ln in raw.decode().split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return [_strip(json.loads(e)) for e in events[:-1]] + ["[DONE]"]


def test_chat_completion_sse(apps):
    body = {"messages": [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"}],
            "max_tokens": 10, "stream": True}
    (js, jb), (ps, pb) = _both(apps, "POST", "/v1/chat/completions", body)
    assert js == ps == 200
    jev, pev = _sse_events(jb), _sse_events(pb)
    assert pev == jev
    assert pev[-2]["choices"][0]["finish_reason"] == "length"


@pytest.mark.parametrize("inp", [["hello", "world"], "one string", [1, 2, 3], [[5, 6], [7]]])
def test_embeddings(apps, inp):
    (js, jb), (ps, pb) = _both(apps, "POST", "/v1/embeddings", {"input": inp})
    assert js == ps == 200
    j, p = json.loads(jb), json.loads(pb)
    je = np.array([d["embedding"] for d in j["data"]])
    pe = np.array([d["embedding"] for d in p["data"]])
    np.testing.assert_allclose(pe, je, atol=1e-6, rtol=0)
    for d in (*j["data"], *p["data"]):
        d.pop("embedding")
    assert p == j


def test_models(apps):
    (js, jb), (ps, pb) = _both(apps, "GET", "/v1/models")
    assert js == ps == 200 and pb == jb


@pytest.mark.parametrize("body", [
    {"messages": []},
    {"messages": "not a list"},
    {"messages": [{"role": "user", "content": "x"}], "n": 2},
    {"model": "nope", "messages": [{"role": "user", "content": "x"}]},
    {"messages": [{"role": "user", "content": "x" * 300}]},  # no decode room
    [1, 2],
])
def test_chat_errors_same_envelope(apps, body):
    (js, jb), (ps, pb) = _both(apps, "POST", "/v1/chat/completions", body)
    assert ps == js and ps in (400, 404)
    assert pb == jb


@pytest.mark.parametrize("method,path", [
    ("GET", "/.well-known/alive"),
    ("GET", "/no/such/route"),
    ("DELETE", "/generate"),
    ("GET", "/v1/chat/completions"),
    ("OPTIONS", "/v1/models"),
])
def test_well_known_and_routing_same(apps, method, path):
    (js, jb), (ps, pb) = _both(apps, method, path)
    assert (ps, pb) == (js, jb)


def test_health_same_shape(apps):
    (js, jb), (ps, pb) = _both(apps, "GET", "/.well-known/health")
    assert js == ps == 200
    j, p = json.loads(jb)["data"], json.loads(pb)["data"]
    assert p["status"] == j["status"] == "UP"
    for d in (j, p):
        d["app"]["details"].pop("uptime_s")
    assert p["app"] == j["app"]
    # the engines' own counters differ; the datasource block's shape does not
    assert p["tpu"]["status"] == j["tpu"]["status"] == "UP"
    assert set(p["tpu"]["details"]) == set(j["tpu"]["details"])
    assert p["tpu"]["details"]["platform"] == j["tpu"]["details"]["platform"] == "cpu"


def test_sse_disconnect_frees_blocks(apps):
    """A client that hangs up after the first chunk: the server's abort
    closes the generator, the request ends with "disconnect" and the
    engine frees its blocks with no other traffic."""
    app = apps[1]
    eng = _engine(app)
    before = eng.stats()["disconnect_cancels"]
    body = json.dumps({"messages": [{"role": "user", "content": "go"}], "max_tokens": 200,
                       "stream": True}).encode()
    sock = socket.create_connection(("127.0.0.1", app.http_server.port), timeout=30)
    try:
        sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        got = b""
        while b"data: " not in got:
            chunk = sock.recv(4096)
            assert chunk, "server closed before the first chunk"
            got += chunk
    finally:
        sock.close()
    assert _wait(lambda: eng.stats()["disconnect_cancels"] == before + 1, 3.0)
    assert _wait(lambda: eng.stats()["kvcache"]["blocks_in_use"] == 0, 3.0)


@pytest.fixture
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for one test. Under a loaded
    CPU (the suite's pytest-xdist workers), an 8-thread pool spends most of
    its time in its barriers: a 4-token generate of the tiny model took
    ~6 s with 10 busy processes on 8 cores, against 0.03-0.07 s on one
    thread, which a 0.3 s handler timeout cannot absorb."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_handler_timeout_408_frees_the_slot(weights, one_torch_thread):
    """A 400-token request past the 0.3 s handler timeout answers 408; the
    engine retires it by its deadline and frees its blocks; the one slot
    then serves the next request within that timeout. The waits are for
    the events asserted, bounded generously: a loaded CPU delays the
    scheduler pass that retires the request, not its outcome."""
    _jcfg, _jp, tp = weights
    app = serve.build_app(new_mock_config({**PORT_CONFIG, "REQUEST_TIMEOUT": "0.3", "LLM_SLOTS": "1",
                                           "LLM_MAX_SEQ": "512"}), params=tp)
    th = app.run_in_background()
    try:
        eng = _engine(app)
        status, body = _call(app, "POST", "/generate", {"tokens": [5, 9, 2], "max_new_tokens": 400})
        assert status == 408 and json.loads(body) == {"error": {"message": "request timed out"}}
        assert _wait(lambda: eng.stats()["deadline_cancels"] == 1, 60.0)
        assert _wait(lambda: eng.stats()["kvcache"]["blocks_in_use"] == 0, 60.0)
        # the one slot serves the next request
        status, body = _call(app, "POST", "/generate", {"tokens": [1, 2], "max_new_tokens": 4})
        assert status == 201 and len(json.loads(body)["data"]["tokens"]) == 4
    finally:
        app.shutdown()
        th.join(timeout=10)
    assert not th.is_alive()


def test_register_llm_refuses_unported(weights):
    _jcfg, _jp, tp = weights
    from gofr_tpu_torch.datasource.gpu import GPURuntime

    cfg = TT.TransformerConfig.tiny()
    rt = GPURuntime(new_mock_config({"TORCH_DEVICE": "cpu"}))
    for kw in ({"mesh": object()}, {"meshes": [object()]}, {"tp_overlap": True}):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            rt.register_llm("m", cfg, tp, **kw)
    # the replica fleet is ported (refused before): replicas=2 builds one,
    # both replicas on the one device
    fleet = rt.register_llm("m", cfg, tp, replicas=2, slots=2, max_seq_len=64, warmup=False)
    try:
        assert type(fleet.engine).__name__ == "ReplicatedLLMEngine" and len(fleet.engines) == 2
        assert fleet.debug_state()["devices"]["home"] == ["cpu", "cpu"]
    finally:
        fleet.close()
    # the contiguous layouts and their whole-row prefix cache are ported
    # (the prefix cache raised before)
    eng = rt.register_llm("m", cfg, tp, kv_paged=False, prefix_cache_mb=1, slots=2, max_seq_len=64)
    try:
        assert eng.kv.prefix is not None and eng.stats()["kvcache"]["prefix"]["capacity_bytes"] == 1 << 20
    finally:
        eng.close()
    # the wave scheduler is ported: TPU_LLM_STEP_TOKEN_BUDGET=0 builds it;
    # since ROADMAP ID 19 the other budgets, TPU_LLM_PREFILL_CHUNK and
    # TPU_LLM_KV_BLOCK (refused before) build what the JAX runtime builds,
    # and a kwarg wins over its knob (setdefault)
    eng = GPURuntime(new_mock_config({"TORCH_DEVICE": "cpu", "TPU_LLM_STEP_TOKEN_BUDGET": "0"})).register_llm(
        "m", cfg, tp, slots=2, max_seq_len=64)
    try:
        assert eng.stats()["scheduler"] == "wave" and not eng.chunked and not eng.constrained
    finally:
        eng.close()
    from gofr_tpu.datasource.tpu import TPURuntime

    jcfg = weights[0]
    knobs = {"TPU_LLM_STEP_TOKEN_BUDGET": "128", "TPU_LLM_KV_BLOCK": "8", "TPU_LLM_PREFILL_CHUNK": "8"}
    for kw in ({}, {"kv_block": 32, "prefill_chunk": 16}):
        jrt = TPURuntime(jax_mock_config(knobs))
        try:
            ref = jrt.register_llm("m", jcfg, weights[1], warmup=False, slots=2, max_seq_len=64, **kw).engine
            eng = GPURuntime(new_mock_config({"TORCH_DEVICE": "cpu", **knobs})).register_llm(
                "m", cfg, tp, slots=2, max_seq_len=64, **kw)
            try:
                got = (eng.step_token_budget, eng.prefill_chunk, eng.chunk_shapes, eng.kv.block, eng.kv.table_width)
                assert got == (ref.step_token_budget, ref.prefill_chunk, ref.chunk_shapes, ref.kv.block,
                               ref.kv.table_width)
                assert got[:2] == (128, kw.get("prefill_chunk", 8)) and got[3] == kw.get("kv_block", 8)
            finally:
                eng.close()
        finally:
            jrt.close()
    # grammar-constrained decoding is ported: its knobs build an engine
    # that admits grammars (or refuses them with "0"); knobs of features
    # still unported keep refusing
    for value, on in (("1", True), ("0", False)):
        eng = GPURuntime(new_mock_config({"TPU_LLM_CONSTRAINED": value, "TPU_LLM_CONSTRAINED_GRAMMARS": "3"})
                         ).register_llm("m", cfg, tp, device="cpu", slots=2, max_seq_len=64)
        try:
            assert eng.constrained is on and eng._g_cap == 3 and bool(eng._programs_g) is on
        finally:
            eng.close()
    # (TPU_LLM_DISAGG is ported: tests/test_torch_disagg.py builds with it.)
    # The flight recorder and the anomaly detectors are ported (refused
    # before): their knobs build what the JAX runtime builds; tensor
    # parallelism stays refused
    eng = GPURuntime(new_mock_config({"TPU_LLM_FLIGHT_RECORDS": "2", "TPU_LLM_ANOMALY": "0"})).register_llm(
        "m", cfg, tp, device="cpu", slots=2, max_seq_len=64)
    try:
        assert eng.flightrec.capacity == 2 and eng.anomaly is None
    finally:
        eng.close()
    eng = GPURuntime(new_mock_config({"TPU_LLM_ANOMALY": "2", "TPU_LLM_FLIGHT_REDACT": "1",
                                      "TPU_LLM_WIDE_EVENT_SAMPLE": "4", "GOFR_BLACKBOX_INTERVAL_S": "7"})
                     ).register_llm("m", cfg, tp, device="cpu", slots=2, max_seq_len=64)
    try:
        assert eng.anomaly is not None and eng.flightrec.redact and eng._wide_sample == 4
        assert eng.blackbox.min_interval_s == 7.0 and not eng.blackbox.enabled()
    finally:
        eng.close()
    for knob in ("TPU_LLM_TP",):
        with pytest.raises(NotImplementedError, match=knob):
            GPURuntime(new_mock_config({knob: "2"})).register_llm("m", cfg, tp, device="cpu")
    # the LoRA pool is ported: its kwargs and knobs (defaults for kwargs
    # left out) build an engine with an adapter pool
    for knobs, kw, slots, rank in (({"TPU_LLM_LORA_SLOTS": "3", "TPU_LLM_LORA_RANK_MAX": "4"}, {}, 3, 4),
                                   ({"TPU_LLM_LORA_SLOTS": "3"}, {"lora_slots": 2}, 2, 8)):
        eng = GPURuntime(new_mock_config(knobs)).register_llm("m", cfg, tp, device="cpu", slots=2,
                                                               max_seq_len=64, **kw)
        try:
            st = eng.stats()["adapters"]
            assert (st["slots"], st["rank_max"]) == (slots, rank)
            assert eng.params["layers"]["lora_wq_a"].shape == (cfg.n_layers, slots + 1, cfg.d_model, rank)
        finally:
            eng.close()
    # the prefix cache and the session tier are ported: their knobs build an
    # engine with a radix (and, for sessions, a host tier of TPU_LLM_HOST_CACHE_MB)
    for knob, value in (("TPU_LLM_SESSION_MB", "64"), ("TPU_LLM_PREFIX_CACHE_MB", "8")):
        eng = GPURuntime(new_mock_config({knob: value, "TPU_LLM_HOST_CACHE_MB": "32"})).register_llm(
            "m", cfg, tp, device="cpu", slots=2, max_seq_len=64)
        try:
            kv = eng.stats()["kvcache"]
            assert eng.kv.radix is not None and kv["prefix"] is not None
            assert (kv["sessions"] is not None) == (knob == "TPU_LLM_SESSION_MB")
            if kv["sessions"] is not None:
                assert kv["sessions"]["offload"]["budget_bytes"] == 32 << 20
        finally:
            eng.close()
    if not torch.cuda.is_available():  # unset TORCH_DEVICE means cuda, never a quiet CPU run
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GPURuntime(new_mock_config({})).register_llm("m", cfg, tp)
    # TPU_LLM_KV_INT8 is read as the JAX runtime reads it
    eng = GPURuntime(new_mock_config({"TORCH_DEVICE": "cpu", "TPU_LLM_KV_INT8": "1"})).register_llm(
        "m", cfg, tp, slots=2, max_seq_len=64)
    try:
        assert eng.stats()["kvcache"]["int8"] is True and eng.device.type == "cpu"
    finally:
        eng.close()


def test_register_llm_builds_a_spec_engine(weights):
    """Speculation is ported: the kwargs and the TPU_LLM_SPEC /
    TPU_LLM_SPEC_DRAFT knobs (defaults for kwargs left out, as the JAX
    runtime reads them) build a speculating engine."""
    _jcfg, _jp, tp = weights
    from gofr_tpu_torch.datasource.gpu import GPURuntime

    cfg = TT.TransformerConfig.tiny()
    cases = (
        ({}, {"speculative": True}, 4),
        ({"TPU_LLM_SPEC": "1", "TPU_LLM_SPEC_DRAFT": "2"}, {}, 2),
        ({"TPU_LLM_SPEC": "1", "TPU_LLM_SPEC_DRAFT": "2"}, {"spec_draft": 3}, 3),
        ({"TPU_LLM_SPEC": "0"}, {}, 0),
    )
    for knobs, kw, draft in cases:
        eng = GPURuntime(new_mock_config({"TORCH_DEVICE": "cpu", **knobs})).register_llm(
            "m", cfg, tp, slots=2, max_seq_len=64, **kw)
        try:
            st = eng.stats()["spec"]
            assert st["enabled"] is (draft > 0) and st["draft"] == draft
            assert (f"llm.step_v{draft + 1}" in eng._programs) is (draft > 0)
        finally:
            eng.close()


def test_generate_with_spec_same_answer(weights):
    """/generate with TPU_LLM_SPEC=1 on both apps: the port's speculating
    engine answers what the JAX app's does."""
    jcfg, jp, tp = weights
    example = _example_module()
    japp = gofr_tpu.new(config=jax_mock_config({
        **COMMON, "METRICS_PORT": "0", "TRACE_EXPORTER": "none", "TPU_LLM_SPEC": "1",
    }))
    japp.container.tpu().register_llm(
        "gemma", jcfg, jp, warmup=False, kv_paged=True,
        slots=SLOTS, max_seq_len=MAX_SEQ, prefill_buckets=(16, 64, 128),
    )
    japp.post("/generate", example.generate)
    papp = serve.build_app(new_mock_config({**PORT_CONFIG, "TPU_LLM_SPEC": "1"}), params=tp)
    threads = [japp.run_in_background(), papp.run_in_background()]
    try:
        for tokens in (([5, 6, 7, 8] * 8)[:20], _prompt(4, 11)):
            (js, jb), (ps, pb) = _both((japp, papp), "POST", "/generate", {"tokens": tokens, "max_new_tokens": 24})
            assert (js, ps) == (201, 201) and pb == jb
        st = _engine(papp).stats()["spec"]
        assert _engine(japp).stats()["spec"]["enabled"] and st["enabled"] and st["steps"] > 0
    finally:
        for app, th in zip((japp, papp), threads):
            app.shutdown()
            th.join(timeout=10)


# -- overload control at the edge ---------------------------------------------

def _call_h(app, method, path, body=None, headers=None):
    """_call, with the response headers."""
    conn = http.client.HTTPConnection("127.0.0.1", app.http_server.port, timeout=120)
    try:
        conn.request(method, path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _raw_engine(app):
    """The engine itself (the JAX runtime hands out a ModelHandle)."""
    h = _engine(app)
    return getattr(h, "engine", h)


OVERLOAD_BODIES = {
    "/generate": {"tokens": [5, 9, 2], "max_new_tokens": 8},
    "/v1/chat/completions": {"model": "gemma", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 8},
}


@pytest.mark.parametrize("path", sorted(OVERLOAD_BODIES))
@pytest.mark.parametrize("cause", ["max_queue", "predicted_wait"])
def test_overload_answers_429_with_retry_after(apps, path, cause):
    """A full queue and a predicted-wait shed answer 429 with a Retry-After
    header on both apps; the port's carries its predicted wait past the
    threshold (10 s - 1 s). Once the pressure is gone the queued request
    is served.

    The pressure is staged so that no engine thread can move it: the
    collector's throughput EMA (``_observe_tput``) is frozen, else a
    program still in flight rewrites the staged ``_tput_ema``; and the JAX
    engine, which serves its queued request meanwhile whatever ``_admit``
    is (load 20 -> 0 and the EMA rewritten within 0.5 s on the CPU), is
    priced on the load it had when the pressure was staged."""
    answers, queued = [], []
    for app in apps:
        eng = _raw_engine(app)
        eng._admit = lambda: False  # the queue only grows
        eng._observe_tput = lambda tokens, dt: None
        try:
            if cause == "max_queue":
                eng.max_queue = 0
            else:
                queued.append(eng.submit(type(eng).submit.__globals__["GenRequest"]([1, 2, 3], max_new_tokens=17)))
                load = eng.load_tokens()
                if app is apps[0]:
                    eng.load_tokens = lambda: load
                eng._tput_ema = load / 10.0  # a 10 s predicted wait
                eng.overload.shed_wait_s = 1.0
            status, headers, body = _call_h(app, "POST", path, OVERLOAD_BODIES[path])
            answers.append((status, headers.get("Retry-After")))
        finally:
            eng.max_queue = None
            eng.overload.shed_wait_s = 0.0
            eng._tput_ema = None
            eng.__dict__.pop("load_tokens", None)
            del eng._admit, eng._observe_tput
    (js, jra), (ps, pra) = answers
    assert js == ps == 429 and int(jra) >= 1, answers
    assert pra == ("9" if cause == "predicted_wait" else "1"), answers
    for r in queued:
        assert len(r.tokens(timeout=60)) == 17


def test_priority_and_client_headers_reach_ledger_and_preemption(apps):
    """X-GoFr-Priority: batch and X-GoFr-Client ride /generate into the
    engine: four batch requests from "bulk" fill the port's four slots, an
    interactive one from "web" takes a slot back, and every batch answer
    still equals the JAX app's; the ledger billed both clients."""
    import concurrent.futures

    japp, papp = apps
    eng = _raw_engine(papp)
    # long enough that no slot is near its end (virtually free) when the
    # interactive request arrives
    bodies = [{"tokens": _prompt(40 + i, 9 + 5 * i), "max_new_tokens": 128} for i in range(SLOTS)]
    want = [json.loads(_call(japp, "POST", "/generate", b)[1])["data"]["tokens"] for b in bodies]
    before = eng.preemptions
    process = eng._process_entry
    go = threading.Event()
    go.set()

    def slow(entry):
        go.wait(timeout=10)
        time.sleep(0.01)
        return process(entry)

    eng._process_entry = slow
    try:
        batch = {"X-GoFr-Priority": "batch", "X-GoFr-Client": "bulk"}
        with concurrent.futures.ThreadPoolExecutor(SLOTS + 1) as ex:
            futs = [ex.submit(_call_h, papp, "POST", "/generate", b, batch) for b in bodies]
            assert _wait(lambda: sum(r is not None and r.emitted > 0 for r in eng._slot_req) == SLOTS, 30)
            go.clear()  # the batch requests stay mid-stream while the interactive one arrives
            inter = ex.submit(_call_h, papp, "POST", "/generate", {"tokens": [3, 1, 4], "max_new_tokens": 4},
                              {"X-GoFr-Client": "web"})
            assert _wait(lambda: eng.preemptions > before, 10)
            go.set()
            status, _h, body = inter.result(timeout=60)
            assert status == 201 and len(json.loads(body)["data"]["tokens"]) == 4
            got = [f.result(timeout=60) for f in futs]
    finally:
        go.set()
        del eng._process_entry
    assert [s for s, _h, _b in got] == [201] * SLOTS
    assert [json.loads(b)["data"]["tokens"] for _s, _h, b in got] == want
    counters = eng.stats()["fairness"]["counters"]
    assert counters["bulk"] > counters["web"] > 0


def test_register_llm_overload_kwargs_and_knobs(weights):
    """register_llm takes the overload kwargs; TPU_LLM_FAIR, _PREEMPT,
    _SHED_WAIT_S and _BROWNOUT_* set the engine's defaults (a kwarg wins);
    TPU_LLM_TENANT_QUOTA_TOK_S (the JAX engine's quota gate, refused before
    it was ported) sets the tenants' quotas, and a tenant past its quota is
    shed with a priced Retry-After."""
    _jcfg, _jp, tp = weights
    from gofr_tpu_torch.datasource.gpu import GPURuntime
    from gofr_tpu_torch.llm import EngineOverloaded
    from gofr_tpu_torch.resilience import FairLedger

    cfg = TT.TransformerConfig.tiny()
    shared = FairLedger({"paid": 4.0})
    knobs = {"TORCH_DEVICE": "cpu", "TPU_LLM_FAIR": "0", "TPU_LLM_PREEMPT": "0", "TPU_LLM_SHED_WAIT_S": "5",
             "TPU_LLM_BROWNOUT_WAIT_S": "2", "TPU_LLM_BROWNOUT_MAX_NEW": "16", "TPU_LLM_BROWNOUT_HOLD_S": "0.5"}
    cases = (
        ({"TORCH_DEVICE": "cpu"}, {}, (True, True, 0.0, 0.0, 0, 2.0, None, None)),
        (knobs, {}, (False, False, 5.0, 2.0, 16, 0.5, None, None)),
        (knobs, {"fair_ledger": shared, "fair_queuing": True, "preemption": True, "max_queue": 8,
                 "ttft_deadline_ms": 250, "brownout_max_new": 4}, (True, True, 5.0, 2.0, 4, 0.5, 8, 0.25)),
    )
    for config, kw, want in cases:
        eng = GPURuntime(new_mock_config(config)).register_llm("m", cfg, tp, slots=2, max_seq_len=64, **kw)
        try:
            o = eng.overload
            got = (eng.ledger is not None, eng.preemption, o.shed_wait_s, o.brownout_wait_s, o.brownout_max_new,
                   o.brownout_hold_s, eng.max_queue, eng.ttft_deadline)
            assert got == want, (config, kw)
            if "fair_ledger" in kw:
                assert eng.ledger is shared
        finally:
            eng.close()
    eng = GPURuntime(new_mock_config({"TORCH_DEVICE": "cpu", "TPU_LLM_TENANT_QUOTA_TOK_S": "acme=0.01,x=y"})
                     ).register_llm("m", cfg, tp, slots=2, max_seq_len=64)
    try:
        assert eng.quota.snapshot() == {"quotas_tok_s": {"acme": 0.01}}
        assert len(eng.generate([1, 2, 3, 4], max_new_tokens=4, client="acme")) == 4
        with pytest.raises(EngineOverloaded, match="TPU_LLM_TENANT_QUOTA_TOK_S") as ei:
            eng.generate([1, 2, 3, 4], max_new_tokens=4, client="acme")
        assert ei.value.retry_after >= 0.25 and eng.stats()["quota"]["sheds"] == 1
        assert len(eng.generate([1, 2, 3, 4], max_new_tokens=4, client="other")) == 4
    finally:
        eng.close()


# -- LoRA adapters at the edge: X-GoFr-Adapter, model=<adapter>, /v1/models ----


@pytest.fixture(scope="module")
def lora_apps(weights):
    """Both apps over engines with a LoRA pool of 2 and the same adapter
    ("tenant", drawn by gofr_tpu.lora.init_adapter) loaded."""
    from gofr_tpu import lora as JL

    jcfg, jp, tp = weights
    adapter = jax.tree.map(np.asarray, JL.init_adapter(jax.random.PRNGKey(7), jcfg, rank=4, scale=1.0))
    example = _example_module()
    japp = gofr_tpu.new(config=jax_mock_config({**COMMON, "METRICS_PORT": "0", "TRACE_EXPORTER": "none"}))
    japp.container.tpu().register_llm(
        "gemma", jcfg, jp, warmup=False, kv_paged=True, lora_slots=2,
        slots=SLOTS, max_seq_len=MAX_SEQ, prefill_buckets=(16, 64, 128),
    )
    japp.post("/generate", example.generate)
    jax_openai_routes(japp, model="gemma", tokenizer=JByteTokenizer(jcfg.vocab_size))
    papp = serve.build_app(new_mock_config({**PORT_CONFIG, "TPU_LLM_LORA_SLOTS": "2"}), params=tp)
    for app in (japp, papp):
        _raw_engine(app).load_adapter("tenant", adapter)
    threads = [japp.run_in_background(), papp.run_in_background()]
    yield japp, papp
    for app, th in zip((japp, papp), threads):
        app.shutdown()
        th.join(timeout=10)
        assert not th.is_alive()


CHAT = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 8}


def _answers(apps, method, path, body=None, headers=None):
    out = []
    for app in apps:
        status, raw = _call(app, method, path, body, headers)
        out.append((status, json.loads(raw)))
    return out


@pytest.mark.parametrize("path", ["/generate", "/v1/chat/completions"])
def test_adapter_header_same_answers(lora_apps, path):
    """X-GoFr-Adapter selects the adapter on both apps: the same tokens,
    which differ from the base's."""
    body = {"tokens": _prompt(31, 9), "max_new_tokens": 10} if path == "/generate" else {"model": "gemma", **CHAT}
    (js, j), (ps, p) = _answers(lora_apps, "POST", path, body, {"X-GoFr-Adapter": "tenant"})
    (_bs, jb), (_pbs, pb) = _answers(lora_apps, "POST", path, body)
    assert js == ps in (200, 201) and _strip(p) == _strip(j)
    assert _strip(pb) == _strip(jb) and _strip(p) != _strip(pb)
    if path == "/v1/chat/completions":
        assert p["model"] == "gemma"  # selected by header: the model field named the base


def test_adapter_model_name_same_answers(lora_apps):
    """model=<adapter> routes to its base with the adapter selected, and
    the answer echoes the adapter's name, plain and as SSE; the explicit
    header wins over the model name."""
    (js, j), (ps, p) = _answers(lora_apps, "POST", "/v1/chat/completions", {"model": "tenant", **CHAT})
    assert js == ps == 200 and _strip(p) == _strip(j) and p["model"] == "tenant"
    (_s, by_header) = _answers(lora_apps, "POST", "/v1/chat/completions", {"model": "gemma", **CHAT},
                               {"X-GoFr-Adapter": "tenant"})[1]
    assert by_header["choices"] == p["choices"]
    (js, jb), (ps, pb) = _both(lora_apps, "POST", "/v1/chat/completions", {"model": "tenant", **CHAT, "stream": True})
    assert js == ps == 200 and _sse_events(pb) == _sse_events(jb)
    assert _sse_events(pb)[0]["model"] == "tenant"


def test_models_list_adapters_beside_base(lora_apps):
    (js, j), (ps, p) = _answers(lora_apps, "GET", "/v1/models")
    assert js == ps == 200 and p == j
    assert [(m["id"], m.get("parent")) for m in p["data"]] == [("gemma", None), ("tenant", "gemma")]


@pytest.mark.parametrize("how", ["generate_header", "chat_header", "chat_model"])
def test_unknown_adapter_same_status(lora_apps, how):
    """An adapter nobody loaded answers 404 on both apps."""
    if how == "generate_header":
        args = ("/generate", {"tokens": [1, 2, 3], "max_new_tokens": 4}, {"X-GoFr-Adapter": "ghost"})
    elif how == "chat_header":
        args = ("/v1/chat/completions", CHAT, {"X-GoFr-Adapter": "ghost"})
    else:
        args = ("/v1/chat/completions", {"model": "ghost", **CHAT}, None)
    (js, j), (ps, p) = _answers(lora_apps, "POST", *args)
    assert js == ps == 404, (j, p)
    if how != "generate_header":
        assert p == j


def test_slo_knobs_engage_a_tracker_like_jax(weights, monkeypatch):
    """Queue 3 item 33: ``TPU_LLM_SLO_TTFT_MS`` (and its siblings) in the
    config build an SLO tracker on the engine ``register_llm`` returns,
    with the JAX runtime's policy; the process env does the same on a bare
    engine; an explicit ``slo=`` wins over the config."""
    from gofr_tpu.datasource.tpu import TPURuntime
    from gofr_tpu.llm import LLMEngine as JEngine
    from gofr_tpu_torch.datasource.gpu import GPURuntime
    from gofr_tpu_torch.llm import LLMEngine

    jcfg, jp, tp = weights
    cfg = TT.TransformerConfig.tiny()
    knobs = {"TPU_LLM_SLO_TTFT_MS": "100"}
    jrt = TPURuntime(jax_mock_config({**knobs, "TPU_TELEMETRY_INTERVAL_S": "0"}))
    trt = GPURuntime(new_mock_config({**knobs, "TORCH_DEVICE": "cpu", "TPU_TELEMETRY_INTERVAL_S": "0"}))
    jh = jrt.register_llm("m", jcfg, jp, slots=2, max_seq_len=64, warmup=False)
    th = trt.register_llm("m", cfg, tp, slots=2, max_seq_len=64)
    try:
        assert jh.engine.slo is not None and th.engine.slo is not None
        assert th.engine.slo.policy.to_dict() == jh.engine.slo.policy.to_dict() == {
            "ttft_ms": 100.0, "tpot_ms": None, "availability": None}
        assert len(th.generate([1, 2, 3], max_new_tokens=4)) == 4
        assert th.engine.slo.snapshot()["total"] == 1
    finally:
        jh.close()
        th.close()
    th = trt.register_llm("m2", cfg, tp, slots=2, max_seq_len=64, slo={"tpot_ms": 7})
    try:
        assert th.engine.slo.policy.to_dict() == {"ttft_ms": None, "tpot_ms": 7.0, "availability": None}
    finally:
        th.close()
        trt.close()
        jrt.close()
    monkeypatch.setenv("TPU_LLM_SLO_TTFT_MS", "100")
    je = JEngine(jcfg, jp, slots=2, max_seq_len=64, warmup=False)
    te = LLMEngine(cfg, tp, device="cpu", slots=2, max_seq_len=64)
    try:
        assert te.slo is not None and te.slo.policy.to_dict() == je.slo.policy.to_dict()
    finally:
        je.close()
        te.close()
