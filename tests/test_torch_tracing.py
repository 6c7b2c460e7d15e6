"""gofr_tpu_torch.tracing and the port's spans and journeys against
gofr_tpu.tracing and the JAX engine's (CPU, f32 tiny preset, greedy,
lookahead 1, ``device="cpu"``).

Held equal: the span tree of the same requests (span names, parent links
and attribute keys; times are not compared), a ``traceparent`` arriving
over HTTP and over gRPC as the request span's ancestor, the Zipkin and
OTLP-HTTP bodies the exporters post for the same fixed-id spans (to a
local ``http.server``), ``RingExporter.query`` / ``trace_ids`` and
``stitch_spans`` on the same span dicts, a failed-over request's journey
(``journey_id`` is the first trace's id; the hop count equals the JAX
fleet's), and the flight records' ``trace_id`` / ``journey_id``."""

import http.client
import http.server
import json
import threading
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gofr_tpu
from gofr_tpu import tracing as JTR
from gofr_tpu.config import new_mock_config as jax_mock_config
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.llm import ReplicatedLLMEngine as JFleet
from gofr_tpu.models import transformer as JT
from gofr_tpu.resilience import FaultInjector as JInjector
from gofr_tpu_torch import serve
from gofr_tpu_torch import tracing as TTR
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.llm import GenRequest, LLMEngine, ReplicatedLLMEngine
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.resilience import FaultInjector

ENGINE_KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8, 16), lookahead=1)
# the fleet tests' shape: small chunks, so a stream spans many passes
FLEET_KW = dict(slots=2, max_seq_len=128, prefill_buckets=(8,), prefill_chunk=4, step_token_budget=4,
                decode_chunk=2, lookahead=1)
PROMPT = [5, 9, 2, 11, 7, 3, 13, 1, 4, 6, 8, 10, 12, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24]


@pytest.fixture(scope="module")
def weights():
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    tcfg = TT.TransformerConfig.tiny()
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _tree(ring, trace_id: str) -> Counter:
    """A trace's spans as (name, parent's name, attribute keys), counted."""
    spans = ring.query(trace_id)
    by_id = {s["span_id"]: s for s in spans}
    return Counter(
        (s["name"], by_id[s["parent_id"]]["name"] if s.get("parent_id") in by_id else None,
         tuple(sorted(s["attributes"])))
        for s in spans
    )


def test_span_trees_equal_jax(weights):
    jcfg, jp, tcfg, tp = weights
    jtr = JTR.Tracer("t", None, JTR.RingExporter(4096))
    ttr = TTR.Tracer("t", None, TTR.RingExporter(4096))
    je = JEngine(jcfg, jp, warmup=False, tracer=jtr, **ENGINE_KW)
    te = LLMEngine(tcfg, tp, device="cpu", tracer=ttr, **ENGINE_KW)
    try:
        for n, new in ((3, 4), (17, 9), (33, 1), (9, 12)):
            prompt = list(range(1, n + 1))
            jr, tr = je.submit(JRequest(prompt, max_new_tokens=new)), te.submit(GenRequest(prompt, max_new_tokens=new))
            assert tr.tokens() == jr.tokens()
            assert tr.journey_id == tr.span.trace_id and tr.span.parent_id is None
            got, want = _tree(ttr.ring, tr.span.trace_id), _tree(jtr.ring, jr.span.trace_id)
            assert got == want, (n, new)
            assert sum(c for (name, _p, _a), c in got.items() if name == "llm.request") == 1
            # every child lies inside its request span
            spans = ttr.ring.query(tr.span.trace_id)
            root = next(s for s in spans if s["name"] == "llm.request")
            for s in spans:
                if s is not root:
                    assert root["start_ns"] - 1_000_000 <= s["start_ns"] <= s["end_ns"] <= root["end_ns"] + 1_000_000
    finally:
        je.close()
        te.close()


def test_traceparent_on_the_request_and_the_thread(weights):
    """An explicit ``traceparent`` outranks the thread's span; without one,
    the submitting thread's active span parents ``llm.request``."""
    _j, _jp, tcfg, tp = weights
    ttr = TTR.Tracer("t", None, TTR.RingExporter(256))
    te = LLMEngine(tcfg, tp, device="cpu", tracer=ttr, **ENGINE_KW)
    try:
        tid, sid = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
        r = te.submit(GenRequest([1, 2, 3], max_new_tokens=2, traceparent=f"00-{tid}-{sid}-01"))
        r.tokens()
        assert (r.span.trace_id, r.span.parent_id, r.journey_id) == (tid, sid, tid)
        with ttr.start_span("caller") as parent:
            r = te.submit(GenRequest([1, 2, 3], max_new_tokens=2))
        r.tokens()
        assert (r.span.trace_id, r.span.parent_id) == (parent.trace_id, parent.span_id)
    finally:
        te.close()


def test_flight_records_carry_trace_and_journey(weights):
    """Item 29: the records' ``trace_id`` and ``journey_id`` are the
    request's, as JAX's are (empty without a tracer, in both)."""
    jcfg, jp, tcfg, tp = weights
    for traced in (False, True):
        jtr = JTR.Tracer("t", None, JTR.RingExporter(256)) if traced else None
        ttr = TTR.Tracer("t", None, TTR.RingExporter(256)) if traced else None
        je = JEngine(jcfg, jp, warmup=False, tracer=jtr, **ENGINE_KW)
        te = LLMEngine(tcfg, tp, device="cpu", tracer=ttr, **ENGINE_KW)
        try:
            jr = je.submit(JRequest([4, 5, 6], max_new_tokens=3))
            tr = te.submit(GenRequest([4, 5, 6], max_new_tokens=3))
            jr.tokens(), tr.tokens()
            jrec, trec = je.flightrec.get(jr.id), te.flightrec.get(tr.id)
            assert bool(trec["trace_id"]) == bool(jrec["trace_id"]) == traced
            assert trec["journey_id"] == trec["trace_id"] == (tr.span.trace_id if traced else "")
        finally:
            je.close()
            te.close()


def _fixed_spans(mod):
    """Three finished spans with fixed ids, times, attributes and a link."""
    a = mod.Span("llm.request", "0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331", None, None)
    b = mod.Span("llm.decode", a.trace_id, "00f067aa0ba902b7", a.span_id, None)
    c = mod.Span("llm.continuation", a.trace_id, "1122334455667788", a.span_id, None)
    for i, s in enumerate((a, b, c)):
        s.start_ns, s.end_ns = 1_700_000_000_000_000_000 + i * 1000, 1_700_000_000_000_500_000 + i * 1000
    a.attributes.update({"llm.model": "m", "llm.request_id": 7, "llm.prompt_tokens": 12})
    b.attributes.update({"llm.chunk": 8, "llm.active": 3})
    c.add_link(a.trace_id, a.span_id)
    c.set_status("ERROR")
    return [a, b, c]


class _Sink(http.server.BaseHTTPRequestHandler):
    bodies: list = []

    def do_POST(self):  # noqa: N802
        n = int(self.headers.get("Content-Length", 0))
        _Sink.bodies.append((self.path, self.headers.get("Content-Type"), json.loads(self.rfile.read(n))))
        self.send_response(202)
        self.end_headers()

    def log_message(self, *_a):
        pass


@pytest.fixture
def sink():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Sink)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    _Sink.bodies = []
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    th.join(timeout=5)


@pytest.mark.parametrize("kind", ["ZipkinExporter", "OTLPHTTPExporter"])
def test_exporter_bodies_equal_jax(sink, kind):
    for mod in (JTR, TTR):
        getattr(mod, kind)(f"{sink}/v1/x", "svc").export(_fixed_spans(mod))
    (jp, jct, jbody), (tpath, tct, tbody) = _Sink.bodies
    assert (tpath, tct) == (jp, jct) and tbody == jbody


def test_batch_processor_ships_through_new_tracer(sink):
    """``new_tracer`` from config: TRACE_EXPORTER=zipkin with TRACER_URL,
    the ring sized by TRACE_RING_SPANS; shutdown flushes the batch."""
    cfg = new_mock_config({"TRACE_EXPORTER": "zipkin", "TRACER_URL": f"{sink}/api/v2/spans",
                           "TRACE_RING_SPANS": "16", "APP_NAME": "svc"})
    tr = TTR.new_tracer(cfg)
    with tr.start_span("work"):
        pass
    tr.shutdown()
    assert [b[2][0]["name"] for b in _Sink.bodies] == ["work"] and tr.ring.stats() == {"spans": 0, "capacity": 16}
    assert TTR.new_tracer(new_mock_config({"TRACE_RING_SPANS": "0"})).ring is None


def test_ring_and_stitch_equal_jax():
    jring, tring = JTR.RingExporter(5, "svc"), TTR.RingExporter(5, "svc")
    for mod, ring in ((JTR, jring), (TTR, tring)):
        spans = _fixed_spans(mod)
        other = mod.Span("other", "f" * 32, "a" * 16, None, None)
        other.start_ns = other.end_ns = 5
        for s in spans + [other] * 3:
            ring.on_end(s)
    tid = "0af7651916cd43dd8448eb211c80319c"
    assert tring.query(tid) == jring.query(tid) and tring.query(tid.upper()) == jring.query(tid.upper())
    assert tring.trace_ids(8) == jring.trace_ids(8) and tring.dump(3) == jring.dump(3)
    assert tring.stats() == jring.stats() and len(tring) == 5
    dicts = [TTR.span_to_dict(s) for s in _fixed_spans(TTR)]
    dicts.append(dict(dicts[1], span_id="9" * 16, parent_id="missing0missing0", process="p2"))
    assert TTR.stitch_spans(dicts) == JTR.stitch_spans(dicts)
    assert tring.clear() == jring.clear() == 5


@pytest.mark.parametrize("bad", [None, "", "00-abc-def-01", "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
                                 "00-" + "g" * 32 + "-" + "1" * 16 + "-01", "00-" + "A" * 32 + "-" + "B" * 16 + "-01"])
def test_parse_traceparent_equals_jax(bad):
    assert TTR.parse_traceparent(bad) == JTR.parse_traceparent(bad)


def test_failover_journey_equals_jax_fleet(weights):
    """A stream killed mid-decode on replica 0 resumes on replica 1 in the
    same trace: one llm.request span, one llm.continuation hop; the
    journey id is the first trace's id, as in the JAX fleet."""
    jcfg, jp, tcfg, tp = weights
    out = {}
    for name in ("jax", "port"):
        if name == "jax":
            inj, tr = JInjector(), JTR.Tracer("t", None, JTR.RingExporter(4096))
            rep = JFleet(jcfg, jp, replicas=2, fault_injector=inj, supervise=False, tracer=tr, warmup=False,
                         **FLEET_KW)
            R = JRequest
        else:
            inj, tr = FaultInjector(), TTR.Tracer("t", None, TTR.RingExporter(4096))
            rep = ReplicatedLLMEngine(tcfg, tp, replicas=2, fault_injector=inj, supervise=False, tracer=tr,
                                      device="cpu", **FLEET_KW)
            R = GenRequest
        try:
            req = rep.engines[0].submit(R(list(PROMPT), max_new_tokens=24))
            first_trace = req.span.trace_id
            got = []
            for t in req.stream(timeout=60):
                got.append(t)
                if len(got) == 1:
                    inj.arm("replica_kill", label="/r0")
            names = Counter(s["name"] for s in tr.ring.query(first_trace))
            out[name] = (got, req.journey_id == first_trace, req.hop, names["llm.request"],
                         names["llm.continuation"], req.retries)
        finally:
            rep.close()
    assert out["port"] == out["jax"]
    assert out["port"][1:] == (True, 1, 1, 1, 1)


def _http(port, method, path, headers=None, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def traced_apps(weights):
    jcfg, jp, _tcfg, tp = weights
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("grpc_gemma_main", root / "examples/grpc-gemma/main.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    common = {"HTTP_PORT": "0", "REQUEST_TIMEOUT": "30", "LOG_LEVEL": "ERROR"}
    japp = gofr_tpu.new(config=jax_mock_config({**common, "METRICS_PORT": "0", "TRACE_EXPORTER": "none"}))
    japp.container.tpu().register_llm("gemma", jcfg, jp, warmup=False, kv_paged=True, slots=4, max_seq_len=256,
                                      prefill_buckets=(16, 64, 128))
    japp.post("/generate", example.generate)
    papp = serve.build_app(new_mock_config({**common, "GEMMA_PRESET": "tiny", "TORCH_DEVICE": "cpu",
                                            "LLM_SLOTS": "4", "LLM_MAX_SEQ": "256", "GRPC_PORT": "0"}), params=tp)
    threads = [japp.run_in_background(), papp.run_in_background()]
    yield japp, papp
    for app, th in zip((japp, papp), threads):
        app.shutdown()
        th.join(timeout=10)


def _ancestry(ring, trace_id: str) -> list[str]:
    """Names from the llm.request span up to the trace's root."""
    spans = {s["span_id"]: s for s in ring.query(trace_id)}
    s = next(s for s in spans.values() if s["name"] == "llm.request")
    names = []
    while s is not None:
        names.append(s["name"])
        parent = s.get("parent_id")
        names_parent = spans.get(parent)
        if names_parent is None:
            names.append(f"parent:{parent}")
        s = names_parent
    return names


def test_http_traceparent_becomes_the_ancestor_like_jax(traced_apps):
    tid, sid = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
    chains = []
    for app in traced_apps:
        status, headers, _body = _http(app.http_server.port, "POST", "/generate",
                                       {"traceparent": f"00-{tid}-{sid}-01"},
                                       {"tokens": [1, 2, 3], "max_new_tokens": 4})
        assert status == 201 and headers.get("X-Correlation-ID") == tid
        chains.append(_ancestry(app.container.tracer.ring, tid))
    assert chains[1] == chains[0] == ["llm.request", "POST /generate", f"parent:{sid}"]


def test_debug_traces_route_returns_the_tree(traced_apps):
    """``GET /.well-known/debug/traces?trace_id=`` answers the trace's span
    fragments (the same keys as JAX's route); without ``trace_id`` the
    recent summaries and the ring's occupancy."""
    tid = "5bf92f3577b34da6a3ce929d0e0e4737"
    outs = []
    for app in traced_apps:
        _http(app.http_server.port, "POST", "/generate", {"traceparent": f"00-{tid}-{'1' * 16}-01"},
              {"tokens": [4, 5, 6], "max_new_tokens": 3})
        status, _h, body = _http(app.http_server.port, "GET", f"/.well-known/debug/traces?trace_id={tid}")
        assert status == 200
        data = json.loads(body)["data"]
        outs.append(data)
        stitched = TTR.stitch_spans(data["spans"])
        assert stitched["span_count"] == data["span_count"] and len(stitched["roots"]) == 1
        status, _h, body = _http(app.http_server.port, "GET", "/.well-known/debug/traces?limit=4")
        assert set(json.loads(body)["data"]) == {"traces", "stats"}
    jd, td = outs
    assert set(td) == set(jd) == {"trace_id", "span_count", "spans"}
    assert Counter(s["name"] for s in td["spans"]) == Counter(s["name"] for s in jd["spans"])
    assert {k for s in td["spans"] for k in s} == {k for s in jd["spans"] for k in s}


def test_grpc_traceparent_becomes_the_ancestor(traced_apps):
    grpc = pytest.importorskip("grpc")
    _japp, papp = traced_apps
    tid, sid = "6bf92f3577b34da6a3ce929d0e0e4738", "00f067aa0ba902b8"
    with grpc.insecure_channel(f"127.0.0.1:{papp.grpc_server.port}") as ch:
        fn = ch.unary_unary("/Gemma/Generate", request_serializer=lambda b: b, response_deserializer=lambda b: b)
        out = json.loads(fn(json.dumps({"tokens": [1, 2, 3], "max_new_tokens": 4}).encode(), timeout=60,
                            metadata=(("traceparent", f"00-{tid}-{sid}-01"),)))
    assert len(out["tokens"]) == 4
    assert _ancestry(papp.container.tracer.ring, tid) == ["llm.request", "grpc/Gemma/Generate", f"parent:{sid}"]
