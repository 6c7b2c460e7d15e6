"""The port's session tier (gofr_tpu_torch.kvcache.sessions and the
engine's X-GoFr-Session turns) against gofr_tpu's on the CPU: the same
bookkeeping op sequences give the same answers and stats; a second turn
block-shares the first, a spilled session restores byte-identically (its
greedy continuation equals JAX's), a finished turn keeps its blocks until
it is published, and two turns over HTTP equal the JAX app's."""

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
from gofr_tpu.config import new_mock_config as jax_mock_config
from gofr_tpu.kvcache import sessions as JS
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch import serve
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.kvcache import sessions as TS
from gofr_tpu_torch.llm import GenRequest, LLMEngine
from gofr_tpu_torch.models import transformer as TT

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE_KW = dict(slots=2, max_seq_len=96, prefill_buckets=(8, 32))  # tests/test_sessions.py's engine


@pytest.fixture(scope="module")
def weights():
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    # untied random head: the tied tiny model repeats its input token
    jp = dict(jp, unembed=jax.random.normal(
        jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32
    ))
    tcfg = TT.TransformerConfig.tiny()
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


class _Pins:
    """The two radix methods the session store calls."""

    def __init__(self):
        self.pins: dict[int, int] = {}

    def pin(self, node):
        self.pins[node] = self.pins.get(node, 0) + 1

    def unpin(self, node):
        self.pins[node] = max(0, self.pins.get(node, 0) - 1)


@pytest.mark.parametrize("seed", range(4))
def test_session_store_and_offload_ops_match_jax(seed):
    """Publishes, spill candidates (with exclusions), spills, host-budget
    expiry, fetches, drops and forgets in one seeded order on JAX's
    SessionStore/HostOffload and the port's: same answers, pins and stats
    after every op."""
    rng = np.random.default_rng(seed)
    sides = [(mod.SessionStore(3000, mod.HostOffload(2500)), _Pins()) for mod in (JS, TS)]
    for step in range(80):
        op = rng.choice(["publish", "publish", "spill", "fetch", "drop", "forget", "store"])
        sid = f"s{int(rng.integers(0, 6))}"
        node = int(rng.integers(1, 9))
        nbytes = int(rng.integers(100, 1500))
        exclude = {f"s{int(rng.integers(0, 6))}"}
        results = []
        for store, radix in sides:
            if op == "publish":
                store.publish(sid, list(range(node)), node, (node,), nbytes, radix)
                results.append(None)
            elif op == "spill":
                cands = store.spill_candidates(exclude)
                for s in cands:
                    store.mark_spilled(s.id, radix)
                    for dropped in store.offload.store(s.id, {"n": s.id}, nbytes):
                        store.forget(dropped, radix)
                results.append([s.id for s in cands])
            elif op == "fetch":
                results.append(store.offload.fetch(sid))
            elif op == "drop":
                store.offload.drop(sid)
                results.append(None)
            elif op == "forget":
                store.forget(sid, radix)
                results.append(None)
            else:
                results.append(store.offload.store(sid, {"n": sid}, nbytes * 2))
        assert results[0] == results[1], (step, op, results)
        (js, jr), (ts, tr) = sides
        assert js.stats() == ts.stats(), (step, op)
        assert jr.pins == tr.pins
        assert {k: (s.state, s.tokens, s.turns, s.device_bytes) for k, s in js.entries.items()} == {
            k: (s.state, s.tokens, s.turns, s.device_bytes) for k, s in ts.entries.items()
        }
    assert ts.publishes and ts.offload.spills


def _turns(eng, Req, turn1, *, spill: bool, n=6):
    """Turn 1, its publish, optionally a forced spill (device budget 1, as
    tests/test_sessions.py does), then turn 2 = turn 1 + its tokens + 2
    new ones. Returns (t1, t2, the session and prefix stats once turn 2 is
    published)."""
    t1 = eng.submit(Req(turn1, max_new_tokens=n, session_id="conv")).tokens()
    assert _wait(lambda: eng.kv.sessions.stats()["publishes"] == 1), eng.kv.sessions.stats()
    if spill:
        eng.kv.sessions.device_budget = 1
        eng._kick.set()
        assert _wait(lambda: eng.kv.sessions.stats()["spilled"] == 1), eng.kv.sessions.stats()
        assert eng.kv.sessions.offload.stats()["spilled_bytes"] > 0
        eng.kv.sessions.device_budget = 16 * 1024 * 1024
    t2 = eng.submit(Req(turn1 + t1 + [40, 41], max_new_tokens=n, session_id="conv")).tokens()
    published = 2 + spill  # a restore re-publishes
    assert _wait(lambda: eng.kv.sessions.stats()["publishes"] == published), eng.kv.sessions.stats()
    st = eng.stats()["kvcache"]
    return t1, t2, st["sessions"], st["prefix"]


SESSION_MODES = {"la1": dict(lookahead=1), "la3": dict(lookahead=3), "int8": dict(lookahead=3, kv_int8=True)}


@pytest.mark.parametrize("mode", list(SESSION_MODES))
def test_spilled_session_restores_token_identical_to_jax(weights, mode):
    """tests/test_sessions.py's roundtrip: the cold session spills to the
    host tier and restores on turn 2; both turns' tokens and the session
    and prefix counters equal JAX's, and no pin leaks."""
    from test_torch_prefix import _assert_no_leaked_pins

    jcfg, jp, tcfg, tp = weights
    kw = SESSION_MODES[mode]
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, session_mb=16.0, kv_int8=kw.get("kv_int8", False),
                  **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", session_mb=16.0, **kw, **ENGINE_KW)
    try:
        turn1 = list(range(1, 25))
        want = _turns(ref, JRequest, turn1, spill=True)
        got = _turns(port, GenRequest, turn1, spill=True)
        assert got == want
        assert got[2]["offload"]["restores"] == 1 and got[3]["partial_hits"] >= 1
        _assert_no_leaked_pins(port)
    finally:
        ref.close()
        port.close()


def test_second_turn_shares_the_first_as_jax(weights):
    """No spill: turn 2 finds the session resident (a resume) and
    block-shares its history; tokens and counters equal JAX's."""
    jcfg, jp, tcfg, tp = weights
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, session_mb=16.0, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", session_mb=16.0, **ENGINE_KW)
    try:
        turn1 = list(range(3, 40))
        want = _turns(ref, JRequest, turn1, spill=False, n=9)
        got = _turns(port, GenRequest, turn1, spill=False, n=9)
        assert got == want and got[2]["resumes"] == 1 and got[3]["partial_hits"] == 1
    finally:
        ref.close()
        port.close()


def test_finished_turn_keeps_its_blocks_until_published(weights):
    """A session turn that ended by length holds its blocks (its slot table
    still owned by it) until the scheduler's flush has published it; then
    the sweep frees them and the radix holds the conversation."""
    _jcfg, _jp, tcfg, tp = weights
    with LLMEngine(tcfg, tp, device="cpu", session_mb=16.0, **ENGINE_KW) as eng:
        flush = eng._kv_session_flush
        eng._kv_session_flush = lambda: None
        r = eng.submit(GenRequest(list(range(5, 30)), max_new_tokens=7, session_id="a"))
        assert len(r.tokens()) == 7 and r.finish_reason == "length"
        time.sleep(0.05)
        assert eng.kv.slot_owner(r.slot) is r and not r._session_published
        assert eng.stats()["kvcache"]["blocks_in_use"] > eng.kv.held_blocks()
        eng._kv_session_flush = flush
        eng._kick.set()
        assert _wait(lambda: eng.kv.sessions.stats()["publishes"] == 1)
        assert _wait(lambda: eng.kv.slot_owner(r.slot) is None)
        # prompt (25) + emitted but the last (6) = 31 rows: one full block + a copied tail
        assert eng.kv.sessions.stats()["resident_bytes"] == 2 * eng.kv.block_bytes


def _example_module():
    spec = importlib.util.spec_from_file_location("grpc_gemma_main", ROOT / "examples/grpc-gemma/main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _call(app, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", app.http_server.port, timeout=120)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_http_session_turns_match_the_jax_app(weights):
    """TPU_LLM_SESSION_MB on both apps' config; two POST /generate turns
    carrying X-GoFr-Session over real sockets: the same tokens, and the
    port's /stats shows the resume."""
    jcfg, jp, _tcfg, tp = weights
    common = {"HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "30", "LOG_LEVEL": "ERROR", "TPU_LLM_SESSION_MB": "16"}
    japp = gofr_tpu.new(config=jax_mock_config({**common, "METRICS_PORT": "0", "TRACE_EXPORTER": "none"}))
    japp.container.tpu().register_llm("gemma", jcfg, jp, warmup=False, kv_paged=True, slots=4, max_seq_len=256,
                                      prefill_buckets=(16, 64, 128))
    example = _example_module()
    japp.post("/generate", example.generate)
    japp.get("/stats", example.engine_stats)
    papp = serve.build_app(new_mock_config({
        **common, "GEMMA_PRESET": "tiny", "TORCH_DEVICE": "cpu", "LLM_SLOTS": "4", "LLM_MAX_SEQ": "256",
    }), params=tp)
    threads = [japp.run_in_background(), papp.run_in_background()]
    try:
        turn1 = np.random.default_rng(4).integers(1, 512, 30).tolist()
        answers = []
        for app in (japp, papp):
            hdr = {"X-GoFr-Session": "chat-1"}
            s1, b1 = _call(app, "POST", "/generate", {"tokens": turn1, "max_new_tokens": 8}, hdr)
            t1 = b1["data"]["tokens"]
            assert s1 == 201 and _wait(
                lambda: _call(app, "GET", "/stats")[1]["data"]["kvcache"]["sessions"]["publishes"] == 1)
            s2, b2 = _call(app, "POST", "/generate", {"tokens": turn1 + t1 + [9, 10], "max_new_tokens": 8}, hdr)
            assert s2 == 201
            kv = _call(app, "GET", "/stats")[1]["data"]["kvcache"]
            answers.append((t1, b2["data"]["tokens"], kv["sessions"]["resumes"], kv["prefix"]["partial_hits"]))
        assert answers[0] == answers[1]
        assert answers[1][2] >= 1 and answers[1][3] >= 1
    finally:
        for app, th in zip((japp, papp), threads):
            app.shutdown()
            th.join(timeout=10)


def test_session_leaf_is_pinned_before_the_retention_eviction(weights):
    """A retention budget (prefix_cache_mb) smaller than the sessions'
    pinned bytes: each turn's new leaf is pinned before the capacity
    eviction runs, so it stays in the tree with live blocks (the JAX tree
    pins after the eviction, evicts the fresh leaf and leaves the session
    a detached node over free blocks, on which a spill fails). Four
    sessions then spill and one restores; the engine stays up and its
    tokens are the unshared engine's."""
    _jcfg, _jp, tcfg, tp = weights
    prompts = [list(range(10 + i, 40 + i)) for i in range(4)]
    with LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW) as plain:
        t1 = [plain.generate(p, max_new_tokens=6) for p in prompts]
        want2 = plain.generate(prompts[3] + t1[3] + [7, 8], max_new_tokens=6)
    with LLMEngine(tcfg, tp, device="cpu", prefix_cache_mb=0.02, session_mb=1.0, **ENGINE_KW) as eng:
        for i, p in enumerate(prompts):
            assert eng.submit(GenRequest(p, max_new_tokens=6, session_id=f"s{i}")).tokens() == t1[i]
            assert _wait(lambda: eng.kv.sessions.stats()["publishes"] == i + 1)
        for i in range(4):
            node = eng.kv.sessions.get(f"s{i}").node
            assert node.parent.children.get(node.tokens[:16]) is node and (eng.kv.pool.refs[node.blocks] > 0).all()
        assert eng.kv.radix.evictions > 0  # the budget did evict: the unpinned prompt leaves
        eng.kv.sessions.device_budget = 1
        eng._kick.set()
        assert _wait(lambda: eng.kv.sessions.stats()["spilled"] == 4), (eng.stats()["error"], eng.kv.sessions.stats())
        eng.kv.sessions.device_budget = 1 << 20
        r = eng.submit(GenRequest(prompts[3] + t1[3] + [7, 8], max_new_tokens=6, session_id="s3"))
        assert r.tokens() == want2 and eng.stats()["error"] is None
        assert eng.kv.sessions.offload.stats()["restores"] == 1
