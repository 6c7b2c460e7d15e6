"""gofr_tpu_torch.goodput and the engine's chip-time accounting against
gofr_tpu.goodput and the JAX LLMEngine (CPU, f32 tiny presets with an
untied random head, greedy, ``device="cpu"``).

The units run on the same seeded inputs through both modules and must
agree exactly (quota specs, prefill splits, pooled snapshots, ledger
snapshots over seeded overlapping windows, usage windows and priced
Retry-Afters under one fake clock). The engine: conservation within 1%
on the pool, the slab and the ring; the lanes each seam hands the ledger,
summed per (request, class) over a burst at lookahead 1, equal to the JAX
engine's (exact); speculative rejects; adapter tenants; the preemption
and failover replays (the preemption's ``_replay_pos`` held against the
JAX engine's); the quota over the engine, the HTTP edge, the OpenAI edge
and ``register_adapter(quota=)``; the usage route's shape (its keys equal
JAX's); ``GOFR_OPENAI_USAGE_EXTRA``; the gauges zeroed at ``_die``; and
``goodput=False``."""

import http.client
import json
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import goodput as JG
from gofr_tpu import handler as JH
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.metrics import Manager as JManager
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch import goodput as TG
from gofr_tpu_torch import handler as TH
from gofr_tpu_torch import serve
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.llm import EngineOverloaded, GenRequest, LLMEngine, ReplicatedLLMEngine
from gofr_tpu_torch.lora import init_adapter
from gofr_tpu_torch.metrics import Manager
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.resilience import FaultInjector
from gofr_tpu_torch.resilience.rollout import ModelHandle

ENGINE_KW = dict(slots=4, max_seq_len=96, prefill_buckets=(8, 16, 32))
# layout -> (preset, kv_paged); the ring is tiny_mistral's window 8
LAYOUTS = {"pool": ("tiny", True), "slab": ("tiny", False), "ring": ("tiny_mistral", "auto")}
CONSERVATION = 0.01  # attributed + idle == wall, and per-tenant sums, within 1%


def _pair(name: str, seed: int = 0):
    jcfg, tcfg = getattr(JT.TransformerConfig, name)(), getattr(TT.TransformerConfig, name)()
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(seed + 100), (jcfg.vocab_size, jcfg.d_model),
                                            jnp.float32))
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def models():
    return {name: _pair(name) for name in ("tiny", "tiny_mistral")}


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _together(eng, R, prompts, news, **req_kw):
    """Every request admitted in one pass (either engine's drain held until
    the last submit), as tests/test_torch_knobs.py does."""
    name = "_drain_and_observe" if isinstance(eng, JEngine) else "_drain_submits"
    setattr(eng, name, lambda *a, **k: None)
    try:
        eng._run_on_scheduler(lambda: None)
        reqs = [eng.submit(R(p, max_new_tokens=n, **req_kw)) for p, n in zip(prompts, news)]
    finally:
        delattr(eng, name)
    return reqs, [r.tokens(timeout=120) for r in reqs]


def _quiet(eng, timeout: float = 20.0) -> None:
    t0 = time.perf_counter()
    while eng._inflight or eng._processing is not None:
        assert time.perf_counter() - t0 < timeout, "programs still in flight"
        time.sleep(0.002)


def _assert_billed(cum_chip_s: dict, chip: dict) -> None:
    """A tenant's meter equals its one request's ``_chip`` class by class,
    within the microsecond the meter's snapshot rounds each class to."""
    for c in set(cum_chip_s) | set(chip):
        assert abs(cum_chip_s.get(c, 0.0) - chip.get(c, 0.0)) <= 5e-7 + 1e-12, (c, cum_chip_s, chip)


def _record_lanes(eng) -> list:
    """Wrap the engine's ledger: every observation's (kind, lanes) copied
    before the ledger bills anonymous slack into them."""
    seen: list = []
    observe = eng.goodput.observe

    def recording(kind, t0, t1, lanes):
        lanes = [(r, dict(cl)) for r, cl in lanes]
        seen.append((kind, [(r, dict(cl)) for r, cl in lanes]))
        return observe(kind, t0, t1, lanes)

    eng.goodput.observe = recording
    return seen


def _lane_sums(seen, reqs) -> dict:
    """{(request index | None, class): tokens} over every observation."""
    index = {id(r): i for i, r in enumerate(reqs)}
    out: dict = {}
    for _kind, lanes in seen:
        for r, cl in lanes:
            key = None if r is None else index.get(id(r), "other")
            for c, n in cl.items():
                out[(key, c)] = out.get((key, c), 0) + n
    return out


# -- the units against JAX's ------------------------------------------------------

SPECS = [None, "", "acme=100", "acme=100, adapter:bob=2.5,*=7", "a=1,a=2", "bad,=3,x=y,z=-1,w=0,q=1e2",
         "tenant=with=eq=4"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_quota_spec_equals_jax(spec):
    assert TG.parse_quota_spec(spec) == JG.parse_quota_spec(spec)


def test_prefill_classes_equals_jax():
    for replay_pos in range(0, 40, 3):
        for pos in range(0, 40, 5):
            for n in (0, 1, 7, 16):
                assert TG.prefill_classes(replay_pos, pos, n) == JG.prefill_classes(replay_pos, pos, n)


def _fake_requests(rng, n):
    return [SimpleNamespace(probe=bool(rng.random() < 0.2), priority=str(rng.choice(["interactive", "batch"])),
                            client=str(rng.choice(["a", "b", "", "adapter:x"])), _chip={}) for _ in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_ledger_snapshots_equal_jax(seed):
    """The same seeded stream of overlapping windows (lookahead-style
    pipelining, gaps, anonymous slack, probes) through both ledgers: equal
    snapshots, per-request chip, usage windows and rendered metrics."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    ms = {"j": JManager(), "t": Manager()}
    JG.register_goodput_metrics(ms["j"])
    TG.register_goodput_metrics(ms["t"])
    usage = {"j": JG.UsageMeter(window_s=30, now_fn=clock), "t": TG.UsageMeter(window_s=30, now_fn=clock)}
    led = {"j": JG.GoodputLedger(ms["j"], "m", usage=usage["j"]), "t": TG.GoodputLedger(ms["t"], "m", usage=usage["t"])}
    reqs = {"j": _fake_requests(np.random.default_rng(seed + 50), 6)}
    reqs["t"] = [SimpleNamespace(**{**vars(r), "_chip": {}}) for r in reqs["j"]]
    t = 0.0
    for _ in range(40):
        t0 = t + float(rng.random() * 0.01) - 0.004  # windows overlap or leave gaps
        t1 = t0 + float(rng.random() * 0.02)
        t = max(t, t1 - 0.005)
        clock.t += float(rng.random())
        picks = rng.choice(len(reqs["j"]), size=int(rng.integers(0, 4)), replace=False).tolist()
        spec = [(i, {c: int(rng.integers(0, 9)) for c in rng.choice(TG.CLASSES[:4], 2, replace=False)})
                for i in picks]
        anon = int(rng.integers(0, 12)) if rng.random() < 0.6 else 0
        for k in ("j", "t"):
            lanes = [(reqs[k][i], dict(cl)) for i, cl in spec]
            if anon:
                lanes.append((None, {"padding": anon}))
            led[k].observe("step", t0, t1, lanes)
    assert led["t"].snapshot() == led["j"].snapshot()
    assert [r._chip for r in reqs["t"]] == [r._chip for r in reqs["j"]]
    assert usage["t"].snapshot() == usage["j"].snapshot()
    assert ms["t"].render_prometheus() == ms["j"].render_prometheus()
    snap = led["t"].snapshot()
    assert abs(snap["attributed_s"] + snap["idle_s"] - snap["wall_s"]) <= 1e-5
    assert TG.pool_goodput([snap, snap, None]) == JG.pool_goodput([snap, snap, None])
    for k in ("j", "t"):
        led[k].zero_gauges()
    assert ms["t"].render_prometheus() == ms["j"].render_prometheus()


def test_usage_meter_and_quota_gate_equal_jax():
    """Under one fake clock: the same adds give the same windows, rates,
    snapshots, bounded tenant tables and priced Retry-Afters."""
    clock = FakeClock()
    meters = [M.UsageMeter(window_s=20, buckets=4, max_tenants=3, now_fn=clock) for M in (JG, TG)]
    gates = [M.QuotaGate({"a": 2.0, "*": 50.0}, m, min_retry_after=0.25) for M, m in zip((JG, TG), meters)]
    rng = np.random.default_rng(3)
    for step in range(60):
        clock.t += float(rng.random() * 2.0)
        tenant = str(rng.choice(["a", "b", "c", "d"]))
        chip, tokens = {"useful": float(rng.random()), "padding": 0.1}, int(rng.integers(0, 30))
        for m in meters:
            m.add(tenant, chip, tokens)
        if step == 30:
            for g in gates:
                g.set("b", 5.0)
                g.set("a", None)
        for t in ("a", "b", "c", "d", "zz"):
            assert meters[1].window(t) == meters[0].window(t)
            assert gates[1].check(t) == gates[0].check(t)
    assert meters[1].snapshot() == meters[0].snapshot() and gates[1].snapshot() == gates[0].snapshot()
    assert len(meters[1].snapshot()["tenants"]) == 3  # the bounded table evicted the stalest


# -- the engine ---------------------------------------------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_conservation_by_layout(models, layout):
    """attributed + idle == wall within 1% (lifetime and over the burst);
    tenants' chip time sums to the attributed total and each tenant's to
    its requests' ``_chip``; the burst's window inside the wall clock."""
    preset, paged = LAYOUTS[layout]
    _j, _jp, tcfg, tp = models[preset]
    eng = LLMEngine(tcfg, tp, device="cpu", kv_paged=paged, **ENGINE_KW)
    try:
        prompts = _prompts(4, (40, 3, 21, 8, 33, 12))
        clients = ["acme", "globex", "acme", "", "globex", "acme"]
        t0 = time.perf_counter()
        reqs = [eng.submit(GenRequest(p, max_new_tokens=9, client=c)) for p, c in zip(prompts, clients)]
        for r in reqs:
            assert len(r.tokens(timeout=120)) == 9
        _quiet(eng)
        wall = time.perf_counter() - t0
        g = eng.goodput.snapshot()
        assert g["observations"] > 0 and g["by_class"]["useful"] > 0
        assert abs(g["attributed_s"] + g["idle_s"] - g["wall_s"]) <= CONSERVATION * g["wall_s"]
        assert g["wall_s"] <= wall * (1 + CONSERVATION)
        tenants = eng.usage.snapshot()["tenants"]
        assert abs(sum(sum(t["cum_chip_s"].values()) for t in tenants.values()) - g["attributed_s"]) \
            <= CONSERVATION * g["attributed_s"]
        for name in ("acme", "globex", "-"):
            got = sum(sum(r._chip.values()) for r, c in zip(reqs, clients) if (c or "-") == name)
            assert got == pytest.approx(sum(tenants[name]["cum_chip_s"].values()), rel=CONSERVATION, abs=1e-6)
        assert eng.stats()["goodput"] == g
    finally:
        eng.close()


@pytest.mark.parametrize("case", ["pool", "slab", "wave"])
def test_seam_lanes_equal_jax_at_lookahead_1(models, case):
    """The lanes every seam hands the ledger (unified steps, prefill waves,
    decode chunks), summed per (request, class) over a burst at lookahead
    1, equal the JAX engine's on the same prompts (exact token counts), as
    the step packing of tests/test_torch_knobs.py is held."""
    jcfg, jp, tcfg, tp = models["tiny"]
    kw = dict(slots=8, max_seq_len=160, prefill_buckets=(8, 16, 64), decode_chunk=4, prefill_chunk=16,
              step_token_budget=0 if case == "wave" else 32, kv_block=8, kv_paged=case != "slab", lookahead=1)
    ref, port = JEngine(jcfg, jp, warmup=False, **kw), LLMEngine(tcfg, tp, device="cpu", **kw)
    try:
        prompts, news = _prompts(10, (40, 33, 17, 60, 9, 25)), [13, 20, 5, 9, 17, 8]
        seen_j, seen_t = _record_lanes(ref), _record_lanes(port)
        jreqs, jout = _together(ref, JRequest, prompts, news)
        treqs, tout = _together(port, GenRequest, prompts, news)
        assert tout == jout
        _quiet(port)
        _quiet(ref)
        got, want = _lane_sums(seen_t, treqs), _lane_sums(seen_j, jreqs)
        assert got == want
        assert [k for k, _ in seen_t] == [k for k, _ in seen_j]
        assert any(c == "padding" for _i, c in got) and all(i != "other" for i, _c in got)
    finally:
        ref.close()
        port.close()


class _Adversary:
    """Proposes the last token + 1 again and again: the target model rejects
    (almost) every draft."""

    def draft(self, tokens, k):
        return [(int(tokens[-1]) + 1 + j) % 512 for j in range(k)]


def test_speculative_rejects_billed(models):
    _j, _jp, tcfg, tp = models["tiny"]
    eng = LLMEngine(tcfg, tp, device="cpu", speculative=True, spec_draft=3, **ENGINE_KW)
    try:
        eng.drafter = _Adversary()
        seen = _record_lanes(eng)
        reqs = [eng.submit(GenRequest(p, max_new_tokens=12)) for p in _prompts(6, (20, 9, 14))]
        for r in reqs:
            assert len(r.tokens(timeout=120)) == 12
        _quiet(eng)
        st = eng.stats()
        rejected = sum(cl.get("spec_reject", 0) for kind, lanes in seen if kind == "verify" for _r, cl in lanes)
        assert st["spec"]["proposed"] > 0 and rejected == st["spec"]["proposed"] - st["spec"]["accepted"] > 0
        assert eng.goodput.snapshot()["by_class"]["spec_reject"] > 0
        assert any(r._chip.get("spec_reject", 0) > 0 for r in reqs)
    finally:
        eng.close()


def test_adapter_billed_as_its_tenant(models):
    _j, _jp, tcfg, tp = models["tiny"]
    eng = LLMEngine(tcfg, tp, device="cpu", lora_slots=1, lora_rank=4, **ENGINE_KW)
    try:
        eng.load_adapter("ft", init_adapter(torch.Generator().manual_seed(3), tcfg, 4))
        r = eng.submit(GenRequest(_prompts(7, (11,))[0], max_new_tokens=6, adapter="ft"))
        assert len(r.tokens(timeout=120)) == 6 and r.client == "adapter:ft"
        _quiet(eng)
        t = eng.usage.snapshot()["tenants"]["adapter:ft"]
        assert t["tokens"] > 0
        _assert_billed(t["cum_chip_s"], r._chip)
        assert "-" not in eng.usage.snapshot()["tenants"]
    finally:
        eng.close()


def _slow(eng, delay=0.01):
    process = eng._process_entry

    def slow(entry):
        time.sleep(delay)
        return process(entry)

    eng._process_entry = slow


def _contend(eng, R):
    """A batch request preempted by an interactive one after its 4th
    token (tests/test_torch_overload.py's scenario)."""
    batch = eng.submit(R(list(range(1, 9)), max_new_tokens=48, priority="batch", client="b"))
    t0 = time.perf_counter()
    while batch.emitted < 4:
        assert time.perf_counter() - t0 < 60
        time.sleep(0.001)
    inter = eng.submit(R([9, 9, 2], max_new_tokens=4, client="i"))
    assert len(inter.tokens(timeout=60)) == 4
    assert len(batch.tokens(timeout=60)) == 48
    return batch


def test_preemption_replay_marker_equals_jax(models):
    """Step 0: a preempted request's continuation re-prefills its grown
    prompt, all of it computed once already: ``_replay_pos`` is its length
    (JAX llm.py:4242-4251), and the ledger bills exactly those positions
    as ``replay``, in the port as in the JAX engine."""
    jcfg, jp, tcfg, tp = models["tiny"]
    kw = dict(slots=1, max_seq_len=128, prefill_buckets=(8, 16), lookahead=1)
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, decode_chunk=8, prefill_chunk=64, step_token_budget=256, **kw)
    port = LLMEngine(tcfg, tp, device="cpu", **kw)
    try:
        for eng, R in ((ref, JRequest), (port, GenRequest)):
            _slow(eng)
            seen = _record_lanes(eng)
            batch = _contend(eng, R)
            _quiet(eng)
            assert eng.preemptions == batch.preempted == 1
            assert batch._replay_pos == len(batch.prompt_tokens) > 8
            sums = _lane_sums(seen, [batch])
            assert sums[(0, "replay")] == batch._replay_pos
            assert batch._chip["replay"] > 0
    finally:
        ref.close()
        port.close()


FLEET_KW = dict(slots=2, max_seq_len=128, prefill_buckets=(8,), prefill_chunk=4, step_token_budget=4,
                decode_chunk=2, lookahead=1, device="cpu")


def test_failover_replay_and_fleet_pooling(models):
    """A killed replica's continuation re-prefills on the survivor as
    ``replay``; one meter serves both replicas; the fleet's goodput pools
    theirs as JAX's pool_goodput does."""
    _j, _jp, tcfg, tp = models["tiny"]
    inj = FaultInjector()
    fleet = ReplicatedLLMEngine(tcfg, tp, replicas=2, supervise=False, fault_injector=inj, canary=False, **FLEET_KW)
    try:
        assert all(e.usage is fleet.usage for e in fleet.engines)
        seen = [_record_lanes(e) for e in fleet.engines]
        victim = fleet.engines[0]
        r = victim.submit(GenRequest(list(range(3, 27)), max_new_tokens=30, client="c"))
        t0 = time.perf_counter()
        while r.emitted < 3:
            assert time.perf_counter() - t0 < 60
            time.sleep(0.001)
        inj.arm("replica_kill", label="/r0")
        assert len(r.tokens(timeout=120)) == 30 and r.deaths == 1 and not victim.alive()
        survivor = fleet.engines[1]
        _quiet(survivor)
        assert r._replay_pos == len(r.prompt_tokens) > 24
        assert _lane_sums(seen[1], [r])[(0, "replay")] == r._replay_pos
        merged = fleet._merged_goodput()
        snaps = [e.goodput.snapshot() for e in fleet.engines]
        assert merged == JG.pool_goodput(snaps) == TG.pool_goodput(snaps)
        t = fleet.usage.snapshot()["tenants"]["c"]
        _assert_billed(t["cum_chip_s"], r._chip)
        state = fleet.usage_state()
        assert state["replicas"] == 2 and state["goodput"] == merged and "c" in state["tenants"]
    finally:
        fleet.close()


# -- the quota at every edge ------------------------------------------------------------


def test_quota_shed_priced_on_the_engine(models):
    """Over quota: EngineOverloaded with the gate's price (a fake clock
    holds it still), no reference taken, a probe admitted; clearing the
    quota admits again."""
    _j, _jp, tcfg, tp = models["tiny"]
    clock = FakeClock()
    metrics = Manager()
    eng = LLMEngine(tcfg, tp, device="cpu", metrics=metrics, usage_meter=TG.UsageMeter(window_s=10, now_fn=clock),
                    quotas={"acme": 1.0}, **ENGINE_KW)
    try:
        p = _prompts(8, (20,))[0]
        assert len(eng.generate(p, max_new_tokens=5, client="acme")) == 5
        _quiet(eng)
        price = eng.quota.check("acme")
        jprice = JG.QuotaGate({"acme": 1.0}, eng.usage).check("acme")
        assert price == jprice and price > 0.25
        submitted = eng.submitted
        with pytest.raises(EngineOverloaded, match="token-rate quota") as ei:
            eng.submit(GenRequest(p, max_new_tokens=5, client="acme"))
        assert ei.value.retry_after == price and eng.submitted == submitted and eng.quota_sheds == 1
        assert 'app_llm_quota_sheds_total{model="llm",tenant="acme"} 1' in metrics.render_prometheus()
        assert len(eng.submit(GenRequest(p, max_new_tokens=3, client="acme", probe=True)).tokens(timeout=60)) == 3
        assert len(eng.generate(p, max_new_tokens=3, client="other")) == 3
        eng.set_tenant_quota("acme", None)
        assert len(eng.generate(p, max_new_tokens=3, client="acme")) == 3
    finally:
        eng.close()


def _call(app, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", app.http_server.port, timeout=120)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


@pytest.fixture
def quota_app(models):
    """serve's app on the CPU with TPU_LLM_TENANT_QUOTA_TOK_S and the
    OpenAI usage extra."""
    _j, _jp, tcfg, tp = models["tiny"]
    app = serve.build_app(new_mock_config({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "30", "LOG_LEVEL": "ERROR", "GEMMA_PRESET": "tiny",
        "TORCH_DEVICE": "cpu", "LLM_SLOTS": "4", "LLM_MAX_SEQ": "256", "TPU_LLM_TENANT_QUOTA_TOK_S": "acme=0.5",
        "GOFR_OPENAI_USAGE_EXTRA": "1",
    }), params=tp)
    th = app.run_in_background()
    yield app
    app.shutdown()
    th.join(timeout=10)


def test_quota_shed_over_http_and_openai(quota_app):
    app = quota_app
    eng = app.container.tpu().llm("gemma").engine
    assert eng.quota.snapshot() == {"quotas_tok_s": {"acme": 0.5}}
    body = {"tokens": list(range(5, 40)), "max_new_tokens": 8}
    status, raw, _h = _call(app, "POST", "/generate", body, {"X-GoFr-Client": "acme"})
    assert status == 201 and len(json.loads(raw)["data"]["tokens"]) == 8
    _quiet(eng)
    status, raw, hdrs = _call(app, "POST", "/generate", body, {"X-GoFr-Client": "acme"})
    assert status == 429 and "token-rate quota" in raw.decode()
    assert int(hdrs["Retry-After"]) >= int(np.ceil(eng.quota.check("acme"))) - 1
    chat = {"model": "gemma", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4}
    status, raw, hdrs = _call(app, "POST", "/v1/chat/completions", chat, {"X-GoFr-Client": "acme"})
    err = json.loads(raw)["error"]
    assert status == 429 and err["type"] == "rate_limit_error" and int(hdrs["Retry-After"]) >= 1
    # another tenant is served, with its chip time in the usage block
    status, raw, _h = _call(app, "POST", "/v1/chat/completions", chat, {"X-GoFr-Client": "other"})
    usage = json.loads(raw)["usage"]
    assert status == 200 and usage["chip_time_ms"] > 0
    assert sum(usage["chip_breakdown_ms"].values()) == pytest.approx(usage["chip_time_ms"], abs=0.01)
    assert set(usage) == {"prompt_tokens", "completion_tokens", "total_tokens", "chip_time_ms", "chip_breakdown_ms"}
    status, raw, _h = _call(app, "GET", "/.well-known/debug/usage")
    view = json.loads(raw)["data"]
    assert status == 200 and view["count"] == 1 and view["models"]["gemma"]["quota_sheds"] == 2
    assert {"acme", "other"} <= set(view["models"]["gemma"]["tenants"])


def test_openai_usage_extra_off_by_default(models):
    _j, _jp, tcfg, tp = models["tiny"]
    app = serve.build_app(new_mock_config({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "30", "LOG_LEVEL": "ERROR", "GEMMA_PRESET": "tiny",
        "TORCH_DEVICE": "cpu", "LLM_SLOTS": "2", "LLM_MAX_SEQ": "128",
    }), params=tp)
    th = app.run_in_background()
    try:
        chat = {"model": "gemma", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 3}
        status, raw, _h = _call(app, "POST", "/v1/chat/completions", chat)
        assert status == 200 and set(json.loads(raw)["usage"]) == {"prompt_tokens", "completion_tokens",
                                                                    "total_tokens"}
    finally:
        app.shutdown()
        th.join(timeout=10)


@pytest.mark.parametrize("kind", ["engine", "fleet"])
def test_register_adapter_quota_sheds_its_tenant(models, kind):
    """register_adapter(quota=) sets adapter:<name>'s quota (on every
    replica of a fleet, over the meter they share, and kept for rebuilds)
    and sheds that tenant once its window passes it."""
    _j, _jp, tcfg, tp = models["tiny"]
    if kind == "engine":
        eng = LLMEngine(tcfg, tp, device="cpu", lora_slots=1, lora_rank=4, **ENGINE_KW)
    else:
        eng = ReplicatedLLMEngine(tcfg, tp, replicas=2, supervise=False, lora_slots=1, lora_rank=4, device="cpu",
                                  **{k: v for k, v in ENGINE_KW.items()})
    handle = ModelHandle("m", eng)
    try:
        handle.register_adapter("ft", init_adapter(torch.Generator().manual_seed(5), tcfg, 4), shadow_probes=0,
                                quota=0.5)
        reps = getattr(eng, "engines", [eng])
        assert all(e.quota.snapshot()["quotas_tok_s"] == {"adapter:ft": 0.5} for e in reps)
        if kind == "fleet":
            assert eng._engine_kw["quotas"] == {"adapter:ft": 0.5}
        p = _prompts(9, (30,))[0]
        assert len(eng.generate(p, max_new_tokens=4, adapter="ft")) == 4
        for e in reps:
            _quiet(e)
        with pytest.raises(EngineOverloaded) as ei:
            eng.submit(GenRequest(p, max_new_tokens=4, adapter="ft"))
        assert ei.value.retry_after == pytest.approx(reps[0].quota.check("adapter:ft"), abs=0.5)
        assert eng.adapters()["resident"]["ft"]["refs"] == 0  # the shed took no reference
        assert len(eng.generate(p, max_new_tokens=4)) == 4  # the base is not the adapter's tenant
    finally:
        handle.close()


# -- the usage view, the gauges, goodput off -------------------------------------------


def _ctx(engine):
    return SimpleNamespace(container=SimpleNamespace(tpu_runtime=SimpleNamespace(_llms={"gemma": engine})))


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return type(obj).__name__ if obj is not None else None


@pytest.mark.parametrize("goodput", [True, False])
def test_usage_state_shape_equals_jax(models, goodput):
    """usage_state's keys (recursively, with a tenant in the window) equal
    the JAX engine's, with the ledger on and off; the route's view equals
    JAX's handler's on the same engine."""
    jcfg, jp, tcfg, tp = models["tiny"]
    clocks = [FakeClock(), FakeClock()]
    kw = dict(goodput=goodput, **ENGINE_KW)
    if goodput:
        ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, usage_meter=JG.UsageMeter(now_fn=clocks[0]), **kw)
        port = LLMEngine(tcfg, tp, device="cpu", usage_meter=TG.UsageMeter(now_fn=clocks[1]), **kw)
    else:
        ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, **kw)
        port = LLMEngine(tcfg, tp, device="cpu", **kw)
    try:
        p = _prompts(2, (12,))[0]
        assert ref.generate(p, max_new_tokens=4, client="t") == port.generate(p, max_new_tokens=4, client="t")
        _quiet(port)
        _quiet(ref)
        assert _keys(port.usage_state()) == _keys(ref.usage_state())
        assert TH.debug_usage_handler(_ctx(port)).keys() == JH.debug_usage_handler(_ctx(port)).keys()
        assert TH.debug_usage_handler(_ctx(port)) == JH.debug_usage_handler(_ctx(port))
        if not goodput:
            assert port.goodput is port.usage is port.quota is None and port.stats()["goodput"] is None
    finally:
        ref.close()
        port.close()


def test_gauges_zero_after_die(models):
    _j, _jp, tcfg, tp = models["tiny"]
    metrics = Manager()
    eng = LLMEngine(tcfg, tp, device="cpu", metrics=metrics, **ENGINE_KW)
    try:
        eng.generate(_prompts(1, (10,))[0], max_new_tokens=6)
        _quiet(eng)
        assert metrics.gauge_total("app_llm_goodput_ratio") > 0
        eng.anomaly._publish("ttft", 1.0)
        eng._die("fault injection: replica_kill")
        assert metrics.gauge_total("app_llm_goodput_ratio") == 0.0
        assert metrics.gauge_total("app_llm_anomaly") == 0.0
        assert eng.goodput.snapshot()["observations"] > 0  # the ledger outlives the death
    finally:
        eng.close()


def test_goodput_off_pays_nothing(models):
    """goodput=False (or TPU_LLM_GOODPUT=0): no ledger, meter or gate; the
    seams never run and requests carry no chip time; a quota knob is inert."""
    _j, _jp, tcfg, tp = models["tiny"]
    eng = LLMEngine(tcfg, tp, device="cpu", goodput=False, quotas={"acme": 0.001}, **ENGINE_KW)
    calls = []
    eng._gp_observe = lambda *a, **k: calls.append(a)
    try:
        r = eng.submit(GenRequest(_prompts(3, (15,))[0], max_new_tokens=5, client="acme"))
        assert len(r.tokens(timeout=60)) == 5 and r._chip == {} and not calls
        assert eng.generate([1, 2, 3], max_new_tokens=2, client="acme")  # no gate
        assert eng.usage_state()["goodput"] is None and eng.stats()["quota"] is None
    finally:
        eng.close()


def test_goodput_env_off(models, monkeypatch):
    monkeypatch.setenv("TPU_LLM_GOODPUT", "0")
    _j, _jp, tcfg, tp = models["tiny"]
    eng = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW)
    try:
        assert eng.goodput is None and eng.usage is None
    finally:
        eng.close()
    monkeypatch.setenv("TPU_LLM_GOODPUT", "1")
    monkeypatch.setenv("TPU_LLM_USAGE_WINDOW_S", "7")
    monkeypatch.setenv("TPU_LLM_TENANT_QUOTA_TOK_S", "acme=3,bad")
    eng = LLMEngine(tcfg, tp, device="cpu", quotas={"b": 2}, **ENGINE_KW)
    try:
        assert eng.usage.window_s == 7.0 and eng.quota.snapshot() == {"quotas_tok_s": {"acme": 3.0, "b": 2.0}}
    finally:
        eng.close()
