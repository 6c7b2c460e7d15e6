"""gofr_tpu_torch.flightrec and the engine's incident path against
gofr_tpu.flightrec and the JAX LLMEngine (CPU, f32 tiny presets with an
untied random head, greedy, ``device="cpu"``).

The recorder's records equal JAX's field for field on the same request
(timestamps, ids and timings excepted); redaction, the ring's eviction,
``snapshot_inflight``, ``first_divergence`` and ``classify_die_reason``
equal JAX's on the same inputs; the dumper writes its manifest last,
rate-limits per trigger class, lists newest first and survives an
unwritable directory; ``AnomalyDetector`` flags at the same indices as
JAX's on seeded signal sequences. Greedy replay is token-identical on the
pool, the slab, the ring, speculative, constrained and LoRA engines;
``_die`` writes a classified bundle with the in-flight record, a
quarantine and a rollback write theirs, wide events are sampled as JAX
samples them, and the replay route is loopback-only. Capturing a bundle
reads no device value."""

import ast
import http.client
import inspect
import json
import os
import textwrap
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import flightrec as JF
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch import flightrec as TF
from gofr_tpu_torch import handler as TH
from gofr_tpu_torch import serve
from gofr_tpu_torch import structured as TS
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.http.errors import HTTPError
from gofr_tpu_torch.kvcache import CacheManager
from gofr_tpu_torch.llm import GenRequest, LLMEngine, ReplicatedLLMEngine
from gofr_tpu_torch.lora import init_adapter
from gofr_tpu_torch.metrics import Manager
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.resilience import DeviceHealthLedger, FaultInjector

ENGINE_KW = dict(slots=4, max_seq_len=96, prefill_buckets=(8, 16, 32))
# fields that hold times, ids or timings: everything else must be equal
VOLATILE = ("id", "submitted_ts", "finished_ts", "phase_ms", "chip_ms")


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


def _stable(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in VOLATILE and not k.startswith("_")}


def _wait(pred, timeout: float = 60.0) -> None:
    t0 = time.perf_counter()
    while not pred():
        assert time.perf_counter() - t0 < timeout, "timed out"
        time.sleep(0.002)


# -- the recorder against JAX's -------------------------------------------------------


@pytest.mark.parametrize("client", ["", "acme"])
def test_records_equal_jax_field_for_field(models, client):
    jcfg, jp, tcfg, tp = models["tiny"]
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW)
    try:
        for p, n in zip(_prompts(1, (12, 30)), (7, 3)):
            jr = ref.submit(JRequest(p, max_new_tokens=n, client=client, priority="batch"))
            tr = port.submit(GenRequest(p, max_new_tokens=n, client=client, priority="batch"))
            assert jr.tokens(timeout=60) == tr.tokens(timeout=60)
            jrec, trec = ref.flightrec.get(jr.id), port.flightrec.get(tr.id)
            assert _stable(trec) == _stable(jrec)
            assert set(trec) == set(jrec) and set(trec["phase_ms"]) == set(jrec["phase_ms"])
            assert trec["final"] and trec["emitted_token_ids"] == tr.history
            assert set(trec["chip_ms"]) == set(jrec["chip_ms"]) and sum(trec["chip_ms"].values()) > 0
        assert port._config_fingerprint().keys() == ref._config_fingerprint().keys()
    finally:
        ref.close()
        port.close()


def _fake_req(i: int, tokens, grammar=None, **kw):
    base = dict(id=i, temperature=0.0, max_new_tokens=8, eos_token=-1, priority="interactive", client="c",
                session_id="", adapter="", _aid=0, _g_id=-1, grammar=grammar, hop=0, deaths=0, retries=0,
                journey_id=None, span=None, prompt_tokens=list(tokens), finish_reason=None, capped=False,
                browned=False, prefix_hit=False, history=[], phase="decode", submitted_at=1.0, slot=0,
                prefill_done=True)
    base.update(kw)
    return SimpleNamespace(**base)


_ENGINE = SimpleNamespace(label="m", version="v3", kv=SimpleNamespace(paged=True, ring=0), speculative=False)


@pytest.mark.parametrize("redact", [False, True])
def test_ring_eviction_redaction_and_inflight_equal_jax(redact):
    clock = iter(range(1000, 2000))
    recs = [M.FlightRecorder(3, redact=redact, clock=lambda: float(next(clock))) for M in (JF, TF)]
    for i in range(5):
        for rc in recs:
            rc.start(_fake_req(i, range(i + 1)), _ENGINE)
    assert [r["id"] for r in recs[1].records()] == [r["id"] for r in recs[0].records()] == [4, 3, 2]
    done = _fake_req(3, range(4), finish_reason="eos", history=[7, 8])
    live = [_fake_req(4, range(5), history=[9]), _fake_req(0, range(1), history=[1, 1]), None]
    for rc in recs:
        rc.finalize(done, queue_wait_ms=1.0, ttft_ms=2.0, per_token_ms=3.0, total_ms=4.0, chip={"useful": 1.5})
    strip = lambda rs: [{k: v for k, v in r.items() if not k.endswith("_ts")} for r in rs]  # noqa: E731
    assert strip(recs[1].records()) == strip(recs[0].records())
    assert strip(recs[1].records(final=True)) == strip(recs[0].records(final=True))
    assert strip(recs[1].snapshot_inflight(live)) == strip(recs[0].snapshot_inflight(live))
    rec = recs[1].get(3)
    assert (rec["prompt_token_ids"] is None) == redact and rec["prompt_sha256"] == JF._sha256_tokens(range(4))
    assert recs[1].snapshot_inflight(live)[1]["evicted"] is True  # request 0 left the ring
    if redact:
        out = TF.replay_record(None, rec)
        assert out == JF.replay_record(None, rec) and "redacted" in out["error"]
    recs[1].clear()
    assert len(recs[1]) == 0


@pytest.mark.parametrize("a,b", [([], []), ([1, 2], [1, 2]), ([1, 2, 3], [1, 9, 3]), ([1, 2], [1, 2, 3]),
                                 ([5], []), ([1, 2, 3], [1, 2])])
def test_first_divergence_equals_jax(a, b):
    assert TF.first_divergence(a, b) == JF.first_divergence(a, b)


@pytest.mark.parametrize("why", ["step watchdog: fetch:step exceeded 3.0s", "numerical watchdog: non-finite logits",
                                 "poison payload: device_step", "fault injection: replica_kill", "", None,
                                 "collector failed 3 fetches in a row"])
def test_classify_die_reason_equals_jax(why):
    assert TF.classify_die_reason(why) == JF.classify_die_reason(why)


def test_request_phase_follows_the_scheduler_state():
    r = _fake_req(1, [1], submitted_at=None)
    assert TF.request_phase(r) == "new"
    r.submitted_at, r.slot = 1.0, None
    assert TF.request_phase(r) == "queued"
    r.slot, r.prefill_done = 0, False
    assert TF.request_phase(r) == "prefill"
    r.prefill_done = True
    assert TF.request_phase(r) == "decode"
    r.finish_reason = "eos"
    assert TF.request_phase(r) == "done"


# -- the dumper ------------------------------------------------------------------------


def test_dumper_manifest_last_rate_limit_listing(tmp_path, monkeypatch):
    clock = {"t": 100.0}
    metrics = Manager()
    bb = TF.BlackboxDumper(str(tmp_path), min_interval_s=10, clock=lambda: clock["t"], metrics=metrics, label="a/b")
    order = []
    write = TF.BlackboxDumper._write_json
    monkeypatch.setattr(TF.BlackboxDumper, "_write_json", staticmethod(
        lambda path, payload: (order.append(os.path.basename(path)), write(path, payload))))
    p1 = bb.dump("watchdog", reason="r1", sections={"debug_state": {"x": 1}, "hbm": []}, records=[{"id": 1, "_g": 2}])
    assert order == ["debug_state.json", "hbm.json", "flight_records.json", "manifest.json"]
    clock["t"] += 1
    assert bb.dump("watchdog", reason="again") is None and bb.rate_limited == 1
    p2 = bb.dump("numerical", reason="r2", sections={}, records=[])
    clock["t"] += 11
    p3 = bb.dump("watchdog", reason="r3", sections={}, records=[])
    assert None not in (p1, p2, p3) and len({p1, p2, p3}) == 3
    assert os.path.basename(p1).startswith("a_b-watchdog-")
    with open(os.path.join(p1, "flight_records.json")) as f:
        assert json.load(f) == [{"id": 1}]  # underscore keys stripped
    listing = bb.listing()
    assert [m["reason"] for m in listing] == ["r3", "r2", "r1"]
    # JAX's listing reads the same directory the same way
    jlisting = JF.BlackboxDumper(str(tmp_path)).listing()
    assert [m["bundle"] for m in jlisting] == [m["bundle"] for m in listing]
    assert 'app_blackbox_bundles_total{model="a/b",trigger="watchdog"} 2' in metrics.render_prometheus()
    bb.close()
    assert not bb.enabled() and bb.dump("manual") is None


def test_dumper_unwritable_directory_never_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    logged = []
    bb = TF.BlackboxDumper(str(blocker / "sub"), min_interval_s=0, logger=SimpleNamespace(
        error=logged.append, info=logged.append))
    assert bb.enabled() and bb.dump("manual", sections={"a": 1}) is None
    assert logged and "failed" in logged[0] and bb.listing() == []
    assert TF.BlackboxDumper("").dump("manual") is None  # unarmed


def test_bundle_names_unique_across_dumpers_of_one_label(tmp_path):
    """Two dumpers of one label (a replica and its rebuild) never write into
    the same directory: the sequence is process-wide (the JAX dumper counts
    per instance)."""
    a, b = (TF.BlackboxDumper(str(tmp_path), min_interval_s=0, label="llm/r0") for _ in range(2))
    pa, pb = a.dump("engine_death", sections={}), b.dump("engine_death", sections={})
    assert pa != pb and len(os.listdir(tmp_path)) == 2


# -- the anomaly detectors ------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_anomaly_flags_at_the_same_indices_as_jax(seed):
    rng = np.random.default_rng(seed)
    clock = {"t": 0.0}
    fired = {"j": [], "t": []}
    dets = {k: M.AnomalyDetector(None, "m", factor=2.5, min_samples=16, sustain=4, clock=lambda: clock["t"],
                                 on_flag=lambda s, v, m, k=k: fired[k].append((s, round(v, 9), round(m, 9))))
            for k, M in (("j", JF), ("t", TF))}
    flags = {"j": [], "t": []}
    for i in range(400):
        clock["t"] += 0.5
        signal = str(rng.choice(list(TF.ANOMALY_SIGNALS) + ["unknown"]))
        base = 0.5 if signal == "spec_accept" else 10.0
        burst = (i // 40) % 3 == 2  # every third stretch deviates
        v = base * (rng.random() + (4.0 if burst and signal != "spec_accept" else 0.5))
        if burst and signal == "spec_accept":
            v = base * 0.01
        for k in ("j", "t"):
            flags[k].append(dets[k].observe(signal, v))
    assert flags["t"] == flags["j"] and fired["t"] == fired["j"] and fired["t"]
    assert dets["t"].snapshot() == dets["j"].snapshot() and dets["t"].flagged() == dets["j"].flagged()
    for d in dets.values():
        d.zero_gauges()
    assert dets["t"].snapshot() == dets["j"].snapshot()


def test_anomaly_knobs_from_env(monkeypatch):
    monkeypatch.setenv("TPU_LLM_ANOMALY_FACTOR", "5")
    monkeypatch.setenv("TPU_LLM_ANOMALY_MIN_SAMPLES", "7")
    monkeypatch.setenv("TPU_LLM_ANOMALY_SUSTAIN", "2")
    d = TF.AnomalyDetector()
    assert (d.factor, d.min_samples, d.sustain) == (5.0, 7, 2)


# -- replay on every engine kind ----------------------------------------------------------------

VOCAB = [bytes([i]).decode("latin-1") for i in range(256)] + [f"<x{i}>" for i in range(255)] + ["<eos>"]


@pytest.mark.parametrize("kind", ["pool", "slab", "ring", "speculative", "constrained", "lora"])
def test_greedy_replay_is_token_identical(models, kind):
    preset = "tiny_mistral" if kind == "ring" else "tiny"
    _j, _jp, tcfg, tp = models[preset]
    kw = dict(ENGINE_KW)
    req_kw: dict = {}
    if kind in ("slab", "ring"):
        kw["kv_paged"] = False if kind == "slab" else "auto"
    elif kind == "speculative":
        kw.update(speculative=True, spec_draft=3)
    elif kind == "lora":
        kw.update(lora_slots=1, lora_rank=4)
        req_kw["adapter"] = "ft"
    eng = LLMEngine(tcfg, tp, device="cpu", **kw)
    try:
        if kind == "ring":
            assert eng.kv.rolling
        if kind == "lora":
            eng.load_adapter("ft", init_adapter(torch.Generator().manual_seed(1), tcfg, 4))
        if kind == "constrained":
            req_kw["grammar"] = TS.compile_regex("[a-c]{3,9}", VOCAB, len(VOCAB) - 1)
        reqs = [eng.submit(GenRequest(p, max_new_tokens=10, **req_kw)) for p in _prompts(2, (9, 25, 4))]
        outs = [r.tokens(timeout=120) for r in reqs]
        for r, out in zip(reqs, outs):
            rec = eng.flightrec.get(r.id)
            assert rec["final"] and rec["emitted_token_ids"] == out
            assert rec["lora"] == (kind == "lora") and rec["constrained"] == (kind == "constrained")
            rp = eng.replay(r.id)
            assert rp["match"] and rp["first_divergence"] is None and rp["replayed_token_ids"] == out, rp
        assert eng.replay(10**9)["error"].startswith("no flight record")
    finally:
        eng.close()


def test_replay_pins_the_version(models):
    _j, _jp, tcfg, tp = models["tiny"]
    eng = LLMEngine(tcfg, tp, device="cpu", version="v2", seed=7, **ENGINE_KW)
    try:
        r = eng.submit(GenRequest([1, 2, 3], max_new_tokens=4))
        r.tokens(timeout=60)
        assert eng.flightrec.get(r.id)["seed"] == 7  # the sampler's seed (JAX records 0: queue 3 item 30)
        rec = dict(eng.flightrec.get(r.id), model_version="v1")
        assert "version mismatch" in eng.replay(rec)["error"]
    finally:
        eng.close()


# -- incidents ---------------------------------------------------------------------------------------


def _bundles(d) -> list[dict]:
    out = []
    for name in sorted(os.listdir(d)):
        if not os.path.exists(os.path.join(d, name, "manifest.json")):
            continue  # still being written: the manifest goes last
        with open(os.path.join(d, name, "manifest.json")) as f:
            m = json.load(f)
        with open(os.path.join(d, name, "flight_records.json")) as f:
            m["records"] = json.load(f)
        m["files"] = sorted(os.listdir(os.path.join(d, name)))
        out.append(m)
    return out


def _hold_collector(eng):
    """Park the collector before its next fetch until released."""
    import threading

    gate = threading.Event()
    process = eng._process_entry

    def held(entry):
        gate.wait(timeout=30)
        return process(entry)

    eng._process_entry = held
    return gate


def test_die_writes_a_classified_bundle_first(models, tmp_path):
    _j, _jp, tcfg, tp = models["tiny"]
    metrics = Manager()
    eng = LLMEngine(tcfg, tp, device="cpu", blackbox_dir=str(tmp_path), metrics=metrics, **ENGINE_KW)
    try:
        done = eng.submit(GenRequest([4, 5, 6], max_new_tokens=3))
        done.tokens(timeout=60)
        gate = _hold_collector(eng)
        r = eng.submit(GenRequest(list(range(1, 30)), max_new_tokens=40))
        _wait(lambda: r.slot is not None)
        eng._die("numerical watchdog: non-finite logits (test)")
        gate.set()
        assert r.tokens(timeout=60) == [] or r.finish_reason == "cancelled"
        (b,) = _bundles(tmp_path)
        assert b["trigger"] == "numerical" and b["reason"].startswith("numerical watchdog")
        # JAX's sections: ``compiles`` always (the capture registry's rows of
        # this engine; on the CPU its first eager runs), ``traces`` only
        # with a tracer (none here)
        assert {"manifest.json", "debug_state.json", "hbm.json", "config.json", "wide_events.json",
                "anomaly.json", "flight_records.json", "compiles.json"} == set(b["files"])
        with open(os.path.join(tmp_path, os.listdir(tmp_path)[0], "compiles.json")) as f:
            comp = json.load(f)
        assert comp["programs"] and {p["model"] for p in comp["programs"]} == {"llm"}
        assert {p["measured"] for p in comp["programs"]} == {"first_call"}
        inflight = [rec for rec in b["records"] if not rec["final"]]
        assert [rec["id"] for rec in inflight] == [r.id] and inflight[0]["phase"] in ("prefill", "decode")
        assert done.id in {rec["id"] for rec in b["records"] if rec["final"]}
        with open(os.path.join(tmp_path, os.listdir(tmp_path)[0], "debug_state.json")) as f:
            ds = json.load(f)
        assert ds["died"] and ds["slot_table"] and ds["slot_table"][0]["id"] == r.id  # taken before the drain
        with open(os.path.join(tmp_path, os.listdir(tmp_path)[0], "hbm.json")) as f:
            assert json.load(f)[0]["bytes_in_use"] is None  # no device counters on the CPU
        # the ring outlives the death: the record is final now
        assert eng.flightrec.get(r.id)["final"] and eng.flightrec.get(r.id)["finish_reason"] == "cancelled"
        assert 'app_blackbox_bundles_total{model="llm",trigger="numerical"} 1' in metrics.render_prometheus()
    finally:
        eng.close()
    assert len(eng.flightrec) == 0 and not eng.blackbox.enabled()  # close clears the ring, stops the dumper


def test_bundle_while_the_lock_is_wedged(models, tmp_path):
    """A hung call holding the lock costs the bundle its debug_state, never
    the bundle: the bounded acquire gives up and the racy sweep still
    records the requests in flight."""
    import threading

    _j, _jp, tcfg, tp = models["tiny"]
    eng = LLMEngine(tcfg, tp, device="cpu", blackbox_dir=str(tmp_path), **ENGINE_KW)
    try:
        gate = _hold_collector(eng)
        r = eng.submit(GenRequest(list(range(1, 20)), max_new_tokens=20))
        _wait(lambda: r.slot is not None)
        held = threading.Event()
        release = threading.Event()
        th = threading.Thread(target=lambda: (eng._lock.acquire(), held.set(), release.wait(10), eng._lock.release()))
        th.start()
        held.wait(5)
        t0 = time.perf_counter()
        path = eng._incident("manual", lock_timeout=0.2)
        assert time.perf_counter() - t0 < 2.0
        release.set()
        th.join()
        gate.set()
        with open(os.path.join(path, "debug_state.json")) as f:
            assert json.load(f)["lock_wedged"] is True
        with open(os.path.join(path, "flight_records.json")) as f:
            assert r.id in [rec["id"] for rec in json.load(f) if not rec["final"]]
        r.tokens(timeout=60)
    finally:
        eng.close()


def test_bundle_capture_reads_no_device_value():
    """debug_state, stats, _hbm_samples and the rest of the capture path
    call no .item(), .cpu(), .tolist() on a tensor, nor synchronize: a hung
    stream or a sticky error must not take the bundle with it."""
    fns = [LLMEngine.debug_state, LLMEngine.stats, LLMEngine._hbm_samples, LLMEngine._incident,
           LLMEngine._config_fingerprint, LLMEngine._inflight_requests, LLMEngine.adapters, CacheManager.stats,
           LLMEngine._spec_summary, LLMEngine._constrained_summary]
    banned = {"item", "cpu", "numpy", "tolist", "synchronize"}
    for fn in fns:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        calls = {n.func.attr for n in ast.walk(tree) if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
        assert not calls & banned, (fn.__qualname__, calls & banned)


def test_quarantine_writes_a_bundle(models, tmp_path):
    _j, _jp, tcfg, tp = models["tiny"]
    inj = FaultInjector()
    fleet = ReplicatedLLMEngine(
        tcfg, tp, replicas=2, fault_injector=inj, health_ledger=DeviceHealthLedger(failures=1),
        blackbox_dir=str(tmp_path), slots=2, max_seq_len=64, prefill_buckets=(8,), lookahead=1, device="cpu",
    )
    try:
        fleet.generate([1, 2, 3], max_new_tokens=2)
        inj.arm("replica_kill", label="/r0")
        _wait(lambda: {b["trigger"] for b in _bundles(tmp_path)} >= {"engine_death", "quarantine"}, 30)
        q = [b for b in _bundles(tmp_path) if b["trigger"] == "quarantine"]
        assert len(q) == 1 and q[0]["label"] == "llm/r1" and "quarantined" in q[0]["reason"]
        assert fleet.health.quarantines == 1
    finally:
        fleet.close()


def test_rollback_writes_one_bundle(models, tmp_path):
    jcfg, jp, tcfg, tp = models["tiny"]
    _j2, _jp2, _t2, tp2 = _pair("tiny", seed=5)
    inj = FaultInjector()
    fleet = ReplicatedLLMEngine(tcfg, tp, replicas=2, fault_injector=inj, supervise=False, blackbox_dir=str(tmp_path),
                                slots=2, max_seq_len=64, prefill_buckets=(8,), lookahead=1, device="cpu")
    try:
        inj.arm("rollout_canary_fail", count=1)
        fleet.deploy(None, tp2, version="v2", bake_s=0.2, drain_timeout_s=30)
        assert fleet._rollout.wait(timeout=120) == "rolled_back"
        rb = [b for b in _bundles(tmp_path) if b["trigger"] == "rollback"]
        assert len(rb) == 1 and rb[0]["reason"].startswith("rolling back v2 -> v1")
    finally:
        fleet.close()


def test_fleet_replay_finds_the_record_on_any_replica(models):
    _j, _jp, tcfg, tp = models["tiny"]
    fleet = ReplicatedLLMEngine(tcfg, tp, replicas=2, supervise=False, slots=2, max_seq_len=64,
                                prefill_buckets=(8,), lookahead=1, device="cpu")
    try:
        reqs = [fleet.submit(GenRequest(p, max_new_tokens=5)) for p in _prompts(3, (6, 9))]
        outs = [r.tokens(timeout=60) for r in reqs]
        for r, out in zip(reqs, outs):
            rp = fleet.replay(r.id)
            assert rp["match"] and rp["replayed_token_ids"] == out
        assert "no flight record" in fleet.replay(10**9)["error"]
    finally:
        fleet.close()


# -- wide events ---------------------------------------------------------------------------------------


class _Lines:
    def __init__(self):
        self.lines = []

    def info(self, *a, **k):
        self.lines.extend(x for x in a if isinstance(x, dict) and x.get("event") == "llm_request")

    warn = error = debug = lambda self, *a, **k: None


def test_wide_event_sampling_equals_jax(models):
    """1 in N request lines logged (each with "sample": N), every line that
    did not end eos/length logged (with "sample": 1), all of them kept for
    bundles; the same lines as the JAX engine's on the same traffic."""
    jcfg, jp, tcfg, tp = models["tiny"]
    logs = {"j": _Lines(), "t": _Lines()}
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, logger=logs["j"], wide_event_sample=3, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", logger=logs["t"], wide_event_sample=3, **ENGINE_KW)
    try:
        for eng, R in ((ref, JRequest), (port, GenRequest)):
            for i, p in enumerate(_prompts(5, (5, 7, 9, 11, 13, 15, 17))):
                r = eng.submit(R(p, max_new_tokens=4))
                if i == 4:
                    r.cancel()
                r.tokens(timeout=60)
            _wait(lambda e=eng: len(e._wide_retained) == 7)
            eng._flush_wide_events()
        pick = lambda ls: sorted((e["prompt_tokens"], e.get("sample"), e["finish_reason"]) for e in ls)  # noqa: E731
        assert pick(logs["t"].lines) == pick(logs["j"].lines) and len(logs["t"].lines) == 3
        keys = set(port._wide_retained[0])
        assert keys == set(ref._wide_retained[0]) - {"trace_id", "journey_id"} | {"trace_id", "journey_id"}
    finally:
        ref.close()
        port.close()


# -- the routes ---------------------------------------------------------------------------------------


def _call(app, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", app.http_server.port, timeout=60)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def test_replay_and_blackbox_routes(models, tmp_path):
    _j, _jp, tcfg, tp = models["tiny"]
    app = serve.build_app(new_mock_config({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "30", "LOG_LEVEL": "ERROR", "GEMMA_PRESET": "tiny",
        "TORCH_DEVICE": "cpu", "LLM_SLOTS": "2", "LLM_MAX_SEQ": "128", "GOFR_BLACKBOX_DIR": str(tmp_path),
        "TPU_LLM_FLIGHT_RECORDS": "16",
    }), params=tp)
    th = app.run_in_background()
    try:
        eng = app.container.tpu().llm("gemma").engine
        assert eng.flightrec.capacity == 16 and eng.blackbox.directory == str(tmp_path)
        status, body = _call(app, "POST", "/generate", {"tokens": [3, 4, 5], "max_new_tokens": 5})
        assert status == 201
        rid = eng.flightrec.records()[0]["id"]
        status, body = _call(app, "POST", "/.well-known/debug/replay", {"id": rid})
        rp = body["data"]["replay"]
        assert status == 201 and body["data"]["model"] == "gemma" and rp["match"]
        assert _call(app, "POST", "/.well-known/debug/replay", {"id": 10**9})[0] == 404
        assert _call(app, "POST", "/.well-known/debug/replay", {"id": "x"})[0] == 400
        assert _call(app, "POST", "/.well-known/debug/replay", {"id": rid, "model": "nope"})[0] == 404
        eng._incident("manual", reason="route check")
        status, body = _call(app, "GET", "/.well-known/debug/blackbox")
        data = body["data"]
        assert status == 200 and data["count"] == 1 and data["bundles"][0]["trigger"] == "manual"
        assert data["recorders"]["gemma"]["flight_records"] >= 2 and data["recorders"]["gemma"]["enabled"]
        # a caller that is not loopback is refused unless GOFR_REPLAY_REMOTE=1
        for opt_in, want in (("0", 403), ("1", None)):
            ctx = SimpleNamespace(
                request=SimpleNamespace(remote_addr="10.1.2.3:5555"), bind=lambda: {"id": rid},
                container=SimpleNamespace(config=new_mock_config({"GOFR_REPLAY_REMOTE": opt_in}),
                                          tpu_runtime=app.container.tpu_runtime),
            )
            if want is None:
                assert TH.replay_handler(ctx)["replay"]["match"]
            else:
                with pytest.raises(HTTPError) as ei:
                    TH.replay_handler(ctx)
                assert ei.value.status_code == want
    finally:
        app.shutdown()
        th.join(timeout=10)
