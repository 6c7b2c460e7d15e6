"""gofr_tpu_torch.batch and gofr_tpu_torch.datasource.pubsub against the
JAX package on the CPU: the ten cases of tests/test_batch_jobs.py run
against the port's engine (results token for token equal to the JAX
worker's on the same jobs and weights), the durable FILE backend across
the two packages (a log written by one is read by the other from its
committed offset), the PUBSUB_BACKEND switch and the container's wiring,
and App.subscribe's loop beside the JAX App's."""

import asyncio
import json
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gofr_tpu
from gofr_tpu.batch import BatchJob as JBatchJob
from gofr_tpu.batch import BatchStore as JBatchStore
from gofr_tpu.batch import BatchWorker as JBatchWorker
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.datasource.pubsub import FilePubSub as JFilePubSub
from gofr_tpu.datasource.pubsub import MemoryPubSub as JMemoryPubSub
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import transformer as JT
from gofr_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from gofr_tpu_torch.app import App
from gofr_tpu_torch.batch import BatchJob, BatchStore, BatchWorker, attach_batch_worker
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.datasource.pubsub import FilePubSub, MemoryPubSub, Message, SubscribeContextRequest, new_pubsub
from gofr_tpu_torch.llm import LLMEngine, ReplicatedLLMEngine
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.models.tokenizer import ByteTokenizer
from gofr_tpu_torch.resilience import FaultInjector

VOCAB = 300
ENGINE_KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8, 16))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny engines' CPU ops on one intra-op thread: under the suite's
    parallel workers an 8-thread pool spends most of its time in its
    barriers and starves the other workers' timing-bound tests."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = JT.TransformerConfig.tiny(vocab_size=VOCAB)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    # an untied random head: the tied tiny model repeats its input token
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (VOCAB, jcfg.d_model), jnp.float32))
    tcfg = TT.TransformerConfig.tiny(vocab_size=VOCAB)
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def port_engine(weights):
    _, _, tcfg, tp = weights
    eng = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW)
    yield eng
    eng.close()


class _Container(SimpleNamespace):
    """The slice of the framework container the worker reads."""

    def __init__(self, pubsub, handle):
        super().__init__(pubsub=pubsub, logger=None, metrics_manager=None, _handle=handle)

    def tpu(self):
        return SimpleNamespace(llm=lambda name: self._handle)


class _WorkerHarness:
    """A worker's drain loop on its own event-loop thread."""

    def __init__(self, worker):
        self.worker = worker
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.worker.run())
        self.loop.close()

    def stop(self, timeout=10.0):
        self.worker.close()
        self.thread.join(timeout=timeout)
        assert not self.thread.is_alive(), "worker loop did not exit"


def _wait(pred, timeout, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _drain_topic(ps, topic):
    out = []
    q = ps._queues.get(topic)
    while q:
        out.append(json.loads(q.popleft()))
    return out


def _job(jid, **kw):
    return json.dumps({"id": jid, "tokens": [1, 2, 3], "max_new_tokens": 4, **kw}).encode()


def _jobs_through(worker_cls, pubsub_cls, engine, payloads, **worker_kw):
    """Publish ``payloads`` on a fresh backend, drain them with a worker of
    ``worker_cls`` over ``engine`` and return {id: result}."""
    ps = pubsub_cls()
    w = worker_cls(_Container(ps, engine), "jobs", model="m", poll_timeout=0.05, **worker_kw)
    h = _WorkerHarness(w)
    try:
        for p in payloads:
            ps.publish_sync("jobs", p)
        _wait(lambda: w.jobs_ok == len(payloads), 120, "every job")
    finally:
        h.stop()
    return {r["id"]: r for r in _drain_topic(ps, "jobs.results")}


# ---------------------------------------------------------------------------
# parsing and the idempotence ledger
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payload", [
    {"tokens": [1, 2]}, {"id": "x", "prompt": "hi", "max_new_tokens": 7, "temperature": 0.5},
    {"id": "y", "tokens": [3], "reply_topic": "r", "webhook": "http://h", "client": "acme", "session": "s",
     "_attempt": 2, "traceparent": "00-" + "a" * 32 + "-" + "b" * 16 + "-01", "schema": {"type": "boolean"}},
])
def test_job_fields_equal_jax(payload):
    j, p = JBatchJob(dict(payload)), BatchJob(dict(payload))
    fields = ("model", "tokens", "prompt", "max_new_tokens", "temperature", "schema", "reply_topic", "webhook",
              "client", "session", "attempt", "traceparent", "raw")
    assert {f: getattr(p, f) for f in fields} == {f: getattr(j, f) for f in fields}
    if "id" in payload:
        assert p.id == j.id
    else:
        assert p.id.startswith("job_") and p.max_new_tokens == 32


@pytest.mark.parametrize("payload", [{"max_new_tokens": 4}, {"tokens": ["a"]}, [1, 2], {"tokens": 5}])
def test_malformed_job_raises_as_jax(payload):
    with pytest.raises(ValueError) as pe:
        BatchJob(payload)
    with pytest.raises(ValueError) as je:
        JBatchJob(payload)
    assert str(pe.value) == str(je.value)


def test_store_claim_and_idempotence_equal_jax():
    def walk(store_cls):
        log = []
        st = store_cls()
        log.append(st.begin("j"))
        log.append(st.begin("j"))  # running: a duplicate pull
        st.finish("j", ok=True, result={"x": 1})
        log.append(st.begin("j"))  # done: a redelivery
        st.begin("k")
        st.finish("k", ok=False, error="boom")
        log.append(st.begin("k"))  # failed: the retry claims again
        st.unclaim("k", error="shed")  # pressure gives the attempt back
        log.append(st.state("k"))
        st.register("a", "batch_1")
        st.register("b", "batch_1")
        st.begin("a")
        st.finish("a", ok=True, result={})
        st.begin("b")
        st.finish("b", ok=False, error="e", final=True)
        log.append(st.batch_view("batch_1"))
        log.append(st.batch_view("nope"))
        small = store_cls(cap=2)
        for jid in ("p", "q", "r"):
            small.register(jid)
        log.append(sorted(small._jobs))
        return log

    assert walk(BatchStore) == walk(JBatchStore)


# ---------------------------------------------------------------------------
# the worker against the port's engine
# ---------------------------------------------------------------------------

def test_reply_topic_roundtrip_batch_class_and_tokens_equal_jax(weights, port_engine):
    jcfg, jp, _, _ = weights
    seen = []
    submit = port_engine.submit

    def spy(req):
        seen.append(req.priority)
        return submit(req)

    port_engine.submit = spy
    payloads = [json.dumps({"id": f"j{i}", "tokens": [5 + i, 9, 40 + 3 * i, 2][: 2 + i % 3],
                            "max_new_tokens": 6}).encode() for i in range(5)]
    try:
        got = _jobs_through(BatchWorker, MemoryPubSub, port_engine, payloads)
    finally:
        del port_engine.submit
    ref_eng = JEngine(jcfg, jp, warmup=False, kv_paged=True, **ENGINE_KW)
    try:
        want = _jobs_through(JBatchWorker, JMemoryPubSub, ref_eng, payloads)
    finally:
        ref_eng.close()
    assert sorted(got) == sorted(want) == [f"j{i}" for i in range(5)]
    for jid in got:
        assert got[jid]["tokens"] == want[jid]["tokens"], jid
        assert {k: v for k, v in got[jid].items() if k != "tokens"} == {
            k: v for k, v in want[jid].items() if k != "tokens"}
        assert got[jid]["status"] == "ok" and got[jid]["n_tokens"] == 6
    assert len({tuple(r["tokens"]) for r in got.values()}) > 1
    assert seen and set(seen) == {"batch"}  # every submission in the batch class


def test_ack_after_publish_on_durable_backend(port_engine, tmp_path):
    """FILE: a failed result publish leaves the offset uncommitted, the
    record is served again, the retry publishes, and the reply log ends
    with exactly one result."""
    ps = FilePubSub(str(tmp_path))
    fails = {"n": 1}
    w = BatchWorker(_Container(ps, port_engine), "jobs", model="m", poll_timeout=0.1, concurrency=1,
                    max_attempts=5)
    orig = w._publish_result

    def flaky(job, result):
        if fails["n"]:
            fails["n"] -= 1
            raise RuntimeError("injected publish outage")
        orig(job, result)

    w._publish_result = flaky
    ps.publish_sync("jobs", _job("dj"))
    h = _WorkerHarness(w)
    try:
        _wait(lambda: w.jobs_ok == 1, 60, "job ok after redelivery")
        assert w.jobs_error == 1
        with open(tmp_path / "jobs.results.jsonl") as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        assert len(lines) == 1 and json.loads(lines[0]["value"])["id"] == "dj"
        assert ps._committed("jobs") == 1
    finally:
        h.stop()


@pytest.mark.parametrize("backend", ["FILE", "MEMORY"])
def test_replica_kill_mid_job_redelivers_exactly_once(weights, monkeypatch, tmp_path, backend):
    """A replica killed mid-decode fails the in-flight generation (one
    replica: nothing to fail over to), the job stays unacknowledged and is
    served again, the supervisor rebuilds the replica, and the job
    publishes exactly one result."""
    _, _, tcfg, tp = weights
    monkeypatch.setenv("TPU_LLM_RESTART_BACKOFF_S", "0.1")
    inj = FaultInjector()
    fleet = ReplicatedLLMEngine(tcfg, tp, replicas=1, supervise=True, canary=False, fault_injector=inj,
                                slots=2, max_seq_len=64, failover_retries=0, device="cpu")
    ps = FilePubSub(str(tmp_path)) if backend == "FILE" else MemoryPubSub()
    w = BatchWorker(_Container(ps, fleet), "jobs", model="m", poll_timeout=0.1, concurrency=1, max_attempts=20)
    ps.publish_sync("jobs", json.dumps({"id": "kj", "tokens": [1, 2, 3], "max_new_tokens": 24}).encode())
    eng = fleet.engines[0]
    process = eng._process_entry
    armed = threading.Event()

    def slow(entry):  # hold the job mid-decode until the fault is armed
        armed.wait(5.0)
        time.sleep(0.01)
        return process(entry)

    eng._process_entry = slow
    h = _WorkerHarness(w)
    try:
        _wait(lambda: any(r is not None for r in eng._slot_req), 30, "job slotted")
        inj.arm("replica_kill", count=1)
        armed.set()
        _wait(lambda: w.jobs_ok == 1, 90, "job completed after kill")
        if backend == "FILE":
            with open(tmp_path / "jobs.results.jsonl") as f:
                results = [json.loads(json.loads(ln)["value"]) for ln in f if ln.strip()]
            assert ps._committed("jobs") == 1
        else:
            results = _drain_topic(ps, "jobs.results")
        assert [r["id"] for r in results] == ["kj"]
        assert w.jobs_error + w.jobs_requeued >= 1  # it did die once
        assert len(results[0]["tokens"]) == 24
    finally:
        eng._process_entry = process
        h.stop()
        fleet.close()


def test_duplicate_delivery_dedups(port_engine):
    ps = MemoryPubSub()
    w = BatchWorker(_Container(ps, port_engine), "jobs", model="m", poll_timeout=0.1)
    h = _WorkerHarness(w)
    try:
        ps.publish_sync("jobs", _job("dup"))
        _wait(lambda: w.jobs_ok == 1, 60, "first delivery ok")
        ps.publish_sync("jobs", _job("dup"))
        _wait(lambda: w.jobs_deduped == 1, 30, "dedup")
        assert len(_drain_topic(ps, "jobs.results")) == 1
    finally:
        h.stop()


def test_webhook_path(port_engine):
    import http.server

    hits = []

    class Hook(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            hits.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    ps = MemoryPubSub()
    w = BatchWorker(_Container(ps, port_engine), "jobs", model="m", poll_timeout=0.1, webhook_timeout=5.0)
    h = _WorkerHarness(w)
    try:
        ps.publish_sync("jobs", _job("wh", webhook=f"http://127.0.0.1:{srv.server_port}/hook"))
        _wait(lambda: w.jobs_ok == 1, 60, "webhook job")
        assert [r["id"] for r in hits] == ["wh"]
        assert not ps._queues.get("jobs.results")
    finally:
        h.stop()
        srv.shutdown()


def test_malformed_payload_to_dlq(port_engine):
    ps = MemoryPubSub()
    w = BatchWorker(_Container(ps, port_engine), "jobs", model="m", poll_timeout=0.1)
    h = _WorkerHarness(w)
    try:
        ps.publish_sync("jobs", b"{not json")
        ps.publish_sync("jobs", b'{"id": "nope"}')
        _wait(lambda: len(ps._queues.get("jobs.dlq", [])) == 2, 30, "dlq")
        assert [json.loads(b) for b in list(ps._queues["jobs.dlq"])[1:]] == [{"id": "nope"}]
    finally:
        h.stop()


def test_failing_job_goes_to_dlq_after_max_attempts(port_engine):
    ps = MemoryPubSub()
    w = BatchWorker(_Container(ps, port_engine), "jobs", poll_timeout=0.05, max_attempts=2)  # no model: fails
    h = _WorkerHarness(w)
    try:
        ps.publish_sync("jobs", _job("nomodel"))
        _wait(lambda: w.jobs_dlq == 1, 30, "dlq after attempts")
        dead = _drain_topic(ps, "jobs.dlq")
        assert dead[0]["id"] == "nomodel" and "no model" in dead[0]["_error"]
        assert w.jobs_error == 2 and w.store.state("nomodel")["status"] == "dlq"
    finally:
        h.stop()


def test_engine_shed_pauses_pull_rate(weights):
    """EngineOverloaded is pressure, not failure: the pull loop backs off
    for the advertised Retry-After, the job keeps its attempts, and it
    completes once the engine recovers."""
    _, _, tcfg, tp = weights
    inj = FaultInjector()
    eng = LLMEngine(tcfg, tp, device="cpu", slots=2, max_seq_len=64, shed_predicted_wait_s=1.0,
                    fault_injector=inj)
    ps = MemoryPubSub()
    w = BatchWorker(_Container(ps, eng), "jobs", model="m", poll_timeout=0.1, max_attempts=2)
    inj.arm("overload_pressure", count=1, delay=30.0)
    h = _WorkerHarness(w)
    try:
        ps.publish_sync("jobs", _job("ov"))
        _wait(lambda: w.jobs_requeued == 1, 30, "shed requeue")
        assert w.stats()["paused_s"] > 0
        assert w.jobs_error == 0
        _wait(lambda: w.jobs_ok == 1, 90, "job after backoff")
    finally:
        h.stop()
        eng.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_shed_job_reaching_a_waiting_pull_is_not_dropped(weights, pkg):
    """ROADMAP queue 3 item 42. On MEMORY a shed job is republished while
    the pull loop may already wait in ``subscribe``; forced here: the pull
    classifies the republished job before ``_process`` has returned. The
    JAX worker still marks the job in flight then, takes it for a
    concurrent duplicate and drops it, and MEMORY never redelivers it: the
    job is lost (the intermittent timeout of
    test_engine_shed_pauses_pull_rate). The port's worker releases the
    mark before the republish, and the job runs."""
    from gofr_tpu.resilience import FaultInjector as JFaultInjector

    jcfg, jp, tcfg, tp = weights
    kw = dict(slots=2, max_seq_len=64, shed_predicted_wait_s=1.0)
    if pkg == "port":
        inj = FaultInjector()
        eng = LLMEngine(tcfg, tp, device="cpu", fault_injector=inj, **kw)
        ps, worker_cls = MemoryPubSub(), BatchWorker
    else:
        inj = JFaultInjector()
        eng = JEngine(jcfg, jp, warmup=False, kv_paged=True, fault_injector=inj, **kw)
        ps, worker_cls = JMemoryPubSub(), JBatchWorker
    # a long poll: the pull surely waits in subscribe when the shed lands
    w = worker_cls(_Container(ps, eng), "jobs", model="m", poll_timeout=5.0, max_attempts=2)
    republished, classified = threading.Event(), threading.Event()
    requeue, state = w._requeue, w.store.state

    def held_requeue(msg, job, consume_attempt):
        requeue(msg, job, consume_attempt)
        republished.set()
        classified.wait(10.0)  # the waiting pull classifies the payload first

    def watched_state(job_id):
        if republished.is_set():
            classified.set()
        return state(job_id)

    w._requeue, w.store.state = held_requeue, watched_state
    inj.arm("overload_pressure", count=1, delay=30.0)
    h = _WorkerHarness(w)
    try:
        ps.publish_sync("jobs", _job("race"))
        _wait(lambda: w.jobs_requeued == 1 and classified.is_set(), 30, "the shed and the pull's classification")
        if pkg == "port":
            _wait(lambda: w.jobs_ok == 1, 60, "the requeued job")
        else:
            time.sleep(1.0)
            assert w.jobs_ok == 0 and state("race")["status"] == "queued"  # lost: nothing redelivers it
    finally:
        h.stop()
        eng.close()


def test_constrained_job_result_validates_and_equals_jax(weights):
    import jsonschema

    jcfg, jp, tcfg, tp = weights
    schema = {"type": "object", "properties": {"ok": {"type": "boolean"}}}
    payload = json.dumps({"id": "cj", "tokens": [1, 2], "max_new_tokens": 60, "schema": schema}).encode()
    eng = LLMEngine(tcfg, tp, device="cpu", slots=2, max_seq_len=200)
    try:
        got = _jobs_through(BatchWorker, MemoryPubSub, eng, [payload], tokenizer=ByteTokenizer(VOCAB))["cj"]
    finally:
        eng.close()
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, slots=2, max_seq_len=200)
    try:
        want = _jobs_through(JBatchWorker, JMemoryPubSub, ref, [payload], tokenizer=JByteTokenizer(VOCAB))["cj"]
    finally:
        ref.close()
    jsonschema.validate(json.loads(got["text"]), schema)
    assert got["tokens"] == want["tokens"] and got["text"] == want["text"]
    assert got["finish_reason"] == want["finish_reason"] == "eos"


def test_batch_job_span_resumes_the_traceparent(port_engine):
    from gofr_tpu_torch.tracing import RingExporter, Tracer

    tracer = Tracer("batch-test", ring=RingExporter(256))
    ps = MemoryPubSub()
    c = _Container(ps, port_engine)
    c.tracer = tracer
    w = BatchWorker(c, "jobs", model="m", poll_timeout=0.1)
    tp = "00-" + "c" * 32 + "-" + "d" * 16 + "-01"
    h = _WorkerHarness(w)
    try:
        ps.publish_sync("jobs", _job("tj", traceparent=tp))
        _wait(lambda: w.jobs_ok == 1, 60, "traced job")
    finally:
        h.stop()
    spans = tracer.ring.query("c" * 32)
    job = [s for s in spans if s["name"] == "batch.job"]
    assert len(job) == 1 and job[0]["parent_id"] == "d" * 16
    assert job[0]["attributes"]["batch.job_id"] == "tj"


# ---------------------------------------------------------------------------
# the App wiring: cron, /v1/batches, subscribe, the container
# ---------------------------------------------------------------------------

def test_cron_job_publishes_to_topic():
    app = App(config=MapConfig({"PUBSUB_BACKEND": "MEMORY", "HTTP_PORT": "0", "METRICS_PORT": "0",
                                "TRACE_EXPORTER": "none"}))
    attach_batch_worker(app, "jobs", model="m",
                        cron_jobs=[("* * * * *", "nightly", {"tokens": [1, 2], "max_new_tokens": 4})])
    jobs = list(app._cron.jobs)
    assert len(jobs) == 1
    jobs[0].fn(None)
    jobs[0].fn(None)
    payloads = _drain_topic(app.container.pubsub, "jobs")
    assert [p["id"] for p in payloads] == ["nightly_1", "nightly_2"]
    assert all(len(p["traceparent"]) == 55 for p in payloads)  # the tick's root span
    app.container.close()


def test_v1_batches_submit_and_poll(weights):
    import urllib.request

    _, _, tcfg, tp = weights
    app = App(config=MapConfig({"PUBSUB_BACKEND": "MEMORY", "HTTP_PORT": "0", "METRICS_PORT": "0",
                                "TORCH_DEVICE": "cpu", "LOG_LEVEL": "ERROR", "TPU_TELEMETRY_INTERVAL_S": "0",
                                "TPU_LLM_BATCH_CONCURRENCY": "2"}))
    app.container.tpu().register_llm("m", tcfg, tp, kv_paged=True, **ENGINE_KW)
    worker = attach_batch_worker(app, "jobs", model="m")
    assert worker.concurrency == 2 and worker.max_attempts == 3
    app.run_in_background()
    base = f"http://127.0.0.1:{app.http_server.port}"
    try:
        req = urllib.request.Request(base + "/v1/batches", method="POST", data=json.dumps({"jobs": [
            {"id": "a", "tokens": [1, 2, 3], "max_new_tokens": 4}, {"id": "b", "tokens": [4, 5], "max_new_tokens": 3},
        ]}).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            sub = json.loads(resp.read())
        assert sub["status"] == "queued" and sub["jobs"] == ["a", "b"]
        _wait(lambda: worker.jobs_ok == 2, 60, "both jobs")
        with urllib.request.urlopen(base + sub["poll"], timeout=30) as resp:
            view = json.loads(resp.read())
        assert view["status"] == "completed" and view["counts"] == {"ok": 2}
        assert view["jobs"]["b"]["result"]["n_tokens"] == 3
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/v1/batches/batch_nope", timeout=30)
        assert ei.value.code == 404
        bad = urllib.request.Request(base + "/v1/batches", method="POST", data=b'{"jobs": [{"id": "x"}]}',
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=30)
        assert ei.value.code == 400
    finally:
        app.shutdown()
        time.sleep(0.2)


def _subscriber_run(app_cls, config_cls, tmp_path):
    """Publish four messages on a FILE topic and serve an App whose
    subscriber raises on the first delivery of "b", returns an error for
    the first delivery of "c" and handles the rest -> (handled payloads,
    the committed offset, the subscribe counters)."""
    app = app_cls(config=config_cls({"PUBSUB_BACKEND": "FILE", "PUBSUB_FILE_DIR": str(tmp_path), "HTTP_PORT": "0",
                                     "METRICS_PORT": "0", "LOG_LEVEL": "FATAL", "TRACE_EXPORTER": "none"}))
    seen, failed = [], set()

    def handler(ctx):
        body = ctx.bind()
        seen.append(body["v"])
        if body["v"] == "b" and "b" not in failed:
            failed.add("b")
            raise RuntimeError("handler panic")
        if body["v"] == "c" and "c" not in failed:
            failed.add("c")
            return ValueError("try again")
        return None

    for v in "abcd":
        app.container.pubsub.publish_sync("topic", json.dumps({"v": v}))
    app.subscribe("topic", handler)
    app.run_in_background()
    try:
        _wait(lambda: app.container.pubsub._committed("topic") == 4, 30, "four commits")
    finally:
        app.shutdown()
        time.sleep(0.3)
    text = app.container.metrics.render_prometheus()
    counts = sorted(ln for ln in text.splitlines() if ln.startswith("app_pubsub_"))
    return seen, app.container.pubsub._committed("topic"), counts


def test_subscribe_commits_on_success_and_recovers_like_jax(tmp_path):
    got = _subscriber_run(App, MapConfig, tmp_path / "port")
    want = _subscriber_run(gofr_tpu.App, JMapConfig, tmp_path / "jax")
    assert got == want
    assert got[0] == ["a", "b", "b", "c", "c", "d"] and got[1] == 4
    assert 'app_pubsub_subscribe_success_count{topic="topic"} 4' in got[2]


def test_subscribe_loop_starts_at_serve_and_stops_at_shutdown():
    app = App(config=MapConfig({"PUBSUB_BACKEND": "MEMORY", "HTTP_PORT": "0", "METRICS_PORT": "0"}))
    got = []

    async def handler(ctx):
        got.append(ctx.bind())

    app.subscribe("t", handler)
    app.container.pubsub.publish_sync("t", b'{"n": 1}')
    time.sleep(0.2)
    assert got == []  # nothing runs before serve()
    th = app.run_in_background()
    _wait(lambda: got == [{"n": 1}], 10, "delivery")
    app.shutdown()
    th.join(timeout=10)
    assert not th.is_alive() and not app._bg_tasks
    app.container.pubsub.publish_sync("t", b'{"n": 2}')
    time.sleep(0.7)
    assert got == [{"n": 1}]


def test_subscribe_without_a_backend_logs_and_registers_nothing():
    app = App(config=MapConfig({"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "FATAL"}))
    app.subscribe("t", lambda ctx: None)
    assert app.container.pubsub is None and app._subscriptions == {}


# ---------------------------------------------------------------------------
# the backends: FILE across the packages, the switch, the container
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_file_topic_is_read_across_packages_from_the_committed_offset(tmp_path, writer, reader):
    cls = {"jax": JFilePubSub, "port": FilePubSub}
    w = cls[writer](str(tmp_path), group="g")
    for i in range(5):
        w.publish_sync("t", json.dumps({"i": i, "text": "é"}))
    # the writer's own consumer commits the first two
    for _ in range(2):
        asyncio.run(w.subscribe("t", timeout=1.0)).commit()
    r = cls[reader](str(tmp_path), group="g")
    got = []
    for _ in range(3):
        msg = asyncio.run(r.subscribe("t", timeout=1.0))
        got.append(json.loads(msg.value)["i"])
        assert msg.metadata["offset"] == str(2 + len(got) - 1)
        msg.commit()
    assert got == [2, 3, 4]
    assert asyncio.run(r.subscribe("t", timeout=0.1)) is None
    assert w._committed("t") == r._committed("t") == 5
    other = cls[reader](str(tmp_path), group="other")  # a new group reads from 0
    assert json.loads(asyncio.run(other.subscribe("t", timeout=1.0)).value)["i"] == 0
    assert r.health() == {**w.health()}


def test_file_uncommitted_record_is_served_again(tmp_path):
    ps = FilePubSub(str(tmp_path))
    ps.publish_sync("t", b"one")
    ps.publish_sync("t", b"two")
    first = asyncio.run(ps.subscribe("t"))
    again = asyncio.run(ps.subscribe("t"))
    assert first.value == again.value == b"one"
    again.commit()
    again.commit()  # idempotent
    assert asyncio.run(ps.subscribe("t")).value == b"two"
    ps.delete_topic("t")
    assert asyncio.run(ps.subscribe("t", timeout=0.05)) is None


def test_memory_pubsub_equals_jax():
    def walk(cls):
        ps = cls()
        ps.create_topic("empty")
        ps.publish_sync("t", "x")
        asyncio.run(ps.publish("t", b"y"))
        out = [asyncio.run(ps.subscribe("t")).value, asyncio.run(ps.subscribe("t")).value,
               asyncio.run(ps.subscribe("t", timeout=0.05)), ps.health()]
        ps.delete_topic("t")
        ps.close()
        out.append(asyncio.run(ps.subscribe("t", timeout=5.0)))  # closed: returns at once
        return out

    assert walk(MemoryPubSub) == walk(JMemoryPubSub)


@pytest.mark.parametrize("backend", ["KAFKA", "MQTT", "GOOGLE", "kafka"])
def test_new_pubsub_refuses_unported_backends(backend):
    """No backend is refused as unported any more: each name builds the
    class JAX's switch builds (against an address nothing listens on), or
    refuses a config as JAX's does (GOOGLE without an endpoint)."""
    from gofr_tpu.datasource.pubsub import new_pubsub as jnew_pubsub

    values = {"PUBSUB_BROKER": "127.0.0.1:1", "MQTT_HOST": "127.0.0.1", "MQTT_PORT": "1", "MQTT_TIMEOUT": "1"}
    if backend == "GOOGLE":
        for make, cfg in ((new_pubsub, MapConfig), (jnew_pubsub, JMapConfig)):
            with pytest.raises(RuntimeError, match="PUBSUB_EMULATOR_HOST"):
                make(backend, cfg({}))
        values = {"PUBSUB_EMULATOR_HOST": "127.0.0.1:1"}
    built = [new_pubsub(backend, MapConfig(values)), jnew_pubsub(backend, JMapConfig(values))]
    try:
        assert type(built[0]).__name__ == type(built[1]).__name__
        assert type(built[0]).__module__.startswith("gofr_tpu_torch.datasource.pubsub.")
    finally:
        for ps in built:
            ps.close()


def test_new_pubsub_builds_memory_and_file_and_rejects_unknown(tmp_path):
    assert isinstance(new_pubsub("memory", MapConfig({})), MemoryPubSub)
    assert isinstance(new_pubsub("INMEM", MapConfig({})), MemoryPubSub)
    ps = new_pubsub("FILE", MapConfig({"PUBSUB_FILE_DIR": str(tmp_path), "PUBSUB_GROUP": "g1"}))
    assert isinstance(ps, FilePubSub) and ps.dir == str(tmp_path) and ps.group == "g1"
    with pytest.raises(RuntimeError, match="unknown PUBSUB_BACKEND"):
        new_pubsub("CARRIER_PIGEON", MapConfig({}))


def test_container_wires_the_backend_its_counters_and_health_like_jax(tmp_path):
    out = []
    for app_cls, cfg_cls in ((App, MapConfig), (gofr_tpu.App, JMapConfig)):
        app = app_cls(config=cfg_cls({"PUBSUB_BACKEND": "FILE", "PUBSUB_FILE_DIR": str(tmp_path / app_cls.__module__),
                                      "HTTP_PORT": "0", "METRICS_PORT": "0", "TRACE_EXPORTER": "none"}))
        c = app.container
        assert c.get_publisher() is c.pubsub is c.get_subscriber()
        c.pubsub.publish_sync("t", b"{}")
        health = c.health()["pubsub"]
        text = c.metrics.render_prometheus()
        out.append((type(c.pubsub).__name__, health["status"], health["details"]["backend"],
                    health["details"]["topics"],
                    sorted(ln for ln in text.splitlines() if "app_pubsub" in ln and not ln.startswith("#"))))
        c.close()
    assert out[0] == out[1]
    assert out[0][3] == {"t": {"messages": 1, "committed": 0}}


def test_subscribe_context_request_shape():
    msg = Message("orders", b'{"a": 1, "b": 2}', metadata={"offset": "7", "key": "k"})
    req = SubscribeContextRequest(msg)
    assert req.bind() == {"a": 1, "b": 2}
    assert req.param("offset") == "7" and req.params("key") == ["k"] and req.params("none") == []
    assert req.path_param("topic") == "orders" and req.host_name() == "orders" and req.header("key") == "k"

    class T:
        a: int

    assert req.bind(T()).a == 1
