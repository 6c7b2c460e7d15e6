"""gofr_tpu_torch.profiling (the capture registry, ``torch.profiler``
capture) and the device-observability routes against gofr_tpu.profiling
and the JAX app's routes (CPU, f32 tiny preset, ``TORCH_DEVICE=cpu``).

Held equal: the registry's snapshot for the same calls (exact); the
engine route's JSON keys with and without ``?serving=1`` for the same
engine state (the serving summary's keys exactly; each engine's
``debug_state`` has JAX's keys plus ``PORT_EXTRAS``, the recovery and
recorder fields the port's incident bundles carry); ``/debug/compiles``'
keys and row keys; ``POST /debug/profile``'s listing keys, its archive
and its 409 while a capture runs. On the CPU the port's registry holds
each program family the engine ran (its first eager run), and a capture
never outlives its budget (``ProfileTimeout``)."""

import http.client
import io
import json
import threading
import time
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gofr_tpu
from gofr_tpu import profiling as JP
from gofr_tpu.config import new_mock_config as jax_mock_config
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch import app as tapp
from gofr_tpu_torch import profiling as TP
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.profiling.capture import ProfileBusy, ProfilerCapture, ProfileTimeout

KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8, 16))
# the port's debug_state fields beyond JAX's: recovery and recorder state
PORT_EXTRAS = {"anomaly", "died", "errored", "finished", "flight_records", "load", "load_tokens", "numeric_check",
               "step_watchdog_s"}


def test_registry_snapshot_equals_jax():
    regs = (JP.CompileRegistry(), TP.CompileRegistry())
    for reg in regs:
        reg.record_compile(program="llm.step_p16_d8", model="m", arg_shapes=("step", "(16, 1)"), compile_s=0.25,
                           backend="cuda", measured="capture")
        reg.record_compile(program="llm.step_p16_d8", model="m", arg_shapes=("step", "(16, 1)"), compile_s=0.5,
                           backend="cuda", measured="capture")
        reg.record_compile(program="llm.decode_chunk8", model="n", arg_shapes=("chunk", "8"), compile_s=0.125,
                           backend="cuda", measured="capture")
        for _ in range(3):
            reg.note_hit("llm.step_p16_d8", "m", ("step", "(16, 1)"))
        reg.note_hit("unknown", "m", ())
        reg.note_backend_event("capture", 0.5)
        reg.record_warmup("m", 1.23456, programs=2)
    snaps = [r.snapshot() for r in regs]
    for s in snaps:
        for w in s["warmup"].values():
            w.pop("at")
    assert snaps[1] == snaps[0]
    assert regs[1].snapshot(model="n") == regs[0].snapshot(model="n")
    assert regs[1].remove_model("m") == regs[0].remove_model("m") == 1
    assert regs[1].snapshot()["totals"] == regs[0].snapshot()["totals"]


def test_engine_rows_on_the_cpu():
    """Each family the engine runs is one row (its first eager run), every
    later run a hit; ``compile_metrics`` series under the JAX names; close
    removes the rows."""
    from gofr_tpu_torch.llm import LLMEngine
    from gofr_tpu_torch.metrics import Manager

    cfg = TT.TransformerConfig.tiny()
    params = TT.params_from_jax(
        jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), JT.TransformerConfig.tiny())), cfg,
        device="cpu")
    m = Manager()
    eng = LLMEngine(cfg, params, device="cpu", kv_label="rows", metrics=m, **KW)
    try:
        for n in (3, 12, 20):
            eng.generate(list(range(1, n + 1)), max_new_tokens=10)
        snap = TP.default_registry().snapshot(model="rows")
        progs = {p["program"]: p for p in snap["programs"]}
        assert set(progs) == eng._ran and all(p["measured"] == "first_call" for p in progs.values())
        assert sum(p["hits"] for p in progs.values()) > 0
        text = m.render_prometheus()
        assert "app_jax_compiles_total{" in text and "app_jax_trace_cache_hits_total{" in text
    finally:
        eng.close()
    assert TP.default_registry().snapshot(model="rows")["programs"] == []


def _http(port, method, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def apps():
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), TT.TransformerConfig.tiny(), device="cpu")
    common = {"HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "30", "LOG_LEVEL": "ERROR", "TPU_TELEMETRY_INTERVAL_S": "0"}
    japp = gofr_tpu.new(config=jax_mock_config({**common, "METRICS_PORT": "0", "TRACE_EXPORTER": "none"}))
    japp.container.tpu().register_llm("gemma", jcfg, jp, warmup=False, kv_paged=True, **KW)
    papp = tapp.new(new_mock_config({**common, "TORCH_DEVICE": "cpu"}))
    papp.container.tpu().register_llm("gemma", TT.TransformerConfig.tiny(), tp, **KW)
    threads = [japp.run_in_background(), papp.run_in_background()]
    for app in (japp, papp):
        app.container.tpu().llm("gemma").generate([1, 2, 3, 4], max_new_tokens=5)
    yield japp, papp
    for app, th in zip((japp, papp), threads):
        app.shutdown()
        th.join(timeout=10)


def _get(app, path):
    status, _ct, body = _http(app.http_server.port, "GET", path)
    assert status == 200, body
    return json.loads(body)["data"]


def test_engine_route_keys_equal_jax(apps):
    jd, td = (_get(a, "/.well-known/debug/engine") for a in apps)
    assert set(td) == set(jd) == {"platform", "engines", "serving"}
    assert td["platform"] == jd["platform"] == "cpu"
    assert set(td["serving"]) == set(jd["serving"]) and set(td["serving"]["models"]) == {"gemma"}
    assert set(td["serving"]["models"]["gemma"]) == set(jd["serving"]["models"]["gemma"])
    je, te = jd["engines"]["gemma"], td["engines"]["gemma"]
    assert set(je) <= set(te) and set(te) - set(je) == PORT_EXTRAS
    for key in ("phases", "mfu", "slo", "spec", "adapters", "overload"):
        if isinstance(je[key], dict):
            assert set(te[key]) == set(je[key]), key
    js, ts = (_get(a, "/.well-known/debug/engine?serving=1") for a in apps)
    assert set(ts) == set(js) == {"serving"} and set(ts["serving"]) == set(js["serving"])


def test_compiles_route_keys_equal_jax(apps):
    jd, td = (_get(a, "/.well-known/debug/compiles") for a in apps)
    assert set(td) == set(jd) and set(td["totals"]) == set(jd["totals"])
    jrows = [p for p in jd["programs"] if p["model"] == "gemma"]
    trows = [p for p in td["programs"] if p["model"] == "gemma"]
    assert trows and jrows and {frozenset(p) for p in trows} == {frozenset(p) for p in jrows}


def test_profile_route_listing_archive_and_busy(apps):
    outs = []
    for app in apps:
        status, _ct, body = _http(app.http_server.port, "POST", "/.well-known/debug/profile?seconds=0.3&download=0")
        assert status == 201, body
        outs.append(json.loads(body)["data"])
    jd, td = outs
    assert set(td) == set(jd) and td["mode"] in ("torch", "fallback") and "archive" not in td
    assert {"capture.json", "engine_samples.json"} <= set(td["files"])
    if td["mode"] == "torch":
        assert "trace.json" in td["files"]
    for app in apps:  # the archive itself: 200 with the zip, as JAX's file response
        status, ctype, body = _http(app.http_server.port, "POST", "/.well-known/debug/profile?seconds=0.2")
        assert status == 200 and ctype == "application/zip"
        assert "capture.json" in zipfile.ZipFile(io.BytesIO(body)).namelist()
    for app in apps:
        status, _ct, _b = _http(app.http_server.port, "POST", "/.well-known/debug/profile?seconds=x")
        assert status == 400
        first = {}
        th = threading.Thread(target=lambda a=app: first.setdefault(
            "s", _http(a.http_server.port, "POST", "/.well-known/debug/profile?seconds=2&download=0")))
        th.start()
        time.sleep(0.8)
        status, _ct, body = _http(app.http_server.port, "POST", "/.well-known/debug/profile?seconds=0.2&download=0")
        th.join(timeout=60)
        assert status == 409 and first["s"][0] == 201


def test_capture_returns_within_its_budget(tmp_path):
    """A stop that outgrows the budget: the caller gets ProfileTimeout
    within the budget; the capturer stays busy until the worker is done."""
    cap = ProfilerCapture(str(tmp_path))
    gate = threading.Event()

    def until():
        gate.wait(5.0)  # a caller condition that hangs past the budget
        return True

    t0 = time.perf_counter()
    with pytest.raises(ProfileTimeout, match="budget"):
        cap.capture(0.2, until=until, budget_s=0.5)
    assert time.perf_counter() - t0 < 2.0
    with pytest.raises(ProfileBusy):
        cap.capture(0.1, budget_s=1.0)
    gate.set()
    t0 = time.perf_counter()
    while cap._busy.locked() and time.perf_counter() - t0 < 30:
        time.sleep(0.05)
    res = cap.capture(0.1, budget_s=30.0)
    assert res["mode"] in ("torch", "fallback") and "capture.json" in res["files"]
    with pytest.raises(ValueError, match="finite"):
        cap.capture(float("nan"), budget_s=1.0)
