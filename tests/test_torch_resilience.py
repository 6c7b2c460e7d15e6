"""gofr_tpu_torch's recovery pieces against gofr_tpu's (CPU, tiny f32
presets): the fault injector, the device-health ledger, the retry budget
and device keys on the same calls and clocks; one engine's per-iteration
recovery, numerical and step watchdogs and graceful drain against the JAX
engine's outcomes on the same inputs; and the app's drain route and
health. The fleet (failover, supervisor, canary, poison, placement) is in
test_torch_fleet.py."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import generate as j_generate
from gofr_tpu.models import transformer as JT
from gofr_tpu.resilience import DeviceHealthLedger as JLedger
from gofr_tpu.resilience import FaultInjector as JInjector
from gofr_tpu.resilience import RetryBudget as JBudget
from gofr_tpu.resilience.faults import _arm_from_env as j_arm_from_env
from gofr_tpu_torch.llm import EngineDraining, EngineStoppedError, GenRequest, LLMEngine
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.resilience import (
    DeviceHealthLedger,
    FaultInjector,
    RetryBudget,
    StepWatchdog,
    device_key,
    spec_device_key,
)
from gofr_tpu_torch.resilience.faults import _arm_from_env

# the JAX resilience tests' engine shapes (tests/test_resilience.py)
ENGINE_KW = dict(slots=2, max_seq_len=64, prefill_buckets=(8,))


def _pair(nan_token: int | None = None):
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    # untied random head: the tied tiny model repeats its input token
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    if nan_token is not None:
        jp = dict(jp, embed=jp["embed"].at[nan_token].set(jnp.nan))
    tcfg = TT.TransformerConfig.tiny()
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def weights():
    return _pair()


@pytest.fixture
def one_thread():
    """Torch on one intra-op thread for a watchdog test: on the CPU a
    dispatch beat times the program itself, and an oversubscribed thread
    pool (test workers x torch threads) stretched a tiny step past a
    second."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(weights, prompt: list[int], n: int) -> list[int]:
    jcfg, jp, _tcfg, _tp = weights
    out = j_generate(jp, jcfg, jnp.asarray([prompt], jnp.int32), jnp.asarray([len(prompt)], jnp.int32), n)
    return [int(t) for t in np.asarray(out)[0]]


def _wait(pred, timeout: float, what: str) -> None:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


# -- the fault injector, against JAX's on the same calls ------------------------


def _injector_script(Inj, arm_env):
    out = []
    inj = Inj()
    inj.arm("device_step", count=2)
    out += [inj.take("device_step") is not None for _ in range(3)] + [inj.fired("device_step")]
    inj.arm("replica_kill", label="llm/r0")
    out += [inj.take("replica_kill", "llm/r1") is None, inj.take("replica_kill", "llm/r0") is not None,
            inj.take("replica_kill", "llm/r0") is None]
    inj.arm("replica_kill", label="/r1")  # a suffix: not "llm/r10"
    out += [inj.take("replica_kill", "llm/r10") is None, inj.take("replica_kill", "llm/r1") is not None]
    with pytest.raises(ValueError, match="unknown fault point"):
        inj.arm("nope")
    env = Inj()
    arm_env(env, "replica_kill=1,step_latency=2:1.5, bogus=x,device_sick=3@cuda:0,nan_logits=1")
    out.append(env.snapshot())
    out += [env.take("device_sick", "cuda:1") is None, env.take("device_sick", "cuda:0") is not None]
    tagged = Inj()
    tagged.arm("device_step", tag="boom", count=-1)
    tagged.arm("device_step", count=1)
    out += [tagged.take("device_step", "llm", tag="other") is None, tagged.take("device_step", "llm").tag,
            tagged.take("device_step", "llm") is None, tagged.take("device_step", "llm", tag="boom").tag,
            tagged.has_tagged("device_step")]
    tagged.disarm()
    out.append(tagged.has_tagged("device_step"))
    forever = Inj()
    forever.arm("device_step", count=-1)
    out.append(forever.take("device_step") is not None)
    forever.disarm("device_step")
    out += [forever.take("device_step") is None, forever.snapshot()]
    return out


def test_fault_injector_matches_jax():
    got = _injector_script(FaultInjector, _arm_from_env)
    assert got == _injector_script(JInjector, j_arm_from_env)
    assert got[:4] == [True, True, False, 2]


def test_default_injector_arms_from_env(monkeypatch):
    from gofr_tpu_torch.resilience import faults

    monkeypatch.setenv("TPU_LLM_FAULTS", "replica_kill=2@/r1")
    monkeypatch.setattr(faults, "_default", faults._DefaultHolder())
    inj = faults.default_injector()
    assert inj.snapshot()["armed"] == {"replica_kill": [{"count": 2, "label": "/r1", "delay": 0.0}]}
    assert faults.default_injector() is inj


# -- the device-health ledger and the retry budget, on the same clocks ------------


def _ledger_script(Ledger):
    out = []
    clock = {"t": 0.0}

    def led(**kw):
        return Ledger(now_fn=lambda: clock["t"], **{"failures": 3, "window_s": 10.0, "cooldown_s": 5.0, **kw})

    a = led()  # K failures in the window trip quarantine
    out += [a.record_failure("d0", "step_fault"), a.record_failure("d0", "watchdog_hang"), a.state("d0"),
            a.usable("d0"), a.record_failure("d0", "rebuild_failure"), a.state("d0"), a.usable("d0"),
            a.quarantines, a.state("d1")]
    clock["t"] = 0.0
    b = led()  # failures age out of the window
    b.record_failure("d0", "step_fault")
    b.record_failure("d0", "step_fault")
    clock["t"] = 11.0
    out += [b.record_failure("d0", "step_fault"), b.state("d0")]
    clock["t"] = 0.0
    c = led(failures=1)  # cooldown -> probation -> a passing probe reintegrates
    c.record_failure("d0", "numerical")
    out.append(c.state("d0"))
    clock["t"] = 5.1
    out += [c.state("d0"), c.usable("d0"), c.quarantined_count()]
    c.probe_ok("d0")
    out += [c.state("d0"), c.quarantined_count()]
    clock["t"] = 0.0
    d = led(failures=1)  # a failure while quarantined doubles the cooldown
    d.record_failure("d0", "step_fault")
    clock["t"] = 5.1
    out.append(d.record_failure("d0", "rebuild_failure"))
    for t in (5.1 + 5.0, 5.1 + 10.1):
        clock["t"] = t
        out.append(d.state("d0"))
    snap = d.snapshot()
    out.append({k: v for k, v in snap.items() if k != "devices"})
    out.append({k: v for k, v in snap["devices"]["d0"].items()})
    out.append([Ledger.classify(w) for w in (
        "step watchdog: fetch:chunk exceeded 0.3s", "numerical watchdog: non-finite logits (decode chunk)",
        "canary rejected: diverged", "device_sick: build refused on cuda:0", "fault injection: replica_kill",
        "scheduler thread exited unexpectedly", None,
    )])
    return out


def test_health_ledger_matches_jax():
    got = _ledger_script(DeviceHealthLedger)
    assert got == _ledger_script(JLedger)
    assert got[5] == "quarantined" and got[-1][:3] == ["watchdog_hang", "numerical", "rebuild_failure"]


def test_retry_budget_matches_jax():
    def script(Budget):
        clock = {"t": 0.0}
        b = Budget(rate=2.0, burst=3.0, now_fn=lambda: clock["t"])
        out = [b.take() for _ in range(4)]
        clock["t"] = 0.75
        out += [round(b.remaining(), 6), b.take(), b.take()]
        off = Budget(rate=0.0, burst=0.0, now_fn=lambda: clock["t"])
        return out + [off.take()]

    assert script(RetryBudget) == script(JBudget) == [True, True, True, False, 1.5, True, False, False]


def test_device_keys():
    assert device_key(torch.device("cuda:0")) == device_key("cuda") == "cuda:0"
    assert device_key(torch.device("cuda", 3)) == "cuda:3"
    assert device_key(torch.device("cpu")) == device_key("cpu") == "cpu"
    assert spec_device_key({"device": torch.device("cpu")}) == "cpu"
    assert spec_device_key({}) == "default"


# -- one engine: per-iteration recovery, typed errors --------------------------------


def test_stopped_engine_raises_typed(weights):
    _jcfg, _jp, tcfg, tp = weights
    eng = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW)
    eng.close()
    with pytest.raises(EngineStoppedError):
        eng.submit(GenRequest([1, 2], max_new_tokens=2))
    assert issubclass(EngineStoppedError, RuntimeError)


def test_admission_oom_is_retried_transparently(weights):
    """Nothing is pulled when the fault fires: the next pass admits the
    request and the caller never notices (JAX test_resilience)."""
    _jcfg, _jp, tcfg, tp = weights
    inj = FaultInjector()
    eng = LLMEngine(tcfg, tp, device="cpu", fault_injector=inj, **ENGINE_KW)
    try:
        inj.arm("admission_oom", count=1)
        assert eng.generate([5, 9, 2], max_new_tokens=4) == _reference(weights, [5, 9, 2], 4)
        assert inj.fired("admission_oom") == 1 and eng.alive()
    finally:
        eng.close()


def test_device_step_fault_recovers_engine(weights):
    """A dispatch that raises: the pass's recovery ends the request in
    flight (no fleet to fail over to), and the engine serves the next one
    with the reference tokens."""
    _jcfg, _jp, tcfg, tp = weights
    inj = FaultInjector()
    eng = LLMEngine(tcfg, tp, device="cpu", prefill_chunk=4, step_token_budget=4, fault_injector=inj, **ENGINE_KW)
    try:
        inj.arm("device_step", count=1)
        req = eng.submit(GenRequest(list(range(1, 9)), max_new_tokens=4))
        toks = req.tokens(timeout=30)
        assert req.finish_reason in ("cancelled", "length") and len(toks) <= 4
        assert inj.fired("device_step") == 1 and eng.alive()
        assert eng.generate([5, 9, 2], max_new_tokens=4) == _reference(weights, [5, 9, 2], 4)
    finally:
        eng.close()


# -- the numerical watchdog: the same outcome as the JAX engine -------------------------

NAN_TOKEN = 77


def _nan_outcome(eng, R, prompt, arm=None, new: int = 8) -> dict:
    req = eng.submit(R(list(prompt), max_new_tokens=new))
    if arm is not None:
        _wait(lambda: req.emitted > 0, 30, "a first token")
        arm()
    toks = req.tokens(timeout=30)
    if eng.numeric_check:
        _wait(lambda: not eng.alive(), 10, "the numerical death")
    return {"alive": eng.alive(), "reason": (eng.died_reason or "").split(" (")[0], "finish": req.finish_reason,
            "sentinel": -1 in toks, "n": len(toks), "trips": eng.numerical_trips}


@pytest.mark.parametrize("check", [True, False])
def test_nan_embedding_row_matches_jax(check):
    """A prompt that reaches a NaN embedding row: non-finite logits from its
    first token on. With the watchdog on, both engines die with a
    numerical reason and end the request the same way; with it off, both
    stay alive and stream to the length (the port streams the -1
    sentinel, the JAX engine, whose programs then carry no guard, other
    garbage)."""
    jcfg, jp, tcfg, tp = _pair(nan_token=NAN_TOKEN)
    kw = dict(ENGINE_KW, numeric_check=check)
    ref = JEngine(jcfg, jp, warmup=False, **kw)
    port = LLMEngine(tcfg, tp, device="cpu", **kw)
    try:
        prompt = [5, NAN_TOKEN, 9]
        want, got = _nan_outcome(ref, JRequest, prompt), _nan_outcome(port, GenRequest, prompt)
        assert {k: v for k, v in got.items() if k != "sentinel"} == {k: v for k, v in want.items() if k != "sentinel"}
        if check:
            assert got["reason"] == "numerical watchdog: non-finite logits" and not got["alive"]
            assert got["finish"] == "cancelled" and got["trips"] == 1 and got["n"] == 0
        else:
            assert got["alive"] and got["finish"] == "length" and got["sentinel"] and got["n"] == 8
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("check", [True, False])
def test_nan_logits_seam_matches_jax(weights, check):
    """The ``nan_logits`` seam mid-decode: with the watchdog the engine dies
    with a numerical reason and nothing of the sentinel reaches the
    stream; without it the sentinel streams and the engine lives on (JAX
    test_device_health's two cases, on both engines)."""
    jcfg, jp, tcfg, tp = weights
    outs = []
    for eng, R in ((JEngine(jcfg, jp, warmup=False, fault_injector=(ji := JInjector()), numeric_check=check,
                            prefill_chunk=4, step_token_budget=4, decode_chunk=2, **ENGINE_KW), JRequest),
                   (LLMEngine(tcfg, tp, device="cpu", fault_injector=(ti := FaultInjector()), numeric_check=check,
                              prefill_chunk=4, step_token_budget=4, decode_chunk=2, **ENGINE_KW), GenRequest)):
        inj = ji if R is JRequest else ti
        try:
            # a long stream: still decoding when the seam is armed
            out = _nan_outcome(eng, R, [5, 9, 2], arm=lambda inj=inj: inj.arm("nan_logits"), new=32)
            outs.append({k: v for k, v in out.items() if k != "n"})
        finally:
            eng.close()
    assert outs[0] == outs[1]
    assert outs[1]["sentinel"] is not check and outs[1]["alive"] is not check
    assert outs[1]["reason"] == ("numerical watchdog: non-finite logits" if check else "")


# -- the step watchdog ---------------------------------------------------------------------


def test_hung_fetch_trips_watchdog(weights, one_thread):
    """A fetch hung past ``step_watchdog_s``: the engine dies within the
    threshold plus one interval with a "step watchdog" reason, and the
    consumer gets its end of stream, not a hang."""
    _jcfg, _jp, tcfg, tp = weights
    inj = FaultInjector()
    # on the CPU a dispatch beat times the program itself, and a cold
    # engine's first programs can take a second under a loaded test run:
    # the watchdog starts on a warm engine (JAX: warm engines, or a
    # threshold above the compile time)
    eng = LLMEngine(tcfg, tp, device="cpu", fault_injector=inj, **ENGINE_KW)
    try:
        assert len(eng.generate([5, 9, 2], max_new_tokens=4)) == 4
        eng.step_watchdog_s = 1.0
        eng.watchdog = StepWatchdog(eng, 1.0)
        inj.arm("step_latency", delay=4.0)
        t0 = time.perf_counter()
        req = eng.submit(GenRequest([5, 9, 2], max_new_tokens=4))
        _wait(lambda: not eng.alive(), 3.0, "the watchdog's death")
        assert time.perf_counter() - t0 < 3.5, "the trip waited out the whole hang"
        assert eng.watchdog.trips == 1 and (eng.died_reason or "").startswith("step watchdog: fetch:")
        assert len(req.tokens(timeout=10)) < 4 and req.finish_reason == "cancelled"
        assert eng.stats()["watchdog_trips"] == 1
    finally:
        eng.close()


def test_watchdog_off_by_default_and_knob(weights, monkeypatch):
    _jcfg, _jp, tcfg, tp = weights
    monkeypatch.setenv("TPU_LLM_STEP_WATCHDOG_S", "7.5")
    monkeypatch.setenv("TPU_LLM_NUMERIC_CHECK", "0")
    eng = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW)
    try:
        assert eng.step_watchdog_s == 7.5 and eng.watchdog is not None and not eng.numeric_check
    finally:
        eng.close()
    monkeypatch.delenv("TPU_LLM_STEP_WATCHDOG_S")
    monkeypatch.delenv("TPU_LLM_NUMERIC_CHECK")
    eng = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW)
    try:
        assert eng.step_watchdog_s == 0 and eng.watchdog is None and eng.numeric_check
    finally:
        eng.close()


# -- the graceful drain -----------------------------------------------------------------------


def test_drain_refuses_new_completes_inflight(weights):
    _jcfg, _jp, tcfg, tp = weights
    eng = LLMEngine(tcfg, tp, device="cpu", slots=2, max_seq_len=128, prefill_buckets=(8,), decode_chunk=2,
                    lookahead=1)
    gate = threading.Event()
    process = eng._process_entry

    def held(entry):  # the first token out, then held until the drain began
        process(entry)
        gate.wait(10)

    eng._process_entry = held
    try:
        want = _reference(weights, [5, 9, 2], 32)
        req = eng.submit(GenRequest([5, 9, 2], max_new_tokens=32))
        _wait(lambda: req.emitted > 0, 30, "a first token")
        eng.drain()
        assert not eng.drained() and eng.alive() and not eng.accepting()
        with pytest.raises(EngineDraining):
            eng.submit(GenRequest([1, 2], max_new_tokens=2))
        assert EngineDraining.status_code == 503 and EngineDraining.retry_after == 5.0
        assert eng.stats()["draining"] is True and eng.debug_state()["draining"] is True
        gate.set()
        assert req.tokens(timeout=60) == want
        _wait(eng.drained, 10, "drained")
        assert eng.alive()
        eng.undrain()
        assert eng.accepting() and eng.generate([5, 9, 2], max_new_tokens=4) == want[:4]
    finally:
        gate.set()
        eng.close()


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, dict(r.headers), json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"null")


def test_app_drain_route_flips_readiness_and_stops(weights):
    """POST /.well-known/debug/drain: health 503 with a Retry-After at once,
    liveness 200, the engine's admission closed, and the server closes
    once the engine is drained (JAX TestAppDrain, with an engine)."""
    from gofr_tpu_torch.app import new
    from gofr_tpu_torch.config import new_mock_config

    _jcfg, _jp, tcfg, tp = weights
    app = new(config=new_mock_config({"HTTP_PORT": "0", "METRICS_PORT": "0", "GOFR_DRAIN_DEADLINE_S": "5", "TORCH_DEVICE": "cpu"}))
    eng = app.container.tpu().register_llm("m", tcfg, tp, **ENGINE_KW)
    th = app.run_in_background()
    base = f"http://127.0.0.1:{app.http_server.port}"
    try:
        status, _h, body = _get(f"{base}/.well-known/health")
        assert status == 201 or status == 200, status
        assert body["data"]["status"] == "UP"
        req = urllib.request.Request(f"{base}/.well-known/debug/drain", method="POST", data=b"")
        with urllib.request.urlopen(req, timeout=5) as r:
            assert json.load(r)["data"] == {"draining": True, "started": True, "deadline_s": 5.0}
        status, headers, _ = _get(f"{base}/.well-known/health")
        assert status == 503 and headers.get("Retry-After") == "5"
        assert _get(f"{base}/.well-known/alive")[0] in (200, 201)
        with pytest.raises(EngineDraining):
            eng.submit(GenRequest([1, 2], max_new_tokens=2))
        th.join(timeout=10)
        assert not th.is_alive(), "the drain did not shut the app down"
    finally:
        app.shutdown()
        th.join(timeout=10)


def test_drain_route_is_loopback_only():
    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.handler import _require_loopback

    class Ctx:
        def __init__(self, addr, cfg):
            self.request = type("R", (), {"remote_addr": addr})()
            self.container = type("C", (), {"config": cfg})()

    _require_loopback(Ctx("127.0.0.1:5000", new_mock_config({})), "GOFR_DRAIN_REMOTE")
    with pytest.raises(Exception, match="loopback-only") as ei:
        _require_loopback(Ctx("10.1.2.3:5000", new_mock_config({})), "GOFR_DRAIN_REMOTE")
    assert ei.value.status_code == 403
    _require_loopback(Ctx("10.1.2.3:5000", new_mock_config({"GOFR_DRAIN_REMOTE": "1"})), "GOFR_DRAIN_REMOTE")


def test_edge_maps_draining_and_poison():
    """The serving edge answers a draining engine 503 with a Retry-After on
    /generate and the OpenAI route, and a poison refusal 500, as the JAX
    edge does."""
    import urllib.request

    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.llm import PoisonedRequestError
    from gofr_tpu_torch.serve import build_app

    app = build_app(new_mock_config({"HTTP_PORT": "0", "METRICS_PORT": "0", "TORCH_DEVICE": "cpu", "GEMMA_PRESET": "tiny",
                                     "LLM_MAX_SEQ": "64", "LOG_LEVEL": "WARN"}))
    th = app.run_in_background()
    base = f"http://127.0.0.1:{app.http_server.port}"

    def post(path, body):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers)

    try:
        eng = app.container.tpu().llm("gemma")
        assert post("/generate", {"tokens": [1, 2, 3], "max_new_tokens": 2})[0] == 201
        real = eng.generate

        def poisoned(*a, **k):
            raise PoisonedRequestError("request implicated in 2 replica deaths; failover refused")

        eng.generate = poisoned
        assert post("/generate", {"tokens": [1, 2, 3], "max_new_tokens": 2})[0] == 500
        eng.generate = real
        eng.drain()
        status, headers = post("/generate", {"tokens": [1, 2, 3], "max_new_tokens": 2})
        assert status == 503 and headers.get("Retry-After") == "5"
        status, headers = post("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                                        "max_tokens": 2})
        assert status == 503 and headers.get("Retry-After") == "5"
    finally:
        app.shutdown()
        th.join(timeout=10)
