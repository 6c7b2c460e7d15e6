"""gofr_tpu_torch.llm.ReplicatedLLMEngine against gofr_tpu's fleet (CPU,
f32 tiny preset with an untied random head): in-flight failover of a
killed, hung or numerically tripped replica streams exactly the JAX
reference tokens (greedy, ``gofr_tpu.models.generate``); the typed
errors, poison quarantine, the supervisor and the canary gate behave as
the JAX tests pin them; the placement policy and the supervisor make the
JAX fleet's decisions on the same death sequence (host-only stubs fed
device keys), except where the port deliberately places several replicas
on one device; routing, the shared ledger, the fleet cap, the runtime's
``register_llm(replicas=)`` and the app's drain and health with a fleet."""

import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.llm import ReplicatedLLMEngine as JFleet
from gofr_tpu.models import generate as j_generate
from gofr_tpu.models import transformer as JT
from gofr_tpu.resilience import DeviceHealthLedger as JLedger
from gofr_tpu.resilience import ReplicaSupervisor as JSupervisor
from gofr_tpu_torch.llm import (
    EngineOverloaded,
    EngineStoppedError,
    GenRequest,
    LLMEngine,
    PoisonedRequestError,
    RequestFailed,
    ReplicatedLLMEngine,
)
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.resilience import DeviceHealthLedger, FaultInjector, ReplicaSupervisor, StepWatchdog, canary_check
from gofr_tpu_torch.resilience.health import CANARY_MAX_NEW

# small chunks, so prefill and decode take many scheduler passes (room to
# kill mid-flight): tests/test_resilience.py's fleet
FLEET_KW = dict(slots=2, max_seq_len=128, prefill_buckets=(8,), prefill_chunk=4, step_token_budget=4,
                decode_chunk=2, lookahead=1, device="cpu")
PROMPT = [5, 9, 2, 11, 7, 3, 13, 1, 4, 6, 8, 10, 12, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24]


@pytest.fixture(scope="module")
def weights():
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    # untied random head: the tied tiny model repeats its input token
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    tcfg = TT.TransformerConfig.tiny()
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


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


_REFS: dict = {}


def _reference(weights, prompt, n: int) -> list[int]:
    """The JAX plain ``generate`` (computed once per prompt and length)."""
    key = (tuple(prompt), n)
    if key not in _REFS:
        jcfg, jp, _tcfg, _tp = weights
        out = j_generate(jp, jcfg, jnp.asarray([list(prompt)], jnp.int32), jnp.asarray([len(prompt)], jnp.int32), n)
        _REFS[key] = [int(t) for t in np.asarray(out)[0]]
    return _REFS[key]


def _fleet(weights, inj, *, replicas=2, supervise=False, **kw):
    _jcfg, _jp, tcfg, tp = weights
    return ReplicatedLLMEngine(tcfg, tp, replicas=replicas, fault_injector=inj, supervise=supervise,
                               **{**FLEET_KW, **kw})


def _wait(pred, timeout: float, what: str) -> None:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


@pytest.fixture
def fast_supervisor(monkeypatch):
    monkeypatch.setenv("TPU_LLM_SUPERVISOR_INTERVAL_S", "0.02")
    monkeypatch.setenv("TPU_LLM_RESTART_BACKOFF_S", "0.02")


# -- typed errors and routing around the dead ---------------------------------------


def test_submit_skips_dead_replica_and_all_dead_raises(weights):
    inj = FaultInjector()
    rep = _fleet(weights, inj)
    try:
        inj.arm("replica_kill", label="/r0")
        _wait(lambda: not rep.engines[0].alive(), 10, "replica 0's death")
        assert rep.engines[0].died_reason == "fault injection: replica_kill"
        for _ in range(2):
            assert rep.generate([5, 9, 2], max_new_tokens=4) == _reference(weights, [5, 9, 2], 4)
        assert rep.engines[1].submitted >= 2
        inj.arm("replica_kill")
        _wait(lambda: not any(e.alive() for e in rep.engines), 10, "the fleet's death")
        with pytest.raises(EngineStoppedError, match="all replicas dead"):
            rep.submit(GenRequest([1, 2], max_new_tokens=2))
    finally:
        rep.close()


# -- in-flight failover: the JAX reference, token for token --------------------------


def test_kill_mid_decode_token_identical(weights):
    inj = FaultInjector()
    rep = _fleet(weights, inj)
    try:
        want = _reference(weights, PROMPT, 48)
        req = rep.engines[0].submit(GenRequest(list(PROMPT), max_new_tokens=48))  # pinned to r0
        got = []
        for t in req.stream(timeout=60):
            got.append(t)
            if len(got) == 1:  # decoding: kill its replica under it
                inj.arm("replica_kill", label="/r0")
        assert got == want and req.finish_reason == "length"
        assert rep.failovers >= 1 and req.retries == 1 and req.deaths == 1
        assert not rep.engines[0].alive() and rep.engines[1].submitted >= 1
        assert req.engine_version == "v1" and req._replay_pos > len(PROMPT)
    finally:
        rep.close()


def test_kill_mid_prefill_token_identical(weights):
    inj = FaultInjector()
    rep = _fleet(weights, inj)
    hold = threading.Event()
    eng0 = rep.engines[0]
    step = eng0._dispatch_step

    def after_first_chunk():  # the kill lands between two prefill chunks
        out = step()
        if eng0.steps >= 1:
            inj.arm("replica_kill", label="/r0")
            hold.set()
        return out

    eng0._dispatch_step = after_first_chunk
    try:
        want = _reference(weights, PROMPT, 8)
        req = eng0.submit(GenRequest(list(PROMPT), max_new_tokens=8))
        assert hold.wait(30)
        assert req.tokens(timeout=60) == want and req.finish_reason == "length"
        assert rep.failovers == 1 and req.deaths == 1 and req._replay_pos < len(PROMPT)
    finally:
        rep.close()


def test_no_live_replica_errors_out(weights):
    inj = FaultInjector()
    rep = _fleet(weights, inj)
    try:
        req = rep.engines[0].submit(GenRequest(list(PROMPT), max_new_tokens=48))
        _wait(lambda: req.emitted > 0, 30, "a first token")
        inj.arm("replica_kill", count=2)
        try:
            toks = req.tokens(timeout=30)
        except (PoisonedRequestError, RequestFailed):
            toks = []
        assert req.finish_reason in ("error", "cancelled", "poison") and len(toks) < 48
        assert rep.failover_errors + rep.failovers + rep.poisoned >= 1
    finally:
        rep.close()


def test_hung_replica_fails_over(weights, one_thread):
    """A fetch hung past the watchdog: the replica dies with a "step
    watchdog" reason and its stream continues on the survivor, token for
    token."""
    inj = FaultInjector()
    rep = _fleet(weights, inj)
    try:
        # on the CPU a dispatch beat times the program itself: the watchdogs
        # start on warm replicas (a cold one's first programs can take a
        # second under a loaded test run)
        for e in rep.engines:
            assert len(e.generate([1, 2, 3], max_new_tokens=2)) == 2
            e.step_watchdog_s = 1.0
            e.watchdog = StepWatchdog(e, 1.0)
        want = _reference(weights, [5, 9, 2, 11], 24)
        req = rep.engines[0].submit(GenRequest([5, 9, 2, 11], max_new_tokens=24))
        _wait(lambda: req.emitted > 0, 30, "a first token")
        inj.arm("step_latency", label="/r0", delay=3.0)
        assert req.tokens(timeout=30) == want
        assert not rep.engines[0].alive() and rep.engines[0].died_reason.startswith("step watchdog")
        assert rep.failovers >= 1
    finally:
        rep.close()


def test_nan_logits_fails_over_token_identical(weights):
    inj = FaultInjector()
    rep = _fleet(weights, inj)
    try:
        want = _reference(weights, [5, 9, 2, 11], 24)
        req = rep.engines[0].submit(GenRequest([5, 9, 2, 11], max_new_tokens=24))
        _wait(lambda: req.emitted > 0, 30, "a first token")
        inj.arm("nan_logits", label="/r0")
        assert req.tokens(timeout=60) == want
        assert not rep.engines[0].alive()
        assert rep.engines[0].died_reason.startswith("numerical watchdog: non-finite logits")
        assert rep.engines[0].numerical_trips == 1 and rep.failovers >= 1
    finally:
        rep.close()


# -- poison quarantine -----------------------------------------------------------------


def test_poison_bounded_to_two_deaths(weights):
    inj = FaultInjector()
    rep = _fleet(weights, inj, replicas=3)
    try:
        want = _reference(weights, PROMPT[:6], 32)
        victim = rep.engines[0].submit(GenRequest(PROMPT[:6], max_new_tokens=32))  # a bystander, same replica
        _wait(lambda: victim.emitted > 0, 30, "the bystander decoding")
        inj.arm("device_step", tag="boom", count=-1)  # reliably fatal
        poison = rep.engines[0].submit(GenRequest([1, 2, 3, 4], max_new_tokens=8, tag="boom"))
        with pytest.raises(PoisonedRequestError):
            poison.tokens(timeout=60)
        assert poison.finish_reason == "poison" and poison.deaths == 2
        assert sum(not e.alive() for e in rep.engines) == 2
        assert victim.tokens(timeout=60) == want
        assert rep.poisoned == 1 and rep.stats()["poisoned"] == 1
        assert rep.generate([7, 7, 7], max_new_tokens=4) == _reference(weights, [7, 7, 7], 4)
    finally:
        inj.disarm()
        rep.close()


def test_poison_disabled_exhausts_retries_as_error(weights):
    inj = FaultInjector()
    rep = _fleet(weights, inj, replicas=3, poison_deaths=0)
    try:
        inj.arm("device_step", tag="boom", count=-1)
        poison = rep.engines[0].submit(GenRequest([1, 2, 3, 4], max_new_tokens=8, tag="boom"))
        with pytest.raises(RequestFailed):
            poison.tokens(timeout=60)
        assert poison.finish_reason == "error" and poison.deaths > 2
    finally:
        inj.disarm()
        rep.close()


# -- the supervisor and the canary -----------------------------------------------------


def test_supervisor_restarts_and_routes_back(weights, fast_supervisor):
    inj = FaultInjector()
    rep = _fleet(weights, inj, supervise=True)
    try:
        corpse = rep.engines[0]
        ledger = rep.ledger
        inj.arm("replica_kill", label="/r0")
        _wait(lambda: rep.engines[0] is not corpse and rep.engines[0].alive(), 30, "the supervised restart")
        assert rep.supervisor.restarts == 1 and rep.stats()["replicas_alive"] == 2
        new = rep.engines[0]
        assert new.label == corpse.label == "llm/r0" and new.ledger is ledger
        assert new.generate([5, 9, 2], max_new_tokens=4) == _reference(weights, [5, 9, 2], 4)
        assert rep.debug_state()["supervisor"]["restarts"] == 1
        # a rebuild copies the fleet's weights: it shares no storage with them
        assert new.params["embed"].data_ptr() != rep.params["embed"].data_ptr()
        snap = rep.health.snapshot()["devices"]["cpu"]
        assert snap["by_reason"] == {"step_fault": 1}
    finally:
        rep.close()


def test_draining_fleet_never_restarts(weights, fast_supervisor):
    inj = FaultInjector()
    rep = _fleet(weights, inj, supervise=True)
    try:
        rep.drain()
        inj.arm("replica_kill", label="/r0")
        _wait(lambda: not rep.engines[0].alive(), 10, "replica 0's death")
        scans = []
        scan = rep.supervisor._scan
        rep.supervisor._scan = lambda: (scans.append(1), scan())
        _wait(lambda: len(scans) >= 5, 10, "five supervisor scans")
        assert rep.supervisor.restarts == 0 and not rep.engines[0].alive() and rep.drained()
    finally:
        rep.close()


def test_canary_rejects_divergent_and_incomplete(weights):
    _jcfg, _jp, tcfg, tp = weights
    ref_eng = LLMEngine(tcfg, tp, device="cpu", slots=2, max_seq_len=64, prefill_buckets=(8,))
    # a half-sick replica: right shapes, its unembedding off by one row
    sick = LLMEngine(tcfg, dict(tp, unembed=tp["unembed"].roll(1, dims=0)), device="cpu", slots=2, max_seq_len=64,
                     prefill_buckets=(8,))
    try:
        ok, _, ref = canary_check(ref_eng)
        assert ok and len(ref) == CANARY_MAX_NEW
        assert canary_check(ref_eng, ref)[0]
        ok3, detail3, _ = canary_check(sick, ref)
        assert not ok3 and "diverged" in detail3
        assert canary_check(sick, None)[0]  # why the fleet caches a reference
    finally:
        ref_eng.close()
        sick.close()

    class Stub:
        cfg = tcfg

        def submit(self, req):
            req.out.put([1, 2])
            req.out.put(None)
            return req

    ok, detail, toks = canary_check(Stub())
    assert not ok and "incomplete" in detail and toks == [1, 2]


def test_supervisor_keeps_canary_rejected_replica_out(weights, fast_supervisor, monkeypatch):
    monkeypatch.setenv("TPU_LLM_DEVICE_QUARANTINE_FAILURES", "100")
    inj = FaultInjector()
    rep = _fleet(weights, inj, supervise=True)
    try:
        real = rep._canary_check
        rejections = []

        def gate(replacement):
            if not rejections:
                rejections.append(1)
                return False, "forced divergence (test)"
            return real(replacement)

        rep._canary_check = gate
        corpse = rep.engines[0]
        inj.arm("replica_kill", label="/r0")
        _wait(lambda: rep.engines[0] is not corpse and rep.engines[0].alive(), 30, "the restart after the canary")
        assert rep.supervisor.canary_rejects == 1 and rep.supervisor.restarts == 1
        assert rep.health.snapshot()["devices"]["cpu"]["by_reason"].get("rebuild_failure", 0) >= 1
        assert rep.engines[0].generate([5, 9, 2], max_new_tokens=4) == _reference(weights, [5, 9, 2], 4)
    finally:
        rep.close()


# -- placement and the supervisor against the JAX fleet's, host-only -----------------------


class _StubEngine:
    def __init__(self, key):
        self.key, self.up, self.version = key, True, "v1"

    def alive(self):
        return self.up

    def close(self):
        self.up = False


def _stub_fleets(keys: list[str], clock: dict, failures: int = 2):
    """The JAX fleet and the port's, built without engines: the same home
    keys, JAX's CPU devices as the pool of alternates, a ledger each on one
    fake clock."""
    jdevs = {f"cpu:{d.id}": d for d in jax.devices()}
    led = dict(failures=failures, window_s=100.0, cooldown_s=5.0, now_fn=lambda: clock["t"])
    j = object.__new__(JFleet)
    j._specs = [{"device": jdevs[k]} for k in keys]
    j._device_keys, j._current_keys = list(keys), list(keys)
    j.engines = [_StubEngine(k) for k in keys]
    j.health, j.logger, j.metrics, j.label, j._draining = JLedger(**led), None, None, "llm", False
    t = object.__new__(ReplicatedLLMEngine)
    seen: dict = {}
    t._seats = []
    for k in keys:
        t._seats.append((k, seen.get(k, 0)))
        seen[k] = seen.get(k, 0) + 1
    t._home_count, t._current_seats = seen, list(t._seats)
    t._specs = [{"device": k} for k in keys]
    t._device_keys, t._current_keys = list(keys), list(keys)
    t._device_pool = [({"device": k}, k) for k in jdevs]
    t.engines = [_StubEngine(k) for k in keys]
    t.health, t.logger, t._draining = DeviceHealthLedger(**led), None, False
    return j, t


def _placed(fleet, i):
    got = fleet._spec_for_rebuild(i)
    return None if got is None else got[1]


def test_placement_matches_jax_on_distinct_devices():
    clock = {"t": 0.0}
    j, t = _stub_fleets(["cpu:0", "cpu:1"], clock)
    trace = []
    for f in (j, t):
        f.engines[0].up = False
    trace.append((_placed(j, 0), _placed(t, 0)))  # home
    for f in (j, t):
        f.health.record_failure("cpu:0", "step_fault")
        f.health.record_failure("cpu:0", "rebuild_failure")
    trace.append((_placed(j, 0), _placed(t, 0)))  # quarantined home: an alternate
    j._current_keys[0] = "cpu:2"
    t._settle(0, _StubEngine("cpu:2"), {"seat": ("cpu:2", 0)}, "cpu:2")
    j.engines[0] = _StubEngine("cpu:2")
    for f in (j, t):
        f.engines[1].up = False
    trace.append((_placed(j, 1), _placed(t, 1)))  # home again
    for f in (j, t):
        for k in [f"cpu:{n}" for n in range(1, 8)]:
            f.health.record_failure(k, "step_fault")
            f.health.record_failure(k, "step_fault")
    trace.append((_placed(j, 1), _placed(t, 1)))  # nothing usable: park
    clock["t"] = 6.0
    trace.append((_placed(j, 1), _placed(t, 1)))  # probation: home
    assert [a for a, _ in trace] == [b for _, b in trace]
    assert [a for a, _ in trace] == ["cpu:0", "cpu:2", "cpu:1", None, "cpu:1"]


def _drive_supervisors(monkeypatch, j, t, script):
    """Both supervisors over their stub fleets, their threads never
    started, each scan called in turn: ``script`` is [(action, arg)]."""
    builds = {"sick": set(), "reject": [0]}

    def build(fleet):
        def _build(i, spec=None):
            key = spec["device"] if isinstance(spec["device"], str) else f"cpu:{spec['device'].id}"
            if key in builds["sick"]:
                raise RuntimeError(f"sick {key}")
            return _StubEngine(key)
        return _build

    def canary(_replacement):
        if builds["reject"][0] > 0:
            builds["reject"][0] -= 1
            return False, "forced divergence"
        return True, "ok"

    sups = []
    with mock.patch.object(threading.Thread, "start", lambda self: None):
        for f, Sup in ((j, JSupervisor), (t, ReplicaSupervisor)):
            f._build_replica, f._canary_check = build(f), canary
            sups.append(Sup(f, interval_s=0.0, backoff_s=0.0, backoff_max_s=0.0, max_attempts=3))
    trace = []
    for action, arg in script:
        for f, sup in zip((j, t), sups):
            if action == "kill":
                f.engines[arg].up = False
                f.engines[arg].died_reason = "fault injection: replica_kill"
            elif action == "scan":
                sup._scan()
        if action == "sick":
            builds["sick"] = set(arg)
        elif action == "reject":
            builds["reject"][0] = 2 * arg  # one per fleet
        elif action == "clock":
            arg["t"] += 6.0
        if action == "scan":
            snaps = [s.snapshot() for s in sups]
            for s in snaps:
                s.pop("interval_s")
                for row in s["pending"].values():
                    row.pop("backoff_s")
                    row.pop("retry_in_s")
            trace.append((snaps, list(j._current_keys), list(t._current_keys),
                          j.health.snapshot()["devices"], t.health.snapshot()["devices"]))
    return trace


def test_supervisor_matches_jax_on_a_death_sequence(monkeypatch):
    clock = {"t": 0.0}
    j, t = _stub_fleets(["cpu:0", "cpu:1"], clock)
    script = [
        ("kill", 0), ("scan", None),  # rebuilt home
        ("sick", ["cpu:0"]), ("kill", 0), ("scan", None), ("scan", None),  # fails, quarantines, lands on cpu:2
        ("sick", []), ("reject", 1), ("kill", 1), ("scan", None), ("scan", None),  # a canary rejection, then home
        ("sick", [f"cpu:{n}" for n in range(8)]), ("kill", 1), ("scan", None), ("scan", None), ("scan", None),
        ("scan", None),  # attempts spent: failed for good
    ]
    trace = _drive_supervisors(monkeypatch, j, t, script)
    for snaps, jkeys, tkeys, jh, th in trace:
        assert snaps[0] == snaps[1] and jkeys == tkeys and jh == th
    final = trace[-1][0][1]
    assert final["restarts"] == 3 and final["canary_rejects"] == 1 and final["failed"] == 1
    assert trace[2][1] == ["cpu:2", "cpu:1"]


def test_parked_slot_reintegrates_like_jax(monkeypatch):
    clock = {"t": 0.0}
    j, t = _stub_fleets(["cpu:0", "cpu:1"], clock, failures=1)
    for f in (j, t):
        for n in range(2, 8):
            f.health.record_failure(f"cpu:{n}", "step_fault")
            f.health.record_failure(f"cpu:{n}", "step_fault")  # re-tripped: 10 s
    script = [("kill", 0), ("scan", None), ("scan", None), ("clock", clock), ("scan", None), ("scan", None)]
    trace = _drive_supervisors(monkeypatch, j, t, script)
    for snaps, jkeys, tkeys, jh, th in trace:
        assert snaps[0] == snaps[1] and jkeys == tkeys and jh == th
    assert trace[0][0][1]["parked"] == 1 and trace[-1][0][1]["restarts"] == 1
    assert trace[-1][4]["cpu:0"]["state"] == "healthy"


def test_replicas_share_one_device(monkeypatch):
    """The port's deliberate difference: N replicas on one device. The JAX
    policy, on the same keys, sees the device held by the live replica
    and has nowhere else to go; the port counts seats, so the dead slot is
    rebuilt at home. A quarantined device parks the dead slot while the
    live replica keeps its seat."""
    clock = {"t": 0.0}
    j, t = _stub_fleets(["cpu:0", "cpu:0"], clock)
    for f in (j, t):
        f.engines[0].up = False
    with mock.patch.object(jax, "devices", lambda *a: [d for d in jax.local_devices() if d.id == 0]):
        assert _placed(j, 0) is None  # JAX: park
    t._device_pool = [({"device": "cpu:0"}, "cpu:0")]
    assert t._spec_for_rebuild(0) == ({"device": "cpu:0", "seat": ("cpu:0", 0)}, "cpu:0")
    t.health.record_failure("cpu:0", "step_fault")
    t.health.record_failure("cpu:0", "step_fault")
    assert t._spec_for_rebuild(0) is None and t.engines[1].alive()


# -- a real fleet on one device: quarantine parks, the survivor serves, health degrades ----


def test_quarantined_device_parks_dead_slot_while_survivor_serves(weights, fast_supervisor, monkeypatch):
    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.datasource.gpu import GPURuntime
    from gofr_tpu_torch.handler import health_handler

    monkeypatch.setenv("TPU_LLM_DEVICE_QUARANTINE_FAILURES", "2")
    monkeypatch.setenv("TPU_LLM_DEVICE_COOLDOWN_S", "60")
    _jcfg, _jp, tcfg, tp = weights
    inj = FaultInjector()
    rt = GPURuntime(new_mock_config({"TORCH_DEVICE": "cpu"}))
    rep = rt.register_llm("m", tcfg, tp, replicas=2, fault_injector=inj,
                          **{k: v for k, v in FLEET_KW.items() if k != "device"})
    try:
        inj.arm("device_sick", label="cpu", count=1)
        inj.arm("replica_kill", label="/r0")
        _wait(lambda: rep.supervisor.parked_count() == 1, 30, "the parked slot")
        assert rep.health.state("cpu") == "quarantined" and rep.engines[1].alive()
        assert rep.generate([5, 9, 2], max_new_tokens=4) == _reference(weights, [5, 9, 2], 4)
        ctx = SimpleNamespace(container=SimpleNamespace(draining=False, tpu_runtime=rt, health=lambda: {}))
        assert rt.degraded() and health_handler(ctx)["status"] == "degraded"
        assert rep.stats()["replicas_parked"] == 1 and rep.stats()["devices_quarantined"] == 1
    finally:
        inj.disarm()
        rt.close()


# -- routing, the shared ledger, the fleet cap ----------------------------------------------


class _LoadStub:
    def __init__(self, tokens, n, version="v1"):
        self.tokens, self.n, self.version = tokens, n, version

    def accepting(self):
        return True

    def alive(self):
        return True

    def load_tokens(self):
        return self.tokens

    def load(self):
        return self.n


def test_least_loaded_pick_matches_jax():
    for loads in ([(300, 1), (20, 3)], [(20, 3), (20, 1)], [(0, 0), (5, 0), (0, 2)]):
        picks = []
        for Fleet in (JFleet, ReplicatedLLMEngine):
            f = object.__new__(Fleet)
            f.engines, f.router = [_LoadStub(*x) for x in loads], "least_loaded"
            picks.append(f.engines.index(f._pick()))
        assert picks[0] == picks[1]


def test_routing_by_queued_tokens_and_one_ledger(weights):
    inj = FaultInjector()
    rep = _fleet(weights, inj)
    try:
        r0 = rep.engines[0]
        r0._admit = lambda: False  # r0's queue holds what it gets
        long = r0.submit(GenRequest(list(range(1, 41)), max_new_tokens=16, client="a"))
        assert r0.load_tokens() == 56 and rep.load_tokens() == 56
        short = rep.submit(GenRequest([5, 9, 2], max_new_tokens=4, client="b"))
        assert short.tokens(timeout=30) == _reference(weights, [5, 9, 2], 4)
        assert rep.engines[1].submitted == 1 and r0.submitted == 1
        assert rep.engines[0].ledger is rep.engines[1].ledger is rep.ledger
        assert rep.ledger.counter("b") > 0  # billed by r1, seen by r0's ordering too
        del r0._admit
        assert len(long.tokens(timeout=30)) == 16
    finally:
        rep.close()


def test_fleet_queue_cap_refuses_with_retry_after(weights):
    inj = FaultInjector()
    rep = _fleet(weights, inj, fleet_max_queue_tokens=30)
    try:
        for e in rep.engines:
            e._admit = lambda: False
        rep.submit(GenRequest(list(range(1, 21)), max_new_tokens=8))  # 28 queued tokens
        rep.submit(GenRequest([1, 2], max_new_tokens=2))  # 28 < 30: in, 32 queued
        with pytest.raises(EngineOverloaded) as ei:
            rep.submit(GenRequest([1, 2], max_new_tokens=2, priority="batch"))  # 32 >= 24, the batch headroom
        assert ei.value.retry_after == 1.0 and rep.fleet_rejected == 1
        with pytest.raises(EngineOverloaded, match="fleet queue full"):
            rep.submit(GenRequest([1, 2], max_new_tokens=2))  # 32 >= 30
        assert rep.fleet_rejected == 2 and rep.stats()["fleet_rejected"] == 2
    finally:
        rep.close()


# -- the runtime and the app -------------------------------------------------------------------


def test_register_llm_builds_fleet_with_watchdog_knobs(weights):
    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.datasource.gpu import GPURuntime

    _jcfg, _jp, tcfg, tp = weights
    rt = GPURuntime(new_mock_config({"TORCH_DEVICE": "cpu", "TPU_LLM_STEP_WATCHDOG_S": "30",
                                     "TPU_LLM_NUMERIC_CHECK": "0"}))
    try:
        rep = rt.register_llm("m", tcfg, tp, replicas=2, supervise=False, slots=2, max_seq_len=64)
        # register_llm returns the model's handle over the fleet
        assert isinstance(rep.engine, ReplicatedLLMEngine) and rt.llm("m") is rep
        assert [e.label for e in rep.engines] == ["m/r0", "m/r1"]
        assert all(e.step_watchdog_s == 30.0 and e.watchdog is not None and not e.numeric_check
                   for e in rep.engines)
        assert rt.health_check()["details"]["llms"]["m"]["replicas_alive"] == 2
        one = rt.register_llm("one", tcfg, tp, numeric_check=True, slots=2, max_seq_len=64)
        assert isinstance(one.engine, LLMEngine) and one.numeric_check and one.step_watchdog_s == 30.0
        with pytest.raises(NotImplementedError, match="meshes"):
            rt.register_llm("tp", tcfg, tp, meshes=[object()])
    finally:
        rt.close()


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, None


def test_app_drain_with_fleet(weights):
    """POST /.well-known/debug/drain on an app serving a fleet: health 503,
    liveness up, both replicas refuse new work while a request in flight
    finishes, and the server closes once the fleet is drained."""
    from gofr_tpu_torch.app import new
    from gofr_tpu_torch.config import new_mock_config

    _jcfg, _jp, tcfg, tp = weights
    app = new(config=new_mock_config({"HTTP_PORT": "0", "METRICS_PORT": "0", "GOFR_DRAIN_DEADLINE_S": "20", "TORCH_DEVICE": "cpu"}))
    rep = app.container.tpu().register_llm("m", tcfg, tp, replicas=2, supervise=False,
                                           **{k: v for k, v in FLEET_KW.items() if k != "device"})
    th = app.run_in_background()
    base = f"http://127.0.0.1:{app.http_server.port}"
    try:
        assert _get(f"{base}/.well-known/health")[1]["data"]["status"] == "UP"
        req = rep.submit(GenRequest([5, 9, 2, 11], max_new_tokens=24))
        _wait(lambda: req.emitted > 0, 30, "a first token")
        post = urllib.request.Request(f"{base}/.well-known/debug/drain", method="POST", data=b"")
        with urllib.request.urlopen(post, timeout=5) as r:
            assert json.load(r)["data"]["started"] is True
        assert _get(f"{base}/.well-known/health")[0] == 503
        assert _get(f"{base}/.well-known/alive")[0] == 200
        assert rep._draining and not any(e.accepting() for e in rep.engines)
        assert req.tokens(timeout=60) == _reference(weights, [5, 9, 2, 11], 24)
        th.join(timeout=20)
        assert not th.is_alive(), "the drain did not shut the app down"
    finally:
        app.shutdown()
        th.join(timeout=10)


def test_adapters_fan_out_and_restage_on_rebuild(weights, fast_supervisor):
    """load_adapter stages an adapter on every live replica and keeps it:
    a rebuilt replica comes back serving it with the same tokens; evict
    retires it fleet-wide, and a name no replica holds is refused fast."""
    from gofr_tpu_torch.llm import UnknownAdapterError
    from gofr_tpu_torch.lora import init_adapter

    _jcfg, _jp, tcfg, _tp = weights
    ad = {k: {"a": v["a"].numpy(), "b": v["b"].numpy()}
          for k, v in init_adapter(torch.Generator().manual_seed(3), tcfg, rank=4, scale=1.0).items()}
    inj = FaultInjector()
    rep = _fleet(weights, inj, supervise=True, lora_slots=2, lora_rank=4)
    try:
        assert rep.load_adapter("A", ad) == 2
        assert all("A" in e.adapters()["resident"] for e in rep.engines) and rep.adapters()["registered"] == ["A"]
        want = rep.engines[1].generate([5, 9, 2], max_new_tokens=6, adapter="A")
        assert want != rep.engines[1].generate([5, 9, 2], max_new_tokens=6)  # the adapter moves the stream
        corpse = rep.engines[0]
        inj.arm("replica_kill", label="/r0")
        _wait(lambda: rep.engines[0] is not corpse and rep.engines[0].alive(), 30, "the supervised restart")
        assert "A" in rep.engines[0].adapters()["resident"]
        assert rep.engines[0].generate([5, 9, 2], max_new_tokens=6, adapter="A") == want
        assert rep.evict_adapter("A") == 2 and rep.adapters()["registered"] == []
        with pytest.raises(UnknownAdapterError):
            rep.submit(GenRequest([1, 2], max_new_tokens=2, adapter="A"))
    finally:
        rep.close()
