"""Overload control in gofr_tpu_torch against gofr_tpu (CPU): the copied
FairLedger and OverloadController driven through the cases of
tests/test_overload.py beside the JAX classes, and the engine's fair
queuing, batch preemption with its continuation, predicted-wait shedding,
brownout and TTFT shedding beside the JAX LLMEngine on the same tiny
weights (the untied random head of tests/test_torch_engine.py; the JAX
engine at the port's fixed shapes). Greedy streams must be token-identical
to the uncontended stream and to the JAX engine's; once idle no block, pin
or grammar reference may be held."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gofr_tpu.llm import EngineOverloaded as JOverloaded
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import transformer as JT
from gofr_tpu.resilience import FairLedger as JLedger
from gofr_tpu.resilience import OverloadController as JController
from gofr_tpu_torch import structured as TS
from gofr_tpu_torch.llm import EngineOverloaded, GenRequest, LLMEngine
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.resilience import FairLedger, OverloadController

ENGINE_KW = dict(slots=1, max_seq_len=128, prefill_buckets=(8, 16))
# the JAX engine at the port's fixed shapes (gofr_tpu_torch.llm constants)
JAX_KW = dict(warmup=False, kv_paged=True, decode_chunk=8, prefill_chunk=64, step_token_budget=256)
PROMPT = list(range(1, 9))


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# FairLedger and OverloadController: each case runs on the port's class and
# on the JAX class; both must pass its checks and observe the same values
# ---------------------------------------------------------------------------

def _charge_orders_least_served_first(L):
    led = L()
    led.touch("a")
    led.touch("b")
    led.charge("a", 100)
    led.charge("b", 10)
    led.set_active("e", {"a", "b"})
    assert led.counter("b") < led.counter("a")
    return led.snapshot()


def _weight_discounts_charges(L):
    led = L({"paid": 4.0})
    led.charge("paid", 100)
    led.charge("free", 100)
    assert led.counter("paid") == pytest.approx(25.0)
    assert led.counter("free") == pytest.approx(100.0)
    return led.snapshot()


def _new_arrival_lifts_to_active_floor(L):
    led = L()
    led.set_active("e", {"a", "b"})
    led.charge("a", 50)
    led.charge("b", 80)
    led.touch("fresh")
    assert led.counter("fresh") == pytest.approx(50.0)
    led.touch("fresh2")
    assert led.counter("fresh2") >= 50.0
    return led.snapshot()


def _idle_return_keeps_earned_debt(L):
    led = L()
    led.set_active("e", {"hog"})
    led.charge("hog", 200)
    led.touch("hog")
    assert led.counter("hog") == pytest.approx(200.0)
    return led.snapshot()


def _debt_spread_active_only(L):
    led = L()
    led.charge("a", 100)
    led.charge("b", 10)
    spreads = [led.debt_spread()]
    led.set_active("e", {"a", "b"})
    spreads.append(led.debt_spread())
    led.set_active("e", {"a"})
    spreads.append(led.debt_spread())
    assert spreads == [0.0, pytest.approx(90.0), 0.0]
    return spreads, led.snapshot()


def _cap_bounds_clients(L):
    led = L(max_clients=4)
    for i in range(10):
        led.touch(f"c{i}")
    assert led.snapshot()["clients"] <= 4
    return led.snapshot()


def _eviction_keeps_heavy_debt(L):
    led = L(max_clients=4)
    led.touch("flooder")
    led.charge("flooder", 10_000)
    for i in range(20):
        led.touch(f"spoof{i}")
    assert led.counter("flooder") == pytest.approx(10_000.0)
    assert "flooder" in led.snapshot()["counters"]
    return led.snapshot()


def _shard_union_across_replicas(L):
    led = L()
    led.charge("a", 10)
    led.charge("b", 90)
    led.set_active("r0", {"a"})
    led.set_active("r1", {"b"})
    spreads = [led.debt_spread()]
    led.set_active("r1", set())
    spreads.append(led.debt_spread())
    assert spreads == [pytest.approx(80.0), 0.0]
    return spreads, led.counters_for({"a", "b", "new"})


LEDGER_CASES = [
    _charge_orders_least_served_first, _weight_discounts_charges, _new_arrival_lifts_to_active_floor,
    _idle_return_keeps_earned_debt, _debt_spread_active_only, _cap_bounds_clients, _eviction_keeps_heavy_debt,
    _shard_union_across_replicas,
]


@pytest.mark.parametrize("case", LEDGER_CASES, ids=lambda f: f.__name__.strip("_"))
def test_fair_ledger_matches_jax(case):
    assert case(FairLedger) == case(JLedger)


def _brownout_engages_after_sustained_hold(C):
    clock = FakeClock()
    c = C(brownout_wait_s=1.0, brownout_max_new=8, brownout_hold_s=2.0, now_fn=clock)
    seen = []
    for dt in (0.0, 1.0, 1.5):
        clock.advance(dt)
        c.observe(5.0)
        seen.append(c.brownout)
    assert seen == [False, False, True]
    return seen, c.snapshot()


def _pressure_blip_resets_hold(C):
    clock = FakeClock()
    c = C(brownout_wait_s=1.0, brownout_max_new=8, brownout_hold_s=2.0, now_fn=clock)
    c.observe(5.0)
    clock.advance(1.9)
    c.observe(0.1)
    clock.advance(0.2)
    c.observe(5.0)
    assert not c.brownout
    return c.snapshot()


def _brownout_exits_with_hysteresis(C):
    c = C(brownout_wait_s=1.0, brownout_max_new=8, brownout_hold_s=0.0, now_fn=FakeClock())
    seen = []
    for w in (5.0, 0.8, 0.3):
        c.observe(w)
        seen.append(c.brownout)
    assert seen == [True, True, False]
    return seen, c.snapshot()


def _clamp_batch_only(C):
    c = C(brownout_wait_s=1.0, brownout_max_new=8, brownout_hold_s=0.0, now_fn=FakeClock())
    c.observe(5.0)
    got = [c.clamp(64, "batch"), c.clamp(64, "interactive"), c.clamp(4, "batch")]
    assert got == [8, 64, 4]
    return got


def _shed_direct_when_no_brownout_configured(C):
    c = C(shed_wait_s=2.0, now_fn=FakeClock())
    got = [c.should_shed(1.0), c.should_shed(None), c.should_shed(7.5)]
    assert got[:2] == [None, None] and got[2] == pytest.approx(5.5)
    return got, c.snapshot()


def _degrade_before_shed(C):
    clock = FakeClock()
    c = C(shed_wait_s=2.0, brownout_wait_s=1.0, brownout_max_new=8, brownout_hold_s=1.0, now_fn=clock)
    c.observe(10.0)
    first = c.should_shed(10.0)
    clock.advance(1.5)
    c.observe(10.0)
    assert first is None and c.brownout
    assert c.should_shed(10.0) == pytest.approx(8.0)
    return first, c.should_shed(10.0), c.snapshot()


def _retry_after_floor(C):
    c = C(shed_wait_s=2.0, now_fn=FakeClock())
    assert c.should_shed(2.01) == pytest.approx(0.5)
    return c.should_shed(2.01)


CONTROLLER_CASES = [
    _brownout_engages_after_sustained_hold, _pressure_blip_resets_hold, _brownout_exits_with_hysteresis,
    _clamp_batch_only, _shed_direct_when_no_brownout_configured, _degrade_before_shed, _retry_after_floor,
]


@pytest.mark.parametrize("case", CONTROLLER_CASES, ids=lambda f: f.__name__.strip("_"))
def test_overload_controller_matches_jax(case):
    assert case(OverloadController) == case(JController)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _head(jp, jcfg):
    # untied random head: the tied tiny model repeats its input token
    return dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))


@pytest.fixture(scope="module")
def weights():
    jcfg = JT.TransformerConfig.tiny()
    jp = _head(JT.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    tcfg = TT.TransformerConfig.tiny()
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _port(weights, **kw):
    _jcfg, _jp, tcfg, tp = weights
    return LLMEngine(tcfg, tp, device="cpu", **{**ENGINE_KW, **kw})


def _jax(weights, **kw):
    jcfg, jp, _tcfg, _tp = weights
    return JEngine(jcfg, jp, **{**JAX_KW, **ENGINE_KW, **kw})


def _wait(pred, timeout: float, what: str) -> None:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def _idle(eng, timeout: float = 10.0) -> None:
    """Wait until nothing is resident or in flight; then no block may be
    in use beyond what the radix holds, no promise or pin outstanding and
    no grammar referenced."""

    def quiet():
        with eng._lock:
            busy = (eng._inflight or eng._processing is not None or any(eng._slot_req) or eng._waiting
                    or eng._admit_q.qsize())
            st = eng.kv.stats()
            return not busy and st["reserved"] == 0 and st["blocks_in_use"] == eng.kv.held_blocks()

    _wait(quiet, timeout, "an idle engine with no block, promise or pin held")
    assert all(n == 0 for n in eng._g_refs), eng._g_refs
    assert eng.load_tokens() == 0


def _slow_collector(eng, delay: float = 0.01) -> threading.Event:
    """Delay every fetch, so programs stay in flight (the card's pace).
    Returns an event, set: clearing it holds the collector before its next
    fetch until it is set again."""
    process = eng._process_entry
    go = threading.Event()
    go.set()

    def slow(entry):
        go.wait(timeout=10)
        time.sleep(delay)
        return process(entry)

    eng._process_entry = slow
    return go


def _live_guard(eng) -> list:
    """Wrap the staging of every dispatch: a lane live in a step or chunk,
    or selected in a verify, must belong to a slot's current occupant
    (a preempted request's lane is off in every later dispatch). Returns
    the list of violations."""
    bad: list = []
    write = eng._in.write

    def guarded(tables, live, meta=None, pack=None, verify=None, gids=None):
        lanes = set(np.flatnonzero(live).tolist())
        if verify is not None:
            lanes |= set(np.flatnonzero(verify[:, -1] == 1).tolist())
        bad.extend(i for i in lanes if eng._slot_req[i] is None)
        return write(tables, live, meta, pack, verify=verify, gids=gids)

    eng._in.write = guarded
    return bad


def _contend(eng, R, prompt, batch_new: int, inter_new: int = 4, hold=None, **batch_kw):
    """A batch request decoding when an interactive one arrives after its
    4th token: -> (batch tokens, interactive tokens, batch tokens out when
    the interactive request finished, batch request). ``hold`` (the event
    of ``_slow_collector``) keeps the port's collector from emitting while
    the interactive request arrives, so the batch request is still short of
    its end (with its programs in flight) when the scheduler looks."""
    batch = eng.submit(R(prompt, max_new_tokens=batch_new, priority="batch", client="b", **batch_kw))
    got: list[int] = []
    th = threading.Thread(target=lambda: got.extend(batch.stream(timeout=60)))
    th.start()
    _wait(lambda: batch.emitted >= 4, 60, "the batch request mid-decode")
    if hold is not None:
        hold.clear()
    inter = eng.submit(R([9, 9, 2], max_new_tokens=inter_new, client="i"))
    if hold is not None:
        if eng.preemption:
            _wait(lambda: eng.preemptions >= 1, 10, "the preemption")
        else:
            time.sleep(0.05)
        hold.set()
    out = inter.tokens(timeout=60)
    at = batch.emitted
    th.join(timeout=60)
    assert not th.is_alive(), "batch consumer hung"
    assert len(out) == inter_new
    return got, out, at, batch


@pytest.fixture(scope="module")
def jax_contended(weights):
    """The JAX engine's uncontended and preempted 48-token batch streams,
    at lookahead 1 and 3. Its collector is held while the interactive
    request arrives, as the port's is: unheld, the engine on the CPU could
    cover the batch request's remaining tokens with programs in flight
    before it looked, and then rightly preempted nothing."""
    out = {}
    for la in (1, 3):
        je = _jax(weights, lookahead=la)
        try:
            want = je.generate(PROMPT, max_new_tokens=48)
            got, inter, at, batch = _contend(je, JRequest, PROMPT, 48, hold=_slow_collector(je))
            assert je.preemptions == 1 and batch.preempted == 1
            out[la] = (want, got, inter, at)
        finally:
            je.close()
    return out


@pytest.mark.parametrize("lookahead", [1, 3])
def test_preempted_batch_stream_token_identical(weights, jax_contended, lookahead):
    """The batch stream, scrubbed from every program in flight and resumed
    as a continuation, equals the uncontended stream and the JAX engine's;
    the interactive request finishes with fewer batch tokens out than
    without preemption."""
    want_j, got_j, inter_j, _at_j = jax_contended[lookahead]
    ats = {}
    for pre in (True, False):
        eng = _port(weights, lookahead=lookahead, preemption=pre)
        try:
            bad = _live_guard(eng)
            want = eng.generate(PROMPT, max_new_tokens=48)
            hold = _slow_collector(eng)
            got, inter, ats[pre], batch = _contend(eng, GenRequest, PROMPT, 48, hold=hold)
            assert want == want_j and got == want == got_j and inter == inter_j
            assert batch.finish_reason == "length"
            assert eng.preemptions == batch.preempted == int(pre)
            assert not bad, f"live lanes of empty slots: {bad}"
            if pre:
                # the continuation's prompt carries the stream it had
                assert batch.prompt_tokens[: len(PROMPT)] == PROMPT and len(batch.prompt_tokens) > len(PROMPT)
                assert batch.prompt_tokens[len(PROMPT):] == got[: len(batch.prompt_tokens) - len(PROMPT)]
            _idle(eng)
        finally:
            eng.close()
    assert ats[True] < ats[False], ats


def test_interactive_never_preempts_interactive(weights):
    for eng, R in ((_port(weights), GenRequest), (_jax(weights), JRequest)):
        try:
            if isinstance(eng, LLMEngine):
                _slow_collector(eng)
            first = eng.submit(R(PROMPT, max_new_tokens=48, client="a"))
            _wait(lambda: first.emitted >= 2, 60, "the first request decoding")
            second = eng.submit(R([5, 5], max_new_tokens=2, client="b"))
            assert len(second.tokens(timeout=60)) == 2 and len(first.tokens(timeout=60)) == 48
            assert eng.preemptions == 0 and first.preempted == 0
            if isinstance(eng, LLMEngine):
                _idle(eng)
        finally:
            eng.close()


def test_preemption_cap_stops_thrash(weights):
    """A batch request already preempted _PREEMPT_CAP times keeps its slot."""
    for eng, R in ((_port(weights), GenRequest), (_jax(weights), JRequest)):
        try:
            if isinstance(eng, LLMEngine):
                _slow_collector(eng)
            batch = eng.submit(R(PROMPT, max_new_tokens=48, priority="batch"))
            _wait(lambda: batch.emitted >= 2, 60, "the batch request decoding")
            batch.preempted = eng._PREEMPT_CAP
            inter = eng.submit(R([3, 1], max_new_tokens=2))
            assert len(inter.tokens(timeout=60)) == 2
            assert eng.preemptions == 0 and len(batch.tokens(timeout=60)) == 48
            if isinstance(eng, LLMEngine):
                _idle(eng)
        finally:
            eng.close()


def test_preemption_opt_out(weights, monkeypatch):
    monkeypatch.setenv("TPU_LLM_PREEMPT", "0")
    for eng, R in ((_port(weights), GenRequest), (_jax(weights), JRequest)):
        try:
            assert eng.preemption is False
            batch = eng.submit(R(PROMPT, max_new_tokens=16, priority="batch"))
            _wait(lambda: batch.emitted >= 2, 60, "the batch request decoding")
            inter = eng.submit(R([3, 1], max_new_tokens=2))
            assert inter.tokens(timeout=60) and batch.tokens(timeout=60)
            assert eng.preemptions == 0
            if isinstance(eng, LLMEngine):
                _idle(eng)
        finally:
            eng.close()


def test_preempted_partial_hit_continuation(weights):
    """Trouble spot (c): a victim admitted through a block-partial radix hit
    holds shared blocks, which its preemption decrefs (never frees); its
    continuation hits the radix itself, and its stream equals the
    uncontended one (from an engine with no cache). Once idle every block
    in use is one the radix holds."""
    base = [int(t) for t in np.random.default_rng(3).integers(1, 512, 40)]
    prompt = base + [7, 7, 3]
    with _port(weights, max_seq_len=160) as plain:
        want = plain.generate(prompt, max_new_tokens=48)
    eng = _port(weights, prefix_cache_mb=4.0, max_seq_len=160)
    try:
        bad = _live_guard(eng)
        eng.generate(base, max_new_tokens=4)  # publishes the 40-token prompt
        radix0 = eng.kv.stats()["prefix"]
        hold = _slow_collector(eng)
        got, _inter, _at, batch = _contend(eng, GenRequest, prompt, 48, hold=hold)
        assert got == want and batch.preempted == 1 and batch.prefix_hit
        radix = eng.kv.stats()["prefix"]
        # the batch request and its continuation: two partial hits
        assert radix["partial_hits"] == radix0["partial_hits"] + 2 and radix["hits"] == radix0["hits"]
        assert not bad
        _idle(eng)
        assert eng.generate(prompt, max_new_tokens=48) == want  # an exact hit now
        _idle(eng)
    finally:
        eng.close()


# -- fair queuing --------------------------------------------------------------

def test_waiting_order_fair_then_fifo(weights):
    orders = []
    for eng, R in ((_port(weights, slots=2), GenRequest), (_jax(weights, slots=2), JRequest)):
        try:
            eng._admit = lambda: False  # hold the queue as the test sets it
            led = eng.ledger
            assert led is not None  # on by default
            led.touch("hog")
            led.touch("lite")
            led.charge("hog", 1000)
            reqs = {
                "h1": R([1], client="hog", priority="batch"),
                "h2": R([1], client="hog", priority="batch"),
                "lite": R([1], client="lite", priority="batch"),
                "inter": R([1], client="hog", priority="interactive"),
            }
            names = {id(r): n for n, r in reqs.items()}
            with eng._lock:
                eng._waiting = type(eng._waiting)([reqs["h1"], reqs["h2"], reqs["lite"], reqs["inter"]])
            eng._order_waiting()
            with eng._lock:
                orders.append([names[id(r)] for r in eng._waiting])
        finally:
            eng.close()
    # interactive first regardless of client debt; then the least-served
    # client; submit id breaks ties
    assert orders[0] == orders[1] == ["inter", "lite", "h1", "h2"]


def test_ties_keep_submit_order(weights):
    """Within one class and one fair-share counter the port keeps the order
    the requests arrived in (as its scheduler drained the submits), where
    the JAX engine keeps the order they were made (GenRequest.id): a
    request made first but submitted second waits behind the other in the
    port. (A deliberate difference: concurrent clients' traffic stays in
    the FIFO order the port served before overload control.)"""
    orders = []
    for eng, R in ((_port(weights), GenRequest), (_jax(weights), JRequest)):
        try:
            eng._admit = lambda: False  # hold the queue; JAX then drains nothing either
            first, second = R([1, 2], client="c"), R([3, 4], client="c")
            eng.submit(second)
            eng.submit(first)
            if isinstance(eng, LLMEngine):
                _wait(lambda: len(eng._waiting) == 2, 10, "the port's drain")
            else:
                eng._waiting = [eng._admit_q.get_nowait(), eng._admit_q.get_nowait()]
            eng._order_waiting()
            with eng._lock:
                orders.append(["first" if r is first else "second" for r in eng._waiting])
        finally:
            eng.close()
    assert orders == [["second", "first"], ["first", "second"]]


def _serialize_admission(eng, gate: threading.Event) -> None:
    """Admit only once ``gate`` is set and the engine is idle, so every
    admission sees every earlier request's tokens billed: the finishing
    order then depends on the ledger alone, not on thread timing."""
    admit = eng._admit

    def serial():
        if not gate.is_set():
            return False
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 10.0:
            with eng._lock:
                busy = eng._inflight or eng._processing is not None or any(
                    r is not None and r.finish_reason is None for r in eng._slot_req
                )
            if not busy:
                break
            time.sleep(0.001)
        if isinstance(eng, LLMEngine):
            # the port orders at the start of a pass, the JAX engine
            # inside its admission: order again now that all is billed
            eng._order_waiting()
        return admit()

    eng._admit = serial


def _record_finishes(eng, names: dict) -> list:
    """The order in which ``eng`` ENDS the requests of ``names`` (request
    id -> name), recorded where the engine ends a request: the port's
    ``_finish``, the JAX engine's ``_observe_finish`` (every terminal path
    of either engine passes there). A consumer thread's wake-up order is
    the OS's, not the engine's."""
    order: list[str] = []
    if isinstance(eng, LLMEngine):
        finish = eng._finish

        def rec(r, reason):
            if r.id in names and r.finish_reason is None:
                order.append(names[r.id])
            return finish(r, reason)

        eng._finish = rec
    else:
        observe = eng._observe_finish

        def rec(r, now, fetch_t=None):
            if r.id in names:
                order.append(names[r.id])
            return observe(r, now, fetch_t=fetch_t)

        eng._observe_finish = rec
    return order


def test_flood_cannot_starve_light_client(weights):
    """Five heavy requests, then two light ones, at slots=1: the light
    client's counter is lowest after the head-of-line heavy request, so
    both light requests finish inside the first four, in the JAX engine's
    order (FIFO would put them last). The order is the one in which each
    engine ends the requests."""
    orders = []
    for eng, R in ((_port(weights), GenRequest), (_jax(weights), JRequest)):
        try:
            gate = threading.Event()
            _serialize_admission(eng, gate)
            names: dict[int, str] = {}
            done = _record_finishes(eng, names)
            reqs = []
            for client, prompt, n in (("heavy", [7, 3, 5, 2, 9, 4], 5), ("light", [6, 1, 8, 2, 4, 3], 2)):
                for i in range(n):
                    r = R(prompt, max_new_tokens=6, client=client)
                    names[r.id] = f"{client[0]}{i}"
                    reqs.append(eng.submit(r))
            gate.set()
            for r in reqs:
                assert len(r.tokens(timeout=60)) == 6
            orders.append(list(done))
            if isinstance(eng, LLMEngine):
                _idle(eng)
        finally:
            eng.close()
    assert orders[0] == orders[1] == ["h0", "l0", "h1", "l1", "h2", "h3", "h4"], orders


def test_fair_queuing_opt_out_restores_fifo(weights, monkeypatch):
    """fair_queuing=False (or TPU_LLM_FAIR=0): no ledger; the queue keeps
    class order, then FIFO, whatever the clients were served."""
    monkeypatch.setenv("TPU_LLM_FAIR", "0")
    orders = []
    for eng, R in ((_port(weights), GenRequest), (_jax(weights), JRequest)):
        try:
            assert eng.ledger is None and eng.stats()["fairness"] is None
            eng._admit = lambda: False
            reqs = [R([1], client="hog", priority="batch"), R([1], client="lite", priority="batch"),
                    R([1], client="hog")]
            with eng._lock:
                eng._waiting = type(eng._waiting)(reqs)
            eng._order_waiting()
            with eng._lock:
                orders.append([reqs.index(r) for r in eng._waiting])
        finally:
            eng.close()
    assert orders[0] == orders[1] == [2, 0, 1]
    eng = _port(weights, fair_queuing=True)
    eng.close()
    assert eng.ledger is not None  # the kwarg beats the knob


# -- shedding and brownout -------------------------------------------------------

def _frozen(eng):
    eng._admit = lambda: False  # the queue only grows
    return eng


def _thaw_and_idle(eng) -> None:
    """Let a frozen port engine admit again, serve what it queued, and
    check it idles with nothing held (the JAX engine is left as it is)."""
    if isinstance(eng, LLMEngine):
        del eng._admit
        eng._tput_ema = None  # no pressure left to shed or brown out by
        eng._kick.set()
        _idle(eng, timeout=30)


def test_predicted_shed_fires_before_max_queue(weights):
    got = []
    for eng, R, Err in ((_port(weights, max_queue=64, shed_predicted_wait_s=1.0), GenRequest, EngineOverloaded),
                        (_jax(weights, max_queue=64, shed_predicted_wait_s=1.0), JRequest, JOverloaded)):
        try:
            _frozen(eng)._tput_ema = 50.0  # measured 50 tok/s
            for _ in range(2):  # 2 x (8 prompt + 20 decode) = 56 tokens owed
                eng.submit(R(PROMPT, max_new_tokens=20))
            with pytest.raises(Err) as ei:
                eng.submit(R(PROMPT, max_new_tokens=20))
            assert eng.sheds_predicted == 1 and eng.rejected == 0
            ra = ei.value.retry_after
            assert ra is not None and 0 < ra < 60
            got.append((ra, eng.load_tokens(), eng.predicted_wait_s()))
            _thaw_and_idle(eng)
        finally:
            eng.close()
    assert got[0] == got[1] == (pytest.approx(0.5), 56, pytest.approx(56 / 50))
    assert got[0][1] == 56


def test_queue_full_429_carries_retry_after(weights):
    got = []
    for eng, R, Err in ((_port(weights, max_queue=1), GenRequest, EngineOverloaded),
                        (_jax(weights, max_queue=1), JRequest, JOverloaded)):
        try:
            _frozen(eng)
            eng.submit(R([1, 2, 3], max_new_tokens=4))
            with pytest.raises(Err) as ei:
                eng.submit(R([1, 2, 3], max_new_tokens=4))
            assert 0 < ei.value.retry_after < float("inf")
            got.append((ei.value.retry_after, eng.rejected, eng.stats()["rejected"]))
            _thaw_and_idle(eng)
        finally:
            eng.close()
    assert got[0] == got[1] == (1.0, 1, 1)


def test_brownout_clamps_batch_then_restores(weights):
    got = []
    kw = dict(brownout_wait_s=1.0, brownout_max_new=4, brownout_hold_s=0.0)
    for eng, R in ((_port(weights, **kw), GenRequest), (_jax(weights, **kw), JRequest)):
        try:
            _frozen(eng)._tput_ema = 10.0
            eng.submit(R(PROMPT, max_new_tokens=20))
            # predicted wait 28 / 10 = 2.8 s > 1.0 s: brownout engages and
            # the batch request is clamped...
            rb = eng.submit(R(PROMPT, max_new_tokens=20, priority="batch"))
            assert eng.overload.brownout and rb.max_new_tokens == 4 and rb.browned
            # ...while interactive requests keep their full budget
            ri = eng.submit(R(PROMPT, max_new_tokens=20))
            assert ri.max_new_tokens == 20 and not ri.browned
            # no throughput estimate: no pressure, brownout lets go
            eng._tput_ema = None
            rb2 = eng.submit(R(PROMPT, max_new_tokens=20, priority="batch"))
            assert not eng.overload.brownout and rb2.max_new_tokens == 20 and not rb2.browned
            got.append((eng.brownout_clamped, eng.overload.snapshot(), eng.load_tokens()))
            _thaw_and_idle(eng)
        finally:
            eng.close()
    assert got[0] == got[1]
    assert got[0][0] == 1 and got[0][2] == 28 + 12 + 28 + 28


def test_brownout_clamp_respects_continuation_emitted(weights):
    kw = dict(brownout_wait_s=1.0, brownout_max_new=4, brownout_hold_s=0.0)
    for eng, R in ((_port(weights, **kw), GenRequest), (_jax(weights, **kw), JRequest)):
        try:
            _frozen(eng)._tput_ema = 1.0
            eng.submit(R(PROMPT, max_new_tokens=20))
            # a continuation that already streamed 10 tokens gets
            # emitted + clamp, never less than it delivered
            r = R(PROMPT, max_new_tokens=20, priority="batch")
            r.emitted = 10
            eng.submit(r)
            assert r.max_new_tokens == 14 and r.browned
            if isinstance(eng, LLMEngine):
                r.emitted = 0  # never served: let the engine serve it whole
            _thaw_and_idle(eng)
        finally:
            eng.close()


def test_ttft_deadline_sheds_stale_requests(weights):
    """More work than one slot can start within ttft_deadline_ms: the
    requests still waiting past it end with "shed" and no token, the rest
    are served whole (JAX test_ttft_deadline_sheds_stale_requests)."""
    for eng, R in ((_port(weights, ttft_deadline_ms=1.0), GenRequest),
                   (_jax(weights, ttft_deadline_ms=1.0), JRequest)):
        try:
            reqs = [eng.submit(R([1 + i % 7, 2], max_new_tokens=8)) for i in range(30)]
            outs = [r.tokens(timeout=60) for r in reqs]
            shed = [r for r in reqs if r.finish_reason == "shed"]
            assert shed, "the deadline never shed anything"
            for r, toks in zip(reqs, outs):
                assert toks == [] if r.finish_reason == "shed" else len(toks) == 8
            assert eng.shed == eng.stats()["shed"] == len(shed)
            assert eng.load_tokens() == 0
            if isinstance(eng, LLMEngine):
                _idle(eng)
        finally:
            eng.close()


def test_priority_normalized_and_stats_keys(weights):
    """submit() maps anything but "batch" to "interactive" (JAX
    llm.py:2503); stats() carries the JAX engine's overload keys."""
    keys = ("load_tokens", "rejected", "shed", "deadline_cancels", "preemptions", "sheds_predicted",
            "brownout_clamped", "predicted_wait_s", "overload", "fairness")
    stats = []
    for eng, R in ((_port(weights), GenRequest), (_jax(weights), JRequest)):
        try:
            r = eng.submit(R([1, 2], max_new_tokens=2, priority="BATCH-ish"))
            r.tokens(timeout=60)
            # "c" arrives once no client waits: it enters at a floor of 0
            _wait(lambda: eng.ledger.snapshot()["active"] == 0, 10, "an empty waiting-client set")
            b = eng.submit(R([1, 2], max_new_tokens=2, priority="batch", client="c"))
            b.tokens(timeout=60)
            assert (r.priority, b.priority) == ("interactive", "batch")
            st = eng.stats()
            stats.append({k: st[k] for k in keys if k != "predicted_wait_s"})
            assert st["predicted_wait_s"] is None or st["predicted_wait_s"] >= 0
            if isinstance(eng, LLMEngine):
                _idle(eng)
        finally:
            eng.close()
    assert stats[0]["overload"] == stats[1]["overload"]
    assert set(stats[0]["fairness"]) == set(stats[1]["fairness"])
    assert stats[0]["fairness"]["counters"] == stats[1]["fairness"]["counters"] == {"": 4.0, "c": 4.0}
    assert {k: v for k, v in stats[0].items() if k not in ("overload", "fairness")} == {
        k: v for k, v in stats[1].items() if k not in ("overload", "fairness")
    }


def test_rejected_submit_takes_no_grammar_reference(weights):
    """Registration runs after every reject path: a queue-full 429 on a
    constrained request leaves the grammar table untouched."""
    g = TS.compile_regex(r"[a-e]{2,4}", [bytes([i % 95 + 32]) for i in range(511)] + [b""], 511)
    eng = _frozen(_port(weights, max_queue=0))
    try:
        with pytest.raises(EngineOverloaded):
            eng.submit(GenRequest([1, 2], max_new_tokens=8, grammar=g))
        assert eng._g_refs == [] and eng.constrained_requests == 0
    finally:
        eng.close()


# -- continuations of constrained and speculating victims ----------------------

VOCAB = [chr(0x20 + i).encode() if 0x20 + i < 0x7F else b"" for i in range(127)] + [b""]
EOS = 127


@pytest.fixture(scope="module")
def weights128():
    jcfg = JT.TransformerConfig.tiny(vocab_size=128)
    jp = _head(JT.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    tcfg = TT.TransformerConfig.tiny(vocab_size=128)
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.mark.parametrize("lookahead", [1, 3])
def test_constrained_continuation_keeps_its_grammar_state(weights128, lookahead):
    """A constrained batch request preempted mid-document resumes its DFA
    where its stream stood: its output is accepted by the grammar and
    equals the uncontended constrained stream (and the JAX engine's)."""
    from gofr_tpu import structured as JS

    regex = r"[a-e]{24,40}"
    tg, jg = TS.compile_regex(regex, VOCAB, EOS), JS.compile_regex(regex, VOCAB, EOS)
    je = _jax(weights128, lookahead=lookahead)
    try:
        want_j = je.generate(PROMPT, max_new_tokens=48, grammar=jg)
    finally:
        je.close()
    eng = _port(weights128, lookahead=lookahead)
    try:
        bad = _live_guard(eng)
        want = eng.generate(PROMPT, max_new_tokens=48, grammar=tg)
        hold = _slow_collector(eng)
        got, _inter, _at, batch = _contend(eng, GenRequest, PROMPT, 48, hold=hold, grammar=tg)
        assert got == want == want_j and batch.preempted == 1 and batch.finish_reason == "eos"
        assert tg.advance_all(0, got) >= 0 and got[-1] == EOS and 24 <= len(got) - 1 <= 40
        assert batch._g_state == tg.advance_all(0, got)
        assert not bad
        _idle(eng)
    finally:
        eng.close()


@pytest.mark.parametrize("lookahead", [1, 3])
def test_speculating_continuation_equals_spec_off(weights, lookahead):
    """A speculating batch request preempted mid-stream (its verifies in
    flight scrubbed, its optimistic stream dropped) equals the spec-off
    stream."""
    prompt = ([5, 6, 7, 8] * 8)[:20]  # the tiny model then repeats: drafts land
    with _port(weights, lookahead=lookahead) as off:
        want = off.generate(prompt, max_new_tokens=48)
    eng = _port(weights, lookahead=lookahead, speculative=True, spec_draft=4)
    try:
        bad = _live_guard(eng)
        hold = _slow_collector(eng)
        got, _inter, _at, batch = _contend(eng, GenRequest, prompt, 48, hold=hold)
        assert got == want and batch.preempted == 1 and eng.spec_steps > 0
        assert not bad
        _idle(eng)
    finally:
        eng.close()


def test_stress_preemption_cancels_and_floods(weights):
    """16 client threads (more than the cores the suite gives a worker)
    submit batch and interactive requests from four clients, some
    cancelled mid-stream, under a short switch interval, at slots=2 and
    lookahead 3: every stream ends; every stream that was not cancelled
    equals its uncontended stream (preempted or not); once idle
    load_tokens is 0 and no block, promise or pin is held."""
    import sys

    prompts = [[int(t) for t in np.random.default_rng(50 + i).integers(1, 512, 5 + 7 * i)] for i in range(4)]
    with _port(weights, slots=1) as ref:
        want = [ref.generate(p, max_new_tokens=24) for p in prompts]
    eng = _port(weights, slots=2, lookahead=3)
    _slow_collector(eng, 0.002)
    errors: list = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(k):
            try:
                rng = np.random.default_rng(k)
                for n in range(6):
                    i = int(rng.integers(0, 4))
                    r = eng.submit(GenRequest(prompts[i], max_new_tokens=24, client=f"c{k % 4}",
                                              priority="batch" if rng.random() < 0.6 else "interactive"))
                    cut = rng.random() < 0.2
                    got = []
                    for t in r.stream(timeout=60):
                        got.append(t)
                        if cut and len(got) >= 3:
                            r.cancel()
                    if cut:
                        assert got == want[i][: len(got)], (k, n, "cut")
                    else:
                        assert got == want[i] and r.finish_reason == "length", (k, n, r.preempted, got)
            except BaseException as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads), "a client hung"
        assert not errors, errors[0]
        _idle(eng)
        assert eng.stats()["finished"] == eng.stats()["submitted"] == 96
        assert eng.preemptions > 0  # the race this test is for happened
    finally:
        sys.setswitchinterval(old)
        eng.close()
