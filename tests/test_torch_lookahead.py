"""The port's pipelined dispatch (lookahead, the collector thread) against
gofr_tpu.llm.LLMEngine at its default lookahead=3, on the same tiny
untied-head weights (CPU): greedy token identity at lookahead 1 and 3,
eos, cancel and deadline retirement with programs in flight, admission
into a virtually free slot, and the capture-safe slot writes."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch.llm import GenRequest, LLMEngine, _scatter_slots
from gofr_tpu_torch.models import transformer as TT

ENGINE_KW = dict(slots=4, max_seq_len=128, prefill_buckets=(8, 16))


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


@pytest.fixture(scope="module")
def ref(weights):
    jcfg, jp, _tcfg, _tp = weights
    eng = JEngine(jcfg, jp, warmup=False, kv_paged=True, **ENGINE_KW)  # lookahead=3, its default
    yield eng
    eng.close()


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).tolist() for n in lengths]


def _slow_collector(eng, delay=0.01, fill=False):
    """Delay every fetch the collector makes, so the scheduler fills the
    pipeline; with ``fill``, first wait (up to 2 s) until the scheduler
    has filled it to ``lookahead`` or has nothing left to dispatch.
    Returns a list that records the entries in flight (the taken one
    included) at each fetch."""
    depths: list[int] = []
    process = eng._process_entry

    def slow(entry):
        t0 = time.perf_counter()
        while fill and time.perf_counter() - t0 < 2.0:
            with eng._lock:
                if len(eng._inflight) + 1 >= eng.lookahead or (
                    not eng._prefilling and eng._needed_steps() <= 0
                ):
                    break
            time.sleep(0.001)
        with eng._lock:
            depths.append(len(eng._inflight) + 1)
        time.sleep(delay)
        return process(entry)

    eng._process_entry = slow
    return depths


def _settled(eng, timeout=30.0):
    """Wait for the pipeline to drain and the pool to be empty."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        st = eng.stats()
        with eng._lock:
            idle = not eng._inflight and eng._processing is None
        if idle and st["kvcache"]["blocks_in_use"] == 0 and st["kvcache"]["reserved"] == 0:
            return st
        time.sleep(0.01)
    raise AssertionError(f"engine did not settle: {eng.stats()}")


def _ended_once(req):
    """The stream ended with one None and carries nothing after it."""
    time.sleep(0.05)
    assert req.out.qsize() == 0, "tokens or a second end after the end of the stream"


@pytest.mark.parametrize("lookahead", [1, 3])
def test_concurrent_burst_with_pure_decode_chunks(weights, ref, lookahead):
    """More requests than slots, long enough that pure decode chunks (K = 8
    and the short K = 2) follow the unified steps."""
    _jcfg, _jp, tcfg, tp = weights
    prompts = _prompts(31, (3, 17, 33, 9, 40, 16))
    jreqs = [ref.submit(JRequest(p, max_new_tokens=19)) for p in prompts]
    want = [r.tokens() for r in jreqs]
    with LLMEngine(tcfg, tp, device="cpu", lookahead=lookahead, **ENGINE_KW) as port:
        depths = _slow_collector(port, 0.002, fill=True)
        treqs = [port.submit(GenRequest(p, max_new_tokens=19)) for p in prompts]
        assert [r.tokens() for r in treqs] == want
        st = _settled(port)
        assert st["chunks"] > st["steps"]  # pure decode chunks ran
        assert max(depths) <= lookahead
        if lookahead > 1:
            assert max(depths) > 1  # programs were in flight together


def test_eos_inside_a_chunk_with_later_chunks_in_flight(weights, ref):
    _jcfg, _jp, tcfg, tp = weights
    (prompt,) = _prompts(32, (10,))
    full = ref.generate(prompt, max_new_tokens=40)
    eos = full[12]  # mid-chunk: the step emits 1 + 8, then chunk tokens 9..16
    want = ref.submit(JRequest(prompt, max_new_tokens=40, eos_token=eos)).tokens()
    assert want == full[: full.index(eos) + 1]
    with LLMEngine(tcfg, tp, device="cpu", lookahead=3, **ENGINE_KW) as port:
        depths = _slow_collector(port, fill=True)
        r = port.submit(GenRequest(prompt, max_new_tokens=40, eos_token=eos))
        assert r.tokens() == want and r.finish_reason == "eos"
        assert depths[1] > 1  # the chunk carrying the eos had later chunks behind it
        _ended_once(r)
        _settled(port)
        # the engine serves on after dropping the in-flight tokens
        assert port.generate(prompt, max_new_tokens=40) == full


@pytest.mark.parametrize("why", ["cancelled", "deadline"])
def test_retirement_with_programs_in_flight(weights, ref, why):
    """A decoding request cancelled (or past its deadline) while later
    programs for it are in flight: the stream ends once, with a prefix of
    JAX's greedy stream, and its slot and blocks are free afterwards."""
    _jcfg, _jp, tcfg, tp = weights
    (prompt,) = _prompts(33, (12,))
    full = ref.generate(prompt, max_new_tokens=90)
    with LLMEngine(tcfg, tp, device="cpu", lookahead=3, **ENGINE_KW) as port:
        _slow_collector(port)
        r = port.submit(GenRequest(prompt, max_new_tokens=90))
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 30:
            with port._lock:  # retire it while programs for it are in flight
                if r.emitted >= 9 and port._inflight:
                    if why == "cancelled":
                        r.cancel()
                    else:
                        r.deadline = time.perf_counter()
                    break
            time.sleep(0.001)
        out = r.tokens(timeout=10)
        assert r.finish_reason == why
        assert 9 <= len(out) < 90 and out == full[: len(out)]
        _ended_once(r)
        st = _settled(port)
        assert r.slot is not None and port._slot_req[r.slot] is None
        assert st["deadline_cancels"] == (why == "deadline")


def test_admission_into_a_virtually_free_slot(weights, ref):
    """One slot: the second request is admitted while the first one's last
    tokens are still in flight (its programs cover them), and both get
    JAX's tokens."""
    jcfg, jp, tcfg, tp = weights
    kw = dict(ENGINE_KW, slots=1)
    a, b = _prompts(34, (7, 11))
    want_a = ref.generate(a, max_new_tokens=10)
    want_b = ref.generate(b, max_new_tokens=6)
    with LLMEngine(tcfg, tp, device="cpu", lookahead=3, **kw) as port:
        _slow_collector(port, 0.05)
        early = []
        attach = port.kv.attach

        def watch(slot, owner, plen, max_new):
            prev = port.kv.slot_owner(slot)
            if prev is not None and prev.finish_reason is None:
                early.append((prev, owner))
            return attach(slot, owner, plen, max_new)

        port.kv.attach = watch
        ra = port.submit(GenRequest(a, max_new_tokens=10))
        rb = port.submit(GenRequest(b, max_new_tokens=6))
        assert ra.tokens() == want_a and rb.tokens() == want_b
        assert early == [(ra, rb)]
        _settled(port)


def test_stats_names_match_the_jax_engine(weights, ref):
    _jcfg, _jp, tcfg, tp = weights
    with LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW) as port:
        st = port.stats()
    jst = ref.stats()
    for key in ("inflight_chunks", "warmup_s"):
        assert key in st and key in jst
    # no graphs on the CPU: nothing is warmed, as with JAX's warmup=False
    assert st["warmup_s"] is None and jst["warmup_s"] is None
    assert st["inflight_chunks"] == 0 and port.lookahead == 3 and not port.families


def test_closed_engine_ends_streams_in_flight(weights):
    """close() with requests waiting and decoding: every stream ends once."""
    _jcfg, _jp, tcfg, tp = weights
    port = LLMEngine(tcfg, tp, device="cpu", lookahead=3, **ENGINE_KW)
    _slow_collector(port)
    reqs = [port.submit(GenRequest(p, max_new_tokens=100)) for p in _prompts(35, (5, 9, 14, 3, 8, 6))]
    while reqs[0].emitted == 0:
        time.sleep(0.001)
    port.close()
    for r in reqs:
        r.tokens(timeout=5)
        assert r.finish_reason in ("cancelled", "length")
        _ended_once(r)


@pytest.mark.parametrize("value", [False, True, 7, 2.5])
def test_scatter_slots_scalar_is_made_on_the_device(value, monkeypatch):
    """``_scatter_slots`` with a Python scalar (the step program's
    ``False`` / ``True`` activations) equals JAX's ``.at[idx].set(value,
    mode="drop")`` and makes no host tensor: a host tensor would need a
    pageable copy, which a CUDA graph capture refuses."""
    dtype = {bool: torch.bool, int: torch.int32, float: torch.float32}[type(value)]
    vec = torch.tensor([1, 0, 1, 0, 1], dtype=torch.int32).to(dtype)
    idx = torch.tensor([3, 5, 0, 9], dtype=torch.int32)  # 5 and 9: dropped
    want = jnp.asarray(vec.numpy()).at[jnp.asarray(idx.numpy())].set(value, mode="drop")

    def no_host_tensor(*a, **kw):
        raise AssertionError("host tensor made from a Python scalar")

    monkeypatch.setattr(torch, "as_tensor", no_host_tensor)
    monkeypatch.setattr(torch, "tensor", no_host_tensor)
    _scatter_slots(vec, idx, value)
    monkeypatch.undo()
    np.testing.assert_array_equal(vec.numpy(), np.asarray(want))


def test_scatter_slots_tensor_values_match_jax():
    vec = torch.zeros(6, dtype=torch.float32)
    idx = torch.tensor([4, 6, 1], dtype=torch.int32)
    vals = torch.tensor([0.5, 9.0, -2.0])
    want = jnp.zeros(6).at[jnp.asarray(idx.numpy())].set(jnp.asarray(vals.numpy()), mode="drop")
    _scatter_slots(vec, idx, vals)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(want))


@pytest.mark.parametrize("where", ["scheduler", "collector"])
def test_dead_engine_ends_every_stream(weights, where):
    """A device program that raises (scheduler thread) or a fetch that
    raises (collector thread), every time, with requests waiting, decoding
    and in flight: the per-iteration recovery ends the streams it reaches
    "cancelled" (as the JAX engine's ``_recover_all`` does), and the third
    failure in a row ends the engine (``_die``, which the JAX engine
    reaches only through a dead thread: a fault that never clears must not
    busy-loop). Every stream ends once, the death names the fault, and the
    engine refuses new requests."""
    from gofr_tpu_torch.llm import EngineStoppedError

    _jcfg, _jp, tcfg, tp = weights
    port = LLMEngine(tcfg, tp, device="cpu", lookahead=3, **ENGINE_KW)
    _slow_collector(port)
    calls = {"n": 0}
    if where == "scheduler":
        launch = port._launch

        def boom(name):
            calls["n"] += 1
            if calls["n"] > 3:
                raise RuntimeError("device fault")
            return launch(name)

        port._launch = boom
    else:
        process = port._process_entry

        def boom(entry):
            calls["n"] += 1
            if calls["n"] > 2:
                raise RuntimeError("fetch fault")
            return process(entry)

        port._process_entry = boom
    try:
        reqs = [port.submit(GenRequest(p, max_new_tokens=60)) for p in _prompts(36, (5, 9, 14, 3, 8, 6))]
        # more work while the engine lives: each failing pass or fetch ends
        # what it reaches, and the streak grows only while work arrives
        for p in _prompts(37, (5,) * 6):
            try:
                reqs.append(port.submit(GenRequest(p, max_new_tokens=60)))
            except EngineStoppedError:
                break
            t0 = time.perf_counter()
            while reqs[-1].finish_reason is None and time.perf_counter() - t0 < 10:
                time.sleep(0.005)
        for r in reqs:
            toks = r.tokens(timeout=10)
            assert len(toks) < 60
            assert r.finish_reason == "cancelled"
            _ended_once(r)
        assert not port.alive()
        assert "fault" in port.died_reason and "in a row" in port.died_reason
        assert "fault" in port.stats()["error"]
        with pytest.raises(EngineStoppedError):
            port.submit(GenRequest([1, 2], max_new_tokens=2))
    finally:
        port.close()


def test_satisfied_lane_stops_advancing(weights, ref):
    """A short request next to a long one: once the short one's programs
    in flight cover its tokens, the chunks the long one's demand drives
    leave its lane out of the live mask. Both streams stay JAX's, and
    every block is free afterwards."""
    _jcfg, _jp, tcfg, tp = weights
    long_p, short_p = _prompts(37, (5, 6))
    want_long = ref.generate(long_p, max_new_tokens=100)
    want_short = ref.generate(short_p, max_new_tokens=3)
    with LLMEngine(tcfg, tp, device="cpu", lookahead=3, **dict(ENGINE_KW, slots=2)) as port:
        _slow_collector(port)
        rl = port.submit(GenRequest(long_p, max_new_tokens=100))
        while rl.slot is None:
            time.sleep(0.001)
        rs = GenRequest(short_p, max_new_tokens=3)
        lanes = []  # the short lane's live bit in each dispatch before its first token is out
        write = port._in.write

        def watch(tables, live, meta=None, pack=None):
            if rs.prefill_done and rs.emitted == 0:
                lanes.append(bool(live[rs.slot]))
            return write(tables, live, meta, pack)

        port._in.write = watch
        port.submit(rs)
        assert rs.tokens() == want_short and rl.tokens() == want_long
        _settled(port)
        # live in its own unified step (1 + 8 tokens cover its 3), then
        # left out of the chunks dispatched before that step's fetch
        assert lanes[0] and len(lanes) > 1 and not any(lanes[1:]), lanes


def test_stress_many_clients_cancels_and_switches(weights):
    """More client threads than cores and slots, a tiny interpreter switch
    interval, and a third of the requests cancelled at random points while
    programs are in flight: every stream ends exactly once, a finished
    stream carries at most its max_new_tokens, and the engine's counts and
    pool come back to zero."""
    import os
    import random
    import sys
    import threading

    _jcfg, _jp, tcfg, tp = weights
    n = min(64, max(16, 2 * len(os.sched_getaffinity(0))))  # more clients than cores
    prompts = _prompts(38, [3 + (7 * i) % 30 for i in range(n)])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with LLMEngine(tcfg, tp, device="cpu", lookahead=3, **ENGINE_KW) as port:
            rng = random.Random(0)
            reqs = [GenRequest(p, max_new_tokens=5 + (3 * i) % 20) for i, p in enumerate(prompts)]
            ends = {id(r): 0 for r in reqs}
            got = {id(r): [] for r in reqs}

            def client(r, cancel_after):
                port.submit(r)
                while True:
                    item = r.out.get(timeout=120)  # generous: the suite may share a loaded CPU
                    if item is None:
                        ends[id(r)] += 1
                        return
                    got[id(r)].extend(item)
                    if cancel_after is not None and len(got[id(r)]) >= cancel_after:
                        r.cancel()

            threads = [
                threading.Thread(target=client, args=(r, rng.randint(1, 4) if i % 3 == 0 else None))
                for i, r in enumerate(reqs)
            ]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            assert not any(th.is_alive() for th in threads)
            st = _settled(port, timeout=60.0)
            for r in reqs:
                assert ends[id(r)] == 1 and r.out.qsize() == 0
                assert len(got[id(r)]) <= r.max_new_tokens
                assert r.finish_reason in ("length", "cancelled")
            assert st["finished"] == st["submitted"] == n
    finally:
        sys.setswitchinterval(old)


def test_cancelled_occupant_displaced_with_nothing_in_flight_ends(weights, ref):
    """A decoding request cancelled just after a pass's retirement sweep,
    with no program of it in flight: its slot counts as free, the waiting
    request takes it, and the cancelled stream still ends once (as JAX's
    ``_assign_slot`` closes it)."""
    _jcfg, _jp, tcfg, tp = weights
    a, b = _prompts(39, (6, 8))
    want_b = ref.generate(b, max_new_tokens=5)
    with LLMEngine(tcfg, tp, device="cpu", lookahead=1, **dict(ENGINE_KW, slots=1)) as port:
        ra = GenRequest(a, max_new_tokens=40)  # leaves the pool room for b
        expire = port._expire_deadlines

        def sweep_then_cancel(now):
            expire(now)
            with port._lock:
                idle = not port._inflight and port._processing is None
            if ra.emitted >= 9 and idle and not ra.cancelled and port._waiting:
                ra.cancel()

        port._expire_deadlines = sweep_then_cancel
        # once ra has 9 tokens out, its next entry waits for b's submit: a
        # test thread descheduled on a loaded CPU must not let ra finish
        # by length before b arrives
        b_submitted = threading.Event()
        process = port._process_entry

        def held(entry):
            if ra.emitted >= 9:
                b_submitted.wait(10)
            return process(entry)

        port._process_entry = held
        port.submit(ra)
        while ra.emitted < 9:
            time.sleep(0.001)
        rb = port.submit(GenRequest(b, max_new_tokens=5))
        b_submitted.set()
        out = ra.tokens(timeout=10)
        assert ra.finish_reason == "cancelled" and 9 <= len(out) < 40
        _ended_once(ra)
        assert rb.tokens(timeout=10) == want_b
        assert port.stats()["finished"] == 2
        _settled(port)
