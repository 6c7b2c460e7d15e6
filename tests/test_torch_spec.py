"""Speculative decoding in gofr_tpu_torch against gofr_tpu (CPU): the copied
n-gram drafter and acceptance rule, ``verify_chunk``, and the engine's
verify program (``llm.step_v{W}``) on the tiny f32 preset with an untied
random head. Greedy streams must equal the JAX engine's spec-on streams
(``kv_paged=True``, the port's knobs) and the port's spec-off streams:
speculation changes scheduling, never tokens."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import spec as JS
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch import spec as TS
from gofr_tpu_torch.llm import GenRequest, LLMEngine
from gofr_tpu_torch.models import transformer as TT

ENGINE_KW = dict(slots=4, max_seq_len=128, prefill_buckets=(8, 16))
REPETITIVE = ([5, 6, 7, 8] * 8)[:20]  # tests/test_speculative.py's prompts
NATURAL = list(range(1, 21))
# verify_chunk against JAX: f32 on both sides, different summation orders
ATOL = 1e-4


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
def spec_off(weights):
    """The port's spec-off engine: the streams every spec-on run must equal."""
    _jcfg, _jp, tcfg, tp = weights
    eng = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW)
    yield eng
    eng.close()


def _port(weights, **kw):
    _jcfg, _jp, tcfg, tp = weights
    return LLMEngine(tcfg, tp, device="cpu", **{**ENGINE_KW, "speculative": True, **kw})


def _jax(weights, **kw):
    jcfg, jp, _tcfg, _tp = weights
    return JEngine(jcfg, jp, warmup=False, kv_paged=True, **{**ENGINE_KW, "speculative": True, **kw})


def _settled(eng, timeout=20.0) -> dict:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        st = eng.stats()
        with eng._lock:
            idle = not eng._inflight and eng._processing is None and not any(eng._slot_req)
        if idle and st["kvcache"]["blocks_in_use"] == 0 and st["kvcache"]["reserved"] == 0:
            return st
        time.sleep(0.01)
    raise AssertionError(f"engine did not settle: {eng.stats()}")


def _slow_collector(eng, delay: float) -> list[int]:
    """Delay every fetch, so verifies pile up in flight; returns a list
    recording the verify entries in flight (the taken one included) at
    each fetch."""
    seen: list[int] = []
    process = eng._process_entry

    def slow(entry):
        with eng._lock:
            seen.append(sum(e[0] == "verify" for e in eng._inflight) + (entry[0] == "verify"))
        time.sleep(delay)
        return process(entry)

    eng._process_entry = slow
    return seen


class _WrongDrafter:
    """Guaranteed rejections (tests/test_speculative.py): draft the token
    one off the known greedy continuation, so every verify writes rows
    that must be rolled back."""

    def __init__(self, prompt_len: int, expected: list[int], vocab: int):
        self.prompt_len, self.expected, self.vocab = prompt_len, expected, vocab

    def draft(self, tokens: list[int], k: int) -> list[int]:
        if k <= 0:
            return []
        pos = len(tokens) - self.prompt_len
        nxt = self.expected[pos : pos + k] or self.expected[-1:] * k
        return [(t + 1) % self.vocab for t in nxt]


class _OracleDrafter:
    """Proposes the continuation each prompt's reference stream gives it
    (the longest prompt the stream starts with)."""

    def __init__(self, prompts, streams):
        self.refs = sorted(zip(prompts, streams), key=lambda ps: -len(ps[0]))

    def draft(self, tokens: list[int], k: int) -> list[int]:
        for p, stream in self.refs:
            if k > 0 and tokens[: len(p)] == p:
                return stream[len(tokens) - len(p) :][:k]
        return []


# -- the drafter and the acceptance rule (a copy of gofr_tpu.spec) ----------


@pytest.mark.parametrize("seed", range(6))
def test_drafter_and_acceptance_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        n = int(rng.integers(0, 40))
        vocab = int(rng.choice([3, 8, 40]))
        stream = rng.integers(0, vocab, n).tolist()
        lo = int(rng.integers(1, 3))
        hi = lo + int(rng.integers(0, 3))
        k = int(rng.integers(0, 7))
        assert TS.NGramDrafter(hi, lo).draft(stream, k) == JS.NGramDrafter(hi, lo).draft(stream, k)
        d = rng.integers(0, 4, int(rng.integers(0, 6))).tolist()
        s = rng.integers(0, 4, len(d) + 1).tolist()
        assert TS.accept_length(d, s) == JS.accept_length(d, s)
        ema, kmax, streak = float(rng.random()), int(rng.integers(0, 9)), int(rng.integers(0, 40))
        assert TS.draft_len(ema, kmax, streak) == JS.draft_len(ema, kmax, streak)
    for name in ("SPEC_DRAFT_DEFAULT", "SPEC_EMA_ALPHA", "SPEC_BACKOFF_EMA", "SPEC_PROBE_EVERY"):
        assert getattr(TS, name) == getattr(JS, name)


@pytest.mark.parametrize("stream,k,want", [
    ([16777216, 1, 999, 257], 2, []),  # 257's bytes at an unaligned offset
    ([257, 42, 16777216, 1, 999, 257], 2, [42, 16777216]),  # aligned hit below the decoy
    ([1, 2, 3, 9, 9, 1, 2, 3], 2, [9, 9]),
    ([5, 6] * 4, 3, [5, 6, 5]),
])
def test_drafter_unaligned_decoys_match_jax(stream, k, want):
    assert TS.NGramDrafter(max_ngram=1).draft(stream, k) == JS.NGramDrafter(max_ngram=1).draft(stream, k)
    assert TS.NGramDrafter().draft(stream, k) == JS.NGramDrafter().draft(stream, k)
    assert TS.NGramDrafter(max_ngram=1).draft(stream, k) == want


# -- verify_chunk -------------------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny", "tiny_llama"])
def test_verify_chunk_matches_jax(preset):
    """Tokens [b, 5] against a gathered cache at mixed cursors, n_new in
    {0, 1, 3, 5}: every position's logits and the written K/V rows."""
    jcfg = getattr(JT.TransformerConfig, preset)()
    jp = JT.init_params(jax.random.PRNGKey(4), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(5), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    tcfg = getattr(TT.TransformerConfig, preset)()
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(6)
    L, b, cap, c = jcfg.n_layers, 4, 32, 5
    shape = (L, b, cap, jcfg.n_kv_heads, jcfg.head_dim)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
    cursors = np.asarray([0, 7, 20, 26], np.int32)
    n_new = np.asarray([5, 3, 0, 1], np.int32)
    want_logits, want = JT.verify_chunk(
        jp, jcfg, jnp.asarray(tokens), JT.KVCache(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(cursors)),
        jnp.asarray(cursors), jnp.asarray(n_new),
    )
    got_logits, got = TT.verify_chunk(
        tp, tcfg, torch.from_numpy(tokens),
        TT.KVCache(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()), torch.from_numpy(cursors)),
        torch.from_numpy(cursors), torch.from_numpy(n_new),
    )
    assert got_logits.shape == (b, c, jcfg.vocab_size) and got_logits.dtype == torch.float32
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got.length.numpy(), cursors + n_new)
    # rows outside [cursor, cursor + n_new) are untouched
    for i in range(b):
        keep = np.ones(cap, bool)
        keep[cursors[i] : cursors[i] + n_new[i]] = False
        np.testing.assert_array_equal(got.k.numpy()[:, i, keep], ck[:, i, keep])


# -- the engine: greedy identity --------------------------------------------------


@pytest.mark.parametrize("spec_draft", [1, 2, 4, 5])
def test_greedy_spec_on_equals_jax_and_spec_off(weights, spec_off, spec_draft):
    want = [spec_off.generate(p, max_new_tokens=24) for p in (REPETITIVE, NATURAL)]
    ref = _jax(weights, spec_draft=spec_draft)
    port = _port(weights, spec_draft=spec_draft)
    try:
        assert [ref.generate(p, max_new_tokens=24) for p in (REPETITIVE, NATURAL)] == want
        assert [port.generate(p, max_new_tokens=24) for p in (REPETITIVE, NATURAL)] == want
        st = port.stats()["spec"]
        assert st["enabled"] and st["draft"] == spec_draft and st["steps"] > 0 and st["accepted"] > 0
        assert st["accepted"] <= st["proposed"] and st["accept_rate"] == round(st["accepted"] / st["proposed"], 3)
        assert f"llm.step_v{spec_draft + 1}" in port._programs
        _settled(port)
    finally:
        ref.close()
        port.close()


def test_concurrent_requests_with_pipelined_verifies(weights, spec_off):
    """Four speculating slots at lookahead 3 with a slowed collector: at
    least two verifies are in flight at once, each stream stays equal to
    spec-off and to JAX spec-on."""
    prompts = [REPETITIVE, NATURAL, [3, 4] * 8, [9] * 12]
    want = [r.tokens() for r in [spec_off.submit(GenRequest(p, max_new_tokens=30)) for p in prompts]]
    ref = _jax(weights)
    try:
        assert [r.tokens() for r in [ref.submit(JRequest(p, max_new_tokens=30)) for p in prompts]] == want
    finally:
        ref.close()
    with _port(weights) as port:
        seen = _slow_collector(port, 0.03)
        got = [r.tokens() for r in [port.submit(GenRequest(p, max_new_tokens=30)) for p in prompts]]
        assert got == want
        assert max(seen) >= 2, seen
        assert port.stats()["spec"]["accepted"] > 0
        _settled(port)


def test_forced_rejection_rolls_back(weights, spec_off):
    """Every draft rejected: the stream is spec-off's, nothing is
    accepted, and the next request on the same slot (over the rejected
    rows) is unchanged."""
    want = spec_off.generate(REPETITIVE, max_new_tokens=24)
    want2 = spec_off.generate(NATURAL, max_new_tokens=16)
    with _port(weights) as port:
        port.drafter = _WrongDrafter(len(REPETITIVE), want, port.cfg.vocab_size)
        r1 = port.submit(GenRequest(list(REPETITIVE), max_new_tokens=24))
        assert r1.tokens() == want
        st = port.stats()["spec"]
        assert st["proposed"] > 0 and st["accepted"] == 0
        _settled(port)
        r2 = port.submit(GenRequest(list(NATURAL), max_new_tokens=16))
        assert r2.tokens() == want2 and r2.slot == r1.slot


def test_backoff_to_plain_chunks(weights, spec_off):
    """0% acceptance over 40 tokens: the EMA falls below the backoff
    threshold and the rest decodes in plain chunks."""
    want = spec_off.generate(NATURAL, max_new_tokens=40)
    with _port(weights) as port:
        port.drafter = _WrongDrafter(len(NATURAL), want, port.cfg.vocab_size)
        before = port.stats()
        req = port.submit(GenRequest(list(NATURAL), max_new_tokens=40))
        assert req.tokens() == want
        st = port.stats()
    assert st["spec"]["accepted"] == 0 and st["spec"]["proposed"] < 40
    assert req._spec_ema < TS.SPEC_BACKOFF_EMA
    assert (st["chunks"] - before["chunks"]) - (st["steps"] - before["steps"]) > 0  # plain chunks ran


def test_plain_burst_ends_with_its_slots(weights, spec_off):
    """Requests served one after another each speculate from their first
    verify. The JAX engine's plain-chunk burst (``_spec_hold``), bought by
    an idle pass or by a last token that leaves no room to draft, outlives
    the slots that bought it: there the same requests run no verify."""
    want = spec_off.generate(REPETITIVE, max_new_tokens=24)
    ref = _jax(weights)
    port = _port(weights)
    try:
        time.sleep(0.2)  # both schedulers pass idle
        assert ref._spec_hold == ref._SPEC_REPROBE_CHUNKS
        for _ in range(2):
            steps = port.stats()["spec"]["steps"]
            assert ref.generate(REPETITIVE, max_new_tokens=24) == want
            assert port.generate(REPETITIVE, max_new_tokens=24) == want
            assert port.stats()["spec"]["steps"] > steps
            _settled(port)
        assert ref.stats()["spec"]["steps"] == 0
    finally:
        ref.close()
        port.close()


# -- scheduling ----------------------------------------------------------------------


def test_budget_rotation_no_slot_starvation(weights, spec_off):
    """A step budget of one verify lane: the lane rotates across
    dispatches, so the long request in the high slot interleaves with the
    short ones refilling the low slot instead of draining after all of
    them (tests/test_speculative.py)."""
    long_prompt = ([5, 6, 7, 8] * 8)[:24]
    want_long = spec_off.generate(long_prompt, max_new_tokens=40)
    want_short = spec_off.generate(REPETITIVE, max_new_tokens=12)
    done: list[str] = []
    lanes: list[int] = []
    lock = threading.Lock()
    with _port(weights, slots=2) as port:
        port.step_token_budget = port.spec_draft + 1
        process = port._process_verify_entry

        def record(entry, toks, now):
            lanes.append(len(entry[2]))
            return process(entry, toks, now)

        port._process_verify_entry = record

        def consume(r, name, want):
            assert r.tokens(timeout=60) == want
            with lock:
                done.append(name)

        first = port.submit(GenRequest(list(REPETITIVE), max_new_tokens=12))
        long_req = port.submit(GenRequest(long_prompt, max_new_tokens=40))
        shorts = [port.submit(GenRequest(list(REPETITIVE), max_new_tokens=12)) for _ in range(6)]
        threads = [threading.Thread(target=consume, args=a) for a in
                   [(first, "s0", want_short), (long_req, "long", want_long)]
                   + [(s, f"s{i + 1}", want_short) for i, s in enumerate(shorts)]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(not t.is_alive() for t in threads), done
        _settled(port)
    assert len(done) == 8 and done.index("long") < len(done) - 1, done
    assert lanes and max(lanes) == 1


def test_prefill_arrives_while_verifies_fly(weights, spec_off):
    """A prompt admitted while a speculating request has verifies in
    flight: its unified step's fused decode part advances the verifying
    slot from the device tail (the JAX order), and both streams equal
    spec-off's."""
    a_prompt, b_prompt = REPETITIVE, ([2, 9, 4] * 6)[:17]
    want_a = spec_off.generate(a_prompt, max_new_tokens=60)
    want_b = spec_off.generate(b_prompt, max_new_tokens=20)
    behind: list[bool] = []
    with _port(weights) as port:
        _slow_collector(port, 0.03)
        step = port._dispatch_step

        def watch():
            with port._lock:
                behind.append(any(e[0] == "verify" for e in port._inflight))
            return step()

        port._dispatch_step = watch
        ra = port.submit(GenRequest(a_prompt, max_new_tokens=60))
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 20:
            with port._lock:
                if ra.emitted >= 12 and any(e[0] == "verify" for e in port._inflight):
                    break
            time.sleep(0.001)
        rb = port.submit(GenRequest(b_prompt, max_new_tokens=20))
        assert ra.tokens() == want_a and rb.tokens() == want_b
        _settled(port)
    assert behind[0] is False and any(behind[1:]), behind


def test_wide_draft_at_max_seq_len(weights):
    """spec_draft 16 (W = 17, the clamp's limit at decode chunk 8) on a
    prompt that leaves the least decode room: every verify row lands
    below the capacity and inside the request's reserved blocks, and the
    stream equals spec-off's and JAX spec-on's."""
    kw = dict(max_seq_len=64)
    prompt = ([5, 6, 7, 8] * 10)[:31]  # room = 64 - 31 - 16 = 17
    _jcfg, _jp, tcfg, tp = weights
    with LLMEngine(tcfg, tp, device="cpu", **{**ENGINE_KW, **kw}) as off:
        want = off.generate(prompt, max_new_tokens=40)
    assert len(want) == 17
    ref = _jax(weights, spec_draft=16, **kw)
    try:
        assert ref.generate(prompt, max_new_tokens=40) == want
    finally:
        ref.close()
    rows: list[tuple[int, int, int]] = []
    with _port(weights, spec_draft=40, **kw) as port:
        assert port.spec_draft == 16 and port.kv.append_slack == 17
        name = "llm.step_v17"
        fn, kind, arg = port._programs[name]

        def checked():
            vp, length = port._in.verify(), port.pool.length
            for s in range(port.slots):
                if int(vp[s, 17]) == 1:
                    r = port._slot_req[s]
                    top = int(length[s]) + int(vp[s, 16])  # the last row this lane writes
                    rows.append((top, port._kv_hi[s], r._kv_limit))
            return fn()

        port._programs[name] = (checked, kind, arg)
        assert port.generate(prompt, max_new_tokens=40) == want
        _settled(port)
    assert rows and all(top < min(hi, port.kv.capacity) and hi <= lim for top, hi, lim in rows), rows


# -- prefix hits, int8, retirement --------------------------------------------------


def test_prefix_hits_then_verify_match_jax(weights):
    """Exact and block-partial hits on repetitive prompts, then verifies:
    JAX's tokens and prefix counters, and every row a verify writes lands
    in a block only the slot holds (refcount 1), never in a shared one."""
    base = REPETITIVE
    sib = base[:16] + [9] * 6  # shares one full block
    ref = _jax(weights, prefix_cache_mb=4.0)
    port = _port(weights, prefix_cache_mb=4.0)
    bad: list = []
    shared_lanes = [0]
    try:
        name = f"llm.step_v{port.spec_draft + 1}"
        fn, kind, arg = port._programs[name]
        Kd, B = port.spec_draft, port.kv.block

        def checked():
            vp, tables, length = port._in.verify(), port._in.tables(), port.pool.length
            refs = port.kv.pool.refs
            for s in range(port.slots):
                if int(vp[s, Kd + 1]) != 1:
                    continue
                shared_lanes[0] += any(refs[int(b)] > 1 for b in tables[s, : int(length[s]) // B])
                for j in range(int(vp[s, Kd]) + 1):
                    blk = int(tables[s, (int(length[s]) + j) // B])
                    if refs[blk] != 1:
                        bad.append((s, int(length[s]) + j, blk, int(refs[blk])))
            return fn()

        port._programs[name] = (checked, kind, arg)
        for p in (base, base, sib, sib):
            want = ref.generate(p, max_new_tokens=20)
            assert port.generate(p, max_new_tokens=20) == want
        st = port.stats()
        assert st["kvcache"]["prefix"] == ref.stats()["kvcache"]["prefix"]
        assert st["kvcache"]["prefix"]["hits"] == 2 and st["kvcache"]["prefix"]["partial_hits"] >= 1
        assert st["spec"]["steps"] > 0
    finally:
        ref.close()
        port.close()
    assert not bad, bad
    assert shared_lanes[0] > 0  # verifies ran on slots holding shared blocks


def test_int8_spec_matches_jax(weights):
    prompts = [REPETITIVE, NATURAL, ([11, 12, 13] * 7)[:19]]
    ref = _jax(weights, kv_int8=True, quantize=True)
    port = _port(weights, kv_int8=True, quantize=True)
    try:
        for p in prompts:
            assert port.generate(p, max_new_tokens=24) == ref.generate(p, max_new_tokens=24)
        st = port.stats()
        assert st["quantized"] and st["kvcache"]["int8"] and st["spec"]["steps"] > 0
        _settled(port)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("why", ["cancelled", "deadline"])
def test_retirement_during_a_verify(weights, spec_off, why):
    """Cancelled (or past its deadline) while verifies for it are in
    flight: retired by the next scheduler pass, not by the slowed
    collector; the stream is a prefix of spec-off's; slot and blocks free."""
    full = spec_off.generate(REPETITIVE, max_new_tokens=90)
    with _port(weights) as port:
        _slow_collector(port, 0.5)
        r = port.submit(GenRequest(list(REPETITIVE), max_new_tokens=90))
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 30:
            with port._lock:
                if r.emitted >= 5 and any(e[0] == "verify" for e in port._inflight):
                    if why == "cancelled":
                        r.cancel()
                    else:
                        r.deadline = time.perf_counter()
                    t_ret = time.perf_counter()
                    break
            time.sleep(0.001)
        while r.finish_reason is None and time.perf_counter() - t_ret < 5:
            time.sleep(0.001)
        with port._lock:  # retired while programs carrying it are still unfetched
            carried = any(r in port._entry_requests(e) for e in [*port._inflight, port._processing] if e)
        assert r.finish_reason == why and carried
        out = r.tokens(timeout=10)
        assert 5 <= len(out) < 90 and out == full[: len(out)]
        st = _settled(port)
        assert port._slot_req[r.slot] is None and st["deadline_cancels"] == (why == "deadline")


# -- temperature, knobs ---------------------------------------------------------------


def test_temperature_histogram_matches_spec_off():
    """At temperature 1 spec-on samples the target distribution
    (Leviathan rejection sampling with a deterministic drafter): pooled
    token histograms of spec-on and spec-off on a 32-token vocab agree
    within total variation 0.25 (the JAX TestTemperature method and
    bound). A drafter that always proposes the last token keeps verifies,
    rejections and bonus draws in most of the stream; an untied random
    head keeps the streams from locking into loops, so two spec-off runs
    with other seeds differ by TV ~0.07 here. Draws differ by design:
    this is a distribution check."""

    class RepeatDrafter:
        def draft(self, tokens, k):
            return [tokens[-1]] * k if k > 0 else []

    cfg = TT.TransformerConfig.tiny(vocab_size=32)
    params = TT.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    params["unembed"] = torch.randn((32, cfg.d_model), generator=torch.Generator().manual_seed(2)) * 0.5
    prompt = ([3, 4, 5] * 5)[:12]

    def harvest(spec: bool):
        counts = np.zeros(cfg.vocab_size)
        with LLMEngine(cfg, params, device="cpu", speculative=spec, spec_draft=3, seed=3, **ENGINE_KW) as eng:
            if spec:
                eng.drafter = RepeatDrafter()
            reqs = [eng.submit(GenRequest(list(prompt), max_new_tokens=40, temperature=1.0)) for _ in range(64)]
            for r in reqs:
                for t in r.tokens():
                    counts[t] += 1
            st = eng.stats()["spec"]
        return counts / counts.sum(), st

    p_off, _ = harvest(False)
    p_on, st = harvest(True)
    assert st["steps"] > 20 and st["proposed"] > 100 and st["accepted"] > 0
    tv = 0.5 * np.abs(p_off - p_on).sum()
    assert tv < 0.25, f"total variation {tv:.3f} (spec-on vs spec-off)"


def test_spec_knobs_and_spec_off_registers_nothing(weights, spec_off, monkeypatch):
    assert spec_off.drafter is None and not spec_off.speculative and spec_off.spec_draft == 0
    assert not any(n.startswith("llm.step_v") for n in spec_off._programs)
    assert sorted(spec_off._programs) == sorted(
        [f"llm.step_p{s}_d8.w{w}" for s in (8, 16) for w in (1, 2, 4)] + ["llm.decode_chunk8", "llm.decode_chunk2"]
    )
    st = spec_off.stats()["spec"]
    assert st == {"enabled": False, "draft": 0, "steps": 0, "proposed": 0, "accepted": 0, "plain_lanes": 0,
                  "accept_rate": None, "constrained": {"proposed": 0, "accepted": 0, "accept_rate": None},
                  "unconstrained": {"proposed": 0, "accepted": 0, "accept_rate": None}}
    assert set(st) == set(_jax_spec_off_summary(weights))
    monkeypatch.setenv("TPU_LLM_SPEC", "1")
    monkeypatch.setenv("TPU_LLM_SPEC_DRAFT", "2")
    _jcfg, _jp, tcfg, tp = weights
    with LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW) as eng:
        assert eng.speculative and eng.spec_draft == 2 and "llm.step_v3" in eng._programs
        assert eng.kv.append_slack == 16  # the widest chunk shape still
    monkeypatch.setenv("TPU_LLM_SPEC", "0")
    with LLMEngine(tcfg, tp, device="cpu", spec_draft=3, **ENGINE_KW) as eng:
        assert not eng.speculative and eng.spec_draft == 0
    with LLMEngine(tcfg, tp, device="cpu", speculative=True, **ENGINE_KW) as eng:
        assert eng.spec_draft == 2  # TPU_LLM_SPEC_DRAFT, for a draft left out


def _jax_spec_off_summary(weights) -> dict:
    jcfg, jp, _tcfg, _tp = weights
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, **ENGINE_KW)
    try:
        return ref.stats()["spec"]
    finally:
        ref.close()


def test_stress_clients_cancels_and_switches(weights, spec_off):
    """More client threads than cores and slots, a tiny interpreter switch
    interval, speculating requests (an oracle drafter proposing spec-off's
    streams, so verifies run and pipeline all along) and a third of them
    cancelled at random points: every stream ends exactly once, an
    uncancelled stream is spec-off's greedy stream, and the engine's
    counts and pool come back to zero."""
    import os
    import random
    import sys

    n = min(64, max(16, 2 * len(os.sched_getaffinity(0))))
    bases = [REPETITIVE, ([2, 9, 4] * 6)[:17], [3, 4] * 8, [9] * 12, ([5, 6, 7, 8] * 10)[:37], NATURAL]
    want = {i: spec_off.generate(p, max_new_tokens=20) for i, p in enumerate(bases)}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _port(weights) as port:
            port.drafter = _OracleDrafter(bases, [want[i] for i in range(len(bases))])
            rng = random.Random(1)
            reqs = [(i % len(bases), GenRequest(list(bases[i % len(bases)]), max_new_tokens=20)) for i in range(n)]
            ends = {id(r): 0 for _b, r in reqs}
            got = {id(r): [] for _b, r in reqs}

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
                threading.Thread(target=client, args=(r, rng.randint(1, 12) if i % 3 == 0 else None))
                for i, (_b, r) in enumerate(reqs)
            ]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            assert not any(th.is_alive() for th in threads)
            st = _settled(port, timeout=60.0)
            for b, r in reqs:
                out = got[id(r)]
                assert ends[id(r)] == 1 and r.out.qsize() == 0
                assert out == want[b][: len(out)]
                assert r.finish_reason == "cancelled" or out == want[b]
            assert st["finished"] == st["submitted"] == n and st["spec"]["accepted"] > 0
    finally:
        sys.setswitchinterval(old)
