"""The contiguous KV layouts of gofr_tpu_torch against gofr_tpu (CPU, f32
tiny presets): the dense slab [L, S, max_seq_len, hkv, hd] and the rolling
ring [L, S, window + slack, hkv, hd] that ``kv_paged="auto"`` gives a
windowed model.

- ops: ``ring_positions`` and both ring attention branches against
  ``gofr_tpu.ops`` (allclose 1e-5), the precondition errors;
- programs: ``prefill_append`` / ``verify_chunk`` with ``ring=`` (cursors
  straddling a multiple of the capacity) and the contiguous
  ``decode_chunk`` (dense with inactive slots and the clamped merge, and
  ring) against the JAX functions (allclose 1e-4: the two frameworks sum
  in different orders, as tests/test_torch_model.py);
- ``CacheManager``'s planning against the JAX manager's;
- engines: greedy token identity against ``gofr_tpu.llm.LLMEngine(
  kv_paged=False)`` on the same weights at lookahead 1 and 3, through
  the unified step, the decode chunks, the verify and the constrained
  twins, with adapters, on tiny_moe, and across a preemption.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import ops as JA
from gofr_tpu import structured as JS
from gofr_tpu.kvcache import CacheManager as JCacheManager
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.lora import init_adapter
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch import structured as TS
from gofr_tpu_torch.kvcache import CacheManager, paged_default
from gofr_tpu_torch.llm import GenRequest, LLMEngine
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.ops import attention as TA

OP_ATOL = 1e-5
ATOL = 1e-4
# tiny_mistral's window is 8: at max_seq_len 64 and chunk shapes (8, 16) the
# ring holds 8 + 16 = 24 rows a slot
ENGINE_KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8, 16))
# the JAX engine at the port's fixed shapes (gofr_tpu_torch.llm constants)
JAX_KW = dict(warmup=False, kv_paged=False, decode_chunk=8, prefill_chunk=64, step_token_budget=256)


def _pair(name: str, seed: int = 0, n_layers: int | None = None, **cfg_kw):
    """(jax cfg, jax params, port cfg, port params) of preset ``name`` (at
    ``n_layers`` when given), with an untied random unembed so greedy
    streams vary."""
    jcfg = getattr(JT.TransformerConfig, name)(**cfg_kw)
    tcfg = getattr(TT.TransformerConfig, name)(**cfg_kw)
    if n_layers is not None:
        jcfg, tcfg = dataclasses.replace(jcfg, n_layers=n_layers), dataclasses.replace(tcfg, n_layers=n_layers)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(seed + 100), (jcfg.vocab_size, jcfg.d_model),
                                            jnp.float32))
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def mistral():
    return _pair("tiny_mistral")


@pytest.fixture(scope="module")
def tiny():
    return _pair("tiny")


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


# -- ops ----------------------------------------------------------------------


def test_ring_positions_match_jax():
    """Every row's reconstructed position, at t == 0 (all negative), below
    the capacity, at it and laps past it."""
    lengths = np.array([0, 1, 5, 23, 24, 25, 61, 96], np.int32)
    for cap in (1, 7, 24):
        got = TA.ring_positions(_t(lengths), cap).numpy()
        np.testing.assert_array_equal(got, np.asarray(JA.ring_positions(_j(lengths), cap)))
        assert (got[0] < 0).all() and got.dtype == np.int32


def _qkv(rng, b, sq, hq, hkv, d, n):
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, n, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, n, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("ring", [0, 20])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_chunk_decode_attention_matches_jax(ring, cap):
    """The joint cache + buffer softmax, dense and on a ring of 20 with a
    window of 12, at lengths 0 (nothing written), inside the capacity and
    laps past it, at every step of a 4-step buffer."""
    rng = np.random.default_rng(1)
    b, hq, hkv, d, K = 4, 4, 2, 16, 4
    n = ring or 40
    q, k, v = _qkv(rng, b, 1, hq, hkv, d, n)
    kb = rng.normal(size=(b, K, hkv, d)).astype(np.float32)
    vb = rng.normal(size=(b, K, hkv, d)).astype(np.float32)
    lengths = np.array([0, 9, 23, 57] if ring else [0, 9, 23, 36], np.int32)
    for step in range(K):
        kw = dict(logit_cap=cap, window=12, ring=ring)
        want = JA.chunk_decode_attention(_j(q), _j(k), _j(v), _j(kb), _j(vb), _j(lengths), jnp.int32(step), **kw)
        got = TA.chunk_decode_attention(_t(q), _t(k), _t(v), _t(kb), _t(vb), _t(lengths), step, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_ATOL, rtol=0)


@pytest.mark.parametrize("c", [8, 5])
def test_chunk_prefill_attention_ring_matches_jax(c):
    """The ring branch at cursors before the first lap, across a multiple
    of the capacity and laps later (rows written before the call, as the
    append does), with a logit cap; c = 5 is the verify's width."""
    rng = np.random.default_rng(2)
    b, hq, hkv, d, ring, window = 4, 4, 2, 16, 24, 16
    q, k, v = _qkv(rng, b, c, hq, hkv, d, ring)
    cursors = np.array([0, 19, 22, 70], np.int32)  # 19 + 8 and 22 + 5 cross 24
    for cap in (0.0, 25.0):
        kw = dict(logit_cap=cap, window=window, ring=ring)
        want = JA.chunk_prefill_attention(_j(q), _j(k), _j(v), _j(cursors), **kw)
        got = TA.chunk_prefill_attention(_t(q), _t(k), _t(v), _t(cursors), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_ATOL, rtol=0)


def test_ring_preconditions_raise_as_jax():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 8, 4, 2, 16, 20)
    kb = np.zeros((1, 2, 2, 16), np.float32)
    lens = np.array([3], np.int32)
    # the prefill branch needs 0 < window <= ring - c; the decode branch 0 < window <= ring
    for window in (0, 13):
        with pytest.raises(ValueError, match="ring - chunk") as te:
            TA.chunk_prefill_attention(_t(q), _t(k), _t(v), _t(lens), window=window, ring=20)
        with pytest.raises(ValueError) as je:
            JA.chunk_prefill_attention(_j(q), _j(k), _j(v), _j(lens), window=window, ring=20)
        assert str(te.value) == str(je.value)
    for window in (0, 21):
        with pytest.raises(ValueError, match="0 < window <= ring,") as te:
            TA.chunk_decode_attention(_t(q[:, :1]), _t(k), _t(v), _t(kb), _t(kb), _t(lens), 0, window=window, ring=20)
        with pytest.raises(ValueError) as je:
            JA.chunk_decode_attention(_j(q[:, :1]), _j(k), _j(v), _j(kb), _j(kb), _j(lens), jnp.int32(0),
                                      window=window, ring=20)
        assert str(te.value) == str(je.value)


# -- programs -----------------------------------------------------------------


def _cache(rng, jcfg, b, cap):
    shape = (jcfg.n_layers, b, cap, jcfg.n_kv_heads, jcfg.head_dim)
    return rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("fn", ["prefill_append", "verify_chunk"])
@pytest.mark.parametrize("c", [8, 5])
def test_append_on_a_ring_matches_jax(mistral, fn, c):
    """A chunk appended into a ring of 24 (window 8): cursors before the
    first lap, straddling 24 and 48, and a row that appends nothing; the
    ring rows, logits and lengths equal the JAX function's."""
    jcfg, jp, tcfg, tp = mistral
    rng = np.random.default_rng(4)
    b, ring = 4, 24
    ck, cv = _cache(rng, jcfg, b, ring)
    tokens = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
    cursors = np.array([0, 20, 45, 33], np.int32)
    n_new = np.array([c, c, c - 2, 0], np.int32)
    want_logits, want = getattr(JT, fn)(
        jp, jcfg, _j(tokens), JT.KVCache(_j(ck), _j(cv), _j(cursors)), _j(cursors), _j(n_new), ring=ring,
    )
    got_logits, got = getattr(TT, fn)(
        tp, tcfg, _t(tokens), TT.KVCache(_t(ck), _t(cv), _t(cursors)), _t(cursors), _t(n_new), ring=ring,
    )
    live = n_new > 0  # a row with nothing appended returns garbage logits
    np.testing.assert_allclose(got_logits.numpy()[live], np.asarray(want_logits)[live], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    # the row that appended nothing kept its rows bit for bit
    np.testing.assert_array_equal(got.k.numpy()[:, 3], ck[:, 3])


def test_dense_append_past_the_capacity_writes_nothing(tiny):
    """A dense row whose chunk runs past the capacity drops the rows past
    it, as the JAX scatter's out-of-bounds indices do."""
    jcfg, jp, tcfg, tp = tiny
    rng = np.random.default_rng(5)
    ck, cv = _cache(rng, jcfg, 2, 20)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    cursors, n_new = np.array([16, 3], np.int32), np.array([8, 8], np.int32)
    want_logits, want = JT.prefill_append(jp, jcfg, _j(tokens), JT.KVCache(_j(ck), _j(cv), _j(cursors)),
                                          _j(cursors), _j(n_new))
    got_logits, got = TT.prefill_append(tp, tcfg, _t(tokens), TT.KVCache(_t(ck), _t(cv), _t(cursors)),
                                        _t(cursors), _t(n_new))
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_logits.numpy()[1], np.asarray(want_logits)[1], atol=ATOL, rtol=0)


def _greedy_j(logits, temps, key):
    return jnp.argmax(logits, axis=-1).astype(jnp.int32)


def _greedy_t(logits, temps, gen):
    return logits.argmax(dim=-1).to(torch.int32)


@pytest.mark.parametrize("layout", ["dense", "ring"])
def test_decode_chunk_matches_jax(mistral, tiny, layout):
    """Four fused steps on a dense slab of 40 rows (tiny; lengths 0, 5, a
    clamped merge at 38 and an inactive slot) and on a ring of 24
    (tiny_mistral; lengths 0, inside the ring, straddling 24 and laps
    past it, one inactive): tokens, rows and lengths equal the JAX
    program's."""
    jcfg, jp, tcfg, tp = mistral if layout == "ring" else tiny
    ring = 24 if layout == "ring" else 0
    rng = np.random.default_rng(6)
    b, K = 4, 4
    ck, cv = _cache(rng, jcfg, b, ring or 40)
    lengths = np.array([0, 5, 22, 61] if ring else [0, 5, 38, 12], np.int32)
    active = np.array([True, True, True, False])
    tokens = rng.integers(0, jcfg.vocab_size, (b,)).astype(np.int32)
    temps = np.zeros((b,), np.float32)
    want_toks, want_last, want, _rng = JT.decode_chunk(
        jp, jcfg, _j(tokens), JT.KVCache(_j(ck), _j(cv), _j(lengths)), _j(active), _j(temps),
        jax.random.PRNGKey(0), n_steps=K, sample_fn=_greedy_j, ring=ring,
    )
    cache = TT.KVCache(_t(ck), _t(cv), _t(lengths))
    got_toks, got_last, got = TT.decode_chunk(
        tp, tcfg, _t(tokens), cache, _t(active), _t(temps), None, n_steps=K, sample_fn=_greedy_t, ring=ring,
    )
    assert got is cache  # written in place
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))
    np.testing.assert_array_equal(got_last.numpy(), np.asarray(want_last))
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=ATOL, rtol=0)


def test_decode_chunk_sample_state_matches_stateless(tiny):
    """The stateful seam: a sampler that threads a counter gives the same
    tokens and returns the state advanced once a step."""
    _jcfg, _jp, tcfg, tp = tiny
    rng = np.random.default_rng(7)
    ck, cv = _cache(rng, tcfg, 2, 32)
    lengths = np.array([3, 9], np.int32)

    def run(state):
        cache = TT.KVCache(_t(ck), _t(cv), _t(lengths))
        fn = (lambda lg, tp_, g, st: (_greedy_t(lg, tp_, g), st + 1)) if state is not None else _greedy_t
        return TT.decode_chunk(tp, tcfg, _t([5, 6]), cache, _t([True, True]), _t([0.0, 0.0]), None,
                               n_steps=3, sample_fn=fn, sample_state=state)

    plain, stateful = run(None), run(torch.zeros(2, dtype=torch.int32))
    assert torch.equal(plain[0], stateful[0]) and stateful[3].tolist() == [3, 3]


# -- CacheManager -------------------------------------------------------------


@pytest.mark.parametrize("case", [
    # (preset, slots, max_seq_len, decode_chunk, kwargs): tests/test_kvcache.py::TestManagerPlanning
    ("tiny", 2, 64, 8, {}),
    ("tiny_mistral", 2, 16, 8, {}),  # window + chunk >= max_seq_len: rolling buys nothing
    ("tiny_mistral", 2, 64, 8, {}),
    ("tiny_mistral", 2, 64, 8, {"window": 0}),  # the dense A/B lever
    ("tiny_mistral", 3, 256, 8, {"append_widths": (16, 5)}),
    ("tiny_mistral", 2, 64, 8, {"paged": "auto"}),
    ("tiny_mistral", 2, 64, 8, {"paged": "auto", "session_mb": 4.0}),
    ("tiny", 2, 64, 8, {"paged": "auto"}),
    ("tiny_mistral", 2, 64, 8, {"paged": True}),
])
def test_cache_manager_planning_matches_jax(case):
    name, slots, max_len, chunk, kw = case
    jcfg, tcfg = getattr(JT.TransformerConfig, name)(), getattr(TT.TransformerConfig, name)()
    j = JCacheManager(jcfg, slots, max_len, chunk, **{"paged": False, **kw})
    t = CacheManager(tcfg, slots, max_len, chunk, **{"paged": False, **kw})
    assert (t.paged, t.rolling, t.capacity, t.ring, t.window, t.append_slack) == (
        j.paged, j.rolling, j.capacity, j.ring, j.window, j.append_slack)
    if not t.paged:
        assert t.slot_bytes == j.slot_bytes
        js, ts = j.stats(), t.stats()
        assert {k: ts[k] for k in js} == js
        cache = t.init_cache(slots, "cpu")
        assert cache.k.shape == (tcfg.n_layers, slots, t.capacity, tcfg.n_kv_heads, tcfg.head_dim)
        assert cache.k.dtype == tcfg.dtype and cache.length.shape == (slots,)
        assert t.pool is None and t.radix is None and t.sessions is None and not t.share


def test_cache_manager_window_override_and_refusals():
    jcfg, tcfg = JT.TransformerConfig.tiny_mistral(), TT.TransformerConfig.tiny_mistral()
    with pytest.raises(ValueError, match="sliding_window"):
        JCacheManager(jcfg, 2, 64, 8, window=4)
    with pytest.raises(ValueError, match="sliding_window"):
        CacheManager(tcfg, 2, 64, 8, window=4, paged=False)
    # the whole-row prefix cache is built on the contiguous layouts, as the
    # JAX manager builds it (it raised before it was ported)
    j = JCacheManager(jcfg, 2, 64, 8, prefix_cache_mb=1.0)
    t = CacheManager(tcfg, 2, 64, 8, paged=False, prefix_cache_mb=1.0)
    assert t.prefix is not None and t.stats()["prefix"] == j.stats()["prefix"]
    assert t.stats()["prefix"]["capacity_bytes"] == 1 << 20
    # int8 KV is the paged pool's only: the contiguous layout stores the model dtype
    assert not CacheManager(tcfg, 2, 64, 8, paged=False, kv_int8=True).int8


def test_paged_default_reads_the_knob(monkeypatch):
    from gofr_tpu.kvcache import paged_default as j_default

    for value in ("", "1", "0", "auto"):
        monkeypatch.setenv("TPU_LLM_KV_PAGED", value)
        assert paged_default() == j_default()
    monkeypatch.delenv("TPU_LLM_KV_PAGED")
    assert paged_default() == "auto"


def test_slot_bytes_at_mistral_7b_widths():
    """The phase's sizes from the arithmetic: Mistral-7B's ring at 8 slots
    and max_seq_len 32768 holds 4096 + 64 rows a slot."""
    cfg = TT.TransformerConfig.mistral_7b()
    kv = CacheManager(cfg, 8, 32768, 8, append_widths=(16, 64), paged="auto")
    assert (kv.rolling, kv.capacity, kv.slot_bytes) == (True, 4160, 4_362_076_160)
    # what the paged pool would take instead (host bookkeeping only)
    for slots, nbytes in ((8, 34_359_738_368), (32, 137_438_953_472)):
        pool = CacheManager(cfg, slots, 32768, 8, append_widths=(16, 64), paged=True)
        assert pool.pool.n_blocks * pool.block_bytes == nbytes


# -- engines ------------------------------------------------------------------


def _same_streams(ref, port, prompts, new_tokens, R=JRequest, **req_kw):
    jreqs = [ref.submit(R(p, max_new_tokens=n, **req_kw)) for p, n in zip(prompts, new_tokens)]
    treqs = [port.submit(GenRequest(p, max_new_tokens=n, **req_kw)) for p, n in zip(prompts, new_tokens)]
    outs = []
    for j, t in zip(jreqs, treqs):
        want = j.tokens(timeout=120)
        assert t.tokens(timeout=120) == want
        outs.append(want)
    return outs


def _idle(eng, timeout: float = 10.0) -> None:
    t0 = time.perf_counter()
    while True:
        with eng._lock:
            if not (eng._inflight or eng._processing is not None or any(eng._slot_req) or eng._waiting):
                break
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("the engine did not idle")
        time.sleep(0.002)
    assert eng.load_tokens() == 0


@pytest.mark.parametrize("lookahead", [1, 3])
@pytest.mark.parametrize("layout", ["ring", "dense", "window0"])
def test_engine_token_identical_to_jax(mistral, tiny, layout, lookahead):
    """Greedy streams of the port's contiguous engine equal the JAX
    engine's (kv_paged=False): tiny_mistral on its ring of 24 rows,
    tiny on the dense slab and tiny_mistral forced dense (kv_window=0),
    prompts of 3-40 tokens straddling the window (8) and the ring's
    capacity (24), one at a time and more than the slots at once."""
    jcfg, jp, tcfg, tp = tiny if layout == "dense" else mistral
    kw = {"kv_window": 0} if layout == "window0" else {}
    ref = JEngine(jcfg, jp, lookahead=lookahead, **JAX_KW, **ENGINE_KW, **kw)
    port = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, lookahead=lookahead, **ENGINE_KW, **kw)
    try:
        kv = port.stats()["kvcache"]
        assert kv["layout"] == ref.kv.stats()["layout"] == ("rolling" if layout == "ring" else "dense")
        assert port.cache.k.shape[2] == kv["capacity"] == ref.kv.capacity and port.pool is None
        for p in _prompts(7, (3, 23, 25)):
            _same_streams(ref, port, [p], [8])
        prompts = _prompts(11, (3, 17, 33, 9, 40, 24))
        _same_streams(ref, port, prompts, [19 if i % 2 else 8 for i in range(len(prompts))])
        _idle(port)
        if layout == "ring":
            # the ring wrapped: lengths are absolute, past the capacity
            assert port.cache.length.max().item() > kv["capacity"]
    finally:
        ref.close()
        port.close()


def test_default_kv_paged_gives_a_windowed_model_the_ring(mistral, tiny):
    """No kv_paged: "auto" (TPU_LLM_KV_PAGED unset), the ring for a
    windowed model where window + slack < max_seq_len, the paged pool
    otherwise, as the JAX engine resolves it."""
    for (jcfg, jp, tcfg, tp), layout in ((mistral, "rolling"), (tiny, "paged")):
        ref = JEngine(jcfg, jp, warmup=False, **ENGINE_KW)
        port = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW)
        try:
            assert port.kv.paged == ref.kv.paged and port.stats()["kvcache"]["layout"] == layout
            assert port.stats()["kv_paged"] is (layout == "paged")
        finally:
            ref.close()
            port.close()


def test_session_tier_keeps_the_paged_pool(mistral):
    """kv_paged="auto" with a session budget pages the windowed model (the
    session tier needs the pool); kv_paged=False takes no session tier."""
    _jcfg, _jp, tcfg, tp = mistral
    with LLMEngine(tcfg, tp, device="cpu", session_mb=1.0, **ENGINE_KW) as eng:
        assert eng.kv.paged and eng.kv.sessions is not None
    with LLMEngine(tcfg, tp, device="cpu", kv_paged=False, session_mb=1.0, **ENGINE_KW) as eng:
        assert not eng.kv.paged and eng.kv.sessions is None and eng.kv.rolling


def _slow_collector(eng, delay: float = 0.002) -> None:
    process = eng._process_entry

    def slow(entry):
        time.sleep(delay)
        return process(entry)

    eng._process_entry = slow


def test_reused_ring_slot_with_stale_active_flag():
    """Lookahead 3, two slots, a ring of 8 + 8 = 16 rows (one chunk shape,
    8): a long request decodes in one slot, so decode chunks keep running,
    while in the other a short request retires with programs in flight
    (its slot's device active flag stays set) and a prompt of 40 tokens
    takes the slot over five appends, with a decode chunk dispatched
    right after every unified step. Without the mid-prefill deactivation,
    that chunk advances the slot's length and its merge overwrites the
    prompt's in-window rows. Six layers: the first token then reads 6 x 8
    positions back, so a row corrupted at any append reaches it."""
    jcfg, jp, tcfg, tp = _pair("tiny_mistral", n_layers=6)
    kw = dict(slots=2, max_seq_len=128, prefill_buckets=(8,), lookahead=3)
    ref = JEngine(jcfg, jp, **JAX_KW, **kw)
    port = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, **kw)
    try:
        assert port.kv.capacity == 16
        step = port._dispatch_step

        def step_then_chunk():
            stepped = step()
            if stepped:
                port._dispatch_chunk(port.decode_chunk)
            return stepped

        port._dispatch_step = step_then_chunk
        runner, short, long = _prompts(13, (6, 5, 40))
        outs = {}
        for eng, R in ((ref, JRequest), (port, GenRequest)):
            run = eng.submit(R(runner, max_new_tokens=90))
            first = eng.submit(R(short, max_new_tokens=3)).tokens(timeout=120)
            second = eng.submit(R(long, max_new_tokens=12))
            outs[eng] = [run.tokens(timeout=120), first, second.tokens(timeout=120)]
        want = outs[ref]
        assert outs[port] == want
        # the long prompt's stream is its own, as served alone
        assert port.generate(long, max_new_tokens=12) == want[2]
        assert port.stats()["steps"] >= 6
    finally:
        ref.close()
        port.close()


class _RepeatDrafter:
    """Proposes the stream's last token k times."""

    def draft(self, tokens, k):
        return [tokens[-1]] * k if k > 0 else []


@pytest.mark.parametrize("lookahead", [1, 3])
def test_speculation_across_the_ring_wrap(mistral, lookahead):
    """Greedy speculative decoding on the ring: verifies append 1 + 4 rows
    on the ring in place and roll back past rejected ones (a rejected row
    reads one lap behind, outside every window: 24 >= 8 + 5); the streams
    cross multiples of 24 and equal the JAX engine's and the spec-off
    port's."""
    jcfg, jp, tcfg, tp = mistral
    spec = dict(speculative=True, spec_draft=4, lookahead=lookahead)
    ref = JEngine(jcfg, jp, **JAX_KW, **ENGINE_KW, **spec)
    port = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, **ENGINE_KW, **spec)
    plain = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, **ENGINE_KW)
    ref.drafter = port.drafter = _RepeatDrafter()
    try:
        prompts = [([5, 6, 7, 8] * 8)[:20], ([3, 9] * 11)[:22]] + _prompts(17, (18,))
        want = _same_streams(ref, port, prompts, [30, 30, 30])
        assert [plain.generate(p, max_new_tokens=30) for p in prompts] == want
        st = port.stats()["spec"]
        assert st["steps"] > 0 and st["accepted"] < st["proposed"]  # verifies rolled back
        assert port.kv.ring == 24 and port.kv.capacity >= port.kv.window + port.spec_draft + 1
    finally:
        ref.close()
        port.close()
        plain.close()


# char-level vocabulary of tests/test_torch_structured.py: id i -> printable byte, last id eos
VOCAB = [chr(0x20 + i).encode() if 0x20 + i < 0x7F else b"" for i in range(127)] + [b""]
EOS = 127


@pytest.mark.parametrize("lookahead", [1, 3])
def test_constrained_request_on_the_ring(lookahead):
    """A regex-constrained request beside free ones on the ring: every
    dispatch runs the constrained twins (step, chunk), the stream matches
    the regex, and all streams equal the JAX engine's."""
    jcfg, jp, tcfg, tp = _pair("tiny_mistral", vocab_size=128)
    kw = dict(ENGINE_KW, max_seq_len=96)
    ref = JEngine(jcfg, jp, lookahead=lookahead, **JAX_KW, **kw)
    port = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, lookahead=lookahead, **kw)
    try:
        assert port.kv.rolling
        jg = JS.compile_regex(r"[a-c]{2,40}", VOCAB, EOS)
        tg = TS.compile_regex(r"[a-c]{2,40}", VOCAB, EOS)
        free = _prompts(19, (30, 12), vocab=128)
        gp = _prompts(23, (27,), vocab=128)[0]
        jreqs = [ref.submit(JRequest(gp, max_new_tokens=40, grammar=jg))]
        jreqs += [ref.submit(JRequest(p, max_new_tokens=20)) for p in free]
        treqs = [port.submit(GenRequest(gp, max_new_tokens=40, grammar=tg))]
        treqs += [port.submit(GenRequest(p, max_new_tokens=20)) for p in free]
        want = [r.tokens(timeout=120) for r in jreqs]
        assert [r.tokens(timeout=120) for r in treqs] == want
        text = b"".join(VOCAB[t] for t in want[0] if t != EOS).decode()
        assert len(text) >= 2 and set(text) <= set("abc")
        assert port.stats()["constrained"]["requests"] == 1
    finally:
        ref.close()
        port.close()


def test_adapted_request_on_the_ring(mistral):
    """A LoRA-adapted request beside a base one on the ring: the adapter
    moves the stream, and both streams equal the JAX engine's."""
    jcfg, jp, tcfg, tp = mistral
    adapter = jax.tree.map(np.asarray, init_adapter(jax.random.PRNGKey(7), jcfg, rank=4, scale=1.0))
    ref = JEngine(jcfg, jp, lora_slots=2, **JAX_KW, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, lora_slots=2, **ENGINE_KW)
    try:
        ref.load_adapter("a", adapter)
        port.load_adapter("a", adapter)
        prompts = _prompts(29, (27, 30))
        jreqs = [ref.submit(JRequest(prompts[0], max_new_tokens=20, adapter="a")),
                 ref.submit(JRequest(prompts[1], max_new_tokens=20))]
        treqs = [port.submit(GenRequest(prompts[0], max_new_tokens=20, adapter="a")),
                 port.submit(GenRequest(prompts[1], max_new_tokens=20))]
        want = [r.tokens(timeout=120) for r in jreqs]
        assert [r.tokens(timeout=120) for r in treqs] == want
        assert port.generate(prompts[0], max_new_tokens=20) != want[0]
    finally:
        ref.close()
        port.close()


def test_moe_on_the_dense_slab():
    """tiny_moe on the dense slab: every program routes its rows through
    the mixture; streams equal the JAX engine's."""
    jcfg, jp, tcfg, tp = _pair("tiny_moe")
    ref = JEngine(jcfg, jp, **JAX_KW, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, **ENGINE_KW)
    try:
        assert port.stats()["kvcache"]["layout"] == "dense"
        for p in _prompts(31, (9, 33)):  # one at a time: capacity is per program
            _same_streams(ref, port, [p], [12])
    finally:
        ref.close()
        port.close()


PROMPT = list(range(1, 9))


def _contend(eng, R, hold=None):
    """A batch request decoding 48 tokens when an interactive one arrives
    after its 4th (tests/test_torch_overload.py's ``_contend``)."""
    batch = eng.submit(R(PROMPT, max_new_tokens=48, priority="batch", client="b"))
    got: list[int] = []
    th = threading.Thread(target=lambda: got.extend(batch.stream(timeout=60)))
    th.start()
    t0 = time.perf_counter()
    while batch.emitted < 4:
        assert time.perf_counter() - t0 < 60
        time.sleep(0.001)
    if hold is not None:
        hold.clear()
    inter = eng.submit(R([9, 9, 2], max_new_tokens=4, client="i"))
    if hold is not None:
        t0 = time.perf_counter()
        while eng.preemptions < 1:
            assert time.perf_counter() - t0 < 10
            time.sleep(0.001)
        hold.set()
    out = inter.tokens(timeout=60)
    th.join(timeout=60)
    return got, out, batch


@pytest.mark.parametrize("lookahead", [1, 3])
def test_preempted_batch_stream_resumes_on_the_ring(mistral, lookahead):
    """One slot on the ring (capacity 24): a batch stream of 48 tokens is
    preempted by an interactive request, scrubbed from every program in
    flight, and resumes as a continuation that re-prefills 8 + its tokens
    past the capacity; it equals the uncontended stream and the JAX
    engine's preempted one."""
    jcfg, jp, tcfg, tp = mistral
    kw = dict(slots=1, max_seq_len=128, prefill_buckets=(8, 16), lookahead=lookahead)
    ref = JEngine(jcfg, jp, **JAX_KW, **kw)
    try:
        want = ref.generate(PROMPT, max_new_tokens=48)
        got_j, inter_j, batch_j = _contend(ref, JRequest)
        assert batch_j.preempted == 1 and got_j == want
    finally:
        ref.close()
    port = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, **kw)
    try:
        assert port.kv.rolling and port.kv.capacity == 24
        assert port.generate(PROMPT, max_new_tokens=48) == want
        process, hold = port._process_entry, threading.Event()
        hold.set()

        def slow(entry):
            hold.wait(timeout=10)
            time.sleep(0.01)
            return process(entry)

        port._process_entry = slow
        got, inter, batch = _contend(port, GenRequest, hold)
        assert got == want and inter == inter_j
        assert batch.preempted == port.preemptions == 1 and batch.finish_reason == "length"
        # the continuation's prompt carries the stream it had; it decodes
        # on past two laps of the ring
        assert batch.prompt_tokens[: len(PROMPT)] == PROMPT and len(batch.prompt_tokens) > len(PROMPT)
        assert batch.prompt_tokens[len(PROMPT):] == got[: len(batch.prompt_tokens) - len(PROMPT)]
        assert len(PROMPT) + 48 > 2 * port.kv.capacity
        _idle(port)
    finally:
        port.close()


def test_memory_bounded_by_window_at_long_max_len(mistral):
    """max_seq_len >> window (tests/test_kvcache.py's case at the port's
    shapes): the ring's row axis, hence its bytes, stays at window + slack;
    a 100-token prompt still decodes as the JAX engine's ring does."""
    jcfg, jp, tcfg, tp = mistral
    kw = dict(slots=2, max_seq_len=256, prefill_buckets=(16,))
    ref = JEngine(jcfg, jp, **JAX_KW, **kw)
    port = LLMEngine(tcfg, tp, device="cpu", **kw)  # kv_paged "auto"
    try:
        kv = port.kv.stats()
        assert kv["capacity"] == 8 + 16 == ref.kv.capacity < 256
        assert port.cache.k.shape[2] == kv["capacity"]
        dense_bytes = kv["slot_bytes"] * 256 // kv["capacity"]
        assert kv["slot_bytes"] * 8 < dense_bytes and kv["slot_bytes"] == ref.kv.slot_bytes
        (prompt,) = _prompts(37, (100,))
        assert port.generate(prompt, max_new_tokens=8) == ref.generate(prompt, max_new_tokens=8)
    finally:
        ref.close()
        port.close()
