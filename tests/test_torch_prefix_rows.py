"""The whole-row prefix cache of the contiguous KV layouts
(gofr_tpu_torch.kvcache.PrefixCache, ring_pack, the whole-prompt
``prefill``) and its engine path on the chunked scheduler, against
gofr_tpu on the CPU (f32 tiny presets, inputs from numpy seeds):

- ``PrefixCache`` op sequences (lookups with and without partials, pins
  that survive an eviction, LRU order under a budget that evicts, byte
  counts) give JAX's entries, order and counters;
- ``ring_pack`` is bitwise JAX's; ``prefill``'s logits and cache equal
  JAX's (atol 1e-4), ragged and windowed (through ``pack_prefill``);
- engines with ``prefix_cache_mb`` > 0 on the slab (exact and partial
  hits) and on the ring (exact only) serve JAX's greedy tokens with JAX's
  hit, partial and miss counts; a reused slot leaves a stored entry as it
  was (``put`` clones).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.kvcache import CacheManager as JCacheManager
from gofr_tpu.kvcache import PrefixCache as JPrefixCache
from gofr_tpu.kvcache import ring_pack as j_ring_pack
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch.kvcache import CacheManager, PrefixCache, ring_pack
from gofr_tpu_torch.llm import GenRequest, LLMEngine
from gofr_tpu_torch.models import transformer as TT

ATOL = 1e-4
# tiny_mistral's window is 8: at max_seq_len 64 with chunk shapes (8, 16)
# the ring holds 8 + 16 = 24 rows a slot
ENGINE_KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8, 16))
JAX_KW = dict(warmup=False, kv_paged=False, decode_chunk=8, prefill_chunk=64, step_token_budget=256)


def _pair(name: str, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params) with an untied random
    head, so greedy streams vary."""
    jcfg, tcfg = getattr(JT.TransformerConfig, name)(), getattr(TT.TransformerConfig, name)()
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(seed + 100), (jcfg.vocab_size, jcfg.d_model),
                                            jnp.float32))
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _pair("tiny")


@pytest.fixture(scope="module")
def mistral():
    return _pair("tiny_mistral")


# -- PrefixCache ---------------------------------------------------------------


def _rows(rng, n, L=2, h=2, d=4, vocab=16):
    """(k, v, logits) numpy arrays of one entry of n rows."""
    return (rng.normal(size=(L, 1, n, h, d)).astype(np.float32), rng.normal(size=(L, 1, n, h, d)).astype(np.float32),
            rng.normal(size=(1, vocab)).astype(np.float32))


def _both(budget):
    return JPrefixCache(budget), PrefixCache(budget)


def _put(j, t, tokens, k, v, logits):
    a = j.put(j.key_for(tokens), jnp.asarray(k), jnp.asarray(v), len(tokens), jnp.asarray(logits))
    b = t.put(t.key_for(tokens), torch.from_numpy(k), torch.from_numpy(v), len(tokens), torch.from_numpy(logits))
    assert a == b
    return a


def _same(j, t):
    assert t.stats() == j.stats()
    assert list(t._entries) == list(j._entries)  # LRU order, oldest first
    assert dict(t._lengths) == dict(j._lengths)
    for key, e in t._entries.items():
        je = j._entries[key]
        assert (e.length, e.nbytes, e.refs) == (je.length, je.nbytes, je.refs)
        np.testing.assert_array_equal(e.k.numpy(), np.asarray(je.k))
        np.testing.assert_array_equal(e.logits.numpy(), np.asarray(je.logits))


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_ops_match_jax(seed):
    """A random sequence of puts, exact and longest-prefix lookups (with
    and without partials) and releases under a budget that evicts leaves
    the same entries, LRU order, pins and counters as JAX's cache."""
    rng = np.random.default_rng(seed)
    budget = 4 * (2 * 2 * 1 * 10 * 2 * 4 * 4 + 16 * 4)  # ~four 10-row entries
    j, t = _both(budget)
    base = rng.integers(1, 100, 30).tolist()
    prompts = [base[:n] for n in (6, 10, 14, 20, 25)] + [rng.integers(1, 100, 9).tolist() for _ in range(3)]
    held: list[tuple] = []
    for _step in range(40):
        op = rng.integers(0, 4)
        p = prompts[rng.integers(0, len(prompts))]
        if op == 0:
            _put(j, t, p, *_rows(rng, len(p) // 2 + 1))
        elif op in (1, 2):
            probe = p + [7] if rng.random() < 0.5 else p
            je, jx = j.lookup_longest(probe, allow_partial=op == 1)
            te, tx = t.lookup_longest(probe, allow_partial=op == 1)
            assert (None if te is None else (te.length, tx)) == (None if je is None else (je.length, jx))
            if je is not None:
                held.append((je, te))
        elif held:
            je, te = held.pop(rng.integers(0, len(held)))
            j.release(je)
            t.release(te)
        _same(j, t)
    for je, te in held:
        j.release(je)
        t.release(te)
    _same(j, t)
    assert t.pinned() == 0


def test_pins_survive_eviction_and_lru_order():
    """A pinned entry outlives a budget that would evict it; the oldest
    UNPINNED entry goes first; an entry larger than the budget is
    refused; a duplicate key is skipped. Byte counts are k + v + logits."""
    rng = np.random.default_rng(3)
    one = 2 * 2 * 1 * 8 * 2 * 4 * 4 + 16 * 4
    j, t = _both(2 * one)
    a, b, c = [1, 2, 3], [4, 5, 6], [7, 8, 9]
    _put(j, t, a, *_rows(rng, 8))
    _put(j, t, b, *_rows(rng, 8))
    assert t.stats()["resident_bytes"] == 2 * one
    ja, ta = j.lookup(j.key_for(a)), t.lookup(t.key_for(a))  # pin a (and make it MRU)
    j.lookup(j.key_for(b)), t.lookup(t.key_for(b))
    j.release(j._entries[j.key_for(b)]), t.release(t._entries[t.key_for(b)])
    _put(j, t, c, *_rows(rng, 8))  # over budget: b is the oldest unpinned
    _same(j, t)
    assert t.key_for(a) in t._entries and t.key_for(b) not in t._entries
    assert not _put(j, t, c, *_rows(rng, 8))  # duplicate
    assert not _put(j, t, [1], *_rows(rng, 40))  # larger than the budget
    j.release(ja), t.release(ta)
    _put(j, t, [9, 9], *_rows(rng, 8))  # now a is evictable
    _same(j, t)
    assert t.stats()["evictions"] == 2


def test_lookup_longest_partial_and_exact():
    """The longest stored prefix is a partial hit (its own counter), an
    exact probe wins over it, and allow_partial=False neither pins nor
    counts a partial."""
    rng = np.random.default_rng(4)
    j, t = _both(1 << 20)
    p = list(range(1, 21))
    for n in (5, 12, 20):
        _put(j, t, p[:n], *_rows(rng, n))
    for probe, allow in ((p + [1, 2], True), (p[:15], True), (p[:15], False), (p[:12], True), (p[:4], True)):
        je, jx = j.lookup_longest(probe, allow_partial=allow)
        te, tx = t.lookup_longest(probe, allow_partial=allow)
        assert (None if te is None else (te.length, tx)) == (None if je is None else (je.length, jx))
        _same(j, t)


def test_put_clones_its_rows():
    """A stored entry is a private copy: writing the source afterwards
    (a reused slot, a graph's next replay) leaves it as it was."""
    pc = PrefixCache(1 << 20)
    src = torch.zeros((2, 3, 8, 2, 4))
    logits = torch.zeros((3, 16))
    pc.put(pc.key_for([1, 2]), src[:, 1:2, :5], src[:, 1:2, :5], 2, logits[1:2])
    src.fill_(7.0)
    logits.fill_(7.0)
    e = pc._entries[pc.key_for([1, 2])]
    assert e.k.abs().sum() == 0 and e.logits.abs().sum() == 0 and e.k.shape == (2, 1, 5, 2, 4)


# -- ring_pack and prefill -----------------------------------------------------


@pytest.mark.parametrize("capacity", [6, 16, 40])
def test_ring_pack_bitwise(capacity):
    """Row j of the ring holds the newest position congruent to j mod the
    capacity; rows never written are zero (lengths 0 and past the
    capacity)."""
    rng = np.random.default_rng(capacity)
    k = rng.normal(size=(2, 4, 32, 2, 4)).astype(np.float32)
    v = rng.normal(size=(2, 4, 32, 2, 4)).astype(np.float32)
    lengths = np.asarray([0, 5, 17, 32], np.int32)
    want = j_ring_pack(JT.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths)), capacity)
    got = ring_pack(TT.KVCache(torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(lengths)), capacity)
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))


@pytest.mark.parametrize("name", ["tiny", "tiny_mistral", "tiny_qwen2"])
def test_prefill_matches_jax(name):
    """Last-token logits and the cache of ragged right-padded prompts
    (past tiny_mistral's window of 8) at a cache wider than the prompts."""
    jcfg, jp, tcfg, tp = _pair(name)
    rng = np.random.default_rng(11)
    toks = rng.integers(1, jcfg.vocab_size, (3, 24)).astype(np.int32)
    lens = np.asarray([24, 13, 2], np.int32)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), 40)
    tl, tc = TT.prefill(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(lens), 40)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    assert tc.k.dtype == tcfg.dtype and not tc.k[:, :, 24:].any()


def test_prefill_windowed_through_pack_prefill(mistral):
    """A windowed prompt's prefill, bucket-wide as JAX builds it on the
    ring, packed into the ring by each manager's pack_prefill (capacity 16
    at the wave's slack): JAX's rows."""
    jcfg, jp, tcfg, tp = mistral
    jkv = JCacheManager(jcfg, 2, 64, 8)
    tkv = CacheManager(tcfg, 2, 64, 8, paged=False)
    assert (tkv.rolling, tkv.capacity) == (jkv.rolling, jkv.capacity) and jkv.prefill_cache_len(32) == 32
    rng = np.random.default_rng(12)
    toks = rng.integers(1, 512, (2, 32)).astype(np.int32)
    lens = np.asarray([30, 11], np.int32)
    _jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), 32)
    _tl, tc = TT.prefill(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(lens), 32)
    jr, tr = jkv.pack_prefill(jc), tkv.pack_prefill(tc)
    assert tr.k.shape[2] == tkv.capacity == 16
    np.testing.assert_allclose(tr.k.numpy(), np.asarray(jr.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tr.v.numpy(), np.asarray(jr.v), atol=ATOL, rtol=0)
    slab = CacheManager(TT.TransformerConfig.tiny(), 2, 64, 8, paged=False)
    assert slab.pack_prefill(tc) is tc


# -- engines on the chunked scheduler -------------------------------------------


def _settle(*engines, timeout: float = 10.0) -> None:
    """Wait until every engine is idle (the last step's store is made at
    dispatch, before its tokens are emitted)."""
    t0 = time.perf_counter()
    for eng in engines:
        while True:
            with eng._lock:
                if not (eng._inflight or eng._processing is not None or any(eng._slot_req) or eng._waiting):
                    break
            assert time.perf_counter() - t0 < timeout, "the engine did not idle"
            time.sleep(0.002)


def _serve(ref, port, prompts, new_tokens=8):
    """Greedy streams of both engines, one request at a time."""
    for p in prompts:
        want = ref.submit(JRequest(p, max_new_tokens=new_tokens)).tokens(timeout=120)
        assert port.submit(GenRequest(p, max_new_tokens=new_tokens)).tokens(timeout=120) == want
    _settle(ref, port)


def _prefix_stats(eng):
    return eng.stats()["kvcache"]["prefix"]


@pytest.mark.parametrize("layout", ["slab", "ring"])
@pytest.mark.parametrize("mb", [1.0, 0.02])
def test_chunked_prefix_hits_match_jax(tiny, mistral, layout, mb):
    """A shared 20-token system prompt: the system prompt alone, three
    longer prompts (partial hits on the slab, misses on the ring), the
    three again (exact hits), then a fourth longer one; at a budget that
    holds everything and one that evicts (0.02 MB). Tokens, hit, partial,
    miss, store and eviction counts and resident bytes equal JAX's."""
    jcfg, jp, tcfg, tp = tiny if layout == "slab" else mistral
    ref = JEngine(jcfg, jp, prefix_cache_mb=mb, **JAX_KW, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, prefix_cache_mb=mb, **ENGINE_KW)
    try:
        assert port.kv.rolling == (layout == "ring") == ref.kv.rolling
        rng = np.random.default_rng(21)
        system = rng.integers(1, 512, 20).tolist()
        longer = [system + rng.integers(1, 512, n).tolist() for n in (3, 9, 1)]
        for rnd in ([system], longer, longer, [system + [5, 6, 7, 8]]):
            _serve(ref, port, rnd)
            assert _prefix_stats(port) == _prefix_stats(ref)
        st = _prefix_stats(port)
        if mb == 1.0:
            assert st["hits"] >= 3 and (st["partial_hits"] > 0) == (layout == "slab") and not st["evictions"]
        else:  # one entry fits
            assert st["evictions"] > 0 and st["entries"] == 1
        assert port.kv.prefix.pinned() == 0 and port.load_tokens() == 0
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("lookahead", [1, 3])
def test_concurrent_hits_and_misses_match_jax(tiny, lookahead):
    """Exact hits, partial hits and misses admitted in one pass on the
    slab (more requests than slots), at lookahead 1 and 3."""
    jcfg, jp, tcfg, tp = tiny
    ref = JEngine(jcfg, jp, prefix_cache_mb=1, **JAX_KW, **{**ENGINE_KW, "lookahead": lookahead})
    port = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, prefix_cache_mb=1, lookahead=lookahead, **ENGINE_KW)
    try:
        rng = np.random.default_rng(22)
        base = [rng.integers(1, 512, n).tolist() for n in (12, 18, 7)]
        _serve(ref, port, base)
        mixed = base + [b + rng.integers(1, 512, 5).tolist() for b in base] + [rng.integers(1, 512, 9).tolist()]
        jr = [ref.submit(JRequest(p, max_new_tokens=6)) for p in mixed]
        tr = [port.submit(GenRequest(p, max_new_tokens=6)) for p in mixed]
        for a, b in zip(jr, tr):
            assert b.tokens(timeout=120) == a.tokens(timeout=120)
        _settle(ref, port)
        st = _prefix_stats(port)
        assert st["hits"] == 3 and st["partial_hits"] == 3
        assert st == _prefix_stats(ref) and port.kv.prefix.pinned() == 0
    finally:
        ref.close()
        port.close()


def test_reused_slot_leaves_the_stored_entry(tiny):
    """One slot: prompt A is stored, prompt B then runs in the same slot
    and overwrites its rows; A's entry keeps the rows A wrote (put
    cloned them), and A again is an exact hit with A's tokens."""
    _jcfg, _jp, tcfg, tp = tiny
    eng = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, prefix_cache_mb=1, slots=1, max_seq_len=64,
                    prefill_buckets=(8, 16))
    try:
        rng = np.random.default_rng(23)
        a, b = rng.integers(1, 512, 14).tolist(), rng.integers(1, 512, 14).tolist()
        first = eng.generate(a, max_new_tokens=6)
        _settle(eng)
        e = eng.kv.prefix._entries[eng.kv.prefix.key_for(a)]
        k0, v0, l0 = e.k.clone(), e.v.clone(), e.logits.clone()
        np.testing.assert_array_equal(k0[:, 0].numpy(), eng.cache.k[:, 0, :14].numpy())
        eng.generate(b, max_new_tokens=6)
        _settle(eng)
        assert not torch.equal(eng.cache.k[:, 0, :14], k0[:, 0])  # the slot now holds B
        assert torch.equal(e.k, k0) and torch.equal(e.v, v0) and torch.equal(e.logits, l0)
        assert eng.generate(a, max_new_tokens=6) == first
        assert eng.stats()["kvcache"]["prefix"]["hits"] == 1
    finally:
        eng.close()


def test_constrained_and_adapted_requests_skip_the_lookup(tiny):
    """A stored prompt sent with a grammar runs a full prefill (a miss is
    not even probed), as JAX's _admit_chunked sends it to the rest."""
    from gofr_tpu_torch import structured as TS

    _jcfg, _jp, tcfg, tp = tiny
    eng = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, prefix_cache_mb=1, **ENGINE_KW)
    try:
        p = list(range(3, 15))
        eng.generate(p, max_new_tokens=4)
        _settle(eng)
        before = _prefix_stats(eng)
        g = TS.compile_regex("[a-c]{1,4}", [bytes([i % 256]) for i in range(tcfg.vocab_size - 1)] + [b""],
                             tcfg.vocab_size - 1)
        eng.submit(GenRequest(p, max_new_tokens=4, grammar=g)).tokens(timeout=60)
        _settle(eng)
        after = _prefix_stats(eng)
        assert (after["hits"], after["misses"], after["partial_hits"]) == (
            before["hits"], before["misses"], before["partial_hits"])
    finally:
        eng.close()


def test_stats_prefix_keys_match_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    ref = JEngine(jcfg, jp, prefix_cache_mb=2, **JAX_KW, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, prefix_cache_mb=2, **ENGINE_KW)
    try:
        assert _prefix_stats(port) == _prefix_stats(ref)
        assert port._keep_logits and "llm.hit_first.w4" in port._programs and "llm.kv_seed" not in port._programs
    finally:
        ref.close()
        port.close()


def test_dense_slab_of_a_windowed_model_takes_partials(mistral):
    """kv_window=0 forces the slab on tiny_mistral: partial hits are
    allowed there (the rows are position-indexed), as in JAX."""
    jcfg, jp, tcfg, tp = mistral
    ref = JEngine(jcfg, jp, prefix_cache_mb=1, kv_window=0, **JAX_KW, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, prefix_cache_mb=1, kv_window=0, **ENGINE_KW)
    try:
        rng = np.random.default_rng(24)
        s = rng.integers(1, 512, 18).tolist()
        _serve(ref, port, [s, s + [3, 4, 5], s + [3, 4, 5]])
        st = _prefix_stats(port)
        assert st == _prefix_stats(ref) and st["partial_hits"] == 1 and st["hits"] == 1
    finally:
        ref.close()
        port.close()


def test_tiny_moe_prefix_hits_match_jax():
    """The MoE preset through the stored rows: same tokens and counters."""
    jcfg, jp, tcfg, tp = _pair("tiny_moe")
    jcfg = dataclasses.replace(jcfg, moe_capacity=4.0)
    tcfg = dataclasses.replace(tcfg, moe_capacity=4.0)
    ref = JEngine(jcfg, jp, prefix_cache_mb=1, **JAX_KW, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", kv_paged=False, prefix_cache_mb=1, **ENGINE_KW)
    try:
        rng = np.random.default_rng(25)
        s = rng.integers(1, 512, 16).tolist()
        _serve(ref, port, [s, s + [9], s])
        assert _prefix_stats(port) == _prefix_stats(ref)
    finally:
        ref.close()
        port.close()
