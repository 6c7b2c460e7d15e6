"""The monolithic wave scheduler of gofr_tpu_torch (``step_token_budget=0``)
against gofr_tpu's (CPU, f32 tiny presets, prompts from numpy seeds):
greedy token identity with ``gofr_tpu.llm.LLMEngine(step_token_budget=0)``
on the paged pool, the dense slab and the rolling ring (prompts in every
bucket and past the last one), with the int8 KV pool, with speculative
decoding and under pool pressure; wave-time exact prefix hits with JAX's
counters on all three layouts; the program families, the stats keys, the
refusal of grammars and the forced-off adapters."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch import structured as TS
from gofr_tpu_torch.kvcache import CacheManager
from gofr_tpu_torch.llm import GenRequest, LLMEngine
from gofr_tpu_torch.models import transformer as TT

# buckets 8 and 16 at max_seq_len 64: a prompt past 16 tokens takes the
# max_seq_len bucket (captured lazily on the card)
ENGINE_KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8, 16))
JAX_KW = dict(warmup=False, decode_chunk=8, prefill_chunk=64, step_token_budget=0)
LAYOUTS = {"pool": ("tiny", True), "slab": ("tiny", False), "ring": ("tiny_mistral", False)}


def _pair(name: str, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params) with an untied random
    head, so greedy streams vary."""
    jcfg, tcfg = getattr(JT.TransformerConfig, name)(), getattr(TT.TransformerConfig, name)()
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(seed + 100), (jcfg.vocab_size, jcfg.d_model),
                                            jnp.float32))
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def models():
    return {name: _pair(name) for name in ("tiny", "tiny_mistral")}


def _engines(models, layout, **kw):
    name, paged = LAYOUTS[layout]
    jcfg, jp, tcfg, tp = models[name]
    ref = JEngine(jcfg, jp, kv_paged=paged, **JAX_KW, **{**ENGINE_KW, **kw})
    port = LLMEngine(tcfg, tp, device="cpu", kv_paged=paged, step_token_budget=0, **{**ENGINE_KW, **kw})
    return ref, port


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


def _same_streams(ref, port, prompts, new_tokens, **req_kw):
    jreqs = [ref.submit(JRequest(p, max_new_tokens=n, **req_kw)) for p, n in zip(prompts, new_tokens)]
    treqs = [port.submit(GenRequest(p, max_new_tokens=n, **req_kw)) for p, n in zip(prompts, new_tokens)]
    for j, t in zip(jreqs, treqs):
        assert t.tokens(timeout=120) == j.tokens(timeout=120)


def _idle(*engines, timeout: float = 10.0) -> None:
    t0 = time.perf_counter()
    for eng in engines:
        while True:
            with eng._lock:
                if not (eng._inflight or eng._processing is not None or any(eng._slot_req) or eng._waiting):
                    break
            assert time.perf_counter() - t0 < timeout, "the engine did not idle"
            time.sleep(0.002)


@pytest.mark.parametrize("lookahead", [1, 3])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_wave_token_identical_to_jax(models, layout, lookahead):
    """Prompts of 3-40 tokens (buckets 8, 16 and max_seq_len; past the
    ring's capacity of 16 and tiny_mistral's window of 8) one at a time,
    then more than the slots at once, ragged lengths and budgets."""
    ref, port = _engines(models, layout, lookahead=lookahead)
    try:
        st = port.stats()
        assert st["scheduler"] == ref.stats()["scheduler"] == "wave"
        assert st["kvcache"]["layout"] == ref.kv.stats()["layout"] and port.kv.capacity == ref.kv.capacity
        for p in _prompts(7, (3, 13, 17, 40)):
            _same_streams(ref, port, [p], [10])
        _same_streams(ref, port, _prompts(8, (5, 9, 16, 30, 2, 22, 11)), [12, 3, 20, 7, 16, 9, 14])
        _idle(port)
        st = port.stats()
        assert st["wave_reqs"] == 11 and sum(st["prefill_waves"].values()) >= 4
        assert set(st["prefill_waves"]) <= {1, 2, 4} and st["steps"] == 0
        assert port.load_tokens() == 0
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_wave_prefix_hits_match_jax(models, layout):
    """With a prefix index, a wave stores its fresh rows (the pool
    publishes into its radix after the insert), and the same prompts
    again are exact hits that skip the prefill: tokens and counters
    (hits, misses, stores, resident bytes) equal JAX's."""
    ref, port = _engines(models, layout, prefix_cache_mb=1)
    try:
        ps = _prompts(9, (3, 9, 17, 30))
        for _round in range(2):
            for p in ps:  # one at a time: the same admission passes on both
                _same_streams(ref, port, [p], [8])
            _idle(ref, port)
        want, got = ref.stats()["kvcache"]["prefix"], port.stats()["kvcache"]["prefix"]
        if layout == "pool":  # the radix tree's counters
            assert (got["hits"], got["misses"]) == (want["hits"], want["misses"])
        else:
            assert got == want
        assert got["hits"] == 4
        assert port.stats()["wave_reqs"] == 4  # the hits ran no wave
    finally:
        ref.close()
        port.close()


def test_wave_int8_kv_token_identical(models):
    """The int8 KV pool under the wave: the insert quantizes each row."""
    ref, port = _engines(models, "pool", kv_int8=True)
    try:
        assert port.kv.int8 and port.pool_scales is not None
        _same_streams(ref, port, _prompts(10, (6, 15, 33, 4)), [10, 10, 10, 10])
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("layout", ["pool", "ring"])
def test_wave_speculative_token_identical(models, layout):
    """Speculative verifies ride the wave scheduler: prompts that repeat
    (the drafter proposes), greedy streams equal JAX's spec-on wave
    engine's, and verifies ran. A wave's first attempt finds only its
    prefill in flight and buys 16 plain chunks, as in JAX, so the streams
    run past 128 tokens."""
    ref, port = _engines(models, layout, speculative=True, spec_draft=4, max_seq_len=256)
    try:
        prompts = [([5, 6, 7, 8] * 8)[:20], ([9, 3] * 10)[:12], _prompts(11, (7,))[0]]
        _same_streams(ref, port, prompts, [160, 160, 160])
        assert port.stats()["spec"]["steps"] > 0
    finally:
        ref.close()
        port.close()


def test_wave_under_pool_pressure(models):
    """A pool of 8 blocks holds two requests' worst cases: the rest wait
    (admit_reserve) and the streams still equal JAX's."""
    ref, port = _engines(models, "pool", kv_pool_blocks=8)
    try:
        assert port.kv.pool.n_blocks == ref.kv.pool.n_blocks == 8
        _same_streams(ref, port, _prompts(12, (10, 12, 9, 14, 11)), [8, 8, 8, 8, 8])
        _idle(port)
        assert port.stats()["kvcache"]["reserved"] == 0 and port.stats()["kvcache"]["blocks_in_use"] == 0
    finally:
        ref.close()
        port.close()


def test_wave_families_and_append_widths(models):
    """A wave engine builds one prefill family per (bucket, width), the
    max_seq_len bucket's marked lazy, and no unified step; its ring
    budgets the decode chunk alone as slack (JAX's append widths)."""
    _jcfg, _jp, tcfg, tp = models["tiny_mistral"]
    eng = LLMEngine(tcfg, tp, device="cpu", step_token_budget=0, **ENGINE_KW)
    chunked = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW)
    try:
        want = {f"llm.prefill_b{b}.w{w}" for b in (8, 16, 64) for w in (1, 2, 4)}
        assert {n for n in eng._programs if n.startswith("llm.prefill")} == want
        assert eng._lazy == {f"llm.prefill_b64.w{w}" for w in (1, 2, 4)}
        assert not any(n.startswith("llm.step_p") for n in eng._programs)
        assert (eng.kv.rolling, eng.kv.capacity, chunked.kv.capacity) == (True, 16, 24)
        assert eng._bucket_for(8) == 8 and eng._bucket_for(9) == 16 and eng._bucket_for(17) == 64
        assert chunked.stats()["scheduler"] == "chunked" and chunked.chunked and not eng.chunked
    finally:
        eng.close()
        chunked.close()


def test_wave_refuses_grammars_and_adapters(models):
    """As in JAX (tests/test_structured.py::test_wave_scheduler_rejects_grammar):
    the wave forces constrained decoding and the adapter pool off, and a
    grammar request is refused naming the chunked scheduler."""
    _jcfg, _jp, tcfg, tp = models["tiny"]
    eng = LLMEngine(tcfg, tp, device="cpu", step_token_budget=0, lora_slots=2, **ENGINE_KW)
    try:
        assert not eng.constrained and eng.lora_slots == 0 and not eng._programs_g
        g = TS.compile_regex("[a-c]{1,4}", [bytes([i % 256]) for i in range(tcfg.vocab_size - 1)] + [b""],
                             tcfg.vocab_size - 1)
        with pytest.raises(ValueError, match="chunked"):
            eng.submit(GenRequest([1], max_new_tokens=8, grammar=g))
    finally:
        eng.close()


@pytest.mark.parametrize("value,ok", [("0", True), ("256", True), ("128", False), ("1", False)])
def test_step_token_budget_knob(models, monkeypatch, value, ok):
    """TPU_LLM_STEP_TOKEN_BUDGET when the kwarg is None: 0 builds the
    wave, any other budget the chunked scheduler under it, as JAX does
    (``ok`` marked the budgets accepted before ROADMAP ID 19; 128 and 1
    raised then and build JAX's engine now)."""
    jcfg, jp, tcfg, tp = models["tiny"]
    monkeypatch.setenv("TPU_LLM_STEP_TOKEN_BUDGET", value)
    ref = JEngine(jcfg, jp, warmup=False, **ENGINE_KW)
    eng = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW)
    try:
        assert eng.step_token_budget == ref.step_token_budget == int(value) and eng.chunked == (value != "0")
        assert eng.stats()["scheduler"] == ref.stats()["scheduler"] == ("chunked" if eng.chunked else "wave")
        assert eng.chunk_shapes == ref.chunk_shapes
        if not ok:  # a budget under one chunk still makes progress (floored at one chunk)
            _same_streams(ref, eng, _prompts(4, (3, 20, 11)), [6, 5, 7])
    finally:
        ref.close()
        eng.close()


def test_wave_fill_hold(models):
    """While slots decode and the arrival EMA says a wave of 4 or more
    fills within admit_delay, a lone waiting request is held; an idle
    engine, a slow arrival rate or a zero delay admits at once."""
    _jcfg, _jp, tcfg, tp = models["tiny"]
    eng = LLMEngine(tcfg, tp, device="cpu", step_token_budget=0, admit_delay_ms=10_000.0, **ENGINE_KW)
    try:
        with eng._work_cv:
            busy = GenRequest([1, 2, 3], max_new_tokens=30)
            busy.prefill_done, busy.slot = True, 3
            eng._slot_req[3] = busy  # a decoding occupant (the device never sees it)
            r = GenRequest([4, 5, 6], max_new_tokens=4)
            r.submitted_at = time.perf_counter()
            eng._waiting.append(r)
            eng._ema_gap = 0.001  # ~10,000 arrivals expected in the hold
            assert not eng._admit() and list(eng._waiting) == [r]
            eng._ema_gap = 5.0  # slow arrivals: no hold
            assert eng._admit() and not eng._waiting and r.slot is not None
            eng._slot_req[3] = None
        assert r.tokens(timeout=60)
    finally:
        eng.close()


def test_cache_manager_wave_pack():
    """The ring packs a bucket-wide prefill to its capacity; the pool and
    the slab take it as it stands (their slots take its first rows)."""
    cfg = TT.TransformerConfig.tiny_mistral()
    ring = CacheManager(cfg, 2, 64, 8, paged=False)
    pool = CacheManager(cfg, 2, 64, 8, paged=True)
    assert ring.rolling and not pool.rolling
    shape = (cfg.n_layers, 2, 32, cfg.n_kv_heads, cfg.head_dim)
    c = TT.KVCache(torch.randn(shape), torch.randn(shape), torch.tensor([30, 5], dtype=torch.int32))
    packed = ring.pack_prefill(c)
    assert packed.k.shape[2] == ring.capacity and pool.pack_prefill(c) is c
