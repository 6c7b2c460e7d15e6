"""The engine's shape knobs in gofr_tpu_torch (``decode_chunk``,
``prefill_chunk``, ``step_token_budget``, ``kv_block`` and their
``TPU_LLM_*`` fallbacks) against gofr_tpu's (CPU, f32 tiny presets with an
untied random head, prompts from numpy seeds), part 2 of 2: greedy token
identity with ``gofr_tpu.llm.LLMEngine`` at lookahead 1 (each combination
at the default lookahead is in test_torch_knobs_tokens.py), the KV
geometry of ``CacheManager`` against JAX's, the unified step's packing at
other budgets, and prefix sharing, session turns, speculation, a grammar,
a LoRA adapter and an MoE config at knobs other than the defaults."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gofr_tpu import structured as JS
from gofr_tpu.kvcache import CacheManager as JCacheManager
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.lora import init_adapter as j_init_adapter
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch import structured as TS
from gofr_tpu_torch.kvcache import CacheManager
from gofr_tpu_torch.llm import GenRequest, LLMEngine
from gofr_tpu_torch.models import transformer as TT

ENGINE_KW = dict(slots=4, max_seq_len=96, prefill_buckets=(8, 16, 32))
# (decode_chunk, prefill_chunk, step_token_budget, kv_block); budget 0 is
# the wave (tests/test_chunked_prefill.py, test_concurrency_stress.py,
# test_device_health.py and test_paged_kv.py run the JAX engine at these)
COMBOS = {
    "K8-P64-S256-B16": (8, 64, 256, 16),
    "K4-P8-S24-B4": (4, 8, 24, 4),
    "K2-P4-S4-B8": (2, 4, 4, 8),
    "K16-P16-S32-B32": (16, 16, 32, 32),
    "wave-K4-P8-B8": (4, 8, 0, 8),
}
# layout -> (preset, kv_paged); the ring is tiny_mistral's window 8 at
# max_seq_len 96 ("auto" on a windowed model)
LAYOUTS = {"pool": ("tiny", True), "slab": ("tiny", False), "ring": ("tiny_mistral", "auto")}


def _knobs(combo: str) -> dict:
    K, P, S, B = COMBOS[combo]
    return dict(decode_chunk=K, prefill_chunk=P, step_token_budget=S, kv_block=B)


def _pair(name: str, seed: int = 0, **cfg_kw):
    jcfg, tcfg = getattr(JT.TransformerConfig, name)(**cfg_kw), getattr(TT.TransformerConfig, name)(**cfg_kw)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(seed + 100), (jcfg.vocab_size, jcfg.d_model),
                                            jnp.float32))
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def models():
    return {name: _pair(name) for name in ("tiny", "tiny_mistral")}


def _engines(pair, **kw):
    jcfg, jp, tcfg, tp = pair
    kw = {**ENGINE_KW, **kw}
    return JEngine(jcfg, jp, warmup=False, **kw), LLMEngine(tcfg, tp, device="cpu", **kw)


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


def _streams(eng, R, prompts, news, **req_kw):
    reqs = [eng.submit(R(p, max_new_tokens=n, **req_kw)) for p, n in zip(prompts, news)]
    return [r.tokens(timeout=120) for r in reqs]


def _together(eng, R, prompts, news, **req_kw):
    """Every request admitted in one pass (either engine's drain held until
    the last submit)."""
    name = "_drain_and_observe" if isinstance(eng, JEngine) else "_drain_submits"
    setattr(eng, name, lambda *a, **k: None)
    try:
        # one whole scheduler pass after the patch: a pass that looked the
        # real drain up before it has ended, so none drains a first submit
        # alone
        eng._run_on_scheduler(lambda: None)
        reqs =[eng.submit(R(p, max_new_tokens=n, **req_kw)) for p, n in zip(prompts, news)]
    finally:
        delattr(eng, name)
    return [r.tokens(timeout=120) for r in reqs]


def _idle(eng, timeout: float = 10.0) -> None:
    t0 = time.perf_counter()
    while True:
        with eng._lock:
            if not (eng._inflight or eng._processing is not None or any(eng._slot_req) or eng._waiting):
                return
        assert time.perf_counter() - t0 < timeout, "the engine did not idle"
        time.sleep(0.002)


# -- greedy token identity ----------------------------------------------------------


@pytest.mark.parametrize("combo", ["K4-P8-S24-B4", "K16-P16-S32-B32"])
def test_greedy_tokens_equal_jax_at_lookahead_1(models, combo):
    ref, port = _engines(models["tiny"], kv_paged=True, lookahead=1, **_knobs(combo))
    try:
        prompts, news = _prompts(9, (40, 3, 21, 8, 33)), [9, 17, 5, 12, 7]
        assert _streams(port, GenRequest, prompts, news) == _streams(ref, JRequest, prompts, news)
    finally:
        ref.close()
        port.close()


# -- the unified step's packing -------------------------------------------------------


@pytest.mark.parametrize("budget", [16, 24, 32, 128, 512])
def test_step_packing_at_budget_matches_jax(models, budget):
    """Six prompts admitted together at lookahead 1 (decode_chunk 4,
    prefill_chunk 16, 8 slots): every unified step packs the same rows
    under the budget (the decode chunk charged first, prefill floored at
    one chunk), so the step count, the tokens they carry and the streams
    equal JAX's."""
    kw = dict(slots=8, max_seq_len=160, prefill_buckets=(8, 16), decode_chunk=4, prefill_chunk=16,
              step_token_budget=budget, kv_block=8, kv_paged=True, lookahead=1)
    jcfg, jp, tcfg, tp = models["tiny"]
    ref, port = JEngine(jcfg, jp, warmup=False, **kw), LLMEngine(tcfg, tp, device="cpu", **kw)
    try:
        prompts, news = _prompts(10, (40, 33, 17, 60, 9, 25)), [64] * 6
        assert _together(port, GenRequest, prompts, news) == _together(ref, JRequest, prompts, news)
        _idle(port)
        got, want = port.stats(), ref.stats()
        assert (got["steps"], got["step_tokens"]) == (want["steps"], want["step_tokens"])
        assert got["steps"] >= (6 if budget < 128 else 2)
    finally:
        ref.close()
        port.close()


# -- the KV geometry -----------------------------------------------------------------

GEOMETRY = {
    # name: (preset, CacheManager args, kwargs)
    "pool-B4": ("tiny", (4, 96, 4), dict(append_widths=(8,), paged=True, block=4)),
    "pool-B8-int8": ("tiny", (4, 96, 8), dict(append_widths=(16, 32), paged=True, block=8, kv_int8=True)),
    "pool-B32-prefix": ("tiny", (4, 100, 16), dict(append_widths=(16, 33), paged=True, block=32,
                                                  prefix_cache_mb=1)),
    "pool-B8-sessions": ("tiny", (2, 96, 2), dict(append_widths=(4,), paged=True, block=8, session_mb=1)),
    "slab-K16": ("tiny", (4, 96, 16), dict(append_widths=(16, 32), paged=False)),
    "ring-K4-P32": ("tiny_mistral", (4, 96, 4), dict(append_widths=(8, 32), paged="auto")),
    "ring-mistral-P128": ("mistral_7b", (8, 32768, 8), dict(append_widths=(16, 64, 128, 5), paged="auto")),
    "ring-mistral-K16": ("mistral_7b", (8, 32768, 16), dict(append_widths=(16, 33), paged="auto")),
}


def _geometry(kv) -> dict:
    out = {k: getattr(kv, k) for k in ("paged", "rolling", "capacity", "ring", "append_slack", "block", "int8")}
    if kv.paged:
        out.update(table_width=kv.table_width, block_bytes=kv.block_bytes, n_blocks=kv.pool.n_blocks,
                   pool_bytes=kv.pool.n_blocks * kv.block_bytes, share=kv.share)
    else:
        out.update(slot_bytes=kv.slot_bytes)
    return out


@pytest.mark.parametrize("case", list(GEOMETRY))
def test_cache_manager_geometry_matches_jax(case):
    preset, args, kw = GEOMETRY[case]
    j = JCacheManager(getattr(JT.TransformerConfig, preset)(), *args, **kw)
    t = CacheManager(getattr(TT.TransformerConfig, preset)(), *args, **kw)
    assert _geometry(t) == _geometry(j)
    if case == "ring-mistral-P128":  # Mistral-7B's ring at prefill_chunk=128: 4096 + 128 rows, not 4,160
        assert (t.rolling, t.capacity) == (True, 4224)


@pytest.mark.parametrize("block", ["4", "8", "32"])
def test_kv_block_env_builds_jax_pool(models, monkeypatch, block):
    """TPU_LLM_KV_BLOCK with the kwarg left None: the same pool as JAX's
    (CacheManager and engine); a kwarg wins over the env."""
    monkeypatch.setenv("TPU_LLM_KV_BLOCK", block)
    cfg = TT.TransformerConfig.tiny()
    assert _geometry(CacheManager(cfg, 4, 96, 8, paged=True)) == _geometry(
        JCacheManager(JT.TransformerConfig.tiny(), 4, 96, 8, paged=True))
    ref, port = _engines(models["tiny"], kv_paged=True)
    try:
        assert _geometry(port.kv) == _geometry(ref.kv) and port.kv.block == int(block)
        assert tuple(port.pool.k.shape[1:3]) == (port.kv.pool.n_blocks, int(block))
    finally:
        ref.close()
        port.close()
    eng = LLMEngine(cfg, models["tiny"][3], device="cpu", kv_block=16, **ENGINE_KW)
    try:
        assert eng.kv.block == 16
    finally:
        eng.close()


@pytest.mark.parametrize("env", [{"TPU_LLM_PREFILL_CHUNK": "8"}, {"TPU_LLM_PREFILL_CHUNK": "128"},
                                 {"TPU_LLM_STEP_TOKEN_BUDGET": "40", "TPU_LLM_PREFILL_CHUNK": "16"},
                                 {"TPU_LLM_STEP_TOKEN_BUDGET": "0", "TPU_LLM_KV_BLOCK": "8"}],
                         ids=["P8", "P128", "S40-P16", "wave-B8"])
@pytest.mark.parametrize("layout", ["pool", "ring"])
def test_env_knobs_build_what_jax_builds(models, monkeypatch, env, layout):
    """TPU_LLM_PREFILL_CHUNK / TPU_LLM_STEP_TOKEN_BUDGET / TPU_LLM_KV_BLOCK
    from the env: the same scheduler, chunk shapes, append slack (the
    ring's capacity) and pool, and the same tokens."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    name, paged = LAYOUTS[layout]
    ref, port = _engines(models[name], kv_paged=paged, prefill_buckets=(8, 16, 128), max_seq_len=160)
    try:
        assert (port.step_token_budget, port.prefill_chunk, port.chunk_shapes) == (
            ref.step_token_budget, ref.prefill_chunk, ref.chunk_shapes)
        assert _geometry(port.kv) == _geometry(ref.kv)
        prompts, news = _prompts(11, (7, 30, 19)), [9, 6, 11]
        assert _streams(port, GenRequest, prompts, news) == _streams(ref, JRequest, prompts, news)
    finally:
        ref.close()
        port.close()


def test_decode_room_and_draft_cap_follow_decode_chunk(models):
    """submit's room is max_seq_len - prompt - 2 decode_chunk, as JAX's
    (a prompt that leaves none is refused with JAX's message), and the
    speculative draft is capped at 2 decode_chunk."""
    for K in (2, 16):
        ref, port = _engines(models["tiny"], kv_paged=True, decode_chunk=K, speculative=True, spec_draft=40)
        try:
            assert port.spec_draft == ref.spec_draft == 2 * K
            plen = ENGINE_KW["max_seq_len"] - 2 * K
            for eng, R in ((ref, JRequest), (port, GenRequest)):
                with pytest.raises(ValueError, match=f"leaves no decode room .* \\(chunk {K}\\)"):
                    eng.submit(R(list(range(1, plen + 1)), max_new_tokens=4))
            p = list(range(1, plen))
            assert port.generate(p, max_new_tokens=10) == ref.generate(p, max_new_tokens=10)
        finally:
            ref.close()
            port.close()


# -- the features at other knobs ---------------------------------------------------------


@pytest.mark.parametrize("block", [4, 8])
def test_prefix_hits_match_jax(models, block):
    """tests/test_paged_kv.py's sequence at kv_block 4 and 8: base, exact
    repeat, a sibling sharing 20 tokens (a block-partial hit: 20 rows at
    block 4, 16 at block 8), the sibling again, a longer prompt: tokens and
    every prefix counter equal JAX's, and no pin leaks."""
    from test_torch_prefix import _assert_no_leaked_pins

    ref, port = _engines(models["tiny"], kv_paged=True, prefix_cache_mb=4.0, decode_chunk=4, prefill_chunk=8,
                         step_token_budget=24, kv_block=block)
    try:
        rng = np.random.default_rng(9)
        base = rng.integers(1, 512, 40).tolist()
        sib = base[:20] + rng.integers(1, 512, 10).tolist()
        longer = base + rng.integers(1, 512, 17).tolist()
        for i, p in enumerate((base, base, sib, sib, longer)):
            assert port.generate(p, max_new_tokens=6) == ref.generate(p, max_new_tokens=6), i
        st = port.stats()["kvcache"]["prefix"]
        assert st == ref.stats()["kvcache"]["prefix"]
        assert st["hits"] == 2 and st["partial_hits"] == 2 and st["misses"] == 1
        _assert_no_leaked_pins(port)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("block", [4, 8])
def test_session_turn_matches_jax(models, block):
    """A session's turn 1, spilled to the host tier and restored by turn 2
    (the spill and restore copy whole blocks of ``block`` rows): both
    turns' tokens and the session and prefix counters equal JAX's."""
    from test_torch_sessions import _turns

    kw = dict(slots=2, max_seq_len=96, prefill_buckets=(8, 32), kv_paged=True, session_mb=16.0, decode_chunk=4,
              prefill_chunk=8, step_token_budget=24, kv_block=block)
    jcfg, jp, tcfg, tp = models["tiny"]
    ref, port = JEngine(jcfg, jp, warmup=False, **kw), LLMEngine(tcfg, tp, device="cpu", **kw)
    try:
        turn1 = list(range(1, 26))
        want = _turns(ref, JRequest, turn1, spill=True)
        got = _turns(port, GenRequest, turn1, spill=True)
        assert got == want and got[2]["offload"]["restores"] == 1
    finally:
        ref.close()
        port.close()


def test_speculation_at_decode_chunk_4(models):
    """decode_chunk=4 caps the draft at 8 (spec_draft 16 asked): the verify
    family is llm.step_v9; the n-gram drafter's greedy streams equal JAX's
    and the spec-off port's, and with an oracle drafter (the streams'
    continuations) verifies of up to 8 drafts run and accept."""
    from test_torch_spec import _OracleDrafter

    kw = dict(kv_paged=True, decode_chunk=4, prefill_chunk=8, step_token_budget=24, kv_block=8)
    ref, port = _engines(models["tiny"], speculative=True, spec_draft=16, **kw)
    off = LLMEngine(models["tiny"][2], models["tiny"][3], device="cpu", **ENGINE_KW, **kw)
    try:
        assert port.spec_draft == ref.spec_draft == 8 and "llm.step_v9" in port._programs
        prompts = [([5, 6, 7, 8] * 8)[:20], _prompts(12, (13,))[0], [9, 9, 9, 9, 9, 9]]
        news = [30, 12, 25]
        want = _streams(ref, JRequest, prompts, news)
        assert _streams(port, GenRequest, prompts, news) == want == _streams(off, GenRequest, prompts, news)
        port.drafter = _OracleDrafter(prompts, want)
        assert _streams(port, GenRequest, prompts, news) == want
        st = port.stats()["spec"]
        assert st["steps"] > 0 and st["accepted"] > 0 and st["draft"] == 8
    finally:
        ref.close()
        port.close()
        off.close()


def test_grammar_at_other_knobs():
    """A JSON schema's greedy constrained streams beside an unconstrained
    neighbour, at decode_chunk 4, prefill_chunk 8, budget 24, kv_block 8:
    equal to JAX's, every constrained one valid and ended on eos."""
    from test_torch_structured import EOS, SCHEMA, VOCAB

    jcfg, jp, tcfg, tp = _pair("tiny", vocab_size=128)
    kw = dict(slots=4, max_seq_len=160, prefill_buckets=(8, 16), kv_paged=True, decode_chunk=4, prefill_chunk=8,
              step_token_budget=24, kv_block=8)
    jg, tg = JS.compile_json_schema(SCHEMA, VOCAB, EOS), TS.compile_json_schema(SCHEMA, VOCAB, EOS)
    prompts = [[5, 6, 7], list(range(10, 30)), [40, 41]]
    ref, port = JEngine(jcfg, jp, warmup=False, **kw), LLMEngine(tcfg, tp, device="cpu", **kw)
    try:
        want = [ref.submit(JRequest(p, max_new_tokens=100, grammar=jg)) for p in prompts[:2]]
        want.append(ref.submit(JRequest(prompts[2], max_new_tokens=24)))
        got = [port.submit(GenRequest(p, max_new_tokens=100, grammar=tg)) for p in prompts[:2]]
        got.append(port.submit(GenRequest(prompts[2], max_new_tokens=24)))
        assert [r.tokens(timeout=120) for r in got] == [r.tokens(timeout=120) for r in want]
        assert all(r.finish_reason == "eos" for r in got[:2])
    finally:
        ref.close()
        port.close()


def test_lora_adapter_at_other_knobs(models):
    """Base and adapted lanes in one batch at decode_chunk 4, prefill_chunk
    8, budget 24, kv_block 8: every stream equals the JAX LoRA engine's."""
    jcfg, jp, tcfg, tp = models["tiny"]
    adapter = jax.tree.map(np.asarray, j_init_adapter(jax.random.PRNGKey(7), jcfg, rank=4, scale=1.0))
    ref, port = _engines(models["tiny"], kv_paged=True, lora_slots=2, decode_chunk=4, prefill_chunk=8,
                         step_token_budget=24, kv_block=8)
    try:
        ref.load_adapter("a", adapter)
        port.load_adapter("a", adapter)
        prompts, lanes, news = _prompts(13, (16, 5, 21, 12)), ["", "a", "a", ""], [12, 10, 14, 9]

        def serve(eng, R):
            reqs = [eng.submit(R(p, max_new_tokens=n, adapter=a)) for p, a, n in zip(prompts, lanes, news)]
            return [r.tokens(timeout=120) for r in reqs]

        got = serve(port, GenRequest)
        assert got == serve(ref, JRequest)
        assert port.stats()["adapters"]["requests"] == 2
    finally:
        ref.close()
        port.close()


def test_moe_at_other_knobs():
    """tiny_moe at capacity E / k (nothing drops, so a program's rows do not
    change a token), admitted together, at decode_chunk 4, prefill_chunk 8,
    budget 24, kv_block 8: the streams equal JAX's."""
    jcfg = dataclasses.replace(JT.TransformerConfig.tiny_moe(), moe_capacity=2.0)
    tcfg = dataclasses.replace(TT.TransformerConfig.tiny_moe(), moe_capacity=2.0)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model)))
    pair = (jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    ref, port = _engines(pair, kv_paged=True, decode_chunk=4, prefill_chunk=8, step_token_budget=24, kv_block=8)
    try:
        prompts, news = _prompts(14, (3, 17, 33, 9, 40, 16)), [8, 19, 8, 19, 8, 19]
        assert _together(port, GenRequest, prompts, news) == _together(ref, JRequest, prompts, news)
        assert port.stats()["moe_experts"] == 4
    finally:
        ref.close()
        port.close()
