"""The model families beside Gemma-2B: the port's presets and programs
against gofr_tpu's on the same weights and inputs (CPU, f32 tiny configs,
atol 1e-4: the two frameworks sum in different orders), and greedy token
identity against gofr_tpu.llm.LLMEngine.

Configs: tiny_mistral (a window of 8), tiny_qwen2 (q/k/v bias), a tiny
multi-head config (4 query and 4 KV heads, as Gemma-7B) and a tiny group-7
config (7 query heads on 1 KV head, with bias, as Qwen2-7B's group)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.datasource.gpu import GPURuntime
from gofr_tpu_torch.llm import GenRequest, LLMEngine
from gofr_tpu_torch.models import quant as TQ
from gofr_tpu_torch.models import transformer as TT

ATOL = 1e-4
ENGINE_KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8, 16))

CONFIGS = {
    "tiny_mistral": lambda M: M.TransformerConfig.tiny_mistral(),
    "tiny_qwen2": lambda M: M.TransformerConfig.tiny_qwen2(),
    "tiny_mha": lambda M: dataclasses.replace(M.TransformerConfig.tiny(), n_heads=4, n_kv_heads=4),
    "tiny_group7": lambda M: dataclasses.replace(M.TransformerConfig.tiny_qwen2(), n_heads=7, n_kv_heads=1),
}
PRESETS = ["gemma_2b", "gemma_7b", "llama3_8b", "mistral_7b", "qwen2_7b",
           "tiny", "tiny_llama", "tiny_mistral", "tiny_qwen2", "tiny_moe"]
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _pair(name: str, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params), with an untied random
    unembed so greedy streams vary."""
    jcfg, tcfg = CONFIGS[name](JT), CONFIGS[name](TT)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, unembed=jax.random.normal(
        jax.random.PRNGKey(seed + 100), (jcfg.vocab_size, jcfg.d_model), jnp.float32
    ))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return (request.param,) + _pair(request.param)


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


# -- presets -------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_matches_jax_field_for_field(preset):
    jcfg = getattr(JT.TransformerConfig, preset)()
    tcfg = getattr(TT.TransformerConfig, preset)()
    for f in dataclasses.fields(tcfg):
        want = getattr(jcfg, f.name)
        got = getattr(tcfg, f.name)
        assert got == (DTYPES[want] if f.name == "dtype" else want), f.name
    # the port's config has every JAX field, in the JAX order
    assert [f.name for f in dataclasses.fields(jcfg)] == [f.name for f in dataclasses.fields(tcfg)]
    assert (jcfg.n_experts > 0) == (preset == "tiny_moe")


def test_init_params_bias_leaves(pair):
    name, jcfg, _jp, tcfg, _tp = pair
    jshapes = jax.tree.map(lambda a: tuple(a.shape), JT.init_params(jax.random.PRNGKey(0), jcfg))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == jshapes
    if tcfg.qkv_bias:  # random, not zero: the add is load-bearing
        assert tp["layers"]["bq"].abs().sum() > 0 and tp["layers"]["bkv"].abs().sum() > 0
    qp = TQ.init_params_quantized(tcfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in qp["layers"].items()} == jshapes["layers"]
    if tcfg.qkv_bias:  # unquantized zeros, as JAX's init_params_quantized
        assert not isinstance(qp["layers"]["bq"], TQ.QTensor) and qp["layers"]["bq"].abs().sum() == 0
        quant = TQ.quantize_params(tp, torch.float32)
        assert torch.equal(quant["layers"]["bkv"], tp["layers"]["bkv"])


# -- the programs ----------------------------------------------------------------


def test_transformer_forward(pair):
    _name, jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    want, _ = JT.transformer_forward(jp, jcfg, jnp.asarray(tokens), jnp.asarray(pos))
    got = TT.transformer_forward(tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["tiny_qwen2", "tiny_group7"])
def test_bias_is_load_bearing(name):
    """Zeroing the bias moves the logits, so the comparisons above and the
    engine identity below hold the bias add of every program."""
    _jcfg, _jp, tcfg, tp = _pair(name)
    tokens = torch.arange(1, 11)[None]
    pos = torch.arange(10)[None]
    zero = dict(tp, layers={**tp["layers"], "bq": tp["layers"]["bq"] * 0, "bkv": tp["layers"]["bkv"] * 0})
    a = TT.transformer_forward(tp, tcfg, tokens, pos)
    b = TT.transformer_forward(zero, tcfg, tokens, pos)
    assert (a - b).abs().max() > 1e-2


def test_prefill_append_then_decode_chunk_paged(pair):
    """One prefill chunk into gathered slot rows at mixed cursors (past the
    window for tiny_mistral), then those rows scattered into a paged pool
    through permuted tables and 4 fused decode steps over it."""
    _name, jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(2)
    L, b, Bk, MB, c = jcfg.n_layers, 3, 4, 8, 12
    cap = Bk * MB
    shape = (L, b, cap, jcfg.n_kv_heads, jcfg.head_dim)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
    cursors = np.asarray([0, 5, 14], np.int32)
    n_new = np.asarray([c, 7, 9], np.int32)
    want_logits, want = JT.prefill_append(
        jp, jcfg, jnp.asarray(tokens), JT.KVCache(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(cursors)),
        jnp.asarray(cursors), jnp.asarray(n_new),
    )
    got_logits, got = TT.prefill_append(
        tp, tcfg, torch.from_numpy(tokens),
        TT.KVCache(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()), torch.from_numpy(cursors)),
        torch.from_numpy(cursors), torch.from_numpy(n_new),
    )
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=ATOL, rtol=0)

    # the JAX cache's rows into a pool of b * MB blocks through permuted tables
    NB = b * MB
    tables = rng.permutation(NB).reshape(b, MB).astype(np.int32)
    pshape = (L, NB, Bk, jcfg.n_kv_heads, jcfg.head_dim)
    pk, pv = np.zeros(pshape, np.float32), np.zeros(pshape, np.float32)
    wk, wv = np.asarray(want.k), np.asarray(want.v)
    for i in range(b):
        for s in range(MB):
            pk[:, tables[i, s]] = wk[:, i, s * Bk : (s + 1) * Bk]
            pv[:, tables[i, s]] = wv[:, i, s * Bk : (s + 1) * Bk]
    lengths = cursors + n_new
    active = np.asarray([True, True, False])
    first = np.argmax(np.asarray(want_logits), axis=-1).astype(np.int32)
    temps = np.zeros((b,), np.float32)
    want_toks, want_last, want_pool, _sc, _rng = JT.decode_chunk_paged(
        jp, jcfg, jnp.asarray(first), JT.KVCache(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(lengths)),
        None, jnp.asarray(tables), jnp.asarray(active), jnp.asarray(temps), jax.random.PRNGKey(0),
        n_steps=4, sample_fn=lambda lg, t, k: jnp.argmax(lg, axis=-1).astype(jnp.int32), block=Bk,
    )
    pool = TT.KVCache(torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()), torch.from_numpy(lengths.copy()))
    got_toks, got_last, got_pool = TT.decode_chunk_paged(
        tp, tcfg, torch.from_numpy(first), pool, torch.from_numpy(tables), torch.from_numpy(active),
        torch.from_numpy(temps), None, n_steps=4, sample_fn=lambda lg, t, g: lg.argmax(dim=-1).to(torch.int32),
        block=Bk,
    )
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))
    np.testing.assert_array_equal(got_last.numpy(), np.asarray(want_last))
    np.testing.assert_array_equal(got_pool.length.numpy(), np.asarray(want_pool.length))
    np.testing.assert_allclose(got_pool.k.numpy(), np.asarray(want_pool.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_pool.v.numpy(), np.asarray(want_pool.v), atol=ATOL, rtol=0)


def test_verify_chunk(pair):
    _name, jcfg, jp, tcfg, tp = pair
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
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=ATOL, rtol=0)


# -- the engine ------------------------------------------------------------------


def _same_streams(ref, port, prompts, new_tokens):
    jreqs = [ref.submit(JRequest(p, max_new_tokens=n)) for p, n in zip(prompts, new_tokens)]
    treqs = [port.submit(GenRequest(p, max_new_tokens=n)) for p, n in zip(prompts, new_tokens)]
    outs = []
    for j, t in zip(jreqs, treqs):
        want = j.tokens()
        assert t.tokens() == want
        outs.append(want)
    return outs


def test_engine_greedy_identity(pair):
    """One at a time, then more requests than slots at once (prefill rows
    sharing unified steps with decode chunks, then pure decode chunks);
    the prompts of 17-40 tokens run past tiny_mistral's window of 8. Both
    engines on the paged pool (kv_paged=True: "auto" would give
    tiny_mistral the rolling ring, held in test_torch_contiguous.py)."""
    _name, jcfg, jp, tcfg, tp = pair
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", kv_paged=True, **ENGINE_KW)
    try:
        for p in _prompts(7, (3, 17, 33)):
            (want,) = _same_streams(ref, port, [p], [8])
            assert len(set(want)) > 1  # a real stream, not one repeated token
        prompts = _prompts(11, (3, 17, 33, 9, 40, 16))
        _same_streams(ref, port, prompts, [19 if i % 2 else 8 for i in range(len(prompts))])
        st = port.stats()
        assert st["kvcache"]["blocks_in_use"] == 0 and st["kvcache"]["reserved"] == 0
    finally:
        ref.close()
        port.close()


class _RepeatDrafter:
    """Proposes the stream's last token k times."""

    def draft(self, tokens, k):
        return [tokens[-1]] * k if k > 0 else []


@pytest.mark.parametrize("mode", ["quantize", "speculative"])
def test_qwen2_engine_int8_and_spec_identity(mode):
    """tiny_qwen2 with int8 weights (bias leaves unquantized) and with
    speculative decoding (verify_chunk carries the bias)."""
    jcfg, jp, tcfg, tp = _pair("tiny_qwen2")
    kw = {"quantize": True} if mode == "quantize" else {"speculative": True, "spec_draft": 4}
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, **ENGINE_KW, **kw)
    port = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW, **kw)
    if mode == "speculative":  # drafts on every stream, accepted or not
        ref.drafter = port.drafter = _RepeatDrafter()
    try:
        prompts = _prompts(13, (5, 20, 33)) + [([5, 6, 7, 8] * 8)[:20]]
        _same_streams(ref, port, prompts, [16] * len(prompts))
        if mode == "quantize":
            assert TQ.is_quantized(port.params) and not isinstance(port.params["layers"]["bq"], TQ.QTensor)
        else:
            assert port.stats()["spec"]["steps"] > 0
    finally:
        ref.close()
        port.close()


def test_windowed_model_served_paged_not_on_a_ring():
    """ROADMAP queue 3 item 11, fixed: register_llm on a windowed config
    whose window + slack < max_seq_len resolves kv_paged as the JAX
    runtime does. "auto" (the default, and TPU_LLM_KV_PAGED=1) serves it
    from the rolling ring at O(window) slot memory, token-identical to the
    JAX engine's ring; kv_paged=True serves it paged, not on a ring, at
    O(max_seq_len), with the same tokens; TPU_LLM_KV_PAGED=0 is
    kv_paged=False, the ring too."""
    jcfg, jp, tcfg, tp = _pair("tiny_mistral")
    ref = JEngine(jcfg, jp, warmup=False, **ENGINE_KW)  # kv_paged "auto"
    rt = GPURuntime(MapConfig({"TORCH_DEVICE": "cpu"}))
    port = rt.register_llm("m", tcfg, tp, kv_paged="auto", **ENGINE_KW)
    try:
        assert not ref.kv.paged and ref.kv.rolling  # the ring engaged: 8 + 16 < 64
        kv = port.stats()["kvcache"]
        assert (kv["layout"], kv["capacity"]) == ("rolling", ref.kv.capacity) == ("rolling", 8 + 16)
        assert port.cache.k.shape[2] == kv["capacity"] and port.pool is None
        prompts = _prompts(21, (30, 41, 12))
        want = _same_streams(ref, port, prompts, [12, 12, 12])
        paged = rt.register_llm("n", tcfg, tp, kv_paged=True, **ENGINE_KW)
        assert paged.kv.capacity == ENGINE_KW["max_seq_len"]
        assert paged.stats()["kvcache"]["layout"] == "paged"
        assert [paged.generate(p, max_new_tokens=12) for p in prompts] == want
        knob = GPURuntime(MapConfig({"TORCH_DEVICE": "cpu", "TPU_LLM_KV_PAGED": "0"}))
        try:
            assert knob.register_llm("o", tcfg, tp, **ENGINE_KW).stats()["kvcache"]["layout"] == "rolling"
        finally:
            knob.close()
    finally:
        ref.close()
        rt.close()
