"""The engine's shape knobs in gofr_tpu_torch against gofr_tpu's, part 1 of
2 (CPU, f32 tiny presets with an untied random head, prompts from numpy
seeds): greedy token identity with ``gofr_tpu.llm.LLMEngine`` at each
combination of ``decode_chunk``, ``prefill_chunk``, ``step_token_budget``
and ``kv_block`` on the paged pool, and on the slab and the ring for two
of them. test_torch_knobs.py holds the rest (lookahead 1, packing,
geometry, the env knobs, prefix, sessions, speculation, grammar, LoRA,
MoE); the two files split one worker's load in two."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import transformer as JT
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
CASES = [(c, "pool") for c in COMBOS] + [(c, lay) for c in ("K16-P16-S32-B32", "wave-K4-P8-B8")
                                         for lay in ("slab", "ring")]


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


def _idle(eng, timeout: float = 10.0) -> None:
    t0 = time.perf_counter()
    while True:
        with eng._lock:
            if not (eng._inflight or eng._processing is not None or any(eng._slot_req) or eng._waiting):
                return
        assert time.perf_counter() - t0 < timeout, "the engine did not idle"
        time.sleep(0.002)


# -- greedy token identity ----------------------------------------------------------


@pytest.mark.parametrize("combo,layout", CASES, ids=[f"{c}-{lay}" for c, lay in CASES])
def test_greedy_tokens_equal_jax(models, combo, layout):
    """Mixed prompt lengths (3-40 tokens: chunk widths, buckets and blocks
    crossed; past the ring's window), more requests than slots, one at a
    time and then all at once: every stream equals JAX's, and the engines
    agree on every shape the knobs set."""
    name, paged = LAYOUTS[layout]
    ref, port = _engines(models[name], kv_paged=paged, **_knobs(combo))
    try:
        K, P, S, B = COMBOS[combo]
        assert (port.decode_chunk, port._chunk_short, port.prefill_chunk, port.step_token_budget) == (
            ref.decode_chunk, ref._chunk_short, ref.prefill_chunk, ref.step_token_budget) == (K, max(1, K // 4), P, S)
        assert port.chunk_shapes == ref.chunk_shapes and port.chunked == ref.chunked == (S > 0)
        for attr in ("paged", "rolling", "capacity", "append_slack", "block"):
            assert getattr(port.kv, attr) == getattr(ref.kv, attr), attr
        want_programs = {f"llm.decode_chunk{K}", f"llm.decode_chunk{max(1, K // 4)}"}
        want_programs |= {f"llm.step_p{s}_d{K}.w{w}" for s in port.chunk_shapes for w in (1, 2, 4)} if S else set()
        assert want_programs <= set(port._programs)
        for p in _prompts(7, (3, 13, 17, 40)):
            assert _streams(port, GenRequest, [p], [10]) == _streams(ref, JRequest, [p], [10])
        prompts, news = _prompts(8, (5, 9, 16, 30, 2, 22, 11)), [12, 3, 20, 7, 16, 9, 14]
        assert _streams(port, GenRequest, prompts, news) == _streams(ref, JRequest, prompts, news)
        _idle(port)
        assert port.load_tokens() == 0 and port.stats()["kvcache"].get("blocks_in_use", 0) == 0
    finally:
        ref.close()
        port.close()
