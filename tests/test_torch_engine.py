"""gofr_tpu_torch.llm.LLMEngine against gofr_tpu.llm.LLMEngine: greedy token
identity on the same tiny weights (CPU), with chunked-prefill rows and
decode sharing steps, plus the port's import guard."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch.llm import GenRequest, LLMEngine, finite_guard
from gofr_tpu_torch.models import transformer as TT

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE_KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8, 16))


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
def engines(weights):
    jcfg, jp, tcfg, tp = weights
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW)
    yield ref, port
    ref.close()
    port.close()


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).tolist() for n in lengths]


def test_greedy_identity_one_at_a_time(engines):
    ref, port = engines
    # straddle one block (16) and one chunk boundary (tests/test_paged_kv.py)
    for prompt in _prompts(7, (3, 17, 33)):
        want = ref.generate(prompt, max_new_tokens=8)
        assert port.generate(prompt, max_new_tokens=8) == want
        assert len(set(want)) > 1  # a real stream, not one repeated token


def test_greedy_identity_concurrent(engines):
    """More requests than slots, submitted together: prefill chunks of
    some rows share unified steps with other rows' decode chunks."""
    ref, port = engines
    prompts = _prompts(11, (3, 17, 33, 9, 40, 16))
    jreqs = [ref.submit(JRequest(p, max_new_tokens=8)) for p in prompts]
    treqs = [port.submit(GenRequest(p, max_new_tokens=8)) for p in prompts]
    for j, t in zip(jreqs, treqs):
        assert t.tokens() == j.tokens()
        assert t.finish_reason == "length"
    st = port.stats()
    assert st["kvcache"]["blocks_in_use"] == 0 and st["kvcache"]["reserved"] == 0


def test_greedy_identity_through_pure_decode_chunks(engines):
    """19 new tokens: the unified step emits 1 + 8, then a full decode
    chunk (K = 8) and a short one (K = 2) run with no prefill pending."""
    ref, port = engines
    prompts = _prompts(17, (3, 20, 9))
    jreqs = [ref.submit(JRequest(p, max_new_tokens=19)) for p in prompts]
    before = port.stats()
    treqs = [port.submit(GenRequest(p, max_new_tokens=19)) for p in prompts]
    for j, t in zip(jreqs, treqs):
        assert t.tokens() == j.tokens()
    after = port.stats()
    # every unified step counts one chunk; pure decode chunks count only there
    pure = (after["chunks"] - before["chunks"]) - (after["steps"] - before["steps"])
    assert pure >= 2


def test_eos_cut_and_cap(engines):
    ref, port = engines
    (prompt,) = _prompts(12, (10,))
    full = port.generate(prompt, max_new_tokens=8)
    r = port.submit(GenRequest(prompt, max_new_tokens=8, eos_token=full[2]))
    assert r.tokens() == full[: full.index(full[2]) + 1]
    assert r.finish_reason == "eos"
    # 40-token prompt at max_seq_len 64 leaves 64 - 40 - 2 * 8 = 8 tokens
    (long_prompt,) = _prompts(13, (40,))
    r = port.submit(GenRequest(long_prompt, max_new_tokens=30))
    assert r.capped and r.max_new_tokens == 8 and len(r.tokens()) == 8
    with pytest.raises(ValueError):
        port.submit(GenRequest(_prompts(14, (60,))[0], max_new_tokens=4))


def test_cancelled_before_admission(engines):
    _ref, port = engines
    r = GenRequest(_prompts(15, (5,))[0], max_new_tokens=8)
    r.cancel()
    assert port.submit(r).tokens() == [] and r.finish_reason == "cancelled"


def test_temperature_sampling_is_seeded(weights):
    _jcfg, _jp, tcfg, tp = weights
    (prompt,) = _prompts(16, (6,))
    outs = []
    for _ in range(2):
        with LLMEngine(tcfg, tp, device="cpu", seed=5, **ENGINE_KW) as eng:
            outs.append(eng.generate(prompt, max_new_tokens=8, temperature=0.8))
    assert outs[0] == outs[1]
    assert all(0 <= t < tcfg.vocab_size for t in outs[0])


def test_finite_guard_sentinel():
    logits = torch.zeros((3, 5))
    logits[1, 2] = float("nan")
    toks = torch.tensor([4, 4, 4], dtype=torch.int32)
    assert finite_guard(logits, toks).tolist() == [4, -1, 4]


def test_engine_without_gpu_raises(weights):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    _jcfg, _jp, tcfg, tp = weights
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(tcfg, tp, **ENGINE_KW)


def test_port_imports_nothing_of_jax():
    """gofr_tpu_torch and chip_smoke.py import neither jax nor gofr_tpu."""
    files = sorted((ROOT / "gofr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 5
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "gofr_tpu"):
                    bad.append(f"{f.relative_to(ROOT)}: {name}")
    assert not bad, bad
