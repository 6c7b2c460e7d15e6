"""Grammar-constrained decoding in gofr_tpu_torch against gofr_tpu (CPU):
the copied grammar compiler (tables, keys, host mirrors and errors equal
the JAX package's exactly), the masked samplers and the stateful seam of
``decode_chunk_paged`` against the JAX functions, the engine's
constrained program families against the JAX engine (``kv_paged=True``,
greedy streams token-identical), and ``response_format`` on the OpenAI
edge against the JAX app. Fixtures mirror tests/test_structured.py: a
char-level vocabulary of 128 ids (the last one eos) and its SCHEMA."""

import json
import re

import jax
import jax.numpy as jnp
import jsonschema
import numpy as np
import pytest
import torch

from gofr_tpu import structured as JS
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch import llm as TL
from gofr_tpu_torch import structured as TS
from gofr_tpu_torch.llm import EngineOverloaded, GenRequest, LLMEngine
from gofr_tpu_torch.models import transformer as TT

# char-level vocabulary: id i -> printable byte, last id = eos
VOCAB = [chr(0x20 + i).encode() if 0x20 + i < 0x7F else b"" for i in range(127)] + [b""]
EOS = 127
SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "maxLength": 6},
        "n": {"type": "integer"},
    },
}
ENGINE_KW = dict(slots=4, max_seq_len=160, prefill_buckets=(8, 16))

SCHEMAS = [
    SCHEMA,
    {"type": "boolean"},
    {"type": "null"},
    {"enum": ["red", "green", 3, None]},
    {"type": "array", "items": {"type": "integer"}, "minItems": 1, "maxItems": 3},
    {"type": "object", "properties": {"a": {"type": "number"}, "b": {"anyOf": [{"type": "string"}, {"const": 1}]}},
     "required": ["a"]},
    {"type": "string", "maxLength": 40},
]
REGEXES = [r"[a-c]{2,5}", r"(yes|no)!?", r"\d{3}-\d{4}", r"[A-Z][a-z]*( [A-Z][a-z]*){0,2}"]


def _text(toks: list[int]) -> str:
    return b"".join(VOCAB[t] for t in toks if t != EOS).decode()


@pytest.fixture(scope="module")
def weights():
    jcfg = JT.TransformerConfig.tiny(vocab_size=128)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    # untied random head: the tied tiny model repeats its input token
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    tcfg = TT.TransformerConfig.tiny(vocab_size=128)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def grammars():
    """SCHEMA compiled by both packages."""
    return JS.compile_json_schema(SCHEMA, VOCAB, EOS), TS.compile_json_schema(SCHEMA, VOCAB, EOS)


def _port(weights, **kw):
    _jcfg, _jp, tcfg, tp = weights
    return LLMEngine(tcfg, tp, device="cpu", **{**ENGINE_KW, **kw})


def _jax(weights, **kw):
    jcfg, jp, _tcfg, _tp = weights
    return JEngine(jcfg, jp, warmup=False, kv_paged=True, **{**ENGINE_KW, **kw})


def _serve(eng, reqs, timeout=120):
    subs = [eng.submit(r) for r in reqs]
    return [r.tokens(timeout=timeout) for r in subs], subs


def _jax_g_sampler(jeng):
    """The JAX engine's own ``_g_sample`` (a closure of its constructor),
    and through it ``_g_rows`` and ``_g_mask``."""
    f = jeng._mk_chunk_c
    cells = dict(zip(f.__code__.co_freevars, (c.cell_contents for c in f.__closure__)))
    g_sample = cells["_g_sample"]
    inner = dict(zip(g_sample.__code__.co_freevars, (c.cell_contents for c in g_sample.__closure__)))
    return g_sample, inner["_g_rows"], inner["_g_mask"]


# ---------------------------------------------------------------------------
# the host compiler: a copy, so everything must be equal
# ---------------------------------------------------------------------------

def _walk_compare(jg, tg, seed: int) -> None:
    assert np.array_equal(jg.table, tg.table)
    assert (jg.key, jg.n_states, jg.vocab_size, jg.eos_id, jg.accepting_start) == (
        tg.key, tg.n_states, tg.vocab_size, tg.eos_id, tg.accepting_start)
    rng = np.random.default_rng(seed)
    for _ in range(20):
        s, walk = 0, []
        for _ in range(30):
            assert np.array_equal(jg.allowed(s), tg.allowed(s))
            ok = np.flatnonzero(tg.allowed(s))
            t = int(rng.choice(ok)) if len(ok) and rng.random() < 0.9 else int(rng.integers(0, tg.vocab_size))
            assert jg.advance(s, t) == tg.advance(s, t)
            walk.append(t)
            s = tg.advance(s, t)
            if s < 0:
                break
        assert jg.advance_all(0, walk) == tg.advance_all(0, walk)
        assert jg.filter_draft(0, walk) == tg.filter_draft(0, walk)


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_schema_tables_match_jax(i):
    _walk_compare(JS.compile_json_schema(SCHEMAS[i], VOCAB, EOS), TS.compile_json_schema(SCHEMAS[i], VOCAB, EOS), i)


@pytest.mark.parametrize("i", range(len(REGEXES)))
def test_regex_tables_match_jax(i):
    _walk_compare(JS.compile_regex(REGEXES[i], VOCAB, EOS), TS.compile_regex(REGEXES[i], VOCAB, EOS), 100 + i)


@pytest.mark.parametrize("case", [
    ("schema", {"type": "wat"}),  # unsupported type
    ("schema", {"type": "array", "items": {"type": "integer"}, "minItems": 3, "maxItems": 1}),
    ("schema", {"type": "object", "properties": {"a": {"type": "null"}}, "required": ["b"]}),
    ("vocab", {"type": "integer"}),  # the vocabulary cannot spell it
    ("depth", None),
    ("regex", r"(ab"),
    ("regex", r"a{3,1}"),
    ("regex", r"\q"),
])
def test_compile_errors_match_jax(case):
    kind, arg = case

    def compile_with(mod):
        if kind == "vocab":
            vocab = [b"a", b"b", b"{", b"}", b'"', b":", b""]
            return mod.compile_json_schema(arg, vocab, len(vocab) - 1)
        if kind == "depth":
            nested = {"type": "integer"}
            for _ in range(20):
                nested = {"type": "object", "properties": {"x": nested}}
            return mod.compile_json_schema(nested, VOCAB, EOS)
        if kind == "regex":
            return mod.compile_regex(arg, VOCAB, EOS)
        return mod.compile_json_schema(arg, VOCAB, EOS)

    with pytest.raises(Exception) as jerr:
        compile_with(JS)
    with pytest.raises(Exception) as terr:
        compile_with(TS)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert type(terr.value).__name__ in ("JsonSchemaError", "RegexError")
    assert str(terr.value) == str(jerr.value)


def test_vocab_and_grammar_cache_match_jax():
    from gofr_tpu.models.tokenizer import ByteTokenizer as JByte
    from gofr_tpu_torch.models.tokenizer import ByteTokenizer as TByte

    jv, tv = JS.vocab_from_tokenizer(JByte(300)), TS.vocab_from_tokenizer(TByte(300))
    assert jv == tv and len(tv) == 300
    a = TS.grammar_cache.get(SCHEMA, VOCAB, EOS)
    assert TS.grammar_cache.get(SCHEMA, VOCAB, EOS) is a  # dedup
    b = TS.grammar_cache.get_regex(REGEXES[0], VOCAB, EOS)
    assert b.key != a.key and np.array_equal(b.table, JS.grammar_cache.get_regex(REGEXES[0], VOCAB, EOS).table)


# ---------------------------------------------------------------------------
# masked sampling: the helpers and the stateful seam against the JAX code
# ---------------------------------------------------------------------------

def _gtab_and_lanes(seed: int):
    """Two resident grammars padded as the engine pads them, 6 lanes:
    constrained at live states, unconstrained, and out-of-range states."""
    tabs = [TS.compile_json_schema(SCHEMA, VOCAB, EOS).table, TS.compile_regex(REGEXES[1], VOCAB, EOS).table]
    gtab = np.full((2, 64, 128), -1, np.int32)
    for i, t in enumerate(tabs):
        gtab[i, : t.shape[0]] = t
    gid = np.array([0, 1, -1, 0, 1, 0], np.int32)
    gstate = np.array([0, 0, 3, 5, 2, 70], np.int32)
    logits = np.random.default_rng(seed).normal(size=(6, 128)).astype(np.float32) * 3
    return gtab, gid, gstate, logits


def test_g_helpers_match_jax(weights):
    je = _jax(weights)
    try:
        j_sample, j_rows, j_mask = _jax_g_sampler(je)
        for seed in range(3):
            gtab, gid, gstate, logits = _gtab_and_lanes(seed)
            jr, jon = j_rows(jnp.asarray(gtab), jnp.asarray(gid), jnp.asarray(gstate))
            tr, ton = TL._g_rows(torch.from_numpy(gtab), torch.from_numpy(gid), torch.from_numpy(gstate))
            assert np.array_equal(np.asarray(jr), tr.numpy()) and np.array_equal(np.asarray(jon), ton.numpy())
            jm = j_mask(jnp.asarray(logits), jr, jon)
            tm = TL._g_mask(torch.from_numpy(logits), tr, ton)
            assert np.array_equal(np.asarray(jm), tm.numpy())
            # unconstrained lanes keep their logits bit for bit
            assert np.array_equal(tm.numpy()[2], logits[2])
            temps = np.zeros((6,), np.float32)
            jt, js = j_sample(jnp.asarray(logits), jnp.asarray(temps), jax.random.PRNGKey(seed),
                              jnp.asarray(gtab), jnp.asarray(gid), jnp.asarray(gstate))
            tt, ts = TL._g_sample(torch.from_numpy(logits), torch.from_numpy(temps), torch.Generator().manual_seed(0),
                                  torch.from_numpy(gtab), torch.from_numpy(gid), torch.from_numpy(gstate))
            assert np.array_equal(np.asarray(jt), tt.numpy()) and np.array_equal(np.asarray(js), ts.numpy())
    finally:
        je.close()


def test_g_sample_at_temperature_draws_only_admitted_tokens():
    gtab, gid, gstate, logits = _gtab_and_lanes(7)
    gtab_t, gid_t, st_t = torch.from_numpy(gtab), torch.from_numpy(gid[:5]), torch.from_numpy(gstate[:5])
    gen = torch.Generator().manual_seed(3)
    temps = torch.full((5,), 2.0)
    for _ in range(200):
        toks, nxt = TL._g_sample(torch.from_numpy(logits[:5]) * 0 + torch.randn(5, 128, generator=gen) * 4,
                                 temps, gen, gtab_t, gid_t, st_t)
        for lane in (0, 1, 3, 4):  # constrained lanes at live states
            assert gtab[gid[lane], gstate[lane], toks[lane]] >= 0
            assert nxt[lane] == gtab[gid[lane], gstate[lane], toks[lane]]
        assert nxt[2] == gstate[2]  # an unconstrained lane's state is left alone


def test_decode_chunk_paged_sample_state_matches_jax(weights):
    jcfg, jp, tcfg, tp = weights
    gtab, gid, gstate, _ = _gtab_and_lanes(0)
    b, K, blk, MB = 6, 5, 8, 4
    rng = np.random.default_rng(1)
    NB = b * MB
    L, hkv, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    k = rng.normal(size=(L, NB, blk, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(L, NB, blk, hkv, hd)).astype(np.float32)
    tables = rng.permutation(NB).reshape(b, MB).astype(np.int32)
    lengths = rng.integers(1, 12, b).astype(np.int32)
    tail = rng.integers(0, 127, b).astype(np.int32)
    active = np.array([1, 1, 1, 1, 0, 1], bool)
    temps = np.zeros((b,), np.float32)
    je = _jax(weights)
    try:
        j_sample = _jax_g_sampler(je)[0]
        jg = (jnp.asarray(gtab), jnp.asarray(gid))
        jout = JT.decode_chunk_paged(
            jp, jcfg, jnp.asarray(tail), JT.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), length=jnp.asarray(lengths)),
            None, jnp.asarray(tables), jnp.asarray(active), jnp.asarray(temps), jax.random.PRNGKey(0), n_steps=K,
            sample_fn=lambda lg, tp_, key, st: j_sample(lg, tp_, key, *jg, st), block=blk,
            sample_state=jnp.asarray(gstate),
        )
    finally:
        je.close()
    tg = (torch.from_numpy(gtab), torch.from_numpy(gid))
    pool = TT.KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()), length=torch.from_numpy(lengths.copy()))
    tout = TT.decode_chunk_paged(
        tp, tcfg, torch.from_numpy(tail), pool, torch.from_numpy(tables), torch.from_numpy(active),
        torch.from_numpy(temps), torch.Generator().manual_seed(0), n_steps=K,
        sample_fn=lambda lg, tp_, gen, st: TL._g_sample(lg, tp_, gen, *tg, st), block=blk,
        sample_state=torch.from_numpy(gstate),
    )
    assert len(tout) == 4
    assert np.array_equal(np.asarray(jout[0]), tout[0].numpy())  # tokens [K, b]
    assert np.array_equal(np.asarray(jout[1]), tout[1].numpy())  # last
    assert np.array_equal(np.asarray(jout[-1]), tout[3].numpy())  # final DFA states
    assert np.array_equal(np.asarray(jout[2].length), tout[2].length.numpy())
    # every constrained lane's tokens walk its grammar, up to its eos
    for lane in (0, 1, 3):
        s = gstate[lane]
        for t in tout[0][:, lane].tolist():
            assert gtab[gid[lane], s, t] >= 0
            s = gtab[gid[lane], s, t]
            if t == EOS:
                break
    # without a state the seam returns the three outputs it always did
    pool2 = TT.KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()), length=torch.from_numpy(lengths.copy()))
    plain = TT.decode_chunk_paged(
        tp, tcfg, torch.from_numpy(tail), pool2, torch.from_numpy(tables), torch.from_numpy(active),
        torch.from_numpy(temps), None, n_steps=K, sample_fn=TL.LLMEngine._sample, block=blk,
    )
    assert len(plain) == 3


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

PROMPTS = [[1, 2, 3], [40, 41, 9, 17], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9]]


@pytest.fixture(scope="module")
def jax_streams(weights, grammars):
    """The JAX engine's greedy constrained streams for PROMPTS, served
    together with an unconstrained neighbour."""
    jg, _tg = grammars
    je = _jax(weights)
    try:
        out, _ = _serve(je, [JRequest(p, max_new_tokens=100, grammar=jg) for p in PROMPTS]
                        + [JRequest([7, 8, 9], max_new_tokens=24)])
    finally:
        je.close()
    return out


@pytest.mark.parametrize("lookahead", [3, 1])
def test_greedy_constrained_streams_equal_jax(weights, grammars, jax_streams, lookahead):
    _jg, tg = grammars
    eng = _port(weights, lookahead=lookahead)
    try:
        out, reqs = _serve(eng, [GenRequest(p, max_new_tokens=100, grammar=tg) for p in PROMPTS]
                           + [GenRequest([7, 8, 9], max_new_tokens=24)])
        assert out == jax_streams
        for toks, r in zip(out[:3], reqs[:3]):
            assert r.finish_reason == "eos" and r.eos_token == EOS
            jsonschema.validate(json.loads(_text(toks)), SCHEMA)
            assert r._g_state == tg.advance_all(0, toks)  # the host mirror
        st = eng.stats()["constrained"]
        assert st == {"enabled": True, "requests": 3, "grammars_resident": 1, "grammar_cap": 8,
                      "states": [tg.n_states]}
        assert eng._g_refs == [0] and tuple(eng._gtab.shape) == (1, 64, 128)
    finally:
        eng.close()


def test_unconstrained_neighbour_unchanged(weights, grammars, jax_streams):
    """The neighbour served beside three constrained requests (through the
    constrained families) equals its stream on an engine that never saw a
    grammar, and that engine ran no constrained program."""
    eng = _port(weights)
    try:
        (solo,), _ = _serve(eng, [GenRequest([7, 8, 9], max_new_tokens=24)])
        assert solo == jax_streams[3]
        assert eng._gtab is None and eng.stats()["constrained"]["requests"] == 0
    finally:
        eng.close()


def test_constrained_programs_only_while_a_grammar_is_resident(weights, grammars):
    """The engine's rule, held at every launch: a ``…g`` program runs if
    and only if a resident request is constrained (``_grammar_live``, read
    under the engine lock as the dispatch reads it). A chunk dispatched
    after the grammar stream ended on eos (its demand counted before the
    collector retired it) runs the plain program, beside or after the
    neighbour's last tokens: the rule holds there too."""
    _jg, tg = grammars
    eng = _port(weights)
    launches = []  # (family, a grammar resident at the launch)
    launch = eng._launch

    def recorded(name):
        with eng._lock:
            launches.append((name, eng._grammar_live()))
        return launch(name)

    eng._launch = recorded
    try:
        _serve(eng, [GenRequest([7, 8, 9], max_new_tokens=12)])
        plain = list(launches)
        _serve(eng, [GenRequest([1, 2, 3], max_new_tokens=100, grammar=tg), GenRequest([5, 6], max_new_tokens=12)])
        seen = list(launches)
        assert plain and not any(n in eng._programs_g or live for n, live in plain)
        assert all((n in eng._programs_g) == live for n, live in seen)
        assert any(live for _n, live in seen[len(plain):])  # the grammar ran constrained programs
    finally:
        del eng._launch
        eng.close()


def test_sampled_constrained_outputs_all_valid(weights, grammars):
    _jg, tg = grammars
    eng = _port(weights, seed=5)
    try:
        out, reqs = _serve(eng, [GenRequest([5 + i, 9], max_new_tokens=110, temperature=0.9, grammar=tg)
                                 for i in range(6)])
        for toks, r in zip(out, reqs):
            assert r.finish_reason == "eos"
            jsonschema.validate(json.loads(_text(toks)), SCHEMA)
        assert len({tuple(t) for t in out}) > 1  # the draws differ
    finally:
        eng.close()


class _FirstDraftOracle:
    """The engine's n-gram drafter, except that each request's FIRST draft
    is its stream's known continuation, so the first verify of every
    stream accepts at least one constrained draft whatever the thread
    timing. With the n-gram drafter alone, a first verify whose drafts all
    missed bought 16 plain chunks that could finish the streams before any
    draft was accepted (ROADMAP queue 3 item 21)."""

    def __init__(self, inner, prompts, streams):
        self.inner = inner
        self.known = {tuple(p): list(s) for p, s in zip(prompts, streams)}
        self.first: set[tuple] = set()

    def draft(self, tokens: list[int], k: int) -> list[int]:
        for p, s in self.known.items():
            done = list(tokens[len(p):])
            if p not in self.first and tuple(tokens[: len(p)]) == p and s[: len(done)] == done:
                self.first.add(p)
                return s[len(done) : len(done) + k]
        return self.inner.draft(tokens, k)


def test_spec_on_equals_spec_off_and_jax(weights, grammars, jax_streams):
    jg, tg = grammars
    je = _jax(weights, speculative=True, spec_draft=4)
    try:
        jout, _ = _serve(je, [JRequest(p, max_new_tokens=100, grammar=jg) for p in PROMPTS])
    finally:
        je.close()
    eng = _port(weights, speculative=True, spec_draft=4)
    eng.drafter = _FirstDraftOracle(eng.drafter, PROMPTS, jax_streams[:3])
    try:
        out, _ = _serve(eng, [GenRequest(p, max_new_tokens=100, grammar=tg) for p in PROMPTS])
        assert out == jax_streams[:3] == jout
        sp = eng.stats()["spec"]
        assert sp["steps"] > 0 and sp["constrained"]["proposed"] > 0
        assert sp["constrained"]["proposed"] == sp["proposed"] and sp["unconstrained"]["proposed"] == 0
        assert 0 < sp["constrained"]["accepted"] <= sp["constrained"]["proposed"]
    finally:
        eng.close()


def test_submit_rejections(weights, grammars):
    _jg, tg = grammars
    eng = _port(weights)
    off = _port(weights, constrained=False)
    try:
        with pytest.raises(ValueError, match="eos"):
            eng.submit(GenRequest([1, 2], max_new_tokens=8, grammar=tg, eos_token=3))
        small = TS.compile_json_schema({"type": "boolean"}, [b"true", b"false", b""], 2)
        with pytest.raises(ValueError, match="vocab"):
            eng.submit(GenRequest([1], max_new_tokens=8, grammar=small))
        with pytest.raises(ValueError, match="TPU_LLM_CONSTRAINED"):
            off.submit(GenRequest([1], max_new_tokens=8, grammar=tg))
        assert eng._g_refs == [] and eng.stats()["constrained"]["requests"] == 0
        assert not off._programs_g and eng._programs_g
        # an unset eos adopts the grammar's
        r = eng.submit(GenRequest([1, 2], max_new_tokens=100, grammar=tg))
        r.tokens(timeout=120)
        assert r.eos_token == EOS and r.finish_reason == "eos"
    finally:
        eng.close()
        off.close()


def test_grammar_slots_evict_and_overflow(weights, grammars):
    jg, tg = grammars
    boolean = TS.compile_json_schema({"type": "boolean"}, VOCAB, EOS)
    null_g = TS.compile_json_schema({"type": "null"}, VOCAB, EOS)
    eng = _port(weights, constrained_grammars=2)
    try:
        _serve(eng, [GenRequest([1, 2], max_new_tokens=100, grammar=tg)])
        _serve(eng, [GenRequest([1, 2], max_new_tokens=20, grammar=boolean)])
        # both resident, no reference: a third grammar evicts one
        (toks,), _ = _serve(eng, [GenRequest([1, 2], max_new_tokens=20, grammar=null_g)])
        assert _text(toks) == "null"
        st = eng.stats()["constrained"]
        assert st["grammars_resident"] == 2 and sorted(st["states"]) == sorted([boolean.n_states, null_g.n_states])
        # every slot held by a live request: the fourth distinct grammar is refused
        eng._drain_submits = lambda: None  # hold them in the queue, references taken
        held = [eng.submit(GenRequest([1, 2], max_new_tokens=20, grammar=g)) for g in (boolean, null_g)]
        with pytest.raises(EngineOverloaded, match="resident grammar slots") as e:
            eng.submit(GenRequest([1, 2], max_new_tokens=20, grammar=tg))
        assert e.value.status_code == 429 and e.value.retry_after == 1.0
        del eng._drain_submits
        eng._kick.set()
        assert [_text(r.tokens(timeout=120)) in ("true", "false", "null") for r in held] == [True, True]
        assert eng._g_refs == [0, 0]
    finally:
        eng.close()


def test_table_grows_past_its_padding_mid_life(weights, grammars):
    """A grammar of more than 32 states after one of fewer: the device
    table grows from (1, 32) to (2, 64) between two requests, and both
    engines serve the same tokens."""
    jg, tg = grammars
    small = {"enum": ["alpha", "beta"]}
    jsmall, tsmall = JS.compile_json_schema(small, VOCAB, EOS), TS.compile_json_schema(small, VOCAB, EOS)
    assert tsmall.n_states <= 32 < tg.n_states
    je = _jax(weights)
    try:
        want = [_serve(je, [JRequest([4, 5], max_new_tokens=40, grammar=g)])[0][0] for g in (jsmall, jg)]
    finally:
        je.close()
    eng = _port(weights)
    try:
        got = [_serve(eng, [GenRequest([4, 5], max_new_tokens=40, grammar=tsmall)])[0][0]]
        assert tuple(eng._gtab.shape) == (1, 32, 128)
        got += [_serve(eng, [GenRequest([4, 5], max_new_tokens=40, grammar=tg)])[0][0]]
        assert tuple(eng._gtab.shape) == (2, 64, 128)
        assert got == want
        assert json.loads(_text(got[0])) in ("alpha", "beta")
        # the first grammar's rows survived the growth
        assert np.array_equal(eng._gtab[0, : tsmall.n_states].numpy(), tsmall.table)
    finally:
        eng.close()


def test_table_keeps_its_padding_when_a_grammar_is_evicted(weights, grammars):
    """One resident slot: SCHEMA (64 padded states), then a small enum
    evicts it. The JAX engine rebuilds a (1, 32) table; the port keeps its
    (1, 64) one (its captured graphs read that address), padding states
    admitting nothing. The tokens are the same."""
    jg, tg = grammars
    small = {"enum": ["alpha", "beta"]}
    je = _jax(weights, constrained_grammars=1)
    try:
        want = [_serve(je, [JRequest([4, 5], max_new_tokens=40, grammar=g)])[0][0]
                for g in (jg, JS.compile_json_schema(small, VOCAB, EOS))]
        assert tuple(je._gr_dev.shape) == (1, 32, 128)
    finally:
        je.close()
    eng = _port(weights, constrained_grammars=1)
    try:
        got = [_serve(eng, [GenRequest([4, 5], max_new_tokens=40, grammar=g)])[0][0]
               for g in (tg, TS.compile_json_schema(small, VOCAB, EOS))]
        assert tuple(eng._gtab.shape) == (1, 64, 128) and got == want
        assert (eng._gtab[0, TS.compile_json_schema(small, VOCAB, EOS).n_states :] == -1).all()
    finally:
        eng.close()


def test_constrained_request_takes_no_radix_hit(weights, grammars):
    """On a sharing engine a constrained request is a full prefill (no
    lookup); an unconstrained repeat of its prompt hits the blocks it
    published, whose logits are the raw ones: the hit serves the
    unconstrained stream."""
    _jg, tg = grammars
    prompt = list(range(10, 45))
    plain = _port(weights)
    shared = _port(weights, prefix_cache_mb=1.0)
    try:
        (want,), _ = _serve(plain, [GenRequest(prompt, max_new_tokens=10)])
        (c1,), _ = _serve(shared, [GenRequest(prompt, max_new_tokens=60, grammar=tg)])
        (c2,), _ = _serve(shared, [GenRequest(prompt, max_new_tokens=60, grammar=tg)])
        pre = shared.stats()["kvcache"]["prefix"]
        assert c1 == c2 and pre["hits"] == 0 and pre["partial_hits"] == 0
        (got,), _ = _serve(shared, [GenRequest(prompt, max_new_tokens=10)])
        assert got == want and shared.stats()["kvcache"]["prefix"]["hits"] == 1
    finally:
        plain.close()
        shared.close()


def test_g_family_names():
    assert LLMEngine._g_name("llm.step_p16_d8.w4") == "llm.step_p16_d8g.w4"
    assert LLMEngine._g_name("llm.decode_chunk8") == "llm.decode_chunk8g"
    assert LLMEngine._g_name("llm.step_v5") == "llm.step_v5g"


# ---------------------------------------------------------------------------
# response_format on the OpenAI edge against the JAX app
# ---------------------------------------------------------------------------

EDGE_SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}}}


@pytest.fixture(scope="module")
def apps():
    import gofr_tpu
    from gofr_tpu.config import new_mock_config as jax_mock_config
    from gofr_tpu.models.tokenizer import ByteTokenizer as JByte
    from gofr_tpu.openai_compat import register_openai_routes as jax_openai_routes
    from gofr_tpu_torch import serve
    from gofr_tpu_torch.config import new_mock_config

    jcfg = JT.TransformerConfig.tiny()  # vocabulary 512: byte-tokenizable
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), TT.TransformerConfig.tiny(), device="cpu")
    common = {"HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "30", "LOG_LEVEL": "ERROR"}
    japp = gofr_tpu.new(config=jax_mock_config({**common, "METRICS_PORT": "0", "TRACE_EXPORTER": "none"}))
    japp.container.tpu().register_llm("gemma", jcfg, jp, warmup=False, kv_paged=True, slots=4, max_seq_len=256,
                                      prefill_buckets=(16, 64, 128))
    jax_openai_routes(japp, model="gemma", tokenizer=JByte(jcfg.vocab_size))
    papp = serve.build_app(new_mock_config({**common, "GEMMA_PRESET": "tiny", "TORCH_DEVICE": "cpu",
                                            "LLM_SLOTS": "4", "LLM_MAX_SEQ": "256"}), params=tp)
    threads = [japp.run_in_background(), papp.run_in_background()]
    yield japp, papp
    for app, th in zip((japp, papp), threads):
        app.shutdown()
        th.join(timeout=10)
        assert not th.is_alive()


def _call(app, body):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", app.http_server.port, timeout=120)
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _strip(obj):
    return {k: v for k, v in obj.items() if k not in ("id", "created")}


@pytest.mark.parametrize("fmt", [
    {"type": "json_schema", "json_schema": {"name": "r", "schema": EDGE_SCHEMA}},
    {"type": "regex", "regex": r"[a-e]{3,8}"},
])
@pytest.mark.parametrize("stream", [False, True])
def test_edge_response_format_same_answer(apps, fmt, stream):
    body = {"messages": [{"role": "user", "content": "answer"}], "max_tokens": 60,
            "response_format": fmt, "stream": stream}
    (js, jb), (ps, pb) = (_call(a, body) for a in apps)
    assert js == ps == 200
    if stream:
        jev, pev = ([_strip(json.loads(e)) if e != "[DONE]" else e
                     for e in (ln[6:] for ln in raw.decode().split("\n") if ln.startswith("data: "))]
                    for raw in (jb, pb))
        assert pev == jev and pev[-1] == "[DONE]"
        content = "".join(e["choices"][0]["delta"].get("content", "") for e in pev[:-1])
        assert pev[-2]["choices"][0]["finish_reason"] == "stop"
    else:
        j, p = json.loads(jb), json.loads(pb)
        assert _strip(p) == _strip(j)
        content = p["choices"][0]["message"]["content"]
        assert p["choices"][0]["finish_reason"] == "stop"
    if fmt["type"] == "regex":
        assert re.fullmatch(fmt["regex"], content)
    else:
        jsonschema.validate(json.loads(content), EDGE_SCHEMA)


@pytest.mark.parametrize("fmt", [
    {"type": "json_object"},
    {"type": "grammar"},
    {"type": "regex"},
    {"type": "json_schema", "json_schema": {"name": "x"}},
    {"type": "json_schema", "json_schema": {"schema": {"type": "wat"}}},
])
def test_edge_response_format_errors_same_envelope(apps, fmt):
    body = {"messages": [{"role": "user", "content": "x"}], "response_format": fmt}
    (js, jb), (ps, pb) = (_call(a, body) for a in apps)
    assert ps == js == 400
    assert pb == jb
