"""Multi-tenant LoRA serving in the port (gofr_tpu_torch.lora, the
adapter deltas of models.transformer and the engine's adapter pool)
against gofr_tpu's on the same tiny f32 weights and the same adapters
(CPU). The adapters are drawn by gofr_tpu.lora.init_adapter and carried
across as numpy; the JAX engine's tables reach the port through
params_from_jax.

What is held: the pool's rules and validate_adapter's messages; the
delta of every projection and every program with tables and mixed
adapter ids (atol 1e-5; logits 1e-4, see LOGIT_ATOL); greedy token identity with the JAX engine on a
batch mixing the base and two adapters at lookahead 1 and 3; gid 0's
exact identity; adapted equal to merged weights; the lifecycle (404, no
pool, eviction under refcount, billing, publish with a zombie draining on
its old gid, loads in place); preemption; prefix exclusion; speculation,
a grammar and int8 weights on adapted lanes."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import lora as JL
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import quant as JQ
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch import lora as TL
from gofr_tpu_torch import structured as TS
from gofr_tpu_torch.llm import GenRequest, LLMEngine, UnknownAdapterError
from gofr_tpu_torch.models import quant as TQ
from gofr_tpu_torch.models import transformer as TT

ATOL = 1e-5  # the deltas and the K/V rows
# logits (up to ~35 here): the two frameworks already differ by 2.3e-5 on a
# gid-0 row, the base model's own summation order, so logits are held at
# the port's program tolerance (tests/test_torch_model.py)
LOGIT_ATOL = 1e-4
ENGINE_KW = dict(slots=4, max_seq_len=96, prefill_buckets=(8, 16))
# the JAX engine at the port's fixed shapes (gofr_tpu_torch.llm constants)
JAX_KW = dict(warmup=False, kv_paged=True, decode_chunk=8, prefill_chunk=64, step_token_budget=256)
PROMPTS = [list(range(1, 17)), [7, 3, 9, 11, 2], list(range(40, 61)), [5, 6, 7, 8] * 3]


@pytest.fixture(scope="module")
def weights():
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    # untied random head: the tied tiny model repeats its input token
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    tcfg = TT.TransformerConfig.tiny()
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def adapters(weights):
    """Two adapters (rank 4 on every target; rank 2 on attention only),
    scaled so adapted argmaxes move, as host numpy."""
    jcfg = weights[0]
    a = JL.init_adapter(jax.random.PRNGKey(7), jcfg, rank=4, scale=1.0)
    b = JL.init_adapter(jax.random.PRNGKey(11), jcfg, rank=2, scale=1.0, targets=("wq", "wkv", "wo"))
    return jax.tree.map(np.asarray, a), jax.tree.map(np.asarray, b)


def _port(weights, **kw):
    _jcfg, _jp, tcfg, tp = weights
    return LLMEngine(tcfg, tp, device="cpu", **{**ENGINE_KW, **kw})


def _jax(weights, **kw):
    jcfg, jp, _tcfg, _tp = weights
    return JEngine(jcfg, jp, **{**JAX_KW, **ENGINE_KW, **kw})


def _wait(pred, timeout: float, what: str) -> None:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def _idle(eng, timeout: float = 10.0) -> None:
    """Nothing resident or in flight, no block, promise or adapter
    reference held, no zombie."""

    def quiet():
        with eng._lock:
            busy = eng._inflight or eng._processing is not None or any(eng._slot_req) or eng._waiting
            st = eng.kv.stats()
            return not busy and st["reserved"] == 0 and st["blocks_in_use"] == eng.kv.held_blocks()

    _wait(quiet, timeout, "an idle engine")
    snap = eng.adapters()
    assert all(e["refs"] == 0 for e in snap["resident"].values()) and snap["zombies"] == [], snap


def _submit_all(eng, R, jobs):
    """Submit every (prompt, adapter, new tokens) job, all before the first
    is admitted (the port drains its submits once per scheduler pass)."""
    reqs = [eng.submit(R(p, max_new_tokens=n, adapter=a)) for p, a, n in jobs]
    return [r.tokens(timeout=120) for r in reqs]


# -- the pool and checkpoint validation (tests/test_lora.py's cases) ------------

MODS = {"jax": JL, "port": TL}


def _load(pool, name, rank=4, version="v1"):
    gid = pool.allocate(f"{name}@stage", version=version, rank=rank)
    pool.publish(f"{name}@stage", name)
    return gid


@pytest.mark.parametrize("impl", sorted(MODS))
def test_pool_allocate_publish_acquire_release(impl):
    pool = MODS[impl].AdapterPool(2)
    gid = _load(pool, "a")
    assert pool.acquire("a") == gid and pool.refs(gid) == 1
    pool.release(gid)
    assert pool.refs(gid) == 0
    with pytest.raises(KeyError):
        pool.acquire("ghost")


@pytest.mark.parametrize("impl", sorted(MODS))
def test_pool_lru_evicts_idle_only(impl):
    M = MODS[impl]
    pool = M.AdapterPool(2)
    _load(pool, "a")
    _load(pool, "b")
    ga = pool.acquire("a")  # a is busy; b is the only evictable row
    _load(pool, "c")
    assert "b" not in pool.resident() and "a" in pool.resident()
    gc = pool.acquire("c")
    with pytest.raises(M.AdapterPoolFull, match="all 2 adapter slots busy"):
        pool.allocate("d@stage", version="v1", rank=2)
    assert pool.snapshot()["evictions"] == 1
    pool.release(ga)
    pool.release(gc)
    with pytest.raises(ValueError, match="already resident"):
        pool.allocate("a", version="v2", rank=2)


@pytest.mark.parametrize("impl", sorted(MODS))
def test_pool_publish_zombies_busy_old_binding(impl):
    pool = MODS[impl].AdapterPool(2)
    old_gid = _load(pool, "a")
    assert pool.acquire("a") == old_gid  # in flight on v1
    pool.allocate("a@v2", version="v2", rank=2)
    assert pool.publish("a@v2", "a") == old_gid
    assert pool.acquire("a") != old_gid  # new requests ride the new gid
    assert old_gid in pool.snapshot()["zombies"]
    pool.release(old_gid)  # the last one in flight drains: the zombie frees
    assert old_gid not in pool.snapshot()["zombies"]
    assert pool.snapshot()["swaps"] == 2 and pool.remove("a") != old_gid


def _bad_adapters(adapter):
    a = adapter["wq"]
    return {
        "bad_shape": {**adapter, "wq": {**a, "a": np.zeros((1, 1))}},
        "b_mismatch": {"wq": {"a": a["a"], "b": a["b"][:, :1]}},
        "rank_over_max": adapter,
        "unknown_target": {"w_router": a},
        "missing_b": {"wq": {"a": a["a"]}},
    }


@pytest.mark.parametrize("case", ["bad_shape", "b_mismatch", "rank_over_max", "unknown_target", "missing_b"])
def test_validate_rejects_with_jax_messages(weights, adapters, case):
    jcfg, _jp, tcfg, _tp = weights
    bad = _bad_adapters(adapters[0])[case]
    msgs = []
    for M, cfg in ((JL, jcfg), (TL, tcfg)):
        with pytest.raises(ValueError) as ei:
            M.validate_adapter(cfg, bad, rank_max=2 if case == "rank_over_max" else 8)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1], msgs


def test_dims_tables_and_canonical_form_match_jax(weights, adapters):
    """target_dims from param_specs, zero_tables' shapes and dtype, and the
    staged form (alpha folded into B) equal the JAX module's."""
    jcfg, _jp, tcfg, _tp = weights
    assert TL.target_dims(tcfg) == JL.target_dims(jcfg)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in JL.zero_tables(jcfg, 3, 4).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in TL.zero_tables(tcfg, 3, 4, "cpu").items()}
    assert got == want
    jc = JL.validate_adapter(jcfg, adapters[0], rank_max=8, alpha=8.0)
    tc = TL.validate_adapter(tcfg, adapters[0], rank_max=8, alpha=8.0)
    assert sorted(jc) == sorted(tc)
    for name in jc:
        for x, y in zip(jc[name], tc[name]):
            np.testing.assert_array_equal(np.asarray(x), y)
    # the port's own init draws from a torch generator, with the JAX scales
    ta = TL.init_adapter(torch.Generator().manual_seed(0), tcfg, rank=4, targets=("wq", "w_down"))
    assert sorted(ta) == ["w_down", "wq"] and ta["w_down"]["a"].shape == (tcfg.n_layers, tcfg.d_ff, 4)
    assert abs(float(ta["w_down"]["a"].std()) - 0.05 / tcfg.d_ff**0.5) < 0.2 * 0.05 / tcfg.d_ff**0.5


# -- the delta and the programs --------------------------------------------------


def _tables(weights, adapters, slots=3):
    """Both trees with LoRA tables of `slots` gids (rank 4): gid 1 = A, gid
    2 = B, the rest zero; the port's tables carried by params_from_jax."""
    jcfg, jp, tcfg, _tp = weights
    tabs = {k: np.array(v) for k, v in JL.zero_tables(jcfg, slots, 4).items()}
    for gid, ad in ((1, adapters[0]), (2, adapters[1])):
        for name, (a, b) in JL.validate_adapter(jcfg, ad, rank_max=4).items():
            r = a.shape[2]
            tabs[f"lora_{name}_a"][:, gid, :, :r] = a
            tabs[f"lora_{name}_b"][:, gid, :r, :] = b
    jpl = {**jp, "layers": {**jp["layers"], **{k: jnp.asarray(v) for k, v in tabs.items()}}}
    tpl = TT.params_from_jax(jax.tree.map(np.asarray, jpl), tcfg, device="cpu")
    assert tpl["layers"]["lora_wq_a"].dtype == torch.float32
    return jpl, tpl


AIDS = np.asarray([2, 0, 1], np.int32)


@pytest.mark.parametrize("name", TL.LORA_TARGETS)
@pytest.mark.parametrize("quantized", [False, True], ids=["plain", "int8"])
def test_lora_mm_matches_jax(weights, adapters, name, quantized):
    """One projection with mixed adapter ids (and the weight-only int8
    product, as the decode chunk composes them): base + delta."""
    jcfg, _jp, tcfg, _tp = weights
    jpl, tpl = _tables(weights, adapters)
    if quantized:  # both leave the float32 tables as they are
        jpl, tpl = JQ.quantize_params(jpl, jnp.float32), TQ.quantize_params(tpl, torch.float32)
        assert tpl["layers"]["lora_wq_a"].dtype == torch.float32 and isinstance(tpl["layers"]["wq"], TQ.QTensor)
    jlp = jax.tree.map(lambda a: a[0], jpl["layers"])
    tlp = TT._layer(tpl, 0)
    d_in = TL.target_dims(tcfg)[name][0]
    h = np.random.default_rng(3).normal(size=(3, 5, d_in)).astype(np.float32)
    want = JT._lora_mm(JQ.qmm, jnp.asarray(h), jlp, name, jnp.asarray(AIDS))
    sel = TT.lora_select(tpl, torch.from_numpy(AIDS))
    got = TT._lora_mm(TQ.qmm, torch.from_numpy(h), tlp, name, sel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert TT._lora_delta(torch.from_numpy(h), tlp, name, None) is None
    assert TT.lora_select(weights[3], torch.from_numpy(AIDS)) is None  # no tables: no op


def test_transformer_forward_with_adapters(weights, adapters):
    jcfg, _jp, tcfg, tp = weights
    jpl, tpl = _tables(weights, adapters)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (3, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (3, 12)).copy()
    want, _ = JT.transformer_forward(jpl, jcfg, jnp.asarray(tokens), jnp.asarray(pos), aids=jnp.asarray(AIDS))
    got = TT.transformer_forward(tpl, tcfg, torch.from_numpy(tokens), torch.from_numpy(pos),
                                 aids=torch.from_numpy(AIDS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    # gid 0's rows are exactly the base model's; adapted rows move
    base = TT.transformer_forward(tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(pos))
    assert torch.equal(got[1], base[1])
    assert (got[0] - base[0]).abs().max() > 1e-2 and (got[2] - base[2]).abs().max() > 1e-2


def _cache(rng, jcfg, b, cap):
    shape = (jcfg.n_layers, b, cap, jcfg.n_kv_heads, jcfg.head_dim)
    return rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("program", ["prefill_append", "verify_chunk"])
def test_chunk_appends_with_adapters(weights, adapters, program):
    """A prefill chunk (and a verify) at mixed cursors, each packed row
    under its own adapter (explicit aids, as the unified step passes)."""
    jcfg, _jp, tcfg, _tp = weights
    jpl, tpl = _tables(weights, adapters)
    rng = np.random.default_rng(2)
    b, cap, c = 3, 32, 6
    ck, cv = _cache(rng, jcfg, b, cap)
    tokens = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
    cursors = np.asarray([0, 5, 14], np.int32)
    n_new = np.asarray([c, 3, 4], np.int32)
    want_logits, want = getattr(JT, program)(
        jpl, jcfg, jnp.asarray(tokens), JT.KVCache(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(cursors)),
        jnp.asarray(cursors), jnp.asarray(n_new), aids=jnp.asarray(AIDS),
    )
    got_logits, got = getattr(TT, program)(
        tpl, tcfg, torch.from_numpy(tokens),
        TT.KVCache(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()), torch.from_numpy(cursors)),
        torch.from_numpy(cursors), torch.from_numpy(n_new), aids=torch.from_numpy(AIDS),
    )
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=ATOL, rtol=0)


def test_decode_chunk_paged_with_adapters(weights, adapters):
    """4 fused decode steps over a paged pool, each slot under its own
    adapter (JAX reads params["aids"]; the port takes aids)."""
    jcfg, _jp, tcfg, _tp = weights
    jpl, tpl = _tables(weights, adapters)
    rng = np.random.default_rng(4)
    L, b, Bk, MB = jcfg.n_layers, 3, 4, 6
    NB = b * MB
    pshape = (L, NB, Bk, jcfg.n_kv_heads, jcfg.head_dim)
    pk, pv = rng.normal(size=pshape).astype(np.float32), rng.normal(size=pshape).astype(np.float32)
    tables = rng.permutation(NB).reshape(b, MB).astype(np.int32)
    lengths = np.asarray([3, 9, 14], np.int32)
    active = np.asarray([True, True, True])
    first = rng.integers(0, jcfg.vocab_size, b).astype(np.int32)
    temps = np.zeros((b,), np.float32)
    want_toks, want_last, want_pool, _sc, _rng = JT.decode_chunk_paged(
        {**jpl, "aids": jnp.asarray(AIDS)}, jcfg, jnp.asarray(first),
        JT.KVCache(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(lengths)),
        None, jnp.asarray(tables), jnp.asarray(active), jnp.asarray(temps), jax.random.PRNGKey(0),
        n_steps=4, sample_fn=lambda lg, t, k: jnp.argmax(lg, axis=-1).astype(jnp.int32), block=Bk,
    )
    pool = TT.KVCache(torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()), torch.from_numpy(lengths.copy()))
    got_toks, got_last, got_pool = TT.decode_chunk_paged(
        tpl, tcfg, torch.from_numpy(first), pool, torch.from_numpy(tables), torch.from_numpy(active),
        torch.from_numpy(temps), None, n_steps=4, sample_fn=lambda lg, t, g: lg.argmax(dim=-1).to(torch.int32),
        block=Bk, aids=torch.from_numpy(AIDS),
    )
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))
    np.testing.assert_array_equal(got_last.numpy(), np.asarray(want_last))
    np.testing.assert_allclose(got_pool.k.numpy(), np.asarray(want_pool.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_pool.v.numpy(), np.asarray(want_pool.v), atol=ATOL, rtol=0)


def test_merge_adapter_matches_jax(weights, adapters):
    jcfg, jp, tcfg, tp = weights
    want = JL.merge_adapter(jp, jcfg, adapters[0], alpha=2.0)
    got = TL.merge_adapter(tp, tcfg, adapters[0], alpha=2.0)
    for name in TL.LORA_TARGETS:
        np.testing.assert_allclose(got["layers"][name].numpy(), np.asarray(want["layers"][name]), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="quantized"):
        TL.merge_adapter(TQ.quantize_params(tp, torch.float32), tcfg, adapters[0])


# -- the engine ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mixed(weights, adapters):
    """The JAX LoRA engine's streams of the mixed batch: base, A, B, A."""
    je = _jax(weights, lora_slots=4)
    try:
        je.load_adapter("a", adapters[0])
        je.load_adapter("b", adapters[1])
        jobs = list(zip(PROMPTS, ["", "a", "b", "a"], [12, 10, 14, 9]))
        return jobs, _submit_all(je, JRequest, jobs)
    finally:
        je.close()


@pytest.mark.parametrize("lookahead", [1, 3])
def test_mixed_batch_matches_jax(weights, adapters, jax_mixed, lookahead):
    """Base and two adapters decoding in one batch: every stream equals the
    JAX engine's, adapted streams differ from the base's, and the engine
    idles with no reference held."""
    jobs, want = jax_mixed
    eng = _port(weights, lora_slots=4, lookahead=lookahead)
    try:
        eng.load_adapter("a", adapters[0])
        eng.load_adapter("b", adapters[1])
        got = _submit_all(eng, GenRequest, jobs)
        assert got == want
        base = [eng.generate(p, max_new_tokens=n) for p, a, n in jobs if a]
        assert all(g != b for g, b in zip([g for g, (_p, a, _n) in zip(got, jobs) if a], base))
        st = eng.stats()["adapters"]
        assert st["requests"] == 3 and st["rank_max"] == 8 and sorted(st["resident"]) == ["a", "b"]
        _idle(eng)
    finally:
        eng.close()


def test_zero_adapter_identity(weights, adapters):
    """A LoRA engine serves the base streams of an engine without the
    feature, bitwise, with no adapter resident and with one resident but
    unused; lora_slots=0 builds no table and no aids region."""
    with _port(weights) as plain:
        want = [plain.generate(p, max_new_tokens=12) for p in PROMPTS]
        assert not any(k.startswith("lora_") for k in plain.params["layers"])
        assert plain._in.o_aids == plain._in.o_ver and plain.lora_slots == 0
    with _port(weights, lora_slots=2) as eng:
        assert [eng.generate(p, max_new_tokens=12) for p in PROMPTS] == want
        eng.load_adapter("a", adapters[0])
        assert [eng.generate(p, max_new_tokens=12) for p in PROMPTS] == want


def test_adapted_equals_merged(weights, adapters):
    """An adapted stream equals the stream of an engine serving the merged
    weights W + A B (the same math inside the programs)."""
    _jcfg, _jp, tcfg, tp = weights
    with LLMEngine(tcfg, TL.merge_adapter(tp, tcfg, adapters[0]), device="cpu", **ENGINE_KW) as ref:
        want = [ref.generate(p, max_new_tokens=12) for p in PROMPTS[:2]]
    with _port(weights, lora_slots=2, lora_rank=4) as eng:
        eng.load_adapter("a", adapters[0])
        assert [eng.generate(p, max_new_tokens=12, adapter="a") for p in PROMPTS[:2]] == want


def test_unknown_adapter_and_no_pool(weights):
    with _port(weights, lora_slots=2) as eng:
        with pytest.raises(UnknownAdapterError) as ei:
            eng.submit(GenRequest([1, 2, 3], adapter="ghost"))
        assert ei.value.status_code == 404 and isinstance(ei.value, KeyError)
        assert "unknown adapter 'ghost'" in str(ei.value)
        assert eng.stats()["submitted"] == 0
    with _port(weights) as eng:
        with pytest.raises(ValueError, match="no adapter pool"):
            eng.submit(GenRequest([1, 2, 3], adapter="ghost"))
        with pytest.raises(ValueError, match="lora_slots=0"):
            eng.load_adapter("a", {})


def _hold_collector(eng, when=None) -> threading.Event:
    """Hold the collector before its next fetch while the returned event is
    clear (set at first), so programs stay in flight (the card's pace).
    With ``when``, the event starts clear and holds only once ``when()``
    is true."""
    process = eng._process_entry
    go = threading.Event()
    if when is None:
        go.set()

    def held(entry):
        if when is None or when():
            go.wait(timeout=30)
        return process(entry)

    eng._process_entry = held
    return go


def test_eviction_under_refcount(weights, adapters):
    """A busy adapter's gid survives a full pool's load; the idle one is
    evicted; the busy stream is unharmed."""
    with _port(weights, lora_slots=2) as eng:
        eng.load_adapter("busy", adapters[0])
        eng.load_adapter("idle", adapters[1])
        want = eng.generate(PROMPTS[0], max_new_tokens=24, adapter="busy")
        go = _hold_collector(eng)
        go.clear()
        req = eng.submit(GenRequest(PROMPTS[0], max_new_tokens=24, adapter="busy"))
        gid = eng.load_adapter("third", adapters[1])
        resident = eng.adapters()["resident"]
        assert "busy" in resident and "third" in resident and "idle" not in resident
        assert gid != resident["busy"]["gid"] and resident["busy"]["refs"] == 1
        other = eng.submit(GenRequest(PROMPTS[1], max_new_tokens=4, adapter="third"))
        with pytest.raises(TL.AdapterPoolFull):  # every gid holds a live request
            eng.load_adapter("fourth", adapters[1])
        go.set()
        assert req.tokens(timeout=60) == want and len(other.tokens(timeout=60)) == 4
        assert eng.adapters()["evictions"] == 1
        _idle(eng)


def test_billing_defaults_to_adapter_client(weights, adapters):
    with _port(weights, lora_slots=2) as eng:
        eng.load_adapter("acme", adapters[0], fair_weight=3.0)
        eng.generate(PROMPTS[1], max_new_tokens=8, adapter="acme")
        eng.generate(PROMPTS[1], max_new_tokens=8, adapter="acme", client="named")
        fair = eng.stats()["fairness"]
        assert fair["weights"].get("adapter:acme") == 3.0
        assert "adapter:acme" in fair["counters"] and "named" in fair["counters"]
        assert eng.stats()["adapters"]["requests"] == 2


def test_publish_drains_zombie_on_old_gid(weights, adapters):
    """A hot-load over a busy name: the request in flight finishes on its
    old adapter (a zombie gid until it drains), new requests get the new
    one, and every table keeps its address."""
    a, b = adapters
    with _port(weights, lora_slots=3) as eng:
        ptrs = {k: v.data_ptr() for k, v in eng.params["layers"].items() if k.startswith("lora_")}
        eng.load_adapter("acme", a)
        want_old = eng.generate(PROMPTS[2], max_new_tokens=30, adapter="acme")
        eng.load_adapter("acme@v2", b, version="v2")
        want_new = eng.generate(PROMPTS[2], max_new_tokens=30, adapter="acme@v2")
        assert want_new != want_old
        go = _hold_collector(eng)
        go.clear()  # the request stays in flight across the publish
        req = eng.submit(GenRequest(PROMPTS[2], max_new_tokens=30, adapter="acme"))
        _wait(lambda: req.slot is not None, 30, "the v1 request admitted")
        old = eng.publish_adapter("acme@v2", "acme")
        assert old == req._aid and eng.adapters()["zombies"] == [old]
        assert eng.adapters()["resident"]["acme"]["version"] == "v2"
        new = eng.submit(GenRequest(PROMPTS[2], max_new_tokens=30, adapter="acme"))
        new_gid = new._aid
        assert new_gid not in (0, old)
        go.set()
        assert req.tokens(timeout=60) == want_old
        assert new.tokens(timeout=60) == want_new
        _idle(eng)
        assert req._aid == new._aid == 0  # retired: references dropped
        assert eng.evict_adapter("acme") == new_gid and "acme" not in eng.adapters()["resident"]
        assert ptrs == {k: v.data_ptr() for k, v in eng.params["layers"].items() if k.startswith("lora_")}


@pytest.mark.parametrize("lookahead", [1, 3])
def test_preempted_adapted_batch_request_resumes(weights, adapters, lookahead):
    """An adapted batch request preempted for an interactive one resumes
    on its gid: its stream equals the uncontended one."""
    with _port(weights, lora_slots=2, slots=1, lookahead=lookahead) as eng:
        eng.load_adapter("a", adapters[0])
        want = eng.generate(PROMPTS[0], max_new_tokens=48, adapter="a")
        batch = GenRequest(PROMPTS[0], max_new_tokens=48, priority="batch", adapter="a")
        # held once its first tokens are out: far from its end, so its slot
        # is not virtually free when the interactive request arrives
        go = _hold_collector(eng, when=lambda: batch.emitted >= 4)
        eng.submit(batch)
        got: list[int] = []
        th = threading.Thread(target=lambda: got.extend(batch.stream(timeout=60)))
        th.start()
        _wait(lambda: batch.emitted >= 4, 60, "the batch request mid-decode")
        inter = eng.submit(GenRequest([9, 9, 2], max_new_tokens=4))
        _wait(lambda: eng.preemptions >= 1, 10, "the preemption")
        assert batch._aid == eng.adapters()["resident"]["a"]["gid"] and eng.adapters()["resident"]["a"]["refs"] == 1
        go.set()
        inter.tokens(timeout=60)
        th.join(timeout=60)
        assert got == want and batch.preempted == 1 and batch.finish_reason == "length"
        _idle(eng)


def test_adapted_requests_skip_the_prefix_cache(weights, adapters):
    """Adapted requests take no radix hit and publish nothing (their rows
    hold their adapter's deltas), sessions included; base requests still
    share."""
    shared = list(range(1, 41))
    with _port(weights, lora_slots=2, prefix_cache_mb=4, session_mb=4) as eng:
        eng.load_adapter("a", adapters[0])
        kv0 = eng.stats()["kvcache"]["prefix"]
        want_a = eng.generate(shared, max_new_tokens=6, adapter="a")
        eng.generate(shared, max_new_tokens=6, adapter="a", session_id="s1")
        kv1 = eng.stats()["kvcache"]["prefix"]
        assert kv1 == kv0  # no lookup, no store
        base = eng.generate(shared, max_new_tokens=6)  # stores the prompt
        req = eng.submit(GenRequest(shared, max_new_tokens=6, adapter="a"))
        assert req.tokens(timeout=60) == want_a and not req.prefix_hit
        hit = eng.submit(GenRequest(shared, max_new_tokens=6))
        assert hit.tokens(timeout=60) == base and hit.prefix_hit  # the base still shares
        kv2 = eng.stats()["kvcache"]["prefix"]
        assert kv2["stores"] > kv1["stores"] and kv2["hits"] == kv1["hits"] + 1
        _idle(eng)


def test_speculation_on_adapted_lanes(weights, adapters):
    """Speculating adapted lanes (verify_chunk with aids) emit the spec-off
    streams."""
    prompt = ([5, 6, 7, 8] * 8)[:20]
    jobs = [(prompt, "a", 32), (prompt, "", 32), (PROMPTS[0], "a", 24)]
    with _port(weights, lora_slots=2) as off:
        off.load_adapter("a", adapters[0])
        want = _submit_all(off, GenRequest, jobs)
    with _port(weights, lora_slots=2, speculative=True, spec_draft=4) as eng:
        eng.load_adapter("a", adapters[0])
        assert _submit_all(eng, GenRequest, jobs) == want
        assert eng.spec_steps > 0


def test_grammar_on_adapted_lane(weights, adapters):
    """A constrained adapted request: valid under its grammar and equal to
    the constrained stream of the merged-weights engine."""
    _jcfg, _jp, tcfg, tp = weights
    vocab = [bytes([0x20 + i % 95]) for i in range(511)] + [b""]
    g = TS.compile_regex(r"[a-e]{6,12}", vocab, 511)
    with LLMEngine(tcfg, TL.merge_adapter(tp, tcfg, adapters[0]), device="cpu", **ENGINE_KW) as ref:
        want = ref.generate(PROMPTS[1], max_new_tokens=16, grammar=g)
    with _port(weights, lora_slots=2, lora_rank=4) as eng:
        eng.load_adapter("a", adapters[0])
        got = eng.generate(PROMPTS[1], max_new_tokens=16, grammar=g, adapter="a")
        assert got == want and got[-1] == 511 and g.advance_all(0, got) >= 0


def test_int8_weights_with_adapter_match_jax(weights, adapters):
    """int8 weights (W8A8 prefill, weight-only decode) under float32
    adapter tables: the JAX engine's streams."""
    jobs = [(PROMPTS[0], "a", 10), (PROMPTS[1], "", 10), (PROMPTS[2], "a", 10)]
    je = _jax(weights, lora_slots=2, quantize=True)
    try:
        je.load_adapter("a", adapters[0])
        want = _submit_all(je, JRequest, jobs)
    finally:
        je.close()
    with _port(weights, lora_slots=2, quantize=True) as eng:
        eng.load_adapter("a", adapters[0])
        assert isinstance(eng.params["layers"]["wq"], TQ.QTensor)
        assert eng.params["layers"]["lora_wq_a"].dtype == torch.float32
        assert _submit_all(eng, GenRequest, jobs) == want


def test_refused_adapter_takes_no_grammar_reference(weights):
    """A constrained request naming an unknown adapter is refused (404)
    holding nothing: the port acquires the adapter before it registers the
    grammar (and drops the adapter if the registration fails). The JAX
    engine registers the grammar first, so the same refusal leaves a
    grammar reference behind (ROADMAP queue 3 item 12)."""
    vocab = [bytes([0x20 + i % 95]) for i in range(511)] + [b""]
    g = TS.compile_regex(r"[a-e]{2,4}", vocab, 511)
    with _port(weights, lora_slots=2) as eng:
        with pytest.raises(UnknownAdapterError):
            eng.submit(GenRequest([1, 2, 3], max_new_tokens=4, grammar=g, adapter="ghost"))
        assert eng._g_refs == [] and eng.constrained_requests == 0
    from gofr_tpu import structured as JS
    from gofr_tpu.llm import UnknownAdapterError as JUnknown

    je = _jax(weights, lora_slots=2)
    try:
        with pytest.raises(JUnknown):
            je.submit(JRequest([1, 2, 3], max_new_tokens=4, grammar=JS.compile_regex(r"[a-e]{2,4}", vocab, 511),
                               adapter="ghost"))
        assert je._g_refs == [1]  # the reference's leak
    finally:
        je.close()


def test_adapted_session_turn_publishes_nothing(weights, adapters):
    """An adapted request with a session id: its finished turn is not
    published, so a base request on the same prefix re-prefills. The JAX
    engine drops the adapter reference (``_aid = 0``) at retirement,
    before its deferred session publish runs, which then stores the
    adapted rows and hands them to the base request as a prefix hit
    (ROADMAP queue 3 item 13)."""
    prompt = list(range(1, 41))
    kw = dict(lora_slots=2, session_mb=4, prefix_cache_mb=4, slots=2)
    with _port(weights, **kw) as eng:
        eng.load_adapter("a", adapters[0])
        eng.generate(prompt, max_new_tokens=6, adapter="a", session_id="s1")
        _idle(eng)
        base = eng.submit(GenRequest(prompt, max_new_tokens=6))
        base.tokens(timeout=60)
        assert not base.prefix_hit and eng.stats()["kvcache"]["sessions"]["publishes"] == 0
    je = _jax(weights, **kw)
    try:
        je.load_adapter("a", adapters[0])
        je.generate(prompt, max_new_tokens=6, adapter="a", session_id="s1")
        _wait(lambda: je.stats()["kvcache"]["sessions"]["publishes"] == 1, 10, "the JAX session publish")
        jbase = je.submit(JRequest(prompt, max_new_tokens=6))
        jbase.tokens(timeout=60)
        assert jbase.prefix_hit  # the reference's fault: adapted rows reused by the base
    finally:
        je.close()
