"""Mixture-of-experts serving in the port (gofr_tpu_torch.models.moe, the
MoE branch of models.transformer._mlp, quantization of expert stacks)
against gofr_tpu's on the CPU: tiny float32 weights and inputs from numpy
seeds, the same arrays through both packages.

What is held: ``moe_ffn`` against ``gofr_tpu.models.moe.moe_ffn`` (y to
1e-5, the aux loss to 1e-6) with and without capacity drops, both
activations and int8 stacks; the tie order of a zero router against
``lax.top_k``; the served form against the plain one (equal in float32,
the bfloat16 difference pinned); the parameter tree and its quantization;
every program against JAX's; greedy token identity with
``gofr_tpu.llm.LLMEngine`` on ``tiny_moe`` in every engine mode, with
idle slots and padding rows claiming capacity at a capacity that drops."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import lora as JL
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import moe as JM
from gofr_tpu.models import quant as JQ
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch import lora as TL
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.datasource.gpu import GPURuntime
from gofr_tpu_torch.llm import GenRequest, LLMEngine
from gofr_tpu_torch.models import moe as TM
from gofr_tpu_torch.models import quant as TQ
from gofr_tpu_torch.models import transformer as TT

Y_ATOL, AUX_ATOL = 1e-5, 1e-6
ATOL = 1e-4  # program logits and K/V, as tests/test_torch_families.py
ENGINE_KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8, 16))
# the JAX engine at the port's fixed shapes (gofr_tpu_torch.llm constants):
# with capacity drops, a program's row count is part of the function
JAX_KW = dict(warmup=False, kv_paged=True, decode_chunk=8, prefill_chunk=64, step_token_budget=256)


def _pair(capacity: float = 1.25, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params) of tiny_moe at
    ``capacity``, with an untied random unembed so greedy streams vary."""
    jcfg = dataclasses.replace(JT.TransformerConfig.tiny_moe(), moe_capacity=capacity)
    tcfg = dataclasses.replace(TT.TransformerConfig.tiny_moe(), moe_capacity=capacity)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(seed + 9), (jcfg.vocab_size, jcfg.d_model)))
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def drops():
    return _pair(1.25)


@pytest.fixture(scope="module")
def nodrops():
    return _pair(2.0)  # E / k: C = T, nothing drops


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


# -- moe_ffn -------------------------------------------------------------------


def _ffn_inputs(seed, T, E, d=16, ff=24):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(T, d)).astype(np.float32),
        rng.normal(size=(d, E)).astype(np.float32),
        (rng.normal(size=(E, d, ff)) / d**0.5).astype(np.float32),  # init_params' 1 / sqrt(fan_in)
        (rng.normal(size=(E, d, ff)) / d**0.5).astype(np.float32),
        (rng.normal(size=(E, ff, d)) / ff**0.5).astype(np.float32),
    )


def _quantized_stacks(ws):
    """The three stacks quantized by each package (float32 scales), the
    port's q and s bitwise JAX's."""
    jw, tw = [], []
    for w in ws:
        jq = JQ.quantize(jnp.asarray(w), jnp.float32)
        tq = TQ.quantize(torch.from_numpy(w), torch.float32)
        np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
        np.testing.assert_array_equal(tq.s.numpy(), np.asarray(jq.s))
        jw.append(jq)
        tw.append(tq)
    return jw, tw


@pytest.mark.parametrize("weights", ["f32", "int8"])
@pytest.mark.parametrize("act", ["gelu", "silu"])
@pytest.mark.parametrize("capacity", ["drop", "none"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("E", [4, 8])
@pytest.mark.parametrize("T", [1, 7, 32, 64])
def test_moe_ffn_matches_jax(T, E, k, capacity, act, weights):
    x, wr, wg, wu, wd = _ffn_inputs(T * 100 + E * 10 + k, T, E)
    cf = 1.25 if capacity == "drop" else E / k
    if weights == "int8":
        (jg, ju, jd), (tg, tu, td) = _quantized_stacks((wg, wu, wd))
    else:
        jg, ju, jd = map(jnp.asarray, (wg, wu, wd))
        tg, tu, td = map(torch.from_numpy, (wg, wu, wd))
    kw = dict(n_experts=E, top_k=k, capacity_factor=cf, act=act)
    want_y, want_aux = JM.moe_ffn(jnp.asarray(x), jnp.asarray(wr), jg, ju, jd, **kw)
    got_y, got_aux = TM.moe_ffn(torch.from_numpy(x), torch.from_numpy(wr), tg, tu, td, **kw)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=Y_ATOL, rtol=0)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=AUX_ATOL, rtol=0)
    assert torch.equal(TM.moe_mlp(torch.from_numpy(x), torch.from_numpy(wr), tg, tu, td, **kw), got_y)
    plain_y, plain_aux = TM.moe_ffn_plain(torch.from_numpy(x), torch.from_numpy(wr), tg, tu, td, **kw)
    np.testing.assert_allclose(got_y.numpy(), plain_y.numpy(), atol=Y_ATOL, rtol=0)
    assert float(plain_aux) == float(got_aux)
    keep = TM.moe_route(torch.from_numpy(x), torch.from_numpy(wr), E, k, cf)[4]
    if capacity == "none":
        assert bool(keep.all())


def test_moe_ffn_drops_at_the_default_capacity():
    """A skewed router (every row's first choice on expert 0) overflows
    expert 0's capacity of 40 at T = 64: the pairs past it drop, in row
    order, those rows' outputs differ from the no-drop run and the other
    rows' do not, and a row with both slots dropped comes out exactly
    zero."""
    T, E, k = 64, 4, 2
    x, wr, wg, wu, wd = (torch.from_numpy(a) for a in _ffn_inputs(5, T, E))
    x, wr[:, 0] = x + 3.0, wr[:, 0] + 1.0
    _p, _tp, top_e, _sp, keep, C = TM.moe_route(x, wr, E, k, 1.25)
    assert C == 40 and (top_e[:, 0] == 0).all()
    assert keep[:40, 0].all() and not keep[40:, 0].any()  # the first 40 rows claim first
    y, _ = TM.moe_ffn(x, wr, wg, wu, wd, n_experts=E, top_k=k, capacity_factor=1.25)
    y_all, _ = TM.moe_ffn(x, wr, wg, wu, wd, n_experts=E, top_k=k, capacity_factor=E / k)
    dropped = ~keep.all(1)
    assert not torch.equal(y[dropped], y_all[dropped]) and torch.equal(y[~dropped], y_all[~dropped])
    if (~keep).all(1).any():
        assert float(y[(~keep).all(1)].abs().max()) == 0.0


def test_zero_router_ties_take_the_lower_expert_first():
    """A zero router makes every probability exactly 1 / E: the top-k is
    experts 0..k-1 in order, as lax.top_k gives, and the outputs and the
    capacity drops (every first choice on expert 0) equal JAX's."""
    T, E, k = 32, 8, 2
    x, _wr, wg, wu, wd = _ffn_inputs(3, T, E)
    wr = np.zeros((x.shape[1], E), np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(wr), axis=-1)
    want_p, want_e = jax.lax.top_k(probs, k)
    _p, top_p, top_e, slot_pos, keep, C = TM.moe_route(torch.from_numpy(x), torch.from_numpy(wr), E, k, 1.25)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(top_p.numpy(), np.asarray(want_p))
    assert (top_e == torch.arange(k)).all() and int(keep.sum()) == 2 * C  # C rows each on experts 0 and 1
    kw = dict(n_experts=E, top_k=k, capacity_factor=1.25)
    want_y, want_aux = JM.moe_ffn(*map(jnp.asarray, (x, wr, wg, wu, wd)), **kw)
    got_y, got_aux = TM.moe_ffn(*map(torch.from_numpy, (x, wr, wg, wu, wd)), **kw)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=Y_ATOL, rtol=0)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=AUX_ATOL, rtol=0)


def test_moe_config_routing_fields():
    """A positional MoEConfig supplies what the keywords leave out (the
    JAX calling convention); keywords win."""
    T, E = 7, 8
    x, wr, wg, wu, wd = map(torch.from_numpy, _ffn_inputs(11, T, E))
    cfg = TM.MoEConfig(n_experts=E, top_k=1, capacity_factor=2.0)
    a, _ = TM.moe_ffn(x, wr, wg, wu, wd, cfg)
    b, _ = TM.moe_ffn(x, wr, wg, wu, wd, n_experts=E, top_k=1, capacity_factor=2.0)
    c, _ = TM.moe_ffn(x, wr, wg, wu, wd, cfg, top_k=2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="activation"):
        TM.moe_ffn(x, wr, wg, wu, wd, cfg, act="relu")


def test_served_form_bf16_difference_is_rounding():
    """ROADMAP queue 3: in bfloat16 the served form multiplies by the
    stored bf16 stacks, the plain (JAX) form by float32 copies. The
    routing decisions are the same; y differs by bf16 rounding of the
    products' inputs and outputs only (well inside the card's 2e-2), and
    in float32 the two are equal to summation order."""
    T, E, k = 32, 8, 2
    x, wr, wg, wu, wd = map(torch.from_numpy, _ffn_inputs(13, T, E, d=64, ff=96))
    bf = [t.to(torch.bfloat16) for t in (x, wg, wu, wd)]
    kw = dict(n_experts=E, top_k=k, capacity_factor=1.25)
    served, _ = TM.moe_ffn(bf[0], wr, *bf[1:], **kw)
    plain, _ = TM.moe_ffn_plain(bf[0], wr, *bf[1:], **kw)
    assert served.dtype == plain.dtype == torch.bfloat16
    torch.testing.assert_close(served.float(), plain.float(), atol=2e-2, rtol=2e-2)
    assert not torch.equal(served, plain)  # the difference is real, and pinned here
    s32, _ = TM.moe_ffn(x, wr, wg, wu, wd, **kw)
    p32, _ = TM.moe_ffn_plain(x, wr, wg, wu, wd, **kw)
    np.testing.assert_allclose(s32.numpy(), p32.numpy(), atol=Y_ATOL, rtol=0)


# -- the parameter tree -------------------------------------------------------


def test_preset_and_mixtral_width_match_jax():
    """tiny_moe field for field, and Mixtral-8x7B's widths written the same
    way in both packages (the card's moe phase builds the port's)."""
    def mixtral(M):
        return dataclasses.replace(M.TransformerConfig.mistral_7b(), sliding_window=0, rope_theta=1e6,
                                   n_experts=8, moe_top_k=2)

    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    for jcfg, tcfg in ((JT.TransformerConfig.tiny_moe(), TT.TransformerConfig.tiny_moe()), (mixtral(JT), mixtral(TT))):
        assert [f.name for f in dataclasses.fields(jcfg)] == [f.name for f in dataclasses.fields(tcfg)]
        for f in dataclasses.fields(tcfg):
            want = getattr(jcfg, f.name)
            assert getattr(tcfg, f.name) == (dt[want] if f.name == "dtype" else want), f.name
    m = mixtral(TT)
    assert (m.d_model, m.n_layers, m.n_heads, m.n_kv_heads, m.head_dim, m.d_ff, m.vocab_size) == (
        4096, 32, 32, 8, 128, 14_336, 32_000)
    assert (m.act, m.scale_embed, m.sliding_window, m.rope_theta, m.n_experts, m.moe_top_k, m.moe_capacity) == (
        "silu", False, 0, 1e6, 8, 2, 1.25)
    tiny = TT.TransformerConfig.tiny_moe()
    assert (tiny.act, tiny.scale_embed, tiny.dtype) == ("gelu", True, torch.float32)


def test_param_specs_and_init_params_match_jax():
    jcfg, tcfg = JT.TransformerConfig.tiny_moe(), TT.TransformerConfig.tiny_moe()
    jshapes = jax.tree.map(lambda a: tuple(a.shape), JT.init_params(jax.random.PRNGKey(0), jcfg))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == jshapes
    specs = TT.param_specs(tcfg)["layers"]
    d, ff, E = tcfg.d_model, tcfg.d_ff, tcfg.n_experts
    assert specs["w_router"][1] == d and specs["w_gate"][1] == d and specs["w_down"][1] == ff
    # each expert matrix is its own draw at its fan-in scale
    g = tp["layers"]["w_gate"]
    assert g.shape == (2, E, d, ff) and not torch.equal(g[0, 0], g[0, 1])
    assert abs(float(g.std()) - d**-0.5) < 0.01
    # lora adapts attention only on a sparse base, as JAX's target_dims
    assert TL.target_dims(tcfg) == JL.target_dims(jcfg) == {k: v for k, v in JL.target_dims(jcfg).items()
                                                             if k in ("wq", "wkv", "wo")}


def test_quantize_stacks_one_matrix_at_a_time_bitwise():
    """quantize works matrix by matrix along the leading axes; the result
    is bitwise the whole-stack result (each matrix's scales are its own)
    and JAX's, for a 4-D expert stack and a 3-D layer stack."""
    rng = np.random.default_rng(4)
    for shape in ((2, 4, 16, 24), (3, 16, 24)):
        w = rng.normal(size=shape).astype(np.float32)
        w[0, ..., 1] = 0.0  # an all-zero channel gets scale 1
        got = TQ.quantize(torch.from_numpy(w), torch.float32)
        whole = TQ._quantize_matrix(torch.from_numpy(w), torch.float32)
        want = JQ.quantize(jnp.asarray(w), jnp.float32)
        assert got.s.shape == shape[:-2] + (1, shape[-1])
        for a, b in ((got.q, whole.q), (got.s, whole.s)):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))


def test_checkpoint_loaders_refuse_moe():
    """No MoE checkpoint mapper exists in either package yet: the HF
    loaders refuse an MoE config before reading a tensor, and the random
    int8 initializer, which draws dense leaves, refuses one too."""
    from gofr_tpu_torch.models import checkpoint as TC

    for load in (TC.llama_params_from_hf, TC.gemma_params_from_hf):
        with pytest.raises(NotImplementedError, match="mixture-of-experts"):
            load({}, TT.TransformerConfig.tiny_moe(), device="cpu")
    # nor does the random int8 initializer draw expert stacks
    with pytest.raises(NotImplementedError, match="MoE"):
        TQ.init_params_quantized(TT.TransformerConfig.tiny_moe(), device="cpu")


@pytest.mark.parametrize("quantized", [False, True])
def test_params_from_jax(drops, quantized):
    jcfg, jp, tcfg, _tp = drops
    if quantized:
        jp = JQ.quantize_params(jp, jnp.float32)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    lay = tp["layers"]
    assert not isinstance(lay["w_router"], TQ.QTensor)
    for name in ("w_gate", "w_up", "w_down"):
        w, jw = lay[name], jp["layers"][name]
        if quantized:
            assert isinstance(w, TQ.QTensor) and w.q.dtype == torch.int8 and w.s.shape[2] == 1
            np.testing.assert_array_equal(w.q.numpy(), np.asarray(jw.q))
            np.testing.assert_array_equal(w.s.numpy(), np.asarray(jw.s))
        else:
            np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    if quantized:  # the port's own quantize_params gives the same tree
        mine = TQ.quantize_params(_pair(1.25)[3], torch.float32)
        for name in ("w_gate", "w_up", "w_down"):
            assert torch.equal(mine["layers"][name].q, lay[name].q)
            assert torch.equal(mine["layers"][name].s, lay[name].s)
        assert torch.equal(mine["layers"]["w_router"], lay["w_router"])


# -- the programs ----------------------------------------------------------------


@pytest.fixture(scope="module", params=["drop", "drop_int8", "nodrop"])
def prog(request, drops, nodrops):
    jcfg, jp, tcfg, tp = nodrops if request.param == "nodrop" else drops
    if request.param.endswith("int8"):
        jp = JQ.quantize_params(jp, jnp.float32)
        tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def test_transformer_forward(prog):
    jcfg, jp, tcfg, tp = prog
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    want, _ = JT.transformer_forward(jp, jcfg, jnp.asarray(tokens), jnp.asarray(pos))
    got = TT.transformer_forward(tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _append(M, params, cfg, tokens, ck, cv, cursors, n_new, verify=False):
    fn = M.verify_chunk if verify else M.prefill_append
    if M is JT:
        return fn(params, cfg, jnp.asarray(tokens), JT.KVCache(jnp.asarray(ck), jnp.asarray(cv),
                  jnp.asarray(cursors)), jnp.asarray(cursors), jnp.asarray(n_new))
    return fn(params, cfg, torch.from_numpy(tokens), TT.KVCache(torch.from_numpy(ck.copy()),
              torch.from_numpy(cv.copy()), torch.from_numpy(cursors)),
              torch.from_numpy(cursors), torch.from_numpy(n_new))


def test_prefill_append_then_decode_chunk_paged(prog):
    """One prefill chunk into gathered slot rows at mixed cursors (random
    tokens in the pad tails, which route and claim capacity like real
    rows), then 4 fused decode steps over a paged pool with an inactive
    slot (whose rows claim capacity too)."""
    jcfg, jp, tcfg, tp = prog
    rng = np.random.default_rng(2)
    L, b, Bk, MB, c = jcfg.n_layers, 3, 4, 8, 12
    cap = Bk * MB
    shape = (L, b, cap, jcfg.n_kv_heads, jcfg.head_dim)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
    cursors = np.asarray([0, 5, 14], np.int32)
    n_new = np.asarray([c, 7, 9], np.int32)
    want_logits, want = _append(JT, jp, jcfg, tokens, ck, cv, cursors, n_new)
    got_logits, got = _append(TT, tp, tcfg, tokens, ck, cv, cursors, n_new)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=ATOL, rtol=0)

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


def test_verify_chunk(prog):
    jcfg, jp, tcfg, tp = prog
    rng = np.random.default_rng(6)
    L, b, cap, c = jcfg.n_layers, 4, 32, 5
    shape = (L, b, cap, jcfg.n_kv_heads, jcfg.head_dim)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
    cursors = np.asarray([0, 7, 20, 26], np.int32)
    n_new = np.asarray([5, 3, 0, 1], np.int32)
    want_logits, want = _append(JT, jp, jcfg, tokens, ck, cv, cursors, n_new, verify=True)
    got_logits, got = _append(TT, tp, tcfg, tokens, ck, cv, cursors, n_new, verify=True)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=ATOL, rtol=0)


def test_pad_rows_claim_capacity(drops):
    """Why the engine must put in its pad rows exactly what the JAX
    programs put there: claiming is row-major inside slot-major, so row
    0's pad tail claims before row 1's real tokens. Other pad tokens in
    row 0 move row 1's logits at a capacity that drops (both packages
    alike) and leave them alone when nothing drops."""
    rng = np.random.default_rng(8)
    for (jcfg, jp, tcfg, tp), moves in ((drops, True), (_pair(2.0), False)):
        L, b, cap, c = tcfg.n_layers, 2, 32, 16
        shape = (L, b, cap, tcfg.n_kv_heads, tcfg.head_dim)
        ck = rng.normal(size=shape).astype(np.float32)
        cv = rng.normal(size=shape).astype(np.float32)
        cursors, n_new = np.asarray([0, 0], np.int32), np.asarray([3, 16], np.int32)
        tokens = rng.integers(1, 512, (b, c)).astype(np.int32)
        outs = []
        for pad in (0, 7):
            t = tokens.copy()
            t[0, 3:] = pad
            want, _ = _append(JT, jp, jcfg, t, ck, cv, cursors, n_new)
            got, _ = _append(TT, tp, tcfg, t, ck, cv, cursors, n_new)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
            outs.append(got[1])
        assert (float((outs[0] - outs[1]).abs().max()) > 1e-3) == moves


# -- the engine ------------------------------------------------------------------


def _together(eng, R, jobs):
    """Submit every (prompt, new tokens, kw) job so one admission pass
    takes them all (either engine's drain held until the last submit):
    with capacity drops, which rows share a program is part of the
    result."""
    name = "_drain_and_observe" if isinstance(eng, JEngine) else "_drain_submits"
    setattr(eng, name, lambda *a, **k: None)
    try:
        reqs = [eng.submit(R(p, max_new_tokens=n, **kw)) for p, n, kw in jobs]
    finally:
        delattr(eng, name)
    return [r.tokens(timeout=120) for r in reqs]


class _Drops:
    """Counts the (row, slot) pairs the port's MoE calls drop."""

    def __init__(self, monkeypatch):
        self.pairs = self.dropped = 0
        served = TT.moe_mlp

        def counting(x, w_router, *a, **kw):
            keep = TM.moe_route(x, w_router, kw["n_experts"], kw["top_k"], kw["capacity_factor"])[4]
            self.pairs += keep.numel()
            self.dropped += int((~keep).sum())
            return served(x, w_router, *a, **kw)

        monkeypatch.setattr(TT, "moe_mlp", counting)


def _engines(pair, jkw=None, **kw):
    jcfg, jp, tcfg, tp = pair
    ref = JEngine(jcfg, jp, **{**JAX_KW, **ENGINE_KW, **(jkw or {}), **kw})
    port = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW, **kw)
    return ref, port


# Fewer requests than slots, mixed prompt lengths. FEW's requests finish
# at different programs: a retired slot keeps running as an idle lane that
# reads the blocks its request freed, which a later admission may already
# have rewritten. At lookahead > 1 whether it has depends on when the
# collector retired the request, in the JAX engine as in the port, and the
# idle lane's rows claim capacity: so FEW is compared at lookahead 1 only.
# SAME's prompts all prefill in the first step and finish together, so no
# lane retires while another decodes.
FEW = [(p, n, {}) for p, n in zip(_prompts(7, (3, 40, 17)), (19, 8, 14))]
SAME = [(p, 12, {}) for p in _prompts(17, (3, 11, 16))]


@pytest.mark.parametrize("lookahead, jobs", [(1, "few"), (1, "same"), (3, "same")])
def test_engine_identity_with_drops(drops, monkeypatch, lookahead, jobs):
    """Fewer requests than slots, mixed prompt lengths, capacity 1.25: the
    idle slot, the inert padding lanes and every pad tail claim capacity,
    pairs drop, and every stream equals the JAX engine's; then each
    request alone, three slots idle with the batch's stale state."""
    jobs = FEW if jobs == "few" else SAME
    ref, port = _engines(drops, lookahead=lookahead)
    counter = _Drops(monkeypatch)
    try:
        want = _together(ref, JRequest, jobs)
        assert _together(port, GenRequest, jobs) == want
        assert counter.dropped > 0 and all(len(set(w)) > 1 for w in want)
        for p, n, _kw in jobs:
            assert port.generate(p, max_new_tokens=n) == ref.generate(p, max_new_tokens=n)
        st = port.stats()
        assert st["moe_experts"] == 4 and st["kvcache"]["blocks_in_use"] == 0
    finally:
        ref.close()
        port.close()


def test_engine_drops_change_tokens(drops, nodrops):
    """The drops are load-bearing: the same weights at capacity E / k give
    other streams."""
    with LLMEngine(drops[2], drops[3], device="cpu", **ENGINE_KW) as a, \
            LLMEngine(nodrops[2], nodrops[3], device="cpu", **ENGINE_KW) as b:
        assert _together(a, GenRequest, SAME) != _together(b, GenRequest, SAME)


def test_engine_identity_more_requests_than_slots(nodrops):
    """Six requests on four slots, slots reused: at capacity E / k no
    program's composition changes a token, so the streams equal JAX's
    however the two schedulers' timing packs them."""
    ref, port = _engines(nodrops)
    jobs = [(p, 19 if i % 2 else 8, {}) for i, p in enumerate(_prompts(11, (3, 17, 33, 9, 40, 16)))]
    try:
        assert _together(port, GenRequest, jobs) == _together(ref, JRequest, jobs)
    finally:
        ref.close()
        port.close()


def test_engine_int8_identity(drops, monkeypatch):
    """quantize=True, kv_int8=True: int8 expert stacks dequantized as
    JAX's _deq, W8A8 attention products, the int8 KV pool."""
    ref, port = _engines(drops, quantize=True, kv_int8=True)
    counter = _Drops(monkeypatch)
    try:
        assert TQ.is_quantized(port.params) and isinstance(port.params["layers"]["w_gate"], TQ.QTensor)
        assert not isinstance(port.params["layers"]["w_router"], TQ.QTensor)
        assert _together(port, GenRequest, SAME) == _together(ref, JRequest, SAME)
        assert counter.dropped > 0
    finally:
        ref.close()
        port.close()


class _RepeatDrafter:
    """Proposes the stream's last token k times."""

    def draft(self, tokens, k):
        return [tokens[-1]] * k if k > 0 else []


def test_engine_speculative_identity(drops):
    """speculative=True: every verify program routes its [slots, 5] rows
    as one MoE call, drafts accepted or not (lookahead 1: the lanes
    accept different counts and so retire at different programs)."""
    ref, port = _engines(drops, speculative=True, spec_draft=4, lookahead=1)
    ref.drafter = port.drafter = _RepeatDrafter()
    jobs = [(p, 16, {}) for p in _prompts(13, (5, 20)) + [([5, 6, 7, 8] * 8)[:20]]]
    try:
        assert _together(port, GenRequest, jobs) == _together(ref, JRequest, jobs)
        assert port.stats()["spec"]["steps"] > 0
    finally:
        ref.close()
        port.close()


def test_engine_prefix_hits_identity(drops):
    """A base prompt, its exact repeat (no prefill: the first token from the
    stored logits), a sibling sharing 20 tokens (a block-partial hit),
    then both again: the streams and prefix counters equal JAX's."""
    ref, port = _engines(drops, prefix_cache_mb=4.0)
    rng = np.random.default_rng(9)
    base = rng.integers(1, 512, 40).tolist()
    sib = base[:20] + rng.integers(1, 512, 10).tolist()
    try:
        for i, p in enumerate((base, base, sib, sib, base)):
            assert port.generate(p, max_new_tokens=6) == ref.generate(p, max_new_tokens=6), i
        st = port.stats()["kvcache"]["prefix"]
        assert st == ref.stats()["kvcache"]["prefix"] and st["hits"] >= 2 and st["partial_hits"] >= 1
    finally:
        ref.close()
        port.close()


@pytest.fixture(scope="module")
def adapter(drops):
    jcfg = drops[0]
    return jax.tree.map(np.asarray, JL.init_adapter(jax.random.PRNGKey(7), jcfg, rank=4, scale=2.0))


def test_engine_lora_zero_adapter_identity(drops, adapter):
    """A LoRA pool on an MoE base: base lanes are token-exact with no pool
    and equal to JAX's, and again (each engine's second batch, from its
    first's state) with an adapter resident but unused."""
    ref, port = _engines(drops, lora_slots=2)
    try:
        assert sorted(k for k in port.params["layers"] if k.startswith("lora_")) == [
            "lora_wkv_a", "lora_wkv_b", "lora_wo_a", "lora_wo_b", "lora_wq_a", "lora_wq_b"]
        want = _together(ref, JRequest, SAME)
        assert _together(port, GenRequest, SAME) == want
        with LLMEngine(drops[2], drops[3], device="cpu", **ENGINE_KW) as plain:
            assert _together(plain, GenRequest, SAME) == want
        ref.load_adapter("t", adapter)
        port.load_adapter("t", adapter)
        assert _together(port, GenRequest, SAME) == _together(ref, JRequest, SAME)
    finally:
        ref.close()
        port.close()


def test_engine_lora_adapted_equals_merged(drops, adapter):
    """An adapted request equals an engine over merge_adapter's weights
    (attention deltas folded in, experts shared), and JAX's adapted
    stream."""
    jcfg, jp, tcfg, tp = drops
    prompt = list(range(1, 17))
    merged = TL.merge_adapter(tp, tcfg, adapter)
    with LLMEngine(tcfg, merged, device="cpu", **ENGINE_KW) as eng:
        want = eng.generate(prompt, max_new_tokens=12)
    ref, port = _engines(drops, lora_slots=2)
    try:
        ref.load_adapter("tenant", adapter)
        port.load_adapter("tenant", adapter)
        got = port.generate(prompt, max_new_tokens=12, adapter="tenant")
        assert got == want == ref.generate(prompt, max_new_tokens=12, adapter="tenant")
        assert got != port.generate(prompt, max_new_tokens=12)
    finally:
        ref.close()
        port.close()


def test_register_llm_serves_moe(drops):
    """GPURuntime.register_llm builds an MoE engine whose stats report its
    experts, with the JAX engine's tokens."""
    jcfg, jp, tcfg, tp = drops
    rt = GPURuntime(MapConfig({"TORCH_DEVICE": "cpu"}))
    ref = JEngine(jcfg, jp, **JAX_KW, **ENGINE_KW)
    try:
        eng = rt.register_llm("moe", tcfg, tp, **ENGINE_KW)
        assert eng.stats()["moe_experts"] == tcfg.n_experts == ref.stats()["moe_experts"]
        prompt = _prompts(3, (21,))[0]
        assert eng.generate(prompt, max_new_tokens=10) == ref.generate(prompt, max_new_tokens=10)
    finally:
        ref.close()
        rt.close()
    with LLMEngine(TT.TransformerConfig.tiny(), TT.init_params(TT.TransformerConfig.tiny(), device="cpu"),
                   device="cpu", warmup=False, **ENGINE_KW) as dense:
        assert dense.stats()["moe_experts"] == 0
