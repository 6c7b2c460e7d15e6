"""The port's int8 serving path against the JAX package (CPU).

int8 KV rows (``quantize_rows`` / ``scatter_rows(scales=)`` /
``gather_slots(scales=)``), the int8 paged-decode partials (plain version
here, held against the Pallas kernel's ``quantized=True`` variant in
interpret mode), int8 weights (``models.quant``), the model functions with
quantized params and an int8 pool, and the engine with ``kv_int8``,
``quantize`` and both, greedy token for token against
``gofr_tpu.llm.LLMEngine``. Inputs are made with numpy from a seed and
handed to both frameworks; each comparison states its tolerance.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gofr_tpu.kvcache import CacheManager as JCacheManager
from gofr_tpu.kvcache import paged as JP
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import quant as JQ
from gofr_tpu.models import transformer as JT
from gofr_tpu.ops import attention as JA
from gofr_tpu_torch.kvcache import CacheManager, dequantize_rows, gather_slots, quantize_rows, scatter_rows
from gofr_tpu_torch.llm import GenRequest, LLMEngine
from gofr_tpu_torch.models import quant as TQ
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.ops import attention as TA

ATOL = 1e-4  # model functions: the two frameworks sum in different orders
ENGINE_KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8, 16))


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bfloat16 (ml_dtypes) through float32, which is exact."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _n(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert _n(got).dtype == want.dtype
    np.testing.assert_array_equal(_n(got), want)


def _int8_pools(rng, L, NB, B, hkv, d):
    """Random f32 pools quantized by the JAX codec: (qk, qv, sk, sv)."""
    pk = rng.normal(size=(L, NB, B, hkv, d)).astype(np.float32)
    pv = rng.normal(size=(L, NB, B, hkv, d)).astype(np.float32)
    qk, sk = (np.asarray(a) for a in JP.quantize_rows(jnp.asarray(pk)))
    qv, sv = (np.asarray(a) for a in JP.quantize_rows(jnp.asarray(pv)))
    return qk, qv, sk, sv


# ---------------------------------------------------------------------------
# KV codec
# ---------------------------------------------------------------------------


class TestKVCodec:
    @pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
    def test_quantize_rows_byte_identical(self, dtype):
        rng = np.random.default_rng(0)
        rows = rng.normal(size=(3, 5, 2, 16)).astype(np.float32)
        rows[0, 0, 0] = 0.0  # a zero row: scale 1e-8 / 127, all codes 0
        # amax 127 gives scale 1.0, so these land exactly on .5 steps:
        # round half to even sends 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> -0
        rows[1, 2, 1] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5] + [0.25] * 8
        rows = rows.astype(dtype)
        q, s = quantize_rows(_t(rows))
        jq, js = JP.quantize_rows(jnp.asarray(rows))
        _same(q, jq)
        _same(s, js)
        assert q[1, 2, 1, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
        assert (q[0, 0, 0] == 0).all()

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_dequantize_rows(self, dtype):
        rng = np.random.default_rng(1)
        q = rng.integers(-127, 128, (4, 2, 8)).astype(np.int8)
        s = rng.random((4, 2)).astype(np.float32)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        _same(dequantize_rows(_t(q), _t(s), dtype), JP.dequantize_rows(jnp.asarray(q), jnp.asarray(s), jdt))

    @pytest.mark.parametrize("seed", [0, 1])
    def test_scatter_rows_int8_byte_identical_with_dropped_lanes(self, seed):
        rng = np.random.default_rng(seed)
        L, NB, B, hkv, d, S, W, MB = 2, 12, 4, 2, 8, 3, 5, 3
        qk, qv, sk, sv = _int8_pools(rng, L, NB, B, hkv, d)
        scales = np.stack([sk, sv])
        tables = rng.permutation(NB)[: S * MB].reshape(S, MB).astype(np.int32)
        rows_k = rng.normal(size=(L, S, W, hkv, d)).astype(np.float32)
        rows_v = rng.normal(size=(L, S, W, hkv, d)).astype(np.float32)
        starts = rng.integers(0, MB * B - W, S)
        pos = (starts[:, None] + np.arange(W)[None, :]).astype(np.int32)
        valid = rng.random((S, W)) > 0.3
        valid[0, 0] = False  # at least one dropped lane
        tk, tv, ts = _t(qk.copy()), _t(qv.copy()), _t(scales.copy())
        out_k, out_v = scatter_rows(
            tk, tv, *map(_t, (tables, rows_k, rows_v, pos, valid)), scales=ts
        )
        assert out_k is tk and out_v is tv  # written in place, scales too
        jk, jv, js = JP.scatter_rows(
            *map(jnp.asarray, (qk, qv, tables, rows_k, rows_v, pos, valid)),
            scales=jnp.asarray(scales),
        )
        _same(tk, jk)
        _same(tv, jv)
        _same(ts, js)
        assert not np.array_equal(ts.numpy(), scales)  # something was written

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_gather_slots_int8(self, dtype):
        rng = np.random.default_rng(2)
        qk, qv, sk, sv = _int8_pools(rng, 2, 10, 4, 2, 8)
        tables = rng.integers(0, 10, (3, 2)).astype(np.int32)
        tables[1, 1] = 12  # out of range: clipped like the JAX gather
        lens = np.asarray([3, 8, 0], np.int32)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        got = gather_slots(*map(_t, (qk, qv, tables, lens)), scales=(_t(sk), _t(sv)), dtype=dtype)
        want = JP.gather_slots(
            *map(jnp.asarray, (qk, qv, tables, lens)),
            scales=(jnp.asarray(sk), jnp.asarray(sv)), dtype=jdt,
        )
        _same(got.k, want.k)
        _same(got.v, want.v)
        # the view's dequant rule: the scale is cast to the model dtype
        # first (in bf16 it keeps 8 bits of mantissa), then multiplied there
        idx = np.clip(tables, 0, 9)
        s_dt = _t(sk)[:, idx].reshape(2, 3, 8, 2).to(dtype)
        k_dt = _t(qk)[:, idx].reshape(2, 3, 8, 2, 8).to(dtype)
        assert torch.equal(got.k, k_dt * s_dt[..., None])


# ---------------------------------------------------------------------------
# The int8 paged-decode partials (plain version vs the Pallas kernel)
# ---------------------------------------------------------------------------


class TestInt8PagedDecode:
    """Mirrors tests/test_paged_kv.py TestPagedAttentionKernel.test_kernel_int8."""

    def _inputs(self, seed=1):
        rng = np.random.RandomState(seed)
        b, hq, hkv, d, Bk, MB, NB, chunk = 3, 4, 2, 16, 8, 4, 24, 4
        pk = rng.randn(NB, Bk, hkv, d).astype(np.float32)
        pv = rng.randn(NB, Bk, hkv, d).astype(np.float32)
        qk, sk = (np.asarray(a) for a in JP.quantize_rows(jnp.asarray(pk)))
        qv, sv = (np.asarray(a) for a in JP.quantize_rows(jnp.asarray(pv)))
        return dict(
            q=rng.randn(b, 1, hq, d).astype(np.float32),
            qk=qk, qv=qv, sk=sk, sv=sv,
            tables=rng.randint(0, NB, size=(b, MB)).astype(np.int32),
            kb=rng.randn(b, chunk, hkv, d).astype(np.float32),
            vb=rng.randn(b, chunk, hkv, d).astype(np.float32),
            lengths=np.asarray([11, 20, 0], np.int32),
        )

    @pytest.mark.parametrize(
        "lo,cap", [([0, 0, 0], 0.0), ([0, 0, 0], 3.0), ([4, 9, 0], 0.0)],
        ids=["full band", "soft cap", "window band"],
    )
    def test_partials_match_pallas_quantized(self, lo, cap):
        x = self._inputs()
        hi = x["lengths"]
        lo = np.asarray(lo, np.int32)
        args = (x["q"][:, 0], x["qk"], x["qv"], x["tables"], lo, hi)
        got = TA.paged_decode_partials(
            *map(_t, args), scale=0.25, logit_cap=cap, k_scales=_t(x["sk"]), v_scales=_t(x["sv"]),
        )
        want = JA._paged_decode_partials(
            *map(jnp.asarray, args), scale=0.25, logit_cap=cap,
            k_scales=jnp.asarray(x["sk"]), v_scales=jnp.asarray(x["sv"]), interpret=True,
        )
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=2e-6)
        # the empty band keeps the kernel's initial partials
        assert (got[2][2] == 0).all() and (got[1][2] == TA.NEG_INF).all()

    @pytest.mark.parametrize("window", [0, 9])
    def test_chunk_decode_int8_matches_kernel_path(self, window):
        x = self._inputs()
        names = ("q", "qk", "qv", "tables", "kb", "vb", "lengths")
        got = TA.paged_chunk_decode_attention(
            *(_t(x[n]) for n in names), 1, window=window,
            k_scales=_t(x["sk"]), v_scales=_t(x["sv"]),
        )
        want = JA.paged_chunk_decode_attention(
            *(jnp.asarray(x[n]) for n in names), jnp.int32(1), window=window,
            k_scales=jnp.asarray(x["sk"]), v_scales=jnp.asarray(x["sv"]),
            use_kernel=True, interpret=True,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_paged_gather_int8_byte_identical(self, dtype):
        x = self._inputs()
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        gk, gv = TA.paged_gather(
            *map(_t, (x["qk"], x["qv"], x["tables"])),
            k_scales=_t(x["sk"]), v_scales=_t(x["sv"]), dtype=dtype,
        )
        jk, jv = JA.paged_gather(
            *map(jnp.asarray, (x["qk"], x["qv"], x["tables"])),
            k_scales=jnp.asarray(x["sk"]), v_scales=jnp.asarray(x["sv"]), dtype=jdt,
        )
        _same(gk, jk)
        _same(gv, jv)

    def test_cpu_int8_runs_plain_version_without_launch(self):
        x = self._inputs()
        args = [_t(a) for a in (x["q"][:, 0], x["qk"], x["qv"], x["tables"])]
        lo = torch.zeros(3, dtype=torch.int32)
        hi = _t(x["lengths"])
        before = (TA.paged_decode_partials.launches, TA.paged_decode_partials.launches_int8)
        kw = dict(scale=0.25, k_scales=_t(x["sk"]), v_scales=_t(x["sv"]))
        got = TA.paged_decode_partials(*args, lo, hi, **kw)
        want = TA.paged_decode_partials_plain(*args, lo, hi, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert (TA.paged_decode_partials.launches, TA.paged_decode_partials.launches_int8) == before

    def test_int8_wrapper_rejects_other_devices_and_half_scales(self):
        qd = torch.empty((2, 2, 16), device="meta")
        pool = torch.empty((4, 4, 1, 16), dtype=torch.int8, device="meta")
        sc = torch.empty((4, 4, 1), device="meta")
        idx = torch.empty((2,), dtype=torch.int32, device="meta")
        tables = torch.empty((2, 3), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            TA.paged_decode_partials(qd, pool, pool, tables, idx, idx, scale=0.25, k_scales=sc, v_scales=sc)
        with pytest.raises(ValueError, match="both k_scales and v_scales"):
            TA.paged_decode_partials(qd, pool, pool, tables, idx, idx, scale=0.25, k_scales=sc)


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------


def _quantized_pair(preset: str, seed: int = 0):
    """(jax cfg, jax quantized params, port cfg, port params from the JAX
    tree) on an untied random head."""
    jcfg = getattr(JT.TransformerConfig, preset)()
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, unembed=jax.random.normal(
        jax.random.PRNGKey(seed + 100), (jcfg.vocab_size, jcfg.d_model), jnp.float32
    ))
    jq = JQ.quantize_params(jp, jnp.float32)
    tcfg = getattr(TT.TransformerConfig, preset)()
    tq = TT.params_from_jax(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    return jcfg, jq, tcfg, tq


class TestWeights:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_quantize_byte_identical(self, dtype):
        rng = np.random.default_rng(3)
        w = rng.normal(size=(2, 24, 16)).astype(np.float32)
        w[1, :, 5] = 0.0  # an all-zero output channel: scale 1
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        got = TQ.quantize(_t(w), dtype)
        want = JQ.quantize(jnp.asarray(w), jdt)
        _same(got.q, want.q)
        _same(got.s, want.s)
        assert got.s.shape == (2, 1, 16) and float(got.s[1, 0, 5]) == 1.0

    @pytest.mark.parametrize("rows", [5, 24])  # below and above _int_mm's 16-row minimum
    def test_qmm_and_qmm_a8(self, rows):
        rng = np.random.default_rng(4)
        x = rng.normal(size=(rows, 32)).astype(np.float32)
        x[1] = 0.0  # a zero activation row: scale 1e-8
        w = rng.normal(size=(32, 24)).astype(np.float32)
        jw = JQ.quantize(jnp.asarray(w), jnp.float32)
        tw = TQ.QTensor(_t(np.asarray(jw.q)), _t(np.asarray(jw.s)))
        np.testing.assert_allclose(
            TQ.qmm(_t(x), tw).numpy(), np.asarray(JQ.qmm(jnp.asarray(x), jw)), atol=1e-5, rtol=0
        )
        # int32 products are exact; both sides then scale in the same order
        np.testing.assert_array_equal(
            TQ.qmm_a8(_t(x), tw).numpy(), np.asarray(JQ.qmm_a8(jnp.asarray(x), jw))
        )
        x3 = x.reshape(1, rows, 32)
        np.testing.assert_array_equal(
            TQ.qmm_a8(_t(x3), tw).numpy(), np.asarray(JQ.qmm_a8(jnp.asarray(x3), jw))
        )
        # plain tensors: a plain product either way
        assert torch.equal(TQ.qmm_a8(_t(x), _t(w)), _t(x) @ _t(w))
        assert torch.equal(TQ.qmm(_t(x), _t(w)), _t(x) @ _t(w))

    def test_params_from_jax_keeps_int8(self):
        jcfg, jq, tcfg, tq = _quantized_pair("tiny")
        assert TQ.is_quantized(tq) and TQ.quantize_params(tq, tcfg.dtype) is tq
        flat = jax.tree_util.tree_flatten_with_path(jq)[0]
        for path, leaf in flat:
            t = tq
            for p in path:
                t = t[p.key] if hasattr(p, "key") else getattr(t, p.name)
            leaf = np.asarray(leaf)
            want_dtype = torch.int8 if leaf.dtype == np.int8 else tcfg.dtype
            assert t.dtype == want_dtype, path
            np.testing.assert_array_equal(t.numpy(), leaf)
        assert isinstance(tq["layers"]["wq"], TQ.QTensor)
        assert not isinstance(tq["layers"]["attn_norm"], TQ.QTensor)

    def test_quantize_params_matches_jax(self):
        jcfg = JT.TransformerConfig.tiny()
        jp = JT.init_params(jax.random.PRNGKey(1), jcfg)
        tcfg = TT.TransformerConfig.tiny()
        tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        got = TQ.quantize_params(tp, torch.float32)
        want = TT.params_from_jax(
            jax.tree.map(np.asarray, JQ.quantize_params(jp, jnp.float32)), tcfg, device="cpu"
        )
        for name in ("embed", "final_norm"):
            assert jax.tree.map(torch.equal, got[name], want[name])
        for name, w in want["layers"].items():
            g = got["layers"][name]
            assert type(g) is type(w)
            assert all(jax.tree.leaves(jax.tree.map(torch.equal, g, w))), name

    def test_init_params_quantized_shapes(self):
        jcfg = JT.TransformerConfig.tiny()
        tcfg = TT.TransformerConfig.tiny()
        want = jax.tree.map(
            lambda a: (tuple(a.shape), str(a.dtype)), JQ.init_params_quantized(jax.random.PRNGKey(0), jcfg)
        )
        tp = TQ.init_params_quantized(tcfg, torch.Generator().manual_seed(0), "cpu")
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), tp)
        assert jax.tree.leaves(got) == jax.tree.leaves(want)
        assert int(tp["layers"]["wq"].q.abs().max()) <= 127

    @pytest.mark.parametrize("preset", ["tiny", "tiny_llama"])
    def test_int8_embed_and_unembed(self, preset):
        jcfg, jq, tcfg, tq = _quantized_pair(preset)
        rng = np.random.default_rng(5)
        tokens = rng.integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
        x = rng.normal(size=(2, 6, jcfg.d_model)).astype(np.float32)
        np.testing.assert_array_equal(
            TT._embed_tokens(tq, tcfg, _t(tokens)).numpy(),
            np.asarray(JT._embed_tokens(jq, jcfg, jnp.asarray(tokens))),
        )
        np.testing.assert_allclose(
            TT._unembed(tq, tcfg, _t(x)).numpy(), np.asarray(JT._unembed(jq, jcfg, jnp.asarray(x))),
            atol=1e-5, rtol=0,
        )


# ---------------------------------------------------------------------------
# Model functions with quantized params and an int8 pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny", "tiny_llama"])
def test_transformer_forward_quantized(preset):
    jcfg, jq, tcfg, tq = _quantized_pair(preset)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    want, _ = JT.transformer_forward(jq, jcfg, jnp.asarray(tokens), jnp.asarray(pos))
    got = TT.transformer_forward(tq, tcfg, _t(tokens), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("preset", ["tiny", "tiny_llama"])
def test_prefill_append_quantized(preset):
    jcfg, jq, tcfg, tq = _quantized_pair(preset)
    rng = np.random.default_rng(7)
    L, b, cap, c = jcfg.n_layers, 3, 32, 8
    # the slot view an int8 pool gathers: dequantized rows
    shape = (L, b, cap, jcfg.n_kv_heads, jcfg.head_dim)
    ck = np.asarray(JP.dequantize_rows(*JP.quantize_rows(jnp.asarray(rng.normal(size=shape).astype(np.float32))), jnp.float32))
    cv = np.asarray(JP.dequantize_rows(*JP.quantize_rows(jnp.asarray(rng.normal(size=shape).astype(np.float32))), jnp.float32))
    tokens = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
    cursors = np.asarray([0, 7, 20], np.int32)
    n_new = np.asarray([c, 3, 0], np.int32)
    want_logits, want = JT.prefill_append(
        jq, jcfg, jnp.asarray(tokens), JT.KVCache(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(cursors)),
        jnp.asarray(cursors), jnp.asarray(n_new),
    )
    got_logits, got = TT.prefill_append(
        tq, tcfg, _t(tokens), TT.KVCache(_t(ck.copy()), _t(cv.copy()), _t(cursors)), _t(cursors), _t(n_new),
    )
    np.testing.assert_allclose(got_logits[:2].numpy(), np.asarray(want_logits)[:2], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=ATOL, rtol=0)


@pytest.mark.parametrize("preset", ["tiny", "tiny_llama"])
def test_decode_chunk_paged_int8(preset):
    jcfg, jq, tcfg, tq = _quantized_pair(preset)
    rng = np.random.default_rng(8)
    L, NB, Bk, b, MB, K = jcfg.n_layers, 12, 4, 3, 4, 4
    qk, qv, sk, sv = _int8_pools(rng, L, NB, Bk, jcfg.n_kv_heads, jcfg.head_dim)
    scales = np.stack([sk, sv])
    tables = rng.permutation(NB)[: b * MB].reshape(b, MB).astype(np.int32)
    lengths = np.asarray([5, 0, 9], np.int32)
    active = np.asarray([True, True, False])
    tokens = rng.integers(0, jcfg.vocab_size, (b,)).astype(np.int32)
    temps = np.zeros((b,), np.float32)

    def j_greedy(logits, temps, key):
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)

    def t_greedy(logits, temps, gen):
        return logits.argmax(dim=-1).to(torch.int32)

    want_toks, want_last, want_pool, want_sc, _rng = JT.decode_chunk_paged(
        jq, jcfg, jnp.asarray(tokens), JT.KVCache(jnp.asarray(qk), jnp.asarray(qv), jnp.asarray(lengths)),
        jnp.asarray(scales), jnp.asarray(tables), jnp.asarray(active), jnp.asarray(temps),
        jax.random.PRNGKey(0), n_steps=K, sample_fn=j_greedy, block=Bk,
    )
    pool = TT.KVCache(_t(qk.copy()), _t(qv.copy()), _t(lengths.copy()))
    ts = _t(scales.copy())
    got_toks, got_last, got_pool = TT.decode_chunk_paged(
        tq, tcfg, _t(tokens), pool, _t(tables), _t(active), _t(temps), None,
        n_steps=K, sample_fn=t_greedy, block=Bk, scales=ts,
    )
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))
    np.testing.assert_array_equal(got_last.numpy(), np.asarray(want_last))
    np.testing.assert_array_equal(got_pool.length.numpy(), np.asarray(want_pool.length))
    assert got_pool.k.dtype == torch.int8
    # the chunk's rows were quantized at the scatter: compare dequantized
    # rows (a code may move by one where the two frameworks' f32 rows round
    # on either side of a .5 step)
    for c, (got_q, want_q) in enumerate(((got_pool.k, want_pool.k), (got_pool.v, want_pool.v))):
        got_f = dequantize_rows(got_q, ts[c], torch.float32).numpy()
        want_f = np.asarray(JP.dequantize_rows(want_q, want_sc[c], jnp.float32))
        np.testing.assert_allclose(got_f, want_f, atol=ATOL + float(np.asarray(want_sc).max()), rtol=0)
        assert np.abs(got_q.numpy().astype(np.int32) - np.asarray(want_q).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(ts.numpy(), np.asarray(want_sc), rtol=1e-5, atol=0)
    # the inactive slot's rows and scales were never written
    blk = tables[2]
    np.testing.assert_array_equal(got_pool.k.numpy()[:, blk], qk[:, blk])
    np.testing.assert_array_equal(ts.numpy()[:, :, blk], scales[:, :, blk])


# ---------------------------------------------------------------------------
# Sizing and the engine
# ---------------------------------------------------------------------------


def test_cache_manager_int8_sizing_matches_reference():
    for kv_int8 in (False, True):
        jkv = JCacheManager(
            JT.TransformerConfig.tiny(), 4, 64, 8, append_widths=(8, 16), paged=True, block=16, kv_int8=kv_int8,
        )
        kv = CacheManager(TT.TransformerConfig.tiny(), 4, 64, 8, append_widths=(8, 16), block=16, kv_int8=kv_int8)
        assert kv.block_bytes == jkv.block_bytes
        assert kv.stats()["int8"] is kv_int8 and kv.stats()["block_bytes"] == kv.block_bytes
        pool, scales = kv.pool_tensors("cpu")
        assert pool.k.dtype == (torch.int8 if kv_int8 else torch.float32)
        if kv_int8:
            assert scales.shape == (2, 2, 16, 16, 2) and scales.dtype == torch.float32
            assert not scales.any()
        else:
            assert scales is None


MODES = {
    "kv_int8": dict(kv_int8=True),
    "quantize": dict(quantize=True),
    "both": dict(kv_int8=True, quantize=True),
}


@pytest.fixture(scope="module", params=list(MODES))
def int8_engines(request):
    mode = MODES[request.param]
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    # untied random head: the tied tiny model repeats its input token
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    tcfg = TT.TransformerConfig.tiny()
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, **mode, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", **mode, **ENGINE_KW)
    yield mode, ref, port
    ref.close()
    port.close()


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).tolist() for n in lengths]


def test_int8_engine_greedy_identity_one_at_a_time(int8_engines):
    mode, ref, port = int8_engines
    st = port.stats()
    assert st["quantized"] is bool(mode.get("quantize")) and st["kvcache"]["int8"] is bool(mode.get("kv_int8"))
    assert TQ.is_quantized(port.params) is bool(mode.get("quantize"))
    # straddle one block (16) and one chunk boundary
    for prompt in _prompts(7, (3, 17, 33)):
        want = ref.generate(prompt, max_new_tokens=8)
        assert port.generate(prompt, max_new_tokens=8) == want
        assert len(set(want)) > 1  # a real stream, not one repeated token


def test_int8_engine_greedy_identity_concurrent(int8_engines):
    """More requests than slots, 19 new tokens each: prefill chunks share
    unified steps with decode chunks, then pure decode chunks run."""
    _mode, ref, port = int8_engines
    prompts = _prompts(11, (3, 17, 33, 9, 40, 16))
    jreqs = [ref.submit(JRequest(p, max_new_tokens=19 if i % 2 else 8)) for i, p in enumerate(prompts)]
    treqs = [port.submit(GenRequest(p, max_new_tokens=19 if i % 2 else 8)) for i, p in enumerate(prompts)]
    for j, t in zip(jreqs, treqs):
        assert t.tokens() == j.tokens()
        assert t.finish_reason == "length"
    st = port.stats()
    assert st["kvcache"]["blocks_in_use"] == 0 and st["kvcache"]["reserved"] == 0
