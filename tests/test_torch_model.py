"""gofr_tpu_torch.models.transformer against gofr_tpu.models.transformer on
the same weights and inputs (CPU, f32 tiny presets, atol 1e-4: the two
frameworks sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import transformer as JT
from gofr_tpu_torch.models import transformer as TT

ATOL = 1e-4
PRESETS = ["tiny", "tiny_llama"]


def _pair(preset: str, seed: int = 0, untied: bool = True):
    """(jax cfg, jax params, port cfg, port params). An untied random
    unembed keeps greedy tokens from collapsing onto the input token (the
    tied tiny model repeats one token), so token comparisons mean
    something."""
    jcfg = getattr(JT.TransformerConfig, preset)()
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    if untied:
        jp = dict(jp, unembed=jax.random.normal(
            jax.random.PRNGKey(seed + 100), (jcfg.vocab_size, jcfg.d_model), jnp.float32
        ))
    tcfg = getattr(TT.TransformerConfig, preset)()
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("preset", PRESETS)
def test_params_from_jax(preset):
    jcfg, jp, tcfg, tp = _pair(preset, untied=False)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(tp["layers"]) + 2
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t = tp
        for k in keys:
            t = t[k]
        assert t.dtype == tcfg.dtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("preset", PRESETS)
def test_init_params_shapes_match_reference(preset):
    jcfg = getattr(JT.TransformerConfig, preset)()
    tcfg = getattr(TT.TransformerConfig, preset)()
    jshapes = jax.tree.map(lambda a: tuple(a.shape), JT.init_params(jax.random.PRNGKey(0), jcfg))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == jshapes


def test_default_device_requires_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_params(TT.TransformerConfig.tiny())


@pytest.mark.parametrize("preset", PRESETS)
def test_transformer_forward(preset):
    jcfg, jp, tcfg, tp = _pair(preset)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    want, _ = JT.transformer_forward(jp, jcfg, jnp.asarray(tokens), jnp.asarray(pos))
    got = TT.transformer_forward(tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    last = np.asarray([11, 4], np.int32)
    want_l, _ = JT.transformer_forward(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(pos), unembed_positions=jnp.asarray(last)
    )
    got_l = TT.transformer_forward(
        tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(pos),
        unembed_positions=torch.from_numpy(last),
    )
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=ATOL, rtol=0)


# c=8 runs attention through the flash wrapper, c=5 through the einsum path
@pytest.mark.parametrize("c", [8, 5])
@pytest.mark.parametrize("preset", PRESETS)
def test_prefill_append(preset, c):
    jcfg, jp, tcfg, tp = _pair(preset)
    rng = np.random.default_rng(2)
    L, b, cap = jcfg.n_layers, 3, 32
    shape = (L, b, cap, jcfg.n_kv_heads, jcfg.head_dim)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
    cursors = np.asarray([0, 7, 20], np.int32)
    n_new = np.asarray([c, 3, 0], np.int32)
    want_logits, want = JT.prefill_append(
        jp, jcfg, jnp.asarray(tokens),
        JT.KVCache(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(cursors)),
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
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))


@pytest.mark.parametrize("preset", PRESETS)
def test_decode_chunk_paged(preset):
    jcfg, jp, tcfg, tp = _pair(preset)
    rng = np.random.default_rng(3)
    L, NB, Bk, b, MB, K = jcfg.n_layers, 12, 4, 3, 4, 4
    shape = (L, NB, Bk, jcfg.n_kv_heads, jcfg.head_dim)
    pk = rng.normal(size=shape).astype(np.float32)
    pv = rng.normal(size=shape).astype(np.float32)
    tables = rng.permutation(NB)[: b * MB].reshape(b, MB).astype(np.int32)
    lengths = np.asarray([5, 0, 9], np.int32)
    active = np.asarray([True, True, False])
    tokens = rng.integers(0, jcfg.vocab_size, (b,)).astype(np.int32)
    temps = np.zeros((b,), np.float32)

    def j_greedy(logits, temps, key):
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)

    def t_greedy(logits, temps, gen):
        return logits.argmax(dim=-1).to(torch.int32)

    want_toks, want_last, want_pool, _sc, _rng = JT.decode_chunk_paged(
        jp, jcfg, jnp.asarray(tokens),
        JT.KVCache(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(lengths)),
        None, jnp.asarray(tables), jnp.asarray(active), jnp.asarray(temps),
        jax.random.PRNGKey(0), n_steps=K, sample_fn=j_greedy, block=Bk,
    )
    pool = TT.KVCache(
        torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()), torch.from_numpy(lengths.copy())
    )
    got_toks, got_last, got_pool = TT.decode_chunk_paged(
        tp, tcfg, torch.from_numpy(tokens), pool, torch.from_numpy(tables),
        torch.from_numpy(active), torch.from_numpy(temps), None,
        n_steps=K, sample_fn=t_greedy, block=Bk,
    )
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))
    np.testing.assert_array_equal(got_last.numpy(), np.asarray(want_last))
    np.testing.assert_array_equal(got_pool.length.numpy(), np.asarray(want_pool.length))
    np.testing.assert_allclose(got_pool.k.numpy(), np.asarray(want_pool.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_pool.v.numpy(), np.asarray(want_pool.v), atol=ATOL, rtol=0)
    # the inactive slot's rows were never written
    blk = tables[2]
    np.testing.assert_array_equal(got_pool.k.numpy()[:, blk], pk[:, blk])
