"""Gemma-family decoder-only transformer (counterpart of
gofr_tpu/models/transformer.py).

Parameters are a plain dictionary of tensors with the JAX package's
layout: ``embed`` [vocab, d], ``final_norm`` [d] and ``layers`` holding
every layer weight stacked on a leading [n_layers] axis (``wkv`` packs
heads outermost, [hkv, 2, hd] per output column block). The layer stack
is a Python loop over that axis; PyTorch runs it eagerly.

Conventions kept from the reference: RMSNorm as (1 + scale) with f32
variance, embeddings scaled by sqrt(d_model) computed in f32 and cast to
the model dtype before the multiply, GeGLU with the tanh-approximate GELU
(``jax.nn.gelu``'s default), split-halves RoPE, GQA, optional soft-caps,
tied embeddings (an ``unembed`` leaf wins when present), logits rounded
to the model dtype by the unembed product and returned as f32.

Weights may be int8 (``models.quant.QTensor`` leaves): as in the JAX
package, prefill chunks and the full-prompt forward run W8A8 products
(``qmm_a8``) and the decode chunk weight-only ones (``qmm``); plain
tensors take a plain ``x @ w`` either way.

Serving entry points: ``prefill_append`` (one chunked-prefill append into
a gathered per-slot view, write-then-attend through ``flash_attention``)
and ``decode_chunk_paged`` (fused decode steps reading the paged pool,
bf16/f32 or int8, through ``paged_decode_partials``).
``transformer_forward`` is the plain oracle: dense causal attention
through ``mha_reference``, no kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops import (
    apply_rope,
    chunk_prefill_attention,
    mha_reference,
    paged_chunk_decode_attention,
    rms_norm,
)
from .quant import QTensor, qmm, qmm_a8


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256_000
    d_model: int = 2048
    n_layers: int = 18
    n_heads: int = 8
    n_kv_heads: int = 1
    head_dim: int = 256
    d_ff: int = 16_384
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    attn_logit_cap: float = 0.0  # gemma-2 style soft-capping; 0 disables
    final_logit_cap: float = 0.0
    act: str = "gelu"  # MLP gate activation: "gelu" (Gemma) | "silu" (Llama)
    scale_embed: bool = True  # multiply embeddings by sqrt(d_model) (Gemma)
    sliding_window: int = 0  # local attention window; 0 = global
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def gemma_2b() -> "TransformerConfig":
        return TransformerConfig()

    @staticmethod
    def tiny_llama(vocab_size: int = 512) -> "TransformerConfig":
        """CI-sized Llama-style config (silu, no embed scale)."""
        return TransformerConfig(
            vocab_size=vocab_size, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, rope_theta=500_000.0,
            norm_eps=1e-5, act="silu", scale_embed=False, dtype=torch.float32,
        )

    @staticmethod
    def tiny(vocab_size: int = 512) -> "TransformerConfig":
        """CI-sized model: runs the identical code path on the CPU in ms."""
        return TransformerConfig(
            vocab_size=vocab_size, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, dtype=torch.float32,
        )


class KVCache(NamedTuple):
    """K/V with a per-sequence length. Slot views are [L, b, capacity,
    hkv, hd]; the paged pool is [L, n_blocks, block, hkv, hd] with
    ``length`` holding each engine slot's valid rows."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # [b] int32


def init_params(cfg: TransformerConfig, generator: torch.Generator | None = None, device=None) -> dict:
    """Random weights from ``generator`` (same shapes and scaling as the
    JAX init: normal / sqrt(fan_in), norms zero), made on ``device``
    (``cuda`` by default). The generator must live on that device."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, hd, hq, hkv, ff, L = (
        cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.n_layers,
    )

    def w(shape, fan_in):
        t = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (t / math.sqrt(fan_in)).to(cfg.dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    return {
        "embed": w((cfg.vocab_size, d), d),
        "final_norm": zeros((d,)),
        "layers": {
            "attn_norm": zeros((L, d)),
            "wq": w((L, d, hq * hd), d),
            "wkv": w((L, d, 2 * hkv * hd), d),
            "wo": w((L, hq * hd, d), hq * hd),
            "mlp_norm": zeros((L, d)),
            "w_gate": w((L, d, ff), d),
            "w_up": w((L, d, ff), d),
            "w_down": w((L, ff, d), ff),
        },
    }


def params_from_jax(np_tree: dict, cfg: TransformerConfig, device=None) -> dict:
    """The JAX parameter pytree, mapped to numpy (``jax.tree.map(np.asarray,
    params)``), as the port's parameter dictionary on ``device``. Same keys
    and layouts. Plain leaves become ``cfg.dtype``; bfloat16 arrays pass
    through float32, which is exact. A quantized tree's ``QTensor(q, s)``
    leaves (any NamedTuple with fields ``q`` and ``s``) become the port's
    ``QTensor``: ``q`` stays int8, ``s`` goes to ``cfg.dtype``."""
    import numpy as np

    dev = resolve_device(device)

    def real(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=cfg.dtype)

    def conv(a):
        if isinstance(a, dict):
            return {key: conv(val) for key, val in a.items()}
        if getattr(a, "_fields", None) == ("q", "s"):
            q = np.asarray(a.q)
            if q.dtype != np.int8:
                raise TypeError(f"quantized leaf has q of dtype {q.dtype}, expected int8")
            return QTensor(q=torch.from_numpy(q.copy()).to(dev), s=real(a.s))
        return real(a)

    return conv(np_tree)


def _layer(params: dict, i: int) -> dict:
    """One layer's weights (views along the stacked leading axis)."""
    return {
        name: QTensor(w.q[i], w.s[i]) if isinstance(w, QTensor) else w[i]
        for name, w in params["layers"].items()
    }


def _act(cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if cfg.act == "silu":
        return F.silu(x)
    raise ValueError(f"unknown activation {cfg.act!r}; expected 'gelu' or 'silu'")


def _mlp(cfg: TransformerConfig, h: torch.Tensor, lp: dict, mm) -> torch.Tensor:
    """Dense gated MLP; the caller adds the residual. ``mm`` is the
    product (``qmm`` or ``qmm_a8``)."""
    return mm(_act(cfg, mm(h, lp["w_gate"])) * mm(h, lp["w_up"]), lp["w_down"])


def _qkv(cfg: TransformerConfig, h: torch.Tensor, lp: dict, positions: torch.Tensor, mm):
    """Projections + RoPE: q [b, s, hq, hd], k/v [b, s, hkv, hd]."""
    b, s, _ = h.shape
    q = mm(h, lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    kv = mm(h, lp["wkv"]).reshape(b, s, cfg.n_kv_heads, 2, cfg.head_dim)
    k, v = kv[:, :, :, 0], kv[:, :, :, 1]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def _attn_out(cfg, x, attn, lp, mm):
    b, s = attn.shape[:2]
    return x + mm(attn.reshape(b, s, cfg.n_heads * cfg.head_dim), lp["wo"]).to(x.dtype)


def _layer_body(cfg: TransformerConfig, x: torch.Tensor, lp: dict, positions: torch.Tensor):
    """One decoder layer on a full prompt (the JAX prefill branch, W8A8
    for int8 weights): returns (x, k, v). Dense causal attention via
    mha_reference."""
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, h, lp, positions, qmm_a8)
    attn = mha_reference(
        q, k, v, causal=True, logit_cap=cfg.attn_logit_cap, window=cfg.sliding_window,
    )
    x = _attn_out(cfg, x, attn, lp, qmm_a8)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _mlp(cfg, h, lp, qmm_a8), k, v


def _embed_tokens(params: dict, cfg: TransformerConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding gather + Gemma sqrt(d) scaling: the scale is computed in
    f32, cast to the model dtype (45.25 in bf16 for d=2048), and the
    multiply runs in that dtype. An int8 embedding gathers int8 rows and
    applies its per-d-column scale in the model dtype."""
    emb = params["embed"]
    if isinstance(emb, QTensor):
        x = emb.q[tokens.long()].to(cfg.dtype) * emb.s.to(cfg.dtype)
    else:
        x = emb[tokens.long()].to(cfg.dtype)
    if not cfg.scale_embed:
        return x
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32)).to(cfg.dtype)
    return x * scale.to(x.device)


def _unembed(params: dict, cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    """[b, s, d] -> [b, s, vocab] f32 logits (tied unless an ``unembed``
    leaf is present); the product runs in the model dtype. An int8 table
    folds its d-column scale into the activations: (x * s) @ q.T."""
    emb = params.get("unembed", params["embed"])
    if isinstance(emb, QTensor):
        logits = ((x * emb.s.to(cfg.dtype)) @ emb.q.T.to(cfg.dtype)).float()
    else:
        logits = (x @ emb.T.to(cfg.dtype)).float()
    if cfg.final_logit_cap > 0.0:
        logits = cfg.final_logit_cap * torch.tanh(logits / cfg.final_logit_cap)
    return logits


def _unembed_last(params: dict, cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    """final norm + unembed for a [b, 1, d] tail -> [b, vocab]."""
    return _unembed(params, cfg, rms_norm(x, params["final_norm"], cfg.norm_eps))[:, 0]


@torch.no_grad()
def transformer_forward(
    params: dict,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [b, s] int
    positions: torch.Tensor,  # [b, s] int
    *,
    unembed_positions: torch.Tensor | None = None,  # [b] -> logits only there
) -> torch.Tensor:
    """Full-prompt forward, no cache: f32 logits [b, s, vocab], or
    [b, 1, vocab] when ``unembed_positions`` is given. The port's plain
    oracle — it reaches no kernel (int8 weights run W8A8, as the JAX
    prefill branch does)."""
    x = _embed_tokens(params, cfg, tokens)
    for i in range(cfg.n_layers):
        x, _k, _v = _layer_body(cfg, x, _layer(params, i), positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if unembed_positions is not None:
        idx = unembed_positions.long()[:, None, None].expand(-1, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    return _unembed(params, cfg, x)


def _write_chunk_rows(cache_l, rows, cursors, n_new) -> None:
    """cache_l[b, cursors[b] + i] = rows[b, i] for i < n_new[b], IN PLACE
    (the JAX code's masked scatter; the gathered slot view is a private
    tensor, so writing it saves a copy). Lanes i >= n_new and positions
    past the capacity write nothing. Computed as a gather + select over
    the whole view, which needs no host sync."""
    b, cap, hkv, hd = cache_l.shape
    c = rows.shape[1]
    p = torch.arange(cap, device=cache_l.device)[None, :]
    j = p - cursors.long()[:, None]  # chunk row landing at position p
    sel = (j >= 0) & (j < n_new.long()[:, None])
    src = torch.gather(rows, 1, j.clamp(0, c - 1)[..., None, None].expand(b, cap, hkv, hd))
    torch.where(sel[..., None, None], src.to(cache_l.dtype), cache_l, out=cache_l)


def _append_forward(params, cfg, tokens, cache: KVCache, cursors, n_new):
    """Shared write-then-attend chunk append: write the chunk's K/V rows at
    each row's cursor, attend over all resident keys + the chunk's causal
    triangle, return the final hidden states [b, c, d] and the (k, v)
    stacks, which are ``cache``'s own tensors updated in place. The chunk's
    own rows are written unquantized; int8 weights run W8A8."""
    b, c = tokens.shape
    positions = cursors.long()[:, None] + torch.arange(c, device=tokens.device)[None, :]
    x = _embed_tokens(params, cfg, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        kc, vc = cache.k[i], cache.v[i]  # [b, capacity, hkv, hd]
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k_new, v_new = _qkv(cfg, h, lp, positions, qmm_a8)
        _write_chunk_rows(kc, k_new, cursors, n_new)
        _write_chunk_rows(vc, v_new, cursors, n_new)
        attn = chunk_prefill_attention(
            q.contiguous(), kc, vc, cursors.to(torch.int32),
            logit_cap=cfg.attn_logit_cap, window=cfg.sliding_window,
        )
        x = _attn_out(cfg, x, attn, lp, qmm_a8)
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(cfg, h, lp, qmm_a8)
    return x, (cache.k, cache.v)


@torch.no_grad()
def prefill_append(
    params: dict,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [b, c] — one prefill chunk per sequence
    cache: KVCache,  # [L, b, capacity, hkv, hd] slot rows (gathered)
    cursors: torch.Tensor,  # [b] int32 — prompt tokens already resident
    n_new: torch.Tensor,  # [b] int32 — valid tokens in this chunk (<= c)
) -> tuple[torch.Tensor, KVCache]:
    """Append one prefill chunk into a per-slot KV view (the chunked-prefill
    half of the engine's unified step). Rows i >= n_new write nothing.
    Returns (last-valid-token logits [b, vocab] f32, the cache with its
    k/v written in place and length = cursors + n_new). Rows with
    n_new == 0 return garbage logits."""
    b, c = tokens.shape
    x, (ks, vs) = _append_forward(params, cfg, tokens, cache, cursors, n_new)
    last = torch.clamp(n_new.long() - 1, 0, c - 1)
    x_last = torch.gather(x, 1, last[:, None, None].expand(-1, 1, x.shape[-1]))
    logits = _unembed_last(params, cfg, x_last)
    return logits, KVCache(k=ks, v=vs, length=(cursors + n_new).to(torch.int32))


@torch.no_grad()
def decode_chunk_paged(
    params: dict,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [b] last sampled token per sequence
    pool: KVCache,  # k/v [L, NB, B, hkv, hd] block pool; length [b] int32
    tables: torch.Tensor,  # [b, MB] int32 — logical block -> pool block
    active: torch.Tensor,  # [b] bool — only active slots advance/write
    temps: torch.Tensor,  # [b] f32 sampling temperatures
    generator: torch.Generator | None,
    *,
    n_steps: int,
    sample_fn,  # (logits [b, vocab] f32, temps [b], generator) -> tokens [b]
    block: int,
    scales: torch.Tensor | None = None,  # [2, L, NB, B, hkv] f32 (int8 pool)
) -> tuple[torch.Tensor, torch.Tensor, KVCache]:
    """``n_steps`` fused decode steps against the BLOCK-PAGED pool.

    The pool is read-only inside the chunk: each step writes its new K/V
    at the uniform position ``step`` of a small [L, b, n_steps, hkv, hd]
    buffer, and attention reads the pool through the block table
    (``paged_chunk_decode_attention``: kernel partials merged with the
    buffer region). At chunk end the buffer rows scatter through the
    tables at positions [length, length + n_steps) for ``active`` slots
    only; write indices derive from the DEVICE lengths. The pool tensors
    and ``pool.length`` are updated IN PLACE (the JAX program donates and
    rebuilds them; writing in place saves a copy of the whole pool).

    An int8 pool passes its ``scales``: each layer's attention reads
    ``scales[0, i]`` / ``scales[1, i]``, the buffer rows stay in the model
    dtype, and they are quantized at the chunk-end scatter (scales updated
    in place). int8 weights run weight-only products (``qmm``).

    Returns (tokens [n_steps, b] int32, last [b] int32, pool)."""
    from ..kvcache.paged import scatter_rows

    L, b = cfg.n_layers, tokens.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    K = n_steps
    dev = tokens.device
    # the chunk buffer is written in place at step k_i (JAX:
    # dynamic_update_slice into a carried buffer)
    kb = torch.zeros((L, b, K, hkv, hd), dtype=cfg.dtype, device=dev)
    vb = torch.zeros((L, b, K, hkv, hd), dtype=cfg.dtype, device=dev)
    lengths = pool.length
    tok = tokens
    out = []
    for k_i in range(K):
        positions = (lengths.long() + k_i)[:, None]  # [b, 1]
        x = _embed_tokens(params, cfg, tok[:, None])
        for i in range(L):
            lp = _layer(params, i)
            h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            q, k_new, v_new = _qkv(cfg, h, lp, positions, qmm)
            kb[i, :, k_i] = k_new[:, 0]
            vb[i, :, k_i] = v_new[:, 0]
            attn = paged_chunk_decode_attention(
                q, pool.k[i], pool.v[i], tables, kb[i], vb[i], lengths, k_i,
                logit_cap=cfg.attn_logit_cap, window=cfg.sliding_window,
                k_scales=None if scales is None else scales[0, i],
                v_scales=None if scales is None else scales[1, i],
            )
            x = _attn_out(cfg, x, attn, lp, qmm)
            h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + _mlp(cfg, h, lp, qmm)
        logits = _unembed_last(params, cfg, x)
        tok = sample_fn(logits, temps, generator).to(torch.int32)
        out.append(tok)

    # merge: the chunk's K rows scatter through the table at positions
    # [length, length + K) — private blocks by the engine's construction
    cap = tables.shape[1] * block
    pos = lengths[:, None].long() + torch.arange(K, device=dev)[None, :]
    valid = active[:, None] & (pos < cap)
    scatter_rows(pool.k, pool.v, tables, kb, vb, pos, valid, scales=scales)
    new_len = torch.where(active, torch.clamp(lengths + K, max=cap), lengths)
    lengths.copy_(new_len.to(lengths.dtype))
    return torch.stack(out), tok, pool
