"""Decoder-only transformer of the Gemma, Llama, Mistral and Qwen2
families and its mixture-of-experts variant (counterpart of
gofr_tpu/models/transformer.py; presets ``gemma_2b``, ``gemma_7b``,
``llama3_8b``, ``mistral_7b``, ``qwen2_7b``, the tiny CI twins and
``tiny_moe``, field for field the JAX ones).

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
to the model dtype by the unembed product and returned as f32; SwiGLU
(``act="silu"``) and no embedding scale for the Llama-shaped families,
a sliding window (Mistral) in every attention mask, and a bias on the
q/k/v projections (Qwen2, ``qkv_bias``) added in ``_qkv``.

Mixture of experts (``n_experts`` > 0): each layer carries a router
``w_router`` [L, d, E] and expert stacks ``w_gate`` / ``w_up`` [L, E, d,
ff] and ``w_down`` [L, E, ff, d] in place of the dense MLP, and ``_mlp``,
the one MLP site of every program, routes each call's rows through
``models.moe.moe_mlp`` (top ``moe_top_k`` of E, capacity factor
``moe_capacity`` over the call's whole row count, padding included).
LoRA adapts the attention projections only there (``lora.target_dims``
skips the 4-D stacks).

Multi-tenant LoRA (``lora``): a layer that carries stacked adapter tables
``lora_<name>_a`` [G, d_in, r] / ``lora_<name>_b`` [G, r, d_out] (sliced
from [L, G, ...]) adds a per-row delta (h @ A[gid]) @ B[gid] to each of
its six projections, computed in float32 and added in the output dtype
(``_lora_mm``). Every entry point takes ``aids`` [b], the rows' adapter
ids (gid 0: the all-zero identity); without tables or ``aids`` no op is
added.

Weights may be int8 (``models.quant.QTensor`` leaves): as in the JAX
package, prefill chunks and the full-prompt forward run W8A8 products
(``qmm_a8``) and the decode chunk weight-only ones (``qmm``); plain
tensors take a plain ``x @ w`` either way.

Serving entry points: ``prefill`` (whole right-padded prompts in one
pass, the wave scheduler's program: flash in its full-prompt mode, the
model's window as the band), ``prefill_append`` (one chunked-prefill append into
a gathered per-slot view, write-then-attend through ``flash_attention``,
or on a rolling ring through the plain ring masks), ``verify_chunk`` (the
same append, every position unembedded: a speculative draft's scores),
``decode_chunk_paged`` (fused decode steps reading the paged pool,
bf16/f32 or int8, through ``paged_decode_partials``) and ``decode_chunk``
(the same steps over a contiguous dense slab or rolling ring, plain
attention as in JAX). W8A8 products for int8 weights in both appends.
``transformer_forward`` is the plain oracle: dense causal attention
through ``mha_reference``, no kernels. ``train_forward`` is the same
forward with a gradient, attending through the flash kernel's
differentiable full-prompt mode (``ops.flash_attention_train``); the
training step (``parallel.train``) differentiates it.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops import (
    apply_rope,
    chunk_decode_attention,
    chunk_prefill_attention,
    flash_attention,
    flash_attention_train,
    mha_reference,
    paged_chunk_decode_attention,
    rms_norm,
)
from .moe import moe_mlp
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
    sliding_window: int = 0  # Mistral-style local attention window; 0 = global
    qkv_bias: bool = False  # Qwen2-style bias on the q/k/v projections
    # mixture of experts (0 = dense): routed top-k over n_experts expert
    # MLPs in every layer (models.moe); attention is unchanged
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity: float = 1.25
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def gemma_2b() -> "TransformerConfig":
        return TransformerConfig()

    @staticmethod
    def gemma_7b() -> "TransformerConfig":
        """Gemma-7B: multi-head attention (16 query and 16 KV heads) at
        head_dim 256, tied embeddings."""
        return TransformerConfig(d_model=3072, n_layers=28, n_heads=16, n_kv_heads=16, d_ff=24_576)

    @staticmethod
    def llama3_8b() -> "TransformerConfig":
        """Llama-3-8B: SwiGLU MLP, GQA 32/8, untied lm_head (the loader adds
        an ``unembed`` leaf), plain RMSNorm (the loader stores HF's scale
        minus 1 so the shared (1 + scale) norm is exact), no embedding
        scaling, rope theta 500k."""
        return TransformerConfig(
            vocab_size=128_256, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, head_dim=128, d_ff=14_336, rope_theta=500_000.0,
            norm_eps=1e-5, act="silu", scale_embed=False,
        )

    @staticmethod
    def mistral_7b() -> "TransformerConfig":
        """Mistral-7B-v0.1: Llama-shaped (SwiGLU, GQA 32/8, untied head, no
        embed scaling) plus a 4096-token sliding attention window."""
        return TransformerConfig(
            vocab_size=32_000, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, head_dim=128, d_ff=14_336, rope_theta=10_000.0,
            norm_eps=1e-5, act="silu", scale_embed=False,
            sliding_window=4096,
        )

    @staticmethod
    def tiny_mistral(vocab_size: int = 512) -> "TransformerConfig":
        """CI-sized Mistral-style config: window 8, so sequences past 8
        tokens exercise the band mask."""
        return TransformerConfig(
            vocab_size=vocab_size, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, rope_theta=10_000.0,
            norm_eps=1e-5, act="silu", scale_embed=False,
            sliding_window=8, dtype=torch.float32,
        )

    @staticmethod
    def qwen2_7b() -> "TransformerConfig":
        """Qwen2-7B: Llama-shaped (SwiGLU, GQA 28/4, a group of 7, untied
        head, no embed scaling) plus bias on the q/k/v projections."""
        return TransformerConfig(
            vocab_size=152_064, d_model=3584, n_layers=28, n_heads=28,
            n_kv_heads=4, head_dim=128, d_ff=18_944, rope_theta=1_000_000.0,
            norm_eps=1e-6, act="silu", scale_embed=False, qkv_bias=True,
        )

    @staticmethod
    def tiny_qwen2(vocab_size: int = 512) -> "TransformerConfig":
        """CI-sized Qwen2-style config (silu, qkv bias, no embed scale)."""
        return TransformerConfig(
            vocab_size=vocab_size, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, rope_theta=1_000_000.0,
            norm_eps=1e-6, act="silu", scale_embed=False, qkv_bias=True,
            dtype=torch.float32,
        )

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

    @staticmethod
    def tiny_moe(vocab_size: int = 512) -> "TransformerConfig":
        """CI-sized sparse config: 4 experts, top-2 routing (GeGLU, embed
        scaling, float32, as ``tiny``)."""
        return TransformerConfig(
            vocab_size=vocab_size, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, dtype=torch.float32,
            n_experts=4, moe_top_k=2,
        )


class KVCache(NamedTuple):
    """K/V with a per-sequence length. Slot views are [L, b, capacity,
    hkv, hd]; the paged pool is [L, n_blocks, block, hkv, hd] with
    ``length`` holding each engine slot's valid rows."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # [b] int32


def param_specs(cfg: TransformerConfig) -> dict:
    """The parameter tree's leaves as (shape, fan_in): normal / sqrt(fan_in)
    weights, or zeros where fan_in is None (the norms). ``init_params``
    draws them in this order; ``checkpoint.validate_params`` reads the
    shapes, so the two cannot drift apart. A qkv-bias config adds ``bq``
    [L, hq * hd] and ``bkv`` [L, 2 * hkv * hd] (random, as in JAX, so the
    bias add is load-bearing in tests), drawn last. An MoE config has
    ``w_router`` [L, d, E] and [L, E, ...] expert stacks in place of the
    dense MLP leaves (JAX ``init_params``)."""
    d, hd, hq, hkv, ff, L = (
        cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.n_layers,
    )
    E = cfg.n_experts
    if E > 0:
        mlp = {
            "w_router": ((L, d, E), d),
            "w_gate": ((L, E, d, ff), d),
            "w_up": ((L, E, d, ff), d),
            "w_down": ((L, E, ff, d), ff),
        }
    else:
        mlp = {"w_gate": ((L, d, ff), d), "w_up": ((L, d, ff), d), "w_down": ((L, ff, d), ff)}
    layers = {
        "attn_norm": ((L, d), None),
        "wq": ((L, d, hq * hd), d),
        "wkv": ((L, d, 2 * hkv * hd), d),
        "wo": ((L, hq * hd, d), hq * hd),
        "mlp_norm": ((L, d), None),
        **mlp,
    }
    if cfg.qkv_bias:
        layers["bq"] = ((L, hq * hd), d)
        layers["bkv"] = ((L, 2 * hkv * hd), d)
    return {"embed": ((cfg.vocab_size, d), d), "final_norm": ((d,), None), "layers": layers}


def init_params(cfg: TransformerConfig, generator: torch.Generator | None = None, device=None) -> dict:
    """Random weights from ``generator`` (same shapes and scaling as the
    JAX init: normal / sqrt(fan_in), norms zero; ``param_specs``), made on
    ``device`` (``cuda`` by default). The generator must live on that
    device."""
    return draw_params(param_specs(cfg), cfg.dtype, generator, device)


def draw_params(specs: dict, dtype: torch.dtype, generator: torch.Generator | None = None, device=None) -> dict:
    """A tree of ``specs``' (shape, fan_in) leaves drawn in order: normal /
    sqrt(fan_in) in float32 cast to ``dtype``, zeros where fan_in is None,
    from ``generator`` (seed 0 on ``device`` when None). An expert stack
    (4-D) is drawn one [d_in, d_out] matrix at a time, so its float32 draw
    never exists whole (a 16-layer Mixtral-width ``w_gate`` would be 30
    GB)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def draw(shape, fan_in):
        t = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (t / math.sqrt(fan_in)).to(dtype)

    def make(spec):
        if isinstance(spec, dict):
            return {key: make(val) for key, val in spec.items()}
        shape, fan_in = spec
        if fan_in is None:
            return torch.zeros(shape, dtype=dtype, device=dev)
        if len(shape) < 4:
            return draw(shape, fan_in)
        out = torch.empty(shape, dtype=dtype, device=dev)
        for idx in itertools.product(*map(range, shape[:-2])):
            out[idx] = draw(shape[-2:], fan_in)
        return out

    return make(specs)


def params_from_jax(np_tree: dict, cfg: TransformerConfig, device=None) -> dict:
    """The JAX parameter pytree, mapped to numpy (``jax.tree.map(np.asarray,
    params)``), as the port's parameter dictionary on ``device``. Same keys
    and layouts. Plain leaves become ``cfg.dtype``; bfloat16 arrays pass
    through float32, which is exact. A quantized tree's ``QTensor(q, s)``
    leaves (any NamedTuple with fields ``q`` and ``s``) become the port's
    ``QTensor``: ``q`` stays int8, ``s`` goes to ``cfg.dtype`` (an MoE
    tree's expert stacks keep their [L, E, 1, out] scales; its router is
    never quantized). A LoRA
    engine's tree keeps its adapter tables (``lora_*`` leaves) in float32
    and its per-slot adapter ids (``aids``) in int32."""
    import numpy as np

    dev = resolve_device(device)

    def real(a, dtype=cfg.dtype):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype)

    def conv(a, key=""):
        if isinstance(a, dict):
            return {k: conv(val, k) for k, val in a.items()}
        if getattr(a, "_fields", None) == ("q", "s"):
            q = np.asarray(a.q)
            if q.dtype != np.int8:
                raise TypeError(f"quantized leaf has q of dtype {q.dtype}, expected int8")
            return QTensor(q=torch.from_numpy(q.copy()).to(dev), s=real(a.s))
        if key == "aids":
            return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)
        return real(a, torch.float32 if key.startswith("lora_") else cfg.dtype)

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


def lora_select(params: dict, aids: torch.Tensor | None) -> torch.Tensor | None:
    """The rows' adapter selector: one-hot [b, G] float32 of ``aids`` [b]
    over the G gids of the layers' LoRA tables, or None when ``params``
    carries no tables or no ``aids`` were passed (no op is added then).
    Made once per program and read by every ``_lora_mm`` in it; an id
    outside [0, G) selects nothing, as gid 0 does."""
    if aids is None:
        return None
    a = next((w for k, w in params["layers"].items() if k.startswith("lora_") and k.endswith("_a")), None)
    if a is None:
        return None
    G = a.shape[1]
    return (aids.long()[:, None] == torch.arange(G, device=aids.device)[None, :]).float()


def _lora_delta(h: torch.Tensor, lp: dict, name: str, sel: torch.Tensor | None) -> torch.Tensor | None:
    """Per-row batched LoRA delta (h @ A[gid]) @ B[gid] in float32 [b, s,
    d_out], or None when this layer carries no tables or ``sel`` is None
    (JAX ``_lora_delta``). ``sel`` is ``lora_select``'s one-hot [b, G].

    The JAX form gathers each row's pair (``take(a, aids)``: a [rows,
    d_in, r] and a [rows, r, d_out] copy a call) and runs two batched
    products. Here the G tables stand side by side: one product [N, d_in]
    @ [d_in, G r] (A's [G, d_in, r] rows laid out so, one copy), each row
    keeps its own gid's columns (the others multiplied by exact zeros),
    and one product [N, G r] @ [G r, d_out] (B as it lies) adds the chosen
    pair's delta and zeros. Batched products with r = 8 output columns
    and a long contraction run on one CTA a batch and were 8x slower on
    an H100 (PERF.md)."""
    a = lp.get("lora_" + name + "_a")
    if a is None or sel is None:
        return None
    b = lp["lora_" + name + "_b"]
    G, d_in, r = a.shape
    rows, s = h.shape[0], h.shape[1]
    t = h.reshape(-1, d_in).float() @ a.permute(1, 0, 2).reshape(d_in, G * r)
    t = (t.view(rows, s, G, r) * sel[:, None, :, None]).view(rows * s, G * r)
    return (t @ b.reshape(G * r, -1)).view(rows, s, -1)


def _lora_mm(mm, h: torch.Tensor, lp: dict, name: str, sel: torch.Tensor | None) -> torch.Tensor:
    """Base projection ``mm(h, lp[name])`` plus the optional per-row
    adapter delta, added in the product's dtype (JAX ``_lora_mm``)."""
    out = mm(h, lp[name])
    d = _lora_delta(h, lp, name, sel)
    return out if d is None else out + d.to(out.dtype)


def _mlp(cfg: TransformerConfig, h: torch.Tensor, lp: dict, mm, sel=None) -> torch.Tensor:
    """Dense gated MLP, or the routed mixture when the layer carries a
    router (JAX ``_mlp_block``); the caller adds the residual. ``mm`` is
    the dense product (``qmm`` or ``qmm_a8``); ``sel`` the LoRA selector.
    The mixture ignores both: its rows, all b * s of them, route as one
    call of ``moe.moe_mlp`` (``moe_ffn`` without the auxiliary loss)."""
    if "w_router" in lp:
        b, s, d = h.shape
        y = moe_mlp(
            h.reshape(b * s, d), lp["w_router"], lp["w_gate"], lp["w_up"], lp["w_down"],
            n_experts=cfg.n_experts, top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity, act=cfg.act,
        )
        return y.reshape(b, s, d).to(h.dtype)
    g = _lora_mm(mm, h, lp, "w_gate", sel)
    u = _lora_mm(mm, h, lp, "w_up", sel)
    return _lora_mm(mm, _act(cfg, g) * u, lp, "w_down", sel)


def _qkv(cfg: TransformerConfig, h: torch.Tensor, lp: dict, positions: torch.Tensor, mm, sel=None):
    """Projections (+ LoRA deltas, + the q/k/v bias) + RoPE: q [b, s, hq,
    hd], k/v [b, s, hkv, hd]. The one bias site: every program (the
    full-prompt forward, both chunk appends, the decode chunk) projects
    through here."""
    b, s, _ = h.shape
    q = _lora_mm(mm, h, lp, "wq", sel)
    kv = _lora_mm(mm, h, lp, "wkv", sel)
    if cfg.qkv_bias:  # Qwen2: the bias rides the flat output, before the reshape
        q = q + lp["bq"].to(q.dtype)
        kv = kv + lp["bkv"].to(kv.dtype)
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    kv = kv.reshape(b, s, cfg.n_kv_heads, 2, cfg.head_dim)
    k, v = kv[:, :, :, 0], kv[:, :, :, 1]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def _attn_out(cfg, x, attn, lp, mm, sel=None):
    b, s = attn.shape[:2]
    return x + _lora_mm(mm, attn.reshape(b, s, cfg.n_heads * cfg.head_dim), lp, "wo", sel).to(x.dtype)


def _layer_body(cfg: TransformerConfig, x: torch.Tensor, lp: dict, positions: torch.Tensor, sel=None):
    """One decoder layer on a full prompt (the JAX prefill branch, W8A8
    for int8 weights): returns (x, k, v). Dense causal attention via
    mha_reference."""
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, h, lp, positions, qmm_a8, sel)
    attn = mha_reference(
        q, k, v, causal=True, logit_cap=cfg.attn_logit_cap, window=cfg.sliding_window,
    )
    x = _attn_out(cfg, x, attn, lp, qmm_a8, sel)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _mlp(cfg, h, lp, qmm_a8, sel), k, v


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
    return x * _embed_scale(cfg)


def _embed_scale(cfg: TransformerConfig) -> float:
    """sqrt(d_model) in f32, rounded to the model dtype, as a Python float:
    a multiply by it runs in the same f32 arithmetic as one by a 0-d
    tensor, and needs no host-to-device copy (a CUDA graph captures it)."""
    scale = torch.sqrt(torch.tensor([float(cfg.d_model)], dtype=torch.float32)).to(cfg.dtype)
    return float(scale.double().numpy()[0])  # a host tensor: no device sync


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
    aids: torch.Tensor | None = None,  # [b] per-row adapter ids (LoRA)
) -> torch.Tensor:
    """Full-prompt forward, no cache: f32 logits [b, s, vocab], or
    [b, 1, vocab] when ``unembed_positions`` is given. The port's plain
    oracle — it reaches no kernel (int8 weights run W8A8, as the JAX
    prefill branch does)."""
    sel = lora_select(params, aids)
    x = _embed_tokens(params, cfg, tokens)
    for i in range(cfg.n_layers):
        x, _k, _v = _layer_body(cfg, x, _layer(params, i), positions, sel)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if unembed_positions is not None:
        idx = unembed_positions.long()[:, None, None].expand(-1, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    return _unembed(params, cfg, x)


def _dense_mm(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return h @ w


def train_forward(
    params: dict,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [b, s] int
    positions: torch.Tensor,  # [b, s] int
    *,
    prefill_attn=None,  # optional (q, k, v) -> attn override
) -> torch.Tensor:
    """Full-prompt forward with a gradient (JAX ``transformer_forward``'s
    no-cache branch, which ``parallel.train.lm_loss`` differentiates): f32
    logits [b, s, vocab]. Attention is ``flash_attention_train`` (causal,
    the model's window and cap): the flash kernel in its full-prompt mode
    on a CUDA tensor, its plain version on the CPU, with the gradient of
    ``flash_attention_backward``. ``prefill_attn`` replaces it, as JAX's
    keyword of that name does. Plain weights only: int8 (``QTensor``)
    weights and LoRA tables are refused, as JAX trains neither."""
    for name, w in itertools.chain(params["layers"].items(), params.items()):
        if isinstance(w, QTensor):
            raise TypeError(f"train_forward: {name!r} is an int8 QTensor; training takes plain weights")
        if name.startswith("lora_"):
            raise ValueError(f"train_forward: {name!r} is a LoRA table; training takes no adapters")
    attend = prefill_attn or (lambda q, k, v: flash_attention_train(
        q, k, v, causal=True, logit_cap=cfg.attn_logit_cap, window=cfg.sliding_window,
    ))
    # one unbind per stacked leaf: its backward stacks the layers' gradients
    # once, where indexing each layer (``_layer``) would add every layer's
    # gradient into a zero-filled copy of the whole stack
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    x = _embed_tokens(params, cfg, tokens)
    for i in range(cfg.n_layers):
        lp = {name: w[i] for name, w in layers.items()}
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, h, lp, positions, _dense_mm)
        x = _attn_out(cfg, x, attend(q.contiguous(), k.contiguous(), v), lp, _dense_mm)
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(cfg, h, lp, _dense_mm)
    return _unembed(params, cfg, rms_norm(x, params["final_norm"], cfg.norm_eps))


@torch.no_grad()
def prefill(
    params: dict,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [b, s] right-padded prompts
    lengths: torch.Tensor,  # [b] int — real tokens of each row
    max_cache_len: int,
) -> tuple[torch.Tensor, KVCache]:
    """Whole prompts in one pass (JAX ``prefill``, the wave scheduler's
    program): last-token f32 logits [b, vocab] and a KVCache [L, b,
    max_cache_len, hkv, hd] in the model dtype holding rows [0, s) at their
    positions (zeros beyond) with length = ``lengths``.

    Attention is ``flash_attention`` in its full-prompt mode (null
    offsets, ``causal``, the model's window as the band): kernel row 2 on
    a CUDA tensor, its plain version on the CPU. The pad rows sit after
    each prompt's real rows, so causal masking alone hides them from every
    real query and no kv_mask is needed (in JAX one would force the
    reference path); the cache's length masks them later. int8 weights
    run W8A8 (``qmm_a8``), as the JAX prefill branch does."""
    b, s = tokens.shape
    if s > max_cache_len:
        raise ValueError(f"prompt width {s} exceeds max_cache_len {max_cache_len}")
    dev = tokens.device
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    shape = (cfg.n_layers, b, max_cache_len, cfg.n_kv_heads, cfg.head_dim)
    ck = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    cv = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    x = _embed_tokens(params, cfg, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, h, lp, positions, qmm_a8)
        ck[i, :, :s] = k
        cv[i, :, :s] = v
        attn = flash_attention(
            q.contiguous(), k.contiguous(), v, causal=True,
            logit_cap=cfg.attn_logit_cap, window=cfg.sliding_window,
        )
        x = _attn_out(cfg, x, attn, lp, qmm_a8)
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(cfg, h, lp, qmm_a8)
    last = (lengths.long() - 1).clamp(0, s - 1)
    x_last = torch.gather(x, 1, last[:, None, None].expand(-1, 1, x.shape[-1]))
    logits = _unembed_last(params, cfg, x_last)
    return logits, KVCache(k=ck, v=cv, length=lengths.to(torch.int32))


def _write_chunk_rows(cache_l, rows, cursors, n_new, ring: int = 0) -> None:
    """cache_l[b, p] = rows[b, i] for i < n_new[b], IN PLACE, at p =
    cursors[b] + i (dense: a row past the capacity writes nothing) or
    (cursors[b] + i) mod ring (the rolling ring): the JAX code's masked
    scatter, whose lanes i >= n_new drop. Only the chunk's c rows a
    sequence are touched, by one ``index_copy_`` with no host sync: within
    a sequence the targets (cursors + i) mod capacity are distinct
    (c <= capacity), and a lane that writes nothing puts back the row it
    read."""
    b, cap, hkv, hd = cache_l.shape
    c = rows.shape[1]
    if c > cap:
        raise ValueError(f"a chunk of {c} rows does not fit a cache of {cap} rows")
    i = torch.arange(c, device=cache_l.device)[None, :]
    pos = cursors.long()[:, None] + i
    sel = i < n_new.long()[:, None]
    if ring <= 0:
        sel = sel & (pos < cap)
    flat = (torch.arange(b, device=cache_l.device)[:, None] * cap + torch.remainder(pos, cap)).reshape(-1)
    view = cache_l.view(b * cap, hkv, hd)
    src = rows.reshape(b * c, hkv, hd).to(cache_l.dtype)
    view.index_copy_(0, flat, torch.where(sel.reshape(-1, 1, 1), src, view[flat]))


def _append_forward(params, cfg, tokens, cache: KVCache, cursors, n_new, aids=None, ring: int = 0):
    """Shared write-then-attend chunk append: write the chunk's K/V rows at
    each row's cursor (mod ``ring`` on a rolling ring), attend over all
    resident keys + the chunk's causal triangle, return the final hidden
    states [b, c, d] and the (k, v) stacks, which are ``cache``'s own
    tensors updated in place. The chunk's own rows are written
    unquantized; int8 weights run W8A8. ``aids`` [b]: each packed row's
    adapter id (explicit, as in JAX: a unified step's rows are not the
    slots)."""
    b, c = tokens.shape
    positions = cursors.long()[:, None] + torch.arange(c, device=tokens.device)[None, :]
    sel = lora_select(params, aids)
    x = _embed_tokens(params, cfg, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        kc, vc = cache.k[i], cache.v[i]  # [b, capacity, hkv, hd]
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k_new, v_new = _qkv(cfg, h, lp, positions, qmm_a8, sel)
        _write_chunk_rows(kc, k_new, cursors, n_new, ring)
        _write_chunk_rows(vc, v_new, cursors, n_new, ring)
        attn = chunk_prefill_attention(
            q.contiguous(), kc, vc, cursors.to(torch.int32),
            logit_cap=cfg.attn_logit_cap, window=cfg.sliding_window, ring=ring,
        )
        x = _attn_out(cfg, x, attn, lp, qmm_a8, sel)
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(cfg, h, lp, qmm_a8, sel)
    return x, (cache.k, cache.v)


@torch.no_grad()
def prefill_append(
    params: dict,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [b, c] — one prefill chunk per sequence
    cache: KVCache,  # [L, b, capacity, hkv, hd] slot rows (gathered)
    cursors: torch.Tensor,  # [b] int32 — prompt tokens already resident
    n_new: torch.Tensor,  # [b] int32 — valid tokens in this chunk (<= c)
    aids: torch.Tensor | None = None,  # [b] per-row adapter ids (LoRA)
    *,
    ring: int = 0,  # >0: the cache is a rolling ring of this capacity
) -> tuple[torch.Tensor, KVCache]:
    """Append one prefill chunk into a per-slot KV view (the chunked-prefill
    half of the engine's unified step). Rows i >= n_new write nothing; on
    a rolling ring chunk row i lands at (cursor + i) mod ring. Returns
    (last-valid-token logits [b, vocab] f32, the cache with its k/v
    written in place and length = cursors + n_new). Rows with n_new == 0
    return garbage logits."""
    b, c = tokens.shape
    x, (ks, vs) = _append_forward(params, cfg, tokens, cache, cursors, n_new, aids, ring)
    last = torch.clamp(n_new.long() - 1, 0, c - 1)
    x_last = torch.gather(x, 1, last[:, None, None].expand(-1, 1, x.shape[-1]))
    logits = _unembed_last(params, cfg, x_last)
    return logits, KVCache(k=ks, v=vs, length=(cursors + n_new).to(torch.int32))


@torch.no_grad()
def verify_chunk(
    params: dict,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [b, c] — last accepted token | draft tokens
    cache: KVCache,  # [L, b, capacity, hkv, hd] slot rows (gathered)
    cursors: torch.Tensor,  # [b] int32 — tokens already resident
    n_new: torch.Tensor,  # [b] int32 — valid tokens (1 + drafts; <= c)
    aids: torch.Tensor | None = None,  # [b] per-row adapter ids (LoRA)
    *,
    ring: int = 0,  # >0: the cache is a rolling ring of this capacity
) -> tuple[torch.Tensor, KVCache]:
    """Score every position of a speculative draft in ONE forward pass:
    the same write-then-attend chunk append as ``prefill_append``, so
    position i sees exactly the keys a sequential decode of
    tokens[:i + 1] would, but ALL c positions are unembedded. Rows the
    engine rejects sit above its rolled-back cursor, causally masked
    until the next append overwrites them (on a ring they read one lap
    behind, outside every window). Returns (per-position logits [b, c,
    vocab] f32, the cache written in place with length = cursors +
    n_new); positions >= n_new carry garbage logits."""
    x, (ks, vs) = _append_forward(params, cfg, tokens, cache, cursors, n_new, aids, ring)
    logits = _unembed(params, cfg, rms_norm(x, params["final_norm"], cfg.norm_eps))
    return logits, KVCache(k=ks, v=vs, length=(cursors + n_new).to(torch.int32))


def _decode_steps(params, cfg, tokens, lengths, temps, generator, n_steps, sample_fn, sample_state, aids, attend):
    """The fused steps of a decode chunk, shared by both layouts: each step
    embeds the last tokens at positions lengths + step, writes its K/V at
    the UNIFORM position ``step`` of a fresh [L, b, n_steps, hkv, hd]
    buffer (JAX: dynamic_update_slice into a carried buffer; fresh each
    call, so a captured chunk keeps it in its graph's private memory
    pool), attends through ``attend(layer, q, kb_l, vb_l, step)`` and
    samples (statefully with ``sample_state``). Returns (tokens [n_steps,
    b] int32, last [b] int32, kb, vb, final sample state)."""
    L, b = cfg.n_layers, tokens.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    kb = torch.zeros((L, b, n_steps, hkv, hd), dtype=cfg.dtype, device=tokens.device)
    vb = torch.zeros((L, b, n_steps, hkv, hd), dtype=cfg.dtype, device=tokens.device)
    tok, sstate = tokens, sample_state
    sel = lora_select(params, aids)
    out = []
    for k_i in range(n_steps):
        positions = (lengths.long() + k_i)[:, None]  # [b, 1]
        x = _embed_tokens(params, cfg, tok[:, None])
        for i in range(L):
            lp = _layer(params, i)
            h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            q, k_new, v_new = _qkv(cfg, h, lp, positions, qmm, sel)
            kb[i, :, k_i] = k_new[:, 0]
            vb[i, :, k_i] = v_new[:, 0]
            attn = attend(i, q, kb[i], vb[i], k_i)
            x = _attn_out(cfg, x, attn, lp, qmm, sel)
            h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + _mlp(cfg, h, lp, qmm, sel)
        logits = _unembed_last(params, cfg, x)
        if sample_state is None:
            tok = sample_fn(logits, temps, generator).to(torch.int32)
        else:
            tok, sstate = sample_fn(logits, temps, generator, sstate)
            tok = tok.to(torch.int32)
        out.append(tok)
    return torch.stack(out), tok, kb, vb, sstate


@torch.no_grad()
def decode_chunk(
    params: dict,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [b] last sampled token per sequence
    cache: KVCache,  # k/v [L, b, capacity, hkv, hd] slot slab or ring; length [b] int32
    active: torch.Tensor,  # [b] bool — only active slots advance their length
    temps: torch.Tensor,  # [b] f32 sampling temperatures
    generator: torch.Generator | None,
    *,
    n_steps: int,
    sample_fn,  # (logits [b, vocab] f32, temps [b], generator) -> tokens [b]
    ring: int = 0,  # >0: the cache is a rolling ring of this capacity
    sample_state=None,  # stateful sampler's carried state (as decode_chunk_paged)
    aids: torch.Tensor | None = None,  # [b] per-slot adapter ids (LoRA)
) -> tuple:
    """``n_steps`` fused decode steps against a CONTIGUOUS per-slot cache
    (JAX ``decode_chunk``): the dense slab [L, b, max_seq_len, hkv, hd],
    or with ``ring`` > 0 the rolling ring [L, b, window + slack, hkv, hd].

    The cache is read-only inside the chunk: each step writes its K/V at
    the uniform position ``step`` of the chunk buffer, and attention spans
    cache and buffer with one joint softmax (``chunk_decode_attention``,
    plain PyTorch as the JAX einsums are). The buffer merges ONCE at chunk
    end, for every slot (an inactive slot's rows are garbage its length
    never covers, and a free slot is rewritten by its next prompt):

    - dense: at [min(length, capacity - K), + K), lengths of active slots
      advancing to min(length + K, capacity);
    - ring: at (length + i) mod ring, overwriting exactly the K oldest
      rows, which ring >= window + K keeps outside every later window;
      lengths stay ABSOLUTE, so RoPE and the window masks stay exact.

    The cache tensors and ``cache.length`` are written IN PLACE. No host
    synchronisation, so a CUDA graph captures it. ``sample_state`` and
    ``aids`` as ``decode_chunk_paged``. Returns (tokens [n_steps, b]
    int32, last [b] int32, cache) [+ the final sample state when one was
    passed]."""
    L, b = cfg.n_layers, tokens.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    K, C = n_steps, cache.k.shape[2]
    lengths = cache.length

    def attend(i, q, kb_l, vb_l, k_i):
        return chunk_decode_attention(
            q, cache.k[i], cache.v[i], kb_l, vb_l, lengths, k_i,
            logit_cap=cfg.attn_logit_cap, window=cfg.sliding_window, ring=ring,
        )

    toks, last, kb, vb, sstate = _decode_steps(
        params, cfg, tokens, lengths, temps, generator, K, sample_fn, sample_state, aids, attend,
    )
    ar = torch.arange(K, device=tokens.device)[None, :]
    if ring > 0:
        rows = torch.remainder(lengths.long()[:, None] + ar, ring)
        new_len = torch.where(active, lengths + K, lengths)
    else:
        rows = torch.clamp(lengths.long(), max=C - K)[:, None] + ar
        new_len = torch.where(active, torch.clamp(lengths + K, max=C), lengths)
    flat = (torch.arange(b, device=tokens.device)[:, None] * C + rows).reshape(-1)  # distinct: K <= C
    for stack, buf in ((cache.k, kb), (cache.v, vb)):
        stack.view(L, b * C, hkv, hd).index_copy_(1, flat, buf.reshape(L, b * K, hkv, hd).to(stack.dtype))
    lengths.copy_(new_len.to(lengths.dtype))
    out = (toks, last, cache)
    return out if sample_state is None else out + (sstate,)


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
    sample_state=None,  # stateful sampler's carried state (see below)
    aids: torch.Tensor | None = None,  # [b] per-slot adapter ids (LoRA)
) -> tuple:
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

    With ``sample_state`` (any value, e.g. the per-slot grammar DFA
    states) the sampler is STATEFUL: ``sample_fn(logits, temps,
    generator, state) -> (tokens, state)``, the state threaded from step
    to step (JAX ``sample_state``).

    ``aids`` selects each slot's LoRA adapter (JAX reads ``params["aids"]``).

    Returns (tokens [n_steps, b] int32, last [b] int32, pool) [+ the final
    sample state when one was passed]."""
    from ..kvcache.paged import scatter_rows

    K = n_steps
    dev = tokens.device
    lengths = pool.length

    def attend(i, q, kb_l, vb_l, k_i):
        return paged_chunk_decode_attention(
            q, pool.k[i], pool.v[i], tables, kb_l, vb_l, lengths, k_i,
            logit_cap=cfg.attn_logit_cap, window=cfg.sliding_window,
            k_scales=None if scales is None else scales[0, i],
            v_scales=None if scales is None else scales[1, i],
        )

    toks, last, kb, vb, sstate = _decode_steps(
        params, cfg, tokens, lengths, temps, generator, K, sample_fn, sample_state, aids, attend,
    )
    # merge: the chunk's K rows scatter through the table at positions
    # [length, length + K) — private blocks by the engine's construction
    cap = tables.shape[1] * block
    pos = lengths[:, None].long() + torch.arange(K, device=dev)[None, :]
    valid = active[:, None] & (pos < cap)
    scatter_rows(pool.k, pool.v, tables, kb, vb, pos, valid, scales=scales)
    new_len = torch.where(active, torch.clamp(lengths + K, max=cap), lengths)
    lengths.copy_(new_len.to(lengths.dtype))
    out = (toks, last, pool)
    return out if sample_state is None else out + (sstate,)
