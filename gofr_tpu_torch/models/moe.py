"""Mixture-of-experts FFN for serving (counterpart of the serving half of
gofr_tpu/models/moe.py: ``MoEConfig`` and ``moe_ffn``).

The routing is the JAX package's, decision for decision:

- router logits ``x @ w_router`` in float32, softmax over the E experts;
- top-k in descending order, the lower expert index first on ties (as
  ``lax.top_k``; a stable descending sort keeps that order, where
  ``torch.topk`` leaves it unspecified);
- capacity ``C = max(1, ceil(T / E * capacity_factor * k))`` per expert for
  the call's T rows, padding rows included;
- capacity claimed slot-major: every row's first choice in row order, then
  every row's second, and so on. A (row, slot) pair past its expert's
  capacity is dropped (combine weight 0);
- the combine weight is the top-k softmax probability, not renormalised;
- the Switch auxiliary loss ``E * sum_e frac_e * mean_prob_e`` (frac over
  the first choices).

Two forms compute that function:

- ``moe_ffn`` (served): positions instead of one-hot tensors. Each kept
  (row, slot) pair copies its row into its expert's [C, d] buffer (the
  pairs' destinations are distinct; dropped pairs land in one spare row),
  the experts run as batched products over [E, C, d] in the weights'
  stored dtype (float32 accumulation), and each row gathers its k outputs
  back, weighted in float32. Every shape follows from T, E, k and C, so
  the function has no host synchronisation and is captured inside the
  engine's CUDA graphs.
- ``moe_ffn_plain``: the literal JAX form, one-hot [T, k, E, C]
  dispatch/combine tensors and float32 einsums with float32 expert
  weights. The tests and the card's check hold the served form against
  it; nothing on the serving path calls it.

In float32 the two agree with JAX to summation order. In bfloat16 the
served form rounds the expert products' inputs and outputs to bfloat16
as the dense MLP does, where the JAX form upcasts the stacks (a float32
copy of every expert weight per call). int8 experts (``QTensor``)
dequantize as JAX's ``_deq`` does, ``q * s``, here into the activations'
dtype; there is no W8A8 product for experts.

The training half of the JAX module: ``moe_init`` (JAX's tree: packed
``wqkv`` [L, d, 3 hq hd], no KV-head grouping), ``moe_params_from_jax``,
``moe_transformer_forward`` (JAX's layer: no embedding scale, causal
attention through the flash kernel with a gradient,
``ops.flash_attention_train``, and the served ``moe_ffn`` with its
auxiliary loss) and ``moe_lm_loss`` (cross entropy plus
``aux_loss_weight`` times the summed aux). Its expert products run in the
stored dtype, as served, where JAX's upcast the stacks to float32: the
same function in float32, where the tests hold the loss and every
gradient against ``jax.grad``; in bfloat16 no float32 copy of a stack is
made or kept for the backward. The expert-parallel ``moe_param_specs`` is
ROADMAP ID 11.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..ops import apply_rope, flash_attention_train, rms_norm
from .quant import QTensor

__all__ = [
    "MoEConfig",
    "moe_ffn",
    "moe_ffn_plain",
    "moe_init",
    "moe_lm_loss",
    "moe_mlp",
    "moe_params_from_jax",
    "moe_route",
    "moe_transformer_forward",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The JAX ``MoEConfig``'s fields; ``moe_ffn`` reads ``n_experts``,
    ``top_k`` and ``capacity_factor`` from it when its keywords are
    left out."""

    vocab_size: int = 512
    d_model: int = 64
    n_layers: int = 2
    n_heads: int = 4
    head_dim: int = 16
    d_ff: int = 128  # per-expert hidden
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    aux_loss_weight: float = 1e-2
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(n_experts: int = 8) -> "MoEConfig":
        return MoEConfig(n_experts=n_experts)


_ACTS = {"gelu": lambda x: F.gelu(x, approximate="tanh"), "silu": F.silu}  # jax.nn.gelu's default is tanh


def _routing(cfg, n_experts, top_k, capacity_factor, act):
    if cfg is not None:
        n_experts = cfg.n_experts if n_experts is None else n_experts
        top_k = cfg.top_k if top_k is None else top_k
        if capacity_factor is None:
            capacity_factor = cfg.capacity_factor
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}; expected one of {sorted(_ACTS)}")
    return int(n_experts), int(top_k), 1.25 if capacity_factor is None else float(capacity_factor)


def _deq(w, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(w, QTensor):
        return w.q.to(dtype) * w.s.to(dtype)
    return w


def moe_route(x: torch.Tensor, w_router: torch.Tensor, n_experts: int, top_k: int, capacity_factor: float):
    """The routing decisions for rows ``x`` [T, d]: (probs [T, E] f32,
    top_p [T, k] f32, top_e [T, k] int64, slot_pos [T, k] int64 (each
    pair's place in its expert's buffer), keep [T, k] bool, C: the rows
    each expert takes)."""
    E, k = n_experts, top_k
    T = x.shape[0]
    C = max(1, math.ceil(T / E * capacity_factor * k))
    probs = torch.softmax(x.float() @ _deq(w_router, torch.float32).float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    onehot = (top_e[..., None] == torch.arange(E, device=x.device)).long()  # [T, k, E]
    pos = onehot.transpose(0, 1).reshape(k * T, E).cumsum(0) - 1  # slot-major claims
    slot_pos = (pos.reshape(k, T, E).transpose(0, 1) * onehot).sum(-1)
    return probs, top_p, top_e, slot_pos, slot_pos < C, C


def _aux(probs: torch.Tensor, top_e: torch.Tensor, E: int) -> torch.Tensor:
    frac = (top_e[:, 0, None] == torch.arange(E, device=probs.device)).float().sum(0) / probs.shape[0]
    return E * (frac * probs.mean(0)).sum()


def _served(x, w_router, w_gate, w_up, w_down, E: int, k: int, cf: float, act: str):
    T, d = x.shape
    probs, top_p, top_e, slot_pos, keep, C = moe_route(x, w_router, E, k, cf)
    dt = x.dtype
    wg, wu, wd = _deq(w_gate, dt), _deq(w_up, dt), _deq(w_down, dt)
    # destination row of each (row, slot) pair in the flat [E * C + 1, d]
    # buffers; every dropped pair goes to the spare last row
    dest = torch.where(keep, top_e * C + slot_pos, E * C).reshape(-1)
    xin = x.new_zeros((E * C + 1, d))
    xin.index_copy_(0, dest, x[:, None].expand(T, k, d).reshape(T * k, d))
    h = xin[: E * C].view(E, C, d)
    a = _ACTS[act](torch.bmm(h, wg).float()) * torch.bmm(h, wu).float()
    yout = torch.cat([torch.bmm(a.to(dt), wd).view(E * C, d), x.new_zeros((1, d))])
    w = torch.where(keep, top_p, 0.0)  # [T, k] f32
    y = (w[..., None] * yout[dest].view(T, k, d).float()).sum(1)
    return y.to(dt), probs, top_e


def moe_ffn(
    x: torch.Tensor,  # [T, d]
    w_router: torch.Tensor,  # [d, E]
    w_gate,  # [E, d, ff] (or a QTensor)
    w_up,
    w_down,  # [E, ff, d]
    cfg: MoEConfig | None = None,
    *,
    n_experts: int | None = None,
    top_k: int | None = None,
    capacity_factor: float | None = None,
    act: str = "gelu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y [T, d] in x's dtype, aux loss f32 scalar): the served form (see
    the module docstring). Routing fields come from the keywords, or from
    ``cfg`` where a keyword is None."""
    E, k, cf = _routing(cfg, n_experts, top_k, capacity_factor, act)
    y, probs, top_e = _served(x, w_router, w_gate, w_up, w_down, E, k, cf, act)
    return y, _aux(probs, top_e, E)


def moe_mlp(x, w_router, w_gate, w_up, w_down, *, n_experts: int, top_k: int, capacity_factor: float,
            act: str) -> torch.Tensor:
    """``moe_ffn``'s y alone: the serving programs' call (``transformer._mlp``),
    which, like the JAX programs once XLA has dropped the unused loss,
    computes no auxiliary loss (its few kernels a layer and step)."""
    E, k, cf = _routing(None, n_experts, top_k, capacity_factor, act)
    return _served(x, w_router, w_gate, w_up, w_down, E, k, cf, act)[0]


def moe_ffn_plain(
    x: torch.Tensor,
    w_router: torch.Tensor,
    w_gate,
    w_up,
    w_down,
    cfg: MoEConfig | None = None,
    *,
    n_experts: int | None = None,
    top_k: int | None = None,
    capacity_factor: float | None = None,
    act: str = "gelu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``moe_ffn``: JAX's one-hot dispatch/combine
    form, line for line, in float32 (int8 stacks dequantized to float32)."""
    E, k, cf = _routing(cfg, n_experts, top_k, capacity_factor, act)
    probs, top_p, top_e, slot_pos, keep, C = moe_route(x, w_router, E, k, cf)
    f32 = torch.float32
    wg, wu, wd = (_deq(w, f32).float() for w in (w_gate, w_up, w_down))
    e_hot = F.one_hot(top_e, E).to(f32)  # [T, k, E]
    c_hot = F.one_hot(torch.where(keep, slot_pos, C), C + 1).to(f32)[..., :C]  # [T, k, C]
    disp = e_hot[..., None] * c_hot[:, :, None, :]  # [T, k, E, C]
    combine = (disp * top_p[..., None, None]).sum(1)  # [T, E, C]
    dispatch = disp.sum(1)
    xin = torch.einsum("tec,td->ecd", dispatch, x.float())
    a = _ACTS[act](xin @ wg) * (xin @ wu)
    y = torch.einsum("tec,ecd->td", combine, a @ wd).to(x.dtype)
    return y, _aux(probs, top_e, E)


# -- the training half --------------------------------------------------------

def _moe_specs(cfg: MoEConfig) -> dict:
    """JAX ``moe_init``'s tree as (shape, fan_in), in its draw order; None
    fan_in: zeros (the norms)."""
    d, hd, hq, ff, E, L = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.d_ff, cfg.n_experts, cfg.n_layers
    return {
        "embed": ((cfg.vocab_size, d), d),
        "final_norm": ((d,), None),
        "layers": {
            "attn_norm": ((L, d), None),
            "wqkv": ((L, d, 3 * hq * hd), d),
            "wo": ((L, hq * hd, d), hq * hd),
            "mlp_norm": ((L, d), None),
            "w_router": ((L, d, E), d),
            "w_gate": ((L, E, d, ff), d),
            "w_up": ((L, E, d, ff), d),
            "w_down": ((L, E, ff, d), ff),
        },
    }


def moe_init(generator: torch.Generator | None, cfg: MoEConfig, device=None) -> dict:
    """Random weights of JAX ``moe_init``'s shapes and scaling (normal /
    sqrt(fan_in) in float32, cast to ``cfg.dtype``; norms zero), drawn from
    ``generator`` (seed 0 on ``device`` when None) on ``device`` (``cuda``
    by default), an expert matrix at a time (``transformer.draw_params``)."""
    from .transformer import draw_params  # transformer imports this module

    return draw_params(_moe_specs(cfg), cfg.dtype, generator, device)


def moe_params_from_jax(np_tree: dict, cfg: MoEConfig, device=None) -> dict:
    """JAX ``moe_init``'s tree, mapped to numpy, as the port's on ``device``
    in ``cfg.dtype`` (``transformer.params_from_jax``, which reads only the
    dtype of the config)."""
    from .transformer import params_from_jax

    return params_from_jax(np_tree, cfg, device)


def moe_transformer_forward(params: dict, cfg: MoEConfig, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[b, s] -> (logits [b, s, vocab] f32, the layers' summed aux loss),
    with a gradient (JAX ``moe_transformer_forward``): causal multi-head
    attention through ``flash_attention_train``, the routed FFN through
    ``moe_ffn``, tied unembedding."""
    b, s = tokens.shape
    d, hq, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    x = params["embed"][tokens.long()].to(cfg.dtype)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    # one unbind per stacked leaf (its backward stacks the layers' gradients
    # once; indexing would zero-fill a copy of the whole stack per layer)
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(cfg.n_layers):
        h = rms_norm(x, layers["attn_norm"][i], cfg.norm_eps)
        qkv = (h @ layers["wqkv"][i]).reshape(b, s, 3, hq, hd)
        q = apply_rope(qkv[:, :, 0], positions, cfg.rope_theta)
        k = apply_rope(qkv[:, :, 1], positions, cfg.rope_theta)
        attn = flash_attention_train(q.contiguous(), k.contiguous(), qkv[:, :, 2].contiguous(), causal=True)
        x = x + (attn.reshape(b, s, hq * hd) @ layers["wo"][i]).to(x.dtype)
        h = rms_norm(x, layers["mlp_norm"][i], cfg.norm_eps)
        y, a = moe_ffn(
            h.reshape(b * s, d), layers["w_router"][i], layers["w_gate"][i], layers["w_up"][i],
            layers["w_down"][i], cfg,
        )
        x = x + y.reshape(b, s, d)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["embed"].T.to(cfg.dtype)).float(), aux


def moe_lm_loss(params: dict, cfg: MoEConfig, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked next-token cross entropy plus ``cfg.aux_loss_weight`` times the
    aux loss (JAX ``moe_lm_loss``)."""
    from ..parallel.train import next_token_loss  # which imports the models

    logits, aux = moe_transformer_forward(params, cfg, tokens)
    return next_token_loss(logits, tokens, mask) + cfg.aux_loss_weight * aux
