"""Int8 weight quantization for serving (counterpart of
gofr_tpu/models/quant.py).

Symmetric per-output-channel int8: ``q`` int8 [..., in, out] and ``s``
[..., 1, out] in the model dtype. The embedding is quantized per d-column,
so one scale vector serves the gather (``q[tokens] * s``) and the unembed
(``(x * s) @ q.T``).

Two products, chosen per call site exactly as in the JAX package:

- ``qmm`` (weight-only; the decode chunk): ``(x @ q.to(x.dtype)) * s``.
  Eager PyTorch materializes the ``x.dtype`` copy of ``q`` for each call.
- ``qmm_a8`` (W8A8; prefill chunks and the full-prompt forward): each
  activation row is quantized to int8 on the fly (scale = max(amax / 127,
  1e-8) in float32), an int8 x int8 -> int32 product runs through
  ``torch._int_mm``, and ``acc * row_scale * s`` is taken in float32.

``QTensor`` is a NamedTuple of two tensors, so a quantized parameter
dictionary has the same keys as a plain one.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import torch

from .. import resolve_device

__all__ = [
    "QTensor",
    "init_params_quantized",
    "is_quantized",
    "qmm",
    "qmm_a8",
    "quantize",
    "quantize_params",
]

# torch._int_mm on CUDA takes only more than 16 rows
_INT_MM_MIN_ROWS = 17


class QTensor(NamedTuple):
    q: torch.Tensor  # int8
    s: torch.Tensor  # scale in the compute dtype, broadcast over the last axis

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):  # the compute dtype after dequantization
        return self.s.dtype


def _quantize_matrix(w: torch.Tensor, dtype) -> QTensor:
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return QTensor(q=q, s=scale.to(dtype))


def quantize(w: torch.Tensor, dtype=torch.bfloat16) -> QTensor:
    """Symmetric int8 per last-axis channel. The amax runs over axis -2
    only (the contraction axis), so stacked [L, in, out] weights get
    [L, 1, out] scales and [L, E, in, out] expert stacks [L, E, 1, out];
    an all-zero channel gets scale 1. A stack is quantized one [in, out]
    matrix at a time (each matrix's scales are its own, so the result is
    the same), so its float32 copy never exists whole: a 16-layer
    Mixtral-width expert stack would be 30 GB."""
    lead = tuple(w.shape[:-2])
    if not lead:
        return _quantize_matrix(w, dtype)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(lead + (1, w.shape[-1]), dtype=dtype, device=w.device)
    for idx in itertools.product(*map(range, lead)):
        q[idx], s[idx] = _quantize_matrix(w[idx], dtype)
    return QTensor(q=q, s=s)


def qmm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for plain tensors or QTensors (weight-only dequantization)."""
    if isinstance(w, QTensor):
        return (x @ w.q.to(x.dtype)) * w.s.to(x.dtype)
    return x @ w


def qmm_a8(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w with per-row dynamic activation quantization (W8A8) for
    QTensors; a plain x @ w otherwise. Rows are padded with zeros up to
    ``torch._int_mm``'s minimum (exact: zero rows give zero sums and are
    dropped)."""
    if not isinstance(w, QTensor):
        return x @ w
    amax = x.abs().amax(dim=-1, keepdim=True).float()
    sc = torch.clamp(amax / 127.0, min=1e-8)
    xq = torch.round(x.float() / sc).clamp(-127, 127).to(torch.int8)
    lead, k = xq.shape[:-1], xq.shape[-1]
    rows = xq.reshape(-1, k)
    m = rows.shape[0]
    if m < _INT_MM_MIN_ROWS:
        rows = torch.cat([rows, rows.new_zeros((_INT_MM_MIN_ROWS - m, k))])
    acc = torch._int_mm(rows, w.q)[:m].reshape(*lead, w.q.shape[-1])
    out = acc.float() * sc * w.s.float().reshape((1,) * (acc.dim() - 1) + (-1,))
    return out.to(x.dtype)


def is_quantized(params: dict) -> bool:
    return isinstance(params.get("embed"), QTensor)


_QUANT_KEYS = ("wq", "wkv", "wo", "w_gate", "w_up", "w_down")


def quantize_params(params: dict, dtype=torch.bfloat16) -> dict:
    """Quantize the matmul weights and the embedding (and an untied
    ``unembed``); an MoE tree's expert stacks too, its router not; norms
    and the q/k/v bias leaves stay as they are (the
    bias add stays in ``transformer._qkv``; ``qmm``/``qmm_a8`` add none).
    Already quantized params are returned unchanged."""
    if is_quantized(params):
        return params
    out = {
        "embed": quantize(params["embed"], dtype),
        "final_norm": params["final_norm"],
        "layers": {
            k: (quantize(v, dtype) if k in _QUANT_KEYS else v) for k, v in params["layers"].items()
        },
    }
    if "unembed" in params:
        out["unembed"] = quantize(params["unembed"], dtype)
    return out


def init_params_quantized(
    cfg, generator: torch.Generator | None = None, device=None, dtype=torch.bfloat16
) -> dict:
    """Random int8 parameters made directly on ``device`` (``cuda`` by
    default), for models whose bf16 tree would not fit: int8 weights
    uniform in [-127, 127] with per-channel scales 1 / (73 sqrt(fan_in)),
    so the dequantized std is about 1 / sqrt(fan_in) (uniform int8 has
    std ~73); norms zero, and a qkv-bias config's bias leaves zero and
    unquantized (JAX ``init_params_quantized``). A mixture-of-experts
    config is refused: this tree has the dense MLP leaves (the JAX
    initializer draws them for it too); quantize ``init_params``' tree
    instead."""
    if getattr(cfg, "n_experts", 0) > 0:
        raise NotImplementedError("init_params_quantized draws dense MLP leaves; for an MoE config use "
                                  "quantize_params(init_params(cfg))")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, hd, hq, hkv, ff, L = (
        cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.n_layers,
    )

    def qw(shape, fan_in):
        q = torch.randint(-127, 128, shape, generator=generator, device=dev, dtype=torch.int8)
        s = torch.full(shape[:-2] + (1, shape[-1]), 1.0 / (73.0 * math.sqrt(fan_in)), dtype=dtype, device=dev)
        return QTensor(q=q, s=s)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    # q/k/v bias leaves stay unquantized, zero as in the JAX initializer
    bias = {"bq": zeros((L, hq * hd)), "bkv": zeros((L, 2 * hkv * hd))} if cfg.qkv_bias else {}
    return {
        "embed": qw((cfg.vocab_size, d), d),
        "final_norm": zeros((d,)),
        "layers": {
            **bias,
            "attn_norm": zeros((L, d)),
            "wq": qw((L, d, hq * hd), d),
            "wkv": qw((L, d, 2 * hkv * hd), d),
            "wo": qw((L, hq * hd, d), hq * hd),
            "mlp_norm": zeros((L, d)),
            "w_gate": qw((L, d, ff), d),
            "w_up": qw((L, d, ff), d),
            "w_down": qw((L, ff, d), ff),
        },
    }
