"""Analytic model FLOPs, device peaks, and MFU/roofline classification
(counterpart of gofr_tpu/profiling/mfu.py: the cost model and the
roofline are the same functions; the peak table holds the GPU rows).

MFU (model FLOPs utilization, the PaLM-system-report framing) is the
serving health signal the latency histograms cannot give: *useful* model
FLOPs per second divided by the chip's peak. The analytic side is
computed ONCE per registered model from the architecture — the standard
2·params·tokens matmul count plus the attention correction (4·L·H·d per
token per attended position, QKᵀ and AV) — and the engine combines it
with measured phase wall time per prefill wave / decode chunk.

Roofline classification compares the program's compute time at peak
FLOPs against its memory time at peak HBM bandwidth: decode streams the
whole weight set plus the live KV prefix per step, so it is
memory-bound everywhere that matters; prefill at real batch widths is
compute-bound. A phase whose measured ratio flips side is the first
sign a kernel regressed.

Peaks are tabulated per GPU (``_GPU_PEAKS``: bf16 dense tensor-core
numbers, the convention MFU reports use even when serving int8, matched
against the name ``torch.cuda.get_device_name`` reports). Elsewhere there is no honest
peak: the CPU uses a nominal 1 TFLOP/s placeholder so the gauges stay
finite and testable — override with the ``TPU_PEAK_FLOPS`` /
``TPU_HBM_BW`` env knobs (the reference's names, so one dashboard reads
either package) when you care about the absolute value.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = [
    "ModelCosts",
    "model_costs",
    "decode_flops",
    "prefill_flops",
    "chunk_prefill_flops",
    "spec_verify_flops",
    "device_peak_flops",
    "device_hbm_bandwidth",
    "roofline_ratio",
    "classify_bound",
    "card_peaks",
]

# GPU data-sheet rows by a substring of the device name: HBM bytes/s, bf16
# dense tensor-core FLOP/s, f32 (non-tensor) FLOP/s. The kernel bounds of
# chip_smoke.py read the same rows (card_peaks).
_GPU_PEAKS: tuple[tuple[str, float, float, float], ...] = (
    ("H100 80GB HBM3", 3.35e12, 989e12, 67e12),  # H100 SXM
)

# Placeholder peak for a device off the table: keeps MFU/roofline math
# finite on the CPU test backend without pretending to know the host's real roofline.
_FALLBACK_PEAK_FLOPS = 1e12
_FALLBACK_HBM_BW = 1e11


def device_peak_flops(platform: str = "", device_kind: str = "") -> float:
    """Peak dense FLOP/s per chip (bf16 convention). TPU_PEAK_FLOPS
    overrides; unknown device kinds fall back to the nominal placeholder."""
    env = os.environ.get("TPU_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    row = _gpu_row(platform, device_kind)
    return row[2] if row is not None else _FALLBACK_PEAK_FLOPS


def device_hbm_bandwidth(platform: str = "", device_kind: str = "") -> float:
    """Peak HBM bandwidth per chip in B/s (TPU_HBM_BW overrides)."""
    env = os.environ.get("TPU_HBM_BW")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    row = _gpu_row(platform, device_kind)
    return row[1] if row is not None else _FALLBACK_HBM_BW


def _gpu_row(platform: str, device_kind: str):
    if platform not in ("gpu", "cuda"):
        return None
    for row in _GPU_PEAKS:
        if row[0] in (device_kind or ""):
            return row
    return None


def card_peaks(name: str) -> tuple[str, tuple[float, float, float]]:
    """(table key, (HBM bytes/s, bf16 FLOP/s, f32 FLOP/s)) for a card named
    as ``nvidia-smi`` or ``torch.cuda.get_device_name`` reports it; raises
    for a card without a row (a bound needs a real peak, no placeholder)."""
    for key, bw, bf16, f32 in _GPU_PEAKS:
        if key in name:
            return key, (bw, bf16, f32)
    raise RuntimeError(f"no peak figures for card {name!r}; add its data sheet row to profiling.mfu._GPU_PEAKS")


@dataclass(frozen=True)
class ModelCosts:
    """Per-model analytic constants, computed once at engine registration.

    ``matmul_flops_per_token`` is the classic 2·params count over the
    weight matmuls a decoded token touches (layer stack + the unembed
    projection; the embedding *lookup* is a gather, not a matmul).
    ``attn_flops_per_token_per_ctx`` is the attention correction per
    attended position: QKᵀ and AV are each 2·H·d FLOPs per (token,
    position) pair per layer."""

    params: int  # total parameter count (embed counted once when tied)
    layer_params: int  # weight params across the layer stack
    embed_params: int  # vocab x d_model (the unembed matmul's matrix)
    matmul_flops_per_token: int
    attn_flops_per_token_per_ctx: int
    kv_bytes_per_ctx_token: int  # bytes of K+V a step reads per attended position
    params_bytes: int  # resident weight bytes (int8 when quantized)
    sliding_window: int  # 0 = global attention


def model_costs(cfg, *, quantized: bool = False) -> ModelCosts:
    """Architecture-derived cost constants for a TransformerConfig.

    The reference's parameter accounting (attention projections with
    GQA, the 3-matrix gated MLP, one vocab x d embed matrix)."""
    layer_params = (
        cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim  # qkv
        + cfg.n_heads * cfg.head_dim * cfg.d_model  # attention out
        + 3 * cfg.d_model * cfg.d_ff  # gate/up/down
    ) * cfg.n_layers
    embed_params = cfg.vocab_size * cfg.d_model
    itemsize = 1 if quantized else _dtype_itemsize(cfg.dtype)
    kv_itemsize = _dtype_itemsize(cfg.dtype)  # KV cache stays cfg.dtype
    return ModelCosts(
        params=layer_params + embed_params,
        layer_params=layer_params,
        embed_params=embed_params,
        matmul_flops_per_token=2 * (layer_params + embed_params),
        attn_flops_per_token_per_ctx=4 * cfg.n_layers * cfg.n_heads * cfg.head_dim,
        kv_bytes_per_ctx_token=2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * kv_itemsize,
        params_bytes=(layer_params + embed_params) * itemsize,
        sliding_window=int(getattr(cfg, "sliding_window", 0) or 0),
    )


def _dtype_itemsize(dtype) -> int:
    size = getattr(dtype, "itemsize", None)  # a torch dtype
    if isinstance(size, int):
        return size
    try:
        import numpy as np

        return int(np.dtype(dtype).itemsize)
    except Exception:  # noqa: BLE001 — bf16 has no numpy dtype
        name = str(getattr(dtype, "__name__", dtype))
        return 2 if "16" in name else 4


def decode_flops(costs: ModelCosts, tokens: int, ctx_total: int) -> float:
    """FLOPs for `tokens` decoded tokens attending over `ctx_total`
    summed context positions (already window-capped by the caller)."""
    return (
        tokens * costs.matmul_flops_per_token
        + costs.attn_flops_per_token_per_ctx * ctx_total
    )


def prefill_flops(costs: ModelCosts, seq_lens: list[int]) -> float:
    """FLOPs for one prefill wave over the given actual prompt lengths.
    Useful-work convention: padding rows and pad tail positions count
    zero, so MFU reads as useful model FLOPs per peak — padding waste
    shows up as LOW utilization rather than being flattered away. The
    unembed matmul runs once per sequence (last position only) and
    causal attention attends ~s/2 positions per token (window-capped)."""
    total = 0.0
    w = costs.sliding_window
    for s in seq_lens:
        if not w or s <= w:
            attended = s * (s + 1) / 2  # full causal triangle
        else:
            # exact window cap: the first w tokens attend causally, every
            # later token attends exactly w positions
            attended = w * (w + 1) / 2 + (s - w) * w
        total += (
            2 * s * costs.layer_params
            + 2 * costs.embed_params
            + costs.attn_flops_per_token_per_ctx * attended
        )
    return total


def chunk_prefill_flops(costs: ModelCosts, spans: list[tuple[int, int]]) -> float:
    """FLOPs for one chunked-prefill step over `spans` of (cursor, n_new):
    n_new tokens appended at absolute positions [cursor, cursor + n_new).
    Same useful-work convention as prefill_flops (padding lanes count
    zero), but attention is position-exact — token at position p attends
    min(p + 1, window) keys — and the unembed matmul bills once per span
    (the step op computes last-token logits every chunk, which is the
    chunked path's extra cost over one-shot prefill)."""
    total = 0.0
    w = costs.sliding_window

    def attended_below(p: int) -> float:
        # sum over positions 0..p-1 of min(pos + 1, window or inf)
        if not w or p <= w:
            return p * (p + 1) / 2
        return w * (w + 1) / 2 + (p - w) * w

    for cursor, n in spans:
        if n <= 0:
            continue
        attended = attended_below(cursor + n) - attended_below(cursor)
        total += (
            2 * n * costs.layer_params
            + 2 * costs.embed_params
            + costs.attn_flops_per_token_per_ctx * attended
        )
    return total


def spec_verify_flops(costs: ModelCosts, spans: list[tuple[int, int]]) -> float:
    """USEFUL FLOPs for one speculative-decoding verify step over `spans`
    of (cursor, n_emitted): the tokens the step actually produced —
    accepted draft tokens plus the bonus token per lane.

    The useful-work convention, applied to speculation: a verify
    forward pass computes draft+1 positions per lane but only
    n_emitted of them advanced the stream, so VERIFIED-BUT-REJECTED
    positions bill ZERO here — exactly like padding rows in
    prefill_flops. MFU (useful FLOPs / wall / peak) then reads LOW when
    acceptance is poor instead of being flattered by throwaway compute,
    which is the honest signal: a spec engine at 0% acceptance burns
    the wall of a (draft+1)-wide pass for one token of progress.
    Per-token accounting matches decode_flops (full matmul stack +
    unembed per emitted token — every emitted token's position WAS
    sampled from its own unembed) with position-exact attention per
    accepted position, the chunk_prefill_flops span convention."""
    total = 0.0
    w = costs.sliding_window

    def attended_below(p: int) -> float:
        if not w or p <= w:
            return p * (p + 1) / 2
        return w * (w + 1) / 2 + (p - w) * w

    for cursor, n in spans:
        if n <= 0:
            continue
        attended = attended_below(cursor + n) - attended_below(cursor)
        total += (
            n * costs.matmul_flops_per_token
            + costs.attn_flops_per_token_per_ctx * attended
        )
    return total


def roofline_ratio(flops: float, bytes_moved: float, peak_flops: float, hbm_bw: float) -> float:
    """compute_time / memory_time for one program execution: > 1 means
    the roofline predicts compute-bound, < 1 memory(HBM)-bound."""
    if bytes_moved <= 0 or peak_flops <= 0 or hbm_bw <= 0:
        return 0.0
    return (flops / peak_flops) / (bytes_moved / hbm_bw)


def classify_bound(ratio: float) -> str:
    if ratio <= 0:
        return "unknown"
    return "compute" if ratio >= 1.0 else "memory"
