"""Attention (counterpart of gofr_tpu/ops/attention.py).

Layout convention at every public function: [batch, seq, heads, head_dim]
("BSHD"), the JAX package's layout, so tests compare like with like. GQA
is native: K/V carry n_kv_heads and query head h reads KV head
h // (n_heads // n_kv_heads).

Two halves:

- Plain PyTorch functions ported from the JAX reference path
  (``mha_reference``, ``chunk_decode_attention``, ``paged_gather``, and
  the partials merge of ``paged_chunk_decode_attention``;
  ``chunk_prefill_attention`` sends every chunk to the flash wrapper).
  They keep the JAX conventions:
  ``NEG_INF`` instead of ``-inf``, dots on values of the cache's stored
  dtype with float32 accumulation.
- Two kernel wrappers, ``flash_attention`` and ``paged_decode_partials``,
  replacing the Pallas TPU kernels with CUDA C++ kernels for Hopper
  (``gofr_tpu_torch/csrc``): ``paged_decode_partials`` launches one
  kernel for bf16/f32 pools and another for int8 pools with float32
  scales (the Pallas kernel's ``quantized=True`` variant). Each has its
  plain PyTorch version beside it. A wrapper runs the plain version for a
  tensor on the CPU; for a tensor on a CUDA device it launches its kernel
  or raises. Each wrapper counts its kernels' launches in ``launches``
  attributes.

float32 upcasts in the plain dots: JAX's ``preferred_element_type=f32``
accumulates products of bf16 values in f32. The product of two bf16
values is exact in f32, so casting both operands to f32 and running an
f32 product gives the same function up to summation order.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -2.3819763e38  # close to bf16 min; avoids nan from (-inf) - (-inf)

# head dims the CUDA kernels are instantiated for (csrc/*.cu)
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Plain reference path
# ---------------------------------------------------------------------------


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum of stored-dtype operands with f32 accumulation (the JAX
    ``preferred_element_type=jnp.float32`` convention)."""
    return torch.einsum(eq, a.float(), b.float())


def mha_reference(
    q: torch.Tensor,  # [b, sq, hq, d]
    k: torch.Tensor,  # [b, sk, hkv, d]
    v: torch.Tensor,  # [b, sk, hkv, d]
    *,
    causal: bool = True,
    scale: float | None = None,
    logit_cap: float = 0.0,
    kv_mask: torch.Tensor | None = None,  # [b, sk] bool, True = attend
    q_positions: torch.Tensor | None = None,  # [b, sq] absolute positions
    window: int = 0,  # sliding window: attend to (q_pos - window, q_pos]
) -> torch.Tensor:
    b, sq, hq, d = q.shape
    hkv, sk = k.shape[2], k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    group = hq // hkv

    qg = (q.float() * scale).permute(0, 2, 1, 3).reshape(b, hkv, group, sq, d)
    kf = k.float().permute(0, 2, 1, 3)  # [b, hkv, sk, d]
    vf = v.float().permute(0, 2, 1, 3)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, kf)
    if logit_cap > 0.0:
        logits = logit_cap * torch.tanh(logits / logit_cap)

    mask = torch.ones((b, sq, sk), dtype=torch.bool, device=q.device)
    if causal or window > 0:
        qpos = (
            q_positions
            if q_positions is not None
            else torch.arange(sq, device=q.device).expand(b, sq)
        )
        kpos = torch.arange(sk, device=q.device)
        if causal:
            mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
        if window > 0:
            mask = mask & (kpos[None, None, :] > qpos[:, :, None] - window)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, :]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, vf)
    return out.reshape(b, hq, sq, d).permute(0, 2, 1, 3).to(q.dtype)


def chunk_decode_attention(
    q: torch.Tensor,  # [b, 1, hq, d]
    k_cache: torch.Tensor,  # [b, max_len, hkv, d] — read-only inside a chunk
    v_cache: torch.Tensor,
    k_buf: torch.Tensor,  # [b, chunk, hkv, d] — this chunk's new K rows
    v_buf: torch.Tensor,
    lengths: torch.Tensor,  # [b] valid main-cache prefix (at chunk START)
    step: int,  # current step within the chunk
    *,
    scale: float | None = None,
    logit_cap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Decode attention over main cache + chunk buffer with one joint
    softmax: main positions masked to < lengths, buffer positions to
    <= step (dense layout; the JAX function's ring option is not ported)."""
    b, sq, hq, d = q.shape
    hkv = k_cache.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    max_len, chunk = k_cache.shape[1], k_buf.shape[1]
    dev = q.device

    qg = (q.float() * scale).to(q.dtype).reshape(b, sq, hkv, group, d)
    s_main = _f32_einsum("bqhgd,bkhd->bhgqk", qg, k_cache)
    s_buf = _f32_einsum("bqhgd,bkhd->bhgqk", qg, k_buf)
    if logit_cap > 0.0:
        s_main = logit_cap * torch.tanh(s_main / logit_cap)
        s_buf = logit_cap * torch.tanh(s_buf / logit_cap)
    ar = torch.arange(max_len, device=dev)[None, :]
    main_mask = ar < lengths[:, None]
    if window > 0:
        # query's absolute position is lengths + step
        main_mask = main_mask & (ar > lengths[:, None] + step - window)
    ac = torch.arange(chunk, device=dev)[None, :]
    buf_mask = ac <= step
    if window > 0:
        buf_mask = buf_mask & (ac > step - window)
    s_main = torch.where(main_mask[:, None, None, None, :], s_main, NEG_INF)
    s_buf = torch.where(buf_mask[:, None, None, None, :], s_buf, NEG_INF)

    m = torch.maximum(
        s_main.amax(dim=-1, keepdim=True), s_buf.amax(dim=-1, keepdim=True)
    )
    p_main = torch.exp(s_main - m)
    p_buf = torch.exp(s_buf - m)
    denom = p_main.sum(dim=-1, keepdim=True) + p_buf.sum(dim=-1, keepdim=True)
    p_main = (p_main / denom).to(v_cache.dtype)
    p_buf = (p_buf / denom).to(v_buf.dtype)
    out = _f32_einsum("bhgqk,bkhd->bqhgd", p_main, v_cache) + _f32_einsum(
        "bhgqk,bkhd->bqhgd", p_buf, v_buf
    )
    return out.reshape(b, sq, hq, d).to(q.dtype)


def chunk_prefill_attention(
    q: torch.Tensor,  # [b, c, hq, d] — one prefill chunk's queries
    k_cache: torch.Tensor,  # [b, capacity, hkv, d] — chunk rows ALREADY written
    v_cache: torch.Tensor,
    cursors: torch.Tensor,  # [b] int32 — tokens resident BEFORE this chunk
    *,
    scale: float | None = None,
    logit_cap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Chunked-prefill attention (dense layout): query i of row b sits at
    absolute position cursors[b] + i and attends every cache row p with
    p <= cursors[b] + i (and p > cursors[b] + i - window when windowed).
    The chunk's rows are written before this call (write-then-attend).

    Every chunk width goes through ``flash_attention`` in its q_offsets
    mode. The JAX package keeps widths that are not a multiple of 8 on
    an einsum path, because a Pallas query block needs an 8-row tile; the
    CUDA kernel guards its rows and takes any width. The JAX reference
    path scales q in f32 and casts back to q.dtype before the dot, while
    the flash kernel keeps q * scale in f32: for power-of-two head dims
    the scale is a power of two, so both give the same values."""
    return flash_attention(
        q, k_cache, v_cache, causal=True, scale=scale,
        logit_cap=logit_cap, window=window, q_offsets=cursors,
    )


def paged_gather(k_pool, v_pool, tables, *, k_scales=None, v_scales=None, dtype=None):
    """[NB, B, hkv, d] pools -> dense [b, MB*B, hkv, d] views through
    [b, MB] block tables (clipped, like the JAX gather). Stale table
    entries gather stale blocks — callers mask by position. With
    ``k_scales``/``v_scales`` ([NB, B, hkv], int8 pools) the rows are
    dequantized in ``dtype``."""
    idx = tables.long().clamp(0, k_pool.shape[0] - 1)

    def take(pool, sc):
        g = pool[idx]  # [b, MB, B, hkv, d]
        b, MB, B, hkv, d = g.shape
        g = g.reshape(b, MB * B, hkv, d)
        if sc is not None:
            g = g.to(dtype) * sc[idx].reshape(b, MB * B, hkv)[..., None].to(dtype)
        return g

    return take(k_pool, k_scales), take(v_pool, v_scales)


def paged_chunk_decode_attention(
    q: torch.Tensor,  # [b, 1, hq, d]
    k_pool: torch.Tensor,  # [NB, B, hkv, d] (one layer's pool)
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [b, MB] int32
    k_buf: torch.Tensor,  # [b, chunk, hkv, d] — this chunk's new K rows
    v_buf: torch.Tensor,
    lengths: torch.Tensor,  # [b] int32 valid pool prefix (at chunk START)
    step: int,  # current step within the chunk
    *,
    scale: float | None = None,
    logit_cap: float = 0.0,
    window: int = 0,
    k_scales: torch.Tensor | None = None,  # [NB, B, hkv] f32 (int8 pool)
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """chunk_decode_attention reading the MAIN region through a block
    table: ``paged_decode_partials`` returns online-softmax partials for
    pool rows [lo, lengths), and they are merged here with the dense
    chunk-buffer region (positions lengths .. lengths + step) by one
    rescale — plain torch, as the merge is XLA outside the kernel in the
    JAX package. An int8 pool passes its scales; the buffer region stays
    in the model dtype."""
    b, sq, hq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    hi = lengths.to(torch.int32)
    if window > 0:
        lo = torch.clamp(hi + step - window + 1, min=0).to(torch.int32)
    else:
        lo = torch.zeros_like(hi)
    o_m, m_m, l_m = paged_decode_partials(
        q[:, 0].contiguous(), k_pool, v_pool, tables, lo, hi,
        scale=scale, logit_cap=logit_cap, k_scales=k_scales, v_scales=v_scales,
    )
    # buffer region: same mask set as chunk_decode_attention's buffer half
    hkv = k_buf.shape[2]
    group = hq // hkv
    chunk = k_buf.shape[1]
    qg = (q.float() * scale).reshape(b, 1, hkv, group, d)
    s_buf = _f32_einsum("bqhgd,bkhd->bhgqk", qg, k_buf)  # [b, hkv, g, 1, chunk]
    if logit_cap > 0.0:
        s_buf = logit_cap * torch.tanh(s_buf / logit_cap)
    ac = torch.arange(chunk, device=q.device)[None, :]
    buf_mask = ac <= step
    if window > 0:
        buf_mask = buf_mask & (ac > step - window)
    s_buf = torch.where(buf_mask[:, None, None, None, :], s_buf, NEG_INF)
    m_b = s_buf.amax(dim=-1)  # [b, hkv, g, 1]
    p_buf = torch.exp(s_buf - m_b[..., None])
    l_b = p_buf.sum(dim=-1)
    o_b = _f32_einsum("bhgqk,bkhd->bhgqd", p_buf, v_buf)  # UNNORMALIZED
    m_b = m_b.reshape(b, hq)
    l_b = l_b.reshape(b, hq)
    o_b = o_b.reshape(b, hq, d)
    # merge the two regions' online-softmax partials
    m = torch.maximum(m_m, m_b)
    a_m = torch.exp(m_m - m) * l_m
    a_b = torch.exp(m_b - m)
    denom = a_m + a_b * l_b
    denom = torch.where(denom == 0.0, 1.0, denom)
    out = (o_m * a_m[..., None] + o_b * a_b[..., None]) / denom[..., None]
    return out[:, None].to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, shape: tuple, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of exactly this shape,
    dtype and device — what the CUDA kernels index by raw pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_aligned(*tensors: torch.Tensor) -> None:
    """The kernels read K/V/Q rows with 16-byte vector loads."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("CUDA kernel inputs must start on a 16-byte boundary")


def _kernel_dtype(t: torch.Tensor, name: str) -> int:
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"{name}: CUDA kernel takes float32 or bfloat16, got {t.dtype}"
        ) from None


def _kernel_head_dim(d: int, name: str) -> None:
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: CUDA kernel head_dim must be one of {KERNEL_HEAD_DIMS}, got {d}")


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def flash_attention_plain(
    q, k, v, *, causal=True, scale=None, logit_cap=0.0, window=0, q_offsets=None,
):
    """Plain PyTorch version of the flash kernel: the same function,
    computed densely. Query row i of batch b sits at absolute position
    q_offsets[b] + i (0 + i without offsets); key rows are absolute
    positions. Masked pairs contribute exactly 0, so a fully-masked row
    gives 0 (the kernel's denominator-0 -> 1 rule)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = (q.float() * scale).permute(0, 2, 1, 3).reshape(b, hkv, group, sq, d)
    kf = k.float().permute(0, 2, 1, 3)  # [b, hkv, sk, d]
    vf = v.float().permute(0, 2, 1, 3)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf)
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    mask = torch.ones((b, sq, sk), dtype=torch.bool, device=q.device)
    if causal or window > 0:
        off = (
            q_offsets.long()[:, None]
            if q_offsets is not None
            else torch.zeros((b, 1), dtype=torch.long, device=q.device)
        )
        qpos = off + torch.arange(sq, device=q.device)[None, :]
        kpos = torch.arange(sk, device=q.device)[None, None, :]
        if causal:
            mask = mask & (kpos <= qpos[:, :, None])
        if window > 0:
            mask = mask & (kpos > qpos[:, :, None] - window)
    mask = mask[:, None, None]  # [b, 1, 1, sq, sk]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, vf) / denom
    return out.reshape(b, hq, sq, d).permute(0, 2, 1, 3).to(q.dtype)


def flash_attention(
    q: torch.Tensor,  # [b, sq, hq, d]
    k: torch.Tensor,  # [b, sk, hkv, d]
    v: torch.Tensor,  # [b, sk, hkv, d]
    *,
    causal: bool = True,
    scale: float | None = None,
    logit_cap: float = 0.0,
    window: int = 0,
    q_offsets: torch.Tensor | None = None,  # [b] int32 per-batch query offset
) -> torch.Tensor:
    """Blockwise online-softmax attention (replaces the Pallas
    ``_flash_kernel`` of gofr_tpu/ops/attention.py, both its q_offsets
    mode and its full-prompt mode). BSHD in and out, output in q.dtype.

    q_offsets (chunk-append prefill): query row i of batch b sits at
    absolute position q_offsets[b] + i while key positions stay absolute
    cache row indices. Without offsets (full-prompt mode) query row i is
    position i.

    CPU tensors run ``flash_attention_plain``; CUDA tensors launch
    csrc/flash_attention.cu (float32 or bfloat16, head_dim in
    KERNEL_HEAD_DIMS, contiguous) or raise."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, scale=scale, logit_cap=logit_cap,
            window=window, q_offsets=q_offsets,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    code = _kernel_dtype(q, "flash_attention")
    _kernel_head_dim(d, "flash_attention")
    _check(q, "q", (b, sq, hq, d), q.dtype, q.device)
    _check(k, "k", (b, sk, hkv, d), q.dtype, q.device)
    _check(v, "v", (b, sk, hkv, d), q.dtype, q.device)
    _check_aligned(q, k, v)
    if q_offsets is not None:
        _check(q_offsets, "q_offsets", (b,), torch.int32, q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention")
    err = fn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(q_offsets), _ptr(out),
        code, b, sq, sk, hq, hkv, d, int(causal), int(window),
        float(scale), float(logit_cap), _stream(q.device),
    )
    flash_attention.launches += 1
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    return out


flash_attention.launches = 0


def paged_decode_partials_plain(
    q, k_pool, v_pool, tables, lo, hi, *, scale, logit_cap=0.0, k_scales=None, v_scales=None,
):
    """Plain PyTorch version of the paged-decode kernels: gather the table
    rows densely (an int8 pool's rows dequantized in float32, each row
    times its scale, as the Pallas kernel does), attend over the valid
    band [lo, hi), and return the online-softmax partials (o normalized,
    m running max, l denominator; 0 / NEG_INF / 0 for an empty band)."""
    b, hq, d = q.shape
    NB, B, hkv, _ = k_pool.shape
    MB = tables.shape[1]
    group = hq // hkv
    kc, vc = paged_gather(
        k_pool, v_pool, tables, k_scales=k_scales, v_scales=v_scales, dtype=torch.float32
    )  # [b, MB*B, hkv, d]
    qg = (q.float() * scale).reshape(b, hkv, group, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, kc.float())
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    pos = torch.arange(MB * B, device=q.device)[None, :]
    band = (pos >= lo[:, None]) & (pos < hi[:, None])  # [b, MB*B]
    band = band[:, None, None, :]
    s = torch.where(band, s, NEG_INF)
    m = s.amax(dim=-1)  # [b, hkv, g]
    p = torch.where(band, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, vc.float())
    o = o / torch.where(l == 0.0, 1.0, l)[..., None]
    return o.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


def paged_decode_partials(
    q: torch.Tensor,  # [b, hq, d] one query per sequence
    k_pool: torch.Tensor,  # [NB, B, hkv, d]
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [b, MB] int32 pool block per logical slot
    lo: torch.Tensor,  # [b] int32 first valid logical position (window)
    hi: torch.Tensor,  # [b] int32 one past the last valid position
    *,
    scale: float,
    logit_cap: float = 0.0,
    k_scales: torch.Tensor | None = None,  # [NB, B, hkv] f32 (int8 pools)
    v_scales: torch.Tensor | None = None,
):
    """Paged-attention decode over the valid band [lo, hi), reading K/V
    blocks through the block table (replaces the Pallas
    ``_paged_decode_kernel`` / ``_paged_decode_partials`` of
    gofr_tpu/ops/attention.py, both variants). Returns
    (o [b, hq, d] f32 normalized, m [b, hq] f32, l [b, hq] f32).

    Pools of q's dtype take no scales. int8 pools take ``k_scales`` and
    ``v_scales``, one float32 per (block, row, KV head); each row is
    dequantized in float32 after the read.

    CPU tensors run ``paged_decode_partials_plain``; CUDA tensors launch
    csrc/paged_decode.cu (``gofr_paged_decode_partials``, or
    ``gofr_paged_decode_partials_int8`` with scales) or raise."""
    b, hq, d = q.shape
    NB, B, hkv, _ = k_pool.shape
    MB = tables.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("paged_decode_partials: pass both k_scales and v_scales, or neither")
    quantized = k_scales is not None
    if q.device.type == "cpu":
        return paged_decode_partials_plain(
            q, k_pool, v_pool, tables, lo, hi, scale=scale, logit_cap=logit_cap,
            k_scales=k_scales, v_scales=v_scales,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_partials: unsupported device {q.device}")
    code = _kernel_dtype(q, "paged_decode_partials")
    _kernel_head_dim(d, "paged_decode_partials")
    if hq // hkv > 16:
        raise ValueError(f"paged_decode_partials: GQA group {hq // hkv} > 16")
    pool_dtype = torch.int8 if quantized else q.dtype
    _check(q, "q", (b, hq, d), q.dtype, q.device)
    _check(k_pool, "k_pool", (NB, B, hkv, d), pool_dtype, q.device)
    _check(v_pool, "v_pool", (NB, B, hkv, d), pool_dtype, q.device)
    if quantized:
        _check(k_scales, "k_scales", (NB, B, hkv), torch.float32, q.device)
        _check(v_scales, "v_scales", (NB, B, hkv), torch.float32, q.device)
    _check(tables, "tables", (b, MB), torch.int32, q.device)
    _check(lo, "lo", (b,), torch.int32, q.device)
    _check(hi, "hi", (b,), torch.int32, q.device)
    _check_aligned(q, k_pool, v_pool)
    o = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    if b == 0:
        return o, m, l
    tail = (
        _ptr(o), _ptr(m), _ptr(l), code, b, hq, hkv, d, NB, B, MB,
        float(scale), float(logit_cap), _stream(q.device),
    )
    if quantized:
        err = _build.function("paged_decode_int8")(
            _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(k_scales), _ptr(v_scales),
            _ptr(tables), _ptr(lo), _ptr(hi), *tail,
        )
        paged_decode_partials.launches_int8 += 1
    else:
        err = _build.function("paged_decode")(
            _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(tables), _ptr(lo), _ptr(hi), *tail,
        )
        paged_decode_partials.launches += 1
    if err:
        raise RuntimeError(f"paged_decode_partials kernel launch failed: CUDA error {err}")
    return o, m, l


paged_decode_partials.launches = 0  # bf16/f32 pool kernel
paged_decode_partials.launches_int8 = 0  # int8 pool kernel


def paged_decode_plan(pool_dtype, b, hq, hkv, d, block, table_width) -> tuple[int, int]:
    """(splits, shared-memory bytes per CTA) of the paged-decode launch for
    these shapes on the current CUDA device: the kernel runs a cluster of
    ``splits`` CTAs per (sequence, KV head), each walking its share of the
    band's table slots (csrc/paged_decode.cu)."""
    splits, smem = ctypes.c_int(0), ctypes.c_int(0)
    elem = torch.empty((), dtype=pool_dtype).element_size()
    err = _build.function("paged_decode_plan")(
        elem, b, hq, hkv, d, block, table_width, ctypes.byref(splits), ctypes.byref(smem)
    )
    if err:
        raise RuntimeError(f"paged_decode_plan failed: CUDA error {err}")
    return splits.value, smem.value
