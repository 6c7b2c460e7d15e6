"""GPU smoke run of the PyTorch/CUDA port (gofr_tpu_torch) on one card.

    python3 chip_smoke.py [--parent TREE]

Phases, each raising on failure:

1. device — require CUDA, print the card's name and power limit, turn TF32
   off for float32 products;
2. build — compile the CUDA kernels from gofr_tpu_torch/csrc (one nvcc per
   source, in parallel) into build/kernels; print each kernel's registers
   and spill bytes (a bf16 flash kernel or a paged-decode kernel that
   spills fails), the count of tensor-core (HMMA) instructions per kernel
   in the flash library's SASS (a bf16 flash kernel without any fails),
   and the paged-decode launch plan at the serving shape (cluster splits,
   shared memory per CTA; an unsplit launch fails);
3. kernels — hold each kernel (flash attention, paged decode over bf16/f32
   pools, paged decode over int8 pools) against its plain PyTorch version
   at the serving path's Gemma-2B shapes, with bfloat16 and float32
   queries, and time the kernel two ways (20 launches back to back from
   Python with CUDA events, which includes the wrapper's host path, and
   the same launches under torch.profiler, the kernel's own device time),
   the plain version, one PyTorch library call where one computes the
   same function, and the card's bound for the same work. With --parent,
   another checkout's paged-decode kernels (e.g. the parent commit
   unpacked by git archive) are built and timed on the same inputs, in
   turns with this tree's;
4. engine — serve concurrent Gemma-2B requests (full width and depth,
   random weights from a seeded generator) through the port's LLMEngine
   at its defaults, check every stream, check every served token against
   greedy decoding by the plain full-prompt forward, and check that both
   kernels launched during this phase;
5. int8 engine — the same burst through LLMEngine(kv_int8=True,
   quantize=True) on the same weights: int8 weights and an int8 KV pool
   read by the int8 paged-decode kernel; every served token checked
   against the plain forward on the same int8 weights, under a gap
   constant set from this path's measured logit drift;
6. report — a "kernels" JSON line, then the last line
   {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package. Exits non-zero,
printing no result, when no GPU is visible.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from gofr_tpu_torch.kvcache import gather_slots, quantize_rows, scatter_rows
from gofr_tpu_torch.llm import KV_BLOCK, GenRequest, LLMEngine
from gofr_tpu_torch.models import (
    KVCache,
    QTensor,
    TransformerConfig,
    decode_chunk_paged,
    init_params,
    prefill_append,
    qmm,
    transformer_forward,
)
from gofr_tpu_torch.models import transformer as T
from gofr_tpu_torch.ops import _build
from gofr_tpu_torch.ops import attention as A

SEED = 0  # inputs, weights and prompts are all made from it

# Tolerances (kernel vs its plain version on the same inputs).
# float32: both sides accumulate in f32 and differ only in summation order.
F32_ATOL = 1e-4
# bfloat16 output: rounded to an 8-bit mantissa, so 1 ulp is ~0.4-0.8%.
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2
# paged partials m and l are f32 in both dtypes: summation order only.
ML_RTOL = 1e-4
# A served token must equal the argmax of the plain forward's logits
# unless the plain top-2 gap is below this: the served path runs the
# sequence in bf16 through other chunkings and kernels, and bf16 rounding
# across 18 layers moves logits by a few hundredths (measured: see the
# "logit drift" line this script prints).
TOKEN_GAP = 0.25
# The int8 engine's tokens are checked against the plain forward on the
# same int8 weights (W8A8 products, unquantized K/V, no kernels); the
# served path adds the int8 KV round trip and weight-only decode products.
# INT8_TOKEN_GAP is at least twice that path's measured logit drift (the
# "int8 logit drift" line: 0.3555 on an H100 80GB HBM3 at 700 W), and at
# most 1 token in 8 may need it.
INT8_TOKEN_GAP = 1.0

# Published dense peaks (NVIDIA data sheets) by the name nvidia-smi reports:
# memory bytes/s, bf16 tensor-core FLOP/s, f32 (non-tensor) FLOP/s.
CARD_PEAKS = {
    "H100 80GB HBM3": (3.35e12, 989e12, 67e12),  # H100 SXM
}


def card_peaks(name: str):
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return key, peaks
    raise RuntimeError(f"no peak figures for card {name!r}; add its data sheet row to CARD_PEAKS")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Device time of one launch of the kernel whose name contains
    ``kernel``: the same launches as time_ms, run under torch.profiler, and
    the kernel's self device time over its launch count. No host time is
    in it, where time_ms of a short kernel is paced by the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and kernel in e.key]
    count = sum(e.count for e in ev)
    if count != iters:
        raise AssertionError(f"profiler saw {count} launches of {kernel!r}, expected {iters}")
    return sum(e.self_device_time_total for e in ev) / count / 1e3


def phase_device() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    key, peaks = card_peaks(name)
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; peaks from data sheet row {key!r}: "
          f"{peaks[0] / 1e12} TB/s, {peaks[1] / 1e12} TFLOP/s bf16, {peaks[2] / 1e12} TFLOP/s f32")
    return {"smi": smi, "name": name, "peaks": peaks}


def phase_build() -> None:
    t0 = time.perf_counter()
    report = _build.build()
    spills = []
    for name, r in report.items():
        print(f"build {name}: {r['seconds']:.2f}s cached={r['cached']}")
        for kern, p in _build.ptxas_kernels(r["ptxas"]).items():
            print(f"  ptxas {kern}: {p['registers']} registers, {p['spill_bytes']} spill bytes")
            if ("flash_mma_kernel" in kern or "paged_decode_kernel" in kern) and p["spill_bytes"]:
                spills.append(f"{kern} spills {p['spill_bytes']} bytes")
    print(f"build total {time.perf_counter() - t0:.2f}s")
    if spills:
        raise AssertionError("; ".join(spills))
    # the bf16 flash kernels must run on the tensor cores
    hmma = _build.sass_hmma(_build.library_path("flash_attention"))
    print("sass HMMA per kernel in the flash library: " + ", ".join(f"{k} {n}" for k, n in sorted(hmma.items())))
    mma = {k: n for k, n in hmma.items() if "flash_mma_kernel" in k}
    if not mma or not all(mma.values()):
        raise AssertionError(f"bf16 flash kernels without tensor-core instructions: {hmma}")
    # the paged kernels at the serving shape (32 slots, Gemma-2B's group of
    # 8 on one KV head, head_dim 256, 16-row blocks, 32 table slots): the
    # registers of its instantiations (D = 256, group 8) and the launch plan
    for r in report.values():
        for kern, p in _build.ptxas_kernels(r["ptxas"]).items():
            if "paged_decode_kernel" in kern and "Li256ELi8E" in kern:
                print(f"paged_decode_kernel at the serving shape: {kern}: {p['registers']} registers, "
                      f"{p['spill_bytes']} spill bytes")
    for pool in (torch.bfloat16, torch.int8):
        splits, smem = A.paged_decode_plan(pool, 32, 8, 1, 256, 16, 32)
        print(f"paged_decode plan, {str(pool)[6:]} pools at the serving shape: {splits} splits "
              f"({32 * splits} CTAs in clusters of {splits}), {smem} bytes of dynamic shared memory per CTA")
        if splits <= 1:
            raise AssertionError(f"paged decode at 32 slots is not split: {splits}")


def _flash_work(q, k, off, causal, window):
    """(bytes, flops, valid pairs) the flash function needs on these inputs."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    qpos = (off.long()[:, None] if off is not None else torch.zeros((b, 1), dtype=torch.long, device=q.device)) \
        + torch.arange(sq, device=q.device)[None, :]
    kpos = torch.arange(sk, device=q.device)[None, None, :]
    mask = torch.ones((b, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos[:, :, None]
    if window > 0:
        mask &= kpos > qpos[:, :, None] - window
    pairs = int(mask.sum()) * hq
    # K and V rows: only those some query of the batch attends to
    kv_rows = int(mask.any(dim=1).sum())
    nbytes = 2 * q.numel() * q.element_size() + 2 * kv_rows * k.shape[2] * d * k.element_size()
    nbytes += 0 if off is None else off.numel() * 4
    return nbytes, 4 * d * pairs, mask


def _bound(nbytes, flops, dtype, peaks):
    bw, bf16, f32 = peaks
    t_mem = nbytes / bw
    t_ops = flops / (bf16 if dtype == torch.bfloat16 else f32)
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def build_parent(tree: str) -> dict:
    """The paged-decode entry points of another checkout (``tree``, e.g. the
    parent commit unpacked by git archive), built from its own sources with
    this build's nvcc flags. The C interface is the same, so both trees'
    kernels take the same arguments."""
    src = Path(tree) / "gofr_tpu_torch" / "csrc" / "paged_decode.cu"
    out = _build.BUILD_DIR / "parent_paged_decode.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)], check=True, capture_output=True)
    print(f"build parent paged_decode from {src}: {time.perf_counter() - t0:.2f}s")
    lib = ctypes.CDLL(str(out))
    fns = {}
    for name in ("paged_decode", "paged_decode_int8"):
        _src, symbol, argtypes = _build.KERNELS[name]
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def _time_parent(fn, t: dict, kernel, args, scales: dict) -> None:
    """Time the parent tree's paged kernel on the same inputs, device-only
    and back to back, in turns with this tree's (parent, this, parent):
    adds parent_device_ms (both parent readings), device_ms_again and
    parent_ms to the timing row ``t``; checks the parent's partials
    against this tree's kernel."""
    q, kp, vp, tables, lo, hi = args
    b, hq, d = q.shape
    NB, B, hkv, _ = kp.shape

    def call():
        o = torch.empty((b, hq, d), dtype=torch.float32, device="cuda")
        m = torch.empty((b, hq), dtype=torch.float32, device="cuda")
        l = torch.empty((b, hq), dtype=torch.float32, device="cuda")
        head = (q, kp, vp) + ((scales["k_scales"], scales["v_scales"]) if scales else ()) + (tables, lo, hi)
        err = fn(*map(A._ptr, head), A._ptr(o), A._ptr(m), A._ptr(l), A._DTYPE_CODES[q.dtype], b, hq, hkv, d,
                 NB, B, tables.shape[1], 1 / 16, 0.0, A._stream(q.device))
        if err:
            raise RuntimeError(f"parent paged kernel launch failed: CUDA error {err}")
        return o, m, l

    for a, w in zip(call(), kernel()):
        torch.cuda.synchronize()
        if not torch.allclose(a, w, rtol=ML_RTOL, atol=F32_ATOL):
            raise AssertionError("parent and this tree's paged kernels disagree")
    first = device_ms(call, "paged_decode_kernel")
    t["device_ms_again"] = device_ms(kernel, "paged_decode_kernel")
    t["parent_device_ms"] = [first, device_ms(call, "paged_decode_kernel")]
    t["parent_ms"] = time_ms(call)
    print(f"  parent tree's kernel, same inputs, in turns: device {t['parent_device_ms'][0]:.4f} / "
          f"{t['parent_device_ms'][1]:.4f} ms (this tree's again {t['device_ms_again']:.4f} ms), "
          f"back to back {t['parent_ms']:.4f} ms; ratio {t['device_ms'] / min(t['parent_device_ms']):.3f}")


def phase_kernels(dev: dict, seed: int, parent: dict | None = None) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    peaks = dev["peaks"]
    errs = {"flash_attention": 0.0, "paged_decode_partials": 0.0}
    timings = {}

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    # -- kernel 1: flash_attention (Gemma-2B: 8 q heads, 1 kv head, hd 256)
    cap = 512
    flash_cases = [
        # (name, nb, c, offsets or None, causal, window, cap)
        ("offsets c16", 8, 16, [0, 37, 16, 200, 300, 480, 496, 5], True, 0, 0.0),
        ("offsets c64", 8, 64, [0, 37, 64, 100, 255, 400, 448, 1], True, 0, 0.0),
        ("full causal S512", 2, 512, None, True, 0, 0.0),
        ("full non-causal S512", 2, 512, None, False, 0, 0.0),
        ("window 100 offsets c64", 8, 64, [0, 37, 64, 100, 255, 400, 448, 1], True, 100, 0.0),
        ("window 128 full S512", 2, 512, None, True, 128, 0.0),
        ("logit cap 50 offsets c16", 8, 16, [0, 37, 16, 200, 300, 480, 496, 5], True, 0, 50.0),
        ("offsets c12 (not 8-aligned)", 8, 12, [0, 37, 16, 200, 300, 480, 500, 5], True, 0, 0.0),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for name, nb, c, offs, causal, window, lcap in flash_cases:
            q = rnd(nb, c, 8, 256, dtype=dtype)
            k = rnd(nb, cap, 1, 256, dtype=dtype)
            v = rnd(nb, cap, 1, 256, dtype=dtype)
            off = None if offs is None else torch.tensor(offs, dtype=torch.int32, device="cuda")
            kw = dict(causal=causal, window=window, logit_cap=lcap, q_offsets=off)
            got = A.flash_attention(q, k, v, **kw)
            want = A.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                ok = err <= F32_ATOL
            else:
                ok = torch.allclose(got.float(), want.float(), atol=BF16_ATOL, rtol=BF16_RTOL)
            print(f"flash_attention {str(dtype)[6:]:8s} {name:28s} max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention disagrees with its plain version: {name} {dtype}")
            errs["flash_attention"] = max(errs["flash_attention"], err)

    # timing at the serving step's shapes (bf16)
    for c, offs in ((16, [0, 37, 16, 200, 300, 480, 496, 5]), (64, [0, 37, 64, 100, 255, 400, 448, 1])):
        q = rnd(8, c, 8, 256, dtype=torch.bfloat16)
        k = rnd(8, cap, 1, 256, dtype=torch.bfloat16)
        v = rnd(8, cap, 1, 256, dtype=torch.bfloat16)
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        nbytes, flops, mask = _flash_work(q, k, off, True, 0)
        bound_ms, bound_by = _bound(nbytes, flops, torch.bfloat16, peaks)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        amask = mask[:, None]  # [b, 1, sq, sk], True = attend

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=amask, scale=1 / 16, enable_gqa=True
            )

        t = {
            "ms": time_ms(lambda: A.flash_attention(q, k, v, q_offsets=off)),
            "device_ms": device_ms(lambda: A.flash_attention(q, k, v, q_offsets=off), "flash_mma_kernel"),
            "plain_ms": time_ms(lambda: A.flash_attention_plain(q, k, v, q_offsets=off)),
            "library_ms": time_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        timings[f"flash_attention c{c}"] = t
        print(f"timing flash_attention c={c}: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), "
              f"plain {t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")

    # full-prompt mode (kernel row 2: the wave scheduler's monolithic
    # prefill, not on the chunked main path): one 512-token prompt
    q = rnd(1, 512, 8, 256, dtype=torch.bfloat16)
    k = rnd(1, 512, 1, 256, dtype=torch.bfloat16)
    v = rnd(1, 512, 1, 256, dtype=torch.bfloat16)
    nbytes, flops, _mask = _flash_work(q, k, None, True, 0)
    bound_ms, bound_by = _bound(nbytes, flops, torch.bfloat16, peaks)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    t = {
        "ms": time_ms(lambda: A.flash_attention(q, k, v)),
        "device_ms": device_ms(lambda: A.flash_attention(q, k, v), "flash_mma_kernel"),
        "plain_ms": time_ms(lambda: A.flash_attention_plain(q, k, v)),
        "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=1 / 16, enable_gqa=True)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    timings["flash_attention full S512"] = t
    print(f"timing flash_attention full causal S=512: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), "
          f"plain {t['plain_ms']:.4f} ms, "
          f"sdpa {t['library_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")

    # -- kernel 2: paged_decode_partials (32 slots, 1024 blocks of 16 rows)
    NB, B, MB, nb = 1024, 16, 32, 32
    lengths = [0, 1, 16, 511, 17, 33, 64, 100] + [(37 * i) % 500 + 2 for i in range(24)]
    for dtype in (torch.bfloat16, torch.float32):
        q = rnd(nb, 8, 256, dtype=dtype)
        kp = rnd(NB, B, 1, 256, dtype=dtype)
        vp = rnd(NB, B, 1, 256, dtype=dtype)
        tables = torch.randperm(NB, generator=g, device="cuda")[: nb * MB].reshape(nb, MB).to(torch.int32)
        hi = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        for name, lo, lcap in (
            ("full band", torch.zeros_like(hi), 0.0),
            ("window band lo>0", torch.clamp(hi - 40, min=0).to(torch.int32), 0.0),
            ("logit cap 30", torch.zeros_like(hi), 30.0),
        ):
            kw = dict(scale=1 / 16, logit_cap=lcap)
            o1, m1, l1 = A.paged_decode_partials(q, kp, vp, tables, lo, hi, **kw)
            o2, m2, l2 = A.paged_decode_partials_plain(q, kp, vp, tables, lo, hi, **kw)
            torch.cuda.synchronize()
            err = (o1 - o2).abs().max().item()
            ok = (
                err <= F32_ATOL
                and torch.allclose(m1, m2, rtol=ML_RTOL, atol=0.0)
                and torch.allclose(l1, l2, rtol=ML_RTOL, atol=0.0)
            )
            print(f"paged_decode_partials {str(dtype)[6:]:8s} {name:18s} o max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"paged_decode_partials disagrees with its plain version: {name} {dtype}")
            errs["paged_decode_partials"] = max(errs["paged_decode_partials"], err)

    q = rnd(nb, 8, 256, dtype=torch.bfloat16)
    kp = rnd(NB, B, 1, 256, dtype=torch.bfloat16)
    vp = rnd(NB, B, 1, 256, dtype=torch.bfloat16)
    tables = torch.randperm(NB, generator=g, device="cuda")[: nb * MB].reshape(nb, MB).to(torch.int32)
    hi = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    lo = torch.zeros_like(hi)
    rows = int(hi.sum())
    # band rows of K and V, the table entries that name their blocks, lo and
    # hi, and the f32 outputs o, m, l
    table_entries = int(((hi + B - 1) // B).sum())
    nbytes = q.numel() * 2 + 2 * rows * 256 * 2 + table_entries * 4 + 2 * nb * 4 + (nb * 8 * 256 + 2 * nb * 8) * 4
    bound_ms, bound_by = _bound(nbytes, 4 * 256 * 8 * rows, torch.bfloat16, peaks)
    def kernel():
        return A.paged_decode_partials(q, kp, vp, tables, lo, hi, scale=1 / 16)

    t = {
        "ms": time_ms(kernel),
        "device_ms": device_ms(kernel, "paged_decode_kernel"),
        "plain_ms": time_ms(lambda: A.paged_decode_partials_plain(q, kp, vp, tables, lo, hi, scale=1 / 16)),
        "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    timings["paged_decode_partials"] = t
    print(f"timing paged_decode_partials: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), "
          f"plain {t['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), {rows} band rows")
    if parent:
        _time_parent(parent["paged_decode"], t, kernel, (q, kp, vp, tables, lo, hi), {})
    # what a launch costs with no row to read, and per table slot: every
    # sequence's band k shares of 16-row slots long (8 splits at this shape)
    splits = A.paged_decode_plan(torch.bfloat16, nb, 8, 1, 256, B, MB)[0]
    by_slots = {}
    for k in (0, 1, 2, 4):
        hi_k = torch.full((nb,), k * splits * B, dtype=torch.int32, device="cuda")
        by_slots[k] = device_ms(lambda: A.paged_decode_partials(q, kp, vp, tables, lo, hi_k, scale=1 / 16),
                                "paged_decode_kernel")
    t["device_ms_by_slots_per_cta"] = by_slots
    print("paged_decode_partials device ms by table slots per CTA (every band the same length): "
          + ", ".join(f"{k}: {v:.4f}" for k, v in by_slots.items()))

    # -- kernel 3: paged_decode_partials over int8 pools (same shapes; rows
    # made by the port's own quantize_rows). Both sides dequantize in f32,
    # so o differs only by summation order: F32_ATOL, m and l ML_RTOL.
    errs["paged_decode_partials_int8"] = 0.0
    kq, ks = quantize_rows(rnd(NB, B, 1, 256, dtype=torch.float32))
    vq, vs = quantize_rows(rnd(NB, B, 1, 256, dtype=torch.float32))
    for dtype in (torch.bfloat16, torch.float32):
        q = rnd(nb, 8, 256, dtype=dtype)
        tables = torch.randperm(NB, generator=g, device="cuda")[: nb * MB].reshape(nb, MB).to(torch.int32)
        hi = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        for name, lo, lcap in (
            ("full band", torch.zeros_like(hi), 0.0),
            ("window band lo>0", torch.clamp(hi - 40, min=0).to(torch.int32), 0.0),
            ("logit cap 30", torch.zeros_like(hi), 30.0),
        ):
            kw = dict(scale=1 / 16, logit_cap=lcap, k_scales=ks, v_scales=vs)
            o1, m1, l1 = A.paged_decode_partials(q, kq, vq, tables, lo, hi, **kw)
            o2, m2, l2 = A.paged_decode_partials_plain(q, kq, vq, tables, lo, hi, **kw)
            torch.cuda.synchronize()
            err = (o1 - o2).abs().max().item()
            ok = (
                err <= F32_ATOL
                and torch.allclose(m1, m2, rtol=ML_RTOL, atol=0.0)
                and torch.allclose(l1, l2, rtol=ML_RTOL, atol=0.0)
            )
            print(f"paged_decode_partials int8 q {str(dtype)[6:]:8s} {name:18s} o max_abs_err {err:.3e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"int8 paged_decode_partials disagrees with its plain version: {name} {dtype}")
            errs["paged_decode_partials_int8"] = max(errs["paged_decode_partials_int8"], err)

    q = rnd(nb, 8, 256, dtype=torch.bfloat16)
    tables = torch.randperm(NB, generator=g, device="cuda")[: nb * MB].reshape(nb, MB).to(torch.int32)
    hi = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    lo = torch.zeros_like(hi)
    rows = int(hi.sum())
    table_entries = int(((hi + B - 1) // B).sum())
    # band rows of K and V (1 byte per element) and their f32 scales (one
    # per row per tensor), the table entries that name their blocks, lo and
    # hi, and the f32 outputs o, m, l. The dots run on dequantized f32
    # values, so the operations count against the f32 peak.
    nbytes = (q.numel() * 2 + 2 * rows * 256 + 2 * rows * 4 + table_entries * 4 + 2 * nb * 4
              + (nb * 8 * 256 + 2 * nb * 8) * 4)
    bound_ms, bound_by = _bound(nbytes, 4 * 256 * 8 * rows, torch.float32, peaks)
    kw = dict(scale=1 / 16, k_scales=ks, v_scales=vs)
    def kernel_int8():
        return A.paged_decode_partials(q, kq, vq, tables, lo, hi, **kw)

    t = {
        "ms": time_ms(kernel_int8),
        "device_ms": device_ms(kernel_int8, "paged_decode_kernel"),
        "plain_ms": time_ms(lambda: A.paged_decode_partials_plain(q, kq, vq, tables, lo, hi, **kw)),
        "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    timings["paged_decode_partials_int8"] = t
    print(f"timing paged_decode_partials int8: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), "
          f"plain {t['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), {rows} band rows")
    if parent:
        _time_parent(parent["paged_decode_int8"], t, kernel_int8, (q, kq, vq, tables, lo, hi),
                     dict(k_scales=ks, v_scales=vs))
    return {"errs": errs, "timings": timings}


def _serve(eng, prompts, new_tokens):
    """Submit every prompt from its own client thread at once; returns
    ({i: tokens}, {i: request}, wall seconds)."""
    results: dict[int, list[int]] = {}
    reqs: dict[int, GenRequest] = {}
    errors: list[BaseException] = []

    def client(i):
        try:
            r = eng.submit(GenRequest(prompts[i], max_new_tokens=new_tokens))
            reqs[i] = r
            results[i] = r.tokens(timeout=600)
        except BaseException as e:  # surfaced below, after every client joined
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads):
        raise TimeoutError("engine clients did not finish")
    return results, reqs, wall


def _profile(fn) -> None:
    """Run fn under torch.profiler and print the device's busy share and
    the kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    groups: dict[str, list] = {}
    for e in kern:
        name = e.key
        group = (
            "paged_decode_kernel" if "paged_decode_kernel" in name
            else "flash kernels" if "flash_" in name and "_kernel" in name
            else "matmul" if any(t in name.lower() for t in ("gemm", "gemv", "xmma", "cutlass", "nvjet"))
            else "other"
        )
        g = groups.setdefault(group, [0.0, 0])
        g[0] += e.self_device_time_total
        g[1] += e.count
    print(f"profile (engine traffic again, under the profiler): wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
          f"idle {100 * (1 - busy_us / wall_us):.1f}%")
    for group, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"profile group {group:20s} {us / 1e3:9.2f} ms device  {n:7d} launches  "
              f"{100 * us / busy_us:5.1f}% of busy")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile kernel {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x {e.key[:90]}")


def phase_engine(dev: dict, seed: int) -> dict:
    cfg = TransformerConfig.gemma_2b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    n_params = sum(w.numel() for w in [params["embed"], params["final_norm"], *params["layers"].values()])
    print(f"gemma_2b random weights: {n_params / 1e9:.3f} B params bf16 in {time.perf_counter() - t0:.1f}s")
    eng = LLMEngine(cfg, params, seed=seed)  # defaults: 32 slots, 512, {16, 64}, 256, K=8, B=16
    try:
        # warm-up request: cuBLAS handles and allocator pools, outside the timed run
        eng.generate([1, 2, 3], max_new_tokens=4)
        rng = np.random.default_rng(seed)
        plens = [5, 16, 17, 63, 64, 65, 200, 440]
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in plens]
        new_tokens = 32
        A.flash_attention.launches = 0
        A.paged_decode_partials.launches = 0
        A.paged_decode_partials.launches_int8 = 0
        results, reqs, wall = _serve(eng, prompts, new_tokens)
        launches = {
            "flash_attention": A.flash_attention.launches,
            "paged_decode_partials": A.paged_decode_partials.launches,
        }
        stats = eng.stats()
        # the same traffic once more under torch.profiler: where the device
        # time goes (the profiler slows the host, so this pass is not timed)
        _profile(lambda: _serve(eng, prompts, new_tokens))
    finally:
        eng.close()

    total = 0
    for i, toks in sorted(results.items()):
        if len(toks) != new_tokens or any(t < 0 or t >= cfg.vocab_size for t in toks):
            raise AssertionError(f"request {i} (prompt {plens[i]}): bad stream {toks}")
        total += len(toks)
    if len(results) != len(prompts):
        raise AssertionError(f"{len(results)} of {len(prompts)} requests finished")

    # every served token against greedy decoding by the plain full-prompt
    # forward (no kernels), teacher-forced on the served stream: token j
    # must be the plain argmax after prompt + served[:j]. The first token
    # comes from prefill (flash kernel), the rest from the decode chunks
    # (paged kernel, partials merge, chunk-end scatter through the tables).
    checked = exempt = 0
    for i, p in enumerate(prompts):
        seq = p + results[i][:-1]
        logits = transformer_forward(
            params, cfg, torch.tensor([seq], device="cuda"), torch.arange(len(seq), device="cuda")[None, :]
        )[0, len(p) - 1 :]  # [new_tokens, vocab]
        top2 = torch.topk(logits, 2, dim=-1)
        gaps = (top2.values[:, 0] - top2.values[:, 1]).tolist()
        want = top2.indices[:, 0].tolist()
        n_match = n_exempt = 0
        for j, served in enumerate(results[i]):
            if served == want[j]:
                n_match += 1
            elif gaps[j] < TOKEN_GAP:
                n_exempt += 1
            else:
                raise AssertionError(
                    f"request {i} (prompt {plens[i]}): token {j} served {served} != plain argmax {want[j]}, "
                    f"gap {gaps[j]:.4f}"
                )
        checked += n_match
        exempt += n_exempt
        print(f"stream prompt {plens[i]:3d}: {n_match} of {len(results[i])} tokens equal the plain greedy argmax, "
              f"{n_exempt} differ within tolerance (top-2 gap < {TOKEN_GAP}); smallest gap {min(gaps):.4f}")
        del logits

    # logit drift between the served path (64-token chunks through the
    # flash kernel) and the plain forward, on one prompt
    p = prompts[6]
    k0 = torch.zeros(
        (cfg.n_layers, 1, eng.kv.capacity, cfg.n_kv_heads, cfg.head_dim), dtype=cfg.dtype, device="cuda"
    )
    view = KVCache(k=k0, v=k0.clone(), length=torch.zeros(1, dtype=torch.int32, device="cuda"))
    cur = 0
    for c0 in range(0, len(p), 64):
        chunk = p[c0 : c0 + 64]
        toks = torch.zeros((1, 64), dtype=torch.long, device="cuda")
        toks[0, : len(chunk)] = torch.tensor(chunk, device="cuda")
        logits_c, view = prefill_append(
            params, cfg, toks, view,
            torch.tensor([cur], dtype=torch.int32, device="cuda"),
            torch.tensor([len(chunk)], dtype=torch.int32, device="cuda"),
        )
        cur += len(chunk)
    plain = transformer_forward(
        params, cfg, torch.tensor([p], device="cuda"), torch.arange(len(p), device="cuda")[None, :],
        unembed_positions=torch.tensor([len(p) - 1], device="cuda"),
    )[0, 0]
    drift = float((logits_c[0] - plain).abs().max())
    print(f"logit drift, served chunked path vs plain forward (prompt {len(p)}): max_abs {drift:.4f}")
    if not math.isfinite(drift) or drift >= TOKEN_GAP:
        raise AssertionError(f"served-path logits drift {drift} >= {TOKEN_GAP}")

    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched while the engine served")
    ttfts = sorted(reqs[i].first_token_at - reqs[i].submitted_at for i in reqs)
    out = {
        "requests": len(results), "tokens": total, "wall_s": wall, "tok_s": total / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1], "launches": launches,
        "steps": stats["steps"] - 1, "tokens_matched": checked, "tokens_exempt": exempt,
    }
    print(
        f"engine gemma_2b on {dev['smi']}: {out['requests']} requests, {total} tokens in {wall:.3f}s "
        f"= {out['tok_s']:.1f} tok/s; ttft p50 {out['ttft_p50_s']:.3f}s max {out['ttft_max_s']:.3f}s; "
        f"launches {launches}"
    )
    return out


def _tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, QTensor):
        return _tensor_bytes(tree.q) + _tensor_bytes(tree.s)
    return tree.numel() * tree.element_size()


def _int8_path_drift(cfg, qparams, prompt, capacity, steps=8):
    """Logit drift of the int8 serving path against the plain forward on
    the same int8 weights: the prompt is prefilled in 64-token chunks
    through an int8 pool (each chunk's view gathered and dequantized, its
    rows quantized again at the scatter, as the engine's unified step
    does), then ``steps`` greedy decode steps run through the int8 kernel.
    Returns the largest |served - plain| logit over the prefill's last
    position and every decode step."""
    L, MB = cfg.n_layers, capacity // KV_BLOCK
    shape = (L, MB, KV_BLOCK, cfg.n_kv_heads, cfg.head_dim)
    pool = KVCache(
        k=torch.zeros(shape, dtype=torch.int8, device="cuda"),
        v=torch.zeros(shape, dtype=torch.int8, device="cuda"),
        length=torch.zeros(1, dtype=torch.int32, device="cuda"),
    )
    scales = torch.zeros((2,) + shape[:-1], dtype=torch.float32, device="cuda")
    tables = torch.arange(MB, dtype=torch.int32, device="cuda")[None]
    cur = 0
    for c0 in range(0, len(prompt), 64):
        chunk = prompt[c0 : c0 + 64]
        toks = torch.zeros((1, 64), dtype=torch.long, device="cuda")
        toks[0, : len(chunk)] = torch.tensor(chunk, device="cuda")
        cursors = torch.tensor([cur], dtype=torch.int32, device="cuda")
        view = gather_slots(pool.k, pool.v, tables, cursors, scales=(scales[0], scales[1]), dtype=cfg.dtype)
        logits_c, view = prefill_append(
            qparams, cfg, toks, view, cursors, torch.tensor([len(chunk)], dtype=torch.int32, device="cuda")
        )
        pos = torch.arange(cur, cur + len(chunk), device="cuda")[None]
        scatter_rows(
            pool.k, pool.v, tables, view.k[:, :, cur : cur + len(chunk)], view.v[:, :, cur : cur + len(chunk)],
            pos, torch.ones_like(pos, dtype=torch.bool), scales=scales,
        )
        cur += len(chunk)
    pool.length.fill_(cur)
    served = [logits_c[0]]

    def capture(logits, temps, gen):
        served.append(logits[0].clone())
        return logits.argmax(dim=-1).to(torch.int32)

    first = logits_c.argmax(dim=-1).to(torch.int32)
    toks, _last, _ = decode_chunk_paged(
        qparams, cfg, first, pool, tables, torch.ones(1, dtype=torch.bool, device="cuda"),
        torch.zeros(1, device="cuda"), None, n_steps=steps, sample_fn=capture, block=KV_BLOCK, scales=scales,
    )
    seq = prompt + [int(first[0])] + toks[:-1, 0].tolist()
    plain = transformer_forward(
        qparams, cfg, torch.tensor([seq], device="cuda"), torch.arange(len(seq), device="cuda")[None, :]
    )[0, len(prompt) - 1 :]
    return max(float((s - p).abs().max()) for s, p in zip(served, plain))


def phase_engine_int8(dev: dict, seed: int) -> dict:
    """The engine burst with int8 weights and an int8 KV pool."""
    cfg = TransformerConfig.gemma_2b()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")  # the bf16 phase's weights
    bf16_bytes = _tensor_bytes(params)
    eng = LLMEngine(cfg, params, seed=seed, kv_int8=True, quantize=True)
    del params
    qparams = eng.params
    weight_bytes = _tensor_bytes(qparams)
    pool_bytes = _tensor_bytes({"k": eng.pool.k, "v": eng.pool.v, "scales": eng.pool_scales})
    print(f"int8 engine: weights {weight_bytes} bytes (bf16 {bf16_bytes}); KV pool {pool_bytes} bytes "
          f"(int8 rows + f32 scales, {eng.kv.pool.n_blocks} blocks of {eng.kv.block_bytes} bytes)")
    try:
        eng.generate([1, 2, 3], max_new_tokens=4)  # warm-up, outside the timed run
        rng = np.random.default_rng(seed)
        plens = [5, 16, 17, 63, 64, 65, 200, 440]
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in plens]
        new_tokens = 32
        A.flash_attention.launches = 0
        A.paged_decode_partials.launches = 0
        A.paged_decode_partials.launches_int8 = 0
        chunks0 = eng.stats()["chunks"]
        results, reqs, wall = _serve(eng, prompts, new_tokens)
        launches = {
            "flash_attention": A.flash_attention.launches,
            "paged_decode_partials": A.paged_decode_partials.launches,
            "paged_decode_partials_int8": A.paged_decode_partials.launches_int8,
        }
        stats = eng.stats()
        _profile(lambda: _serve(eng, prompts, new_tokens))
    finally:
        eng.close()
    chunks = stats["chunks"] - chunks0
    print(f"int8 engine launches {launches} over {chunks} decode chunks "
          f"({launches['paged_decode_partials_int8'] / max(chunks, 1):.1f} int8 launches per chunk; "
          f"{cfg.n_layers * 8} per 8-step chunk)")
    if launches["paged_decode_partials_int8"] <= 0 or launches["paged_decode_partials_int8"] % cfg.n_layers:
        raise AssertionError(f"int8 kernel launches {launches['paged_decode_partials_int8']}: not whole decode steps")
    if launches["paged_decode_partials"] or launches["flash_attention"] <= 0:
        raise AssertionError(f"int8 engine launched the wrong kernels: {launches}")
    if not stats["quantized"] or not stats["kvcache"]["int8"]:
        raise AssertionError(f"int8 engine stats: {stats}")

    total = 0
    for i, toks in sorted(results.items()):
        if len(toks) != new_tokens or any(t < 0 or t >= cfg.vocab_size for t in toks):
            raise AssertionError(f"int8 request {i} (prompt {plens[i]}): bad stream {toks}")
        total += len(toks)
    if len(results) != len(prompts):
        raise AssertionError(f"int8 engine: {len(results)} of {len(prompts)} requests finished")

    drift = _int8_path_drift(cfg, qparams, prompts[6], eng.kv.capacity)
    print(f"int8 logit drift, served int8 path (int8 KV round trip between chunks, int8 kernel decode, "
          f"weight-only decode products) vs plain forward on the int8 weights (prompt {len(prompts[6])}, "
          f"prefill + 8 decode steps): max_abs {drift:.4f} on {dev['smi']}; gap constant {INT8_TOKEN_GAP}")
    if not math.isfinite(drift) or 2 * drift > INT8_TOKEN_GAP:
        raise AssertionError(f"int8 path logit drift {drift}: INT8_TOKEN_GAP {INT8_TOKEN_GAP} is under twice it")

    # every served token against the plain forward on the same int8
    # weights, teacher-forced on the served stream
    checked = exempt = 0
    for i, p in enumerate(prompts):
        seq = p + results[i][:-1]
        logits = transformer_forward(
            qparams, cfg, torch.tensor([seq], device="cuda"), torch.arange(len(seq), device="cuda")[None, :]
        )[0, len(p) - 1 :]
        top2 = torch.topk(logits, 2, dim=-1)
        gaps = (top2.values[:, 0] - top2.values[:, 1]).tolist()
        want = top2.indices[:, 0].tolist()
        n_match = n_exempt = 0
        for j, served in enumerate(results[i]):
            if served == want[j]:
                n_match += 1
            elif gaps[j] < INT8_TOKEN_GAP:
                n_exempt += 1
            else:
                raise AssertionError(
                    f"int8 request {i} (prompt {plens[i]}): token {j} served {served} != plain argmax "
                    f"{want[j]}, gap {gaps[j]:.4f}"
                )
        checked += n_match
        exempt += n_exempt
        print(f"int8 stream prompt {plens[i]:3d}: {n_match} of {len(results[i])} tokens equal the plain greedy "
              f"argmax, {n_exempt} differ within tolerance (top-2 gap < {INT8_TOKEN_GAP}); "
              f"smallest gap {min(gaps):.4f}")
        del logits
    if 8 * exempt > total:
        raise AssertionError(f"int8 engine: {exempt} of {total} tokens needed the gap exemption (> 1 in 8)")

    # eager weight-only products dequantize the int8 weight per call: its
    # cost at the decode shape (32 rows), on the widest layer weight and
    # the unembed, against the same product on a bf16 copy made once
    x = torch.randn((32, cfg.d_model), device="cuda").to(cfg.dtype)
    wg = qparams["layers"]["w_gate"]
    w = QTensor(wg.q[0], wg.s[0])
    w_bf16 = w.q.to(cfg.dtype) * w.s
    emb = qparams["embed"]
    emb_bf16 = emb.q.to(cfg.dtype) * emb.s
    x3 = x[:, None]
    cost = {
        "qmm_w_gate_ms": time_ms(lambda: qmm(x, w)),
        "bf16_w_gate_ms": time_ms(lambda: x @ w_bf16),
        "unembed_int8_ms": time_ms(lambda: T._unembed(qparams, cfg, x3)),
        "unembed_bf16_ms": time_ms(lambda: T._unembed({"embed": emb_bf16}, cfg, x3)),
    }
    print(f"qmm cost at 32 rows: w_gate {list(w.q.shape)} int8 {cost['qmm_w_gate_ms']:.4f} ms vs a "
          f"{str(cfg.dtype)[6:]} copy {cost['bf16_w_gate_ms']:.4f} ms; unembed {list(emb.q.shape)} int8 "
          f"{cost['unembed_int8_ms']:.4f} ms vs a {str(cfg.dtype)[6:]} copy {cost['unembed_bf16_ms']:.4f} ms")

    ttfts = sorted(reqs[i].first_token_at - reqs[i].submitted_at for i in reqs)
    out = {
        "requests": len(results), "tokens": total, "wall_s": wall, "tok_s": total / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1], "launches": launches,
        "tokens_matched": checked, "tokens_exempt": exempt, "drift": drift,
        "weight_bytes": weight_bytes, "pool_bytes": pool_bytes, **cost,
    }
    print(
        f"int8 engine gemma_2b (kv_int8, quantize) on {dev['smi']}: {out['requests']} requests, {total} tokens "
        f"in {wall:.3f}s = {out['tok_s']:.1f} tok/s; ttft p50 {out['ttft_p50_s']:.3f}s max "
        f"{out['ttft_max_s']:.3f}s; {checked} tokens matched, {exempt} exempt; launches {launches}"
    )
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description="GPU smoke run of gofr_tpu_torch on one card")
    ap.add_argument("--parent", metavar="TREE",
                    help="also build another checkout's paged-decode kernels (e.g. the parent commit from "
                         "git archive) and time them beside this tree's on the same inputs")
    args = ap.parse_args()
    dev = phase_device()
    phase_build()
    kern = phase_kernels(dev, SEED, build_parent(args.parent) if args.parent else None)
    eng = phase_engine(dev, SEED)
    eng8 = phase_engine_int8(dev, SEED)
    # name -> (source, replaced Pallas kernel, timing key, engine run whose
    # launches count)
    sources = {
        "flash_attention": ("gofr_tpu_torch/csrc/flash_attention.cu", "gofr_tpu/ops/attention.py:101",
                            "flash_attention c64", eng),
        "paged_decode_partials": ("gofr_tpu_torch/csrc/paged_decode.cu", "gofr_tpu/ops/attention.py:661",
                                  "paged_decode_partials", eng),
        "paged_decode_partials_int8": ("gofr_tpu_torch/csrc/paged_decode.cu",
                                       "gofr_tpu/ops/attention.py:661 (quantized=True)",
                                       "paged_decode_partials_int8", eng8),
    }
    kernels = []
    for name, (src, replaces, tkey, run) in sources.items():
        t = kern["timings"][tkey]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": run["launches"][name], "max_abs_err": kern["errs"][name],
            "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(dev["smi"])  # name, power limit: nvidia-smi's own line
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
