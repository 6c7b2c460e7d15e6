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
4. engine — the port's LLMEngine at its defaults over Gemma-2B (full
   width and depth, random weights from a seeded generator): lookahead
   3 and every program family captured as a CUDA graph at construction.
   Prints the families, warmup_s and torch.cuda.memory_reserved before
   and after the capture; holds every family's replay against its eager
   program on a cloned random state at temperature 0 (tokens, pool bytes,
   lengths, tail, active mask and temperatures bitwise equal; launches per
   replay equal to the captured count) and checks that two replays at a
   high temperature draw differently. Then serves a burst of concurrent
   requests three times at lookahead 3 and once at lookahead 1, checks
   every stream and every served token against greedy decoding by the
   plain full-prompt forward, prints the median and spread of tok/s and
   TTFT, checks that both kernels launched in every burst, and profiles
   one more burst (idle share; whether the profiler names the kernels
   inside graph replays);
5. int8 engine — the same through LLMEngine(kv_int8=True, quantize=True)
   on the same weights: int8 weights and an int8 KV pool read by the
   int8 paged-decode kernel; every served token checked against the
   plain forward on the same int8 weights, under a gap constant set from
   this path's measured logit drift;
6. edge — the port's HTTP server (gofr_tpu_torch.serve) on an ephemeral
   port, reached at 127.0.0.1, a bf16 engine at its defaults (graphs,
   lookahead 3) over the same weights, its warmup printed: the burst as
   concurrent POST /generate requests over real sockets (every token
   through the same replay gate as the engine phase), one OpenAI chat
   completion plain and then as SSE (the deltas must join to the plain
   content), and a client that hangs up after the first SSE chunk (the
   KV pool must show 0 blocks in use within 3 s); both kernels must
   launch during the phase. Prints an "edge" line: tok/s and the
   client's time to first byte beside the engine phase's numbers;
7. report — a "kernels" JSON line, then the last line
   {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package. Exits non-zero,
printing no result, when no GPU is visible.
"""

from __future__ import annotations

import argparse
import ctypes
import http.client
import json
import math
import socket
import statistics
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


def _engine_state(eng) -> dict:
    """Every tensor the engine's programs write: the pool's K/V rows (and
    an int8 pool's scales), lengths, tail, active mask and temperatures."""
    state = {"k": eng.pool.k, "v": eng.pool.v, "length": eng.pool.length, "tail": eng._tail,
             "active": eng._active, "temps": eng._temps}
    if eng.pool_scales is not None:
        state["scales"] = eng.pool_scales
    return state


def _snapshot(eng) -> dict:
    return {k: v.clone() for k, v in _engine_state(eng).items()}


def _restore(eng, snap: dict) -> None:
    for k, v in _engine_state(eng).items():
        v.copy_(snap[k])


def _bytes_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _family_inputs(eng, name: str, g: torch.Generator, temperature: float):
    """Random live state for family ``name`` (written into the engine) and
    the inputs of one dispatch: every slot active and live on private
    blocks with room for the step, prefill rows (the last lane padding
    when the width allows) at their slots' lengths, alternate rows
    finishing their prompt."""
    cfg, slots, K = eng.cfg, eng.slots, eng.decode_chunk
    cap, MB, NB = eng.kv.capacity, eng.kv.table_width, eng.kv.pool.n_blocks
    dev = eng.device
    if eng.pool_scales is None:
        eng.pool.k.copy_(torch.randn(eng.pool.k.shape, generator=g, device=dev).to(eng.pool.k.dtype))
        eng.pool.v.copy_(torch.randn(eng.pool.v.shape, generator=g, device=dev).to(eng.pool.v.dtype))
    else:
        for t in (eng.pool.k, eng.pool.v):
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, device=dev, dtype=torch.int8))
        eng.pool_scales.copy_(torch.rand(eng.pool_scales.shape, generator=g, device=dev) * 0.02 + 1e-3)
    step = eng._programs[name][1]
    shape = step[0] if step else 0
    lengths = torch.randint(1, cap - shape - 2 * K, (slots,), generator=g, device=dev, dtype=torch.int32)
    eng.pool.length.copy_(lengths)
    eng._tail.copy_(torch.randint(0, cfg.vocab_size, (slots,), generator=g, device=dev, dtype=torch.int32))
    eng._active.fill_(True)
    eng._temps.fill_(temperature)
    tables = torch.randperm(NB, generator=g, device=dev)[: slots * MB].reshape(slots, MB).int().cpu().numpy()
    live = np.ones((slots,), bool)
    if step is None:
        return tables, live, None, None
    nb = step[1]
    rows = nb - 1 if nb > 1 else 1
    lens = lengths.cpu().numpy()
    pack = np.zeros((nb, shape + 3), np.int32)
    meta = np.zeros((2, nb), np.int32)
    meta[0, :] = slots
    toks = torch.randint(1, cfg.vocab_size, (nb, shape), generator=g, device=dev).cpu().numpy()
    for j in range(rows):
        n = shape - j
        pack[j, :n] = toks[j, :n]
        pack[j, shape], pack[j, shape + 1] = lens[j], n
        pack[j, shape + 2] = np.float32(temperature).view(np.int32)
        meta[0, j], meta[1, j] = j, j % 2
    return tables, live, meta, pack


def check_family(eng, name: str, seed: int, temperature: float = 0.0, replays: int = 1) -> dict:
    """Family ``name`` of a CUDA engine (captured at its warmup, or here)
    against its eager program on a random live state: one eager call, then
    ``replays`` replays, each from the same cloned state on identical
    inputs. Returns whether the first replay's tokens and its pool bytes,
    lengths, tail, active mask and temperatures are bitwise the eager
    call's (the test at temperature 0; above it the draws differ by
    design), whether the first two replays' tokens differ (fresh draws),
    and the kernel launches the replays counted beside the family's
    captured count. Runs with the engine idle, holding its lock, and puts
    its state back."""
    g = torch.Generator(device=eng.device).manual_seed(seed)
    with eng._lock, torch.no_grad(), torch.cuda.stream(eng._stream):
        eng._ensure_family(name)
        fam = eng.families[name]
        orig = _snapshot(eng)
        inputs = _family_inputs(eng, name, g, temperature)
        s0 = _snapshot(eng)
        eng._in.write(*inputs)
        eager = eng._programs[name][0]().clone()
        s_eager = _snapshot(eng)
        before = {k: getattr(*A._counter(k)) for k in fam.launches}
        draws, s_replay = [], None
        for _ in range(replays):
            _restore(eng, s0)
            eng._in.write(*inputs)
            draws.append(eng._launch(name).clone())
            if s_replay is None:
                s_replay = _snapshot(eng)
        eng._stream.synchronize()
        state_equal = {k: _bytes_equal(s_eager[k], s_replay[k]) for k in s0}
        out = {
            "eager_equal": torch.equal(eager, draws[0]) and all(state_equal.values()),
            "state_equal": state_equal,
            "draws_differ": len(draws) > 1 and not torch.equal(draws[0], draws[1]),
            "launches": {k: getattr(*A._counter(k)) - before[k] for k in fam.launches},
            "captured": dict(fam.launches),
        }
        _restore(eng, orig)
        eng._stream.synchronize()
    return out


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


def _profile(fn, label: str = "") -> dict:
    """Run fn under torch.profiler and print the device's busy and idle
    share and the kernels that took the most device time. Returns the
    idle share and {group: (device ms, launches)}."""
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
    idle = 1 - busy_us / wall_us
    print(f"{label}profile (engine traffic again, under the profiler): wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), idle {100 * idle:.1f}%")
    for group, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"{label}profile group {group:20s} {us / 1e3:9.2f} ms device  {n:7d} launches  "
              f"{100 * us / max(busy_us, 1e-9):5.1f}% of busy")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"{label}profile kernel {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x {e.key[:90]}")
    named = "paged_decode_kernel" in groups and "flash kernels" in groups
    print(f"{label}profile: the profiler {'names' if named else 'does NOT name'} the hand-written kernels "
          f"inside CUDA graph replays (groups seen: {sorted(groups)})")
    return {"idle": idle, "wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "groups": {k: (v[0] / 1e3, v[1]) for k, v in groups.items()}}


def gemma_weights(seed: int) -> tuple[TransformerConfig, dict]:
    """Gemma-2B's random bf16 weights, made once from ``seed`` and shared by
    the engine, int8 and edge phases."""
    cfg = TransformerConfig.gemma_2b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    n_params = sum(w.numel() for w in [params["embed"], params["final_norm"], *params["layers"].values()])
    print(f"gemma_2b random weights: {n_params / 1e9:.3f} B params bf16 in {time.perf_counter() - t0:.1f}s")
    return cfg, params


def _replay_gate(params, cfg, prompts, results, gap: float, label: str = "", verbose: bool = True) -> tuple[int, int]:
    """Every served token against greedy decoding by the plain full-prompt
    forward on ``params`` (no kernels), teacher-forced on the served
    stream: token j must be the plain argmax after prompt + served[:j],
    unless the plain top-2 gap is below ``gap``. Raises on a token that
    fails; returns (tokens matched, tokens exempt)."""
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
            elif gaps[j] < gap:
                n_exempt += 1
            else:
                raise AssertionError(
                    f"{label}request {i} (prompt {len(p)}): token {j} served {served} != plain argmax "
                    f"{want[j]}, gap {gaps[j]:.4f}"
                )
        checked += n_match
        exempt += n_exempt
        if verbose:
            print(f"{label}stream prompt {len(p):3d}: {n_match} of {len(results[i])} tokens equal the plain greedy "
                  f"argmax, {n_exempt} differ within tolerance (top-2 gap < {gap}); smallest gap {min(gaps):.4f}")
        del logits
    return checked, exempt


def _warm_report(label: str, eng) -> dict:
    """Print an engine's captured graph families, warmup_s and the memory
    the capture reserved; fail unless every family was captured."""
    before, after = eng.warmup_reserved
    names = list(eng.families)
    print(f"{label}warmup: {len(names)} CUDA graphs captured in {eng.warmup_s:.3f} s (warmup_s): "
          f"{', '.join(names)}; torch.cuda.memory_reserved {before} -> {after} bytes (+{after - before})")
    if sorted(names) != sorted(eng._programs) or eng.stats()["warmup_s"] != eng.warmup_s:
        raise AssertionError(f"{label}warmup captured {names}, programs {list(eng._programs)}")
    return {"families": names, "warmup_s": eng.warmup_s, "reserved_before": before, "reserved_after": after}


def _check_families(label: str, eng, seed: int) -> None:
    """Every captured family against its eager program (check_family), at
    temperature 0; then two replays each of the 8-step chunk and the
    widest step at a high temperature, which must draw differently."""
    for i, name in enumerate(eng.families):
        r = check_family(eng, name, seed + i)
        print(f"{label}replay vs eager {name}: tokens and state bitwise "
              f"{'equal' if r['eager_equal'] else 'DIFFERENT ' + str(r['state_equal'])}; launches per replay "
              f"{r['launches']} (captured {r['captured']})")
        if not r["eager_equal"]:
            raise AssertionError(f"{label}{name}: replay differs from the eager program: {r['state_equal']}")
        if r["launches"] != r["captured"] or not r["captured"].get(
            "paged_decode_partials_int8" if eng.pool_scales is not None else "paged_decode_partials"
        ):
            raise AssertionError(f"{label}{name}: launches {r['launches']}, captured {r['captured']}")
        if name.startswith("llm.step") and not r["captured"].get("flash_attention"):
            raise AssertionError(f"{label}{name} holds no flash launch: {r['captured']}")
    for name in (f"llm.decode_chunk{eng.decode_chunk}", eng._step_name(eng.chunk_shapes[-1], eng.admit_cap)):
        r = check_family(eng, name, seed + 100, temperature=1000.0, replays=2)
        print(f"{label}sampled replays {name} at temperature 1000: two replays from one state "
              f"{'draw different tokens' if r['draws_differ'] else 'REPEAT THEIR DRAWS'}; launches {r['launches']}")
        if not r["draws_differ"] or r["launches"] != {k: 2 * n for k, n in r["captured"].items()}:
            raise AssertionError(f"{label}{name}: sampled replays {r}")


def _bursts(label: str, eng, prompts, new_tokens: int, counters: tuple) -> list[dict]:
    """The burst three times at the engine's lookahead, then once at
    lookahead 1 on the same engine (the scheduler reads ``lookahead`` on
    every pass), each with the kernel counters zeroed just before it.
    Prints each, then the median and spread of tok/s and TTFT."""
    runs = []
    depth = eng.lookahead
    for la in (depth, depth, depth, 1):
        eng.lookahead = la
        for name in counters:
            fn, attr = A._counter(name)
            setattr(fn, attr, 0)
        st0 = eng.stats()
        results, reqs, wall = _serve(eng, prompts, new_tokens)
        st = eng.stats()
        launches = {name: getattr(*A._counter(name)) for name in counters}
        ttfts = sorted(reqs[i].first_token_at - reqs[i].submitted_at for i in reqs)
        total = sum(len(t) for t in results.values())
        run = {"lookahead": la, "results": results, "wall_s": wall, "tokens": total, "tok_s": total / wall,
               "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1], "launches": launches,
               "chunks": st["chunks"] - st0["chunks"], "steps": st["steps"] - st0["steps"]}
        runs.append(run)
        print(f"{label}burst {len(runs)} at lookahead {la}: {total} tokens in {wall:.3f}s = {run['tok_s']:.1f} tok/s; "
              f"ttft p50 {run['ttft_p50_s']:.3f}s max {run['ttft_max_s']:.3f}s; {run['chunks']} programs "
              f"({run['steps']} unified steps); "
              f"launches {launches}")
    eng.lookahead = depth
    for key in ("tok_s", "ttft_p50_s", "ttft_max_s"):
        vals = [r[key] for r in runs[:3]]
        print(f"{label}bursts at lookahead {depth}, {key}: median {statistics.median(vals):.4f}, "
              f"min {min(vals):.4f}, max {max(vals):.4f}, spread {max(vals) - min(vals):.4f}; "
              f"at lookahead 1: {runs[3][key]:.4f}")
    for r in runs:
        toks = r["results"]
        if len(toks) != len(prompts) or any(
            len(t) != new_tokens or any(x < 0 or x >= eng.cfg.vocab_size for x in t) for t in toks.values()
        ):
            raise AssertionError(f"{label}burst at lookahead {r['lookahead']}: bad streams {toks}")
    return runs


def _burst_prompts(cfg, seed: int) -> tuple[list, list]:
    rng = np.random.default_rng(seed)
    plens = [5, 16, 17, 63, 64, 65, 200, 440]
    return plens, [rng.integers(1, cfg.vocab_size, n).tolist() for n in plens]


def phase_engine(dev: dict, seed: int, cfg: TransformerConfig, params: dict) -> dict:
    eng = LLMEngine(cfg, params, seed=seed)  # defaults: 32 slots, 512, {16, 64}, 256, K=8, B=16, lookahead 3, graphs
    try:
        warm = _warm_report("", eng)
        _check_families("", eng, seed)
        # warm-up request: allocator pools and the collector, outside the timed runs
        eng.generate([1, 2, 3], max_new_tokens=4)
        plens, prompts = _burst_prompts(cfg, seed)
        new_tokens = 32
        runs = _bursts("", eng, prompts, new_tokens, ("flash_attention", "paged_decode_partials"))
        stats = eng.stats()
        # the same traffic once more under torch.profiler: where the device
        # time goes (the profiler slows the host, so this pass is not timed)
        prof = _profile(lambda: _serve(eng, prompts, new_tokens))
    finally:
        eng.close()

    # every served token of every burst against greedy decoding by the
    # plain full-prompt forward. The first token comes from prefill (flash
    # kernel), the rest from the decode chunks (paged kernel, partials
    # merge, chunk-end scatter through the tables).
    checked = exempt = 0
    for i, r in enumerate(runs):
        c, e = _replay_gate(params, cfg, prompts, r["results"], TOKEN_GAP,
                            label=f"burst {i + 1} (lookahead {r['lookahead']}) ", verbose=i == 0)
        print(f"burst {i + 1} (lookahead {r['lookahead']}): {c} tokens equal the plain greedy argmax, {e} exempt")
        checked, exempt = checked + c, exempt + e

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

    launches = runs[0]["launches"]
    for r in runs:
        for name, n in r["launches"].items():
            if n <= 0:
                raise AssertionError(f"{name} was not launched in a burst at lookahead {r['lookahead']}")
    first = runs[0]
    out = {
        "requests": len(first["results"]), "tokens": first["tokens"], "wall_s": first["wall_s"],
        "tok_s": statistics.median(r["tok_s"] for r in runs[:3]),
        "ttft_p50_s": statistics.median(r["ttft_p50_s"] for r in runs[:3]),
        "ttft_max_s": statistics.median(r["ttft_max_s"] for r in runs[:3]),
        "launches": launches, "steps": stats["steps"], "tokens_matched": checked, "tokens_exempt": exempt,
        "warmup": warm, "profile": prof, "runs": [{k: v for k, v in r.items() if k != "results"} for r in runs],
    }
    print(
        f"engine gemma_2b on {dev['smi']}: {out['requests']} requests x 32 tokens, 3 bursts at lookahead 3: "
        f"median {out['tok_s']:.1f} tok/s; ttft p50 {out['ttft_p50_s']:.3f}s max {out['ttft_max_s']:.3f}s "
        f"(medians); lookahead 1: {runs[3]['tok_s']:.1f} tok/s; idle {100 * prof['idle']:.1f}% of a profiled "
        f"burst; launches in burst 1 {launches}"
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


def phase_engine_int8(dev: dict, seed: int, cfg: TransformerConfig, params: dict) -> dict:
    """The engine bursts with int8 weights (the bf16 phase's, quantized at
    construction) and an int8 KV pool."""
    bf16_bytes = _tensor_bytes(params)
    eng = LLMEngine(cfg, params, seed=seed, kv_int8=True, quantize=True)
    qparams = eng.params
    weight_bytes = _tensor_bytes(qparams)
    pool_bytes = _tensor_bytes({"k": eng.pool.k, "v": eng.pool.v, "scales": eng.pool_scales})
    print(f"int8 engine: weights {weight_bytes} bytes (bf16 {bf16_bytes}); KV pool {pool_bytes} bytes "
          f"(int8 rows + f32 scales, {eng.kv.pool.n_blocks} blocks of {eng.kv.block_bytes} bytes)")
    counters = ("flash_attention", "paged_decode_partials", "paged_decode_partials_int8")
    try:
        warm = _warm_report("int8 ", eng)
        _check_families("int8 ", eng, seed)
        eng.generate([1, 2, 3], max_new_tokens=4)  # warm-up, outside the timed runs
        plens, prompts = _burst_prompts(cfg, seed)
        new_tokens = 32
        runs = _bursts("int8 ", eng, prompts, new_tokens, counters)
        stats = eng.stats()
        prof = _profile(lambda: _serve(eng, prompts, new_tokens), label="int8 ")
    finally:
        eng.close()
    for r in runs:
        launches = r["launches"]
        print(f"int8 burst at lookahead {r['lookahead']}: launches {launches} over {r['chunks']} programs "
              f"({launches['paged_decode_partials_int8'] / max(r['chunks'], 1):.1f} int8 launches per program; "
              f"{cfg.n_layers * 8} per 8-step chunk)")
        if launches["paged_decode_partials_int8"] <= 0 or launches["paged_decode_partials_int8"] % cfg.n_layers:
            raise AssertionError(f"int8 kernel launches {launches['paged_decode_partials_int8']}: not whole decode steps")
        if launches["paged_decode_partials"] or launches["flash_attention"] <= 0:
            raise AssertionError(f"int8 engine launched the wrong kernels: {launches}")
    if not stats["quantized"] or not stats["kvcache"]["int8"]:
        raise AssertionError(f"int8 engine stats: {stats}")

    drift = _int8_path_drift(cfg, qparams, prompts[6], eng.kv.capacity)
    print(f"int8 logit drift, served int8 path (int8 KV round trip between chunks, int8 kernel decode, "
          f"weight-only decode products) vs plain forward on the int8 weights (prompt {len(prompts[6])}, "
          f"prefill + 8 decode steps): max_abs {drift:.4f} on {dev['smi']}; gap constant {INT8_TOKEN_GAP}")
    if not math.isfinite(drift) or 2 * drift > INT8_TOKEN_GAP:
        raise AssertionError(f"int8 path logit drift {drift}: INT8_TOKEN_GAP {INT8_TOKEN_GAP} is under twice it")

    # every served token of every burst against the plain forward on the
    # same int8 weights, teacher-forced on the served stream
    checked = exempt = 0
    for i, r in enumerate(runs):
        c, e = _replay_gate(qparams, cfg, prompts, r["results"], INT8_TOKEN_GAP,
                            label=f"int8 burst {i + 1} (lookahead {r['lookahead']}) ", verbose=i == 0)
        print(f"int8 burst {i + 1} (lookahead {r['lookahead']}): {c} tokens equal the plain greedy argmax, "
              f"{e} exempt")
        if 8 * e > r["tokens"]:
            raise AssertionError(f"int8 engine: {e} of {r['tokens']} tokens needed the gap exemption (> 1 in 8)")
        checked, exempt = checked + c, exempt + e

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

    first = runs[0]
    out = {
        "requests": len(first["results"]), "tokens": first["tokens"], "wall_s": first["wall_s"],
        "tok_s": statistics.median(r["tok_s"] for r in runs[:3]),
        "ttft_p50_s": statistics.median(r["ttft_p50_s"] for r in runs[:3]),
        "ttft_max_s": statistics.median(r["ttft_max_s"] for r in runs[:3]),
        "launches": first["launches"], "tokens_matched": checked, "tokens_exempt": exempt, "drift": drift,
        "weight_bytes": weight_bytes, "pool_bytes": pool_bytes, "warmup": warm, "profile": prof, **cost,
    }
    print(
        f"int8 engine gemma_2b (kv_int8, quantize) on {dev['smi']}: 3 bursts at lookahead 3: median "
        f"{out['tok_s']:.1f} tok/s; ttft p50 {out['ttft_p50_s']:.3f}s max {out['ttft_max_s']:.3f}s (medians); "
        f"lookahead 1: {runs[3]['tok_s']:.1f} tok/s; idle {100 * prof['idle']:.1f}%; {checked} tokens matched, "
        f"{exempt} exempt; launches in burst 1 {first['launches']}"
    )
    return out


def _http(port: int, method: str, path: str, body=None, timeout: float = 600.0):
    """One request on its own connection -> (status, body bytes, seconds to
    the response's first byte, seconds to its last)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        t_first = time.perf_counter() - t0
        raw = resp.read()
        return resp.status, raw, t_first, time.perf_counter() - t0
    finally:
        conn.close()


def _sse_events(raw: bytes) -> list:
    events = [ln[len("data: "):] for ln in raw.decode().split("\n") if ln.startswith("data: ")]
    if not events or events[-1] != "[DONE]":
        raise AssertionError(f"SSE stream does not end with [DONE]: {events[-2:]}")
    return [json.loads(e) for e in events[:-1]]


def phase_edge(dev: dict, seed: int, cfg: TransformerConfig, params: dict, engine_out: dict) -> dict:
    """The port's HTTP server (gofr_tpu_torch.serve) on an ephemeral port,
    serving Gemma-2B through a bf16 engine at its defaults over the same
    weights, driven over real sockets: the burst as concurrent POST
    /generate requests (every token through the replay gate), one OpenAI
    chat request plain and then SSE, and a client that hangs up mid-stream
    (its blocks must be free within 3 s)."""
    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.serve import build_app

    app = build_app(new_mock_config({
        "HTTP_PORT": "0", "GEMMA_PRESET": "2b", "LLM_SLOTS": "32", "LLM_MAX_SEQ": "512",
        "REQUEST_TIMEOUT": "600", "LOG_LEVEL": "WARN",
    }), params=params)
    thread = app.run_in_background()
    port = app.http_server.port
    eng = app.container.tpu().llm("gemma")
    warm = _warm_report("edge ", eng)
    A.flash_attention.launches = 0
    A.paged_decode_partials.launches = 0
    try:
        status, raw, _, _ = _http(port, "POST", "/generate", {"tokens": [1, 2, 3], "max_new_tokens": 4})
        if status != 201 or len(json.loads(raw)["data"]["tokens"]) != 4:  # warm-up, outside the timed run
            raise AssertionError(f"warm-up /generate: {status} {raw[:200]!r}")

        # 1. the burst as concurrent POST /generate requests
        rng = np.random.default_rng(seed)
        plens = [5, 16, 17, 63, 64, 65, 200, 440]
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in plens]
        new_tokens = 32
        answers: dict[int, tuple] = {}
        errors: list[BaseException] = []

        def client(i):
            try:
                answers[i] = _http(port, "POST", "/generate", {"tokens": prompts[i], "max_new_tokens": new_tokens})
            except BaseException as e:  # surfaced below, after every client joined
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        burst_launches0 = (A.flash_attention.launches, A.paged_decode_partials.launches)
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        burst_launches = {
            "flash_attention": A.flash_attention.launches - burst_launches0[0],
            "paged_decode_partials": A.paged_decode_partials.launches - burst_launches0[1],
        }
        if errors:
            raise errors[0]
        if any(th.is_alive() for th in threads) or len(answers) != len(prompts):
            raise TimeoutError(f"{len(answers)} of {len(prompts)} HTTP clients finished")
        results = {}
        for i, (status, raw, _, _) in sorted(answers.items()):
            toks = json.loads(raw)["data"]["tokens"] if status == 201 else None
            if toks is None or len(toks) != new_tokens or any(t < 0 or t >= cfg.vocab_size for t in toks):
                raise AssertionError(f"edge request {i} (prompt {plens[i]}): {status} {raw[:200]!r}")
            results[i] = toks
        total = sum(len(t) for t in results.values())
        checked, exempt = _replay_gate(params, cfg, prompts, results, TOKEN_GAP, label="edge ")

        # 2. one OpenAI chat request, plain and then SSE, each alone
        chat = {"model": "gemma", "messages": [{"role": "user", "content": "Say hello to the H100."}],
                "max_tokens": 24}
        status, raw, _, _ = _http(port, "POST", "/v1/chat/completions", chat)
        if status != 200:
            raise AssertionError(f"chat completion: {status} {raw[:300]!r}")
        plain = json.loads(raw)
        finish = plain["choices"][0]["finish_reason"]
        if not 0 < plain["usage"]["completion_tokens"] <= 24 or finish not in ("length", "stop"):
            raise AssertionError(f"chat completion: {plain}")
        status, raw, sse_first, _ = _http(port, "POST", "/v1/chat/completions", {**chat, "stream": True})
        if status != 200:
            raise AssertionError(f"chat SSE: {status} {raw[:300]!r}")
        events = _sse_events(raw)
        joined = "".join(e["choices"][0]["delta"].get("content", "") for e in events)
        content = plain["choices"][0]["message"]["content"]
        if joined != content or events[-1]["choices"][0]["finish_reason"] != finish:
            raise AssertionError(f"SSE deltas {joined!r} / {events[-1]} differ from the plain answer {content!r}")

        # 3. a client that hangs up after the first SSE chunk
        disconnects0 = eng.stats()["disconnect_cancels"]
        body = json.dumps({**chat, "max_tokens": 400, "stream": True}).encode()
        with socket.create_connection(("127.0.0.1", port), timeout=120) as sock:
            sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: smoke\r\n"
                         b"Content-Type: application/json\r\n"
                         + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            got = b""
            while b"data: " not in got:
                chunk = sock.recv(4096)
                if not chunk:
                    raise AssertionError("server closed the SSE stream before its first chunk")
                got += chunk
        t_gone = time.perf_counter()
        while time.perf_counter() - t_gone < 3.0:
            st = eng.stats()
            if st["kvcache"]["blocks_in_use"] == 0 and st["disconnect_cancels"] == disconnects0 + 1:
                break
            time.sleep(0.01)
        freed_s = time.perf_counter() - t_gone
        st = eng.stats()
        if st["kvcache"]["blocks_in_use"] or st["disconnect_cancels"] != disconnects0 + 1:
            raise AssertionError(f"disconnected stream not retired within 3 s: {st}")
        launches = {"flash_attention": A.flash_attention.launches,
                    "paged_decode_partials": A.paged_decode_partials.launches}
    finally:
        app.shutdown()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("edge server did not stop")
    for name, n in launches.items():
        if n <= 0 or burst_launches[name] <= 0:
            raise AssertionError(f"{name} was not launched while the edge served: {launches}, burst {burst_launches}")

    first = sorted(a[2] for a in answers.values())
    out = {
        "requests": len(results), "tokens": total, "wall_s": wall, "tok_s": total / wall,
        "ttft_p50_s": first[len(first) // 2], "ttft_max_s": first[-1], "sse_first_byte_s": sse_first,
        "disconnect_freed_s": freed_s, "tokens_matched": checked, "tokens_exempt": exempt,
        "launches": launches, "burst_launches": burst_launches, "warmup": warm,
    }
    print(
        f"edge gemma_2b over HTTP on {dev['smi']}: {out['requests']} concurrent POST /generate, {total} tokens "
        f"in {wall:.3f}s = {out['tok_s']:.1f} tok/s; client ttft (first response byte, which carries the whole "
        f"answer) p50 {out['ttft_p50_s']:.3f}s max {out['ttft_max_s']:.3f}s; engine phase in-process "
        f"{engine_out['tok_s']:.1f} tok/s, ttft p50 {engine_out['ttft_p50_s']:.3f}s max "
        f"{engine_out['ttft_max_s']:.3f}s; {checked} tokens matched, {exempt} exempt; SSE first byte "
        f"{sse_first:.3f}s; disconnect freed in {freed_s:.3f}s; burst launches {burst_launches}, phase {launches}"
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
    cfg, params = gemma_weights(SEED)
    eng = phase_engine(dev, SEED, cfg, params)
    eng8 = phase_engine_int8(dev, SEED, cfg, params)
    torch.cuda.empty_cache()  # the closed engines' pools
    phase_edge(dev, SEED, cfg, params, eng)
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
