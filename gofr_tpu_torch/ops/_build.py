"""Build and load the port's CUDA kernels.

Each source in ``gofr_tpu_torch/csrc`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface and
loaded with ``ctypes`` — no PyTorch headers, so a build takes seconds. A
source may export several kernels' entry points (``paged_decode.cu``
exports the bf16/f32 and the int8 paged-decode kernels); they share its
library.
Libraries land in ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the sources and flags: a changed source
rebuilds, an unchanged one is reused. The build happens at first use (the
first wrapper call) or up front through ``build()``, which starts one
``nvcc`` per source at once.

Nothing here runs at import: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel name -> (source file, exported C function, its argument types)
KERNELS = {
    "flash_attention": (
        "flash_attention.cu", "gofr_flash_attention",
        # q, k, v, q_offsets, out | dtype, b, sq, sk, hq, hkv, d, causal,
        # window | scale, logit_cap | stream
        [_P] * 5 + [_I] * 9 + [_F] * 2 + [_P],
    ),
    "paged_decode": (
        "paged_decode.cu", "gofr_paged_decode_partials",
        # q, k_pool, v_pool, tables, lo, hi, o, m, l | dtype, b, hq, hkv,
        # d, n_blocks, block, table_width | scale, logit_cap | stream
        [_P] * 9 + [_I] * 8 + [_F] * 2 + [_P],
    ),
    "paged_decode_int8": (
        "paged_decode.cu", "gofr_paged_decode_partials_int8",
        # q, k_pool, v_pool, k_scales, v_scales, tables, lo, hi, o, m, l |
        # dtype (of q), b, hq, hkv, d, n_blocks, block, table_width |
        # scale, logit_cap | stream
        [_P] * 11 + [_I] * 8 + [_F] * 2 + [_P],
    ),
    # not a kernel: the launch plan (cluster split, shared memory) that
    # both paged-decode entry points use
    "paged_decode_plan": (
        "paged_decode.cu", "gofr_paged_decode_plan",
        # pool element bytes, b, hq, hkv, d, block, table_width | splits*,
        # smem_bytes*
        [_I] * 7 + [ctypes.POINTER(_I)] * 2,
    ),
}

_lock = threading.Lock()
_functions: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from source on the GPU machine")
    return path


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives for the current sources and
    flags (one library per source file)."""
    src = KERNELS[name][0]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, dict]:
    """Compile every library the named kernels need that is missing, one
    ``nvcc`` per source, all started together. Returns {source stem:
    {"seconds", "cached", "ptxas"}} (ptxas is the compiler's
    register/shared-memory report). Raises on any failed compile, with
    nvcc's output."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started: dict[str, tuple] = {}
    report: dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        src = KERNELS[name][0]
        lib = Path(src).stem
        if lib in started or lib in report:
            continue  # another kernel of the same source
        out = library_path(name)
        if out.exists():
            report[lib] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[lib] = (proc, tmp, out)
    failures = []
    for lib, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{lib}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        report[lib] = {
            "seconds": time.perf_counter() - t0, "cached": False, "ptxas": log,
        }
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return report


def ptxas_kernels(log: str) -> dict[str, dict]:
    """{mangled kernel name: {"registers", "spill_bytes"}} from the ptxas
    report of a build (nvcc -Xptxas=-v)."""
    out: dict[str, dict] = {}
    name = None
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            name = m.group(1)
            out[name] = {"registers": None, "spill_bytes": 0}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            out[name]["registers"] = int(m.group(1))
    return out


def sass_hmma(lib) -> dict[str, int]:
    """{mangled kernel name: count of tensor-core (HMMA) instructions} in a
    built library's SASS (cuobjdump -sass)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    counts: dict[str, int] = {}
    name = None
    for ln in sass.splitlines():
        if m := re.search(r"Function : (\w+)", ln):
            name = m.group(1)
            counts[name] = 0
        elif name and "HMMA" in ln:
            counts[name] += 1
    return counts


def function(name: str):
    """The kernel library's C entry point with argtypes set, building the
    library first if needed. Returns the ``ctypes`` function; it returns
    the ``cudaError_t`` of its launch."""
    fn = _functions.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _functions.get(name)
        if fn is None:
            build([name])
            _src, symbol, argtypes = KERNELS[name]
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[name] = fn
    return fn
