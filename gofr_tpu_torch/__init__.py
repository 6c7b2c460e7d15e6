"""gofr_tpu_torch — the PyTorch/CUDA port of gofr_tpu's serving path.

The JAX package ``gofr_tpu`` is the reference; this package re-implements
its serving main path for an NVIDIA H100 (Hopper, ``sm_90a``): the paged-KV
``LLMEngine`` with chunked prefill and the fused decode chunk. Module names
mirror the JAX package so each counterpart is easy to find:

- ``ops`` — RMSNorm, RoPE, attention (plain PyTorch versions plus the two
  hand-written CUDA kernels that replace the Pallas kernels);
- ``models.transformer`` — the Gemma-family decoder and its serving entry
  points (``prefill_append``, ``decode_chunk_paged``);
- ``kvcache`` — the block pool, slot tables and the paged cache manager;
- ``llm`` — ``GenRequest`` and ``LLMEngine``.

The package imports torch and numpy only: nothing of ``jax`` and nothing of
``gofr_tpu``. Host-only pieces it needs are copied and trimmed.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU they raise. A kernel wrapper given a CPU
tensor runs the kernel's plain PyTorch version; given a CUDA tensor it
launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, ``cpu`` only
    when the caller asks for it. Raises when CUDA is requested (explicitly
    or by default) and no GPU is visible — a missing card must never turn
    into a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gofr_tpu_torch runs on CUDA by default and no GPU is visible; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["resolve_device"]
