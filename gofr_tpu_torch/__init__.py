"""gofr_tpu_torch — the PyTorch/CUDA port of gofr_tpu's serving path.

The JAX package ``gofr_tpu`` is the reference; this package re-implements
its serving main path for an NVIDIA H100 (Hopper, ``sm_90a``): the HTTP and
OpenAI edge in front of the paged-KV ``LLMEngine`` with chunked prefill and
the fused decode chunk. Module names
mirror the JAX package so each counterpart is easy to find:

- ``ops`` — RMSNorm, RoPE, attention (plain PyTorch versions plus the two
  hand-written CUDA kernels that replace the Pallas kernels);
- ``models.transformer`` — the Gemma-family decoder and its serving entry
  points (``prefill_append``, ``decode_chunk_paged``, ``verify_chunk``);
  ``models.mlp`` the MNIST-class MLP of the plain-model path;
- ``kvcache`` — the block pool, slot tables and the paged cache manager
  with its radix prefix index and session tier;
- ``spec`` — the n-gram drafter and acceptance policy of speculative
  decoding (``models.transformer.verify_chunk`` scores the drafts);
- ``structured`` — the JSON-schema / regex -> token-DFA compiler of
  grammar-constrained decoding (host numpy; the engine masks on the card);
- ``resilience`` — overload control's fair-queuing ledger, brownout/shed
  controller and retry budget, the fault injector, the step watchdog,
  the device-health ledger and canary gate, and the replica supervisor;
- ``lora`` — the multi-tenant LoRA adapter pool's host bookkeeping and
  adapter validation (the engine holds the tables on the card);
- ``llm`` — ``GenRequest``, ``LLMEngine`` (with its recovery paths) and
  ``ReplicatedLLMEngine`` (the replica fleet with failover);
- observability: ``metrics`` (the ``Manager`` and its instruments;
  ``metrics.slo``, the SLO engine), ``tracing`` (spans, W3C trace
  context, exporters, the span ring), ``profiling`` (the graph-capture
  registry; ``profiling.mfu``, the cost model and the peak table;
  ``profiling.capture``, ``torch.profiler`` capture), ``goodput`` and
  ``flightrec`` (chip-time accounting, the flight recorder) and
  ``datasource.gpu.telemetry`` (the HBM sampler);
- the serving edge: ``serve`` (``python -m gofr_tpu_torch.serve``:
  ``/generate``, ``/stats`` and the OpenAI routes of ``openai_compat``),
  ``app``, ``handler``, ``context``, ``container``, ``config``,
  ``logging``, ``http`` (the asyncio HTTP/1.1 server, router, request and
  responder), ``grpcx`` (JSON over gRPC: serve's ``Gemma/Generate`` and
  ``Gemma/Stream``; imported only when a gRPC route is registered),
  ``datasource.gpu`` (``GPURuntime.register_llm``, and
  ``register_model`` with its dynamic ``Batcher``), ``serve_mnist`` (the
  MNIST app: ``POST /infer``, ``GET /model``) and ``models.tokenizer``
  (``ByteTokenizer``).

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
