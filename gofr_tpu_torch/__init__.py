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
  ``logging`` (with the remote level), ``http`` (the asyncio HTTP/1.1
  server, the router with path parameters, request and responder, the
  default and the auth middleware), ``service`` (the outbound HTTP client
  with circuit breakers and streams), ``metrics.server`` (the metrics
  server), ``cron``, ``staticfiles``, ``swagger``, ``cmd`` (CLI apps:
  ``new_cmd``), ``fileutil``, ``version``, ``grpcx`` (JSON over gRPC: serve's ``Gemma/Generate`` and
  ``Gemma/Stream``; imported only when a gRPC route is registered),
  ``datasource.gpu`` (``GPURuntime.register_llm``, and
  ``register_model`` with its dynamic ``Batcher``), ``serve_mnist`` (the
  MNIST app: ``POST /infer``, ``GET /model``) and ``models.tokenizer``
  (``ByteTokenizer``);
- the scale-out and job tiers: ``router`` (``python -m
  gofr_tpu_torch.router``: the front router over engine processes, with
  the rendezvous ring, the polled fleet view, failover, the autoscaler,
  and ``router.engine_stub``, a runnable engine process),
  ``datasource.pubsub`` (the MEMORY and FILE backends behind
  ``App.subscribe``) and ``batch`` (offline generation jobs over pub/sub
  in the engine's batch class, ``POST /v1/batches``);
- the native edge and the datasources: ``native`` (the HTTP wire codec,
  C++ built with g++ at first use) behind ``http.nativeserver`` (the
  App's default server), ``datasource.sql``, ``datasource.redis``,
  ``migration`` (``App.migrate``), ``crud`` (``App.add_rest_handlers``),
  ``testutil`` (``MiniRedis``) and ``utils`` (``snake_case``);
  ``datasource.mongo`` (``InMemoryMongo``, ``InstrumentedMongo``, the
  BSON/OP_MSG codec and ``WireMongo`` over SCRAM and TLS, wired by
  ``App.add_mongo``) with ``testutil.fakemongo``, and ``container_mock``
  (``new_mock_container``, ``MockGPU``);
  ``examples`` holds the counterparts of the JAX package's framework
  examples, each run as ``python -m gofr_tpu_torch.examples.<name>``;
- training on one card: ``parallel`` (``make_mesh``, ``lm_loss``,
  ``make_train_step`` with AdamW as optax's, ``place_batch``; multi-card
  meshes are refused), ``data`` (the memory-mapped token corpus, the
  checkpointable batch iterator, ``device_prefetch``; the native gather
  of ``native/datacore.cc``), ``models.transformer.train_forward`` and
  the MoE training half of ``models.moe``, whose attention is the flash
  kernel with a gradient, and the ``train_lm`` example.

The package imports torch and numpy only: nothing of ``jax`` and nothing of
``gofr_tpu``. Host-only pieces it needs are copied and trimmed. Importing
the package itself loads no torch: the HTTP framework and the front
router (``router``, which launches engine processes and proxies to them)
run without it. The package exports the JAX package's public names
(``App``, ``new``, ``new_cmd``, ``Context``, the HTTP errors, ``Raw``,
``FileResponse``, ``Redirect``, ``StreamingResponse``,
``new_mock_container``, ``__version__``) and ``resolve_device``, each
loaded on first access.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU they raise. A kernel wrapper given a CPU
tensor runs the kernel's plain PyTorch version; given a CUDA tensor it
launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

from .version import FRAMEWORK as __version__


def resolve_device(device=None) -> "torch.device":  # noqa: F821 — torch loads here, not at package import
    """The device an entry point runs on: ``cuda`` by default, ``cpu`` only
    when the caller asks for it. Raises when CUDA is requested (explicitly
    or by default) and no GPU is visible — a missing card must never turn
    into a silent CPU run."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gofr_tpu_torch runs on CUDA by default and no GPU is visible; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def new_cmd(config=None, configs_dir: str = "./configs"):
    """A CLI app (``cmd.CMDApp``): sub-commands, no servers."""
    from .cmd import CMDApp

    return CMDApp(config=config, configs_dir=configs_dir)


# The framework's public names (JAX gofr_tpu/__init__.py's), loaded on first
# access (PEP 562): submodules import ``resolve_device`` from this package,
# so an eager import of ``.app`` here would run against a half-built
# package. None of them loads torch.
_LAZY = {
    "App": ".app", "new": ".app", "Context": ".context",
    "ErrorEntityNotFound": ".http", "ErrorInvalidParam": ".http", "ErrorInvalidRoute": ".http",
    "ErrorMissingParam": ".http", "HTTPError": ".http", "Raw": ".http",
    "FileResponse": ".http", "Redirect": ".http", "StreamingResponse": ".http",
    "new_mock_container": ".container_mock",
}


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module, __name__), name)
    globals()[name] = value
    return value


__all__ = ["new_cmd", "resolve_device", *_LAZY]
