"""HTTP and gRPC serving of the Gemma, Llama and Mistral presets through
the port (counterpart of examples/grpc-gemma/main.py).

    python -m gofr_tpu_torch.serve

gRPC (JSON over gRPC, ``grpcx``): ``Gemma/Generate`` (unary, the same
handler as ``POST /generate``, answering its ``data``) and ``Gemma/Stream``
(server-streaming, one ``{"token": id}`` chunk per token, with ``text``
when a tokenizer is loaded) on ``GRPC_PORT`` (default 9000), registered
when ``grpc`` (grpcio) imports; without it the app logs one line and
serves HTTP alone, unless ``GRPC_PORT`` is set, which then raises. gRPC
metadata reaches the handlers through ``ctx.header``: ``x-gofr-priority``,
``x-gofr-client``, ``x-gofr-session`` and ``x-gofr-adapter`` work as the
HTTP headers do; an overloaded engine answers RESOURCE_EXHAUSTED with a
``retry-after`` trailer.

Routes: ``POST /generate`` (body ``{"tokens": [...]}`` or ``{"prompt":
"..."}``; plus ``max_new_tokens``, ``temperature``, ``eos_token``; answers
201 ``{"data": {"tokens": [...]}}``, with ``text`` for a prompt or
whenever an HF tokenizer is loaded), ``GET /stats`` (the engine's
counters), and the OpenAI routes ``/v1/chat/completions`` (plain and
SSE), ``/v1/embeddings`` and ``/v1/models``, beside the well-known health
and liveness routes.

Config (process environment, or ``configs/.env``): ``GEMMA_PRESET``
``tiny`` (default), ``2b``, ``7b``, ``llama3-8b``, ``tiny-llama``,
``mistral-7b`` or ``tiny-mistral`` (the JAX example's names; a windowed
preset is served from the paged pool, ROADMAP queue 3 item 11);
``GEMMA_CKPT`` loads an HF safetensors checkpoint (a file, a directory
of shards, or one with ``model.safetensors.index.json``) through the
Llama mapper for the ``llama*``/``mistral*`` presets and the Gemma mapper
otherwise, then ``validate_params`` (without it the weights are random,
from a ``torch.Generator`` seeded with 0); the tokenizer comes from
``GEMMA_TOKENIZER``, else from the ``tokenizer.json`` of a checkpoint
directory (a missing file logs a warning and keeps the id-only API);
``GEMMA_INT8=1`` serves int8 weights; ``LLM_SLOTS`` (4), ``LLM_MAX_SEQ``
(256); ``LLM_REPLICAS`` (1; more serves a ``ReplicatedLLMEngine`` of that
many replicas on the one device, with failover and the supervisor, and
``TPU_LLM_STEP_WATCHDOG_S`` / ``TPU_LLM_NUMERIC_CHECK`` set the watchdogs); ``TORCH_DEVICE=cpu`` runs on the CPU (default: the GPU, raising
without one); ``HTTP_PORT`` (8000), ``REQUEST_TIMEOUT`` (5 s);
``TPU_LLM_STEP_TOKEN_BUDGET`` (0: the wave scheduler), ``TPU_LLM_PREFILL_CHUNK``
and ``TPU_LLM_KV_BLOCK`` set the engine's shape knobs;
``TPU_LLM_PREFIX_CACHE_MB``, ``TPU_LLM_SESSION_MB`` and ``TPU_LLM_HOST_CACHE_MB``
turn on the prefix cache and the ``X-GoFr-Session`` tier, ``TPU_LLM_SPEC=1``
(with ``TPU_LLM_SPEC_DRAFT``) speculative decoding, and ``TPU_LLM_FAIR``,
``TPU_LLM_PREEMPT``, ``TPU_LLM_SHED_WAIT_S`` and ``TPU_LLM_BROWNOUT_*``
tune overload control, and ``TPU_LLM_LORA_SLOTS`` (with
``TPU_LLM_LORA_RANK_MAX``) gives the engine a LoRA adapter pool
(``GPURuntime``). ``X-GoFr-Priority: batch`` and ``X-GoFr-Client`` reach
the engine's queue order and preemption; an overloaded engine answers 429
with a Retry-After header. ``X-GoFr-Adapter`` (or ``model=<adapter>`` on
the OpenAI routes) selects a loaded adapter; an unknown one answers 404.

Text: a ``prompt`` is encoded by the loaded tokenizer (eos = its eos, or
none); with no tokenizer, by ``ByteTokenizer`` when the vocabulary has
258 ids or more, else the request answers 400. The OpenAI routes use the
same tokenizer.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from .app import App, new
from .config import Config
from .handler import llm_request_kwargs
from .http.errors import ErrorInvalidParam, HTTPError
from .llm import GenRequest
from .models import TransformerConfig, init_params
from .models.checkpoint import load_gemma_checkpoint, load_llama_checkpoint, validate_params
from .models.tokenizer import ByteTokenizer, load_tokenizer
from .openai_compat import register_openai_routes

PRESETS = {
    "tiny": TransformerConfig.tiny,
    "2b": TransformerConfig.gemma_2b,
    "7b": TransformerConfig.gemma_7b,
    "llama3-8b": TransformerConfig.llama3_8b,
    "tiny-llama": TransformerConfig.tiny_llama,
    "mistral-7b": TransformerConfig.mistral_7b,
    "tiny-mistral": TransformerConfig.tiny_mistral,
}
MODEL = "gemma"


class NoTokenizer(HTTPError):
    """A text prompt on a deployment with no tokenizer for it."""

    status_code = 400


def _tokenizer(app: App, ckpt: str):
    """The HF tokenizer from ``GEMMA_TOKENIZER``, or from a checkpoint
    directory's tokenizer.json; None (id-only API) when there is none."""
    path = app.config.get_or_default("GEMMA_TOKENIZER", "") or (ckpt if os.path.isdir(ckpt) else "")
    if not path:
        return None
    try:
        tok = load_tokenizer(path)
    except FileNotFoundError:
        app.logger.warn(f"no tokenizer.json under {path}; id-only API")
        return None
    app.logger.info(f"tokenizer loaded ({tok.vocab_size} pieces)")
    return tok


def build_engine(app: App, params: dict | None = None) -> tuple[TransformerConfig, object]:
    """Register the ``gemma`` engine on ``app``: ``params`` when given (they
    must match the preset at their own depth, the stacked layer count),
    else the ``GEMMA_CKPT`` checkpoint, else random weights from seed 0.
    Returns (config, HF tokenizer or None)."""
    cfg_ = app.config
    preset = cfg_.get_or_default("GEMMA_PRESET", "tiny")
    if preset not in PRESETS:
        raise ValueError(f"GEMMA_PRESET={preset!r}: one of {sorted(PRESETS)}")
    cfg = PRESETS[preset]()
    if params is not None:  # the preset's widths at the params' own depth
        cfg = dataclasses.replace(cfg, n_layers=int(next(iter(params["layers"].values())).shape[0]))
    rt = app.container.tpu()
    ckpt = cfg_.get_or_default("GEMMA_CKPT", "")
    if params is None and ckpt:
        app.logger.info(f"loading weights from {ckpt}")
        loader = load_llama_checkpoint if ("llama" in preset or "mistral" in preset) else load_gemma_checkpoint
        params = loader(ckpt, cfg, device=rt.device)
        validate_params(params, cfg)
    elif params is None:
        app.logger.warn("GEMMA_CKPT not set: serving randomly initialized weights")
        dev = rt.device
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, gen, dev)
    tok = _tokenizer(app, ckpt)
    rt.register_llm(
        MODEL, cfg, params,
        slots=cfg_.get_int("LLM_SLOTS", 4),
        max_seq_len=cfg_.get_int("LLM_MAX_SEQ", 256),
        prefill_buckets=(16, 64, 128),
        quantize=cfg_.get_bool("GEMMA_INT8"),
        replicas=cfg_.get_int("LLM_REPLICAS", 1),
    )
    return cfg, tok


def build_app(config: Config | None = None, params: dict | None = None) -> App:
    app = new(config=config)
    grpc_on = _grpc_available(app)  # before the engine: a refusal leaks nothing
    cfg, hf_tok = build_engine(app, params)
    tok = hf_tok if hf_tok is not None else ByteTokenizer(cfg.vocab_size) if cfg.vocab_size >= 258 else None

    def request_tokens(body) -> tuple[list[int], int]:
        if not isinstance(body, dict):
            raise ErrorInvalidParam("body")
        if "prompt" in body:
            if tok is None:
                raise NoTokenizer("no tokenizer configured; send 'tokens'")
            eos = tok.eos_id if tok.eos_id is not None else -1
            return tok.encode(str(body["prompt"])), eos
        return list(body["tokens"]), int(body.get("eos_token", -1))

    def generate(ctx):
        body = ctx.bind()
        toks, eos = request_tokens(body)
        out = ctx.tpu().llm(MODEL).generate(
            toks, max_new_tokens=int(body.get("max_new_tokens", 16)),
            temperature=float(body.get("temperature", 0.0)), eos_token=eos,
            # past the handler's timeout the engine retires the request
            # instead of decoding for a client that has its 408
            deadline=ctx.deadline,
            **llm_request_kwargs(ctx),
        )
        resp = {"tokens": out}
        if "prompt" in body or hf_tok is not None:
            resp["text"] = tok.decode(out)
        return resp

    async def stream(ctx):
        """Gemma/Stream: one chunk per token. No deadline, unlike generate:
        REQUEST_TIMEOUT bounds obtaining this generator, never the stream."""
        body = ctx.bind()
        toks, eos = request_tokens(body)
        req = ctx.tpu().llm(MODEL).submit(GenRequest(
            toks, max_new_tokens=int(body.get("max_new_tokens", 16)),
            temperature=float(body.get("temperature", 0.0)), eos_token=eos,
            **llm_request_kwargs(ctx),
        ))
        emitted: list[int] = []
        async for t in req.astream():
            chunk = {"token": t}
            if hf_tok is not None:
                # incremental text: all tokens so far minus the prefix
                prev = hf_tok.decode(emitted)
                emitted.append(t)
                chunk["text"] = hf_tok.decode(emitted)[len(prev):]
            yield chunk

    def engine_stats(ctx):
        return ctx.tpu().llm(MODEL).stats()

    if grpc_on:
        app.grpc_unary("Gemma", "Generate", generate)
        app.grpc_server_stream("Gemma", "Stream", stream)
    app.post("/generate", generate)
    app.get("/stats", engine_stats)
    register_openai_routes(app, model=MODEL, tokenizer=tok)
    return app


def _grpc_available(app: App) -> bool:
    """Whether the gRPC routes can be served: ``grpc`` imports. Without it
    the app logs that gRPC is off and serves HTTP alone; a ``GRPC_PORT``
    set explicitly asks for gRPC, so its absence then raises."""
    try:
        import grpc  # noqa: F401
    except ImportError as e:
        if app.config.get("GRPC_PORT"):
            raise RuntimeError(f"GRPC_PORT is set but grpc (grpcio) cannot be imported: {e}") from e
        app.logger.info("gRPC off: grpc (grpcio) is not installed; serving HTTP only")
        return False
    return True


def main() -> None:
    build_app().run()


if __name__ == "__main__":
    main()
