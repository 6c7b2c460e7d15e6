"""HTTP serving of Gemma through the port (counterpart of the HTTP half of
examples/grpc-gemma/main.py).

    python -m gofr_tpu_torch.serve

Routes: ``POST /generate`` (body ``{"tokens": [...]}`` or ``{"prompt":
"..."}``, byte-tokenized; plus ``max_new_tokens``, ``temperature``,
``eos_token``; answers 201 ``{"data": {"tokens": [...]}}``, with ``text``
for a prompt), ``GET /stats`` (the engine's counters), and the OpenAI
routes ``/v1/chat/completions`` (plain and SSE), ``/v1/embeddings`` and
``/v1/models`` through ``ByteTokenizer(cfg.vocab_size)``, beside the
well-known health and liveness routes.

Config (process environment, or ``configs/.env``): ``GEMMA_PRESET``
``tiny`` (default) or ``2b``; ``GEMMA_INT8=1`` serves int8 weights;
``LLM_SLOTS`` (4), ``LLM_MAX_SEQ`` (256); ``TORCH_DEVICE=cpu`` runs on the CPU (default: the GPU,
raising without one); ``HTTP_PORT`` (8000), ``REQUEST_TIMEOUT`` (5 s);
``TPU_LLM_PREFIX_CACHE_MB``, ``TPU_LLM_SESSION_MB`` and ``TPU_LLM_HOST_CACHE_MB``
turn on the prefix cache and the ``X-GoFr-Session`` tier, ``TPU_LLM_SPEC=1``
(with ``TPU_LLM_SPEC_DRAFT``) speculative decoding, and ``TPU_LLM_FAIR``,
``TPU_LLM_PREEMPT``, ``TPU_LLM_SHED_WAIT_S`` and ``TPU_LLM_BROWNOUT_*``
tune overload control (``GPURuntime``). ``X-GoFr-Priority: batch`` and
``X-GoFr-Client`` reach the engine's queue order and preemption; an
overloaded engine answers 429 with a Retry-After header.
Weights are random, made from a ``torch.Generator`` seeded with 0: loading a
checkpoint (``GEMMA_CKPT``) is not ported and raises.
"""

from __future__ import annotations

import torch

from .app import App, new
from .config import Config
from .handler import llm_request_kwargs
from .http.errors import ErrorInvalidParam
from .models import TransformerConfig, init_params
from .models.tokenizer import ByteTokenizer
from .openai_compat import register_openai_routes

PRESETS = {"tiny": TransformerConfig.tiny, "2b": TransformerConfig.gemma_2b}
MODEL = "gemma"


def build_engine(app: App, params: dict | None = None) -> TransformerConfig:
    """Register the ``gemma`` engine on ``app``: random weights from seed 0
    unless ``params`` are given (they must match the preset)."""
    cfg_ = app.config
    preset = cfg_.get_or_default("GEMMA_PRESET", "tiny")
    if preset not in PRESETS:
        raise ValueError(f"GEMMA_PRESET={preset!r}: one of {sorted(PRESETS)}")
    if cfg_.get("GEMMA_CKPT"):
        raise NotImplementedError("GEMMA_CKPT: checkpoint loading is not ported; the port serves random weights")
    cfg = PRESETS[preset]()
    rt = app.container.tpu()
    if params is None:
        app.logger.warn("serving randomly initialized weights")
        dev = rt.device
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, gen, dev)
    rt.register_llm(
        MODEL, cfg, params,
        slots=cfg_.get_int("LLM_SLOTS", 4),
        max_seq_len=cfg_.get_int("LLM_MAX_SEQ", 256),
        prefill_buckets=(16, 64, 128),
        quantize=cfg_.get_bool("GEMMA_INT8"),
    )
    return cfg


def build_app(config: Config | None = None, params: dict | None = None) -> App:
    app = new(config=config)
    cfg = build_engine(app, params)
    tok = ByteTokenizer(cfg.vocab_size)

    def request_tokens(body) -> tuple[list[int], int]:
        if not isinstance(body, dict):
            raise ErrorInvalidParam("body")
        if "prompt" in body:
            return tok.encode(str(body["prompt"])), tok.eos_id
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
        if "prompt" in body:
            resp["text"] = tok.decode(out)
        return resp

    def engine_stats(ctx):
        return ctx.tpu().llm(MODEL).stats()

    app.post("/generate", generate)
    app.get("/stats", engine_stats)
    register_openai_routes(app, model=MODEL, tokenizer=tok)
    return app


def main() -> None:
    build_app().run()


if __name__ == "__main__":
    main()
