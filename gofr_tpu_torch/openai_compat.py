"""OpenAI-compatible serving edge (counterpart of gofr_tpu/openai_compat.py):

- ``POST /v1/chat/completions`` — messages -> chat-templated prompt ->
  engine stream; ``stream: true`` answers Server-Sent Events
  (``data: {chunk}\\n\\n`` ... ``data: [DONE]\\n\\n``);
- ``POST /v1/embeddings`` — mean-pooled rows of the model's embedding
  matrix, L2-normalized; accepts a string, a list of strings, or token-id
  lists;
- ``GET /v1/models`` — the registered models, each LoRA adapter resident
  on one listed beside it (``parent``: its base).

A request selects a LoRA adapter by ``model=<adapter>`` (routed to the
base model that holds it) or by the ``X-GoFr-Adapter`` header, which wins
when both are given; answers echo the adapter's name as ``model``.

``response_format`` ``{"type": "json_schema", "json_schema": {"schema":
...}}`` or ``{"type": "regex", "regex": "..."}`` compiles (once per
schema, through ``structured.grammar_cache``) against the model's
tokenizer vocabulary into a token grammar that constrains the request's
decoding: the content is valid under it by construction.

Errors answer the OpenAI envelope ``{"error": {"message", "type",
"code"}}``: 400 for a bad body, a prompt that leaves no decode room or a
``response_format`` that cannot be compiled (``json_object`` among them,
as in the JAX edge), 404 for an unknown model or adapter, 429 with
Retry-After when every resident-grammar slot holds live requests, 503
when the engine has stopped.

Tokenization: a tokenizer passed in, else the byte-level tokenizer when
the model's vocabulary admits it (>= 258 ids), else text routes answer
400. Knobs: ``GOFR_OPENAI_MODEL`` (model when the request names none),
``GOFR_OPENAI_MAX_TOKENS`` (default and cap of max_tokens),
``GOFR_OPENAI_STREAM_TIMEOUT_S``, ``GOFR_OPENAI_USAGE_EXTRA`` ("1": a
completion's ``usage`` also carries the request's chip time,
``chip_time_ms``, and its waste breakdown, ``chip_breakdown_ms``, from the
goodput ledger; off by default, the OpenAI schema byte for byte).
"""

from __future__ import annotations

import asyncio
import math
import time
import uuid
from typing import Any

import numpy as np
import torch

from .http.responder import Response, StreamingResponse, to_json_bytes
from .llm import EngineDraining, EngineOverloaded, EngineStoppedError, GenRequest, UnknownAdapterError
from .models.quant import QTensor

__all__ = ["register_openai_routes", "chat_prompt"]


def _openai_error(status: int, message: str, *, etype: str = "invalid_request_error",
                  code: str | None = None, retry_after: float | None = None) -> Response:
    headers = [("Content-Type", "application/json")]
    if retry_after is not None and retry_after > 0:
        headers.append(("Retry-After", str(max(1, math.ceil(retry_after)))))
    return Response(status, headers, to_json_bytes({
        "error": {"message": message, "type": etype, "code": code},
    }))


class _OpenAIReject(Exception):
    def __init__(self, resp: Response):
        self.resp = resp


def chat_prompt(messages: list[dict]) -> str:
    """Minimal chat template: role-tagged turns plus the assistant cue."""
    parts = []
    for m in messages:
        role = str(m.get("role", "user"))
        content = m.get("content", "")
        if isinstance(content, list):  # OpenAI content-part arrays
            content = "".join(
                p.get("text", "") for p in content if isinstance(p, dict)
            )
        parts.append(f"<|{role}|>\n{content}\n")
    parts.append("<|assistant|>\n")
    return "".join(parts)


def _host_embedding(params: dict) -> np.ndarray:
    """The embedding matrix as host float32 (dequantized when int8)."""
    emb = params["embed"]
    if isinstance(emb, QTensor):
        emb = emb.q.float() * emb.s.float()
    return emb.detach().to("cpu", torch.float32).numpy()


def register_openai_routes(
    app,
    model: str = "",
    *,
    tokenizer: Any = None,
) -> None:
    """Register the OpenAI-compatible routes on an App serving the
    registered LLM ``model`` (default: GOFR_OPENAI_MODEL, else the first
    registered model)."""
    cfg = app.config
    default_model = model or cfg.get_or_default("GOFR_OPENAI_MODEL", "")
    max_tokens_cap = int(cfg.get_or_default("GOFR_OPENAI_MAX_TOKENS", "512"))
    stream_timeout = float(cfg.get_or_default("GOFR_OPENAI_STREAM_TIMEOUT_S", "120"))
    usage_extra = cfg.get_or_default("GOFR_OPENAI_USAGE_EXTRA", "0") not in ("", "0")  # JAX :109-113
    # per-model caches; the embedding matrix is fetched to the host once
    state: dict[str, Any] = {"tok": {}, "vocab": {}, "embed": None}

    def _adapter_names(engine) -> list[str]:
        """Resident LoRA adapter names on this engine (JAX
        ``_adapter_names``)."""
        return sorted(engine.adapters().get("resident", {}))

    def _handle(ctx, name: str = ""):
        """The request's ``model`` field -> (served name, engine, adapter).
        An adapter name routes to the base engine that holds it, with the
        adapter selected; an unknown non-empty name raises KeyError (the
        OpenAI 404) instead of serving base weights to a tenant that asked
        for its fine-tune."""
        llms = ctx.container.tpu()._llms
        want = name or default_model
        if want and want in llms:
            return want, llms[want], ""
        if want:
            for base_name, engine in llms.items():
                if want in _adapter_names(engine):
                    return base_name, engine, want
            raise KeyError(
                f"model {want!r} not found; registered: "
                f"{sorted(llms) or 'none'}"
            )
        if llms:
            first = next(iter(llms))
            return first, llms[first], ""
        raise KeyError("no LLM registered")

    def _tokenizer(name: str, engine):
        if tokenizer is not None:
            return tokenizer
        cached = state["tok"].get(name)
        if cached is not None:
            return cached
        if engine.cfg.vocab_size >= 258:
            from .models.tokenizer import ByteTokenizer

            state["tok"][name] = ByteTokenizer(engine.cfg.vocab_size)
            return state["tok"][name]
        return None

    def _grammar(name: str, tok, response_format):
        """The request's token grammar, or None (JAX ``_grammar``)."""
        if not response_format:
            return None
        ftype = response_format.get("type")
        if ftype in (None, "text"):
            return None
        if ftype not in ("json_schema", "regex"):
            raise _OpenAIReject(_openai_error(
                400,
                f"response_format type {ftype!r} unsupported; use "
                "'json_schema' or 'regex' (a full free-form 'json_object' "
                "grammar needs a pushdown automaton, not a DFA)",
            ))
        if ftype == "regex":
            pattern = response_format.get("regex") or response_format.get("pattern")
            if not isinstance(pattern, str) or not pattern:
                raise _OpenAIReject(_openai_error(400, "response_format.regex missing (pattern string)"))
            schema = None
        else:
            spec = response_format.get("json_schema") or {}
            schema = spec.get("schema", spec if "properties" in spec else None)
            if schema is None:
                raise _OpenAIReject(_openai_error(400, "response_format.json_schema.schema missing"))
        if tok is None:
            raise _OpenAIReject(_openai_error(400, f"{ftype} needs a tokenizer on this deployment"))
        from .structured import JsonSchemaError, grammar_cache, vocab_from_tokenizer

        if name not in state["vocab"]:
            state["vocab"][name] = vocab_from_tokenizer(tok)
        eos = getattr(tok, "eos_id", None)
        if eos is None:
            raise _OpenAIReject(_openai_error(400, "tokenizer exposes no eos; cannot close a grammar"))
        try:
            if ftype == "regex":
                return grammar_cache.get_regex(pattern, state["vocab"][name], int(eos))
            return grammar_cache.get(schema, state["vocab"][name], int(eos))
        except JsonSchemaError as e:
            raise _OpenAIReject(_openai_error(400, str(e))) from e

    def _gen_kwargs(ctx, body, adapter: str = "") -> dict:
        from .handler import llm_request_kwargs

        kw = llm_request_kwargs(ctx)
        user = body.get("user")
        if user and not kw.get("client"):
            kw["client"] = str(user)
        # the adapter the model name resolved to; an explicit
        # X-GoFr-Adapter header (already in kw) wins
        if adapter and not kw.get("adapter"):
            kw["adapter"] = adapter
        return kw

    def _submit(ctx, name, engine, body, tok, adapter: str = ""):
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise _OpenAIReject(_openai_error(400, "messages must be a non-empty list"))
        if body.get("n", 1) not in (1, None):
            raise _OpenAIReject(_openai_error(400, "n > 1 unsupported"))
        grammar = _grammar(name, tok, body.get("response_format"))
        if tok is None:
            raise _OpenAIReject(_openai_error(
                400,
                "no tokenizer on this deployment and the model vocabulary "
                "is too small for the byte fallback; send token ids via "
                "the native /generate surface",
            ))
        toks = tok.encode(chat_prompt(messages))
        max_new = int(
            body.get("max_completion_tokens")
            or body.get("max_tokens")
            or min(64, max_tokens_cap)
        )
        max_new = max(1, min(max_new, max_tokens_cap))
        eos = grammar.eos_id if grammar is not None else (tok.eos_id if tok.eos_id is not None else -1)
        req = GenRequest(
            toks,
            max_new_tokens=max_new,
            temperature=float(body.get("temperature") or 0.0),
            eos_token=eos,
            grammar=grammar,
            **_gen_kwargs(ctx, body, adapter),
        )
        try:
            return engine.submit(req), len(toks)
        except EngineOverloaded as e:
            raise _OpenAIReject(_openai_error(
                429, str(e), etype="rate_limit_error", retry_after=e.retry_after,
            )) from e
        except EngineDraining as e:
            raise _OpenAIReject(_openai_error(
                503, str(e), etype="service_unavailable", retry_after=e.retry_after,
            )) from e
        except EngineStoppedError as e:
            raise _OpenAIReject(_openai_error(503, str(e), etype="service_unavailable")) from e
        except UnknownAdapterError as e:
            raise _OpenAIReject(_openai_error(404, str(e), etype="not_found_error")) from e
        except ValueError as e:
            raise _OpenAIReject(_openai_error(400, str(e))) from e

    def _finish(reason: str | None) -> str:
        return "stop" if reason == "eos" else (
            "length" if reason in ("length", None) else str(reason)
        )

    async def chat_completions(ctx):
        body = ctx.bind()
        if not isinstance(body, dict):
            return _openai_error(400, "body must be a JSON object")
        try:
            name, engine, adapter = _handle(ctx, str(body.get("model") or ""))
        except KeyError as e:
            return _openai_error(404, str(e), etype="not_found_error")
        tok = _tokenizer(name, engine)
        try:
            req, n_prompt = _submit(ctx, name, engine, body, tok, adapter)
        except _OpenAIReject as e:
            return e.resp
        # answers echo the model the client selected: the adapter's name
        # when the request routed through a tenant's fine-tune
        base = {"id": f"chatcmpl-{uuid.uuid4().hex[:16]}", "created": int(time.time()), "model": adapter or name}
        eos_id = req.eos_token

        if body.get("stream"):
            async def sse():
                emitted: list[int] = []
                prev = ""
                head = {
                    **base,
                    "object": "chat.completion.chunk",
                    "choices": [{
                        "index": 0,
                        "delta": {"role": "assistant", "content": ""},
                        "finish_reason": None,
                    }],
                }
                yield b"data: " + to_json_bytes(head) + b"\n\n"
                # a vanished client closes this generator: astream's
                # disconnect hook cancels the engine request, and only a
                # stream that finished reaches the terminal chunk below
                async for t in req.astream(timeout=stream_timeout):
                    if t == eos_id:
                        continue
                    emitted.append(t)
                    text = tok.decode(emitted)
                    delta, prev = text[len(prev):], text
                    if not delta:
                        continue  # partial multi-byte sequence
                    chunk = {
                        **base,
                        "object": "chat.completion.chunk",
                        "choices": [{
                            "index": 0,
                            "delta": {"content": delta},
                            "finish_reason": None,
                        }],
                    }
                    yield b"data: " + to_json_bytes(chunk) + b"\n\n"
                tail = {
                    **base,
                    "object": "chat.completion.chunk",
                    "choices": [{
                        "index": 0,
                        "delta": {},
                        "finish_reason": _finish(req.finish_reason),
                    }],
                }
                yield b"data: " + to_json_bytes(tail) + b"\n\n"
                yield b"data: [DONE]\n\n"

            return StreamingResponse(sse(), content_type="text/event-stream")

        loop = asyncio.get_running_loop()
        out = await loop.run_in_executor(None, lambda: req.tokens(timeout=stream_timeout))
        content_ids = [t for t in out if t != eos_id]
        usage = {"prompt_tokens": n_prompt, "completion_tokens": len(out), "total_tokens": n_prompt + len(out)}
        if usage_extra:  # JAX :388-396
            chip = dict(req._chip)
            usage["chip_time_ms"] = round(sum(chip.values()) * 1e3, 3)
            usage["chip_breakdown_ms"] = {c: round(v * 1e3, 3) for c, v in chip.items()}
        payload = {
            **base,
            "object": "chat.completion",
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": tok.decode(content_ids)},
                "finish_reason": _finish(req.finish_reason),
            }],
            "usage": usage,
        }
        return Response(200, [("Content-Type", "application/json")], to_json_bytes(payload))

    def embeddings(ctx):
        body = ctx.bind()
        if not isinstance(body, dict):
            return _openai_error(400, "body must be a JSON object")
        try:
            name, engine, _adapter = _handle(ctx, str(body.get("model") or ""))
        except KeyError as e:
            return _openai_error(404, str(e), etype="not_found_error")
        raw = body.get("input")
        if raw is None:
            return _openai_error(400, "input missing")
        items = raw if isinstance(raw, list) else [raw]
        if items and isinstance(items[0], int):
            items = [items]  # single token-id list
        tok = _tokenizer(name, engine)
        if state["embed"] is None or state["embed"][0] != name:
            state["embed"] = (name, _host_embedding(engine.params))
        emb = state["embed"][1]
        data = []
        total_toks = 0
        for i, item in enumerate(items):
            if isinstance(item, str):
                if tok is None:
                    return _openai_error(400, "text input needs a tokenizer on this deployment")
                ids = tok.encode(item, add_bos=False)
            elif isinstance(item, list) and all(isinstance(t, int) for t in item):
                ids = item
            else:
                return _openai_error(400, f"input[{i}] must be text or token ids")
            ids = [t for t in ids if 0 <= t < emb.shape[0]] or [0]
            total_toks += len(ids)
            v = emb[ids].mean(axis=0)
            norm = float(np.linalg.norm(v))
            if norm > 1e-12:
                v = v / norm
            data.append({"object": "embedding", "index": i, "embedding": [float(x) for x in v]})
        return Response(200, [("Content-Type", "application/json")], to_json_bytes({
            "object": "list",
            "data": data,
            "model": name,
            "usage": {"prompt_tokens": total_toks, "total_tokens": total_toks},
        }))

    def list_models(ctx):
        llms = ctx.container.tpu()._llms
        data = [
            {"id": name, "object": "model", "created": 0, "owned_by": "gofr_tpu"}
            for name in llms
        ]
        # every resident adapter lists beside its base, as OpenAI lists
        # fine-tunes: ``parent`` names the base model
        for name, engine in llms.items():
            for aname in _adapter_names(engine):
                data.append({"id": aname, "object": "model", "created": 0, "owned_by": "gofr_tpu", "parent": name})
        return Response(200, [("Content-Type", "application/json")], to_json_bytes({
            "object": "list",
            "data": data,
        }))

    # a non-streaming generation may run past REQUEST_TIMEOUT; a streaming
    # handler needs the timeout only to obtain its generator
    app._add(
        "POST", "/v1/chat/completions", chat_completions,
        timeout_s=max(stream_timeout, app.request_timeout),
    )
    app.post("/v1/embeddings", embeddings)
    app.get("/v1/models", list_models)
