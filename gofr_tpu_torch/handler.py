"""Handler adaptation: ``handler(ctx) -> result`` to a wire handler
(counterpart of gofr_tpu/handler.py: ``wrap_handler``,
``llm_request_kwargs``, the health and liveness handlers, the loopback
guard of the drain route, the favicon, the rollout routes, the engine, capture
registry, trace ring and profile routes, and the flight recorder's and
the usage meter's routes: blackbox listing, usage, replay)."""

from __future__ import annotations

import asyncio
import contextvars
import hashlib
import inspect
import time
import traceback
from typing import Any, Callable

from .container import Container
from .context import Context
from .http.errors import ErrorPanicRecovery, ErrorRequestTimeout, ErrorServiceUnavailable, HTTPError
from .http.request import Request
from .http.responder import Response, respond
from .http.router import WireHandler

# a 1x1 transparent PNG: /favicon.ico answers 200 with an image
FAVICON = (
    b"\x89PNG\r\n\x1a\n\x00\x00\x00\rIHDR\x00\x00\x00\x01\x00\x00\x00\x01\x08\x06"
    b"\x00\x00\x00\x1f\x15\xc4\x89\x00\x00\x00\nIDATx\x9cc\x00\x01\x00\x00\x05\x00"
    b"\x01\r\n-\xb4\x00\x00\x00\x00IEND\xaeB`\x82"
)


async def favicon_wire_handler(_req: Request) -> Response:
    return Response(200, [("Content-Type", "image/png")], FAVICON)


async def _call_handler(fn: Callable, ctx: Context) -> Any:
    if inspect.iscoroutinefunction(fn):
        return await fn(ctx)
    # a sync handler blocks (an engine wait): run it in the executor, never
    # on the event loop, in a copy of this task's context (the active span)
    loop = asyncio.get_running_loop()
    cvars = contextvars.copy_context()
    return await loop.run_in_executor(None, lambda: cvars.run(fn, ctx))


def wrap_handler(fn: Callable, container: Container, timeout_s: float | None) -> WireHandler:
    """The wire handler for one user handler: the route's timeout answers
    408 (and sets ``ctx.deadline``, so the engine retires the abandoned
    request), an HTTPError answers its own status, and any other exception
    the masked 500 envelope."""

    async def h(req: Request) -> Response:
        ctx = Context(req, container)
        if timeout_s and timeout_s > 0:
            ctx.deadline = time.perf_counter() + timeout_s
        try:
            if timeout_s and timeout_s > 0:
                result = await asyncio.wait_for(_call_handler(fn, ctx), timeout=timeout_s)
            else:
                result = await _call_handler(fn, ctx)
        except asyncio.TimeoutError:
            return respond(None, ErrorRequestTimeout(), req.method)
        except Exception as e:  # noqa: BLE001 - error envelope boundary
            if getattr(e, "status_code", None) is None:
                container.logger.error(f"panic recovered: {traceback.format_exc()}")
                return respond(None, ErrorPanicRecovery(), req.method)
            return respond(None, e, req.method)
        return respond(result, None, req.method)

    return h


def llm_request_kwargs(ctx: Context) -> dict:
    """GenRequest identity kwargs from the request edge, as the JAX edge
    builds them: ``priority`` (X-GoFr-Priority), ``client`` (X-GoFr-Client,
    else a hash of X-API-KEY, else the first X-Forwarded-For hop, else the
    peer address without its port), ``session_id`` (X-GoFr-Session) and
    ``adapter`` (X-GoFr-Adapter: a LoRA adapter loaded on the engine; 404
    when none of that name is resident). Over gRPC the same names arrive
    as metadata (lowercase) through ``ctx.header``. The engine orders its queue by the priority class and the
    client's fair-share counter, preempts batch requests for interactive
    ones and clamps batch requests under brownout; the session id selects
    the engine's session tier when it has one (``session_mb``)."""

    def hdr(name: str) -> str:
        try:
            return ctx.header(name) or ""
        except Exception:  # noqa: BLE001 — headerless request shapes
            return ""

    client = hdr("X-GoFr-Client")
    if not client:
        key = hdr("X-API-KEY")
        if key:
            client = "key:" + hashlib.sha256(key.encode()).hexdigest()[:12]
    if not client:
        fwd = hdr("X-Forwarded-For")
        if fwd:
            client = fwd.split(",")[0].strip()
    if not client:
        addr = getattr(ctx.request, "remote_addr", "") or ""
        client = addr.rsplit(":", 1)[0] if addr else ""
    return {
        "priority": (hdr("X-GoFr-Priority") or "interactive").lower(),
        "client": client,
        "session_id": hdr("X-GoFr-Session"),
        "adapter": hdr("X-GoFr-Adapter"),
    }


def health_handler(ctx: Context) -> Any:
    """Aggregated health and a serving status: "degraded" (still 200) while
    a fleet runs short a replica slot (parked or failed for good), else
    "UP". A draining app answers 503 with a Retry-After (readiness down the
    moment a rolling deploy begins); liveness stays 200."""
    if getattr(ctx.container, "draining", False):
        raise ErrorServiceUnavailable("draining", retry_after=5.0)
    out = ctx.container.health()
    rt = ctx.container.tpu_runtime
    out["status"] = "degraded" if rt is not None and rt.degraded() else "UP"
    return out


def _require_loopback(ctx: Context, opt_in_key: str) -> None:
    """Mutating admin routes answer loopback callers only (403 otherwise)
    unless the config sets ``opt_in_key``=1."""
    host = (getattr(ctx.request, "remote_addr", "") or "").rsplit(":", 1)[0]
    if host in ("127.0.0.1", "::1", "[::1]", "localhost", ""):
        return
    cfg = ctx.container.config
    if cfg is not None and cfg.get_or_default(opt_in_key, "0") == "1":
        return
    err = HTTPError(f"this route is loopback-only (set {opt_in_key}=1)")
    err.status_code = 403
    raise err


def live_handler(_ctx: Context) -> Any:
    return {"status": "UP"}


# -- device observability (JAX handler.py:232-401) ------------------------------


def debug_engine_handler(ctx: Context) -> Any:
    """GET /.well-known/debug/engine: every registered engine's
    ``debug_state`` (slot table, in-flight programs, recent phase
    percentiles, SLO, MFU, capture rows, KV residency) and the
    ``serving`` summary; ``?serving=1`` answers the summary alone (the
    front router's poll). Read-only and bounded; never builds the
    runtime."""
    rt = ctx.container.tpu_runtime
    llms = getattr(rt, "_llms", {}) if rt is not None else {}
    serving = _serving_summary(ctx.container, llms)
    if ctx.param("serving") == "1":
        return {"serving": serving}
    if rt is None:
        return {"engines": {}, "note": "tpu runtime not initialized", "serving": serving}
    return {
        "platform": getattr(rt, "platform", None),
        "engines": {name: eng.debug_state() for name, eng in list(llms.items())},
        "serving": serving,
    }


def _serving_summary(container, llms) -> dict:
    """The process's compact serving signals (JAX ``_serving_summary``):
    queued tokens, measured throughput and predicted wait per model, the
    drain flag, and the degraded-backend signals (the last incident
    bundle's time, the anomaly-flagged signals)."""
    total_load = 0
    total_tput = 0.0
    models: dict[str, dict] = {}
    for name, handle in list(llms.items()):
        eng = getattr(handle, "engine", handle)
        try:
            load = int(eng.load_tokens())
            tput = eng.throughput_tok_s() or 0.0
            wait = eng.predicted_wait_s()
        except Exception:  # noqa: BLE001 — a dying engine must not 500 this
            continue
        total_load += load
        total_tput += tput
        models[name] = {"load_tokens": load, "throughput_tok_s": tput or None, "predicted_wait_s": wait}
    last_incident_ts = None
    flagged: set[str] = set()
    for handle in list(llms.values()):
        eng = getattr(handle, "engine", handle)
        for rep in _replicas(eng):
            bb = getattr(rep, "blackbox", None)
            if bb is not None and bb.last_ts is not None:
                last_incident_ts = max(last_incident_ts or 0.0, bb.last_ts)
            an = getattr(rep, "anomaly", None)
            if an is not None:
                flagged.update(an.flagged())
    return {
        "draining": bool(getattr(container, "draining", False)),
        "load_tokens": total_load,
        "throughput_tok_s": total_tput or None,
        "predicted_wait_s": total_load / total_tput if total_tput > 1e-9 else None,
        "last_incident_ts": last_incident_ts,
        "anomaly": sorted(flagged),
        "models": models,
    }


def _replicas(eng) -> list:
    """An engine's serving engines: a fleet's replicas, a disaggregated
    engine's two pools' replicas, else the engine itself."""
    if hasattr(eng, "prefill") and hasattr(eng, "decode"):
        return list(eng.prefill.engines) + list(eng.decode.engines)
    return list(getattr(eng, "engines", None) or [eng])


def debug_compiles_handler(_ctx: Context) -> Any:
    """GET /.well-known/debug/compiles: the process's capture registry
    (every captured graph family per engine with its capture seconds and
    replays, and the engines' warmup records)."""
    from .profiling import default_registry

    return default_registry().snapshot()


def debug_traces_handler(ctx: Context) -> Any:
    """GET /.well-known/debug/traces: this process's span ring.
    ``?trace_id=<32 hex>`` returns that trace's spans as stored; without
    it, the recent trace summaries (``?limit=``, 64) and the ring's
    occupancy. Read-only and bounded."""
    tracer = getattr(ctx.container, "tracer", None)
    ring = getattr(tracer, "ring", None)
    if ring is None:
        return {"traces": [], "stats": None, "note": "trace ring disabled (TRACE_RING_SPANS=0)"}
    tid = (ctx.param("trace_id") or "").strip().lower()
    if tid:
        spans = ring.query(tid)
        return {"trace_id": tid, "span_count": len(spans), "spans": spans}
    try:
        limit = int(ctx.param("limit") or 64)
    except ValueError:
        limit = 64
    return {"traces": ring.trace_ids(limit=limit), "stats": ring.stats()}


def debug_profile_handler(ctx: Context) -> Any:
    """POST /.well-known/debug/profile: an on-demand ``torch.profiler``
    capture. Query params: ``seconds`` (default 2, clamped 0.1..30),
    ``steps`` (end early once the live engines dispatched that many more
    decode steps), ``download=0`` (the JSON metadata instead of the zip
    archive). One capture at a time (409 otherwise). The capture is
    bounded by the route's own budget less a margin (504 past it), so the
    route answers even when the profiler does not."""
    import math

    from .http.errors import ErrorInvalidParam
    from .http.responder import FileResponse
    from .profiling.capture import profiler_capture

    try:
        seconds = float(ctx.param("seconds") or 2.0)
        if not math.isfinite(seconds):
            raise ValueError
    except ValueError:
        raise ErrorInvalidParam("seconds") from None
    try:
        steps = int(ctx.param("steps") or 0)
    except ValueError:
        raise ErrorInvalidParam("steps") from None
    sample_fn = until = None
    rt = ctx.container.tpu_runtime  # never build one: profile what runs
    llms = dict(getattr(rt, "_llms", {})) if rt is not None else {}
    if llms:
        def sample():  # the host-side view that makes the trace readable
            return {"t": time.time(), "engines": {n: e.stats() for n, e in llms.items()}}

        sample_fn = sample
        if steps > 0:
            replicas = [rep for e in llms.values() for rep in _replicas(getattr(e, "engine", e))]

            def total_steps() -> int:
                return sum(rep._stat_chunk_steps for rep in replicas)

            start = total_steps()
            until = lambda: total_steps() - start >= steps  # noqa: E731
    # the route always has a deadline (app.py registers it with its own
    # timeout); a second of margin leaves room to answer 504
    budget = max(1.0, ctx.deadline - time.perf_counter() - 1.0)
    res = profiler_capture().capture(seconds, budget_s=budget, sample_fn=sample_fn, until=until)
    if ctx.param("download") == "0":
        return {k: v for k, v in res.items() if k != "archive"}
    return FileResponse(res["archive"], "application/zip")


def rollout_status_handler(ctx: Context) -> Any:
    """GET /.well-known/debug/rollout: per registered LLM its active
    version, live replicas per version and the state of its active (or
    last) rollout. Read-only; never builds the runtime."""
    rt = ctx.container.tpu_runtime
    if rt is None:
        return {"models": {}, "note": "tpu runtime not initialized"}
    out = {}
    for name, handle in list(getattr(rt, "_llms", {}).items()):
        eng = getattr(handle, "engine", handle)
        out[name] = {
            "version": getattr(eng, "version", None),
            "versions": (
                eng.version_counts() if hasattr(eng, "version_counts") else {getattr(eng, "version", "v1"): 1}
            ),
            "rollout": handle.rollout_state(),
        }
    return {"models": out}


def rollout_handler(ctx: Context) -> Any:
    """POST /.well-known/debug/rollout: stage a zero-downtime weight rollout
    from a checkpoint on disk. Body: ``{"model": <registered LLM>,
    "checkpoint": <path>, "version": "v2" (optional, derived), "family":
    "gemma" | "llama" (default gemma), "bake_s" / "shadow_probes"
    (optional)}``. The checkpoint is loaded (``models.checkpoint.
    load_checkpoint``) and validated against the model's config before
    ``deploy``: a bad path or tree is a 400, an unknown model a 404, a
    second deploy while one is active a 409. Loopback-only unless
    ``GOFR_ROLLOUT_REMOTE=1``: this route swaps the serving weights."""
    from .http.errors import ErrorEntityNotFound, ErrorInvalidParam
    from .models.checkpoint import load_checkpoint, validate_params

    _require_loopback(ctx, "GOFR_ROLLOUT_REMOTE")
    body = ctx.bind() or {}
    if not isinstance(body, dict):
        raise ErrorInvalidParam("body")
    name = body.get("model")
    path = body.get("checkpoint")
    if not name or not isinstance(name, str):
        raise ErrorInvalidParam("model")
    if not path or not isinstance(path, str):
        raise ErrorInvalidParam("checkpoint")
    rt = ctx.container.tpu_runtime  # never build one: roll what runs
    handle = (getattr(rt, "_llms", {}) if rt is not None else {}).get(name)
    if handle is None or not hasattr(handle, "deploy"):
        raise ErrorEntityNotFound("llm", name)
    cfg = handle.cfg
    params = load_checkpoint(path, cfg, str(body.get("family", "gemma")), device=handle.device)
    validate_params(params, cfg)  # a 400 here; deploy checks again before anything changes
    kw = {}
    if body.get("bake_s") is not None:
        kw["bake_s"] = float(body["bake_s"])
    if body.get("shadow_probes") is not None:
        kw["shadow_probes"] = int(body["shadow_probes"])
    version = body.get("version")
    snap = handle.deploy(cfg, params, version=str(version) if version else None, **kw)
    return {"model": name, "rollout": snap}


# -- the flight recorder and the usage meter (JAX handler.py:498-600) ----------


def debug_blackbox_handler(ctx: Context) -> Any:
    """GET /.well-known/debug/blackbox: this process's incident view, the
    completed bundles' manifests (newest first, one per bundle however
    many replicas share the directory) and each engine's recorder state.
    Read-only and bounded; never builds the runtime."""
    rt = ctx.container.tpu_runtime
    llms = getattr(rt, "_llms", {}) if rt is not None else {}
    bundles: dict[str, dict] = {}
    recorders: dict[str, dict] = {}
    for handle in list(llms.values()):
        eng = getattr(handle, "engine", handle)
        for rep in getattr(eng, "engines", None) or [eng]:
            bb = getattr(rep, "blackbox", None)
            if bb is None:
                continue
            for m in bb.listing():
                bundles.setdefault(m.get("bundle") or m.get("path", ""), m)
            fr = getattr(rep, "flightrec", None)
            an = getattr(rep, "anomaly", None)
            recorders[rep.label] = {
                "directory": bb.directory or None,
                "enabled": bb.enabled(),
                "last_trigger": bb.last_trigger,
                "last_ts": bb.last_ts,
                "rate_limited": bb.rate_limited,
                "flight_records": len(fr) if fr is not None else 0,
                "anomaly": an.flagged() if an is not None else [],
            }
    out = sorted(bundles.values(), key=lambda m: m.get("ts") or 0, reverse=True)
    return {"bundles": out, "count": len(out), "recorders": recorders}


def debug_usage_handler(ctx: Context) -> Any:
    """GET /.well-known/debug/usage: per model, the windowed per-tenant
    usage (chip-seconds by waste class, useful tokens, token rate), the
    cumulative goodput with its conservation identity and the quota
    table (``usage_state``). Read-only and bounded (the meter caps its
    tenants)."""
    rt = ctx.container.tpu_runtime
    llms = getattr(rt, "_llms", {}) if rt is not None else {}
    models: dict[str, dict] = {}
    for name, handle in list(llms.items()):
        usage_state = getattr(getattr(handle, "engine", handle), "usage_state", None)
        if usage_state is not None:
            models[name] = usage_state()
    return {"models": models, "count": len(models)}


def replay_handler(ctx: Context) -> Any:
    """POST /.well-known/debug/replay: re-execute a flight record and
    report the first index where the replay leaves the recorded emission.
    Body: ``{"id": <record id>, "model": <llm> (optional: every model is
    searched), "timeout": seconds (optional, 120)}``. Loopback-only unless
    ``GOFR_REPLAY_REMOTE=1``: a replay decodes real tokens on the serving
    card."""
    from .flightrec import find_record
    from .http.errors import ErrorEntityNotFound, ErrorInvalidParam

    _require_loopback(ctx, "GOFR_REPLAY_REMOTE")
    body = ctx.bind() or {}
    if not isinstance(body, dict):
        raise ErrorInvalidParam("body")
    try:
        rid = int(body.get("id"))
    except (TypeError, ValueError):
        raise ErrorInvalidParam("id") from None
    try:
        timeout = float(body.get("timeout") or 120.0)
    except (TypeError, ValueError):
        raise ErrorInvalidParam("timeout") from None
    rt = ctx.container.tpu_runtime  # never build one: replay what runs
    llms = getattr(rt, "_llms", {}) if rt is not None else {}
    name = body.get("model")
    if name:
        if name not in llms:
            raise ErrorEntityNotFound("llm", str(name))
        targets = {name: llms[name]}
    else:
        targets = dict(llms)
    for model, handle in targets.items():
        eng = getattr(handle, "engine", handle)
        rec, _owner = find_record(eng, rid)
        if rec is not None:
            return {"model": model, "replay": eng.replay(rid, timeout=timeout)}
    raise ErrorEntityNotFound("flight_record", str(rid))
