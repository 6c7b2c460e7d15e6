"""A runnable engine process for the front router (counterpart of
gofr_tpu/router/engine_stub.py).

``python -m gofr_tpu_torch.router.engine_stub --port 8101 --metrics-port 8102``
boots one serving process: the port's continuous-batching engine over the
tiny preset (random weights from a torch generator seeded with 0) behind
the standard App edge (the well-known routes, ``/metrics``, the graceful
drain on SIGTERM or ``POST /.well-known/debug/drain``), which is what the
front router expects of a backend. The autoscaler's default
``TPU_ROUTER_ENGINE_CMD`` launches it. The engine runs on the GPU unless
``TORCH_DEVICE=cpu`` is set (the process environment), and raises without
one.

Routes: ``POST /generate`` (buffered), ``POST /stream`` (one JSONL chunk
a token), ``GET /stats``, ``GET``/``POST /echo`` (a trivial answer: the
router hop's own cost). Every response carries an ``X-Engine-Id`` header
naming this process.

Env knobs (all optional): ``ENGINE_SLOTS`` (8), ``ENGINE_MAX_SEQ`` (256),
``ENGINE_MAX_QUEUE`` (20000), ``ENGINE_SESSION_MB`` (8), ``ENGINE_WARMUP``
(0), ``ENGINE_LOG_LEVEL`` (ERROR), ``ENGINE_REQUEST_TIMEOUT`` (600),
``ENGINE_DRAIN_DEADLINE_S`` (60).

The handlers are async end to end (``astream`` loops), so in-flight
concurrency is bounded by the engine's queue, not by the executor's
threads.
"""

from __future__ import annotations

import argparse
import json
import os


def build_app(port: int, metrics_port: int, *, engine_id: str | None = None):
    import torch

    from ..app import App
    from ..config import new_mock_config
    from ..handler import llm_request_kwargs
    from ..http.responder import StreamingResponse
    from ..llm import GenRequest
    from ..models import TransformerConfig, init_params

    device = os.environ.get("TORCH_DEVICE", "")
    app = App(config=new_mock_config({
        "APP_NAME": "engine-stub",
        "HTTP_PORT": str(port),
        "METRICS_PORT": str(metrics_port),
        "LOG_LEVEL": os.environ.get("ENGINE_LOG_LEVEL", "ERROR"),
        "TPU_TELEMETRY_INTERVAL_S": "0",
        "TORCH_DEVICE": device,
        # the router owns end-to-end deadlines: a queued request on a
        # saturated backend may wait far past the API default
        "REQUEST_TIMEOUT": os.environ.get("ENGINE_REQUEST_TIMEOUT", "600"),
        "GOFR_DRAIN_DEADLINE_S": os.environ.get("ENGINE_DRAIN_DEADLINE_S", "60"),
    }))
    rt = app.container.tpu()
    cfg = TransformerConfig.tiny()
    dev = rt.device
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rt.register_llm(
        "stub", cfg, params,
        slots=int(os.environ.get("ENGINE_SLOTS", "8")),
        max_seq_len=int(os.environ.get("ENGINE_MAX_SEQ", "256")),
        prefill_buckets=(8, 32),
        decode_chunk=4,
        admit_cap=8,
        admit_delay_ms=2.0,
        max_queue=int(os.environ.get("ENGINE_MAX_QUEUE", "20000")),
        warmup=os.environ.get("ENGINE_WARMUP", "0") in ("1", "true"),
        # sessions make the router's affinity observable: a second turn on
        # the same backend shares the first turn's blocks
        session_mb=float(os.environ.get("ENGINE_SESSION_MB", "8")),
    )
    eid = engine_id or f"engine-{port}"

    def engine_id_middleware(next_handler):
        async def h(req):
            resp = await next_handler(req)
            resp.headers.append(("X-Engine-Id", eid))
            return resp

        return h

    app.use_middleware(engine_id_middleware)

    def submit(ctx):
        body = ctx.bind()
        return ctx.tpu().llm("stub").submit(GenRequest(
            list(body["tokens"]),
            max_new_tokens=int(body.get("max_new_tokens", 8)),
            temperature=float(body.get("temperature", 0.0)),
            **llm_request_kwargs(ctx),
        ))

    async def generate(ctx):
        req = submit(ctx)
        return {"tokens": [t async for t in req.astream()], "engine": eid}

    async def stream(ctx):
        req = submit(ctx)

        async def chunks():
            async for tok in req.astream():
                yield (json.dumps({"t": tok}) + "\n").encode()

        return StreamingResponse(chunks(), content_type="application/jsonl")

    def stats(ctx):
        return ctx.tpu().llm("stub").stats()

    def echo(_ctx):
        return {"ok": 1}

    app.post("/echo", echo)
    app.get("/echo", echo)
    app.post("/generate", generate)
    app.post("/stream", stream)
    app.get("/stats", stats)
    return app


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--metrics-port", type=int, default=0)
    ap.add_argument("--engine-id", default=None)
    args = ap.parse_args()
    build_app(args.port, args.metrics_port, engine_id=args.engine_id).run()


if __name__ == "__main__":
    main()
