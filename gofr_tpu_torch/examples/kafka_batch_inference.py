"""Pub/sub-driven batch inference (counterpart of
examples/kafka-batch-inference/main.py).

    PUBSUB_BACKEND=KAFKA PUBSUB_BROKER=host:9092 python -m gofr_tpu_torch.examples.kafka_batch_inference

A message of ``inference-requests`` carries a microbatch, ``{"id": ...,
"xs": [[16 floats], ...]}``; ``on_request`` sends each row through
``ctx.tpu().infer_async`` into the model's dynamic batcher, where the rows
of in-flight messages and HTTP traffic coalesce into one launch, and
publishes ``{"id": ..., "preds": [argmax, ...]}`` on ``inference-results``;
``on_result`` keeps them for ``GET /results``. The model is the MLP 16 ->
32 -> 4 in float32 (``models.mlp``), registered as ``mnist`` on the
runtime's device (TORCH_DEVICE; the card unless it names the CPU).
Commit on success gives at-least-once processing. PUBSUB_BACKEND is MEMORY
by default and KAFKA against a broker.

    POST /enqueue  {"id": "a1", "xs": [[...16 floats], ...]}
    GET  /results  -> {"a1": [3, 0, ...], ...}

HTTP on 9130, metrics on 9131.
"""

from __future__ import annotations

import asyncio
import json

import numpy as np

from ..app import App, new
from ..config import Config
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "kafka-batch-inference", "HTTP_PORT": "9130", "METRICS_PORT": "9131",
            "PUBSUB_BACKEND": "MEMORY", "TPU_BATCH_MAX_SIZE": "64", "TPU_BATCH_MAX_DELAY_MS": "2"}

RESULTS: dict = {}


def _register_model(app: App, params: dict | None = None) -> None:
    """``mnist``: the MLP 16 -> 32 -> 4 (float32), from ``params`` (the
    leaves of ``models.mlp.mlp_init``, e.g. JAX's through
    ``mlp_params_from_jax``) or drawn from seed 0."""
    import torch

    from ..models import MLPConfig, mlp_forward, mlp_init

    mcfg = MLPConfig(in_dim=16, hidden=(32,), out_dim=4, dtype=torch.float32)
    if params is None:
        params = mlp_init(torch.Generator().manual_seed(0), mcfg, device="cpu")
    app.container.tpu().register_model("mnist", mlp_forward, params, example_args=(np.zeros(16, np.float32),))


async def on_request(ctx):
    """One message, one microbatch: its rows coalesce in the batcher with
    whatever else is in flight."""
    body = ctx.bind()
    xs = [np.asarray(x, np.float32) for x in body["xs"]]
    outs = await asyncio.gather(*[ctx.tpu().infer_async("mnist", x) for x in xs])
    preds = [int(np.argmax(o)) for o in outs]
    await ctx.get_publisher().publish("inference-results", json.dumps({"id": body["id"], "preds": preds}).encode())
    return None  # success: commit


def on_result(ctx):
    body = ctx.bind()
    RESULTS[body["id"]] = body["preds"]
    return None


async def enqueue(ctx):
    body = ctx.bind()
    await ctx.get_publisher().publish("inference-requests", ctx.request.body)
    return {"queued": body["id"], "rows": len(body["xs"])}


def results(ctx):
    return RESULTS


def build_app(config: Config | None = None, params: dict | None = None) -> App:
    app = new(config=config or DefaultsConfig(DEFAULTS))
    _register_model(app, params)
    app.subscribe("inference-requests", on_request)
    app.subscribe("inference-results", on_result)
    app.post("/enqueue", enqueue)
    app.get("/results", results)
    return app


if __name__ == "__main__":
    build_app().run()
