"""MNIST-class MLP serving through the port's plain-model path
(counterpart of examples/tpu-mnist/main.py): a stock ``new()`` app whose
handler sends one image through ``ctx.tpu().infer_async``, which the
model's ``Batcher`` coalesces into power-of-two waves on the card.

    python -m gofr_tpu_torch.serve_mnist

Routes: ``POST /infer`` (body ``{"image": [784 floats]}``; answers 201
``{"data": {"digit": d, "logits": [10 floats]}}``, 400 without 784
floats) and ``GET /model`` (the runtime's health: the model's meta and
queue depth, the device), beside the well-known routes.

Config (process environment, or ``configs/.env``): ``HTTP_PORT`` (8000),
``REQUEST_TIMEOUT`` (5 s), ``TPU_BATCH_MAX_SIZE`` (64),
``TPU_BATCH_MAX_DELAY_MS`` (2), ``TPU_BATCH_MAX_INFLIGHT`` (8),
``TORCH_DEVICE=cpu`` runs on the CPU (default: the GPU, raising without
one). The weights are random, drawn from a ``torch.Generator`` seeded with
0, unless ``build_app`` is given ``params``.
"""

from __future__ import annotations

import numpy as np
import torch

from .app import App, new
from .config import Config
from .http.errors import ErrorInvalidParam
from .models.mlp import MLPConfig, mlp_forward, mlp_init

MODEL = "mnist"


def register_model(app: App, params: dict | None = None) -> MLPConfig:
    """Register the MLP as ``mnist`` on ``app``'s runtime (warmed at every
    batch bucket): ``params`` when given, else random weights."""
    cfg = MLPConfig()
    rt = app.container.tpu()
    if params is None:
        params = mlp_init(torch.Generator().manual_seed(0), cfg, rt.device)
    rt.register_model(MODEL, mlp_forward, params, example_args=(np.zeros(cfg.in_dim, np.float32),))
    return cfg


async def infer(ctx):
    body = ctx.bind()
    image = body.get("image") if isinstance(body, dict) else None
    if image is None or len(image) != 784:
        raise ErrorInvalidParam("image (need 784 floats)")
    logits = await ctx.tpu().infer_async(MODEL, np.asarray(image, np.float32))
    return {"digit": int(np.argmax(logits)), "logits": np.asarray(logits).tolist()}


def model_info(ctx):
    return ctx.tpu().health_check()


def build_app(config: Config | None = None, params: dict | None = None) -> App:
    app = new(config=config)
    register_model(app, params)
    app.post("/infer", infer)
    app.get("/model", model_info)
    return app


def main() -> None:
    build_app().run()


if __name__ == "__main__":
    main()
