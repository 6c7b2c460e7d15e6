"""A CLI training app: corpus -> train step -> checkpoint and resume
(counterpart of examples/train-lm/main.py).

    python -m gofr_tpu_torch.examples.train_lm encode -out=corpus.tok
    python -m gofr_tpu_torch.examples.train_lm train -corpus=corpus.tok -steps=20 -ckpt=./run1
    python -m gofr_tpu_torch.examples.train_lm train -corpus=corpus.tok -steps=20 -ckpt=./run1  # resumes

``encode`` writes JAX's toy corpus byte for byte (numpy's
``default_rng(0)``, a geometric distribution capped at 511). ``train``
trains ``TransformerConfig.tiny()`` through ``gofr_tpu_torch.data``
(memory-mapped corpus, shuffled windows, the native batch gather,
``device_prefetch``) and ``parallel.make_train_step`` (AdamW as optax's),
on the card unless ``TORCH_DEVICE=cpu``; its attention is the flash
kernel with a gradient. It saves the parameters and the optimizer's state
with ``models.checkpoint.save_train_state`` (where JAX's saves to Orbax)
and JAX's ``progress.json`` (``global_step``) under ``-ckpt``; a rerun
restores both and positions the data stream with ``seek(global_step)``,
so it continues at the exact batch.
"""

from __future__ import annotations

import json
import os
import sys

from .. import new_cmd
from ..cmd import CMDApp
from ..config import Config
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "train-lm", "LOG_LEVEL": "INFO"}
STATE_FILE = "state.safetensors"


def encode(ctx):
    import numpy as np

    from ..data import encode_corpus

    out = ctx.param("out") or "corpus.tok"
    n = int(ctx.param("n") or 100_000)
    rng = np.random.default_rng(0)
    # a zipf-ish toy distribution, so training has something to learn
    toks = np.minimum(rng.geometric(0.02, n), 511)
    encode_corpus(toks, out, vocab_size=512)
    return f"wrote {n} tokens to {out}"


def train(ctx):
    import numpy as np
    import torch

    from .. import resolve_device
    from ..data import TokenDataset, device_prefetch
    from ..models import TransformerConfig, init_params
    from ..models.checkpoint import load_train_state, save_train_state
    from ..parallel import make_mesh, make_train_step, mesh_shape_for

    corpus = ctx.param("corpus") or "corpus.tok"
    steps = int(ctx.param("steps") or 20)
    ckpt = ctx.param("ckpt") or "./train-ckpt"
    batch = int(ctx.param("batch") or 8)
    seq_len = int(ctx.param("seq") or 32)
    device = resolve_device(ctx.container.config.get("TORCH_DEVICE") or None)

    cfg = TransformerConfig.tiny()
    mesh = make_mesh(mesh_shape_for(1), devices=[device])
    shard_fn, init_opt, step_fn = make_train_step(cfg, mesh)

    ds = TokenDataset(corpus, seq_len=seq_len)
    it = ds.batches(batch, seed=0)

    # resume: parameters and optimizer moments from the checkpoint; the
    # data stream via seek(consumed batches) — device_prefetch advances
    # the raw iterator ahead of consumption, so the loop's count is the
    # truth (BatchIterator.state's docstring)
    params = shard_fn(init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device))
    opt_state = init_opt(params)
    start = 0
    state_file = os.path.join(ckpt, "progress.json")
    if os.path.isdir(ckpt) and os.path.exists(state_file):
        params, opt_state = load_train_state(os.path.join(ckpt, STATE_FILE), device=device)
        with open(state_file) as f:
            start = json.load(f)["global_step"]
        it.seek(start)
        ctx.logger.info(f"resumed at global step {start} (epoch {it.epoch})")
    resumed = {"epoch": it.epoch, "step": it.step}

    # stage complete training batches (tokens + mask) onto the device from
    # the prefetch thread: one copy per step, overlapped with compute
    def feed():
        for b in it:
            toks = np.concatenate([b["inputs"], b["targets"][:, -1:]], axis=1)
            yield {"tokens": toks, "mask": np.ones_like(toks, dtype=bool)}

    pf = device_prefetch(feed(), device=device)
    first = last = None
    try:
        for _i in range(steps):
            b = next(pf)
            params, opt_state, loss = step_fn(params, opt_state, b["tokens"], b["mask"])
            last = float(loss)
            first = first if first is not None else last
    finally:
        pf.close()

    os.makedirs(ckpt, exist_ok=True)
    save_train_state(os.path.join(ckpt, STATE_FILE), params, opt_state)
    with open(state_file, "w") as f:
        json.dump({"global_step": start + steps}, f)
    return {
        "steps": steps, "global_step": start + steps,
        "loss_first": round(first, 4), "loss_last": round(last, 4),
        "epoch": (start + steps) // it.steps_per_epoch(), "ckpt": ckpt,
        "resumed": resumed, "device": str(device),
    }


def build_app(config: Config | None = None) -> CMDApp:
    app = new_cmd(config=config or DefaultsConfig(DEFAULTS))
    app.sub_command("encode", encode, description="write a toy token corpus")
    app.sub_command("train", train, description="train (resumes from -ckpt)")
    return app


if __name__ == "__main__":
    sys.exit(build_app().run())
