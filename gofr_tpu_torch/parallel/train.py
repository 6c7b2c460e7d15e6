"""The training step on one card (counterpart of gofr_tpu/parallel/train.py).

``lm_loss`` is JAX's: masked next-token cross entropy over a float32
log-softmax of ``models.transformer.train_forward``'s logits, whose
attention is the flash kernel with a gradient. ``make_train_step`` returns
JAX's triple ``(shard_fn, init_opt_fn, step_fn)``; the step is the loss
and its gradient (``torch.autograd.grad`` over the parameter leaves) and
one optimizer update. The default optimizer is ``AdamW``: optax's
``adamw(learning_rate)`` with its defaults (b1 0.9, b2 0.999, eps 1e-8
outside the square root, weight decay 1e-4 on every leaf, moments in the
parameters' dtype). ``torch.optim.AdamW`` differs in its default decay
(0.01), so the port keeps its own.

What differs from JAX: the update is made in place (the parameter and
moment tensors are overwritten and returned), where optax returns new
arrays; on a card that holds Gemma-2B's 5 GB of bf16 weights and 10 GB of
moments this saves a copy of each. A mesh with an axis larger than 1 is
refused: multi-card training is ROADMAP ID 11.

As JAX's ``instrument_jit`` does, the step and the optimizer's init record
a row in ``profiling.default_registry()`` (programs ``parallel.train_step``
and ``parallel.init_opt``, model ``"train"``) at their first call with a
new signature, timed as that first call (``measured="first_call"``: there
is no compile), and a hit at every later call.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ..models.checkpoint import _flatten
from ..models.transformer import TransformerConfig, train_forward
from ..profiling import default_registry
from .mesh import Mesh

__all__ = ["AdamW", "lm_loss", "make_train_step", "next_token_loss", "place_batch", "value_and_grad"]


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of ``tokens[:, 1:]`` under ``logits[:, :-1]``
    (log-softmax in float32) over the positions ``mask[:, 1:]`` keeps."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    w = mask[:, 1:].float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def lm_loss(params: dict, cfg: TransformerConfig, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy over valid positions. tokens [b, s], mask
    [b, s] (JAX ``lm_loss``; the mask weights the loss only, as there)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    return next_token_loss(train_forward(params, cfg, tokens, positions), tokens, mask)


def value_and_grad(loss_fn: Callable, params: dict, *args) -> tuple[torch.Tensor, dict]:
    """(loss, gradient tree) of ``loss_fn(params, *args)`` with respect to
    every leaf of ``params`` (``jax.value_and_grad``); the leaves are made
    to require grad in place, nothing is stored in ``.grad``."""
    leaves = list(_flatten(params).values())  # _map's order
    for t in leaves:
        t.requires_grad_(True)
    loss = loss_fn(params, *args)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), _map(lambda _: next(grads), params)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``adamw`` with its signature and defaults (``eps_root`` 0, no
    mask): ``scale_by_adam`` (moments in the parameters' dtype,
    bias-corrected, eps outside the square root), plus ``weight_decay``
    times the parameter, times ``-learning_rate``. State: ``{"count": int32
    0-d, "mu": tree, "nu": tree}``."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: dict) -> dict:
        dev = next(iter(_flatten(params).values())).device
        return {
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": _map(lambda p: torch.zeros_like(p, memory_format=torch.contiguous_format), params),
            "nu": _map(lambda p: torch.zeros_like(p, memory_format=torch.contiguous_format), params),
        }

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict) -> None:
        """One step, in place on ``params`` and ``state``."""
        state["count"].add_(1)
        # optax's bias corrections, 1 - decay ** count in float32, cast to
        # each moment's dtype; on the device, so the step never waits on it
        count = state["count"].float()
        bcs = [1.0 - torch.pow(count.new_full((), b), count) for b in (self.b1, self.b2)]
        grads_by, mu_by, nu_by = (_flatten(t) for t in (grads, state["mu"], state["nu"]))
        for path, p in _flatten(params).items():
            g, mu, nu = grads_by[path], mu_by[path], nu_by[path]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu / bcs[0].to(mu.dtype)).div_((nu / bcs[1].to(nu.dtype)).sqrt_().add_(self.eps))
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-self.learning_rate)


def _tensors(args) -> list:
    return [t for a in args for t in (_flatten(a).values() if isinstance(a, dict) else [a])
            if isinstance(t, torch.Tensor)]


def _signature(args) -> tuple[str, ...]:
    return tuple(f"{tuple(t.shape)}:{str(t.dtype).removeprefix('torch.')}" for t in _tensors(args))


def _instrumented(program: str, fn: Callable) -> Callable:
    """``fn`` with JAX ``instrument_jit``'s registry rows: the first call
    of each signature is recorded (its seconds, the device's type as the
    backend), every later one is a hit."""
    seen: set = set()

    def call(*args):
        sig = _signature(args)
        if sig in seen:
            default_registry().note_hit(program, "train", sig)
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        dev = next((t.device for t in _tensors(args)), None)
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        default_registry().record_compile(
            program=program, model="train", arg_shapes=sig, compile_s=time.perf_counter() - t0,
            backend="" if dev is None else dev.type, measured="first_call",
        )
        seen.add(sig)
        return out

    return call


def _refuse_multi(mesh: Mesh) -> None:
    if any(n > 1 for n in mesh.sizes):
        raise NotImplementedError(
            f"mesh {mesh.shape} spans {mesh.size} devices: the port trains on one card; "
            "multi-card training (DP x TP meshes) is ROADMAP ID 11"
        )


def make_train_step(
    cfg: TransformerConfig,
    mesh: Mesh,
    *,
    optimizer: AdamW | None = None,
    learning_rate: float = 3e-4,
) -> tuple[Callable, Callable, Callable]:
    """Returns (shard_fn, init_opt_fn, step_fn), as JAX's:

    shard_fn(params)            -> params on the mesh's device
    init_opt_fn(params)         -> opt_state
    step_fn(params, opt_state, tokens, mask) -> (params, opt_state, loss)

    ``step_fn`` updates ``params`` and ``opt_state`` in place and returns
    them with the step's loss (a 0-d float32 tensor on the device)."""
    _refuse_multi(mesh)
    opt = optimizer or AdamW(learning_rate)
    device = mesh.devices[0]

    def shard_fn(params):
        return _map(lambda t: t.to(device), params)

    def init_opt_fn(params):
        return opt.init(params)

    def step_fn(params, opt_state, tokens, mask):
        loss, grads = value_and_grad(lm_loss, params, cfg, tokens, mask)
        opt.update(params, grads, opt_state)
        return params, opt_state, loss

    return (
        shard_fn,
        _instrumented("parallel.init_opt", init_opt_fn),
        _instrumented("parallel.train_step", step_fn),
    )


def place_batch(batch: Any, mesh: Mesh) -> Any:
    """Every array or tensor of ``batch`` (a dict, list or tuple of them) on
    the mesh's device, as JAX's ``place_batch`` puts it under the batch
    spec."""
    _refuse_multi(mesh)
    device = mesh.devices[0]

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x).to(device)

    return put(batch)
