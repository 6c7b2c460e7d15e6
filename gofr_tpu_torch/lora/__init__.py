"""Batched LoRA adapter serving: multi-tenant model multiplexing
(counterpart of gofr_tpu/lora/__init__.py).

One resident base model serves N tenants: each tenant's weight delta is a
low-rank (A, B) pair per projection, and ALL resident adapters live
stacked in float32 device tables

    lora_<name>_a [L, G, d_in, r_max]     lora_<name>_b [L, G, r_max, d_out]

inside ``params["layers"]`` (the leading L axis is sliced per layer like
every other stacked weight). The engine's programs read a per-slot
adapter-id vector (``aids``) that selects each lane's pair:

    out = x @ W + (x @ A[gid]) @ B[gid]

Gid 0 is the reserved ZERO-RANK IDENTITY: its tables are all-zero, so an
unadapted lane adds exact zeros and stays token-identical to an engine
with no adapter support at all. Loading or evicting an adapter rewrites
one gid's table slice in place: same shapes and addresses, so the captured
programs serve every tenant and a hot-load captures nothing.

The per-name scaling alpha/r is folded into B at validation time, and
ranks below r_max zero-pad: padded columns contribute exact zeros.

``AdapterPool`` is the host-side bookkeeping mirror of the device tables:
fixed gid slots (``TPU_LLM_LORA_SLOTS``), per-gid refcounts of in-flight
requests, LRU eviction of idle named adapters, and zombie tracking for
gids whose name moved on (a hot-load repoints the name at a freshly
staged gid; the old gid keeps serving its in-flight requests until the
last reference drains).

Dimensions come from ``models.transformer.param_specs``, the shapes of
the tree the engine serves. Adapters are host arrays (numpy, torch or
anything ``numpy.asarray`` reads).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..models.quant import QTensor
from ..models.transformer import param_specs

__all__ = [
    "LORA_TARGETS",
    "AdapterPool",
    "AdapterPoolFull",
    "init_adapter",
    "merge_adapter",
    "target_dims",
    "validate_adapter",
    "zero_tables",
]

# Projections an adapter may touch: q/k/v (wkv packs k and v), the output
# projection, and the dense MLP. Expert weights (4-D stacks) are excluded.
LORA_TARGETS = ("wq", "wkv", "wo", "w_gate", "w_up", "w_down")


def target_dims(cfg) -> dict[str, tuple[int, int]]:
    """(d_in, d_out) per adaptable projection, read from ``param_specs``
    (the shapes ``init_params`` makes and ``validate_params`` checks), so
    adapters validate against the same tree the engine serves."""
    layers = param_specs(cfg)["layers"]
    out = {}
    for name in LORA_TARGETS:
        spec = layers.get(name)
        if spec is None or len(spec[0]) != 3:  # expert stacks are 4-D
            continue
        out[name] = (int(spec[0][1]), int(spec[0][2]))
    return out


def zero_tables(cfg, pool_slots: int, rank: int, device=None) -> dict:
    """The all-identity stacked tables a LoRA-enabled engine starts with:
    G = pool_slots + 1 gid rows (gid 0 the reserved identity), every entry
    zero, float32 whatever the base dtype (the delta products are rank-r
    slivers: full precision costs little and keeps small adapters from
    drowning in bf16 rounding). Made on ``device`` (``cuda`` by default)."""
    dev = resolve_device(device)
    L = cfg.n_layers
    G = int(pool_slots) + 1
    r = max(1, int(rank))
    out = {}
    for name, (d_in, d_out) in target_dims(cfg).items():
        out[f"lora_{name}_a"] = torch.zeros((L, G, d_in, r), dtype=torch.float32, device=dev)
        out[f"lora_{name}_b"] = torch.zeros((L, G, r, d_out), dtype=torch.float32, device=dev)
    return out


def _host(x) -> np.ndarray:
    """A writable host float32 copy of an array-like (numpy, torch, ...)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.array(x, np.float32)


def validate_adapter(cfg, adapter: dict, *, rank_max: int, alpha: float | None = None) -> dict:
    """Check an adapter checkpoint against the base config and return the
    canonical staged form {name: (a [L, d_in, r], b [L, r, d_out])}, host
    float32, with the alpha/r scale folded into b.

    Accepted entry forms per target name: {"a": ..., "b": ...} (optional
    per-entry "alpha") or a bare (a, b) tuple. Raises ValueError on an
    unknown target, a shape mismatch, or rank > rank_max. An empty adapter
    is legal: it stages as a pure identity."""
    dims = target_dims(cfg)
    L = cfg.n_layers
    out = {}
    for name, entry in adapter.items():
        if name not in dims:
            raise ValueError(
                f"adapter targets unknown projection {name!r}; expected "
                f"one of {sorted(dims)}"
            )
        if isinstance(entry, dict):
            a, b = entry.get("a"), entry.get("b")
            ent_alpha = entry.get("alpha", alpha)
        else:
            a, b = entry
            ent_alpha = alpha
        if a is None or b is None:
            raise ValueError(f"adapter entry {name!r} needs both 'a' and 'b'")
        a = _host(a)
        b = _host(b)
        d_in, d_out = dims[name]
        if a.ndim != 3 or a.shape[0] != L or a.shape[1] != d_in:
            raise ValueError(
                f"adapter {name!r}: A must be [n_layers={L}, {d_in}, r], "
                f"got {a.shape}"
            )
        r = int(a.shape[2])
        if b.shape != (L, r, d_out):
            raise ValueError(
                f"adapter {name!r}: B must be [{L}, {r}, {d_out}] to match "
                f"A {a.shape}, got {b.shape}"
            )
        if r > rank_max:
            raise ValueError(
                f"adapter {name!r} rank {r} exceeds the pool's rank_max "
                f"{rank_max} (TPU_LLM_LORA_RANK_MAX)"
            )
        if r > 0 and ent_alpha is not None:
            b = b * (float(ent_alpha) / r)
        if r > 0:
            out[name] = (a, b)
    return out


def init_adapter(
    generator: torch.Generator, cfg, rank: int, *, scale: float = 0.05, targets=None,
) -> dict:
    """Random test/bench adapter drawn from ``generator`` on its device: A ~
    N(0, scale / sqrt(d_in)), B ~ N(0, scale / sqrt(rank)), both nonzero so
    adapted outputs measurably differ from the base (real LoRA trains from
    B = 0; a zero B would make every equality test pass vacuously)."""
    dims = target_dims(cfg)
    names = list(targets) if targets is not None else list(dims)
    dev = generator.device
    L = cfg.n_layers
    out = {}
    for name in names:
        d_in, d_out = dims[name]
        a = torch.randn((L, d_in, rank), generator=generator, device=dev, dtype=torch.float32)
        b = torch.randn((L, rank, d_out), generator=generator, device=dev, dtype=torch.float32)
        out[name] = {"a": a * (scale / d_in**0.5), "b": b * (scale / max(1, rank) ** 0.5)}
    return out


def merge_adapter(params: dict, cfg, adapter: dict, *, alpha=None) -> dict:
    """Reference semantics: fold the adapter INTO the base weights (W' = W +
    A @ B per layer, computed in float32 and rounded to W's dtype). The
    equality tests hold the batched serving path against an engine built
    from these merged weights. Plain (unquantized) weights only."""
    canon = validate_adapter(cfg, adapter, rank_max=10**9, alpha=alpha)
    layers = dict(params["layers"])
    for name, (a, b) in canon.items():
        w = layers[name]
        if isinstance(w, QTensor):
            raise ValueError(f"merge_adapter: {name!r} is quantized; merge into plain weights, then quantize")
        delta = torch.einsum(
            "lir,lro->lio", torch.from_numpy(a).to(w.device), torch.from_numpy(b).to(w.device)
        )
        layers[name] = (w.float() + delta).to(w.dtype)
    return {**params, "layers": layers}


class AdapterPoolFull(RuntimeError):
    """No free gid and every resident adapter has in-flight requests."""


class AdapterPool:
    """Host bookkeeping for the fixed-gid device tables: name -> gid
    binding, per-gid in-flight refcounts, LRU eviction of idle named
    adapters, zombie gids (name moved on, refs still draining). NOT
    thread-safe: the engine calls it under its own lock."""

    def __init__(self, slots: int):
        self.slots = int(slots)  # usable gids: 1..slots (0 = identity)
        self._by_name: dict[str, dict] = {}
        self._refs = [0] * (self.slots + 1)
        self._zombies: set[int] = set()
        self._clock = 0  # monotonic LRU tick (no wall time needed)
        self.evictions = 0
        self.swaps = 0

    # -- queries ---------------------------------------------------------
    def resident(self) -> dict[str, dict]:
        return {
            name: {
                "gid": e["gid"], "version": e["version"], "rank": e["rank"],
                "refs": self._refs[e["gid"]],
            }
            for name, e in sorted(self._by_name.items())
        }

    def lookup(self, name: str) -> dict:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __len__(self) -> int:
        return len(self._by_name)

    def refs(self, gid: int) -> int:
        return self._refs[gid]

    # -- request lifecycle -----------------------------------------------
    def acquire(self, name: str) -> int:
        """Pin one in-flight request to name's gid (KeyError if absent)."""
        e = self._by_name[name]
        gid = e["gid"]
        self._refs[gid] += 1
        self._clock += 1
        e["used"] = self._clock
        return gid

    def release(self, gid: int) -> None:
        if 0 < gid <= self.slots:
            self._refs[gid] = max(0, self._refs[gid] - 1)
            if self._refs[gid] == 0:
                self._zombies.discard(gid)

    # -- adapter lifecycle -----------------------------------------------
    def allocate(self, name: str, *, version: str, rank: int) -> int:
        """Bind ``name`` to a free gid (staging slot for a load). A name
        collision is an error: hot-loads stage under a distinct staging
        name and repoint via publish(). Evicts the LRU idle adapter when
        every gid is taken; raises AdapterPoolFull when none is idle."""
        if name in self._by_name:
            raise ValueError(f"adapter {name!r} already resident")
        taken = {e["gid"] for e in self._by_name.values()}
        taken |= {g for g in range(1, self.slots + 1) if self._refs[g] > 0}
        taken |= self._zombies
        free = [g for g in range(1, self.slots + 1) if g not in taken]
        if not free:
            idle = [
                (e["used"], n) for n, e in self._by_name.items()
                if self._refs[e["gid"]] == 0
            ]
            if not idle:
                raise AdapterPoolFull(
                    f"all {self.slots} adapter slots busy (in-flight "
                    "requests hold every gid)"
                )
            _, victim = min(idle)
            gid = self._by_name.pop(victim)["gid"]
            self.evictions += 1
        else:
            gid = free[0]
        self._clock += 1
        self._by_name[name] = {
            "gid": gid, "version": str(version), "rank": int(rank),
            "used": self._clock,
        }
        return gid

    def publish(self, staging: str, name: str) -> int | None:
        """Atomically repoint ``name`` at the gid staged under ``staging``
        (hot-load commit). Returns the PREVIOUS gid (now a zombie until its
        in-flight requests drain) or None for a first load."""
        entry = self._by_name.pop(staging)
        old = self._by_name.pop(name, None)
        self._by_name[name] = entry
        self.swaps += 1
        if old is None:
            return None
        if self._refs[old["gid"]] > 0:
            self._zombies.add(old["gid"])
        return old["gid"]

    def remove(self, name: str) -> int:
        """Unbind a name (retire / canary reject). The gid frees
        immediately when idle, else drains as a zombie."""
        e = self._by_name.pop(name)
        gid = e["gid"]
        if self._refs[gid] > 0:
            self._zombies.add(gid)
        return gid

    def snapshot(self) -> dict[str, Any]:
        return {
            "slots": self.slots,
            "resident": self.resident(),
            "zombies": sorted(self._zombies),
            "evictions": self.evictions,
            "swaps": self.swaps,
        }
