"""The GPU datasource: the LLM registry behind ``ctx.tpu()`` (counterpart
of gofr_tpu/datasource/tpu/__init__.py ``TPURuntime``, its
``register_llm`` / ``llm`` surface only).

``register_llm(name, cfg, params, **engine_kw)`` builds the port's
``LLMEngine`` and registers it under ``name``; ``llm(name)`` returns it.
The engine runs on ``cuda`` unless the caller passes ``device="cpu"`` or
the config sets ``TORCH_DEVICE=cpu``; without a GPU it raises.

Only what the port's engine has is accepted: the kwargs ``slots``,
``max_seq_len``, ``prefill_buckets``, ``quantize``, ``kv_int8``, ``seed``,
``device``, ``lookahead``, ``warmup`` and ``kv_paged=True`` (the port's
one layout), and the config knob ``TPU_LLM_KV_INT8`` (read as the JAX
runtime reads it). Any other kwarg, and any of the JAX runtime's engine
knobs set to ask for a feature the port lacks (speculation, replicas,
meshes, LoRA, sessions, a prefix cache, ...), raises ``NotImplementedError`` naming it; none is ignored.
The JAX package's plain-model registry (``register_model`` and its
dynamic batcher) is not ported.
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from ... import resolve_device
from ...llm import KV_BLOCK, PREFILL_CHUNK, STEP_TOKEN_BUDGET, LLMEngine
from .. import STATUS_DOWN, STATUS_UP, health

__all__ = ["GPURuntime"]

_ENGINE_KWARGS = (
    "slots", "max_seq_len", "prefill_buckets", "quantize", "kv_int8", "seed", "device", "lookahead", "warmup",
)

# The JAX runtime's engine knobs that select a feature this port lacks,
# each with the values that ask for nothing more than the port does.
_UNPORTED_KNOBS = {
    "TPU_LLM_PREFIX_CACHE_MB": ("0",),
    "TPU_LLM_STEP_TOKEN_BUDGET": (str(STEP_TOKEN_BUDGET),),
    "TPU_LLM_PREFILL_CHUNK": (str(PREFILL_CHUNK),),
    "TPU_LLM_SPEC": ("0",),
    "TPU_LLM_SPEC_DRAFT": (),
    "TPU_LLM_KV_PAGED": ("1",),
    "TPU_LLM_KV_BLOCK": (str(KV_BLOCK),),
    "TPU_LLM_SESSION_MB": ("0",),
    "TPU_LLM_HOST_CACHE_MB": ("0",),
    "TPU_LLM_STEP_WATCHDOG_S": ("0",),
    "TPU_LLM_NUMERIC_CHECK": ("1",),
    "TPU_LLM_CONSTRAINED": ("0",),
    "TPU_LLM_CONSTRAINED_GRAMMARS": (),
    "TPU_LLM_LORA_SLOTS": ("0",),
    "TPU_LLM_LORA_RANK_MAX": (),
    "TPU_LLM_FLIGHT_RECORDS": ("0",),
    "TPU_LLM_FLIGHT_REDACT": (),
    "GOFR_BLACKBOX_DIR": (),
    "GOFR_BLACKBOX_INTERVAL_S": (),
    "TPU_LLM_ANOMALY": ("0",),
    "TPU_LLM_WIDE_EVENT_SAMPLE": (),
    "TPU_LLM_TP": ("0", "1"),
    "TPU_LLM_DISAGG": ("0",),
    "TPU_LLM_DISAGG_PREFILL_REPLICAS": (),
    "TPU_LLM_KV_HANDOFF_TIMEOUT_S": (),
}


class GPURuntime:
    """``ctx.tpu()`` — built lazily by the Container."""

    def __init__(self, config=None, logger=None):
        self.config = config
        self.logger = logger
        get = (lambda k: config.get_or_default(k, "")) if config is not None else (lambda k: "")
        self.default_device = get("TORCH_DEVICE") or None  # None: cuda
        self.default_llm_kv_int8 = get("TPU_LLM_KV_INT8")
        self._knobs = {k: get(k) for k in _UNPORTED_KNOBS}
        self._llms: dict[str, LLMEngine] = {}
        self._lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        """The device engines run on (raises without a GPU unless the
        config asks for the CPU)."""
        return resolve_device(self.default_device)

    def register_llm(self, name: str, cfg, params, **engine_kw) -> LLMEngine:
        """Build an ``LLMEngine`` over ``params`` and register it as
        ``name`` (replacing and closing an earlier one)."""
        if engine_kw.pop("kv_paged", True) is False:
            raise NotImplementedError("kv_paged=False: the port serves the paged KV pool only")
        unknown = sorted(set(engine_kw) - set(_ENGINE_KWARGS))
        if unknown:
            raise NotImplementedError(f"register_llm: not ported: {', '.join(unknown)}")
        for knob, fine in _UNPORTED_KNOBS.items():
            v = self._knobs[knob]
            if v != "" and v not in fine:
                raise NotImplementedError(f"{knob}={v}: not ported")
        if self.default_llm_kv_int8 != "":
            engine_kw.setdefault("kv_int8", self.default_llm_kv_int8 != "0")
        engine_kw.setdefault("device", self.default_device)
        engine = LLMEngine(cfg, params, **engine_kw)
        with self._lock:
            old = self._llms.get(name)
            self._llms[name] = engine
        if old is not None:
            old.close()
        if self.logger is not None:
            self.logger.info(f"LLM {name!r} registered on {engine.device} ({cfg.n_layers} layers, d_model {cfg.d_model})")
        return engine

    def llm(self, name: str) -> LLMEngine:
        try:
            return self._llms[name]
        except KeyError:
            raise KeyError(f"LLM '{name}' not registered; known: {list(self._llms)}") from None

    def health_check(self) -> dict:
        try:
            eng = next(iter(self._llms.values()), None)
            dev = eng.device if eng is not None else torch.device(self.default_device or "cuda")
            on_gpu = dev.type == "cuda" and torch.cuda.is_available()
            details: dict[str, Any] = {
                "platform": "gpu" if on_gpu else "cpu",
                "device_count": torch.cuda.device_count() if on_gpu else 1,
                "device_kind": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
                "models": {},  # the plain-model registry is not ported
                "llms": {n: e.stats() for n, e in self._llms.items()},
                "memory": (
                    {"bytes_in_use": torch.cuda.memory_allocated(dev),
                     "bytes_limit": torch.cuda.get_device_properties(dev).total_memory}
                    if on_gpu else {}
                ),
            }
            return health(STATUS_UP, **details)
        except Exception as e:  # noqa: BLE001 - health must answer
            return health(STATUS_DOWN, error=str(e))

    def close(self) -> None:
        with self._lock:
            llms, self._llms = list(self._llms.values()), {}
        for eng in llms:
            eng.close()
