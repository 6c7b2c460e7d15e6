"""The GPU datasource: the LLM registry behind ``ctx.tpu()`` (counterpart
of gofr_tpu/datasource/tpu/__init__.py ``TPURuntime``, its
``register_llm`` / ``llm`` surface only).

``register_llm(name, cfg, params, **engine_kw)`` builds the port's
``LLMEngine`` and registers it under ``name``; ``llm(name)`` returns it.
The engine runs on ``cuda`` unless the caller passes ``device="cpu"`` or
the config sets ``TORCH_DEVICE=cpu``; without a GPU it raises.

Only what the port's engine has is accepted: the kwargs ``slots``,
``max_seq_len``, ``prefill_buckets``, ``quantize``, ``kv_int8``, ``seed``,
``device``, ``lookahead``, ``warmup``, ``prefix_cache_mb``,
``session_mb``, ``host_cache_mb``, ``kv_pool_blocks``, the scheduler's
``step_token_budget`` (256, the chunked scheduler, or 0, the wave),
``admit_cap`` and ``admit_delay_ms``, ``speculative``, ``spec_draft``,
``constrained``, ``constrained_grammars``, the overload kwargs
``max_queue``, ``ttft_deadline_ms``, ``fair_queuing``, ``fair_weights``,
``fair_ledger``, ``preemption``, ``shed_predicted_wait_s``,
``brownout_wait_s``, ``brownout_max_new`` and ``brownout_hold_s``, the
LoRA pool's ``lora_slots`` and ``lora_rank``, the KV layout's
``kv_paged`` (``True``, ``False`` or ``"auto"``: the paged pool, or the
contiguous layouts, the rolling ring for a windowed model where window +
slack < max_seq_len and the dense slab otherwise; ``"auto"`` takes the
ring where it engages and no session tier is asked for) and ``kv_window``
(0 forces the dense slab), and the config knobs ``TPU_LLM_KV_PAGED`` ("0"
means ``kv_paged=False``, anything else ``"auto"``, as in the JAX
runtime), ``TPU_LLM_STEP_TOKEN_BUDGET`` ("0" or "256"),
``TPU_LLM_KV_INT8``, ``TPU_LLM_PREFIX_CACHE_MB``, ``TPU_LLM_SESSION_MB``,
``TPU_LLM_HOST_CACHE_MB``, ``TPU_LLM_SPEC``, ``TPU_LLM_SPEC_DRAFT``,
``TPU_LLM_CONSTRAINED``, ``TPU_LLM_CONSTRAINED_GRAMMARS``,
``TPU_LLM_FAIR``, ``TPU_LLM_PREEMPT``, ``TPU_LLM_SHED_WAIT_S``,
``TPU_LLM_BROWNOUT_WAIT_S``, ``TPU_LLM_BROWNOUT_MAX_NEW``,
``TPU_LLM_BROWNOUT_HOLD_S``, ``TPU_LLM_LORA_SLOTS`` and
``TPU_LLM_LORA_RANK_MAX`` (defaults for the kwargs a caller leaves out,
with the JAX engine's meanings). As in the JAX runtime,
``TPU_LLM_KV_POOL_BLOCKS`` has no config mapping: the process env reaches
the engine's ``CacheManager``, which reads it (with ``TPU_LLM_KV_INT8``,
``TPU_LLM_SESSION_MB`` and ``TPU_LLM_HOST_CACHE_MB``) for a kwarg left
None. Other step budgets, ``TPU_LLM_PREFILL_CHUNK`` and ``TPU_LLM_KV_BLOCK``
away from their defaults stay refused (ROADMAP queue 1 ID 19).
Any other kwarg, and any of the JAX runtime's engine knobs set to ask for
a feature the port lacks (replicas, meshes, ...), raises
``NotImplementedError`` naming it; none is ignored.
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
    "prefix_cache_mb", "session_mb", "host_cache_mb", "speculative", "spec_draft", "constrained",
    "constrained_grammars", "max_queue", "ttft_deadline_ms", "fair_queuing", "fair_weights", "fair_ledger",
    "preemption", "shed_predicted_wait_s", "brownout_wait_s", "brownout_max_new", "brownout_hold_s",
    "lora_slots", "lora_rank", "kv_paged", "kv_window", "kv_pool_blocks", "step_token_budget", "admit_cap",
    "admit_delay_ms",
)

# Overload-control and LoRA knobs: config key -> (engine kwarg, parser of
# the value)
_OVERLOAD_KNOBS = {
    "TPU_LLM_FAIR": ("fair_queuing", lambda v: v != "0"),
    "TPU_LLM_PREEMPT": ("preemption", lambda v: v != "0"),
    "TPU_LLM_SHED_WAIT_S": ("shed_predicted_wait_s", float),
    "TPU_LLM_BROWNOUT_WAIT_S": ("brownout_wait_s", float),
    "TPU_LLM_BROWNOUT_MAX_NEW": ("brownout_max_new", int),
    "TPU_LLM_BROWNOUT_HOLD_S": ("brownout_hold_s", float),
    "TPU_LLM_LORA_SLOTS": ("lora_slots", int),
    "TPU_LLM_LORA_RANK_MAX": ("lora_rank", int),
}

# The JAX runtime's engine knobs that select a feature this port lacks,
# each with the values that ask for nothing more than the port does (the
# shape knobs' other values: ROADMAP queue 1 ID 19).
_SHAPE_KNOBS = ("TPU_LLM_STEP_TOKEN_BUDGET", "TPU_LLM_PREFILL_CHUNK", "TPU_LLM_KV_BLOCK")
_UNPORTED_KNOBS = {
    "TPU_LLM_STEP_TOKEN_BUDGET": ("0", str(STEP_TOKEN_BUDGET)),
    "TPU_LLM_PREFILL_CHUNK": (str(PREFILL_CHUNK),),
    "TPU_LLM_KV_BLOCK": (str(KV_BLOCK),),
    "TPU_LLM_STEP_WATCHDOG_S": ("0",),
    "TPU_LLM_NUMERIC_CHECK": ("1",),
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
    # the JAX engine's per-tenant token-rate quota (goodput.QuotaGate)
    "TPU_LLM_TENANT_QUOTA_TOK_S": (),
}


class GPURuntime:
    """``ctx.tpu()`` — built lazily by the Container."""

    def __init__(self, config=None, logger=None):
        self.config = config
        self.logger = logger
        get = (lambda k: config.get_or_default(k, "")) if config is not None else (lambda k: "")
        self.default_device = get("TORCH_DEVICE") or None  # None: cuda
        self.default_llm_kv_paged = get("TPU_LLM_KV_PAGED")
        self.default_llm_kv_int8 = get("TPU_LLM_KV_INT8")
        self.default_llm_prefix_cache_mb = float(get("TPU_LLM_PREFIX_CACHE_MB") or 0.0)
        self.default_llm_session_mb = get("TPU_LLM_SESSION_MB")
        self.default_llm_host_cache_mb = get("TPU_LLM_HOST_CACHE_MB")
        self.default_llm_spec = get("TPU_LLM_SPEC")
        self.default_llm_spec_draft = get("TPU_LLM_SPEC_DRAFT")
        self.default_llm_constrained = get("TPU_LLM_CONSTRAINED")
        self.default_llm_constrained_grammars = get("TPU_LLM_CONSTRAINED_GRAMMARS")
        self._knobs = {k: get(k) for k in _UNPORTED_KNOBS}
        self._overload_knobs = {k: get(k) for k in _OVERLOAD_KNOBS}
        self._llms: dict[str, LLMEngine] = {}
        self._lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        """The device engines run on (raises without a GPU unless the
        config asks for the CPU)."""
        return resolve_device(self.default_device)

    def register_llm(self, name: str, cfg, params, **engine_kw) -> LLMEngine:
        """Build an ``LLMEngine`` over ``params`` and register it as
        ``name`` (replacing and closing an earlier one). A config with
        ``n_experts`` > 0 serves its mixture-of-experts FFN through the
        same engine, every expert on the one card: expert parallelism
        (the JAX runtime's sharding of the expert stacks under
        ``TPU_LLM_TP``) is not ported, and a ``TPU_LLM_TP`` degree above
        1 stays refused. ``kv_paged`` / ``TPU_LLM_KV_PAGED`` pick the KV
        layout (the engine's ``kv_paged``); the contiguous layouts serve
        ``prefix_cache_mb`` through the whole-row prefix cache and ignore
        ``kv_int8`` (``kvcache`` logs it). ``step_token_budget`` /
        ``TPU_LLM_STEP_TOKEN_BUDGET`` 0 builds the wave scheduler."""
        unknown = sorted(set(engine_kw) - set(_ENGINE_KWARGS))
        if unknown:
            raise NotImplementedError(f"register_llm: not ported: {', '.join(unknown)}")
        for knob, fine in _UNPORTED_KNOBS.items():
            v = self._knobs[knob]
            if v != "" and v not in fine:
                why = " (ROADMAP queue 1 ID 19)" if knob in _SHAPE_KNOBS else ""
                raise NotImplementedError(f"{knob}={v}: not ported{why}")
        if self._knobs["TPU_LLM_STEP_TOKEN_BUDGET"] != "":
            engine_kw.setdefault("step_token_budget", int(self._knobs["TPU_LLM_STEP_TOKEN_BUDGET"]))
        if self.default_llm_kv_paged != "":
            # "1" means "auto", as the process-wide knob does
            engine_kw.setdefault("kv_paged", False if self.default_llm_kv_paged == "0" else "auto")
        if self.default_llm_kv_int8 != "":
            engine_kw.setdefault("kv_int8", self.default_llm_kv_int8 != "0")
        engine_kw.setdefault("prefix_cache_mb", self.default_llm_prefix_cache_mb)
        if self.default_llm_session_mb != "":
            engine_kw.setdefault("session_mb", float(self.default_llm_session_mb))
        if self.default_llm_host_cache_mb != "":
            engine_kw.setdefault("host_cache_mb", float(self.default_llm_host_cache_mb))
        if self.default_llm_spec != "":
            engine_kw.setdefault("speculative", self.default_llm_spec != "0")
        if self.default_llm_spec_draft != "":
            engine_kw.setdefault("spec_draft", int(self.default_llm_spec_draft))
        if self.default_llm_constrained != "":
            engine_kw.setdefault("constrained", self.default_llm_constrained != "0")
        if self.default_llm_constrained_grammars != "":
            engine_kw.setdefault("constrained_grammars", int(self.default_llm_constrained_grammars))
        for knob, v in self._overload_knobs.items():
            if v != "":
                kwarg, parse = _OVERLOAD_KNOBS[knob]
                engine_kw.setdefault(kwarg, parse(v))
        engine_kw.setdefault("device", self.default_device)
        engine = LLMEngine(cfg, params, **engine_kw)
        with self._lock:
            old = self._llms.get(name)
            self._llms[name] = engine
        if old is not None:
            old.close()
        if self.logger is not None:
            kv = engine.kv.stats()
            self.logger.info(f"LLM {name!r} registered on {engine.device} ({cfg.n_layers} layers, d_model {cfg.d_model}; "
                             f"KV {kv['layout']}, capacity {kv['capacity']})")
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
