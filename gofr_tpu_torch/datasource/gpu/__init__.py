"""The GPU datasource: the model and LLM registry behind ``ctx.tpu()``
(counterpart of gofr_tpu/datasource/tpu/__init__.py ``TPURuntime``: the
plain-model registry with its dynamic ``Batcher``, and ``register_llm``).

``register_model(name, apply_fn, params, example_args=...)`` moves the
params to the runtime's device, warms every power-of-two batch bucket up
to ``max_batch`` when ``example_args`` is given, and starts the model's
``Batcher`` (``TPU_BATCH_MAX_SIZE`` 64, ``TPU_BATCH_MAX_DELAY_MS`` 2,
``TPU_BATCH_MAX_INFLIGHT`` 8). ``infer_async`` / ``infer_one`` send one
example (no batch axis) through the batcher, ``infer`` calls the model on
a batch the caller formed. ``apply_fn(params, *batched_args)`` takes
tensors on the device (the batcher stacks numpy examples and copies them
there) and returns a tensor, or a tuple, list or dict of them; each caller
gets its own row as numpy.

``register_llm(name, cfg, params, **engine_kw)`` builds the port's
``LLMEngine`` (or, with ``replicas`` > 1 or ``devices``, a
``ReplicatedLLMEngine``; with ``disagg=True`` or ``TPU_LLM_DISAGG=1`` a
``DisaggregatedLLMEngine``) and registers it under ``name`` behind a
``resilience.rollout.ModelHandle``, which it returns and ``llm(name)``
resolves: the handle passes the engine's surface through and adds
``deploy``, ``register_adapter`` and ``rollout_state``. ``drain`` /
``drained`` serve the app's graceful drain.
The engine runs on ``cuda`` unless the caller passes ``device="cpu"`` or
the config sets ``TORCH_DEVICE=cpu``; without a GPU it raises.

Only what the port's engine has is accepted: the kwargs ``slots``,
``max_seq_len``, ``prefill_buckets``, ``quantize``, ``kv_int8``, ``seed``,
``device``, ``lookahead``, ``warmup``, ``prefix_cache_mb``,
``session_mb``, ``host_cache_mb``, ``kv_pool_blocks``, the shape knobs
``decode_chunk``, ``prefill_chunk``, ``kv_block`` and
``step_token_budget`` (above 0 the chunked scheduler, 0 the wave),
``admit_cap`` and ``admit_delay_ms``, ``speculative``, ``spec_draft``,
``constrained``, ``constrained_grammars``, the overload kwargs
``max_queue``, ``ttft_deadline_ms``, ``fair_queuing``, ``fair_weights``,
``fair_ledger``, ``preemption``, ``shed_predicted_wait_s``,
``brownout_wait_s``, ``brownout_max_new`` and ``brownout_hold_s``, the
LoRA pool's ``lora_slots`` and ``lora_rank``, the recovery kwargs
``fault_injector``, ``step_watchdog_s``, ``numeric_check`` and
``version``, the fleet's ``replicas``, ``devices``, ``router``,
``supervise``, ``failover_retries``, ``fleet_max_queue_tokens``,
``retry_budget_per_s``, ``retry_budget_burst``, ``poison_deaths``,
``canary`` and ``health_ledger``, the disaggregated fleet's ``disagg``,
``prefill_replicas``, ``handoff_timeout_s`` and ``handoff_d2d``, the
accounting and recorder kwargs ``metrics`` (default: the runtime's
``metrics``, the container's manager), ``goodput``, ``quotas``,
``usage_meter``, ``usage_window_s``, ``flight_records``, ``flight_redact``,
``blackbox_dir``, ``blackbox_interval_s``, ``anomaly`` and
``wide_event_sample``, the KV layout's
``kv_paged`` (``True``, ``False`` or ``"auto"``: the paged pool, or the
contiguous layouts, the rolling ring for a windowed model where window +
slack < max_seq_len and the dense slab otherwise; ``"auto"`` takes the
ring where it engages and no session tier is asked for) and ``kv_window``
(0 forces the dense slab), and the config knobs ``TPU_LLM_KV_PAGED`` ("0"
means ``kv_paged=False``, anything else ``"auto"``, as in the JAX
runtime), the shape knobs ``TPU_LLM_STEP_TOKEN_BUDGET`` (0 the wave),
``TPU_LLM_PREFILL_CHUNK`` and ``TPU_LLM_KV_BLOCK``, ``TPU_LLM_KV_INT8``,
``TPU_LLM_PREFIX_CACHE_MB``, ``TPU_LLM_SESSION_MB``,
``TPU_LLM_HOST_CACHE_MB``, ``TPU_LLM_SPEC``, ``TPU_LLM_SPEC_DRAFT``,
``TPU_LLM_CONSTRAINED``, ``TPU_LLM_CONSTRAINED_GRAMMARS``,
``TPU_LLM_FAIR``, ``TPU_LLM_PREEMPT``, ``TPU_LLM_SHED_WAIT_S``,
``TPU_LLM_BROWNOUT_WAIT_S``, ``TPU_LLM_BROWNOUT_MAX_NEW``,
``TPU_LLM_BROWNOUT_HOLD_S``, ``TPU_LLM_LORA_SLOTS``,
``TPU_LLM_LORA_RANK_MAX``, ``TPU_LLM_STEP_WATCHDOG_S``,
``TPU_LLM_NUMERIC_CHECK``, ``TPU_LLM_DISAGG``,
``TPU_LLM_DISAGG_PREFILL_REPLICAS``, ``TPU_LLM_KV_HANDOFF_TIMEOUT_S``,
``TPU_LLM_KV_HANDOFF_D2D``, ``TPU_LLM_FLIGHT_RECORDS``,
``TPU_LLM_FLIGHT_REDACT``, ``GOFR_BLACKBOX_DIR``,
``GOFR_BLACKBOX_INTERVAL_S``, ``TPU_LLM_ANOMALY``,
``TPU_LLM_WIDE_EVENT_SAMPLE``, ``TPU_LLM_GOODPUT``,
``TPU_LLM_USAGE_WINDOW_S`` and ``TPU_LLM_TENANT_QUOTA_TOK_S``
("tenant=tok/s,...") (defaults for the kwargs a caller leaves out, with
the JAX engine's meanings; the engine also reads each from the process
env, as do the detectors ``TPU_LLM_ANOMALY_{FACTOR,MIN_SAMPLES,SUSTAIN}``).
``TPU_LLM_TP`` above 1 stays refused. As in the JAX runtime,
``TPU_LLM_KV_POOL_BLOCKS`` has no config mapping: the process env reaches
the engine's ``CacheManager``, which reads it (with ``TPU_LLM_KV_INT8``,
``TPU_LLM_SESSION_MB`` and ``TPU_LLM_HOST_CACHE_MB``) for a kwarg left
None. Any other kwarg, and any of the JAX runtime's engine knobs set to
ask for a feature the port lacks (meshes, ...), raises
``NotImplementedError`` naming it; none is ignored.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import queue
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ... import resolve_device
from ...goodput import parse_quota_spec
from ...llm import LLMEngine, ReplicatedLLMEngine
from ...resilience.rollout import ModelHandle
from .. import STATUS_DOWN, STATUS_UP, health

__all__ = ["Batcher", "GPURuntime"]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of equal-structured trees of tuples, lists and
    dicts (the pytrees ``apply_fn`` takes and returns here)."""
    t = trees[0]
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    return fn(*trees)


def _on(stream):
    """A context running CUDA work on ``stream`` (None: as it stands)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _leaves(tree) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


class _Readback:
    """One wave's output on its way to the host: CUDA tensors are copied
    into pinned buffers behind one event, on the stream current at
    construction (the wave's); anything else is taken as it stands.
    ``wait`` blocks on the event and returns the tree as numpy."""

    __slots__ = ("host", "event")

    def __init__(self, out):
        cuda = any(isinstance(x, torch.Tensor) and x.is_cuda for x in _leaves(out))

        def start(x):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
                return h
            return x

        self.host = _tree_map(start, out)
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return _tree_map(lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x), self.host)


@dataclass
class _Pending:
    args: tuple  # single-example args (no batch axis)
    future: Any  # concurrent.futures.Future
    enqueued: float = field(default_factory=time.perf_counter)


class Batcher:
    """Per-model dynamic batching queue, pipelined (JAX ``Batcher``).

    Requests are single examples; the collector thread takes the first,
    lingers up to ``max_delay_ms`` (or until ``max_batch``) for more,
    stacks them and pads the batch to the next power of two with copies of
    the last example, then makes ONE launch, ``run_batch(stacked, n)``,
    which returns the wave's output on the device without waiting for it.
    The collector starts the copy to pinned host memory behind a CUDA
    event (on ``stream`` when one is given, the stream the launch ran on)
    and goes back to assembling the next wave; one of ``max_inflight``
    completion workers waits on that event and resolves each request's
    future with its row. So waves overlap, as under XLA's asynchronous
    dispatch. A launch or readback error fails every future of its wave;
    ``close`` fails every request still queued. ``widths`` counts the
    waves by their request count."""

    def __init__(
        self,
        name: str,
        run_batch: Callable[[tuple, int], Any],
        *,
        max_batch: int = 64,
        max_delay_ms: float = 2.0,
        max_inflight: int = 8,
        stream=None,
        logger=None,
    ):
        self.name = name
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1000.0
        self.stream = stream
        self.logger = logger
        self.widths: Counter = Counter()  # requests per wave -> waves
        self.q: queue.Queue[_Pending | None] = queue.Queue()
        self._inflight = threading.Semaphore(max_inflight)
        self._completion = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_inflight, thread_name_prefix=f"gpu-complete-{name}"
        )
        self._thread = threading.Thread(target=self._loop, name=f"gpu-batcher-{name}", daemon=True)
        self._closed = False
        self._thread.start()

    def submit(self, args: tuple) -> concurrent.futures.Future:
        if self._closed:
            raise RuntimeError(f"batcher {self.name} is closed")
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self.q.put(_Pending(args=args, future=fut))
        return fut

    def _collect(self) -> list[_Pending]:
        """Block for the first request, then linger up to max_delay (or
        until max_batch) for co-travellers."""
        first = self.q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_delay
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self.q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                self._closed = True
                break
            batch.append(item)
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                break
            self._dispatch(batch)
            if self._closed:
                break
        # a submit() that read _closed as False but enqueued behind the
        # shutdown sentinel gets an error, never a hang
        while True:
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._resolve(item, error=RuntimeError(f"batcher {self.name} is closed"))
        self._completion.shutdown(wait=True)

    def _dispatch(self, batch: list[_Pending]) -> None:
        """Collector side: stack, launch, start the readback, hand off to
        a completion worker (at most max_inflight waves outstanding)."""
        n = len(batch)
        t0 = time.perf_counter()
        self.widths[n] += 1
        self._inflight.acquire()
        try:
            examples = [p.args for p in batch]
            examples += [batch[-1].args] * (_next_pow2(n) - n)
            stacked = _tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *examples)
            with _on(self.stream):
                rb = _Readback(self.run_batch(stacked, n))
        except Exception as e:  # noqa: BLE001 - a launch failure fans out now
            self._inflight.release()
            for p in batch:
                self._resolve(p, error=e)
            return
        self._completion.submit(self._complete, batch, rb, t0)

    @staticmethod
    def _resolve(pending: _Pending, result=None, error: Exception | None = None) -> None:
        """Set a future's outcome; a future the caller already cancelled is
        left as it is (its wave completes for the others)."""
        try:
            if error is not None:
                pending.future.set_exception(error)
            else:
                pending.future.set_result(result)
        except Exception:  # noqa: BLE001 - cancelled or resolved: detach
            pass

    def _complete(self, batch: list[_Pending], rb: _Readback, t0: float) -> None:
        """Completion side: wait for the wave's readback, scatter rows."""
        try:
            out = rb.wait()
            for i, p in enumerate(batch):
                self._resolve(p, result=_tree_map(lambda x, i=i: x[i], out))
        except Exception as e:  # noqa: BLE001 - a wave failure fans out to its callers
            for p in batch:
                self._resolve(p, error=e)
        finally:
            self._inflight.release()
        if self.logger is not None:
            self.logger.debug(f"GPU batch model={self.name} n={len(batch)} took "
                              f"{(time.perf_counter() - t0) * 1e3:.2f}ms")

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.q.put(None)
            self._thread.join(timeout=10)


class _Model:
    def __init__(self, name: str, fn: Callable, params, batcher: Batcher, meta: dict, stream=None):
        self.name = name
        self.fn = fn
        self.params = params
        self.batcher = batcher
        self.meta = meta
        self.stream = stream

_ENGINE_KWARGS = (
    "slots", "max_seq_len", "prefill_buckets", "quantize", "kv_int8", "seed", "device", "lookahead", "warmup",
    "prefix_cache_mb", "session_mb", "host_cache_mb", "speculative", "spec_draft", "constrained",
    "constrained_grammars", "max_queue", "ttft_deadline_ms", "fair_queuing", "fair_weights", "fair_ledger",
    "preemption", "shed_predicted_wait_s", "brownout_wait_s", "brownout_max_new", "brownout_hold_s",
    "lora_slots", "lora_rank", "kv_paged", "kv_window", "kv_pool_blocks", "step_token_budget", "admit_cap",
    "admit_delay_ms", "decode_chunk", "prefill_chunk", "kv_block",
    # recovery (every engine) and the replica fleet
    "fault_injector", "step_watchdog_s", "numeric_check", "version", "replicas", "devices", "router", "supervise",
    "failover_retries", "fleet_max_queue_tokens", "retry_budget_per_s", "retry_budget_burst", "poison_deaths",
    "canary", "health_ledger",
    # the disaggregated fleet
    "disagg", "prefill_replicas", "handoff_timeout_s", "handoff_d2d",
    # chip-time accounting and the flight recorder
    "metrics", "goodput", "quotas", "usage_meter", "usage_window_s", "flight_records", "flight_redact",
    "blackbox_dir", "blackbox_interval_s", "anomaly", "wide_event_sample",
)

# Overload-control, LoRA and shape knobs: config key -> (engine kwarg, parser of
# the value)
_MAPPED_KNOBS = {
    "TPU_LLM_FAIR": ("fair_queuing", lambda v: v != "0"),
    "TPU_LLM_PREEMPT": ("preemption", lambda v: v != "0"),
    "TPU_LLM_SHED_WAIT_S": ("shed_predicted_wait_s", float),
    "TPU_LLM_BROWNOUT_WAIT_S": ("brownout_wait_s", float),
    "TPU_LLM_BROWNOUT_MAX_NEW": ("brownout_max_new", int),
    "TPU_LLM_BROWNOUT_HOLD_S": ("brownout_hold_s", float),
    "TPU_LLM_LORA_SLOTS": ("lora_slots", int),
    "TPU_LLM_LORA_RANK_MAX": ("lora_rank", int),
    # the engine's shape knobs (JAX datasource/tpu/__init__.py:541-548, :592-593)
    "TPU_LLM_STEP_TOKEN_BUDGET": ("step_token_budget", int),
    "TPU_LLM_PREFILL_CHUNK": ("prefill_chunk", int),
    "TPU_LLM_KV_BLOCK": ("kv_block", int),
    # the watchdogs (JAX datasource/tpu/__init__.py:555-564)
    "TPU_LLM_STEP_WATCHDOG_S": ("step_watchdog_s", float),
    "TPU_LLM_NUMERIC_CHECK": ("numeric_check", lambda v: v != "0"),
    # the disaggregated fleet (JAX datasource/tpu/__init__.py:673-699)
    "TPU_LLM_DISAGG": ("disagg", lambda v: v != "0"),
    "TPU_LLM_DISAGG_PREFILL_REPLICAS": ("prefill_replicas", int),
    "TPU_LLM_KV_HANDOFF_TIMEOUT_S": ("handoff_timeout_s", float),
    "TPU_LLM_KV_HANDOFF_D2D": ("handoff_d2d", lambda v: v != "0"),
    # the flight recorder (JAX datasource/tpu/__init__.py:298-308, :604-632)
    "TPU_LLM_FLIGHT_RECORDS": ("flight_records", int),
    "TPU_LLM_FLIGHT_REDACT": ("flight_redact", lambda v: v != "0"),
    "GOFR_BLACKBOX_DIR": ("blackbox_dir", str),
    "GOFR_BLACKBOX_INTERVAL_S": ("blackbox_interval_s", float),
    "TPU_LLM_ANOMALY": ("anomaly", lambda v: v != "0"),
    "TPU_LLM_WIDE_EVENT_SAMPLE": ("wide_event_sample", int),
    # the goodput ledger and the quota gate (read by the JAX engine from
    # the process env; here from the config too)
    "TPU_LLM_GOODPUT": ("goodput", lambda v: v != "0"),
    "TPU_LLM_USAGE_WINDOW_S": ("usage_window_s", float),
    "TPU_LLM_TENANT_QUOTA_TOK_S": ("quotas", parse_quota_spec),
}

# the knobs only a disaggregated fleet reads
_DISAGG_KWARGS = ("prefill_replicas", "handoff_timeout_s", "handoff_d2d")

# The JAX runtime's engine knobs that select a feature this port lacks,
# each with the values that ask for nothing more than the port does.
_UNPORTED_KNOBS = {
    "TPU_LLM_TP": ("0", "1"),
}


class GPURuntime:
    """``ctx.tpu()`` — built lazily by the Container."""

    def __init__(self, config=None, logger=None, metrics=None):
        self.config = config
        self.logger = logger
        self.metrics = metrics  # a metrics.Manager every engine built here writes
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
        self._mapped_knobs = {k: get(k) for k in _MAPPED_KNOBS}
        self.default_max_batch = int(get("TPU_BATCH_MAX_SIZE") or 64)
        self.default_max_delay_ms = float(get("TPU_BATCH_MAX_DELAY_MS") or 2)
        self.default_max_inflight = int(get("TPU_BATCH_MAX_INFLIGHT") or 8)
        self._models: dict[str, _Model] = {}
        self._llms: dict[str, ModelHandle] = {}
        self._lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        """The device engines run on (raises without a GPU unless the
        config asks for the CPU)."""
        return resolve_device(self.default_device)

    # -- the plain-model registry -------------------------------------------
    def register_model(
        self,
        name: str,
        apply_fn: Callable,
        params: Any,
        *,
        example_args: tuple | None = None,
        max_batch: int | None = None,
        max_delay_ms: float | None = None,
    ) -> None:
        """Move ``params`` (a tree of tensors or arrays) to the runtime's
        device, start the model's batcher (replacing and closing an earlier
        one of that name) and, when ``example_args`` (one example, no batch
        axis) is given, run ``apply_fn`` once on every power-of-two bucket
        up to ``max_batch``, so the first requests pay no first-call cost.
        ``apply_fn(params, *batched_args)`` runs under
        ``torch.inference_mode`` on the model's own CUDA stream."""
        dev = self.device
        params = _tree_map(lambda x: torch.as_tensor(x).to(dev), params)
        max_batch = max_batch or self.default_max_batch
        max_delay_ms = max_delay_ms if max_delay_ms is not None else self.default_max_delay_ms
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))  # the params' copies

        def to_dev(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.pin_memory().to(dev, non_blocking=True) if stream is not None else t

        def run_batch(stacked_args, true_n: int):
            # launch only: the batcher's completion workers wait for the
            # readback, so waves pipeline
            with torch.inference_mode():
                return apply_fn(params, *_tree_map(to_dev, stacked_args))

        batcher = Batcher(
            name, run_batch, max_batch=max_batch, max_delay_ms=max_delay_ms,
            max_inflight=self.default_max_inflight, stream=stream, logger=self.logger,
        )
        meta = {
            "max_batch": max_batch,
            "max_delay_ms": max_delay_ms,
            "params_bytes": sum(x.numel() * x.element_size() for x in _leaves(params)),
        }
        model = _Model(name, apply_fn, params, batcher, meta, stream)
        with self._lock:
            old = self._models.get(name)
            self._models[name] = model
        if old is not None:
            old.batcher.close()
        if example_args is not None:
            buckets = tuple(1 << i for i in range(max_batch.bit_length()) if (1 << i) <= max_batch)
            for bucket in buckets:
                stacked = _tree_map(lambda x: np.stack([np.asarray(x)] * bucket), example_args)
                with _on(stream):
                    _Readback(run_batch(stacked, bucket)).wait()
            if self.logger is not None:
                self.logger.info(f"model '{name}' registered & warmed (buckets {buckets})")

    def model(self, name: str) -> _Model:
        try:
            return self._models[name]
        except KeyError:
            raise KeyError(f"model '{name}' not registered; known: {list(self._models)}") from None

    def infer(self, name: str, *batched_args) -> Any:
        """Direct batched call (the caller formed the batch): synchronous,
        returns the output as numpy."""
        m = self.model(name)
        dev = self.device
        with _on(m.stream), torch.inference_mode():
            args = _tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(dev), batched_args)
            return _Readback(m.fn(m.params, *args)).wait()

    async def infer_async(self, name: str, *example_args) -> Any:
        """One example through the model's batcher; awaitable."""
        import asyncio

        return await asyncio.wrap_future(self.model(name).batcher.submit(example_args))

    def infer_one(self, name: str, *example_args, timeout: float | None = None) -> Any:
        """One example through the model's batcher, blocking."""
        return self.model(name).batcher.submit(example_args).result(timeout=timeout)

    # -- LLM engines ----------------------------------------------------------
    def register_llm(self, name: str, cfg, params, **engine_kw) -> ModelHandle:
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
        ``TPU_LLM_STEP_TOKEN_BUDGET`` 0 builds the wave scheduler.
        ``replicas`` > 1 (or ``devices``) builds a ``ReplicatedLLMEngine``
        (the JAX runtime's fleet; the replicas may share one card), whose
        fleet kwargs (``router``, ``supervise``, ``failover_retries``, ...)
        pass through; ``meshes`` stays refused. ``TPU_LLM_STEP_WATCHDOG_S``
        and ``TPU_LLM_NUMERIC_CHECK`` set the watchdogs. ``disagg``
        (``TPU_LLM_DISAGG``) builds a ``DisaggregatedLLMEngine`` over
        ``replicas`` (default 2; ``prefill_replicas`` of them prefill). The
        engine is returned behind a ``ModelHandle``; a bare engine's
        handle keeps its constructor kwargs, so ``deploy`` builds the
        staged engine with the same serving shape."""
        unknown = sorted(set(engine_kw) - set(_ENGINE_KWARGS))
        if unknown:
            raise NotImplementedError(f"register_llm: not ported: {', '.join(unknown)}")
        for knob, fine in _UNPORTED_KNOBS.items():
            v = self._knobs[knob]
            if v != "" and v not in fine:
                raise NotImplementedError(f"{knob}={v}: not ported")
        explicit = [k for k in _DISAGG_KWARGS if k in engine_kw]
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
        for knob, v in self._mapped_knobs.items():
            if v != "":
                kwarg, parse = _MAPPED_KNOBS[knob]
                engine_kw.setdefault(kwarg, parse(v))
        engine_kw.setdefault("device", self.default_device)
        engine_kw.setdefault("kv_label", name)
        if self.metrics is not None:
            engine_kw.setdefault("metrics", self.metrics)
        replicas = engine_kw.pop("replicas", None)
        disagg = engine_kw.pop("disagg", False)
        dkw = {k: engine_kw.pop(k) for k in _DISAGG_KWARGS if k in engine_kw}
        if explicit and not disagg:
            raise ValueError(f"register_llm: {', '.join(explicit)} apply to a disaggregated fleet only (disagg=True)")
        build_kw: dict = {}  # a fleet retains its own rebuild inputs
        if disagg:
            from ...llm_disagg import DisaggregatedLLMEngine

            engine = DisaggregatedLLMEngine(cfg, params, replicas=replicas, logger=self.logger, **dkw, **engine_kw)
        elif (replicas or 1) > 1 or "devices" in engine_kw:
            engine = ReplicatedLLMEngine(cfg, params, replicas=replicas, logger=self.logger, **engine_kw)
        else:
            engine = LLMEngine(cfg, params, logger=self.logger, **engine_kw)
            # a deploy builds the staged engine with this serving shape;
            # only the weights change
            build_kw = dict(engine_kw, logger=self.logger)
            build_kw.pop("version", None)
        handle = ModelHandle(name, engine, build_kw=build_kw, logger=self.logger)
        with self._lock:
            old = self._llms.get(name)
            self._llms[name] = handle
        if old is not None:
            old.close()
        if self.logger is not None:
            lead = engine.engines[0] if hasattr(engine, "engines") else engine
            kv = lead.kv.stats()
            n = len(engine.engines) if hasattr(engine, "engines") else 1
            kind = "disaggregated, " if disagg else ""
            self.logger.info(f"LLM {name!r} registered on {engine.device} ({kind}{n} replica(s), {cfg.n_layers} "
                             f"layers, d_model {cfg.d_model}; KV {kv['layout']}, capacity {kv['capacity']})")
        return handle

    def llm(self, name: str) -> ModelHandle:
        try:
            return self._llms[name]
        except KeyError:
            raise KeyError(f"LLM '{name}' not registered; known: {list(self._llms)}") from None

    def health_check(self) -> dict:
        try:
            eng = next(iter(self._llms.values()), None)
            dev = eng.device if eng is not None else torch.device(self.default_device or "cuda")
            with self._lock:
                models = list(self._models.values())
            on_gpu = dev.type == "cuda" and torch.cuda.is_available()
            details: dict[str, Any] = {
                "platform": "gpu" if on_gpu else "cpu",
                "device_count": torch.cuda.device_count() if on_gpu else 1,
                "device_kind": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
                "models": {m.name: dict(m.meta, queue_depth=m.batcher.q.qsize()) for m in models},
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

    def drain(self) -> None:
        """Close admission on every registered LLM engine or fleet (submit
        -> ``EngineDraining``, 503) while their work in flight finishes; the
        plain models serve until ``close``."""
        for eng in list(self._llms.values()):
            eng.drain()

    def drained(self) -> bool:
        """True once no LLM engine holds queued or in-flight work."""
        return all(eng.drained() for eng in list(self._llms.values()))

    def degraded(self) -> bool:
        """A fleet runs short: a replica slot is parked (no usable device)
        or has failed for good (the JAX health's gauges, read here from
        the supervisors)."""
        for eng in list(self._llms.values()):
            sup = getattr(eng, "supervisor", None)
            if sup is not None and (sup.parked_count() or sup.failed_count()):
                return True
        return False

    def close(self) -> None:
        with self._lock:
            models, self._models = list(self._models.values()), {}
            llms, self._llms = list(self._llms.values()), {}
        for m in models:
            m.batcher.close()
        for eng in llms:
            eng.close()
