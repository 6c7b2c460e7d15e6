"""Device-program observability: the graph-capture observatory
(counterpart of gofr_tpu/profiling/__init__.py).

In the reference a "compile" is an XLA compilation of a jitted program;
here it is the capture of one of the engine's program families as a CUDA
graph (``LLMEngine._capture``), recorded per family and shape with its
seconds, and a "hit" is a replay of the captured graph. On the CPU, where
the engine captures nothing and runs its programs eagerly, a family's
first run is its entry (``measured="first_call"``) and every later run a
hit.

- :class:`CompileRegistry` / :func:`default_registry` — the process-wide
  store behind ``GET /.well-known/debug/compiles`` and the incident
  bundle's ``compiles`` section. Engines remove their entries on
  ``close()`` and ``_die()``.
- metrics: ``app_jax_compile_seconds{program,model}`` plus the compile /
  cache-hit counters (the reference's names, so one dashboard reads
  either package), registered idempotently by
  :func:`register_compile_metrics`.

MFU / roofline math lives in :mod:`.mfu`; on-demand ``torch.profiler``
capture in :mod:`.capture`. Nothing here imports torch.
"""

from __future__ import annotations

import threading
import time

__all__ = [
    "COMPILE_BUCKETS",
    "CompileRegistry",
    "default_registry",
    "register_compile_metrics",
]

# A capture spans three orders of magnitude: a tiny engine's family
# captures in milliseconds, a wide one's fused 16-step decode in seconds.
COMPILE_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

# Serializes app_jax_* registration across engines (replicas register on
# parallel threads).
_REG_LOCK = threading.Lock()


def register_compile_metrics(metrics) -> None:
    """Idempotently register the capture-observatory instruments."""
    with _REG_LOCK:
        if not metrics.has("app_jax_compile_seconds"):
            metrics.new_histogram(
                "app_jax_compile_seconds",
                "graph capture wall seconds per program family",
                COMPILE_BUCKETS,
            )
        for name, desc in (
            ("app_jax_compiles_total",
             "graph captures per program family"),
            ("app_jax_trace_cache_hits_total",
             "dispatches served by an already-captured graph"),
        ):
            if not metrics.has(name):
                metrics.new_counter(name, desc)


class CompileRegistry:
    """Process-wide store of compiled device programs.

    Entries are keyed by (program, model, arg-shape signature): one row
    per captured graph family of an engine. Callers hand it plain
    numbers, so it is constructible (and serveable) in a process that
    never touched the device.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[tuple, dict] = {}
        self._events: dict[str, list] = {}  # backend phase events: name -> [n, total_s]
        self._warmups: dict[str, dict] = {}

    # -- writers ----------------------------------------------------------
    def record_compile(
        self,
        *,
        program: str,
        model: str = "",
        arg_shapes: tuple[str, ...] = (),
        trace_s: float = 0.0,
        compile_s: float = 0.0,
        flops: float | None = None,
        bytes_accessed: float | None = None,
        backend: str = "",
        measured: str = "capture",
    ) -> dict:
        key = (program, model, arg_shapes)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = {
                    "program": program,
                    "model": model,
                    "arg_shapes": list(arg_shapes),
                    "compiles": 0,
                    "hits": 0,
                    "trace_s": 0.0,
                    "compile_s": 0.0,
                    "compile_s_total": 0.0,
                    "flops": None,
                    "bytes_accessed": None,
                    "backend": backend,
                    # "capture": a CUDA graph capture timed directly;
                    # "first_call": first eager run (the CPU, no graph)
                    "measured": measured,
                    "first_compiled_at": time.time(),
                }
                self._entries[key] = e
            e["compiles"] += 1
            e["trace_s"] = round(trace_s, 6)
            e["compile_s"] = round(compile_s, 6)
            e["compile_s_total"] = round(e["compile_s_total"] + compile_s, 6)
            if flops is not None:
                e["flops"] = flops
            if bytes_accessed is not None:
                e["bytes_accessed"] = bytes_accessed
            return e

    def note_hit(self, program: str, model: str = "", arg_shapes: tuple[str, ...] = ()) -> None:
        key = (program, model, arg_shapes)
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e["hits"] += 1

    def note_backend_event(self, event: str, duration_s: float) -> None:
        """Aggregate a backend phase-duration event (bounded cardinality:
        a handful of phase names)."""
        with self._lock:
            agg = self._events.setdefault(event, [0, 0.0])
            agg[0] += 1
            agg[1] += duration_s

    def record_warmup(self, model: str, seconds: float, programs: int | None = None) -> None:
        """One engine warmup: the wall time of capturing the full program
        set, with the families' warm-up runs and synchronization (so at
        least the sum of the capture seconds)."""
        with self._lock:
            self._warmups[model] = {
                "seconds": round(seconds, 3),
                "programs": programs,
                "at": time.time(),
            }

    def remove_model(self, model: str) -> int:
        """Engine teardown: drop every entry (and warmup record) the label
        owns so a closed engine stops being listed. Returns entries removed."""
        with self._lock:
            gone = [k for k in self._entries if k[1] == model]
            for k in gone:
                del self._entries[k]
            self._warmups.pop(model, None)
            return len(gone)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._events.clear()
            self._warmups.clear()

    # -- readers ----------------------------------------------------------
    def snapshot(self, model: str | None = None) -> dict:
        """JSON-able view for /.well-known/debug/compiles. Bounded by the
        process's executable set (the engine's whole point is a bounded
        program count), so safe to serve under load."""
        now = time.time()
        with self._lock:
            entries = [
                dict(e, age_s=round(now - e["first_compiled_at"], 1))
                for k, e in self._entries.items()
                if model is None or k[1] == model
            ]
            events = {k: {"count": v[0], "total_s": round(v[1], 4)} for k, v in self._events.items()}
            warmups = {
                m: dict(w) for m, w in self._warmups.items()
                if model is None or m == model
            }
        entries.sort(key=lambda e: (e["model"], e["program"], e["arg_shapes"]))
        for e in entries:
            e.pop("first_compiled_at", None)
        return {
            "programs": entries,
            "totals": {
                "programs": len(entries),
                "compiles": sum(e["compiles"] for e in entries),
                "cache_hits": sum(e["hits"] for e in entries),
                "compile_s_total": round(sum(e["compile_s_total"] for e in entries), 3),
            },
            "backend_events": events,
            "warmup": warmups,
        }


_default_registry = CompileRegistry()


def default_registry() -> CompileRegistry:
    """The process-wide registry every engine records into."""
    return _default_registry
