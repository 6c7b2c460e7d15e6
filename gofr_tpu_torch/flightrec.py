"""Incident flight recorder: per-request black-box records, incident
bundles, deterministic replay and rolling-baseline anomaly detection
(counterpart of gofr_tpu/flightrec/__init__.py, copied: the port imports
nothing of the JAX package).

- :class:`FlightRecorder` — a bounded per-engine ring of flight records
  (``TPU_LLM_FLIGHT_RECORDS``, default 512): what re-executes one request
  (prompt token ids, or only their hash under ``TPU_LLM_FLIGHT_REDACT``;
  sampling params and seed; model name and version; adapter, grammar id,
  KV layout, speculative and constrained flags), its timings, deaths and
  hops, finish reason, chip time by waste class and emitted token ids.
  Records are started at submit and finalized on every terminal path.
- :class:`BlackboxDumper` — on a watchdog trip, a numerical trip, a
  poison verdict, any other engine death, a device quarantine, a rollout
  rollback or a flagged anomaly, a bundle directory under
  ``GOFR_BLACKBOX_DIR`` (rate-limited per trigger class by
  ``GOFR_BLACKBOX_INTERVAL_S``): debug_state, the retained wide events,
  HBM samples, the config fingerprint and the flight records of
  everything in flight, the manifest written last.
  ``app_blackbox_bundles_total{trigger}`` counts them.
- :func:`replay_record` — re-submit a recorded request with its version,
  adapter, grammar and sampling pinned and report the first index where
  the replay leaves the recorded emission.
- :class:`AnomalyDetector` — sustained deviation of TTFT, TPOT, step wall,
  queue wait or speculative acceptance from a rolling baseline flags
  ``app_llm_anomaly{signal}`` and triggers a bundle.

With ``GOFR_BLACKBOX_DIR`` unset no bundle is written; the recorder's
steady-state cost is one dict write at submit and one at each terminal.

Differences from the JAX module: bundle names take a process-wide
sequence number (JAX counts per dumper, so two engines of one label, a
replica and its rebuild, wrote into the same directory); a request's
``phase`` is derived from its scheduler state (:func:`request_phase`).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable

__all__ = [
    "FLIGHT_RECORDS_DEFAULT",
    "WIDE_EVENTS_KEEP",
    "AnomalyDetector",
    "BlackboxDumper",
    "FlightRecorder",
    "classify_die_reason",
    "find_record",
    "first_divergence",
    "register_flightrec_metrics",
    "replay_record",
    "request_phase",
]

FLIGHT_RECORDS_DEFAULT = 512
# last-N wide events retained for bundles (a line the log's 1-in-N
# sampling skipped still lands here in full)
WIDE_EVENTS_KEEP = 256
# newest manifests a listing returns (bounded: the endpoint must be safe
# against a directory that accumulated months of incidents)
LISTING_LIMIT = 64

_REG_LOCK = threading.Lock()
# bundle sequence numbers, shared by every dumper of the process
_BUNDLE_SEQ = itertools.count(1)


def register_flightrec_metrics(metrics) -> None:
    """Idempotent registration (register_slo_metrics' pattern)."""
    with _REG_LOCK:
        if not metrics.has("app_blackbox_bundles_total"):
            metrics.new_counter(
                "app_blackbox_bundles_total",
                "black-box incident bundles written (trigger labels the "
                "incident class: watchdog|numerical|poison|engine_death|"
                "quarantine|rollback|slo_fast_burn|anomaly|manual)",
            )
        if not metrics.has("app_llm_anomaly"):
            metrics.new_gauge(
                "app_llm_anomaly",
                "1 while the labelled signal (ttft|tpot|step|queue_wait|"
                "spec_accept) is sustained-deviant from its rolling "
                "baseline (zeroed at engine close)",
            )


def _sha256_tokens(tokens) -> str:
    h = hashlib.sha256()
    for t in tokens:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.hexdigest()


def request_phase(req) -> str:
    """new -> queued -> prefill -> decode -> done, from the port's request
    state (the JAX request keeps the field itself)."""
    if req.finish_reason is not None:
        return "done"
    if req.submitted_at is None:
        return "new"
    if req.slot is None:
        return "queued"
    return "decode" if req.prefill_done else "prefill"


def classify_die_reason(why: str) -> str:
    """Map an engine death reason onto its bundle trigger class."""
    why = why or ""
    if why.startswith("step watchdog"):
        return "watchdog"
    if why.startswith("numerical watchdog"):
        return "numerical"
    if why.startswith("poison payload"):
        return "poison"
    return "engine_death"


class FlightRecorder:
    """Bounded ring of per-request flight records, keyed by request id.

    ``start()`` captures the re-execution inputs at submit time (so an
    in-flight request is already replayable when the engine dies);
    ``finalize()`` stamps the terminal outcome — timings, finish
    reason, emitted token ids. The ring holds ``capacity`` records and
    evicts oldest-first; capacity 0 disables recording entirely.

    Redaction (``TPU_LLM_FLIGHT_REDACT=1`` or ``redact=True``) keeps
    only sha256 hashes of the prompt and emission — the record still
    proves WHAT ran and whether a replay diverged elsewhere, without
    persisting tenant content in process memory or bundles.

    The grammar OBJECT rides the record under the non-serializable
    ``_grammar`` key (replay re-submits it); ``serializable()`` strips
    underscore keys for bundles and HTTP responses."""

    def __init__(
        self,
        capacity: int | None = None,
        *,
        redact: bool | None = None,
        clock: Callable[[], float] | None = None,
    ):
        if capacity is None:
            capacity = int(
                os.environ.get("TPU_LLM_FLIGHT_RECORDS", "")
                or FLIGHT_RECORDS_DEFAULT
            )
        self.capacity = max(0, int(capacity))
        if redact is None:
            redact = os.environ.get("TPU_LLM_FLIGHT_REDACT", "0") not in ("", "0")
        self.redact = bool(redact)
        self._clock = clock if clock is not None else time.time
        self._lock = threading.Lock()
        self._ring: OrderedDict[int, dict] = OrderedDict()

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def _tokens_fields(self, prefix: str, tokens) -> dict:
        toks = [int(t) for t in tokens]
        out = {
            f"{prefix}_len": len(toks),
            f"{prefix}_sha256": _sha256_tokens(toks),
        }
        out[f"{prefix}_token_ids"] = None if self.redact else toks
        return out

    def start(self, req, engine) -> None:
        """Capture the re-execution inputs at submit time. Called once
        per (re)submit — a failover continuation overwrites its own
        record with the continuation prompt, which is exactly what a
        replay of THIS engine's work needs."""
        if not self.enabled:
            return
        kv = getattr(engine, "kv", None)
        layout = "dense"
        if kv is not None and getattr(kv, "paged", False):
            layout = "paged"
        elif kv is not None and getattr(kv, "ring", None):
            layout = "windowed"
        rec = {
            "id": req.id,
            "model": engine.label,
            "model_version": engine.version,
            # every engine seeds its sampler from PRNGKey(rng_seed):
            # greedy ignores it, temperature>0 replays pin it
            "seed": int(getattr(engine, "rng_seed", 0)),
            "temperature": float(req.temperature),
            "max_new_tokens": int(req.max_new_tokens),
            "eos_token": int(req.eos_token),
            "priority": req.priority,
            "client": req.client,
            "session_id": req.session_id,
            "adapter": req.adapter or "",
            "adapter_version": (
                f"{req.adapter}@{req._aid}" if req.adapter else ""
            ),
            "grammar_id": (
                f"g{req._g_id}" if getattr(req, "_g_id", -1) >= 0 else None
            ),
            "kv_layout": layout,
            "speculative": bool(getattr(engine, "speculative", False)),
            "constrained": req.grammar is not None,
            "lora": bool(req.adapter),
            "submitted_ts": self._clock(),
            "hop": req.hop,
            "deaths": req.deaths,
            "retries": req.retries,
            "journey_id": req.journey_id or "",
            "trace_id": req.span.trace_id if req.span is not None else "",
            "finish_reason": None,
            "final": False,
            "redacted": self.redact,
            **self._tokens_fields("prompt", req.prompt_tokens),
        }
        if req.grammar is not None:
            rec["_grammar"] = req.grammar
        with self._lock:
            self._ring[req.id] = rec
            self._ring.move_to_end(req.id)
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)

    def finalize(
        self,
        req,
        *,
        queue_wait_ms=None,
        ttft_ms=None,
        per_token_ms=None,
        total_ms=None,
        chip=None,
    ) -> dict | None:
        """Stamp the terminal outcome. Every terminal path lands here —
        the regular finish observer AND the die-drain paths — so a
        record is never left dangling non-final for a finished request."""
        if not self.enabled:
            return None
        with self._lock:
            rec = self._ring.get(req.id)
        if rec is None:
            return None
        rec.update({
            "final": True,
            "finish_reason": req.finish_reason,
            "hop": req.hop,
            "deaths": req.deaths,
            "retries": req.retries,
            "capped": req.capped,
            "browned": req.browned,
            "prefix_hit": req.prefix_hit,
            "finished_ts": self._clock(),
            "phase_ms": {
                "queue_wait": queue_wait_ms,
                "ttft": ttft_ms,
                "per_token": per_token_ms,
                "total": total_ms,
            },
            # chip-time attribution by waste class (goodput;
            # milliseconds): the per-request cost line an incident
            # bundle carries beside the latency breakdown
            "chip_ms": chip,
            # history holds the tokens emitted since THIS engine's
            # submit — exactly the emission a replay of the recorded
            # prompt reproduces
            **self._tokens_fields("emitted", req.history),
        })
        return rec

    def get(self, rid: int) -> dict | None:
        with self._lock:
            return self._ring.get(int(rid))

    def records(self, limit: int | None = None, final=None) -> list[dict]:
        """Newest-first record list; ``final`` filters terminal state."""
        with self._lock:
            out = list(self._ring.values())[::-1]
        if final is not None:
            out = [r for r in out if bool(r.get("final")) == final]
        if limit is not None:
            out = out[: max(0, int(limit))]
        return out

    def snapshot_inflight(self, reqs) -> list[dict]:
        """The bundle's in-flight view: every live request's record with
        its progress-so-far stamped (non-final — the death that
        triggered the bundle has not finished them). Requests the ring
        already evicted get a fresh minimal row so the bundle never
        silently omits an in-flight request."""
        out = []
        seen: set[int] = set()
        for r in reqs:
            if r is None or r.id in seen:
                continue
            seen.add(r.id)
            rec = self.get(r.id)
            if rec is None:
                rec = {"id": r.id, "evicted": True}
            rec = dict(rec)
            rec.update({
                "final": False,
                "phase": request_phase(r),
                "finish_reason": r.finish_reason,
                "hop": r.hop,
                "deaths": r.deaths,
                **self._tokens_fields("emitted", r.history),
            })
            out.append(rec)
        return out

    @staticmethod
    def serializable(rec: dict) -> dict:
        return {k: v for k, v in rec.items() if not k.startswith("_")}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


def first_divergence(recorded, replayed) -> int | None:
    """Index of the first token where the replay diverges from the
    recorded emission; None when token-identical (same tokens, same
    length). A pure-prefix mismatch diverges at the shorter length."""
    a = list(recorded or [])
    b = list(replayed or [])
    for i, (x, y) in enumerate(zip(a, b)):
        if int(x) != int(y):
            return i
    if len(a) != len(b):
        return min(len(a), len(b))
    return None


def replay_record(engine, record: dict, *, timeout: float = 120.0) -> dict:
    """Deterministic replay: re-submit ``record``'s request against
    ``engine`` with pinned version/adapter/grammar/seed and report the
    first-divergence index vs the recorded emission.

    The pinning is strict: a version mismatch is an error, not a silent
    cross-version comparison — different weights legitimately emit
    different tokens and the report would be noise. Redacted records
    cannot replay (the prompt is gone by design)."""
    rec = record
    if rec.get("redacted") or rec.get("prompt_token_ids") is None:
        return {
            "id": rec.get("id"),
            "error": "record redacted (TPU_LLM_FLIGHT_REDACT): prompt "
                     "tokens unavailable for replay",
        }
    want_version = rec.get("model_version")
    if want_version and engine.version != want_version:
        return {
            "id": rec.get("id"),
            "error": f"version mismatch: record pinned to "
                     f"{want_version!r}, engine serves {engine.version!r}",
        }
    recorded = list(rec.get("emitted_token_ids") or [])
    finish = rec.get("finish_reason")
    if finish in ("eos", "length"):
        max_new = int(rec.get("max_new_tokens") or max(1, len(recorded)))
    else:
        # cancelled/shed/failover-partial streams: replay only the prefix
        # the original actually emitted — decoding past it compares nothing
        max_new = max(1, len(recorded))
    from .llm import GenRequest

    req = GenRequest(
        list(rec["prompt_token_ids"]),
        max_new_tokens=max_new,
        temperature=float(rec.get("temperature") or 0.0),
        eos_token=int(
            rec["eos_token"] if rec.get("eos_token") is not None else -1
        ),
        priority=rec.get("priority") or "interactive",
        client="flightrec-replay",
        grammar=rec.get("_grammar"),
        adapter=rec.get("adapter") or "",
        probe=True,  # debug traffic: goodput classes it as probe waste
    )
    t0 = time.perf_counter()
    replayed = engine.submit(req).tokens(timeout=timeout)
    div = first_divergence(recorded, replayed)
    return {
        "id": rec.get("id"),
        "model": rec.get("model"),
        "model_version": engine.version,
        "recorded_len": len(recorded),
        "replayed_len": len(replayed),
        "first_divergence": div,
        "match": div is None,
        "recorded_token_ids": recorded,
        "replayed_token_ids": replayed,
        "replay_finish_reason": req.finish_reason,
        "replay_ms": round((time.perf_counter() - t0) * 1e3, 1),
    }


def find_record(engine, rid: int) -> tuple[dict, Any] | tuple[None, None]:
    """Locate flight record ``rid`` across an engine handle — a bare
    LLMEngine, a ReplicatedLLMEngine (search replicas), or anything
    exposing ``engines``. Returns (record, owning engine)."""
    for eng in getattr(engine, "engines", None) or [engine]:
        fr = getattr(eng, "flightrec", None)
        if fr is None:
            continue
        rec = fr.get(rid)
        if rec is not None:
            return rec, eng
    return None, None


class BlackboxDumper:
    """Write incident bundles under ``GOFR_BLACKBOX_DIR``.

    One bundle is a directory ``<label>-<trigger>-<seq>/`` of small
    JSON files (manifest, debug_state, wide events, HBM samples, config
    fingerprint, anomaly state, flight records, the trace ring and the
    capture registry) — the
    exact evidence an engineer needs when the process that held it is
    gone. Dumps are rate-limited PER TRIGGER CLASS
    (``GOFR_BLACKBOX_INTERVAL_S``, default 60 s): a crash loop or a
    flapping anomaly produces one bundle per window, not a disk full of
    identical ones. Unconfigured (empty dir) the dumper is inert."""

    def __init__(
        self,
        directory: str | None = None,
        *,
        min_interval_s: float | None = None,
        clock: Callable[[], float] | None = None,
        logger=None,
        metrics=None,
        label: str = "llm",
    ):
        if directory is None:
            directory = os.environ.get("GOFR_BLACKBOX_DIR", "")
        self.directory = directory or ""
        if min_interval_s is None:
            min_interval_s = float(
                os.environ.get("GOFR_BLACKBOX_INTERVAL_S", "") or 60.0
            )
        self.min_interval_s = max(0.0, float(min_interval_s))
        self._clock = clock if clock is not None else time.time
        self.logger = logger
        self.metrics = metrics
        self.label = label
        self._lock = threading.Lock()
        self._last: dict[str, float] = {}  # trigger class -> last dump ts
        self._closed = False
        self.last_ts: float | None = None  # newest dump (serving summary)
        self.last_trigger: str | None = None
        self.rate_limited = 0
        self._manifests: deque = deque(maxlen=LISTING_LIMIT)
        if metrics is not None:
            register_flightrec_metrics(metrics)

    def enabled(self) -> bool:
        return bool(self.directory) and not self._closed

    def close(self) -> None:
        """close()/_die() contract (the dead-engine-gauge rule's file
        sibling): a torn-down engine must not write further bundles."""
        self._closed = True

    def dump(
        self,
        trigger: str,
        *,
        reason: str = "",
        sections: dict[str, Any] | None = None,
        records: list[dict] | None = None,
    ) -> str | None:
        """Write one bundle; returns its path, or None when disabled or
        rate-limited. Never raises — the incident path must survive a
        full disk or an unwritable directory."""
        if not self.enabled():
            return None
        now = self._clock()
        with self._lock:
            last = self._last.get(trigger)
            if (
                last is not None
                and self.min_interval_s > 0
                and now - last < self.min_interval_s
            ):
                self.rate_limited += 1
                return None
            self._last[trigger] = now
            seq = next(_BUNDLE_SEQ)
        name = f"{self.label.replace('/', '_')}-{trigger}-{seq:04d}"
        path = os.path.join(self.directory, name)
        manifest = {
            "bundle": name,
            "label": self.label,
            "trigger": trigger,
            "reason": reason,
            "ts": now,
            "sections": sorted(sections or {}),
            "flight_records": len(records or []),
        }
        try:
            os.makedirs(path, exist_ok=True)
            for fname, payload in (sections or {}).items():
                self._write_json(os.path.join(path, f"{fname}.json"), payload)
            if records is not None:
                self._write_json(
                    os.path.join(path, "flight_records.json"),
                    [FlightRecorder.serializable(r) for r in records],
                )
            # manifest LAST: its presence marks the bundle complete, so
            # a listing never serves a half-written directory as done
            self._write_json(os.path.join(path, "manifest.json"), manifest)
        except OSError as e:
            if self.logger is not None:
                self.logger.error(f"blackbox bundle write failed: {e!r}")
            return None
        self.last_ts = now
        self.last_trigger = trigger
        with self._lock:
            self._manifests.append(manifest)
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_blackbox_bundles_total",
                trigger=trigger, model=self.label,
            )
        if self.logger is not None:
            self.logger.error(
                f"black-box bundle written: {path} (trigger={trigger})"
            )
        return path

    @staticmethod
    def _write_json(path: str, payload: Any) -> None:
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=repr)

    def listing(self) -> list[dict]:
        """Manifests of completed bundles in the directory (newest
        first, bounded) — includes bundles other processes sharing the
        dir wrote, which is what a fleet-wide listing wants."""
        if not self.directory or not os.path.isdir(self.directory):
            with self._lock:
                return list(self._manifests)[::-1]
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            names = []
        for name in names:
            mpath = os.path.join(self.directory, name, "manifest.json")
            try:
                with open(mpath) as f:
                    m = json.load(f)
            except (OSError, ValueError):
                continue
            m["path"] = os.path.join(self.directory, name)
            out.append(m)
        out.sort(key=lambda m: m.get("ts") or 0, reverse=True)
        return out[:LISTING_LIMIT]


# signal name -> deviation direction: +1 flags values ABOVE the
# baseline (latencies), -1 flags values BELOW it (acceptance rates)
ANOMALY_SIGNALS = {
    "ttft": 1,
    "tpot": 1,
    "step": 1,
    "queue_wait": 1,
    "spec_accept": -1,
}


class AnomalyDetector:
    """Sustained-deviation detection against rolling baselines.

    Per signal, a long :class:`~gofr_tpu_torch.metrics.RollingWindow` holds
    the NORMAL regime (only non-deviant observations feed it — an
    anomaly must not become its own baseline; after ``max_age_s`` with
    nothing but deviant traffic the baseline ages out and the detector
    recalibrates to the new normal). An observation is deviant when it
    exceeds ``factor`` x the baseline mean (or falls below mean/factor
    for lower-is-worse signals); ``sustain`` consecutive deviants flag
    the signal — one p99 straggler never pages — and ``sustain``
    consecutive normals clear it. Flag transitions publish
    ``app_llm_anomaly{model,signal}`` and fire ``on_flag`` (the
    perf-incident bundle trigger)."""

    def __init__(
        self,
        metrics=None,
        label: str = "llm",
        *,
        factor: float | None = None,
        min_samples: int | None = None,
        sustain: int | None = None,
        max_age_s: float = 3600.0,
        clock: Callable[[], float] | None = None,
        on_flag: Callable[[str, float, float], None] | None = None,
    ):
        from .metrics import RollingWindow

        if factor is None:
            factor = float(os.environ.get("TPU_LLM_ANOMALY_FACTOR", "") or 3.0)
        if min_samples is None:
            min_samples = int(
                os.environ.get("TPU_LLM_ANOMALY_MIN_SAMPLES", "") or 64
            )
        if sustain is None:
            sustain = int(os.environ.get("TPU_LLM_ANOMALY_SUSTAIN", "") or 8)
        self.factor = max(1.0, float(factor))
        self.min_samples = max(1, int(min_samples))
        self.sustain = max(1, int(sustain))
        self.metrics = metrics
        self.label = label
        self.on_flag = on_flag
        self._lock = threading.Lock()
        self._baseline = {
            s: RollingWindow(size=2048, max_age_s=max_age_s, clock=clock)
            for s in ANOMALY_SIGNALS
        }
        self._streak = dict.fromkeys(ANOMALY_SIGNALS, 0)  # consecutive deviants
        self._normal = dict.fromkeys(ANOMALY_SIGNALS, 0)  # consecutive normals
        self._flagged: set[str] = set()
        self._last: dict[str, float] = {}
        if metrics is not None:
            register_flightrec_metrics(metrics)

    def observe(self, signal: str, value: float) -> bool:
        """Feed one observation; returns whether the signal is flagged
        after it. Unknown signals are ignored (forward compat)."""
        direction = ANOMALY_SIGNALS.get(signal)
        if direction is None:
            return False
        value = float(value)
        fired = None
        with self._lock:
            base = self._baseline[signal]
            self._last[signal] = value
            deviant = False
            mean = 0.0
            if len(base) >= self.min_samples:
                mean = base.mean()
                if direction > 0:
                    deviant = value > self.factor * mean
                else:
                    deviant = value < mean / self.factor
            if deviant:
                self._streak[signal] += 1
                self._normal[signal] = 0
                if (
                    signal not in self._flagged
                    and self._streak[signal] >= self.sustain
                ):
                    self._flagged.add(signal)
                    fired = (value, mean)
                    self._publish(signal, 1.0)
            else:
                base.observe(value)  # only normal traffic is baseline
                self._streak[signal] = 0
                self._normal[signal] += 1
                if (
                    signal in self._flagged
                    and self._normal[signal] >= self.sustain
                ):
                    self._flagged.discard(signal)
                    self._publish(signal, 0.0)
            flagged = signal in self._flagged
        if fired is not None and self.on_flag is not None:
            try:
                self.on_flag(signal, fired[0], fired[1])
            except Exception:  # noqa: BLE001 — detection must not break serving
                pass
        return flagged

    def _publish(self, signal: str, value: float) -> None:
        if self.metrics is not None:
            self.metrics.set_gauge(
                "app_llm_anomaly", value, model=self.label, signal=signal
            )

    def flagged(self) -> list[str]:
        with self._lock:
            return sorted(self._flagged)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                s: {
                    "flagged": s in self._flagged,
                    "streak": self._streak[s],
                    "baseline_mean": (
                        self._baseline[s].mean() if len(self._baseline[s]) else None
                    ),
                    "baseline_samples": len(self._baseline[s]),
                    "last": self._last.get(s),
                }
                for s in ANOMALY_SIGNALS
            }

    def zero_gauges(self) -> None:
        """close()/_die(): a dead engine must not hold an anomaly flag
        (the dead-engine-gauge regression class), and a restarted one
        starts against a fresh baseline."""
        with self._lock:
            self._flagged.clear()
            for s in ANOMALY_SIGNALS:
                self._streak[s] = 0
                self._normal[s] = 0
                self._baseline[s].clear()
        if self.metrics is not None:
            for s in ANOMALY_SIGNALS:
                self._publish(s, 0.0)
