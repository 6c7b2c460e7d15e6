"""Metrics: manager, instruments and the Prometheus / OpenMetrics text
exposition (counterpart of gofr_tpu/metrics/__init__.py, copied: the port
imports nothing of the JAX package).

``Manager`` registers counters, up-down counters, gauges and histograms by
name and renders them (``render_prometheus``, ``render_openmetrics`` with
histogram exemplars). ``RollingWindow`` keeps recent observations with
exact percentiles (``summarize_window``); the anomaly detectors of
``flightrec`` read its means. Instruments are lock-light: one small lock
a series map.

``slo`` holds the SLO engine (``SLOPolicy``, ``SLOTracker``). The engine,
the KV cache manager, the resilience code, the goodput ledger and the
flight recorder register their series on a ``Manager`` they are handed;
``server.MetricsServer`` serves the exposition on the App's METRICS_PORT.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Iterable

from ..logging import Logger

DEFAULT_HISTOGRAM_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10,
)
# HTTP server and outbound-service latencies (app_http_response,
# app_http_service_response)
HTTP_BUCKETS = (0.001, 0.003, 0.005, 0.01, 0.02, 0.03, 0.05, 0.1, 0.2, 0.3, 0.5, 0.75, 1, 2, 3, 5, 10, 30)
# datasource op latencies, 50 us .. 10 ms (app_sql_stats, app_redis_stats)
DATASOURCE_BUCKETS = (0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.002, 0.003, 0.005, 0.0075, 0.01)
# device-program latencies, 100 us .. 5 s (the engine's phase histograms)
TPU_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, description: str):
        self.name = name
        self.description = description
        self._lock = threading.Lock()
        self._series: dict[tuple[tuple[str, str], ...], float] = {}

    def _bump(self, delta: float, labels: dict[str, str]) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + delta

    def _set(self, value: float, labels: dict[str, str]) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = value

    def collect(self) -> Iterable[tuple[str, dict[str, str], float]]:
        with self._lock:
            items = list(self._series.items())
        for key, value in items:
            yield self.name, dict(key), value


class Counter(_Instrument):
    kind = "counter"

    def increment(self, by: float = 1.0, **labels: str) -> None:
        self._bump(by, labels)


class UpDownCounter(_Instrument):
    kind = "gauge"  # prometheus has no native updown; exposed as gauge

    def delta(self, by: float, **labels: str) -> None:
        self._bump(by, labels)


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        self._set(value, labels)


class Histogram:
    kind = "histogram"

    def __init__(self, name: str, description: str, buckets: tuple[float, ...]):
        self.name = name
        self.description = description
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        # per label-set: [bucket counts..., +inf count], sum, count
        self._series: dict[tuple[tuple[str, str], ...], list] = {}
        # per label-set: bucket index -> (exemplar labels, value, unix ts) —
        # last-wins, bounded by (label sets x buckets), so a percentile on
        # the exposition always links the most recent trace that landed in
        # that bucket (OpenMetrics exemplars).
        self._exemplars: dict[tuple[tuple[str, str], ...], dict[int, tuple]] = {}

    def record(self, value: float, exemplar: dict | None = None, **labels: str) -> None:
        key = _label_key(labels)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._series[key] = s
            s[0][idx] += 1
            s[1] += value
            s[2] += 1
            if exemplar:
                self._exemplars.setdefault(key, {})[idx] = (
                    dict(exemplar), value, time.time(),
                )

    def collect_histogram(self):
        with self._lock:
            items = [(k, ([*v[0]], v[1], v[2])) for k, v in self._series.items()]
        return items

    def collect_exemplars(self):
        with self._lock:
            return {k: dict(v) for k, v in self._exemplars.items()}

    def percentile(self, q: float, **labels: str) -> float:
        """Approximate percentile from bucket midpoints (for health/bench)."""
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if not s:
                return 0.0
            counts, _, total = [*s[0]], s[1], s[2]
        if total == 0:
            return 0.0
        target = q * total
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target:
                if i < len(self.buckets):
                    return self.buckets[i]
                return self.buckets[-1]
        return self.buckets[-1]


def summarize_window(values: Iterable[float]) -> dict:
    """{count, p50, p99, max} over a sample list — exact order statistics,
    unlike Histogram.percentile's bucket-midpoint approximation. Used for
    the serving engine's recent-window phase summaries (stats()/debug)."""
    xs = sorted(values)
    if not xs:
        return {"count": 0, "p50": 0.0, "p99": 0.0, "max": 0.0}
    return {
        "count": len(xs),
        "p50": xs[len(xs) // 2],
        "p99": xs[min(len(xs) - 1, int(0.99 * len(xs)))],
        "max": xs[-1],
    }


class RollingWindow:
    """Fixed-size window of recent observations with exact percentiles.

    The Prometheus histograms are cumulative-forever; live debugging wants
    "what do the LAST few hundred requests look like" — this keeps that
    window in-process at deque-append cost (O(1), one small lock) so the
    serving hot loop can afford one observe() per phase transition.

    With `max_age_s` set the window is additionally time-bounded: each
    observation is timestamped and values older than the horizon fall out
    on read — the form the SLO burn-rate engine uses for its 5m/1h
    goodness windows (a quiet tenant's hour-old failures must stop
    burning budget once they age past the window).
    """

    def __init__(self, size: int = 512, max_age_s: float | None = None, clock=None):
        from collections import deque

        self._lock = threading.Lock()
        self._age = float(max_age_s) if max_age_s else None
        self._clock = clock if clock is not None else time.monotonic
        self._values: deque = deque(maxlen=size)
        self._sum = 0.0  # running sum -> O(1) mean() on the SLO hot path

    def observe(self, value: float) -> None:
        with self._lock:
            if (
                self._values.maxlen is not None
                and len(self._values) == self._values.maxlen
                and self._values
            ):
                evicted = self._values[0]
                self._sum -= evicted[1] if self._age is not None else evicted
            if self._age is None:
                self._values.append(value)
            else:
                self._values.append((self._clock(), value))
            self._sum += value

    def _trim_locked(self) -> None:
        if self._age is None:
            return
        horizon = self._clock() - self._age
        while self._values and self._values[0][0] < horizon:
            _, v = self._values.popleft()
            self._sum -= v

    def values(self) -> list[float]:
        with self._lock:
            self._trim_locked()
            if self._age is None:
                return list(self._values)
            return [v for _, v in self._values]

    def mean(self) -> float:
        with self._lock:
            self._trim_locked()
            n = len(self._values)
            return (self._sum / n) if n else 0.0

    def __len__(self) -> int:
        with self._lock:
            self._trim_locked()
            return len(self._values)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()
            self._sum = 0.0

    def summary(self) -> dict:
        return summarize_window(self.values())


class Manager:
    """Name->instrument registry."""

    def __init__(self, logger: Logger | None = None):
        self._logger = logger
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    def _register(self, name: str, inst):
        with self._lock:
            if name in self._instruments:
                if self._logger:
                    self._logger.warn(f"metric {name} already registered")
                return self._instruments[name]
            self._instruments[name] = inst
            return inst

    def has(self, name: str) -> bool:
        """Silent existence check — for idempotent framework registration
        paths (the WARN in _register is for USER double registration, the
        ERROR in _get for using an unregistered metric)."""
        with self._lock:
            return name in self._instruments

    def new_counter(self, name: str, description: str = "") -> Counter:
        return self._register(name, Counter(name, description))

    def new_updown_counter(self, name: str, description: str = "") -> UpDownCounter:
        return self._register(name, UpDownCounter(name, description))

    def new_gauge(self, name: str, description: str = "") -> Gauge:
        return self._register(name, Gauge(name, description))

    def new_histogram(
        self, name: str, description: str = "", buckets: tuple[float, ...] = DEFAULT_HISTOGRAM_BUCKETS
    ) -> Histogram:
        return self._register(name, Histogram(name, description, buckets))

    def _get(self, name: str, kind):
        inst = self._instruments.get(name)
        if inst is None or not isinstance(inst, kind):
            if self._logger:
                self._logger.error(f"metric {name} not registered as {kind.__name__}")
            return None
        return inst

    # Verb API: callers address instruments by name, so user code never
    # holds instrument objects.
    def increment_counter(self, name: str, by: float = 1.0, **labels: str) -> None:
        c = self._get(name, Counter)
        if c:
            c.increment(by, **labels)

    def delta_updown_counter(self, name: str, by: float, **labels: str) -> None:
        c = self._get(name, UpDownCounter)
        if c:
            c.delta(by, **labels)

    def record_histogram(self, name: str, value: float, exemplar: dict | None = None, **labels: str) -> None:
        h = self._get(name, Histogram)
        if h:
            h.record(value, exemplar=exemplar, **labels)

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        g = self._get(name, Gauge)
        if g:
            g.set(value, **labels)

    def histogram(self, name: str) -> Histogram | None:
        return self._get(name, Histogram)

    def gauge_total(self, name: str) -> float:
        """Sum of a gauge across its label sets (0.0 when unregistered).
        Silent like has(): framework health probes read engine gauges
        that only exist once an LLM is registered."""
        with self._lock:
            g = self._instruments.get(name)
        if not isinstance(g, Gauge):
            return 0.0
        return sum(value for _name, _labels, value in g.collect())

    # -- exposition --
    def render_prometheus(self) -> str:
        """Prometheus text format 0.0.4."""
        return self._render(openmetrics=False)

    def render_openmetrics(self) -> str:
        """OpenMetrics text: the 0.0.4 exposition plus histogram-bucket
        exemplars (`... # {trace_id="..."} value timestamp`) and the
        mandatory `# EOF` terminator. Exemplars are only legal on this
        content type, so the metrics server negotiates it via Accept —
        it is how a p99 bucket links back to a stitchable journey."""
        return self._render(openmetrics=True)

    def _render(self, openmetrics: bool) -> str:
        with self._lock:
            instruments = list(self._instruments.values())
        out: list[str] = []
        for inst in instruments:
            name = inst.name  # type: ignore[attr-defined]
            if inst.description:  # type: ignore[attr-defined]
                out.append(f"# HELP {name} {inst.description}")  # type: ignore[attr-defined]
            out.append(f"# TYPE {name} {inst.kind}")  # type: ignore[attr-defined]
            if isinstance(inst, Histogram):
                exemplars = inst.collect_exemplars() if openmetrics else {}
                for key, (counts, total_sum, count) in inst.collect_histogram():
                    base = dict(key)
                    ex = exemplars.get(key, {})
                    acc = 0
                    for i, (ub, c) in enumerate(zip(inst.buckets, counts)):
                        acc += c
                        line = _line(f"{name}_bucket", {**base, "le": _fmt(ub)}, acc)
                        if i in ex:
                            line += _exemplar_suffix(*ex[i])
                        out.append(line)
                    acc += counts[-1]
                    line = _line(f"{name}_bucket", {**base, "le": "+Inf"}, acc)
                    if len(inst.buckets) in ex:
                        line += _exemplar_suffix(*ex[len(inst.buckets)])
                    out.append(line)
                    out.append(_line(f"{name}_sum", base, total_sum))
                    out.append(_line(f"{name}_count", base, count))
            else:
                for mname, labels, value in inst.collect():  # type: ignore[attr-defined]
                    out.append(_line(mname, labels, value))
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n"


def _fmt(v: float) -> str:
    return f"{v:g}"


def _line(name: str, labels: dict[str, str], value) -> str:
    if labels:
        lab = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
        return f"{name}{{{lab}}} {_fmt(float(value))}"
    return f"{name} {_fmt(float(value))}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _exemplar_suffix(labels: dict, value: float, ts: float) -> str:
    lab = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return f" # {{{lab}}} {_fmt(float(value))} {ts:.3f}"


def new_metrics_manager(logger: Logger | None = None) -> Manager:
    return Manager(logger)
