"""Step watchdog: a hung step becomes a detectable death (counterpart of
gofr_tpu/resilience/watchdog.py).

Each engine thread wraps its blocking work in a :class:`Heartbeat` beat
(the dispatch on the scheduler, the fetch on the collector); the
:class:`StepWatchdog` thread samples both and, when one has been in flight
longer than the threshold (``step_watchdog_s`` / ``TPU_LLM_STEP_WATCHDOG_S``),
drives the engine's ``_die`` with a "step watchdog" reason and a bounded
lock wait: a hang inside a dispatch holds the engine lock, so ``_die`` then
only marks the engine dead and leaves its memory and its stuck thread
(Python cannot kill a thread blocked in C; the supervisor replaces the
replica). Beats wrap serving only, never the warmup's captures.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

__all__ = ["Heartbeat", "StepWatchdog"]


class Heartbeat:
    """One thread's operation in flight: (name, started at). Written by the
    engine thread and read by the watchdog without a lock: ``begin``
    publishes the time before the name, ``end`` retracts the name, and the
    reader starts from the name."""

    __slots__ = ("_name", "_t0")

    def __init__(self):
        self._name: str | None = None
        self._t0 = 0.0

    def begin(self, name: str) -> None:
        self._t0 = time.perf_counter()
        self._name = name

    def end(self) -> None:
        self._name = None

    @contextmanager
    def beat(self, name: str):
        self.begin(name)
        try:
            yield
        finally:
            self.end()

    def stalled(self) -> tuple[str | None, float]:
        """(operation name, seconds in flight), (None, 0.0) when idle."""
        name = self._name
        if name is None:
            return None, 0.0
        return name, time.perf_counter() - self._t0


class StepWatchdog:
    """Per-engine monitor thread over the engine's two heartbeats. Samples
    every threshold / 4 (capped at 1 s), so a hang becomes a death within
    threshold + one interval. One-shot: it exits after a trip."""

    def __init__(self, engine, threshold_s: float, *, interval_s: float | None = None):
        self.engine = engine
        self.threshold = float(threshold_s)
        self.interval = interval_s if interval_s is not None else max(0.01, min(self.threshold / 4.0, 1.0))
        self.trips = 0
        self._thread = threading.Thread(target=self._run, name="llm-torch-watchdog", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        eng = self.engine
        while not eng._stop:
            for hb in (eng._hb_dispatch, eng._hb_fetch):
                name, dt = hb.stalled()
                if name is not None and dt > self.threshold:
                    self._trip(name, dt)
                    return
            time.sleep(self.interval)

    def _trip(self, name: str, dt: float) -> None:
        eng = self.engine
        self.trips += 1
        if eng.logger is not None:
            eng.logger.error(
                f"LLM engine watchdog: {name} in flight {dt:.1f}s (threshold {self.threshold:.1f}s) — killing replica"
            )
        eng._die(
            f"step watchdog: {name} exceeded {self.threshold:.1f}s",
            lock_timeout=min(5.0, max(1.0, self.threshold)),
        )

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout=timeout)
