"""Deterministic fault injection for the serving path (counterpart of
gofr_tpu/resilience/faults.py, copied: the port imports nothing of the
JAX package).

The recovery code of ``gofr_tpu_torch.llm`` (per-iteration scheduler
recovery, collector fetch retries, replica failover, the step watchdog,
supervised restart) never runs in a healthy process: a card does not
fault on demand, and a real CUDA fault poisons the whole process. The
injector gives every recovery path a named, countable, host-side trigger.

Named failure points (armed per point, optionally per engine label):

- ``device_step``    — raise ``InjectedFault`` at the next dispatch
                       (scheduler side: per-iteration recovery). Armed
                       with a ``tag`` it fires only for a resident request
                       whose ``GenRequest.tag`` equals it, and kills that
                       replica (the poison payload).
- ``step_latency``   — sleep ``delay`` seconds inside the next fetch
                       (collector side, inside the fetch heartbeat, outside
                       the engine lock: a hung step, the watchdog's prey).
- ``admission_oom``  — raise at the next admission before any request is
                       pulled from the queue.
- ``replica_kill``   — the next scheduler pass calls ``_die``.
- ``overload_pressure`` — the next submit() sees a predicted queue wait of
                       ``delay`` seconds (default 3600).
- ``nan_logits``     — corrupt one fetched program's first live lane with
                       the numerical-watchdog sentinel -1 (what NaN logits
                       produce on the card).
- ``device_sick``    — raise at a replica (re)build on a matching device
                       key ("cuda:0"); count=-1 models a card that fails
                       every rebuild.
- ``rollout_canary_fail`` — the rollout controller's admission gate
                       rejects the next candidate as if its canary or
                       shadow probe diverged (``resilience.rollout``).
- ``rollout_bake_regression`` — the next bake-window poll of a rollout
                       sees a regression, whatever the fleet's health.

Arming: ``injector.arm(point, ...)``, or ``TPU_LLM_FAULTS`` for a black-box
process: a comma list of ``point[=count[:delay_s]][@label]`` entries parsed
once when the process-default injector is first built, e.g.
``TPU_LLM_FAULTS="replica_kill=1,step_latency=1:5.0,device_sick=3@cuda:0"``.
A disarmed injector costs one dict lookup per check.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

__all__ = ["FaultInjector", "InjectedFault", "default_injector", "FAULT_POINTS"]

FAULT_POINTS = (
    "device_step",
    "step_latency",
    "admission_oom",
    "replica_kill",
    "overload_pressure",
    "nan_logits",
    "device_sick",
    "rollout_canary_fail",
    "rollout_bake_regression",
)


class InjectedFault(RuntimeError):
    """Raised by an armed raise-kind failure point; recovery treats it like
    any other device error."""


@dataclass
class _Spec:
    point: str
    count: int = 1  # fires remaining; <0 = unlimited
    # exact label or suffix ("/r1" matches "llm/r1", not "llm/r10");
    # None = any engine
    label: str | None = None
    delay: float = 0.0  # step_latency sleep seconds
    message: str = ""
    # poison-payload marker: a tagged spec fires only for a take() with
    # the same tag, an untagged one only for tagless takes
    tag: str | None = None

    def matches(self, label: str) -> bool:
        return self.label is None or label == self.label or label.endswith(self.label)


class FaultInjector:
    """Thread-safe registry of armed failure points. Engines hold one (the
    process default unless a test passes its own) and call :meth:`take`
    at each seam; a hit decrements the armed count and is tallied in
    :meth:`fired`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: dict[str, list[_Spec]] = {}
        self._fired: dict[str, int] = {}

    def arm(
        self, point: str, *, count: int = 1, label: str | None = None, delay: float = 0.0,
        message: str = "", tag: str | None = None,
    ) -> None:
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}; known: {FAULT_POINTS}")
        spec = _Spec(point=point, count=count, label=label, delay=delay,
                     message=message or f"injected fault: {point}", tag=tag)
        with self._lock:
            self._armed.setdefault(point, []).append(spec)

    def disarm(self, point: str | None = None) -> None:
        with self._lock:
            if point is None:
                self._armed.clear()
            else:
                self._armed.pop(point, None)

    def take(self, point: str, label: str = "", tag: str | None = None) -> _Spec | None:
        """One seam check: the first armed spec of ``point`` matching this
        engine label and tag population fires (its count decrements); None
        when nothing is armed."""
        if not self._armed:  # benign race: worst case one extra locked check
            return None
        with self._lock:
            specs = self._armed.get(point)
            if not specs:
                return None
            for spec in specs:
                if spec.tag != tag or not spec.matches(label) or spec.count == 0:
                    continue
                if spec.count > 0:
                    spec.count -= 1
                self._fired[point] = self._fired.get(point, 0) + 1
                if spec.count == 0:
                    specs.remove(spec)
                    if not specs:
                        del self._armed[point]
                return spec
            return None

    def fired(self, point: str | None = None) -> int:
        with self._lock:
            if point is not None:
                return self._fired.get(point, 0)
            return sum(self._fired.values())

    def has_tagged(self, point: str) -> bool:
        """Any tagged spec armed for ``point``? (the poison seam's
        one-lookup pre-check)"""
        if not self._armed:
            return False
        with self._lock:
            return any(s.tag for s in self._armed.get(point, ()))

    def snapshot(self) -> dict:
        def row(s: _Spec) -> dict:
            out = {"count": s.count, "label": s.label, "delay": s.delay}
            if s.tag is not None:
                out["tag"] = s.tag
            return out

        with self._lock:
            return {
                "armed": {p: [row(s) for s in specs] for p, specs in self._armed.items()},
                "fired": dict(self._fired),
            }


@dataclass
class _DefaultHolder:
    injector: FaultInjector | None = None
    lock: threading.Lock = field(default_factory=threading.Lock)


_default = _DefaultHolder()


def _arm_from_env(inj: FaultInjector, raw: str, logger=None) -> None:
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        # the label first: device keys ("cuda:0") hold the count/delay separator
        body, _, label = part.partition("@")
        point, _, rest = body.partition("=")
        count, delay = 1, 0.0
        if rest:
            cnt, _, d = rest.partition(":")
            try:
                count = int(cnt)
                if d:
                    delay = float(d)
            except ValueError:
                if logger is not None:
                    logger.warn(f"TPU_LLM_FAULTS: unparseable entry {part!r}")
                continue
        try:
            inj.arm(point.strip(), count=count, delay=delay, label=label.strip() or None)
        except ValueError as e:
            if logger is not None:
                logger.warn(f"TPU_LLM_FAULTS: {e}")


def default_injector() -> FaultInjector:
    """Process-default injector, armed once from ``TPU_LLM_FAULTS``."""
    if _default.injector is None:
        with _default.lock:
            if _default.injector is None:
                inj = FaultInjector()
                raw = os.environ.get("TPU_LLM_FAULTS", "")
                if raw:
                    _arm_from_env(inj, raw)
                _default.injector = inj
    return _default.injector


def sleep_for(spec: _Spec) -> None:
    """Serve a step_latency spec: a plain blocking host sleep."""
    if spec.delay > 0:
        time.sleep(spec.delay)
