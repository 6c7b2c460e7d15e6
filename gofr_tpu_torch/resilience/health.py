"""Device health: the failure ledger, its quarantine state machine, and
the canary gate (counterpart of gofr_tpu/resilience/health.py, with device
keys for torch devices: "cuda:0", "cpu").

- :class:`DeviceHealthLedger` — a per-device sliding-window failure
  ledger. Replica deaths and rebuild failures are classified
  (``step_fault`` / ``watchdog_hang`` / ``numerical`` /
  ``rebuild_failure``) and recorded against the device the replica ran on;
  ``TPU_LLM_DEVICE_QUARANTINE_FAILURES`` (3) failures inside
  ``TPU_LLM_DEVICE_QUARANTINE_WINDOW_S`` (60) quarantine it. A quarantined
  device takes no rebuild until its cooldown (``TPU_LLM_DEVICE_COOLDOWN_S``,
  30, doubling at every re-trip up to 8x) has passed; it is then on
  PROBATION: a rebuild may use it behind the canary gate, whose verdict
  reintegrates it or re-quarantines it.
- :func:`canary_check` — the fixed greedy probe a rebuilt replica must
  pass before it is routed: token-equal to a healthy replica's output when
  one exists, else complete and inside the vocabulary (the
  numerical-watchdog sentinel -1 is not).

The ledger takes a ``now_fn`` so tests drive it with a fake clock.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = [
    "CANARY_MAX_NEW",
    "CANARY_PROMPT",
    "DeviceHealthLedger",
    "canary_check",
    "device_key",
    "spec_device_key",
]

FAILURE_REASONS = ("step_fault", "watchdog_hang", "numerical", "rebuild_failure", "unknown")

# the fixed greedy probe: one prefill chunk and one decode chunk
CANARY_PROMPT = (3, 1, 4, 1, 5, 9, 2, 6)
CANARY_MAX_NEW = 8


def device_key(dev) -> str:
    """Stable identity of one torch device: "cuda:<index>" (index 0 when
    unset) or "cpu"."""
    import torch

    dev = torch.device(dev)
    if dev.type == "cpu":
        return "cpu"
    return f"{dev.type}:{dev.index or 0}"


def spec_device_key(spec: dict) -> str:
    """Identity of the device a replica spec ({"device": ...}) pins to."""
    dev = spec.get("device")
    return device_key(dev) if dev is not None else "default"


class DeviceHealthLedger:
    """Sliding-window failure ledger with quarantine and probation states
    (``healthy``, ``quarantined``, ``probation``). Thread-safe; all
    mutation under one lock."""

    def __init__(
        self, *, failures: int | None = None, window_s: float | None = None, cooldown_s: float | None = None,
        cooldown_max_s: float | None = None, now_fn=time.monotonic, logger=None, metrics=None, model: str = "llm",
    ):
        if failures is None:
            failures = int(os.environ.get("TPU_LLM_DEVICE_QUARANTINE_FAILURES", "3"))
        if window_s is None:
            window_s = float(os.environ.get("TPU_LLM_DEVICE_QUARANTINE_WINDOW_S", "60"))
        if cooldown_s is None:
            cooldown_s = float(os.environ.get("TPU_LLM_DEVICE_COOLDOWN_S", "30"))
        if cooldown_max_s is None:
            cooldown_max_s = max(cooldown_s, 8 * cooldown_s)
        self.failures_limit = max(1, failures)
        self.window_s = max(0.001, window_s)
        self.cooldown_s = max(0.001, cooldown_s)
        self.cooldown_max_s = cooldown_max_s
        self.now = now_fn
        self.logger = logger
        # the quarantine counter and gauge (a fleet sets its manager)
        self.metrics = metrics
        self.model = model
        self.quarantines = 0  # trips, re-trips included
        self._lock = threading.Lock()
        # the incident seam (JAX health.py:159-165): ReplicatedLLMEngine
        # points it at a live replica's bundle dump; called outside the
        # lock with (device, reason), exceptions swallowed
        self.on_quarantine = None
        # per device: {"events": [(t, reason)], "state", "until", "cooldown",
        # "trips", "by_reason": {reason: n}}
        self._devices: dict[str, dict] = {}

    @staticmethod
    def classify(died_reason: str | None) -> str:
        """An engine's ``died_reason`` as a failure class."""
        if not died_reason:
            return "unknown"
        r = died_reason.lower()
        if r.startswith("step watchdog"):
            return "watchdog_hang"
        if r.startswith("numerical watchdog"):
            return "numerical"
        if "rebuild" in r or "canary" in r or "device_sick" in r:
            return "rebuild_failure"
        return "step_fault"

    def record_failure(self, device: str, reason: str, detail: str = "") -> bool:
        """Record one failure against ``device``; True when it newly trips
        (or re-trips) quarantine."""
        if reason not in FAILURE_REASONS:
            reason = "unknown"
        with self._lock:
            now = self.now()
            d = self._devices.setdefault(device, {
                "events": [], "state": "healthy", "until": 0.0, "cooldown": self.cooldown_s, "trips": 0,
                "by_reason": {},
            })
            d["by_reason"][reason] = d["by_reason"].get(reason, 0) + 1
            d["events"].append((now, reason))
            lo = now - self.window_s
            d["events"] = [e for e in d["events"] if e[0] >= lo]
            if d["state"] == "quarantined":
                # a failure while quarantined (a failed probe): re-trip with
                # a doubled cooldown
                d["cooldown"] = min(d["cooldown"] * 2.0, self.cooldown_max_s)
                d["until"] = now + d["cooldown"]
                d["trips"] += 1
                tripped = True
            elif len(d["events"]) >= self.failures_limit:
                d["state"] = "quarantined"
                d["until"] = now + d["cooldown"]
                d["trips"] += 1
                tripped = True
            else:
                tripped = False
            if tripped:
                self.quarantines += 1
        if tripped and self.logger is not None:
            self.logger.error(
                f"device {device} quarantined ({reason}: {detail or 'n/a'}; trip {self.quarantines}, "
                f"cooldown {self._devices[device]['cooldown']:.1f}s)"
            )
        if tripped and self.metrics is not None:
            self.metrics.increment_counter("app_llm_device_quarantines_total", model=self.model)
        if tripped and self.on_quarantine is not None:
            try:
                self.on_quarantine(device, f"{reason}: {detail or 'n/a'}")
            except Exception:  # noqa: BLE001 — incident capture is best-effort
                pass
        self._observe_gauge()
        return tripped

    def _observe_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.set_gauge("app_llm_devices_quarantined", float(self.quarantined_count()), model=self.model)

    def probe_ok(self, device: str) -> None:
        """A canary-gated rebuild on ``device`` passed: reintegrate it (a
        no-op for a healthy device)."""
        with self._lock:
            d = self._devices.get(device)
            back = d is not None and d["state"] == "quarantined"
            if back:
                d["state"] = "healthy"
                d["events"] = []
                d["cooldown"] = self.cooldown_s
        if back and self.logger is not None:
            self.logger.info(f"device {device} reintegrated (canary passed)")
        self._observe_gauge()

    def state(self, device: str) -> str:
        with self._lock:
            return self._state_locked(device)

    def _state_locked(self, device: str) -> str:
        d = self._devices.get(device)
        if d is None or d["state"] == "healthy":
            return "healthy"
        if self.now() >= d["until"]:
            return "probation"
        return "quarantined"

    def usable(self, device: str) -> bool:
        """May a rebuild target this device? Healthy, or on probation."""
        return self.state(device) != "quarantined"

    def quarantined_count(self) -> int:
        """Devices not healthy: quarantined, or on probation without a
        passing probe yet."""
        with self._lock:
            return sum(1 for k in self._devices if self._state_locked(k) != "healthy")

    def snapshot(self) -> dict:
        with self._lock:
            now = self.now()
            devices = {}
            for k, d in self._devices.items():
                st = self._state_locked(k)
                row = {
                    "state": st,
                    "recent_failures": len([e for e in d["events"] if e[0] >= now - self.window_s]),
                    "trips": d["trips"],
                    "by_reason": dict(d["by_reason"]),
                }
                if st == "quarantined":
                    row["cooldown_remaining_s"] = round(d["until"] - now, 2)
                devices[k] = row
            return {
                "quarantines": self.quarantines, "failures_limit": self.failures_limit,
                "window_s": self.window_s, "cooldown_s": self.cooldown_s, "devices": devices,
            }


def canary_check(
    candidate, reference_tokens: list[int] | None = None, *, prompt=CANARY_PROMPT, max_new: int = CANARY_MAX_NEW,
    timeout: float = 60.0,
) -> tuple[bool, str, list[int]]:
    """Run the fixed greedy probe on ``candidate`` (an engine not yet
    routed) and judge it: ``(ok, detail, tokens)``. With
    ``reference_tokens`` the tokens must equal them; without, the stream
    must be complete (``max_new`` tokens; the probe sets no eos) and inside
    the vocabulary."""
    from ..llm import GenRequest

    try:
        req = candidate.submit(GenRequest(list(prompt), max_new_tokens=max_new, temperature=0.0, eos_token=-1,
                                             probe=True))
        toks = req.tokens(timeout=timeout)
    except Exception as e:  # noqa: BLE001 — a crashing probe is the verdict
        return False, f"probe crashed: {e!r}", []
    if len(toks) != max_new:
        return False, f"probe stream incomplete ({len(toks)}/{max_new} tokens, finish={req.finish_reason!r})", toks
    vocab = getattr(getattr(candidate, "cfg", None), "vocab_size", None)
    if vocab is not None and any(t < 0 or t >= vocab for t in toks):
        return False, f"probe emitted out-of-vocabulary token: {toks}", toks
    if reference_tokens is not None and toks != list(reference_tokens):
        return False, f"probe diverged from healthy reference: {toks} != {list(reference_tokens)}", toks
    return True, "ok", toks
