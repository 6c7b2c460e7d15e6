"""Replica supervisor: rebuild dead replicas behind the canary gate, with
the device-health ledger's judgment (counterpart of
gofr_tpu/resilience/supervisor.py).

Every death is classified and billed to the device the replica ran on
(``DeviceHealthLedger``). A dead slot is rebuilt after a capped
exponential backoff (``backoff_s`` doubling to ``backoff_max_s``) where
the fleet's placement says (``fleet._spec_for_rebuild``: its home seat, or
an alternate; None parks the slot, visibly, until a device is usable
again), and the replacement enters routing only after
``fleet._canary_check`` passes; a passing probe reintegrates a device on
probation. ``TPU_LLM_RESTART_MAX_ATTEMPTS`` (8; 0 unlimited) consecutive
failed rebuilds fail the slot for good. A draining fleet never rebuilds,
and a slot the rollout controller holds (``fleet._rollout_hold``: drained
and closed on purpose, mid-shift or mid-rollback) is neither rebuilt nor
billed. The fleet owns construction and placement; the supervisor owns
when, and the slot state machine.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = ["ReplicaSupervisor"]


class ReplicaSupervisor:
    """Monitor thread over a ``ReplicatedLLMEngine``'s slots."""

    def __init__(
        self, fleet, *, interval_s: float = 0.5, backoff_s: float = 1.0, backoff_max_s: float = 30.0,
        max_attempts: int | None = None,
    ):
        self.fleet = fleet
        self.interval = interval_s
        self.backoff0 = backoff_s
        self.backoff_max = backoff_max_s
        if max_attempts is None:
            max_attempts = int(os.environ.get("TPU_LLM_RESTART_MAX_ATTEMPTS", "8") or 0)
        self.max_attempts = max(0, max_attempts)  # 0 = unlimited
        self.restarts = 0
        self.restart_failures = 0
        self.canary_rejects = 0  # rebuilds the gate kept out of routing
        self.rebuild_s: list[float] = []  # build + canary seconds of each restart
        self._stop = False
        # per slot: {"backoff", "next_try", "failures", "parked", "failed", "reason"}
        self._state: dict[int, dict] = {}
        self._thread = threading.Thread(target=self._run, name="llm-torch-supervisor", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop:
            try:
                self._scan()
            except Exception as e:  # noqa: BLE001 — the supervisor must survive
                log = getattr(self.fleet, "logger", None)
                if log is not None:
                    log.error(f"replica supervisor scan failed: {e!r}")
            time.sleep(self.interval)

    def _scan(self) -> None:
        fleet = self.fleet
        if self._stop or getattr(fleet, "_draining", False):
            return
        now = time.perf_counter()
        health = getattr(fleet, "health", None)
        hold = getattr(fleet, "_rollout_hold", ())
        for i, eng in enumerate(list(fleet.engines)):
            if i in hold:
                continue
            if eng.alive():
                self._state.pop(i, None)
                continue
            st = self._state.get(i)
            if st is None:
                st = {"backoff": self.backoff0, "next_try": now + self.backoff0, "failures": 0, "parked": False,
                      "failed": False, "reason": None}
                self._state[i] = st
                # bill the device the replica actually ran on
                if health is not None:
                    why = getattr(eng, "died_reason", None)
                    health.record_failure(fleet._current_keys[i], health.classify(why), detail=why or "")
            if st["failed"]:
                continue
            if st["parked"]:
                # leave the parking lot the moment any placement exists
                if fleet._spec_for_rebuild(i) is None:
                    continue
                st["parked"] = False
                st["reason"] = None
                st["next_try"] = now
            if now < st["next_try"]:
                continue
            self._rebuild(i, st)

    def _rebuild(self, i: int, st: dict) -> None:
        fleet = self.fleet
        log = getattr(fleet, "logger", None)
        picked = fleet._spec_for_rebuild(i)
        if picked is None:
            st["parked"] = True
            st["reason"] = "parked: no usable device (home quarantined, no alternate)"
            if log is not None:
                log.error(f"replica {i} parked: no usable device for rebuild")
            return
        spec, key = picked
        if log is not None:
            home = key == fleet._device_keys[i]
            log.warn(f"replica supervisor: rebuilding dead replica {i} on {key}{'' if home else ' (alternate device)'}")
        t0 = time.perf_counter()
        try:
            replacement = fleet._build_replica(i, spec=spec)
        except Exception as e:  # noqa: BLE001 — the device may still be sick
            self._rebuild_failed(i, st, key, f"build failed: {e!r}")
            return
        try:
            ok, detail = fleet._canary_check(replacement)
        except Exception as e:  # noqa: BLE001 — a crashing gate must not leak the engine
            ok, detail = False, f"canary crashed: {e!r}"
        if not ok:
            self.canary_rejects += 1
            try:
                replacement.close()
            except Exception:  # noqa: BLE001 — teardown must not mask the verdict
                pass
            self._rebuild_failed(i, st, key, f"canary rejected: {detail}")
            return
        if (self._stop or getattr(fleet, "_draining", False) or i in getattr(fleet, "_rollout_hold", ())
                or fleet.engines[i].alive()):
            # raced a close or a drain, the rollout controller claimed the
            # slot, or it is live again: the replacement must neither be
            # routed nor leak
            replacement.close()
            self._state.pop(i, None)
            return
        fleet._settle(i, replacement, spec, key)
        health = getattr(fleet, "health", None)
        if health is not None:
            health.probe_ok(key)
        self._state.pop(i, None)
        self.restarts += 1
        self.rebuild_s.append(time.perf_counter() - t0)
        if log is not None:
            log.info(f"replica {i} restarted on {key} and routed back in {self.rebuild_s[-1]:.1f}s")

    def _rebuild_failed(self, i: int, st: dict, key: str, why: str) -> None:
        log = getattr(self.fleet, "logger", None)
        self.restart_failures += 1
        st["failures"] += 1
        health = getattr(self.fleet, "health", None)
        if health is not None:
            health.record_failure(key, "rebuild_failure", detail=why)
        if self.max_attempts and st["failures"] >= self.max_attempts:
            st["failed"] = True
            st["reason"] = f"permanently failed after {st['failures']} rebuild attempts (last: {why})"
            if log is not None:
                log.error(f"replica {i} {st['reason']}")
            return
        st["backoff"] = min(st["backoff"] * 2.0, self.backoff_max)
        st["next_try"] = time.perf_counter() + st["backoff"]
        if log is not None:
            log.error(f"replica {i} rebuild on {key} failed ({why}); next attempt in {st['backoff']:.1f}s")

    def parked_count(self) -> int:
        return sum(1 for st in list(self._state.values()) if st.get("parked"))

    def failed_count(self) -> int:
        return sum(1 for st in list(self._state.values()) if st.get("failed"))

    def snapshot(self) -> dict:
        per_slot = {}
        for i, st in list(self._state.items()):
            row = {
                "backoff_s": round(st["backoff"], 2), "failures": st["failures"],
                "retry_in_s": round(max(0.0, st["next_try"] - time.perf_counter()), 2),
                "parked": st["parked"], "failed": st["failed"],
            }
            if st.get("reason"):
                row["reason"] = st["reason"]
            per_slot[i] = row
        return {
            "restarts": self.restarts, "restart_failures": self.restart_failures,
            "canary_rejects": self.canary_rejects, "max_attempts": self.max_attempts,
            "parked": self.parked_count(), "failed": self.failed_count(), "interval_s": self.interval,
            "pending": per_slot,
        }

    def close(self, timeout: float = 120.0) -> None:
        """Stop scanning; a rebuild under way finishes (and its replacement
        is closed) first, so no build outlives its fleet on the card."""
        self._stop = True
        self._thread.join(timeout=timeout)
