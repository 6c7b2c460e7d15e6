"""Overload control's host state machines (counterpart of
gofr_tpu/resilience/overload.py, copied: the port imports nothing of the
JAX package). ``gofr_tpu_torch.llm.LLMEngine`` wires them through its
scheduler:

- :class:`FairLedger` — per-client virtual token counters ("Fairness in
  Serving Large Language Models", OSDI'24): every served token is billed
  to its client at ``tokens / weight``, and the engine orders its
  waiting queue by least-billed-first instead of FIFO, so a flood from
  one client cannot push another below its weighted share.
- :class:`OverloadController` — the degrade-then-shed state machine:
  predicted queue wait (queued tokens / measured throughput) above the
  brownout threshold for a sustained hold engages BROWNOUT (new
  batch-class requests get their ``max_new_tokens`` clamped — shorter
  answers, not errors); predicted wait above the shed threshold sheds
  with a computed Retry-After. Degrade, then shed, never collapse.

Both take a ``now_fn`` (the controller) or no clock at all (the ledger),
so tests drive them with faked clocks. :class:`RetryBudget` is the replica
fleet's token bucket that bounds router-side retries (``ReplicatedLLMEngine``).
Plain Python and ``threading``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

__all__ = ["FairLedger", "OverloadController", "RetryBudget"]


class FairLedger:
    """Per-client weighted virtual token counters (the VTC scheduler's
    ledger). ``charge(client, tokens)`` bills served work at
    ``tokens / weight``; the engine sorts its waiting queue by
    :meth:`counter` ascending, so the least-served client (in weighted
    terms) is admitted first.

    New-arrival rule: a client absent from the ledger (or idle long
    enough to be evicted) starts at the MINIMUM counter among clients
    with work currently waiting — an idle period must not bank unbounded
    credit, and a flood cannot be beaten by reconnecting under a fresh
    name with zero debt. ``touch()`` applies the same lift to a known
    client returning from idle.

    Bounded: at most ``max_clients`` entries, least-debt-evicted (NOT
    LRU: LRU would let a flooder spray spoofed ids to evict its own
    heavy counter and re-enter with laundered debt) — the ledger is an
    ordering heuristic, not an account book, and an evicted client
    simply re-enters under the new-arrival rule.
    """

    def __init__(
        self,
        weights: dict[str, float] | None = None,
        *,
        default_weight: float = 1.0,
        max_clients: int = 1024,
    ):
        self._lock = threading.Lock()
        self._weights = dict(weights or {})
        self._default_weight = max(1e-6, float(default_weight))
        self._max_clients = max(1, int(max_clients))
        self._served: OrderedDict[str, float] = OrderedDict()
        # clients with waiting work, per shard (one shard per replica —
        # a fleet-shared ledger unions them): refreshed wholesale by each
        # shard's scheduler pass rather than inc/dec bookkeeping, so a
        # missed exit path can never leak an "active" client forever
        self._active: dict[str, frozenset[str]] = {}

    def weight(self, client: str) -> float:
        w = self._weights.get(client, self._default_weight)
        return w if w > 0 else self._default_weight

    def set_weight(self, client: str, weight: float) -> None:
        with self._lock:
            self._weights[client] = max(1e-6, float(weight))

    def _active_union(self) -> set[str]:
        out: set[str] = set()
        for clients in self._active.values():
            out |= clients
        return out

    def _floor(self) -> float:
        """Min counter among clients with waiting work (0 when none)."""
        vals = [
            self._served[c] for c in self._active_union() if c in self._served
        ]
        return min(vals) if vals else 0.0

    def set_active(self, shard: str, clients: set[str]) -> None:
        """Refresh the waiting-client set for one shard (replica). The
        new-arrival floor considers the union across shards."""
        with self._lock:
            if clients:
                self._active[shard] = frozenset(clients)
            else:
                self._active.pop(shard, None)

    def touch(self, client: str) -> None:
        """A request from `client` entered a waiting queue: lift its
        counter to the active floor (new-arrival / return-from-idle
        rule) — an idle period banks no credit, and a flood cannot be
        beaten by reconnecting under a fresh name with zero debt."""
        with self._lock:
            floor = self._floor()
            cur = self._served.get(client)
            self._served[client] = floor if cur is None else max(cur, floor)
            self._served.move_to_end(client)
            while len(self._served) > self._max_clients:
                # evict the LEAST-debt entry, not the least-recently
                # touched one: LRU would let a flooder spray max_clients
                # spoofed ids to push its own heavy counter out and
                # re-enter at the floor with laundered debt. Least-debt
                # eviction discards exactly the entries whose loss is
                # free (a fresh client re-enters at the floor anyway)
                # and keeps the heavy hitters' history.
                victim = min(self._served, key=self._served.get)
                del self._served[victim]

    def charge(self, client: str, tokens: int) -> None:
        """Bill `tokens` of served work to `client` at its weight."""
        if tokens <= 0:
            return
        with self._lock:
            self._served[client] = (
                self._served.get(client, self._floor())
                + tokens / self.weight(client)
            )
            self._served.move_to_end(client)

    def counter(self, client: str) -> float:
        """The ordering key: weighted tokens served so far (new clients
        read the active floor, which is what touch() would set)."""
        with self._lock:
            v = self._served.get(client)
            return self._floor() if v is None else v

    def counters_for(self, clients: set[str]) -> dict[str, float]:
        """Bulk ordering keys under ONE lock acquisition with the floor
        computed once — the scheduler sorts its whole waiting queue per
        pass, and per-request counter() calls would contend the
        fleet-shared lock O(waiting x shards*clients) times."""
        with self._lock:
            floor = self._floor()
            return {c: self._served.get(c, floor) for c in clients}

    def debt_spread(self) -> float:
        """Max - min counter across clients with waiting work: 0 when
        service is perfectly balanced (or <2 active clients), growing as
        one backlogged client falls behind another. The
        app_llm_fairness_debt gauge."""
        with self._lock:
            vals = [
                self._served[c]
                for c in self._active_union()
                if c in self._served
            ]
            if len(vals) < 2:
                return 0.0
            return max(vals) - min(vals)

    def snapshot(self) -> dict:
        """debug_state()["fairness"] payload (bounded at 32 rows)."""
        with self._lock:
            active = self._active_union()
            vals = [self._served[c] for c in active if c in self._served]
            rows = sorted(self._served.items(), key=lambda kv: kv[1])
            return {
                "clients": len(self._served),
                "active": len(active),
                "debt_spread": (
                    max(vals) - min(vals) if len(vals) >= 2 else 0.0
                ),
                "counters": {c: round(v, 1) for c, v in rows[:32]},
                "weights": dict(self._weights),
            }


class RetryBudget:
    """Token bucket bounding router-side retries: ``rate`` tokens/s refill
    up to ``burst``; every retry (a failover re-dispatch, a replica death
    between pick and submit) must :meth:`take` one. An empty bucket
    surfaces the original error instead of retrying. ``rate=0`` with
    ``burst=0`` disables retries."""

    def __init__(self, rate: float = 1.0, burst: float = 10.0, *, now_fn=time.monotonic):
        self._lock = threading.Lock()
        self.rate = max(0.0, float(rate))
        self.burst = max(0.0, float(burst))
        self._now = now_fn
        self._tokens = self.burst
        self._last = self._now()

    def _refill(self, now: float) -> None:
        if self.rate > 0 and now > self._last:
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now

    def take(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill(self._now())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def remaining(self) -> float:
        with self._lock:
            self._refill(self._now())
            return self._tokens


class OverloadController:
    """Degrade-then-shed: the brownout/shed state machine one engine (or
    one fleet router) consults at every admission.

    Inputs are predicted queue wait estimates (seconds) fed through
    :meth:`observe`. Two thresholds, strictly ordered:

    - ``brownout_wait_s`` (< shed): predicted wait above it for
      ``brownout_hold_s`` CONTINUOUS seconds engages brownout — new
      batch-class requests get ``max_new_tokens`` clamped to
      ``brownout_max_new``. Below half the threshold for the same hold,
      brownout disengages (hysteresis: flapping at the boundary would
      alternate clamped and unclamped answers request-to-request).
    - ``shed_wait_s``: predicted wait above it sheds the request NOW
      with ``retry_after = predicted - shed_wait_s`` (the time the
      backlog needs to drain back under the threshold), floored at
      ``min_retry_after``.

    Either threshold can be 0 (disabled). A zero ``brownout_hold_s``
    engages/disengages instantly (how the faked-clock tests drive it).
    """

    def __init__(
        self,
        *,
        shed_wait_s: float = 0.0,
        brownout_wait_s: float = 0.0,
        brownout_max_new: int = 0,
        brownout_hold_s: float = 2.0,
        min_retry_after: float = 0.5,
        now_fn=time.monotonic,
    ):
        self.shed_wait_s = max(0.0, float(shed_wait_s))
        self.brownout_wait_s = max(0.0, float(brownout_wait_s))
        self.brownout_max_new = max(0, int(brownout_max_new))
        self.brownout_hold_s = max(0.0, float(brownout_hold_s))
        self.min_retry_after = max(0.0, float(min_retry_after))
        self._now = now_fn
        self._lock = threading.Lock()
        self._over_since: float | None = None
        self._under_since: float | None = None
        self.brownout = False
        self.brownout_entries = 0  # times brownout engaged (telemetry)

    def enabled(self) -> bool:
        return self.shed_wait_s > 0 or (
            self.brownout_wait_s > 0 and self.brownout_max_new > 0
        )

    def observe(self, wait_s: float | None) -> None:
        """Feed one predicted-wait sample; advances the brownout state
        machine. None (no throughput estimate yet) counts as no
        pressure."""
        if self.brownout_wait_s <= 0 or self.brownout_max_new <= 0:
            return
        w = wait_s or 0.0
        now = self._now()
        with self._lock:
            if not self.brownout:
                if w > self.brownout_wait_s:
                    if self._over_since is None:
                        self._over_since = now
                    if now - self._over_since >= self.brownout_hold_s:
                        self.brownout = True
                        self.brownout_entries += 1
                        self._under_since = None
                else:
                    self._over_since = None
            else:
                if w < 0.5 * self.brownout_wait_s:
                    if self._under_since is None:
                        self._under_since = now
                    if now - self._under_since >= self.brownout_hold_s:
                        self.brownout = False
                        self._over_since = None
                else:
                    self._under_since = None

    def clamp(self, max_new_tokens: int, priority: str) -> int:
        """Brownout degrade: batch-class requests get shorter answers
        while the mode holds; interactive requests are never clamped
        (their latency is the thing brownout exists to protect)."""
        if (
            self.brownout
            and priority == "batch"
            and self.brownout_max_new > 0
        ):
            return min(max_new_tokens, self.brownout_max_new)
        return max_new_tokens

    def should_shed(self, wait_s: float | None) -> float | None:
        """Returns the Retry-After seconds when `wait_s` crosses the
        shed threshold, else None. Shed fires only past the DEGRADE
        stage: with brownout configured, requests are shed only while
        brownout is already active (degrade, then shed)."""
        if self.shed_wait_s <= 0 or wait_s is None:
            return None
        if wait_s <= self.shed_wait_s:
            return None
        if self.brownout_wait_s > 0 and self.brownout_max_new > 0:
            if not self.brownout:
                return None  # still in (or entering) the degrade stage
        return max(self.min_retry_after, wait_s - self.shed_wait_s)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled(),
                "brownout": self.brownout,
                "brownout_entries": self.brownout_entries,
                "shed_wait_s": self.shed_wait_s,
                "brownout_wait_s": self.brownout_wait_s,
                "brownout_max_new": self.brownout_max_new,
            }
