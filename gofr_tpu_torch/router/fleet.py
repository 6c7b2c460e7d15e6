"""The front router's cached view of its engine processes (counterpart
of gofr_tpu/router/fleet.py).

A poll thread samples every backend's serving summary (``GET
/.well-known/debug/engine?serving=1``: the drain flag, queued tokens,
measured throughput, predicted wait) into plain fields on
:class:`Backend`; the request path reads the cached view plus a local
in-flight counter and never waits on a poll. The probes of one cycle run
concurrently under a cycle budget, so one wedged backend riding out its
socket timeout holds neither the view nor the autoscaler's tick. A
membership change (a launch, a drain, a death) rebuilds the rendezvous
ring over the accepting members only, so session affinity moves exactly
the keys that must move.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Callable

from ..service import CircuitBreaker, new_http_service
from .ring import HashRing

__all__ = ["Backend", "FleetView"]

_POLL_TIMEOUT_S = 5.0
# consecutive failed polls before a backend is down: one slow answer from
# a saturated engine must not flap it out of the ring (the data path's
# breaker catches a dead backend sooner)
_DOWN_AFTER_FAILURES = 2
# ceiling on one poll cycle: the cycle moves on once the healthy majority
# answered; a stuck probe finishes on its own pool thread
_POLL_CYCLE_BUDGET_S = 1.0


class Backend:
    """One engine process, as the router sees it."""

    def __init__(self, address: str, svc, *, managed: bool = False, proc=None):
        self.address = address.rstrip("/")
        self.svc = svc  # HTTPService with a per-backend circuit breaker
        self.managed = managed  # launched (and reaped) by the autoscaler
        self.proc = proc  # subprocess.Popen when managed
        self.alive = False  # the poll reached it
        self.draining = False  # the process reports a drain (or we asked for one)
        self.load_tokens = 0
        self.throughput_tok_s: float | None = None
        self.predicted_wait_s: float | None = None
        self.last_poll: float | None = None
        self.poll_failures = 0
        # requests dispatched since the last poll landed: the poll is the
        # truth, this keeps a burst from piling onto one backend between polls
        self.outstanding = 0
        # a 503's Retry-After: not routed here until it elapses
        self.cooldown_until = 0.0
        # a probe of this backend is still running past the cycle budget
        self.poll_inflight = False
        # the autoscaler's sticky drain intent: a lost drain POST must not
        # let the next poll (draining=False) void the scale-down
        self.drain_requested = False

    def breaker_open(self) -> bool:
        cb = self.svc.circuit
        return cb is not None and cb.state == "open"

    def accepting(self, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        return self.alive and not self.draining and not self.breaker_open() and now >= self.cooldown_until

    def effective_load(self) -> float:
        """Routing weight: the polled queued tokens plus a charge for the
        requests dispatched since."""
        return self.load_tokens + 64.0 * self.outstanding

    def snapshot(self) -> dict:
        return {
            "address": self.address,
            "alive": self.alive,
            "draining": self.draining,
            "accepting": self.accepting(),
            "breaker": self.svc.circuit.state if self.svc.circuit else "none",
            "managed": self.managed,
            "load_tokens": self.load_tokens,
            "outstanding": self.outstanding,
            "throughput_tok_s": self.throughput_tok_s,
            "predicted_wait_s": self.predicted_wait_s,
            "pool": self.svc.pool_stats(),
        }


class FleetView:
    """Polled membership and load, shared by the proxy path and the
    autoscaler. Mutation happens under one lock; the request path reads the
    atomically swapped ring and the per-backend fields."""

    def __init__(
        self,
        *,
        logger=None,
        metrics=None,
        poll_interval_s: float = 0.5,
        breaker_failures: int = 3,
        breaker_interval_s: float = 1.0,
        now_fn: Callable[[], float] = time.monotonic,
        service_factory=None,
    ):
        self.logger = logger
        self.metrics = metrics
        self.poll_interval_s = max(0.05, float(poll_interval_s))
        self._breaker_failures = breaker_failures
        self._breaker_interval_s = breaker_interval_s
        self._now = now_fn
        self._service_factory = service_factory or self._default_service
        self._lock = threading.Lock()
        self._backends: dict[str, Backend] = {}
        self.ring = HashRing()
        self._ring_epoch = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._tick_hooks: list[Callable[[], None]] = []
        self._probe_pool: concurrent.futures.ThreadPoolExecutor | None = None

    def _default_service(self, address: str):
        return new_http_service(
            address, self.logger, self.metrics,
            CircuitBreaker(threshold=self._breaker_failures, interval=self._breaker_interval_s),
        )

    # -- membership --------------------------------------------------------
    def add(self, address: str, *, managed: bool = False, proc=None) -> Backend:
        address = address.rstrip("/")
        with self._lock:
            b = self._backends.get(address)
            if b is None:
                b = Backend(address, self._service_factory(address), managed=managed, proc=proc)
                self._backends[address] = b
            elif managed:
                b.managed, b.proc = True, proc
        return b

    def remove(self, address: str) -> None:
        with self._lock:
            b = self._backends.pop(address.rstrip("/"), None)
        if b is not None:
            b.svc.close()
            self._rebuild_ring()

    def backends(self) -> list[Backend]:
        with self._lock:
            return list(self._backends.values())

    def get(self, address: str) -> Backend | None:
        with self._lock:
            return self._backends.get(address.rstrip("/"))

    def accepting(self) -> list[Backend]:
        now = self._now()
        return [b for b in self.backends() if b.accepting(now)]

    def add_tick_hook(self, fn: Callable[[], None]) -> None:
        """Run `fn` after every poll cycle (the autoscaler's tick)."""
        self._tick_hooks.append(fn)

    # -- polled state ------------------------------------------------------
    def poll_once(self) -> None:
        """Probe every backend concurrently and fold in what lands within
        the cycle budget; a probe still running skips this cycle."""
        futs = []
        for b in self.backends():
            if b.poll_inflight:
                continue
            b.poll_inflight = True
            futs.append(self._pool().submit(self._probe_task, b))
        if futs:
            concurrent.futures.wait(futs, timeout=_POLL_CYCLE_BUDGET_S)
        self._rebuild_ring()
        self._export_gauges()

    def _probe_task(self, b: Backend) -> None:
        try:
            self._poll_backend(b)
        finally:
            b.poll_inflight = False

    def _pool(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._probe_pool is None:
            self._probe_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=16, thread_name_prefix="router-fleet-probe"
            )
        return self._probe_pool

    def _poll_backend(self, b: Backend) -> None:
        """One request per backend per cycle: the serving summary, which
        carries the drain flag, so readiness and load arrive together."""
        try:
            dbg = b.svc.request(
                "GET", "/.well-known/debug/engine", params={"serving": "1"},
                timeout=_POLL_TIMEOUT_S, _health_probe=True,
            ).json()
        except Exception:  # noqa: BLE001 — unreachable backend
            b.poll_failures += 1
            if b.poll_failures >= _DOWN_AFTER_FAILURES:
                b.alive = False
            b.last_poll = self._now()
            return
        dbg = dbg.get("data", dbg)  # the handler's success envelope
        serving = dbg.get("serving") or {}
        b.alive = True
        b.poll_failures = 0
        b.draining = bool(serving.get("draining")) or b.drain_requested
        b.load_tokens = int(serving.get("load_tokens") or 0)
        b.throughput_tok_s = serving.get("throughput_tok_s")
        b.predicted_wait_s = serving.get("predicted_wait_s")
        b.outstanding = 0  # the poll folds in everything dispatched before it
        b.last_poll = self._now()

    def _rebuild_ring(self) -> None:
        """The ring over the accepting members, swapped on a change: a
        draining, dead or breaker-open member leaves it and its sessions
        re-home (re-prefill on the new owner, never an error)."""
        members = tuple(sorted(b.address for b in self.accepting()))
        if members != self.ring.members:
            self.ring = HashRing(sorted(members))
            self._ring_epoch += 1

    def ring_epoch(self) -> int:
        return self._ring_epoch

    # -- aggregates (the router's admission inputs) ------------------------
    def pooled_predicted_wait_s(self) -> float | None:
        """The fleet's predicted queue wait: queued tokens over pooled
        measured throughput, priced as one engine prices its own."""
        load = 0
        tput = 0.0
        for b in self.accepting():
            load += b.load_tokens + int(64 * b.outstanding)
            if b.throughput_tok_s:
                tput += b.throughput_tok_s
        if tput <= 1e-9:
            return None
        return load / tput

    def pooled_throughput_tok_s(self) -> float | None:
        tput = sum(b.throughput_tok_s or 0.0 for b in self.accepting())
        return tput if tput > 1e-9 else None

    def _export_gauges(self) -> None:
        if self.metrics is None:
            return
        bs = self.backends()
        now = self._now()
        self.metrics.set_gauge("app_router_backends", float(len(bs)), state="known")
        self.metrics.set_gauge("app_router_backends", float(sum(b.accepting(now) for b in bs)), state="accepting")
        self.metrics.set_gauge("app_router_backends", float(sum(b.draining for b in bs)), state="draining")
        self.metrics.set_gauge("app_router_backends", float(sum(not b.alive for b in bs)), state="down")
        self.metrics.set_gauge("app_router_fleet_load_tokens", float(sum(b.load_tokens for b in bs)))
        wait = self.pooled_predicted_wait_s()
        self.metrics.set_gauge("app_router_predicted_wait_s", float(wait or 0.0))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name="router-fleet-poll", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the poll must never die
                if self.logger is not None:
                    self.logger.error(f"fleet poll failed: {e!r}")
            for hook in self._tick_hooks:
                try:
                    hook()
                except Exception as e:  # noqa: BLE001
                    if self.logger is not None:
                        self.logger.error(f"fleet tick hook failed: {e!r}")
            self._stop.wait(self.poll_interval_s)

    def restart_after_fork(self) -> None:
        """A forked worker inherits the Thread object but not the thread:
        drop it (and the probe pool, whose dead workers would still count
        against its max) and start a fresh poll loop in this process."""
        if self._thread is not None and not self._thread.is_alive():
            self._thread = None
        self._probe_pool = None
        for b in self.backends():
            b.poll_inflight = False
        self.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._probe_pool is not None:
            self._probe_pool.shutdown(wait=False, cancel_futures=True)
            self._probe_pool = None
        for b in self.backends():
            b.svc.close()

    def snapshot(self) -> dict:
        return {
            "backends": [b.snapshot() for b in self.backends()],
            "ring": list(self.ring.members),
            "ring_epoch": self._ring_epoch,
            "pooled_predicted_wait_s": self.pooled_predicted_wait_s(),
            "pooled_throughput_tok_s": self.pooled_throughput_tok_s(),
        }
