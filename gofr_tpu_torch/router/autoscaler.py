"""Autoscaler: grow and shrink the engine-process fleet from the signals
the admission ladder sheds on (counterpart of gofr_tpu/router/autoscaler.py).

A sustained pooled backlog (or a router shed) launches another engine
process; sustained calm drains one. Both transitions are slow on
purpose (hold + cooldown): capacity costs a warmup on the way up and KV
re-prefills on the way down. Scale-down is the graceful drain across a
process boundary: the victim leaves the ring first, a ``POST
/.well-known/debug/drain`` flips its readiness, in-flight streams finish
on the old process, and it is reaped once it has exited (or after a grace
window). A managed process that dies without a drain is reaped at the
next tick and the minimum relaunches it, at most once a cooldown.

Everything is injectable (clock, launcher, fleet), so the tests walk the
state machine with fakes.
"""

from __future__ import annotations

import os
import shlex
import socket
import subprocess
import sys
import threading
import time
from typing import Callable

__all__ = ["Autoscaler", "ProcessLauncher", "free_port", "DEFAULT_ENGINE_CMD"]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class ProcessLauncher:
    """Launch engine processes from a command template.

    ``cmd`` is a shell-style template with ``{port}`` and
    ``{metrics_port}`` placeholders (``TPU_ROUTER_ENGINE_CMD``), e.g.::

        python -m gofr_tpu_torch.router.engine_stub --port {port} --metrics-port {metrics_port}

    The process inherits the environment plus ``env``."""

    def __init__(self, cmd: str, *, logger=None, env: dict | None = None):
        self.cmd = cmd
        self.logger = logger
        self.env = env or {}

    def launch(self) -> tuple[str, subprocess.Popen]:
        port, metrics_port = free_port(), free_port()
        argv = [a.format(port=port, metrics_port=metrics_port) for a in shlex.split(self.cmd)]
        proc = subprocess.Popen(  # noqa: S603 — the operator's template
            argv, env={**os.environ, **self.env}, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
        )
        address = f"http://127.0.0.1:{port}"
        if self.logger is not None:
            self.logger.info(f"autoscaler launched engine pid={proc.pid} at {address}")
        return address, proc

    def reap(self, proc, *, grace_s: float = 10.0) -> None:
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=grace_s)


class Autoscaler:
    """Predicted-wait-driven replica count. ``tick()`` runs after every
    fleet poll; every transition lives here, so a fake clock walks it."""

    def __init__(
        self,
        fleet,
        launcher,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        up_wait_s: float = 2.0,
        down_wait_s: float = 0.25,
        hold_s: float = 3.0,
        cooldown_s: float = 10.0,
        drain_grace_s: float = 60.0,
        now_fn: Callable[[], float] = time.monotonic,
        shed_count_fn: Callable[[], int] | None = None,
        metrics=None,
        logger=None,
    ):
        self.fleet = fleet
        self.launcher = launcher
        self.min_replicas = max(0, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.up_wait_s = float(up_wait_s)
        self.down_wait_s = float(down_wait_s)
        self.hold_s = max(0.0, float(hold_s))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.drain_grace_s = float(drain_grace_s)
        self._now = now_fn
        self._shed_count = shed_count_fn or (lambda: 0)
        self.metrics = metrics
        self.logger = logger
        self._over_since: float | None = None
        self._under_since: float | None = None
        self._cooldown_until = 0.0
        self._sheds_seen = 0
        self._drain_started: dict[str, float] = {}  # address -> t
        self.scale_ups = 0
        self.scale_downs = 0
        self._closed = False
        # only the process that built the autoscaler scales: a forked
        # worker's fleet view does not track the parent's processes
        self._home_pid = os.getpid()

    # -- helpers -----------------------------------------------------------
    def _replicas(self) -> list:
        """The backends counted against the bounds: all but those leaving."""
        return [b for b in self.fleet.backends() if not b.draining]

    def ensure_min(self) -> None:
        while len(self._replicas()) < self.min_replicas and not self._closed:
            self._scale_up(reason="min_replicas")

    def _scale_up(self, reason: str) -> None:
        address, proc = self.launcher.launch()
        self.fleet.add(address, managed=True, proc=proc)
        self.scale_ups += 1
        self._cooldown_until = self._now() + self.cooldown_s
        if self.metrics is not None:
            self.metrics.increment_counter("app_router_autoscale_total", direction="up")
        if self.logger is not None:
            self.logger.info(f"autoscale up ({reason}): +{address}")

    def _scale_down(self, backend) -> None:
        # leave the ring before the drain POST; the intent is sticky, so a
        # lost POST does not void the scale-down
        backend.drain_requested = True
        backend.draining = True
        self.fleet._rebuild_ring()
        self._drain_started[backend.address] = self._now()
        self.scale_downs += 1
        self._cooldown_until = self._now() + self.cooldown_s
        if self.metrics is not None:
            self.metrics.increment_counter("app_router_autoscale_total", direction="down")
        if self.logger is not None:
            self.logger.info(f"autoscale down: draining {backend.address}")

        # on its own thread: tick() runs on the poll thread, which a victim
        # that stops answering would otherwise stall for the POST's timeout
        def _post(svc=backend.svc, addr=backend.address):
            try:
                svc.request("POST", "/.well-known/debug/drain", timeout=5.0, _health_probe=True)
            except Exception as e:  # noqa: BLE001 — an already-dead backend
                if self.logger is not None:
                    self.logger.warn(f"drain POST to {addr} failed: {e!r}")

        threading.Thread(target=_post, name="router-drain-post", daemon=True).start()

    def _reap_drained(self) -> None:
        """Remove drained backends whose process exited, or that outlived
        the grace window. Going unreachable does not shortcut the grace: a
        draining engine finishing its last streams can miss polls."""
        now = self._now()
        for b in self.fleet.backends():
            if not b.draining or not b.managed:
                continue
            started = self._drain_started.get(b.address)
            exited = b.proc is not None and b.proc.poll() is not None
            timed_out = started is not None and now - started > self.drain_grace_s
            if exited or timed_out:
                if not exited and self.launcher is not None:
                    # reap on every removal path, or a live process is orphaned
                    self.launcher.reap(b.proc)
                self.fleet.remove(b.address)
                self._drain_started.pop(b.address, None)
                if self.logger is not None:
                    self.logger.info(f"autoscaler reaped {b.address}")

    def _reap_crashed(self) -> None:
        """Collect managed engines that died without a drain (a kill, an
        out-of-memory, a segfault): ``poll()`` reaps the zombie, and the
        removal lets the minimum relaunch."""
        for b in self.fleet.backends():
            if not b.managed or b.draining or b.proc is None:
                continue
            if b.proc.poll() is not None:
                self.fleet.remove(b.address)
                if self.logger is not None:
                    self.logger.warn(f"autoscaler reaped crashed engine {b.address} (exit {b.proc.returncode})")

    # -- the state machine -------------------------------------------------
    def tick(self) -> None:
        if self._closed or os.getpid() != self._home_pid:
            return
        self._reap_drained()
        self._reap_crashed()
        now = self._now()
        wait = self.fleet.pooled_predicted_wait_s()
        sheds = self._shed_count()
        shed_delta = sheds - self._sheds_seen
        self._sheds_seen = sheds
        replicas = self._replicas()
        n = len(replicas)
        if self.metrics is not None:
            self.metrics.set_gauge("app_router_replicas", float(n))
        # the minimum holds continuously (a crash may have dropped below it
        # with no backlog); the cooldown makes a boot crash a slow retry
        if n < self.min_replicas and now >= self._cooldown_until:
            self._scale_up(reason="min_replicas")
            return
        # a router shed means demand already outran the fleet: no hold
        pressure = (wait or 0.0) > self.up_wait_s
        if pressure:
            if self._over_since is None:
                self._over_since = now
        else:
            self._over_since = None
        held_up = self._over_since is not None and now - self._over_since >= self.hold_s
        if (held_up or shed_delta > 0) and n < self.max_replicas:
            if now >= self._cooldown_until:
                self._scale_up(reason="shed" if shed_delta > 0 else "predicted_wait")
                self._over_since = None
            return
        # scale down only on sustained calm, and only a managed backend
        # (static members are the operator's)
        idle = wait is not None and wait < self.down_wait_s
        if wait is None:  # no throughput estimate: idle iff nothing queued
            idle = all(b.load_tokens == 0 and b.outstanding == 0 for b in replicas)
        if idle and n > self.min_replicas:
            if self._under_since is None:
                self._under_since = now
            if now - self._under_since >= self.hold_s and now >= self._cooldown_until:
                candidates = [b for b in replicas if b.managed and b.accepting(now)]
                if candidates:
                    victim = min(candidates, key=lambda b: b.effective_load())
                    self._scale_down(victim)
                    self._under_since = None
        else:
            self._under_since = None

    def snapshot(self) -> dict:
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "replicas": len(self._replicas()),
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "draining": sorted(self._drain_started),
            "up_wait_s": self.up_wait_s,
            "down_wait_s": self.down_wait_s,
        }

    def close(self, *, reap_managed: bool = True) -> None:
        """Stop scaling; optionally terminate every managed process."""
        self._closed = True
        if not reap_managed:
            return
        for b in self.fleet.backends():
            if b.managed and b.proc is not None:
                try:
                    self.launcher.reap(b.proc, grace_s=5.0)
                except Exception:  # noqa: BLE001 — teardown
                    pass


# the default TPU_ROUTER_ENGINE_CMD's engine: the stub over the tiny preset
DEFAULT_ENGINE_CMD = (
    f"{sys.executable} -m gofr_tpu_torch.router.engine_stub --port {{port}} --metrics-port {{metrics_port}}"
)
