"""Zero-downtime model rollouts: live weight reload, canary-gated traffic
shift, automatic rollback (counterpart of gofr_tpu/resilience/rollout.py,
copied: the port imports nothing of the JAX package).

- :class:`RolloutController` — the fleet's state machine (``shifting ->
  baking -> completed`` | ``rolling_back -> rolled_back``). One replica at
  a time it drains the replica (its in-flight requests finish on the old
  weights), closes it, rebuilds it on the staged version through the
  fleet's ``_build_replica``, gates the candidate (the
  ``rollout_canary_fail`` fault point, the canary probe against the
  version's reference, a shadow replay of recent real prompts judged for
  completeness and vocabulary, not equality) and only then routes it.
  After the last shift a bake window (``TPU_LLM_ROLLOUT_BAKE_S``) watches
  for a replica death, a request-error delta, a device quarantine or the
  ``rollout_bake_regression`` fault point; a trip rolls every upgraded
  slot back to the retained old version. The fleet always ends on ONE
  version.
- :class:`ModelHandle` — what ``GPURuntime.register_llm`` returns and
  ``llm(name)`` resolves: it proxies the engine's surface and adds
  ``deploy`` (the fleet's controller, or for a bare engine a blue-green
  swap: build beside, gate, repoint, drain the old one, bake, swap back on
  a regression), the canary-gated ``register_adapter`` and
  ``rollout_state``.
- Typed errors with an HTTP status: a malformed deploy is a 400 at the
  admin route, a concurrent one a 409.

A rollback dumps a ``rollback`` incident bundle (``flightrec``) from a
live replica before it converges. The JAX controller's ``app_llm_rollout*``
and ``app_llm_faults_injected`` series and its ``rollout.shadow_replay``
span come with the port's metrics and tracing (ROADMAP ID 10); each seam
is marked where it goes.
"""

from __future__ import annotations

import os
import re
import threading
import time

__all__ = ["ModelHandle", "RolloutController", "RolloutError", "RolloutInProgress", "shadow_probe"]


class RolloutError(RuntimeError):
    """A deploy that cannot be staged (bad arguments, a duplicate version
    label, no params): 400 at the admin route."""

    status_code = 400


class RolloutInProgress(RolloutError):
    """A deploy while another rollout shifts, bakes or rolls back: 409,
    retry once it is terminal."""

    status_code = 409


_ACTIVE_STATES = ("idle", "shifting", "baking", "rolling_back")

SHADOW_MAX_NEW = 8  # tokens per shadow replay (sanity, not equality)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _recent_distinct(ring, n: int) -> list[tuple]:
    """The ``n`` most recent distinct prompts of a shadow ring."""
    seen: list[tuple] = []
    for p in reversed(list(ring)):
        if p not in seen:
            seen.append(p)
        if len(seen) >= n:
            break
    return seen


def shadow_probe(candidate, prompts, *, max_new: int = SHADOW_MAX_NEW, timeout: float = 60.0,
                 adapter: str = "") -> tuple[bool, str]:
    """Replay a few real prompts on a not-yet-routed candidate and judge
    sanity only: each stream must complete (``max_new`` tokens; no eos is
    set) and stay inside the vocabulary (the numerical watchdog's sentinel
    -1 is outside it). Token equality is not checked: a new version
    answers differently. ``adapter`` replays through a staged LoRA adapter
    of a live engine. (JAX wraps the replay in a ``rollout.shadow_replay``
    span: ROADMAP ID 10.)"""
    from ..llm import GenRequest

    vocab = getattr(getattr(candidate, "cfg", None), "vocab_size", None)
    for n, prompt in enumerate(prompts):
        try:
            req = candidate.submit(GenRequest(
                list(prompt), max_new_tokens=max_new, temperature=0.0, eos_token=-1, adapter=adapter, probe=True,
            ))
            toks = req.tokens(timeout=timeout)
        except Exception as e:  # noqa: BLE001 — a crashing replay IS the verdict
            return False, f"shadow probe {n} crashed: {e!r}"
        if len(toks) != max_new:
            return False, (f"shadow probe {n} incomplete ({len(toks)}/{max_new} tokens, "
                           f"finish={req.finish_reason!r})")
        if vocab is not None and any(t < 0 or t >= vocab for t in toks):
            return False, f"shadow probe {n} emitted out-of-vocabulary token"
    return True, "ok"


class _RolloutBase:
    """The fleet controller's and the single-engine swap's shared state
    machine, history ring of 32 and bake-window watch."""

    def __init__(self, *, label: str, logger=None, bake_s: float | None = None, shadow_probes: int | None = None,
                 drain_timeout_s: float | None = None, interval_s: float = 0.05):
        self.label = label
        self.logger = logger
        self.bake_s = _env_float("TPU_LLM_ROLLOUT_BAKE_S", 5.0) if bake_s is None else max(0.0, float(bake_s))
        self.shadow_probes = (
            _env_int("TPU_LLM_ROLLOUT_SHADOW", 2) if shadow_probes is None else max(0, int(shadow_probes))
        )
        self.drain_timeout_s = (
            _env_float("TPU_LLM_ROLLOUT_DRAIN_S", 120.0) if drain_timeout_s is None
            else max(0.1, float(drain_timeout_s))
        )
        self.interval = interval_s
        self.state = "idle"
        self.error: str | None = None
        self.started_at: float | None = None
        self.finished_at: float | None = None
        self.canary_fails = 0
        self.shadow_fails = 0
        self._history: list[str] = []
        self._stop = False
        self._thread: threading.Thread | None = None
        self._fault_injector = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self.started_at = time.perf_counter()
        self._thread = threading.Thread(target=self._run_safe, name="llm-rollout", daemon=True)
        self._thread.start()

    def _run_safe(self) -> None:
        try:
            self._run()
        except Exception as e:  # noqa: BLE001 — a crashed controller must land terminal
            self.error = self.error or f"rollout controller crashed: {e!r}"
            if self.logger is not None:
                self.logger.error(f"rollout controller crashed: {e!r}")
            try:
                self._converge_after_crash()
            finally:
                if self.state in _ACTIVE_STATES:
                    self._finish("aborted")

    def _run(self) -> None:  # pragma: no cover — subclass responsibility
        raise NotImplementedError

    def _converge_after_crash(self) -> None:
        """Best-effort single-version convergence after an unexpected
        controller exception (the fleet controller overrides it)."""

    def active(self) -> bool:
        return self.state in _ACTIVE_STATES

    def close(self, timeout: float = 10.0) -> None:
        self._stop = True
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout)

    def wait(self, timeout: float = 120.0) -> str:
        """Block until the rollout is terminal (or ``timeout``); returns the
        state."""
        deadline = time.monotonic() + timeout
        while self.active() and time.monotonic() < deadline:
            time.sleep(0.01)
        return self.state

    # -- state and visibility --------------------------------------------------
    def _note(self, event: str) -> None:
        self._history.append(f"{time.strftime('%H:%M:%S')} {event}")
        del self._history[:-32]  # bounded debug ring
        if self.logger is not None:
            self.logger.info(f"rollout[{self.label}]: {event}")

    def _set_state(self, state: str) -> None:
        self.state = state
        self._note(f"state -> {state}")  # + the app_llm_rollout_state gauge (ROADMAP ID 10)

    def _finish(self, state: str) -> None:
        self.finished_at = time.perf_counter()
        self._set_state(state)  # + app_llm_rollouts_{state}_total (ROADMAP ID 10)

    def snapshot(self) -> dict:
        out = {
            "state": self.state,
            "from_version": self.from_version,
            "to_version": self.to_version,
            "bake_s": self.bake_s,
            "shadow_probes": self.shadow_probes,
            "canary_fails": self.canary_fails,
            "shadow_fails": self.shadow_fails,
            "error": self.error,
            "history": list(self._history),
        }
        if self.started_at is not None:
            end = self.finished_at or time.perf_counter()
            out["elapsed_s"] = round(end - self.started_at, 2)
        return out

    # -- shared mechanics ------------------------------------------------------
    def _injector(self):
        from .faults import default_injector

        return self._fault_injector if self._fault_injector is not None else default_injector()

    def _count_fault(self, point: str) -> None:
        if self.logger is not None:  # + app_llm_faults_injected_total (ROADMAP ID 10)
            self.logger.warn(f"fault injection: {point} fired on {self.label}")

    def _wait_drained(self, engine, deadline: float) -> bool:
        while not self._stop and time.perf_counter() < deadline:
            if not engine.alive() or engine.drained():
                return True
            time.sleep(self.interval)
        return not engine.alive() or engine.drained()

    def _shadow_gate(self, candidate, ring) -> tuple[bool, str]:
        """The shadow replay of the ring's most recent distinct prompts."""
        if self.shadow_probes > 0:
            seen = _recent_distinct(ring, self.shadow_probes)
            if seen:
                ok, detail = shadow_probe(candidate, seen)
                if not ok:
                    self.shadow_fails += 1
                    return False, detail
        return True, "ok"

    def _bake_watch(self, engines_fn, errored_baseline: int, quarantine_baseline: int) -> str | None:
        """Watch the shifted fleet for ``bake_s`` seconds: a regression
        reason, or None when the window passed clean. The signals: the
        ``rollout_bake_regression`` fault point, a replica death, a request
        finishing "error"/"poison" (``errored``), a device quarantine."""
        t_end = time.perf_counter() + self.bake_s
        while not self._stop and time.perf_counter() < t_end:
            if self._injector().take("rollout_bake_regression", self.label):
                self._count_fault("rollout_bake_regression")
                return "injected rollout_bake_regression"
            engines = engines_fn()
            dead = [e for e in engines if not e.alive()]
            if dead:
                why = getattr(dead[0], "died_reason", None) or "unknown"
                return f"replica death during bake ({why})"
            errored = sum(e.errored for e in engines)
            if errored > errored_baseline:
                return f"request errors during bake (+{errored - errored_baseline})"
            q = getattr(self, "_quarantines_fn", None)
            if q is not None and q() > quarantine_baseline:
                return "device quarantine during bake"
            time.sleep(self.interval)
        return None


class RolloutController(_RolloutBase):
    """Blue-green replica shift over a ``ReplicatedLLMEngine``: the fleet
    owns the versions registry (``fleet._versions[version] = (cfg,
    params)``, staged by ``fleet.deploy``) and the build and canary seams;
    the controller owns when, and the guarantee: one replica out of routing
    at a time, in-flight work finished on the old weights, every candidate
    gated before admission, and a fleet that ends on one version whichever
    step failed."""

    def __init__(self, fleet, to_version: str, **kw):
        super().__init__(label=fleet.label, logger=fleet.logger, **kw)
        self.fleet = fleet
        self.from_version = fleet.version
        self.to_version = to_version
        self.shifted = 0
        self.total = len(fleet.engines)
        self._fault_injector = fleet._engine_kw.get("fault_injector")
        self._quarantines_fn = lambda: fleet.health.quarantines

    def snapshot(self) -> dict:
        out = super().snapshot()
        out["shifted"] = self.shifted
        out["total"] = self.total
        return out

    # -- main sequence ----------------------------------------------------------
    def _run(self) -> None:
        fleet = self.fleet
        self._set_state("shifting")
        for i in range(len(fleet.engines)):
            if self._stop or fleet._draining:
                self._finish("aborted")
                return
            if not self._shift_slot(i):
                self._rollback()
                return
            self.shifted += 1
        quarantine_base = fleet.health.quarantines
        errored_base = sum(e.errored for e in fleet.engines)
        self._set_state("baking")
        regression = self._bake_watch(lambda: list(fleet.engines), errored_base, quarantine_base)
        if self._stop or fleet._draining:
            self._finish("aborted")
            return
        if regression is not None:
            self.error = regression
            self._note(f"bake regression: {regression}")
            self._rollback()
            return
        # committed: the staged version is THE version; the other retained
        # params are dropped and their canary references pruned
        fleet.version = self.to_version
        for v in list(fleet._versions):
            if v != self.to_version:
                fleet._versions.pop(v, None)
                fleet._canary_ref.pop(v, None)
        self._finish("completed")

    def _shift_slot(self, i: int) -> bool:
        """Move slot ``i`` to the staged version; False leaves the fleet
        mid-shift for ``_rollback``. The hold is released only on success:
        released in between, the supervisor would bill the deliberate close
        to the device ledger and race ``_rollback``'s rebuild of the slot."""
        fleet = self.fleet
        fleet._rollout_hold.add(i)
        old = fleet.engines[i]
        if old.alive():
            # per-replica drain: the router stops feeding it while its
            # in-flight requests finish on the old weights
            old.drain()
            if not self._wait_drained(old, time.perf_counter() + self.drain_timeout_s):
                if self._stop:
                    return False
                # wedged in-flight work: back in service rather than killing live streams
                old.undrain()
                self.error = f"slot {i} failed to drain within {self.drain_timeout_s:.0f}s"
                return False
            old.close()
        picked = fleet._spec_for_rebuild(i)
        if picked is None:
            self.error = f"slot {i}: no usable device for rebuild"
            return False
        spec, key = picked
        try:
            cand = fleet._build_replica(i, spec=spec, version=self.to_version)
        except Exception as e:  # noqa: BLE001 — a failed build rolls back
            self.error = f"slot {i} build on {key} failed: {e!r}"
            return False
        ok, detail = self._gate(cand)
        if not ok:
            try:
                cand.close()
            except Exception:  # noqa: BLE001 — teardown must not mask the verdict
                pass
            self.error = f"slot {i} rejected: {detail}"
            return False
        if self._stop or fleet._draining:
            cand.close()
            return False
        fleet._settle(i, cand, spec, key)  # one item assignment: routers see old or new
        fleet._slot_versions[i] = self.to_version
        fleet.health.probe_ok(key)
        self._note(f"slot {i} shifted to {self.to_version} on {key}")
        fleet._rollout_hold.discard(i)
        return True

    def _gate(self, candidate) -> tuple[bool, str]:
        """The ``rollout_canary_fail`` point, the canary probe, then the
        shadow replay: a candidate failing any never serves live traffic."""
        fleet = self.fleet
        if self._injector().take("rollout_canary_fail", fleet.label):
            self._count_fault("rollout_canary_fail")
            self.canary_fails += 1
            return False, "injected rollout_canary_fail"
        ok, detail = fleet._canary_check(candidate)
        if not ok:
            self.canary_fails += 1
            return False, f"canary: {detail}"
        return self._shadow_gate(candidate, fleet._shadow_ring)

    # -- rollback ---------------------------------------------------------------
    def _rollback(self) -> None:
        """Converge every slot back onto the retained old version. A slot
        whose rebuild fails stays recorded on the old version for the
        supervisor (its rebuild reads the slot's version): the fleet never
        ends with two versions in routing."""
        fleet = self.fleet
        self._set_state("rolling_back")
        # the evidence first (JAX rollout.py:526-536): a rollback means the
        # new version failed in production; capture the fleet before the
        # converge below rebuilds it away
        fleet.incident("rollback", reason=f"rolling back {self.to_version} -> {self.from_version}: "
                                          f"{self.error or 'gate failed'}")
        try:
            for i in range(len(fleet.engines)):
                if self._stop or fleet._draining:
                    self._finish("aborted")
                    return
                eng = fleet.engines[i]
                if eng.alive() and eng.version == self.from_version:
                    continue
                fleet._rollout_hold.add(i)
                # intent first: a supervisor rebuild of the slot uses it
                fleet._slot_versions[i] = self.from_version
                if eng.alive():
                    eng.drain()
                    if not self._wait_drained(eng, time.perf_counter() + self.drain_timeout_s):
                        # rollback must converge; the wedged replica's
                        # requests get the failover a crash would give them
                        eng._die(f"rollout rollback: replica failed to drain within {self.drain_timeout_s:.0f}s")
                    eng.close()
                picked = fleet._spec_for_rebuild(i)
                if picked is None:
                    self._note(f"rollback: slot {i} parked (no device)")
                    continue
                spec, key = picked
                try:
                    repl = fleet._build_replica(i, spec=spec, version=self.from_version)
                except Exception as e:  # noqa: BLE001 — the supervisor converges it later
                    self._note(f"rollback: slot {i} rebuild failed: {e!r}")
                    continue
                ok, detail = fleet._canary_check(repl)
                if not ok:
                    self._note(f"rollback: slot {i} canary: {detail}")
                    try:
                        repl.close()
                    except Exception:  # noqa: BLE001
                        pass
                    continue
                fleet._settle(i, repl, spec, key)
                self._note(f"slot {i} rolled back to {self.from_version}")
                fleet._rollout_hold.discard(i)
            # the rejected version goes: params freed, canary references
            # pruned, the label free for a fixed redeploy
            fleet._versions.pop(self.to_version, None)
            fleet._canary_ref.pop(self.to_version, None)
            self._finish("rolled_back")
        finally:
            # every hold still owned (a failed shift or rebuild, an abort)
            # is released here; such slots stay on from_version
            fleet._rollout_hold.clear()

    def _converge_after_crash(self) -> None:
        if any(v != self.from_version for v in self.fleet._slot_versions):
            self._rollback()


class _EngineSwapRollout(_RolloutBase):
    """Blue-green swap for a bare engine: build the staged version beside
    the serving one (two weight copies resident meanwhile), gate it,
    repoint the handle, drain the old engine and keep it through the bake,
    so a regression swaps back instead of rebuilding."""

    def __init__(self, handle, to_version: str, cfg, params, **kw):
        super().__init__(label=handle._engine.label, logger=handle._logger, **kw)
        self.handle = handle
        self.from_version = handle._engine.version
        self.to_version = to_version
        self._cfg, self._params = cfg, params
        self._fault_injector = handle._build_kw.get("fault_injector")

    def _run(self) -> None:
        from ..llm import LLMEngine

        handle = self.handle
        old = handle._engine
        self._set_state("shifting")
        try:
            cand = LLMEngine(self._cfg, self._params, version=self.to_version, **handle._build_kw)
        except Exception as e:  # noqa: BLE001 — the staged build failed; the old engine serves on
            self.error = f"build failed: {e!r}"
            self._finish("rolled_back")
            return
        # re-stage the registered adapters BEFORE the gate: the candidate
        # must serve the tenants the old engine does
        if getattr(cand, "lora_slots", 0):
            for aname, rec in list(old._adapters_host.items()):
                try:
                    cand.load_adapter(aname, rec["adapter"], version=rec["version"], alpha=rec["alpha"],
                                      fair_weight=rec["fair_weight"])
                except Exception as e:  # noqa: BLE001
                    self.error = f"adapter {aname!r} re-stage failed: {e!r}"
                    try:
                        cand.close()
                    except Exception:  # noqa: BLE001
                        pass
                    self._finish("rolled_back")
                    return
        ok, detail = self._gate(cand)
        if not ok:
            self.error = detail
            try:
                cand.close()
            except Exception:  # noqa: BLE001
                pass
            self._finish("rolled_back")
            return
        if self._stop:
            cand.close()
            self._finish("aborted")
            return
        # atomic repoint: new submissions land on the staged engine while
        # the old one's in-flight requests finish behind its drain; the
        # recent prompts move with it, the next rollout's shadow source
        cand._shadow_ring.extend(old._shadow_ring)
        handle._engine = cand
        old.drain()
        self._note(f"swapped to {self.to_version}; old engine draining")
        errored_base = cand.errored
        self._set_state("baking")
        regression = self._bake_watch(lambda: [cand], errored_base, 0)
        if self._stop:
            old.close()  # the staged engine serves; retire the drained old one
            self._finish("aborted")
            return
        if regression is not None:
            self.error = regression
            # swap BACK: the old engine is alive and warm
            handle._engine = old
            old.undrain()
            cand.drain()
            if not self._wait_drained(cand, time.perf_counter() + self.drain_timeout_s):
                self._note("regressed engine failed to drain; closing with in-flight work")
            cand.close()
            self._note(f"bake regression ({regression}); swapped back")
            self._finish("rolled_back")
            return
        if not self._wait_drained(old, time.perf_counter() + self.drain_timeout_s):
            self._note("old engine failed to drain; closing with in-flight work")
        old.close()
        self._finish("completed")

    def _finish(self, state: str) -> None:
        self._params = None  # a terminal swap pins no weights: the serving engine holds its own
        super()._finish(state)

    def _gate(self, candidate) -> tuple[bool, str]:
        from .health import canary_check

        if self._injector().take("rollout_canary_fail", self.label):
            self._count_fault("rollout_canary_fail")
            self.canary_fails += 1
            return False, "injected rollout_canary_fail"
        # no same-version peer exists: completeness and vocabulary only
        ok, detail, _toks = canary_check(candidate)
        if not ok:
            self.canary_fails += 1
            return False, f"canary: {detail}"
        return self._shadow_gate(candidate, self.handle._engine._shadow_ring)


class ModelHandle:
    """The versioned registry entry of one registered LLM. It proxies
    attribute access to the live engine (submit, generate, stats, drain,
    replica internals, ``cfg``), so callers of the bare engine keep
    working, and adds the model lifecycle: ``deploy`` (the fleet's rollout
    controller, or the bare engine's blue-green swap), ``register_adapter``
    / ``retire_adapter`` and ``rollout_state``. ``build_kw`` holds a bare
    engine's constructor kwargs, so a swap builds the same serving shape.
    The shadow ring and the adapters' host copies are the engine's (a
    bare engine and a fleet keep both). Unlike the JAX handle it keeps no
    reference to the registered config or params, which the engine
    holds: on the card a params reference would pin a retired version's
    weights after a commit."""

    def __init__(self, name: str, engine, *, build_kw: dict | None = None, logger=None):
        self.name = name
        self._engine = engine
        self._build_kw = dict(build_kw or {})
        self._logger = logger
        self._lock = threading.Lock()
        self._swap: _EngineSwapRollout | None = None

    # -- the engine's surface ------------------------------------------------
    @property
    def engine(self):
        return self._engine

    def __getattr__(self, item):
        # consulted only for what the handle lacks: the engine's surface
        return getattr(self._engine, item)

    # -- the model lifecycle ---------------------------------------------------
    def deploy(self, cfg=None, params=None, *, version: str | None = None, bake_s: float | None = None,
               shadow_probes: int | None = None, drain_timeout_s: float | None = None) -> dict:
        """Stage new weights and shift traffic onto them with zero downtime
        (a fleet's ``RolloutController``, else the engine swap). The params
        are validated against the config before anything changes (a bad
        checkpoint is a 400, never a dead replica); returns the rollout's
        snapshot at once, progress in ``rollout_state()``."""
        eng = self._engine
        if hasattr(eng, "deploy"):  # a fleet (or a disaggregated one, which refuses)
            return eng.deploy(cfg, params, version=version, bake_s=bake_s, shadow_probes=shadow_probes,
                              drain_timeout_s=drain_timeout_s)
        from ..models.checkpoint import validate_params

        if params is None:
            raise RolloutError("deploy() needs params (the new weights)")
        cfg = eng.cfg if cfg is None else cfg
        validate_params(params, cfg)
        with self._lock:
            if self._swap is not None and self._swap.active():
                raise RolloutInProgress(
                    f"rollout to {self._swap.to_version!r} already in progress (state {self._swap.state})"
                )
            if version is None:
                version = _next_version(eng.version)
            if version == eng.version:
                raise RolloutError(f"model version {version!r} is already active")
            self._swap = _EngineSwapRollout(self, version, cfg, params, bake_s=bake_s, shadow_probes=shadow_probes,
                                            drain_timeout_s=drain_timeout_s)
            self._swap.start()
        return self._swap.snapshot()

    def register_adapter(self, name: str, adapter: dict, *, version: str = "v1", alpha: float | None = None,
                         fair_weight: float | None = None, shadow_probes: int | None = None,
                         quota: float | None = None) -> dict:
        """Canary-gated adapter hot-load: validate and stage ``adapter``
        under ``<name>@<version>``, replay recent real prompts THROUGH the
        staged delta on the live engine, and only then publish it under
        ``name``. A reject evicts the staging row and raises
        ``RolloutError``; the previous binding of ``name`` serves on.
        ``fair_weight`` sets the tenant's share (``adapter:<name>``) and
        ``quota`` its token-rate ceiling in tok/s (JAX rollout.py:865-929),
        enforced at admission against the goodput usage meter."""
        eng = self._engine
        staging = f"{name}@{version}"
        probes = _env_int("TPU_LLM_ADAPTER_SHADOW", 2) if shadow_probes is None else max(0, int(shadow_probes))
        eng.load_adapter(staging, adapter, version=version, alpha=alpha)
        seen = _recent_distinct(eng._shadow_ring, probes)
        if probes > 0 and seen:
            ok, detail = shadow_probe(eng, seen, adapter=staging)
            if not ok:
                eng.evict_adapter(staging)  # and its host copy
                raise RolloutError(f"adapter {name!r} version {version!r} rejected by shadow gate: {detail}")
        eng.publish_adapter(staging, name)  # the host copy moves to ``name``
        if fair_weight is not None:
            ledger = getattr(eng, "ledger", None)
            if ledger is not None:
                ledger.set_weight(f"adapter:{name}", fair_weight)
            eng._adapters_host[name]["fair_weight"] = fair_weight
        if quota is not None:
            eng.set_tenant_quota(f"adapter:{name}", float(quota))
        return {"name": name, "version": version, "state": "published"}

    def retire_adapter(self, name: str) -> None:
        """Unbind ``name`` everywhere and forget its host copy, so no swap
        or rebuild brings it back."""
        self._engine.evict_adapter(name)

    def rollout_state(self) -> dict | None:
        eng = self._engine
        if hasattr(eng, "rollout_state"):
            return eng.rollout_state()
        return None if self._swap is None else self._swap.snapshot()

    def close(self) -> None:
        if self._swap is not None:
            self._swap.close()
        self._engine.close()


def _next_version(current: str) -> str:
    """v3 -> v4; anything else gets a ``.next`` suffix."""
    m = re.match(r"^v(\d+)$", current)
    return f"v{int(m.group(1)) + 1}" if m else f"{current}.next"
