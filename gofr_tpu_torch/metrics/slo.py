"""Per-tenant SLO engine: declared latency/availability targets, goodput
counters, and multi-window error-budget burn rates (a copy of
gofr_tpu/metrics/slo.py: the port imports nothing of the JAX package).

The fleet's health question is not "what is p99" but "are we burning the
error budget faster than we can afford" (the SRE multi-window burn-rate
alert). Targets come from config (`TPU_LLM_SLO_TTFT_MS`,
`TPU_LLM_SLO_TPOT_MS`, `TPU_LLM_SLO_AVAILABILITY`) with per-model and
per-adapter overrides via `register_llm(..., slo=...)`. Every finished
request is judged good/bad against its tenant's policy and feeds:

- `app_llm_slo_good_total` / `app_llm_slo_total{model,tenant,priority}` —
  the goodput ratio any dashboard can derive;
- `app_llm_slo_burn_rate{model,window}` — bad-fraction over the window
  divided by the budget (1 - availability target); 1.0 means "burning
  exactly the sustainable rate", 14.4 means "the monthly budget is gone
  in ~2 days";
- `app_llm_slo_fast_burn{model}` — 1 when BOTH the 5m and 1h windows
  exceed the fast-burn threshold (the two-window AND suppresses blips),
  which flips `/.well-known/health` to degraded.

Windows are `metrics.RollingWindow(max_age_s=...)` — time-bounded, so a
burst of failures ages out instead of poisoning the gauge forever.
Gauges zero at engine `close()` AND `_die()` (the dead-engine-gauge
regression class): a dead engine must not hold "fast burn" forever.
"""

from __future__ import annotations

import threading

from . import Manager, RollingWindow

# SRE workbook fast-burn threshold: 14.4x burns a 30-day budget in 2 days.
DEFAULT_FAST_BURN = 14.4
# Minimum judged requests in the short window before fast-burn can trip —
# one bad request out of one must not page.
MIN_FAST_BURN_SAMPLES = 10

_WINDOWS = (("5m", 300.0, 4096), ("1h", 3600.0, 16384))

_REG_LOCK = threading.Lock()


def register_slo_metrics(metrics: Manager) -> None:
    """Idempotent registration (same pattern as register_resilience_metrics)."""
    with _REG_LOCK:
        if not metrics.has("app_llm_slo_total"):
            metrics.new_counter(
                "app_llm_slo_total",
                "requests judged against the SLO policy",
            )
        if not metrics.has("app_llm_slo_good_total"):
            metrics.new_counter(
                "app_llm_slo_good_total",
                "requests that met every declared SLO target",
            )
        if not metrics.has("app_llm_slo_breaches_total"):
            metrics.new_counter(
                "app_llm_slo_breaches_total",
                "individual objective violations (which target burns the budget)",
            )
        if not metrics.has("app_llm_slo_burn_rate"):
            metrics.new_gauge(
                "app_llm_slo_burn_rate",
                "error-budget burn rate over the labelled window (1.0 = sustainable)",
            )
        if not metrics.has("app_llm_slo_fast_burn"):
            metrics.new_gauge(
                "app_llm_slo_fast_burn",
                "1 when both burn windows exceed the fast-burn threshold",
            )


class SLOPolicy:
    """Declared targets. Any subset may be set; unset targets don't judge.
    availability is the good-fraction target (e.g. 0.999): it defines the
    error budget (1 - availability) the burn rate is measured against."""

    __slots__ = ("ttft_ms", "tpot_ms", "availability")

    def __init__(
        self,
        ttft_ms: float | None = None,
        tpot_ms: float | None = None,
        availability: float | None = None,
    ):
        self.ttft_ms = float(ttft_ms) if ttft_ms else None
        self.tpot_ms = float(tpot_ms) if tpot_ms else None
        av = float(availability) if availability else None
        if av is not None:
            av = min(max(av, 0.0), 0.99999)
        self.availability = av

    @classmethod
    def from_config(cls, config) -> "SLOPolicy":
        def _f(key):
            try:
                raw = config.get(key) if config else None
                return float(raw) if raw not in (None, "") else None
            except (TypeError, ValueError):
                return None

        return cls(
            ttft_ms=_f("TPU_LLM_SLO_TTFT_MS"),
            tpot_ms=_f("TPU_LLM_SLO_TPOT_MS"),
            availability=_f("TPU_LLM_SLO_AVAILABILITY"),
        )

    @classmethod
    def coerce(cls, spec) -> "SLOPolicy | None":
        """Accept a policy, a {ttft_ms,tpot_ms,availability} dict, or None."""
        if spec is None or isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls(
                ttft_ms=spec.get("ttft_ms"),
                tpot_ms=spec.get("tpot_ms"),
                availability=spec.get("availability"),
            )
        raise TypeError(f"slo spec must be SLOPolicy or dict, got {type(spec)!r}")

    def merged(self, override: "SLOPolicy | None") -> "SLOPolicy":
        if override is None:
            return self
        return SLOPolicy(
            ttft_ms=override.ttft_ms or self.ttft_ms,
            tpot_ms=override.tpot_ms or self.tpot_ms,
            availability=override.availability or self.availability,
        )

    def active(self) -> bool:
        return any(
            v is not None for v in (self.ttft_ms, self.tpot_ms, self.availability)
        )

    def budget(self) -> float:
        """Error budget: the tolerated bad-fraction."""
        return 1.0 - (self.availability if self.availability is not None else 0.999)

    def judge(self, *, ok: bool, ttft_ms: float | None, tpot_ms: float | None) -> bool:
        return not self.violations(ok=ok, ttft_ms=ttft_ms, tpot_ms=tpot_ms)

    def violations(
        self, *, ok: bool, ttft_ms: float | None, tpot_ms: float | None
    ) -> list[str]:
        """Which objectives this request violated (empty = good)."""
        out = []
        if not ok:
            out.append("availability")
        if self.ttft_ms is not None and ttft_ms is not None and ttft_ms > self.ttft_ms:
            out.append("ttft")
        if self.tpot_ms is not None and tpot_ms is not None and tpot_ms > self.tpot_ms:
            out.append("tpot")
        return out

    def to_dict(self) -> dict:
        return {
            "ttft_ms": self.ttft_ms,
            "tpot_ms": self.tpot_ms,
            "availability": self.availability,
        }


class SLOTracker:
    """Per-engine goodput accounting + burn-rate windows for one model
    label. Tenant overrides (adapter name -> SLOPolicy) refine the base
    policy; counters stay per-{model,tenant,priority} while burn gauges
    pool per-model (gauge cardinality stays bounded by fleet size)."""

    def __init__(
        self,
        policy: SLOPolicy,
        metrics: Manager | None,
        label: str,
        tenant_overrides: dict[str, SLOPolicy] | None = None,
        fast_burn_threshold: float = DEFAULT_FAST_BURN,
        clock=None,
    ):
        self.policy = policy
        self.metrics = metrics
        self.label = label
        self.tenant_overrides = dict(tenant_overrides or {})
        self.fast_burn_threshold = float(fast_burn_threshold)
        self._lock = threading.Lock()
        self._windows = {
            name: RollingWindow(size=size, max_age_s=age, clock=clock)
            for name, age, size in _WINDOWS
        }
        self._good = 0
        self._total = 0
        # incident seam (flightrec): fired once per 0 -> 1
        # fast-burn transition — the flip is the moment the evidence
        # (which requests burned the budget, what the engine looked
        # like) is still live, so it triggers a black-box bundle.
        self.on_fast_burn = None
        self._fast_burn_prev = False
        if metrics is not None:
            register_slo_metrics(metrics)

    def policy_for(self, tenant: str) -> SLOPolicy:
        return self.policy.merged(self.tenant_overrides.get(tenant))

    def observe(
        self,
        *,
        tenant: str,
        priority: str,
        ok: bool,
        ttft_ms: float | None,
        tpot_ms: float | None,
    ) -> bool:
        """Judge one finished request; returns the good/bad verdict."""
        violated = self.policy_for(tenant).violations(
            ok=ok, ttft_ms=ttft_ms, tpot_ms=tpot_ms
        )
        good = not violated
        with self._lock:
            self._total += 1
            if good:
                self._good += 1
        for w in self._windows.values():
            w.observe(0.0 if good else 1.0)
        if self.metrics is not None:
            labels = {"model": self.label, "tenant": tenant, "priority": priority}
            self.metrics.increment_counter("app_llm_slo_total", **labels)
            if good:
                self.metrics.increment_counter("app_llm_slo_good_total", **labels)
            for objective in violated:
                self.metrics.increment_counter(
                    "app_llm_slo_breaches_total",
                    model=self.label,
                    objective=objective,
                )
            self._publish_gauges()
        return good

    def burn_rates(self) -> dict[str, float]:
        budget = max(self.policy.budget(), 1e-6)
        return {
            name: (w.mean() / budget) for name, w in self._windows.items()
        }

    def fast_burn(self) -> bool:
        """Two-window AND: both 5m and 1h above threshold, with enough
        short-window samples that a single bad request can't page."""
        if len(self._windows["5m"]) < MIN_FAST_BURN_SAMPLES:
            return False
        rates = self.burn_rates()
        return all(r >= self.fast_burn_threshold for r in rates.values())

    def _publish_gauges(self) -> None:
        m = self.metrics
        if m is None:
            return
        for name, rate in self.burn_rates().items():
            m.set_gauge(
                "app_llm_slo_burn_rate", rate, model=self.label, window=name
            )
        fast = self.fast_burn()
        m.set_gauge(
            "app_llm_slo_fast_burn", 1.0 if fast else 0.0, model=self.label
        )
        flipped, self._fast_burn_prev = (
            fast and not self._fast_burn_prev, fast
        )
        if flipped and self.on_fast_burn is not None:
            try:
                self.on_fast_burn()
            except Exception:  # noqa: BLE001 — incident capture is best-effort
                pass

    def zero_gauges(self) -> None:
        """close()/_die() path: a dead engine's burn state must read 0 —
        the dead-engine-gauge regression class. Windows clear too, so a
        restarted engine starts with a clean budget."""
        self._fast_burn_prev = False
        for w in self._windows.values():
            w.clear()
        m = self.metrics
        if m is not None:
            for name, _age, _size in _WINDOWS:
                m.set_gauge(
                    "app_llm_slo_burn_rate", 0.0, model=self.label, window=name
                )
            m.set_gauge("app_llm_slo_fast_burn", 0.0, model=self.label)

    def snapshot(self) -> dict:
        with self._lock:
            good, total = self._good, self._total
        return {
            "policy": self.policy.to_dict(),
            "tenant_overrides": {
                t: p.to_dict() for t, p in sorted(self.tenant_overrides.items())
            },
            "good": good,
            "total": total,
            "goodput": (good / total) if total else 1.0,
            "burn_rates": self.burn_rates(),
            "fast_burn": self.fast_burn(),
            "fast_burn_threshold": self.fast_burn_threshold,
        }


def pool_snapshots(snaps: list[dict]) -> dict:
    """Fleet pooling for ReplicatedLLMEngine.debug_state(): sum goodput,
    max burn (the hottest replica gates health, same as gauge_total on
    the per-replica fast-burn gauge)."""
    snaps = [s for s in snaps if s]
    if not snaps:
        return {}
    good = sum(s.get("good", 0) for s in snaps)
    total = sum(s.get("total", 0) for s in snaps)
    burn: dict[str, float] = {}
    for s in snaps:
        for w, r in (s.get("burn_rates") or {}).items():
            burn[w] = max(burn.get(w, 0.0), r)
    return {
        "policy": snaps[0].get("policy"),
        "replicas": len(snaps),
        "good": good,
        "total": total,
        "goodput": (good / total) if total else 1.0,
        "burn_rates": burn,
        "fast_burn": any(s.get("fast_burn") for s in snaps),
    }
