"""Goodput ledger: per-request device-time attribution, the waste
taxonomy, per-tenant usage metering and token-rate quotas (counterpart of
gofr_tpu/goodput/__init__.py, copied whole: the port imports nothing of
the JAX package).

The engine's collector thread calls :meth:`GoodputLedger.observe` once per
fetched program (a unified step, a pure decode chunk, a prefill wave or an
exact-hit group, a speculative verify) with the dispatch->fetch window
(``_Fetch.t0`` to the fetch time, host clock) and the lanes packed in it.
The ledger splits the window's *novel* time proportionally across lanes by
tokens processed and classifies every slice:

``useful``
    tokens the caller asked for and received: prompt positions computed
    for the first time, decoded/accepted tokens.
``padding``
    budget slack: dead lanes in a dense pass, bucket rows beyond the
    packed prompts, unselected verify rows. Slack no lane owns is billed
    to the window's packed requests proportionally to their token counts
    (chargeback is CLOSED: per-tenant chip time sums to the attributed
    total).
``spec_reject``
    verify positions proposed by the drafter and rejected.
``replay``
    re-prefill of positions already served once: preemption and failover
    continuations fold emitted history into the prompt and compute it
    again (``GenRequest._replay_pos``).
``probe``
    synthetic traffic (canary, shadow, replay-debug): any lane whose
    request carries ``probe=True`` reclassifies wholesale.
``idle``
    scheduler gaps between device windows.

Conservation is structural: the engine pipelines up to ``lookahead``
programs whose windows overlap, so the ledger keeps a *busy frontier* —
each window contributes only the time past the frontier as busy, the gap
before it as idle, and ``sum(by_class) + idle == frontier - first_t0`` to
float precision. The windows are host dispatch->fetch times, so a window
reads at least the device time of its program.

Attributions roll up per request (``req._chip``: the flight record, the
wide event and the OpenAI ``usage`` block), per tenant into
:class:`UsageMeter` windows (``/.well-known/debug/usage``) and per class
and priority into the ``app_llm_goodput_*`` counters. :class:`QuotaGate`
enforces hard per-tenant token-rate quotas at admission with a
Retry-After priced from the tenant's measured window.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Iterable

# Attributed classes, in display order. "idle" is tracked separately —
# it is engine time no lane owns (scheduler gaps), never per-request.
CLASSES = ("useful", "padding", "spec_reject", "replay", "probe")
IDLE = "idle"

_REG_LOCK = threading.Lock()


def register_goodput_metrics(metrics) -> None:
    """Register the goodput metric family once per manager (idempotent)."""
    with _REG_LOCK:
        if not metrics.has("app_llm_goodput_seconds_total"):
            metrics.new_counter(
                "app_llm_goodput_seconds_total",
                "Device chip-seconds attributed by the goodput ledger, "
                "by waste class (useful/padding/spec_reject/replay/"
                "probe/idle) and priority class",
            )
        if not metrics.has("app_llm_goodput_ratio"):
            metrics.new_gauge(
                "app_llm_goodput_ratio",
                "Fraction of engine wall time spent on useful tokens "
                "(useful / (attributed + idle))",
            )
        if not metrics.has("app_llm_tenant_chip_seconds_total"):
            metrics.new_counter(
                "app_llm_tenant_chip_seconds_total",
                "Device chip-seconds attributed per tenant (client / "
                "adapter:<name> FairLedger ids) and waste class",
            )
        if not metrics.has("app_llm_tenant_tokens_total"):
            metrics.new_counter(
                "app_llm_tenant_tokens_total",
                "Useful tokens (prompt positions + decoded tokens) "
                "metered per tenant by the goodput ledger",
            )
        if not metrics.has("app_llm_quota_sheds_total"):
            metrics.new_counter(
                "app_llm_quota_sheds_total",
                "Admissions rejected because the tenant exceeded its "
                "token-rate quota (TPU_LLM_TENANT_QUOTA_TOK_S)",
            )


def parse_quota_spec(spec: str | None) -> dict[str, float]:
    """Parse ``"tenant=rate,adapter:bob=rate,*=rate"`` into a quota map
    (tokens/second). Malformed entries are dropped, not fatal — a typo
    in an env var must not take the engine down."""
    out: dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        tenant, _, rate = part.rpartition("=")
        try:
            val = float(rate)
        except ValueError:
            continue
        if tenant.strip() and val > 0:
            out[tenant.strip()] = val
    return out


def goodput_knobs(goodput: bool | None = None, usage_window_s: float | None = None) -> tuple[bool, float]:
    """``goodput`` and ``usage_window_s`` with each None read from its knob,
    as the JAX engine and fleet read them (JAX llm.py:1040-1048,
    :7488-7495): ``TPU_LLM_GOODPUT`` (on unless "0" or empty) and
    ``TPU_LLM_USAGE_WINDOW_S`` (60 s)."""
    if goodput is None:
        goodput = os.environ.get("TPU_LLM_GOODPUT", "1") not in ("", "0")
    if usage_window_s is None:
        usage_window_s = float(os.environ.get("TPU_LLM_USAGE_WINDOW_S", "") or 60.0)
    return bool(goodput), float(usage_window_s)


class UsageMeter:
    """Per-tenant rolling usage windows: chip-seconds by waste class and
    useful tokens, bucketed so old usage ages out in O(buckets). One
    meter is shared across a ReplicatedLLMEngine's replicas (the
    FairLedger pattern) so quotas and the usage endpoint see fleet-local
    totals, not per-replica shards. ``now_fn`` is injectable for fake
    clocks in tests."""

    def __init__(
        self,
        window_s: float = 60.0,
        buckets: int = 6,
        max_tenants: int = 512,
        now_fn: Callable[[], float] = time.monotonic,
    ) -> None:
        self.window_s = max(1e-3, float(window_s))
        self.buckets = max(1, int(buckets))
        self.bucket_s = self.window_s / self.buckets
        self.max_tenants = max_tenants
        self.now = now_fn
        self._lock = threading.Lock()
        # tenant -> deque[(bucket_start, {class: chip_s}, tokens)]
        self._win: dict[str, deque] = {}
        self._cum_chip: dict[str, dict[str, float]] = {}
        self._cum_tokens: dict[str, int] = {}
        self.t0 = now_fn()

    def _prune(self, dq: deque, now: float) -> None:
        horizon = now - self.window_s
        while dq and dq[0][0] + self.bucket_s <= horizon:
            dq.popleft()

    def add(self, tenant: str, chip: dict[str, float], tokens: int) -> None:
        now = self.now()
        bucket = now - (now % self.bucket_s)
        with self._lock:
            dq = self._win.get(tenant)
            if dq is None:
                if len(self._win) >= self.max_tenants:
                    # bounded tenant table: evict the stalest window so a
                    # client-id cardinality attack cannot grow the host
                    stale = min(
                        self._win, key=lambda t: self._win[t][-1][0]
                        if self._win[t] else 0.0
                    )
                    self._win.pop(stale, None)
                dq = self._win[tenant] = deque()
            if not dq or dq[-1][0] != bucket:
                self._prune(dq, now)
                dq.append((bucket, {}, [0]))
            _, by_class, toks = dq[-1]
            for cls, s in chip.items():
                by_class[cls] = by_class.get(cls, 0.0) + s
            toks[0] += tokens
            cum = self._cum_chip.setdefault(tenant, {})
            for cls, s in chip.items():
                cum[cls] = cum.get(cls, 0.0) + s
            self._cum_tokens[tenant] = (
                self._cum_tokens.get(tenant, 0) + tokens
            )

    def window(self, tenant: str) -> tuple[dict[str, float], int, float]:
        """(chip_s by class, tokens, effective window seconds) for the
        tenant's trailing window. The effective window is clamped to the
        meter's age so a cold meter does not report absurd rates."""
        now = self.now()
        eff = min(self.window_s, max(self.bucket_s, now - self.t0))
        with self._lock:
            dq = self._win.get(tenant)
            if not dq:
                return {}, 0, eff
            self._prune(dq, now)
            chip: dict[str, float] = {}
            tokens = 0
            for _b, by_class, toks in dq:
                for cls, s in by_class.items():
                    chip[cls] = chip.get(cls, 0.0) + s
                tokens += toks[0]
            return chip, tokens, eff

    def tok_rate(self, tenant: str) -> float:
        _chip, tokens, eff = self.window(tenant)
        return tokens / eff

    def snapshot(self) -> dict:
        """Windowed per-tenant usage for the debug/usage endpoint and
        chargeback export: chip-seconds by class, useful tokens, and
        token rate over the trailing window, plus lifetime cumulatives."""
        tenants: dict[str, dict] = {}
        with self._lock:
            names = list(self._win)
        for tenant in names:
            chip, tokens, eff = self.window(tenant)
            with self._lock:
                cum_chip = dict(self._cum_chip.get(tenant, {}))
                cum_tokens = self._cum_tokens.get(tenant, 0)
            tenants[tenant] = {
                "chip_s": {c: round(v, 6) for c, v in chip.items()},
                "chip_s_total": round(sum(chip.values()), 6),
                "tokens": tokens,
                "tok_s": round(tokens / eff, 3),
                "cum_chip_s": {c: round(v, 6) for c, v in cum_chip.items()},
                "cum_tokens": cum_tokens,
            }
        return {"window_s": self.window_s, "tenants": tenants}


class QuotaGate:
    """Hard per-tenant token-rate quotas on top of the measured usage
    windows (beyond the fair-share weights of ``resilience.FairLedger``).
    Tenants without an explicit quota (and no ``*`` wildcard) fall back
    to fair-share only — :meth:`check` returns None for them. A shed's
    Retry-After is *priced*: the time the trailing window needs, with no
    new admissions, for the tenant's rate to decay back under quota."""

    def __init__(
        self,
        quotas: dict[str, float] | None,
        meter: UsageMeter,
        min_retry_after: float = 0.25,
    ) -> None:
        self._lock = threading.Lock()
        self.quotas: dict[str, float] = dict(quotas or {})
        self.meter = meter
        self.min_retry_after = min_retry_after

    def active(self) -> bool:
        return bool(self.quotas)

    def set(self, tenant: str, tok_s: float | None) -> None:
        with self._lock:
            if tok_s is None or tok_s <= 0:
                self.quotas.pop(tenant, None)
            else:
                self.quotas[tenant] = float(tok_s)

    def quota_for(self, tenant: str) -> float | None:
        with self._lock:
            q = self.quotas.get(tenant)
            if q is None:
                q = self.quotas.get("*")
            return q

    def check(self, tenant: str) -> float | None:
        """None when the tenant may proceed; otherwise the priced
        Retry-After in seconds."""
        quota = self.quota_for(tenant)
        if quota is None:
            return None
        _chip, tokens, eff = self.meter.window(tenant)
        allowed = quota * eff
        if tokens <= allowed:
            return None
        return max(self.min_retry_after, (tokens - allowed) / quota)

    def snapshot(self) -> dict:
        with self._lock:
            return {"quotas_tok_s": dict(self.quotas)}


class GoodputLedger:
    """Busy-frontier device-time attribution. One per engine; fed by the
    collector thread (observations arrive FIFO in dispatch order, so t1
    is monotone per engine and the frontier never double-counts the
    overlap between pipelined device windows)."""

    def __init__(
        self,
        metrics=None,
        label: str = "llm",
        version_fn: Callable[[], str] | None = None,
        usage: UsageMeter | None = None,
    ) -> None:
        self.metrics = metrics
        self.label = label
        self.version_fn = version_fn
        self.usage = usage
        self._lock = threading.Lock()
        self.first_t0: float | None = None
        self.frontier: float | None = None
        self.by_class: dict[str, float] = {c: 0.0 for c in CLASSES}
        self.idle_s = 0.0
        self.observations = 0

    def observe(
        self,
        kind: str,
        t0: float,
        t1: float,
        lanes: Iterable[tuple[object, dict[str, int]]],
    ) -> None:
        """Attribute one device window. ``lanes`` is ``[(request_or_None,
        {class: tokens})]`` — a None request marks anonymous slack (dead
        lanes, bucket padding). Only the time past the busy frontier is
        novel; the rest of the window overlapped an earlier dispatch and
        was already attributed."""
        if t1 < t0:
            t1 = t0
        # per-(class, priority) and per-(tenant, class) batches: one
        # counter increment per distinct key, not per lane
        agg: dict[tuple[str, str], float] = {}
        tagg: dict[tuple[str, str], float] = {}
        toks_by_tenant: dict[str, int] = {}
        with self._lock:
            if self.frontier is None:
                self.first_t0 = t0
                self.frontier = t0
            idle = max(0.0, t0 - self.frontier)
            busy = max(0.0, t1 - max(t0, self.frontier))
            if t1 > self.frontier:
                self.frontier = t1
            self.idle_s += idle
            self.observations += 1
            lanes = list(lanes)
            # chargeback closure: anonymous slack (dead lanes, bucket
            # rows beyond the packed prompts) is billed to the requests
            # packed in the window, proportionally to their token
            # counts, as THEIR padding share — every chip-second lands
            # on a tenant, so per-tenant chip time sums to the
            # attributed total. A window with no owned lanes (cannot
            # happen from the engine's seams) stays anonymous.
            owned = [(r, cl) for r, cl in lanes if r is not None]
            anon = sum(
                max(0, n)
                for r, cl in lanes if r is None for n in cl.values()
            )
            if anon and owned:
                own_tok = sum(
                    max(0, n) for _r, cl in owned for n in cl.values()
                )
                if own_tok > 0:
                    for _r, cl in owned:
                        share = anon * sum(cl.values()) / own_tok
                        cl["padding"] = cl.get("padding", 0) + share
                    lanes = owned
            total = sum(
                max(0, n) for _r, cl in lanes for n in cl.values()
            )
            if total > 0 and busy > 0.0:
                per_tok = busy / total
                for r, classes in lanes:
                    probe = r is not None and getattr(r, "probe", False)
                    prio = getattr(r, "priority", None) or "-"
                    tenant = (getattr(r, "client", "") or "-") if r is not None else None
                    useful_toks = 0
                    for cls, n in classes.items():
                        if n <= 0:
                            continue
                        if cls == "useful":
                            useful_toks += n
                        # probe traffic reclassifies wholesale: its
                        # "useful" tokens are synthetic, not demand
                        ccls = "probe" if probe else cls
                        share = per_tok * n
                        self.by_class[ccls] += share
                        agg[(ccls, prio)] = agg.get((ccls, prio), 0.0) + share
                        if r is not None:
                            chip = getattr(r, "_chip", None)
                            if chip is not None:
                                chip[ccls] = chip.get(ccls, 0.0) + share
                            tagg[(tenant, ccls)] = (
                                tagg.get((tenant, ccls), 0.0) + share
                            )
                    if r is not None and useful_toks and not probe:
                        toks_by_tenant[tenant] = (
                            toks_by_tenant.get(tenant, 0) + useful_toks
                        )
            elif busy > 0.0:
                # a window with no classifiable lanes (cannot happen from
                # the engine's seams, but keep conservation structural)
                self.by_class["padding"] += busy
                agg[("padding", "-")] = busy
            wall = self.frontier - (self.first_t0 or self.frontier)
            useful = self.by_class["useful"]
            ratio = useful / wall if wall > 0 else 0.0
        if self.usage is not None:
            per_tenant: dict[str, dict[str, float]] = {}
            for (tenant, cls), share in tagg.items():
                per_tenant.setdefault(tenant, {})[cls] = share
            for tenant, chip in per_tenant.items():
                self.usage.add(
                    tenant, chip, toks_by_tenant.get(tenant, 0)
                )
            for tenant, n in toks_by_tenant.items():
                if tenant not in per_tenant:
                    self.usage.add(tenant, {}, n)
        m = self.metrics
        if m is not None:
            if idle > 0.0:
                m.increment_counter(
                    "app_llm_goodput_seconds_total", by=idle,
                    model=self.label, **{"class": IDLE}, priority="-",
                )
            for (cls, prio), share in agg.items():
                m.increment_counter(
                    "app_llm_goodput_seconds_total", by=share,
                    model=self.label, **{"class": cls}, priority=prio,
                )
            for (tenant, cls), share in tagg.items():
                m.increment_counter(
                    "app_llm_tenant_chip_seconds_total", by=share,
                    model=self.label, tenant=tenant, **{"class": cls},
                )
            for tenant, n in toks_by_tenant.items():
                m.increment_counter(
                    "app_llm_tenant_tokens_total", by=float(n),
                    model=self.label, tenant=tenant,
                )
            m.set_gauge(
                "app_llm_goodput_ratio", ratio, model=self.label
            )

    def snapshot(self) -> dict:
        """Cumulative attribution with the conservation identity made
        explicit: ``attributed_s + idle_s == wall_s`` (float precision)."""
        with self._lock:
            wall = (
                (self.frontier - self.first_t0)
                if self.frontier is not None and self.first_t0 is not None
                else 0.0
            )
            by_class = {c: round(v, 6) for c, v in self.by_class.items()}
            attributed = sum(self.by_class.values())
            useful = self.by_class["useful"]
            return {
                "wall_s": round(wall, 6),
                "attributed_s": round(attributed, 6),
                "idle_s": round(self.idle_s, 6),
                "by_class": by_class,
                "goodput_ratio": round(useful / wall, 6) if wall > 0 else 0.0,
                "observations": self.observations,
                "version": self.version_fn() if self.version_fn else "",
            }

    def zero_gauges(self) -> None:
        """close()/_die() discipline: a dead engine must not freeze a
        last-known goodput ratio on the exposition."""
        if self.metrics is not None:
            self.metrics.set_gauge(
                "app_llm_goodput_ratio", 0.0, model=self.label
            )


def pool_goodput(snaps: Iterable[dict]) -> dict:
    """Pool per-replica goodput snapshots into one fleet view (sums are
    additive; the ratio recomputes from the pooled sums)."""
    wall = idle = attributed = 0.0
    by_class = {c: 0.0 for c in CLASSES}
    obs = 0
    for s in snaps:
        if not s:
            continue
        wall += s.get("wall_s", 0.0)
        idle += s.get("idle_s", 0.0)
        attributed += s.get("attributed_s", 0.0)
        obs += s.get("observations", 0)
        for c, v in (s.get("by_class") or {}).items():
            by_class[c] = by_class.get(c, 0.0) + v
    return {
        "wall_s": round(wall, 6),
        "attributed_s": round(attributed, 6),
        "idle_s": round(idle, 6),
        "by_class": {c: round(v, 6) for c, v in by_class.items()},
        "goodput_ratio": (
            round(by_class["useful"] / wall, 6) if wall > 0 else 0.0
        ),
        "observations": obs,
    }


def prefill_classes(replay_pos: int, pos: int, n: int) -> dict[str, int]:
    """Split a prefill span ``[pos, pos+n)`` into replay (positions the
    engine already computed once — preemption/failover re-prefill) vs
    useful (first-time prompt work)."""
    replay = max(0, min(replay_pos - pos, n))
    out = {"useful": n - replay}
    if replay:
        out["replay"] = replay
    return out
