"""Resilience pieces of the port (counterpart of gofr_tpu/resilience):
overload control's fair-queuing ledger, brownout/shed controller and the
fleet's retry budget; fault injection (``faults``), the step watchdog
(``watchdog``), the device-health ledger and canary gate (``health``) and
the replica supervisor (``supervisor``) and rollouts (``rollout``). In-flight failover, poison
quarantine, the numerical watchdog and the graceful drain live in
``gofr_tpu_torch.llm`` and ``gofr_tpu_torch.app``: they are the engine's
and the app's lifecycle. ``register_resilience_metrics`` registers the
series they write (the JAX package's names)."""

import threading

from .faults import FAULT_POINTS, FaultInjector, InjectedFault, default_injector
from .health import DeviceHealthLedger, canary_check, device_key, spec_device_key
from .overload import FairLedger, OverloadController, RetryBudget
from .rollout import ModelHandle, RolloutController, RolloutError, RolloutInProgress
from .supervisor import ReplicaSupervisor
from .watchdog import Heartbeat, StepWatchdog

__all__ = [
    "FAULT_POINTS",
    "DeviceHealthLedger",
    "FairLedger",
    "FaultInjector",
    "Heartbeat",
    "InjectedFault",
    "ModelHandle",
    "OverloadController",
    "ReplicaSupervisor",
    "RetryBudget",
    "RolloutController",
    "RolloutError",
    "RolloutInProgress",
    "StepWatchdog",
    "canary_check",
    "default_injector",
    "device_key",
    "register_resilience_metrics",
    "spec_device_key",
]

# Serializes registration across engines (replicas register concurrently;
# the engine's phase-series lock serializes its own set).
_REG_LOCK = threading.Lock()


def register_resilience_metrics(metrics) -> None:
    """The resilience instrument set, registered once per process (series
    separate by the model label). Counters are monotone trip/restart
    tallies; the drain gauge is the rolling-deploy signal (0 serving,
    1 draining)."""
    with _REG_LOCK:
        for name, desc in (
            ("app_llm_replica_restarts_total",
             "llm replicas rebuilt and routed back by the supervisor"),
            ("app_llm_failovers_total",
             "llm in-flight requests re-dispatched off a dead replica"),
            ("app_llm_failover_errors_total",
             "llm failover requests errored out (no live replica or "
             "retry budget exhausted)"),
            ("app_llm_watchdog_trips_total",
             "llm device steps converted to replica death by the step "
             "watchdog"),
            ("app_llm_deadline_cancels_total",
             "llm requests cancelled mid-flight because their deadline "
             "passed"),
            ("app_llm_faults_injected_total",
             "faults fired by the injection harness (chaos only)"),
            ("app_llm_preemptions_total",
             "llm batch-class requests preempted (slot freed, requeued "
             "as a continuation) to admit interactive traffic"),
            ("app_llm_sheds_predicted_total",
             "llm requests shed at submit because predicted queue wait "
             "crossed the shed threshold (429 + Retry-After)"),
            ("app_llm_fleet_rejected_total",
             "llm requests rejected at the fleet queued-token admission "
             "cap (429 + Retry-After)"),
            ("app_llm_device_quarantines_total",
             "devices quarantined by the health ledger (K "
             "attributable failures inside the sliding window)"),
            ("app_llm_numerical_trips_total",
             "llm device steps whose logits went non-finite, converted "
             "to replica death by the numerical watchdog"),
            ("app_llm_poison_requests_total",
             "llm requests refused further failover after being in "
             "flight across the poison death threshold (500/INTERNAL "
             "to the caller)"),
            # model lifecycle (resilience.rollout;
            # docs/advanced-guide/rollouts.md)
            ("app_llm_rollouts_started_total",
             "llm weight rollouts staged (deploy()/the admin route)"),
            ("app_llm_rollouts_completed_total",
             "llm weight rollouts fully shifted and baked clean"),
            ("app_llm_rollouts_rolled_back_total",
             "llm weight rollouts rolled back to the old version "
             "(canary/shadow rejection or bake-window regression)"),
            ("app_llm_requests_by_version_total",
             "llm requests finished, by model version and finish "
             "reason — the per-version error-rate view during a "
             "traffic shift"),
            ("app_llm_disconnect_cancels_total",
             "llm requests cancelled because the serving edge detected "
             "a dead peer (broken pipe / closed gRPC context) — slot "
             "freed instead of decoding to completion"),
        ):
            if not metrics.has(name):
                metrics.new_counter(name, desc)
        for name, desc in (
            ("app_llm_drain_state",
             "llm engine drain state (0 serving, 1 draining)"),
            ("app_llm_brownout_state",
             "llm brownout mode (0 normal, 1 batch max_new_tokens "
             "clamped under sustained pressure)"),
            ("app_llm_fairness_debt",
             "spread (max-min) of weighted served-token counters across "
             "clients with waiting work — 0 is perfectly fair"),
            ("app_llm_retry_budget_remaining",
             "router retry-budget tokens remaining (token bucket; 0 "
             "means retries surface the original error)"),
            ("app_llm_devices_quarantined",
             "devices currently quarantined or awaiting a "
             "successful reintegration probe"),
            ("app_llm_replicas_parked",
             "llm replica slots parked for lack of a usable device "
             "(capacity-degraded, not crash-looping; health reports "
             "degraded)"),
            ("app_llm_replicas_failed",
             "llm replica slots permanently failed after "
             "TPU_LLM_RESTART_MAX_ATTEMPTS consecutive rebuild "
             "failures (operator attention required)"),
            ("app_llm_model_version_info",
             "live replicas serving each model version (single engine: "
             "1 for its version); mixed only mid-rollout, 0 after close"),
            ("app_llm_rollout_state",
             "llm rollout state machine (0 idle/terminal, 1 shifting, "
             "2 baking, 3 rolling back)"),
        ):
            if not metrics.has(name):
                metrics.new_gauge(name, desc)
