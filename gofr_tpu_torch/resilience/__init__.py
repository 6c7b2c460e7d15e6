"""Resilience pieces of the port (counterpart of gofr_tpu/resilience):
overload control's fair-queuing ledger, brownout/shed controller and the
fleet's retry budget; fault injection (``faults``), the step watchdog
(``watchdog``), the device-health ledger and canary gate (``health``) and
the replica supervisor (``supervisor``) and rollouts (``rollout``). In-flight failover, poison
quarantine, the numerical watchdog and the graceful drain live in
``gofr_tpu_torch.llm`` and ``gofr_tpu_torch.app``: they are the engine's
and the app's lifecycle."""

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
    "spec_device_key",
]
