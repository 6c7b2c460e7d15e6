"""Resilience pieces of the port (counterpart of gofr_tpu/resilience):
overload control's fair-queuing ledger and brownout/shed controller."""

from .overload import FairLedger, OverloadController

__all__ = ["FairLedger", "OverloadController"]
