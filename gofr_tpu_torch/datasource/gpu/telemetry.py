"""GPU device telemetry: periodic HBM gauges (counterpart of
gofr_tpu/datasource/tpu/telemetry.py, under the same series names so one
dashboard reads either package).

The health endpoint samples device memory once per probe; dashboards and
alerts want a continuously refreshed series instead. This sampler
publishes

- ``app_tpu_hbm_bytes{device, kind=in_use|limit}``
- ``app_tpu_hbm_utilization{device}``  (in_use / limit, 0..1)

on a daemon thread. ``in_use`` is the device memory this process's
caching allocator holds (``torch.cuda.memory_stats``' reserved bytes:
tensors, the graph pools and the allocator's cache; what the card cannot
give anyone else), ``limit`` the card's total (``torch.cuda.mem_get_info``). Host-side reads only: nothing here
synchronizes a stream. On a runtime without a CUDA device every sweep is
empty and the thread parks itself after a few, as the reference's does on
the CPU: the gauges simply never appear.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["GPUTelemetry"]


class GPUTelemetry:
    """Daemon sampler bound to a metrics Manager and a device list."""

    _EMPTY_SWEEP_LIMIT = 3  # park only after consecutive empty sweeps

    def __init__(self, metrics, devices, *, interval_s: float = 10.0, logger=None):
        self.metrics = metrics
        self.devices = [torch.device(d) for d in (devices or [])]
        self.interval = interval_s
        self.logger = logger
        self.parked = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if not metrics.has("app_tpu_hbm_bytes"):
            metrics.new_gauge("app_tpu_hbm_bytes", "device HBM bytes (kind=in_use|limit)")
        if not metrics.has("app_tpu_hbm_utilization"):
            metrics.new_gauge("app_tpu_hbm_utilization", "device HBM in_use/limit (0..1)")
        if self.devices and interval_s > 0:
            self._thread = threading.Thread(target=self._run, name="gpu-telemetry", daemon=True)
            self._thread.start()

    def sample_once(self) -> int:
        """Publish one sweep; returns how many devices yielded stats."""
        published = 0
        for d in self.devices:
            if d.type != "cuda" or not torch.cuda.is_available():
                continue
            try:
                st = torch.cuda.memory_stats(d)
                _free, total = torch.cuda.mem_get_info(d)
            except Exception:  # noqa: BLE001 — a sick card costs its sample
                continue
            in_use = st.get("reserved_bytes.all.current")
            if in_use is None:
                continue
            dev = str(d.index if d.index is not None else torch.cuda.current_device())
            self.metrics.set_gauge("app_tpu_hbm_bytes", float(in_use), device=dev, kind="in_use")
            if total:
                self.metrics.set_gauge("app_tpu_hbm_bytes", float(total), device=dev, kind="limit")
                self.metrics.set_gauge("app_tpu_hbm_utilization", float(in_use) / float(total), device=dev)
            published += 1
        return published

    def _run(self) -> None:
        # park only after several empty sweeps in a row: the first one may
        # race the device's initialization
        empty = 0
        while True:
            if self.sample_once() > 0:
                empty = 0
            else:
                empty += 1
                if empty >= self._EMPTY_SWEEP_LIMIT:
                    self.parked = True
                    if self.logger is not None:
                        self.logger.debug(f"GPU telemetry: no device reported memory stats in {empty} sweeps; "
                                          "sampler idle")
                    return
            if self._stop.wait(self.interval):
                return

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
