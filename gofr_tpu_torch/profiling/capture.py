"""On-demand device profiler capture with single-capture concurrency
(counterpart of gofr_tpu/profiling/capture.py, on ``torch.profiler``).

``POST /.well-known/debug/profile`` drives :class:`ProfilerCapture`,
which runs ``torch.profiler`` (CPU activities, plus CUDA where the card
is visible) for N seconds — or until a caller-supplied condition (the
route uses "M decode steps dispatched") — writes the Chrome trace
(``trace.json``: every kernel the card ran in the window, by name) and
returns the run directory zipped.

Concurrency: the profiler is process-global, so exactly ONE capture may
run at a time; a second request while one is in flight fails fast with
:class:`ProfileBusy` (HTTP 409).

The window never hangs its caller: the capture runs on a worker thread
and the caller waits at most ``budget_s``, then gets
:class:`ProfileTimeout` (HTTP 504) naming the phase that did not return
(a stop whose trace readback outgrew the budget); the worker keeps the
busy lock until it has finished, so no second capture starts beside it.
Nothing in the window touches the engine: its scheduler and collector
threads keep serving, and the profiler records the kernels their graph
replays launch.

Parking: where the profiler refuses to start, the capture *parks* — it
still samples the engine state at 10 Hz in pure Python, archives those
samples with the park reason, and reports ``mode="fallback"``. The
samples ride along in every archive (``engine_samples.json``): the
host-side view of slot occupancy is what makes a device trace readable.
Captures land under ``GOFR_PROFILE_DIR`` (default: the temp dir's
``gofr-tpu-profiles``).
"""

from __future__ import annotations

import io
import json
import math
import os
import tempfile
import threading
import time
import zipfile
from typing import Any, Callable

__all__ = ["ProfileBusy", "ProfileTimeout", "ProfilerCapture", "profiler_capture"]

_MAX_SECONDS = 30.0
_SAMPLE_PERIOD_S = 0.1


class ProfileBusy(RuntimeError):
    """A capture is already running (the profiler is process-global);
    ``status_code`` maps it to 409 at the responder."""

    status_code = 409


class ProfileTimeout(RuntimeError):
    """The capture did not return within its budget (504)."""

    status_code = 504


class ProfilerCapture:
    """One capture at a time; archives the run directory to zip bytes."""

    def __init__(self, base_dir: str | None = None):
        self._busy = threading.Lock()
        self.base_dir = base_dir

    def _resolve_dir(self, trace_dir: str | None) -> str:
        d = (
            trace_dir
            or self.base_dir
            or os.environ.get("GOFR_PROFILE_DIR")
            or os.path.join(tempfile.gettempdir(), "gofr-tpu-profiles")
        )
        run = os.path.join(d, time.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}-{time.monotonic_ns() % 10**6}")
        os.makedirs(run, exist_ok=True)
        return run

    def capture(
        self,
        seconds: float = 2.0,
        *,
        budget_s: float,
        trace_dir: str | None = None,
        sample_fn: Callable[[], Any] | None = None,
        until: Callable[[], bool] | None = None,
    ) -> dict:
        """Run one capture window. ``seconds`` bounds the window (clamped
        to 0.1..30); ``until`` ends it early; ``sample_fn`` is polled at
        10 Hz and its samples archived beside the trace; ``budget_s``
        bounds the whole call (``ProfileTimeout`` past it).

        Returns {mode, seconds, requested_seconds, samples, dir, files,
        archive, parked?}: ``archive`` is the zip bytes of the run
        directory; ``mode`` is "torch" for a real trace, "fallback" for
        the parked pure-Python capture (``parked`` carries the reason).
        The seconds spent starting, stopping and exporting go into the
        archive's ``stages.json``."""
        seconds = float(seconds)
        if not math.isfinite(seconds):
            # NaN slips through min/max and would make the window infinite
            raise ValueError(f"seconds must be finite, got {seconds}")
        seconds = min(max(seconds, 0.1), _MAX_SECONDS)
        if not self._busy.acquire(blocking=False):
            raise ProfileBusy(
                "a profile capture is already running (the profiler is process-global; retry when the current "
                "capture finishes)"
            )
        box: dict = {"phase": "starting"}
        done = threading.Event()

        def run():
            try:
                box["result"] = self._capture(seconds, trace_dir, sample_fn, until, box)
            except BaseException as e:  # noqa: BLE001 — handed to the caller
                box["error"] = e
            finally:
                self._busy.release()
                done.set()

        threading.Thread(target=run, name="gofr-profile-capture", daemon=True).start()
        if not done.wait(budget_s):
            raise ProfileTimeout(
                f"profile capture did not return within its {budget_s:.0f} s budget (stuck {box['phase']}); the "
                "capture keeps the profiler until it finishes"
            )
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _capture(self, seconds: float, trace_dir, sample_fn, until, box: dict) -> dict:
        run_dir = self._resolve_dir(trace_dir)
        mode, parked, prof = "torch", None, None
        stage = {}
        t = time.perf_counter()
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:  # noqa: BLE001 — park, don't fail
            mode, parked, prof = "fallback", f"{type(e).__name__}: {e}", None
        stage["start"] = round(time.perf_counter() - t, 3)
        box["phase"] = "in the window"
        samples: list[Any] = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        try:
            while True:
                if sample_fn is not None:
                    try:
                        samples.append(sample_fn())
                    except Exception:  # noqa: BLE001 — samples are best-effort
                        pass
                if until is not None and until():
                    break
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                time.sleep(min(_SAMPLE_PERIOD_S, remaining))
        finally:
            # the profiler stops even when until() (caller code) raises: a
            # started one would park every later capture
            elapsed = time.perf_counter() - t0
            if prof is not None:
                box["phase"] = "stopping the profiler"
                t = time.perf_counter()
                try:
                    prof.stop()
                    stage["stop"] = round(time.perf_counter() - t, 3)
                    box["phase"] = "exporting the trace"
                    t = time.perf_counter()
                    prof.export_chrome_trace(os.path.join(run_dir, "trace.json"))
                    stage["export"] = round(time.perf_counter() - t, 3)
                except Exception as e:  # noqa: BLE001
                    mode, parked = "fallback", f"stop/export: {type(e).__name__}: {e}"
        box["phase"] = "archiving"
        meta = {
            "mode": mode,
            "seconds": round(elapsed, 3),
            "requested_seconds": seconds,
            "samples": len(samples),
        }
        if parked:
            meta["parked"] = parked
        with open(os.path.join(run_dir, "capture.json"), "w", encoding="utf-8") as f:
            json.dump(meta, f, indent=1, default=str)
        with open(os.path.join(run_dir, "stages.json"), "w", encoding="utf-8") as f:
            json.dump(stage, f)
        if samples:
            with open(os.path.join(run_dir, "engine_samples.json"), "w", encoding="utf-8") as f:
                json.dump(samples, f, default=str)
        files, archive = _zip_dir(run_dir)
        return {**meta, "dir": run_dir, "files": files, "archive": archive}


def _zip_dir(run_dir: str) -> tuple[list[str], bytes]:
    buf = io.BytesIO()
    names: list[str] = []
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, _dirs, files in os.walk(run_dir):
            for name in sorted(files):
                path = os.path.join(root, name)
                rel = os.path.relpath(path, run_dir)
                names.append(rel)
                z.write(path, rel)
    return names, buf.getvalue()


_capturer = ProfilerCapture()


def profiler_capture() -> ProfilerCapture:
    """The process-wide capturer (one profiler per process, so one guard)."""
    return _capturer
