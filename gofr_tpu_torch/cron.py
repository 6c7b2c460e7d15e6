"""In-process cron scheduler (counterpart of gofr_tpu/cron.py).

``Schedule`` parses a 5-field crontab expression (minute, hour, day of
month, month, day of week with Sunday 0) of ``*``, lists, ranges and
``/n`` steps; ``CronScheduleError`` refuses a bad one. ``Cron.run`` ticks
at every minute boundary on the app's loop and starts each due job as a
task (a sync job in the executor) inside a span ``cron:<name>``, with a
Context of its own; a failing job is logged and the ticker goes on. The
App cancels the ticker at shutdown."""

from __future__ import annotations

import asyncio
import time
from typing import Callable

FIELD_RANGES = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 6))  # min hour dom mon dow


class CronScheduleError(ValueError):
    pass


def _parse_field(field: str, lo: int, hi: int) -> frozenset[int]:
    out: set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, _, step_s = part.partition("/")
            try:
                step = int(step_s)
            except ValueError as e:
                raise CronScheduleError(f"bad step {step_s!r}") from e
            if step <= 0:
                raise CronScheduleError(f"bad step {step}")
        if part in ("*", ""):
            lo2, hi2 = lo, hi
        elif "-" in part:
            a, _, b = part.partition("-")
            try:
                lo2, hi2 = int(a), int(b)
            except ValueError as e:
                raise CronScheduleError(f"bad range {part!r}") from e
        else:
            try:
                lo2 = hi2 = int(part)
            except ValueError as e:
                raise CronScheduleError(f"bad value {part!r}") from e
        if lo2 < lo or hi2 > hi or lo2 > hi2:
            raise CronScheduleError(f"value out of range [{lo},{hi}]: {part!r}")
        out.update(range(lo2, hi2 + 1, step))
    return frozenset(out)


class Schedule:
    """Parsed 5-field crontab expression."""

    __slots__ = ("minutes", "hours", "days", "months", "weekdays", "expr")

    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) != 5:
            raise CronScheduleError(f"schedule must have 5 fields, got {len(fields)}: {expr!r}")
        self.expr = expr
        sets = [_parse_field(f, lo, hi) for f, (lo, hi) in zip(fields, FIELD_RANGES)]
        self.minutes, self.hours, self.days, self.months, self.weekdays = sets

    def matches(self, t: time.struct_time) -> bool:
        # struct_time.tm_wday: Monday=0; cron: Sunday=0
        dow = (t.tm_wday + 1) % 7
        return (
            t.tm_min in self.minutes
            and t.tm_hour in self.hours
            and t.tm_mday in self.days
            and t.tm_mon in self.months
            and dow in self.weekdays
        )


class Job:
    __slots__ = ("schedule", "name", "fn")

    def __init__(self, schedule: Schedule, name: str, fn: Callable):
        self.schedule = schedule
        self.name = name
        self.fn = fn


class Cron:
    """Minutely ticker dispatching due jobs (cron.go:61-75)."""

    def __init__(self, container):
        self.container = container
        self.jobs: list[Job] = []

    def add_job(self, schedule: str, job_name: str, fn: Callable) -> None:
        self.jobs.append(Job(Schedule(schedule), job_name, fn))

    async def _run_job(self, job: Job) -> None:
        tracer = getattr(self.container, "tracer", None)
        span = tracer.start_span(f"cron:{job.name}") if tracer else None
        start = time.perf_counter()
        try:
            if asyncio.iscoroutinefunction(job.fn):
                await job.fn(self._job_context())
            else:
                await asyncio.get_running_loop().run_in_executor(None, job.fn, self._job_context())
            self.container.logger.debug(
                f"cron job {job.name} completed in {int((time.perf_counter() - start) * 1e6)}us"
            )
        except Exception as e:  # noqa: BLE001 - a failing job must not kill the ticker
            self.container.logger.error(f"cron job {job.name} failed: {e!r}")
        finally:
            if span:
                span.end()

    def _job_context(self):
        from .context import Context

        return Context(_CronRequest(), self.container)

    def run_due(self, now: float | None = None) -> list[asyncio.Task]:
        t = time.localtime(now if now is not None else time.time())
        return [asyncio.ensure_future(self._run_job(j)) for j in self.jobs if j.schedule.matches(t)]

    async def run(self) -> None:
        running: set[asyncio.Task] = set()  # the loop holds tasks weakly
        # Align to minute boundaries like the reference's time.Ticker(minute)
        while True:
            now = time.time()
            await asyncio.sleep(60 - (now % 60) + 0.01)
            for task in self.run_due():
                running.add(task)
                task.add_done_callback(running.discard)


class _CronRequest:
    """Empty request so cron jobs get a normal Context."""

    def __init__(self):
        self.context: dict = {}

    def param(self, _key: str) -> str:
        return ""

    def params(self, _key: str) -> list[str]:
        return []

    def path_param(self, _key: str) -> str:
        return ""

    def bind(self, _target=None):
        return None

    def header(self, _key: str) -> str:
        return ""

    def host_name(self) -> str:
        return ""
