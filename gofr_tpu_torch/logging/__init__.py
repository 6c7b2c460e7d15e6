"""Leveled JSON-line logging (counterpart of gofr_tpu/logging/__init__.py,
without the terminal pretty printer and the remote log level).

One JSON object per line: ``level``, ``time``, ``message`` and any keyword
fields; ERROR and above go to stderr, the rest to stdout. A payload with
``to_log_dict()`` logs as that dictionary. Each line is written under a
lock, so the event loop, executor threads and the engine's scheduler can
share one logger.
"""

from __future__ import annotations

import io
import json
import sys
import threading
import time
from typing import Any, Protocol, runtime_checkable

DEBUG, INFO, NOTICE, WARN, ERROR, FATAL = 1, 2, 3, 4, 5, 6

_LEVEL_NAMES = {DEBUG: "DEBUG", INFO: "INFO", NOTICE: "NOTICE", WARN: "WARN", ERROR: "ERROR", FATAL: "FATAL"}
_NAME_LEVELS = {v: k for k, v in _LEVEL_NAMES.items()}
# ANSI foreground colours per level, for the terminal printer
_LEVEL_COLORS = {DEBUG: 36, INFO: 36, NOTICE: 36, WARN: 33, ERROR: 31, FATAL: 31}


def level_from_string(s: str | None) -> int:
    if not s:
        return INFO
    return _NAME_LEVELS.get(s.strip().upper(), INFO)


@runtime_checkable
class PrettyPrint(Protocol):
    """A log payload that renders itself on a terminal."""

    def pretty_print(self, writer: io.TextIOBase) -> None: ...


class Logger:
    """JSON lines, or coloured text when ``pretty`` (by default: when the
    output is a terminal)."""

    def __init__(self, level: int = INFO, out: Any = None, err: Any = None, pretty: bool | None = None):
        self.level = level
        self._out = out if out is not None else sys.stdout
        self._err = err if err is not None else sys.stderr
        if pretty is None:
            pretty = hasattr(self._out, "isatty") and self._out.isatty()
        self._pretty = pretty
        self._lock = threading.Lock()

    def change_level(self, level: int) -> None:
        self.level = level

    def _log(self, level: int, args: tuple, kwargs: dict) -> None:
        if level < self.level:
            return
        stream = self._err if level >= ERROR else self._out
        t = time.time()
        if self._pretty:
            self._emit_pretty(stream, level, t, args, kwargs)
        else:
            self._emit_json(stream, level, t, args, kwargs)

    def _emit_json(self, stream, level: int, t: float, args: tuple, kwargs: dict) -> None:
        if len(args) == 1:
            a = args[0]
            msg: Any = a.to_log_dict() if hasattr(a, "to_log_dict") else a
        else:
            msg = " ".join(str(a) for a in args)
        rec = {
            "level": _LEVEL_NAMES[level],
            "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t)) + f".{int((t % 1) * 1e6):06d}Z",
            "message": msg,
        }
        if kwargs:
            rec.update(kwargs)
        try:
            line = json.dumps(rec, default=str)
        except (TypeError, ValueError):
            rec["message"] = str(msg)
            line = json.dumps(rec, default=str)
        with self._lock:
            stream.write(line + "\n")

    def _emit_pretty(self, stream, level: int, t: float, args: tuple, kwargs: dict) -> None:
        buf = io.StringIO()
        buf.write(f"\x1b[{_LEVEL_COLORS[level]}m{_LEVEL_NAMES[level]:<6}\x1b[0m [{time.strftime('%H:%M:%S', time.localtime(t))}] ")
        for a in args:
            if isinstance(a, PrettyPrint):
                a.pretty_print(buf)
            else:
                buf.write(str(a))
                buf.write(" ")
        if kwargs:
            buf.write(" ".join(f"{k}={v}" for k, v in kwargs.items()))
        buf.write("\n")
        with self._lock:
            stream.write(buf.getvalue())

    def debug(self, *args: Any, **kw: Any) -> None:
        self._log(DEBUG, args, kw)

    def info(self, *args: Any, **kw: Any) -> None:
        self._log(INFO, args, kw)

    def notice(self, *args: Any, **kw: Any) -> None:
        self._log(NOTICE, args, kw)

    def warn(self, *args: Any, **kw: Any) -> None:
        self._log(WARN, args, kw)

    warning = warn

    def error(self, *args: Any, **kw: Any) -> None:
        self._log(ERROR, args, kw)

    def fatal(self, *args: Any, **kw: Any) -> None:
        self._log(FATAL, args, kw)

    def logf(self, level: int, fmt: str, *args: Any) -> None:
        self._log(level, (fmt % args if args else fmt,), {})


def new_logger(level_name: str | None = None) -> Logger:
    return Logger(level=level_from_string(level_name))


def new_file_logger(path: str, level: int = INFO) -> Logger:
    """A logger writing JSON lines to a file (CLI apps)."""
    f = open(path, "a", encoding="utf-8")  # noqa: SIM115 - lives as long as the process
    return Logger(level=level, out=f, err=f, pretty=False)


class MockLogger(Logger):
    """Keeps every record for assertions."""

    def __init__(self, level: int = DEBUG):
        self.records: list[tuple[int, tuple, dict]] = []
        super().__init__(level=level, out=io.StringIO(), err=io.StringIO(), pretty=False)

    def _log(self, level: int, args: tuple, kwargs: dict) -> None:
        if level >= self.level:
            self.records.append((level, args, kwargs))
        super()._log(level, args, kwargs)

    @property
    def stdout(self) -> str:
        return self._out.getvalue()

    @property
    def stderr(self) -> str:
        return self._err.getvalue()

    def messages(self, level: int | None = None) -> list[str]:
        return [" ".join(str(a) for a in args) for lvl, args, _ in self.records if level is None or lvl == level]


def new_mock_logger(level: int = DEBUG) -> MockLogger:
    return MockLogger(level)
