"""Leveled JSON-line logging (counterpart of gofr_tpu/logging/__init__.py,
without the terminal pretty printer and the remote log level).

One JSON object per line: ``level``, ``time``, ``message`` and any keyword
fields; ERROR and above go to stderr, the rest to stdout. A payload with
``to_log_dict()`` logs as that dictionary. Each line is written under a
lock, so the event loop, executor threads and the engine's scheduler can
share one logger.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any

DEBUG, INFO, NOTICE, WARN, ERROR, FATAL = 1, 2, 3, 4, 5, 6

_LEVEL_NAMES = {DEBUG: "DEBUG", INFO: "INFO", NOTICE: "NOTICE", WARN: "WARN", ERROR: "ERROR", FATAL: "FATAL"}
_NAME_LEVELS = {v: k for k, v in _LEVEL_NAMES.items()}


def level_from_string(s: str | None) -> int:
    if not s:
        return INFO
    return _NAME_LEVELS.get(s.strip().upper(), INFO)


class Logger:
    def __init__(self, level: int = INFO, out: Any = None, err: Any = None):
        self.level = level
        self._out = out if out is not None else sys.stdout
        self._err = err if err is not None else sys.stderr
        self._lock = threading.Lock()

    def _log(self, level: int, args: tuple, kwargs: dict) -> None:
        if level < self.level:
            return
        t = time.time()
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
        stream = self._err if level >= ERROR else self._out
        with self._lock:
            stream.write(line + "\n")

    def debug(self, *args: Any, **kw: Any) -> None:
        self._log(DEBUG, args, kw)

    def info(self, *args: Any, **kw: Any) -> None:
        self._log(INFO, args, kw)

    def warn(self, *args: Any, **kw: Any) -> None:
        self._log(WARN, args, kw)

    warning = warn

    def error(self, *args: Any, **kw: Any) -> None:
        self._log(ERROR, args, kw)


def new_logger(level_name: str | None = None) -> Logger:
    return Logger(level=level_from_string(level_name))

