"""The remote log level (counterpart of gofr_tpu/logging/remote.py): a
logger that polls REMOTE_LOG_URL every REMOTE_LOG_FETCH_INTERVAL seconds
(15) and applies the level it answers. The body is ``{"data":
[{"serviceName": ..., "logLevel": "DEBUG"}]}`` or ``{"logLevel":
"DEBUG"}``. The container always installs it; the poller thread runs only
when a URL is set, and stops at ``close()``.
"""

from __future__ import annotations

import json
import threading
import urllib.request

from . import Logger, level_from_string


class RemoteLevelLogger(Logger):
    def __init__(self, level: int, url: str | None, interval_s: float = 15.0, **kw):
        super().__init__(level=level, **kw)
        self._url = url
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if url:
            self._thread = threading.Thread(target=self._poll, daemon=True, name="gofr-remote-log-level")
            self._thread.start()

    def _fetch_level(self) -> int | None:
        assert self._url is not None
        with urllib.request.urlopen(self._url, timeout=5) as resp:  # noqa: S310
            body = json.loads(resp.read().decode("utf-8"))
        if isinstance(body, dict):
            data = body.get("data")
            if isinstance(data, list) and data and isinstance(data[0], dict):
                lvl = data[0].get("logLevel") or data[0].get("LOG_LEVEL")
                if lvl:
                    return level_from_string(lvl)
            lvl = body.get("logLevel") or body.get("LOG_LEVEL")
            if lvl:
                return level_from_string(lvl)
        return None

    def _poll(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                lvl = self._fetch_level()
                if lvl is not None and lvl != self.level:
                    self.change_level(lvl)
            except Exception:  # noqa: BLE001 - the poller must never die
                continue

    def close(self) -> None:
        self._stop.set()


def new(level_name: str | None, url: str | None, interval_s: float = 15.0) -> RemoteLevelLogger:
    return RemoteLevelLogger(level_from_string(level_name), url, interval_s)
