"""The metrics server (counterpart of gofr_tpu/metrics/server.py): a
stdlib ThreadingHTTPServer on the App's METRICS_PORT (2121 by default; 0
binds an ephemeral port, read back from ``port``) that answers ``GET
/metrics`` with the manager's exposition, refreshing the Python runtime
gauges at each scrape. An ``Accept: application/openmetrics-text`` scrape
gets OpenMetrics with exemplars. Scrapes are rare and must not contend
with the asyncio serving loop, hence a thread of its own; a failed bind
raises."""

from __future__ import annotations

import gc
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import Manager

try:
    import resource
except ImportError:  # non-posix
    resource = None  # type: ignore[assignment]


def refresh_runtime_gauges(m: Manager) -> None:
    """The Python runtime's gauges: threads, gen-0 allocations, completed
    collections and the resident set size."""
    m.set_gauge("app_python_threads", float(threading.active_count()))
    counts = gc.get_count()
    m.set_gauge("app_python_gc_gen0", float(counts[0]))
    m.set_gauge("app_python_num_gc", float(gc.get_stats()[-1].get("collections", 0)))
    if resource is not None:
        # ru_maxrss is KiB on Linux
        m.set_gauge("app_sys_memory_rss", float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024.0)


class _Handler(BaseHTTPRequestHandler):
    manager: Manager = None  # type: ignore[assignment]

    def do_GET(self):  # noqa: N802
        if self.path.split("?")[0] not in ("/metrics", "/metrics/"):
            self.send_response(404)
            self.end_headers()
            return
        refresh_runtime_gauges(self.manager)
        # OpenMetrics negotiation (how Prometheus asks for exemplars):
        # exemplar suffixes are only legal on the openmetrics content type,
        # so the plain scrape stays byte-compatible 0.0.4.
        accept = self.headers.get("Accept", "")
        openmetrics = "application/openmetrics-text" in accept
        if openmetrics:
            body = self.manager.render_openmetrics().encode("utf-8")
            ctype = "application/openmetrics-text; version=1.0.0; charset=utf-8"
        else:
            body = self.manager.render_prometheus().encode("utf-8")
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence default stderr access log
        pass


class MetricsServer:
    def __init__(self, manager: Manager, port: int = 2121, host: str = "0.0.0.0"):
        self.manager = manager
        self.port = port
        self.host = host
        self.reuse_port = False  # HTTP_WORKERS prefork: every worker binds the port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        handler = type("BoundHandler", (_Handler,), {"manager": self.manager})
        server_cls = ThreadingHTTPServer
        if self.reuse_port:
            server_cls = type("ReusePortHTTPServer", (ThreadingHTTPServer,), {"allow_reuse_port": True})
        self._httpd = server_cls((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True, name="gofr-metrics-server")
        self._thread.start()

    def shutdown(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
