"""The port's outbound service client (gofr_tpu_torch.service) against the
JAX package's (gofr_tpu.service): both clients make the same calls to one
local stub upstream and must see the same answers, send the same headers,
move their breakers through the same states and record the same
app_http_service_response series; an SSE upstream streams through
``astream`` to the same bytes; HTTPS with a custom CA, an untrusted CA and
verification off behaves the same."""

import asyncio
import http.server
import json
import ssl
import threading
import time
import urllib.error

import pytest

from gofr_tpu import service as jsvc
from gofr_tpu.metrics import new_metrics_manager as jax_manager
from gofr_tpu.testutil import self_signed_cert
from gofr_tpu_torch import service as psvc
from gofr_tpu_torch.app import new
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.metrics import new_metrics_manager as port_manager

PACKAGES = {"jax": (jsvc, jax_manager), "port": (psvc, port_manager)}
SSE_EVENTS = [f'data: {{"n": {i}, "text": "chunk {i}"}}\n\n'.encode() for i in range(5)] + [b"data: [DONE]\n\n"]


class _Stub(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    state = {"fail": False, "down_health": False}

    def _send(self, status, body: bytes, ctype="application/json"):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _any(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        path = self.path.split("?")[0]
        if path == "/echo":
            self._send(200, json.dumps({
                "method": self.command, "query": self.path.partition("?")[2], "body": body.decode(),
                "auth": self.headers.get("Authorization", ""), "apikey": self.headers.get("X-API-KEY", ""),
                "custom": self.headers.get("X-Custom", ""), "ctype": self.headers.get("Content-Type", ""),
                "traceparent": self.headers.get("traceparent", ""),
            }, sort_keys=True).encode())
        elif path == "/flaky":
            self._send(500 if self.state["fail"] else 200, b'{"ok": false}' if self.state["fail"] else b'{"ok": true}')
        elif path in ("/.well-known/alive", "/custom-health"):
            self._send(503 if self.state["down_health"] else 200, b'{"data": {"status": "UP"}}')
        elif path == "/sse":
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for ev in SSE_EVENTS:
                self.wfile.write(f"{len(ev):x}\r\n".encode() + ev + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
        else:
            self._send(404, b'{"error": "no route"}')

    do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _any

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def upstream():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    srv.daemon_threads = True
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", _Stub.state
    srv.shutdown()
    srv.server_close()
    th.join(timeout=5)


def _both(fn):
    """fn(service module, metrics manager) for both packages -> (jax, port)."""
    out = []
    for mod, manager in PACKAGES.values():
        out.append(fn(mod, manager()))
    return out


@pytest.mark.parametrize("verb", ["get", "post", "put", "patch", "delete"])
def test_verbs_equal(upstream, verb):
    base, _ = upstream

    def call(mod, m):
        svc = mod.new_http_service(base, None, m)
        kw = {"params": {"q": "1"}} if verb == "get" else {"json": {"x": [1, 2]}}
        r = getattr(svc, verb)("/echo", **kw)
        return r.status_code, r.json(), r.text()

    j, p = _both(call)
    assert j == p
    assert j[1]["method"] == verb.upper()


@pytest.mark.parametrize("option", ["basic", "apikey", "custom"])
def test_option_headers_equal(upstream, option):
    base, _ = upstream

    def call(mod, m):
        opt = {"basic": lambda: mod.BasicAuth("ada", "s3cret"), "apikey": lambda: mod.APIKeyAuth("k-123"),
               "custom": lambda: mod.CustomHeaders({"X-Custom": "yes"})}[option]()
        return mod.new_http_service(base, None, m, opt).get("echo").json()

    j, p = _both(call)
    assert j == p
    assert j["auth"] or j["apikey"] or j["custom"]


def test_async_verbs_equal(upstream):
    base, _ = upstream

    def call(mod, m):
        svc = mod.new_http_service(base, None, m)

        async def run():
            return [(r.status_code, r.json()) for r in await asyncio.gather(
                svc.aget("echo"), svc.apost("echo", body=b"raw"), svc.aput("echo", json=[1]), svc.adelete("echo"))]

        return asyncio.run(run())

    j, p = _both(call)
    assert j == p


def test_health_custom_and_down(upstream):
    base, state = upstream

    def call(mod, m):
        up = mod.new_http_service(base, None, m, mod.HealthConfig("/custom-health")).health_check_sync()
        state["down_health"] = True
        try:
            down = mod.new_http_service(base, None, m).health_check_sync()
        finally:
            state["down_health"] = False
        gone = mod.new_http_service("http://127.0.0.1:1", None, m).health_check_sync()
        strip = lambda h: (h["status"], {k: v for k, v in h["details"].items() if k not in ("latency_ms", "error")})  # noqa: E731
        return strip(up), strip(down), strip(gone)

    j, p = _both(call)
    assert j == p
    assert [h[0] for h in j] == ["UP", "DOWN", "DOWN"]


def test_breaker_transitions_equal(upstream):
    base, state = upstream

    def call(mod, m):
        svc = mod.new_http_service(base, None, m, mod.CircuitBreaker(threshold=3, interval=0.1))
        seen = []
        state["fail"] = True
        try:
            for _ in range(3):
                seen.append((svc.get("flaky").status_code, svc.circuit.state, svc.circuit.failures))
            with pytest.raises(mod.CircuitOpenError) as ei:
                svc.get("flaky")
            seen.append((str(ei.value).replace(base, "BASE"), ei.value.status_code()))
            state["fail"] = False
            deadline = time.monotonic() + 5
            while svc.circuit.state == "open" and time.monotonic() < deadline:
                time.sleep(0.02)
            seen.append((svc.circuit.state, svc.get("flaky").status_code, svc.circuit.failures))
        finally:
            state["fail"] = False
            svc.close()
        return seen

    j, p = _both(call)
    assert j == p
    assert j[2] == (500, "open", 3) and j[-1] == ("closed", 200, 0)


def test_transport_failure_opens():
    def call(mod, m):
        svc = mod.new_http_service("http://127.0.0.1:1", None, m, mod.CircuitBreaker(threshold=1, interval=1.0))
        with pytest.raises(OSError):
            svc.get("x", timeout=0.5)
        state = svc.circuit.state
        svc.close()
        return state

    assert _both(call) == ["open", "open"]


def test_service_response_series_equal(upstream):
    base, _ = upstream

    def call(mod, m):
        svc = mod.new_http_service(base, None, m)
        svc.get("echo")
        svc.post("echo", json={})
        svc.get("nowhere")
        with pytest.raises(OSError):
            mod.new_http_service("http://127.0.0.1:1", None, m).get("x", timeout=0.5)
        text = m.render_prometheus()
        return sorted(ln.rsplit(" ", 1)[0] for ln in text.splitlines()
                      if ln.startswith("app_http_service_response_count"))

    j, p = _both(call)
    assert j == p
    assert 'app_http_service_response_count{method="GET",path="nowhere",status="404"}' in j


@pytest.mark.parametrize("read", ["chunks", "aread"])
def test_sse_through_astream_equal(upstream, read):
    base, _ = upstream

    def call(mod, m):
        svc = mod.new_http_service(base, None, m)

        async def run():
            out = []
            for _ in range(2):  # the second exchange reuses the pooled socket
                st = await svc.astream("GET", "sse", timeout=10.0)
                body = (b"".join([c async for c in st.aiter_raw()]) if read == "chunks" else await st.aread())
                out.append((st.status_code, st.streamed, st.headers.get("content-type"), body))
            stats = svc.pool_stats()
            svc.close()
            return out, (stats["hits"], stats["dials"])

        return asyncio.run(run())

    j, p = _both(call)
    assert j == p
    status, streamed, ctype, body = j[0][0]
    assert status == 200 and streamed and ctype == "text/event-stream"
    assert body == b"".join(SSE_EVENTS)
    assert j[1] == (1, 1)


@pytest.fixture(scope="module")
def tls_upstream():
    cert, key = self_signed_cert()
    app = new(config=new_mock_config({"APP_NAME": "tls-upstream", "HTTP_PORT": "0", "METRICS_PORT": "0",
                                      "LOG_LEVEL": "FATAL", "HTTP_TLS_CERT_FILE": cert, "HTTP_TLS_KEY_FILE": key}))
    app.get("/ping", lambda ctx: "pong")
    th = app.run_in_background()
    yield f"https://127.0.0.1:{app.http_server.port}", cert
    app.shutdown()
    th.join(timeout=10)


@pytest.mark.parametrize("mode", ["custom_ca", "insecure", "untrusted"])
def test_tls_modes_equal(tls_upstream, mode):
    base, cert = tls_upstream

    def call(mod, m):
        opts = {"custom_ca": (mod.TLSConfig(ca_cert=cert),), "insecure": (mod.TLSConfig(insecure=True),),
                "untrusted": ()}[mode]
        svc = mod.new_http_service(base, None, m, *opts)
        try:
            r = svc.get("/ping")
            out = (r.status_code, r.json())
        except (ssl.SSLError, urllib.error.URLError, OSError) as e:
            out = ("refused", type(getattr(e, "reason", e)).__name__)

        async def stream():
            try:
                return (await (await svc.astream("GET", "ping", timeout=5.0)).aread()).decode()
            except (ssl.SSLError, OSError) as e:
                return type(e).__name__

        return out, asyncio.run(stream())

    j, p = _both(call)
    assert j == p
    if mode == "untrusted":
        assert j[0][0] == "refused"
    else:
        assert j == ((200, {"data": "pong"}), '{"data":"pong"}')
