"""The port's examples (gofr_tpu_torch.examples) against the JAX package's
(examples/<name>/main.py), each booted in-process on ephemeral ports and
driven over real sockets the way tests/test_examples.py drives the JAX
ones: the same requests must give the same answers, and the framework
routes (health, liveness, favicon, 404) must answer in both."""

import http.server
import importlib
import importlib.util
import io
import json
import os
import threading
import urllib.error
import urllib.request
import zipfile

import pytest

from gofr_tpu.context import Context as JContext
from gofr_tpu_torch.context import Context as PContext

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _load_jax(example: str):
    path = os.path.join(EXAMPLES, example, "main.py")
    spec = importlib.util.spec_from_file_location(f"torch_cmp_example_{example.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_port(example: str):
    return importlib.import_module(f"gofr_tpu_torch.examples.{example.replace('-', '_')}")


@pytest.fixture()
def pair(request, monkeypatch):
    """Both apps of one example, serving: (JAX app, port app, their modules)."""
    name = request.param
    monkeypatch.setenv("HTTP_PORT", "0")
    monkeypatch.setenv("METRICS_PORT", "0")
    monkeypatch.setenv("LOG_LEVEL", "ERROR")
    monkeypatch.setenv("GOFR_HTTP_NATIVE", "0")
    monkeypatch.chdir(os.path.join(EXAMPLES, name))
    jmod, pmod = _load_jax(name), _load_port(name)
    apps = [jmod.build_app(), pmod.build_app()]
    threads = [a.run_in_background() for a in apps]
    yield apps[0], apps[1], jmod, pmod
    for a in apps:
        for svc in a.container.services.values():
            svc.close()
        a.shutdown()
    for th in threads:
        th.join(timeout=10)


def _call(app, method, path, body=None, headers=None, port=None):
    url = f"http://127.0.0.1:{port or app.http_server.port}{path}"
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _both(pair, method, path, body=None, headers=None):
    return [_call(a, method, path, body, headers) for a in pair[:2]]


def _framework_routes(pair):
    for app in pair[:2]:
        code, body = _call(app, "GET", "/.well-known/health")
        assert code == 200 and json.loads(body)["data"]["app"]["status"] == "UP"
    assert [s for s, _ in _both(pair, "GET", "/.well-known/alive")] == [200, 200]
    (js, jb), (ps, pb) = _both(pair, "GET", "/favicon.ico")
    assert js == ps == 200 and jb == pb
    (js, jb), (ps, pb) = _both(pair, "GET", "/definitely-not-a-route")
    assert js == ps == 404 and jb == pb


@pytest.mark.parametrize("pair", ["http-server"], indirect=True)
@pytest.mark.parametrize("path", ["/greet", "/hello?name=ada", "/hello", "/hello?name="])
def test_http_server(pair, path):
    (js, jb), (ps, pb) = _both(pair, "GET", path)
    assert (js, jb) == (ps, pb)
    assert js == (400 if path in ("/hello", "/hello?name=") else 200)
    _framework_routes(pair)


@pytest.mark.parametrize("pair", ["using-cron-jobs"], indirect=True)
def test_using_cron_jobs(pair):
    japp, papp, jmod, pmod = pair
    assert _both(pair, "GET", "/count") == [(200, b'{"data":{"count":0}}')] * 2
    # fire the job directly (the minutely tick is too slow for a test)
    japp._cron.jobs[0].fn(JContext(None, japp.container))
    papp._cron.jobs[0].fn(PContext(None, papp.container))
    assert _both(pair, "GET", "/count") == [(200, b'{"data":{"count":1}}')] * 2
    assert [(j.schedule.expr, j.name) for j in japp._cron.jobs] == [(j.schedule.expr, j.name) for j in papp._cron.jobs]
    _framework_routes(pair)


@pytest.mark.parametrize("pair", ["using-custom-metrics"], indirect=True)
def test_using_custom_metrics(pair):
    japp, papp, _, _ = pair
    assert _both(pair, "POST", "/transaction", b"{}") == [(201, b'{"data":"Transaction Successful"}')] * 2
    assert _both(pair, "POST", "/return", b"{}") == [(201, b'{"data":"Return Successful"}')] * 2
    scraped = []
    for app in (japp, papp):
        code, text = _call(app, "GET", "/metrics", port=app.metrics_server.port)
        assert code == 200
        scraped.append(sorted(ln for ln in text.decode().splitlines()
                              if ln.startswith(("transaction_success", "total_credit_day_sale", "product_stock"))
                              or (ln.startswith("transaction_time") and "_sum" not in ln)))
    assert scraped[0] == scraped[1]
    assert "product_stock 50" in scraped[1]
    _framework_routes(pair)


def _upload_body():
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("a.txt", "alpha")
        zf.writestr("b.txt", "beta")
    boundary = "testboundary123"
    parts = [
        f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; filename="{fname}"\r\n'
        f"Content-Type: {ctype}\r\n\r\n".encode() + content + b"\r\n"
        for name, fname, content, ctype in (("upload", "files.zip", buf.getvalue(), "application/zip"),
                                            ("a", "hello.txt", b"hello world", "text/plain"))
    ]
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


@pytest.mark.parametrize("pair", ["using-file-bind"], indirect=True)
def test_using_file_bind(pair):
    body, ctype = _upload_body()
    (js, jb), (ps, pb) = _both(pair, "POST", "/upload", body, {"Content-Type": ctype})
    assert (js, jb) == (ps, pb) and ps == 201
    assert json.loads(pb)["data"] == {"zip_entries": ["a.txt", "b.txt"], "file_name": "hello.txt",
                                      "file_content": "hello world"}
    # a missing part answers 400 in both
    only_a = body.split(b"--testboundary123\r\n")
    partial = b"--testboundary123\r\n" + only_a[2]
    (js, jb), (ps, pb) = _both(pair, "POST", "/upload", partial, {"Content-Type": ctype})
    assert (js, jb) == (ps, pb) and ps == 400
    _framework_routes(pair)


class _FactStub(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        body = b'{"fact": "cats sleep a lot", "length": 17}' if self.path.startswith("/fact") else b"{}"
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture()
def fact_upstream():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _FactStub)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    th.join(timeout=5)


@pytest.mark.parametrize("pair", ["using-http-service"], indirect=True)
def test_using_http_service(pair, fact_upstream):
    japp, papp, _, _ = pair
    for app in (japp, papp):
        app.container.get_http_service("fact-service").address = fact_upstream
    (js, jb), (ps, pb) = _both(pair, "GET", "/fact?max=50")
    assert (js, jb) == (ps, pb) and ps == 200
    assert json.loads(pb)["data"]["fact"] == "cats sleep a lot"
    jsvc, psvc = (a.container.get_http_service("fact-service") for a in (japp, papp))
    assert (jsvc.health_endpoint, jsvc.circuit.threshold, jsvc.circuit.interval) == \
        (psvc.health_endpoint, psvc.circuit.threshold, psvc.circuit.interval)
    health = [json.loads(_call(a, "GET", "/.well-known/health")[1])["data"]["fact-service"] for a in (japp, papp)]
    assert [h["status"] for h in health] == ["UP", "UP"]
    _framework_routes(pair)


@pytest.mark.parametrize("pair", ["using-http-service"], indirect=True)
def test_using_http_service_upstream_error(pair):
    _, papp, _, _ = pair
    # nothing listens at the default address: the client's error is masked as in every handler
    papp.container.get_http_service("fact-service").address = "http://127.0.0.1:1"
    status, body = _call(papp, "GET", "/fact")
    assert status == 500 and json.loads(body) == {"error": {"message": "some unexpected error has occurred"}}


@pytest.mark.parametrize("argv", [["hello"], ["params", "-name=Vikash"], ["nope"], [], ["help"]])
def test_sample_cmd(argv, monkeypatch, capsys):
    monkeypatch.chdir(os.path.join(EXAMPLES, "sample-cmd"))
    out = []
    for mod in (_load_jax("sample-cmd"), _load_port("sample-cmd")):
        rc = mod.build_app().run(argv)
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    assert out[0] == out[1]
    assert out[1][0] == (1 if argv == ["nope"] else 0)
