"""The port's App surface against the JAX package's, on the CPU: the router
with ``{name}`` and ``{rest...}`` segments on one route table (404/405
included), every verb and ``use_middleware`` order, static files, swagger
and the favicon, the metrics server's scrape, CORS overrides, HTTPS,
multipart and zip binding, cron expressions and their next fire times,
background tasks, the CLI app (help, flags, unknown commands, ``replay
-bundle`` and ``replay -id`` against a tiny-preset port app), the leveled
logger and the remote log level. Both packages get the same inputs and
must give the same answers."""

import asyncio
import calendar
import dataclasses
import http.client
import http.server
import io
import json
import os
import ssl
import threading
import time
import zipfile

import pytest

import gofr_tpu
from gofr_tpu import cmd as jcmd
from gofr_tpu import cron as jcron
from gofr_tpu import logging as jlog
from gofr_tpu.config import new_mock_config as jax_mock_config
from gofr_tpu.fileutil import Zip as JZip
from gofr_tpu.http import errors as jerrors
from gofr_tpu.http import responder as jresp
from gofr_tpu.http.request import Request as JRequest
from gofr_tpu.http.request import UploadedFile as JUploadedFile
from gofr_tpu.http.router import Router as JRouter
from gofr_tpu.logging import remote as jremote
from gofr_tpu.testutil import self_signed_cert
from gofr_tpu_torch import app as papp_mod
from gofr_tpu_torch import cmd as pcmd
from gofr_tpu_torch import cron as pcron
from gofr_tpu_torch import logging as plog
from gofr_tpu_torch import new_cmd
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.fileutil import Zip as PZip
from gofr_tpu_torch.http import errors as perrors
from gofr_tpu_torch.http import responder as presp
from gofr_tpu_torch.http.request import Request as PRequest
from gofr_tpu_torch.http.request import UploadedFile as PUploadedFile
from gofr_tpu_torch.http.router import Router as PRouter
from gofr_tpu_torch.logging import remote as premote

BASE = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "FATAL", "REQUEST_TIMEOUT": "5",
        "ACCESS_CONTROL_ALLOW_ORIGIN": "https://example.com", "ACCESS_CONTROL_ALLOW_CREDENTIALS": "true"}
SPEC = {"openapi": "3.0.0", "info": {"title": "surface"}, "paths": {"/users/{id}": {"get": {"summary": "a user"}}}}

# -- the router on one route table ----------------------------------------------

ROUTE_TABLE = [
    ("GET", "/users"), ("GET", "/users/{id}"), ("PUT", "/users/{id}"), ("GET", "/users/me"),
    ("GET", "/users/{id}/orders/{oid}"), ("DELETE", "/users/{id}/orders/{oid}"), ("GET", "/files/{rest...}"),
    ("POST", "/files/{rest...}"), ("GET", "/"), ("GET", "/a/{x}/c"), ("GET", "/a/b/{y}"),
]
REQUESTS = [
    ("GET", "/users"), ("GET", "/users/7"), ("PUT", "/users/7"), ("PATCH", "/users/7"), ("GET", "/users/me"),
    ("PUT", "/users/me"), ("GET", "/users/7/orders/9"), ("DELETE", "/users/7/orders/9"), ("POST", "/users/7/orders/9"),
    ("GET", "/users/7/orders"), ("GET", "/files/a/b/c.txt"), ("GET", "/files/"), ("GET", "/files"),
    ("POST", "/files/x"), ("DELETE", "/files/x"), ("GET", "/"), ("OPTIONS", "/users"), ("GET", "/nope"),
    ("GET", "/users//orders/9"), ("GET", "/a/z/c"), ("GET", "/a/b/q"), ("GET", "/a/b/c"), ("HEAD", "/users"),
]


def _router(Router, Response):
    r = Router()
    for method, template in ROUTE_TABLE:
        async def h(req, t=template):
            return Response(200, [], json.dumps({"t": t, "p": req.path_params}, sort_keys=True).encode())
        r.add(method, template, h)
    return r


@pytest.mark.parametrize("method,path", REQUESTS)
def test_router_matches_jax(method, path):
    out = []
    for Router, Request, Response in ((JRouter, JRequest, jresp.Response), (PRouter, PRequest, presp.Response)):
        r = _router(Router, Response)
        req = Request(method, path, {})
        resp = asyncio.run(r.dispatch(req))
        out.append((resp.status, resp.body, req.route_template, req.path_params, r.routes(),
                    r.has("GET", "/users/"), r.has("GET", "/users/{id}")))
    assert out[0] == out[1]


def test_router_catch_all_must_be_last():
    for Router in (JRouter, PRouter):
        with pytest.raises(ValueError):
            Router().add("GET", "/x/{rest...}/y", None)


# -- request, responder and errors ----------------------------------------------

@dataclasses.dataclass
class Form:
    name: str
    age: int = 0
    ok: bool = False
    ratio: float = 0.0


def _multipart(parts, boundary="b0undary"):
    body = b""
    for name, fname, content in parts:
        disp = f'form-data; name="{name}"' + (f'; filename="{fname}"' if fname else "")
        body += f"--{boundary}\r\nContent-Disposition: {disp}\r\nContent-Type: text/plain\r\n\r\n".encode()
        body += content + b"\r\n"
    return body + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def _zip_bytes(files):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for n, c in files.items():
            zf.writestr(n, c)
    return buf.getvalue()


@pytest.mark.parametrize("case", ["json_dataclass", "json_missing", "json_bad_int", "multipart_fields", "multipart_files",
                                  "multipart_dataclass", "dict_merge", "not_json", "no_boundary"])
def test_bind_matches_jax(case):
    def run(Request, Zip, UploadedFile):
        @dataclasses.dataclass
        class Upload:
            archive: Zip = None
            note: UploadedFile = dataclasses.field(default=None, metadata={"file": "a"})
            title: str = ""

        body, ctype = {
            "json_dataclass": (b'{"name": "ada", "age": "36", "ok": "yes", "ratio": 2}', "application/json"),
            "json_missing": (b'{"age": 3}', "application/json"),
            "json_bad_int": (b'{"name": "x", "age": "old"}', "application/json"),
            "dict_merge": (b'{"k": 1}', "application/json"),
            "not_json": (b"{nope", "application/json"),
            "no_boundary": (b"x", "multipart/form-data"),
        }.get(case) or _multipart([("title", None, b"hello"), ("archive", "z.zip", _zip_bytes({"a.txt": "1", "b/c": "2"})),
                                   ("a", "note.txt", b"note body")])
        req = Request("POST", "/x?x=1&x=2", {"content-type": ctype, "host": "svc:80", "x-forwarded-proto": "https"}, body)
        target = {"json_dataclass": Form, "json_missing": Form, "json_bad_int": Form, "multipart_dataclass": Upload,
                  "dict_merge": {"base": 0}}.get(case)
        try:
            got = req.bind(target)
        except Exception as e:  # noqa: BLE001 — the error is part of the answer
            return type(e).__name__, getattr(e, "status_code", None), str(e)
        if isinstance(got, dict):
            got = {k: (v.filename, v.content, v.content_type) if isinstance(v, UploadedFile) else v for k, v in got.items()}
        elif dataclasses.is_dataclass(got) and isinstance(got, Upload):
            got = (sorted(got.archive.files.items()), got.note.filename, got.note.content, got.title)
        elif dataclasses.is_dataclass(got):
            got = dataclasses.asdict(got)
        return got, req.params("x"), req.param("x"), req.host_name(), req.content_type

    j, p = run(JRequest, JZip, JUploadedFile), run(PRequest, PZip, PUploadedFile)
    assert j == p


def test_responder_and_errors_match_jax():
    cases = [
        (jresp.Raw({"a": 1}), presp.Raw({"a": 1})), (jresp.Redirect("/to"), presp.Redirect("/to")),
        (jresp.Redirect("/to", 301), presp.Redirect("/to", 301)),
    ]
    for jr, pr in cases:
        a, b = jresp.respond(jr, None), presp.respond(pr, None)
        assert (a.status, a.headers, a.body) == (b.status, b.headers, b.body)
    errs = [(jerrors.ErrorMissingParam("a", "b"), perrors.ErrorMissingParam("a", "b")),
            (jerrors.ErrorTooManyRequests(retry_after=2.5), perrors.ErrorTooManyRequests(retry_after=2.5)),
            (jerrors.ErrorTooManyRequests(), perrors.ErrorTooManyRequests())]
    for je, pe in errs:
        a, b = jresp.respond(None, je, "POST"), presp.respond(None, pe, "POST")
        assert (a.status, a.headers, a.body) == (b.status, b.headers, b.body)


# -- two served apps with one registration ------------------------------------------

def _register(app, events):
    app.get("/users/{id}", lambda ctx: {"id": ctx.path_param("id"), "tags": ctx.params("tag"),
                                        "host": ctx.host_name(), "user": ctx.authenticated_user})
    app.put("/users/{id}", lambda ctx: {"put": ctx.path_param("id"), "body": ctx.bind()})
    app.patch("/users/{id}", lambda ctx: {"patch": ctx.path_param("id")})
    app.delete("/users/{id}", lambda ctx: None)
    app.get("/files/{rest...}", lambda ctx: ctx.path_param("rest"))

    def order(tag):
        def mw(nxt):
            async def h(req):
                req.context.setdefault("order", []).append(tag)
                resp = await nxt(req)
                resp.headers.append(("X-Order", ",".join(req.context["order"])))
                return resp
            return h
        return mw

    app.use_middleware(order("a"), order("b"))
    app.use_middleware(order("c"))

    async def task():
        events["started"].set()
        try:
            await asyncio.sleep(3600)
        except asyncio.CancelledError:
            events["cancelled"].set()
            raise

    app.add_background_task(task)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("surface")
    (root / "static").mkdir()
    (root / "static" / "openapi.json").write_text(json.dumps(SPEC))
    (root / "assets").mkdir()
    (root / "assets" / "index.html").write_text("<h1>home</h1>")
    (root / "assets" / "app.js").write_text("console.log(1)")
    (root / "secret.txt").write_text("no")
    cwd = os.getcwd()
    os.chdir(root)  # swagger reads ./static/openapi.json at start-up
    apps, threads, events = [], [], []
    try:
        for app in (gofr_tpu.new(config=jax_mock_config({**BASE, "GOFR_HTTP_NATIVE": "0", "TRACE_EXPORTER": "none"})),
                    papp_mod.new(config=new_mock_config(BASE))):
            ev = {"started": threading.Event(), "cancelled": threading.Event()}
            _register(app, ev)
            app.add_static_files("/assets", str(root / "assets"))
            threads.append(app.run_in_background())
            apps.append(app)
            events.append(ev)
    finally:
        os.chdir(cwd)
    yield apps, events
    for app in apps:
        app.shutdown()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    assert events[1]["cancelled"].wait(5)  # the port awaits its cancelled tasks


def _call(port, method, path, body=None, headers=None, context=None):
    conn = (http.client.HTTPSConnection("127.0.0.1", port, timeout=10, context=context) if context
            else http.client.HTTPConnection("127.0.0.1", port, timeout=10))
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        hdrs = {k.lower(): v for k, v in resp.getheaders() if k.lower() not in ("date", "x-correlation-id", "server")}
        return resp.status, resp.read(), hdrs
    finally:
        conn.close()


SURFACE = [
    ("GET", "/users/42?tag=a&tag=b", None), ("PUT", "/users/42", b'{"x": 1}'), ("PATCH", "/users/42", None),
    ("DELETE", "/users/42", None), ("POST", "/users/42", None), ("GET", "/files/deep/er/f.bin", None),
    ("GET", "/nowhere", None), ("OPTIONS", "/users/42", None), ("GET", "/assets/", None),
    ("GET", "/assets/app.js", None), ("GET", "/assets/missing.js", None), ("GET", "/assets/../secret.txt", None),
    ("GET", "/assets/%2e%2e/secret.txt", None), ("GET", "/favicon.ico", None),
    ("GET", "/.well-known/openapi.json", None), ("GET", "/.well-known/alive", None),
]


@pytest.mark.parametrize("method,path,body", SURFACE)
def test_served_surface_matches_jax(served, method, path, body):
    apps, _ = served
    j, p = (_call(a.http_server.port, method, path, body, {"Host": "svc.local:8000", "Content-Type": "application/json"})
            for a in apps)
    assert j == p
    if method == "OPTIONS":
        assert p[2]["access-control-allow-origin"] == "https://example.com"
        assert p[2]["access-control-allow-credentials"] == "true"
    elif path.startswith("/users/42") and method != "POST":
        assert p[2]["x-order"] == "a,b,c"


def test_swagger_page_served(served):
    apps, _ = served
    (js, jb, jh), (ps, pb, ph) = (_call(a.http_server.port, "GET", "/.well-known/swagger") for a in apps)
    assert js == ps == 200 and jb == pb and jh["content-type"] == ph["content-type"] == "text/html; charset=utf-8"
    assert json.loads(_call(apps[1].http_server.port, "GET", "/.well-known/openapi.json")[1]) == SPEC


def test_background_tasks_started(served):
    _, events = served
    assert all(ev["started"].wait(5) for ev in events)


def test_metrics_server_scrape_matches_jax(served):
    apps, _ = served
    for a in apps:
        _call(a.http_server.port, "GET", "/users/1")
        _call(a.http_server.port, "GET", "/nowhere")

    def labels(app, accept=None):
        s, body, h = _call(app.metrics_server.port, "GET", "/metrics", headers={"Accept": accept} if accept else {})
        assert s == 200
        names = {ln.split(" ")[0] for ln in body.decode().splitlines() if ln.startswith("app_http_response_count")}
        gauges = {ln.split("{")[0].split(" ")[0] for ln in body.decode().splitlines()
                  if ln.startswith(("app_python_", "app_sys_", "app_info"))}
        return names, gauges, h["content-type"]

    j, p = labels(apps[0]), labels(apps[1])
    assert j[1] == p[1] and j[2] == p[2]
    assert 'app_http_response_count{method="GET",path="/users/{id}",status="200"}' in p[0]
    assert 'app_http_response_count{method="GET",path="/__unmatched__",status="404"}' in p[0]
    assert p[0] <= j[0] | p[0] and {n for n in j[0] if "/users/{id}" in n} == {n for n in p[0] if "/users/{id}" in n}
    assert labels(apps[0], "application/openmetrics-text")[2] == labels(apps[1], "application/openmetrics-text")[2]
    assert _call(apps[1].metrics_server.port, "GET", "/other")[0] == _call(apps[0].metrics_server.port, "GET", "/other")[0]


def test_metrics_bind_failure_raises():
    taken = papp_mod.new(config=new_mock_config({**BASE}))
    th = taken.run_in_background()
    try:
        clash = papp_mod.new(config=new_mock_config({**BASE, "METRICS_PORT": str(taken.metrics_server.port)}))
        with pytest.raises(OSError):
            clash.metrics_server.start()
    finally:
        taken.shutdown()
        th.join(timeout=10)


def test_https_serving_matches_jax():
    cert, key = self_signed_cert()
    tls = {"HTTP_TLS_CERT_FILE": cert, "HTTP_TLS_KEY_FILE": key}
    apps = [gofr_tpu.new(config=jax_mock_config({**BASE, **tls, "GOFR_HTTP_NATIVE": "0", "TRACE_EXPORTER": "none"})),
            papp_mod.new(config=new_mock_config({**BASE, **tls}))]
    threads = []
    for a in apps:
        a.get("/ping/{who}", lambda ctx: f"pong {ctx.path_param('who')}")
        threads.append(a.run_in_background())
    try:
        ctx = ssl.create_default_context(cafile=cert)
        j, p = (_call(a.http_server.port, "GET", "/ping/x", context=ctx) for a in apps)
        assert j == p and p[0] == 200 and json.loads(p[1]) == {"data": "pong x"}
        with pytest.raises(ssl.SSLError):
            _call(apps[1].http_server.port, "GET", "/ping/x", context=ssl.create_default_context())
    finally:
        for a, th in zip(apps, threads):
            a.shutdown()
            th.join(timeout=10)


# -- cron ---------------------------------------------------------------------------

CRON_EXPRS = ["* * * * *", "*/15 * * * *", "0 9-17 * * 1-5", "5,10,55 0 1 1 *", "0 0 29 2 *", "30 2 * * 0",
              "0-59/7 */5 1-31/3 * *", "1 2 3 4 5", "bad", "* * * *", "60 * * * *", "* * 0 * *", "*/0 * * * *",
              "5-1 * * * *", "a-b * * * *", "* * * 13 *", "* * * * 7"]


def _next_fire(sched, start: float, limit_minutes: int = 60 * 24 * 800) -> float | None:
    t = start - start % 60 + 60
    for _ in range(limit_minutes):
        if sched.matches(time.gmtime(t)):
            return t
        t += 60
    return None


@pytest.mark.parametrize("expr", CRON_EXPRS)
def test_cron_parse_and_next_fire_match_jax(expr):
    out = []
    for mod in (jcron, pcron):
        try:
            s = mod.Schedule(expr)
        except mod.CronScheduleError as e:
            out.append(("error", str(e)))
            continue
        start = calendar.timegm((2026, 2, 27, 23, 58, 0, 0, 0, 0))
        fires, t = [], start
        for _ in range(3):
            t = _next_fire(s, t)
            fires.append(t)
            if t is None:
                break
        out.append((sorted(s.minutes), sorted(s.hours), sorted(s.days), sorted(s.months), sorted(s.weekdays), fires))
    assert out[0] == out[1]


def test_cron_runs_due_jobs_in_spans():
    for mod, new_app, cfg in ((jcron, gofr_tpu.new, jax_mock_config), (pcron, papp_mod.new, new_mock_config)):
        app = new_app(config=cfg({**BASE, "TRACE_EXPORTER": "none"}))
        ran = []

        async def ajob(ctx):
            ran.append(("async", ctx.path_param("x")))

        app.add_cron_job("* * * * *", "every", lambda ctx: ran.append(("sync", ctx.param("x"))))
        app.add_cron_job("0 0 1 1 *", "yearly", ajob)
        app.add_cron_job("* * * * *", "boom", lambda ctx: 1 / 0)

        async def tick():
            tasks = app._cron.run_due(calendar.timegm((2026, 3, 3, 10, 0, 0, 0, 0, 0)) - time.timezone)
            await asyncio.gather(*tasks)
            return len(tasks)

        assert asyncio.run(tick()) == 2
        assert ran == [("sync", "")]
        with pytest.raises(mod.CronScheduleError):
            app.add_cron_job("* *", "bad", lambda ctx: None)


# -- the CLI app ---------------------------------------------------------------------

@dataclasses.dataclass
class Flags:
    name: str = ""
    n: int = 0
    verbose: bool = False
    ratio: float = 1.0


def _cli(run, argv, capsys):
    rc = run(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _cmd_app(package):
    if package == "jax":
        app = gofr_tpu.new_cmd(config=jax_mock_config({"LOG_LEVEL": "FATAL"}))
    else:
        app = new_cmd(config=new_mock_config({"LOG_LEVEL": "FATAL"}))
    app.sub_command("hello", lambda ctx: "Hello World!", description="greet")
    app.sub_command(r"params", lambda ctx: f"Hello {ctx.param('name')}!")
    app.add_sub_command(r"bind", lambda ctx: dataclasses.asdict(ctx.bind(Flags)))
    app.sub_command(r"raw", lambda ctx: ctx.bind())
    app.sub_command(r"fail", lambda ctx: 1 / 0)
    app.sub_command(r"quiet", lambda ctx: None)
    return app


@pytest.mark.parametrize("argv", [[], ["help"], ["--help"], ["hello"], ["params", "-name=Vikash"],
                                  ["bind", "-name=x", "--n=3", "-verbose", "-ratio=0.5"], ["raw", "-a=1", "--b", "c"],
                                  ["fail"], ["quiet"], ["nope"], ["hello", "world"], ["replay"]])
def test_cmd_app_matches_jax(argv, capsys):
    j = _cli(_cmd_app("jax").run, argv, capsys)
    p = _cli(_cmd_app("port").run, argv, capsys)
    assert j == p


def test_cmd_replay_bundle_lists_records(tmp_path, capsys):
    records = [{"id": 3, "model": "gemma", "model_version": "v1", "prompt_len": 5, "emitted_len": 8,
                "finish_reason": "length", "final": True},
               {"id": 4, "model": "gemma", "model_version": "v1", "prompt_len": 17, "emitted_len": 2,
                "finish_reason": None, "final": False, "redacted": True}]
    (tmp_path / "flight_records.json").write_text(json.dumps(records))
    j = _cli(_cmd_app("jax").run, ["replay", f"-bundle={tmp_path}"], capsys)
    p = _cli(_cmd_app("port").run, ["replay", f"-bundle={tmp_path}"], capsys)
    assert j == p
    assert p[0] == 0 and p[1].startswith(f"2 flight record(s) in {tmp_path}:") and "IN-FLIGHT redacted" in p[1]


def test_cmd_replay_id_against_a_port_app(capsys):
    from gofr_tpu_torch import serve

    app = serve.build_app(new_mock_config({**BASE, "GEMMA_PRESET": "tiny", "TORCH_DEVICE": "cpu", "LLM_SLOTS": "2",
                                           "LLM_MAX_SEQ": "128", "REQUEST_TIMEOUT": "30"}))
    th = app.run_in_background()
    try:
        port = app.http_server.port
        s, body, _ = _call(port, "POST", "/generate", json.dumps({"tokens": [5, 9, 13, 2], "max_new_tokens": 6}).encode(),
                           {"Content-Type": "application/json"})
        assert s == 201
        rec = app.container.tpu().llm("gemma").flightrec.records(final=True)[0]
        rc, out, err = _cli(_cmd_app("port").run, ["replay", f"-id={rec['id']}", f"-url=http://127.0.0.1:{port}"],
                            capsys)
        assert rc == 0 and "token-identical" in out and f"replay id={rec['id']} model=gemma@" in out, (out, err)
        rc, out, err = _cli(_cmd_app("port").run, ["replay", "-id=99999", f"-url=http://127.0.0.1:{port}"], capsys)
        assert rc == 1 and "404" in err
    finally:
        app.shutdown()
        th.join(timeout=10)


def test_cmd_profile_writes_an_archive(tmp_path, capsys):
    rc, out, err = _cli(_cmd_app("port").run, ["profile", "-seconds=0.1", f"-dir={tmp_path}",
                                                f"-out={tmp_path / 'p.zip'}"], capsys)
    assert rc == 0, err
    assert out.startswith("profile mode=") and f"archive={tmp_path / 'p.zip'}" in out
    assert zipfile.is_zipfile(tmp_path / "p.zip")


def test_cmd_module_surface_matches_jax():
    j, p = jcmd.CMDRequest(["a", "-k=v", "--f", "b"]), pcmd.CMDRequest(["a", "-k=v", "--f", "b"])
    assert (j.command, j.params, j.params_list("k"), j.path_param("k"), j.header("x"), j.host_name()) == \
        (p.command, p.params, p.params_list("k"), p.path_param("k"), p.header("x"), p.host_name())


# -- logging and the remote level -------------------------------------------------------

def _log_lines(mod, pretty):
    out, err = io.StringIO(), io.StringIO()
    lg = mod.Logger(level=mod.DEBUG, out=out, err=err, pretty=pretty)

    class Payload:
        def to_log_dict(self):
            return {"k": 1}

        def pretty_print(self, w):
            w.write("pretty payload")

    lg.debug("d", 1)
    lg.info(Payload())
    lg.notice("n", extra="x")
    lg.warn("w")
    lg.warning("w2")
    lg.logf(mod.INFO, "%s=%d", "a", 3)
    lg.error("e")
    lg.fatal({"f": True})
    lg.change_level(mod.ERROR)
    lg.info("dropped")
    lg.error("kept")

    def strip(text):
        if pretty:
            return [ln.split("] ", 1)[0].split(" [")[0] + " " + ln.split("] ", 1)[1] for ln in text.splitlines()]
        return [{k: v for k, v in json.loads(ln).items() if k != "time"} for ln in text.splitlines()]

    return strip(out.getvalue()), strip(err.getvalue())


@pytest.mark.parametrize("pretty", [False, True])
def test_logger_output_matches_jax(pretty):
    assert _log_lines(jlog, pretty) == _log_lines(plog, pretty)


def test_file_and_mock_loggers_match_jax(tmp_path):
    for mod, name in ((jlog, "j.log"), (plog, "p.log")):
        lg = mod.new_file_logger(str(tmp_path / name), level=mod.INFO)
        lg.info("to file")
        lg.debug("not written")
        lg._out.close()
    rd = lambda n: [{k: v for k, v in json.loads(ln).items() if k != "time"}  # noqa: E731
                    for ln in (tmp_path / n).read_text().splitlines()]
    assert rd("j.log") == rd("p.log") == [{"level": "INFO", "message": "to file"}]
    mocks = []
    for mod in (jlog, plog):
        m = mod.new_mock_logger()
        m.info("a", "b")
        m.error("c")
        mocks.append((m.messages(), m.messages(mod.ERROR), [r[0] for r in m.records], bool(m.stdout), bool(m.stderr)))
    assert mocks[0] == mocks[1]
    assert [jlog.level_from_string(s) for s in ("debug", "Warn", "", None, "x")] == \
        [plog.level_from_string(s) for s in ("debug", "Warn", "", None, "x")]


@pytest.fixture()
def level_server():
    state = {"body": {"data": [{"serviceName": "svc", "logLevel": "DEBUG"}]}}

    class Stub(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(state["body"]).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/level", state
    srv.shutdown()
    srv.server_close()
    th.join(timeout=5)


def _wait(pred, seconds=5.0):
    t0 = time.monotonic()
    while not pred() and time.monotonic() - t0 < seconds:
        time.sleep(0.01)
    return pred()


def test_remote_log_level_matches_jax(level_server):
    url, state = level_server
    loggers = [jremote.RemoteLevelLogger(jlog.INFO, url, 0.05, out=io.StringIO(), err=io.StringIO()),
               premote.RemoteLevelLogger(plog.INFO, url, 0.05, out=io.StringIO(), err=io.StringIO())]
    try:
        assert all(_wait(lambda lg=lg: lg.level == plog.DEBUG) for lg in loggers)
        state["body"] = {"logLevel": "ERROR"}
        assert all(_wait(lambda lg=lg: lg.level == plog.ERROR) for lg in loggers)
        state["body"] = {"nothing": 1}  # no level: kept
        time.sleep(0.15)
        assert [lg.level for lg in loggers] == [plog.ERROR, plog.ERROR]
    finally:
        for lg in loggers:
            lg.close()
    for lg in loggers:
        lg._thread.join(timeout=5)
        assert not lg._thread.is_alive()


def test_container_installs_the_remote_level(level_server):
    url, _ = level_server
    app = papp_mod.new(config=new_mock_config({**BASE, "REMOTE_LOG_URL": url, "REMOTE_LOG_FETCH_INTERVAL": "0.05"}))
    assert isinstance(app.logger, premote.RemoteLevelLogger)
    assert _wait(lambda: app.logger.level == plog.DEBUG)
    app.container.close()
    app.logger._thread.join(timeout=5)
    assert not app.logger._thread.is_alive()
    quiet = papp_mod.new(config=new_mock_config(BASE))
    assert isinstance(quiet.logger, premote.RemoteLevelLogger) and quiet.logger._thread is None
