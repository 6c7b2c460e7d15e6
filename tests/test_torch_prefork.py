"""The port App's ``HTTP_WORKERS`` prefork (JAX app.py:512-632), on the
CPU, each app in a process of its own: a CPU-only app forks and answers
from several pids on one port, and SIGTERM reaps every worker (the case of
tests/test_app_integration.py's prefork test); an app that has imported
torch refuses with the JAX package's words (torch for jax) and serves in
one process; an ephemeral port refuses; ``REMOTE_LOG_URL`` warns; both
servers and the metrics server share a port under ``reuse_port``; a
worker that ignores SIGTERM is killed after the grace."""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from gofr_tpu_torch.http.nativeserver import NativeHTTPServer
from gofr_tpu_torch.http.responder import Response
from gofr_tpu_torch.http.server import AsyncHTTPServer

ROOT = Path(__file__).resolve().parents[1]
REFUSED_TORCH = ("HTTP_WORKERS>1 ignored: torch already imported and device state does not survive fork "
                 "— use engine replicas to scale")
REFUSED_PORT = ("HTTP_WORKERS>1 ignored: ephemeral port 0 cannot be shared across workers; set fixed "
                "HTTP_PORT/METRICS_PORT")

pytestmark = pytest.mark.skipif(not hasattr(socket, "SO_REUSEPORT"), reason="no SO_REUSEPORT on this platform")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(cfg: dict, pre: str = "", native: str = "1") -> tuple[subprocess.Popen, int]:
    """A port App with ``cfg`` (plus GET /pid) in a process of its own,
    after ``pre``; its log lines go to the returned process's stdout."""
    port = int(cfg.get("HTTP_PORT", 0))
    conf = {"APP_NAME": "mw", "LOG_LEVEL": "INFO", "GOFR_HTTP_NATIVE": native, **cfg}
    script = (
        "import os, sys\n" + pre
        + "from gofr_tpu_torch.app import App\n"
        "from gofr_tpu_torch.config import new_mock_config\n"
        f"app = App(config=new_mock_config({conf!r}))\n"
        "app.get('/pid', lambda ctx: {'pid': os.getpid(), 'torch': 'torch' in sys.modules})\n"
        "app.run()\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", script], env={**os.environ, "PYTHONPATH": str(ROOT)},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, port


def _pids(port: int, seconds: float, want: int) -> tuple[set, list]:
    """The pids that answer GET /pid within ``seconds`` (stopping at
    ``want``), each on a fresh connection; and every answer."""
    deadline = time.time() + seconds
    pids, answers, last = set(), [], None
    while time.time() < deadline and len(pids) < want:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/pid", timeout=2) as r:
                answers.append(json.load(r)["data"])
            pids.add(answers[-1]["pid"])
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            last = e
            time.sleep(0.1)
    assert answers, f"no worker answered: {last!r}"
    return pids, answers


def _stop(proc: subprocess.Popen) -> str:
    """SIGTERM (the graceful drain) and the process's log."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate(timeout=10)
        raise AssertionError(f"the app did not exit on SIGTERM: {out[-2000:]}") from None
    return out


def _messages(log: str) -> list[str]:
    """The text messages of a JSON log (request logs are objects)."""
    msgs = (json.loads(ln)["message"] for ln in log.splitlines() if ln.startswith("{"))
    return [m for m in msgs if isinstance(m, str)]


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.mark.parametrize("native", ["1", "0"])
def test_cpu_app_forks_serves_from_several_pids_and_reaps_them(native):
    """HTTP_WORKERS=3 without torch: answers from more than one pid within
    15 s on one port; SIGTERM to the parent reaps every worker, and none
    serves the port after."""
    port, mport = _free_port(), _free_port()
    proc, _ = _start({"HTTP_PORT": str(port), "METRICS_PORT": str(mport), "HTTP_WORKERS": "3"}, native=native)
    try:
        pids, answers = _pids(port, 15.0, want=2)
        assert len(pids) >= 2, f"only one worker served: {pids}"
        assert not any(a["torch"] for a in answers)
    finally:
        log = _stop(proc)
    assert f"HTTP multi-worker: 3 processes on :{port}" in _messages(log)
    time.sleep(0.5)
    assert not any(_alive(p) for p in pids - {proc.pid})
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/pid", timeout=1)


def test_app_that_imported_torch_refuses_and_serves_in_one_process():
    """An app that serves a model has imported torch: prefork is refused
    with a warning (a CUDA context does not survive a fork) and one
    process answers."""
    port, mport = _free_port(), _free_port()
    proc, _ = _start({"HTTP_PORT": str(port), "METRICS_PORT": str(mport), "HTTP_WORKERS": "3"}, pre="import torch\n")
    try:
        pids, answers = _pids_many(port, 20)
        assert pids == {proc.pid} and all(a["torch"] for a in answers)
    finally:
        log = _stop(proc)
    msgs = _messages(log)
    assert REFUSED_TORCH in msgs and not any(m.startswith("HTTP multi-worker") for m in msgs)


def _pids_many(port: int, n: int) -> tuple[set, list]:
    """``n`` answers of GET /pid (after the first), each on a fresh
    connection."""
    pids, answers = _pids(port, 30.0, want=1)
    for _ in range(n - 1):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/pid", timeout=5) as r:
            answers.append(json.load(r)["data"])
        pids.add(answers[-1]["pid"])
    return pids, answers


def test_ephemeral_port_refuses():
    proc, _ = _start({"HTTP_PORT": "0", "METRICS_PORT": "0", "HTTP_WORKERS": "3", "LOG_LEVEL": "INFO"})
    try:
        deadline = time.time() + 15
        log = ""
        while time.time() < deadline and "listening on" not in log:
            log += proc.stdout.readline()
    finally:
        log += _stop(proc)
    msgs = _messages(log)
    assert REFUSED_PORT in msgs and not any(m.startswith("HTTP multi-worker") for m in msgs)


def test_remote_log_url_warns_and_forks():
    port, mport = _free_port(), _free_port()
    proc, _ = _start({"HTTP_PORT": str(port), "METRICS_PORT": str(mport), "HTTP_WORKERS": "2",
                      "REMOTE_LOG_URL": f"http://127.0.0.1:{_free_port()}/level",
                      "REMOTE_LOG_FETCH_INTERVAL": "3600"})
    try:
        _pids(port, 15.0, want=1)
    finally:
        log = _stop(proc)
    msgs = _messages(log)
    assert "HTTP_WORKERS>1: remote log-level polling runs in the parent worker only" in msgs
    assert f"HTTP multi-worker: 2 processes on :{port}" in msgs


@pytest.mark.parametrize("server_cls", [AsyncHTTPServer, NativeHTTPServer], ids=["python", "native"])
def test_reuse_port_lets_two_servers_share_a_port(server_cls):
    """What each worker does: bind the same port with SO_REUSEPORT."""
    port = _free_port()

    async def dispatch(req):
        return Response(200, [], b"ok")

    async def main():
        a, b = (server_cls(dispatch, port=port, host="127.0.0.1") for _ in range(2))
        a.reuse_port = b.reuse_port = True
        await a.start()
        await b.start()
        try:
            assert a.port == b.port == port
        finally:
            await a.shutdown()
            await b.shutdown()
        single = server_cls(dispatch, port=port, host="127.0.0.1")
        other = server_cls(dispatch, port=port, host="127.0.0.1")
        await single.start()
        try:
            with pytest.raises(OSError):  # without reuse_port the second bind fails
                await other.start()
        finally:
            await single.shutdown()

    asyncio.run(main())


def test_metrics_server_reuse_port():
    from gofr_tpu_torch.metrics import new_metrics_manager
    from gofr_tpu_torch.metrics.server import MetricsServer

    port = _free_port()
    servers = [MetricsServer(new_metrics_manager(), port, host="127.0.0.1") for _ in range(2)]
    for s in servers:
        s.reuse_port = True
        s.start()
    try:
        assert [s.port for s in servers] == [port, port]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
            assert r.status == 200
    finally:
        for s in servers:
            s.shutdown()


def test_reap_kills_a_worker_that_ignores_sigterm():
    """A worker wedged past the grace is SIGKILLed: the parent's exit is
    never held."""
    from gofr_tpu_torch.app import App

    stubborn = subprocess.Popen([sys.executable, "-c", "import signal, time; signal.signal(signal.SIGTERM, "
                                 "signal.SIG_IGN); print('ready', flush=True); time.sleep(120)"],
                                stdout=subprocess.PIPE, text=True)
    polite = subprocess.Popen([sys.executable, "-c", "import time; print('ready', flush=True); time.sleep(120)"],
                              stdout=subprocess.PIPE, text=True)
    for p in (stubborn, polite):
        assert p.stdout.readline().strip() == "ready"
    t0 = time.monotonic()
    App._reap_workers([stubborn.pid, polite.pid], grace=1.0)
    took = time.monotonic() - t0
    assert 1.0 <= took < 5.0
    assert not _alive(stubborn.pid) and not _alive(polite.pid)
