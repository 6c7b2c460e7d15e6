"""gofr_tpu_torch.router against gofr_tpu.router on the CPU.

- The rendezvous ring ranks members exactly as JAX's does.
- FleetView, FrontRouter.pick and the Autoscaler walk the scenarios of the
  JAX package's router tests, fed the same fakes and the same fake clock in
  both packages, and must make the same decisions in the same order
  (launches, drains, reaps, ring members and epochs, picks).
- The port's router in front of port Apps over real sockets: header
  forwarding, affinity, streamed proxying, disconnect propagation (a port
  engine retires the request), the in-flight cap, the recovery rules, the
  breaker after a kill, fleet admission, the debug route.
- Real tiny engines on the wire between the packages: the port's router
  over port engines, the JAX router over port engines and the port's
  router over JAX engines all give the greedy tokens of direct access.
- One real engine_stub process launched by the autoscaler.
"""

import ast
import asyncio
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gofr_tpu.router as jrouter
from gofr_tpu.config import new_mock_config as jax_mock_config
from gofr_tpu.models import transformer as JT
from gofr_tpu.router.autoscaler import Autoscaler as JAutoscaler
from gofr_tpu.router.fleet import FleetView as JFleetView
from gofr_tpu.router.ring import HashRing as JHashRing
from gofr_tpu_torch.app import App
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.http.errors import ErrorServiceUnavailable, ErrorTooManyRequests
from gofr_tpu_torch.http.responder import StreamingResponse
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.router import FrontRouter, _GuardedStream, new_router_app
from gofr_tpu_torch.router.autoscaler import DEFAULT_ENGINE_CMD, Autoscaler
from gofr_tpu_torch.router.fleet import FleetView
from gofr_tpu_torch.router.ring import HashRing

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny engines' CPU ops on one intra-op thread: under the suite's
    parallel workers an 8-thread pool spends most of its time in its
    barriers and starves the other workers' timing-bound tests."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

MEMBER_SETS = (
    ("a", "b", "c", "d"),
    tuple(f"http://127.0.0.1:{8100 + i}" for i in range(5)),
    ("solo",),
    tuple(f"engine-{i}" for i in range(17)),
)


@pytest.mark.parametrize("members", MEMBER_SETS, ids=lambda m: f"n{len(m)}")
def test_ring_owners_equal_jax(members):
    keys = [f"session-{i}" for i in range(1000)]
    port, ref = HashRing(members), JHashRing(members)
    assert port.members == ref.members
    assert [port.owner(k) for k in keys] == [ref.owner(k) for k in keys]
    assert [list(port.owners(k)) for k in keys] == [list(ref.owners(k)) for k in keys]
    extra = "http://10.0.0.9:8000"
    assert port.with_member(extra).members == ref.with_member(extra).members
    assert [port.with_member(extra).owner(k) for k in keys] == [ref.with_member(extra).owner(k) for k in keys]
    drop = members[0]
    assert [port.without_member(drop).owner(k) for k in keys] == [ref.without_member(drop).owner(k) for k in keys]


def test_empty_ring_has_no_owner():
    assert HashRing().owner("k") is None and JHashRing().owner("k") is None
    assert list(HashRing().owners("k")) == []


def test_ring_owner_deterministic_and_balanced():
    ring = HashRing([f"b{i}" for i in range(4)])
    keys = [f"session-{i}" for i in range(2000)]
    owners = [ring.owner(k) for k in keys]
    assert owners == [ring.owner(k) for k in keys]
    for m in ring.members:
        assert 0.5 * 500 < owners.count(m) < 1.5 * 500


def test_ring_removal_moves_only_the_removed_members_keys():
    ring = HashRing(["a", "b", "c", "d"])
    keys = [f"k{i}" for i in range(1000)]
    before = {k: ring.owner(k) for k in keys}
    smaller = ring.without_member("b")
    moved = [k for k in keys if smaller.owner(k) != before[k]]
    assert set(moved) == {k for k in keys if before[k] == "b"}


def test_ring_addition_moves_bounded_fraction_to_the_new_member():
    ring = HashRing(["a", "b", "c", "d"])
    keys = [f"k{i}" for i in range(1000)]
    before = {k: ring.owner(k) for k in keys}
    bigger = ring.with_member("e")
    moved = [k for k in keys if bigger.owner(k) != before[k]]
    assert len(moved) / len(keys) < 0.30
    assert all(bigger.owner(k) == "e" for k in moved)


def test_ring_owners_ranking_is_the_fallthrough_order():
    ring = HashRing(["a", "b", "c"])
    ranked = list(ring.owners("some-session"))
    assert ranked[0] == ring.owner("some-session")
    assert sorted(ranked) == ["a", "b", "c"]
    assert ring.without_member(ranked[0]).owner("some-session") == ranked[1]


# ---------------------------------------------------------------------------
# fleet view, pick and autoscaler: the same scenario in both packages
# ---------------------------------------------------------------------------

class _FakeService:
    """Stands in for HTTPService in both packages' fleet views."""

    def __init__(self, address):
        self.address = address
        self.circuit = None
        self.serving = {"load_tokens": 0, "throughput_tok_s": None, "predicted_wait_s": None, "draining": False}
        self.requests = []
        self.fail = False

    def request(self, method, path, **kw):
        self.requests.append((method, path))
        if self.fail:
            raise ConnectionError("down")
        serving = self.serving

        class R:
            status_code = 200

            @staticmethod
            def json():
                return {"data": {"serving": serving}}

        return R()

    def pool_stats(self):
        return {"idle": 0, "hits": 0, "dials": 0}

    def close(self):
        pass


class _FakeProc:
    def __init__(self):
        self.exited = False
        self.terminated = False
        self.returncode = None

    def poll(self):
        return 0 if self.exited else None


class _FakeLauncher:
    def __init__(self):
        self.launched = []
        self.reaped = []

    def launch(self):
        proc = _FakeProc()
        addr = f"http://scaled{len(self.launched)}"
        self.launched.append((addr, proc))
        return addr, proc

    def reap(self, proc, **kw):
        proc.terminated = True
        self.reaped.append(proc)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class _Pkg:
    def __init__(self, name, fleet_view, autoscaler, front_router, mock_config):
        self.name = name
        self.FleetView = fleet_view
        self.Autoscaler = autoscaler
        self.FrontRouter = front_router
        self.mock_config = mock_config


JAX = _Pkg("jax", JFleetView, JAutoscaler, jrouter.FrontRouter, jax_mock_config)
PORT = _Pkg("port", FleetView, Autoscaler, FrontRouter, new_mock_config)


class _Run:
    """One scenario in one package: the fleet, the clock, the launcher and
    the log of every decision."""

    def __init__(self, pkg, n=2, clock=True):
        self.pkg = pkg
        self.clock = _Clock()
        kw = {"now_fn": self.clock} if clock else {}
        self.fleet = pkg.FleetView(service_factory=_FakeService, poll_interval_s=0.05, **kw)
        for i in range(n):
            self.fleet.add(f"http://b{i}")
        self.launcher = _FakeLauncher()
        self.log = []

    def scaler(self, **kw):
        for k, v in (("min_replicas", 1), ("max_replicas", 3), ("up_wait_s", 2.0), ("down_wait_s", 0.25),
                     ("hold_s", 3.0), ("cooldown_s", 5.0)):
            kw.setdefault(k, v)
        return self.pkg.Autoscaler(self.fleet, self.launcher, now_fn=self.clock, **kw)

    def note(self, label, **extra):
        bs = sorted(self.fleet.backends(), key=lambda b: b.address)
        self.log.append((
            label,
            tuple((b.address, b.alive, b.draining, b.managed, b.accepting(self.clock()), b.load_tokens,
                   b.outstanding) for b in bs),
            self.fleet.ring.members,
            self.fleet.ring_epoch(),
            tuple(a for a, _ in self.launcher.launched),
            len(self.launcher.reaped),
            tuple(sorted(extra.items())),
        ))

    def pressure(self, wait_s):
        for b in self.fleet.backends():
            b.alive = True
            b.load_tokens = int(100 * wait_s)
            b.throughput_tok_s = 100.0


def _wait_drain_post(b, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not any(p.endswith("/drain") for _m, p in b.svc.requests):
        time.sleep(0.01)
    return any(p.endswith("/drain") for _m, p in b.svc.requests)


def sc_poll_reads_serving_block(pkg):
    r = _Run(pkg, 2)
    r.fleet.get("http://b0").svc.serving.update(load_tokens=128, throughput_tok_s=64.0)
    r.fleet.poll_once()
    b0 = r.fleet.get("http://b0")
    assert b0.alive and b0.accepting() and b0.load_tokens == 128
    assert r.fleet.pooled_predicted_wait_s() == pytest.approx(2.0)
    r.note("polled", wait=r.fleet.pooled_predicted_wait_s(), tput=r.fleet.pooled_throughput_tok_s())
    return r.log


def sc_draining_backend_rehomes_its_sessions(pkg):
    r = _Run(pkg, 3)
    r.fleet.poll_once()
    keys = [f"s{i}" for i in range(300)]
    before = {k: r.fleet.ring.owner(k) for k in keys}
    victim = r.fleet.ring.owner("s0")
    r.note("ring", owners=tuple(before[k] for k in keys))
    r.fleet.get(victim).svc.serving["draining"] = True
    r.fleet.poll_once()
    moved = [k for k in keys if r.fleet.ring.owner(k) != before[k]]
    assert set(moved) == {k for k in keys if before[k] == victim}
    r.note("drained", moved=tuple(moved))
    return r.log


def sc_dead_backend_after_two_failures(pkg):
    r = _Run(pkg, 2)
    r.fleet.poll_once()
    r.fleet.get("http://b1").svc.fail = True
    for i in range(2):
        r.fleet.poll_once()
        r.note(f"failed poll {i}")
    assert not r.fleet.get("http://b1").alive
    r.fleet.get("http://b1").svc.fail = False
    r.fleet.poll_once()
    r.note("recovered")
    return r.log


def sc_pick_owner_then_fallthrough(pkg):
    cfg = pkg.mock_config({"TPU_ROUTER_POLL_INTERVAL_S": "30"})
    fr = pkg.FrontRouter(cfg, service_factory=_FakeService)
    for i in range(2):
        fr.fleet.add(f"http://b{i}")
    fr.fleet.poll_once()
    log = []
    for sid in ("sess-42", "sess-7", "conv-1", ""):
        b, res = fr.pick(sid, set())
        log.append((sid, b.address, res))
    owner = fr.fleet.ring.owner("sess-42")
    fr.fleet.get(owner).draining = True
    b, res = fr.pick("sess-42", set())
    assert b.address != owner and res == "fallthrough"
    log.append(("draining owner", b.address, res))
    fr.fleet.get(owner).draining = False
    fr.fleet.get("http://b0").load_tokens = 500
    fr.fleet.get("http://b1").load_tokens = 5
    b, res = fr.pick("", set())
    assert b.address == "http://b1" and res == "none"
    log.append(("least loaded", b.address, res))
    log.append(("excluded", *(x.address if hasattr(x, "address") else x
                              for x in fr.pick("sess-42", {"http://b0", "http://b1"}))))
    fr.fleet.get("http://b0").outstanding = 10
    fr.fleet.get("http://b0").load_tokens = 0
    fr.fleet.get("http://b1").load_tokens = 0
    log.append(("outstanding", fr.pick("", set())[0].address))
    fr.close()
    return log


def sc_scale_up_on_sustained_backlog_only(pkg):
    r = _Run(pkg, 1)
    r.fleet.poll_once()
    sc = r.scaler()
    r.pressure(10.0)
    for dt in (0.0, 1.0, 2.5, 3.1, 3.1, 5.0, 3.1):
        r.clock.t += dt
        sc.tick()
        r.note(f"tick +{dt}", ups=sc.scale_ups)
    assert len(r.launcher.launched) == 2
    return r.log


def sc_shed_scales_up_without_hold(pkg):
    r = _Run(pkg, 1)
    r.fleet.poll_once()
    sheds = {"n": 0}
    sc = r.scaler(shed_count_fn=lambda: sheds["n"])
    sc.tick()
    r.note("calm")
    sheds["n"] = 3
    sc.tick()
    r.note("shed")
    assert len(r.launcher.launched) == 1
    return r.log


def sc_max_and_min_bounds(pkg):
    r = _Run(pkg, 1)
    r.fleet.poll_once()
    sc = r.scaler(max_replicas=2, cooldown_s=0.0, hold_s=0.0)
    r.pressure(10.0)
    for i in range(5):
        sc.tick()
        r.fleet.poll_once()
        r.pressure(10.0)
        r.clock.t += 1.0
        r.note(f"pressure {i}")
    assert len(r.launcher.launched) == 1
    r.pressure(0.0)
    for i in range(5):
        sc.tick()
        r.clock.t += 1.0
        r.note(f"idle {i}", downs=sc.scale_downs)
    draining = [b for b in r.fleet.backends() if b.draining]
    assert len(draining) == 1 and draining[0].managed
    return r.log


def sc_graceful_drain(pkg):
    r = _Run(pkg, 1)
    r.fleet.poll_once()
    sc = r.scaler(min_replicas=0, hold_s=0.0, cooldown_s=0.0, drain_grace_s=60.0)
    addr, proc = r.launcher.launch()
    r.fleet.add(addr, managed=True, proc=proc)
    b = r.fleet.get(addr)
    b.alive, b.throughput_tok_s = True, 100.0
    r.fleet._rebuild_ring()
    r.note("launched")
    sc.tick()
    assert b.draining and addr not in r.fleet.ring.members
    assert _wait_drain_post(b), "drain POST not sent"
    r.note("draining")
    r.clock.t += 10.0
    sc.tick()
    assert not proc.terminated and r.fleet.get(addr) is not None
    r.note("still streaming")
    proc.exited = True
    sc.tick()
    assert r.fleet.get(addr) is None
    r.note("exited")
    return r.log


def sc_lost_drain_post_keeps_the_scale_down(pkg):
    r = _Run(pkg, 2)
    r.fleet.poll_once()
    for b in r.fleet.backends():
        b.managed, b.proc, b.load_tokens, b.throughput_tok_s = True, _FakeProc(), 0, 100.0
        orig = b.svc.request

        def failing(method, path, _orig=orig, **kw):
            if path.endswith("/drain"):
                raise TimeoutError("drain POST lost")
            return _orig(method, path, **kw)

        b.svc.request = failing
    sc = r.scaler(min_replicas=1, cooldown_s=0.0, hold_s=0.0, drain_grace_s=30.0)
    sc.tick()
    victim = [b for b in r.fleet.backends() if b.draining][0]
    r.note("drain")
    r.fleet.poll_once()
    assert victim.draining and victim.address not in r.fleet.ring.members
    r.note("poll after lost POST")
    r.clock.t += 31.0
    sc.tick()
    assert r.fleet.get(victim.address) is None and victim.proc.terminated
    r.note("grace reap")
    return r.log


def sc_crashed_engine_replaced(pkg):
    r = _Run(pkg, 0)
    sc = r.scaler(min_replicas=1, cooldown_s=0.0)
    sc.ensure_min()
    r.fleet.poll_once()
    r.note("min")
    addr, proc = r.launcher.launched[0]
    proc.exited = True
    sc.tick()
    assert r.fleet.get(addr) is None and len(r.launcher.launched) == 2
    r.note("replaced")
    return r.log


def sc_min_floor_respects_cooldown(pkg):
    r = _Run(pkg, 0)
    sc = r.scaler(min_replicas=1, cooldown_s=5.0)
    sc.ensure_min()
    for i in range(8):
        r.launcher.launched[-1][1].exited = True
        sc.tick()
        r.clock.t += 1.0
        r.note(f"crash loop {i}")
    assert len(r.launcher.launched) <= 3
    return r.log


def sc_unreachable_mid_drain_waits_for_grace(pkg):
    r = _Run(pkg, 0)
    sc = r.scaler(min_replicas=0, hold_s=0.0, cooldown_s=0.0, drain_grace_s=30.0)
    addr, proc = r.launcher.launch()
    r.fleet.add(addr, managed=True, proc=proc)
    b = r.fleet.get(addr)
    b.alive, b.throughput_tok_s = True, 100.0
    sc.tick()
    b.alive = False
    r.clock.t += 5.0
    sc.tick()
    assert not proc.terminated and r.fleet.get(addr) is not None
    r.note("unreachable")
    r.clock.t += 26.0
    sc.tick()
    assert proc.terminated and r.fleet.get(addr) is None
    r.note("grace")
    return r.log


def sc_wedged_drain_reaped(pkg):
    r = _Run(pkg, 0)
    sc = r.scaler(min_replicas=0, hold_s=0.0, cooldown_s=0.0, drain_grace_s=30.0)
    addr, proc = r.launcher.launch()
    r.fleet.add(addr, managed=True, proc=proc)
    b = r.fleet.get(addr)
    b.alive, b.throughput_tok_s = True, 100.0
    sc.tick()
    r.note("drain", snap=json.dumps(sc.snapshot(), sort_keys=True))
    r.clock.t += 31.0
    sc.tick()
    assert proc.terminated and r.fleet.get(addr) is None
    r.note("reaped", snap=json.dumps(sc.snapshot(), sort_keys=True))
    return r.log


def sc_scale_down_picks_least_loaded_managed(pkg):
    r = _Run(pkg, 1)
    r.fleet.poll_once()
    sc = r.scaler(min_replicas=1, hold_s=2.0, cooldown_s=1.0)
    for i in range(3):
        addr, proc = r.launcher.launch()
        r.fleet.add(addr, managed=True, proc=proc)
    for i, b in enumerate(sorted(r.fleet.backends(), key=lambda b: b.address)):
        b.alive, b.throughput_tok_s, b.load_tokens = True, 1000.0, 7 * i
    for i in range(12):
        sc.tick()
        r.clock.t += 1.0
        r.note(f"calm {i}", downs=sc.scale_downs)
    assert sc.scale_downs >= 2
    return r.log


SCENARIOS = (
    sc_poll_reads_serving_block, sc_draining_backend_rehomes_its_sessions, sc_dead_backend_after_two_failures,
    sc_pick_owner_then_fallthrough, sc_scale_up_on_sustained_backlog_only, sc_shed_scales_up_without_hold,
    sc_max_and_min_bounds, sc_graceful_drain, sc_lost_drain_post_keeps_the_scale_down, sc_crashed_engine_replaced,
    sc_min_floor_respects_cooldown, sc_unreachable_mid_drain_waits_for_grace, sc_wedged_drain_reaped,
    sc_scale_down_picks_least_loaded_managed,
)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_state_machine_decisions_equal_jax(scenario):
    want = scenario(JAX)
    got = scenario(PORT)
    assert len(got) > 0
    assert got == want


def test_fleet_gauges_equal_jax():
    from gofr_tpu.metrics import new_metrics_manager
    from gofr_tpu_torch.metrics import Manager

    texts = []
    for pkg, mgr in ((JAX, new_metrics_manager()), (PORT, Manager())):
        fr = pkg.FrontRouter(pkg.mock_config({}), metrics=mgr, service_factory=_FakeService)
        for i in range(3):
            fr.fleet.add(f"http://b{i}")
        fr.fleet.get("http://b0").svc.serving.update(load_tokens=300, throughput_tok_s=50.0)
        fr.fleet.get("http://b1").svc.serving["draining"] = True
        fr.fleet.get("http://b2").svc.fail = True
        fr.fleet.poll_once()
        fr.fleet.poll_once()
        texts.append(sorted(ln for ln in mgr.render_prometheus().splitlines() if ln.startswith("app_router_")))
        fr.close()
    assert texts[0] == texts[1]
    assert any('state="down"} 1' in ln for ln in texts[1])


# ---------------------------------------------------------------------------
# the port's router in front of port Apps, over real sockets
# ---------------------------------------------------------------------------

COMMON = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR", "REQUEST_TIMEOUT": "30"}


def _backend_app(name, handlers=None):
    app = App(config=new_mock_config({**COMMON, "APP_NAME": name}))
    state = {"requests": 0}

    def who(ctx):
        state["requests"] += 1
        return {"name": name, "headers": {k: v for k, v in ctx.request.headers.items()
                                          if k.startswith("x-") or k == "traceparent"}}

    app.post("/who", who)
    app.get("/who", who)
    for path, h in (handlers or {}).items():
        app.post(path, h)
    app.state = state
    app.run_in_background()
    return app


def _addr(app):
    return f"http://127.0.0.1:{app.http_server.port}"


def _router_for(backends, extra_cfg=None, mock_config=new_mock_config, factory=new_router_app):
    app = factory(config=mock_config({
        **COMMON, "APP_NAME": "router",
        "TPU_ROUTER_BACKENDS": ",".join(_addr(b) for b in backends),
        "TPU_ROUTER_POLL_INTERVAL_S": "0.1",
        "TPU_ROUTER_BREAKER_INTERVAL_S": "0.2",
        **(extra_cfg or {}),
    }))
    app.run_in_background()
    return app


def _request(app, path, payload=None, headers=None, method=None, timeout=15):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{app.http_server.port}{path}", data=data,
        headers={"Content-Type": "application/json", **(headers or {})},
        method=method or ("POST" if data is not None else "GET"),
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _wait_accepting(router_app, n, timeout=15):
    fr = router_app.front_router
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(fr.fleet.accepting()) == n:
            return
        time.sleep(0.03)
    raise AssertionError(f"fleet never reached {n} accepting: {[b.snapshot() for b in fr.fleet.backends()]}")


def _stop(*apps):
    for app in apps:
        app.shutdown()
    time.sleep(0.1)


def _raw_stream(app, path, body=b"{}"):
    s = socket.create_connection(("127.0.0.1", app.http_server.port), timeout=10)
    s.sendall(b"POST %s HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\nContent-Length: %d\r\n\r\n%s"
              % (path.encode(), len(body), body))
    return s


@pytest.fixture
def duo():
    b1, b2 = _backend_app("b1"), _backend_app("b2")
    router = _router_for([b1, b2])
    try:
        _wait_accepting(router, 2)
        yield router, b1, b2
    finally:
        _stop(router, b1, b2)


def test_proxy_forwards_identity_and_trace_headers(duo):
    router, _b1, _b2 = duo
    tp = "00-" + "a" * 32 + "-" + "b" * 16 + "-01"
    _st, _h, body = _request(router, "/who", {}, {"traceparent": tp, "X-GoFr-Priority": "batch",
                                                  "X-GoFr-Session": "conv-1", "X-GoFr-Client": "tenant-7"})
    seen = json.loads(body)["data"]["headers"]
    assert seen["x-gofr-priority"] == "batch"
    assert seen["x-gofr-session"] == "conv-1"
    assert seen["x-gofr-client"] == "tenant-7"
    assert seen["x-forwarded-for"].startswith("127.0.0.1")
    # re-stamped to the router.proxy span: the same trace, a new span id
    assert seen["traceparent"].startswith("00-" + "a" * 32 + "-")
    assert "b" * 16 not in seen["traceparent"]


def test_proxy_synthesizes_client_identity_when_absent(duo):
    router, *_ = duo
    seen = json.loads(_request(router, "/who", {}, {"X-Forwarded-For": "10.1.2.3"})[2])["data"]["headers"]
    assert seen["x-gofr-client"] == "10.1.2.3"
    assert seen["x-forwarded-for"] == "10.1.2.3, 127.0.0.1"


def _owned(members, owner, n):
    """``n`` session ids whose rendezvous owner among ``members`` is ``owner``."""
    ring = HashRing(members)
    return [sid for sid in (f"s{i}" for i in range(1000)) if ring.owner(sid) == owner][:n]


def test_session_affinity_pins_and_spreads(duo):
    router, b1, b2 = duo
    for b, name in ((b1, "b1"), (b2, "b2")):
        for sid in _owned([_addr(b1), _addr(b2)], _addr(b), 6):
            names = {json.loads(_request(router, "/who", {}, {"X-GoFr-Session": sid})[2])["data"]["name"]
                     for _ in range(5)}
            assert names == {name}, f"session {sid} on {names}, its owner is {name}"
    text = router.front_router.metrics.render_prometheus()
    assert 'app_router_affinity_total{result="hit"} 60' in text


def test_streamed_proxy_byte_identity_and_pool_reuse():
    async def stream(ctx):
        async def chunks():
            for i in range(8):
                yield f"chunk-{i}|".encode()
                await asyncio.sleep(0.005)

        return StreamingResponse(chunks(), content_type="text/plain")

    b3 = _backend_app("b3", handlers={"/chunks": stream})
    router = _router_for([b3])
    try:
        _wait_accepting(router, 1)
        _st, _h, direct = _request(b3, "/chunks", {})
        for _ in range(3):
            _st, headers, via = _request(router, "/chunks", {})
            assert via == direct
        assert headers["Content-Type"] == "text/plain"
        stats = router.front_router.fleet.get(_addr(b3)).svc.pool_stats()
        assert stats["hits"] > 0, stats
    finally:
        _stop(router, b3)


def test_client_disconnect_propagates_across_the_hop():
    closed = threading.Event()

    async def endless(ctx):
        async def chunks():
            try:
                while True:
                    yield b"tok\n"
                    await asyncio.sleep(0.02)
            finally:
                closed.set()

        return StreamingResponse(chunks(), content_type="text/plain")

    b = _backend_app("bs", handlers={"/endless": endless})
    router = _router_for([b])
    try:
        _wait_accepting(router, 1)
        s = _raw_stream(router, "/endless")
        assert s.recv(4096)
        time.sleep(0.1)
        s.close()
        assert closed.wait(timeout=10), "the backend stream was not cancelled"
    finally:
        _stop(router, b)


def test_max_inflight_cap_covers_streams_and_releases_slots():
    closed = threading.Event()

    async def short(ctx):
        async def chunks():
            for _ in range(3):
                yield b"x" * 8
                await asyncio.sleep(0.01)

        return StreamingResponse(chunks(), content_type="text/plain")

    async def endless(ctx):
        async def chunks():
            try:
                while True:
                    yield b"tok\n"
                    await asyncio.sleep(0.02)
            finally:
                closed.set()

        return StreamingResponse(chunks(), content_type="text/plain")

    b = _backend_app("bcap", handlers={"/short": short, "/endless": endless})
    router = _router_for([b], extra_cfg={"TPU_ROUTER_MAX_INFLIGHT": "2"})
    try:
        _wait_accepting(router, 1)
        for _ in range(6):
            assert _request(router, "/short", {})[2] == b"x" * 24
        s = _raw_stream(router, "/endless")
        assert s.recv(1024)
        s.close()
        assert closed.wait(timeout=10)
        for _ in range(3):
            assert _request(router, "/short", {})[2] == b"x" * 24
    finally:
        _stop(router, b)


def test_guarded_stream_cleanup_runs_even_when_never_started():
    cleaned, inner_finally = [], []

    async def inner():
        try:
            yield b"x"
        finally:
            inner_finally.append(1)

    async def cleanup():
        cleaned.append(1)

    gs = _GuardedStream(inner(), cleanup)
    asyncio.run(gs.aclose())
    assert inner_finally == [] and cleaned == [1]
    asyncio.run(gs.aclose())
    assert cleaned == [1]


def test_guarded_stream_cleanup_runs_on_exhaustion_and_failure():
    cleaned = []

    async def three():
        for _ in range(3):
            yield b"c"

    async def boom():
        yield b"c"
        raise ConnectionError("upstream died")

    async def cleanup():
        cleaned.append(1)

    async def run(gen):
        return [c async for c in _GuardedStream(gen, cleanup)]

    assert asyncio.run(run(three())) == [b"c"] * 3
    with pytest.raises(ConnectionError):
        asyncio.run(run(boom()))
    assert cleaned == [1, 1]


def test_proxy_metric_path_label_is_bounded(duo):
    router, *_ = duo
    for q in ("alpha", "beta", "gamma"):
        _request(router, f"/who?scan={q}", {})
    text = router.front_router.metrics.render_prometheus()
    assert 'path="proxy"' in text and "scan=" not in text
    assert 'app_router_requests_total{outcome="ok"} 3' in text


def test_backend_429_retry_after_is_surfaced_not_retried():
    def shed(ctx):
        raise ErrorTooManyRequests("engine saturated", retry_after=7.0)

    b1, b2 = _backend_app("b1", {"/gen": shed}), _backend_app("b2", {"/gen": shed})
    router = _router_for([b1, b2])
    try:
        _wait_accepting(router, 2)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _request(router, "/gen", {})
        assert ei.value.code == 429 and ei.value.headers["Retry-After"] == "7"
        assert b1.state["requests"] + b2.state["requests"] == 0
        assert router.front_router.retries == 0
    finally:
        _stop(router, b1, b2)


def test_upstream_timeout_surfaces_without_redispatch():
    hits = {"n": 0}

    def slow(ctx):
        hits["n"] += 1
        time.sleep(3.0)
        return {"name": "late"}

    b1, b2 = _backend_app("b1", {"/gen": slow}), _backend_app("b2", {"/gen": slow})
    router = _router_for([b1, b2], extra_cfg={"TPU_ROUTER_UPSTREAM_TIMEOUT_S": "1.0"})
    try:
        _wait_accepting(router, 2)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _request(router, "/gen", {})
        assert ei.value.code == 503 and b"timed out" in ei.value.read()
        assert hits["n"] == 1 and router.front_router.retries == 0
    finally:
        _stop(router, b1, b2)


def test_backend_5xx_redispatches_to_survivor():
    def boom(ctx):
        raise RuntimeError("device exploded")

    def ok(ctx):
        return {"name": "ok"}

    b1, b2 = _backend_app("b1", {"/gen": boom}), _backend_app("b2", {"/gen": ok})
    router = _router_for([b1, b2])
    try:
        _wait_accepting(router, 2)
        for _ in range(4):
            assert json.loads(_request(router, "/gen", {})[2])["data"]["name"] == "ok"
    finally:
        _stop(router, b1, b2)


def test_backend_503_falls_through_then_surfaces_retry_after():
    def draining(ctx):
        raise ErrorServiceUnavailable("draining", retry_after=5.0)

    def ok(ctx):
        return {"name": "ok"}

    b1, b2 = _backend_app("b1", {"/gen": draining}), _backend_app("b2", {"/gen": ok})
    router = _router_for([b1, b2])
    try:
        _wait_accepting(router, 2)
        for _ in range(4):
            assert json.loads(_request(router, "/gen", {})[2])["data"]["name"] == "ok"
    finally:
        _stop(router, b1, b2)
    b3 = _backend_app("b3", {"/gen": draining})
    router2 = _router_for([b3])
    try:
        _wait_accepting(router2, 1)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _request(router2, "/gen", {})
        assert ei.value.code == 503 and ei.value.headers["Retry-After"] == "5"
    finally:
        _stop(router2, b3)


def test_killed_backend_breaker_opens_and_traffic_converges():
    b1, b2 = _backend_app("b1"), _backend_app("b2")
    router = _router_for([b1, b2])
    try:
        _wait_accepting(router, 2)
        b1.shutdown()
        time.sleep(0.2)
        for _ in range(8):
            assert json.loads(_request(router, "/who", {})[2])["data"]["name"] == "b2"
        fr = router.front_router
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and fr.fleet.get(_addr(b1)).accepting():
            time.sleep(0.05)
        assert not fr.fleet.get(_addr(b1)).accepting()
        _wait_accepting(router, 1)
        # the ring follows at the next poll cycle (0.1 s apart)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and fr.fleet.ring.members != (_addr(b2),):
            time.sleep(0.02)
        assert fr.fleet.ring.members == (_addr(b2),)
    finally:
        _stop(router, b2)


def test_router_fleet_admission_sheds_with_priced_retry_after():
    b1 = _backend_app("b1")
    router = _router_for([b1], extra_cfg={"TPU_ROUTER_SHED_WAIT_S": "1.0", "TPU_ROUTER_POLL_INTERVAL_S": "60"})
    try:
        _wait_accepting(router, 1)
        b = router.front_router.fleet.backends()[0]
        b.load_tokens, b.throughput_tok_s = 10_000, 100.0  # a 100 s wait
        with pytest.raises(urllib.error.HTTPError) as ei:
            _request(router, "/who", {})
        assert ei.value.code == 429
        assert 90 <= float(ei.value.headers["Retry-After"]) <= 100
        assert router.front_router.sheds == 1
        b.load_tokens = 0
        assert _request(router, "/who", {})[0] in (200, 201)
    finally:
        _stop(router, b1)


def test_router_debug_route_and_serving_summary_shape():
    b1 = _backend_app("b1")
    router = _router_for([b1])
    try:
        _wait_accepting(router, 1)
        snap = json.loads(_request(router, "/.well-known/router")[2])["data"]
        assert snap["fleet"]["ring"] == [_addr(b1)]
        assert snap["fleet"]["backends"][0]["accepting"] is True
        assert "retry_budget_remaining" in snap and snap["autoscaler"] is None
        serving = json.loads(_request(b1, "/.well-known/debug/engine?serving=1")[2])["data"]["serving"]
        assert serving["draining"] is False and serving["load_tokens"] == 0
        # the router's own health and fleet views answer from its process
        assert _request(router, "/.well-known/health")[0] == 200
        usage = json.loads(_request(router, "/.well-known/debug/usage")[2])["data"]
        assert usage["backends"][0]["address"] == _addr(b1) and usage["backends"][0]["ok"]
        box = json.loads(_request(router, "/.well-known/debug/blackbox")[2])["data"]
        assert box["backends"][0]["ok"] and box["count"] == 0
        journey = json.loads(_request(router, "/.well-known/debug/journey?trace_id=" + "c" * 32)[2])["data"]
        assert journey["trace_id"] == "c" * 32 and journey["backends"][0]["ok"]
    finally:
        _stop(router, b1)


def test_router_drain_stops_scaling_and_keeps_the_engines():
    b1 = _backend_app("b1")
    app = new_router_app(config=new_mock_config({
        **COMMON, "TPU_ROUTER_BACKENDS": _addr(b1), "GOFR_DRAIN_DEADLINE_S": "1"}))
    fr = app.front_router
    fr.autoscaler = Autoscaler(fr.fleet, _FakeLauncher(), min_replicas=0)
    th = app.run_in_background()
    try:
        assert app.begin_drain()
        assert fr.autoscaler._closed
        th.join(timeout=10)
        assert not th.is_alive()
        assert _request(b1, "/who", {})[0] == 201  # the engine serves on
    finally:
        _stop(app, b1)


def test_idle_keep_alive_connection_does_not_hold_the_shutdown():
    """ROADMAP queue 3 item 37: a router's pooled keep-alive socket to an
    engine closes when the engine shuts down, instead of holding the
    drained process for the 75 s keep-alive idle timeout."""
    b = _backend_app("b")
    s = socket.create_connection(("127.0.0.1", b.http_server.port), timeout=10)
    s.sendall(b"GET /who HTTP/1.1\r\nHost: x\r\n\r\n")
    assert b"200 OK" in s.recv(4096)  # the connection stays open, idle
    t0 = time.monotonic()
    b.shutdown()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and b.http_server._server is not None:
        time.sleep(0.02)
    assert b.http_server._server is None, "shutdown waited on the idle keep-alive connection"
    assert time.monotonic() - t0 < 5
    assert s.recv(4096) == b""  # closed by the server
    s.close()


# ---------------------------------------------------------------------------
# real tiny engines: the wire between the two packages
# ---------------------------------------------------------------------------

ENGINE_KW = dict(slots=2, max_seq_len=64, prefill_buckets=(8,), warmup=False, session_mb=4)
PROMPTS = ([1, 2, 3, 4, 5, 6, 7, 8], [9, 40, 2, 77, 3], list(range(100, 119)))


@pytest.fixture(scope="module")
def weights():
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    # an untied random head: the tied tiny model repeats its input token
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), TT.TransformerConfig.tiny(), device="cpu")
    return jcfg, jp, TT.TransformerConfig.tiny(), tp


def _port_engine_app(name, cfg, params):
    from gofr_tpu_torch.handler import llm_request_kwargs
    from gofr_tpu_torch.llm import GenRequest

    app = App(config=new_mock_config({**COMMON, "APP_NAME": name, "REQUEST_TIMEOUT": "60",
                                      "TORCH_DEVICE": "cpu", "TPU_TELEMETRY_INTERVAL_S": "0"}))
    app.container.tpu().register_llm("tiny", cfg, params, kv_paged=True, **ENGINE_KW)

    def gen(ctx):
        body = ctx.bind()
        out = ctx.tpu().llm("tiny").generate(list(body["tokens"]), max_new_tokens=int(body.get("max_new_tokens", 6)),
                                             **llm_request_kwargs(ctx))
        return {"tokens": out, "backend": name}

    async def stream(ctx):
        body = ctx.bind()
        req = ctx.tpu().llm("tiny").submit(GenRequest(list(body["tokens"]),
                                                      max_new_tokens=int(body.get("max_new_tokens", 6)),
                                                      **llm_request_kwargs(ctx)))

        async def chunks():
            async for tok in req.astream():
                yield (json.dumps({"t": tok}) + "\n").encode()

        return StreamingResponse(chunks(), content_type="application/jsonl")

    app.post("/generate", gen)
    app.post("/stream", stream)
    app.run_in_background()
    return app


def _jax_engine_app(name, cfg, params):
    from gofr_tpu.app import App as JApp
    from gofr_tpu.handler import llm_request_kwargs

    app = JApp(config=jax_mock_config({**COMMON, "APP_NAME": name, "REQUEST_TIMEOUT": "60",
                                       "TPU_TELEMETRY_INTERVAL_S": "0", "TRACE_EXPORTER": "none"}))
    app.container.tpu().register_llm("tiny", cfg, params, kv_paged=True, **ENGINE_KW)

    def gen(ctx):
        body = ctx.bind()
        out = ctx.tpu().llm("tiny").generate(list(body["tokens"]), max_new_tokens=int(body.get("max_new_tokens", 6)),
                                             **llm_request_kwargs(ctx))
        return {"tokens": out, "backend": name}

    app.post("/generate", gen)
    app.run_in_background()
    return app


@pytest.fixture(scope="module")
def engine_apps(weights):
    jcfg, jp, tcfg, tp = weights
    apps = {"port": [_port_engine_app(f"p{i}", tcfg, tp) for i in range(2)],
            "jax": [_jax_engine_app(f"j{i}", jcfg, jp) for i in range(2)]}
    yield apps
    for app in apps["port"] + apps["jax"]:
        app.shutdown()
    time.sleep(0.2)


def _tokens(app, prompt, headers=None):
    body = json.loads(_request(app, "/generate", {"tokens": prompt, "max_new_tokens": 6}, headers, timeout=60)[2])
    return body["data"]["tokens"], body["data"]["backend"]


@pytest.mark.parametrize("router_pkg,engine_pkg", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_routed_greedy_tokens_equal_direct(engine_apps, router_pkg, engine_pkg):
    engines = engine_apps[engine_pkg]
    if router_pkg == "port":
        router = _router_for(engines)
    else:
        router = _router_for(engines, mock_config=jax_mock_config, factory=jrouter.new_router_app,
                             extra_cfg={"TRACE_EXPORTER": "none"})
    try:
        _wait_accepting(router, 2, timeout=30)
        for prompt in PROMPTS:
            direct = [_tokens(e, prompt)[0] for e in engines]
            assert direct[0] == direct[1]
            routed, _ = _tokens(router, prompt)
            assert routed == direct[0]
            assert len(set(routed)) > 1  # a real stream
        # every turn of a conversation on its ring owner, three owned by each engine
        for e in engines:
            for sid in _owned([_addr(x) for x in engines], _addr(e), 3):
                names = {_tokens(router, PROMPTS[0], {"X-GoFr-Session": sid})[1] for _ in range(3)}
                assert names == {e.config.get("APP_NAME")}, (sid, names)
        # the poll read the engines' serving summaries off the wire
        b = router.front_router.fleet.get(_addr(engines[0]))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not b.throughput_tok_s:
            time.sleep(0.1)
        assert b.throughput_tok_s and b.throughput_tok_s > 0 and isinstance(b.load_tokens, int)
    finally:
        router.shutdown()
        time.sleep(0.2)


def test_port_and_jax_engines_agree_direct(engine_apps):
    for prompt in PROMPTS:
        assert _tokens(engine_apps["port"][0], prompt)[0] == _tokens(engine_apps["jax"][0], prompt)[0]


def test_disconnect_through_the_router_retires_the_engine_request(engine_apps):
    engine_app = engine_apps["port"][0]
    eng = engine_app.container.tpu().llm("tiny")
    eng = getattr(eng, "engine", eng)
    process = eng._process_entry

    def slow(entry):  # keep the request mid-decode while the client leaves
        time.sleep(0.2)
        return process(entry)

    eng._process_entry = slow
    router = _router_for([engine_app])
    try:
        _wait_accepting(router, 1, timeout=30)
        before = eng.stats()["disconnect_cancels"]
        s = _raw_stream(router, "/stream", json.dumps({"tokens": [1, 2, 3], "max_new_tokens": 60}).encode())
        got = b""
        while b'{"t"' not in got:
            chunk = s.recv(4096)
            assert chunk, "closed before the first token"
            got += chunk
        s.close()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and eng.stats()["disconnect_cancels"] == before:
            time.sleep(0.05)
        assert eng.stats()["disconnect_cancels"] == before + 1
        # no slot holds a block: only the radix and the session tier do
        while time.monotonic() < deadline and eng.stats()["kvcache"]["blocks_in_use"] != eng.kv.held_blocks():
            time.sleep(0.05)
        assert eng.stats()["kvcache"]["blocks_in_use"] == eng.kv.held_blocks()
    finally:
        eng._process_entry = process
        router.shutdown()
        time.sleep(0.2)


# ---------------------------------------------------------------------------
# one real engine process, and the router's imports
# ---------------------------------------------------------------------------

def test_autoscaler_launches_a_real_engine_stub_to_accepting(monkeypatch):
    """ProcessLauncher starts ``python -m gofr_tpu_torch.router.engine_stub``
    on the CPU (the launched process inherits TORCH_DEVICE=cpu); the
    autoscaler's minimum brings it to accepting, a routed generate answers
    from it, and the router's close reaps it. Bounded by its own 120 s
    deadline."""
    deadline = time.monotonic() + 120
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the stub's torch, beside the suite's other workers
    app = new_router_app(config=new_mock_config({
        **COMMON, "TPU_ROUTER_ENGINE_CMD": DEFAULT_ENGINE_CMD, "TPU_ROUTER_MIN_REPLICAS": "1",
        "TPU_ROUTER_MAX_REPLICAS": "1", "TPU_ROUTER_POLL_INTERVAL_S": "0.2"}))
    fr = app.front_router
    procs = [b.proc for b in fr.fleet.backends()]
    try:
        assert len(procs) == 1  # ensure_min launched it at start
        app.run_in_background()
        while time.monotonic() < deadline and not fr.fleet.accepting():
            assert procs[0].poll() is None, "engine_stub exited"
            time.sleep(0.2)
        assert len(fr.fleet.accepting()) == 1, [b.snapshot() for b in fr.fleet.backends()]
        _st, headers, body = _request(app, "/generate", {"tokens": [1, 2, 3], "max_new_tokens": 4},
                                      timeout=max(1.0, deadline - time.monotonic()))
        port = fr.fleet.accepting()[0].address.rsplit(":", 1)[1]
        assert headers["X-Engine-Id"] == f"engine-{port}"
        assert len(json.loads(body)["data"]["tokens"]) == 4
        assert fr.autoscaler.snapshot()["replicas"] == 1
    finally:
        app.shutdown()
        t_end = time.monotonic() + 30
        for p in procs:
            while p.poll() is None and time.monotonic() < t_end:
                time.sleep(0.1)
            if p.poll() is None:
                p.kill()
    assert all(p.poll() is not None for p in procs), "the router's close left an engine process"


def test_router_modules_import_no_torch():
    """The front router holds no CUDA context: its modules import neither
    torch nor jax (engine_stub, which builds an engine, excepted), and a
    fresh process importing the router app loads no torch."""
    for f in sorted((ROOT / "gofr_tpu_torch" / "router").glob("*.py")):
        if f.name == "engine_stub.py":
            continue
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] in ("torch", "jax") for n in names), (f.name, names)
    code = ("import sys, gofr_tpu_torch.router, gofr_tpu_torch.batch, gofr_tpu_torch.datasource.pubsub; "
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=60,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_close_reaps_every_process_launched_while_the_poll_ticks():
    """ROADMAP queue 3 item 38: the poll thread runs the autoscaler's ticks,
    so FrontRouter.close stops it before reaping; a tick's launch can no
    longer land after the reap and orphan its process."""
    fr = FrontRouter(new_mock_config({"TPU_ROUTER_POLL_INTERVAL_S": "0.05"}), service_factory=_FakeService)
    launcher = _FakeLauncher()
    fr.autoscaler = Autoscaler(fr.fleet, launcher, min_replicas=0, max_replicas=10_000, cooldown_s=0.0)
    fr.start()
    fr.autoscaler.min_replicas = 10_000  # from now on every tick launches one
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and len(launcher.launched) < 20:
        time.sleep(0.01)
    fr.close()
    n = len(launcher.launched)
    time.sleep(0.3)
    assert len(launcher.launched) == n >= 20
    assert [p for _a, p in launcher.launched if not p.terminated] == []
