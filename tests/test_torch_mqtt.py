"""gofr_tpu_torch's MQTT stack (datasource/pubsub/{mqttproto,mqtt}.py,
testutil/fakemqtt.py) against the JAX package's on the CPU.

- Cross-wire round trips: the port's client against JAX's fake broker, JAX's
  client against the port's broker, and the port against itself, over real
  TCP on ephemeral ports: QoS 0 and 1, PUBACK on commit, wildcards,
  unsubscribe, fan-out, password auth, reconnect with re-subscribe, TLS.
- Persistent-session redelivery: an uncommitted QoS 1 message comes back
  after the connection drops, against the port's broker (JAX's fake keeps
  no session: ROADMAP queue 3 item 45, pinned).
- Byte identity of every packet builder on inputs made from a seed, and the
  parsers on tests/test_fuzz_codecs.py's fuzz inputs: the same packets or
  the same error, in bounded time.
"""

import asyncio
import contextlib
import importlib
import socket
import struct
import time
from types import SimpleNamespace

import numpy as np
import pytest

from gofr_tpu.config import new_mock_config as jconfig
from gofr_tpu.datasource.pubsub import mqtt as jmqtt
from gofr_tpu.datasource.pubsub import mqttproto as jmp
from gofr_tpu.testutil import fakemqtt as jfake
from gofr_tpu_torch.config import new_mock_config as pconfig
from gofr_tpu_torch.datasource.pubsub import new_pubsub
from gofr_tpu_torch.datasource.pubsub import mqtt as pmqtt
from gofr_tpu_torch.datasource.pubsub import mqttproto as pmp
from gofr_tpu_torch.testutil import fakemqtt as pfake

PKG = {
    "jax": SimpleNamespace(mp=jmp, mqtt=jmqtt, Broker=jfake.FakeMQTTBroker, config=jconfig,
                           testutil="gofr_tpu.testutil"),
    "port": SimpleNamespace(mp=pmp, mqtt=pmqtt, Broker=pfake.FakeMQTTBroker, config=pconfig,
                            testutil="gofr_tpu_torch.testutil"),
}
PAIRS = [("port", "jax"), ("jax", "port"), ("port", "port")]
PAIR_IDS = [f"{c}-client-{b}-broker" for c, b in PAIRS]


@pytest.fixture(params=PAIRS, ids=PAIR_IDS)
def pair(request):
    return request.param


@contextlib.contextmanager
def _broker(pkg: str, **kw):
    b = PKG[pkg].Broker(**kw)
    try:
        yield b
    finally:
        b.close()


def _make(pkg: str, broker, **over):
    cfg = {"MQTT_HOST": broker.host, "MQTT_PORT": str(broker.port), "MQTT_TIMEOUT": "5", **over}
    return PKG[pkg].mqtt.MQTTPubSub(PKG[pkg].mqtt.MQTTConfig(PKG[pkg].config(cfg)))


@contextlib.contextmanager
def _client(pkg: str, broker, **over):
    c = _make(pkg, broker, **over)
    try:
        yield c
    finally:
        c.close()


def _wait(pred, timeout=5.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _sever(broker):
    """Cut every connection from the broker's side."""
    with broker._lock:
        conns = [s.conn for s in broker._sessions]
    for conn in conns:
        with contextlib.suppress(OSError):
            conn.shutdown(socket.SHUT_RDWR)
        conn.close()


def run(coro):
    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# cross-wire round trips
# ---------------------------------------------------------------------------

def test_qos1_round_trip(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b) as c:
        c.create_topic("orders")
        c.publish_sync("orders", b"hello")
        msg = run(c.subscribe("orders", timeout=5))
        assert msg.value == b"hello" and msg.metadata == {"qos": "1", "retain": "false"}
        assert b.published == [("orders", b"hello", 1)]


def test_qos1_commit_sends_puback(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b) as c:
        c.create_topic("t")
        b.inject("t", b"x", qos=1)
        msg = run(c.subscribe("t", timeout=5))
        assert msg is not None and b.acked == []
        msg.commit()
        _wait(lambda: len(b.acked) == 1, what="the PUBACK")


def test_qos0_needs_no_puback(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b, MQTT_QOS="0") as c:
        assert c.cfg.clean_session
        c.create_topic("t0")
        c.publish_sync("t0", b"fire-and-forget")
        msg = run(c.subscribe("t0", timeout=5))
        assert msg.value == b"fire-and-forget" and msg.metadata["qos"] == "0"
        msg.commit()
        time.sleep(0.1)
        assert b.published == [("t0", b"fire-and-forget", 0)] and b.acked == []


def test_wildcard_subscription(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b) as c:
        c.create_topic("sensors/+/temp")
        b.inject("sensors/kitchen/temp", b"21")
        msg = run(c.subscribe("sensors/+/temp", timeout=5))
        assert msg.topic == "sensors/kitchen/temp" and msg.value == b"21"


def test_unsubscribe_stops_delivery(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b) as c:
        c.create_topic("u")
        c.unsubscribe("u")
        assert "u" not in c._subscribed
        b.inject("u", b"after")
        time.sleep(0.2)
        assert not c._queues.get("u")


def test_two_clients_fan_out(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b, MQTT_CLIENT_ID="c1") as c1, _client(cp, b, MQTT_CLIENT_ID="c2") as c2:
        c1.create_topic("fan")
        c2.create_topic("fan")
        c1.publish_sync("fan", b"m")
        assert run(c1.subscribe("fan", timeout=5)).value == run(c2.subscribe("fan", timeout=5)).value == b"m"


def test_password_auth(pair):
    cp, bp = pair
    with _broker(bp, password="sekrit") as b:
        with _client(cp, b, MQTT_USER="svc", MQTT_PASSWORD="sekrit") as good:
            assert good.health()["status"] == "UP"
        with _client(cp, b, MQTT_USER="svc", MQTT_PASSWORD="wrong") as bad:
            h = bad.health()
            assert h["status"] == "DOWN" and "refused" in h["details"]["error"]
        assert [c.password for c in b.connects] == ["sekrit", "wrong"]


def test_health_up_then_down_when_the_broker_goes(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b) as c:
        h = c.health()
        assert h["status"] == "UP" and h["details"]["backend"] == "MQTT"
        assert h["details"]["host"] == f"{b.host}:{b.port}" and h["details"]["qos"] == 1
        b.close()
        with pytest.raises(Exception):
            c.publish_sync("x", b"y")
        assert c.health()["status"] == "DOWN"


def test_reconnect_resubscribes(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b) as c:
        c.create_topic("r")
        _sever(b)
        deadline = time.monotonic() + 10
        msg = None
        while msg is None and time.monotonic() < deadline:
            b.inject("r", b"back")
            msg = c._pop_blocking("r", timeout=0.5)
        assert msg is not None and msg.value == b"back"


def test_async_facade_and_new_pubsub(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b) as c:
        async def flow():
            c.create_topic("af")
            await c.publish("af", b"async")
            return await c.subscribe("af", timeout=5)

        assert run(flow()).value == b"async"
        ps = new_pubsub("MQTT", pconfig({"PUBSUB_BROKER": b.address, "MQTT_CLIENT_ID": "via-switch"}))
        try:
            assert isinstance(ps, pmqtt.MQTTPubSub) and ps.health()["status"] == "UP"
        finally:
            ps.close()


def test_tls_round_trip(pair):
    pytest.importorskip("cryptography")
    cp, bp = pair
    cert, _ = importlib.import_module(PKG[bp].testutil).self_signed_cert()
    with _broker(bp, tls=True, password="pw") as b, _client(cp, b, MQTT_TLS="true", MQTT_TLS_CA_CERT=cert,
                                                            MQTT_USER="u", MQTT_PASSWORD="pw") as c:
        c.create_topic("sec")
        c.publish_sync("sec", b"over-tls")
        assert run(c.subscribe("sec", timeout=5)).value == b"over-tls"


def test_tls_untrusted_certificate_stays_down(pair):
    pytest.importorskip("cryptography")
    cp, bp = pair
    with _broker(bp, tls=True) as b, _client(cp, b, MQTT_TLS="true") as c:
        assert c.health()["status"] == "DOWN"


@pytest.mark.parametrize("bp", ["jax", "port"])
def test_app_subscriber_commits_on_success(bp):
    """PUBSUB_BACKEND=MQTT through the port's App: the subscribe loop hands
    the message to the handler and its success PUBACKs it."""
    from gofr_tpu_torch.app import App

    with _broker(bp) as b:
        app = App(config=pconfig({"APP_NAME": "mqtt-int", "HTTP_PORT": "0", "METRICS_PORT": "0",
                                  "LOG_LEVEL": "ERROR", "PUBSUB_BACKEND": "MQTT", "MQTT_HOST": b.host,
                                  "MQTT_PORT": str(b.port)}))
        got = []

        async def handler(ctx):
            got.append(ctx.bind())

        app.subscribe("orders", handler)
        app.run_in_background()
        try:
            _wait(lambda: any(s.subs for s in b._sessions), 10, "the subscription")
            b.inject("orders", b'{"id": 7}', qos=1)
            _wait(lambda: got == [{"id": 7}], 10, "the handler")
            _wait(lambda: len(b.acked) == 1, 10, "the PUBACK")
            assert app.container.health()["pubsub"]["status"] == "UP"
        finally:
            app.shutdown()


def test_config_keys_and_defaults_equal_jax():
    for values in ({}, {"PUBSUB_BROKER": "h1:1884,h2"}, {"MQTT_HOST": "m", "MQTT_PORT": "1999", "MQTT_QOS": "0"},
                   {"MQTT_HOST": "m:8883", "MQTT_CLIENT_ID": "x", "MQTT_USER": "u", "MQTT_PASSWORD": "p",
                    "MQTT_KEEPALIVE": "9", "MQTT_TIMEOUT": "2.5", "MQTT_CLEAN_SESSION": "true"}):
        j = jmqtt.MQTTConfig(jconfig(values))
        p = pmqtt.MQTTConfig(pconfig(values))
        assert vars(p) == vars(j)


# ---------------------------------------------------------------------------
# persistent sessions: QoS 1 redelivery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cp", ["port", "jax"])
def test_uncommitted_qos1_message_is_redelivered_after_a_drop(cp):
    with _broker("port") as b, _client(cp, b, MQTT_CLIENT_ID="sub-1") as c:
        assert not c.cfg.clean_session  # QoS 1 defaults to a persistent session
        c.create_topic("jobs")
        b.inject("jobs", b"once", qos=1)
        first = c._pop_blocking("jobs", 5)
        assert first.value == b"once"  # handed out, not committed
        _sever(b)
        again = c._pop_blocking("jobs", 10)
        assert again is not None and again.value == b"once" and b.redelivered == [("jobs", b"once")]
        again.commit()
        _wait(lambda: b.acked, what="the PUBACK")
        with b._lock:
            assert all(not s.unacked for s in b._sessions)


@pytest.mark.parametrize("cp", ["port", "jax"])
def test_persistent_session_holds_messages_while_away(cp):
    with _broker("port") as b:
        with _client(cp, b, MQTT_CLIENT_ID="sub-2") as c:
            c.create_topic("jobs")
        _wait(lambda: "sub-2" in b._held, what="the held session")
        b.inject("jobs", b"while-away", qos=1)
        # the session's subscription is the broker's: a client that
        # subscribes again after its CONNACK receives the held message
        with _client(cp, b, MQTT_CLIENT_ID="sub-2") as c2:
            c2.create_topic("jobs")
            _wait(lambda: b.redelivered == [("jobs", b"while-away")], what="the held message")


def test_clean_session_discards_held_state():
    with _broker("port") as b:
        with _client("port", b, MQTT_CLIENT_ID="sub-3") as c:
            c.create_topic("jobs")
        _wait(lambda: "sub-3" in b._held, what="the held session")
        b.inject("jobs", b"x", qos=1)
        with _client("port", b, MQTT_CLIENT_ID="sub-3", MQTT_CLEAN_SESSION="true") as c2:
            assert c2.health()["status"] == "UP"
            time.sleep(0.2)
            assert b.redelivered == [] and "sub-3" not in b._held


def test_jax_fake_broker_keeps_no_session():
    """ROADMAP queue 3 item 45: JAX's fake answers every CONNECT with a
    fresh session, so an uncommitted QoS 1 message is never sent again and
    the client's at-least-once path cannot be shown against it."""
    with _broker("jax") as b, _client("port", b, MQTT_CLIENT_ID="sub-4") as c:
        c.create_topic("jobs")
        b.inject("jobs", b"once", qos=1)
        assert c._pop_blocking("jobs", 5).value == b"once"
        _sever(b)
        assert c._pop_blocking("jobs", 2) is None


# ---------------------------------------------------------------------------
# byte identity and the parsers
# ---------------------------------------------------------------------------

def _seeded_frames(mp, seed: int):
    rng = np.random.default_rng(seed)

    def text(n):
        return "".join(chr(int(c)) for c in rng.integers(97, 123, size=n))

    frames = [
        mp.connect_packet(text(8), keepalive=int(rng.integers(0, 65536)), clean_session=bool(rng.integers(0, 2)),
                          username=text(int(rng.integers(0, 6))), password=text(int(rng.integers(0, 6)))),
        mp.connack_packet(bool(rng.integers(0, 2)), int(rng.integers(0, 6))),
        mp.publish_packet(f"{text(3)}/{text(4)}", rng.bytes(int(rng.integers(0, 300))), qos=0,
                          retain=bool(rng.integers(0, 2))),
        mp.publish_packet(text(5), rng.bytes(int(rng.integers(0, 20000))), qos=1,
                          packet_id=int(rng.integers(1, 65536)), dup=bool(rng.integers(0, 2))),
        mp.puback_packet(int(rng.integers(1, 65536))),
        mp.subscribe_packet(int(rng.integers(1, 65536)), [(f"{text(3)}/+", 1), ("#", 0)]),
        mp.suback_packet(int(rng.integers(1, 65536)), [0, 1, 0x80]),
        mp.unsubscribe_packet(int(rng.integers(1, 65536)), [text(4), text(2)]),
        mp.unsuback_packet(int(rng.integers(1, 65536))),
        mp.pingreq_packet(), mp.pingresp_packet(), mp.disconnect_packet(),
    ]
    return frames


def _reader(data: bytes):
    buf = bytearray(data)

    def take(n):
        out = bytes(buf[:n])
        if len(out) < n:
            raise ConnectionError("eof")
        del buf[:n]
        return out

    return take


_PARSERS = ("parse_connect", "parse_connack", "parse_publish", "parse_packet_id", "parse_subscribe",
            "parse_suback", "parse_unsubscribe")


def _parsed(mp, data: bytes):
    """Every parser's view of one frame, as comparable values."""
    try:
        p = mp.read_packet_from(_reader(data))
    except (ValueError, ConnectionError, IndexError) as e:
        return ("error", type(e).__name__)
    out = [("packet", p.type, p.flags, bytes(p.body))]
    for name in _PARSERS:
        try:
            v = getattr(mp, name)(p)
            out.append((name, repr(v).replace(mp.__name__, "")))
        except (ValueError, IndexError, UnicodeDecodeError, struct.error) as e:
            out.append((name, "error", type(e).__name__))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_packets_are_byte_identical_and_parse_alike(seed):
    for j, p in zip(_seeded_frames(jmp, seed), _seeded_frames(pmp, seed)):
        assert p == j
        assert _parsed(pmp, j) == _parsed(jmp, j)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 16383, 16384, 2097151, 268435455])
def test_remaining_length_equals_jax(n):
    assert pmp.encode_remaining_length(n) == jmp.encode_remaining_length(n)


def test_topic_filters_equal_jax():
    rng = np.random.default_rng(3)
    levels = ["a", "b", "c", "+", "#"]
    for _ in range(300):
        filt = "/".join(rng.choice(levels, size=int(rng.integers(1, 4))))
        topic = "/".join(rng.choice(levels[:3], size=int(rng.integers(1, 4))))
        assert pmp.topic_matches(filt, topic) == jmp.topic_matches(filt, topic), (filt, topic)


def test_read_packet_size_bound_equals_jax():
    big = jmp.publish_packet("t", b"x" * 5000, qos=0)
    for mp in (jmp, pmp):
        with pytest.raises(ValueError):
            mp.read_packet_from(_reader(big), max_size=1024)
        with pytest.raises(ValueError):  # 5 continuation bytes: at most 4 are allowed
            mp.read_packet_from(_reader(bytes([0x30, 0x80, 0x80, 0x80, 0x80, 0x01])))


def _fuzz_inputs(case: str, seed: int):
    rng = np.random.default_rng(seed)
    if case == "random":
        return [rng.bytes(int(rng.integers(0, 256))) for _ in range(100)]
    frames = [jmp.connect_packet("cid", username="u", password="p"),
              jmp.publish_packet("a/b", b"payload", qos=1, packet_id=7),
              jmp.subscribe_packet(3, [("t/#", 1)])]
    out = []
    for frame in frames:
        for _ in range(40):
            m = bytearray(frame)
            m[int(rng.integers(0, len(m)))] ^= 1 << int(rng.integers(0, 8))
            out.append(bytes(m))
    return out


@pytest.mark.parametrize("case", ["random", "mutated"])
@pytest.mark.parametrize("seed", range(3))
def test_parsers_on_fuzz_inputs_equal_jax_in_bounded_time(case, seed):
    t0 = time.perf_counter()
    for data in _fuzz_inputs(case, seed):
        assert _parsed(pmp, data) == _parsed(jmp, data)
    assert time.perf_counter() - t0 < 60.0
