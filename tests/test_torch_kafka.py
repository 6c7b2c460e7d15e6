"""gofr_tpu_torch's Kafka stack (datasource/scram.py,
datasource/pubsub/{kafkaproto,kafka}.py, testutil/fakekafka.py) against
the JAX package's on the CPU.

- Cross-wire round trips: the port's client against JAX's fake broker, JAX's
  client against the port's broker, and the port against itself, over real
  TCP on ephemeral ports: v2 record batches and the legacy v1 message-set
  fallback, SASL PLAIN / SCRAM-SHA-256 / SCRAM-SHA-512, a wrong password
  refused, TLS with and without SCRAM, an untrusted certificate refused,
  commit / resume / redelivery, start offset ``latest``, several partitions.
- Byte identity of the codecs on inputs made from a seed: message sets,
  record batches, the request encoders, CRC32C, the varint/zigzag codec,
  and ``ScramClient``'s messages under a fixed ``nonce=``.
- The decoders on the fuzz inputs of tests/test_fuzz_codecs.py: both return
  the same records or raise the same error, in bounded time.
- The batch tier over KAFKA on a tiny engine: the port's BatchWorker over
  its KafkaPubSub against JAX's over JAX's client, greedy tokens equal.
- ROADMAP queue 3 items 43 and 44, pinned: the port's consumer commits a
  forward-only watermark where JAX's moves the position back, and the
  port's worker runs a shed Kafka job that JAX's loses.
"""

import base64
import contextlib
import json
import struct
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from gofr_tpu.config import new_mock_config as jconfig
from gofr_tpu.datasource import scram as jscram
from gofr_tpu.datasource.pubsub import kafkaproto as jkp
from gofr_tpu.datasource.pubsub import kafka as jkafka
from gofr_tpu.testutil import fakekafka as jfake
from gofr_tpu_torch.config import new_mock_config as pconfig
from gofr_tpu_torch.datasource import scram as pscram
from gofr_tpu_torch.datasource.pubsub import kafkaproto as pkp
from gofr_tpu_torch.datasource.pubsub import kafka as pkafka
from gofr_tpu_torch.datasource.pubsub import new_pubsub
from gofr_tpu_torch.testutil import fakekafka as pfake

PKG = {
    "jax": SimpleNamespace(kp=jkp, kafka=jkafka, Broker=jfake.FakeKafkaBroker, config=jconfig, scram=jscram,
                           testutil="gofr_tpu.testutil"),
    "port": SimpleNamespace(kp=pkp, kafka=pkafka, Broker=pfake.FakeKafkaBroker, config=pconfig, scram=pscram,
                            testutil="gofr_tpu_torch.testutil"),
}
# (client, broker): each package's client against the other's broker, and the port alone
PAIRS = [("port", "jax"), ("jax", "port"), ("port", "port")]
PAIR_IDS = [f"{c}-client-{b}-broker" for c, b in PAIRS]


def _tls(pkg: str):
    import importlib

    return importlib.import_module(PKG[pkg].testutil).client_tls_context()


@contextlib.contextmanager
def _broker(pkg: str, **kw):
    b = PKG[pkg].Broker(**kw)
    try:
        yield b
    finally:
        b.close()


@contextlib.contextmanager
def _client(pkg: str, broker, **over):
    cfg = {"PUBSUB_BROKER": broker.address, "KAFKA_BATCH_SIZE": "4", "KAFKA_BATCH_TIMEOUT": "50", **over}
    c = PKG[pkg].kafka.KafkaPubSub(PKG[pkg].kafka.KafkaConfig(PKG[pkg].config(cfg)))
    try:
        yield c
    finally:
        c.close()


def _wait(pred, timeout=5.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(params=PAIRS, ids=PAIR_IDS)
def pair(request):
    return request.param


# ---------------------------------------------------------------------------
# cross-wire round trips
# ---------------------------------------------------------------------------

def test_round_trip_negotiates_v2_records(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b) as c:
        c.publish_sync("nb", b"m1")
        c.flush()
        assert c._broker_at(b.host, b.port).uses_v2_records()
        m = c.subscribe_sync("nb", timeout=5)
        assert m.value == b"m1" and m.metadata["offset"] == "0" and m.metadata["partition"] == "0"


def test_legacy_broker_falls_back_to_v1_message_sets(pair):
    cp, bp = pair
    with _broker(bp, legacy=True) as b, _client(cp, b) as c:
        c.publish_sync("lb", b"m1")
        c.flush()
        assert not c._broker_at(b.host, b.port).uses_v2_records()
        m = c.subscribe_sync("lb", timeout=5)
        assert m.value == b"m1"
        m.commit()
        assert b.committed(c.cfg.group, "lb") == 1


def _authed(cp, b, mech, pw="hunter2", **over):
    return _client(cp, b, KAFKA_SASL_MECHANISM=mech, KAFKA_SASL_USERNAME="svc", KAFKA_SASL_PASSWORD=pw, **over)


@pytest.mark.parametrize("mech", ["PLAIN", "SCRAM-SHA-256", "SCRAM-SHA-512"])
def test_sasl_round_trip(pair, mech):
    cp, bp = pair
    with _broker(bp, users={"svc": "hunter2"}) as b, _authed(cp, b, mech) as c:
        c.publish_sync("auth-t", b"secret-payload")
        c.flush()
        assert b.records("auth-t")[0].value == b"secret-payload"
        assert c.subscribe_sync("auth-t", timeout=5).value == b"secret-payload"


@pytest.mark.parametrize("mech", ["PLAIN", "SCRAM-SHA-256", "SCRAM-SHA-512"])
def test_sasl_wrong_password_refused(pair, mech):
    cp, bp = pair
    with _broker(bp, users={"svc": "hunter2"}) as b, _authed(cp, b, mech, pw="wrong") as c:
        with pytest.raises((PKG[cp].kafka.KafkaError, ConnectionError)):
            c.create_topic("auth-t")
        assert b.records("auth-t") == []


def test_unauthenticated_client_cut_off(pair):
    cp, bp = pair
    with _broker(bp, users={"svc": "hunter2"}) as b, _client(cp, b) as c:
        with pytest.raises((ConnectionError, OSError)):
            c.create_topic("t")


def test_tls_round_trip(pair):
    pytest.importorskip("cryptography")
    cp, bp = pair
    with _broker(bp, tls=True) as b, _client(cp, b) as c:
        c.cfg.tls = _tls(bp)  # trust the certificate this broker serves
        c.publish_sync("tls-t", b"over-tls")
        c.flush()
        assert c.subscribe_sync("tls-t", timeout=5).value == b"over-tls"


def test_tls_untrusted_certificate_refused(pair):
    pytest.importorskip("cryptography")
    import ssl

    cp, bp = pair
    with _broker(bp, tls=True) as b, _client(cp, b) as c:
        c.cfg.tls = True  # the default trust store: the test certificate is not in it
        with pytest.raises((ssl.SSLError, ConnectionError, OSError)):
            c.create_topic("t")


def test_tls_with_scram(pair):
    pytest.importorskip("cryptography")
    cp, bp = pair
    with _broker(bp, users={"svc": "pw"}, tls=True) as b, _authed(cp, b, "SCRAM-SHA-256", pw="pw") as c:
        c.cfg.tls = _tls(bp)
        c.publish_sync("both-t", b"authed+tls")
        c.flush()
        assert b.records("both-t")[0].value == b"authed+tls"


def test_commit_persists_and_a_new_client_resumes(pair):
    cp, bp = pair
    with _broker(bp) as b:
        b.seed("jobs", [b"m0", b"m1", b"m2"])
        with _client(cp, b, KAFKA_CONSUMER_GROUP="g1") as c:
            m0 = c.subscribe_sync("jobs", timeout=5)
            assert m0.value == b"m0"
            m0.commit()
            assert b.committed("g1", "jobs") == 1
        with _client(cp, b, KAFKA_CONSUMER_GROUP="g1") as c2:
            assert c2.subscribe_sync("jobs", timeout=5).value == b"m1"


def test_uncommitted_record_is_redelivered_to_a_new_client(pair):
    cp, bp = pair
    with _broker(bp) as b:
        b.seed("jobs", [b"m0"])
        with _client(cp, b, KAFKA_CONSUMER_GROUP="g2") as c:
            assert c.subscribe_sync("jobs", timeout=5).value == b"m0"  # not committed
        with _client(cp, b, KAFKA_CONSUMER_GROUP="g2") as c2:
            again = c2.subscribe_sync("jobs", timeout=5)
            assert again is not None and again.value == b"m0"


def test_start_offset_latest_skips_the_backlog(pair):
    cp, bp = pair
    with _broker(bp) as b:
        b.seed("logs", [b"old1", b"old2"])
        with _client(cp, b, KAFKA_START_OFFSET="latest", KAFKA_CONSUMER_GROUP="g3") as c:
            assert c.subscribe_sync("logs", timeout=0.3) is None
            c.publish_sync("logs", b"new")
            c.flush()
            assert c.subscribe_sync("logs", timeout=5).value == b"new"


def test_partitions_round_robin_and_all_are_consumed(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b, KAFKA_PARTITIONS="3", KAFKA_BATCH_SIZE="1") as c:
        c.create_topic("mp")
        for i in range(6):
            c.publish_sync("mp", f"v{i}".encode())
        c.flush()
        per_part = [len(b.records("mp", p)) for p in range(3)]
        assert per_part == [2, 2, 2]
        got = []
        deadline = time.time() + 10
        while len(got) < 6 and time.time() < deadline:
            m = c.subscribe_sync("mp", timeout=1.0)
            if m is not None:
                got.append(m.value)
                m.commit()
        assert sorted(got) == [f"v{i}".encode() for i in range(6)]
        assert [b.committed(c.cfg.group, "mp", p) for p in range(3)] == [2, 2, 2]


def test_failed_produce_is_requeued_not_dropped(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b, KAFKA_BATCH_SIZE="1000", KAFKA_BATCH_TIMEOUT="60000") as c:
        c.create_topic("t")
        c.publish_sync("t", b"keep-me")
        b.fail_next_produce = PKG[bp].kp.NOT_LEADER_FOR_PARTITION
        with pytest.raises(Exception):
            c.flush()
        assert b.records("t") == []
        c.flush()
        assert [r.value for r in b.records("t")] == [b"keep-me"]


def test_producer_buffer_cap_raises(pair):
    cp, _ = pair
    c = PKG[cp].kafka.KafkaPubSub(PKG[cp].kafka.KafkaConfig(PKG[cp].config(
        {"PUBSUB_BROKER": "127.0.0.1:1", "KAFKA_MAX_BUFFER": "2", "KAFKA_BATCH_SIZE": "100",
         "KAFKA_BATCH_TIMEOUT": "60000"})))
    try:
        c.publish_sync("t", b"a")
        c.publish_sync("t", b"b")
        with pytest.raises(PKG[cp].kafka.KafkaError, match="producer buffer full"):
            c.publish_sync("t", b"c")
    finally:
        c._closed = True  # nothing to flush to: skip close's flush
        c.close()


def test_batching_by_size(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b, KAFKA_BATCH_SIZE="3", KAFKA_BATCH_TIMEOUT="60000") as c:
        c.create_topic("t")
        c.publish_sync("t", b"a")
        c.publish_sync("t", b"b")
        assert b.records("t") == []
        c.publish_sync("t", b"c")
        _wait(lambda: len(b.records("t")) == 3, what="the size-triggered flush")
        assert [r.value for r in b.records("t")] == [b"a", b"b", b"c"]


def test_publish_auto_creates_and_admin_creates_and_deletes(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b) as c:
        c.publish_sync("fresh", b"v")
        c.flush()
        assert [r.value for r in b.records("fresh")] == [b"v"]
        c.create_topic("adm")
        c.create_topic("adm")  # TOPIC_ALREADY_EXISTS is tolerated
        assert "adm" in b._topics
        c.delete_topic("adm")
        assert "adm" not in b._topics


def test_tombstone_surfaces_as_metadata(pair):
    cp, bp = pair
    with _broker(bp) as b, _client(cp, b) as c:
        b.seed("compacted", [b"live"])
        b.seed("compacted", [None])
        m1 = c.subscribe_sync("compacted", timeout=5)
        assert m1.value == b"live" and "tombstone" not in m1.metadata
        m1.commit()
        m2 = c.subscribe_sync("compacted", timeout=5)
        assert m2.value == b"" and m2.metadata.get("tombstone") == "true"


def test_reconnect_reauthenticates(pair):
    cp, bp = pair
    with _broker(bp, users={"svc": "hunter2"}) as b, _authed(cp, b, "SCRAM-SHA-256") as c:
        c.publish_sync("rc", b"before")
        c.flush()
        _wait(lambda: [r.value for r in b.records("rc")] == [b"before"], what="the first produce")
        c._broker_at(b.host, b.port).close()  # a dropped connection
        c.publish_sync("rc", b"after")
        c.flush()
        _wait(lambda: len(b.records("rc")) == 2, what="the produce after the reconnect")
        assert [r.value for r in b.records("rc")] == [b"before", b"after"]


def test_health_up_and_down_and_the_async_facade(pair):
    import asyncio

    cp, bp = pair
    with _broker(bp) as b, _client(cp, b) as c:
        h = c.health()
        assert h["status"] == "UP" and h["details"]["backend"] == "KAFKA"
        assert h["details"]["brokers"] == [b.address]

        async def flow():
            await c.publish("a-topic", b"async-v")
            c.flush()
            return await c.subscribe("a-topic", timeout=5.0)

        assert asyncio.run(flow()).value == b"async-v"
    dead = PKG[cp].kafka.KafkaPubSub(PKG[cp].kafka.KafkaConfig(PKG[cp].config({"PUBSUB_BROKER": "127.0.0.1:1"})))
    try:
        h = dead.health()
        assert h["status"] == "DOWN" and h["details"]["backend"] == "KAFKA"
    finally:
        dead.close()


def test_config_keys_and_defaults_equal_jax():
    for values in ({}, {"PUBSUB_BROKER": "a:1, b:2", "KAFKA_SASL_MECHANISM": "SCRAM-SHA-512",
                        "KAFKA_SASL_USERNAME": "u", "KAFKA_SASL_PASSWORD": "p", "KAFKA_CONSUMER_GROUP": "g",
                        "KAFKA_BATCH_SIZE": "7", "KAFKA_BATCH_BYTES": "99", "KAFKA_BATCH_TIMEOUT": "5",
                        "KAFKA_START_OFFSET": "latest", "KAFKA_PARTITIONS": "3", "APP_NAME": "x",
                        "KAFKA_MAX_BUFFER": "11"}):
        j = jkafka.KafkaConfig(jconfig(values))
        p = pkafka.KafkaConfig(pconfig(values))
        assert vars(p) == vars(j)


def test_new_pubsub_builds_the_kafka_client(pair):
    _, bp = pair
    with _broker(bp) as b:
        ps = new_pubsub("KAFKA", pconfig({"PUBSUB_BROKER": b.address}))
        try:
            assert isinstance(ps, pkafka.KafkaPubSub)
            assert ps.health()["status"] == "UP"
        finally:
            ps.close()


# ---------------------------------------------------------------------------
# byte identity of the codecs
# ---------------------------------------------------------------------------

def _seeded_records(seed: int, n: int = 6, headers: bool = True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = None if rng.random() < 0.3 else rng.bytes(int(rng.integers(0, 12)))
        value = None if rng.random() < 0.15 else rng.bytes(int(rng.integers(0, 200)))
        hdrs = {}
        if headers:
            for k in range(int(rng.integers(0, 3))):
                hdrs[f"h{k}"] = None if rng.random() < 0.3 else rng.bytes(int(rng.integers(0, 8)))
        out.append(dict(key=key, value=value, timestamp=int(rng.integers(0, 2**40)), offset=i, headers=hdrs))
    return out


def _recs(kp, specs, headers=True):
    return [kp.Record(key=s["key"], value=s["value"], timestamp=s["timestamp"], offset=s["offset"],
                      **({"headers": s["headers"]} if headers else {})) for s in specs]


def _fields(recs):
    return [(r.key, r.value, r.offset, r.timestamp, r.headers) for r in recs]


@pytest.mark.parametrize("seed", range(6))
def test_message_sets_are_byte_identical(seed):
    specs = _seeded_records(seed, headers=False)
    j = jkp.encode_message_set(_recs(jkp, specs, headers=False))
    p = pkp.encode_message_set(_recs(pkp, specs, headers=False))
    assert p == j
    assert _fields(pkp.decode_message_set(j)) == _fields(jkp.decode_message_set(j))


@pytest.mark.parametrize("seed", range(6))
def test_record_batches_are_byte_identical(seed):
    specs = _seeded_records(seed)
    base = int(np.random.default_rng(seed).integers(0, 2**33))
    j = jkp.encode_record_batch(_recs(jkp, specs), base_offset=base)
    p = pkp.encode_record_batch(_recs(pkp, specs), base_offset=base)
    assert p == j
    got = pkp.decode_record_batches(j)
    assert _fields(got) == _fields(jkp.decode_record_batches(j))
    assert [r.offset for r in got] == [base + i for i in range(len(specs))]
    assert _fields(pkp.decode_records(j)) == _fields(jkp.decode_records(j))


def test_control_batches_are_skipped_as_jax_skips_them():
    for kp in (jkp, pkp):
        data = kp.encode_record_batch([kp.Record(b"k", b"v", 1)], base_offset=0)
        ctrl = bytearray(kp.encode_record_batch([kp.Record(None, b"\x00\x00\x00\x00", 1)], base_offset=1))
        attrs_off = 8 + 4 + 4 + 1 + 4
        struct.pack_into(">h", ctrl, attrs_off, struct.unpack_from(">h", ctrl, attrs_off)[0] | 0x20)
        struct.pack_into(">I", ctrl, 17, kp.crc32c(bytes(ctrl[attrs_off:])))
        assert [(r.key, r.value) for r in kp.decode_record_batches(data + bytes(ctrl))] == [(b"k", b"v")]


@pytest.mark.parametrize("seed", range(4))
def test_crc32c_equals_jax(seed):
    assert pkp.crc32c(b"123456789") == 0xE3069283  # RFC 3720 B.4
    rng = np.random.default_rng(seed)
    for _ in range(20):
        data = rng.bytes(int(rng.integers(0, 300)))
        assert pkp.crc32c(data) == jkp.crc32c(data)
        start = int(rng.integers(1, 2**32))
        assert pkp.crc32c(data, start) == jkp._crc32c_py(data, start)


@pytest.mark.parametrize("seed", range(4))
def test_varint_zigzag_equals_jax(seed):
    rng = np.random.default_rng(seed)
    values = [0, 1, -1, 63, -64, 64, 300, -300, 2**31, -(2**31), 2**62, -(2**63)]
    values += [int(v) for v in rng.integers(-(2**62), 2**62, size=50)]
    for v in values:
        enc = pkp.enc_varint(v)
        assert enc == jkp.enc_varint(v)
        assert pkp.dec_varint(enc, 0) == jkp.dec_varint(enc, 0) == (v, len(enc))


@pytest.mark.parametrize("seed", range(4))
def test_request_and_response_codecs_are_byte_identical(seed):
    rng = np.random.default_rng(seed)
    topic = f"t{int(rng.integers(0, 1000))}"
    parts = {int(p): int(rng.integers(0, 2**40)) for p in rng.integers(0, 8, size=3)}
    blob = {p: rng.bytes(int(rng.integers(0, 64))) for p in parts}
    cases = [
        ("encode_request", (1, 4, int(rng.integers(0, 2**31)), "cid", rng.bytes(20))),
        ("encode_response", (int(rng.integers(0, 2**31)), rng.bytes(20))),
        ("enc_api_versions_req", ()),
        ("enc_api_versions_resp", ({0: (0, 3), 1: (0, 4), 18: (0, 0)},)),
        ("enc_sasl_handshake_req", ("SCRAM-SHA-256",)),
        ("enc_sasl_handshake_resp", (0, ["PLAIN", "SCRAM-SHA-256"])),
        ("enc_sasl_authenticate_req", (rng.bytes(30),)),
        ("enc_sasl_authenticate_resp", (0, None, rng.bytes(30))),
        ("enc_metadata_req", ([topic],)),
        ("enc_metadata_req", (None,)),
        ("enc_metadata_resp", ({0: ("127.0.0.1", 9092)}, 0, {topic: (0, [(p, 0) for p in parts])})),
        ("enc_produce_req", (1, 5000, {topic: blob})),
        ("enc_produce_req_v3", (1, 5000, {topic: blob})),
        ("enc_produce_resp", ({topic: {p: (0, o) for p, o in parts.items()}},)),
        ("enc_fetch_req", (200, 1, {topic: {p: (o, 1 << 20) for p, o in parts.items()}})),
        ("enc_fetch_req_v4", (200, 1, 1 << 25, {topic: {p: (o, 1 << 20) for p, o in parts.items()}})),
        ("enc_fetch_resp", ({topic: {p: (0, o, blob[p]) for p, o in parts.items()}},)),
        ("enc_fetch_resp_v4", ({topic: {p: (0, o, blob[p]) for p, o in parts.items()}},)),
        ("enc_list_offsets_req", ({topic: {p: -2 for p in parts}},)),
        ("enc_list_offsets_resp", ({topic: {p: (0, o) for p, o in parts.items()}},)),
        ("enc_offset_commit_req", ("grp", {topic: parts})),
        ("enc_offset_commit_resp", ({topic: {p: 0 for p in parts}},)),
        ("enc_offset_fetch_req", ("grp", {topic: sorted(parts)})),
        ("enc_offset_fetch_resp", ({topic: {p: (o, 0) for p, o in parts.items()}},)),
        ("enc_find_coordinator_req", ("grp",)),
        ("enc_find_coordinator_resp", (0, 0, "127.0.0.1", 9092)),
        ("enc_create_topics_req", ({topic: 3},)),
        ("enc_create_topics_resp", ({topic: 0},)),
        ("enc_delete_topics_req", ([topic],)),
        ("enc_delete_topics_resp", ({topic: 0},)),
    ]
    for name, args in cases:
        try:
            want = getattr(jkp, name)(*args)
        except Exception as e:  # noqa: BLE001 - an argument shape JAX refuses is refused alike
            with pytest.raises(type(e)):
                getattr(pkp, name)(*args)
            continue
        assert getattr(pkp, name)(*args) == want, name


@pytest.mark.parametrize("mech", ["SCRAM-SHA-1", "SCRAM-SHA-256", "SCRAM-SHA-512"])
@pytest.mark.parametrize("seed", range(2))
def test_scram_client_messages_equal_jax_under_a_fixed_nonce(mech, seed):
    rng = np.random.default_rng(seed)
    nonce = base64.b64encode(rng.bytes(18)).decode()
    user = ["svc", "a=b,c"][seed]
    pw = base64.b64encode(rng.bytes(9)).decode()
    j = jscram.ScramClient(mech, user, pw, nonce=nonce)
    p = pscram.ScramClient(mech, user, pw, nonce=nonce)
    assert p.first_message() == j.first_message()
    salt = rng.bytes(16)
    server_first = f"r={nonce}{base64.b64encode(rng.bytes(9)).decode()},s={base64.b64encode(salt).decode()},i=4096"
    final = p.process_server_first(server_first)
    assert final == j.process_server_first(server_first)
    # the verifier of either package accepts the proof and signs the same way
    srv = pscram.ScramServer(mech, {user: pw})
    srv._salt, srv._snonce = salt, server_first.split(",")[0][2 + len(nonce):]
    assert srv.process_client_first(p.first_message()) == server_first
    v = srv.process_client_final(final)
    p.verify_server_final(v)
    j.verify_server_final(v)
    assert pscram.scram_server_keys(mech, pw, salt, 4096) == jscram.scram_server_keys(mech, pw, salt, 4096)
    with pytest.raises(pscram.ScramError):
        p.verify_server_final("v=" + base64.b64encode(b"x" * 32).decode())


def test_scram_errors_equal_jax():
    for bad in ("r=other,s=c2FsdA==,i=4096", "r=abc", "s=c2FsdA==,i=4096"):
        with pytest.raises(pscram.ScramError):
            pscram.ScramClient("SCRAM-SHA-256", "u", "p", nonce="abc1").process_server_first(bad)
        with pytest.raises(jscram.ScramError):
            jscram.ScramClient("SCRAM-SHA-256", "u", "p", nonce="abc1").process_server_first(bad)
    with pytest.raises(pscram.ScramError, match="unsupported mechanism"):
        pscram.ScramClient("SCRAM-MD5", "u", "p")
    srv = pscram.ScramServer("SCRAM-SHA-256", {"u": "right"})
    c = pscram.ScramClient("SCRAM-SHA-256", "u", "wrong")
    final = c.process_server_first(srv.process_client_first(c.first_message()))
    with pytest.raises(pscram.ScramError, match="authentication failed"):
        srv.process_client_final(final)


# ---------------------------------------------------------------------------
# the decoders on the fuzz inputs (tests/test_fuzz_codecs.py's cases)
# ---------------------------------------------------------------------------

def _outcome(fn, data):
    try:
        return ("ok", [(r.key, r.value, r.offset) for r in fn(data)])
    except (ValueError, struct.error, EOFError, IndexError) as e:
        return ("error", type(e).__name__)


def _fuzz_inputs(case: str, seed: int):
    rng = np.random.default_rng(seed)
    if case == "random":
        return [rng.bytes(int(rng.integers(0, 256))) for _ in range(100)]
    if case == "message_set":
        base = jkp.encode_message_set([jkp.Record(key=b"k", value=b"some-value", timestamp=5)])
    else:
        base = jkp.encode_record_batch([jkp.Record(b"k", b"v" * 20, 1, headers={"h": b"x"})] * 3)
    out = []
    for _ in range(100):
        m = bytearray(base)
        for _m in range(int(rng.integers(1, 4))):
            m[int(rng.integers(0, len(m)))] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(m))
    out.append(base[: len(base) // 2])  # a truncated tail
    return out


@pytest.mark.parametrize("case", ["random", "message_set", "record_batch"])
@pytest.mark.parametrize("decoder", ["decode_message_set", "decode_record_batches", "decode_records"])
def test_decoders_on_fuzz_inputs_equal_jax_in_bounded_time(case, decoder):
    t0 = time.perf_counter()
    for seed in range(3):
        for data in _fuzz_inputs(case, seed):
            assert _outcome(getattr(pkp, decoder), data) == _outcome(getattr(jkp, decoder), data)
    assert time.perf_counter() - t0 < 60.0


# ---------------------------------------------------------------------------
# ROADMAP queue 3 item 43: the commit position moves only forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_out_of_order_commits_keep_the_position_forward(pkg):
    """Kafka commits a position. Records handed out 0-3 and committed in
    the order 3, 1, 0, 2 (a worker with concurrency finishes them so):
    JAX's client commits offset+1 each time, so the position goes 4, 2, 1, 3
    and a new consumer of the group is handed record 3 again, which was
    done; after the commit of 3 alone records 0-2, still running, sit
    behind the position. The port commits the lowest offset still handed
    out: nothing moves until record 0 is done, then 2, then 4."""
    with _broker(pkg) as b, _client(pkg, b, KAFKA_CONSUMER_GROUP="g") as c:
        b.seed("t", [f"m{i}".encode() for i in range(4)])
        msgs = [c.subscribe_sync("t", timeout=5) for _ in range(4)]
        assert [m.value for m in msgs] == [b"m0", b"m1", b"m2", b"m3"]
        seen = []
        for i in (3, 1, 0, 2):
            msgs[i].commit()
            seen.append(b.committed("g", "t"))
        with _client(pkg, b, KAFKA_CONSUMER_GROUP="g") as fresh:
            again = fresh.subscribe_sync("t", timeout=0.5)
        if pkg == "port":
            assert seen == [None, None, 2, 4] and again is None
        else:
            assert seen == [4, 2, 1, 3] and again.value == b"m3"


# ---------------------------------------------------------------------------
# the batch tier over KAFKA on a tiny engine
# ---------------------------------------------------------------------------

VOCAB = 300
ENGINE_KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8, 16))


@pytest.fixture(scope="module")
def weights():
    import jax
    import jax.numpy as jnp
    import torch

    from gofr_tpu.models import transformer as JT
    from gofr_tpu_torch.models import transformer as TT

    jcfg = JT.TransformerConfig.tiny(vocab_size=VOCAB)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (VOCAB, jcfg.d_model), jnp.float32))
    tcfg = TT.TransformerConfig.tiny(vocab_size=VOCAB)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    torch.set_num_threads(n)


class _Container(SimpleNamespace):
    def __init__(self, pubsub, handle):
        super().__init__(pubsub=pubsub, logger=None, metrics_manager=None, _handle=handle)

    def tpu(self):
        return SimpleNamespace(llm=lambda name: self._handle)


@contextlib.contextmanager
def _running(worker):
    import asyncio

    loop = asyncio.new_event_loop()
    th = threading.Thread(target=lambda: loop.run_until_complete(worker.run()), daemon=True)
    th.start()
    try:
        yield worker
    finally:
        worker.close()
        th.join(timeout=15)
        loop.close()
        assert not th.is_alive(), "worker loop did not exit"


def _engine(pkg, weights, **kw):
    jcfg, jp, tcfg, tp = weights
    if pkg == "port":
        from gofr_tpu_torch.llm import LLMEngine

        return LLMEngine(tcfg, tp, device="cpu", **{**ENGINE_KW, **kw})
    from gofr_tpu.llm import LLMEngine as JEngine

    return JEngine(jcfg, jp, warmup=False, kv_paged=True, **{**ENGINE_KW, **kw})


def _worker_cls(pkg):
    if pkg == "port":
        from gofr_tpu_torch.batch import BatchWorker
    else:
        from gofr_tpu.batch import BatchWorker
    return BatchWorker


def _read_results(pkg, broker, topic, n, timeout=30.0, **auth):
    """Every record of ``topic`` through a fresh consumer of its own group."""
    out = []
    with _client(pkg, broker, KAFKA_CONSUMER_GROUP="reader", KAFKA_PARTITIONS="2", **auth) as r:
        deadline = time.time() + timeout
        while len(out) < n and time.time() < deadline:
            m = r.subscribe_sync(topic, timeout=0.5)
            if m is not None:
                out.append(json.loads(m.value))
                m.commit()
        assert r.subscribe_sync(topic, timeout=0.3) is None  # nothing beyond the n
    return out


def _jobs_over_kafka(pkg, weights, payloads, users=None, mech=None):
    eng = _engine(pkg, weights)
    auth = dict(KAFKA_SASL_MECHANISM=mech, KAFKA_SASL_USERNAME="svc", KAFKA_SASL_PASSWORD="pw") if mech else {}
    over = dict(KAFKA_PARTITIONS="2", KAFKA_CONSUMER_GROUP="workers", KAFKA_BATCH_TIMEOUT="10", **auth)
    try:
        with _broker(pkg, users=users) as b:
            with _client(pkg, b, **over) as ps:
                w = _worker_cls(pkg)(_Container(ps, eng), "jobs", model="m", poll_timeout=0.05, concurrency=3)
                for p in payloads:
                    ps.publish_sync("jobs", p)
                ps.flush()
                with _running(w):
                    _wait(lambda: w.jobs_ok == len(payloads), 120, "every job")
                    ps.flush()
                committed = [b.committed("workers", "jobs", p) for p in range(2)]
                ends = [len(b.records("jobs", p)) for p in range(2)]
            results = _read_results(pkg, b, "jobs.results", len(payloads), **auth)
        return {r["id"]: r for r in results}, committed, ends
    finally:
        eng.close()


def test_batch_jobs_over_kafka_give_jax_tokens(weights):
    payloads = [json.dumps({"id": f"j{i}", "tokens": [5 + i, 9, 40 + 3 * i, 2][: 2 + i % 3],
                            "max_new_tokens": 6}).encode() for i in range(6)]
    got, committed, ends = _jobs_over_kafka("port", weights, payloads, users={"svc": "pw"}, mech="SCRAM-SHA-256")
    want, _, _ = _jobs_over_kafka("jax", weights, payloads)
    assert sorted(got) == sorted(want) == [f"j{i}" for i in range(6)]
    for jid in got:
        assert got[jid]["tokens"] == want[jid]["tokens"], jid
        assert got[jid]["status"] == "ok" and got[jid]["n_tokens"] == 6
    assert len({tuple(r["tokens"]) for r in got.values()}) > 1
    assert committed == ends  # every record of both partitions committed


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_shed_kafka_job_is_run_not_lost(weights, pkg):
    """ROADMAP queue 3 item 44. An engine shed (EngineOverloaded) hands the
    job back to the broker. JAX's worker republishes only on MEMORY and
    leaves a Kafka record uncommitted for the broker to serve again, but
    the consumer has moved past it: the job is never run in this process.
    The port's worker republishes it and commits the original."""
    if pkg == "port":
        from gofr_tpu_torch.resilience import FaultInjector
    else:
        from gofr_tpu.resilience import FaultInjector
    inj = FaultInjector()
    eng = _engine(pkg, weights, slots=2, shed_predicted_wait_s=1.0, fault_injector=inj)
    try:
        with _broker(pkg) as b, _client(pkg, b, KAFKA_CONSUMER_GROUP="w", KAFKA_BATCH_TIMEOUT="10") as ps:
            w = _worker_cls(pkg)(_Container(ps, eng), "jobs", model="m", poll_timeout=0.1, max_attempts=2)
            inj.arm("overload_pressure", count=1, delay=30.0)
            ps.publish_sync("jobs", json.dumps({"id": "ov", "tokens": [1, 2, 3], "max_new_tokens": 4}).encode())
            ps.flush()
            with _running(w):
                _wait(lambda: w.jobs_requeued == 1, 30, "the shed")
                if pkg == "port":
                    _wait(lambda: w.jobs_ok == 1, 60, "the requeued job")
                    ps.flush()
                    _wait(lambda: b.committed("w", "jobs") == 2, what="both records committed")
                else:
                    time.sleep(1.5)  # past the pause: a redelivery would have run by now
                    assert w.jobs_ok == 0 and b.committed("w", "jobs") is None
    finally:
        eng.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_result_is_on_the_broker_before_the_job_commits(weights, pkg):
    """ROADMAP queue 3 item 46. KafkaPubSub.publish_sync only buffers for
    the batching producer. JAX's worker commits the job as soon as its
    result is in that buffer: here, with a flush timeout of a minute, the
    job is committed while the broker has no result, so a crash then loses
    the job. The port's worker drains the producer before the commit."""
    eng = _engine(pkg, weights)
    try:
        with _broker(pkg) as b, _client(pkg, b, KAFKA_CONSUMER_GROUP="w", KAFKA_BATCH_SIZE="1000",
                                        KAFKA_BATCH_TIMEOUT="60000") as ps:
            w = _worker_cls(pkg)(_Container(ps, eng), "jobs", model="m", poll_timeout=0.1)
            ps.publish_sync("jobs", json.dumps({"id": "d1", "tokens": [1, 2, 3], "max_new_tokens": 4}).encode())
            ps.flush()
            with _running(w):
                _wait(lambda: w.jobs_ok == 1, 60, "the job")
                assert b.committed("w", "jobs") == 1
                results = [json.loads(r.value)["id"] for r in b.records("jobs.results")]
                assert results == (["d1"] if pkg == "port" else [])
    finally:
        eng.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_requeued_job_is_on_the_broker_before_the_original_commits(weights, pkg):
    """ROADMAP queue 3 item 50, the twin of item 46's test. A shed job is
    republished with publish_sync, which only buffers for the batching
    producer: with a flush timeout of a minute, a commit right after it
    would leave the job committed while its copy is not on the broker,
    where a crash loses it. The port's worker drains the producer before
    it commits the original. JAX's never republishes on KAFKA (item 44):
    the topic keeps its one record and nothing is committed."""
    if pkg == "port":
        from gofr_tpu_torch.resilience import FaultInjector
    else:
        from gofr_tpu.resilience import FaultInjector
    inj = FaultInjector()
    eng = _engine(pkg, weights, slots=2, shed_predicted_wait_s=1.0, fault_injector=inj)
    try:
        with _broker(pkg) as b, _client(pkg, b, KAFKA_CONSUMER_GROUP="w", KAFKA_BATCH_SIZE="1000",
                                        KAFKA_BATCH_TIMEOUT="60000") as ps:
            seen = []  # the topic's records on the broker at each commit of "jobs"
            commit = b._offset_commit

            def watched(group, topics):
                if "jobs" in topics:
                    seen.append([json.loads(r.value) for r in b.records("jobs")])
                return commit(group, topics)

            b._offset_commit = watched
            w = _worker_cls(pkg)(_Container(ps, eng), "jobs", model="m", poll_timeout=0.1, max_attempts=2)
            inj.arm("overload_pressure", count=1, delay=30.0)
            ps.publish_sync("jobs", json.dumps({"id": "rq", "tokens": [1, 2, 3], "max_new_tokens": 4}).encode())
            ps.flush()
            with _running(w):
                _wait(lambda: w.jobs_requeued == 1, 30, "the shed")
                if pkg == "port":
                    _wait(lambda: len(seen) >= 1, 10, "the original's commit")
                    assert [r["id"] for r in seen[0]] == ["rq", "rq"]  # the copy went first
                    _wait(lambda: w.jobs_ok == 1, 60, "the requeued job")
                    _wait(lambda: b.committed("w", "jobs") == 2, what="both records committed")
                else:
                    time.sleep(1.5)
                    assert seen == [] and len(b.records("jobs")) == 1 and w.jobs_ok == 0
    finally:
        eng.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_an_empty_topic_is_not_fetched_in_a_spin(pkg):
    """ROADMAP queue 3 item 47. The fake broker answers an empty fetch at
    once. JAX's consumer fetches again at once, thousands of times a
    second, holding the connection's lock its producer and commits wait
    on; the port's backs off 5 ms after an empty fetch that came back
    sooner."""
    with _broker(pkg) as b, _client(pkg, b) as c:
        c.create_topic("quiet")
        assert c.subscribe_sync("quiet", timeout=0.05) is None  # the reader's offsets
        calls = []
        fetch = c._fetch_once

        def counted(*a, **kw):
            calls.append(1)
            return fetch(*a, **kw)

        c._fetch_once = counted
        assert c.subscribe_sync("quiet", timeout=0.5) is None
        c.publish_sync("quiet", b"late")
        c.flush()
        assert c.subscribe_sync("quiet", timeout=5).value == b"late"
        if pkg == "port":
            assert len(calls) <= 0.5 / 0.005 + 5
        else:
            assert len(calls) > 300  # thousands: a fetch each round trip


def test_testutil_capture_and_tls_helpers_equal_jax():
    import ssl
    import sys

    from gofr_tpu import testutil as jtu
    from gofr_tpu_torch import testutil as ptu

    for tu in (jtu, ptu):
        out, err = sys.stdout, sys.stderr
        with tu.capture_stdout() as o, tu.capture_stderr() as e:
            print("to stdout")
            print("to stderr", file=sys.stderr)
        assert (o.getvalue(), e.getvalue()) == ("to stdout\n", "to stderr\n")
        assert (sys.stdout, sys.stderr) == (out, err)
    pytest.importorskip("cryptography")
    cert, key = ptu.self_signed_cert()
    assert ptu.self_signed_cert() == (cert, key)  # made once per process
    assert open(cert).read().startswith("-----BEGIN CERTIFICATE-----")
    import socket

    srv = socket.create_server(("127.0.0.1", 0))
    srv.settimeout(10)
    got = {}

    def serve():
        conn, _ = srv.accept()
        with ptu.server_tls_context().wrap_socket(conn, server_side=True) as tls:
            got["data"] = tls.recv(5)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    try:
        with socket.create_connection(srv.getsockname(), timeout=10) as raw:
            with ptu.client_tls_context().wrap_socket(raw, server_hostname="localhost") as tls:
                tls.sendall(b"hello")
        th.join(timeout=10)
        assert got["data"] == b"hello"
        assert ptu.client_tls_context().verify_mode == ssl.CERT_REQUIRED
    finally:
        srv.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_consumers_starting_together_share_one_clean_connection(pkg):
    """ROADMAP queue 3 item 48. Three consumers of one client start at
    once (an App's subscribe loops do): each dials the broker through
    ``_bootstrap``. JAX's dials without the broker's lock, so the
    handshakes interleave on one socket: mismatched correlation ids, a
    closed descriptor, or a read that waits out the socket's timeout (10 s;
    1 s here). The port dials under the lock: no error in 20 starts."""
    failures = []
    for _trial in range(20):
        with _broker(pkg, users={"svc": "pw"}) as b, _authed(pkg, b, "SCRAM-SHA-256", pw="pw") as c:
            c._broker_at(b.host, b.port).timeout = 1.0
            errors = []

            def pull(topic):
                try:
                    c.subscribe_sync(topic, timeout=0.1)
                except Exception as e:  # noqa: BLE001 - what the race raises varies
                    errors.append(e)

            threads = [threading.Thread(target=pull, args=(f"t{i}",)) for i in range(3)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=10)
            failures.extend(errors)
        if pkg == "jax" and failures:
            break
    if pkg == "port":
        assert failures == []
    else:
        assert failures, "JAX's client raced in none of 20 starts"
