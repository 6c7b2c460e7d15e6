"""The one-call mock container for tests (counterpart of
gofr_tpu/container/mock.py; the port's ``container`` is a module, so this
lives beside it as ``container_mock``, and ``gofr_tpu_torch.new_mock_container``
is the same function).

    from gofr_tpu_torch import new_mock_container

    c, mocks = new_mock_container()
    c.sql.exec("CREATE TABLE t (id INTEGER)")
    mocks.tpu.results["mnist"] = [0.9]
    ...
    mocks.close()

Every datasource is an in-process stand-in speaking the real protocol or
implementing the real interface: in-memory sqlite through
``datasource.sql.new_sql_mocks``, ``testutil.MiniRedis`` behind the RESP
client, ``MemoryPubSub`` or a ``testutil.fakekafka.FakeKafkaBroker`` behind
``KafkaPubSub``, ``datasource.mongo.InMemoryMongo`` through ``add_mongo``,
and ``MockGPU`` as the runtime (``c.tpu_runtime`` and ``mocks.tpu``, the JAX
package's names). ``mocks`` also carries the backing servers for
assertions (``redis_server``, ``kafka_broker``); ``mocks.close()`` (or a
``with mocks:`` block) tears everything down. Nothing here loads torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from .datasource import STATUS_UP, health

__all__ = ["MockGPU", "Mocks", "new_mock_container"]


class MockGPU:
    """The runtime's test double (counterpart of JAX's ``MockTPU``): records
    every call in ``calls`` and answers with the canned ``results[name]``;
    no device, no torch."""

    def __init__(self, results: dict[str, Any] | None = None):
        self.results = results or {}
        self.calls: list[tuple[str, tuple]] = []

    def register_model(self, name: str, *a, **k) -> None:
        self.calls.append(("register_model", (name,)))
        self.results.setdefault(name, None)

    def infer(self, name: str, *args) -> Any:
        self.calls.append(("infer", (name, *args)))
        return self.results.get(name)

    async def infer_async(self, name: str, *args) -> Any:
        self.calls.append(("infer_async", (name, *args)))
        return self.results.get(name)

    def infer_one(self, name: str, *args, timeout=None) -> Any:
        self.calls.append(("infer_one", (name, *args)))
        return self.results.get(name)

    def health_check(self) -> dict:
        return health(STATUS_UP, platform="mock", device_count=0, models={})

    async def start_batchers(self) -> None:
        pass

    async def stop_batchers(self) -> None:
        pass

    def drain(self) -> None:
        pass

    def drained(self) -> bool:
        return True

    def close(self) -> None:
        pass


@dataclass
class Mocks:
    config: Any
    metrics: Any
    tpu: Any
    sql: Any = None
    redis: Any = None
    redis_server: Any = None
    pubsub: Any = None
    kafka_broker: Any = None
    mongo: Any = None
    _container: Any = field(default=None, repr=False)

    def close(self) -> None:
        if self._container is not None:
            self._container.close()
        if self.redis_server is not None:
            self.redis_server.stop()
        if self.kafka_broker is not None:
            self.kafka_broker.close()

    def __enter__(self) -> "Mocks":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def new_mock_container(
    *,
    sql: bool = True,
    redis: bool = True,
    pubsub: str = "memory",  # "memory" | "kafka" | "none"
    mongo: bool = True,
    overrides: dict[str, str] | None = None,
):
    """A Container with every datasource backed by an in-process stand-in:
    (container, mocks). ``overrides`` are config keys over
    ``APP_NAME=mock-app``."""
    from .config import new_mock_config
    from .container import Container
    from .logging import new_logger

    if pubsub not in ("memory", "kafka", "none"):
        raise ValueError(f"unknown mock pubsub backend {pubsub!r}")
    cfg = new_mock_config({"APP_NAME": "mock-app", **(overrides or {})})
    c = Container(config=cfg, logger=new_logger(level_name="ERROR"))
    c.register_framework_metrics()

    mocks = Mocks(config=cfg, metrics=c.metrics_manager, tpu=MockGPU(), _container=c)
    c.tpu_runtime = mocks.tpu

    if sql:
        from .datasource.sql import new_sql_mocks

        c.sql = mocks.sql = new_sql_mocks(c.logger, c.metrics_manager)

    if redis:
        from .datasource.redis import Redis
        from .testutil import MiniRedis

        mocks.redis_server = MiniRedis().start()
        c.redis = mocks.redis = Redis("127.0.0.1", mocks.redis_server.port, logger=c.logger,
                                      metrics=c.metrics_manager)

    if pubsub == "memory":
        from .datasource.pubsub import MemoryPubSub

        c.pubsub = mocks.pubsub = MemoryPubSub(c.logger, c.metrics_manager)
    elif pubsub == "kafka":
        from .datasource.pubsub.kafka import KafkaConfig, KafkaPubSub
        from .testutil.fakekafka import FakeKafkaBroker

        mocks.kafka_broker = FakeKafkaBroker()
        kcfg = KafkaConfig(new_mock_config({"PUBSUB_BROKER": mocks.kafka_broker.address,
                                            "KAFKA_BATCH_TIMEOUT": "20"}))
        c.pubsub = mocks.pubsub = KafkaPubSub(kcfg, logger=c.logger, metrics=c.metrics_manager)

    if mongo:
        from .datasource.mongo import InMemoryMongo

        c.add_mongo(InMemoryMongo())
        mocks.mongo = c.mongo

    return c, mocks
