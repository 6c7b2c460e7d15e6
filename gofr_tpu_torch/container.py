"""Container: the dependency hub handed to every handler (counterpart of
gofr_tpu/container/__init__.py: config, logger, the metrics manager, the
outbound HTTP services, the Redis and SQL datasources, the pub/sub
backend, the Mongo provider ``add_mongo`` wires, the lazily built runtime
behind ``tpu()`` and the front router). ``create`` installs the
remote-level logger (REMOTE_LOG_URL), registers the framework's series
(the runtime gauges, ``app_info``, the two HTTP histograms,
``app_redis_stats``, ``app_sql_stats``, ``app_mongo_stats``, the two SQL
connection gauges, the three ``app_tpu_*`` histograms of the runtime and
the four ``app_pubsub_*`` counters: the JAX container's set), builds the
Redis client when ``REDIS_HOST`` is set (``datasource.redis.new_client``),
the SQL handle when ``DB_DIALECT`` or ``DB_HOST`` is
(``datasource.sql.new_sql``) and the pub/sub backend ``PUBSUB_BACKEND``
names (``datasource.pubsub.new_pubsub``: MEMORY, FILE, KAFKA, MQTT or
GOOGLE); the manager
also carries the series the runtime and its engines write, and the App's
metrics server serves it. ``tracer`` (set by the App) is handed to the
runtime, which passes it to every engine; ``front_router`` is set by
``router.new_router_app``. ``add_mongo(provider)`` wraps a user-built Mongo
provider in ``datasource.mongo.InstrumentedMongo``, connects it and holds
it as ``mongo``. ``health`` aggregates the SQL, Redis, pub/sub, Mongo,
runtime and service healths; ``close`` closes the Redis client, the SQL
handle, the pub/sub backend, the Mongo provider (when it has ``close``),
the runtime, the front router (its poll, its
probes and the engine processes it launched), the services (breaker
probes, pooled sockets) and the level poller."""

from __future__ import annotations

import threading
import time
from typing import Any

from . import logging as gl
from .config import Config
from .logging.remote import RemoteLevelLogger
from .metrics import DATASOURCE_BUCKETS, HTTP_BUCKETS, TPU_BUCKETS, Manager
from .version import FRAMEWORK


class Container:
    def __init__(self, config: Config | None = None, logger: gl.Logger | None = None):
        self.config = config
        self.logger: gl.Logger = logger or gl.new_logger()
        self.metrics_manager = Manager(self.logger)
        self.app_name = "gofr-tpu-app"
        self.app_version = "dev"
        self.services: dict[str, Any] = {}  # outbound HTTP services by name
        self.redis = None  # datasource.redis.Redis, when REDIS_HOST is set
        self.sql = None  # datasource.sql.DB, when DB_DIALECT or DB_HOST is set
        self.pubsub = None  # PUBSUB_BACKEND's publisher and subscriber
        self.mongo = None  # datasource.mongo.InstrumentedMongo, set by add_mongo
        self.tpu_runtime = None
        self.front_router = None  # the scale-out proxy core (router.new_router_app)
        self.tracer = None  # the App's tracing.Tracer
        self.start_time = time.time()
        self._lock = threading.Lock()

    @classmethod
    def create(cls, config: Config) -> "Container":
        c = cls(config=config, logger=RemoteLevelLogger(
            gl.level_from_string(config.get("LOG_LEVEL")),
            config.get("REMOTE_LOG_URL") or None,
            config.get_float("REMOTE_LOG_FETCH_INTERVAL", 15.0),
        ))
        c.app_name = config.get_or_default("APP_NAME", "gofr-tpu-app")
        c.app_version = config.get_or_default("APP_VERSION", "dev")
        c.register_framework_metrics()
        c.metrics_manager.set_gauge(
            "app_info", 1.0, app_name=c.app_name, app_version=c.app_version, framework_version=FRAMEWORK
        )
        # datasources are wired only when configured
        if config.get("REDIS_HOST"):
            from .datasource.redis import new_client as new_redis

            c.redis = new_redis(config, c.logger, c.metrics_manager)
        if config.get("DB_DIALECT") or config.get("DB_HOST"):
            from .datasource.sql import new_sql

            c.sql = new_sql(config, c.logger, c.metrics_manager)
        backend = (config.get("PUBSUB_BACKEND") or "").upper()
        if backend:
            from .datasource.pubsub import new_pubsub

            c.pubsub = new_pubsub(backend, config, c.logger, c.metrics_manager)
        return c

    def register_framework_metrics(self) -> None:
        m = self.metrics_manager
        m.new_gauge("app_info", "static app info")
        m.new_gauge("app_python_threads", "live thread count")
        m.new_gauge("app_sys_memory_rss", "resident set size bytes")
        m.new_gauge("app_python_gc_gen0", "gen0 allocations since last gc")
        m.new_gauge("app_python_num_gc", "completed gc collections")
        m.new_histogram("app_http_response", "http server response time s", HTTP_BUCKETS)
        m.new_histogram("app_http_service_response", "outbound http call time s", HTTP_BUCKETS)
        m.new_histogram("app_redis_stats", "redis op time s", DATASOURCE_BUCKETS)
        m.new_histogram("app_sql_stats", "sql op time s", DATASOURCE_BUCKETS)
        m.new_histogram("app_mongo_stats", "mongo op time s", DATASOURCE_BUCKETS)
        m.new_gauge("app_sql_open_connections", "open sql connections")
        m.new_gauge("app_sql_inuse_connections", "in-use sql connections")
        m.new_histogram("app_tpu_stats", "tpu execute time s", TPU_BUCKETS)
        m.new_histogram("app_tpu_batch_size", "dynamic batch sizes", (1, 2, 4, 8, 16, 32, 64, 128, 256))
        m.new_histogram("app_tpu_queue_wait", "batch queue wait s", TPU_BUCKETS)
        m.new_counter("app_pubsub_publish_total_count", "messages published")
        m.new_counter("app_pubsub_publish_success_count", "messages published ok")
        m.new_counter("app_pubsub_subscribe_total_count", "subscribe receives")
        m.new_counter("app_pubsub_subscribe_success_count", "messages handled ok")

    @property
    def metrics(self) -> Manager:
        return self.metrics_manager

    def get_http_service(self, name: str):
        return self.services.get(name)

    def get_publisher(self):
        return self.pubsub

    def get_subscriber(self):
        return self.pubsub

    def tpu(self):
        """The GPU runtime (LLM registry), built on first use: an app that
        registers no model never touches the device."""
        with self._lock:
            if self.tpu_runtime is None:
                from .datasource.gpu import GPURuntime

                # engines registered before the App set its tracer serve untraced
                self.tpu_runtime = GPURuntime(self.config, self.logger, metrics=self.metrics_manager,
                                              tracer=self.tracer)
            return self.tpu_runtime

    def health(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.sql is not None:
            out["sql"] = self.sql.health_check()
        if self.redis is not None:
            out["redis"] = self.redis.health_check()
        if self.pubsub is not None:
            out["pubsub"] = self.pubsub.health()
        if self.mongo is not None:
            out["mongo"] = self.mongo.health_check()
        if self.tpu_runtime is not None:
            out["tpu"] = self.tpu_runtime.health_check()
        for name, svc in self.services.items():
            try:
                out[name] = svc.health_check_sync()
            except Exception as e:  # noqa: BLE001
                out[name] = {"status": "DOWN", "details": {"error": str(e)}}
        out["app"] = {
            "status": "UP",
            "details": {
                "name": self.app_name,
                "version": self.app_version,
                "framework": FRAMEWORK,
                "uptime_s": round(time.time() - self.start_time, 3),
            },
        }
        return out

    def add_mongo(self, provider) -> None:
        """Wire a user-built Mongo provider: inject the logger and the
        metrics, connect it, expose it as ``mongo`` (``ctx.mongo``)."""
        from .datasource.mongo import InstrumentedMongo

        db = InstrumentedMongo(provider, self.logger, self.metrics_manager)
        provider.connect()
        self.mongo = db

    def close(self) -> None:
        for ds in (self.redis, self.sql, self.pubsub, self.mongo, self.tpu_runtime, self.front_router):
            if ds is not None and hasattr(ds, "close"):
                try:
                    ds.close()
                except Exception:  # noqa: BLE001 — the rest must still close
                    pass
        for svc in self.services.values():
            svc.close()
        if isinstance(self.logger, RemoteLevelLogger):
            self.logger.close()
