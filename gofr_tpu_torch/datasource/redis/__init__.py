"""Redis datasource: an asyncio RESP2 client (counterpart of
gofr_tpu/datasource/redis/__init__.py).

``new_client`` builds it from the config (``REDIS_HOST``, ``REDIS_PORT``
6379, ``REDIS_DB``, ``REDIS_USER``, ``REDIS_PASSWORD``, and TLS through
``REDIS_TLS`` / ``REDIS_TLS_CA_CERT`` / ``REDIS_TLS_INSECURE``); it
connects lazily. Every command is logged at debug level with its duration
and recorded in the ``app_redis_stats`` histogram by command; health is
PING then INFO stats. The wire protocol is implemented here (no driver
library); ``testutil.MiniRedis`` is an in-process server speaking it.

Commands are async (handlers run on asyncio); sync code (CLI, cron,
migrations) uses ``execute_sync``, which drives a private loop.
Connections are per event loop, so callers on different loops (gRPC
worker threads, tests) never share a socket.
"""

from __future__ import annotations

import asyncio
import itertools
import threading
import time
import weakref
from typing import Any

from .. import STATUS_DOWN, STATUS_UP, health, tls_from_config

__all__ = ["Redis", "new_client"]


class RESPError(Exception):
    pass


def _encode(parts: tuple) -> bytes:
    """RESP2 array-of-bulk-strings command encoding."""
    out = [f"*{len(parts)}\r\n".encode()]
    for p in parts:
        if isinstance(p, bytes):
            b = p
        else:
            b = str(p).encode()
        out.append(f"${len(b)}\r\n".encode())
        out.append(b)
        out.append(b"\r\n")
    return b"".join(out)


async def _decode(reader: asyncio.StreamReader) -> Any:
    line = (await reader.readline()).rstrip(b"\r\n")
    if not line:
        raise RESPError("connection closed")
    t, rest = line[:1], line[1:]
    if t == b"+":
        return rest.decode()
    if t == b"-":
        raise RESPError(rest.decode())
    if t == b":":
        return int(rest)
    if t == b"$":
        n = int(rest)
        if n == -1:
            return None
        data = await reader.readexactly(n + 2)
        return data[:-2]
    if t == b"*":
        n = int(rest)
        if n == -1:
            return None
        return [await _decode(reader) for _ in range(n)]
    raise RESPError(f"bad RESP type byte {t!r}")


def with_suppress_close(writer) -> None:
    """Close a stream writer, swallowing teardown errors."""
    if writer is not None:
        try:
            writer.close()
        except Exception:  # noqa: BLE001
            pass


_CLIENT_SEQ = itertools.count()


class _ConnState:
    """Per-event-loop connection state. Strongly referenced only by the loop
    it belongs to, so it (and its socket) is collected when the loop is."""

    __slots__ = ("reader", "writer", "lock", "__weakref__")

    def __init__(self):
        self.reader = None
        self.writer = None
        self.lock = asyncio.Lock()


class Redis:
    """Minimal-but-real Redis client: GET/SET/DEL/EXISTS/EXPIRE/TTL/INCR/
    HSET/HGET/HGETALL/LPUSH/RPOP/KEYS/FLUSHDB/PING/INFO + raw execute()."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        logger=None,
        metrics=None,
        db: int = 0,
        username: str | None = None,
        password: str | None = None,
        tls=None,
    ):
        self.host, self.port, self.db = host, port, db
        self.username, self.password = username, password
        # tls: None (plaintext), True (default SSLContext), or an
        # ssl.SSLContext (the rediss:// / TLSConfig of a Go driver)
        self.tls = tls
        self.logger = logger
        self.metrics = metrics
        # Asyncio streams and locks bind to the loop that created them, and
        # callers legitimately arrive on different loops (the app loop, gRPC
        # worker threads each running asyncio.run, tests): keep one
        # connection + lock PER LOOP. The state lives as an attribute ON the
        # loop object (not in a map keyed by id(loop) — a recycled id must
        # never hand a new loop streams bound to a dead one, and any map
        # value holding the streams would strongly reference the loop and
        # leak it). A WeakSet tracks live states for close()/health only.
        self._loop_attr = f"_gofr_redis_{next(_CLIENT_SEQ)}"  # never-recycled key
        self._states: "weakref.WeakSet[_ConnState]" = weakref.WeakSet()
        self._loop_states: "weakref.WeakKeyDictionary | None" = None  # uvloop fallback
        self._map_lock = threading.Lock()

    def _conn_state(self) -> "_ConnState":
        loop = asyncio.get_running_loop()
        state = getattr(loop, self._loop_attr, None)
        if state is None:
            with self._map_lock:
                if self._loop_states is not None:
                    state = self._loop_states.get(loop)
        if state is None:
            state = _ConnState()
            try:
                setattr(loop, self._loop_attr, state)
            except AttributeError:
                # C-implemented loops without an instance __dict__ (uvloop)
                # reject arbitrary attributes; fall back to a weak-key map
                # (weak keys avoid leaking dead loops, and no id-recycling
                # hazard since the loop object itself is the key). Init and
                # writes stay under _map_lock — two loops hitting the
                # fallback concurrently must not clobber each other's map.
                with self._map_lock:
                    if self._loop_states is None:
                        self._loop_states = weakref.WeakKeyDictionary()
                    existing = self._loop_states.get(loop)
                    if existing is not None:
                        state = existing
                    else:
                        self._loop_states[loop] = state
        with self._map_lock:
            # idempotent: re-register states that reconnect after close()
            self._states.add(state)
        return state

    async def _ensure(self, state: "_ConnState") -> None:
        if state.writer is None or state.writer.is_closing():
            kw = {}
            if self.tls is not None and self.tls is not False:
                import ssl as _ssl

                kw["ssl"] = (
                    _ssl.create_default_context() if self.tls is True else self.tls
                )
            state.reader, state.writer = await asyncio.open_connection(
                self.host, self.port, **kw
            )
            try:
                # AUTH precedes every other command (server answers -NOAUTH
                # otherwise); two-arg form is Redis 6 ACL, one-arg classic
                # requirepass
                if self.password:
                    if self.username:
                        await self._call_on(
                            state, "AUTH", self.username, self.password
                        )
                    else:
                        await self._call_on(state, "AUTH", self.password)
                if self.db:
                    await self._call_on(state, "SELECT", self.db)
            except BaseException:
                # a half-initialized (unauthenticated) connection must not
                # stay cached: it would answer -NOAUTH forever with no
                # retry of the handshake
                writer, state.writer = state.writer, None
                with_suppress_close(writer)
                raise

    @staticmethod
    async def _call_on(state: "_ConnState", *parts) -> Any:
        reader, writer = state.reader, state.writer
        writer.write(_encode(parts))
        await writer.drain()
        return await _decode(reader)

    async def execute(self, *parts) -> Any:
        """One command over the wire, instrumented (hook.go:17-105)."""
        t0 = time.perf_counter()
        err: Exception | None = None
        state = self._conn_state()
        try:
            async with state.lock:
                await self._ensure(state)
                return await self._call_on(state, *parts)
        except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
            err = e
            state.writer = None  # force reconnect next call on this loop
            raise
        finally:
            dt = time.perf_counter() - t0
            if self.metrics is not None:
                self.metrics.record_histogram(
                    "app_redis_stats", dt, type=str(parts[0]).lower()
                )
            if self.logger is not None:
                self.logger.debug(
                    {
                        "type": "redis", "command": str(parts[0]),
                        "duration_us": round(dt * 1e6),
                        **({"error": str(err)} if err else {}),
                    }
                )

    # -- string ops -------------------------------------------------------
    async def get(self, key: str) -> bytes | None:
        return await self.execute("GET", key)

    async def set(self, key: str, value, ex: int | None = None) -> str:
        if ex is not None:
            return await self.execute("SET", key, value, "EX", ex)
        return await self.execute("SET", key, value)

    async def delete(self, *keys: str) -> int:
        return await self.execute("DEL", *keys)

    async def exists(self, *keys: str) -> int:
        return await self.execute("EXISTS", *keys)

    async def expire(self, key: str, seconds: int) -> int:
        return await self.execute("EXPIRE", key, seconds)

    async def ttl(self, key: str) -> int:
        return await self.execute("TTL", key)

    async def incr(self, key: str) -> int:
        return await self.execute("INCR", key)

    # -- hash / list ------------------------------------------------------
    async def hset(self, key: str, field: str, value) -> int:
        return await self.execute("HSET", key, field, value)

    async def hget(self, key: str, field: str) -> bytes | None:
        return await self.execute("HGET", key, field)

    async def hgetall(self, key: str) -> dict[bytes, bytes]:
        flat = await self.execute("HGETALL", key) or []
        return dict(zip(flat[::2], flat[1::2]))

    async def lpush(self, key: str, *values) -> int:
        return await self.execute("LPUSH", key, *values)

    async def rpop(self, key: str) -> bytes | None:
        return await self.execute("RPOP", key)

    async def keys(self, pattern: str = "*") -> list[bytes]:
        return await self.execute("KEYS", pattern) or []

    async def flushdb(self) -> str:
        return await self.execute("FLUSHDB")

    async def ping(self) -> str:
        return await self.execute("PING")

    async def info(self, section: str = "stats") -> str:
        raw = await self.execute("INFO", section)
        return raw.decode() if isinstance(raw, bytes) else str(raw)

    # -- health (health.go:13-50) -----------------------------------------
    async def health(self) -> dict:
        try:
            t0 = time.perf_counter()
            await self.ping()
            stats = await self.info("stats")
            parsed = dict(
                line.split(":", 1)
                for line in stats.splitlines()
                if ":" in line and not line.startswith("#")
            )
            return health(
                STATUS_UP,
                host=f"{self.host}:{self.port}",
                ping_ms=round((time.perf_counter() - t0) * 1e3, 3),
                stats={k: parsed[k] for k in list(parsed)[:8]},
            )
        except Exception as e:  # noqa: BLE001
            return health(STATUS_DOWN, host=f"{self.host}:{self.port}", error=str(e))

    def health_check(self) -> dict:
        """Sync facade for the container's aggregate health endpoint."""
        try:
            return asyncio.run(self.health())
        except RuntimeError:
            # already inside a loop: report connection state only
            with self._map_lock:
                up = any(
                    s.writer is not None and not s.writer.is_closing()
                    for s in self._states
                )
            return health(
                STATUS_UP if up else STATUS_DOWN, host=f"{self.host}:{self.port}"
            )

    def execute_sync(self, *parts, timeout: float = 10.0) -> Any:
        """Sync facade for CLI/cron/migration code (own private loop)."""
        return asyncio.run(asyncio.wait_for(self.execute(*parts), timeout))

    def close(self) -> None:
        with self._map_lock:
            states = list(self._states)
            self._states.clear()
        for s in states:
            # close() only; never null the attr — an in-flight command on the
            # loop thread must see is_closing() (caught ConnectionError path),
            # not a None writer (uncaught AttributeError).
            if s.writer is not None:
                try:
                    s.writer.close()
                except Exception:  # noqa: BLE001
                    pass


def new_client(config, logger=None, metrics=None) -> Redis | None:
    """Container wiring (container.go:98, redis.go:35-64)."""
    host = config.get("REDIS_HOST")
    if not host:
        return None
    port = config.get_int("REDIS_PORT", 6379)
    db = config.get_int("REDIS_DB", 0)
    if metrics is not None:
        from ...metrics import DATASOURCE_BUCKETS

        metrics.new_histogram("app_redis_stats", "redis op time s", DATASOURCE_BUCKETS)
    client = Redis(
        host, port, logger=logger, metrics=metrics, db=db,
        username=config.get("REDIS_USER") or None,
        password=config.get("REDIS_PASSWORD") or None,
        tls=tls_from_config(config, "REDIS"),
    )
    if logger is not None:
        logger.info(f"redis client configured for {host}:{port} (lazy connect)")
    return client
