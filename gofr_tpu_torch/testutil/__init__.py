"""Test helpers (counterpart of gofr_tpu/testutil/__init__.py): stdout and
stderr capture (``capture_stdout``, ``capture_stderr``), a self-signed
localhost certificate and the TLS contexts that serve and trust it
(``self_signed_cert``, ``server_tls_context``, ``client_tls_context``;
``cryptography`` is imported by ``self_signed_cert`` alone), and
``MiniRedis``, an in-process Redis server speaking the real RESP2 wire
protocol. The fake brokers are modules of their own: ``fakekafka``,
``fakemqtt`` and ``fakegooglepubsub`` (which needs grpcio). The card's
machine has no Redis server and no broker, and the port imports nothing of
the JAX package, hence its own copies."""

from __future__ import annotations

import asyncio
import contextlib
import fnmatch
import io
import ssl
import sys
import threading
import time
from typing import Iterator


@contextlib.contextmanager
def capture_stdout() -> Iterator[io.StringIO]:
    """Everything written to ``sys.stdout`` inside the block, in a buffer."""
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        yield buf
    finally:
        sys.stdout = old


@contextlib.contextmanager
def capture_stderr() -> Iterator[io.StringIO]:
    """Everything written to ``sys.stderr`` inside the block, in a buffer."""
    buf = io.StringIO()
    old = sys.stderr
    sys.stderr = buf
    try:
        yield buf
    finally:
        sys.stderr = old


_CERT_CACHE: tuple[str, str] | None = None


def self_signed_cert() -> tuple[str, str]:
    """A self-signed localhost certificate and its key, made once per
    process: (cert_pem_path, key_pem_path). The SANs cover localhost and
    127.0.0.1, so a verifying client context with cafile=cert_path passes
    full hostname checking."""
    global _CERT_CACHE
    if _CERT_CACHE is not None:
        return _CERT_CACHE
    import datetime
    import ipaddress
    import tempfile

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=1))
        .add_extension(
            x509.SubjectAlternativeName(
                [x509.DNSName("localhost"), x509.IPAddress(ipaddress.IPv4Address("127.0.0.1"))]
            ),
            critical=False,
        )
        .sign(key, hashes.SHA256())
    )
    d = tempfile.mkdtemp(prefix="gofr-tls-")
    cert_path, key_path = f"{d}/cert.pem", f"{d}/key.pem"
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(key_path, "wb") as f:
        f.write(key.private_bytes(serialization.Encoding.PEM, serialization.PrivateFormat.TraditionalOpenSSL,
                                  serialization.NoEncryption()))
    _CERT_CACHE = (cert_path, key_path)
    return _CERT_CACHE


def server_tls_context() -> ssl.SSLContext:
    """A server context serving the ``self_signed_cert()`` pair."""
    cert, key = self_signed_cert()
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    return ctx


def client_tls_context() -> ssl.SSLContext:
    """A verifying client context trusting only ``self_signed_cert()``."""
    cert, _ = self_signed_cert()
    return ssl.create_default_context(cafile=cert)


class MiniRedis:
    """In-process RESP2 server on an ephemeral port (asyncio, own thread).

    Supports the command set the framework's Redis client exposes: strings
    (GET/SET/DEL/EXISTS/EXPIRE/TTL/INCR), hashes (HSET/HGET/HGETALL), lists
    (LPUSH/RPOP), KEYS, FLUSHDB, PING, INFO, SELECT. ``password`` (and
    ``username``) make connections AUTH first; ``tls`` is a server-side
    ``ssl.SSLContext`` to serve TLS with.
    """

    def __init__(
        self,
        password: str | None = None,
        username: str | None = None,
        tls: ssl.SSLContext | None = None,
    ):
        self.data: dict[bytes, object] = {}
        self.expiry: dict[bytes, float] = {}
        # password set -> connections must AUTH first (requirepass / ACL
        # semantics), exercising the client's auth handshake paths
        self.password = password
        self.username = username
        self.tls = tls
        self.port: int | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server = None
        self._started = threading.Event()

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "MiniRedis":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("MiniRedis failed to start")
        return self

    def _run(self) -> None:
        async def main():
            self._server = await asyncio.start_server(
                self._client, "127.0.0.1", 0,
                ssl=self.tls or None,
            )
            self.port = self._server.sockets[0].getsockname()[1]
            self._loop = asyncio.get_running_loop()
            self._started.set()
            async with self._server:
                await self._server.serve_forever()

        with contextlib.suppress(asyncio.CancelledError):
            asyncio.run(main())

    def stop(self) -> None:
        if self._loop is not None:
            for task in asyncio.all_tasks(self._loop):
                self._loop.call_soon_threadsafe(task.cancel)
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- protocol ---------------------------------------------------------
    async def _client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        authed = self.password is None
        try:
            while True:
                line = (await reader.readline()).strip()
                if not line:
                    return
                assert line[:1] == b"*", line
                n = int(line[1:])
                parts = []
                for _ in range(n):
                    ln = (await reader.readline()).strip()
                    assert ln[:1] == b"$"
                    size = int(ln[1:])
                    parts.append((await reader.readexactly(size + 2))[:-2])
                if self.password is not None and parts[0].upper() == b"AUTH":
                    pw_ok = parts[-1].decode() == self.password
                    user_ok = len(parts) == 2 or parts[1].decode() == (
                        self.username or "default"
                    )
                    if pw_ok and user_ok:
                        authed = True
                        writer.write(self._simple("OK"))
                    else:
                        writer.write(b"-WRONGPASS invalid username-password pair\r\n")
                    await writer.drain()
                    continue
                if not authed:
                    writer.write(b"-NOAUTH Authentication required.\r\n")
                    await writer.drain()
                    continue
                writer.write(self._dispatch(parts))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, AssertionError):
            pass
        finally:
            with contextlib.suppress(Exception):
                writer.close()

    # -- encoding helpers -------------------------------------------------
    @staticmethod
    def _bulk(v: bytes | None) -> bytes:
        if v is None:
            return b"$-1\r\n"
        return b"$%d\r\n%s\r\n" % (len(v), v)

    @staticmethod
    def _int(v: int) -> bytes:
        return b":%d\r\n" % v

    @staticmethod
    def _simple(s: str) -> bytes:
        return b"+%s\r\n" % s.encode()

    @staticmethod
    def _err(s: str) -> bytes:
        return b"-ERR %s\r\n" % s.encode()

    @classmethod
    def _array(cls, items: list[bytes]) -> bytes:
        return b"*%d\r\n%s" % (len(items), b"".join(cls._bulk(i) for i in items))

    # -- command dispatch -------------------------------------------------
    def _alive(self, key: bytes) -> bool:
        exp = self.expiry.get(key)
        if exp is not None and exp <= time.time():
            self.data.pop(key, None)
            self.expiry.pop(key, None)
            return False
        return key in self.data

    def _dispatch(self, parts: list[bytes]) -> bytes:  # noqa: PLR0911, PLR0912
        cmd = parts[0].upper().decode()
        args = parts[1:]
        d = self.data
        if cmd == "PING":
            return self._simple("PONG")
        if cmd == "SELECT":
            return self._simple("OK")
        if cmd == "SET":
            d[args[0]] = args[1]
            self.expiry.pop(args[0], None)
            if len(args) >= 4 and args[2].upper() == b"EX":
                self.expiry[args[0]] = time.time() + int(args[3])
            return self._simple("OK")
        if cmd == "GET":
            v = d.get(args[0]) if self._alive(args[0]) else None
            return self._bulk(v if isinstance(v, (bytes, type(None))) else None)
        if cmd == "DEL":
            n = sum(1 for k in args if d.pop(k, None) is not None)
            return self._int(n)
        if cmd == "EXISTS":
            return self._int(sum(1 for k in args if self._alive(k)))
        if cmd == "EXPIRE":
            if args[0] in d:
                self.expiry[args[0]] = time.time() + int(args[1])
                return self._int(1)
            return self._int(0)
        if cmd == "TTL":
            if not self._alive(args[0]):
                return self._int(-2)
            exp = self.expiry.get(args[0])
            return self._int(-1 if exp is None else max(0, round(exp - time.time())))
        if cmd == "INCR":
            cur = int(d.get(args[0], b"0")) + 1
            d[args[0]] = str(cur).encode()
            return self._int(cur)
        if cmd == "HSET":
            h = d.setdefault(args[0], {})
            created = args[1] not in h
            h[args[1]] = args[2]
            return self._int(1 if created else 0)
        if cmd == "HGET":
            h = d.get(args[0]) or {}
            return self._bulk(h.get(args[1]) if isinstance(h, dict) else None)
        if cmd == "HGETALL":
            h = d.get(args[0]) or {}
            flat: list[bytes] = []
            if isinstance(h, dict):
                for k, v in h.items():
                    flat += [k, v]
            return self._array(flat)
        if cmd == "LPUSH":
            lst = d.setdefault(args[0], [])
            for v in args[1:]:
                lst.insert(0, v)
            return self._int(len(lst))
        if cmd == "RPOP":
            lst = d.get(args[0]) or []
            return self._bulk(lst.pop() if lst else None)
        if cmd == "KEYS":
            pat = args[0].decode()
            return self._array(
                [k for k in list(d) if self._alive(k) and fnmatch.fnmatch(k.decode(), pat)]
            )
        if cmd == "FLUSHDB":
            d.clear()
            self.expiry.clear()
            return self._simple("OK")
        if cmd == "INFO":
            body = (
                "# Stats\r\ntotal_connections_received:1\r\n"
                f"total_commands_processed:{len(d)}\r\n"
            )
            return self._bulk(body.encode())
        return self._err(f"unknown command '{cmd}'")
