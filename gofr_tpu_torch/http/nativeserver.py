"""Protocol-mode HTTP/1.1 server over the native C++ wire codec
(counterpart of gofr_tpu/http/nativeserver.py ``NativeHTTPServer``), the
App's default server (``GOFR_HTTP_NATIVE=0`` picks ``AsyncHTTPServer``).

The same observable behaviour as ``http/server.py``: keep-alive, chunked
request bodies, Expect: 100-continue, HEAD, chunked streaming responses,
the 5 s read-header timeout, the 64 KiB header cap, the 100 MB body cap,
the same error envelopes. Connections are ``asyncio.Protocol`` instances
that feed a byte buffer into the codec's ``parse`` (``native/httpcore.cc``)
and write each response head, serialized by ``build_head``, in one
``transport.write``. Dispatch, routing and middleware stay Python and are
shared with ``AsyncHTTPServer``; tests/test_torch_native_http.py runs one
conformance suite against both.

A streaming response checks the connection before every chunk; when the
peer is gone it closes the producing generator, which is where a token
stream cancels its engine request (finish_reason "disconnect"). At
shutdown an idle connection closes at once and a busy one after its
response, as ``AsyncHTTPServer``'s do (the JAX server waits out the 75 s
keep-alive idle timeout: ROADMAP queue 3 item 37).
"""

from __future__ import annotations

import asyncio
from typing import Callable

from ..logging import Logger
from ..native import load_http_codec
from .request import Request
from .responder import Response
from .server import _clean_header, _status_line  # shared with server.py

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 100 * 1024 * 1024  # server.py parity
READ_HEADER_TIMEOUT = 5.0  # httpServer.go:37
KEEPALIVE_IDLE_TIMEOUT = 75.0
# receive-side high-water mark: while a request is processing, a client
# streaming ahead (pipelining/flooding) is paused once this much is
# buffered — the streams server gets the same protection from asyncio
# flow control; without this the protocol server would buffer unbounded
RECV_HIGH_WATER = 256 * 1024

_ERR_HEAD = b"Content-Type: application/json\r\nConnection: close\r\n"


def _py_serialize(
    resp: Response, body: bytes, close: bool, chunked: bool = False
) -> bytes:
    """Tolerant fallback serializer with server.py's f-string semantics,
    used when the strict C serializer rejects exotic header values.
    chunked=True emits a streaming head (Transfer-Encoding, no body)."""
    head = [_status_line(resp.status)]
    seen = set()
    for k, v in resp.headers:
        ck = _clean_header(k)
        seen.add(ck.lower())
        head.append(f"{ck}: {_clean_header(v)}\r\n".encode("latin-1"))
    if close:
        head.append(b"Connection: close\r\n")
    if chunked:
        if "transfer-encoding" not in seen:
            head.append(b"Transfer-Encoding: chunked\r\n")
    elif "content-length" not in seen:
        head.append(f"Content-Length: {len(resp.body)}\r\n".encode())
    head.append(b"\r\n")
    return b"".join(head) + body


class _HTTPProtocol(asyncio.Protocol):
    """One connection: buffer -> native parse -> dispatch -> native head."""

    __slots__ = (
        "server", "codec", "transport", "buf", "head", "remote",
        "processing", "closed", "timer", "paused_reading", "can_write",
        "chunk_parts", "chunk_len", "_loop",
    )

    def __init__(self, server: "NativeHTTPServer"):
        self.server = server
        self.codec = server.codec
        self.transport: asyncio.Transport | None = None
        self.buf = bytearray()
        self.head = None  # parsed tuple awaiting its body
        self.remote = ""
        self.processing = False
        self.closed = False
        self.paused_reading = False
        self.chunk_parts: list[bytes] | None = None  # incremental chunked body
        self.chunk_len = 0
        self.timer: asyncio.TimerHandle | None = None
        self.can_write: asyncio.Event | None = None  # created lazily (streams)
        self._loop = server._loop

    # ---- transport callbacks -------------------------------------------
    def connection_made(self, transport) -> None:
        self.transport = transport
        self.server._conns.add(self)
        peer = transport.get_extra_info("peername")
        self.remote = f"{peer[0]}:{peer[1]}" if isinstance(peer, tuple) else ""
        self._arm_timer(READ_HEADER_TIMEOUT)

    def connection_lost(self, exc) -> None:
        self.closed = True
        self.server._conns.discard(self)
        if self.timer is not None:
            self.timer.cancel()
            self.timer = None
        if self.can_write is not None:
            self.can_write.set()  # unblock a draining stream writer

    def pause_writing(self) -> None:
        if self.can_write is None:
            self.can_write = asyncio.Event()
        self.can_write.clear()

    def resume_writing(self) -> None:
        if self.can_write is not None:
            self.can_write.set()

    def data_received(self, data: bytes) -> None:
        self.buf += data
        if self.processing:
            if len(self.buf) > RECV_HIGH_WATER and not self.paused_reading:
                self.paused_reading = True
                self.transport.pause_reading()
            return
        self._pump()

    # ---- timers ---------------------------------------------------------
    def _arm_timer(self, timeout: float) -> None:
        if self.timer is not None:
            self.timer.cancel()
        self.timer = self._loop.call_later(timeout, self._on_timeout)

    def _on_timeout(self) -> None:
        self.timer = None
        if not self.processing and self.transport is not None:
            self.transport.close()

    # ---- request assembly ----------------------------------------------
    def _pump(self) -> None:
        """Parse as many complete requests as the buffer holds (one at a
        time — the next parse happens after the current response)."""
        if self.closed or self.transport is None:
            return
        try:
            if self.head is None:
                parsed = self.codec.parse(self.buf)
                if parsed is None:
                    if len(self.buf) > MAX_HEADER_BYTES:
                        self._protocol_error(431, "headers too large")
                    return
                if parsed[0] > MAX_HEADER_BYTES:
                    self._protocol_error(431, "headers too large")
                    return
                self.head = parsed
                # header block complete: body reads are not timed (streams
                # server parity — its wait_for wraps _read_headers only)
                if self.timer is not None:
                    self.timer.cancel()
                    self.timer = None
                if parsed[6] & self.codec.F_CHUNKED:
                    self.chunk_parts = []
                    self.chunk_len = 0
                if parsed[6] & self.codec.F_EXPECT_CONTINUE:
                    self.transport.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            end, method, target, minor, headers, clen, flags = self.head
            if flags & self.codec.F_CHUNKED:
                # incremental: consume complete chunks NOW and drop their
                # encoded bytes from the buffer, so a large upload arriving
                # in many segments is parsed once (O(n)), not re-scanned
                # from scratch per data_received
                data, new_off, done = self.codec.parse_chunked_step(self.buf, end)
                if data:
                    self.chunk_parts.append(data)
                    self.chunk_len += len(data)
                    if self.chunk_len > MAX_BODY_BYTES:
                        raise ValueError(413, "body too large")
                if new_off > end:
                    del self.buf[end:new_off]
                if not done:
                    return
                body = b"".join(self.chunk_parts)
                self.chunk_parts = None
                consumed = end
            elif clen > 0:
                if len(self.buf) - end < clen:
                    return
                body = bytes(self.buf[end : end + clen])
                consumed = end + clen
            else:
                body = b""
                consumed = end
        except ValueError as e:
            if len(e.args) == 2 and isinstance(e.args[0], int):
                status, msg = e.args
            else:
                status, msg = 400, "bad request"
            self._protocol_error(status, msg)
            return

        del self.buf[:consumed]
        self.head = None
        # server.py parity: HTTP/1.0 always closes (even with an explicit
        # keep-alive header — the pure-Python server ignores it too)
        close = bool(flags & self.codec.F_CLOSE) or minor == 0
        req = Request(method, target, headers, body, self.remote)
        self.processing = True
        self._loop.create_task(self._respond(req, method, close))

    def _protocol_error(self, status: int, msg: str) -> None:
        if self.transport is None:
            return
        body = ('{"error":{"message":"' + msg + '"}}').encode()
        self.transport.write(
            _status_line(status)
            + _ERR_HEAD
            + f"Content-Length: {len(body)}\r\n\r\n".encode()
            + body
        )
        self.transport.close()
        self.closed = True

    # ---- response -------------------------------------------------------
    async def _respond(self, req: Request, method: str, close: bool) -> None:
        try:
            try:
                resp = await self.server.dispatch(req)
            except Exception as e:  # noqa: BLE001 - middleware recovers first
                if self.server.logger:
                    self.server.logger.error(f"unhandled dispatch error: {e!r}")
                resp = Response(
                    500,
                    [("Content-Type", "application/json")],
                    b'{"error":{"message":"internal error"}}',
                )
            if self.closed or self.transport is None:
                # client vanished while the handler ran: the response is
                # undeliverable, but a streamed body still owns resources
                # (engine slot, a proxy's in-flight permit + upstream
                # socket) — close the producer instead of dropping it
                await self._aclose_stream(resp)
                return
            try:
                if resp.stream is not None and method != "HEAD":
                    ok = await self._write_stream(resp, close)
                    if not ok:
                        return
                else:
                    body = b"" if method == "HEAD" else resp.body
                    try:
                        # HEAD advertises the real entity length (server.py
                        # parity)
                        out = self.codec.build_head(
                            resp.status, resp.headers, len(resp.body),
                            1 if close else 0, 0,
                            body if body else None,
                        )
                    except Exception:
                        # the C serializer is strict (2-tuples of str); the
                        # streams server stringifies anything — match it so
                        # the same handler works under either server
                        out = _py_serialize(resp, body, close)
                    self.transport.write(out)
                    # drain: a pipelining client that reads slowly must not
                    # grow the transport buffer unbounded (server.py awaits
                    # writer.drain() after every response)
                    if self.can_write is not None and not self.can_write.is_set():
                        await self.can_write.wait()
                        if self.closed:
                            return
            except Exception as e:  # noqa: BLE001 - never leave a hung conn
                if self.server.logger:
                    self.server.logger.error(f"response write failed: {e!r}")
                if self.transport is not None:
                    self.transport.abort()
                self.closed = True
                return
            if close or self.server._closing:
                # a shutdown in progress closes the connection after its
                # response instead of keeping it alive for another
                self.transport.close()
                self.closed = True
                return
        finally:
            self.processing = False
            if self.paused_reading and self.transport is not None and not self.closed:
                self.paused_reading = False
                self.transport.resume_reading()
        self._arm_timer(KEEPALIVE_IDLE_TIMEOUT)
        if self.buf:
            self._pump()  # pipelined request already buffered

    async def _write_stream(self, resp: Response, close: bool) -> bool:
        """Chunked streaming response with transport flow control.
        Returns False when the connection is dead (caller stops serving)."""
        assert self.transport is not None
        try:
            head = self.codec.build_head(
                resp.status, resp.headers, -1, 1 if close else 0, 1
            )
        except Exception:
            # strict C serializer rejected a header (exotic type or CR/LF
            # taint) — sanitize and serialize in Python like the non-stream
            # fallback, so both servers serve the stream instead of aborting
            head = _py_serialize(resp, b"", close, chunked=True)
        self.transport.write(head)
        try:
            async for chunk in resp.stream:
                if not chunk:
                    continue
                if self.closed:
                    # peer hung up (connection_lost): close the producer
                    # NOW — its GeneratorExit path is where a streaming
                    # LLM handler cancels the GenRequest (slot freed,
                    # finish_reason "disconnect") instead of decoding to
                    # completion for a dead connection
                    await self._aclose_stream(resp)
                    return False
                self.transport.write(
                    f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n"
                )
                if self.can_write is not None and not self.can_write.is_set():
                    await self.can_write.wait()
                    if self.closed:
                        await self._aclose_stream(resp)
                        return False
        except Exception as e:  # noqa: BLE001
            # Mid-stream failure: abort WITHOUT the chunked terminator so the
            # client sees truncation, not a silently-short success (server.py
            # semantics).
            if self.server.logger:
                self.server.logger.error(f"stream aborted: {e!r}")
            self.transport.abort()
            self.closed = True
            await self._aclose_stream(resp)
            return False
        self.transport.write(b"0\r\n\r\n")
        return True

    @staticmethod
    async def _aclose_stream(resp: Response) -> None:
        """Close an abandoned body generator so handler-side cleanup
        (GenRequest disconnect-cancel) runs immediately, not at GC."""
        aclose = getattr(resp.stream, "aclose", None)
        if aclose is not None:
            try:
                await aclose()
            except Exception:  # noqa: BLE001 — teardown must not mask the abort
                pass


class NativeHTTPServer:
    """Drop-in alternative to AsyncHTTPServer backed by the C++ codec.

    Construction requires the codec: callers use ``available()`` (or let
    the App decide) and fall back to AsyncHTTPServer otherwise.
    """

    def __init__(
        self,
        dispatch: Callable,
        port: int = 8000,
        host: str = "0.0.0.0",
        logger: Logger | None = None,
        tls=None,
    ):
        codec = load_http_codec()
        if codec is None:
            raise RuntimeError("native HTTP codec unavailable")
        self.codec = codec
        self.dispatch = dispatch  # async (Request) -> Response
        self.port = port
        self.host = host
        self.logger = logger
        self.reuse_port = False
        self.tls = tls  # server-side ssl.SSLContext (HTTPS); see server.py
        self._server: asyncio.AbstractServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        # the open connections, and the shutdown flag that closes a busy
        # one after its response
        self._conns: set[_HTTPProtocol] = set()
        self._closing = False

    @staticmethod
    def available() -> bool:
        return load_http_codec() is not None

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._server = await self._loop.create_server(
            lambda: _HTTPProtocol(self),
            self.host,
            self.port,
            reuse_port=self.reuse_port or None,
            ssl=self.tls,
        )
        self.port = self._server.sockets[0].getsockname()[1]
        if self.logger:
            scheme = "HTTPS" if self.tls is not None else "HTTP"
            self.logger.info(
                f"{scheme} server (native codec) listening on :{self.port}"
            )

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        assert self._server is not None
        await self._server.serve_forever()

    async def shutdown(self) -> None:
        """Stop listening and wait for the open connections: one in the
        middle of a response finishes it (a drain's streams run to their
        end) and then closes; an idle one (keep-alive, or no request yet)
        closes now. Left open, a client's pooled connection (a front
        router's) would hold ``wait_closed`` for the 75 s keep-alive idle
        timeout."""
        if self._server is not None:
            self._server.close()
            self._closing = True
            for proto in list(self._conns):
                if not proto.processing and proto.transport is not None:
                    proto.closed = True
                    proto.transport.close()
            await self._server.wait_closed()
            self._server = None
