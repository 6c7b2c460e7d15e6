"""Asyncio HTTP/1.1 server with keep-alive and chunked streaming responses
(counterpart of gofr_tpu/http/server.py ``AsyncHTTPServer``): the App's
server under ``GOFR_HTTP_NATIVE=0`` or when the native codec cannot be
built (``http/nativeserver.py`` is the default). ``tls`` (a server-side
``ssl.SSLContext``) serves HTTPS; ``reuse_port`` binds with SO_REUSEPORT
(the App's ``HTTP_WORKERS`` prefork).

One event loop; each request is a task awaiting its handler. Protocol
support: request line and headers (64 KiB cap), Content-Length and chunked
request bodies, keep-alive, HEAD, Expect: 100-continue, chunked streaming
responses (token streams) and Connection: close. A streaming response
checks the transport before every chunk; when the peer is gone it aborts
the connection and closes the producing generator, which is where a
token stream cancels its engine request (finish_reason "disconnect").
At shutdown an idle keep-alive connection closes at once and a busy one
after its response (the JAX server waits out the keep-alive idle timeout:
ROADMAP queue 3 item 37).
"""

from __future__ import annotations

import asyncio
from typing import Callable

from ..logging import Logger
from .request import Request
from .responder import Response

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 100 * 1024 * 1024  # matches the reference's 100MB zip cap spirit
READ_HEADER_TIMEOUT = 5.0  # httpServer.go:37


class HTTPProtocolError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _cl_value(digits: str) -> int:
    """Parse an all-digits Content-Length, clamped at MAX_BODY_BYTES+1 like
    the JAX package's native codec (every oversized value means the same
    thing: too large). The length pre-check keeps a multi-KB digit string from
    tripping CPython's int-conversion digit limit (uncaught ValueError)."""
    s = digits.lstrip("0")
    if len(s) > 15:
        return MAX_BODY_BYTES + 1
    return min(int(s or "0"), MAX_BODY_BYTES + 1)


def _clean_header(s: object) -> str:
    """Strip CR/LF/NUL so a handler echoing untrusted input into a response
    header cannot split the response (Go's net/http sanitizes these too)."""
    s = str(s)
    if "\r" in s or "\n" in s or "\x00" in s:
        return s.replace("\r", "").replace("\n", "").replace("\x00", "")
    return s


async def _read_headers(reader: asyncio.StreamReader) -> tuple[str, str, str, dict[str, str]] | None:
    """Read request line + headers. Returns None on clean EOF between requests."""
    try:
        block = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise HTTPProtocolError(400, "truncated request") from e
    except asyncio.LimitOverrunError as e:
        raise HTTPProtocolError(431, "headers too large") from e
    lines = block.decode("latin-1").split("\r\n")
    # a CR surviving the CRLF split is a bare CR (RFC 9112 2.2) — parsers
    # that treat it as a terminator would frame this head differently
    for line in lines:
        if "\r" in line:
            raise HTTPProtocolError(400, "bare CR in header")
    request_line = lines[0]
    parts = request_line.split(" ")
    if len(parts) != 3:
        raise HTTPProtocolError(400, "malformed request line")
    method, target, version = parts
    # the same bounds as the JAX package's server and its native codec:
    # non-empty method <= 31 chars, non-empty target, version
    # HTTP/1.<minor> with a minor digit
    if not method or len(method) > 31 or not target:
        raise HTTPProtocolError(400, "malformed request line")
    if not version.startswith("HTTP/1.") or len(version) < 8:
        raise HTTPProtocolError(505, "http version not supported")
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        # obs-fold (RFC 7230 3.2.4): a continuation line would otherwise
        # parse as a fresh header and desync against proxies that unfold
        if line[0] in " \t":
            raise HTTPProtocolError(400, "obsolete line folding")
        if ":" not in line:
            raise HTTPProtocolError(400, "malformed header")
        k, _, v = line.partition(":")
        k = k.strip()
        if not k:  # RFC 9112: field names are non-empty tokens
            raise HTTPProtocolError(400, "malformed header")
        k = k.lower()
        v = v.strip()
        # duplicate Content-Length with a different value is a smuggling
        # vector (proxies disagree on which wins) -> hard 400. Compare
        # PARSED values, clamped at the cap, mirroring the JAX package's native codec
        # ("5" vs "05" is not a conflict; two oversized values both mean
        # "too large" and 413 later).
        if k == "content-length":
            # digits only, validated per-line like the JAX package's native codec ('+5',
            # '5_0' etc. must not frame a body a strict peer rejects)
            if not (v.isascii() and v.isdigit()):
                raise HTTPProtocolError(400, "bad content-length")
            if k in headers and headers[k] != v:
                if _cl_value(headers[k]) != _cl_value(v):
                    raise HTTPProtocolError(400, "conflicting content-length")
        # the FINAL transfer coding must be chunked or the body length is
        # undefined (RFC 7230 3.3.3); checked per-line like the native
        # codec so a smuggled first line can't hide behind dict last-wins
        if k == "transfer-encoding":
            last = v.rsplit(",", 1)[-1].strip()
            if last.lower() != "chunked":
                raise HTTPProtocolError(400, "unsupported transfer-encoding")
        headers[k] = v
    # Transfer-Encoding and Content-Length together is the canonical
    # request-smuggling ambiguity -> reject
    if "transfer-encoding" in headers and "content-length" in headers:
        raise HTTPProtocolError(400, "content-length with transfer-encoding")
    return method.upper(), target, version, headers


async def _read_body(reader: asyncio.StreamReader, headers: dict[str, str]) -> bytes:
    te = headers.get("transfer-encoding", "").lower()
    if "chunked" in te:
        chunks: list[bytes] = []
        total = 0
        while True:
            size_line = await reader.readline()
            hexpart = size_line.strip().split(b";")[0]
            # strict hex only — int(x, 16) also accepts '0x10', '1_0' and
            # '-5' (negative would crash readexactly), none of which the
            # native codec or an RFC-strict peer frames the same way
            if not hexpart or any(
                c not in b"0123456789abcdefABCDEF" for c in hexpart
            ):
                raise HTTPProtocolError(400, "bad chunk size")
            size = int(hexpart, 16)
            if size == 0:
                # trailers until blank line
                while (await reader.readline()).strip():
                    pass
                break
            total += size
            if total > MAX_BODY_BYTES:
                raise HTTPProtocolError(413, "body too large")
            chunks.append(await reader.readexactly(size))
            await reader.readexactly(2)  # CRLF
        return b"".join(chunks)
    cl = headers.get("content-length")
    if cl is None:
        return b""
    if not (cl.isascii() and cl.isdigit()):
        raise HTTPProtocolError(400, "bad content-length")
    # clamped parse: a huge digit string means "too large" (413), and must
    # not trip CPython's int-conversion digit limit (as the JAX package's native codec)
    n = _cl_value(cl)
    if n > MAX_BODY_BYTES:
        raise HTTPProtocolError(413, "body too large")
    if n == 0:
        return b""
    try:
        return await reader.readexactly(n)
    except asyncio.IncompleteReadError as e:
        raise HTTPProtocolError(400, "truncated body") from e


_STATUS_TEXT = {
    200: "OK", 201: "Created", 204: "No Content", 301: "Moved Permanently", 302: "Found",
    400: "Bad Request", 401: "Unauthorized", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout", 413: "Payload Too Large",
    429: "Too Many Requests", 431: "Request Header Fields Too Large",
    500: "Internal Server Error", 503: "Service Unavailable", 505: "HTTP Version Not Supported",
}


def _status_line(status: int) -> bytes:
    return f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'Status')}\r\n".encode("latin-1")


class AsyncHTTPServer:
    def __init__(
        self,
        dispatch: Callable,
        port: int = 8000,
        host: str = "0.0.0.0",
        logger: Logger | None = None,
        tls=None,
    ):
        self.dispatch = dispatch  # async (Request) -> Response
        self.port = port
        self.host = host
        self.logger = logger
        self.tls = tls  # server-side ssl.SSLContext: HTTPS
        self.reuse_port = False  # HTTP_WORKERS prefork: every worker binds the port
        self._server: asyncio.AbstractServer | None = None
        # keep-alive connections waiting for their next request, and the
        # shutdown flag that stops a connection after its response
        self._idle: set[asyncio.StreamWriter] = set()
        self._closing = False

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, limit=MAX_HEADER_BYTES,
            reuse_port=self.reuse_port or None, ssl=self.tls,
        )
        self.port = self._server.sockets[0].getsockname()[1]
        if self.logger:
            scheme = "HTTPS" if self.tls is not None else "HTTP"
            self.logger.info(f"{scheme} server listening on :{self.port}")

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        assert self._server is not None
        await self._server.serve_forever()

    async def shutdown(self) -> None:
        """Stop listening and wait for the open connections: one in the
        middle of a response finishes it (a drain's streams run to their
        end) and then closes; an idle keep-alive connection closes now.
        Left open, a client's pooled connection (a front router's) would
        hold ``wait_closed`` for the 75 s keep-alive idle timeout."""
        if self._server is not None:
            self._server.close()
            self._closing = True
            for w in list(self._idle):
                w.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        remote = f"{peer[0]}:{peer[1]}" if isinstance(peer, tuple) else ""
        try:
            first_request = True
            while True:
                if not first_request:
                    if self._closing:
                        return
                    self._idle.add(writer)
                try:
                    timeout = READ_HEADER_TIMEOUT if first_request else 75.0  # keep-alive idle
                    head = await asyncio.wait_for(_read_headers(reader), timeout=timeout)
                except asyncio.TimeoutError:
                    return
                finally:
                    self._idle.discard(writer)
                if head is None:
                    return
                first_request = False
                method, target, version, headers = head
                if headers.get("expect", "").lower() == "100-continue":
                    writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                    await writer.drain()
                body = await _read_body(reader, headers)
                req = Request(method, target, headers, body, remote)
                try:
                    resp = await self.dispatch(req)
                except Exception as e:  # noqa: BLE001 - last-resort; middleware recovers first
                    if self.logger:
                        self.logger.error(f"unhandled dispatch error: {e!r}")
                    resp = Response(500, [("Content-Type", "application/json")], b'{"error":{"message":"internal error"}}')
                close = (
                    headers.get("connection", "").lower() == "close"
                    or version == "HTTP/1.0"
                )
                await self._write_response(writer, resp, method, close)
                if close:
                    return
        except HTTPProtocolError as e:
            try:
                body = ('{"error":{"message":"' + e.message + '"}}').encode()
                writer.write(
                    _status_line(e.status)
                    + b"Content-Type: application/json\r\nConnection: close\r\n"
                    + f"Content-Length: {len(body)}\r\n\r\n".encode()
                    + body
                )
                await writer.drain()
            except (ConnectionError, RuntimeError):
                pass
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    async def _write_response(
        self, writer: asyncio.StreamWriter, resp: Response, method: str, close: bool
    ) -> None:
        head = [_status_line(resp.status)]
        # 'seen' must reflect the names as EMITTED (post-sanitization) or a
        # CR/LF-bearing name could coexist with the auto-added framing line
        seen = set()
        for k, v in resp.headers:
            ck = _clean_header(k)
            seen.add(ck.lower())
            head.append(f"{ck}: {_clean_header(v)}\r\n".encode("latin-1"))
        if close:
            head.append(b"Connection: close\r\n")
        if resp.stream is not None and method != "HEAD":
            if "transfer-encoding" not in seen:
                head.append(b"Transfer-Encoding: chunked\r\n")
            head.append(b"\r\n")
            try:
                # header write INSIDE the try: a client gone before the
                # first byte must still run the except path below, which
                # closes the producing generator — an un-started
                # generator's finally never runs, so dropping it here
                # would leak the producer (and whatever it holds: an
                # engine slot, a proxy's upstream socket)
                writer.write(b"".join(head))
                await writer.drain()
                async for chunk in resp.stream:
                    if not chunk:
                        continue
                    # a peer that hung up surfaces as connection_lost on
                    # the transport before the next write fails — check
                    # it per chunk so a dead client is detected at the
                    # next produced token, not at stream end
                    if writer.transport.is_closing():
                        raise ConnectionError("client disconnected")
                    writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                    await writer.drain()
            except Exception as e:  # noqa: BLE001
                # Mid-stream failure: do NOT write the chunked terminator —
                # abort the connection so the client sees truncation instead
                # of a syntactically-complete (but silently short) response.
                # CLOSE the producing generator before raising: its finally/
                # GeneratorExit path is where a streaming LLM handler
                # cancels the GenRequest (slot freed, load credited,
                # finish_reason "disconnect") — leaving it to the GC would
                # let an abandoned request decode to completion first.
                if self.logger:
                    self.logger.error(f"stream aborted: {e!r}")
                writer.transport.abort()
                aclose = getattr(resp.stream, "aclose", None)
                if aclose is not None:
                    try:
                        await aclose()
                    except Exception:  # noqa: BLE001 — teardown must not mask the abort
                        pass
                raise ConnectionError("stream aborted") from e
            writer.write(b"0\r\n\r\n")
            await writer.drain()
            return
        body = b"" if method == "HEAD" else resp.body
        if "content-length" not in seen:
            head.append(f"Content-Length: {len(resp.body)}\r\n".encode())
        head.append(b"\r\n")
        writer.write(b"".join(head) + body)
        await writer.drain()
