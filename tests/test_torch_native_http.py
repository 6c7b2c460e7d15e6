"""The port's HTTP servers against each other and against the JAX package
(CPU). The conformance suite of tests/test_native_http.py runs against
both of the port's servers (``AsyncHTTPServer`` and the native-codec
``NativeHTTPServer``) through one raw-socket client; the wire bytes of a
set of requests, protocol errors included, equal those of the JAX
package's server of the same kind; the port's codec (``_gofr_torch_http``,
built here with g++) equals JAX's ``_gofr_http`` on seeded fuzz for
``parse``, ``parse_chunked_step`` and ``build_head``. Then the App's
server choice (native by default, ``GOFR_HTTP_NATIVE=0``, the fallback
when the codec cannot be built), a shutdown with an idle keep-alive
connection (ROADMAP queue 3 item 37) and with a busy one, and a client
that hangs up mid-SSE on a tiny engine, each on both servers."""

from __future__ import annotations

import asyncio
import contextlib
import functools
import json
import random
import socket
import threading
import time

import pytest

from gofr_tpu.http.nativeserver import NativeHTTPServer as JNativeHTTPServer
from gofr_tpu.http.responder import Response as JResponse
from gofr_tpu.http.server import AsyncHTTPServer as JAsyncHTTPServer
from gofr_tpu.native import load_http_codec as jax_load_http_codec
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.http.nativeserver import NativeHTTPServer
from gofr_tpu_torch.http.responder import Response
from gofr_tpu_torch.http.server import AsyncHTTPServer
from gofr_tpu_torch.native import build_error, load_http_codec

codec = load_http_codec()
jcodec = jax_load_http_codec()
SERVERS = {"python": AsyncHTTPServer, "native": NativeHTTPServer}
JAX_SERVERS = {"python": JAsyncHTTPServer, "native": JNativeHTTPServer}


def async_test(fn):
    """Run an async test to completion (no pytest-asyncio here)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        asyncio.run(fn(*args, **kwargs))

    return wrapper


def _echo(response_cls):
    """A dispatch that mirrors the request back, built on one package's
    Response (the same routes as tests/test_native_http.py's)."""

    async def dispatch(req):
        if req.path == "/stream":
            async def gen():
                for part in (b"alpha", b"", b"beta"):
                    yield part
            return response_cls(200, [("Content-Type", "text/plain")], stream=gen())
        if req.path == "/boom-stream":
            async def gen():
                yield b"partial"
                raise RuntimeError("mid-stream failure")
            return response_cls(200, [], stream=gen())
        if req.path == "/boom":
            raise RuntimeError("handler exploded")
        if req.path == "/echo-header":
            # reflects a request header into a response header; the taint
            # is added handler-side (the request parser rejects raw CR/LF)
            val = req.header("x-probe") or ""
            if "taint" in req.query:
                val += "\r\nSet-Cookie: pwn=1"
            return response_cls(200, [("X-Echo", val)], b"ok")
        if req.path == "/evil-stream":
            async def gen():
                yield b"alpha"
                yield b"beta"
            return response_cls(200, [("X-Echo", "a\r\nSet-Cookie: pwn=1")], stream=gen())
        if req.path == "/exotic":
            return response_cls(200, [["X-List", 7]], b"ok")
        payload = {
            "method": req.method,
            "path": req.path,
            "query": {k: v[0] for k, v in req.query.items()},
            "body": req.body.decode("latin-1"),
            "hdr": req.header("x-probe") or "",
        }
        return response_cls(200, [("Content-Type", "application/json")], json.dumps(payload).encode())

    return dispatch


echo_dispatch = _echo(Response)


def test_codec_builds_and_loads_beside_jax():
    """The port's extension builds from its own source and loads in the
    same process as the JAX package's: two module names."""
    assert codec is not None, build_error()
    assert jcodec is not None
    assert codec.__name__ == "_gofr_torch_http" and jcodec.__name__ == "_gofr_http"
    assert codec is not jcodec and codec.__file__ != jcodec.__file__
    assert "gofr_tpu_torch" in codec.__file__
    assert (codec.F_CHUNKED, codec.F_CLOSE, codec.F_EXPECT_CONTINUE, codec.F_KEEPALIVE) == (
        jcodec.F_CHUNKED, jcodec.F_CLOSE, jcodec.F_EXPECT_CONTINUE, jcodec.F_KEEPALIVE)


@pytest.fixture(params=sorted(SERVERS))
def server_cls(request):
    return SERVERS[request.param]


@contextlib.asynccontextmanager
async def serving(server_cls, dispatch=echo_dispatch):
    """Start a server; yield (srv, connect). Connections opened through
    ``connect`` are aborted before the shutdown, so a test that fails
    mid-connection cannot hold it."""
    srv = server_cls(dispatch, port=0, host="127.0.0.1")
    await srv.start()
    writers: list[asyncio.StreamWriter] = []

    async def connect():
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        writers.append(writer)
        return reader, writer

    try:
        yield srv, connect
    finally:
        for w in writers:
            with contextlib.suppress(Exception):
                w.transport.abort()
        await asyncio.wait_for(srv.shutdown(), timeout=10)


async def _talk(connect, payload: bytes) -> bytes:
    reader, writer = await connect()
    writer.write(payload)
    await writer.drain()
    return await asyncio.wait_for(reader.read(), timeout=5)


async def _read_response(reader) -> tuple[int, dict, bytes]:
    head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout=5)
    lines = head.decode().split("\r\n")
    status = int(lines[0].split(" ")[1])
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
    if "content-length" in headers:
        body = await reader.readexactly(int(headers["content-length"]))
    elif headers.get("transfer-encoding") == "chunked":
        body = b""
        while True:
            size = int((await reader.readline()).strip(), 16)
            if size == 0:
                await reader.readline()
                break
            body += await reader.readexactly(size)
            await reader.readline()
    else:
        body = b""
    return status, headers, body


# ---------------------------------------------------------------------------
# the conformance suite, on both of the port's servers
# ---------------------------------------------------------------------------

@async_test
async def test_get_roundtrip_and_keepalive(server_cls):
    async with serving(server_cls) as (srv, connect):
        reader, writer = await connect()
        for i in range(3):  # one connection, three requests
            writer.write(f"GET /echo?i={i} HTTP/1.1\r\nHost: t\r\nX-Probe: v{i}\r\n\r\n".encode())
            await writer.drain()
            status, _headers, body = await _read_response(reader)
            assert status == 200
            got = json.loads(body)
            assert (got["method"], got["path"], got["query"], got["hdr"]) == ("GET", "/echo", {"i": str(i)}, f"v{i}")


@async_test
async def test_post_body_and_pipelining(server_cls):
    async with serving(server_cls) as (srv, connect):
        reader, writer = await connect()
        writer.write(
            b"POST /a HTTP/1.1\r\nHost: t\r\nContent-Length: 5\r\n\r\nhello"
            b"POST /b HTTP/1.1\r\nHost: t\r\nContent-Length: 5\r\n\r\nworld"
        )
        await writer.drain()
        s1, _, b1 = await _read_response(reader)
        s2, _, b2 = await _read_response(reader)
        assert (s1, s2) == (200, 200)
        assert (json.loads(b1)["body"], json.loads(b2)["body"]) == ("hello", "world")


@async_test
async def test_chunked_request_body(server_cls):
    async with serving(server_cls) as (srv, connect):
        reader, writer = await connect()
        writer.write(b"POST /c HTTP/1.1\r\nHost: t\r\nTransfer-Encoding: chunked\r\n\r\n"
                     b"4\r\nwiki\r\n5;ext=1\r\npedia\r\n0\r\nTrailer: x\r\n\r\n")
        await writer.drain()
        status, _, body = await _read_response(reader)
        assert status == 200 and json.loads(body)["body"] == "wikipedia"


@async_test
async def test_expect_100_continue(server_cls):
    async with serving(server_cls) as (srv, connect):
        reader, writer = await connect()
        writer.write(b"POST /e HTTP/1.1\r\nHost: t\r\nContent-Length: 2\r\nExpect: 100-continue\r\n\r\n")
        await writer.drain()
        interim = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout=5)
        assert interim.startswith(b"HTTP/1.1 100")
        writer.write(b"ok")
        await writer.drain()
        status, _, body = await _read_response(reader)
        assert status == 200 and json.loads(body)["body"] == "ok"


@async_test
async def test_head_has_length_but_no_body(server_cls):
    async with serving(server_cls) as (srv, connect):
        data = await _talk(connect, b"HEAD /h HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n")
        head, _, rest = data.partition(b"\r\n\r\n")
        assert b"HTTP/1.1 200" in head and b"Content-Length:" in head
        assert rest == b""


@async_test
async def test_streaming_response(server_cls):
    async with serving(server_cls) as (srv, connect):
        reader, writer = await connect()
        writer.write(b"GET /stream HTTP/1.1\r\nHost: t\r\n\r\n")
        await writer.drain()
        status, headers, body = await _read_response(reader)
        assert status == 200 and headers.get("transfer-encoding") == "chunked" and body == b"alphabeta"


@async_test
async def test_stream_abort_truncates(server_cls):
    """A handler failing mid-stream leaves no chunked terminator: the
    client can tell the body is short."""
    async with serving(server_cls) as (srv, connect):
        data = await _talk(connect, b"GET /boom-stream HTTP/1.1\r\nHost: t\r\n\r\n")
        assert b"partial" in data and not data.endswith(b"0\r\n\r\n")


@async_test
async def test_unhandled_dispatch_error_returns_500(server_cls):
    async with serving(server_cls) as (srv, connect):
        data = await _talk(connect, b"GET /boom HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n")
        assert b"HTTP/1.1 500" in data and b"internal error" in data


PROTOCOL_ERRORS = [
    (b"BROKEN-LINE\r\n\r\n", b"400"),
    (b"GET /x SPDY/3\r\n\r\n", b"505"),
    (b"GET  HTTP/1.1\r\n\r\n", b"400"),  # empty target
    (b" / HTTP/1.1\r\n\r\n", b"400"),  # empty method
    (b"A" * 32 + b" / HTTP/1.1\r\n\r\n", b"400"),  # method too long
    (b"GET / HTTP/1.\r\n\r\n", b"505"),  # no minor digit
    (b"GET / HTTP/1.1\r\n : v\r\n\r\n", b"400"),  # empty header name
    (b"GET / HTTP/1.1\r\nBad-Header-Without-Colon\r\n\r\n", b"400"),
    (b"POST / HTTP/1.1\r\nContent-Length: nope\r\n\r\n", b"400"),
    (b"POST / HTTP/1.1\r\nContent-Length: 999999999999\r\n\r\n", b"413"),
    (b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\nzz\r\n", b"400"),
    # request smuggling: both parsers must reject
    (b"POST / HTTP/1.1\r\nContent-Length: 5\r\nContent-Length: 6\r\n\r\nhello", b"400"),
    (b"POST / HTTP/1.1\r\nContent-Length: 5\r\nTransfer-Encoding: chunked\r\n\r\n0\r\n\r\n", b"400"),
    (b"POST / HTTP/1.1\r\nTransfer-Encoding: gzip\r\n\r\n", b"400"),  # chunked not the final coding
    (b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked, gzip\r\n\r\n", b"400"),
    (b"GET / HTTP/1.1\r\nHost: t\r\n folded-continuation\r\n\r\n", b"400"),  # obs-fold
    (b"GET / HTTP/1.1\r\nA: v\rX-Smuggle: x\r\n\r\n", b"400"),  # a bare CR ends no line
    (b"POST / HTTP/1.1\r\nContent-Length: +5\r\n\r\nhello", b"400"),  # digits only
    (b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n-5\r\n\r\n", b"400"),  # negative chunk size
    (b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n0x10\r\n\r\n", b"400"),  # 0x prefix
    (b"POST / HTTP/1.1\r\nContent-Length: " + b"9" * 4400 + b"\r\n\r\n", b"413"),  # past int's digit limit
    (b"POST / HTTP/1.1\r\nContent-Length: " + b"9" * 4400 + b"\r\nContent-Length: " + b"8" * 4400
     + b"\r\n\r\n", b"413"),  # two oversized values both mean too large
]


@pytest.mark.parametrize("raw,expect_status", PROTOCOL_ERRORS)
@async_test
async def test_protocol_errors(server_cls, raw, expect_status):
    async with serving(server_cls) as (srv, connect):
        data = await _talk(connect, raw)
        assert data.split(b" ")[1].startswith(expect_status), data[:100]


@async_test
async def test_response_splitting_neutralized(server_cls):
    """A handler echoing CR/LF into a response header cannot make a second
    response head."""
    async with serving(server_cls) as (srv, connect):
        data = await _talk(connect, b"GET /echo-header HTTP/1.1\r\nHost: t\r\n"
                                    b"X-Probe: clean-value\r\nConnection: close\r\n\r\n")
        assert b"X-Echo: clean-value" in data
        data = await _talk(connect, b"GET /echo-header?taint=1 HTTP/1.1\r\nHost: t\r\n"
                                    b"X-Probe: evil\r\nConnection: close\r\n\r\n")
        assert data.startswith(b"HTTP/1.1 200")
        head_lines = data.split(b"\r\n\r\n")[0].split(b"\r\n")
        assert not any(ln.startswith(b"Set-Cookie:") for ln in head_lines)
        assert sum(ln.startswith(b"Content-Length:") for ln in head_lines) == 1

    # a CR/LF-bearing header NAME must not yield a second Content-Length line
    from gofr_tpu_torch.http.nativeserver import _py_serialize

    resp = Response(200, [("Content-Length\n", "999")], b"ok")
    head_lines = _py_serialize(resp, resp.body, False).split(b"\r\n\r\n")[0].split(b"\r\n")
    assert [ln for ln in head_lines if ln.lower().startswith(b"content-length:")] == [b"Content-Length: 999"]


@async_test
async def test_response_splitting_streaming_path(server_cls):
    """Tainted headers on a streaming response are sanitized and the
    stream served, not the connection aborted."""
    async with serving(server_cls) as (srv, connect):
        data = await _talk(connect, b"GET /evil-stream HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n")
        assert data.startswith(b"HTTP/1.1 200")
        head = data.split(b"\r\n\r\n")[0]
        assert not any(ln.startswith(b"Set-Cookie:") for ln in head.split(b"\r\n"))
        assert b"Transfer-Encoding: chunked" in head
        assert b"alpha" in data and b"beta" in data and data.endswith(b"0\r\n\r\n")


@async_test
async def test_header_cap_431(server_cls):
    async with serving(server_cls) as (srv, connect):
        big = b"GET / HTTP/1.1\r\nHost: t\r\nX-Fill: " + b"a" * (70 * 1024) + b"\r\n\r\n"
        assert b"431" in (await _talk(connect, big)).split(b"\r\n")[0]


@async_test
async def test_http10_closes_connection(server_cls):
    async with serving(server_cls) as (srv, connect):
        # read() returns because the server closed the connection
        assert b"HTTP/1.1 200" in await _talk(connect, b"GET /x HTTP/1.0\r\nHost: t\r\n\r\n")


@pytest.mark.parametrize("raw", [
    b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n10000000\r\n",  # one huge chunk
    b"POST / HTTP/1.1\r\nContent-Length: 268435456\r\n\r\n",
])
@async_test
async def test_oversized_body_is_413(server_cls, raw):
    async with serving(server_cls) as (srv, connect):
        data = await _talk(connect, raw)
        assert data.split(b" ")[1] == b"413", data[:80]


@async_test
async def test_exotic_header_types_match_python_server(server_cls):
    """List headers and non-str values serve alike under both servers (the
    native one falls back to the tolerant serializer)."""
    async with serving(server_cls) as (srv, connect):
        data = await _talk(connect, b"GET /exotic HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n")
        assert b"200" in data.split(b"\r\n")[0] and b"X-List: 7" in data and data.endswith(b"ok")


@async_test
async def test_large_chunked_upload_incremental(server_cls):
    """A 1 MiB chunked body in many small writes (the native server
    consumes chunks as they complete)."""
    payload = bytes(range(256)) * 4096
    chunks = [payload[i: i + 8192] for i in range(0, len(payload), 8192)]
    wire = b"".join(f"{len(c):x}\r\n".encode() + c + b"\r\n" for c in chunks) + b"0\r\n\r\n"
    async with serving(server_cls) as (srv, connect):
        reader, writer = await connect()
        writer.write(b"POST /big HTTP/1.1\r\nHost: t\r\nTransfer-Encoding: chunked\r\n\r\n")
        for i in range(0, len(wire), 16384):
            writer.write(wire[i: i + 16384])
            await writer.drain()
        status, _, body = await _read_response(reader)
        assert status == 200 and json.loads(body)["body"] == payload.decode("latin-1")


# ---------------------------------------------------------------------------
# the wire against the JAX package's server of the same kind
# ---------------------------------------------------------------------------

WIRE = [
    b"GET /echo?i=1 HTTP/1.1\r\nHost: t\r\nX-Probe: v\r\nConnection: close\r\n\r\n",
    b"POST /a HTTP/1.1\r\nHost: t\r\nContent-Length: 5\r\n\r\nhello"
    b"POST /b HTTP/1.1\r\nHost: t\r\nContent-Length: 5\r\nConnection: close\r\n\r\nworld",
    b"POST /c HTTP/1.1\r\nHost: t\r\nTransfer-Encoding: chunked\r\nConnection: close\r\n\r\n"
    b"4\r\nwiki\r\n5;ext=1\r\npedia\r\n0\r\nTrailer: x\r\n\r\n",
    b"POST /e HTTP/1.1\r\nHost: t\r\nContent-Length: 2\r\nExpect: 100-continue\r\nConnection: close\r\n\r\nok",
    b"HEAD /h HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n",
    b"GET /stream HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n",
    b"GET /boom HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n",
    b"GET /echo-header?taint=1 HTTP/1.1\r\nHost: t\r\nX-Probe: evil\r\nConnection: close\r\n\r\n",
    b"GET /evil-stream HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n",
    b"GET /exotic HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n",
    b"GET /x HTTP/1.0\r\nHost: t\r\n\r\n",
] + [raw for raw, _ in PROTOCOL_ERRORS]


async def _wire(server_cls, dispatch, raw: bytes) -> bytes:
    srv = server_cls(dispatch, port=0, host="127.0.0.1")
    await srv.start()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        try:
            writer.write(raw)
            await writer.drain()
            return await asyncio.wait_for(reader.read(), timeout=5)
        finally:
            writer.transport.abort()
    finally:
        await asyncio.wait_for(srv.shutdown(), timeout=10)


@pytest.mark.parametrize("kind", sorted(SERVERS))
@pytest.mark.parametrize("i", range(len(WIRE)))
@async_test
async def test_wire_bytes_equal_jax(kind, i):
    """Every byte the port's server writes for the request equals what the
    JAX package's server of the same kind writes."""
    port = await _wire(SERVERS[kind], _echo(Response), WIRE[i])
    jax = await _wire(JAX_SERVERS[kind], _echo(JResponse), WIRE[i])
    assert port == jax and port


# ---------------------------------------------------------------------------
# the codec: its own cases, and against JAX's on seeded fuzz
# ---------------------------------------------------------------------------

def test_codec_smuggling_rejections():
    r = codec.parse(b"POST / HTTP/1.1\r\nContent-Length: 5\r\nContent-Length: 5\r\n\r\n")
    assert r is not None and r[5] == 5  # a repeated equal Content-Length stays accepted
    r = codec.parse(b"POST / HTTP/1.1\r\nTransfer-Encoding: gzip, chunked\r\n\r\n")
    assert r is not None and r[6] & codec.F_CHUNKED
    for raw in (b"POST / HTTP/1.1\r\nContent-Length: 5\r\nContent-Length: 6\r\n\r\n",
                b"POST / HTTP/1.1\r\nContent-Length: 5\r\nTransfer-Encoding: chunked\r\n\r\n",
                b"POST / HTTP/1.1\r\nTransfer-Encoding: identity\r\n\r\n"):
        with pytest.raises(ValueError) as ei:
            codec.parse(raw)
        assert ei.value.args[0] == 400
    for bad in ("a\rb", "a\nb", "a\x00b"):  # build_head rejects CR/LF/NUL
        with pytest.raises(ValueError):
            codec.build_head(200, [("X-H", bad)], -1, 0, 0)
        with pytest.raises(ValueError):
            codec.build_head(200, [(bad, "v")], -1, 0, 0)


def test_codec_chunked_step_enforces_body_cap():
    chunk = b"3c00000\r\n" + b"a" * 0x3C00000 + b"\r\n"  # 60 MiB twice: past the 100 MB cap
    with pytest.raises(ValueError) as ei:
        codec.parse_chunked_step(chunk * 2, 0)
    assert ei.value.args[0] == 413


def test_codec_parse_basic():
    end, method, target, minor, headers, clen, flags = codec.parse(
        b"PoSt /p%20q?a=1 HTTP/1.1\r\nHost: h\r\nContent-Length: 7\r\nX-Mixed-CASE:  v  \r\n\r\nrest")
    assert (method, target, minor, headers["x-mixed-case"], clen, flags) == ("POST", "/p%20q?a=1", 1, "v", 7, 0)


def test_codec_parse_incomplete_and_offset():
    assert codec.parse(b"GET / HTTP/1.1\r\nHost: h\r\n") is None
    buf = b"JUNK" + b"GET /o HTTP/1.1\r\n\r\n"
    end, _method, target, *_ = codec.parse(buf, 4)
    assert (target, end) == ("/o", len(buf))


def test_codec_flags():
    *_, flags = codec.parse(b"POST / HTTP/1.1\r\nTransfer-Encoding: Chunked\r\n"
                            b"Connection: Close\r\nExpect: 100-Continue\r\n\r\n")
    assert flags & codec.F_CHUNKED and flags & codec.F_CLOSE and flags & codec.F_EXPECT_CONTINUE
    *_, kflags = codec.parse(b"GET / HTTP/1.0\r\nConnection: Keep-Alive\r\n\r\n")
    assert kflags & codec.F_KEEPALIVE


def test_codec_build_head_suppresses_duplicates():
    assert codec.build_head(200, [("Content-Length", "5")], 99, 0, 0).count(b"Content-Length") == 1
    assert codec.build_head(200, [("Transfer-Encoding", "chunked")], -1, 0, 1).count(b"Transfer-Encoding") == 1
    out = codec.build_head(204, [], -1, 1, 0)
    assert b"Connection: close" in out and b"204 No Content" in out


def test_codec_python_parser_parity_fuzz():
    """The codec and the port's pure-Python parser accept the same heads
    with the same results (seeded differential fuzz)."""
    from gofr_tpu_torch.http.server import _read_headers

    rnd = random.Random(0xC0DEC)
    methods = ["GET", "POST", "put", "DELETE", "OPTIONS"]
    targets = ["/", "/a/b?x=1&y=2", "/%E2%82%AC", "/" + "p" * 100]
    pool = [("Host", "example.com"), ("X-Empty", ""), ("Content-Length", "0"), ("Connection", "close"),
            ("Connection", "keep-alive"), ("Accept", "a, b;q=0.5"), ("X-Ws", "  padded  "), ("X-Colons", "a:b:c")]

    async def py_parse(raw):
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        return await _read_headers(reader)

    loop = asyncio.new_event_loop()
    try:
        for _ in range(200):
            raw = f"{rnd.choice(methods)} {rnd.choice(targets)} HTTP/1.1\r\n".encode()
            for k, v in rnd.sample(pool, rnd.randint(0, 5)):
                raw += f"{k}: {v}\r\n".encode()
            raw += b"\r\n"
            end, cm, ct, _minor, cheaders, _clen, _flags = codec.parse(raw)
            pm, pt, _pv, pheaders = loop.run_until_complete(py_parse(raw))
            assert (cm, ct, cheaders, end) == (pm, pt, pheaders, len(raw))
    finally:
        loop.close()


def test_codec_chunked_roundtrip_fuzz():
    rnd = random.Random(7)
    for _ in range(50):
        parts = [bytes(rnd.getrandbits(8) for _ in range(rnd.randint(1, 300))) for _ in range(rnd.randint(0, 8))]
        raw = b"".join(f"{len(p):x}\r\n".encode() + p + b"\r\n" for p in parts) + b"0\r\n\r\n"
        body, end = codec.parse_chunked(raw + b"NEXT")
        assert body == b"".join(parts) and end == len(raw)
        for cut in sorted(rnd.sample(range(len(raw)), min(10, len(raw)))):
            pre = codec.parse_chunked(raw[:cut])  # a strict prefix is incomplete, never an error
            assert pre is None or pre[1] <= cut


def test_codec_parse_chunked_step_incremental():
    parts = [b"abc", b"defgh", b"Z" * 100]
    wire = b"".join(f"{len(p):x}\r\n".encode() + p + b"\r\n" for p in parts) + b"0\r\nT: v\r\n\r\n"
    buf, out, done = bytearray(), [], 0
    for i in range(len(wire)):  # byte by byte, as the server consumes
        buf.append(wire[i])
        data, new_off, done = codec.parse_chunked_step(buf, 0)
        if data:
            out.append(data)
        del buf[:new_off]
        if done:
            assert i == len(wire) - 1
    assert done == 1 and b"".join(out) == b"".join(parts) and bytes(buf) == b""


def test_codec_parse_chunked_step_matches_oneshot():
    rnd = random.Random(11)
    for _ in range(30):
        parts = [bytes(rnd.getrandbits(8) for _ in range(rnd.randint(1, 200))) for _ in range(rnd.randint(1, 6))]
        wire = b"".join(f"{len(p):x}\r\n".encode() + p + b"\r\n" for p in parts) + b"0\r\n\r\n"
        body_ref, end_ref = codec.parse_chunked(wire)
        collected, off, done = [], 0, 0
        while not done:
            data, off, done = codec.parse_chunked_step(wire, off)
            if data:
                collected.append(data)
        assert b"".join(collected) == body_ref and off == end_ref


def _outcome(fn, *args):
    """A call's result, or its exception's type name and arguments."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — compared, not handled
        return ("raise", type(e).__name__, e.args)


def _mutate(rnd: random.Random, raw: bytes) -> bytes:
    """Flip, insert, delete or truncate a few bytes (from a seeded stream)."""
    b = bytearray(raw)
    for _ in range(rnd.randint(1, 3)):
        op = rnd.randrange(4)
        if not b:
            break
        i = rnd.randrange(len(b))
        if op == 0:
            b[i] = rnd.choice(b"\r\n :\t\x00;0123456789abcdefxXzZ-+,")
        elif op == 1:
            b.insert(i, rnd.choice(b"\r\n :\t\x00;0fF-"))
        elif op == 2:
            del b[i]
        else:
            del b[i:]
    return bytes(b)


def _heads(rnd: random.Random):
    """400 heads: the first part of each from a valid pool, then, at a
    seeded rate, a malformed part or a mutation."""
    def pick(good, bad):
        return rnd.choice(bad) if rnd.random() < 0.15 else rnd.choice(good)

    methods = (["GET", "POST", "put", "DELETE", "A" * 31], ["A" * 32, ""])
    targets = (["/", "/a/b?x=1", "/%E2%82%AC"], [""])
    versions = (["HTTP/1.1", "HTTP/1.0"], ["HTTP/1.", "HTTP/2.0", "SPDY/3"])
    good = ["Host: h", "Content-Length: 5", "Content-Length: 05", "Transfer-Encoding: chunked",
            "Transfer-Encoding: gzip, chunked", "Connection: close", "Connection: keep-alive",
            "Expect: 100-continue", "X-Ws:   v  ", "X-Colons: a:b:c", "X-Empty:"]
    bad = ["Content-Length: 6", "Content-Length: +5", "Content-Length: " + "9" * 30,
           "Transfer-Encoding: chunked, gzip", " folded", "NoColon", ": empty", "X-Bare: a\rb"]
    for _ in range(400):
        head = f"{pick(*methods)} {pick(*targets)} {pick(*versions)}\r\n"
        head += "".join(pick(good, bad) + "\r\n" for _ in range(rnd.randint(0, 5))) + "\r\n"
        raw = head.encode("latin-1") + rnd.choice([b"", b"hello", b"GET / HTTP/1.1\r\n\r\n"])
        yield raw if rnd.random() < 0.7 else _mutate(rnd, raw)


def test_codec_parse_equals_jax_fuzz():
    """``parse`` (and ``parse`` at an offset) returns the same tuple or
    raises the same (status, message) as JAX's codec on 400 seeded heads,
    valid and mutated."""
    rnd = random.Random(24)
    n_ok = n_err = 0
    for raw in _heads(rnd):
        for off in (0, rnd.randrange(len(raw) + 1)):
            got, want = _outcome(codec.parse, raw, off), _outcome(jcodec.parse, raw, off)
            assert got == want, (raw, off)
            n_ok += got[0] == "ok" and got[1] is not None
            n_err += got[0] == "raise"
    assert n_ok > 100 and n_err > 100  # both sides of the parser were reached


def test_codec_parse_chunked_step_equals_jax_fuzz():
    """``parse_chunked_step`` walks the same (data, offset, done) or raises
    the same error as JAX's codec, step by step, on seeded bodies, valid
    and mutated."""
    rnd = random.Random(25)
    n_err = 0
    for _ in range(300):
        parts = [bytes(rnd.getrandbits(8) for _ in range(rnd.randint(1, 64))) for _ in range(rnd.randint(0, 5))]
        wire = b"".join(f"{len(p):x}".encode() + rnd.choice([b"", b";x=1"]) + b"\r\n" + p + b"\r\n"
                        for p in parts) + b"0\r\n" + rnd.choice([b"", b"T: v\r\n"]) + b"\r\n"
        if rnd.random() < 0.5:
            wire = _mutate(rnd, wire)
        off = 0
        for _step in range(len(parts) + 3):
            got, want = _outcome(codec.parse_chunked_step, wire, off), _outcome(jcodec.parse_chunked_step, wire, off)
            assert got == want, (wire, off)
            if got[0] == "raise":
                n_err += 1
                break
            _data, off, done = got[1]
            if done:
                break
    assert n_err > 10


def test_codec_build_head_equals_jax_fuzz():
    """``build_head`` writes the same bytes, or raises the same error, as
    JAX's codec on seeded statuses, headers, lengths, flags and bodies."""
    rnd = random.Random(26)
    statuses = [200, 201, 204, 301, 400, 404, 405, 408, 413, 429, 431, 500, 503, 505, 299, 999]
    names = ["Content-Type", "Content-Length", "Transfer-Encoding", "Connection", "X-A", "x-b", "Retry-After",
             "X-Bad\r", "X-Nul\x00"]
    values = ["application/json", "5", "chunked", "close", "", "v" * 300, "a\nb", "é", "1"]
    for _ in range(500):
        headers = [(rnd.choice(names), rnd.choice(values)) for _ in range(rnd.randint(0, 6))]
        if rnd.random() < 0.1:
            headers = [[rnd.choice(names), 7]]  # a list and a non-str value: the strict serializer's refusal
        body = rnd.choice([None, b"", b"ok", bytes(range(256))])
        args = (rnd.choice(statuses), headers, rnd.choice([-1, 0, 2, len(body or b""), 10 ** 12]),
                rnd.randint(0, 1), rnd.randint(0, 1))
        if body is not None:
            args = args + (body,)
        assert _outcome(codec.build_head, *args) == _outcome(jcodec.build_head, *args), args


# ---------------------------------------------------------------------------
# the App: the server choice, the shutdown with open connections
# ---------------------------------------------------------------------------

BASE = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR"}


def _app(native: str | None = None, **extra):
    from gofr_tpu_torch.app import App

    cfg = {**BASE, **extra}
    if native is not None:
        cfg["GOFR_HTTP_NATIVE"] = native
    return App(config=new_mock_config(cfg))


def test_app_serves_native_by_default_and_asyncio_on_request():
    """As the JAX App: the native server unless GOFR_HTTP_NATIVE=0."""
    import gofr_tpu
    from gofr_tpu.config import new_mock_config as jax_mock_config

    for native, want in ((None, NativeHTTPServer), ("1", NativeHTTPServer), ("0", AsyncHTTPServer)):
        app = _app(native)
        jcfg = {**BASE, **({} if native is None else {"GOFR_HTTP_NATIVE": native})}
        japp = gofr_tpu.new(config=jax_mock_config(jcfg))
        assert type(app.http_server) is want
        assert type(app.http_server).__name__ == type(japp.http_server).__name__
        app.container.close()
        japp.container.close()


def test_app_falls_back_with_a_warning_when_the_codec_is_missing(monkeypatch, capsys):
    """A codec that cannot be built: the JAX App's warning, and the
    asyncio server."""
    monkeypatch.setattr(NativeHTTPServer, "available", staticmethod(lambda: False))
    app = _app(LOG_LEVEL="WARN")
    assert type(app.http_server) is AsyncHTTPServer
    assert "native HTTP codec unavailable; using pure-Python server" in capsys.readouterr().out
    app.container.close()


@pytest.mark.parametrize("native", ["1", "0"])
def test_idle_keep_alive_connection_does_not_hold_the_shutdown(native):
    """ROADMAP queue 3 item 37 on both servers: an idle keep-alive
    connection (a router's pooled socket) closes at the shutdown instead
    of holding it for the 75 s keep-alive idle timeout."""
    app = _app(native)
    app.get("/who", lambda ctx: "b")
    thread = app.run_in_background()
    s = socket.create_connection(("127.0.0.1", app.http_server.port), timeout=10)
    try:
        s.sendall(b"GET /who HTTP/1.1\r\nHost: x\r\n\r\n")
        assert b"200 OK" in s.recv(4096)  # the connection stays open, idle
        t0 = time.monotonic()
        app.shutdown()
        thread.join(timeout=10)
        assert not thread.is_alive() and app.http_server._server is None
        assert time.monotonic() - t0 < 5
        assert s.recv(4096) == b""  # closed by the server
    finally:
        s.close()


@pytest.mark.parametrize("native", ["1", "0"])
def test_busy_connection_finishes_its_response_at_the_shutdown(native):
    """A stream in flight when the shutdown starts runs to its end, then
    its connection closes; a connection that sent nothing closes at once."""
    from gofr_tpu_torch.http.responder import StreamingResponse

    release = threading.Event()

    async def slow(ctx):
        async def gen():
            yield b"one\n"
            while not release.is_set():
                await asyncio.sleep(0.01)
            yield b"two\n"
        return StreamingResponse(gen(), "text/plain")

    app = _app(native)
    app.get("/slow", slow)
    thread = app.run_in_background()
    quiet = socket.create_connection(("127.0.0.1", app.http_server.port), timeout=10)
    s = socket.create_connection(("127.0.0.1", app.http_server.port), timeout=10)
    try:
        s.sendall(b"GET /slow HTTP/1.1\r\nHost: x\r\n\r\n")
        got = b""
        while b"one" not in got:
            got += s.recv(4096)
        app.shutdown()
        time.sleep(0.3)
        assert thread.is_alive()  # the stream holds the shutdown
        assert quiet.recv(4096) == b""  # the connection with no request closed
        release.set()
        while not got.endswith(b"0\r\n\r\n"):
            chunk = s.recv(4096)
            assert chunk, got
            got += chunk
        assert b"two" in got
        assert s.recv(4096) == b""  # closed after its response
        thread.join(timeout=10)
        assert not thread.is_alive()
    finally:
        release.set()
        s.close()
        quiet.close()


# ---------------------------------------------------------------------------
# a client that hangs up mid-SSE, on a tiny engine, on both servers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_params():
    """tests/test_torch_edge.py's weights: the tiny preset with an untied
    random head (the tied tiny model repeats its input token)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gofr_tpu.models import transformer as JT
    from gofr_tpu_torch.models import transformer as TT

    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    return TT.params_from_jax(jax.tree.map(np.asarray, jp), TT.TransformerConfig.tiny(), device="cpu")


@pytest.fixture
def one_torch_thread():
    """The tiny engine's CPU ops on one intra-op thread: under the suite's
    parallel workers an 8-thread pool spends most of its time in its
    barriers (tests/test_torch_edge.py's fixture), and a scheduler pass
    that slow misses the 3 s in which a disconnect must be retired."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("native", ["1", "0"])
def test_sse_disconnect_frees_blocks(native, tiny_params, one_torch_thread):
    """tests/test_torch_edge.py's case on each server: the server's abort
    closes the generator, the request ends with "disconnect" and the
    engine frees its blocks with no other traffic."""
    from gofr_tpu_torch import serve

    app = serve.build_app(new_mock_config({
        **BASE, "REQUEST_TIMEOUT": "30", "GEMMA_PRESET": "tiny", "TORCH_DEVICE": "cpu", "LLM_SLOTS": "2",
        "LLM_MAX_SEQ": "256", "GOFR_HTTP_NATIVE": native,
    }), params=tiny_params)
    assert type(app.http_server) is (NativeHTTPServer if native == "1" else AsyncHTTPServer)
    thread = app.run_in_background()
    try:
        eng = app.container.tpu().llm("gemma")
        before = eng.stats()["disconnect_cancels"]
        body = json.dumps({"messages": [{"role": "user", "content": "go"}], "max_tokens": 200,
                           "stream": True}).encode()
        sock = socket.create_connection(("127.0.0.1", app.http_server.port), timeout=30)
        try:
            sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                         + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            got = b""
            while b"data: " not in got:
                chunk = sock.recv(4096)
                assert chunk, "server closed before the first chunk"
                got += chunk
        finally:
            sock.close()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 3.0 and not (
                eng.stats()["disconnect_cancels"] == before + 1 and eng.stats()["kvcache"]["blocks_in_use"] == 0):
            time.sleep(0.01)
        st = eng.stats()
        assert st["disconnect_cancels"] == before + 1 and st["kvcache"]["blocks_in_use"] == 0
    finally:
        app.shutdown()
        thread.join(timeout=30)
