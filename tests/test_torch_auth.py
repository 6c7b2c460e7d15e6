"""The port's inbound auth middleware (gofr_tpu_torch.http.middleware.auth)
against the JAX package's: the same requests through basic, API-key and
OAuth (JWT over a JWKS) middleware must give the same status, body and
headers and leave the same user or claims on the request; the exempt
paths pass without credentials; JWT ``exp``/``nbf`` inside and outside the
leeway. The RSA key is built here from two fixed primes (found by a
deterministic search from fixed seeds), and the JWKS is served by a local
stub."""

import asyncio
import base64
import hashlib
import hmac
import http.server
import json
import threading
import time

import pytest

from gofr_tpu.http.middleware import auth as jauth
from gofr_tpu.http.request import Request as JRequest
from gofr_tpu.http.responder import Response as JResponse
from gofr_tpu_torch.http.middleware import auth as pauth
from gofr_tpu_torch.http.request import Request as PRequest
from gofr_tpu_torch.http.responder import Response as PResponse

PACKAGES = {"jax": (jauth, JRequest, JResponse), "port": (pauth, PRequest, PResponse)}


def _is_probable_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _prime_from(seed: bytes, bits: int = 1024) -> int:
    n = int.from_bytes(hashlib.shake_256(seed).digest(bits // 8), "big") | (1 << (bits - 1)) | 1
    while not _is_probable_prime(n):
        n += 2
    return n


P, Q, E = _prime_from(b"gofr-auth-p"), _prime_from(b"gofr-auth-q"), 65537
N = P * Q
D = pow(E, -1, (P - 1) * (Q - 1))
KID = "k1"
HS_SECRET = b"shared-secret"


def _b64u(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _int_b64u(i: int) -> str:
    return _b64u(i.to_bytes((i.bit_length() + 7) // 8, "big"))


def _jwt(claims: dict, alg: str = "RS256", kid: str = KID, tamper: bool = False) -> str:
    head = _b64u(json.dumps({"alg": alg, "kid": kid, "typ": "JWT"}).encode())
    body = _b64u(json.dumps(claims).encode())
    signing = f"{head}.{body}".encode()
    if alg == "HS256":
        sig = hmac.new(HS_SECRET, signing, hashlib.sha256).digest()
    elif alg in ("RS256", "RS384", "RS512"):
        hasher, prefix = jauth._DIGEST_INFO[alg]
        k = (N.bit_length() + 7) // 8
        digest = hasher(signing).digest()
        em = b"\x00\x01" + b"\xff" * (k - len(prefix) - len(digest) - 3) + b"\x00" + prefix + digest
        sig = pow(int.from_bytes(em, "big"), D, N).to_bytes(k, "big")
    else:
        sig = b""
    if tamper:
        sig = bytes([sig[0] ^ 1]) + sig[1:]
    return f"{head}.{body}.{_b64u(sig)}"


@pytest.fixture(scope="module")
def jwks_url():
    doc = json.dumps({"keys": [{"kty": "RSA", "kid": KID, "n": _int_b64u(N), "e": _int_b64u(E)},
                               {"kty": "EC", "kid": "ec"}]}).encode()

    class Stub(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(doc)))
            self.end_headers()
            self.wfile.write(doc)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/jwks.json"
    srv.shutdown()
    srv.server_close()
    th.join(timeout=5)


def _through(pkg: str, make_mw, method: str, path: str, headers: dict):
    """One request through the package's middleware in front of a handler
    that echoes what auth left on the request -> (status, body, headers,
    user, claims, whether the handler ran)."""
    mod, Request, Response = PACKAGES[pkg]
    seen = {}

    async def handler(req):
        seen["ran"] = True
        return Response(200, [("Content-Type", "application/json")], b'{"data":"ok"}')

    req = Request(method, path, {k.lower(): v for k, v in headers.items()}, b"", "127.0.0.1:1")
    resp = asyncio.run(make_mw(mod)(handler)(req))
    return (resp.status, resp.body, list(resp.headers), req.context.get("user"), req.context.get("JWTClaims"),
            seen.get("ran", False))


def _basic(user: str, password: str) -> dict:
    return {"Authorization": "Basic " + base64.b64encode(f"{user}:{password}".encode()).decode()}


BASIC_CASES = {
    "none": {},
    "valid": _basic("ada", "lovelace"),
    "wrong_password": _basic("ada", "babbage"),
    "unknown_user": _basic("eve", "lovelace"),
    "not_basic": {"Authorization": "Bearer abc"},
    "bad_base64": {"Authorization": "Basic ###"},
    "no_colon": {"Authorization": "Basic " + base64.b64encode(b"ada").decode()},
}
ROUTES = [("GET", "/orders"), ("GET", "/.well-known/health"), ("GET", "/favicon.ico"), ("OPTIONS", "/orders")]


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: f"{r[0]}{r[1]}")
@pytest.mark.parametrize("case", sorted(BASIC_CASES))
def test_basic_static_users_equal(case, route):
    make = lambda mod: mod.basic_auth_middleware(users={"ada": "lovelace", "alan": "turing"})  # noqa: E731
    j, p = (_through(pkg, make, *route, BASIC_CASES[case]) for pkg in PACKAGES)
    assert j == p
    exempt = route[1] != "/orders" or route[0] == "OPTIONS"
    assert j[0] == (200 if exempt or case == "valid" else 401)
    if case == "valid" and not exempt:
        assert j[3] == "ada"


@pytest.mark.parametrize("is_async", [False, True])
@pytest.mark.parametrize("case", ["valid", "wrong_password", "none"])
def test_basic_validator_equal(case, is_async):
    def check(user, password):
        return user == "ada" and password == "lovelace"

    async def acheck(user, password):
        return check(user, password)

    make = lambda mod: mod.basic_auth_middleware(validate_func=acheck if is_async else check)  # noqa: E731
    j, p = (_through(pkg, make, "GET", "/orders", BASIC_CASES[case]) for pkg in PACKAGES)
    assert j == p
    assert j[0] == (200 if case == "valid" else 401)


@pytest.mark.parametrize("route", ROUTES[:2], ids=lambda r: r[1])
@pytest.mark.parametrize("key", [None, "", "k-good", "k-bad"])
@pytest.mark.parametrize("validator", [False, True])
def test_api_key_equal(key, route, validator):
    def make(mod):
        if validator:
            return mod.apikey_auth_middleware(validate_func=lambda k: k.startswith("k-g"))
        return mod.apikey_auth_middleware(keys=["k-good", "k-other"])

    headers = {} if key is None else {"X-API-KEY": key}
    j, p = (_through(pkg, make, *route, headers) for pkg in PACKAGES)
    assert j == p
    assert j[0] == (200 if route[1] != "/orders" or key == "k-good" else 401)


def _token_cases(now: float) -> dict:
    return {
        "rs256": _jwt({"sub": "u1", "exp": now + 600}),
        "rs384": _jwt({"sub": "u1", "exp": now + 600}, alg="RS384"),
        "rs512": _jwt({"sub": "u1", "exp": now + 600}, alg="RS512"),
        "bad_signature": _jwt({"sub": "u1"}, tamper=True),
        "unknown_kid": _jwt({"sub": "u1"}, kid="nope"),
        "expired_within_leeway": _jwt({"sub": "u1", "exp": now - 10}),
        "expired": _jwt({"sub": "u1", "exp": now - 120}),
        "nbf_within_leeway": _jwt({"sub": "u1", "nbf": now + 10}),
        "nbf_future": _jwt({"sub": "u1", "nbf": now + 120}),
        "bad_time_claim": _jwt({"sub": "u1", "exp": "soon"}),
        "hs256": _jwt({"sub": "svc", "scope": "read"}, alg="HS256"),
        "alg_none": _jwt({"sub": "u1"}, alg="none"),
        "malformed": "abc.def",
    }


@pytest.mark.parametrize("route", ROUTES[:3], ids=lambda r: r[1])
@pytest.mark.parametrize("case", sorted(_token_cases(0.0)))
@pytest.mark.parametrize("hs", [False, True])
def test_oauth_equal(jwks_url, case, route, hs):
    token = _token_cases(time.time())[case]
    providers = {}

    def make(mod):
        prov = providers[mod] = mod.JWKSProvider(jwks_url, refresh_interval_s=1.0)
        return mod.oauth_middleware(prov, hs_secret=HS_SECRET if hs else None)

    try:
        j, p = (_through(pkg, make, *route, {"Authorization": f"Bearer {token}"}) for pkg in PACKAGES)
    finally:
        for prov in providers.values():
            prov.close()
    assert j == p
    ok = case in ("rs256", "rs384", "rs512", "expired_within_leeway", "nbf_within_leeway") or (hs and case == "hs256")
    exempt = route[1] != "/orders"
    assert j[0] == (200 if ok or exempt else 401)
    if ok and not exempt:
        assert j[4]["sub"] in ("u1", "svc")


def test_oauth_no_bearer_and_key_refresh(jwks_url):
    provs = [mod.JWKSProvider(jwks_url, refresh_interval_s=0.05) for mod, _, _ in PACKAGES.values()]
    try:
        assert [sorted(p._keys) for p in provs] == [[KID], [KID]]  # the EC key is not kept
        j, p = (_through(pkg, lambda mod, i=i: mod.oauth_middleware(provs[i]), "GET", "/orders",
                         {"Authorization": "Basic x"}) for i, pkg in enumerate(PACKAGES))
        assert j == p and j[0] == 401 and j[1] == b'{"error":{"message":"Unauthorized"}}'
    finally:
        for prov in provs:
            prov.close()
    for prov in provs:
        prov._thread.join(timeout=5)
        assert not prov._thread.is_alive()
