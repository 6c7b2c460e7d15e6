"""Auth middleware: basic, API key, and OAuth (bearer JWT over a JWKS)
(counterpart of gofr_tpu/http/middleware/auth.py).

Basic auth checks a static user map (``hmac.compare_digest``) or a
validator and puts the user on ``req.context["user"]``; API-key auth
checks ``X-API-KEY`` against a key list or a validator; OAuth verifies a
bearer JWT (RS256/384/512 against the JWKS key named by ``kid``, or HS256
against a shared secret; ``exp``/``nbf`` with a 30 s leeway) and puts its
claims on ``req.context["JWTClaims"]``. A refusal answers 401 with the
error envelope. ``/.well-known/*``, ``/favicon.ico`` and OPTIONS pass
without credentials.

RSASSA-PKCS1-v1_5 verification is a modular exponentiation and a
DigestInfo comparison, so it needs no crypto package.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import threading
import time
import urllib.request

from ..request import Request
from ..responder import Response, to_json_bytes
from ..router import WireHandler, ensure_async

_WELL_KNOWN = "/.well-known/"


def _unauthorized(msg: str = "Unauthorized") -> Response:
    return Response(401, [("Content-Type", "application/json")], to_json_bytes({"error": {"message": msg}}))


def _exempt(req: Request) -> bool:
    return req.path.startswith(_WELL_KNOWN) or req.path == "/favicon.ico" or req.method == "OPTIONS"


def basic_auth_middleware(users: dict[str, str] | None = None, validate_func=None):
    """A static user map or a validator ``(user, password) -> bool``."""
    if validate_func is not None:
        validate_func = ensure_async(validate_func)

    def mw(next_handler: WireHandler) -> WireHandler:
        async def h(req: Request) -> Response:
            if _exempt(req):
                return await next_handler(req)
            header = req.headers.get("authorization", "")
            if not header.startswith("Basic "):
                return _unauthorized()
            try:
                user, _, password = base64.b64decode(header[6:]).decode("utf-8").partition(":")
            except (ValueError, UnicodeDecodeError):
                return _unauthorized()
            if validate_func is not None:
                ok = await validate_func(user, password)
            else:
                ok = users is not None and hmac.compare_digest(users.get(user, "\x00"), password)
            if not ok:
                return _unauthorized()
            req.context["user"] = user
            return await next_handler(req)

        return h

    return mw


def apikey_auth_middleware(keys: list[str] | None = None, validate_func=None):
    """The ``X-API-KEY`` header against a key list or a validator ``(key) -> bool``."""
    if validate_func is not None:
        validate_func = ensure_async(validate_func)
    keyset = set(keys or [])

    def mw(next_handler: WireHandler) -> WireHandler:
        async def h(req: Request) -> Response:
            if _exempt(req):
                return await next_handler(req)
            key = req.headers.get("x-api-key", "")
            if not key:
                return _unauthorized()
            ok = (await validate_func(key)) if validate_func is not None else key in keyset
            if not ok:
                return _unauthorized()
            return await next_handler(req)

        return h

    return mw


# ---------------- JWT / JWKS ----------------

def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _b64url_to_int(s: str) -> int:
    return int.from_bytes(_b64url_decode(s), "big")


# DigestInfo prefixes of EMSA-PKCS1-v1_5 (RFC 8017 section 9.2, note 1)
_DIGEST_INFO = {
    "RS256": (hashlib.sha256, bytes.fromhex("3031300d060960864801650304020105000420")),
    "RS384": (hashlib.sha384, bytes.fromhex("3041300d060960864801650304020205000430")),
    "RS512": (hashlib.sha512, bytes.fromhex("3051300d060960864801650304020305000440")),
}


def _rsa_pkcs1_verify(alg: str, n: int, e: int, message: bytes, signature: bytes) -> bool:
    hasher, prefix = _DIGEST_INFO[alg]
    k = (n.bit_length() + 7) // 8
    if len(signature) != k:
        return False
    em = pow(int.from_bytes(signature, "big"), e, n).to_bytes(k, "big")
    digest = hasher(message).digest()
    expected = b"\x00\x01" + b"\xff" * (k - len(prefix) - len(digest) - 3) + b"\x00" + prefix + digest
    return hmac.compare_digest(em, expected)


class JWKSProvider:
    """Fetches and caches a JWKS document (its RSA keys by ``kid``),
    refreshed every ``refresh_interval_s`` by a daemon thread until
    ``close()``."""

    def __init__(self, url: str, refresh_interval_s: float = 300.0):
        self.url = url
        self._keys: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.refresh()
        self._thread = threading.Thread(
            target=self._loop, args=(refresh_interval_s,), daemon=True, name="gofr-jwks-refresh"
        )
        self._thread.start()

    def _loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.refresh()
            except Exception:  # noqa: BLE001 - keep serving with the cached keys
                continue

    def refresh(self) -> None:
        with urllib.request.urlopen(self.url, timeout=5) as resp:  # noqa: S310
            doc = json.loads(resp.read().decode("utf-8"))
        keys = {k["kid"]: k for k in doc.get("keys", []) if k.get("kty") == "RSA" and "kid" in k}
        with self._lock:
            self._keys = keys

    def key(self, kid: str) -> dict | None:
        with self._lock:
            return self._keys.get(kid)

    def close(self) -> None:
        self._stop.set()


def verify_jwt(token: str, key_lookup, *, hs_secret: bytes | None = None, leeway_s: float = 30.0) -> dict:
    """Verify a JWT and return its claims; ``PermissionError`` otherwise.
    ``key_lookup(kid)`` -> JWK dict for RS*; ``hs_secret`` enables HS256."""
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(_b64url_decode(header_b64))
        payload = json.loads(_b64url_decode(payload_b64))
        signature = _b64url_decode(sig_b64)
    except (ValueError, json.JSONDecodeError) as e:
        raise PermissionError("malformed token") from e
    alg = header.get("alg", "")
    signing_input = f"{header_b64}.{payload_b64}".encode()
    if alg in _DIGEST_INFO:
        jwk = key_lookup(header.get("kid", "")) if key_lookup else None
        if jwk is None:
            raise PermissionError("unknown key id")
        n, e = _b64url_to_int(jwk["n"]), _b64url_to_int(jwk["e"])
        if not _rsa_pkcs1_verify(alg, n, e, signing_input, signature):
            raise PermissionError("bad signature")
    elif alg == "HS256" and hs_secret is not None:
        expected = hmac.new(hs_secret, signing_input, hashlib.sha256).digest()
        if not hmac.compare_digest(expected, signature):
            raise PermissionError("bad signature")
    else:
        raise PermissionError(f"unsupported alg {alg}")
    now = time.time()
    try:
        if "exp" in payload and now > float(payload["exp"]) + leeway_s:
            raise PermissionError("token expired")
        if "nbf" in payload and now < float(payload["nbf"]) - leeway_s:
            raise PermissionError("token not yet valid")
    except (TypeError, ValueError) as e:
        raise PermissionError("malformed time claim") from e
    return payload


def oauth_middleware(jwks: JWKSProvider | None = None, *, hs_secret: bytes | None = None):
    """Bearer-JWT auth; the claims land on ``req.context["JWTClaims"]``."""

    def mw(next_handler: WireHandler) -> WireHandler:
        async def h(req: Request) -> Response:
            if _exempt(req):
                return await next_handler(req)
            header = req.headers.get("authorization", "")
            if not header.startswith("Bearer "):
                return _unauthorized()
            try:
                claims = verify_jwt(header[7:], jwks.key if jwks else None, hs_secret=hs_secret)
            except PermissionError as e:
                return _unauthorized(str(e))
            req.context["JWTClaims"] = claims
            return await next_handler(req)

        return h

    return mw
