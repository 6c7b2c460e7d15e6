"""Google service-account auth: RS256 JWT signing in the standard library
only (counterpart of gofr_tpu/datasource/pubsub/googleauth.py).

The two token shapes Google accepts, from a service-account JSON key:

- **Self-signed JWT** (default): an RS256-signed JWT with the service API
  as audience, accepted directly as a Bearer token.
- **OAuth2 JWT grant**: the signed assertion POSTed to ``token_uri``
  (urn:ietf:params:oauth:grant-type:jwt-bearer) for an access token.

RSASSA-PKCS1-v1_5 signing is pow(padded_digest, d, n); the key comes from
a minimal DER reader for the two layouts service-account keys use (PKCS#8
``PrivateKeyInfo`` wrapping PKCS#1 ``RSAPrivateKey``).
"""

from __future__ import annotations

import base64
import json
import threading
import time

__all__ = ["ServiceAccountAuth", "rs256_sign", "parse_private_key_pem"]


# ---------------------------------------------------------------------------
# DER / PEM parsing (minimal ASN.1: SEQUENCE, INTEGER, OCTET STRING)
# ---------------------------------------------------------------------------


def _der_read(buf: bytes, at: int) -> tuple[int, bytes, int]:
    """Read one TLV -> (tag, value, next_offset)."""
    tag = buf[at]
    length = buf[at + 1]
    at += 2
    if length & 0x80:
        nbytes = length & 0x7F
        length = int.from_bytes(buf[at : at + nbytes], "big")
        at += nbytes
    return tag, buf[at : at + length], at + length


def _der_ints(seq: bytes, count: int) -> list[int]:
    out, at = [], 0
    while len(out) < count:
        tag, val, at = _der_read(seq, at)
        if tag != 0x02:
            raise ValueError(f"expected DER INTEGER, got tag 0x{tag:02x}")
        out.append(int.from_bytes(val, "big"))
    return out


def parse_private_key_pem(pem: str) -> tuple[int, int, int]:
    """-> (n, e, d) from 'BEGIN PRIVATE KEY' (PKCS#8) or
    'BEGIN RSA PRIVATE KEY' (PKCS#1) PEM."""
    lines = [ln.strip() for ln in pem.strip().splitlines()]
    if not lines or "-----BEGIN" not in lines[0]:
        raise ValueError("not a PEM private key")
    body = "".join(ln for ln in lines[1:-1] if ln and not ln.startswith("-"))
    der = base64.b64decode(body)
    tag, outer, _ = _der_read(der, 0)
    if tag != 0x30:
        raise ValueError("bad DER: expected outer SEQUENCE")
    if "RSA PRIVATE KEY" not in lines[0]:
        # PKCS#8: SEQ { version INT, algId SEQ, privateKey OCTET STRING }
        at = 0
        _, _version, at = _der_read(outer, at)  # version
        _, _alg, at = _der_read(outer, at)  # algorithm identifier
        tag, octets, at = _der_read(outer, at)
        if tag != 0x04:
            raise ValueError("bad PKCS#8: expected OCTET STRING")
        tag, outer, _ = _der_read(octets, 0)
        if tag != 0x30:
            raise ValueError("bad inner PKCS#1: expected SEQUENCE")
    # PKCS#1 RSAPrivateKey: version, n, e, d, p, q, ...
    version, n, e, d = _der_ints(outer, 4)
    if version != 0:
        raise ValueError(f"unsupported RSAPrivateKey version {version}")
    return n, e, d


# ---------------------------------------------------------------------------
# RS256 signing (RSASSA-PKCS1-v1_5 over SHA-256)
# ---------------------------------------------------------------------------

# DigestInfo prefix for SHA-256 — same constant the verifier uses
# (http/middleware/auth.py:104)
_SHA256_PREFIX = bytes.fromhex("3031300d060960864801650304020105000420")


def rs256_sign(message: bytes, n: int, d: int) -> bytes:
    import hashlib

    k = (n.bit_length() + 7) // 8
    digest_info = _SHA256_PREFIX + hashlib.sha256(message).digest()
    pad_len = k - len(digest_info) - 3
    if pad_len < 8:
        raise ValueError("RSA key too small for RS256")
    em = b"\x00\x01" + b"\xff" * pad_len + b"\x00" + digest_info
    sig = pow(int.from_bytes(em, "big"), d, n)
    return sig.to_bytes(k, "big")


def _b64url(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()


class ServiceAccountAuth:
    """Produces `authorization: Bearer ...` gRPC metadata from a service-
    account key, caching tokens until shortly before expiry.

    mode="self_signed" (default): the JWT itself is the bearer token,
    audience = the service endpoint. mode="oauth" exchanges the signed
    assertion at token_uri for an access token (RFC 7523 JWT grant).
    """

    _EARLY = 300  # refresh 5 min before expiry, like google-auth clients

    def __init__(
        self,
        info: dict | str,
        *,
        audience: str = "https://pubsub.googleapis.com/",
        scope: str = "https://www.googleapis.com/auth/pubsub",
        mode: str = "self_signed",
        lifetime: int = 3600,
    ):
        if isinstance(info, str):
            with open(info, encoding="utf-8") as f:
                info = json.load(f)
        if mode not in ("self_signed", "oauth"):
            raise ValueError(f"unknown auth mode {mode!r}")
        self.email = info["client_email"]
        self.key_id = info.get("private_key_id", "")
        self.token_uri = info.get(
            "token_uri", "https://oauth2.googleapis.com/token"
        )
        self.n, self.e, self.d = parse_private_key_pem(info["private_key"])
        self.audience = audience
        self.scope = scope
        self.mode = mode
        self.lifetime = lifetime
        self._lock = threading.Lock()
        self._token: str | None = None
        self._expiry = 0.0

    # -- JWT ----------------------------------------------------------------
    def _signed_jwt(self, claims: dict) -> str:
        header = {"alg": "RS256", "typ": "JWT"}
        if self.key_id:
            header["kid"] = self.key_id
        signing_input = (
            _b64url(json.dumps(header, separators=(",", ":")).encode())
            + "."
            + _b64url(json.dumps(claims, separators=(",", ":")).encode())
        ).encode("ascii")
        sig = rs256_sign(signing_input, self.n, self.d)
        return signing_input.decode() + "." + _b64url(sig)

    def _fresh_token(self) -> tuple[str, float]:
        now = int(time.time())
        if self.mode == "self_signed":
            claims = {
                "iss": self.email,
                "sub": self.email,
                "aud": self.audience,
                "iat": now,
                "exp": now + self.lifetime,
            }
            return self._signed_jwt(claims), float(now + self.lifetime)
        # OAuth2 JWT-bearer grant (RFC 7523)
        claims = {
            "iss": self.email,
            "scope": self.scope,
            "aud": self.token_uri,
            "iat": now,
            "exp": now + self.lifetime,
        }
        assertion = self._signed_jwt(claims)
        import urllib.parse
        import urllib.request

        data = urllib.parse.urlencode(
            {
                "grant_type": "urn:ietf:params:oauth:grant-type:jwt-bearer",
                "assertion": assertion,
            }
        ).encode()
        req = urllib.request.Request(
            self.token_uri, data=data,
            headers={"Content-Type": "application/x-www-form-urlencoded"},
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            payload = json.load(resp)
        token = payload["access_token"]
        return token, float(now + int(payload.get("expires_in", self.lifetime)))

    def token(self) -> str:
        with self._lock:
            tok, exp = self._token, self._expiry
        if tok is not None and time.time() < exp - self._EARLY:
            return tok
        # refresh OUTSIDE the lock: in oauth mode this is a blocking HTTP
        # round trip (up to 10 s), and holding the lock would convoy every
        # concurrent caller behind one slow token endpoint
        new_tok, new_exp = self._fresh_token()
        with self._lock:
            if new_exp > self._expiry:  # keep whichever refresh is fresher
                self._token, self._expiry = new_tok, new_exp
            return self._token

    def metadata(self) -> list[tuple[str, str]]:
        """gRPC call metadata carrying the bearer token."""
        return [("authorization", f"Bearer {self.token()}")]
