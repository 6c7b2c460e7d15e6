"""SCRAM (RFC 5802 / RFC 7677), the SASL layer of the wire clients
(counterpart of gofr_tpu/datasource/scram.py, the same exchange bytes).

``ScramClient`` (SCRAM-SHA-1/256/512; ``nonce=`` fixes the client nonce so
an exchange is reproducible) is what the Kafka client authenticates with
through SaslAuthenticate; ``ScramServer`` and ``scram_server_keys`` are the
verifier side, used by the in-process fake brokers so that auth tests run
the real handshake.

Flow (client side):
    c = ScramClient("SCRAM-SHA-256", user, password)
    send c.first_message()
    c.process_server_first(server_first) -> client_final, send it
    c.verify_server_final(server_final)  # raises ScramError on a bad proof
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os

__all__ = ["ScramClient", "ScramError", "scram_server_keys"]

_HASHES = {
    "SCRAM-SHA-256": hashlib.sha256,
    "SCRAM-SHA-512": hashlib.sha512,  # Kafka's other standard mechanism
    "SCRAM-SHA-1": hashlib.sha1,  # MongoDB legacy
}


class ScramError(Exception):
    """Malformed exchange or server-proof verification failure."""


def _escape_username(name: str) -> str:
    # RFC 5802 5.1: "=" and "," in saslname are escaped
    return name.replace("=", "=3D").replace(",", "=2C")


class ScramClient:
    def __init__(
        self,
        mechanism: str,
        username: str,
        password: str | bytes,
        *,
        nonce: str | None = None,
    ):
        if mechanism not in _HASHES:
            raise ScramError(f"unsupported mechanism {mechanism!r}")
        self.mechanism = mechanism
        self._hash = _HASHES[mechanism]
        self.username = username
        # password: str for the RFC flow; bytes allows pre-derived secrets
        self.password = (
            password.encode() if isinstance(password, str) else password
        )
        self._cnonce = nonce or base64.b64encode(os.urandom(18)).decode()
        self._client_first_bare = (
            f"n={_escape_username(username)},r={self._cnonce}"
        )
        self._auth_message: bytes | None = None
        self._salted: bytes | None = None

    # -- exchange ----------------------------------------------------------
    def first_message(self) -> str:
        """gs2-header 'n,,' (no channel binding) + client-first-bare."""
        return "n,," + self._client_first_bare

    def process_server_first(self, server_first: str) -> str:
        """Parse r=/s=/i=, derive proof, return client-final-message."""
        attrs = _parse(server_first)
        rnonce, salt_b64, iters = attrs.get("r"), attrs.get("s"), attrs.get("i")
        if not rnonce or not salt_b64 or not iters:
            raise ScramError(f"malformed server-first {server_first!r}")
        if not rnonce.startswith(self._cnonce):
            # a server echoing a foreign nonce is answering someone else's
            # exchange (or replaying) — abort before proving anything
            raise ScramError("server nonce does not extend client nonce")
        iterations = int(iters)
        if iterations < 1:
            raise ScramError("non-positive iteration count")
        salt = base64.b64decode(salt_b64)
        self._salted = hashlib.pbkdf2_hmac(
            self._hash().name, self.password, salt, iterations
        )
        client_key = hmac.new(self._salted, b"Client Key", self._hash).digest()
        stored_key = self._hash(client_key).digest()
        without_proof = f"c=biws,r={rnonce}"
        self._auth_message = ",".join(
            (self._client_first_bare, server_first, without_proof)
        ).encode()
        signature = hmac.new(stored_key, self._auth_message, self._hash).digest()
        proof = bytes(a ^ b for a, b in zip(client_key, signature))
        return f"{without_proof},p={base64.b64encode(proof).decode()}"

    def verify_server_final(self, server_final: str) -> None:
        """Check v= against our own ServerSignature — mutual auth; without
        it a MITM that let our proof pass through could impersonate the
        server for the rest of the session."""
        attrs = _parse(server_final)
        if "e" in attrs:
            raise ScramError(f"server rejected credentials: {attrs['e']}")
        v = attrs.get("v")
        if not v or self._auth_message is None or self._salted is None:
            raise ScramError("server-final before exchange completed")
        server_key = hmac.new(self._salted, b"Server Key", self._hash).digest()
        expected = hmac.new(server_key, self._auth_message, self._hash).digest()
        if not hmac.compare_digest(base64.b64decode(v), expected):
            raise ScramError("server signature mismatch")


def _parse(message: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for part in message.split(","):
        if len(part) >= 2 and part[1] == "=":
            out[part[0]] = part[2:]
    return out


def scram_server_keys(
    mechanism: str, password: str | bytes, salt: bytes, iterations: int
) -> tuple[bytes, bytes]:
    """(StoredKey, ServerKey) for a fake/test server's credential store."""
    h = _HASHES[mechanism]
    pw = password.encode() if isinstance(password, str) else password
    salted = hashlib.pbkdf2_hmac(h().name, pw, salt, iterations)
    client_key = hmac.new(salted, b"Client Key", h).digest()
    return h(client_key).digest(), hmac.new(salted, b"Server Key", h).digest()


class ScramServer:
    """Verifier side, for the in-process fakes (FakeMongoServer,
    FakeKafkaBroker): same RFC flow the clients speak, so auth tests run
    the real handshake bytes end to end instead of stubbing acceptance."""

    def __init__(
        self,
        mechanism: str,
        users: dict[str, str | bytes],
        *,
        iterations: int = 4096,
    ):
        self.mechanism = mechanism
        self._hash = _HASHES[mechanism]
        self.users = users
        self.iterations = iterations
        self._salt = os.urandom(16)
        self._snonce = base64.b64encode(os.urandom(18)).decode()
        self._client_first_bare: str | None = None
        self._server_first: str | None = None
        self._username: str | None = None

    def process_client_first(self, client_first: str) -> str:
        if not client_first.startswith(("n,,", "y,,")):
            raise ScramError("unsupported gs2 header")
        bare = client_first.split(",,", 1)[1]
        attrs = _parse(bare)
        user, cnonce = attrs.get("n"), attrs.get("r")
        if not user or not cnonce:
            raise ScramError("malformed client-first")
        self._username = user.replace("=2C", ",").replace("=3D", "=")
        self._client_first_bare = bare
        self._server_first = (
            f"r={cnonce}{self._snonce},"
            f"s={base64.b64encode(self._salt).decode()},i={self.iterations}"
        )
        return self._server_first

    def process_client_final(self, client_final: str) -> str:
        attrs = _parse(client_final)
        proof_b64 = attrs.get("p")
        if not proof_b64 or self._server_first is None:
            raise ScramError("malformed client-final")
        if self._username not in self.users:
            raise ScramError("unknown user")
        stored_key, server_key = scram_server_keys(
            self.mechanism, self.users[self._username], self._salt, self.iterations
        )
        without_proof = client_final.rsplit(",p=", 1)[0]
        auth_message = ",".join(
            (self._client_first_bare, self._server_first, without_proof)
        ).encode()
        signature = hmac.new(stored_key, auth_message, self._hash).digest()
        proof = base64.b64decode(proof_b64)
        client_key = bytes(a ^ b for a, b in zip(proof, signature))
        if not hmac.compare_digest(self._hash(client_key).digest(), stored_key):
            raise ScramError("authentication failed")
        v = hmac.new(server_key, auth_message, self._hash).digest()
        return f"v={base64.b64encode(v).decode()}"
