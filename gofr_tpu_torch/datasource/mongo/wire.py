"""WireMongo: a MongoProvider over the MongoDB wire protocol (counterpart
of gofr_tpu/datasource/mongo/wire.py, the same frames).

``app.add_mongo(WireMongo(host, port, database, ...))`` runs the CRUD
surface of ``InMemoryMongo`` against a live server over OP_MSG
(``mongoproto``): hello at connect, find with its getMore walk, insert
(``insert_many`` sends its documents as a kind-1 sequence), update,
delete, count, drop (NamespaceNotFound, code 26, is a no-op) and ping for
the health check. ``testutil/fakemongo.py`` is the in-process server the
tests run it against.

Authentication: SCRAM-SHA-256 (the default) or SCRAM-SHA-1 through the
port's ``datasource.scram`` (saslStart / saslContinue on ``auth_source``);
SHA-1 authenticates with md5("user:mongo:password") hex in place of the
password, as the drivers' authentication specification says. TLS:
``tls=`` True (the default verifying context) or an ``ssl.SSLContext``
(``datasource.tls_from_config`` builds one from ``{PREFIX}_TLS*``).

Connections: a pool of at most ``pool_size`` sockets, each authenticated
when dialled; the dial happens outside the pool's lock. A command takes an
idle socket, dials one below the cap, or waits up to ``timeout``. A
``ConnectionError`` discards the socket (the next command redials), a
server error (``MongoError``) returns it to the pool; ``find`` holds one
socket for its whole cursor walk.
"""

from __future__ import annotations

import hashlib
import itertools
import socket
import threading

from .. import STATUS_DOWN, STATUS_UP, health, wrap_tls
from ..scram import ScramClient
from . import mongoproto as mb

__all__ = ["WireMongo", "MongoError"]


class MongoError(Exception):
    """Server-reported command failure ({ok: 0} or writeErrors)."""

    def __init__(self, message: str, code: int = 0):
        super().__init__(message)
        self.code = code


class _Conn:
    """One authenticated socket. command() is NOT thread-safe; the pool
    hands a connection to one caller at a time."""

    def __init__(self, owner: "WireMongo"):
        self._ids = itertools.count(1)
        raw = socket.create_connection(
            (owner.host, owner.port), timeout=owner.timeout
        )
        raw.settimeout(owner.timeout)
        self.sock = wrap_tls(raw, owner.tls, owner.host)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("MongoDB server closed connection")
            buf += chunk
        return buf

    def command(
        self,
        body: dict,
        *,
        db: str,
        sequences: dict[str, list[dict]] | None = None,
    ) -> dict:
        """Send one command, return the reply body; raises MongoError on
        {ok: 0} and surfaces writeErrors. ConnectionError means this
        socket is dead — the caller must discard the connection."""
        body = dict(body)
        body["$db"] = db
        # encode OUTSIDE the wire try-block: a BSON error is a caller
        # bug, not a connection failure, and must not tear down a
        # healthy socket or masquerade as a server outage
        frame_out = mb.encode_op_msg(
            body, request_id=next(self._ids), sequences=sequences
        )
        try:
            self.sock.sendall(frame_out)
            frame = mb.read_message(self._recv_exact)
        except (OSError, ValueError) as e:
            raise ConnectionError(f"MongoDB wire failure: {e}") from e
        _, _, reply = mb.decode_op_msg(frame)
        if not reply.get("ok"):
            raise MongoError(
                str(reply.get("errmsg", "command failed")),
                int(reply.get("code", 0)),
            )
        errors = reply.get("writeErrors")
        if errors:
            first = errors[0]
            raise MongoError(
                str(first.get("errmsg", "write failed")), int(first.get("code", 0))
            )
        return reply


class WireMongo:
    """Wire-protocol MongoDB client over a small authenticated connection
    pool (thread-safe; cursor walks pin one connection)."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 27017,
        database: str = "test",
        *,
        timeout: float = 5.0,
        username: str | None = None,
        password: str | None = None,
        auth_source: str = "admin",
        auth_mechanism: str = "SCRAM-SHA-256",
        tls=None,
        pool_size: int = 4,
    ):
        self.host, self.port, self.database = host, port, database
        self.timeout = timeout
        self.username, self.password = username, password
        self.auth_source, self.auth_mechanism = auth_source, auth_mechanism
        self.tls = tls
        self.pool_size = max(1, pool_size)
        self._idle: list[_Conn] = []
        self._total = 0
        self._cond = threading.Condition()
        self._closed = False
        self.logger = None
        self.metrics = None

    # -- provider seam -----------------------------------------------------
    def use_logger(self, logger) -> None:
        self.logger = logger

    def use_metrics(self, metrics) -> None:
        self.metrics = metrics

    def connect(self) -> None:
        conn = self._acquire()
        try:
            hello = conn.command({"hello": 1}, db="admin")
        except Exception:
            self._discard(conn)
            raise
        self._release(conn)
        if self.logger is not None:
            auth = f" as {self.username}" if self.username else ""
            self.logger.info(
                f"connected to MongoDB at {self.host}:{self.port}{auth} "
                f"(maxWireVersion {hello.get('maxWireVersion')})"
            )

    def close(self) -> None:
        with self._cond:
            self._closed = True
            idle, self._idle = self._idle, []
            self._total = 0
            self._cond.notify_all()
        for c in idle:
            c.close()

    # -- pool --------------------------------------------------------------
    def _acquire(self) -> _Conn:
        with self._cond:
            while True:
                if self._closed:
                    raise ConnectionError("client closed")
                if self._idle:
                    return self._idle.pop()
                if self._total < self.pool_size:
                    self._total += 1
                    break  # dial outside the lock
                if not self._cond.wait(timeout=self.timeout):
                    raise ConnectionError(
                        f"no MongoDB connection available in {self.timeout}s"
                    )
        conn = None
        try:
            conn = _Conn(self)
            self._authenticate(conn)
            return conn
        except Exception:
            if conn is not None:
                conn.close()  # don't leak the dialed socket on auth failure
            with self._cond:
                self._total -= 1
                self._cond.notify()
            raise

    def _release(self, conn: _Conn) -> None:
        with self._cond:
            if self._closed:
                conn.close()
                return
            self._idle.append(conn)
            self._cond.notify()

    def _discard(self, conn: _Conn) -> None:
        conn.close()
        with self._cond:
            if not self._closed:
                self._total -= 1
            self._cond.notify()

    def _authenticate(self, conn: _Conn) -> None:
        """SCRAM conversation on a fresh socket (RFC 5802; SHA-1 variant
        hashes the password per the MongoDB legacy scheme first)."""
        if not self.username:
            return
        if self.password is None:
            raise ValueError(
                f"username {self.username!r} configured without a password "
                f"({self.auth_mechanism} requires one)"
            )
        if self.auth_mechanism == "SCRAM-SHA-1":
            # MONGODB-CR-derived: H(user ":mongo:" password) hex is the
            # effective SCRAM password for SHA-1 (drivers' auth spec)
            digest = hashlib.md5(
                f"{self.username}:mongo:{self.password}".encode()
            ).hexdigest()
            client = ScramClient(self.auth_mechanism, self.username, digest)
        else:
            client = ScramClient(
                self.auth_mechanism, self.username, self.password or ""
            )
        reply = conn.command(
            {
                "saslStart": 1,
                "mechanism": self.auth_mechanism,
                "payload": client.first_message().encode(),
                "options": {"skipEmptyExchange": True},
            },
            db=self.auth_source,
        )
        cid = reply.get("conversationId", 1)
        final = client.process_server_first(bytes(reply["payload"]).decode())
        reply = conn.command(
            {"saslContinue": 1, "conversationId": cid, "payload": final.encode()},
            db=self.auth_source,
        )
        client.verify_server_final(bytes(reply["payload"]).decode())
        # without skipEmptyExchange the server wants one empty round
        while not reply.get("done", False):
            reply = conn.command(
                {"saslContinue": 1, "conversationId": cid, "payload": b""},
                db=self.auth_source,
            )

    def _command(
        self,
        body: dict,
        *,
        db: str | None = None,
        sequences: dict[str, list[dict]] | None = None,
    ) -> dict:
        conn = self._acquire()
        try:
            reply = conn.command(
                body, db=db or self.database, sequences=sequences
            )
        except ConnectionError:
            self._discard(conn)  # dead socket: next caller redials
            raise
        except Exception:
            self._release(conn)  # server-level error; socket still good
            raise
        self._release(conn)
        return reply

    # -- CRUD surface -----------------------------------------------------
    def find(self, collection: str, filter: dict | None = None) -> list[dict]:
        # pin ONE connection for the whole cursor walk: getMore is
        # server-scoped, but pinning keeps the conversation ordered and
        # matches driver sessions
        conn = self._acquire()
        try:
            reply = conn.command(
                {"find": collection, "filter": filter or {}}, db=self.database
            )
            cursor = reply["cursor"]
            docs = list(cursor["firstBatch"])
            while cursor.get("id"):
                # cursor id is type-checked server-side: must be BSON int64
                reply = conn.command(
                    {"getMore": mb.Int64(cursor["id"]), "collection": collection},
                    db=self.database,
                )
                cursor = reply["cursor"]
                docs.extend(cursor["nextBatch"])
        except ConnectionError:
            self._discard(conn)
            raise
        except Exception:
            self._release(conn)
            raise
        self._release(conn)
        return docs

    def find_one(self, collection: str, filter: dict | None = None) -> dict | None:
        reply = self._command(
            {"find": collection, "filter": filter or {}, "limit": 1}
        )
        batch = reply["cursor"]["firstBatch"]
        return batch[0] if batch else None

    def insert_one(self, collection: str, document: dict):
        doc = dict(document)
        doc.setdefault("_id", mb.ObjectId())
        self._command({"insert": collection, "documents": [doc]})
        return doc["_id"]

    def insert_many(self, collection: str, documents: list[dict]) -> list:
        docs = [dict(d) for d in documents]
        for d in docs:
            d.setdefault("_id", mb.ObjectId())
        if docs:
            # documents ride a kind-1 sequence: the command body document is
            # capped at 16MB but sequences are not, matching real drivers
            self._command(
                {"insert": collection}, sequences={"documents": docs}
            )
        return [d["_id"] for d in docs]

    def update_by_id(self, collection: str, id, update: dict) -> int:
        return self._update(collection, {"_id": id}, update, multi=False)

    def update_one(self, collection: str, filter: dict, update: dict) -> int:
        return self._update(collection, filter, update, multi=False)

    def update_many(self, collection: str, filter: dict, update: dict) -> int:
        return self._update(collection, filter, update, multi=True)

    def _update(self, collection: str, q: dict, u: dict, *, multi: bool) -> int:
        reply = self._command(
            {"update": collection, "updates": [{"q": q, "u": u, "multi": multi}]}
        )
        return int(reply.get("nModified", reply.get("n", 0)))

    def delete_one(self, collection: str, filter: dict) -> int:
        return self._delete(collection, filter, limit=1)

    def delete_many(self, collection: str, filter: dict) -> int:
        return self._delete(collection, filter, limit=0)

    def _delete(self, collection: str, q: dict, *, limit: int) -> int:
        reply = self._command(
            {"delete": collection, "deletes": [{"q": q, "limit": limit}]}
        )
        return int(reply.get("n", 0))

    def count_documents(self, collection: str, filter: dict | None = None) -> int:
        reply = self._command({"count": collection, "query": filter or {}})
        return int(reply.get("n", 0))

    def drop_collection(self, collection: str) -> None:
        try:
            self._command({"drop": collection})
        except MongoError as e:
            if e.code != 26:  # NamespaceNotFound: dropping absent is a no-op
                raise

    def health_check(self) -> dict:
        try:
            self._command({"ping": 1}, db="admin")
            return health(
                STATUS_UP, backend="mongo-wire",
                host=f"{self.host}:{self.port}", database=self.database,
            )
        except Exception as e:  # noqa: BLE001
            return health(
                STATUS_DOWN, backend="mongo-wire",
                host=f"{self.host}:{self.port}", error=str(e),
            )
