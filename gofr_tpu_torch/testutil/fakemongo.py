"""An in-process MongoDB server speaking the wire protocol (counterpart of
gofr_tpu/testutil/fakemongo.py): ``FakeMongoServer`` parses OP_MSG frames
with the client's own codec (``datasource.mongo.mongoproto``), runs each
command against an ``InMemoryMongo`` and replies with a server's reply
shapes ({ok: 0, errmsg, code} and writeErrors), so that ``WireMongo`` is
tested end to end over a real socket without a mongod.

Commands: hello, ping, find (cursor batches of ``batch_size``, default
101, and getMore), insert, update, delete, count, drop; saslStart and
saslContinue when ``users`` is given (SCRAM-SHA-256, or SCRAM-SHA-1 over
md5("user:mongo:password") hex, verified with the port's ``ScramServer``;
every other command is refused with code 13 until the conversation is
done). ``tls=True`` serves over ``testutil.self_signed_cert()``.
"""

from __future__ import annotations

import hashlib
import itertools
import socket
import threading

from ..datasource.mongo import InMemoryMongo
from ..datasource.mongo import mongoproto as mb
from ..datasource.scram import ScramError, ScramServer

__all__ = ["FakeMongoServer"]


class FakeMongoServer:
    """Minimal mongod stand-in. A small ``batch_size`` forces cursor paging
    so the client's getMore path runs. ``close`` stops accepting and drops
    the open connections, as a server that goes down does."""

    def __init__(
        self,
        batch_size: int = 101,
        users: dict[str, str] | None = None,
        tls: bool = False,
    ):
        self.store = InMemoryMongo()
        self.store.connect()
        self.batch_size = batch_size
        # users set -> connections must complete a SCRAM conversation
        # (saslStart/saslContinue) before running CRUD, like a mongod with
        # auth enabled; tls -> serve over testutil.self_signed_cert()
        self.users = users
        self.tls = tls
        self._cursors: dict[int, list[dict]] = {}
        self._cursor_ids = itertools.count(1)
        self._lock = threading.Lock()
        self._conns: set = set()  # the served sockets, dropped at close
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._closed = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    # -- plumbing ----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        if self.tls:
            from . import server_tls_context

            try:
                conn = server_tls_context().wrap_socket(conn, server_side=True)
            except OSError:
                conn.close()
                return
        with self._lock:
            if self._closed:
                conn.close()
                return
            self._conns.add(conn)

        def recv_exact(n: int) -> bytes:
            buf = b""
            while len(buf) < n:
                chunk = conn.recv(n - len(buf))
                if not chunk:
                    raise ConnectionError("client closed")
                buf += chunk
            return buf

        state = {"authed": self.users is None, "scram": None}
        try:
            while True:
                frame = mb.read_message(recv_exact)
                rid, _, body = mb.decode_op_msg(frame)
                try:
                    reply = self._execute(body, state)
                except _CommandError as e:
                    reply = {"ok": 0.0, "errmsg": e.args[0], "code": e.code}
                conn.sendall(
                    mb.encode_op_msg(
                        reply, request_id=next(self._cursor_ids) + 1_000_000,
                        response_to=rid,
                    )
                )
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    # -- command dispatch --------------------------------------------------
    def _execute(self, body: dict, state: dict | None = None) -> dict:
        state = state if state is not None else {"authed": True, "scram": None}
        db = body.get("$db", "test")
        if "hello" in body or "isMaster" in body:
            return {
                "ok": 1.0, "isWritablePrimary": True,
                "maxWireVersion": 17, "minWireVersion": 0,
                "maxBsonObjectSize": 16 * 1024 * 1024,
            }
        if "ping" in body:
            return {"ok": 1.0}
        if "saslStart" in body or "saslContinue" in body:
            return self._sasl(body, state)
        if not state["authed"]:
            # mongod with auth enabled: everything else is Unauthorized
            raise _CommandError("command requires authentication", 13)
        if "find" in body:
            return self._find(db, body)
        if "getMore" in body:
            return self._get_more(db, body)
        if "insert" in body:
            return self._insert(body)
        if "update" in body:
            return self._update(body)
        if "delete" in body:
            return self._delete(body)
        if "count" in body:
            n = self.store.count_documents(body["count"], body.get("query"))
            return {"ok": 1.0, "n": n}
        if "drop" in body:
            with self._lock:
                if body["drop"] not in self.store._collections:
                    raise _CommandError("ns not found", 26)
            self.store.drop_collection(body["drop"])
            return {"ok": 1.0, "nIndexesWas": 1}
        raise _CommandError(f"no such command: {next(iter(body))!r}", 59)

    def _sasl(self, body: dict, state: dict) -> dict:
        """SCRAM conversation (saslStart/saslContinue), mongod reply
        shapes: {conversationId, payload, done, ok}."""
        if self.users is None:
            raise _CommandError("authentication not enabled", 18)
        try:
            if "saslStart" in body:
                mech = str(body.get("mechanism", ""))
                users = self.users
                if mech == "SCRAM-SHA-1":
                    # MongoDB's SHA-1 flow uses md5(user:mongo:pwd) hex as
                    # the effective SCRAM password (drivers' auth spec)
                    users = {
                        u: hashlib.md5(f"{u}:mongo:{p}".encode()).hexdigest()
                        for u, p in users.items()
                    }
                state["scram"] = ScramServer(mech, users)
                server_first = state["scram"].process_client_first(
                    bytes(body["payload"]).decode()
                )
                return {
                    "ok": 1.0, "conversationId": 1, "done": False,
                    "payload": server_first.encode(),
                }
            if state["scram"] is None:
                raise _CommandError("no SASL conversation in progress", 17)
            payload = bytes(body.get("payload", b""))
            if not payload:  # empty final round (no skipEmptyExchange)
                return {"ok": 1.0, "conversationId": 1, "done": True,
                        "payload": b""}
            server_final = state["scram"].process_client_final(payload.decode())
            state["authed"] = True
            return {
                "ok": 1.0, "conversationId": 1, "done": True,
                "payload": server_final.encode(),
            }
        except ScramError as e:
            raise _CommandError(f"Authentication failed: {e}", 18) from e

    def _find(self, db: str, body: dict) -> dict:
        coll = body["find"]
        docs = self.store.find(coll, body.get("filter"))
        limit = int(body.get("limit", 0))
        if limit:
            docs = docs[:limit]
        first, rest = docs[: self.batch_size], docs[self.batch_size :]
        cursor_id = 0
        if rest:
            with self._lock:
                cursor_id = next(self._cursor_ids)
                self._cursors[cursor_id] = rest
        return {
            "ok": 1.0,
            "cursor": {"firstBatch": first, "id": cursor_id, "ns": f"{db}.{coll}"},
        }

    def _get_more(self, db: str, body: dict) -> dict:
        cid = body["getMore"]
        with self._lock:
            rest = self._cursors.pop(cid, None)
        if rest is None:
            raise _CommandError(f"cursor id {cid} not found", 43)
        batch, rest = rest[: self.batch_size], rest[self.batch_size :]
        new_id = 0
        if rest:
            with self._lock:
                new_id = next(self._cursor_ids)
                self._cursors[new_id] = rest
        return {
            "ok": 1.0,
            "cursor": {
                "nextBatch": batch, "id": new_id,
                "ns": f"{db}.{body['collection']}",
            },
        }

    def _insert(self, body: dict) -> dict:
        coll = body["insert"]
        n = 0
        write_errors = []
        for i, doc in enumerate(body.get("documents", [])):
            if "_id" in doc and self.store.find_one(coll, {"_id": doc["_id"]}):
                write_errors.append(
                    {"index": i, "code": 11000, "errmsg": "E11000 duplicate key"}
                )
                continue
            self.store.insert_one(coll, doc)
            n += 1
        reply = {"ok": 1.0, "n": n}
        if write_errors:
            reply["writeErrors"] = write_errors
        return reply

    def _update(self, body: dict) -> dict:
        coll = body["update"]
        n = 0
        for u in body.get("updates", []):
            q, doc, multi = u.get("q", {}), u.get("u", {}), u.get("multi", False)
            # delegate to the store's own update methods so wire and
            # in-memory backends share one query/update-semantics impl
            if multi:
                n += self.store.update_many(coll, q, doc)
            else:
                n += self.store.update_one(coll, q, doc)
        return {"ok": 1.0, "n": n, "nModified": n}

    def _delete(self, body: dict) -> dict:
        coll = body["delete"]
        n = 0
        for d in body.get("deletes", []):
            q, limit = d.get("q", {}), d.get("limit", 0)
            if limit == 1:
                n += self.store.delete_one(coll, q)
            else:
                n += self.store.delete_many(coll, q)
        return {"ok": 1.0, "n": n}


class _CommandError(Exception):
    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code
