"""The Mongo datasource (counterpart of gofr_tpu/datasource/mongo/__init__.py).

A provider is not built from the config: the user constructs one and hands
it to ``App.add_mongo`` (``Container.add_mongo``), which wraps it in
``InstrumentedMongo``, injects the logger and the metrics and calls
``connect()``; handlers reach it as ``ctx.mongo``. The CRUD surface:
``find``, ``find_one``, ``insert_one``, ``insert_many``, ``update_by_id``,
``update_one``, ``update_many``, ``delete_one``, ``delete_many``,
``count_documents``, ``drop_collection``, and ``health_check``.

Providers:

- ``InMemoryMongo``: an in-process document store (the filter operators
  ``$eq/$ne/$gt/$gte/$lt/$lte/$in/$nin/$exists`` and implicit equality;
  the update operators ``$set/$inc/$unset`` and whole-document replacement
  that keeps ``_id``; ``uuid4`` hex ids; documents deep-copied on the way
  in and out, as a BSON round trip would);
- ``WireMongo`` (``.wire``, imported on first use): the OP_MSG client with
  SCRAM and TLS.
"""

from __future__ import annotations

import copy
import threading
import time
import uuid
from typing import Any, Protocol, runtime_checkable

from .. import STATUS_DOWN, STATUS_UP, health

__all__ = ["MongoProvider", "InMemoryMongo", "InstrumentedMongo", "WireMongo"]


def __getattr__(name: str):
    # the wire client and its codec load only when an app asks for them
    if name == "WireMongo":
        from .wire import WireMongo

        return WireMongo
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@runtime_checkable
class MongoProvider(Protocol):
    """The seam a provider implements."""

    def connect(self) -> None: ...
    def use_logger(self, logger) -> None: ...
    def use_metrics(self, metrics) -> None: ...
    def find(self, collection: str, filter: dict | None = None) -> list[dict]: ...
    def find_one(self, collection: str, filter: dict | None = None) -> dict | None: ...
    def insert_one(self, collection: str, document: dict) -> Any: ...
    def insert_many(self, collection: str, documents: list[dict]) -> list[Any]: ...
    def update_by_id(self, collection: str, id: Any, update: dict) -> int: ...
    def update_one(self, collection: str, filter: dict, update: dict) -> int: ...
    def update_many(self, collection: str, filter: dict, update: dict) -> int: ...
    def delete_one(self, collection: str, filter: dict) -> int: ...
    def delete_many(self, collection: str, filter: dict) -> int: ...
    def count_documents(self, collection: str, filter: dict | None = None) -> int: ...
    def drop_collection(self, collection: str) -> None: ...
    def health_check(self) -> dict: ...


# filter operator -> test of (the field's value, the operand, whether the field is present)
_FILTER_OPS = {
    "$eq": lambda val, ref, present: val == ref,
    "$ne": lambda val, ref, present: val != ref,
    "$gt": lambda val, ref, present: val is not None and val > ref,
    "$gte": lambda val, ref, present: val is not None and val >= ref,
    "$lt": lambda val, ref, present: val is not None and val < ref,
    "$lte": lambda val, ref, present: val is not None and val <= ref,
    "$in": lambda val, ref, present: val in ref,
    "$nin": lambda val, ref, present: val not in ref,
    "$exists": lambda val, ref, present: present == bool(ref),
}


def _matches(doc: dict, filter: dict | None) -> bool:
    if not filter:
        return True
    for key, cond in filter.items():
        val = doc.get(key)
        if isinstance(cond, dict) and any(k.startswith("$") for k in cond):
            for op, ref in cond.items():
                test = _FILTER_OPS.get(op)
                if test is None:
                    raise ValueError(f"unsupported mongo operator {op!r}")
                if not test(val, ref, key in doc):
                    return False
        elif val != cond:
            return False
    return True


def _apply_update(doc: dict, update: dict) -> None:
    if not any(k.startswith("$") for k in update):
        # replacement keeps the stored _id, as a server does
        _id = doc.get("_id")
        doc.clear()
        doc.update(update)
        doc["_id"] = _id
        return
    for op, fields in update.items():
        if op == "$set":
            doc.update(fields)
        elif op == "$inc":
            for k, v in fields.items():
                doc[k] = doc.get(k, 0) + v
        elif op == "$unset":
            for k in fields:
                doc.pop(k, None)
        else:
            raise ValueError(f"unsupported mongo update operator {op!r}")


class InMemoryMongo:
    """Thread-safe in-process document store implementing MongoProvider."""

    def __init__(self, database: str = "test"):
        self.database = database
        self._collections: dict[str, list[dict]] = {}
        self._lock = threading.RLock()
        self._connected = False

    def connect(self) -> None:
        self._connected = True

    def use_logger(self, logger) -> None:
        pass  # InstrumentedMongo logs

    def use_metrics(self, metrics) -> None:
        pass

    def _coll(self, name: str) -> list[dict]:
        return self._collections.setdefault(name, [])

    def find(self, collection: str, filter: dict | None = None) -> list[dict]:
        with self._lock:
            return [copy.deepcopy(d) for d in self._coll(collection) if _matches(d, filter)]

    def find_one(self, collection: str, filter: dict | None = None) -> dict | None:
        with self._lock:
            for d in self._coll(collection):
                if _matches(d, filter):
                    return copy.deepcopy(d)
        return None

    def insert_one(self, collection: str, document: dict) -> Any:
        with self._lock:
            doc = copy.deepcopy(document)
            doc.setdefault("_id", uuid.uuid4().hex)
            self._coll(collection).append(doc)
            return doc["_id"]

    def insert_many(self, collection: str, documents: list[dict]) -> list[Any]:
        return [self.insert_one(collection, d) for d in documents]

    def update_by_id(self, collection: str, id: Any, update: dict) -> int:
        return self.update_one(collection, {"_id": id}, update)

    def update_one(self, collection: str, filter: dict, update: dict) -> int:
        return self._update(collection, filter, update, multi=False)

    def update_many(self, collection: str, filter: dict, update: dict) -> int:
        return self._update(collection, filter, update, multi=True)

    def _update(self, collection: str, filter: dict, update: dict, *, multi: bool) -> int:
        n = 0
        with self._lock:
            for d in self._coll(collection):
                if _matches(d, filter):
                    _apply_update(d, update)
                    n += 1
                    if not multi:
                        break
        return n

    def delete_one(self, collection: str, filter: dict) -> int:
        with self._lock:
            coll = self._coll(collection)
            for i, d in enumerate(coll):
                if _matches(d, filter):
                    del coll[i]
                    return 1
        return 0

    def delete_many(self, collection: str, filter: dict) -> int:
        with self._lock:
            coll = self._coll(collection)
            keep = [d for d in coll if not _matches(d, filter)]
            n = len(coll) - len(keep)
            coll[:] = keep
            return n

    def count_documents(self, collection: str, filter: dict | None = None) -> int:
        with self._lock:
            return sum(1 for d in self._coll(collection) if _matches(d, filter))

    def drop_collection(self, collection: str) -> None:
        with self._lock:
            self._collections.pop(collection, None)

    def health_check(self) -> dict:
        with self._lock:
            stats = {name: len(docs) for name, docs in self._collections.items()}
        return health(STATUS_UP if self._connected else STATUS_DOWN,
                      backend="mongo-inmemory", database=self.database, collections=stats)


_OPS = (
    "find", "find_one", "insert_one", "insert_many", "update_by_id",
    "update_one", "update_many", "delete_one", "delete_many",
    "count_documents", "drop_collection",
)


class InstrumentedMongo:
    """Any MongoProvider behind one ``app_mongo_stats`` observation
    (labels ``operation`` and ``collection``) and one debug log entry per
    CRUD call; what the container holds and ``ctx.mongo`` returns. Other
    attributes pass through to the provider."""

    def __init__(self, provider, logger=None, metrics=None):
        self._provider = provider
        self.logger = logger
        self.metrics = metrics
        provider.use_logger(logger)
        provider.use_metrics(metrics)

    def __getattr__(self, name: str):
        fn = getattr(self._provider, name)
        if name not in _OPS:
            return fn

        def wrapped(collection: str, *args, **kwargs):
            t0 = time.perf_counter()
            err: Exception | None = None
            try:
                return fn(collection, *args, **kwargs)
            except Exception as e:  # noqa: BLE001 — logged, then raised as it was
                err = e
                raise
            finally:
                dt = time.perf_counter() - t0
                if self.metrics is not None:
                    self.metrics.record_histogram("app_mongo_stats", dt, operation=name, collection=collection)
                if self.logger is not None:
                    self.logger.debug({
                        "type": "mongo", "operation": name, "collection": collection,
                        "duration_us": round(dt * 1e6), **({"error": str(err)} if err else {}),
                    })

        return wrapped

    def health_check(self) -> dict:
        try:
            return self._provider.health_check()
        except Exception as e:  # noqa: BLE001 — a failing check is a DOWN report
            return health(STATUS_DOWN, backend="mongo", error=str(e))
