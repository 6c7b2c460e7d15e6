"""Session tier: conversation id -> resident KV, with a host-RAM spill
(counterpart of gofr_tpu/kvcache/sessions.py, copied: host-only
bookkeeping).

Between turns a conversation's KV is pure state. This module keeps idle
sessions warm without holding device memory:

- :class:`SessionStore` — ``X-GoFr-Session`` id -> the radix leaf holding
  the conversation's published KV blocks (prompt + emitted tokens). A
  resident session costs only its pool blocks, deduplicated against every
  other session and prompt sharing its prefix.
- LRU spill: when resident session bytes exceed the device budget
  (``session_mb``), the coldest sessions' blocks are fetched to host
  buffers (:class:`HostOffload`, ``host_cache_mb``) and their device
  blocks released. The next turn restores them block-wise (host to device,
  re-inserted into the radix tree), byte-identically.
- Eviction from the host tier (budget pressure) forgets the session: the
  next turn pays a full re-prefill. Sessions degrade, never break.

All mutation happens under the CacheManager lock; the engine owns the
device transfers and calls back into these classes for bookkeeping only.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any

__all__ = ["HostOffload", "SessionStore", "Session"]


class HostOffload:
    """Host-RAM spill tier: session id -> fetched block payloads, LRU
    under a byte budget. A payload is a dict of host tensors (k/v block
    stacks, optional int8 scales) plus the token sequence and tail length
    — what the engine needs to rebuild pool blocks byte-identically."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._data: OrderedDict[str, tuple[dict, int]] = OrderedDict()
        self.spilled_bytes = 0
        self.spills = 0
        self.restores = 0
        self.expired = 0  # sessions dropped by host-budget pressure

    def store(self, sid: str, payload: dict, nbytes: int) -> list[str]:
        """Retain a spilled session; returns the ids EXPIRED to make
        room (the caller forgets them — next turn is a full re-prefill).
        A payload larger than the whole budget is refused the same way
        (returned as its own expiry)."""
        nbytes = int(nbytes)
        if nbytes > self.budget_bytes:
            self.expired += 1
            return [sid]
        self._data.pop(sid, None)
        self._data[sid] = (payload, nbytes)
        self.spilled_bytes = sum(n for _, n in self._data.values())
        self.spills += 1
        dropped: list[str] = []
        while self.spilled_bytes > self.budget_bytes and self._data:
            old_sid, (_, n) = next(iter(self._data.items()))
            if old_sid == sid and len(self._data) == 1:
                break
            self._data.pop(old_sid)
            self.spilled_bytes -= n
            self.expired += 1
            dropped.append(old_sid)
        return dropped

    def fetch(self, sid: str) -> dict | None:
        """Pop a spilled session's payload (restore consumes it)."""
        item = self._data.pop(sid, None)
        if item is None:
            return None
        payload, n = item
        self.spilled_bytes -= n
        self.restores += 1
        return payload

    def drop(self, sid: str) -> None:
        item = self._data.pop(sid, None)
        if item is not None:
            self.spilled_bytes -= item[1]

    def stats(self) -> dict:
        return {
            "entries": len(self._data),
            "spilled_bytes": self.spilled_bytes,
            "budget_bytes": self.budget_bytes,
            "spills": self.spills,
            "restores": self.restores,
            "expired": self.expired,
        }


class Session:
    __slots__ = (
        "id", "tokens", "node", "end_key", "device_bytes",
        "last_use", "turns", "state",
    )

    def __init__(self, sid: str):
        self.id = sid
        self.tokens: list[int] = []
        self.node: Any = None  # pinned radix leaf while device-resident
        self.end_key: tuple = ()
        self.device_bytes = 0
        self.last_use = time.monotonic()
        self.turns = 0
        self.state = "new"  # new -> resident -> spilled (-> resident ...)


class SessionStore:
    """Conversation registry over the radix tree. Publishing pins the
    conversation's leaf (eviction cannot reclaim a live session's
    blocks); the device budget decides WHEN cold sessions spill, the
    engine decides HOW (it owns the device arrays)."""

    def __init__(self, device_budget_bytes: int, offload: HostOffload):
        self.device_budget = int(device_budget_bytes)
        self.offload = offload
        self.entries: dict[str, Session] = {}
        self.publishes = 0
        self.resumes = 0  # second-turn submissions that found the session

    def get(self, sid: str) -> Session | None:
        return self.entries.get(sid)

    def publish(self, sid: str, tokens, node, end_key, device_bytes: int, radix) -> None:
        """Record a finished turn: pin the new leaf, release the old one
        (its blocks usually survive anyway — they prefix the new leaf)."""
        s = self.entries.get(sid)
        if s is None:
            s = Session(sid)
            self.entries[sid] = s
        if s.node is not None:
            radix.unpin(s.node)
        s.tokens = list(tokens)
        s.node = node
        s.end_key = end_key
        s.device_bytes = int(device_bytes)
        s.last_use = time.monotonic()
        s.turns += 1
        s.state = "resident"
        self.offload.drop(sid)  # a stale spilled copy must not resurrect
        self.publishes += 1

    def resident_bytes(self) -> int:
        return sum(s.device_bytes for s in self.entries.values() if s.state == "resident")

    def spill_candidates(self, exclude: set[str] | None = None) -> list[Session]:
        """Coldest-first resident sessions to spill until the device
        budget holds. Returns the list; the engine performs the fetches
        and then calls mark_spilled per session."""
        exclude = exclude or set()
        over = self.resident_bytes() - self.device_budget
        if over <= 0:
            return []
        cands = sorted(
            (s for s in self.entries.values()
             if s.state == "resident" and s.id not in exclude and s.node is not None),
            key=lambda s: s.last_use,
        )
        out: list[Session] = []
        for s in cands:
            if over <= 0:
                break
            out.append(s)
            over -= s.device_bytes
        return out

    def mark_spilled(self, sid: str, radix) -> None:
        s = self.entries.get(sid)
        if s is None:
            return
        if s.node is not None:
            radix.unpin(s.node)
            s.node = None
        s.device_bytes = 0
        s.state = "spilled"

    def forget(self, sid: str, radix) -> None:
        s = self.entries.pop(sid, None)
        if s is not None and s.node is not None:
            radix.unpin(s.node)
        self.offload.drop(sid)

    def clear(self, radix) -> None:
        for sid in list(self.entries):
            self.forget(sid, radix)

    def stats(self) -> dict:
        resident = sum(1 for s in self.entries.values() if s.state == "resident")
        spilled = sum(1 for s in self.entries.values() if s.state == "spilled")
        return {
            "sessions": len(self.entries),
            "resident": resident,
            "spilled": spilled,
            "resident_bytes": self.resident_bytes(),
            "device_budget_bytes": self.device_budget,
            "publishes": self.publishes,
            "resumes": self.resumes,
            "offload": self.offload.stats(),
        }
