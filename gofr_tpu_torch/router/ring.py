"""Consistent hashing for session affinity (counterpart of
gofr_tpu/router/ring.py: rendezvous / highest-random-weight hashing).

The front router pins every ``X-GoFr-Session`` conversation to one
engine process, so the session's KV blocks stay on the process that
holds them. Each key ranks every member by ``blake2b(key, member)`` and
picks the maximum: removing a member moves exactly that member's keys,
adding one moves about ``1/(n+1)`` of them, and the full ranking
(``owners``) is the failover order. The scores are the JAX package's,
byte for byte, so both routers send a key to the same member.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Iterator

__all__ = ["HashRing"]


def _score(member: str, key: str) -> int:
    # blake2b is stable across processes (hash() is salted); 8 bytes rank
    # a small fleet
    return int.from_bytes(hashlib.blake2b(key.encode() + b"\x00" + member.encode(), digest_size=8).digest(), "big")


class HashRing:
    """Rendezvous-hash membership set. Immutable: the fleet view swaps
    whole instances on a membership change, so readers never see a
    half-updated ring."""

    def __init__(self, members: Iterable[str] = ()):
        self._members: tuple[str, ...] = tuple(dict.fromkeys(members))

    @property
    def members(self) -> tuple[str, ...]:
        return self._members

    def __len__(self) -> int:
        return len(self._members)

    def owner(self, key: str) -> str | None:
        """The member owning `key`, or None on an empty ring."""
        if not self._members:
            return None
        return max(self._members, key=lambda m: _score(m, key))

    def owners(self, key: str) -> Iterator[str]:
        """Every member ranked best-first for `key`: the fallthrough order
        when the owner is draining or dead."""
        return iter(sorted(self._members, key=lambda m: _score(m, key), reverse=True))

    def with_member(self, member: str) -> "HashRing":
        if member in self._members:
            return self
        return HashRing((*self._members, member))

    def without_member(self, member: str) -> "HashRing":
        if member not in self._members:
            return self
        return HashRing(m for m in self._members if m != member)
