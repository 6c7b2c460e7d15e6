"""KV memory manager (counterpart of gofr_tpu/kvcache).

``CacheManager`` picks the engine's KV layout as the JAX one does:

- **paged** (the serving default for global-attention models): one pool
  of ``block``-row blocks, bf16/f32 or int8 rows, read and written through
  per-slot block tables, with its radix prefix index and session tier;
- **contiguous** (``paged=False``, or ``"auto"`` on a windowed model):
  the ROLLING ring [L, slots, window + append_slack, hkv, hd] when the
  model has a sliding window and window + slack < max_seq_len (a slot
  costs O(window) rows, not O(max_seq_len)), else the dense slab [L,
  slots, max_seq_len, hkv, hd]. Rows are stored in the model dtype (no
  int8), with no pool, radix tree or sessions. Prefix reuse there is the
  whole-row ``PrefixCache`` (``prefix_cache_mb`` > 0): a finished
  prompt's slot rows and last-token logits, cloned, refcounted and
  LRU-evicted under a byte budget.

The wave scheduler (``step_token_budget=0``) prefills whole prompts into a
bucket-wide cache; ``pack_prefill`` makes it a slot's layout (``ring_pack``
on the ring).

``paged="auto"`` (``paged_default()``, from ``TPU_LLM_KV_PAGED``) is
contiguous exactly when the ring engages and no session tier is asked
for. The paged sizing rules:

- ``table_width = ceil(max_seq_len / block)`` entries per slot table;
- ``capacity = table_width * block`` logical rows per slot;
- ``pool_blocks = slots * table_width`` (every slot fully grown, no
  sharing) plus the blocks of the retention budget (``prefix_cache_mb``)
  and of the session budget (``session_mb``), unless ``pool_blocks``
  (``TPU_LLM_KV_POOL_BLOCKS``) names a count;
- one ``append_slack`` term (the widest append one device program can
  make) in every admission reservation, and in the ring's capacity.

Sharing is on when either budget is above 0: admission consults the radix
tree (``lookup_seed``), a slot's table points at shared full prefix
blocks in place (``attach_seed``), and finished prompts and session turns
are published into it (``publish_plan`` / ``publish_commit``). Host
tables grow as each cursor advances (``ensure``) and return their blocks
on ``release_slot``; the device pool tensors are [L, n_blocks, block,
hkv, hd] (plus [2, L, n_blocks, block, hkv] float32 scales for an int8
pool) and belong to the engine, which performs every device copy.

Each knob left None reads the JAX engine's env fallback with its default
and parsing: ``block`` ``TPU_LLM_KV_BLOCK`` (16, the paged layout
only), ``session_mb`` ``TPU_LLM_SESSION_MB`` (0; read before
``"auto"`` resolves), ``kv_int8`` ``TPU_LLM_KV_INT8`` (off unless set and
not "0"), ``host_cache_mb`` ``TPU_LLM_HOST_CACHE_MB`` (256) and
``pool_blocks`` ``TPU_LLM_KV_POOL_BLOCKS`` (0: the worst case above).

Threading: the scheduler thread mutates; the collector releases slots;
``stats()`` readers may come from anywhere. Every mutation of the pool,
the tables, the radix and the sessions happens under ``_lock``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import Counter, OrderedDict
from typing import Any, NamedTuple

import numpy as np
import torch

from .paged import (
    BlockPool,
    PoolExhausted,
    RadixTree,
    SlotTable,
    copy_blocks,
    dequantize_rows,
    gather_blocks_host,
    gather_slots,
    quantize_rows,
    scatter_rows,
)
from .sessions import HostOffload, SessionStore

__all__ = [
    "BlockPool", "CacheManager", "paged_default", "PoolExhausted", "PrefixCache", "RadixTree", "SeedPlan",
    "SlotTable", "copy_blocks", "dequantize_rows", "gather_blocks_host", "gather_slots", "quantize_rows",
    "ring_pack", "scatter_rows",
]

_MB = 1024 * 1024

# Serializes app_kvcache_* registration across engines (a fleet builds its
# replicas on parallel threads).
_METRICS_REG_LOCK = threading.Lock()


def _count_event(metrics, model: str, event: str, name: str = "app_kvcache_events") -> None:
    if metrics is not None:
        metrics.increment_counter(name, 1.0, model=model, event=event)


def ring_pack(cache, capacity: int):
    """A position-indexed prefill cache [L, b, s, hkv, hd] re-laid as a
    ring of ``capacity`` rows (JAX ``ring_pack``): row j holds the newest
    prompt position congruent to j mod capacity (``ring_positions``), so
    the newest ``capacity`` rows survive; rows never written are zeroed.
    One gather per k and v; lengths stay absolute."""
    from ..models.transformer import KVCache
    from ..ops.attention import ring_positions

    L, b, s, h, d = cache.k.shape
    pos = ring_positions(cache.length, capacity)  # [b, C]
    valid = (pos >= 0)[None, :, :, None, None]
    idx = pos.long().clamp(0, s - 1)[None, :, :, None, None].expand(L, b, capacity, h, d)

    def take(a):
        return torch.where(valid, torch.gather(a, 2, idx), torch.zeros((), dtype=a.dtype, device=a.device))

    return KVCache(k=take(cache.k), v=take(cache.v), length=cache.length)


class _Entry:
    """One retained prompt: its slot rows k/v [L, 1, rows, hkv, hd] and
    last-token logits [1, vocab] f32, each a private copy."""

    __slots__ = ("key", "k", "v", "length", "logits", "nbytes", "refs")

    def __init__(self, key, k, v, length, logits, nbytes):
        self.key = key
        self.k = k
        self.v = v
        self.length = length  # absolute prompt length
        self.logits = logits
        self.nbytes = nbytes
        self.refs = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class PrefixCache:
    """Prompt -> retained slot rows, refcounted, LRU-evicted under a byte
    budget (JAX ``PrefixCache``, the contiguous layouts' prefix index).

    A lookup PINS its entry (refs += 1) until the engine releases it, so
    eviction never frees rows an admission is about to insert. Eviction
    is strict LRU over unpinned entries whenever resident bytes exceed the
    budget; an entry larger than the whole budget is refused. Bytes count
    as in JAX (k, v and logits), so one budget evicts the same entries.

    ``put`` CLONES the rows and the logits row it is given: the engine
    passes views of its slab (a reused slot would rewrite them) or of a
    graph's static output (the next replay would). The clone is enqueued
    on the caller's stream, after the program that wrote them. A hit's
    rows go straight into its slot (the engine's ``_insert_rows``), so
    JAX's ``assemble`` into a capacity-wide wave has no counterpart.

    Thread-safe: the scheduler mutates while stats() readers come from
    anywhere."""

    def __init__(self, capacity_bytes: int, metrics=None, model: str = "llm"):
        self.capacity_bytes = int(capacity_bytes)
        self.metrics = metrics
        self.model = model
        self._entries: OrderedDict[bytes, _Entry] = OrderedDict()
        self._lengths: Counter[int] = Counter()  # distinct stored lengths, refcounted
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.partial_hits = 0
        self.evictions = 0
        self.stores = 0
        self.resident_bytes = 0

    @staticmethod
    def key_for(tokens) -> bytes:
        """Exact-content key: the int32 bytes of the token sequence."""
        return np.asarray(tokens, np.int32).tobytes()

    def lookup(self, key: bytes) -> _Entry | None:
        """Hit: move to MRU, pin, return the entry. Miss: count, None."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
            else:
                self._entries.move_to_end(key)
                e.refs += 1
                self.hits += 1
        _count_event(self.metrics, self.model, "miss" if e is None else "hit")
        return e

    def lookup_longest(self, tokens, *, allow_partial: bool = True) -> tuple[_Entry | None, bool]:
        """(entry, exact) for the longest stored prompt that prefixes
        ``tokens``: an exact hit skips prefill; a partial hit's rows seed
        the slot and its prefill cursor starts at ``entry.length``.
        ``allow_partial=False`` probes the whole prompt only (a ring's rows
        are laid out for the entry's own length and serve no shorter one).
        The key of tokens[:n] is key[:4n], so one probe per distinct
        stored length, longest first; partial hits have their own counter."""
        key = self.key_for(tokens)
        e = self.lookup(key)
        if e is not None:
            return e, True
        if not allow_partial:
            return None, False
        n = len(key) // 4
        with self._lock:
            for length in sorted((ln for ln in self._lengths if ln < n), reverse=True):
                e = self._entries.get(key[: 4 * length])
                if e is None:
                    continue
                self._entries.move_to_end(e.key)
                e.refs += 1
                self.partial_hits += 1
                break
            else:
                return None, False
        _count_event(self.metrics, self.model, "partial_hit")
        return e, False

    def release(self, entry: _Entry) -> None:
        with self._lock:
            entry.refs -= 1

    def put(self, key: bytes, k, v, length: int, logits) -> bool:
        """Retain a private copy of a prompt's rows and logits; False when
        skipped (duplicate key, or larger than the whole budget)."""
        nbytes = _nbytes(k) + _nbytes(v) + _nbytes(logits)
        evicted = 0
        with self._lock:
            if key in self._entries or nbytes > self.capacity_bytes:
                return False
            self._entries[key] = _Entry(key, k.clone(), v.clone(), int(length), logits.clone(), nbytes)
            self._lengths[int(length)] += 1
            self.resident_bytes += nbytes
            self.stores += 1
            while self.resident_bytes > self.capacity_bytes:
                victim = next((ky for ky, e in self._entries.items() if e.refs == 0), None)
                if victim is None:  # everything pinned: over budget until released
                    break
                ve = self._entries.pop(victim)
                self.resident_bytes -= ve.nbytes
                self._lengths[ve.length] -= 1
                if not self._lengths[ve.length]:
                    del self._lengths[ve.length]
                self.evictions += 1
                evicted += 1
        _count_event(self.metrics, self.model, "store")
        for _ in range(evicted):
            _count_event(self.metrics, self.model, "eviction")
        self._gauge()
        return True

    def _gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.set_gauge(
                "app_kvcache_resident_bytes", float(self.resident_bytes), model=self.model, kind="prefix",
            )

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._lengths.clear()
            self.resident_bytes = 0
        self._gauge()

    def pinned(self) -> int:
        """Entries some admission still pins (0 once the engine is idle)."""
        with self._lock:
            return sum(1 for e in self._entries.values() if e.refs)

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "partial_hits": self.partial_hits,
                "evictions": self.evictions,
                "stores": self.stores,
                "entries": len(self._entries),
                "resident_bytes": self.resident_bytes,
                "capacity_bytes": self.capacity_bytes,
            }


class SeedPlan(NamedTuple):
    """Admission-time radix consult result."""

    blocks: list  # shared full prefix blocks, in table order
    shared: int  # tokens covered by `blocks` (block-aligned)
    exact: bool  # an end record with logits matched the WHOLE prompt
    tail_src: int  # end record's copied tail block (-1 = none)
    tail_len: int  # valid rows in the tail block
    logits: Any  # stored last-token logits (exact hits skip prefill)


def paged_default():
    """The engine's default layout: ``"auto"`` unless ``TPU_LLM_KV_PAGED``
    is "0", which asks for the contiguous layouts (JAX
    ``paged_default``). ``"auto"`` resolves per model in CacheManager:
    paged for global-attention models, the rolling ring for a windowed
    model where it engages (the paged pool reclaims no block behind the
    window, so paging there would trade the ring's O(window) slot bound
    for O(max_seq_len)); ``paged=True`` pages a windowed model anyway."""
    return "auto" if os.environ.get("TPU_LLM_KV_PAGED", "1") != "0" else False


class CacheManager:
    """KV bookkeeping for one engine. Paged: pool, slot tables and (with a
    retention or session budget) the radix tree and sessions. Contiguous
    (``paged=False``, or ``"auto"`` where the ring engages and
    ``session_mb`` is 0): the slab's geometry only, ``rolling``,
    ``capacity`` (window + append_slack when rolling, else max_seq_len),
    ``ring`` (the capacity when rolling, else 0), ``slot_bytes``,
    ``init_cache`` and, with ``prefix_cache_mb`` > 0, the whole-row
    ``prefix`` (a ``PrefixCache``; None otherwise and on the paged layout).

    ``window=None`` adopts ``cfg.sliding_window``; ``window=0`` forces the
    dense slab on a windowed model (the JAX rolling-vs-dense lever); any
    other value must equal the config's window. ``append_widths``: every
    width one program can append (chunk shapes, the verify width); their
    max with ``decode_chunk`` is the one slack term both layouts budget.
    ``kv_int8``, ``session_mb``, ``host_cache_mb`` and ``pool_blocks`` left
    None read their env fallbacks (the module docstring)."""

    def __init__(
        self,
        cfg,
        slots: int,
        max_seq_len: int,
        decode_chunk: int,
        *,
        window: int | None = None,
        append_widths: tuple = (),
        paged=True,
        block: int | None = None,
        pool_blocks: int | None = None,
        kv_int8: bool | None = None,
        prefix_cache_mb: float = 0.0,
        session_mb: float | None = None,
        host_cache_mb: float | None = None,
        metrics=None,
        model: str = "llm",
    ):
        self.cfg = cfg
        self.slots = slots
        self.metrics = metrics
        self.model = model
        self.max_seq_len = max_seq_len
        w = cfg.sliding_window if window is None else window
        if w and w != cfg.sliding_window:
            raise ValueError(
                f"kv window {w} must match cfg.sliding_window {cfg.sliding_window} (attention masks use the config)"
            )
        self.window = int(w or 0)
        self.append_slack = max(tuple(int(x) for x in append_widths) + (int(decode_chunk),))
        would_roll = 0 < self.window and self.window + self.append_slack < max_seq_len
        env = os.environ.get
        if session_mb is None:  # read before "auto" resolves, as in JAX
            session_mb = float(env("TPU_LLM_SESSION_MB", "0") or 0.0)
        if kv_int8 is None:
            kv_int8 = env("TPU_LLM_KV_INT8", "0") not in ("", "0")
        if host_cache_mb is None:
            host_cache_mb = float(env("TPU_LLM_HOST_CACHE_MB", "256") or 0.0)
        if pool_blocks is None:
            pool_blocks = int(env("TPU_LLM_KV_POOL_BLOCKS", "0"))
        if paged == "auto":
            # the ring keeps its O(window) slot bound unless the session
            # tier, which only the paged pool provides, is asked for
            paged = not would_roll or session_mb > 0
        self.paged = bool(paged)
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        self._lock = threading.Lock()
        if not self.paged:
            if kv_int8:
                logging.getLogger(__name__).warning(
                    "kv_int8 ignored: the contiguous KV layout stores rows in the model dtype"
                )
            self.rolling = would_roll
            self.capacity = self.window + self.append_slack if self.rolling else max_seq_len
            self.ring = self.capacity if self.rolling else 0  # 0: the dense slab
            self.slot_bytes = 2 * cfg.n_layers * slots * self.capacity * cfg.n_kv_heads * cfg.head_dim * itemsize
            self.block = self.table_width = 0
            self.int8 = self.share = False
            self.pool = self.radix = self.sessions = None
            self.prefix = PrefixCache(int(prefix_cache_mb * _MB), metrics, model) if prefix_cache_mb > 0 else None
            self._register_metrics()
            return
        self.prefix = None  # the radix tree is the paged layout's prefix index
        self.rolling = False
        self.ring = 0
        self.block = int(block if block is not None else env("TPU_LLM_KV_BLOCK", "16"))
        self.table_width = -(-max_seq_len // self.block)
        self.capacity = self.table_width * self.block
        self.int8 = bool(kv_int8)
        kv_itemsize = 1 if self.int8 else itemsize
        rows = 2 * cfg.n_layers * self.block * cfg.n_kv_heads
        # an int8 row carries one float32 scale per (row, KV head)
        self.block_bytes = rows * cfg.head_dim * kv_itemsize + (rows * 4 if self.int8 else 0)
        retain_bytes = int(prefix_cache_mb * _MB)
        session_bytes = int(session_mb * _MB)
        # worst case with zero sharing (every slot fully grown), plus the
        # retained-prefix and session budgets, unless a count is named
        n_blocks = int(pool_blocks) or (
            slots * self.table_width + -(-retain_bytes // self.block_bytes) + -(-session_bytes // self.block_bytes)
        )
        self.pool = BlockPool(n_blocks, self.block, self.block_bytes)
        self._slot_tables = [SlotTable(self.table_width) for _ in range(slots)]
        self._tables_np = np.zeros((slots, self.table_width), np.int32)
        self.tables_dirty = True
        # sharing is on with a retention budget OR when the session tier
        # wants the radix as its index
        self.share = retain_bytes > 0 or session_bytes > 0
        self.radix = RadixTree(self.pool, self.block, retain_bytes) if self.share else None
        self.sessions = (
            SessionStore(session_bytes, HostOffload(int(host_cache_mb * _MB))) if session_bytes > 0 else None
        )
        self._register_metrics()

    def _register_metrics(self) -> None:
        """The ``app_kvcache_*`` series (JAX kvcache/__init__.py:492-535):
        events and resident bytes on every layout, the pool's block,
        spill and session series on the paged one."""
        metrics = self.metrics
        if metrics is None:
            return
        with _METRICS_REG_LOCK:
            if not metrics.has("app_kvcache_events"):
                metrics.new_counter("app_kvcache_events", "kv-cache events (event=hit|miss|store|eviction)")
            if not metrics.has("app_kvcache_resident_bytes"):
                metrics.new_gauge("app_kvcache_resident_bytes", "resident kv bytes (kind=slots|prefix)")
            if self.paged:
                for name, desc in (
                    ("app_kvcache_blocks_in_use", "KV pool blocks with refcount > 0"),
                    ("app_kvcache_blocks_shared", "KV pool blocks with refcount > 1 (prefix sharing)"),
                    ("app_kvcache_spilled_bytes", "session KV bytes spilled to the host tier"),
                    ("app_kvcache_session_count", "sessions tracked (state=resident|spilled)"),
                ):
                    if not metrics.has(name):
                        metrics.new_gauge(name, desc)
                if not metrics.has("app_kvcache_session_events"):
                    metrics.new_counter(
                        "app_kvcache_session_events",
                        "session lifecycle events (event=publish|resume|spill|restore|expire)",
                    )
        self._update_gauges()
        if not self.paged:
            metrics.set_gauge("app_kvcache_resident_bytes", float(self.slot_bytes), model=self.model, kind="slots")

    def _count(self, event: str) -> None:
        _count_event(self.metrics, self.model, event)

    def _count_session(self, event: str) -> None:
        _count_event(self.metrics, self.model, event, "app_kvcache_session_events")

    def _update_gauges(self) -> None:
        """The pool's gauges (JAX ``_update_gauges``): host reads, under the
        manager's lock at its callers."""
        m = self.metrics
        if m is None or not self.paged:
            return
        m.set_gauge("app_kvcache_resident_bytes", float(self.pool.bytes_in_use()), model=self.model, kind="slots")
        if self.radix is not None:
            m.set_gauge("app_kvcache_resident_bytes", float(self.radix.owned_bytes), model=self.model, kind="prefix")
        m.set_gauge("app_kvcache_blocks_in_use", float(self.pool.blocks_in_use()), model=self.model)
        m.set_gauge("app_kvcache_blocks_shared", float(self.pool.blocks_shared()), model=self.model)
        if self.sessions is not None:
            st = self.sessions.stats()
            m.set_gauge("app_kvcache_spilled_bytes", float(st["offload"]["spilled_bytes"]), model=self.model)
            m.set_gauge("app_kvcache_session_count", float(st["resident"]), model=self.model, state="resident")
            m.set_gauge("app_kvcache_session_count", float(st["spilled"]), model=self.model, state="spilled")

    def close(self) -> None:
        """Zero the series of a closed engine's cache: a stale gauge would
        keep reporting its KV bytes as resident (JAX ``close``)."""
        m = self.metrics
        if m is None:
            return
        for kind in ("slots", "prefix"):
            m.set_gauge("app_kvcache_resident_bytes", 0.0, model=self.model, kind=kind)
        if self.paged:
            for name in ("app_kvcache_blocks_in_use", "app_kvcache_blocks_shared", "app_kvcache_spilled_bytes"):
                m.set_gauge(name, 0.0, model=self.model)
            for state in ("resident", "spilled"):
                m.set_gauge("app_kvcache_session_count", 0.0, model=self.model, state=state)

    def init_cache(self, rows: int, device):
        """A zeroed contiguous cache of ``rows`` slots at the planned
        capacity: k/v [L, rows, capacity, hkv, hd] in the model dtype and
        lengths [rows] (JAX ``init_cache``). The engine owns it."""
        from ..models.transformer import KVCache

        cfg = self.cfg
        shape = (cfg.n_layers, rows, self.capacity, cfg.n_kv_heads, cfg.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=device),
            length=torch.zeros((rows,), dtype=torch.int32, device=device),
        )

    def pack_prefill(self, cache):
        """A freshly prefilled cache in the slot layout: ring-packed on the
        ring, as it stands otherwise."""
        return ring_pack(cache, self.capacity) if self.rolling else cache

    def pool_tensors(self, device):
        """Zeroed device pool [L, n_blocks, block, hkv, hd] (int8 when
        ``kv_int8``, else the model dtype) plus per-slot lengths, and the
        int8 pool's zeroed float32 scales [2, L, n_blocks, block, hkv]
        (None otherwise). The engine owns these tensors."""
        from ..models.transformer import KVCache

        cfg = self.cfg
        shape = (cfg.n_layers, self.pool.n_blocks, self.block, cfg.n_kv_heads, cfg.head_dim)
        dtype = torch.int8 if self.int8 else cfg.dtype
        cache = KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros((self.slots,), dtype=torch.int32, device=device),
        )
        scales = (
            torch.zeros((2,) + shape[:-1], dtype=torch.float32, device=device) if self.int8 else None
        )
        return cache, scales

    def blocks_for(self, tokens: int) -> int:
        return -(-max(0, int(tokens)) // self.block)

    def reserve_tokens(self, prompt_len: int, max_new: int) -> int:
        """Worst-case rows a request can occupy: prompt + decode budget +
        ONE append-slack term, clamped to the logical capacity."""
        return min(prompt_len + max_new - 1 + self.append_slack, self.capacity)

    # -- admission ---------------------------------------------------------
    def lookup_seed(self, prompt_tokens, *, allow_partial: bool = True, count: bool = True) -> SeedPlan | None:
        """Radix consult for one prompt. An exact end record WITH logits
        gives an exact plan (prefill skipped); otherwise the longest
        block-aligned shared prefix, clamped to (n - 1) // block * block so
        at least one prompt token still runs through prefill (session end
        records keep rows, not logits, and take this path).
        ``allow_partial=False`` returns exact plans only (the wave has no
        mid-prompt append). ``count=False`` leaves the radix's hit
        counters alone (a KV-handoff export probe is not admission
        traffic; the radix's own stats count every lookup, as JAX's do).
        The plan's blocks (and tail source) are pinned:
        ``attach_seed`` adopts the pins, every other path calls
        ``release_plan``."""
        if self.radix is None:
            return None
        with self._lock:
            m = self.radix.lookup(prompt_tokens)
            n = len(prompt_tokens)
            if m.end is not None and m.end.logits is not None:
                if count:
                    self._count("hit")
                plan = SeedPlan(
                    blocks=m.blocks, shared=m.shared, exact=True,
                    tail_src=m.end.tail_block if m.end.tail_block is not None else -1,
                    tail_len=m.end.tail_len, logits=m.end.logits,
                )
            else:
                shared = min(m.shared, ((n - 1) // self.block) * self.block)
                if shared <= 0 or not allow_partial:
                    if count:
                        self._count("miss")
                    return None
                if count:
                    self._count("partial_hit")
                plan = SeedPlan(
                    blocks=m.blocks[: shared // self.block], shared=shared,
                    exact=False, tail_src=-1, tail_len=0, logits=None,
                )
            self.pool.incref(plan.blocks)
            if plan.tail_src >= 0:
                self.pool.incref([plan.tail_src])
            return plan

    def release_plan(self, plan: SeedPlan | None) -> None:
        """Drop an unconsumed seed plan's pins (blocked, stranded or failed
        admissions)."""
        if plan is None:
            return
        with self._lock:
            self.pool.decref(plan.blocks)
            if plan.tail_src >= 0:
                self.pool.decref([plan.tail_src])

    def reserve_need(self, prompt_len: int, max_new: int, plan: SeedPlan | None = None) -> int:
        """Blocks a request still needs beyond its seed plan's shared
        prefix (an exact hit's tail copy is the first non-shared block)."""
        need = self.blocks_for(self.reserve_tokens(prompt_len, max_new))
        return max(0, need - (len(plan.blocks) if plan is not None else 0))

    def unreserve(self, n: int) -> None:
        """Return an unconsumed admission promise (a stranded request put
        back in the queue)."""
        if n > 0:
            with self._lock:
                self.pool.unreserve(n)

    def admit_reserve(self, prompt_len: int, max_new: int, plan: SeedPlan | None = None) -> bool:
        """Promise pool blocks for a request's worst case (minus what a
        seed plan shares), evicting retained radix leaves if it must.
        False = the pool cannot host it yet; the engine keeps it queued."""
        need = self.reserve_need(prompt_len, max_new, plan)
        with self._lock:
            if self.pool.available() < need and self.radix is not None:
                self.radix.evict_for(need - self.pool.available())
            return self.pool.reserve(need)

    def attach_seed(self, slot: int, plan: SeedPlan | None, owner, prompt_len: int, max_new: int) -> dict:
        """Bind a slot to a newly admitted request: release the previous
        occupant's blocks, point the table at the plan's shared blocks
        (adopting the plan's pins) and move the admission promise onto the
        slot. Returns the device work the engine must dispatch: ``copies``
        (src, dst) block pairs — an exact hit's tail is shared by COPY —
        and ``seed_len``, the slot's rows once seeded."""
        with self._lock:
            st = self._slot_tables[slot]
            self._release_slot_locked(slot)
            st.owner = owner
            st.reserved = self.reserve_need(prompt_len, max_new, plan)
            copies: list[tuple[int, int]] = []
            seed_len = 0
            if plan is not None:
                n = len(plan.blocks)
                st.rows[:n] = np.asarray(plan.blocks, np.int32)
                st.shared = st.hi = n
                seed_len = plan.shared
                if plan.exact and plan.tail_src >= 0:
                    dst = self.pool.alloc(1, reserved=True)[0]
                    st.reserved -= 1
                    st.rows[n] = dst
                    st.hi = n + 1
                    copies.append((plan.tail_src, dst))
                    seed_len = plan.shared + plan.tail_len
                    # the copy the engine dispatches next is ordered on the
                    # stream before any later owner's write to the source
                    self.pool.decref([plan.tail_src])
            self.tables_dirty = True
            self._update_gauges()
            return {"copies": copies, "seed_len": seed_len}

    def attach(self, slot: int, owner, prompt_len: int, max_new: int) -> None:
        """``attach_seed`` for a request with no seed plan (a miss)."""
        self.attach_seed(slot, None, owner, prompt_len, max_new)

    def ensure(self, slot: int, upto_tokens: int) -> bool:
        """Materialize table entries so rows [0, upto_tokens) are writable
        or shared — blocks are allocated as the cursor advances, drawn from
        the slot's reservation first, then from free headroom (evicting
        retained prefixes if it must). Returns True when the table changed."""
        upto = min(int(upto_tokens), self.capacity)
        need = self.blocks_for(upto)
        with self._lock:
            st = self._slot_tables[slot]
            if need <= st.hi:
                return False
            n = need - st.hi
            take_r = min(n, st.reserved)
            fresh: list[int] = []
            if take_r:
                fresh += self.pool.alloc(take_r, reserved=True)
                st.reserved -= take_r
            extra = n - take_r
            if extra:
                if self.pool.available() < extra and self.radix is not None:
                    self.radix.evict_for(extra - self.pool.available())
                fresh += self.pool.alloc(extra)
            st.rows[st.hi : need] = np.asarray(fresh, np.int32)
            st.hi = need
            self.tables_dirty = True
            self._update_gauges()
            return True

    def _release_slot_locked(self, slot: int) -> None:
        st = self._slot_tables[slot]
        if st.hi:
            self.pool.decref(st.blocks())
        if st.reserved:
            self.pool.unreserve(st.reserved)
        st.hi = st.shared = st.reserved = 0
        st.owner = None

    def release_slot(self, slot: int, owner=None) -> None:
        """Drop a slot's blocks (retire). Owner-checked when given, so a
        late release can never free a successor's blocks."""
        with self._lock:
            st = self._slot_tables[slot]
            if owner is not None and st.owner is not owner:
                return
            self._release_slot_locked(slot)
            self.tables_dirty = True
            self._update_gauges()

    def slot_owner(self, slot: int):
        return self._slot_tables[slot].owner

    def take_tables(self) -> np.ndarray | None:
        """The [slots, table_width] host mirror when it changed, else None
        (always None on the contiguous layout)."""
        with self._lock:
            if not self.paged or not self.tables_dirty:
                return None
            for s, st in enumerate(self._slot_tables):
                self._tables_np[s] = st.rows
            self.tables_dirty = False
            return self._tables_np.copy()

    # -- publishing (radix + sessions) ------------------------------------
    def publish_plan(self, slot: int, tokens, *, want_tail: bool) -> dict | None:
        """Plan publishing a slot's first ``len(tokens)`` rows: the full
        blocks are shared in place; the sub-block tail (when wanted) is
        COPIED into a fresh radix-owned block. None when sharing is off or
        no tail block can be had even after eviction."""
        if self.radix is None:
            return None
        n = len(tokens)
        full = n - n % self.block
        with self._lock:
            st = self._slot_tables[slot]
            if self.blocks_for(n) > st.hi:
                return None  # rows not resident
            blocks = [int(b) for b in st.rows[: full // self.block]]
            tail_src = tail_dst = -1
            tail_len = n - full
            if want_tail and tail_len > 0:
                if self.pool.available() < 1:
                    self.radix.evict_for(1)
                if self.pool.available() < 1:
                    return None
                tail_src = int(st.rows[full // self.block])
                tail_dst = self.pool.alloc(1)[0]
            return {
                "slot": slot, "blocks": blocks, "tail_src": tail_src,
                "tail_dst": tail_dst, "tail_len": tail_len if want_tail else 0,
            }

    def publish_commit(self, plan: dict, tokens, logits=None, logits_nbytes: int = 0,
                       session_id: str | None = None) -> None:
        """Insert the published sequence into the radix (dedup against
        existing paths) and, for a session turn, pin the leaf to it."""
        session = bool(session_id) and self.sessions is not None
        with self._lock:
            node, key = self.radix.insert(
                list(tokens), plan["blocks"],
                tail_block=plan["tail_dst"] if plan["tail_dst"] >= 0 else None,
                tail_len=plan["tail_len"], logits=logits, logits_nbytes=logits_nbytes, pin=session,
            )
            self._count("store")
            if session:
                nblocks = len(plan["blocks"]) + (1 if plan["tail_dst"] >= 0 else 0)
                self.sessions.publish(session_id, tokens, node, key, nblocks * self.block_bytes, self.radix)
                self._count_session("publish")
            self._update_gauges()

    # -- session spill / restore ------------------------------------------
    def session_path(self, sid: str) -> dict | None:
        """The device blocks a resident session's pinned leaf covers (root
        to leaf) and its end record's tail: what a spill fetches."""
        if self.sessions is None:
            return None
        with self._lock:
            s = self.sessions.get(sid)
            if s is None or s.state != "resident" or s.node is None:
                return None
            chain, node = [], s.node
            while node is not None and node.parent is not None:
                chain.append(node)
                node = node.parent
            blocks = [b for n in reversed(chain) for b in n.blocks]
            end = s.node.ends.get(s.end_key)
            tail = end.tail_block if end is not None and end.tail_block is not None else -1
            return {"tokens": list(s.tokens), "blocks": blocks, "tail": tail,
                    "tail_len": end.tail_len if end is not None else 0}

    def spill_commit(self, sid: str, payload: dict, nbytes: int) -> None:
        """After the engine fetched a session's blocks to host: unpin, store
        the payload in the host tier (LRU under its budget; the ids it
        expires are forgotten), and evict the session's now-exclusive leaf
        chain so its device blocks free. Nodes still pinned or shared stay."""
        with self._lock:
            s = self.sessions.get(sid)
            node = s.node if s is not None else None
            self.sessions.mark_spilled(sid, self.radix)
            for dropped in self.sessions.offload.store(sid, payload, nbytes):
                self.sessions.forget(dropped, self.radix)
                self._count_session("expire")
            while node is not None and node.parent is not None and not node.children and node.refs == 0:
                parent = node.parent
                self.radix._evict_node(node)
                node = parent
            self._count_session("spill")
            self._update_gauges()

    def restore_fetch(self, sid: str) -> dict | None:
        """Pop a spilled session's host payload; a spilled session whose
        payload is gone is forgotten (its next turn is a clean miss)."""
        if self.sessions is None:
            return None
        with self._lock:
            s = self.sessions.get(sid)
            if s is None or s.state != "spilled":
                return None
            payload = self.sessions.offload.fetch(sid)
            if payload is None:
                self.sessions.forget(sid, self.radix)
                self._count_session("expire")
            return payload

    def session_forget(self, sid: str) -> None:
        """Drop a session entirely (its payload is consumed and its blocks
        cannot be allocated)."""
        if self.sessions is None:
            return
        with self._lock:
            self.sessions.forget(sid, self.radix)
            self._count_session("expire")
            self._update_gauges()

    def alloc_restore(self, n: int) -> list[int] | None:
        with self._lock:
            if self.pool.available() < n and self.radix is not None:
                self.radix.evict_for(n - self.pool.available())
            if self.pool.available() < n:
                return None
            return self.pool.alloc(n)

    def release_blocks(self, blocks: list[int]) -> None:
        """Drop one reference per block: a failed handoff import's
        allocation, before any table or radix record adopted it."""
        if blocks:
            with self._lock:
                self.pool.decref(blocks)
                self._update_gauges()

    def handoff_commit(self, tokens, blocks: list[int], tail_block: int, tail_len: int, *, logits=None,
                       logits_nbytes: int = 0) -> None:
        """Adopt KV blocks a peer engine handed over (disaggregated
        serving, JAX ``CacheManager.handoff_commit``): insert the prompt
        into the radix WITH its last-token logits, so this engine's next
        admission of that exact prompt skips prefill. ``insert`` takes its
        own references (deduplicating against prefixes that grew here
        meanwhile); the allocation's references drop here, and the tail
        block is adopted by the end record as it stands."""
        with self._lock:
            self.radix.insert(
                list(tokens), blocks, tail_block=tail_block if tail_block >= 0 else None, tail_len=tail_len,
                logits=logits, logits_nbytes=logits_nbytes,
            )
            self.pool.decref(blocks)
            self._count("store")
            self._update_gauges()

    def restore_commit(self, sid: str, tokens, blocks: list[int], tail_block: int, tail_len: int) -> None:
        """Re-insert a restored session into the radix and pin it again.
        insert() takes its own references (deduplicating against prefixes
        that grew meanwhile); the allocation's references drop here, and
        the tail block is adopted by the end record as it stands."""
        with self._lock:
            node, key = self.radix.insert(
                list(tokens), blocks, tail_block=tail_block if tail_block >= 0 else None, tail_len=tail_len,
                pin=True,
            )
            self.pool.decref(blocks)
            nbytes = (len(blocks) + (1 if tail_block >= 0 else 0)) * self.block_bytes
            self.sessions.publish(sid, tokens, node, key, nbytes, self.radix)
            self._count_session("restore")
            self._update_gauges()

    def spill_candidates(self, exclude=None):
        if self.sessions is None:
            return []
        with self._lock:
            return self.sessions.spill_candidates(exclude)

    def session_touch(self, sid: str) -> str:
        """Record a turn arriving for ``sid``; returns the session's state
        ("off" | "new" | "resident" | "spilled")."""
        if self.sessions is None:
            return "off"
        with self._lock:
            s = self.sessions.get(sid)
            if s is None:
                return "new"
            s.last_use = time.monotonic()
            if s.state == "resident":
                self.sessions.resumes += 1
                self._count_session("resume")
            return s.state

    # -- observability -----------------------------------------------------
    def held_blocks(self) -> int:
        """Blocks the radix and the sessions hold: what ``blocks_in_use``
        must equal once no slot holds any (no pin leaked)."""
        with self._lock:
            if self.radix is None:
                return 0
            held, stack = set(), [self.radix.root]  # the root holds sub-block prompts' end records
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                held.update(n.blocks)
                held.update(e.tail_block for e in n.ends.values() if e.tail_block is not None)
            return len(held)

    def stats(self) -> dict:
        if not self.paged:
            return {
                "layout": "rolling" if self.rolling else "dense",
                "capacity": self.capacity,
                "window": self.window,
                "slot_bytes": self.slot_bytes,
                "int8": False,
                "prefix": self.prefix.stats() if self.prefix is not None else None,
                "sessions": None,
            }
        with self._lock:
            return {
                "layout": "paged",
                "window": self.window,
                "block": self.block,
                "int8": self.int8,
                "block_bytes": self.block_bytes,
                "pool_blocks": self.pool.n_blocks,
                "blocks_in_use": self.pool.blocks_in_use(),
                "blocks_shared": self.pool.blocks_shared(),
                "reserved": self.pool.reserved,
                "cow_copies": self.pool.cow_copies,
                "slot_bytes": self.pool.bytes_in_use(),
                "capacity": self.capacity,
                "prefix": self.radix.stats() if self.radix is not None else None,
                "sessions": self.sessions.stats() if self.sessions is not None else None,
            }
