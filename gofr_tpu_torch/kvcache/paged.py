"""Block-paged KV pool with radix prefix sharing (counterpart of
gofr_tpu/kvcache/paged.py).

One device pool of fixed-size blocks backs every engine slot: logical row
``p`` of a slot lives at pool row ``table[p // B] * B + p % B``. Blocks
are refcounted, so sibling prompts share every common FULL prefix block in
place, found through a radix tree over token ids; a sub-block tail is
shared by COPY. The copy-on-write invariant: no write ever lands in a
block with refcount > 1 (shared blocks sit strictly below every writer's
cursor; ``BlockPool.ensure_writable`` is the mechanical seam). An int8
pool stores each row as int8 plus one float32 scale per (row, KV head)
beside it (:func:`quantize_rows`).

Host bookkeeping (copied and trimmed from the JAX package, which is
host-only code there too): :class:`BlockPool` (refcounts, free list,
admission reservations), :class:`SlotTable` (one block table per slot)
and :class:`RadixTree` (the block-granular prefix index, LRU-evicted).
Device helpers: :func:`gather_slots` builds the dense per-slot view
through the tables; :func:`scatter_rows` writes rows through them;
:func:`copy_blocks` copies whole blocks (tail publishes and exact-hit
seeds); :func:`gather_blocks_host` fetches blocks to host memory (session
spills); :func:`quantize_rows` / :func:`dequantize_rows` are the int8 row
codec.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch

__all__ = [
    "BlockPool", "PoolExhausted", "RadixMatch", "RadixTree", "SlotTable", "copy_blocks",
    "dequantize_rows", "gather_blocks_host", "gather_slots", "quantize_rows", "scatter_rows",
]


class PoolExhausted(RuntimeError):
    """No free block and nothing evictable — callers queue, never crash."""


class BlockPool:
    """Refcounted free list over ``n_blocks`` device blocks of ``block``
    tokens each. Pure host bookkeeping: the device tensors live with the
    engine; this class decides WHICH pool rows a sequence may use. Not
    internally locked — the CacheManager lock serializes callers."""

    def __init__(self, n_blocks: int, block: int, block_bytes: int):
        if n_blocks < 1 or block < 1:
            raise ValueError(f"pool needs >= 1 block of >= 1 tokens, got {n_blocks}x{block}")
        self.n_blocks = int(n_blocks)
        self.block = int(block)
        self.block_bytes = int(block_bytes)
        self.refs = np.zeros(self.n_blocks, np.int32)
        # LIFO free stack: recently freed blocks are reused first
        self._free: list[int] = list(range(self.n_blocks - 1, -1, -1))
        # blocks promised to admitted requests but not yet materialized;
        # available() subtracts them so admission never over-commits
        self.reserved = 0
        self.cow_copies = 0  # copy-on-write splits performed

    def blocks_in_use(self) -> int:
        return self.n_blocks - len(self._free)

    def blocks_shared(self) -> int:
        return int(np.count_nonzero(self.refs > 1))

    def available(self) -> int:
        """Free blocks not yet promised to anyone."""
        return len(self._free) - self.reserved

    def bytes_in_use(self) -> int:
        return self.blocks_in_use() * self.block_bytes

    def reserve(self, n: int) -> bool:
        """Promise ``n`` blocks to an admitted request. False = the pool
        cannot honor it now (the caller keeps the request queued)."""
        if n > self.available():
            return False
        self.reserved += n
        return True

    def unreserve(self, n: int) -> None:
        self.reserved = max(0, self.reserved - n)

    def alloc(self, n: int = 1, *, reserved: bool = False) -> list[int]:
        """Take ``n`` fresh blocks (refcount 1 each). ``reserved=True``
        draws down a prior reserve() promise instead of free headroom."""
        if n > len(self._free):
            raise PoolExhausted(f"need {n} blocks, {len(self._free)} free")
        if not reserved and n > self.available():
            raise PoolExhausted(f"need {n} unreserved blocks, {self.available()} available")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self.refs[b] = 1
        if reserved:
            self.reserved = max(0, self.reserved - n)
        return out

    def incref(self, blocks) -> None:
        for b in blocks:
            if self.refs[b] <= 0:
                raise ValueError(f"incref on free block {b}")
            self.refs[b] += 1

    def decref(self, blocks) -> int:
        """Drop one reference per block; fully released blocks return to
        the free list. Returns how many blocks were freed."""
        freed = 0
        for b in blocks:
            if self.refs[b] <= 0:
                raise ValueError(f"decref on free block {b}")
            self.refs[b] -= 1
            if self.refs[b] == 0:
                self._free.append(b)
                freed += 1
        return freed

    def ensure_writable(self, block: int, *, reserved: bool = False) -> int | None:
        """Copy-on-write seam for a block a write window touches: refcount
        1 -> private, write in place (None); refcount > 1 -> a fresh block
        the caller must device-copy the old contents into and repoint its
        table at BEFORE writing (the writer's reference migrates to it)."""
        if self.refs[block] <= 0:
            raise ValueError(f"write planned into free block {block}")
        if self.refs[block] == 1:
            return None
        fresh = self.alloc(1, reserved=reserved)[0]
        self.refs[block] -= 1
        self.cow_copies += 1
        return fresh


class SlotTable:
    """One engine slot's logical-row -> pool-block mapping: ``rows[j]``
    holds logical positions [j*B, (j+1)*B). Entries at or beyond ``hi``
    are stale — gathers read them, masks hide them, writes never touch
    them. The first ``shared`` entries name radix-shared blocks
    (read-only for this slot); every entry from ``shared`` on is
    private."""

    __slots__ = ("rows", "hi", "shared", "reserved", "owner")

    def __init__(self, width: int):
        self.rows = np.zeros(width, np.int32)
        self.hi = 0  # table entries materialized
        self.shared = 0  # leading entries that are radix-shared (read-only)
        self.reserved = 0  # blocks promised at admission, not yet drawn
        self.owner: Any = None  # engine-side occupancy token

    def blocks(self) -> list[int]:
        return [int(b) for b in self.rows[: self.hi]]

    def private_blocks(self) -> list[int]:
        return [int(b) for b in self.rows[self.shared : self.hi]]


class _End:
    """An exact published sequence ending at a node: its sub-block tail
    rows (COPIED into a radix-owned block at publish) and, for prompts,
    the stored last-token logits that let an exact hit skip prefill."""

    __slots__ = ("tail_block", "tail_len", "logits", "nbytes", "last_use")

    def __init__(self, tail_block, tail_len, logits, nbytes):
        self.tail_block = tail_block  # pool block id or None
        self.tail_len = int(tail_len)
        self.logits = logits  # [1, vocab] device tensor or None
        self.nbytes = int(nbytes)
        self.last_use = time.monotonic()


class RadixNode:
    __slots__ = ("tokens", "blocks", "children", "parent", "refs", "ends", "last_use")

    def __init__(self, tokens: tuple, blocks: list[int], parent):
        self.tokens = tokens  # edge label; len % block == 0
        self.blocks = blocks  # one pool block per `block` tokens of the edge
        # keyed by the edge's FIRST whole block group (a tuple of `block`
        # token ids): two edges may share a first token yet diverge
        # mid-block, so every found child matches at least one group
        self.children: dict[tuple, RadixNode] = {}
        self.parent = parent
        self.refs = 0  # long-lived pins (sessions)
        self.ends: dict[tuple, _End] = {}
        self.last_use = time.monotonic()

    def depth_tokens(self) -> int:
        n, node = 0, self
        while node.parent is not None:
            n += len(node.tokens)
            node = node.parent
        return n


class RadixMatch(NamedTuple):
    blocks: list[int]  # shared full prefix blocks, in order
    shared: int  # shared tokens (= len(blocks) * block)
    end: Any  # _End for an exact match, else None
    node: Any  # deepest fully-matched node (touch/pin target)


class RadixTree:
    """Token-id trie at block granularity over pool blocks. Every edge
    label is a multiple of ``block`` tokens and carries one pool block per
    group; exact published sequences also attach an ``_End`` (copied
    tail, stored logits). ``lookup`` finds the longest block-aligned
    shared prefix against everything published. Mutated only under the
    CacheManager lock."""

    def __init__(self, pool: BlockPool, block: int, capacity_bytes: int = 0):
        self.pool = pool
        self.block = int(block)
        self.capacity_bytes = int(capacity_bytes)  # 0 = unbounded (pool pressure evicts)
        self.root = RadixNode((), [], None)
        self.owned_bytes = 0  # blocks + tails + logits the radix holds refs on
        self.nodes = 0
        self.hits = 0  # exact hits (lookup returned an end record)
        self.partial_hits = 0  # block-granular prefix hits
        self.misses = 0
        self.stores = 0
        self.evictions = 0

    def _matched_groups(self, edge: tuple, tokens: list, at: int, limit: int) -> int:
        """Whole B-token groups of ``edge`` equal to tokens[at:], capped
        so a match never extends past ``limit`` tokens of the query."""
        B = self.block
        g = 0
        max_g = min(len(edge), limit - at) // B
        while g < max_g and tuple(tokens[at + g * B : at + (g + 1) * B]) == edge[g * B : (g + 1) * B]:
            g += 1
        return g

    def lookup(self, tokens, *, max_shared: int | None = None) -> RadixMatch:
        """Longest block-aligned shared prefix of ``tokens``; ``end`` is the
        end record when the FULL sequence (sub-block tail included) was
        published. ``max_shared`` caps the shared prefix. Touches the
        matched path (LRU) and counts a hit, partial hit or miss."""
        B = self.block
        n = len(tokens)
        limit = n if max_shared is None else min(n, max_shared)
        node, i, blocks = self.root, 0, []
        while i + B <= limit:
            child = node.children.get(tuple(tokens[i : i + B]))
            if child is None:
                break
            g = self._matched_groups(child.tokens, tokens, i, limit)
            blocks.extend(child.blocks[:g])
            i += g * B
            if g * B < len(child.tokens):
                # mid-edge divergence: the shared blocks count, but `node`
                # stays the last FULLY matched node (exact checks and pins
                # anchor on whole nodes)
                break
            node = child
        now = time.monotonic()
        cur = node
        while cur is not None:
            cur.last_use = now
            cur = cur.parent
        end = None
        full = n - n % B
        if i == full and node.depth_tokens() == full:
            end = node.ends.get(tuple(tokens[full:]))
            if end is not None:
                end.last_use = now
        self.hits += end is not None
        self.partial_hits += end is None and bool(blocks)
        self.misses += end is None and not blocks
        return RadixMatch(blocks=[int(b) for b in blocks], shared=len(blocks) * B, end=end, node=node)

    def insert(self, tokens, blocks: list[int], *, tail_block: int | None = None, tail_len: int = 0,
               logits=None, logits_nbytes: int = 0, pin: bool = False) -> tuple[RadixNode, tuple]:
        """Publish a sequence: adopt its FULL prefix blocks (one reference
        per block the tree does not already cover; an existing path is
        deduplicated) and attach an end record when a copied ``tail_block``
        or ``logits`` is given. A tail that loses to an existing end record
        is released. ``pin`` pins the leaf before the capacity eviction
        runs, so a session's new leaf cannot be evicted before its owner
        holds it (the JAX tree pins after ``insert`` returns: with more
        pinned session bytes than the budget, the fresh leaf is evicted
        and the session keeps a detached node whose blocks are free).
        Returns (leaf node, end key)."""
        B = self.block
        n = len(tokens)
        full = n - n % B
        node, i = self.root, 0
        while i < full:
            key = tuple(tokens[i : i + B])
            child = node.children.get(key)
            if child is None:
                new = RadixNode(tuple(tokens[i:full]), [int(b) for b in blocks[i // B : full // B]], node)
                self.pool.incref(new.blocks)
                self.owned_bytes += len(new.blocks) * self.pool.block_bytes
                node.children[key] = new
                self.nodes += 1
                node, i = new, full
                break
            g = self._matched_groups(child.tokens, tokens, i, full)
            if g * B == len(child.tokens):
                node, i = child, i + len(child.tokens)
                continue
            # split the edge at the divergence (group-aligned: g >= 1)
            top = RadixNode(child.tokens[: g * B], child.blocks[:g], node)
            top.children[tuple(child.tokens[g * B : (g + 1) * B])] = child
            child.tokens = child.tokens[g * B :]
            child.blocks = child.blocks[g:]
            child.parent = top
            node.children[key] = top
            self.nodes += 1
            node, i = top, i + g * B
        key = tuple(tokens[full:])
        if (tail_block is not None or logits is not None) and key not in node.ends:
            nbytes = (self.pool.block_bytes if tail_block is not None else 0) + int(logits_nbytes)
            node.ends[key] = _End(tail_block, tail_len, logits, nbytes)
            self.owned_bytes += nbytes
        elif tail_block is not None:
            # an earlier publish holds this exact end: the fresh tail copy
            # is unwanted, and would leak a pool block if kept
            self.pool.decref([tail_block])
        self.stores += 1
        node.last_use = time.monotonic()
        if pin:
            self.pin(node)
        if self.capacity_bytes:
            self.evict_to(self.capacity_bytes)
        return node, key

    def pin(self, node: RadixNode) -> None:
        node.refs += 1

    def unpin(self, node: RadixNode) -> None:
        node.refs = max(0, node.refs - 1)

    def _evict_node(self, node: RadixNode) -> int:
        """Drop one unpinned leaf: deref its blocks and end records."""
        freed = 0
        for e in node.ends.values():
            if e.tail_block is not None:
                freed += self.pool.decref([e.tail_block])
            self.owned_bytes -= e.nbytes
        node.ends.clear()
        freed += self.pool.decref(node.blocks)
        self.owned_bytes -= len(node.blocks) * self.pool.block_bytes
        if node.parent is not None:
            node.parent.children.pop(tuple(node.tokens[: self.block]), None)
        self.nodes -= 1
        self.evictions += 1
        return freed

    def _evictable_leaves(self) -> list[RadixNode]:
        out = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n.refs == 0:
                out.append(n)
        out.sort(key=lambda n: n.last_use)
        return out

    def evict_to(self, budget_bytes: int) -> int:
        """LRU-evict unpinned leaves until the retained bytes fit the
        budget; each sorted batch of leaves is consumed before the tree is
        walked again (evicting a leaf can expose its parent). Returns the
        blocks freed."""
        freed = 0
        while self.owned_bytes > budget_bytes:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            for n in leaves:
                if self.owned_bytes <= budget_bytes:
                    break
                freed += self._evict_node(n)
        return freed

    def evict_for(self, n_blocks: int) -> int:
        """Free at least ``n_blocks`` pool blocks by evicting LRU leaves
        (pool pressure). Returns the blocks actually freed: dropping a
        reference on a block a slot still holds frees nothing."""
        freed = 0
        while freed < n_blocks:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            for n in leaves:
                if freed >= n_blocks:
                    break
                freed += self._evict_node(n)
        return freed

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "partial_hits": self.partial_hits,
            "evictions": self.evictions,
            "stores": self.stores,
            "entries": self.nodes,
            "resident_bytes": self.owned_bytes,
            "capacity_bytes": self.capacity_bytes,
        }


def gather_slots(pool_k, pool_v, tables, lengths, *, scales=None, dtype=None):
    """Dense per-slot view THROUGH the block tables: logical row ``p`` of
    slot ``s`` comes from pool block ``tables[s, p // B]``, row ``p % B``
    (table entries clipped into range, like the JAX gather). Returns a
    KVCache of fresh [L, S, MB*B, h, d] tensors with ``length=lengths``.
    With ``scales`` = (k_scales, v_scales), each [L, NB, B, h] (int8
    pool), rows are dequantized in ``dtype``: the scale is cast to
    ``dtype`` before the multiply, as in the JAX function."""
    from ..models.transformer import KVCache

    idx = tables.long().clamp(0, pool_k.shape[1] - 1)

    def take(pool, sc):
        g = pool[:, idx]  # [L, S, MB, B, h, d]
        L, S, MB, B, h, d = g.shape
        g = g.reshape(L, S, MB * B, h, d)
        if sc is not None:
            s = sc[:, idx].reshape(L, S, MB * B, h)
            g = dequantize_rows(g, s, dtype)
        return g

    ks, vs = (None, None) if scales is None else scales
    return KVCache(k=take(pool_k, ks), v=take(pool_v, vs), length=lengths)


def quantize_rows(rows: torch.Tensor):
    """Symmetric per-row int8 over the last (head_dim) axis: scale =
    max(amax, 1e-8) / 127 in float32, values rounded half to even and
    clipped to +-127. Returns (int8 rows, float32 scales without that
    axis)."""
    rf = rows.float()
    scale = rf.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
    q = torch.round(rf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return q.to(dtype) * scale[..., None].to(dtype)


def scatter_rows(pool_k, pool_v, tables, rows_k, rows_v, positions, valid, *, scales=None):
    """Write per-slot K/V rows through the block tables, IN PLACE (the
    JAX function returns new pools; writing the pool in place saves a
    copy of the whole pool). ``rows_k/v`` are [L, S, W, h, d],
    ``positions`` [S, W] logical rows, ``valid`` [S, W] bool. Invalid
    lanes, and targets outside the pool, write nothing. With ``scales``
    (the int8 pool's [2, L, NB, B, h] float32 tensor) the rows are
    quantized first and their scales written in place beside them.
    Returns (pool_k, pool_v).

    Every lane takes part in one fixed-shape write, with no host sync, so
    the function can be captured in a CUDA graph. A dropped lane (the JAX
    ``mode="drop"``) repeats the first kept lane: the same target and the
    same row, so duplicate targets only ever write equal bytes, and a
    dropped lane never lands on a row of its own. When no lane is kept,
    every lane rewrites pool row 0 with what it already holds."""
    L, NB, B, h, d = pool_k.shape
    positions = positions.long()
    bi = (positions // B).clamp(0, tables.shape[1] - 1)
    blk = torch.gather(tables.long(), 1, bi)  # [S, W]
    flat = blk * B + positions % B
    keep = (valid & (flat >= 0) & (flat < NB * B)).reshape(-1)
    flat = flat.reshape(-1)
    first = keep.int().argmax()  # the first kept lane (0 when none is)
    any_kept = keep.any()
    src = torch.where(keep, torch.arange(keep.shape[0], device=keep.device), first)
    idx = torch.where(any_kept, flat[src], 0)

    def write(dst, rows):
        """dst [L, NB*B, ...] <- rows [L, S*W, ...] of the kept lanes."""
        dst.index_copy_(1, idx, torch.where(any_kept, rows[:, src], dst[:, :1]))

    for c, (pool, rows) in enumerate(((pool_k, rows_k), (pool_v, rows_v))):
        rows = rows.reshape(L, -1, h, d)
        if scales is not None:
            rows, sc = quantize_rows(rows)
            write(scales[c].view(L, NB * B, h), sc)
        write(pool.view(L, NB * B, h, d), rows.to(pool.dtype))
    return pool_k, pool_v


def copy_blocks(pool_k, pool_v, srcs, dsts, *, scales=None):
    """Block-granular device copy, IN PLACE: pool block ``dsts[i]`` :=
    block ``srcs[i]`` (sources clipped into range); lanes whose ``dsts`` lies
    outside the pool write nothing (the JAX ``mode="drop"``). With
    ``scales`` (the int8 pool's [2, L, NB, B, h] float32 tensor) each
    block's row scales move with it. Fixed shapes and no host sync, so the
    function can be captured in a CUDA graph: as in :func:`scatter_rows`,
    a dropped lane repeats the first kept lane, and when no lane is kept
    block 0 is rewritten with its own bytes. Returns (pool_k, pool_v,
    scales)."""
    NB = pool_k.shape[1]
    srcs = srcs.long().clamp(0, NB - 1)
    dsts = dsts.long()
    keep = (dsts >= 0) & (dsts < NB)
    first = keep.int().argmax()
    any_kept = keep.any()
    lane = torch.where(keep, torch.arange(keep.shape[0], device=keep.device), first)
    src = torch.where(any_kept, srcs[lane], 0)
    dst = torch.where(any_kept, dsts[lane], 0)
    for pool in (pool_k, pool_v):
        pool.index_copy_(1, dst, pool[:, src])
    if scales is not None:
        scales.index_copy_(2, dst, scales[:, :, src])
    return pool_k, pool_v, scales


def gather_blocks_host(pool_k, pool_v, blocks, *, scales=None):
    """Fetch pool blocks to host memory (session spills): returns (k [L, n,
    B, h, d], v, scales [2, L, n, B, h] or None) as CPU tensors, pinned
    when the pool is on a GPU. The gather is enqueued on the current stream
    and the call returns once the copies have run, so the payload is
    complete when it is stored."""
    idx = torch.as_tensor(np.asarray(blocks, np.int64), device=pool_k.device).clamp(0, pool_k.shape[1] - 1)
    parts = [pool_k[:, idx], pool_v[:, idx]] + ([] if scales is None else [scales[:, :, idx]])
    if pool_k.device.type == "cpu":
        out = parts
    else:
        out = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True) for p in parts]
        for h, p in zip(out, parts):
            h.copy_(p, non_blocking=True)
        torch.cuda.current_stream(pool_k.device).synchronize()
    return out[0], out[1], (out[2] if scales is not None else None)
