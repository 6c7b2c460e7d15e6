"""Block-paged KV pool (counterpart of gofr_tpu/kvcache/paged.py).

One device pool of fixed-size blocks backs every engine slot: logical row
``p`` of a slot lives at pool row ``table[p // B] * B + p % B``. This
port keeps the unshared pool — no radix tree, no prefix sharing — so every
block has refcount 1 and is private to its slot. An int8 pool stores each
row as int8 plus one float32 scale per (row, KV head) beside it
(:func:`quantize_rows`).

Host bookkeeping (copied and trimmed from the JAX package, which is
host-only code there too): :class:`BlockPool` (refcounts, free list,
admission reservations) and :class:`SlotTable` (one block table per
slot). Device helpers: :func:`gather_slots` builds the dense per-slot
view through the tables; :func:`scatter_rows` writes rows through them;
:func:`quantize_rows` / :func:`dequantize_rows` are the int8 row codec.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = [
    "BlockPool", "PoolExhausted", "SlotTable", "dequantize_rows", "gather_slots",
    "quantize_rows", "scatter_rows",
]


class PoolExhausted(RuntimeError):
    """No free block — callers queue, never crash."""


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

    def blocks_in_use(self) -> int:
        return self.n_blocks - len(self._free)

    def available(self) -> int:
        """Free blocks not yet promised to anyone."""
        return len(self._free) - self.reserved

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


class SlotTable:
    """One engine slot's logical-row -> pool-block mapping: ``rows[j]``
    holds logical positions [j*B, (j+1)*B). Entries at or beyond ``hi``
    are stale — gathers read them, masks hide them, writes never touch
    them."""

    __slots__ = ("rows", "hi", "reserved", "owner")

    def __init__(self, width: int):
        self.rows = np.zeros(width, np.int32)
        self.hi = 0  # table entries materialized
        self.reserved = 0  # blocks promised at admission, not yet drawn
        self.owner: Any = None  # engine-side occupancy token

    def blocks(self) -> list[int]:
        return [int(b) for b in self.rows[: self.hi]]


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
