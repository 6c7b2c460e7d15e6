"""KV memory manager (counterpart of gofr_tpu/kvcache, paged layout only).

The JAX package's CacheManager picks between a paged pool, a rolling ring
and a dense slab, and adds a radix prefix index and sessions. The port
keeps the serving default — the paged pool, bf16/f32 or int8 rows — with
the same sizing rules:

- ``table_width = ceil(max_seq_len / block)`` entries per slot table;
- ``capacity = table_width * block`` logical rows per slot;
- ``pool_blocks = slots * table_width`` (every slot fully grown, no
  sharing);
- one ``append_slack`` term (the widest append one device program can
  make) in every admission reservation.

Host tables grow as each cursor advances (``ensure``) and return their
blocks on ``release_slot``; the device pool tensors are
[L, n_blocks, block, hkv, hd] (plus [2, L, n_blocks, block, hkv] float32
scales for an int8 pool) and belong to the engine.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .paged import (
    BlockPool,
    PoolExhausted,
    SlotTable,
    dequantize_rows,
    gather_slots,
    quantize_rows,
    scatter_rows,
)

__all__ = [
    "BlockPool", "CacheManager", "PoolExhausted", "SlotTable", "dequantize_rows",
    "gather_slots", "quantize_rows", "scatter_rows",
]


class CacheManager:
    """Paged KV bookkeeping for one engine. Mutated only by the engine's
    scheduler thread; the lock keeps concurrent ``stats()`` readers
    consistent."""

    def __init__(
        self,
        cfg,
        slots: int,
        max_seq_len: int,
        decode_chunk: int,
        *,
        append_widths: tuple = (),
        block: int = 16,
        kv_int8: bool = False,
    ):
        self.cfg = cfg
        self.slots = slots
        self.max_seq_len = max_seq_len
        self.append_slack = max(tuple(int(x) for x in append_widths) + (int(decode_chunk),))
        self.block = int(block)
        self.table_width = -(-max_seq_len // self.block)
        self.capacity = self.table_width * self.block
        self.int8 = bool(kv_int8)
        itemsize = 1 if self.int8 else torch.empty((), dtype=cfg.dtype).element_size()
        rows = 2 * cfg.n_layers * self.block * cfg.n_kv_heads
        # an int8 row carries one float32 scale per (row, KV head)
        self.block_bytes = rows * cfg.head_dim * itemsize + (rows * 4 if self.int8 else 0)
        # worst case with zero sharing: every slot fully grown
        self.pool = BlockPool(slots * self.table_width, self.block, self.block_bytes)
        self._slot_tables = [SlotTable(self.table_width) for _ in range(slots)]
        self._tables_np = np.zeros((slots, self.table_width), np.int32)
        self.tables_dirty = True
        self._lock = threading.Lock()

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

    def reserve_need(self, prompt_len: int, max_new: int) -> int:
        return self.blocks_for(self.reserve_tokens(prompt_len, max_new))

    def admit_reserve(self, prompt_len: int, max_new: int) -> bool:
        """Promise pool blocks for a request's worst case. False = the
        pool cannot host it yet; the engine keeps it queued."""
        with self._lock:
            return self.pool.reserve(self.reserve_need(prompt_len, max_new))

    def attach(self, slot: int, owner, prompt_len: int, max_new: int) -> None:
        """Bind a slot to a newly admitted request: release the previous
        occupant's blocks and move the admission promise onto the slot."""
        with self._lock:
            self._release_slot_locked(slot)
            st = self._slot_tables[slot]
            st.owner = owner
            st.reserved = self.reserve_need(prompt_len, max_new)
            self.tables_dirty = True

    def ensure(self, slot: int, upto_tokens: int) -> bool:
        """Materialize table entries so rows [0, upto_tokens) are
        writable — blocks are allocated as the cursor advances, drawn
        from the slot's reservation first. Returns True when the table
        changed."""
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
            if n - take_r:
                fresh += self.pool.alloc(n - take_r)
            st.rows[st.hi : need] = np.asarray(fresh, np.int32)
            st.hi = need
            self.tables_dirty = True
            return True

    def _release_slot_locked(self, slot: int) -> None:
        st = self._slot_tables[slot]
        if st.hi:
            self.pool.decref(st.blocks())
        if st.reserved:
            self.pool.unreserve(st.reserved)
        st.hi = 0
        st.reserved = 0
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

    def slot_owner(self, slot: int):
        return self._slot_tables[slot].owner

    def take_tables(self) -> np.ndarray | None:
        """The [slots, table_width] host mirror when it changed, else None."""
        with self._lock:
            if not self.tables_dirty:
                return None
            for s, st in enumerate(self._slot_tables):
                self._tables_np[s] = st.rows
            self.tables_dirty = False
            return self._tables_np.copy()

    def stats(self) -> dict:
        with self._lock:
            return {
                "layout": "paged",
                "block": self.block,
                "int8": self.int8,
                "block_bytes": self.block_bytes,
                "pool_blocks": self.pool.n_blocks,
                "blocks_in_use": self.pool.blocks_in_use(),
                "reserved": self.pool.reserved,
                "capacity": self.capacity,
            }
