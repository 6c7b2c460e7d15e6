"""gofr_tpu_torch.kvcache against gofr_tpu.kvcache (CPU, byte identity for
the device helpers; behaviour for the host bookkeeping)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.kvcache.paged import gather_slots as j_gather_slots
from gofr_tpu.kvcache.paged import scatter_rows as j_scatter_rows
from gofr_tpu_torch.kvcache import (
    BlockPool,
    CacheManager,
    PoolExhausted,
    SlotTable,
    gather_slots,
    scatter_rows,
)
from gofr_tpu_torch.models import TransformerConfig

B = 4  # unit-test block size


def _pools(rng, L=2, NB=10, hkv=2, hd=4):
    pk = rng.normal(size=(L, NB, B, hkv, hd)).astype(np.float32)
    pv = rng.normal(size=(L, NB, B, hkv, hd)).astype(np.float32)
    return pk, pv


class TestDeviceHelpers:
    def test_gather_slots_byte_identical(self):
        rng = np.random.default_rng(1)
        pk, pv = _pools(rng)
        tables = rng.integers(0, 10, (3, 2)).astype(np.int32)
        tables[1, 1] = 12  # out of range: clipped like the JAX gather
        lens = np.asarray([3, 8, 0], np.int32)
        got = gather_slots(*map(torch.from_numpy, (pk, pv, tables, lens)))
        want = j_gather_slots(*map(jnp.asarray, (pk, pv, tables, lens)))
        np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
        np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
        np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_scatter_rows_byte_identical_with_dropped_lanes(self, seed):
        rng = np.random.default_rng(seed)
        L, NB, S, W, MB = 2, 12, 3, 5, 3
        pk, pv = _pools(rng, L=L, NB=NB)
        # distinct private blocks per slot, like the engine's tables
        tables = rng.permutation(NB)[: S * MB].reshape(S, MB).astype(np.int32)
        rows_k = rng.normal(size=(L, S, W, 2, 4)).astype(np.float32)
        rows_v = rng.normal(size=(L, S, W, 2, 4)).astype(np.float32)
        starts = rng.integers(0, MB * B - W, S)
        pos = (starts[:, None] + np.arange(W)[None, :]).astype(np.int32)
        valid = rng.random((S, W)) > 0.3
        valid[0, 0] = False  # at least one dropped lane
        tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
        out_k, out_v = scatter_rows(
            tk, tv, *map(torch.from_numpy, (tables, rows_k, rows_v, pos, valid))
        )
        assert out_k is tk and out_v is tv  # written in place
        jk, jv, _ = j_scatter_rows(*map(jnp.asarray, (pk, pv, tables, rows_k, rows_v, pos, valid)))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    @pytest.mark.parametrize("int8", [False, True])
    @pytest.mark.parametrize("kept", ["none", "some"])
    def test_scatter_rows_dropped_lanes_on_kept_targets(self, int8, kept):
        """The fixed-shape write against the JAX ``mode="drop"`` scatter:
        slot 1 shares slot 0's table, so each of its dropped lanes aims at
        the row a kept lane of slot 0 writes; slot 2's first lanes aim
        past the pool (a stale table entry) and are dropped though valid,
        its last lanes past the table (the block index clamps). int8 rows
        are quantized and their scales written beside them."""
        rng = np.random.default_rng(5)
        L, NB, W, MB, hkv, hd = 2, 8, 4, 2, 2, 4
        if int8:
            pk = rng.integers(-127, 128, (L, NB, B, hkv, hd)).astype(np.int8)
            pv = rng.integers(-127, 128, (L, NB, B, hkv, hd)).astype(np.int8)
            sc = rng.random((2, L, NB, B, hkv)).astype(np.float32)
        else:
            pk, pv = _pools(rng, L=L, NB=NB)
            sc = None
        tables = np.asarray([[3, 5], [3, 5], [NB + 2, 1]], np.int32)
        pos = np.asarray([[1, 2, 3, 4], [1, 2, 3, 4], [0, 1, 9, 10]], np.int32)
        valid = np.zeros((3, W), bool)
        valid[2, :2] = True  # past the pool: dropped all the same
        if kept == "some":
            valid[0] = True
            valid[2, 2:] = True  # past the table: the block index clamps
        rows_k = rng.normal(size=(L, 3, W, hkv, hd)).astype(np.float32)
        rows_v = rng.normal(size=(L, 3, W, hkv, hd)).astype(np.float32)
        tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
        ts = None if sc is None else torch.from_numpy(sc.copy())
        scatter_rows(tk, tv, *map(torch.from_numpy, (tables, rows_k, rows_v, pos, valid)), scales=ts)
        jk, jv, js = j_scatter_rows(
            *map(jnp.asarray, (pk, pv, tables, rows_k, rows_v, pos, valid)),
            scales=None if sc is None else jnp.asarray(sc),
        )
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        if int8:
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        if kept == "none":  # nothing written at all
            np.testing.assert_array_equal(tk.numpy(), pk)

    def test_scatter_all_dropped_is_noop(self):
        rng = np.random.default_rng(4)
        pk, pv = _pools(rng)
        tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
        scatter_rows(
            tk, tv, torch.zeros((1, 2), dtype=torch.int32),
            torch.ones((2, 1, 3, 2, 4)), torch.ones((2, 1, 3, 2, 4)),
            torch.arange(3)[None], torch.zeros((1, 3), dtype=torch.bool),
        )
        np.testing.assert_array_equal(tk.numpy(), pk)


class TestBlockPool:
    """Behaviour pinned by tests/test_paged_kv.py TestBlockPool."""

    def test_alloc_free_refcount(self):
        pool = BlockPool(8, B, 100)
        a = pool.alloc(3)
        assert pool.blocks_in_use() == 3 and pool.available() == 5
        assert all(pool.refs[b] == 1 for b in a)
        assert pool.decref(a[:1]) == 1
        assert pool.blocks_in_use() == 2
        assert pool.alloc(1) == a[:1]  # LIFO: the freed block is reused first
        pool.decref(a)
        assert pool.blocks_in_use() == 0

    def test_reservation_gates_allocation(self):
        pool = BlockPool(4, B, 100)
        assert pool.reserve(3)
        assert not pool.reserve(2)  # only 1 unreserved left
        pool.alloc(2, reserved=True)
        assert pool.reserved == 1
        with pytest.raises(PoolExhausted):
            pool.alloc(2)  # 2 free, but 1 is promised
        pool.unreserve(1)
        pool.alloc(2)

    def test_double_free_raises(self):
        pool = BlockPool(2, B, 100)
        (b,) = pool.alloc(1)
        pool.decref([b])
        with pytest.raises(ValueError):
            pool.decref([b])

    def test_slot_table(self):
        st = SlotTable(5)
        assert st.blocks() == [] and st.rows.shape == (5,)
        st.rows[:2] = [7, 3]
        st.hi = 2
        assert st.blocks() == [7, 3]


class TestCacheManager:
    def test_sizing_matches_reference_rules(self):
        cfg = TransformerConfig.tiny()
        kv = CacheManager(cfg, 4, 64, 8, append_widths=(8, 16), block=16)
        assert kv.table_width == 4 and kv.capacity == 64
        assert kv.pool.n_blocks == 4 * 4  # slots x table_width
        assert kv.append_slack == 16
        assert kv.reserve_tokens(10, 8) == 10 + 8 - 1 + 16
        pool, scales = kv.pool_tensors("cpu")
        assert pool.k.shape == (2, 16, 16, 2, 16) and pool.length.shape == (4,)
        assert pool.k.dtype == cfg.dtype and scales is None

    def test_ensure_release_cycle(self):
        cfg = TransformerConfig.tiny()
        kv = CacheManager(cfg, 2, 64, 8, block=16)
        assert kv.admit_reserve(20, 8)
        kv.attach(0, "r0", 20, 8)
        assert kv.ensure(0, 20) and kv.pool.blocks_in_use() == 2
        assert not kv.ensure(0, 30)  # still inside block 2
        t = kv.take_tables()
        assert t is not None and len(set(t[0, :2].tolist())) == 2
        assert kv.take_tables() is None  # unchanged since the last take
        kv.release_slot(0, owner="someone else")  # owner-checked: no-op
        assert kv.pool.blocks_in_use() == 2
        kv.release_slot(0, owner="r0")
        assert kv.pool.blocks_in_use() == 0 and kv.pool.reserved == 0

    def test_reservation_blocks_admission_when_pool_full(self):
        cfg = TransformerConfig.tiny()
        kv = CacheManager(cfg, 1, 64, 8, block=16)  # 1 slot: a 4-block pool
        assert kv.admit_reserve(40, 8)  # 40 + 8 - 1 + 8 = 55 rows -> 4 blocks
        assert not kv.admit_reserve(3, 8)
