"""gofr_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card. Imports nothing of JAX, so it runs on the GPU machine:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the repo-root conftest configures JAX). Without a CUDA
device every test here skips.
"""

import pytest
import torch

from gofr_tpu_torch.kvcache import quantize_rows
from gofr_tpu_torch.ops import attention as TA


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built and run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    """CUDA kernels against their plain versions at small shapes; f32 to
    summation order, bf16 to the bf16 output's rounding."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("offsets", [None, [0, 37, 200]])
    def test_flash(self, cuda, dtype, offsets):
        g = torch.Generator(device=cuda).manual_seed(0)
        q = torch.randn((3, 64, 8, 128), generator=g, device=cuda).to(dtype)
        k = torch.randn((3, 320, 2, 128), generator=g, device=cuda).to(dtype)
        v = torch.randn((3, 320, 2, 128), generator=g, device=cuda).to(dtype)
        off = None if offsets is None else torch.tensor(offsets, dtype=torch.int32, device=cuda)
        before = TA.flash_attention.launches
        got = TA.flash_attention(q, k, v, q_offsets=off, window=50, logit_cap=20.0)
        want = TA.flash_attention_plain(q, k, v, q_offsets=off, window=50, logit_cap=20.0)
        assert TA.flash_attention.launches == before + 1
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

    # bf16 runs the tensor-core kernel (GQA-packed 64-row tiles): every
    # group size (6 does not divide 64), head dim and chunk width, against
    # the plain version to the bf16 output's rounding
    @pytest.mark.parametrize("heads", [(8, 1), (8, 2), (8, 8), (6, 1)])
    @pytest.mark.parametrize("d", [64, 128, 256])
    @pytest.mark.parametrize("sq", [1, 5, 12, 64, 512])
    def test_flash_bf16_shapes(self, cuda, heads, d, sq):
        """sq < 512: chunk queries at per-batch offsets into a 320-row
        cache; sq = 512: one full causal prompt."""
        hq, hkv = heads
        g = torch.Generator(device=cuda).manual_seed(sq * 1000 + d + hq * 10 + hkv)
        b, sk = (3, 320) if sq < 512 else (1, 512)
        q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(torch.bfloat16)
        k = torch.randn((b, sk, hkv, d), generator=g, device=cuda).to(torch.bfloat16)
        v = torch.randn((b, sk, hkv, d), generator=g, device=cuda).to(torch.bfloat16)
        off = None if sq == 512 else torch.tensor([0, 37, 250], dtype=torch.int32, device=cuda)
        before = TA.flash_attention.launches
        got = TA.flash_attention(q, k, v, q_offsets=off)
        want = TA.flash_attention_plain(q, k, v, q_offsets=off)
        assert TA.flash_attention.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)

    @pytest.mark.parametrize("heads", [(8, 1), (8, 2), (8, 8), (6, 1)])
    @pytest.mark.parametrize("d", [64, 128, 256])
    @pytest.mark.parametrize(
        "kw", [dict(window=100), dict(logit_cap=30.0), dict(causal=False)],
        ids=["window100", "cap30", "noncausal"],
    )
    def test_flash_bf16_options(self, cuda, heads, d, kw):
        hq, hkv = heads
        g = torch.Generator(device=cuda).manual_seed(d + hq * 10 + hkv)
        for sq, offsets in ((64, [0, 37, 250]), (12, [5, 200, 300]), (512, None)):
            b, sk = (3, 320) if offsets else (1, 512)
            q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(torch.bfloat16)
            k = torch.randn((b, sk, hkv, d), generator=g, device=cuda).to(torch.bfloat16)
            v = torch.randn((b, sk, hkv, d), generator=g, device=cuda).to(torch.bfloat16)
            off = None if offsets is None else torch.tensor(offsets, dtype=torch.int32, device=cuda)
            before = TA.flash_attention.launches
            got = TA.flash_attention(q, k, v, q_offsets=off, **kw)
            want = TA.flash_attention_plain(q, k, v, q_offsets=off, **kw)
            assert TA.flash_attention.launches == before + 1
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)

    @pytest.mark.parametrize("heads", [(8, 1), (6, 1), (8, 2)])
    def test_flash_bf16_fully_masked_rows_are_zero(self, cuda, heads):
        """A window that ends before the cache does leaves rows that see no
        key: batch 1 (offset 200, window 50, 64 keys) entirely, batch 0
        (offset 60) from row 53 on, whose window starts at key 64."""
        hq, hkv = heads
        g = torch.Generator(device=cuda).manual_seed(5)
        q = torch.randn((2, 64, hq, 128), generator=g, device=cuda).to(torch.bfloat16)
        k = torch.randn((2, 64, hkv, 128), generator=g, device=cuda).to(torch.bfloat16)
        v = torch.randn((2, 64, hkv, 128), generator=g, device=cuda).to(torch.bfloat16)
        off = torch.tensor([60, 200], dtype=torch.int32, device=cuda)
        before = TA.flash_attention.launches
        got = TA.flash_attention(q, k, v, q_offsets=off, window=50)
        want = TA.flash_attention_plain(q, k, v, q_offsets=off, window=50)
        assert TA.flash_attention.launches == before + 1
        assert torch.count_nonzero(got[1]) == 0
        assert torch.count_nonzero(got[0, 53:]) == 0
        assert torch.count_nonzero(got[0, :53]) > 0
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)

    @pytest.mark.parametrize("c", [12, 5])
    def test_chunk_prefill_any_width_launches_flash(self, cuda, c):
        """A chunk width that is not a multiple of 8 still runs the kernel."""
        g = torch.Generator(device=cuda).manual_seed(2)
        q = torch.randn((2, c, 8, 128), generator=g, device=cuda)
        k = torch.randn((2, 64, 2, 128), generator=g, device=cuda)
        v = torch.randn((2, 64, 2, 128), generator=g, device=cuda)
        cursors = torch.tensor([0, 41], dtype=torch.int32, device=cuda)
        before = TA.flash_attention.launches
        got = TA.chunk_prefill_attention(q, k, v, cursors, window=20)
        want = TA.flash_attention_plain(q, k, v, q_offsets=cursors, window=20)
        assert TA.flash_attention.launches == before + 1
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_paged_decode(self, cuda, dtype):
        g = torch.Generator(device=cuda).manual_seed(1)
        q = torch.randn((4, 8, 128), generator=g, device=cuda).to(dtype)
        kp = torch.randn((64, 16, 2, 128), generator=g, device=cuda).to(dtype)
        vp = torch.randn((64, 16, 2, 128), generator=g, device=cuda).to(dtype)
        tables = torch.randperm(64, generator=g, device=cuda)[:32].reshape(4, 8).to(torch.int32)
        hi = torch.tensor([0, 1, 16, 127], dtype=torch.int32, device=cuda)
        lo = torch.tensor([0, 0, 3, 40], dtype=torch.int32, device=cuda)
        got = TA.paged_decode_partials(q, kp, vp, tables, lo, hi, scale=0.1, logit_cap=30.0)
        want = TA.paged_decode_partials_plain(q, kp, vp, tables, lo, hi, scale=0.1, logit_cap=30.0)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", [128, 16])
    def test_paged_decode_int8(self, cuda, dtype, d):
        """int8 pools with f32 row scales; both sides dequantize in f32, so
        only the summation order (and the kernel's folded K scale) differs."""
        g = torch.Generator(device=cuda).manual_seed(3)
        q = torch.randn((5, 8, d), generator=g, device=cuda).to(dtype)
        kq, ks = quantize_rows(torch.randn((64, 16, 2, d), generator=g, device=cuda))
        vq, vs = quantize_rows(torch.randn((64, 16, 2, d), generator=g, device=cuda))
        tables = torch.randperm(64, generator=g, device=cuda)[:40].reshape(5, 8).to(torch.int32)
        hi = torch.tensor([0, 1, 16, 37, 127], dtype=torch.int32, device=cuda)
        for lo in (torch.zeros_like(hi), torch.tensor([0, 0, 3, 20, 40], dtype=torch.int32, device=cuda)):
            kw = dict(scale=0.1, logit_cap=30.0, k_scales=ks, v_scales=vs)
            before = TA.paged_decode_partials.launches_int8
            got = TA.paged_decode_partials(q, kq, vq, tables, lo, hi, **kw)
            want = TA.paged_decode_partials_plain(q, kq, vq, tables, lo, hi, **kw)
            assert TA.paged_decode_partials.launches_int8 == before + 1
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)

    def test_paged_decode_int8_rejects_wrong_pool_dtype(self, cuda):
        q = torch.zeros((2, 8, 128), device=cuda)
        pool = torch.zeros((4, 16, 1, 128), device=cuda)  # f32, not int8
        sc = torch.ones((4, 16, 1), device=cuda)
        idx = torch.zeros((2,), dtype=torch.int32, device=cuda)
        tables = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
        with pytest.raises(TypeError, match="k_pool"):
            TA.paged_decode_partials(q, pool, pool, tables, idx, idx, scale=0.1, k_scales=sc, v_scales=sc)


def _split_pools(g, cuda, pool, nb, hkv, d):
    """(k_pool, v_pool, scales kwargs) of `pool` kind: float32, bfloat16,
    or int8 rows with f32 scales made by the port's quantize_rows."""
    shape = (nb, 16, hkv, d)
    if pool == "int8":
        kq, ks = quantize_rows(torch.randn(shape, generator=g, device=cuda))
        vq, vs = quantize_rows(torch.randn(shape, generator=g, device=cuda))
        return kq, vq, dict(k_scales=ks, v_scales=vs)
    dtype = torch.float32 if pool == "f32" else torch.bfloat16
    kp = torch.randn(shape, generator=g, device=cuda).to(dtype)
    vp = torch.randn(shape, generator=g, device=cuda).to(dtype)
    return kp, vp, {}


def _split_bands(splits, MB, b, B=16):
    """(lo, hi) lists that aim at the cluster split: bands of whole shares
    (k * splits slots), one row past them, fewer slots than splits (some
    CTAs empty), windows with lo > 0, empty bands and the full table."""
    cap = MB * B
    his = [splits * B, splits * B + 1, 2 * splits * B, 2 * splits * B + 1, cap, cap - 1, 1, B, 3 * B + 5, 0]
    his = [min(h, cap) for h in his]
    los = [0] * len(his)
    his += [cap, cap, splits * B + 1, 2 * B, 100]
    los += [cap - 40, B * (splits - 1) + 3, splits * B, 2 * B, 37]  # windows; (2B, 2B) is empty at lo > 0
    while len(his) < b:
        i = len(his)
        his.append((37 * i) % (cap + 1))
        los.append(max(0, his[-1] - (40 if i % 2 else 3 * B)))
    if b == 1:
        return [([lo], [hi]) for lo, hi in zip(los, his)]
    return [(los[:b], his[:b])]


@pytest.mark.cuda
class TestPagedSplitOnCard:
    """The paged-decode kernel splits each band's table slots over a
    cluster of CTAs and merges their partials over distributed shared
    memory: held against the plain version at the split's edges. f32 and
    int8 pools dequantize to the same f32 values on both sides, and bf16
    pools read the same bf16 values, so o differs by summation order only
    (atol 1e-4); m and l to rtol 1e-4, with atol 1e-5 for scores near 0."""

    @pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("group", [1, 2, 8, 16])
    @pytest.mark.parametrize("d", [16, 64, 256])
    def test_split_edges(self, cuda, pool, group, d):
        hkv = 2 if group == 2 else 1
        hq = group * hkv
        g = torch.Generator(device=cuda).manual_seed(d * 100 + group)
        q_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}.get(
            pool, torch.bfloat16 if group in (1, 8) else torch.float32
        )
        pool_dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[pool]
        counter = "launches_int8" if pool == "int8" else "launches"
        for case, (b, MB) in enumerate([(1, 8), (1, 32), (1, 128), (32, 8), (32, 32), (32, 128)]):
            splits, _smem = TA.paged_decode_plan(pool_dtype, b, hq, hkv, d, 16, MB)
            assert 1 <= splits <= min(8, MB)
            kp, vp, sc = _split_pools(g, cuda, pool, b * MB, hkv, d)
            tables = torch.randperm(b * MB, generator=g, device=cuda).reshape(b, MB).to(torch.int32)
            q = torch.randn((b, hq, d), generator=g, device=cuda).to(q_dtype)
            kw = dict(scale=d ** -0.5, logit_cap=30.0 if case % 2 else 0.0, **sc)
            for lo_l, hi_l in _split_bands(splits, MB, b):
                lo = torch.tensor(lo_l, dtype=torch.int32, device=cuda)
                hi = torch.tensor(hi_l, dtype=torch.int32, device=cuda)
                before = getattr(TA.paged_decode_partials, counter)
                o1, m1, l1 = TA.paged_decode_partials(q, kp, vp, tables, lo, hi, **kw)
                o2, m2, l2 = TA.paged_decode_partials_plain(q, kp, vp, tables, lo, hi, **kw)
                assert getattr(TA.paged_decode_partials, counter) == before + 1
                where = f"b={b} MB={MB} splits={splits} lo={lo_l[:4]} hi={hi_l[:4]}"
                torch.testing.assert_close(o1, o2, atol=1e-4, rtol=0, msg=lambda m: f"o {where}: {m}")
                torch.testing.assert_close(m1, m2, atol=1e-5, rtol=1e-4, msg=lambda m: f"m {where}: {m}")
                torch.testing.assert_close(l1, l2, atol=1e-5, rtol=1e-4, msg=lambda m: f"l {where}: {m}")

    @pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
    def test_all_empty_batch(self, cuda, pool):
        """Every band empty (lo >= hi, at 0 and past it): every CTA weighs 0
        in the merge, and the partials are exactly (0, NEG_INF, 0)."""
        g = torch.Generator(device=cuda).manual_seed(11)
        pool_dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[pool]
        for b in (1, 32):
            kp, vp, sc = _split_pools(g, cuda, pool, b * 32, 1, 256)
            q = torch.randn((b, 8, 256), generator=g, device=cuda).to(
                torch.float32 if pool == "f32" else torch.bfloat16
            )
            tables = torch.randperm(b * 32, generator=g, device=cuda).reshape(b, 32).to(torch.int32)
            hi = torch.tensor([(53 * i) % 400 for i in range(b)], dtype=torch.int32, device=cuda)
            assert TA.paged_decode_plan(pool_dtype, b, 8, 1, 256, 16, 32)[0] > 1
            for lo in (hi, hi + 7):
                o, m, l = TA.paged_decode_partials(q, kp, vp, tables, lo, hi, scale=1 / 16, **sc)
                assert torch.count_nonzero(o) == 0
                assert bool((m == TA.NEG_INF).all()) and torch.count_nonzero(l) == 0
