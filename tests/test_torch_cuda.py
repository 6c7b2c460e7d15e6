"""gofr_tpu_torch's CUDA kernels against their plain PyTorch versions, and
the engine's CUDA graphs against its eager programs, on the card. Imports
nothing of JAX, so it runs on the GPU machine:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the repo-root conftest configures JAX). Without a CUDA
device every test here skips.
"""

import dataclasses

import pytest
import torch

from gofr_tpu_torch.kvcache import quantize_rows
from gofr_tpu_torch.llm import GenRequest, LLMEngine
from gofr_tpu_torch.models import TransformerConfig, init_params
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

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("c", [1, 5, 17])
    def test_flash_verify_widths(self, cuda, dtype, c):
        """The verify program's chunk widths (W = draft + 1: 5 at the
        default draft, 17 at its clamp) at Gemma-2B's heads, q_offsets at
        decode-time cursors, one of them near the end of the cache."""
        g = torch.Generator(device=cuda).manual_seed(c)
        b, sk = 6, 256
        q = torch.randn((b, c, 8, 256), generator=g, device=cuda).to(dtype)
        k = torch.randn((b, sk, 1, 256), generator=g, device=cuda).to(dtype)
        v = torch.randn((b, sk, 1, 256), generator=g, device=cuda).to(dtype)
        off = torch.tensor([0, 3, 16, 77, 200, sk - c], dtype=torch.int32, device=cuda)
        before = TA.flash_attention.launches
        got = TA.flash_attention(q, k, v, q_offsets=off)
        want = TA.flash_attention_plain(q, k, v, q_offsets=off)
        assert TA.flash_attention.launches == before + 1
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

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


# the head shapes of the families beside Gemma-2B: Qwen2-7B's group of 7
# (hq 28 on hkv 4, head_dim 128; the paged kernel pads the group to 8) and
# Gemma-7B's multi-head attention (16 query and 16 KV heads at head_dim 256)
FAMILY_HEADS = [(28, 4, 128), (16, 16, 256)]


@pytest.mark.cuda
class TestFamilyShapesOnCard:
    """Both kernels at the families' head shapes against their plain
    versions, at reduced batch and length (chip_smoke.py's families phase
    runs the full ones): f32 to summation order, bf16 to the bf16 output's
    rounding; paged o to atol 1e-4, m and l to rtol 1e-4 (atol 1e-5 near
    0), as TestPagedSplitOnCard."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("heads", FAMILY_HEADS)
    @pytest.mark.parametrize("window", [0, 100])
    def test_flash_q_offsets(self, cuda, dtype, heads, window):
        hq, hkv, d = heads
        g = torch.Generator(device=cuda).manual_seed(hq + d + window)
        q = torch.randn((3, 64, hq, d), generator=g, device=cuda).to(dtype)
        k = torch.randn((3, 320, hkv, d), generator=g, device=cuda).to(dtype)
        v = torch.randn((3, 320, hkv, d), generator=g, device=cuda).to(dtype)
        off = torch.tensor([0, 37, 250], dtype=torch.int32, device=cuda)
        before = TA.flash_attention.launches
        got = TA.flash_attention(q, k, v, q_offsets=off, window=window)
        want = TA.flash_attention_plain(q, k, v, q_offsets=off, window=window)
        assert TA.flash_attention.launches == before + 1
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

    @pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("heads", FAMILY_HEADS)
    def test_paged_decode(self, cuda, pool, heads):
        """32 sequences (Qwen2's padding row of the group of 7 must read no
        q and write no o, and stay out of the merge), full bands and bands
        with lo > 0, both entry points."""
        hq, hkv, d = heads
        g = torch.Generator(device=cuda).manual_seed(hq * d)
        b, MB = 32, 8
        kp, vp, sc = _split_pools(g, cuda, pool, b * MB, hkv, d)
        q = torch.randn((b, hq, d), generator=g, device=cuda).to(
            torch.float32 if pool == "f32" else torch.bfloat16
        )
        tables = torch.randperm(b * MB, generator=g, device=cuda).reshape(b, MB).to(torch.int32)
        hi = torch.tensor([(37 * i) % (MB * 16 + 1) for i in range(b)], dtype=torch.int32, device=cuda)
        counter = "launches_int8" if pool == "int8" else "launches"
        for lo in (torch.zeros_like(hi), torch.clamp(hi - 40, min=0).to(torch.int32)):
            before = getattr(TA.paged_decode_partials, counter)
            o1, m1, l1 = TA.paged_decode_partials(q, kp, vp, tables, lo, hi, scale=d ** -0.5, **sc)
            o2, m2, l2 = TA.paged_decode_partials_plain(q, kp, vp, tables, lo, hi, scale=d ** -0.5, **sc)
            assert getattr(TA.paged_decode_partials, counter) == before + 1
            torch.testing.assert_close(o1, o2, atol=1e-4, rtol=0)
            torch.testing.assert_close(m1, m2, atol=1e-5, rtol=1e-4)
            torch.testing.assert_close(l1, l2, atol=1e-5, rtol=1e-4)

    @pytest.mark.parametrize("pool", ["bf16", "int8"])
    def test_paged_band_above_zero_over_a_wide_table(self, cuda, pool):
        """Mistral's decode band [hi - window, hi) past the window: 36 table
        slots of 16 rows, lo > 0 on every sequence (hq 32 on hkv 8, head_dim
        128, window 400)."""
        g = torch.Generator(device=cuda).manual_seed(36)
        b, MB, hq, hkv, d = 4, 36, 32, 8, 128
        kp, vp, sc = _split_pools(g, cuda, pool, b * MB, hkv, d)
        q = torch.randn((b, hq, d), generator=g, device=cuda).to(torch.bfloat16)
        tables = torch.randperm(b * MB, generator=g, device=cuda).reshape(b, MB).to(torch.int32)
        hi = torch.tensor([450, 517, 560, 576], dtype=torch.int32, device=cuda)
        lo = (hi - 400).to(torch.int32)
        o1, m1, l1 = TA.paged_decode_partials(q, kp, vp, tables, lo, hi, scale=d ** -0.5, **sc)
        o2, m2, l2 = TA.paged_decode_partials_plain(q, kp, vp, tables, lo, hi, scale=d ** -0.5, **sc)
        torch.testing.assert_close(o1, o2, atol=1e-4, rtol=0)
        torch.testing.assert_close(m1, m2, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(l1, l2, atol=1e-5, rtol=1e-4)


def _tiny_engine(cuda, mode, **kw):
    """A tiny engine on the card: f32 (the FMA flash kernel), bf16 at
    head_dim 64 (the tensor-core flash kernel), or int8 weights and KV
    at widths cuBLASLt's int8 product takes (it refuses 17 rows at
    d_model 64)."""
    cfg = TransformerConfig.tiny()
    if mode == "bf16":
        cfg = dataclasses.replace(cfg, head_dim=64, dtype=torch.bfloat16)
    if mode == "int8":
        cfg = dataclasses.replace(
            cfg, d_model=512, n_heads=8, n_kv_heads=2, head_dim=64, d_ff=1024, dtype=torch.bfloat16
        )
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    int8 = mode == "int8"
    return LLMEngine(cfg, params, device=cuda, slots=4, max_seq_len=64, prefill_buckets=(8, 16),
                     kv_int8=int8, quantize=int8, **kw)


@pytest.mark.cuda
class TestGraphsOnCard:
    """The engine's program families as CUDA graphs at tiny size: every
    replay bitwise equal to the eager program on the same state and
    inputs, kernel counters that count each replay's launches, fresh
    draws per replay, and the same tokens with the families captured at
    warmup or at their first dispatch."""

    @pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
    def test_replays_equal_eager_and_count_launches(self, cuda, mode):
        from chip_smoke import check_family

        eng = _tiny_engine(cuda, mode)
        try:
            # chunk shapes {8, 16} x widths {1, 2, 4}, and K in {8, 2}
            assert sorted(eng.families) == sorted(
                [f"llm.step_p{s}_d8.w{w}" for s in (8, 16) for w in (1, 2, 4)]
                + ["llm.decode_chunk8", "llm.decode_chunk2"]
            )
            assert eng.stats()["warmup_s"] > 0
            paged = "paged_decode_partials_int8" if mode == "int8" else "paged_decode_partials"
            for i, name in enumerate(eng.families):
                r = check_family(eng, name, seed=i, replays=3)
                assert r["eager_equal"], (name, r["state_equal"])
                assert r["launches"] == {k: 3 * n for k, n in r["captured"].items()}, name
                k = 2 if name == "llm.decode_chunk2" else 8
                assert r["captured"][paged] == k * eng.cfg.n_layers, (name, r["captured"])
                assert r["captured"].get("flash_attention", 0) == (eng.cfg.n_layers if "step" in name else 0)
            for name in ("llm.decode_chunk8", "llm.step_p16_d8.w4"):
                assert check_family(eng, name, seed=50, temperature=1000.0, replays=2)["draws_differ"], name
        finally:
            eng.close()

    @pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
    def test_verify_family_replays_equal_eager(self, cuda, mode):
        """``llm.step_v5`` of a speculating engine: 11 families (the 10
        above plus the verify), each replay bitwise its eager program on a
        random state and pack, the flash kernel once per layer per replay
        and no paged kernel; fresh draws at a high temperature."""
        from chip_smoke import check_family

        eng = _tiny_engine(cuda, mode, speculative=True)
        try:
            assert sorted(eng.families) == sorted(
                [f"llm.step_p{s}_d8.w{w}" for s in (8, 16) for w in (1, 2, 4)]
                + ["llm.decode_chunk8", "llm.decode_chunk2", "llm.step_v5"]
            )
            r = check_family(eng, "llm.step_v5", seed=7, replays=3)
            assert r["eager_equal"], r["state_equal"]
            assert r["launches"] == {k: 3 * n for k, n in r["captured"].items()}
            assert r["captured"].get("flash_attention") == eng.cfg.n_layers
            assert not any(n for k, n in r["captured"].items() if k.startswith("paged_decode"))
            assert check_family(eng, "llm.step_v5", seed=8, temperature=1000.0, replays=2)["draws_differ"]
        finally:
            eng.close()

    @pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
    def test_constrained_families_replay_equal_eager_and_recapture(self, cuda, mode):
        """No constrained family at warmup; the first constrained request
        captures them all (the verify's twin too), each replay bitwise its
        eager program with grammar ids and DFA states set. A grammar past
        the table's padding grows it and captures them again; one within
        it is written in place, with no capture."""
        import re

        from chip_smoke import check_family
        from gofr_tpu_torch.llm import GenRequest
        from gofr_tpu_torch.models.tokenizer import ByteTokenizer
        from gofr_tpu_torch.structured import compile_json_schema, compile_regex, vocab_from_tokenizer

        eng = _tiny_engine(cuda, mode, speculative=True)
        try:
            main = sorted(eng.families)
            assert eng._programs_g and not set(eng._programs_g) & set(main) and eng.g_captures == 0
            tok = ByteTokenizer(eng.cfg.vocab_size)
            vocab = vocab_from_tokenizer(tok)

            def serve(grammar, pattern, new_tokens=40):
                r = eng.submit(GenRequest([1, 2, 3], max_new_tokens=new_tokens, grammar=grammar))
                text = tok.decode(r.tokens(timeout=300))
                assert r.finish_reason == "eos" and re.fullmatch(pattern, text), text
                return tuple(eng._gtab.shape[:2]), eng.g_captures

            assert serve(compile_json_schema({"type": "boolean"}, vocab, tok.eos_id), "true|false") == ((1, 32), 1)
            assert sorted(eng.families) == sorted(main + list(eng._programs_g))
            for i, name in enumerate(eng._programs_g):
                r = check_family(eng, name, seed=i, replays=2)
                assert r["eager_equal"], (name, r["state_equal"])
                assert r["launches"] == {k: 2 * n for k, n in r["captured"].items()}, name
            assert serve(compile_json_schema({"type": "null"}, vocab, tok.eos_id), "null") == ((2, 32), 2)
            assert serve(compile_regex("[ab]{33,36}", vocab, tok.eos_id), "[ab]{33,36}") == ((4, 64), 3)
            for i, name in enumerate(eng._programs_g):
                assert check_family(eng, name, seed=20 + i)["eager_equal"], name
            # within the padding: written in place, nothing captured
            assert serve(compile_json_schema({"enum": ["yes", "no"]}, vocab, tok.eos_id), '"yes"|"no"') == ((4, 64), 3)
        finally:
            eng.close()

    def test_spec_engine_serves_the_spec_off_tokens(self, cuda):
        """Greedy tokens with every verify on the card, whatever its
        drafts: a drafter that always proposes the last token repeated."""

        class RepeatDrafter:
            def draft(self, tokens, k):
                return [tokens[-1]] * k if k > 0 else []

        plain = _tiny_engine(cuda, "f32")
        spec = _tiny_engine(cuda, "f32", speculative=True)
        spec.drafter = RepeatDrafter()
        try:
            for prompt in (([5, 6, 7, 8] * 8)[:20], list(range(5, 25))):
                assert spec.generate(prompt, max_new_tokens=30) == plain.generate(prompt, max_new_tokens=30)
            assert spec.stats()["spec"]["steps"] > 0
        finally:
            plain.close()
            spec.close()

    def test_lazy_capture_serves_the_same_tokens(self, cuda):
        warm = _tiny_engine(cuda, "f32")
        lazy = _tiny_engine(cuda, "f32", warmup=False, lookahead=1)
        try:
            assert not lazy.families and lazy.stats()["warmup_s"] is None
            for prompt in ([1, 2, 3], list(range(5, 25))):
                assert lazy.generate(prompt, max_new_tokens=19) == warm.generate(prompt, max_new_tokens=19)
            assert lazy.families  # captured at their first dispatch
        finally:
            warm.close()
            lazy.close()


@pytest.mark.cuda
class TestPrefixOnCard:
    """The prefix cache's device work on the card: block copies with an
    int8 pool's scales, the sharing engine's families (kv_seed and the hit
    programs included) as CUDA graphs, and its exact and partial hits."""

    def test_copy_blocks_int8_scales_match_the_cpu(self, cuda):
        from gofr_tpu_torch.kvcache import copy_blocks, gather_blocks_host

        g = torch.Generator().manual_seed(4)
        L, NB, B, h, d = 3, 12, 16, 2, 64
        k = torch.randint(-127, 128, (L, NB, B, h, d), generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, (L, NB, B, h, d), generator=g, dtype=torch.int8)
        sc = torch.rand((2, L, NB, B, h), generator=g)
        srcs = torch.tensor([2, 9, 4, 0, 7], dtype=torch.int32)
        dsts = torch.tensor([5, NB, 11, 3, NB + 2], dtype=torch.int32)  # two pad lanes
        dk, dv, dsc = k.to(cuda), v.to(cuda), sc.to(cuda)
        copy_blocks(dk, dv, srcs.to(cuda), dsts.to(cuda), scales=dsc)
        copy_blocks(k, v, srcs, dsts, scales=sc)
        torch.cuda.synchronize()
        assert torch.equal(dk.cpu(), k) and torch.equal(dv.cpu(), v) and torch.equal(dsc.cpu(), sc)
        assert torch.equal(sc[:, :, 11], sc[:, :, 4]) and torch.equal(k[:, 5], k[:, 2])
        hk, hv, hs = gather_blocks_host(dk, dv, [11, 5, 0], scales=dsc)
        assert hk.is_pinned() and torch.equal(hk, k[:, [11, 5, 0]]) and torch.equal(hs, sc[:, :, [11, 5, 0]])
        assert torch.equal(hv, v[:, [11, 5, 0]])

    @pytest.mark.parametrize("mode", ["f32", "int8"])
    def test_sharing_families_replay_equal_eager(self, cuda, mode):
        from chip_smoke import check_family

        eng = _tiny_engine(cuda, mode, prefix_cache_mb=1.0, session_mb=1.0)
        try:
            assert sorted(eng.families) == sorted(eng._programs) and "llm.kv_seed" in eng.families
            assert {f"llm.hit_first.w{w}" for w in (1, 2, 4)} <= set(eng.families)
            for i, name in enumerate(eng.families):
                r = check_family(eng, name, seed=i, replays=2)
                assert r["eager_equal"], (name, r["state_equal"])
                kind = eng._programs[name][1]
                assert (kind in ("seed", "hit")) == (not any(r["captured"].values())), (name, r["captured"])
            assert check_family(eng, "llm.hit_first.w4", seed=60, temperature=1000.0, replays=2)["draws_differ"]
        finally:
            eng.close()

    def test_exact_and_partial_hits_serve_the_unshared_tokens(self, cuda):
        plain = _tiny_engine(cuda, "f32")
        shared = _tiny_engine(cuda, "f32", prefix_cache_mb=1.0)
        try:
            base = list(range(5, 45))
            sib = base[:20] + list(range(100, 110))
            for p in (base, base, sib):
                assert shared.generate(p, max_new_tokens=12) == plain.generate(p, max_new_tokens=12)
            st = shared.stats()["kvcache"]["prefix"]
            assert st["hits"] == 1 and st["partial_hits"] == 1 and st["misses"] == 1
        finally:
            plain.close()
            shared.close()


@pytest.mark.cuda
class TestLoraOnCard:
    """A LoRA engine's captured programs on the card: every family's replay
    bitwise its eager program with mixed adapter ids live (the step's
    prefill rows gather their slots' ids; padding lanes clamp), the same
    families as without the pool, and a hot-load that writes a gid's rows
    in place: the graphs keep reading the same table addresses, nothing is
    captured, and the adapter's tokens come out."""

    @staticmethod
    def _adapters(cfg, cuda):
        from gofr_tpu_torch.lora import init_adapter

        g = torch.Generator(device=cuda).manual_seed(3)
        return (init_adapter(g, cfg, 8, scale=0.5), init_adapter(g, cfg, 4, scale=0.5),
                init_adapter(g, cfg, 8, scale=0.5, targets=("wq", "wkv", "wo")))

    @pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
    def test_families_replay_equal_eager_with_mixed_aids(self, cuda, mode):
        from chip_smoke import check_family

        plain = _tiny_engine(cuda, mode, speculative=True)
        names = sorted(plain.families)
        plain.close()
        eng = _tiny_engine(cuda, mode, speculative=True, lora_slots=3)
        try:
            assert sorted(eng.families) == names
            for i, ad in enumerate(self._adapters(eng.cfg, cuda)):
                eng.load_adapter(f"t{i}", ad)
            for i, name in enumerate(eng.families):
                r = check_family(eng, name, seed=i, replays=2)
                assert r["eager_equal"], (name, r["state_equal"])
                assert r["launches"] == {k: 2 * n for k, n in r["captured"].items()}, name
        finally:
            eng.close()

    def test_hot_load_in_place_keeps_graph_addresses(self, cuda):
        """Loads, an eviction and a publish after warmup: the tables keep
        their addresses, the families and memory_reserved are unchanged, and
        the adapted tokens equal those of an engine that loaded the same
        adapter before capturing anything."""
        from gofr_tpu_torch.llm import GenRequest

        eng = _tiny_engine(cuda, "f32", lora_slots=2)
        lazy = _tiny_engine(cuda, "f32", lora_slots=2, warmup=False, lookahead=1)
        try:
            a, b, c = self._adapters(eng.cfg, cuda)
            ptrs = {k: v.data_ptr() for k, v in eng.params["layers"].items() if k.startswith("lora_")}
            fams = dict(eng.families)
            torch.cuda.synchronize()
            reserved = torch.cuda.memory_reserved()
            eng.load_adapter("a", a)
            eng.load_adapter("b", b)
            eng.load_adapter("c", c)  # evicts the LRU idle adapter "a"
            eng.load_adapter("b@v2", a, version="v2")  # evicts "b"... then publish over it
            assert sorted(eng.adapters()["resident"]) == ["b@v2", "c"]
            eng.publish_adapter("b@v2", "b")
            torch.cuda.synchronize()
            assert {k: v.data_ptr() for k, v in eng.params["layers"].items() if k.startswith("lora_")} == ptrs
            assert eng.families == fams and torch.cuda.memory_reserved() == reserved
            lazy.load_adapter("b", a)
            lazy.load_adapter("c", c)
            for prompt, name in (([1, 2, 3], "b"), (list(range(5, 25)), "c"), (list(range(5, 25)), "")):
                want = lazy.submit(GenRequest(prompt, max_new_tokens=19, adapter=name)).tokens(timeout=300)
                assert eng.submit(GenRequest(prompt, max_new_tokens=19, adapter=name)).tokens(timeout=300) == want
            assert eng.families == fams
        finally:
            eng.close()
            lazy.close()


@pytest.mark.cuda
class TestMoEOnCard:
    """The mixture-of-experts FFN on the card: captured in a CUDA graph, a
    replay is bitwise its eager call (float32, bfloat16 and int8 stacks)
    and follows new inputs written in place; the served form agrees with
    the plain one; a tiny_moe engine's families replay bitwise their eager
    programs."""

    @pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
    def test_moe_ffn_graph_replay_bitwise(self, cuda, mode):
        from gofr_tpu_torch.models import moe as TM
        from gofr_tpu_torch.models.quant import quantize

        g = torch.Generator(device=cuda).manual_seed(0)
        T, d, ff, E = 32, 256, 512, 8
        dt = torch.float32 if mode == "f32" else torch.bfloat16

        def r(*shape, fan_in=1):
            return torch.randn(shape, generator=g, device=cuda) / fan_in**0.5

        wr = r(d, E, fan_in=d)
        ws = [r(E, d, ff, fan_in=d), r(E, d, ff, fan_in=d), r(E, ff, d, fan_in=ff)]
        ws = [quantize(w, dt) for w in ws] if mode == "int8" else [w.to(dt) for w in ws]
        kw = dict(n_experts=E, top_k=2, capacity_factor=1.25, act="silu")
        x = r(T, d).to(dt)
        static = x.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            TM.moe_ffn(static, wr, *ws, **kw)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, aux = TM.moe_ffn(static, wr, *ws, **kw)
        for _ in range(2):  # a second input, written in place, routes differently
            want, want_aux = TM.moe_ffn(x, wr, *ws, **kw)
            static.copy_(x)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want) and torch.equal(aux, want_aux)
            plain, _ = TM.moe_ffn_plain(x, wr, *ws, **kw)
            tol = 1e-4 if mode == "f32" else 2e-2
            torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)
            x = r(T, d).to(dt)

    @pytest.mark.parametrize("mode", ["f32", "bf16"])
    def test_engine_families_replay_equal_eager(self, cuda, mode):
        from chip_smoke import check_family

        cfg = TransformerConfig.tiny_moe()
        if mode == "bf16":
            cfg = dataclasses.replace(cfg, head_dim=64, dtype=torch.bfloat16)
        params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
        eng = LLMEngine(cfg, params, device=cuda, slots=4, max_seq_len=64, prefill_buckets=(8, 16),
                        speculative=True)
        try:
            assert eng.stats()["moe_experts"] == 4 and len(eng.families) == 9
            for i, name in enumerate(eng.families):
                r = check_family(eng, name, seed=i, replays=2)
                assert r["eager_equal"], (name, r["state_equal"])
                assert r["launches"] == {k: 2 * n for k, n in r["captured"].items()}, name
        finally:
            eng.close()


def _contiguous_engine(cuda, layout, mode, **kw):
    """A tiny contiguous engine on the card: tiny_mistral on its rolling
    ring (window 8, 8 + 16 rows a slot) or tiny on the dense slab, in f32
    or bf16 at head_dim 64 (the tensor-core flash kernel on the slab)."""
    cfg = TransformerConfig.tiny_mistral() if layout == "ring" else TransformerConfig.tiny()
    if mode == "bf16":
        cfg = dataclasses.replace(cfg, head_dim=64, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    return LLMEngine(cfg, params, device=cuda, slots=4, max_seq_len=64, prefill_buckets=(8, 16), kv_paged=False, **kw)


@pytest.mark.cuda
class TestContiguousOnCard:
    """The contiguous KV layouts' program families as CUDA graphs: every
    replay bitwise its eager program on a random state (a ring's lengths
    past its capacity), flash once per layer in each step and verify on
    the slab, no kernel on the ring, no paged kernel on either; fresh
    draws at a high temperature; greedy tokens equal to the paged
    engine's."""

    @pytest.mark.parametrize("mode", ["f32", "bf16"])
    @pytest.mark.parametrize("layout", ["dense", "ring"])
    def test_families_replay_equal_eager(self, cuda, layout, mode):
        from chip_smoke import check_family

        eng = _contiguous_engine(cuda, layout, mode, speculative=True)
        try:
            assert eng.stats()["kvcache"]["layout"] == ("rolling" if layout == "ring" else "dense")
            assert sorted(eng.families) == sorted(
                [f"llm.step_p{s}_d8.w{w}" for s in (8, 16) for w in (1, 2, 4)]
                + ["llm.decode_chunk8", "llm.decode_chunk2", "llm.step_v5"]
            )
            for i, name in enumerate(eng.families):
                r = check_family(eng, name, seed=i, replays=2)
                assert r["eager_equal"], (name, r["state_equal"])
                assert r["launches"] == {k: 2 * n for k, n in r["captured"].items()}, name
                assert not any(n for k, n in r["captured"].items() if k.startswith("paged_decode")), name
                flash = eng.cfg.n_layers if layout == "dense" and "step" in name else 0
                assert r["captured"].get("flash_attention", 0) == flash, (name, r["captured"])
            for name in ("llm.decode_chunk8", "llm.step_p16_d8.w4", "llm.step_v5"):
                assert check_family(eng, name, seed=50, temperature=1000.0, replays=2)["draws_differ"], name
        finally:
            eng.close()

    @pytest.mark.parametrize("layout", ["dense", "ring"])
    def test_serves_the_paged_tokens(self, cuda, layout):
        """f32 greedy streams past the ring's capacity, contiguous against
        the paged pool on the same weights, at lookahead 3."""
        cont = _contiguous_engine(cuda, layout, "f32")
        paged = LLMEngine(cont.cfg, cont.params, device=cuda, slots=4, max_seq_len=64, prefill_buckets=(8, 16),
                          kv_paged=True)
        try:
            prompts = [list(range(5, 25)), [3, 1, 4, 1, 5, 9, 2, 6], list(range(40, 73))]
            want = [paged.generate(p, max_new_tokens=24) for p in prompts]
            reqs = [cont.submit(GenRequest(p, max_new_tokens=24)) for p in prompts]
            assert [r.tokens(timeout=300) for r in reqs] == want
        finally:
            cont.close()
            paged.close()

    @pytest.mark.parametrize("layout", ["dense", "ring"])
    def test_hit_insert_issues_no_host_sync(self, cuda, layout):
        """Seeding a slot from a stored prefix (``_insert_rows``, run by
        every exact and partial hit) is only enqueued on the engine
        stream: under torch's sync debug mode it raises nothing. A host
        sync there holds the hit's admission behind every program in
        flight. The slot then holds the entry's rows and length."""
        eng = _contiguous_engine(cuda, layout, "f32", prefix_cache_mb=1)
        try:
            prompt = list(range(5, 25))
            eng.generate(prompt, max_new_tokens=4)
            e, exact = eng.kv.prefix.lookup_longest(prompt, allow_partial=False)
            assert e is not None and exact
            slot, n = eng.slots - 1, e.k.shape[2]
            with eng._lock, torch.cuda.stream(eng._stream):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    eng._insert_rows(slot, e)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                eng._stream.synchronize()
                assert torch.equal(eng.cache.k[:, slot, :n], e.k[:, 0])
                assert torch.equal(eng.cache.v[:, slot, :n], e.v[:, 0])
                assert int(eng.cache.length[slot]) == e.length == len(prompt)
            eng.kv.prefix.release(e)
        finally:
            eng.close()


def _wave_engine(cuda, layout, mode, **kw):
    """A tiny wave engine (step_token_budget=0) on the card: tiny on the
    pool or the slab, tiny_mistral on its ring (8 + 8 rows a slot), f32
    or bf16 at head_dim 64 (the tensor-core flash kernel)."""
    cfg = TransformerConfig.tiny_mistral() if layout == "ring" else TransformerConfig.tiny()
    if mode == "bf16":
        cfg = dataclasses.replace(cfg, head_dim=64, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    return LLMEngine(cfg, params, device=cuda, slots=4, max_seq_len=64, prefill_buckets=(8, 16),
                     kv_paged=layout == "pool", step_token_budget=0, **kw)


@pytest.mark.cuda
class TestWaveOnCard:
    """The wave scheduler's whole-prompt prefill on the card: ``prefill``
    (flash in its full-prompt mode, counted apart) against the plain
    forward; every wave family's replay bitwise its eager program with its
    launches; greedy tokens equal to the chunked scheduler's."""

    @pytest.mark.parametrize("mode", ["f32", "bf16"])
    @pytest.mark.parametrize("name", ["tiny", "tiny_mistral"])
    def test_prefill_matches_the_plain_forward(self, cuda, mode, name):
        from gofr_tpu_torch.models import transformer_forward
        from gofr_tpu_torch.models.transformer import prefill

        cfg = getattr(TransformerConfig, name)()
        if mode == "bf16":
            cfg = dataclasses.replace(cfg, head_dim=64, dtype=torch.bfloat16)
        params = init_params(cfg, torch.Generator(device=cuda).manual_seed(1), cuda)
        g = torch.Generator(device=cuda).manual_seed(2)
        toks = torch.randint(1, cfg.vocab_size, (3, 40), generator=g, device=cuda)
        lens = torch.tensor([40, 17, 3], dtype=torch.int32, device=cuda)
        before = (TA.flash_attention.launches, TA.flash_attention.launches_prompt)
        logits, cache = prefill(params, cfg, toks, lens, 48)
        assert (TA.flash_attention.launches, TA.flash_attention.launches_prompt) == (
            before[0] + cfg.n_layers, before[1] + cfg.n_layers)
        tol = 1e-3 if mode == "f32" else 0.15
        for i, n in enumerate(lens.tolist()):
            want = transformer_forward(params, cfg, toks[i : i + 1, :n], torch.arange(n, device=cuda)[None, :],
                                       unembed_positions=torch.tensor([n - 1], device=cuda))[0, 0]
            torch.testing.assert_close(logits[i], want, atol=tol, rtol=tol)
        assert cache.k.shape == (cfg.n_layers, 3, 48, cfg.n_kv_heads, cfg.head_dim)
        assert not cache.k[:, :, 40:].any() and cache.length.tolist() == [40, 17, 3]

    @pytest.mark.parametrize("mode", ["f32", "bf16"])
    @pytest.mark.parametrize("layout", ["pool", "slab", "ring"])
    def test_wave_families_replay_equal_eager(self, cuda, layout, mode):
        from chip_smoke import check_family

        eng = _wave_engine(cuda, layout, mode, prefix_cache_mb=1)
        try:
            waves = [f"llm.prefill_b{b}.w{w}" for b in (8, 16, 64) for w in (1, 2, 4)]
            assert eng._lazy == {n for n in waves if "_b64." in n}
            assert not any(n.startswith("llm.step_p") for n in eng.families)
            for i, name in enumerate(sorted(eng._programs)):
                r = check_family(eng, name, seed=i, replays=2)
                assert r["eager_equal"], (name, r["state_equal"])
                assert r["launches"] == {k: 2 * n for k, n in r["captured"].items()}, name
                flash = eng.cfg.n_layers if name in waves else 0
                assert r["captured"].get("flash_attention", 0) == flash, (name, r["captured"])
                assert r["captured"].get("flash_attention_prompt", 0) == flash, (name, r["captured"])
            for name in ("llm.decode_chunk8", "llm.prefill_b16.w4", "llm.hit_first.w4"):
                assert check_family(eng, name, seed=50, temperature=1000.0, replays=2)["draws_differ"], name
        finally:
            eng.close()

    @pytest.mark.parametrize("layout", ["pool", "slab", "ring"])
    def test_wave_serves_the_chunked_tokens(self, cuda, layout):
        """f32 greedy streams (buckets 8, 16 and the lazy 64), the wave
        against the chunked scheduler on the same weights, then again as
        exact prefix hits."""
        wave = _wave_engine(cuda, layout, "f32", prefix_cache_mb=1)
        chunked = LLMEngine(wave.cfg, wave.params, device=cuda, slots=4, max_seq_len=64, prefill_buckets=(8, 16),
                            kv_paged=layout == "pool")
        try:
            prompts = [list(range(5, 25)), [3, 1, 4, 1, 5, 9, 2, 6], list(range(40, 73)), [7, 7, 8]]
            want = [chunked.generate(p, max_new_tokens=20) for p in prompts]
            for _round in range(2):
                reqs = [wave.submit(GenRequest(p, max_new_tokens=20)) for p in prompts]
                assert [r.tokens(timeout=300) for r in reqs] == want
            assert wave.stats()["kvcache"]["prefix"]["hits"] == 4
        finally:
            wave.close()
            chunked.close()


# The shape knobs' KV blocks and chunk widths (chip_smoke.py's kernels and
# knobs phases run them at full size): Gemma-2B's heads (8 on 1 at 256)
# and Llama-3-8B's (32 on 8 at 128)
KNOB_HEADS = [(8, 1, 256), (32, 8, 128)]


def _knob_pools(g, cuda, pool, nb, B, hkv, d):
    """`pool` kind pools [nb, B, hkv, d] (as _split_pools, any block)."""
    shape = (nb, B, hkv, d)
    if pool == "int8":
        kq, ks = quantize_rows(torch.randn(shape, generator=g, device=cuda))
        vq, vs = quantize_rows(torch.randn(shape, generator=g, device=cuda))
        return kq, vq, dict(k_scales=ks, v_scales=vs)
    dtype = torch.float32 if pool == "f32" else torch.bfloat16
    return (torch.randn(shape, generator=g, device=cuda).to(dtype),
            torch.randn(shape, generator=g, device=cuda).to(dtype), {})


@pytest.mark.cuda
class TestKnobsOnCard:
    """Kernel rows 3-4 at 8- and 32-row KV blocks and row 1 at the prefill
    chunk widths 32, 128 and 256 and the verify width 33, against their
    plain versions (paged o to atol 1e-4, m and l to rtol 1e-4 with atol
    1e-5 near 0; flash f32 1e-4, bf16 2e-2); a block past the card's
    shared memory raises naming the limit; engines at other knobs replay
    every family bitwise and serve the default engine's greedy tokens."""

    @pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("heads", KNOB_HEADS)
    @pytest.mark.parametrize("B", [8, 32])
    def test_paged_decode_blocks(self, cuda, pool, heads, B):
        hq, hkv, d = heads
        g = torch.Generator(device=cuda).manual_seed(B * 1000 + hq)
        b, MB = 32, 512 // B
        pool_dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[pool]
        splits, smem = TA.paged_decode_plan(pool_dtype, b, hq, hkv, d, B, MB)
        assert 1 <= splits <= min(8, MB)
        assert smem <= torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
        kp, vp, sc = _knob_pools(g, cuda, pool, b * MB, B, hkv, d)
        q = torch.randn((b, hq, d), generator=g, device=cuda).to(torch.float32 if pool == "f32" else torch.bfloat16)
        tables = torch.randperm(b * MB, generator=g, device=cuda).reshape(b, MB).to(torch.int32)
        hi = torch.tensor([0, 1, B - 1, B, B + 1, 511, 512] + [(37 * i) % 513 for i in range(b - 7)],
                          dtype=torch.int32, device=cuda)
        counter = "launches_int8" if pool == "int8" else "launches"
        for lo, cap in ((torch.zeros_like(hi), 0.0), (torch.clamp(hi - 40, min=0).to(torch.int32), 30.0)):
            before = getattr(TA.paged_decode_partials, counter)
            o1, m1, l1 = TA.paged_decode_partials(q, kp, vp, tables, lo, hi, scale=d ** -0.5, logit_cap=cap, **sc)
            o2, m2, l2 = TA.paged_decode_partials_plain(q, kp, vp, tables, lo, hi, scale=d ** -0.5, logit_cap=cap,
                                                        **sc)
            assert getattr(TA.paged_decode_partials, counter) == before + 1
            torch.testing.assert_close(o1, o2, atol=1e-4, rtol=0)
            torch.testing.assert_close(m1, m2, atol=1e-5, rtol=1e-4)
            torch.testing.assert_close(l1, l2, atol=1e-5, rtol=1e-4)

    def test_block_past_the_shared_memory_limit_raises(self, cuda):
        """f32 pools at head_dim 256 in 64-row blocks need ~400 KB of ring
        a CTA: the wrapper refuses, naming the bytes and the limit."""
        q = torch.zeros((2, 8, 256), device=cuda)
        pool = torch.zeros((4, 64, 1, 256), device=cuda)
        idx = torch.zeros((2,), dtype=torch.int32, device=cuda)
        tables = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
        limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
        with pytest.raises(ValueError, match=f"64-row KV blocks.*over this card's limit of {limit}"):
            TA.paged_decode_partials(q, pool, pool, tables, idx, idx, scale=0.1)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("c", [32, 128, 256, 33])
    def test_flash_knob_widths(self, cuda, dtype, c):
        """q [b, c, 8, 256] against 512 cached rows at offsets reaching the
        cache's end (c = 33: 32 decode-time cursors of the verify)."""
        g = torch.Generator(device=cuda).manual_seed(c)
        b = 32 if c == 33 else 4
        q = torch.randn((b, c, 8, 256), generator=g, device=cuda).to(dtype)
        k = torch.randn((b, 512, 1, 256), generator=g, device=cuda).to(dtype)
        v = torch.randn((b, 512, 1, 256), generator=g, device=cuda).to(dtype)
        offs = [(37 * i) % (512 - c) for i in range(b - 1)] + [512 - c]
        off = torch.tensor(offs, dtype=torch.int32, device=cuda)
        before = TA.flash_attention.launches
        got = TA.flash_attention(q, k, v, q_offsets=off)
        want = TA.flash_attention_plain(q, k, v, q_offsets=off)
        assert TA.flash_attention.launches == before + 1
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

    @pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("knobs", [(16, 32, 64, 32), (4, 8, 24, 8), (8, 16, 0, 32)],
                             ids=["K16-P32-S64-B32", "K4-P8-S24-B8", "wave-K8-B32"])
    def test_knob_engine_families_replay_equal_eager(self, cuda, mode, knobs):
        from chip_smoke import check_family

        K, P, S, B = knobs
        eng = _tiny_engine(cuda, mode, decode_chunk=K, prefill_chunk=P, step_token_budget=S, kv_block=B)
        try:
            assert eng.kv.block == B and eng.decode_chunk == K and eng.kv.table_width == -(-64 // B)
            assert f"llm.decode_chunk{K}" in eng.families and f"llm.decode_chunk{max(1, K // 4)}" in eng.families
            for i, name in enumerate(sorted(eng._programs)):
                r = check_family(eng, name, seed=i, replays=2)
                assert r["eager_equal"], (name, r["state_equal"])
                assert r["launches"] == {k: 2 * n for k, n in r["captured"].items()}, name
        finally:
            eng.close()

    @pytest.mark.parametrize("knobs", [(16, 32, 64, 32), (4, 8, 24, 8), (2, 4, 4, 8)])
    def test_knob_engine_serves_the_default_tokens(self, cuda, knobs):
        """f32 greedy streams at other knobs equal the default engine's on
        the same weights (the chunkings and blocks move rounding only)."""
        K, P, S, B = knobs
        base = _tiny_engine(cuda, "f32")
        eng = LLMEngine(base.cfg, base.params, device=cuda, slots=4, max_seq_len=64, prefill_buckets=(8, 16),
                        decode_chunk=K, prefill_chunk=P, step_token_budget=S, kv_block=B)
        try:
            prompts = [list(range(5, 25)), [3, 1, 4, 1, 5, 9, 2, 6], [7, 7, 8]]
            want = [base.generate(p, max_new_tokens=12) for p in prompts]
            reqs = [eng.submit(GenRequest(p, max_new_tokens=12)) for p in prompts]
            assert [r.tokens(timeout=300) for r in reqs] == want
        finally:
            base.close()
            eng.close()


@pytest.mark.cuda
class TestTrainOnCard:
    """Training on the card: the flash function's gradient (kernel forward,
    plain-PyTorch backward) against autograd of the plain version, and one
    tiny train step through the kernel."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("heads", [(4, 4), (4, 2), (8, 1)])
    @pytest.mark.parametrize("mask", [dict(), dict(window=7), dict(logit_cap=5.0)])
    def test_flash_gradient(self, cuda, dtype, heads, mask):
        hq, hkv = heads
        g = torch.Generator(device=cuda).manual_seed(hq * 10 + hkv)
        q = torch.randn((2, 64, hq, 64), generator=g, device=cuda).to(dtype).requires_grad_()
        k = torch.randn((2, 64, hkv, 64), generator=g, device=cuda).to(dtype).requires_grad_()
        v = torch.randn((2, 64, hkv, 64), generator=g, device=cuda).to(dtype).requires_grad_()
        dout = torch.randn((2, 64, hq, 64), generator=g, device=cuda).to(dtype)
        before = TA.flash_attention.launches_prompt
        got = torch.autograd.grad(TA.flash_attention_train(q, k, v, causal=True, **mask), (q, k, v), dout)
        assert TA.flash_attention.launches_prompt == before + 1
        want = torch.autograd.grad(TA.flash_attention_plain(q, k, v, causal=True, **mask), (q, k, v), dout)
        for a, b in zip(got, want):
            # f32: summation order; bf16: the kernel's rounded output in rowsum(dO * O)
            rel = float((a.float() - b.float()).norm() / b.float().norm())
            assert rel < (1e-5 if dtype == torch.float32 else 2e-2), rel

    def test_tiny_train_step_launches_the_kernel(self, cuda, monkeypatch):
        from gofr_tpu_torch.parallel import make_mesh, make_train_step

        def refuse(*a, **kw):
            raise AssertionError("flash_attention_plain ran on a CUDA tensor in the training forward")

        monkeypatch.setattr(TA, "flash_attention_plain", refuse)
        cfg = TransformerConfig.tiny()
        params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
        shard_fn, init_opt, step_fn = make_train_step(cfg, make_mesh(devices=[cuda]), learning_rate=1e-2)
        params = shard_fn(params)
        state = init_opt(params)
        tokens = torch.randint(0, cfg.vocab_size, (4, 32), device=cuda, generator=torch.Generator(device=cuda))
        mask = torch.ones_like(tokens, dtype=torch.bool)
        before = TA.flash_attention.launches_prompt
        losses = [float(step_fn(params, state, tokens, mask)[2]) for _ in range(3)]
        assert TA.flash_attention.launches_prompt == before + 3 * cfg.n_layers
        assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]
        assert int(state["count"]) == 3
