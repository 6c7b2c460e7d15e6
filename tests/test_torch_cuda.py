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
