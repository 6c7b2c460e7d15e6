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
