"""gofr_tpu_torch.ops against gofr_tpu.ops on the same inputs (CPU, f32).

Inputs are made with numpy from a seed and handed to both frameworks. The
port's kernel wrappers run their plain PyTorch versions here (the tensors
lie on the CPU); the JAX Pallas kernels run in interpret mode, as the JAX
package's own tests run them. The CUDA kernels themselves are held
against the plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops import attention as JA
from gofr_tpu.ops import apply_rope as j_apply_rope
from gofr_tpu.ops import rms_norm as j_rms_norm
from gofr_tpu_torch.ops import attention as TA
from gofr_tpu_torch.ops import apply_rope, rms_norm


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


class TestNormsRope:
    def test_rms_norm(self):
        rng = np.random.default_rng(0)
        x, s = _rand(rng, 3, 5, 64), _rand(rng, 64)
        _close(rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
               j_rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6), 1e-6)

    @pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
    def test_apply_rope_split_halves(self, theta):
        rng = np.random.default_rng(1)
        x = _rand(rng, 2, 7, 3, 16)
        pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
        _close(apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               j_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-6)


class TestReferenceAttention:
    @pytest.mark.parametrize(
        "kw",
        [
            dict(causal=True),
            dict(causal=False),
            dict(causal=True, window=5),
            dict(causal=True, logit_cap=2.0),
        ],
    )
    def test_mha_reference(self, kw):
        rng = np.random.default_rng(2)
        q, k, v = _rand(rng, 2, 12, 4, 16), _rand(rng, 2, 12, 2, 16), _rand(rng, 2, 12, 2, 16)
        got = TA.mha_reference(*map(torch.from_numpy, (q, k, v)), **kw)
        want = JA.mha_reference(*map(jnp.asarray, (q, k, v)), **kw)
        _close(got, want, 1e-5)

    def test_mha_reference_masks_and_positions(self):
        rng = np.random.default_rng(3)
        q, k, v = _rand(rng, 2, 6, 4, 16), _rand(rng, 2, 20, 2, 16), _rand(rng, 2, 20, 2, 16)
        qpos = np.stack([np.arange(6) + 3, np.arange(6) + 14]).astype(np.int32)
        kvm = rng.random((2, 20)) > 0.2
        kvm[:, 0] = True
        got = TA.mha_reference(
            *map(torch.from_numpy, (q, k, v)), q_positions=torch.from_numpy(qpos),
            kv_mask=torch.from_numpy(kvm), window=8,
        )
        want = JA.mha_reference(
            *map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(qpos),
            kv_mask=jnp.asarray(kvm), window=8,
        )
        _close(got, want, 1e-5)

    @pytest.mark.parametrize("window", [0, 5])
    @pytest.mark.parametrize("step", [0, 3])
    def test_chunk_decode_attention(self, window, step):
        rng = np.random.default_rng(4)
        b, L, C = 3, 24, 4
        q = _rand(rng, b, 1, 4, 16)
        kc, vc = _rand(rng, b, L, 2, 16), _rand(rng, b, L, 2, 16)
        kb, vb = _rand(rng, b, C, 2, 16), _rand(rng, b, C, 2, 16)
        lengths = np.asarray([0, 9, 20], np.int32)
        got = TA.chunk_decode_attention(
            *map(torch.from_numpy, (q, kc, vc, kb, vb, lengths)), step,
            window=window, logit_cap=3.0,
        )
        want = JA.chunk_decode_attention(
            *map(jnp.asarray, (q, kc, vc, kb, vb, lengths)), jnp.int32(step),
            window=window, logit_cap=3.0,
        )
        _close(got, want, 1e-5)

    # both widths reach the flash wrapper (its plain version here); the JAX
    # package runs c=8 through flash and keeps c=5 on its einsum path
    @pytest.mark.parametrize("c", [8, 5])
    @pytest.mark.parametrize("window", [0, 6])
    def test_chunk_prefill_attention_dense(self, c, window):
        rng = np.random.default_rng(5)
        b, cap = 3, 32
        q = _rand(rng, b, c, 4, 16)
        kc, vc = _rand(rng, b, cap, 2, 16), _rand(rng, b, cap, 2, 16)
        cursors = np.asarray([0, 7, 24], np.int32)
        got = TA.chunk_prefill_attention(
            *map(torch.from_numpy, (q, kc, vc, cursors)), window=window, logit_cap=4.0
        )
        want = JA.chunk_prefill_attention(
            *map(jnp.asarray, (q, kc, vc, cursors)), window=window, logit_cap=4.0
        )
        _close(got, want, 1e-5)

    def test_paged_gather_byte_identical(self):
        rng = np.random.default_rng(6)
        kp, vp = _rand(rng, 10, 4, 2, 8), _rand(rng, 10, 4, 2, 8)
        tables = rng.integers(0, 10, (3, 5)).astype(np.int32)
        gk, gv = TA.paged_gather(*map(torch.from_numpy, (kp, vp, tables)))
        jk, jv = JA.paged_gather(*map(jnp.asarray, (kp, vp, tables)))
        np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))


class TestFlashPlainVsPallas:
    """The port's plain flash version against the Pallas kernel in
    interpret mode (mirrors tests/test_ops.py and test_chunked_prefill)."""

    @pytest.mark.parametrize(
        "kw",
        [dict(window=0), dict(window=64), dict(window=0, logit_cap=5.0)],
    )
    def test_offsets_mode(self, kw):
        rng = np.random.default_rng(7)
        b, cap, c, hq, hkv, d = 2, 256, 16, 4, 2, 32
        q, k, v = _rand(rng, b, c, hq, d), _rand(rng, b, cap, hkv, d), _rand(rng, b, cap, hkv, d)
        offs = np.asarray([0, 97], np.int32)
        got = TA.flash_attention(
            *map(torch.from_numpy, (q, k, v)), causal=True, q_offsets=torch.from_numpy(offs), **kw
        )
        want = JA.flash_attention(
            *map(jnp.asarray, (q, k, v)), causal=True, q_offsets=jnp.asarray(offs),
            block_q=c, interpret=True, **kw,
        )
        _close(got, want, 1e-4)

    @pytest.mark.parametrize(
        "kw",
        [dict(causal=True), dict(causal=False), dict(causal=True, window=100),
         dict(causal=True, logit_cap=5.0)],
    )
    def test_full_prompt_mode(self, kw):
        rng = np.random.default_rng(8)
        q, k, v = _rand(rng, 1, 256, 4, 32), _rand(rng, 1, 256, 2, 32), _rand(rng, 1, 256, 2, 32)
        got = TA.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
        want = JA.flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True, **kw)
        _close(got, want, 1e-4)

    # the GQA groups that the bf16 card kernel packs into 64-row tiles: one
    # KV head for 8 query heads (Gemma-2B), a group of 6 that does not
    # divide 64, and no sharing at all
    @pytest.mark.parametrize("heads", [(8, 1), (6, 1), (8, 8)])
    def test_offsets_mode_gqa_groups(self, heads):
        rng = np.random.default_rng(11)
        hq, hkv = heads
        b, cap, c, d = 2, 128, 8, 32
        q, k, v = _rand(rng, b, c, hq, d), _rand(rng, b, cap, hkv, d), _rand(rng, b, cap, hkv, d)
        offs = np.asarray([3, 77], np.int32)
        got = TA.flash_attention(
            *map(torch.from_numpy, (q, k, v)), causal=True, window=40, q_offsets=torch.from_numpy(offs)
        )
        want = JA.flash_attention(
            *map(jnp.asarray, (q, k, v)), causal=True, window=40, q_offsets=jnp.asarray(offs),
            block_q=c, interpret=True,
        )
        _close(got, want, 1e-4)

    def test_fully_masked_rows_are_zero(self):
        # query rows past the key range see no key at all -> 0
        rng = np.random.default_rng(9)
        q, k, v = _rand(rng, 1, 8, 2, 16), _rand(rng, 1, 8, 2, 16), _rand(rng, 1, 8, 2, 16)
        out = TA.flash_attention(
            *map(torch.from_numpy, (q, k, v)), causal=True, window=2,
            q_offsets=torch.tensor([20], dtype=torch.int32),
        )
        assert torch.count_nonzero(out) == 0


class TestPagedDecodePlainVsPallas:
    """Mirrors tests/test_paged_kv.py TestPagedAttentionKernel."""

    def _inputs(self):
        rng = np.random.RandomState(0)
        b, hq, hkv, d, Bk, MB, NB, chunk = 3, 4, 2, 16, 8, 6, 40, 4
        return dict(
            q=rng.randn(b, 1, hq, d).astype(np.float32),
            pk=rng.randn(NB, Bk, hkv, d).astype(np.float32),
            pv=rng.randn(NB, Bk, hkv, d).astype(np.float32),
            tables=rng.randint(0, NB, size=(b, MB)).astype(np.int32),
            kb=rng.randn(b, chunk, hkv, d).astype(np.float32),
            vb=rng.randn(b, chunk, hkv, d).astype(np.float32),
            lengths=np.asarray([13, 0, 37], np.int32),
        )

    @pytest.mark.parametrize("window", [0, 9])
    def test_chunk_decode_matches_kernel_path(self, window):
        x = self._inputs()
        names = ("q", "pk", "pv", "tables", "kb", "vb", "lengths")
        got = TA.paged_chunk_decode_attention(
            *(torch.from_numpy(x[n]) for n in names), 2, window=window,
        )
        want = JA.paged_chunk_decode_attention(
            *(jnp.asarray(x[n]) for n in names), jnp.int32(2),
            window=window, use_kernel=True, interpret=True,
        )
        _close(got, want, 2e-6)

    def test_partials_match_kernel(self):
        x = self._inputs()
        hi = np.asarray([13, 0, 37], np.int32)
        lo = np.asarray([4, 0, 0], np.int32)
        args = (x["q"][:, 0], x["pk"], x["pv"], x["tables"], lo, hi)
        got = TA.paged_decode_partials(*map(torch.from_numpy, args), scale=0.25, logit_cap=3.0)
        want = JA._paged_decode_partials(
            *map(jnp.asarray, args), scale=0.25, logit_cap=3.0, interpret=True
        )
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=2e-6)
        # the empty band keeps the kernel's initial partials
        assert (got[2][1] == 0).all() and (got[1][1] == TA.NEG_INF).all()


class TestWrappers:
    def test_cpu_tensor_runs_plain_version_without_launch(self):
        rng = np.random.default_rng(10)
        q, k, v = (torch.from_numpy(_rand(rng, 1, 8, 2, 16)) for _ in range(3))
        before = TA.flash_attention.launches
        out = TA.flash_attention(q, k, v)
        torch.testing.assert_close(out, TA.flash_attention_plain(q, k, v), rtol=0, atol=0)
        assert TA.flash_attention.launches == before

    def test_non_cuda_device_raises(self):
        q = torch.empty((1, 8, 2, 16), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            TA.flash_attention(q, q, q)
        qd = torch.empty((2, 2, 16), device="meta")
        pool = torch.empty((4, 4, 1, 16), device="meta")
        idx = torch.empty((2,), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            TA.paged_decode_partials(
                qd, pool, pool, torch.empty((2, 3), dtype=torch.int32, device="meta"),
                idx, idx, scale=0.25,
            )
