"""The merge algebra of the split paged-decode kernel, on the CPU.

The CUDA kernel (gofr_tpu_torch/csrc/paged_decode.cu) shares each band's
table slots out over a cluster of CTAs and merges their online-softmax
partials: with M the largest m_p (taken as 0 when every share is empty),
w_p = exp(m_p - M), l = sum_p w_p l_p and o = sum_p w_p acc_p / l, where
acc_p = o_p l_p is share p's unnormalized output. Here the shares are
computed by the plain version over the same sub-bands the kernel gives its
CTAs, merged that way, and held against the JAX Pallas kernel
(``_paged_decode_partials`` in interpret mode) over the whole band, in
float32 and with int8 pools.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops import attention as JA
from gofr_tpu_torch.ops import attention as TA

B, MB, NB = 8, 8, 64
# (lo, hi): empty, short, window, ending on a slot boundary, empty at
# lo > 0, full table. Empty bands sit on slot boundaries: the Pallas kernel
# visits a slot that merely contains lo == hi (its liveness test is
# base < hi and base + B > lo) and returns o = mean of V, l = B there,
# where the port returns (0, NEG_INF, 0); the caller's merge weighs either
# by exp(NEG_INF - m) * l = 0.
BANDS = [(0, 0), (0, 13), (4, 37), (24, 64), (16, 16), (0, 64)]


def _inputs(quant: bool):
    rng = np.random.RandomState(7)
    b, hq, hkv, d = len(BANDS), 4, 2, 16
    x = dict(
        q=rng.randn(b, hq, d).astype(np.float32),
        tables=rng.permutation(NB)[: b * MB].reshape(b, MB).astype(np.int32),
        lo=np.asarray([lo for lo, _ in BANDS], np.int32),
        hi=np.asarray([hi for _, hi in BANDS], np.int32),
    )
    if quant:
        for n in ("k", "v"):
            x[f"{n}p"] = rng.randint(-127, 128, size=(NB, B, hkv, d)).astype(np.int8)
            x[f"{n}s"] = (rng.rand(NB, B, hkv) * 0.05 + 0.01).astype(np.float32)
    else:
        x["kp"] = rng.randn(NB, B, hkv, d).astype(np.float32)
        x["vp"] = rng.randn(NB, B, hkv, d).astype(np.float32)
    return x


def _scales(x, lib):
    conv = torch.from_numpy if lib == "torch" else jnp.asarray
    return dict(k_scales=conv(x["ks"]), v_scales=conv(x["vs"])) if "ks" in x else {}


@functools.lru_cache(maxsize=None)
def _pallas(quant: bool):
    """The JAX Pallas kernel (interpret mode) over the whole band."""
    x = _inputs(quant)
    out = JA._paged_decode_partials(
        *(jnp.asarray(x[n]) for n in ("q", "kp", "vp", "tables", "lo", "hi")),
        scale=0.25, logit_cap=3.0, interpret=True, **_scales(x, "jax"),
    )
    return tuple(np.asarray(a) for a in out)


def _shares(lo: int, hi: int, splits: int):
    """The sub-bands CTA 0 .. splits-1 take: the band's table slots
    [lo // B, ceil(hi / B)) in contiguous shares of ceil(n / splits)."""
    j_first = lo // B
    n = (hi - 1) // B + 1 - j_first if hi > lo else 0
    per = -(-n // splits)
    out = []
    for rank in range(splits):
        j0 = j_first + min(n, rank * per)
        j1 = j_first + min(n, (rank + 1) * per)
        a, z = max(lo, j0 * B), min(hi, j1 * B)
        out.append((a, z) if j1 > j0 else (0, 0))
    return out


def _split_and_merge(x, splits: int):
    t = {n: torch.from_numpy(x[n]) for n in ("q", "kp", "vp", "tables")}
    parts = []
    for rank in range(splits):
        sub = [_shares(int(lo), int(hi), splits)[rank] for lo, hi in zip(x["lo"], x["hi"])]
        lo = torch.tensor([a for a, _ in sub], dtype=torch.int32)
        hi = torch.tensor([z for _, z in sub], dtype=torch.int32)
        parts.append(TA.paged_decode_partials_plain(
            t["q"], t["kp"], t["vp"], t["tables"], lo, hi, scale=0.25, logit_cap=3.0,
            **_scales(x, "torch"),
        ))
    m_all = torch.stack([m for _, m, _ in parts])  # [splits, b, hq]
    mm = m_all.amax(dim=0)
    w = torch.exp(m_all - torch.where(mm == TA.NEG_INF, 0.0, mm))
    lt = (w * torch.stack([l for _, _, l in parts])).sum(dim=0)
    acc = sum(wp[..., None] * o * l[..., None] for wp, (o, _, l) in zip(w, parts))
    return acc / torch.where(lt == 0.0, 1.0, lt)[..., None], mm, lt


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_merged_shares_equal_pallas_whole_band(quant, splits):
    x = _inputs(quant)
    got = _split_and_merge(x, splits)
    want = _pallas(quant)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=2e-6)
    # empty bands: exactly the kernel's initial partials, whatever the split
    for i, (lo, hi) in enumerate(BANDS):
        if hi <= lo:
            assert (got[0][i] == 0).all() and (got[2][i] == 0).all()
            assert (got[1][i] == TA.NEG_INF).all() and (want[1][i] == TA.NEG_INF).all()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_all_empty_batch_merges_to_initial_partials(quant):
    """No share of any sequence sees a row: every weight is exp(NEG_INF) =
    0 and the merge gives (0, NEG_INF, 0) bit for bit, as the Pallas
    kernel's initial state does."""
    x = _inputs(quant)
    x["lo"] = x["hi"] = np.asarray([0, 8, 16, 40, 56, 64], np.int32)
    o, m, l = _split_and_merge(x, 8)
    w_o, w_m, w_l = JA._paged_decode_partials(
        *(jnp.asarray(x[n]) for n in ("q", "kp", "vp", "tables", "lo", "hi")),
        scale=0.25, logit_cap=3.0, interpret=True, **_scales(x, "jax"),
    )
    assert torch.count_nonzero(o) == 0 and torch.count_nonzero(l) == 0
    assert bool((m == TA.NEG_INF).all())
    np.testing.assert_array_equal(o.numpy(), np.asarray(w_o))
    np.testing.assert_array_equal(m.numpy(), np.asarray(w_m))
    np.testing.assert_array_equal(l.numpy(), np.asarray(w_l))
