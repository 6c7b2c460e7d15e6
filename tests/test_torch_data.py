"""The port's training data loader (gofr_tpu_torch.data, with the native
gather of gofr_tpu_torch/native/datacore.cc) against gofr_tpu.data on the
same corpus files: every behaviour of tests/test_data.py — windows,
per-epoch permutations, dp strides, resume (state/restore/seek), the
errors, uint16/uint32/.npy corpora, the native gather against numpy's —
plus the torch side: device_prefetch on the CPU and an import that loads
no torch."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gofr_tpu import data as JD
from gofr_tpu.native import load_data_core as jax_data_core
from gofr_tpu_torch import data as TD
from gofr_tpu_torch.native import DATA_MODULE, load_data_core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(tmp_path, kind: str):
    """(path, tokens) of a seeded corpus: uint16 or uint32 raw with a
    sidecar (written by the JAX encoder, which the port's must match), or a
    uint16 .npy."""
    rng = np.random.default_rng({"u16": 0, "u32": 1, "npy": 2}[kind])
    if kind == "npy":
        toks = rng.integers(0, 512, 10_000).astype(np.uint16)
        path = str(tmp_path / "c.npy")
        np.save(path, toks)
        return path, toks
    vocab = 512 if kind == "u16" else 100_000
    toks = rng.integers(0, vocab, 10_000)
    path = str(tmp_path / f"c_{kind}.tok")
    JD.encode_corpus(toks, path, vocab_size=vocab)
    return path, toks


@pytest.fixture(params=["u16", "u32", "npy"])
def corpus(request, tmp_path):
    return _write(tmp_path, request.param)


def _pair(path, seq_len):
    return JD.TokenDataset(path, seq_len), TD.TokenDataset(path, seq_len)


def _same_batch(a: dict, b: dict) -> None:
    assert set(a) == set(b) == {"inputs", "targets"}
    for key in a:
        assert a[key].dtype == b[key].dtype == np.int32
        assert np.array_equal(a[key], b[key]), key


# -- the corpus ------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [512, 65_536, 65_537, None])
def test_encode_corpus_bytes_equal_jax(tmp_path, vocab):
    toks = np.random.default_rng(3).integers(0, vocab or 70_000, 5_000)
    jp, tp = str(tmp_path / "j.tok"), str(tmp_path / "t.tok")
    assert JD.encode_corpus(toks, jp, vocab_size=vocab) == jp
    assert TD.encode_corpus(toks, tp, vocab_size=vocab) == tp
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    with open(jp + ".json") as a, open(tp + ".json") as b:
        assert json.load(a) == json.load(b)


def test_dataset_fields_equal_jax(corpus):
    path, toks = corpus
    for seq_len in (9, 16, 32):
        j, t = _pair(path, seq_len)
        assert (j.dtype, j.n_tokens, j.window, j.n_windows) == (t.dtype, t.n_tokens, t.window, t.n_windows)
        assert t.n_windows == len(toks) // (seq_len + 1)


# -- the stream ------------------------------------------------------------------

@pytest.mark.parametrize("seq_len,batch,seed", [(32, 4, 1), (16, 8, 3), (9, 7, 11)])
def test_batches_equal_jax_across_epochs(corpus, seq_len, batch, seed):
    path, _ = corpus
    j, t = _pair(path, seq_len)
    ji, ti = j.batches(batch, seed=seed), t.batches(batch, seed=seed)
    assert ji.steps_per_epoch() == ti.steps_per_epoch()
    for _ in range(2 * ti.steps_per_epoch() + 3):
        _same_batch(next(ji), next(ti))
        assert ji.state() == ti.state()
    assert ti.epoch == 2


def test_targets_are_shifted_inputs_from_the_corpus(corpus):
    path, toks = corpus
    ds = TD.TokenDataset(path, seq_len=16)
    b = next(ds.batches(8, seed=2))
    assert np.array_equal(b["inputs"][:, 1:], b["targets"][:, :-1])
    flat = np.asarray(toks).astype(np.int32)
    for row in np.concatenate([b["inputs"], b["targets"][:, -1:]], axis=1):
        starts = [s for s in np.flatnonzero(flat[: len(flat) - 17] == row[0]) if s % 17 == 0]
        assert any(np.array_equal(flat[s : s + 17], row) for s in starts)


@pytest.mark.parametrize("seeds", [(7, 7), (7, 8)])
def test_seed_permutations_equal_jax(corpus, seeds):
    path, _ = corpus
    j, t = _pair(path, 32)
    a = next(t.batches(4, seed=seeds[0]))["inputs"]
    b = next(t.batches(4, seed=seeds[1]))["inputs"]
    assert np.array_equal(a, b) == (seeds[0] == seeds[1])
    assert np.array_equal(a, next(j.batches(4, seed=seeds[0]))["inputs"])


def test_epoch_rollover_reshuffles_as_jax(corpus):
    path, _ = corpus
    j, t = _pair(path, 32)
    ji, ti = j.batches(4, seed=1), t.batches(4, seed=1)
    first = next(ti)["inputs"].copy()
    next(ji)
    for _ in range(ti.steps_per_epoch() - 1):
        _same_batch(next(ji), next(ti))
    assert ti.epoch == ji.epoch == 0
    second = next(ti)["inputs"]
    assert np.array_equal(second, next(ji)["inputs"])
    assert ti.epoch == ji.epoch == 1
    assert not np.array_equal(first, second)


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("batch", [4, 7])
def test_drop_remainder_equal_jax(corpus, drop_remainder, batch):
    path, _ = corpus
    j, t = _pair(path, 16)
    ji = j.batches(batch, seed=4, drop_remainder=drop_remainder)
    ti = t.batches(batch, seed=4, drop_remainder=drop_remainder)
    assert ji.steps_per_epoch() == ti.steps_per_epoch()
    for _ in range(ti.steps_per_epoch() + 2):
        _same_batch(next(ji), next(ti))


# -- dp strides ----------------------------------------------------------------------

@pytest.mark.parametrize("dp_size", [2, 3, 4])
def test_dp_ranks_equal_jax_disjoint_and_cover(corpus, dp_size):
    path, _ = corpus
    j, t = _pair(path, 32)
    seen = []
    for rank in range(dp_size):
        ji = j.batches(2, seed=5, dp_rank=rank, dp_size=dp_size)
        ti = t.batches(2, seed=5, dp_rank=rank, dp_size=dp_size)
        assert ji.steps_per_epoch() == ti.steps_per_epoch()
        ids = set()
        for _ in range(ti.steps_per_epoch()):
            b = next(ti)
            _same_batch(next(ji), b)
            ids |= {tuple(row) for row in b["inputs"]}
        seen.append(ids)
    for i in range(dp_size):
        for k in range(i + 1, dp_size):
            assert not (seen[i] & seen[k])
    # the ranks' windows cover every window the batches could take
    assert sum(len(s) for s in seen) == sum(
        2 * t.batches(2, seed=5, dp_rank=r, dp_size=dp_size).steps_per_epoch() for r in range(dp_size))


# -- resume ----------------------------------------------------------------------------

@pytest.mark.parametrize("consumed", [0, 7, 30, 75, 80])
def test_state_restore_and_seek_equal_jax(corpus, consumed):
    path, _ = corpus
    j, t = _pair(path, 32)
    ti = t.batches(4, seed=11)
    for _ in range(consumed):
        next(ti)
    state = ti.state()
    want = [next(ti) for _ in range(3)]
    restored = t.batches(4, seed=11).restore(state)
    sought = t.batches(4, seed=11).seek(consumed)
    jax_sought = j.batches(4, seed=11).seek(consumed)
    assert (sought.epoch, sought.step) == (jax_sought.epoch, jax_sought.step)
    # at an epoch's end the stream rolls over lazily: (0, 75) and (1, 0) are one position
    assert state["epoch"] * ti.steps_per_epoch() + state["step"] == consumed
    for w in want:
        _same_batch(w, next(restored))
        _same_batch(w, next(sought))
        _same_batch(w, next(jax_sought))


# -- errors ---------------------------------------------------------------------------

def _raises_alike(fn_jax, fn_port):
    with pytest.raises(Exception) as je:
        fn_jax()
    with pytest.raises(Exception) as te:
        fn_port()
    assert type(te.value) is type(je.value)
    return str(je.value), str(te.value)


@pytest.mark.parametrize("case", [
    "bad_rank", "negative_rank", "oversized_batch", "restore_seed", "restore_batch_size", "restore_dp_size",
    "restore_seq_len",
])
def test_iterator_errors_equal_jax(tmp_path, case):
    path, _ = _write(tmp_path, "u16")
    j, t = _pair(path, 16)

    def make(pkg_ds, other_ds):
        if case == "bad_rank":
            return lambda: pkg_ds.batches(2, dp_rank=4, dp_size=4)
        if case == "negative_rank":
            return lambda: pkg_ds.batches(2, dp_rank=-1, dp_size=2)
        if case == "oversized_batch":
            return lambda: pkg_ds.batches(pkg_ds.n_windows + 1, seed=1)
        base = pkg_ds.batches(4, seed=1)
        if case == "restore_seed":
            return lambda: pkg_ds.batches(4, seed=2).restore(base.state())
        if case == "restore_batch_size":
            return lambda: pkg_ds.batches(8, seed=1).restore(base.state())
        if case == "restore_dp_size":
            return lambda: pkg_ds.batches(4, seed=1, dp_size=2).restore(base.state())
        return lambda: other_ds.batches(4, seed=1).restore(base.state())

    jo, to = JD.TokenDataset(path, 15), TD.TokenDataset(path, 15)
    jm, tm = _raises_alike(make(j, jo), make(t, to))
    assert jm == tm


@pytest.mark.parametrize("case", ["no_sidecar", "bad_magic", "npy_2d", "too_short", "wrapping_ids", "negative_ids"])
def test_corpus_errors_equal_jax(tmp_path, case):
    p = str(tmp_path / "x.tok")
    if case == "no_sidecar":
        with open(p, "wb") as f:
            f.write(b"\x00" * 100)
        fns = [lambda pkg=pkg: pkg.TokenDataset(p, 8) for pkg in (JD, TD)]
    elif case == "bad_magic":
        with open(p, "wb") as f:
            f.write(b"\x00" * 100)
        with open(p + ".json", "w") as f:
            json.dump({"magic": "other", "dtype": "uint16", "n": 50}, f)
        fns = [lambda pkg=pkg: pkg.TokenDataset(p, 8) for pkg in (JD, TD)]
    elif case == "npy_2d":
        p = str(tmp_path / "x.npy")
        np.save(p, np.zeros((4, 4), np.uint16))
        fns = [lambda pkg=pkg: pkg.TokenDataset(p, 2) for pkg in (JD, TD)]
    elif case == "too_short":
        JD.encode_corpus(np.arange(5), p, vocab_size=512)
        fns = [lambda pkg=pkg: pkg.TokenDataset(p, 8) for pkg in (JD, TD)]
    else:
        toks = np.asarray([70_000] if case == "wrapping_ids" else [3, -1])
        fns = [lambda pkg=pkg: pkg.encode_corpus(toks, p, vocab_size=512) for pkg in (JD, TD)]
    jm, tm = _raises_alike(*fns)
    assert jm == tm


# -- the native gather -------------------------------------------------------------------

def test_native_core_loads_under_its_own_name():
    core = load_data_core()
    assert core is not None and core.__name__ == DATA_MODULE == "_gofr_torch_data"
    # both extensions live in one process
    assert jax_data_core() is not None and jax_data_core().__name__ == "_gofr_data"


def test_native_gather_equals_numpy_and_jax(corpus):
    path, _ = corpus
    j, t = _pair(path, 32)
    assert t._core is not None
    ids = np.asarray([0, 5, 17, 2, 2, t.n_windows - 1])
    native = t.gather(ids)
    core, t._core = t._core, None
    try:
        fallback = t.gather(ids)
    finally:
        t._core = core
    assert native.dtype == fallback.dtype == np.int32
    assert np.array_equal(native, fallback)
    assert np.array_equal(native, j.gather(ids))


def test_uint32_gather(tmp_path):
    toks = np.arange(70_000, dtype=np.uint32) % 70_000
    path = str(tmp_path / "big.tok")
    TD.encode_corpus(toks, path, vocab_size=70_000)
    ds = TD.TokenDataset(path, seq_len=9)
    assert ds.dtype == np.uint32
    assert np.array_equal(ds.gather(np.asarray([0, 1]))[0], np.arange(10))


@pytest.mark.parametrize("case", ["past_end", "negative", "itemsize", "window", "short_out", "starts_dtype"])
def test_native_gather_errors_equal_jax(tmp_path, case):
    path, _ = _write(tmp_path, "u16")
    ds = TD.TokenDataset(path, seq_len=32)
    starts = np.asarray([ds.n_tokens if case == "past_end" else -1 if case == "negative" else 0], np.int64)
    itemsize = 3 if case == "itemsize" else ds.dtype.itemsize
    window = 0 if case == "window" else ds.window
    out = np.empty((1, ds.window - (1 if case == "short_out" else 0)), ds.dtype)
    if case == "starts_dtype":
        starts = np.zeros(3, np.int32)  # 12 bytes: not a whole int64 count

    def call(core):
        return lambda: core.gather_windows(memoryview(ds._tokens).cast("B"), starts, window, itemsize,
                                           memoryview(out).cast("B"))

    jm, tm = _raises_alike(call(jax_data_core()), call(load_data_core()))
    assert jm == tm


def test_native_disabled_gathers_with_numpy(tmp_path):
    path, _ = _write(tmp_path, "u32")
    code = (
        "import numpy as np, sys; from gofr_tpu_torch.data import TokenDataset; "
        f"ds = TokenDataset({path!r}, 16); print(ds._core is None, ds.gather(np.asarray([3, 1])).sum(), "
        "'torch' in sys.modules)"
    )
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True,
                         env={**os.environ, "GOFR_NATIVE": "0"}).stdout.split()
    want = int(TD.TokenDataset(path, 16).gather(np.asarray([3, 1])).sum())
    assert got == ["True", str(want), "False"]


# -- device_prefetch (torch) ----------------------------------------------------------------

def test_device_prefetch_cpu_yields_tensors(corpus):
    path, _ = corpus
    ds = TD.TokenDataset(path, seq_len=16)
    want = [next(ds.batches(4, seed=3)) for _ in range(1)][0]
    pf = TD.device_prefetch(ds.batches(4, seed=3), lookahead=2, device="cpu")
    b = next(pf)
    assert isinstance(b["inputs"], torch.Tensor) and b["inputs"].device.type == "cpu"
    assert b["inputs"].shape == (4, 16) and b["inputs"].dtype == torch.int32
    assert np.array_equal(b["inputs"].numpy(), want["inputs"])
    pf.close()


@pytest.mark.parametrize("batch", [{"a": np.ones((2, 3))}, (np.ones(2), np.zeros(3, np.int64)), [np.arange(4)]])
def test_device_prefetch_keeps_the_batch_structure(batch):
    pf = TD.device_prefetch(iter([batch, batch]), device="cpu")
    got = list(pf)
    assert len(got) == 2
    for b in got:
        assert type(b) is type(batch)
        leaves = list(b.values()) if isinstance(b, dict) else list(b)
        want = list(batch.values()) if isinstance(batch, dict) else list(batch)
        assert all(isinstance(x, torch.Tensor) and np.array_equal(x.numpy(), w) for x, w in zip(leaves, want))


def test_device_prefetch_finite_iterator_stops(tmp_path):
    path, _ = _write(tmp_path, "u16")
    it = TD.TokenDataset(path, seq_len=16).batches(4, seed=1)
    finite = [next(it) for _ in range(3)]
    assert len(list(TD.device_prefetch(iter(finite), lookahead=2, device="cpu"))) == 3


def test_device_prefetch_surfaces_the_iterators_error():
    def broken():
        yield {"x": np.zeros(2)}
        raise KeyError("boom")

    pf = TD.device_prefetch(broken(), device="cpu")
    next(pf)
    with pytest.raises(KeyError, match="boom"):
        next(pf)


def test_device_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no GPU"):
        TD.device_prefetch(iter([]))


def test_import_loads_no_torch():
    code = "import sys, gofr_tpu_torch.data, gofr_tpu_torch.native; print('torch' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"


def test_loader_feeds_a_train_step(tmp_path):
    """Corpus -> loader -> prefetch -> the port's train step: loss falls
    (tests/test_data.py's end-to-end step, on one CPU device)."""
    from gofr_tpu_torch.models import TransformerConfig, init_params
    from gofr_tpu_torch.parallel import make_mesh, make_train_step, place_batch

    path, _ = _write(tmp_path, "u16")
    cfg = TransformerConfig.tiny()
    mesh = make_mesh({"data": 1, "model": 1}, devices=["cpu"])
    shard_fn, init_opt, step = make_train_step(cfg, mesh)
    params = shard_fn(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    opt_state = init_opt(params)
    batch = next(TD.TokenDataset(path, seq_len=16).batches(4, seed=9))
    toks = np.concatenate([batch["inputs"], batch["targets"][:, -1:]], axis=1)
    toks, mask = place_batch((toks, np.ones_like(toks, dtype=bool)), mesh)
    losses = [float(step(params, opt_state, toks, mask)[2]) for _ in range(5)]
    assert losses[-1] < losses[0]
