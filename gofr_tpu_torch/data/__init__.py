"""Training data loader: a memory-mapped token corpus -> shuffled,
shardable, checkpointable batches staged onto the card (counterpart of
gofr_tpu/data/__init__.py; its host code is a copy).

Design, as in the JAX package:
- **Corpus = one flat token array on disk** (raw little-endian uint16/
  uint32, or a .npy of the same), memory-mapped: no parsing, no copies
  at open. ``encode_corpus`` writes it with a JSON sidecar.
- **Sampling**: non-overlapping windows of seq_len + 1 tokens (inputs and
  shifted targets come from one window), visited in a per-epoch
  permutation from ``np.random.default_rng((seed, epoch))``.
- **Sharding**: ``dp_rank`` / ``dp_size`` stride the permuted windows, so
  data-parallel ranks see disjoint streams with the same epoch
  boundaries.
- **Checkpoint/resume**: the iterator's ``state()`` is (epoch, step); a
  restored iterator replays the exact position, and ``seek(n)`` positions
  it as if n batches had been consumed (the prefetch-safe resume).
- **Batch assembly** gathers B windows from the mmap into one array. The
  native ``_gofr_torch_data.gather_windows`` (``native/datacore.cc``, a
  copy of JAX's ``_gofr_data``) does this with the GIL released, so the
  prefetch thread's assembly overlaps the card's step; a numpy gather
  runs when the extension cannot be built (no compiler) or
  ``GOFR_NATIVE=0``.
- **Prefetch**: ``device_prefetch`` stages each batch onto the card from a
  thread, through pinned memory on a copy stream of its own; the
  consumer's stream waits on the copy's event and the tensors are
  recorded on it, so the caching allocator cannot hand their memory to
  another tensor while the step still reads them. This module imports
  torch only there.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
from typing import Any, Iterator

import numpy as np

from ..native import load_data_core

__all__ = ["TokenDataset", "BatchIterator", "encode_corpus", "device_prefetch"]

_MAGIC = "gofr-tokens-v1"


def encode_corpus(tokens, path: str, *, vocab_size: int | None = None) -> str:
    """Write a token sequence as a raw mmap-able corpus + JSON sidecar.
    dtype is uint16 when the ids fit (vocab <= 65536), else uint32."""
    arr = np.asarray(tokens)
    amax = int(arr.max(initial=0))
    if arr.size and int(arr.min()) < 0:
        raise ValueError("token ids must be non-negative")
    if vocab_size is not None and amax >= vocab_size:
        raise ValueError(
            f"token id {amax} >= vocab_size {vocab_size} — astype would wrap silently"
        )
    hi = amax if vocab_size is None else vocab_size - 1
    dtype = np.uint16 if hi < 2**16 else np.uint32
    arr = arr.astype(dtype)
    with open(path, "wb") as f:
        f.write(arr.tobytes())
    with open(path + ".json", "w") as f:
        json.dump({"magic": _MAGIC, "dtype": arr.dtype.name, "n": int(arr.size)}, f)
    return path


@dataclasses.dataclass(frozen=True)
class _Meta:
    dtype: np.dtype
    n_tokens: int


def _open_corpus(path: str) -> tuple[_Meta, np.ndarray]:
    """Returns (meta, mmap'd 1-D token array) — one open per corpus."""
    sidecar = path + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
        if meta.get("magic") != _MAGIC:
            raise ValueError(f"{sidecar}: not a {_MAGIC} sidecar")
        m = _Meta(np.dtype(meta["dtype"]), int(meta["n"]))
        return m, np.memmap(path, dtype=m.dtype, mode="r")
    if path.endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        if arr.ndim != 1:
            raise ValueError("corpus .npy must be 1-D")
        return _Meta(arr.dtype, arr.size), arr
    raise FileNotFoundError(
        f"{path}: need a {sidecar} sidecar (use data.encode_corpus) or a .npy"
    )


class TokenDataset:
    """Memory-mapped token corpus serving fixed-length training windows."""

    def __init__(self, path: str, seq_len: int):
        self.path = path
        self.seq_len = seq_len
        meta, self._tokens = _open_corpus(path)
        self.dtype = meta.dtype
        self.n_tokens = meta.n_tokens
        # window = seq_len + 1 so (inputs, targets) shift out of one slice
        self.window = seq_len + 1
        self.n_windows = self.n_tokens // self.window
        if self.n_windows == 0:
            raise ValueError(
                f"corpus has {self.n_tokens} tokens < one window ({self.window})"
            )
        self._core = load_data_core()

    def batches(
        self,
        batch_size: int,
        *,
        seed: int = 0,
        dp_rank: int = 0,
        dp_size: int = 1,
        drop_remainder: bool = True,
    ) -> "BatchIterator":
        return BatchIterator(
            self, batch_size, seed=seed, dp_rank=dp_rank, dp_size=dp_size,
            drop_remainder=drop_remainder,
        )

    # -- hot path ---------------------------------------------------------
    def gather(self, window_ids: np.ndarray) -> np.ndarray:
        """[B] window indices -> [B, window] int32 batch."""
        starts = window_ids.astype(np.int64) * self.window
        if self._core is not None:
            out = np.empty((len(starts), self.window), self.dtype)
            self._core.gather_windows(
                memoryview(self._tokens).cast("B"),
                np.ascontiguousarray(starts),
                self.window,
                self.dtype.itemsize,
                memoryview(out).cast("B"),
            )
        else:
            out = self._tokens[starts[:, None] + np.arange(self.window)]
        return out.astype(np.int32)


class BatchIterator:
    """Deterministic, shardable, checkpointable batch stream.

    Yields dicts {"inputs": [B, seq_len], "targets": [B, seq_len]} int32.
    """

    def __init__(self, ds: TokenDataset, batch_size: int, *, seed: int,
                 dp_rank: int, dp_size: int, drop_remainder: bool):
        if not (0 <= dp_rank < dp_size):
            raise ValueError(f"dp_rank {dp_rank} not in [0, {dp_size})")
        self.ds = ds
        self.batch_size = batch_size
        self.seed = seed
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.drop_remainder = drop_remainder
        self.epoch = 0
        self.step = 0
        self._perm: np.ndarray | None = None
        n_rank = (ds.n_windows - dp_rank + dp_size - 1) // dp_size
        if drop_remainder and n_rank < batch_size:
            raise ValueError(
                f"batch_size {batch_size} exceeds this rank's {n_rank} "
                f"windows/epoch (corpus too small for dp_size={dp_size} "
                f"with drop_remainder)"
            )

    # -- checkpoint/resume ------------------------------------------------
    def state(self) -> dict:
        """NOTE: when the iterator is wrapped in device_prefetch, the pump
        thread has advanced it PAST what the consumer has seen — snapshot
        with seek(consumed_batches) semantics instead (count batches in the
        training loop and call seek on resume), or checkpoint before
        wrapping."""
        return {"epoch": self.epoch, "step": self.step, "seed": self.seed,
                "dp_rank": self.dp_rank, "dp_size": self.dp_size,
                "batch_size": self.batch_size, "seq_len": self.ds.seq_len,
                "n_windows": self.ds.n_windows}

    def restore(self, state: dict) -> "BatchIterator":
        # position is step * batch_size within THIS rank's permutation of
        # THIS window grid — every one of these changes what it replays
        checks = {
            "seed": self.seed, "dp_size": self.dp_size,
            "dp_rank": self.dp_rank, "batch_size": self.batch_size,
            "seq_len": self.ds.seq_len, "n_windows": self.ds.n_windows,
        }
        for key, val in checks.items():
            if key in state and state[key] != val:
                raise ValueError(
                    f"restore: {key} mismatch (checkpoint {state[key]}, "
                    f"iterator {val})"
                )
        self.epoch = int(state["epoch"])
        self.step = int(state["step"])
        self._perm = None
        return self

    def seek(self, n_batches: int) -> "BatchIterator":
        """Position the stream as if n_batches had been consumed from the
        start — the prefetch-safe resume: the training loop checkpoints its
        own consumed count, not the (look-ahead-advanced) iterator."""
        spe = self.steps_per_epoch()
        self.epoch, self.step = divmod(int(n_batches), spe)
        self._perm = None
        return self

    # -- iteration --------------------------------------------------------
    def _epoch_perm(self) -> np.ndarray:
        if self._perm is None:
            rng = np.random.default_rng((self.seed, self.epoch))
            perm = rng.permutation(self.ds.n_windows)
            self._perm = perm[self.dp_rank :: self.dp_size]
        return self._perm

    def steps_per_epoch(self) -> int:
        n = len(self._epoch_perm()) if self._perm is not None else (
            (self.ds.n_windows - self.dp_rank + self.dp_size - 1) // self.dp_size
        )
        return n // self.batch_size if self.drop_remainder else (
            (n + self.batch_size - 1) // self.batch_size
        )

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        perm = self._epoch_perm()
        lo = self.step * self.batch_size
        if lo + (self.batch_size if self.drop_remainder else 1) > len(perm):
            # epoch rollover — the stream is infinite; epoch boundaries are
            # visible through .state()/.epoch
            self.epoch += 1
            self.step = 0
            self._perm = None
            perm = self._epoch_perm()
            lo = 0
        ids = perm[lo : lo + self.batch_size]
        self.step += 1
        batch = self.ds.gather(ids)
        return {"inputs": batch[:, :-1], "targets": batch[:, 1:]}


def device_prefetch(it, *, lookahead: int = 2, device=None):
    """Wrap a batch iterator (each batch a dict, list or tuple of numpy
    arrays): a background thread stages ``lookahead`` batches onto
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``; raises
    without a GPU) while the consumer runs the current step, and ``next``
    returns them as tensors. On a card each batch goes through pinned host
    memory on a copy stream; the consumer's current stream waits on the
    copy's event and ``record_stream`` marks the tensors as used there.
    Batch assembly (native gather, GIL-free) and the copy overlap the
    card's work."""
    import torch

    from .. import resolve_device

    dev = resolve_device(device)
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=lookahead)
    stop = threading.Event()
    done = object()  # end-of-stream sentinel: a finite iterator must
    # surface StopIteration, not deadlock the consumer's q.get()

    def to_device(x):
        if isinstance(x, dict):
            return {k: to_device(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to_device(v) for v in x)
        t = torch.from_numpy(np.ascontiguousarray(x))
        if copy_stream is None:
            return t
        return t.pin_memory().to(dev, non_blocking=True)

    def tensors(x):
        if isinstance(x, dict):
            return [t for v in x.values() for t in tensors(v)]
        if isinstance(x, (list, tuple)):
            return [t for v in x for t in tensors(v)]
        return [x]

    def pump():
        try:
            for batch in it:
                if stop.is_set():
                    return
                if copy_stream is None:
                    q.put((to_device(batch), None))
                    continue
                with torch.cuda.stream(copy_stream):
                    staged = to_device(batch)
                    ready = torch.cuda.Event()
                    ready.record(copy_stream)
                q.put((staged, ready))
            q.put(done)
        except BaseException as e:  # noqa: BLE001 - surfaced to consumer
            q.put(e)

    t = threading.Thread(target=pump, daemon=True, name="gofr-data-prefetch")
    t.start()

    class _Prefetched:
        def __iter__(self):
            return self

        def __next__(self):
            item = q.get()
            if item is done:
                raise StopIteration
            if isinstance(item, BaseException):
                raise item
            staged, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(ready)
                for x in tensors(staged):
                    x.record_stream(stream)
            return staged

        def close(self):
            stop.set()
            try:
                q.get_nowait()  # unblock a full queue
            except queue.Empty:
                pass

    return _Prefetched()
