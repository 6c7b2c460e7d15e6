"""LLM serving engine (counterpart of gofr_tpu/llm.py, main path only).

``LLMEngine`` serves ``GenRequest``s from one scheduler thread over the
paged KV pool, in the JAX engine's default configuration:

- chunked prefill: prompts advance through unified device steps of
  {16, 64}-token chunks (the prefill buckets capped at PREFILL_CHUNK)
  under a STEP_TOKEN_BUDGET of 256 tokens, the active slots' decode
  chunk charged first, prefill rows packed up to ADMIT_CAP with a FIFO
  head-of-line rule (``_dispatch_step``);
- the unified step program (JAX ``llm.step_p{S}_d{K}``): gather the
  packed rows' slot views through the block tables, run
  ``prefill_append``, scatter the chunk rows back into the pool, sample
  first tokens for rows whose prompt completed, activate them, then run
  one fused ``decode_chunk_paged`` for every live slot;
- the pure decode chunk program (JAX ``llm.decode_chunk{K}``) when no
  prompt is pending, K = 8 (or 2 for tail ends);
- greedy (temperature 0) or top-64 temperature sampling from a
  ``torch.Generator``, with the ``finite_guard`` sentinel;
- retirement on every scheduler pass (``_expire_deadlines``): a request
  cancelled by its caller or its edge (a client that hung up), or past
  its ``deadline``, ends at once whether it waits or holds a slot, and
  its slot and KV blocks are freed;
- int8 serving, as the JAX engine's two flags: ``quantize=True`` serves
  int8 weights (``models.quant``; W8A8 prefill, weight-only decode) and
  ``kv_int8=True`` an int8 KV pool with float32 row scales, read by the
  int8 paged-decode kernel. Either works alone.

The pack/meta layouts of the JAX programs are kept: pack [nb, S+3] int32
= tokens | cursor | n_new | temperature bits; meta [2, nb] int32 = slot
(``slots`` for inert padding lanes) | finish flag.

Left out of this slice (queued in ROADMAP.md): lookahead pipelining and
the collector thread — a step's tokens are fetched and emitted before the
next dispatch — and every feature that is off by default in the JAX
engine (speculation, grammar, LoRA, prefix cache, sessions, overload
control and fair queuing, goodput, flight recorder), plus the monolithic
wave scheduler. ``GenRequest`` carries the edge's identity fields
(``priority``, ``client``, ``session_id``) so the edge hands them over as
the JAX edge does, but this FIFO scheduler does not act on them.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch

from . import resolve_device
from .kvcache import CacheManager, gather_slots, scatter_rows
from .models.quant import QTensor, is_quantized, quantize_params
from .models.transformer import decode_chunk_paged, prefill_append

_EOS_DEFAULT = -1  # no EOS cut by default (random-weight models)

# The JAX engine's serving defaults (llm.py:629-762, kvcache/__init__.py:411)
DECODE_CHUNK = 8  # fused decode steps per chunk
PREFILL_CHUNK = 64  # widest prefill chunk shape
STEP_TOKEN_BUDGET = 256  # tokens one unified step may carry
ADMIT_CAP = 8  # prefill rows per unified step
KV_BLOCK = 16  # tokens per KV pool block


class EngineStoppedError(RuntimeError):
    """submit() on a closed engine."""


class RequestFailed(RuntimeError):
    """Raised by GenRequest.stream()/tokens() when the engine could not
    serve the request (a device error, or non-finite logits)."""


def finite_guard(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """Numerical-watchdog sentinel: replace each sampled token whose
    logits row holds NaN/Inf with -1, an id no sampler produces; the
    engine turns it into a failed request instead of streaming garbage."""
    ok = torch.isfinite(logits).all(dim=-1)
    return torch.where(ok, toks, torch.full_like(toks, -1))


def _sample_raw(logits: torch.Tensor, temps: torch.Tensor, generator, topk: int = 64) -> torch.Tensor:
    """Greedy for temp == 0; otherwise a categorical draw (Gumbel-max over
    uniforms from ``generator``) restricted to the top-``topk`` logits,
    which keeps the random work at batch x 64 instead of batch x vocab."""
    greedy = logits.argmax(dim=-1)
    topv, topi = torch.topk(logits, min(topk, logits.shape[-1]), dim=-1)
    u = torch.rand(topv.shape, generator=generator, device=logits.device).clamp_(min=1e-20)
    gumbel = -torch.log(-torch.log(u))
    local = (topv / temps.clamp(min=1e-4)[:, None] + gumbel).argmax(dim=-1)
    sampled = topi.gather(1, local[:, None])[:, 0]
    return torch.where(temps > 0.0, sampled, greedy).to(torch.int32)


def _scatter_slots(vec: torch.Tensor, idx: torch.Tensor, values) -> None:
    """vec[idx[i]] = values[i] IN PLACE, dropping idx outside [0, len) —
    the JAX ``.at[idx].set(values, mode="drop")`` on the engine's small
    per-slot vectors, written as a select so it needs no host sync.
    Indices must be distinct."""
    n = vec.shape[0]
    hit = idx.long()[:, None] == torch.arange(n, device=vec.device)[None, :]  # [m, n]
    vals = torch.as_tensor(values, device=vec.device).to(vec.dtype).expand(idx.shape[0])
    picked = vals[hit.int().argmax(dim=0)]
    torch.where(hit.any(dim=0), picked, vec, out=vec)


def _rows_at(stack: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """[L, S, C, h, d] rows at per-slot positions [S, W] -> [L, S, W, h, d]."""
    L, S, C, h, d = stack.shape
    idx = pos.long().clamp(0, C - 1)[None, :, :, None, None].expand(L, S, pos.shape[1], h, d)
    return torch.gather(stack, 2, idx)


@dataclass(eq=False)  # identity semantics: requests are handles
class GenRequest:
    prompt_tokens: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_token: int = _EOS_DEFAULT
    # Identity from the serving edge (``handler.llm_request_kwargs``): the
    # X-GoFr-Priority class, the fair-queuing client id and the
    # X-GoFr-Session conversation id. Kept so the edge hands them over as
    # it does to the JAX engine; this port's FIFO scheduler does not act
    # on them yet (no priority classes, fair queuing or session tier), so
    # they change nothing in what is served.
    priority: str = "interactive"
    client: str = ""
    session_id: str = ""
    # Absolute wall deadline (time.perf_counter timebase). Past it the
    # engine retires the request even while it holds a slot
    # (finish_reason "deadline"). Handlers pass ctx.deadline here.
    deadline: float | None = None
    # LoRA adapter name: the port has no adapter pool, so submit() refuses
    # a non-empty name (as the JAX engine does without one).
    adapter: str = ""
    id: int = field(default_factory=itertools.count().__next__)

    def __post_init__(self):
        self.out: queue.Queue = queue.Queue()
        self.cancelled = False
        # becomes the finish_reason when the engine retires the request:
        # "cancelled" for a caller's cancel, "disconnect" when the serving
        # edge found the peer gone
        self.cancel_reason = "cancelled"
        self.emitted = 0
        self.capped = False  # engine reduced max_new_tokens to fit the cache
        # "eos" | "length" | "cancelled" | "disconnect" | "deadline" | "error"
        self.finish_reason: str | None = None
        self.error: str | None = None
        self.submitted_at: float | None = None
        self.first_token_at: float | None = None
        # chunked-prefill scheduler state (engine-maintained)
        self.prefill_pos = 0  # prompt tokens already appended to slot KV
        self.prefill_done = False  # all prompt tokens resident; decoding
        self.slot: int | None = None  # slot index while resident
        self._kv_limit = 0  # worst-case rows (CacheManager.reserve_tokens)

    def _raise_terminal(self) -> None:
        if self.finish_reason == "error":
            raise RequestFailed(f"request {self.id} failed: {self.error}")

    def _consumer_gone(self) -> None:
        """The consuming generator was closed before the stream finished
        (the edge found the peer gone, or the caller dropped the
        iterator): cancel, so the engine frees the slot instead of
        decoding for nobody."""
        if self.finish_reason is None and not self.cancelled:
            self.cancel(reason="disconnect")

    def stream(self, timeout: float = 60.0) -> Iterator[int]:
        """Yield token ids until the engine signals completion; raises
        RequestFailed when the engine could not serve the request."""
        try:
            while True:
                item = self.out.get(timeout=timeout)
                if item is None:
                    self._raise_terminal()
                    return
                yield from item
        except GeneratorExit:
            self._consumer_gone()
            raise

    async def astream(self, timeout: float = 60.0):
        """``stream`` for asyncio callers: each wait for the engine runs in
        the loop's executor, never on the event loop."""
        import asyncio

        loop = asyncio.get_running_loop()
        try:
            while True:
                item = await loop.run_in_executor(None, lambda: self.out.get(timeout=timeout))
                if item is None:
                    self._raise_terminal()
                    return
                for t in item:
                    yield t
        except GeneratorExit:
            self._consumer_gone()
            raise

    def cancel(self, reason: str = "cancelled") -> None:
        self.cancel_reason = reason
        self.cancelled = True

    def tokens(self, timeout: float = 60.0) -> list[int]:
        return list(self.stream(timeout=timeout))


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.q.to(device), tree.s.to(device))
    return tree.to(device)


class LLMEngine:
    """Paged-KV serving engine with chunked prefill and fused decode
    chunks. Runs on ``cuda`` unless ``device="cpu"`` is passed (the CPU
    runs every kernel's plain version); raises without a GPU otherwise.

    ``quantize=True`` quantizes the params to int8 at construction unless
    they already are; ``kv_int8=True`` stores the KV pool as int8 rows
    with float32 scales."""

    def __init__(
        self,
        cfg,
        params: dict,
        *,
        slots: int = 32,
        max_seq_len: int = 512,
        prefill_buckets: tuple[int, ...] = (16, 64, 128),
        seed: int = 0,
        device=None,
        quantize: bool = False,
        kv_int8: bool = False,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        if quantize and not is_quantized(self.params):
            self.params = quantize_params(self.params, cfg.dtype)
        self.quantized = bool(quantize)
        self.slots = slots
        self.max_seq_len = max_seq_len
        self.prefill_buckets = tuple(sorted(b for b in prefill_buckets if b <= max_seq_len))
        self.decode_chunk = DECODE_CHUNK
        self._chunk_short = max(1, DECODE_CHUNK // 4)
        self.admit_cap = min(ADMIT_CAP, slots)
        self.step_token_budget = STEP_TOKEN_BUDGET
        # the prefill buckets survive as the chunk shapes, capped at the
        # widest chunk, so short prompts keep their tight shapes
        shapes = {min(b, PREFILL_CHUNK) for b in self.prefill_buckets}
        shapes.discard(0)
        self.chunk_shapes = tuple(sorted(shapes)) or (min(PREFILL_CHUNK, max_seq_len),)
        self.kv = CacheManager(
            cfg, slots, max_seq_len, DECODE_CHUNK, append_widths=self.chunk_shapes, block=KV_BLOCK,
            kv_int8=kv_int8,
        )
        dev = self.device
        # device-resident state: the paged pool (+ per-slot lengths, and
        # the int8 pool's scales), the block tables' device mirror, the
        # chain tail, active mask and temperatures. active is never cleared
        # on retire: the host live mask keeps a retired slot from
        # advancing or writing.
        self.pool, self.pool_scales = self.kv.pool_tensors(dev)
        self._tables_dev = torch.zeros((slots, self.kv.table_width), dtype=torch.int32, device=dev)
        self._tail = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self._temps = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        # host-side scheduler state (scheduler thread only)
        self._slot_req: list[GenRequest | None] = [None] * slots
        self._kv_hi = [0] * slots  # per-slot block allocation watermark
        self._admit_q: queue.Queue[GenRequest] = queue.Queue()
        self._waiting: deque[GenRequest] = deque()
        self._prefilling: deque[GenRequest] = deque()
        self._lock = threading.Lock()  # counters read by stats()
        self._kick = threading.Event()
        self._stop = False
        self.error: str | None = None
        self.submitted = 0
        self.finished = 0
        self.steps = 0  # unified steps dispatched
        self.step_tokens = 0  # tokens packed into unified steps
        self.chunks = 0  # decode chunks (fused or pure) dispatched
        self.deadline_cancels = 0  # requests retired past their deadline
        self.disconnect_cancels = 0  # requests retired for a vanished consumer
        self._thread = threading.Thread(
            target=self._schedule_loop, name="llm-torch-sched", daemon=True
        )
        self._thread.start()

    # -- public API -------------------------------------------------------
    def submit(self, req: GenRequest) -> GenRequest:
        if self._stop:
            raise EngineStoppedError(f"engine stopped ({self.error or 'closed'})")
        if req.adapter:
            raise ValueError(
                f"request names adapter {req.adapter!r} but this engine has no adapter pool"
            )
        plen = len(req.prompt_tokens)
        if plen == 0:
            raise ValueError("empty prompt")
        if plen >= self.max_seq_len:
            raise ValueError(f"prompt of {plen} tokens exceeds max_seq_len {self.max_seq_len}")
        # cap max_new_tokens so a slot's rows stay inside its capacity: a
        # request's length may overshoot by one decode chunk, and the
        # end-of-chunk merge needs another chunk of slack
        room = self.max_seq_len - plen - 2 * self.decode_chunk
        if room < 1:
            raise ValueError(
                f"prompt of {plen} tokens leaves no decode room at max_seq_len "
                f"{self.max_seq_len} (chunk {self.decode_chunk})"
            )
        if req.max_new_tokens > room:
            req.max_new_tokens = room
            req.capped = True
        need = self.kv.reserve_need(plen, req.max_new_tokens)
        if need > self.kv.pool.n_blocks:
            raise ValueError(f"request needs {need} KV blocks, pool holds {self.kv.pool.n_blocks}")
        req.submitted_at = time.perf_counter()
        with self._lock:
            self.submitted += 1
        self._admit_q.put(req)
        if self._stop:  # stopped between the check above and the put
            self._end_all("error" if self.error else "cancelled")
        self._kick.set()
        return req

    def generate(self, prompt_tokens: list[int], **kw) -> list[int]:
        return self.submit(GenRequest(prompt_tokens, **kw)).tokens()

    def stats(self) -> dict:
        with self._lock:
            return {
                "scheduler": "chunked",
                "slots": self.slots,
                "quantized": self.quantized,
                "submitted": self.submitted,
                "finished": self.finished,
                "steps": self.steps,
                "step_tokens": self.step_tokens,
                "chunks": self.chunks,
                "deadline_cancels": self.deadline_cancels,
                "disconnect_cancels": self.disconnect_cancels,
                "chunk_shapes": self.chunk_shapes,
                "kvcache": self.kv.stats(),
                "error": self.error,
            }

    def close(self, timeout: float = 30.0) -> None:
        """Stop the scheduler and end every unfinished stream."""
        self._stop = True
        self._kick.set()
        self._thread.join(timeout=timeout)
        self._end_all("cancelled")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- scheduler ------------------------------------------------------------
    def _schedule_loop(self) -> None:
        try:
            with torch.no_grad():
                while not self._stop:
                    self._drain_submits()
                    self._expire_deadlines(time.perf_counter())
                    self._admit()
                    if self._prefilling and self._dispatch_step():
                        continue
                    needed = self._needed_steps()
                    if needed > 0:
                        self._dispatch_chunk(needed)
                        continue
                    self._kick.wait(timeout=0.005)
                    self._kick.clear()
        except Exception as e:  # noqa: BLE001 — a dead engine must end every stream
            self.error = f"{type(e).__name__}: {e}"
            self._stop = True
            self._end_all("error")
            raise

    def _end_all(self, reason: str) -> None:
        pending = list(self._waiting) + [r for r in self._slot_req if r is not None]
        while True:
            try:
                pending.append(self._admit_q.get_nowait())
            except queue.Empty:
                break
        for r in pending:
            if r.finish_reason is None:
                r.error = self.error
                self._finish(r, reason)

    def _finish(self, r: GenRequest, reason: str) -> None:
        """Terminal bookkeeping: end the stream and return the slot (and
        its blocks) when ``r`` still owns it."""
        r.finish_reason = reason
        r.out.put(None)
        with self._lock:
            self.finished += 1
            self.deadline_cancels += reason == "deadline"
            self.disconnect_cancels += reason == "disconnect"
        slot = r.slot
        if slot is not None and self._slot_req[slot] is r:
            self._slot_req[slot] = None
            self.kv.release_slot(slot, r)
            self._kv_hi[slot] = 0

    def _drain_submits(self) -> None:
        while True:
            try:
                self._waiting.append(self._admit_q.get_nowait())
            except queue.Empty:
                return

    def _expire_deadlines(self, now: float) -> None:
        """Retire every request, waiting or slotted, that was cancelled or
        whose deadline has passed (JAX ``LLMEngine._expire_deadlines``).
        Without it a cancelled occupant of an idle engine kept its slot
        and blocks: only a later dispatch's ``_emit_to`` would finish it.
        The port fetches every step before the next dispatch, so no
        device work is in flight here and a retired slot is free at once.
        Runs once per scheduler pass: O(slots + waiting), no device work."""

        def reason(r: GenRequest) -> str | None:
            if r.cancelled:
                return r.cancel_reason
            if r.deadline is not None and now > r.deadline:
                return "deadline"
            return None

        retired = False
        for r in self._slot_req:
            if r is not None and (why := reason(r)) is not None:
                self._finish(r, why)  # frees the slot and its blocks
                retired = True
        kept: deque[GenRequest] = deque()
        for r in self._waiting:
            if (why := reason(r)) is not None:
                self._finish(r, why)
            else:
                kept.append(r)
        self._waiting = kept
        if retired:
            self._prefilling = deque(r for r in self._prefilling if r.finish_reason is None)

    def _admit(self) -> None:
        """Give waiting requests free slots, FIFO. A request the pool
        cannot reserve blocks for stays at the head of the queue."""
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        while self._waiting and free:
            r = self._waiting[0]
            plen = len(r.prompt_tokens)
            if not self.kv.admit_reserve(plen, r.max_new_tokens):
                break
            self._waiting.popleft()
            slot = free.pop(0)
            self._slot_req[slot] = r
            r.slot = slot
            r.prefill_pos = 0
            r.prefill_done = False
            self.kv.attach(slot, r, plen, r.max_new_tokens)
            r._kv_limit = self.kv.reserve_tokens(plen, r.max_new_tokens)
            self._kv_hi[slot] = 0
            self._prefilling.append(r)

    def _needed_steps(self) -> int:
        """Decode steps still required by the decoding occupants."""
        worst = 0
        for r in self._slot_req:
            if r is not None and r.prefill_done and not r.cancelled:
                worst = max(worst, r.max_new_tokens - r.emitted)
        return worst

    def _chunk_shape_for(self, n: int) -> int:
        """Smallest chunk shape that covers n pending tokens, else the
        largest (the prompt then takes several chunks)."""
        for s in self.chunk_shapes:
            if n <= s:
                return s
        return self.chunk_shapes[-1]

    def _wave_width(self, n: int) -> int:
        """Step batch dim: next power of two, capped at admit_cap."""
        return min(self.admit_cap, 1 << max(0, n - 1).bit_length())

    def _tables_device(self) -> torch.Tensor:
        """Device mirror of the block tables, re-shipped only when the
        host bookkeeping changed."""
        t = self.kv.take_tables()
        if t is not None:
            self._tables_dev = torch.from_numpy(t).to(self.device)
        return self._tables_dev

    def _grow(self, slot: int, r: GenRequest, hi: int) -> None:
        """Raise a slot's block watermark to ``hi`` rows (bounded by the
        request's worst case) and materialize the blocks."""
        self._kv_hi[slot] = min(max(self._kv_hi[slot], hi), r._kv_limit or self.kv.capacity)
        self.kv.ensure(slot, self._kv_hi[slot])

    @staticmethod
    def _sample(logits, temps, generator):
        return finite_guard(logits, _sample_raw(logits, temps, generator))

    def _dispatch_step(self) -> bool:
        """Pack one unified step: the active slots' decode chunk fused
        with up to admit_cap pending prefill chunks. Decode tokens are
        charged against step_token_budget first; prefill fills what
        remains, floored at one chunk. Returns False when every queued
        prefill row turned out stale (cancelled)."""
        K = self.decode_chunk
        active_n = sum(1 for r in self._slot_req if r is not None and r.prefill_done)
        rows: list[tuple[GenRequest, int]] = []
        shape = budget_left = 0
        keep: deque[GenRequest] = deque()
        while self._prefilling:
            r = self._prefilling.popleft()
            if r.slot is None or self._slot_req[r.slot] is not r or r.prefill_done:
                continue
            if r.cancelled:
                self._finish(r, r.cancel_reason)
                continue
            rem = len(r.prompt_tokens) - r.prefill_pos
            if not rows:
                # the first row fixes the step's chunk shape and the
                # prefill allowance: budget minus the decode tokens
                # riding this step, floored at one chunk
                shape = self._chunk_shape_for(rem)
                budget_left = max(min(rem, shape), self.step_token_budget - K * active_n)
            n = min(shape, rem)
            if len(rows) == self.admit_cap or n > budget_left:
                keep.append(r)  # head-of-line stays FIFO for the next step
                break
            rows.append((r, n))
            budget_left -= n
            if r.prefill_pos + n < len(r.prompt_tokens):
                keep.append(r)  # more chunks to come
        keep.extend(self._prefilling)
        self._prefilling = keep
        if not rows:
            return False

        nb = self._wave_width(len(rows))
        pack = np.zeros((nb, shape + 3), np.int32)
        meta = np.zeros((2, nb), np.int32)
        meta[0, :] = self.slots  # padding lanes: inert (their writes drop)
        finishes: list[tuple[int, int, GenRequest]] = []
        prefill_tokens = 0
        for j, (r, n) in enumerate(rows):
            pos = r.prefill_pos
            pack[j, :n] = r.prompt_tokens[pos : pos + n]
            pack[j, shape] = pos
            pack[j, shape + 1] = n
            pack[j, shape + 2] = np.float32(r.temperature).view(np.int32)
            meta[0, j] = r.slot
            done = pos + n >= len(r.prompt_tokens)
            meta[1, j] = 1 if done else 0
            r.prefill_pos = pos + n
            # blocks for the appended rows (+ the fused decode chunk when
            # this row activates)
            self._grow(r.slot, r, pos + n + (K if done else 0))
            prefill_tokens += n
            if done:
                r.prefill_done = True
                finishes.append((j, r.slot, r))
        fin_slots = {s for _j, s, _r in finishes}
        live = np.zeros((self.slots,), bool)
        for i, r in enumerate(self._slot_req):
            if r is None or not r.prefill_done:
                continue
            if i not in fin_slots:
                if r.emitted >= r.max_new_tokens:
                    continue  # satisfied lane: must not advance past its blocks
                self._grow(i, r, self._kv_hi[i] + K)
            live[i] = True
        first, toks = self._step_program(shape, pack, meta, live, self._tables_device())
        snapshot = [r if (r is not None and r.prefill_done) else None for r in self._slot_req]
        first_h = first.cpu().tolist()
        toks_h = toks.cpu().numpy()
        with self._lock:
            self.steps += 1
            self.step_tokens += prefill_tokens + K * sum(r is not None for r in snapshot)
            self.chunks += 1
        now = time.perf_counter()
        for j, slot, r in finishes:
            self._emit_to(r, slot, [first_h[j]], now)
        for slot, r in enumerate(snapshot):
            if r is not None:
                self._emit_to(r, slot, toks_h[:, slot].tolist(), now)
        return True

    def _dispatch_chunk(self, needed: int) -> None:
        """One pure decode chunk for the decoding slots: the short chunk
        only when even it covers the whole remaining demand."""
        k = self._chunk_short if needed <= self._chunk_short else self.decode_chunk
        snapshot = [r if (r is not None and r.prefill_done) else None for r in self._slot_req]
        live = np.zeros((self.slots,), bool)
        for i, r in enumerate(snapshot):
            if r is None or r.emitted >= r.max_new_tokens:
                continue
            live[i] = True
            self._grow(i, r, self._kv_hi[i] + k)
        toks = self._chunk_program(k, live, self._tables_device())
        toks_h = toks.cpu().numpy()
        with self._lock:
            self.chunks += 1
        now = time.perf_counter()
        for slot, r in enumerate(snapshot):
            if r is not None:
                self._emit_to(r, slot, toks_h[:, slot].tolist(), now)

    def _emit_to(self, r: GenRequest, slot: int, toks: list[int], now: float) -> None:
        """Append a request's next tokens, honoring max_new/eos/cancel and
        the -1 non-finite sentinel."""
        if r.finish_reason is not None:
            return
        finish = None
        if r.cancelled:
            toks, finish = [], r.cancel_reason
        toks = toks[: r.max_new_tokens - r.emitted]
        if -1 in toks:
            toks = toks[: toks.index(-1)]
            r.error = "non-finite logits"
            finish = "error"
        if r.eos_token >= 0 and r.eos_token in toks:
            toks = toks[: toks.index(r.eos_token) + 1]
            finish = "eos"
        if toks:
            if r.emitted == 0:
                r.first_token_at = now
            r.out.put(toks)
            r.emitted += len(toks)
        if finish is None and r.emitted >= r.max_new_tokens:
            finish = "length"
        if finish is not None:
            self._finish(r, finish)

    # -- device programs ------------------------------------------------------
    def _step_program(self, shape, pack, meta, live, tables):
        """The unified step (JAX ``llm.step_p{shape}_d{K}``). Updates the
        pool (and its int8 scales), lengths, tail, active and temps IN
        PLACE; returns (first tokens [nb], decode tokens [K, slots]). An
        int8 pool's packed slot views are dequantized in the model dtype;
        the chunk rows are quantized again at the scatter back."""
        dev, cfg, slots, sc = self.device, self.cfg, self.slots, self.pool_scales
        cap = self.kv.capacity
        pack_t = torch.from_numpy(pack).to(dev)
        meta_t = torch.from_numpy(meta).to(dev)
        live_t = torch.from_numpy(live).to(dev)
        tokens = pack_t[:, :shape]
        cursors = pack_t[:, shape].contiguous()
        n_new = pack_t[:, shape + 1].contiguous()
        req_temps = pack_t[:, shape + 2].contiguous().view(torch.float32)
        slot_idx, finish = meta_t[0], meta_t[1]
        tsub = tables[slot_idx.clamp(0, slots - 1).long()]
        sub = gather_slots(
            self.pool.k, self.pool.v, tsub, cursors,
            scales=None if sc is None else (sc[0], sc[1]), dtype=cfg.dtype,
        )
        logits, sub2 = prefill_append(self.params, cfg, tokens, sub, cursors, n_new)
        ar = torch.arange(shape, device=dev)[None, :]
        pos_a = cursors[:, None].long() + ar
        valid_a = (ar < n_new[:, None]) & (pos_a < cap)
        scatter_rows(
            self.pool.k, self.pool.v, tsub,
            _rows_at(sub2.k, pos_a), _rows_at(sub2.v, pos_a), pos_a, valid_a, scales=sc,
        )
        _scatter_slots(self.pool.length, slot_idx, cursors + n_new)
        first = self._sample(logits, req_temps, self._gen)
        fin_slot = torch.where(finish == 1, slot_idx, slots)
        mid_slot = torch.where(finish == 1, slots, slot_idx)
        _scatter_slots(self._active, mid_slot, False)
        _scatter_slots(self._tail, fin_slot, first)
        _scatter_slots(self._active, fin_slot, True)
        _scatter_slots(self._temps, fin_slot, req_temps)
        toks, last, _ = decode_chunk_paged(
            self.params, cfg, self._tail, self.pool, tables, self._active & live_t,
            self._temps, self._gen, n_steps=self.decode_chunk, sample_fn=self._sample,
            block=self.kv.block, scales=sc,
        )
        self._tail = last
        return first, toks

    def _chunk_program(self, k: int, live, tables):
        """The pure decode chunk (JAX ``llm.decode_chunk{K}``): returns
        tokens [k, slots]; the pool, lengths and tail advance in place."""
        live_t = torch.from_numpy(live).to(self.device)
        toks, last, _ = decode_chunk_paged(
            self.params, self.cfg, self._tail, self.pool, tables, self._active & live_t,
            self._temps, self._gen, n_steps=k, sample_fn=self._sample, block=self.kv.block,
            scales=self.pool_scales,
        )
        self._tail = last
        return toks
