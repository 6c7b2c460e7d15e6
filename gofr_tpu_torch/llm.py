"""LLM serving engine (counterpart of gofr_tpu/llm.py, main path only).

``LLMEngine`` serves ``GenRequest``s from a scheduler thread and a
collector thread over the paged KV pool, in the JAX engine's default
configuration:

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
- ``warmup=True``: on a CUDA device every program family (each chunk
  shape x wave width of the step, each K of the chunk) is captured at
  construction as one CUDA graph, all in one graph memory pool; every
  dispatch after that is one replay (``warmup=False`` captures a family
  at its first dispatch). The programs read their host inputs from one
  device buffer at a fixed address, filled from a ring of pinned host
  buffers, and write all state in place. On the CPU the same program
  functions run eagerly;
- ``lookahead=3``: up to three programs in flight. Each dispatch copies
  its tokens to pinned host memory behind an event; the collector thread
  waits on that event, emits, and serves prefill first tokens ahead of
  queued chunk tokens (one jump per processed chunk). The scheduler
  counts the decode steps in flight (``_inflight_steps``): a slot whose
  in-flight programs cover its owner's remaining tokens is admitted into
  at once (``_free_slots``), demand is net of them (``_needed_steps``),
  satisfied lanes stop advancing, and the depth gate dispatches one
  unified step per pass while prefill is pending, then as many chunks as
  the demand and the depth allow;
- greedy (temperature 0) or top-64 temperature sampling from a
  ``torch.Generator`` (registered with every graph, so each replay draws
  fresh uniforms), with the ``finite_guard`` sentinel;
- retirement on every scheduler pass (``_expire_deadlines``): a request
  cancelled by its caller or its edge (a client that hung up), or past
  its ``deadline``, ends at once whether it waits or holds a slot, and
  its slot and blocks are free; tokens of its programs still in flight
  are dropped;
- int8 serving, as the JAX engine's two flags: ``quantize=True`` serves
  int8 weights (``models.quant``; W8A8 prefill, weight-only decode) and
  ``kv_int8=True`` an int8 KV pool with float32 row scales, read by the
  int8 paged-decode kernel. Either works alone.

The pack/meta layouts of the JAX programs are kept: pack [nb, S+3] int32
= tokens | cursor | n_new | temperature bits; meta [2, nb] int32 = slot
(``slots`` for inert padding lanes) | finish flag.

Left out of this slice (queued in ROADMAP.md): every feature that is off
by default in the JAX engine (speculation, grammar, LoRA, prefix cache,
sessions, overload control and fair queuing, goodput, flight recorder),
plus the monolithic wave scheduler. ``GenRequest`` carries the edge's
identity fields (``priority``, ``client``, ``session_id``) so the edge
hands them over as the JAX edge does, but this FIFO scheduler does not
act on them.
"""

from __future__ import annotations

import contextlib
import functools
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
from .ops.attention import add_launches, capture_launches

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
    if isinstance(values, torch.Tensor):
        vals = values.to(vec.dtype).expand(idx.shape[0])
    else:  # made on the device: a host tensor would need a copy a graph cannot capture
        vals = torch.full(idx.shape, values, dtype=vec.dtype, device=vec.device)
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


class _Inputs:
    """The programs' host inputs in ONE int32 device buffer at a fixed
    address, which every captured graph reads: tables [slots, MB] | live
    [slots] | meta [2, admit_cap] | pack [admit_cap, S_max + 3] (a step
    of nb rows and shape S uses the first 2 nb and nb (S + 3) elements of
    the last two). ``write`` fills it from a ring of ``depth`` pinned host
    buffers with one async copy; each buffer is rewritten only after the
    event recorded behind its last copy, so a later dispatch never
    overwrites pinned memory a queued copy has not read yet."""

    def __init__(self, device, slots: int, table_width: int, admit_cap: int, max_shape: int, depth: int):
        self.slots, self.table_width = slots, table_width
        self.o_live = slots * table_width
        self.o_meta = self.o_live + slots
        self.o_pack = self.o_meta + 2 * admit_cap
        size = self.o_pack + admit_cap * (max_shape + 3)
        self.dev = torch.zeros(size, dtype=torch.int32, device=device)
        cuda = device.type == "cuda"
        self.host = [torch.zeros(size, dtype=torch.int32, pin_memory=cuda) for _ in range(depth if cuda else 1)]
        self.events = [torch.cuda.Event() if cuda else None for _ in self.host]
        self._next = 0

    def tables(self) -> torch.Tensor:
        return self.dev[: self.o_live].view(self.slots, self.table_width)

    def live(self) -> torch.Tensor:
        return self.dev[self.o_live : self.o_meta] != 0

    def meta(self, nb: int) -> torch.Tensor:
        return self.dev[self.o_meta : self.o_meta + 2 * nb].view(2, nb)

    def pack(self, shape: int, nb: int) -> torch.Tensor:
        return self.dev[self.o_pack : self.o_pack + nb * (shape + 3)].view(nb, shape + 3)

    def write(self, tables: np.ndarray, live: np.ndarray, meta=None, pack=None) -> None:
        """Stage one dispatch's inputs (meta and pack for a unified step)
        and enqueue their copy on the current stream."""
        j = self._next
        self._next = (j + 1) % len(self.host)
        if self.events[j] is not None:
            self.events[j].synchronize()  # the copy that last read this buffer has run
        h = self.host[j].numpy()
        h[: self.o_live] = tables.reshape(-1)
        h[self.o_live : self.o_meta] = live
        end = self.o_meta
        if meta is not None:
            h[self.o_meta : self.o_meta + meta.size] = meta.reshape(-1)
            end = self.o_pack + pack.size
            h[self.o_pack : end] = pack.reshape(-1)
        self.dev[:end].copy_(self.host[j][:end], non_blocking=True)
        if self.events[j] is not None:
            self.events[j].record()


class _Fetch:
    """A program's tokens on their way to the host: a pinned copy behind
    an event on CUDA (enqueued right after the replay, before the next
    replay overwrites the graph's output), the tensor itself on the CPU."""

    __slots__ = ("host", "event")

    def __init__(self, out: torch.Tensor):
        if out.device.type == "cpu":
            self.host, self.event = out, None
            return
        # one pinned buffer per entry, owned by it until the collector has
        # read it (PyTorch's pinned-memory cache reuses it only after the
        # copy's recorded event)
        self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        self.host.copy_(out, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


@dataclass
class _Family:
    """One captured program family: its graph, the graph's static output,
    and the kernel launches one replay makes (``ops.attention``)."""

    graph: object  # torch.cuda.CUDAGraph
    out: torch.Tensor
    launches: dict


_WARM_RUNS = 2  # eager runs on the capture stream before a capture


class LLMEngine:
    """Paged-KV serving engine with chunked prefill and fused decode
    chunks. Runs on ``cuda`` unless ``device="cpu"`` is passed (the CPU
    runs every kernel's plain version); raises without a GPU otherwise.

    ``quantize=True`` quantizes the params to int8 at construction unless
    they already are; ``kv_int8=True`` stores the KV pool as int8 rows
    with float32 scales. ``lookahead`` bounds the programs in flight;
    ``warmup=True`` captures every program family as a CUDA graph in the
    constructor (on a CUDA device; a capture that fails raises)."""

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
        lookahead: int = 3,
        warmup: bool = True,
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
        self.lookahead = max(1, int(lookahead))
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
        # device-resident state, written IN PLACE by the programs: the
        # paged pool (+ per-slot lengths, and the int8 pool's scales), the
        # chain tail, active mask and temperatures. active is never cleared
        # on retire: the live mask keeps a retired slot from advancing or
        # writing.
        self.pool, self.pool_scales = self.kv.pool_tensors(dev)
        self._tail = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self._temps = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self._tables_np = np.zeros((slots, self.kv.table_width), np.int32)
        self._in = _Inputs(
            dev, slots, self.kv.table_width, self.admit_cap, self.chunk_shapes[-1], self.lookahead + 1
        )
        # program families, by the JAX compile family's name (+ the wave
        # width of a step): name -> (eager program, step (shape, nb) or None)
        self._programs: dict[str, tuple] = {}
        for shape in self.chunk_shapes:
            for nb in self._wave_widths():
                self._programs[self._step_name(shape, nb)] = (
                    functools.partial(self._step_program, shape, nb), (shape, nb)
                )
        for k in sorted({self.decode_chunk, self._chunk_short}, reverse=True):
            self._programs[f"llm.decode_chunk{k}"] = (functools.partial(self._chunk_program, k), None)
        self.families: dict[str, _Family] = {}  # captured (CUDA only)
        self.warmup_s: float | None = None
        # torch.cuda.memory_reserved() before and after the warmup capture
        self.warmup_reserved: tuple[int, int] | None = None
        # host-side scheduler state, shared with the collector under _lock
        self._slot_req: list[GenRequest | None] = [None] * slots
        self._kv_hi = [0] * slots  # per-slot block allocation watermark
        self._admit_q: queue.Queue[GenRequest] = queue.Queue()
        self._waiting: deque[GenRequest] = deque()
        self._prefilling: deque[GenRequest] = deque()
        self._lock = threading.RLock()
        self._work_cv = threading.Condition(self._lock)  # _inflight appended
        self._kick = threading.Event()  # scheduler wake: submit / entry emitted
        # dispatched programs, oldest first: ("step", fetch, finishes, nb,
        # snapshot, K) or ("chunk", fetch, snapshot, k)
        self._inflight: deque[tuple] = deque()
        self._processing: tuple | None = None  # entry popped, not yet emitted
        self._jumped = False  # prefill-priority ration (one per chunk)
        self._stop = False
        self.error: str | None = None
        self.submitted = 0
        self.finished = 0
        self.steps = 0  # unified steps dispatched
        self.step_tokens = 0  # tokens packed into unified steps
        self.chunks = 0  # decode chunks (fused or pure) dispatched
        self.deadline_cancels = 0  # requests retired past their deadline
        self.disconnect_cancels = 0  # requests retired for a vanished consumer
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(dev)  # every program, copy and capture
            self._graph_pool = torch.cuda.graph_pool_handle()  # shared by the families
            torch.cuda.synchronize(dev)  # params and pool, made on another stream
            if warmup:
                self._warm()
        self._thread = threading.Thread(
            target=self._schedule_loop, name="llm-torch-sched", daemon=True
        )
        self._collector = threading.Thread(
            target=self._collect_loop, name="llm-torch-collect", daemon=True
        )
        self._thread.start()
        self._collector.start()

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
                "inflight_chunks": sum(1 for e in self._inflight if e[0] == "chunk"),
                "deadline_cancels": self.deadline_cancels,
                "disconnect_cancels": self.disconnect_cancels,
                "chunk_shapes": self.chunk_shapes,
                "kvcache": self.kv.stats(),
                "warmup_s": self.warmup_s,
                "error": self.error,
            }

    def close(self, timeout: float = 30.0) -> None:
        """Stop the scheduler, let the collector emit what is in flight,
        and end every unfinished stream."""
        self._stop = True
        self._kick.set()
        self._thread.join(timeout=timeout)
        with self._work_cv:
            self._work_cv.notify_all()
        self._collector.join(timeout=timeout)
        self._end_all("cancelled")
        if self.device.type == "cuda":
            self._stream.synchronize()
            self.families.clear()  # the graphs and their memory pool

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- scheduler ------------------------------------------------------------
    def _schedule_loop(self) -> None:
        try:
            on_card = torch.cuda.stream(self._stream) if self.device.type == "cuda" else contextlib.nullcontext()
            with torch.no_grad(), on_card:
                while not self._stop:
                    self._drain_submits()
                    self._expire_deadlines(time.perf_counter())
                    admitted = self._admit()
                    with self._lock:
                        depth = len(self._inflight) + (self._processing is not None)
                        needed = self._needed_steps()
                        prefilling = bool(self._prefilling)
                    stepped = False
                    if prefilling and depth < self.lookahead:
                        # one unified step per pass; the loop comes
                        # straight back for the next
                        stepped = self._dispatch_step()
                        if stepped:
                            depth += 1
                            needed = max(0, needed - self.decode_chunk)
                    want = min(-(-needed // self.decode_chunk), self.lookahead - depth)
                    for _ in range(max(0, want)):
                        needed = max(0, needed - self._dispatch_chunk(needed))
                    if not admitted and not stepped and want <= 0:
                        self._kick.wait(timeout=0.005)
                        self._kick.clear()
        except Exception as e:  # noqa: BLE001 — a dead engine must end every stream
            self._fail(e)
            raise

    def _fail(self, e: BaseException) -> None:
        self.error = f"{type(e).__name__}: {e}"
        self._stop = True
        self._end_all("error")
        with self._work_cv:
            self._work_cv.notify_all()

    def _end_all(self, reason: str) -> None:
        """End every unfinished stream: waiting, slotted, prefilling and
        carried by an in-flight program; the in-flight programs' tokens
        are dropped. Each stream ends once."""
        with self._lock:
            pending = list(self._waiting) + list(self._prefilling)
            pending += [r for r in self._slot_req if r is not None]
            entries = list(self._inflight) + ([self._processing] if self._processing is not None else [])
            for e in entries:
                pending += self._entry_requests(e)
            self._inflight.clear()
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
        """Terminal bookkeeping: end the stream, and return the slot and
        its blocks when ``r`` still owns them. That is safe with ``r``'s
        programs still in flight: they run before any program dispatched
        later (one stream), so a new owner's writes to a reused block land
        after theirs, and a new owner reads only rows it wrote. The tables
        they read are rewritten only by a later dispatch's copy, which
        runs after them."""
        with self._lock:
            r.finish_reason = reason
            r.out.put(None)
            self.finished += 1
            self.deadline_cancels += reason == "deadline"
            self.disconnect_cancels += reason == "disconnect"
            slot = r.slot
            if slot is not None and self._slot_req[slot] is r:
                self._slot_req[slot] = None
            if slot is not None and self.kv.slot_owner(slot) is r:
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
        whose deadline has passed (JAX ``LLMEngine._expire_deadlines``):
        its stream ends at once and its slot is free for the next
        admission; tokens of its programs still in flight are dropped.
        Runs once per scheduler pass: O(slots + waiting), no device work."""

        def reason(r: GenRequest) -> str | None:
            if r.cancelled:
                return r.cancel_reason
            if r.deadline is not None and now > r.deadline:
                return "deadline"
            return None

        with self._lock:
            retired = False
            for r in self._slot_req:
                if r is not None and r.finish_reason is None and (why := reason(r)) is not None:
                    self._finish(r, why)
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

    def _inflight_steps(self) -> dict[int, int]:
        """Per-slot decode steps already dispatched for the CURRENT owner,
        including the entry the collector took but has not emitted (JAX
        ``_inflight_steps``). Call with the lock held."""
        steps: dict[int, int] = {}
        entries = list(self._inflight)
        if self._processing is not None:
            entries.append(self._processing)
        for e in entries:
            if e[0] == "step":
                # each finishing row carries its first token, and the
                # fused decode part k tokens per snapshot slot
                _, _fetch, finishes, _nb, snapshot, k = e
                for _j, slot, r in finishes:
                    if r is self._slot_req[slot]:
                        steps[slot] = steps.get(slot, 0) + 1
            else:
                _, _fetch, snapshot, k = e
            for slot, r in enumerate(snapshot):
                if r is not None and r is self._slot_req[slot]:
                    steps[slot] = steps.get(slot, 0) + k
        return steps

    def _free_slots(self) -> list[int]:
        """Free or VIRTUALLY free slots: a slot whose in-flight programs
        already cover its request's remaining tokens is reassigned at once.
        The old request keeps receiving from those programs' snapshots, and
        the new one's programs run after them on the stream. Lock held."""
        steps = self._inflight_steps()
        return [
            i for i, r in enumerate(self._slot_req)
            if r is None or r.emitted + steps.get(i, 0) >= r.max_new_tokens or r.cancelled
        ]

    def _admit(self) -> bool:
        """Give waiting requests free (or virtually free) slots, FIFO. A
        request the pool cannot reserve blocks for stays at the head of
        the queue. Returns whether any request was admitted."""
        with self._lock:
            free = self._free_slots()
            admitted = False
            while self._waiting and free:
                r = self._waiting[0]
                plen = len(r.prompt_tokens)
                if not self.kv.admit_reserve(plen, r.max_new_tokens):
                    break
                self._waiting.popleft()
                slot = free.pop(0)
                old = self._slot_req[slot]
                if old is not None and old.cancelled and old.finish_reason is None:
                    # cancelled after this pass's sweep: it may have no
                    # program in flight left to end its stream (JAX
                    # ``_assign_slot``)
                    self._finish(old, old.cancel_reason)
                self._slot_req[slot] = r
                r.slot = slot
                r.prefill_pos = 0
                r.prefill_done = False
                # releases a virtually free predecessor's blocks (see _finish)
                self.kv.attach(slot, r, plen, r.max_new_tokens)
                r._kv_limit = self.kv.reserve_tokens(plen, r.max_new_tokens)
                self._kv_hi[slot] = 0
                self._prefilling.append(r)
                admitted = True
            return admitted

    def _needed_steps(self) -> int:
        """Decode steps the decoding occupants still need beyond those in
        flight: the dispatch gate. Lock held."""
        steps = self._inflight_steps()
        worst = 0
        for i, r in enumerate(self._slot_req):
            if r is not None and r.prefill_done and not r.cancelled:
                worst = max(worst, r.max_new_tokens - r.emitted - steps.get(i, 0))
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

    def _wave_widths(self) -> list[int]:
        """Every width ``_wave_width`` gives: {1, 2, 4, ..., admit_cap}."""
        return sorted({self._wave_width(n) for n in range(1, self.admit_cap + 1)})

    def _step_name(self, shape: int, nb: int) -> str:
        return f"llm.step_p{shape}_d{self.decode_chunk}.w{nb}"

    def _host_tables(self) -> np.ndarray:
        t = self.kv.take_tables()
        if t is not None:
            self._tables_np = t
        return self._tables_np

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
        with self._work_cv:
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
                # blocks for the appended rows (+ the fused decode chunk
                # when this row activates)
                self._grow(r.slot, r, pos + n + (K if done else 0))
                prefill_tokens += n
                if done:
                    r.prefill_done = True
                    finishes.append((j, r.slot, r))
            fin_slots = {s for _j, s, _r in finishes}
            steps_cov = self._inflight_steps()
            live = np.zeros((self.slots,), bool)
            for i, r in enumerate(self._slot_req):
                if r is None or not r.prefill_done:
                    continue
                if i not in fin_slots:
                    if r.emitted + steps_cov.get(i, 0) >= r.max_new_tokens:
                        continue  # satisfied lane: must not advance past its blocks
                    self._grow(i, r, self._kv_hi[i] + K)
                live[i] = True
            name = self._step_name(shape, nb)
            self._ensure_family(name)
            self._in.write(self._host_tables(), live, meta, pack)
            fetch = _Fetch(self._launch(name))
            # after the rows loop: rows finishing this step decode in it
            snapshot = [r if (r is not None and r.prefill_done) else None for r in self._slot_req]
            self._inflight.append(("step", fetch, finishes, nb, snapshot, K))
            self.steps += 1
            self.step_tokens += prefill_tokens + K * sum(r is not None for r in snapshot)
            self.chunks += 1
            self._work_cv.notify()
            return True

    def _dispatch_chunk(self, needed: int) -> int:
        """One pure decode chunk for the decoding slots: the short chunk
        only when even it covers the whole remaining demand. Returns the
        chunk's length."""
        k = self._chunk_short if needed <= self._chunk_short else self.decode_chunk
        with self._work_cv:
            snapshot = [r if (r is not None and r.prefill_done) else None for r in self._slot_req]
            steps = self._inflight_steps()
            live = np.zeros((self.slots,), bool)
            for i, r in enumerate(snapshot):
                if r is None or r.emitted + steps.get(i, 0) >= r.max_new_tokens:
                    continue  # satisfied lane: must not advance past its blocks
                live[i] = True
                self._grow(i, r, self._kv_hi[i] + k)
            name = f"llm.decode_chunk{k}"
            self._ensure_family(name)
            self._in.write(self._host_tables(), live)
            fetch = _Fetch(self._launch(name))
            self._inflight.append(("chunk", fetch, snapshot, k))
            self.chunks += 1
            self._work_cv.notify()
            return k

    def _emit_to(self, r: GenRequest, slot: int, toks: list[int], now: float) -> None:
        """Append a request's next tokens, honoring max_new/eos/cancel and
        the -1 non-finite sentinel. Tokens after a finish are dropped.
        Lock held."""
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

    # -- collector --------------------------------------------------------
    def _collect_loop(self) -> None:
        try:
            while True:
                with self._work_cv:
                    while not self._inflight and not self._stop:
                        self._work_cv.wait(timeout=0.1)
                    if not self._inflight:
                        if self._stop:
                            return
                        continue
                    # TTFT: a step whose decode part serves only its own
                    # finishing rows may jump older entries (it carries
                    # fresh requests' first tokens), once per processed
                    # chunk so fresh arrivals cannot starve decode
                    idx = 0
                    if not self._jumped:
                        idx = next((i for i, e in enumerate(self._inflight) if self._jump_safe(e)), 0)
                    if idx:
                        entry = self._inflight[idx]
                        del self._inflight[idx]
                        self._jumped = True
                    else:
                        entry = self._inflight.popleft()
                        self._jumped = False  # every entry carries a decode part
                    self._processing = entry
                self._process_entry(entry)
                self._kick.set()
        except Exception as e:  # noqa: BLE001 — a dead engine must end every stream
            self._fail(e)
            raise

    @staticmethod
    def _jump_safe(entry: tuple) -> bool:
        """May the collector serve this entry ahead of older ones? Only a
        step with finishing rows whose decode part serves no one else: an
        active request's earlier tokens may sit in the entries it would
        pass, and a finishing row is in no older entry."""
        if entry[0] != "step" or not entry[2]:
            return False
        fin = {r for _j, _s, r in entry[2]}
        return all(r is None or r in fin for r in entry[4])

    @staticmethod
    def _entry_requests(entry: tuple) -> list[GenRequest]:
        snapshot = entry[4] if entry[0] == "step" else entry[2]
        out = [r for r in snapshot if r is not None]
        if entry[0] == "step":
            out += [r for _j, _s, r in entry[2]]
        return out

    def _process_entry(self, entry: tuple) -> None:
        """Wait for one program's tokens (outside the lock: the card runs
        the next program meanwhile) and emit them; the entry leaves
        ``_processing`` in the same lock acquisition as the emits."""
        toks = entry[1].wait()
        now = time.perf_counter()
        with self._lock:
            if entry[0] == "step":
                _, _fetch, finishes, nb, snapshot, k = entry
                for j, slot, r in finishes:
                    self._emit_to(r, slot, [int(toks[j])], now)
                toks = toks[nb:]
            else:
                _, _fetch, snapshot, k = entry
            cols = toks.reshape(k, self.slots)
            for slot, r in enumerate(snapshot):
                if r is not None:
                    self._emit_to(r, slot, cols[:, slot].tolist(), now)
            self._processing = None

    # -- device programs ------------------------------------------------------
    def _launch(self, name: str) -> torch.Tensor:
        """Run program family ``name`` on the staged inputs: eagerly on the
        CPU, as one replay of its captured graph on CUDA. Returns its
        output (a replay's is the graph's static buffer)."""
        if self.device.type == "cpu":
            return self._programs[name][0]()
        fam = self.families[name]
        fam.graph.replay()
        add_launches(fam.launches)
        return fam.out

    def _ensure_family(self, name: str) -> None:
        """Capture family ``name`` unless it is (CUDA only)."""
        if self.device.type == "cuda" and name not in self.families:
            self._capture(name)

    def _warm(self) -> None:
        """Capture every program family (JAX ``_warm``), recording the
        seconds it took and the memory the graphs reserved."""
        t0 = time.perf_counter()
        torch.cuda.empty_cache()  # as each capture does: "before" holds no cached blocks either
        before = torch.cuda.memory_reserved(self.device)
        for name in self._programs:
            self._capture(name)
        torch.cuda.synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0
        self.warmup_reserved = (before, torch.cuda.memory_reserved(self.device))

    def _capture(self, name: str) -> None:
        """Capture one program family as a CUDA graph on the engine's
        stream, into the shared graph pool. As in the JAX warm chain the
        inputs are inert — zero live mask, padding lanes at ``slots``, an
        empty pack — so the warm-up runs PyTorch needs before a capture
        write nothing but the tail, which is restored. A capture failure
        raises: nothing falls back to eager ops."""
        fn, step = self._programs[name]
        with torch.no_grad(), torch.cuda.stream(self._stream):
            live = np.zeros((self.slots,), bool)
            if step is None:
                self._in.write(self._tables_np, live)
            else:
                shape, nb = step
                meta = np.zeros((2, nb), np.int32)
                meta[0, :] = self.slots
                self._in.write(self._tables_np, live, meta, np.zeros((nb, shape + 3), np.int32))
            tail = self._tail.clone()
            for _ in range(_WARM_RUNS):
                fn()
            self._tail.copy_(tail)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self._gen)  # each replay draws fresh uniforms
            with capture_launches() as tally, torch.cuda.graph(
                graph, pool=self._graph_pool, stream=self._stream, capture_error_mode="thread_local"
            ):
                out = fn()
        self.families[name] = _Family(graph, out, dict(tally))

    def _step_program(self, shape: int, nb: int) -> torch.Tensor:
        """The unified step (JAX ``llm.step_p{shape}_d{K}``) of ``nb`` rows
        on the staged inputs. Updates the pool (and its int8 scales),
        lengths, tail, active and temps IN PLACE; returns first tokens [nb]
        then decode tokens [K, slots], flat. An int8 pool's packed slot
        views are dequantized in the model dtype; the chunk rows are
        quantized again at the scatter back."""
        dev, cfg, slots, sc = self.device, self.cfg, self.slots, self.pool_scales
        cap = self.kv.capacity
        pack_t, meta_t = self._in.pack(shape, nb), self._in.meta(nb)
        tables = self._in.tables()
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
            self.params, cfg, self._tail, self.pool, tables, self._active & self._in.live(),
            self._temps, self._gen, n_steps=self.decode_chunk, sample_fn=self._sample,
            block=self.kv.block, scales=sc,
        )
        self._tail.copy_(last)  # the next program reads it at the same address
        return torch.cat([first, toks.reshape(-1)])

    def _chunk_program(self, k: int) -> torch.Tensor:
        """The pure decode chunk (JAX ``llm.decode_chunk{K}``) on the
        staged inputs: returns tokens [k, slots], flat; the pool, lengths
        and tail advance in place."""
        toks, last, _ = decode_chunk_paged(
            self.params, self.cfg, self._tail, self.pool, self._in.tables(),
            self._active & self._in.live(), self._temps, self._gen, n_steps=k,
            sample_fn=self._sample, block=self.kv.block, scales=self.pool_scales,
        )
        self._tail.copy_(last)
        return toks.reshape(-1)
