"""LLM serving engine (counterpart of gofr_tpu/llm.py, main path only).

``LLMEngine`` serves ``GenRequest``s from a scheduler thread and a
collector thread over the KV layout ``kvcache.CacheManager`` resolves, in
the JAX engine's default configuration:

- the KV layout (``kv_paged``; ``None`` reads ``TPU_LLM_KV_PAGED``,
  "auto" unless "0", as ``paged_default``): the paged pool for a
  global-attention model, the ROLLING ring [L, slots, window + slack,
  hkv, hd] for a windowed model whose window + slack < max_seq_len (no
  session tier asked for), and with ``kv_paged=False`` the contiguous
  layouts: that ring, or the dense slab [L, slots, max_seq_len, hkv, hd]
  (``kv_window=0`` forces the slab on a windowed model). A contiguous
  engine runs the same program families under the same names on
  ``self.cache``: its step gathers the packed rows' slots, appends
  through ``prefill_append(ring=)`` (flash on the slab, plain ring masks
  on the ring) and writes the appended rows back; its decode is
  ``decode_chunk`` (plain attention, as the JAX einsum) with the device
  ``active`` flags and no paged ``live`` mask; its verify runs on the
  cache in place. It has no blocks, tables, radix, sessions or int8 KV;
  its prefix reuse is the whole-row ``PrefixCache`` (below);

- the scheduler (``step_token_budget``; ``None`` reads
  ``TPU_LLM_STEP_TOKEN_BUDGET``, default 256): any budget above 0 is
  chunked prefill: prompts advance through unified device steps of
  chunks (the prefill buckets capped at ``prefill_chunk``; ``None`` reads
  ``TPU_LLM_PREFILL_CHUNK``, default 64: {16, 64}) under that many
  tokens a step, the active slots' decode chunk charged first, prefill rows
  packed up to ``admit_cap`` with a FIFO head-of-line rule
  (``_dispatch_step``). 0, the monolithic WAVE (JAX ``_admit_wave``):
  whole prompts, grouped by prefill bucket (a prompt past the last one
  takes max_seq_len), up to ``admit_cap`` a wave at power-of-two widths,
  prefilled by one ``llm.prefill_b{bucket}.w{nb}`` program each
  (``_prefill_program``: ``models.transformer.prefill``, whose attention
  is flash in its full-prompt mode, the ring's ``ring_pack``, the insert
  into the slots, the first tokens), with the fill hold of
  ``admit_delay_ms`` while arrivals are fast; decode chunks run by
  demand, speculative verifies ride as on the chunked scheduler, and
  grammars and adapters are refused (``constrained`` and ``lora_slots``
  are forced off, as in JAX);
- the unified step program (JAX ``llm.step_p{S}_d{K}``): gather the
  packed rows' slot views through the block tables, run
  ``prefill_append``, scatter the chunk rows back into the pool, sample
  first tokens for rows whose prompt completed, activate them, then run
  one fused ``decode_chunk_paged`` for every live slot;
- the pure decode chunk program (JAX ``llm.decode_chunk{K}``) when no
  prompt is pending, K = ``decode_chunk`` (default 8; or K // 4 for tail
  ends);
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
  int8 paged-decode kernel. Either works alone;
- the whole-row prefix cache of the contiguous layouts: ``prefix_cache_mb``
  > 0 keeps each finished base prompt's slot rows (trimmed to the rows it
  wrote, the whole ring when rolling) and last-token logits in a
  ``kvcache.PrefixCache``. The chunked admission takes an exact hit
  (the hit program over the stored logits, the rows copied into the
  slot: ``_insert_rows``) or, on the slab, the longest stored prefix as a
  partial hit whose cursor starts at its length; the wave takes exact
  hits. Unified steps then return their rows' logits, and each prompt is
  stored right after the step (or wave) that finishes it;
- prefix reuse, off by default as in the JAX engine: ``prefix_cache_mb``
  > 0 (or ``session_mb`` > 0) turns on the radix tree over the paged pool
  (``kvcache``). Admission (``_admit``) consults it for every request it
  pulls: an exact hit (a published prompt with stored last-token logits)
  skips prefill — its first token is sampled from the stored logits
  (``llm.hit_first.w{nb}``, fused with the JAX ``llm.admit_update``) and
  ``llm.kv_seed`` copies its sub-block tail into a private block and sets
  its length; a block-partial hit points its table at the shared full
  blocks and starts ``prefill_pos`` there; a miss starts at 0. Every
  unified step then returns its rows' last-token logits too, and each
  prompt is published right after the step that finishes it;
- sessions: ``session_mb`` > 0 keeps an ``X-GoFr-Session`` conversation
  (prompt + emitted tokens) published and pinned between turns, spills
  the coldest to host memory (``host_cache_mb``) past the device budget,
  and restores a spilled one before its next turn's radix consult
  (``_session_prepare``; the restore's host-to-device copy is eager, on
  the engine stream). A finished turn keeps its blocks until the next
  scheduler pass has published it (``_kv_session_flush``, ``_kv_sweep``);
- speculative decoding, off by default as in the JAX engine:
  ``speculative=True`` (or ``TPU_LLM_SPEC=1``) drafts up to
  ``spec_draft`` tokens per decoding slot with the host n-gram drafter
  (``spec``) over the request's optimistic stream, and one all-slot
  verify program (JAX ``llm.step_v{W}``, W = spec_draft + 1, a captured
  graph like the others) appends tail + draft through ``verify_chunk``,
  samples every position, accepts the longest agreeing prefix on the
  device and rolls each slot's length back past rejected rows. Verifies
  pipeline to the lookahead depth; each counts one guaranteed token per
  lane in ``_inflight_steps``. A clean-pipe attempt whose lanes drafted
  nothing buys 16 plain chunks; chunks and verifies never interleave
  (``_spec_regime``). Greedy spec-on streams equal spec-off's;
- grammar-constrained decoding, on by default as in the JAX engine
  (``constrained=None`` reads ``TPU_LLM_CONSTRAINED``, default "1") and
  engaged per request: a ``GenRequest.grammar`` (a ``structured``
  ``TokenGrammar``) masks every sampled token to what its DFA state
  admits. The resident grammars live in one padded device table
  [G, Smax, vocab] (``_register_grammar``, ``_g_sync``) and each slot's
  DFA state in a device vector chained like the tail (``_gstate``). While
  any resident request is constrained, every dispatch runs the
  constrained twin of its program (``llm.step_p{S}_d{K}g.w{nb}``,
  ``llm.decode_chunk{K}g``, ``llm.step_v{W}g``; per-slot grammar ids in
  the staged inputs, -1 for an unconstrained lane, whose logits are left
  untouched). Those families are captured at the first constrained
  request, never at warmup, and again when the table's padding grows
  (``_g_prepare``). A constrained request is always a full prefill (no
  radix lookup); its speculative drafts are filtered and extended through
  the grammar (``_spec_drafts``);
- overload control, on by default as in the JAX engine
  (``resilience``): the waiting queue is ordered by (priority class,
  the client's weighted served-token counter in a ``FairLedger``, arrival
  order at the scheduler: the drain order, where JAX uses the request id)
  each pass (``_order_waiting``; ``fair_queuing=False`` keeps class
  then FIFO); an interactive request that finds no free slot takes one
  back from a batch-class occupant (``_preempt_for_waiting``,
  ``_preempt``: the victim is scrubbed from every program in flight, its
  emitted tokens fold into its prompt and it re-queues as a continuation
  that re-prefills through the unified step and resumes its stream);
  ``max_queue`` and a predicted-wait threshold refuse a submit with
  ``EngineOverloaded`` and a Retry-After, ``ttft_deadline_ms`` sheds a
  request still waiting past it (finish reason "shed"), and brownout
  clamps batch-class ``max_new_tokens`` under sustained pressure
  (``OverloadController``). The wait is priced as outstanding tokens
  (``load_tokens``) over the measured throughput (``_observe_tput``);
- multi-tenant LoRA, off by default as in the JAX engine: ``lora_slots``
  > 0 (or ``TPU_LLM_LORA_SLOTS``) adds stacked float32 adapter tables
  for that many adapters of rank up to ``lora_rank``
  (``TPU_LLM_LORA_RANK_MAX``, default 8) to every layer's params
  (``lora``), allocated once on the device. ``load_adapter`` writes an
  adapter's rows into a free gid in place, on the engine stream, so a
  hot-load captures nothing; ``publish_adapter`` repoints a name at a
  staged gid while requests in flight finish on the old one, and
  ``evict_adapter`` unbinds a name (``AdapterPool``: LRU eviction of idle
  adapters, refcounts, zombies). A request names its adapter
  (``GenRequest.adapter``); submit pins the gid (``_aid``) and retirement
  releases it. Each dispatch stages the slots' adapter ids beside the
  other inputs (``_Inputs``), and every program family adds each row's
  delta (``models.transformer._lora_mm``; gid 0 adds exact zeros, so base
  lanes are token-identical to an engine without adapters). Adapted
  requests never take a prefix hit and never publish to the radix tree.

The pack/meta layouts of the JAX programs are kept: pack [nb, S+3] int32
= tokens | cursor | n_new | temperature bits; meta [2, nb] int32 = slot
(``slots`` for inert padding lanes) | finish flag, and [4, nb] in a
constrained step: + grammar id (-1: none) | start DFA state.

Mixture-of-experts configs (``n_experts`` > 0) serve through the same
programs: every one routes its whole row count, idle slots and padding
lanes included, through ``models.moe.moe_mlp``, which has no host
synchronisation and is captured with the rest (``stats()["moe_experts"]``).

Recovery, as in the JAX engine (``resilience``): a scheduler pass that
raises is recovered in place (``_recover_all``: every slotted and
in-flight request ends "cancelled", the device state resets, the engine
serves on); a fetch that raises loses its program's tokens
(``_close_unreachable``). ``_FETCH_FAIL_LIMIT`` failures in a row on
either thread (a sticky CUDA error fails every one) end in ``_die``, the
terminal path: the engine stops (``alive()`` false, ``submit`` raises
``EngineStoppedError``), hands every recoverable request to
``failover_hook`` when a ``ReplicatedLLMEngine`` set one, and ends every
other stream "cancelled". The numerical watchdog (``numeric_check``, on
unless ``TPU_LLM_NUMERIC_CHECK=0``) dies on a fetched -1 sentinel; the
step watchdog (``step_watchdog_s`` / ``TPU_LLM_STEP_WATCHDOG_S`` > 0) dies
on a dispatch or fetch in flight past its threshold. ``drain()`` closes
admission (``EngineDraining``) while the work in flight finishes. The
fault seams of ``resilience.faults`` sit where the JAX engine's do.
``ReplicatedLLMEngine`` serves N replicas behind a router with in-flight
failover, poison quarantine, the device-health ledger, the supervisor
and the canary gate (several replicas may share one device).

Chip-time accounting and the incident flight recorder, on by default as
in the JAX engine (JAX llm.py:977-1064): the ``goodput.GoodputLedger``
attributes every fetched program's dispatch->fetch window to its lanes
by waste class (``_gp_observe``, from ``_process_entry`` and
``_process_verify_entry``) into ``GenRequest._chip``, a per-tenant
``UsageMeter`` and the ``app_llm_goodput_*`` series; the ``QuotaGate``
refuses a tenant past its token-rate quota at submit
(``EngineOverloaded`` with the priced Retry-After; probes pass). The
``flightrec.FlightRecorder`` records every request at submit and
finalizes it in ``_finish`` with its timings and chip time; ``replay``
re-executes a record. ``_incident`` dumps a bundle (``BlackboxDumper``,
armed by ``GOFR_BLACKBOX_DIR``): ``_die``'s first step, a flagged
``AnomalyDetector`` signal, a fleet's quarantine and a rollback. The
bundle has no ``traces`` and no ``compiles`` section: the port has no
tracer and no compile registry until ROADMAP ID 10, which also holds the
engine's other ``app_llm_*`` series.

The shape knobs (JAX llm.py:637-644, :675-676) are the JAX engine's:
``decode_chunk`` (K: the fused steps of a chunk, the step's decode part,
the short chunk K // 4, the draft cap 2 K and the decode room of 2 K
rows), ``prefill_chunk``, ``step_token_budget`` and ``kv_block`` (the
pool's rows a block; ``None`` reads ``TPU_LLM_KV_BLOCK``, default 16,
in ``kvcache.CacheManager``). ``DECODE_CHUNK``, ``PREFILL_CHUNK``,
``STEP_TOKEN_BUDGET`` and ``KV_BLOCK`` are their defaults only.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import queue
import re
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np
import torch

from . import resolve_device
from .flightrec import WIDE_EVENTS_KEEP, AnomalyDetector, BlackboxDumper, FlightRecorder, classify_die_reason
from .goodput import (
    GoodputLedger,
    QuotaGate,
    UsageMeter,
    goodput_knobs,
    parse_quota_spec,
    pool_goodput,
    prefill_classes,
    register_goodput_metrics,
)
from .kvcache import CacheManager, copy_blocks, gather_blocks_host, gather_slots, paged_default, scatter_rows
from .lora import AdapterPool, target_dims, validate_adapter, zero_tables
from .models.quant import QTensor, is_quantized, quantize_params
from .models.transformer import (
    KVCache,
    _write_chunk_rows,
    decode_chunk,
    decode_chunk_paged,
    prefill,
    prefill_append,
    verify_chunk,
)
from .ops.attention import add_launches, capture_launches
from .resilience import (
    DeviceHealthLedger,
    FairLedger,
    FaultInjector,
    Heartbeat,
    InjectedFault,
    OverloadController,
    ReplicaSupervisor,
    RetryBudget,
    StepWatchdog,
    canary_check,
    default_injector,
    device_key,
    spec_device_key,
)
from .resilience.faults import sleep_for
from .resilience.health import CANARY_MAX_NEW, CANARY_PROMPT
from .spec import SPEC_DRAFT_DEFAULT, SPEC_EMA_ALPHA, NGramDrafter, draft_len

_EOS_DEFAULT = -1  # no EOS cut by default (random-weight models)

# The JAX engine's serving defaults (llm.py:629-762, kvcache/__init__.py:411)
DECODE_CHUNK = 8  # fused decode steps per chunk
PREFILL_CHUNK = 64  # widest prefill chunk shape
STEP_TOKEN_BUDGET = 256  # tokens one unified step may carry
ADMIT_CAP = 8  # prefill rows per unified step (or per wave)
KV_BLOCK = 16  # tokens per KV pool block
ADMIT_DELAY_MS = 40.0  # the wave's fill hold


class EngineStoppedError(RuntimeError):
    """submit() on a closed engine."""


class EngineOverloaded(RuntimeError):
    """submit() found no capacity for the request (JAX
    ``EngineOverloaded``): the waiting queue is at ``max_queue``, the
    predicted queue wait is past the shed threshold, or every
    resident-grammar slot holds live requests. The edge answers 429 with
    ``retry_after`` seconds in a Retry-After header."""

    status_code = 429
    retry_after: float | None = None

    def __init__(self, message: str = "", retry_after: float | None = None):
        super().__init__(message)
        if retry_after is not None:
            self.retry_after = max(0.1, float(retry_after))


class EngineDraining(RuntimeError):
    """submit() while the engine drains (JAX ``EngineDraining``): admission
    is closed, the work in flight runs to completion. 503 with a
    Retry-After; retryable inside a fleet (another replica may accept)."""

    status_code = 503
    retry_after: float | None = 5.0


class PoisonedRequestError(RuntimeError):
    """Raised by GenRequest.stream()/tokens() when the fleet refused the
    request further failover (JAX ``PoisonedRequestError``): it was in
    flight across ``poison_deaths`` replica deaths, so its payload is the
    prime suspect. 500; the caller must not retry it."""

    status_code = 500


class UnknownAdapterError(KeyError):
    """Raised by submit() when ``req.adapter`` names no resident adapter
    (JAX ``UnknownAdapterError``): 404 at the edge. A KeyError subclass so
    registry-shaped callers that probe with ``except KeyError`` keep
    working."""

    status_code = 404

    def __init__(self, name: str, resident=()):
        super().__init__(name)
        self.adapter = name
        self.resident = sorted(resident)

    def __str__(self) -> str:
        return f"unknown adapter {self.adapter!r}; resident: {self.resident or 'none'}"


class RequestFailed(RuntimeError):
    """Raised by GenRequest.stream()/tokens() when a request ends "error":
    the fleet could not place its failover continuation (no live replica,
    or its retries spent)."""


def finite_guard(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """Numerical-watchdog sentinel: replace each sampled token whose
    logits row holds NaN/Inf with -1, an id no sampler produces; with
    ``numeric_check`` on the collector turns it into the engine's death
    instead of streaming garbage."""
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


# Grammar-constrained sampling (JAX ``_g_rows``/``_g_mask``/``_g_sample``).
# gtab [G, Smax, V] int32 is the resident-grammar transition table (entry
# < 0: token not admitted in that state); gid [B] selects each lane's
# grammar (-1: unconstrained) and gstate [B] its DFA state. The mask is a
# large negative, not -inf (an all-masked padding row stays NaN-free), and
# the watchdog runs on the RAW logits (a grammar mask is not a numerical
# fault). Unconstrained lanes keep their logits untouched (a select, not a
# +0 bias): that is what keeps them token-identical to the plain programs.
_G_NEG = -1e30


def _g_rows(gtab: torch.Tensor, gid: torch.Tensor, gstate: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """([B, V] next state per token, or < 0; [B] lanes the grammar
    constrains)."""
    G, Smax = gtab.shape[0], gtab.shape[1]
    rows = gtab[gid.clamp(0, G - 1).long(), gstate.clamp(0, Smax - 1).long()]
    on = (gid >= 0) & (gstate >= 0) & (gstate < Smax)
    return rows, on


def _g_mask(logits: torch.Tensor, rows: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    return torch.where(on[:, None] & (rows < 0), _G_NEG, logits)


def _g_sample(logits, temps, generator, gtab, gid, gstate) -> tuple[torch.Tensor, torch.Tensor]:
    """One masked sample and DFA advance per lane: the stateful sampler
    the constrained programs thread through decode chunks
    (``decode_chunk_paged(sample_state=...)``). The mask comes before
    ``_sample_raw``'s top-64, so a constrained draw is always admitted."""
    rows, on = _g_rows(gtab, gid, gstate)
    out = finite_guard(logits, _sample_raw(_g_mask(logits, rows, on), temps, generator))
    nxt = rows.gather(1, out.clamp(min=0).long()[:, None])[:, 0]
    return out, torch.where(on, nxt, gstate)


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


def _put_appended(stack: torch.Tensor, sub: torch.Tensor, slot_idx, cursors, n_new, c: int, ring: int) -> None:
    """Write back the rows a unified step appended into its gathered slot
    views ``sub`` [L, nb, C, h, d]: packed row j's rows i < n_new[j] (of
    the step's ``c``) into slot slot_idx[j] of the contiguous ``stack`` [L,
    S, C, h, d], IN PLACE, through ``_write_chunk_rows`` (at cursors + i,
    mod ``ring`` on a ring). The JAX step writes the gathered rows back
    whole; they differ from the slab only in these rows, so writing just
    these computes the same slab, at c rows a slot instead of C. A slot in
    no packed row appends nothing, and an inert padding lane (slot_idx =
    S) matches no slot."""
    L, S, C = stack.shape[:3]
    hit = slot_idx.long()[:, None] == torch.arange(S, device=stack.device)[None, :]  # [nb, S]
    lane = hit.int().argmax(dim=0)  # each slot's packed row (any, where none)
    pos = cursors.long()[lane][:, None] + torch.arange(c, device=stack.device)[None, :]
    rows = _rows_at(sub[:, lane], torch.remainder(pos, C))  # [L, S, c, h, d]
    n = torch.where(hit.any(dim=0), n_new[lane], 0)
    for i in range(L):
        _write_chunk_rows(stack[i], rows[i], cursors[lane], n, ring)


def _insert_slots(stack: torch.Tensor, rows: torch.Tensor, slot_idx: torch.Tensor) -> None:
    """stack[:, slot_idx[j], :W] = rows[:, j] IN PLACE for the contiguous
    ``stack`` [L, S, C, h, d] and a wave's rows [L, nb, W, h, d], W <= C
    (JAX ``llm.insert_many``): one ``index_copy_`` with no host sync and
    no read of the stack. Every lane must name a slot (a wave's pad lanes
    repeat lane 0, with equal rows); an out-of-range slot is clamped to
    S - 1 only so that no index faults."""
    L, S, C, h, d = stack.shape
    nb, W = rows.shape[1], rows.shape[2]
    flat = (slot_idx.long().clamp(0, S - 1)[:, None] * C + torch.arange(W, device=stack.device)[None, :]).reshape(-1)
    stack.view(L, S * C, h, d).index_copy_(1, flat, rows.reshape(L, nb * W, h, d).to(stack.dtype))


@dataclass(eq=False)  # identity semantics: requests are handles
class GenRequest:
    prompt_tokens: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_token: int = _EOS_DEFAULT
    # Identity from the serving edge (``handler.llm_request_kwargs``): the
    # X-GoFr-Priority class ("batch" or "interactive", normalized by
    # submit(): batch requests wait behind interactive ones, may be
    # preempted for them and are clamped under brownout), the
    # fair-queuing client id (the ledger bills its served tokens) and the
    # X-GoFr-Session conversation id (the session tier, ``session_mb``).
    priority: str = "interactive"
    client: str = ""
    session_id: str = ""
    # Absolute wall deadline (time.perf_counter timebase). Past it the
    # engine retires the request even while it holds a slot
    # (finish_reason "deadline"). Handlers pass ctx.deadline here.
    deadline: float | None = None
    # Multi-tenant LoRA adapter name: the resident adapter whose delta this
    # request decodes under ("" = the base model). The edge maps
    # model=<adapter> and X-GoFr-Adapter here; an engine without an
    # adapter pool (lora_slots=0) refuses a non-empty name.
    adapter: str = ""
    # Grammar-constrained decoding (``structured``): a compiled
    # TokenGrammar. Every sampled token is masked to what the grammar's
    # current DFA state admits, so the output is valid by construction;
    # the per-slot state advances inside the device programs. eos_token
    # is taken from the grammar when unset. None = unconstrained.
    grammar: Any = None
    # Poison-payload marker of the fault injector: a tagged ``device_step``
    # spec kills the replica serving a request with the same tag.
    tag: str = ""
    # Synthetic-traffic marker: canary checks, shadow probes and replays
    # set it. The goodput ledger bills its chip time as probe waste and
    # the quota gate waves it through.
    probe: bool = False
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
        self._rows_hi = 0  # highest slot row its prefill wrote (the prefix store's trim)
        # "eos" | "length" | "cancelled" | "disconnect" | "deadline" |
        # "shed" | "error" | "poison" ("failover" marks, for a moment, a
        # request rescued off a dying replica, so its drain skips it)
        self.finish_reason: str | None = None
        self.error: str | None = None
        self.submitted_at: float | None = None  # a continuation restamps it
        self.admitted_at: float | None = None  # slot assigned (last admission)
        self.first_token_at: float | None = None
        # failover (engine- and fleet-maintained): the version label of the
        # engine that last accepted the request (a continuation that has
        # emitted tokens stays on it); the re-dispatches consumed; the
        # replica deaths it was in flight for (slotted, prefilling or in a
        # program: queued bystanders are not implicated), which the fleet's
        # poison quarantine counts; prompt positions below _replay_pos were
        # computed once already (a continuation's re-prefill)
        self.engine_version: str | None = None
        self.retries = 0
        self.deaths = 0
        self._replay_pos = 0
        # overload control (engine-maintained): brownout clamped
        # max_new_tokens; times a batch slot was taken back; the tokens
        # of outstanding work this request adds to load_tokens(); whether
        # its prompt was billed to the ledger (once a lifetime)
        self.browned = False
        self.preempted = 0
        self._load_acct = 0
        self._prompt_billed = False
        self._seq = 0  # arrival order at the scheduler (a continuation keeps its own)
        # chunked-prefill scheduler state (engine-maintained)
        self.prefill_pos = 0  # prompt tokens already appended to slot KV
        self.prefill_done = False  # all prompt tokens resident; decoding
        self.slot: int | None = None  # slot index while resident
        self._kv_limit = 0  # worst-case rows (CacheManager.reserve_tokens)
        self.history: list[int] = []  # emitted tokens (a session turn's publish)
        self.prefix_hit = False  # admitted through a radix hit (exact or partial)
        self._kv_resv = 0  # admission block promise not yet bound to a slot
        self._kv_plan = None  # pinned seed plan not yet attached to a slot
        self._prefix_entry = None  # pinned whole-row PrefixCache entry (contiguous layouts)
        self._session_published = False  # end-of-turn radix publish done
        # speculative decoding (engine-maintained): the acceptance EMA that
        # sizes the draft (optimistic until the first verify measures it),
        # the plain-lane streak that paces a backed-off request's probe,
        # the predicted spans of verifies in flight (the optimistic stream
        # the next draft extends) and the count of those verifies
        self._spec_ema = 1.0
        self._spec_plain = 0
        self._spec_pending: list[int] = []
        self._spec_inflight = 0
        # grammar-constrained decoding (engine-maintained): the resident
        # grammar table slot (-1 while unconstrained) and the HOST mirror
        # of the DFA state after every emitted token (the drafter's
        # filter; the start state of the request's first-token mask)
        self._g_id = -1
        self._g_state = 0
        # multi-tenant LoRA (engine-maintained): the adapter pool gid this
        # request decodes under and holds a reference to (taken at submit,
        # kept through a preemption's continuation, dropped at retirement,
        # which sets it back to 0, the base)
        self._aid = 0
        # goodput attribution (engine-maintained; JAX llm.py:545-552):
        # chip-seconds billed to this request by waste class, rolled into
        # the flight record, the wide event and the OpenAI usage block
        self._chip: dict[str, float] = {}

    @property
    def hop(self) -> int:
        """Re-admissions after the first (preemption continuations and
        failover re-dispatches): the JAX request's ``hop``."""
        return self.preempted + self.retries

    def _raise_terminal(self) -> None:
        if self.finish_reason == "poison":
            raise PoisonedRequestError(
                f"request {self.id} implicated in {self.deaths} replica deaths; failover refused "
                "(do not retry this payload)"
            )
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
        RequestFailed for a request that ended "error" and
        PoisonedRequestError for one refused as poison."""
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
    [slots] | gids [slots] (each slot's grammar id, -1 unconstrained; read
    by the constrained families only) | aids [slots] (each slot's LoRA
    adapter gid, 0 the base; a LoRA engine's only) | verify pack [slots, ver_width]
    (draft tokens | n_draft | selected, of ``llm.step_v{W}``; empty with
    speculation off) | meta [4, admit_cap] | pack [admit_cap, S_max + 3]
    (a step of nb rows and shape S uses the first 2 nb, or 4 nb for a
    constrained step, and nb (S + 3) elements of the last two) | seed [7,
    admit_cap] (srcs | dsts | slot_idx | lens of ``llm.kv_seed``, then the
    hit programs' meta: slot | row | temperature bits). ``write`` and
    ``write_seed`` fill it from a ring of ``depth`` pinned host buffers
    with one async copy of their own region; each buffer is rewritten only
    after the event recorded behind its last copy, so a later dispatch
    never overwrites pinned memory a queued copy has not read yet."""

    def __init__(
        self, device, slots: int, table_width: int, admit_cap: int, max_shape: int, depth: int, ver_width: int = 0,
        lora: bool = False,
    ):
        self.slots, self.table_width, self.admit_cap = slots, table_width, admit_cap
        self.ver_width = ver_width
        self.o_live = slots * table_width
        self.o_gids = self.o_live + slots
        self.o_aids = self.o_gids + slots
        self.o_ver = self.o_aids + (slots if lora else 0)
        self.o_meta = self.o_ver + slots * ver_width
        self.o_pack = self.o_meta + 4 * admit_cap
        self.o_seed = self.o_pack + admit_cap * (max_shape + 3)
        size = self.o_seed + 7 * admit_cap
        self.dev = torch.zeros(size, dtype=torch.int32, device=device)
        cuda = device.type == "cuda"
        self.host = [torch.zeros(size, dtype=torch.int32, pin_memory=cuda) for _ in range(depth if cuda else 1)]
        self.events = [torch.cuda.Event() if cuda else None for _ in self.host]
        self._next = 0

    def tables(self) -> torch.Tensor:
        return self.dev[: self.o_live].view(self.slots, self.table_width)

    def live(self) -> torch.Tensor:
        return self.dev[self.o_live : self.o_gids] != 0

    def gids(self) -> torch.Tensor:
        return self.dev[self.o_gids : self.o_aids]

    def aids(self) -> torch.Tensor:
        return self.dev[self.o_aids : self.o_ver]

    def verify(self) -> torch.Tensor:
        """[slots, ver_width]: draft tokens | n_draft | selected."""
        return self.dev[self.o_ver : self.o_meta].view(self.slots, self.ver_width)

    def meta(self, nb: int, rows: int = 2) -> torch.Tensor:
        return self.dev[self.o_meta : self.o_meta + rows * nb].view(rows, nb)

    def pack(self, shape: int, nb: int) -> torch.Tensor:
        return self.dev[self.o_pack : self.o_pack + nb * (shape + 3)].view(nb, shape + 3)

    def seed(self) -> torch.Tensor:
        """[7, admit_cap]: srcs | dsts | slot_idx | lens | hit meta [3]."""
        return self.dev[self.o_seed :].view(7, self.admit_cap)

    def _buffer(self) -> tuple[int, np.ndarray]:
        j = self._next
        self._next = (j + 1) % len(self.host)
        if self.events[j] is not None:
            self.events[j].synchronize()  # the copy that last read this buffer has run
        return j, self.host[j].numpy()

    def _copy(self, j: int, lo: int, hi: int) -> None:
        self.dev[lo:hi].copy_(self.host[j][lo:hi], non_blocking=True)
        if self.events[j] is not None:
            self.events[j].record()

    def write_seed(self, seed: np.ndarray) -> None:
        """Stage the [7, admit_cap] inputs of ``llm.kv_seed`` and the hit
        programs and enqueue their copy on the current stream."""
        j, h = self._buffer()
        h[self.o_seed :] = seed.reshape(-1)
        self._copy(j, self.o_seed, h.size)

    def write(
        self, tables: np.ndarray, live: np.ndarray, meta=None, pack=None, verify=None, gids=None, aids=None
    ) -> None:
        """Stage one dispatch's inputs (meta and pack for a unified step,
        the verify pack for a verify, the grammar ids for a constrained
        program, the slots' adapter ids on a LoRA engine) and enqueue their
        copy on the current stream."""
        j, h = self._buffer()
        h[: self.o_live] = tables.reshape(-1)
        h[self.o_live : self.o_gids] = live
        if gids is not None:
            h[self.o_gids : self.o_aids] = gids
        if aids is not None:
            h[self.o_aids : self.o_ver] = aids
        end = self.o_ver
        if verify is not None:
            h[self.o_ver : self.o_meta] = verify.reshape(-1)
            end = self.o_meta
        if meta is not None:
            h[self.o_meta : self.o_meta + meta.size] = meta.reshape(-1)
            end = self.o_pack + pack.size
            h[self.o_pack : end] = pack.reshape(-1)
        self._copy(j, 0, end)


class _Fetch:
    """A program's tokens on their way to the host: a pinned copy behind
    an event on CUDA (enqueued right after the replay, before the next
    replay overwrites the graph's output), the tensor itself on the CPU.
    ``t0`` is the dispatch time and ``work`` the tokens the program serves
    (prefill rows + decode tokens; a verify's are counted at its fetch),
    which price the throughput EMA (``LLMEngine._observe_tput``); ``t0``
    to the fetch is the window the goodput ledger attributes."""

    __slots__ = ("host", "event", "t0", "work", "gp")

    def __init__(self, out: torch.Tensor, work: int = 0, t0: float | None = None, gp=None):
        self.t0, self.work = time.perf_counter() if t0 is None else t0, work
        # what the goodput ledger needs of a step or a wave beyond the
        # entry: ("step", shape, nb, prefill tokens, [(req, pos, n)]) or
        # ("wave", bucket)
        self.gp = gp
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
    out: object  # a tensor, or (tokens, logits) for a step when sharing is on
    launches: dict


_WARM_RUNS = 2  # eager runs on the capture stream before a capture

# Dead engines whose stream had not passed their death's event (None: never
# reached, the lock was wedged): kept referenced, so their device memory is
# not handed out while programs may still write it (``LLMEngine._release_device``).
_UNRELEASED: list[tuple] = []


class LLMEngine:
    """Serving engine with chunked prefill and fused decode chunks. Runs on
    ``cuda`` unless ``device="cpu"`` is passed (the CPU runs every
    kernel's plain version); raises without a GPU otherwise.

    ``kv_paged`` (``None`` reads ``TPU_LLM_KV_PAGED``: "auto" unless "0")
    picks the KV layout as the JAX engine does: ``True`` the paged pool,
    ``False`` the contiguous layouts (the rolling ring for a windowed
    model where window + slack < max_seq_len, else the dense slab),
    ``"auto"`` the ring where it engages and ``session_mb`` is 0, else
    paged. ``kv_window=0`` forces the dense slab on a windowed model; any
    other value must equal the config's window. A contiguous engine holds
    its slab or ring in ``self.cache`` (``self.pool`` is None); its prefix
    cache is the whole-row ``PrefixCache``, it has no sessions, and it
    ignores ``kv_int8``.

    ``step_token_budget`` (``None`` reads ``TPU_LLM_STEP_TOKEN_BUDGET``,
    default 256) picks the scheduler: above 0 chunked, under that many
    tokens a unified step, 0 the wave. ``prefill_chunk`` (``None`` reads
    ``TPU_LLM_PREFILL_CHUNK``, default 64) caps the chunk shapes,
    ``decode_chunk`` (8) sets the fused steps of a decode chunk and
    ``kv_block`` (``None`` reads ``TPU_LLM_KV_BLOCK``, default 16) the
    paged pool's rows a block. ``admit_cap`` bounds the prefill rows of a
    step or a wave, ``admit_delay_ms`` the wave's fill hold. ``kv_pool_blocks``
    sizes the paged pool (``None`` reads ``TPU_LLM_KV_POOL_BLOCKS``; 0 the
    worst case); ``kv_int8``, ``session_mb`` and ``host_cache_mb`` left
    None read ``TPU_LLM_KV_INT8``, ``TPU_LLM_SESSION_MB`` and
    ``TPU_LLM_HOST_CACHE_MB`` (``kvcache.CacheManager``).

    ``quantize=True`` quantizes the params to int8 at construction unless
    they already are; ``kv_int8=True`` stores the KV pool as int8 rows
    with float32 scales. ``lookahead`` bounds the programs in flight;
    ``warmup=True`` captures every program family as a CUDA graph in the
    constructor (on a CUDA device; a capture that fails raises).
    ``prefix_cache_mb`` > 0 retains published prompts in the radix tree
    under that byte budget; ``session_mb`` > 0 adds the session tier with
    that device budget, spilling to ``host_cache_mb`` of host memory.
    ``speculative=True`` decodes through n-gram drafts verified by
    ``llm.step_v{spec_draft + 1}``; ``None`` reads ``TPU_LLM_SPEC`` (and
    ``spec_draft=None`` ``TPU_LLM_SPEC_DRAFT``), as the JAX engine does.
    ``constrained`` admits requests with a grammar (``None`` reads
    ``TPU_LLM_CONSTRAINED``, on unless "0"), with up to
    ``constrained_grammars`` distinct grammars resident (``None`` reads
    ``TPU_LLM_CONSTRAINED_GRAMMARS``, default 8).

    Overload control (JAX llm.py:792-858; each ``None`` reads its knob):
    ``max_queue`` bounds the waiting requests and ``ttft_deadline_ms``
    sheds one still waiting past it; ``fair_queuing`` (``TPU_LLM_FAIR``,
    on unless "0") orders the queue through a ``FairLedger`` (built from
    ``fair_weights``, or ``fair_ledger`` when given); ``preemption``
    (``TPU_LLM_PREEMPT``, on unless "0") takes batch slots back for
    interactive work; ``shed_predicted_wait_s`` (``TPU_LLM_SHED_WAIT_S``)
    refuses submits past that predicted wait, and ``brownout_wait_s``,
    ``brownout_max_new`` and ``brownout_hold_s``
    (``TPU_LLM_BROWNOUT_WAIT_S``, ``_MAX_NEW``, ``_HOLD_S``, default 2 s)
    clamp batch requests first. ``max_queue``, ``ttft_deadline``,
    ``ledger`` and ``preemption`` may be changed at runtime.

    ``lora_slots`` > 0 (``None`` reads ``TPU_LLM_LORA_SLOTS``, default 0)
    adds an adapter pool of that many gids of rank up to ``lora_rank``
    (``None`` reads ``TPU_LLM_LORA_RANK_MAX``, default 8); with 0 the
    engine captures exactly the programs it does without the feature.

    Recovery (JAX llm.py:860-890): ``fault_injector`` (the process default
    of ``resilience.faults``, armed from ``TPU_LLM_FAULTS``, unless given),
    ``step_watchdog_s`` (``TPU_LLM_STEP_WATCHDOG_S``, 0 off) and
    ``numeric_check`` (``TPU_LLM_NUMERIC_CHECK``, on unless "0");
    ``kv_label`` names the engine in logs and fault labels (a fleet's
    replicas are ``<label>/r<i>``), ``version`` is its model-version
    label, ``logger`` receives its recovery messages. ``role`` ("prefill",
    "decode", or "" for a colocated engine) is the engine's pool in a
    disaggregated fleet (``llm_disagg``); ``stats()`` reports it.

    Chip-time accounting and the flight recorder (JAX llm.py:977-1064;
    each ``None`` reads its knob): ``goodput`` (``TPU_LLM_GOODPUT``, on
    unless "0") turns on the ledger, the usage meter (``usage_meter`` when
    a fleet shares one, else a window of ``usage_window_s``,
    ``TPU_LLM_USAGE_WINDOW_S``, 60 s) and the quota gate (``quotas`` over
    ``TPU_LLM_TENANT_QUOTA_TOK_S``, "tenant=tok/s,..."); ``flight_records``
    (``TPU_LLM_FLIGHT_RECORDS``, 512; 0 off) and ``flight_redact``
    (``TPU_LLM_FLIGHT_REDACT``) size and redact the record ring;
    ``blackbox_dir`` (``GOFR_BLACKBOX_DIR``, unset: no bundle) and
    ``blackbox_interval_s`` (``GOFR_BLACKBOX_INTERVAL_S``, 60) arm the
    bundles; ``anomaly`` (``TPU_LLM_ANOMALY``, on unless "0") the
    detectors (``TPU_LLM_ANOMALY_{FACTOR,MIN_SAMPLES,SUSTAIN}``);
    ``wide_event_sample`` (``TPU_LLM_WIDE_EVENT_SAMPLE``, 1) logs one
    request line in N (all are kept for bundles). ``metrics`` is a
    ``metrics.Manager`` the ledger, the dumper and the detectors write.

    KV handoff (JAX llm.py:4964-5128): ``kv_handoff_export`` gathers one
    exact published prompt's pool blocks and logits, ``kv_handoff_import``
    scatters a peer's into fresh blocks and publishes them as an exact
    radix record; both run on the scheduler thread (``_run_on_scheduler``),
    the only one that writes the pool."""

    _FETCH_FAIL_LIMIT = 3  # failures in a row on one thread before _die

    # plain decode chunks bought by one clean-pipe verify attempt whose
    # lanes drafted nothing (speculative mode); then speculation re-probes
    _SPEC_REPROBE_CHUNKS = 16
    _PREEMPT_CAP = 2  # preemptions per batch request; then it keeps its slot

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
        kv_int8: bool | None = None,
        lookahead: int = 3,
        warmup: bool = True,
        prefix_cache_mb: float = 0.0,
        session_mb: float | None = None,
        host_cache_mb: float | None = None,
        kv_pool_blocks: int | None = None,
        kv_block: int | None = None,
        decode_chunk: int = DECODE_CHUNK,
        prefill_chunk: int | None = None,
        step_token_budget: int | None = None,
        admit_cap: int = ADMIT_CAP,
        admit_delay_ms: float = ADMIT_DELAY_MS,
        speculative: bool | None = None,
        spec_draft: int | None = None,
        constrained: bool | None = None,
        constrained_grammars: int | None = None,
        max_queue: int | None = None,
        ttft_deadline_ms: float | None = None,
        fair_queuing: bool | None = None,
        fair_weights: dict[str, float] | None = None,
        fair_ledger: FairLedger | None = None,
        preemption: bool | None = None,
        shed_predicted_wait_s: float | None = None,
        brownout_wait_s: float | None = None,
        brownout_max_new: int | None = None,
        brownout_hold_s: float | None = None,
        lora_slots: int | None = None,
        lora_rank: int | None = None,
        kv_paged=None,
        kv_window: int | None = None,
        fault_injector: FaultInjector | None = None,
        step_watchdog_s: float | None = None,
        numeric_check: bool | None = None,
        kv_label: str = "llm",
        version: str = "v1",
        role: str = "",
        logger=None,
        metrics=None,
        goodput: bool | None = None,
        quotas: dict[str, float] | None = None,
        usage_meter: UsageMeter | None = None,
        usage_window_s: float | None = None,
        flight_records: int | None = None,
        flight_redact: bool | None = None,
        blackbox_dir: str | None = None,
        blackbox_interval_s: float | None = None,
        anomaly: bool | None = None,
        wide_event_sample: int | None = None,
    ):
        self.device = resolve_device(device)
        self.rng_seed = int(seed)  # the flight records' seed
        self.cfg = cfg
        # the scheduler (JAX llm.py:749-757): a budget > 0 packs prompts
        # into unified steps of chunks no wider than prefill_chunk; 0 is
        # the monolithic wave
        if step_token_budget is None:
            step_token_budget = int(os.environ.get("TPU_LLM_STEP_TOKEN_BUDGET", str(STEP_TOKEN_BUDGET)))
        if prefill_chunk is None:
            prefill_chunk = int(os.environ.get("TPU_LLM_PREFILL_CHUNK", str(PREFILL_CHUNK)))
        self.prefill_chunk = max(1, int(prefill_chunk))
        step_token_budget = max(0, int(step_token_budget))
        self.step_token_budget = step_token_budget
        self.chunked = step_token_budget > 0
        self.params = _to_device(params, self.device)
        if quantize and not is_quantized(self.params):
            self.params = quantize_params(self.params, cfg.dtype)
        self.quantized = bool(quantize)
        # multi-tenant LoRA (JAX llm.py:1150-1197): zero float32 tables for
        # lora_slots + 1 gids (gid 0: the identity) inside params["layers"],
        # added after quantization (the tables stay float32), allocated
        # once: every load writes a gid's rows in place, so the captured
        # programs keep reading the same addresses
        if lora_slots is None:
            lora_slots = int(os.environ.get("TPU_LLM_LORA_SLOTS", "0") or 0)
        if lora_rank is None:
            lora_rank = int(os.environ.get("TPU_LLM_LORA_RANK_MAX", "8") or 8)
        # chunked scheduler only, as in JAX: the wave's packed prefill rows
        # are not the slots, so no adapter id rides them
        self.lora_slots = max(0, int(lora_slots)) if self.chunked else 0
        self.lora_rank = max(1, int(lora_rank))
        self.adapter_requests = 0  # lifetime adapter-attributed submissions
        # one gid's rows in pinned host memory (made at the first load on
        # CUDA, reused), and the event behind the last load's copies
        self._lora_host: dict[str, torch.Tensor] | None = None
        self._lora_done = None
        if self.lora_slots:
            tables = zero_tables(cfg, self.lora_slots, self.lora_rank, self.device)
            self.params = {**self.params, "layers": {**self.params["layers"], **tables}}
            self._lora_pool = AdapterPool(self.lora_slots)
        self.slots = slots
        self.max_seq_len = max_seq_len
        self.prefill_buckets = tuple(sorted(b for b in prefill_buckets if b <= max_seq_len))
        self.decode_chunk = int(decode_chunk)
        self._chunk_short = max(1, self.decode_chunk // 4)
        self.lookahead = max(1, int(lookahead))
        self.admit_cap = min(int(admit_cap), slots)
        self.admit_delay = admit_delay_ms / 1000.0
        # the prefill buckets survive as the chunk shapes, capped at the
        # widest chunk, so short prompts keep their tight shapes
        shapes = {min(b, self.prefill_chunk) for b in self.prefill_buckets}
        shapes.discard(0)
        self.chunk_shapes = tuple(sorted(shapes)) or (min(self.prefill_chunk, max_seq_len),)
        # speculative decoding, off by default (JAX llm.py:763-790): the
        # verify writes spec_draft + 1 rows past a slot's length, which
        # submit()'s decode room keeps inside 2 * decode_chunk rows of slack
        if speculative is None:
            speculative = os.environ.get("TPU_LLM_SPEC", "0") not in ("", "0")
        self.speculative = bool(speculative)
        if spec_draft is None:
            spec_draft = int(os.environ.get("TPU_LLM_SPEC_DRAFT", "") or 0)
        self.spec_draft = (
            max(1, min(int(spec_draft or SPEC_DRAFT_DEFAULT), 2 * self.decode_chunk)) if self.speculative else 0
        )
        # every width one program appends (JAX llm.py:1081-1085): the
        # wave appends decode chunks (and verifies) only
        widths = (self.chunk_shapes if self.chunked else ()) + ((self.spec_draft + 1,) if self.speculative else ())
        self.kv = CacheManager(
            cfg, slots, max_seq_len, self.decode_chunk, window=kv_window, append_widths=widths,
            paged=paged_default() if kv_paged is None else kv_paged, block=kv_block, pool_blocks=kv_pool_blocks,
            kv_int8=kv_int8, prefix_cache_mb=prefix_cache_mb, session_mb=session_mb,
            host_cache_mb=host_cache_mb,
        )
        # the last-token logits ride the prefill programs whenever a prefix
        # index can serve exact hits from them (JAX keep_logits)
        self._keep_logits = self.kv.share or self.kv.prefix is not None
        dev = self.device
        # device-resident state, written IN PLACE by the programs: the KV
        # cache (+ per-slot lengths; the paged pool, with an int8 pool's
        # scales, or the contiguous slab or ring), the chain tail, active
        # mask and temperatures. active is never cleared on retire: on the
        # paged pool the live mask keeps a retired slot from advancing or
        # writing; a contiguous slot advances until its next prompt's
        # first step clears it, as in JAX (its rows are masked)
        if self.kv.paged:
            self.pool, self.pool_scales = self.kv.pool_tensors(dev)
            self.cache = self.pool
        else:
            self.pool = self.pool_scales = None
            self.cache = self.kv.init_cache(slots, dev)
        self._tail = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self._temps = torch.zeros((slots,), dtype=torch.float32, device=dev)
        # grammar-constrained decoding (JAX llm.py:2336-2362): each slot's
        # DFA state on the device, chained like the tail; the resident
        # grammars and their reference counts on the host; the padded
        # [G, Smax, vocab] transition table on the device, made at the
        # first registration (``_g_sync``)
        if constrained is None:
            constrained = os.environ.get("TPU_LLM_CONSTRAINED", "1") != "0"
        # chunked scheduler only, as in JAX: the wave samples first tokens
        # in programs the grammar mask does not ride
        self.constrained = bool(constrained) and self.chunked
        if constrained_grammars is None:
            constrained_grammars = int(os.environ.get("TPU_LLM_CONSTRAINED_GRAMMARS", "8") or 8)
        self._g_cap = max(1, int(constrained_grammars))
        self._grammars: list[Any] = []  # resident TokenGrammars (index = gid)
        self._g_refs: list[int] = []  # live requests holding each gid
        self._g_dirty: set[int] = set()  # gids whose device rows are stale
        self._gtab: torch.Tensor | None = None
        self._g_uploads: list[tuple] = []  # (event, pinned rows) of copies in flight
        self._gstate = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.constrained_requests = 0  # lifetime constrained submissions
        self.spec_proposed_c = 0  # drafts proposed for constrained lanes
        self.spec_accepted_c = 0  # drafts accepted for constrained lanes
        # the constrained families' captures (CUDA): how many times the set
        # was captured (again after the table's padding grew), the seconds
        # and the memory_reserved before/after of the first
        self.g_captures = 0
        self.g_capture_s: float | None = None
        self.g_reserved: tuple[int, int] | None = None
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self._tables_np = np.zeros((slots, self.kv.table_width), np.int32)
        # the wave stages whole prompts: a pack row is a step row of the
        # prompt's bucket (the widest is max_seq_len)
        self._in = _Inputs(
            dev, slots, self.kv.table_width, self.admit_cap,
            self.chunk_shapes[-1] if self.chunked else max_seq_len, self.lookahead + 1,
            ver_width=self.spec_draft + 2 if self.speculative else 0, lora=bool(self.lora_slots),
        )
        # exact hits' stored logits, staged by a device copy before the hit
        # program's replay reads them (with a prefix index only)
        self._hit_logits = (
            torch.zeros((self.admit_cap, cfg.vocab_size), dtype=torch.float32, device=dev)
            if self._keep_logits else None
        )
        # program families, by the JAX compile family's name (+ the wave
        # width of a step, a prefill or a hit): name -> (eager program,
        # kind, arg) with kind "step" (arg (shape, nb)), "prefill" ((bucket,
        # nb)), "chunk" (k), "seed", "hit" (nb) or "verify" (W). Families
        # in _lazy are captured at their first dispatch, not at warmup
        self._programs: dict[str, tuple] = {}
        self._lazy: set[str] = set()
        self._warming = False  # _capture's eager warm-up runs are under way
        if self.chunked:
            for shape in self.chunk_shapes:
                for nb in self._wave_widths():
                    self._programs[self._step_name(shape, nb)] = (
                        functools.partial(self._step_program, shape, nb), "step", (shape, nb)
                    )
        else:
            # one prefill per (bucket, width), as JAX's _warm enumerates;
            # a prompt past the last bucket takes max_seq_len, whose family
            # (as JAX's executable) is made at its first use
            for bucket in self.prefill_buckets + (max_seq_len,):
                for nb in self._wave_widths():
                    name = self._prefill_name(bucket, nb)
                    self._programs[name] = (
                        functools.partial(self._prefill_program, bucket, nb), "prefill", (bucket, nb)
                    )
                    if bucket not in self.prefill_buckets:
                        self._lazy.add(name)
        for k in sorted({self.decode_chunk, self._chunk_short}, reverse=True):
            self._programs[f"llm.decode_chunk{k}"] = (functools.partial(self._chunk_program, k), "chunk", k)
        if self.kv.share:
            self._programs["llm.kv_seed"] = (self._seed_program, "seed", None)
        if self._keep_logits:
            for nb in self._wave_widths():
                self._programs[f"llm.hit_first.w{nb}"] = (functools.partial(self._hit_program, nb), "hit", nb)
        # the drafter is an attribute so a caller (or a test) may swap it;
        # with speculation off nothing of it exists
        self.drafter = None
        if self.speculative:
            self.drafter = NGramDrafter()
            W = self.spec_draft + 1
            self._programs[f"llm.step_v{W}"] = (self._verify_program, "verify", W)
        # the constrained twins of the step, chunk and verify families,
        # captured at the first constrained request (``_g_prepare``)
        self._programs_g: dict[str, tuple] = {}
        if self.constrained:
            for name, (fn, kind, arg) in self._programs.items():
                if kind in ("step", "chunk", "verify"):
                    self._programs_g[self._g_name(name)] = (functools.partial(fn, g=True), kind, arg)
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
        # held by a capture outside the lock (``_g_prepare``) and by an
        # adapter load, whose copies must not land in a graph being captured
        self._capture_lock = threading.Lock()
        self._work_cv = threading.Condition(self._lock)  # _inflight appended
        self._kick = threading.Event()  # scheduler wake: submit / entry emitted
        # dispatched programs, oldest first: ("step", fetch, finishes, nb,
        # snapshot, K), ("chunk", fetch, snapshot, k), ("prefill", fetch,
        # [(slot, req), ...], nb) for a group of exact hits (first tokens
        # only), or ("verify", fetch, [(slot, req), ...], info) for a verify
        self._inflight: deque[tuple] = deque()
        self._processing: tuple | None = None  # entry popped, not yet emitted
        self._jumped = False  # prefill-priority ration (one per chunk)
        self._stop = False
        self.submitted = 0
        self.finished = 0
        self.steps = 0  # unified steps dispatched
        self.waves: dict[int, int] = {}  # prefill waves dispatched, by width
        self.wave_reqs = 0  # requests admitted through waves
        self._last_submit_t: float | None = None
        self._ema_gap: float | None = None  # inter-arrival EMA (the wave's fill hold)
        self.step_tokens = 0  # tokens packed into unified steps
        self.prefill_tokens = 0  # prompt tokens prefilled (packed into unified steps, or waves)
        # session turns finished (eos/length) awaiting their publish, and
        # restores whose host-to-device copies may still be in flight
        self._session_pub: deque[tuple[int, GenRequest]] = deque()
        self._restoring: list[tuple] = []
        self.chunks = 0  # decode chunks (fused or pure) dispatched
        self.deadline_cancels = 0  # requests retired past their deadline
        self.disconnect_cancels = 0  # requests retired for a vanished consumer
        self.spec_steps = 0  # verify programs dispatched
        self.spec_proposed = 0  # draft tokens proposed
        self.spec_accepted = 0  # draft tokens accepted
        self.spec_plain = 0  # verify lanes run with no draft (plain decode)
        self._spec_hold = 0  # plain chunks left before the next verify attempt
        self._spec_rr = 0  # where the next budget-cut verify scan starts
        self._init_overload(
            max_queue, ttft_deadline_ms, fair_queuing, fair_weights, fair_ledger, preemption,
            shed_predicted_wait_s, brownout_wait_s, brownout_max_new, brownout_hold_s,
        )
        self._init_resilience(fault_injector, step_watchdog_s, numeric_check, kv_label, version, logger)
        self.role = str(role)
        self._init_observability(
            metrics, goodput, quotas, usage_meter, usage_window_s, flight_records, flight_redact, blackbox_dir,
            blackbox_interval_s, anomaly, wide_event_sample,
        )
        # a rollout's inputs, kept as a fleet keeps them: the last 8
        # accepted prompts (the shadow replay's source) and the registered
        # adapters' host copies (re-staged into an engine swap's candidate)
        self._shadow_ring: deque = deque(maxlen=8)
        self._adapters_host: dict[str, dict] = {}
        # host work other threads queue for the scheduler thread (the KV
        # handoff): (fn, box) pairs, run at the top of each pass
        self._sched_work: deque[tuple] = deque()
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
        if self.step_watchdog_s > 0:
            # after the warmup: beats wrap serving only, never a capture
            self.watchdog = StepWatchdog(self, self.step_watchdog_s)

    # -- public API -------------------------------------------------------
    def submit(self, req: GenRequest) -> GenRequest:
        """Queue ``req`` (JAX ``submit``): validate it, then the overload
        gates in the JAX order — the predicted-wait shed, the brownout
        clamp of a batch request's REMAINING tokens, the ``max_queue``
        reject (each ``EngineOverloaded`` with a Retry-After) — and only
        then take references (the adapter's gid, a grammar's table slot), so
        a refused submit leaks nothing. An adapted request with no client
        bills the adapter's pseudo-client ``adapter:<name>``."""
        if self._stop:
            raise EngineStoppedError(f"engine stopped ({self.died_reason or 'closed'})")
        if self._draining:
            raise EngineDraining("engine draining (rolling deploy)")
        if req.adapter and not self.lora_slots:
            raise ValueError(
                f"request names adapter {req.adapter!r} but this engine has no adapter pool "
                "(lora_slots=0; set TPU_LLM_LORA_SLOTS)"
            )
        plen = len(req.prompt_tokens)
        if plen == 0:
            raise ValueError("empty prompt")
        if plen >= self.max_seq_len:
            raise ValueError(f"prompt of {plen} tokens exceeds max_seq_len {self.max_seq_len}")
        # cap max_new_tokens so a slot's rows stay inside its capacity: a
        # request's length may overshoot by one decode chunk, and the
        # end-of-chunk merge needs another chunk of slack. Only the
        # REMAINING tokens need room (a continuation arrives with emitted > 0)
        room = self.max_seq_len - plen - 2 * self.decode_chunk
        if room < 1:
            raise ValueError(
                f"prompt of {plen} tokens leaves no decode room at max_seq_len "
                f"{self.max_seq_len} (chunk {self.decode_chunk})"
            )
        if req.max_new_tokens - req.emitted > room:
            req.max_new_tokens = room + req.emitted
            req.capped = True
        if self.kv.paged:  # a contiguous slot holds its whole capacity
            # a worst case past the WHOLE pool could never be admitted:
            # refuse it now (pool pressure queues the ones that fit later)
            need = self.kv.reserve_need(plen, req.max_new_tokens - req.emitted)
            if need > self.kv.pool.n_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks, pool holds {self.kv.pool.n_blocks} "
                    "(raise kv_pool_blocks / TPU_LLM_KV_POOL_BLOCKS)"
                )
        if req.grammar is not None:  # JAX llm.py:2479-2497
            if not self.constrained:
                raise ValueError(
                    "grammar-constrained decoding requires the chunked scheduler (step_token_budget > 0) "
                    "and TPU_LLM_CONSTRAINED=1"
                )
            g = req.grammar
            if req.eos_token < 0:
                # the grammar's completion transition IS the eos: without
                # it the stream would run past the closed value
                req.eos_token = g.eos_id
            elif req.eos_token != g.eos_id:
                raise ValueError(
                    f"request eos_token {req.eos_token} != grammar eos {g.eos_id} (the grammar closes the stream)"
                )
        # anything but the literal "batch" is interactive: a typo in the
        # header degrades to the latency-safe class (JAX llm.py:2503)
        req.priority = "batch" if req.priority == "batch" else "interactive"
        # the tenant's token-rate quota over its MEASURED usage window (JAX
        # llm.py:2504-2527), before any reference is taken; probes pass,
        # so an over-quota tenant cannot block the canary that guards it
        if self.quota is not None and self.quota.active() and not req.probe:
            tenant = req.client or (f"adapter:{req.adapter}" if req.adapter else "-")
            quota_retry = self.quota.check(tenant)
            if quota_retry is not None:
                self.quota_sheds += 1
                if self.metrics is not None:
                    self.metrics.increment_counter("app_llm_quota_sheds_total", model=self.label, tenant=tenant)
                raise EngineOverloaded(
                    f"tenant {tenant!r} over token-rate quota {self.quota.quota_for(tenant):.0f} tok/s "
                    "(TPU_LLM_TENANT_QUOTA_TOK_S)",
                    retry_after=quota_retry,
                )
        wait_s = self.predicted_wait_s()
        spec = self.faults.take("overload_pressure", self.label)
        if spec is not None:
            # chaos seam: this submit sees ``delay`` seconds of predicted wait
            self._count_fault("overload_pressure")
            wait_s = spec.delay if spec.delay > 0 else 3600.0
        self.overload.observe(wait_s)
        shed_after = self.overload.should_shed(wait_s)
        if shed_after is not None:
            self.sheds_predicted += 1
            raise EngineOverloaded(
                f"predicted queue wait {wait_s:.1f}s exceeds shed threshold {self.overload.shed_wait_s:.1f}s",
                retry_after=shed_after,
            )
        clamp = self.overload.clamp(req.max_new_tokens - req.emitted, req.priority) + req.emitted
        if clamp < req.max_new_tokens:
            req.max_new_tokens = clamp
            req.browned = True
            self.brownout_clamped += 1
        if self.max_queue is not None:
            depth = self._admit_q.qsize() + len(self._waiting)
            if depth >= self.max_queue:
                self.rejected += 1
                raise EngineOverloaded(
                    f"admission queue full ({depth} >= {self.max_queue})",
                    retry_after=wait_s if wait_s else 1.0,
                )
        if req.adapter:  # JAX llm.py:2589-2621
            with self._lock:
                try:
                    req._aid = self._lora_pool.acquire(req.adapter)
                except KeyError:
                    raise UnknownAdapterError(req.adapter, self._lora_pool.resident()) from None
                self.adapter_requests += 1
            if not req.client:
                req.client = f"adapter:{req.adapter}"
        else:
            req._aid = 0
        if req.grammar is not None:
            with self._lock:
                try:
                    req._g_id = self._register_grammar(req.grammar)
                except BaseException:
                    self._lora_release(req)
                    raise
                self._g_refs[req._g_id] += 1
                self.constrained_requests += 1
        if self.ledger is not None:
            # the new-arrival lift, before the request becomes orderable
            self.ledger.touch(req.client)
        req.submitted_at = now = time.perf_counter()
        # a continuation that has emitted tokens stays on this version
        req.engine_version = self.version
        # a failover continuation's spec state belongs to its old replica
        req._spec_pending = []
        req._spec_inflight = 0
        with self._lock:
            self.submitted += 1
            req._load_acct = plen + max(0, req.max_new_tokens - req.emitted)
            self._load_tokens += req._load_acct
            # the arrival-rate estimate the wave's fill hold reads (JAX
            # llm.py:2700-2708)
            last, self._last_submit_t = self._last_submit_t, now
            if last is not None:
                gap = min(max(now - last, 0.0), 1.0)
                self._ema_gap = gap if self._ema_gap is None else 0.8 * self._ema_gap + 0.2 * gap
        self._shadow_ring.append(tuple(req.prompt_tokens[:32]))
        # the flight record's re-execution inputs, now: an in-flight request
        # is replayable when the engine dies (JAX llm.py:2717; a failover
        # continuation records its continuation prompt)
        self.flightrec.start(req, self)
        self._admit_q.put(req)
        if self._stop:
            # stopped between the check above and the put: the one-shot
            # drain may have run already (JAX llm.py:2719-2724)
            self._drain_pending()
        self._kick.set()
        return req

    def generate(self, prompt_tokens: list[int], **kw) -> list[int]:
        return self.submit(GenRequest(prompt_tokens, **kw)).tokens()

    def stats(self) -> dict:
        with self._lock:
            return {
                "scheduler": "chunked" if self.chunked else "wave",
                "step_token_budget": self.step_token_budget,
                "decode_chunk": self.decode_chunk,
                "prefill_chunk": self.prefill_chunk,
                "prefill_waves": dict(sorted(self.waves.items())),
                "wave_reqs": self.wave_reqs,
                "slots": self.slots,
                "active": sum(r is not None for r in self._slot_req),
                "waiting": self._admit_q.qsize() + len(self._waiting),
                "max_seq_len": self.max_seq_len,
                "quantized": self.quantized,
                "moe_experts": self.cfg.n_experts,
                "submitted": self.submitted,
                "finished": self.finished,
                "steps": self.steps,
                "step_tokens": self.step_tokens,
                "prefill_tokens": self.prefill_tokens,
                "chunks": self.chunks,
                "inflight_chunks": sum(1 for e in self._inflight if e[0] == "chunk"),
                "deadline_cancels": self.deadline_cancels,
                "disconnect_cancels": self.disconnect_cancels,
                # overload control, under the JAX engine's keys
                "load_tokens": self.load_tokens(),
                "rejected": self.rejected,
                "shed": self.shed,
                "preemptions": self.preemptions,
                "sheds_predicted": self.sheds_predicted,
                "brownout_clamped": self.brownout_clamped,
                "predicted_wait_s": self.predicted_wait_s(),
                "overload": self.overload.snapshot(),
                "fairness": self.ledger.snapshot() if self.ledger is not None else None,
                "chunk_shapes": self.chunk_shapes,
                "kv_paged": self.kv.paged,
                "spec": self._spec_summary(),
                "constrained": self._constrained_summary(),
                "adapters": {
                    **self.adapters(), "requests": self.adapter_requests,
                    "rank_max": self.lora_rank if self.lora_slots else 0,
                },
                "kvcache": self.kv.stats(),
                "warmup_s": self.warmup_s,
                # recovery and the model lifecycle (JAX stats' keys)
                "version": self.version,
                "role": self.role,
                "errored": self.errored,
                "alive": self.alive(),
                "draining": self._draining,
                "error": self.died_reason,
                "numeric_check": self.numeric_check,
                "numerical_trips": self.numerical_trips,
                "watchdog_trips": self.watchdog.trips if self.watchdog is not None else 0,
                # chip-time attribution and the quota gate (JAX stats' keys)
                "goodput": self.goodput.snapshot() if self.goodput is not None else None,
                "quota": {**self.quota.snapshot(), "sheds": self.quota_sheds} if self.quota is not None else None,
            }

    def debug_state(self) -> dict:
        """The engine's recovery, accounting and recorder state (a subset of
        JAX ``debug_state``): host counters only, no device read."""
        return {
            "label": self.label, "version": self.version, "role": self.role, "alive": self.alive(),
            "draining": self._draining, "errored": self.errored,
            "died": self._died, "died_reason": self.died_reason, "load": self.load(),
            "load_tokens": self.load_tokens(), "step_watchdog_s": self.step_watchdog_s,
            "numeric_check": self.numeric_check, "faults": self.faults.snapshot(),
            "submitted": self.submitted, "finished": self.finished, "rejected": self.rejected, "shed": self.shed,
            "slot_table": [
                {"slot": i, "id": r.id, "phase": "decode" if r.prefill_done else "prefill", "emitted": r.emitted,
                 "max_new_tokens": r.max_new_tokens, "client": r.client}
                for i, r in enumerate(list(self._slot_req)) if r is not None
            ],
            "inflight": [e[0] for e in list(self._inflight)],
            "waiting_total": self._admit_q.qsize() + len(self._waiting),
            "goodput": self.goodput.snapshot() if self.goodput is not None else None,
            "usage": self.usage.snapshot() if self.usage is not None else None,
            "quota": {**self.quota.snapshot(), "sheds": self.quota_sheds} if self.quota is not None else None,
            "flight_records": len(self.flightrec),
            "anomaly": self.anomaly.flagged() if self.anomaly is not None else [],
            "kvcache": self.kv.stats(),
            "warmup_s": self.warmup_s,
        }

    def close(self, timeout: float = 30.0) -> None:
        """Stop the scheduler, let the collector emit what is in flight,
        and end every unfinished stream. A dead engine's memory is left to
        its ``_die`` (a wedged stream is never waited on)."""
        self._stop = True
        self._fail_sched_work()  # handoff waiters fail fast, not by timeout
        self._kick.set()
        self._thread.join(timeout=timeout)
        with self._work_cv:
            self._work_cv.notify_all()
        self._collector.join(timeout=timeout)
        if self.watchdog is not None:
            self.watchdog.join(timeout=timeout)
        if not self._died:  # _die drained already, or found the lock wedged
            # every unfinished stream ends "cancelled": slotted and in
            # flight, then waiting and queued
            self._recover_all()
            self._drain_pending()
        if self.ledger is not None:
            # a closed engine must not pin a shared ledger's new-arrival
            # floor with a stale waiting-client set
            self.ledger.set_active(self._shard, set())
        self._flush_wide_events()
        # no further bundle, and the record ring goes with the engine (after
        # a _die the ring stayed for the post-mortem) (JAX llm.py:3671-3692,
        # :3736-3737)
        self._zero_gauges()
        self.blackbox.close()
        self.flightrec.clear()
        if self.device.type == "cuda" and not self._died:
            self._stream.synchronize()
            self.families.clear()  # the graphs and their memory pool

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- scheduler ------------------------------------------------------------
    def _schedule_loop(self) -> None:
        """The scheduler thread (JAX ``_schedule_loop``): the terminal
        chaos seams, then one pass at a time under per-iteration recovery
        (``_recover_all``; ``_FETCH_FAIL_LIMIT`` failing passes in a row
        with no program launched between them end in ``_die``). A thread
        that leaves the loop while the engine runs dies loudly."""
        try:
            on_card = torch.cuda.stream(self._stream) if self.device.type == "cuda" else contextlib.nullcontext()
            with torch.no_grad(), on_card:
                while not self._stop:
                    if self.faults.take("replica_kill", self.label) is not None:
                        self._count_fault("replica_kill")
                        self._die("fault injection: replica_kill")
                        break
                    if self._poison_fault():
                        break
                    try:
                        self._schedule_pass()
                        self._flush_wide_events()
                    except Exception as e:  # noqa: BLE001 — the engine must not die silently
                        if self._stop:
                            break
                        self._sched_fail_streak += 1
                        why = f"{type(e).__name__}: {e}"
                        if self.logger is not None:
                            self.logger.error(f"LLM engine step failed: {e!r}")
                        if self._sched_fail_streak >= self._FETCH_FAIL_LIMIT:
                            self._die(f"scheduler failed {self._sched_fail_streak} passes in a row: {why}")
                            break
                        self._recover_all()
                        time.sleep(0.1)
        finally:
            if not self._stop:
                self._die("scheduler thread exited unexpectedly")

    def _schedule_pass(self) -> None:
        """One scheduler pass: queued host work, retire, order, admit,
        dispatch."""
        self._run_sched_work()
        self._drain_submits()
        self._expire_deadlines(time.perf_counter())
        self._order_waiting()
        # a pressure sample every pass, so brownout can let go
        # while no submit arrives
        self.overload.observe(self.predicted_wait_s())
        if self.kv.share:
            # paged-pool housekeeping, in dependency order:
            # publish finished session turns (needs their
            # blocks), return retired slots' blocks, spill cold
            # sessions past their device budget
            self._kv_session_flush()
            self._kv_sweep()
            self._kv_session_spill()
        admitted = self._admit()
        if self.constrained:
            self._g_prepare()
        with self._lock:
            # decode programs in flight (hit groups carry none)
            entries = list(self._inflight) + [e for e in (self._processing,) if e is not None]
            depth = sum(1 for e in entries if e[0] != "prefill")
            needed = self._needed_steps()
            prefilling = bool(self._prefilling)
            if self.speculative and not any(r is not None and r.prefill_done for r in self._slot_req):
                self._spec_hold = 0  # no slot decodes: see _spec_regime
        stepped = False
        if prefilling and depth < self.lookahead:
            # one unified step per pass; the loop comes
            # straight back for the next
            stepped = self._dispatch_step()
            if stepped:
                depth += 1
                needed = max(0, needed - self.decode_chunk)
        did_v, chunk_ok = False, True
        if self.speculative:
            did_v, chunk_ok = self._spec_regime(stepped, depth)
        want = 0
        if chunk_ok:
            want = min(-(-needed // self.decode_chunk), self.lookahead - depth)
            for _ in range(max(0, want)):
                needed = max(0, needed - self._dispatch_chunk(needed))
                if self.speculative:
                    self._spec_hold -= 1
        if not admitted and not stepped and not did_v and want <= 0:
            self._kick.wait(timeout=0.005)
            self._kick.clear()

    def _spec_regime(self, stepped: bool, depth: int) -> tuple[bool, bool]:
        """The speculative regime's policy for one scheduler pass (JAX
        ``_schedule_loop``): decode advances through verify programs, up
        to the lookahead depth, whenever anything drafts. A clean-pipe
        attempt whose eligible lanes drafted nothing buys a burst of
        ``_SPEC_REPROBE_CHUNKS`` plain chunks (``_spec_hold``); when it is
        spent the pipe drains and speculation probes again. Chunks and
        verifies never interleave: a chunk advances every device-active
        slot from the device tail and would double-advance a verify's
        slots. Returns (a verify was dispatched, chunks may dispatch).

        One repair against the reference: the burst ends with the slots
        that bought it, so a scheduler pass that starts with no slot
        decoding drops what is left of it (``_schedule_loop``). The JAX
        engine keeps it: an idle pass (its attempt finds no lane) or a
        last token (no room to draft) buys a burst that only chunks
        spend, and the next requests decode their first 16 chunks without
        speculating."""
        with self._lock:
            kinds = {e[0] for e in self._inflight}
            if self._processing is not None:
                kinds.add(self._processing[0])
        ver_fly = "verify" in kinds
        dec_fly = bool(kinds - {"prefill"})
        did_v = False
        if not stepped and depth < self.lookahead and self._spec_hold <= 0:
            did_v = self._dispatch_verify()
            if not did_v and not dec_fly:
                self._spec_hold = self._SPEC_REPROBE_CHUNKS
        return did_v, not ver_fly and not did_v and self._spec_hold > 0

    # -- recovery (JAX llm.py:860-890, 3505-3650, 6992-7330) -----------------
    def _init_resilience(self, fault_injector, step_watchdog_s, numeric_check, kv_label, version, logger) -> None:
        """The recovery kwargs with the JAX engine's env fallbacks."""
        self.faults = fault_injector if fault_injector is not None else default_injector()
        self.label = kv_label
        self.version = str(version)
        self.logger = logger
        # the scheduler's device section and the collector's fetch, which
        # the step watchdog samples
        self._hb_dispatch = Heartbeat()
        self._hb_fetch = Heartbeat()
        if step_watchdog_s is None:
            step_watchdog_s = float(os.environ.get("TPU_LLM_STEP_WATCHDOG_S", "0") or 0.0)
        self.step_watchdog_s = max(0.0, float(step_watchdog_s))
        self.watchdog: StepWatchdog | None = None  # started after the threads
        if numeric_check is None:
            numeric_check = os.environ.get("TPU_LLM_NUMERIC_CHECK", "1") != "0"
        self.numeric_check = bool(numeric_check)
        self.numerical_trips = 0
        self.errored = 0  # requests finished "error" or "poison": a rollout's bake signal
        self._draining = False
        self._died = False  # _die ran: idempotence, and no emission after it
        self._die_guard = threading.Lock()
        self.died_reason: str | None = None
        # ReplicatedLLMEngine sets it: _die hands it the recoverable requests
        self.failover_hook = None
        self._sched_fail_streak = 0  # failing passes with no launch between them
        self._fetch_fail_streak = 0  # failing fetches in a row

    # -- chip-time accounting and the flight recorder (JAX llm.py:977-1064,
    # :2983-3140, :5548-5660) ----------------------------------------------
    def _init_observability(
        self, metrics, goodput, quotas, usage_meter, usage_window_s, flight_records, flight_redact, blackbox_dir,
        blackbox_interval_s, anomaly, wide_event_sample,
    ) -> None:
        """The ledger, the meter, the quota gate, the recorder, the dumper
        and the detectors with the JAX engine's defaults and env
        fallbacks (the recorder, the dumper and the detectors read their
        own knobs for a None)."""
        env = os.environ.get
        self.metrics = metrics
        if metrics is not None:
            register_goodput_metrics(metrics)
        self.flightrec = FlightRecorder(flight_records, redact=flight_redact)
        self.blackbox = BlackboxDumper(
            blackbox_dir, min_interval_s=blackbox_interval_s, logger=self.logger, metrics=metrics, label=self.label,
        )
        if anomaly is None:
            anomaly = env("TPU_LLM_ANOMALY", "1") not in ("", "0")
        self.anomaly = None
        if anomaly:
            self.anomaly = AnomalyDetector(
                metrics, self.label,
                on_flag=lambda sig, val, mean: self._incident(
                    "anomaly", reason=f"{sig} sustained deviant: {val:.3f} vs baseline mean {mean:.3f}"
                ),
            )
        # every request's wide event is kept for bundles; the log gets one
        # in wide_event_sample (incident lines always)
        if wide_event_sample is None:
            wide_event_sample = int(env("TPU_LLM_WIDE_EVENT_SAMPLE", "") or 1)
        self._wide_sample = max(1, int(wide_event_sample))
        self._wide_seq = 0
        self._wide_retained: deque = deque(maxlen=WIDE_EVENTS_KEEP)
        self._wide_events: list[dict] = []  # appended under _lock, logged outside it
        goodput, usage_window_s = goodput_knobs(goodput, usage_window_s)
        self.goodput = self.usage = self.quota = None
        self.quota_sheds = 0
        if goodput:
            self.usage = usage_meter if usage_meter is not None else UsageMeter(window_s=usage_window_s)
            self.goodput = GoodputLedger(
                metrics=metrics, label=self.label, version_fn=lambda: self.version, usage=self.usage,
            )
            q = parse_quota_spec(env("TPU_LLM_TENANT_QUOTA_TOK_S"))
            for tenant, rate in (quotas or {}).items():
                try:
                    q[str(tenant)] = float(rate)
                except (TypeError, ValueError):
                    continue
            self.quota = QuotaGate(q, self.usage)

    def _gp_observe(self, entry: tuple, now: float, acc=None) -> None:
        """Hand the goodput ledger one fetched program's window and lanes
        (JAX llm.py:6432-6461, :6526-6544, :6655-6680, :6802-6820), before
        its tokens are emitted: a lane's useful decode tokens are capped at
        what its request may still emit, the rest of its lane is padding,
        and a lane no request owns (a dead slot, a bucket row past the
        packed prompts, an unselected verify row) is anonymous padding,
        billed by the ledger to the window's requests. Collector thread,
        outside the lock (it reads ``emitted``, which only the collector
        advances)."""
        kind, fetch = entry[0], entry[1]
        lanes: list = []

        def decode(snapshot, k):
            live = 0
            for r in snapshot:
                if r is None:
                    continue
                live += 1
                use = min(k, max(0, r.max_new_tokens - r.emitted))
                cl = {"useful": use}
                if k - use > 0:
                    cl["padding"] = k - use
                lanes.append((r, cl))
            return k * (len(snapshot) - live)

        if kind == "prefill":
            # a wave ran [nb, bucket] prompt rows (scrubbed lanes are
            # padding); an exact-hit group ran one first-token sample a lane
            bucket = fetch.gp[1] if fetch.gp is not None else None
            plen_sum = 0
            for _s, r in entry[2]:
                if r is None:
                    continue
                if bucket is None:
                    lanes.append((r, {"useful": 1}))
                    continue
                plen = len(r.prompt_tokens)
                lanes.append((r, prefill_classes(r._replay_pos, 0, plen)))
                plen_sum += plen
            pad = bucket * max(entry[3], len(entry[2])) - plen_sum if bucket is not None else 0
        elif kind == "step":
            # each packed chunk is its row's request's (a continuation's
            # replayed positions split off); the fused decode chunk ran k
            # steps over every slot lane
            _k, shape, nb, prefill_tokens, rows = fetch.gp
            for r, pos, n in rows:
                lanes.append((r, prefill_classes(r._replay_pos, pos, n)))
            pad = shape * nb - prefill_tokens + decode(entry[4], entry[5])
        elif kind == "chunk":
            pad = decode(entry[2], entry[3])
        else:  # verify: accepted span + bonus useful, rejected drafts spec_reject
            info = entry[3]
            W = info["W"]
            for slot, r in entry[2]:
                a = int(acc[slot])
                use = min(a + 1, max(0, r.max_new_tokens - r.emitted))
                cl = {"useful": use}
                if a + 1 - use > 0:
                    cl["padding"] = a + 1 - use
                rej = info["n_draft"].get(slot, 0) - a
                if rej > 0:
                    cl["spec_reject"] = rej
                lanes.append((r, cl))
            pad = W * (self.slots - len(entry[2]))
        if pad > 0:
            lanes.append((None, {"padding": pad}))
        self.goodput.observe(kind, fetch.t0, now, lanes)

    def _observe_finish(self, r: GenRequest, now: float) -> None:
        """A request's terminal observability (JAX ``_observe_finish``'s
        flight-record, anomaly and wide-event part): finalize its record
        with its phase times and chip time, feed the queue-wait, TTFT and
        TPOT detectors, and keep its wide event (logged 1-in-N). Lock
        held."""
        total = None if r.submitted_at is None else now - r.submitted_at
        queue_wait = None if r.admitted_at is None or r.submitted_at is None else r.admitted_at - r.submitted_at
        ttft = None if r.first_token_at is None or r.submitted_at is None else r.first_token_at - r.submitted_at
        tpot = None
        if r.first_token_at is not None and r.emitted > 1:
            tpot = (now - r.first_token_at) / (r.emitted - 1)
        chip = dict(r._chip)

        def ms(v):
            return None if v is None else round(v * 1e3, 3)

        self.flightrec.finalize(
            r, queue_wait_ms=None if queue_wait is None else queue_wait * 1e3,
            ttft_ms=None if ttft is None else ttft * 1e3, per_token_ms=None if tpot is None else tpot * 1e3,
            total_ms=None if total is None else total * 1e3, chip={c: ms(v) for c, v in chip.items()} or None,
        )
        if self.anomaly is not None:
            for signal, v in (("queue_wait", queue_wait), ("ttft", ttft), ("tpot", tpot)):
                if v is not None:
                    self.anomaly.observe(signal, v * 1e3)
        ev = {
            "event": "llm_request", "model": self.label, "model_version": self.version, "id": r.id,
            "trace_id": "", "journey_id": "", "hop": r.hop, "prompt_tokens": len(r.prompt_tokens),
            "output_tokens": r.emitted, "finish_reason": r.finish_reason, "queue_wait_ms": ms(queue_wait),
            "ttft_ms": ms(ttft), "per_token_ms": ms(tpot), "total_ms": ms(total), "prefix_hit": r.prefix_hit,
            "capped": r.capped, "chip_ms": ms(sum(chip.values())),
            "chip_breakdown_ms": {c: ms(v) for c, v in chip.items()},
        }
        self._wide_retained.append(ev)
        if self.logger is not None:
            self._wide_seq += 1
            forced = r.finish_reason not in ("eos", "length") or r.deaths > 0 or r.hop > 0
            if self._wide_sample <= 1:
                self._wide_events.append(ev)
            elif forced:
                self._wide_events.append({**ev, "sample": 1})
            elif self._wide_seq % self._wide_sample == 0:
                self._wide_events.append({**ev, "sample": self._wide_sample})

    def _flush_wide_events(self) -> None:
        """Log the queued wide events, outside the lock."""
        if not self._wide_events:
            return
        with self._lock:
            events, self._wide_events = self._wide_events, []
        for ev in events:
            self.logger.info(ev)

    def usage_state(self) -> dict:
        """Windowed per-tenant usage and the cumulative goodput for
        ``/.well-known/debug/usage`` (JAX ``usage_state``; a fleet's has the
        same shape)."""
        usage = self.usage.snapshot() if self.usage is not None else {"window_s": None, "tenants": {}}
        return {
            "replicas": 1,
            "goodput": self.goodput.snapshot() if self.goodput is not None else None,
            "quota": self.quota.snapshot() if self.quota is not None else None,
            "quota_sheds": self.quota_sheds,
            **usage,
        }

    def set_tenant_quota(self, tenant: str, tok_s: float | None) -> None:
        """Set (or clear, with None) a tenant's token-rate quota at runtime
        (``register_adapter(quota=)`` sets ``adapter:<name>``'s)."""
        if self.quota is not None:
            self.quota.set(tenant, tok_s)

    def _inflight_requests(self) -> list[GenRequest]:
        """Every live request (slotted, in a program in flight,
        prefilling, waiting), swept WITHOUT the lock: the incident path may
        run while a hung call holds it, and a torn read (one request too
        many) beats a bundle stuck behind the hang it documents."""
        out: list[GenRequest] = []
        seen: set[int] = set()

        def take(r) -> None:
            if r is not None and r.id not in seen:
                seen.add(r.id)
                out.append(r)

        for r in list(self._slot_req):
            take(r)
        entries = list(self._inflight)
        proc = self._processing
        if proc is not None:
            entries.append(proc)
        for e in entries:
            try:
                for r in self._entry_requests(e):
                    take(r)
            except Exception:  # noqa: BLE001 — racy sweep, entries may be torn
                continue
        for r in list(self._prefilling) + list(self._waiting):
            take(r)
        return out

    def _hbm_samples(self) -> list[dict]:
        """Device memory per visible card from the caching allocator's
        counters (host-side reads, no synchronization); None fields on
        the CPU, as JAX's on a backend without memory_stats."""
        if not torch.cuda.is_available():
            return [{"device": "cpu", "platform": "cpu", "kind": "cpu", "bytes_in_use": None, "bytes_limit": None,
                     "peak_bytes_in_use": None}]
        out = []
        for d in range(torch.cuda.device_count()):
            try:
                st = torch.cuda.memory_stats(d)
                props = torch.cuda.get_device_properties(d)
                out.append({
                    "device": d, "platform": "gpu", "kind": props.name,
                    "bytes_in_use": st.get("allocated_bytes.all.current"),
                    "bytes_limit": props.total_memory,
                    "peak_bytes_in_use": st.get("allocated_bytes.all.peak"),
                })
            except Exception:  # noqa: BLE001 — a sick card costs its row, not the bundle
                out.append({"device": d, "platform": "gpu", "kind": "", "bytes_in_use": None, "bytes_limit": None,
                            "peak_bytes_in_use": None})
        return out

    def _config_fingerprint(self) -> dict:
        """The serving shape plus its content hash: is the replay host
        configured like the incident host (JAX ``_config_fingerprint``;
        ``tp_degree`` is 1, tensor parallelism is not ported)."""
        import hashlib
        import json

        shape = {
            "model": self.label, "version": self.version, "role": self.role, "slots": self.slots,
            "max_seq_len": self.max_seq_len, "decode_chunk": self.decode_chunk, "chunked": self.chunked,
            "speculative": self.speculative, "spec_draft": self.spec_draft, "constrained": self.constrained,
            "lora_slots": self.lora_slots, "quantized": self.quantized, "kv_paged": self.kv.paged,
            "kv_window": self.kv.window, "tp_degree": 1, "flight_records": self.flightrec.capacity,
            "flight_redact": self.flightrec.redact, "wide_event_sample": self._wide_sample,
        }
        shape["sha256"] = hashlib.sha256(json.dumps(shape, sort_keys=True, default=repr).encode()).hexdigest()
        return shape

    def _incident(self, trigger: str, *, reason: str = "", lock_timeout: float = 2.0) -> str | None:
        """Dump one black-box bundle (JAX ``_incident``): debug_state, the
        retained wide events, the HBM samples, the config fingerprint, the
        detectors' state and the flight records of everything in flight
        (then the newest 64 final ones). Returns its path, or None when
        unarmed or rate-limited. Never raises. The bundle's ``traces`` and
        ``compiles`` sections wait for the port's tracer and compile
        registry (ROADMAP ID 10), as JAX leaves ``traces`` out without a
        tracer. Nothing here synchronizes the card: a hung stream or a
        sticky error costs a section at most."""
        if not self.blackbox.enabled():
            return None
        try:
            sections: dict[str, Any] = {}
            # a bounded acquire: the incident may BE a hung call holding
            # the lock (an RLock: a caller under it re-enters at once)
            if self._lock.acquire(timeout=lock_timeout):
                try:
                    sections["debug_state"] = self.debug_state()
                finally:
                    self._lock.release()
            else:
                sections["debug_state"] = {"lock_wedged": True, "died": self._died, "died_reason": self.died_reason}
            sections["wide_events"] = list(self._wide_retained)
            sections["hbm"] = self._hbm_samples()
            sections["config"] = self._config_fingerprint()
            if self.anomaly is not None:
                sections["anomaly"] = self.anomaly.snapshot()
            records = self.flightrec.snapshot_inflight(self._inflight_requests())
            records.extend(self.flightrec.records(limit=64, final=True))
            return self.blackbox.dump(trigger, reason=reason, sections=sections, records=records)
        except Exception as e:  # noqa: BLE001 — see docstring
            if self.logger is not None:
                self.logger.error(f"black-box bundle capture failed: {e!r}")
            return None

    def replay(self, record_or_id, *, timeout: float = 120.0) -> dict:
        """Re-execute a flight record (or a record id) with its version,
        adapter, grammar and sampling pinned; reports the first index where
        the replay leaves the recorded emission (``flightrec.replay_record``)."""
        from .flightrec import replay_record

        rec = record_or_id
        if not isinstance(rec, dict):
            rec = self.flightrec.get(int(record_or_id))
            if rec is None:
                return {
                    "id": record_or_id,
                    "error": f"no flight record with that id (ring holds {len(self.flightrec)} of "
                             f"{self.flightrec.capacity})",
                }
        return replay_record(self, rec, timeout=timeout)

    def _zero_gauges(self) -> None:
        """close() and _die(): a dead engine must not hold its goodput ratio
        or an anomaly flag on the exposition (and a restarted one starts
        on fresh baselines)."""
        if self.goodput is not None:
            self.goodput.zero_gauges()
        if self.anomaly is not None:
            self.anomaly.zero_gauges()

    def load(self) -> int:
        """The router's tie-break: occupants plus queued requests
        (lock-free; a torn read costs a stale unit)."""
        return sum(r is not None for r in self._slot_req) + self._admit_q.qsize() + len(self._waiting)

    def resident_slots(self) -> int:
        """Occupied slots right now: the decode pool's routing signal in a
        disaggregated fleet (lock-free, as ``load``)."""
        return sum(r is not None for r in self._slot_req)

    def alive(self) -> bool:
        """Serving: neither ``close`` nor ``_die`` has begun and both threads run."""
        return not self._stop and self._thread.is_alive() and self._collector.is_alive()

    def accepting(self) -> bool:
        """Alive and taking new work (a draining engine is not)."""
        return self.alive() and not self._draining

    def drain(self) -> None:
        """Close admission (``submit`` raises ``EngineDraining``, 503) while
        every queued and slotted request runs to completion."""
        self._draining = True
        self._kick.set()

    def undrain(self) -> None:
        """Reopen admission after a drain that was called off."""
        self._draining = False
        self._kick.set()

    def drained(self) -> bool:
        """True once nothing is queued, slotted or in flight; a dead
        engine is drained (its lock may be held by a wedged call)."""
        if self._died:
            return True
        with self._lock:
            return self.load() == 0 and not self._inflight and self._processing is None

    def _fault(self, point: str) -> None:
        """Raise-kind seam: ``InjectedFault`` when ``point`` is armed for
        this engine's label."""
        spec = self.faults.take(point, self.label)
        if spec is None:
            return
        self._count_fault(point)
        raise InjectedFault(spec.message)

    def _fault_latency(self) -> None:
        """Sleep-kind seam (inside the fetch heartbeat, outside the lock):
        a wedged transfer, as the host sees one."""
        spec = self.faults.take("step_latency", self.label)
        if spec is None:
            return
        self._count_fault("step_latency")
        sleep_for(spec)

    def _count_fault(self, point: str) -> None:
        if self.logger is not None:
            self.logger.warn(f"fault injection: {point} fired on {self.label}")

    def _poison_fault(self) -> bool:
        """Poison-payload seam (each scheduler pass): a ``device_step`` spec
        armed with a tag kills the engine when a resident request carries
        that tag. One dict lookup while nothing tagged is armed."""
        if not self.faults.has_tagged("device_step"):
            return False
        with self._lock:
            resident = [r for r in self._slot_req if r is not None] + list(self._prefilling)
        for r in resident:
            if r.tag and self.faults.take("device_step", self.label, tag=r.tag):
                self._count_fault("device_step")
                self._die(f"poison payload: device_step fired for tagged request (tag={r.tag!r})")
                return True
        return False

    def _numeric_trip(self, where: str) -> None:
        """Non-finite logits reached a fetched token array: the engine dies
        with a classifiable reason, and a fleet fails its requests over."""
        self.numerical_trips += 1
        self._die(f"numerical watchdog: non-finite logits ({where})")

    def _numeric_check_fetch(self, arr: np.ndarray, cols: list[int], where: str) -> tuple[np.ndarray, bool]:
        """The collector's sentinel scan over one fetched array's lanes of
        live requests ``cols`` (last axis), before any emission; also the
        ``nan_logits`` seam, which writes -1 over the first live lane.
        Returns (array, tripped); after a trip the caller emits nothing."""
        if not cols:
            return arr, False
        if self.faults.take("nan_logits", self.label) is not None:
            self._count_fault("nan_logits")
            arr = np.array(arr)
            arr[..., cols[0]] = -1
        if self.numeric_check and bool((arr[..., cols] == -1).any()):
            self._numeric_trip(where)
            return arr, True
        return arr, False

    def _die(self, why: str, lock_timeout: float | None = None) -> None:
        """Terminal failure (JAX ``_die``): mark the engine dead, dump the
        incident bundle of its class (``flightrec.classify_die_reason``)
        before anything moves, hand every recoverable request to
        ``failover_hook`` when one is set, end every other stream
        "cancelled", zero the goodput and anomaly gauges, then free the
        device state once the engine stream has run what was queued on it.
        Idempotent; the flight-record ring outlives the death.

        ``lock_timeout`` (the watchdog's) bounds the wait for the lock a
        hung call may hold: without the lock the engine is only marked dead
        and its memory is kept; with it, the stream is never waited on, and
        the memory is kept until an event recorded behind the stream's last
        program has passed (``_release_device``). No dispatch follows:
        ``_launch`` refuses once the engine stops."""
        with self._die_guard:
            if self._died:
                return
            self._died = True
        self._stop = True
        self.died_reason = why
        self._fail_sched_work()  # a handoff waiting on this engine fails now
        if self.logger is not None:
            self.logger.error(f"LLM engine {self.label} died: {why}")
        # the black-box bundle FIRST, while the corpse is warm: the rescue
        # and the drain below empty the very state it captures (JAX
        # llm.py:7018-7030); the reason's prefix classifies the trigger
        self._incident(
            classify_die_reason(why), reason=why,
            lock_timeout=2.0 if lock_timeout is None else min(2.0, lock_timeout),
        )
        acquired = self._lock.acquire() if lock_timeout is None else self._lock.acquire(timeout=lock_timeout)
        rescued: list[GenRequest] = []
        done = None
        if acquired:
            try:
                if self.failover_hook is not None:
                    rescued = self._extract_recoverable()
                try:
                    self._recover_all()
                except Exception:  # noqa: BLE001 — dying must not re-raise
                    pass
                self._drain_pending()
                if self.device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record(self._stream)
            finally:
                self._lock.release()
        elif self.logger is not None:
            self.logger.error("LLM engine lock wedged while dying; marked dead without drain")
        if self.ledger is not None:
            self.ledger.set_active(self._shard, set())
        self._zero_gauges()
        self._kick.set()
        if acquired:
            with self._work_cv:
                self._work_cv.notify_all()
        if rescued:
            # outside the lock: the hook submits into other engines; before
            # the release, which may wait for this engine's stream
            try:
                self.failover_hook(rescued)
            except Exception as e:  # noqa: BLE001 — a rescue must end every stream
                if self.logger is not None:
                    self.logger.error(f"failover hook failed: {e!r}")
                for r in rescued:
                    if r.finish_reason == "failover":
                        r.finish_reason = "error"
                        r.out.put(None)
        self._release_device(done, wait=acquired and lock_timeout is None)

    def _release_device(self, done, wait: bool) -> None:
        """Free a dead engine's graphs once its stream has passed ``done``;
        its other tensors go with the engine object. ``wait`` synchronizes
        on the event; otherwise a stream still running (or never reached:
        ``done`` None) keeps the engine referenced in ``_UNRELEASED``, and
        each later death or close lets go of those whose event has passed."""
        if self.device.type != "cuda":
            return
        _UNRELEASED[:] = [(e, x) for e, x in _UNRELEASED if e is None or not e.query()]
        if done is not None and (wait or done.query()):
            done.synchronize()
            self.families.clear()
        else:
            _UNRELEASED.append((done, self))

    def _extract_recoverable(self) -> list[GenRequest]:
        """Every request a live replica could finish — slotted,
        prefilling, carried by a program in flight, waiting or still in the
        submit queue — marked "failover" (the die paths walk past it), in
        submit order. Those in flight at the death count one more death.
        Lock held."""
        rescued: dict[int, GenRequest] = {}
        inflight_ids: set[int] = set()

        def take(r: GenRequest | None, inflight: bool = False) -> None:
            if r is not None and r.finish_reason is None and not r.cancelled:
                rescued[r.id] = r
                if inflight:
                    inflight_ids.add(r.id)

        for r in self._slot_req:
            take(r, inflight=True)
        for e in list(self._inflight) + [e for e in (self._processing,) if e is not None]:
            for r in self._entry_requests(e):
                take(r, inflight=True)
        for r in self._prefilling:
            take(r, inflight=True)
        for r in self._waiting:
            take(r)
        while True:
            try:
                r = self._admit_q.get_nowait()
            except queue.Empty:
                break
            if r.finish_reason is None and not r.cancelled:
                take(r)
            elif r.finish_reason is None:
                self._finish(r, r.cancel_reason)
        self._waiting = deque(r for r in self._waiting if r.id not in rescued)
        out = [rescued[i] for i in sorted(rescued)]
        for r in out:
            r.finish_reason = "failover"
            if r.id in inflight_ids:
                r.deaths += 1
        return out

    def _recover_all(self) -> None:
        """Full-stop recovery in one critical section (JAX ``_recover_all``
        with ``_abort_all``): end every request in a program in flight or
        in a slot "cancelled" (the slots and their blocks are free), drop
        the programs in flight (their tokens are never fetched) and reset
        the slots' device state behind them on the engine stream. Waiting
        requests stay queued."""
        with self._lock:
            entries = list(self._inflight) + [e for e in (self._processing,) if e is not None]
            orphans = [r for e in entries for r in self._entry_requests(e)]
            orphans += [r for r in self._slot_req if r is not None]
            self._inflight.clear()
            self._processing = None
            self._prefilling.clear()
            self._fetch_fail_streak = 0
            for r in orphans:
                if r.finish_reason is None:
                    self._finish(r, "cancelled")
            self._slot_req[:] = [None] * self.slots
            on_card = torch.cuda.stream(self._stream) if self.device.type == "cuda" else contextlib.nullcontext()
            with on_card:
                self._tail.zero_()
                self._active.fill_(False)
                self._temps.zero_()

    def _drain_pending(self) -> None:
        """End every waiting or queued request "cancelled" (``_die``)."""
        with self._lock:
            waiting, self._waiting = list(self._waiting), deque()
            while True:
                try:
                    waiting.append(self._admit_q.get_nowait())
                except queue.Empty:
                    break
            for r in waiting:
                if r.finish_reason is None:
                    self._finish(r, "cancelled")

    def _close_unreachable(self, failed: tuple) -> None:
        """A failed fetch loses its program's tokens (JAX
        ``_close_unreachable``): a request it carried that holds no slot
        (virtually freed) and whose surviving programs in flight cannot
        finish it would never end — end those "cancelled". Slotted ones get
        make-up chunks, with a gap in their stream where the lost tokens
        were."""
        with self._lock:
            self._processing = None
            lost = set(self._entry_requests(failed)) - {r for r in self._slot_req if r is not None}
            if not lost:
                return
            cover: dict = {}
            for e in self._inflight:
                if e[0] in ("prefill", "verify"):  # one token each (a verify's guaranteed one)
                    for r in self._entry_requests(e):
                        cover[r] = cover.get(r, 0) + 1
                    continue
                fin = {r for _j, _s, r in e[2]} if e[0] == "step" else set()
                k = e[5] if e[0] == "step" else e[3]
                for r in fin:
                    cover[r] = cover.get(r, 0) + k + 1
                for r in e[4] if e[0] == "step" else e[2]:
                    if r is not None and r not in fin:
                        cover[r] = cover.get(r, 0) + k
            for r in lost:
                if r.finish_reason is None and r.emitted + cover.get(r, 0) < r.max_new_tokens:
                    self._finish(r, "cancelled")

    def _finish(self, r: GenRequest, reason: str) -> None:
        """Terminal bookkeeping: return the slot and its blocks when ``r``
        still owns them, then end the stream. That is safe with ``r``'s
        programs still in flight: they run before any program dispatched
        later (one stream), so a new owner's writes to a reused block land
        after theirs, and a new owner reads only rows it wrote. The tables
        they read are rewritten only by a later dispatch's copy, which
        runs after them. With sharing on, a session turn that ended by eos
        or length keeps its blocks until the scheduler has published it
        (``_kv_session_flush``; ``_kv_sweep`` frees them after)."""
        with self._lock:
            r.finish_reason = reason
            self.finished += 1
            self._load_tokens -= r._load_acct  # the residue a cut leaves
            r._load_acct = 0
            self.deadline_cancels += reason == "deadline"
            self.disconnect_cancels += reason == "disconnect"
            self.errored += reason in ("error", "poison")
            if 0 <= r._g_id < len(self._g_refs):
                # the resident grammar becomes evictable once no live
                # request holds it
                self._g_refs[r._g_id] = max(0, self._g_refs[r._g_id] - 1)
                r._g_id = -1
            slot = r.slot
            if slot is not None and self._slot_req[slot] is r:
                self._slot_req[slot] = None
            if slot is not None and self.kv.paged and self.kv.slot_owner(slot) is r:
                if self.kv.share and r.session_id and r._aid == 0 and reason in ("eos", "length"):
                    self._session_pub.append((slot, r))
                else:
                    self.kv.release_slot(slot, r)
                    self._kv_hi[slot] = 0
            # the adapter's gid becomes evictable (or a zombie drains);
            # programs in flight that name it run before any later load's
            # rows on the engine stream
            self._lora_release(r)
            # the flight record, the detectors and the wide event, before
            # the consumer wakes (JAX llm.py:5548-5660)
            self._observe_finish(r, time.perf_counter())
            r.out.put(None)

    def _drain_submits(self) -> None:
        """Move submitted requests to the waiting queue, stamping their
        arrival order (``_order_waiting``'s last key)."""
        while True:
            try:
                r = self._admit_q.get_nowait()
            except queue.Empty:
                return
            self._arrivals += 1
            r._seq = self._arrivals
            self._waiting.append(r)

    def _expire_deadlines(self, now: float) -> None:
        """Retire every request, waiting or slotted, that was cancelled or
        whose deadline has passed (JAX ``LLMEngine._expire_deadlines``):
        its stream ends at once and its slot is free for the next
        admission; tokens of its programs still in flight are dropped.
        A waiting request past ``ttft_deadline_ms`` is shed first (finish
        reason "shed", JAX llm.py:4075-4091): its first token can no longer
        arrive in time, so it takes no slot. Runs once per scheduler pass:
        O(slots + waiting), no device work."""
        ttft = self.ttft_deadline

        def reason(r: GenRequest, waiting: bool = False) -> str | None:
            if waiting and ttft is not None and r.submitted_at is not None and now - r.submitted_at > ttft:
                return "shed"
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
                if (why := reason(r, waiting=True)) is not None:
                    self.shed += why == "shed"
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
            if e[0] in ("prefill", "verify"):
                # a hit group carries each request's first token; a
                # verify's yield depends on the data (1 to W tokens), so
                # it counts its guaranteed ONE: more could virtually free
                # a slot on tokens that never arrive
                for slot, r in e[2]:
                    if r is not None and r is self._slot_req[slot]:
                        steps[slot] = steps.get(slot, 0) + 1
                continue
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
        """Admission, once per scheduler pass (JAX ``_admit``): the
        chunked scheduler's immediate slot assignment, or the wave's
        batched whole-prompt prefill."""
        return self._admit_chunked() if self.chunked else self._admit_wave()

    def _admit_chunked(self) -> bool:
        """Give waiting requests free (or virtually free) slots (JAX
        ``_admit_chunked``): first take batch slots back for interactive
        requests that find none (``_preempt_for_waiting``), then pull as
        many requests as there are such slots in the queue's order
        (``_order_waiting``). On the paged pool, for each: touch its
        session (restoring a spilled one), consult the radix and reserve
        its blocks net of the shared prefix (and of the tokens a
        continuation already streamed, which its prompt now holds); a
        request the pool cannot host goes back to the head of the queue,
        in order, while the others go ahead. On the contiguous layouts
        with a prefix cache, ``lookup_longest`` (partial hits on the slab
        only: a ring entry is laid out for its own length). Constrained and
        adapted requests skip the lookup. Exact hits are dispatched at once
        (``_admit_exact_hits``); partial hits start their prefill cursor at
        the shared prefix (a contiguous one after its entry's rows are
        inserted); misses at 0. Every path releases the pins. Returns
        whether any request was admitted."""
        with self._work_cv:
            free = self._free_slots()
            if self._waiting:
                free = self._preempt_for_waiting(free)
            if not self._waiting or not free:
                return False
            self._fault("admission_oom")  # chaos seam: nothing pulled yet
            pulled = [self._waiting.popleft() for _ in range(min(len(free), len(self._waiting)))]
            hits: list[GenRequest] = []
            partials: list[GenRequest] = []
            rest: list[GenRequest] = []
            try:
                blocked: list[GenRequest] = []
                for r in pulled:
                    if r.session_id:
                        self._session_prepare(r.session_id)
                    # a constrained request forces a miss (JAX
                    # llm.py:5168-5176, 5201-5205): an exact hit admits
                    # through the hit program, which the grammar mask does
                    # not ride. So does an adapted one: stored rows hold
                    # K/V computed under the base wq/wkv, not its deltas
                    base = r.grammar is None and r._aid == 0
                    if not self.kv.paged:  # a contiguous slot holds its whole capacity
                        e, exact = None, False
                        if self.kv.prefix is not None and base:
                            e, exact = self.kv.prefix.lookup_longest(
                                r.prompt_tokens, allow_partial=not self.kv.rolling
                            )
                        r._prefix_entry = e
                        (rest if e is None else hits if exact else partials).append(r)
                        continue
                    plan = self.kv.lookup_seed(r.prompt_tokens) if self.kv.share and base else None
                    if not self._kv_reserve(r, plan):
                        blocked.append(r)
                        continue
                    (rest if plan is None else hits if plan.exact else partials).append(r)
                self._waiting.extendleft(reversed(blocked))
                try:
                    self._admit_exact_hits(hits, free)
                    for r in partials:
                        plan, e = r._kv_plan, r._prefix_entry
                        self._assign_slot(r, free.pop(0))
                        self._kv_attach(r, r.slot, plan)
                        if e is not None:
                            # the entry's rows seed the slot; the prompt's
                            # chunks from its length on run through steps
                            self._insert_rows(r.slot, e)
                        shared = plan.shared if plan is not None else e.length
                        r.prefix_hit = True
                        r.prefill_pos = r._rows_hi = shared
                        self._load_credit(r, shared)
                        self._prefilling.append(r)
                finally:
                    for r in hits + partials:
                        self._kv_release_plan(r)
                for r in rest:
                    self._assign_slot(r, free.pop(0))
                    self._kv_attach(r, r.slot, None)
                    self._prefilling.append(r)
            except BaseException:
                self._requeue_stranded(pulled)
                raise
            return bool(hits or partials or rest)

    def _admit_wave(self) -> bool:
        """The wave scheduler's admission (JAX ``_admit_wave``): after the
        preemption of batch slots for interactive requests, pull waiting
        requests into (virtually) free slots and prefill each whole prompt
        in one program per bucket (``_admit_waves``). While anything
        decodes and requests arrive fast enough to fill a wave of 4 or
        more within ``admit_delay`` (the inter-arrival EMA), a partial
        wave whose oldest request is younger than that waits for the rest;
        an idle engine admits at once. Exact prefix hits skip prefill:
        on the pool the radix's exact end records (no partial: the wave
        has no mid-prompt append), with the block reservation that queues
        what the pool cannot host yet, and no session restore; on the
        contiguous layouts ``PrefixCache.lookup``. Every pin is released,
        and an escaping error puts the pulled requests that hold no slot
        back at the head of the queue. Returns whether any was admitted."""
        with self._work_cv:
            free = self._free_slots()
            busy = any(r is not None for r in self._slot_req) or bool(self._inflight) or self._processing is not None
            if self._waiting:
                free = self._preempt_for_waiting(free)
            if not self._waiting or not free:
                return False
            gap = self._ema_gap
            goal = min(self.admit_cap, int(self.admit_delay / gap if gap and gap > 0 else 0.0))
            head = self._waiting[0]
            if (
                self.admit_delay > 0 and busy and goal >= 4 and len(self._waiting) < min(goal, len(free))
                and head.submitted_at is not None and time.perf_counter() - head.submitted_at < self.admit_delay
            ):
                return False
            self._fault("admission_oom")  # chaos seam: nothing pulled yet
            pulled = [self._waiting.popleft() for _ in range(min(len(free), len(self._waiting)))]
            hits: list[GenRequest] = []
            misses: list[GenRequest] = []
            try:
                blocked: list[GenRequest] = []
                for r in pulled:
                    if not self.kv.paged:
                        e = None
                        if self.kv.prefix is not None:
                            e = self.kv.prefix.lookup(self.kv.prefix.key_for(r.prompt_tokens))
                        r._prefix_entry = e
                        (misses if e is None else hits).append(r)
                        continue
                    plan = self.kv.lookup_seed(r.prompt_tokens, allow_partial=False) if self.kv.share else None
                    if not self._kv_reserve(r, plan):
                        blocked.append(r)
                        continue
                    (misses if plan is None else hits).append(r)
                self._waiting.extendleft(reversed(blocked))
                try:
                    self._admit_exact_hits(hits, free)
                finally:
                    for r in hits:
                        self._kv_release_plan(r)
                self._admit_waves(misses, free)
            except BaseException:
                self._requeue_stranded(pulled)
                raise
            return bool(hits or misses)

    def _admit_waves(self, misses: list[GenRequest], free: list[int]) -> None:
        """Prefill the misses (JAX ``_admit_waves``): grouped by bucket
        (``_bucket_for``), admit_cap at a time, one ``llm.prefill`` program
        a wave (``_dispatch_wave``). Lock held."""
        by_bucket: dict[int, list[GenRequest]] = {}
        for r in misses:
            by_bucket.setdefault(self._bucket_for(len(r.prompt_tokens)), []).append(r)
        for bucket, reqs in by_bucket.items():
            for i in range(0, len(reqs), self.admit_cap):
                self._dispatch_wave(bucket, reqs[i : i + self.admit_cap], free)

    def _dispatch_wave(self, bucket: int, reqs: list[GenRequest], free: list[int]) -> None:
        """One prefill wave (JAX ``_admit_waves``' body and ``_slot_in``):
        the requests take slots (on the pool, their tables and the blocks
        of their prompt rows), one pack of right-padded prompts is staged
        (a step pack: tokens | cursor 0 | length | temperature bits; pad
        rows are one token long, and pad lanes of the meta repeat lane 0),
        and ``llm.prefill_b{bucket}.w{nb}`` prefills them, writes their rows
        into their slots, samples the first tokens and activates the slots.
        The group becomes one "prefill" entry. With a prefix index each
        fresh row is then stored: on the contiguous layouts its rows
        trimmed to the bucket (``PrefixCache.put`` clones them from the
        program's output), on the pool published into the radix from the
        slot's blocks, after the insert. Lock held."""
        nb = self._wave_width(len(reqs))
        pack = np.zeros((nb, bucket + 3), np.int32)
        pack[:, bucket + 1] = 1  # pad rows: one token, discarded
        meta = np.zeros((2, nb), np.int32)
        taken: list[tuple[int, GenRequest]] = []
        prompt_tokens = 0
        for j, r in enumerate(reqs):
            n = len(r.prompt_tokens)
            pack[j, :n] = r.prompt_tokens
            pack[j, bucket + 1] = n
            pack[j, bucket + 2] = np.float32(r.temperature).view(np.int32)
            self._assign_slot(r, free.pop(0))
            slot = r.slot
            self._kv_attach(r, slot, None)
            self._grow(slot, r, n)  # the blocks the insert writes (pool only)
            taken.append((slot, r))
            r.prefill_pos = r._rows_hi = n
            r.prefill_done = True
            self._load_credit(r, n)
            meta[0, j], meta[1, j] = slot, j
            prompt_tokens += n
        meta[:, len(reqs) :] = meta[:, :1]
        name = self._prefill_name(bucket, nb)
        self._ensure_family(name)
        self._stage(False, self._host_tables(), np.zeros((self.slots,), bool), meta, pack)
        t0 = time.perf_counter()
        first, logits, rows = self._launch(name)
        self._inflight.append(("prefill", _Fetch(first, prompt_tokens, t0, gp=("wave", bucket)), taken, nb))
        self.waves[nb] = self.waves.get(nb, 0) + 1
        self.wave_reqs += len(reqs)
        self.prefill_tokens += prompt_tokens
        if self.kv.prefix is not None:
            keep = min(bucket, self.kv.capacity)
            for j, r in enumerate(reqs):
                self.kv.prefix.put(
                    self.kv.prefix.key_for(r.prompt_tokens), rows[0][:, j : j + 1, :keep],
                    rows[1][:, j : j + 1, :keep], len(r.prompt_tokens), logits[j : j + 1],
                )
        elif logits is not None:  # the pool's radix
            for j, (slot, r) in enumerate(taken):
                self._kv_publish(slot, r, logits[j : j + 1].clone())
        self._work_cv.notify()

    def _assign_slot(self, r: GenRequest, slot: int) -> None:
        """Make ``r`` the slot's occupant and close its queue wait (JAX
        ``_assign_slot`` + ``_observe_admission``): the ledger bills its
        prompt once a lifetime (a continuation's re-prefill is the
        engine's choice, not the client's). Lock held."""
        old = self._slot_req[slot]
        if old is not None and old.cancelled and old.finish_reason is None:
            # cancelled after this pass's sweep: it may have no program in
            # flight left to end its stream (JAX ``_assign_slot``)
            self._finish(old, old.cancel_reason)
        self._slot_req[slot] = r
        r.slot = slot
        r.prefill_pos = 0
        r.prefill_done = False
        r.admitted_at = time.perf_counter()
        if self.ledger is not None and not r._prompt_billed:
            r._prompt_billed = True
            self.ledger.charge(r.client, len(r.prompt_tokens))

    def _kv_attach(self, r: GenRequest, slot: int, plan) -> dict:
        """Bind the slot's block table to ``r`` and its seed plan (adopting
        the plan's pins); releases a virtually free predecessor's blocks
        (see ``_finish``). A contiguous slot has no table: its rows are
        bounded by max_seq_len (the ring's lengths are absolute)."""
        plen, new = len(r.prompt_tokens), r.max_new_tokens - r.emitted
        if not self.kv.paged:
            r._kv_limit = self.max_seq_len
            r._kv_resv = 0
            return {"copies": [], "seed_len": 0}
        if plan is None:
            self.kv.attach(slot, r, plen, new)
            info = {"copies": [], "seed_len": 0}
        else:
            info = self.kv.attach_seed(slot, plan, r, plen, new)
        r._kv_limit = self.kv.reserve_tokens(plen, new)
        r._kv_resv = 0  # the admission promise is on the slot's books now
        r._kv_plan = None
        self._kv_hi[slot] = info["seed_len"]
        return info

    def _kv_reserve(self, r: GenRequest, plan) -> bool:
        """Hold ``plan`` on ``r`` and promise the pool blocks of its worst
        case net of the plan's shared prefix (and of the tokens a
        continuation already streamed). False, with the plan's pins
        dropped, when the pool cannot host it yet. Lock held."""
        r._kv_plan = plan
        plen, new = len(r.prompt_tokens), r.max_new_tokens - r.emitted
        if not self.kv.admit_reserve(plen, new, plan):
            self._kv_release_plan(r)
            return False
        r._kv_resv = self.kv.reserve_need(plen, new, plan)
        return True

    def _kv_release_plan(self, r: GenRequest) -> None:
        """Drop an unconsumed seed plan's pins, or a prefix entry's pin;
        idempotent (attach clears the plan)."""
        plan, r._kv_plan = r._kv_plan, None
        self.kv.release_plan(plan)
        e, r._prefix_entry = r._prefix_entry, None
        if e is not None:
            self.kv.prefix.release(e)

    def _insert_rows(self, slot: int, e) -> None:
        """Seed a contiguous slot with a prefix entry's rows and length (JAX
        ``assemble`` + ``llm.insert_many`` for one entry): two strided
        copies into the slab or ring and one length write, eager on the
        engine stream, so they run after every program dispatched before
        and before any dispatched after. The slot's rows past the entry's
        stay as they are, beyond its length and never read (JAX's insert
        zero-pads them; a captured insert would need a staging input of
        [L, admit_cap, capacity, hkv, hd]). Lock held."""
        n = e.k.shape[2]
        self.cache.k[:, slot, :n].copy_(e.k[:, 0])
        self.cache.v[:, slot, :n].copy_(e.v[:, 0])
        # fill_, not item assignment: that copies a host scalar and waits
        # for the stream, here behind every program in flight
        self.cache.length[slot : slot + 1].fill_(e.length)

    def _requeue_stranded(self, pulled: list[GenRequest]) -> None:
        """An admission error strands pulled requests that hold no slot:
        put them back at the head of the queue (where ``_drain_pending`` finds
        them) and hand back their block promises and plan pins. Lock held."""
        stranded = [
            r for r in pulled
            if r.finish_reason is None and (r.slot is None or self._slot_req[r.slot] is not r)
            and r not in self._waiting
        ]
        self._waiting.extendleft(reversed(stranded))
        for r in stranded:
            self.kv.unreserve(r._kv_resv)
            r._kv_resv = 0
            self._kv_release_plan(r)

    def _admit_exact_hits(self, hits: list[GenRequest], free: list[int]) -> None:
        """Exact hits (JAX ``_admit_exact_hits`` and its paged twin, both
        schedulers), admit_cap at a time: no prefill runs. On the pool each
        slot's table points at the shared blocks and ``llm.kv_seed`` copies
        the stored sub-block tail into the slot's first private block and
        sets its length; on the contiguous layouts the entry's rows are
        inserted (``_insert_rows``). The hit program samples each first
        token from the stored last-token logits (staged by a device copy)
        at the request's temperature and activates the slot with it. The
        group becomes one "prefill" entry that carries only first tokens.
        The caller releases the pins. Lock held."""
        M = self.admit_cap
        for i in range(0, len(hits), M):
            group = hits[i : i + M]
            nb = self._wave_width(len(group))
            seed = self._inert_seed()
            taken: list[tuple[int, GenRequest]] = []
            for j, r in enumerate(group):
                plan, e = r._kv_plan, r._prefix_entry
                self._assign_slot(r, free.pop(0))
                slot = r.slot
                info = self._kv_attach(r, slot, plan)
                taken.append((slot, r))
                r.prefix_hit = True
                r.prefill_pos = r._rows_hi = len(r.prompt_tokens)
                r.prefill_done = True
                self._load_credit(r, len(r.prompt_tokens))
                if e is not None:
                    self._insert_rows(slot, e)
                for src, dst in info["copies"]:
                    seed[0, j], seed[1, j] = src, dst
                seed[2, j], seed[3, j] = slot, info["seed_len"]
                seed[4, j], seed[5, j] = slot, j
                seed[6, j] = np.float32(r.temperature).view(np.int32)
                self._hit_logits[j].copy_((e.logits if e is not None else plan.logits)[0])
            name = f"llm.hit_first.w{nb}"
            if self.kv.paged:
                self._ensure_family("llm.kv_seed")
            self._ensure_family(name)  # a capture stages inputs of its own: before ours
            self._in.write_seed(seed)
            if self.kv.paged:
                self._launch("llm.kv_seed")
            fetch = _Fetch(self._launch(name))
            self._inflight.append(("prefill", fetch, taken, nb))
            self._work_cv.notify()

    def _inert_seed(self) -> np.ndarray:
        """[7, admit_cap] seed inputs whose every lane writes nothing:
        destination blocks and slots out of range."""
        seed = np.zeros((7, self.admit_cap), np.int32)
        seed[0:2] = self.kv.pool.n_blocks if self.kv.paged else 0
        seed[2] = seed[4] = self.slots
        return seed

    # -- overload control (JAX llm.py:792-858, 3456-3505, 4130-4307) ---------
    def _init_overload(
        self, max_queue, ttft_deadline_ms, fair_queuing, fair_weights, fair_ledger, preemption,
        shed_predicted_wait_s, brownout_wait_s, brownout_max_new, brownout_hold_s,
    ) -> None:
        """The overload kwargs with the JAX engine's env fallbacks and
        defaults; fair queuing and preemption are on unless their knob is
        "0", shedding and brownout off unless configured."""
        env = os.environ.get
        self.max_queue = max_queue
        self.ttft_deadline = ttft_deadline_ms / 1000.0 if ttft_deadline_ms else None
        if fair_queuing is None:
            fair_queuing = env("TPU_LLM_FAIR", "1") != "0"
        self.ledger = (fair_ledger if fair_ledger is not None else FairLedger(fair_weights)) if fair_queuing else None
        if preemption is None:
            preemption = env("TPU_LLM_PREEMPT", "1") != "0"
        self.preemption = bool(preemption)
        if shed_predicted_wait_s is None:
            shed_predicted_wait_s = float(env("TPU_LLM_SHED_WAIT_S", "0") or 0.0)
        if brownout_wait_s is None:
            brownout_wait_s = float(env("TPU_LLM_BROWNOUT_WAIT_S", "0") or 0.0)
        if brownout_max_new is None:
            brownout_max_new = int(env("TPU_LLM_BROWNOUT_MAX_NEW", "0") or 0)
        if brownout_hold_s is None:
            brownout_hold_s = float(env("TPU_LLM_BROWNOUT_HOLD_S", "2.0") or 0.0)
        self.overload = OverloadController(
            shed_wait_s=shed_predicted_wait_s, brownout_wait_s=brownout_wait_s,
            brownout_max_new=brownout_max_new, brownout_hold_s=brownout_hold_s,
        )
        self._shard = f"llm-torch-{id(self):x}"  # this engine's waiting set in the ledger
        self.rejected = 0  # max_queue rejects
        self.shed = 0  # waiting requests shed past ttft_deadline_ms
        self.sheds_predicted = 0  # predicted-wait rejects
        self.brownout_clamped = 0  # batch requests clamped under brownout
        self.preemptions = 0  # batch slots taken back for interactive work
        self._load_tokens = 0  # outstanding-work estimate (load_tokens)
        self._arrivals = 0  # requests drained from the submit queue
        self._tput_ema: float | None = None  # measured tokens/s (EMA)

    def load_tokens(self) -> int:
        """The device work still owed to every live request, in tokens:
        submit adds prompt + remaining decode, prefill chunks, radix hits
        and emitted tokens credit it back, a finish flushes the residue."""
        return max(0, self._load_tokens)

    def predicted_wait_s(self) -> float | None:
        """Predicted queue wait of a new request: ``load_tokens`` over the
        measured throughput; None until the first program has been
        measured (no pressure: a cold engine never sheds). At lookahead 3
        the measured windows overlap, so the throughput reads low and the
        wait high, as in the JAX engine."""
        tput = self._tput_ema
        if not tput or tput <= 1e-9:
            return None
        return self.load_tokens() / tput

    def throughput_tok_s(self) -> float | None:
        """Measured serving throughput (the EMA; None before the first
        program)."""
        return self._tput_ema

    def _observe_tput(self, tokens: int, dt: float) -> None:
        """Fold one program's tokens over its dispatch-to-fetch seconds
        into the throughput EMA."""
        if tokens <= 0 or dt <= 0:
            return
        rate = tokens / dt
        ema = self._tput_ema
        self._tput_ema = rate if ema is None else 0.8 * ema + 0.2 * rate

    def _load_credit(self, r: GenRequest, n: int) -> None:
        """Retire ``n`` tokens of ``r``'s outstanding work (at most what it
        still owes). Lock held."""
        n = min(n, r._load_acct)
        if n > 0:
            r._load_acct -= n
            self._load_tokens -= n

    def _order_waiting(self) -> None:
        """Order the waiting queue (JAX ``_order_waiting``): interactive
        first, then the least weighted-served client (the ledger's
        counter), then arrival order at the scheduler. Also refreshes the ledger's
        waiting-client set, which anchors the new-arrival floor. With
        fair queuing off: class, then FIFO.

        Arrival order is the order the scheduler drained the submits in
        (``_seq``); the JAX engine breaks the tie by ``GenRequest.id``,
        the order the requests were made. The two agree when a caller
        submits requests in the order it makes them; concurrent clients
        make and submit in different orders, and the arrival order keeps
        one client's traffic in the FIFO order the port served before
        overload control (ROADMAP queue 3 item 9). ``GenRequest.id`` stays
        as the last key for requests that reach ``_waiting`` without the
        drain, which stamps no ``_seq`` (they all share 0)."""
        led = self.ledger
        with self._lock:
            clients = {r.client for r in self._waiting}
            if led is not None:
                led.set_active(self._shard, clients)
            if len(self._waiting) < 2:
                return
            counters = led.counters_for(clients) if led is not None else {}
            self._waiting = deque(sorted(
                self._waiting, key=lambda r: (r.priority == "batch", counters.get(r.client, 0.0), r._seq, r.id)
            ))

    def _preempt_for_waiting(self, free: list[int]) -> list[int]:
        """When waiting interactive requests outnumber the free slots, take
        slots back from batch-class occupants, the most recently admitted
        first (the least progress to redo), at most ``_PREEMPT_CAP`` times
        a request (JAX ``_preempt_for_waiting``). An occupant whose slot is
        already free (virtually: its programs in flight cover its
        remaining tokens) is no victim: its slot is counted in ``free``.
        Returns the free slots again. Lock held."""
        if not self.preemption:
            return free
        want = sum(1 for r in self._waiting if r.priority != "batch" and r.finish_reason is None) - len(free)
        if want <= 0:
            return free
        victims = [
            r for i, r in enumerate(self._slot_req)
            if r is not None and i not in free and r.priority == "batch" and not r.cancelled
            and r.finish_reason is None and r.preempted < self._PREEMPT_CAP
        ]
        if not victims:
            return free
        victims.sort(key=lambda r: r.admitted_at or 0.0, reverse=True)
        for r in victims[:want]:
            self._preempt(r)
        return self._free_slots()

    def _preempt(self, r: GenRequest) -> None:
        """Take ``r``'s slot back now (JAX ``_preempt``) without ending its
        stream. The slot and its blocks are free at once (shared prefix
        blocks are decref'd): ``r``'s programs in flight still write them,
        but they run before any later owner's on the one engine stream
        (the argument of ``_finish``), and no later dispatch has ``r``'s
        lane live. ``r`` is scrubbed from every program in flight, so none
        of their tokens reach it; its emitted tokens fold into its prompt
        and it re-queues as a continuation that re-prefills through the
        unified step and resumes where its stream stands, with its grammar
        reference and DFA state (the step starts a constrained row at
        ``_g_state``) and its adapter's gid. The tokens computed but not
        emitted are computed again. Lock held, scheduler thread."""
        slot = r.slot
        if slot is not None and self._slot_req[slot] is r:
            self._slot_req[slot] = None
            if self.kv.paged and self.kv.slot_owner(slot) is r:
                self.kv.release_slot(slot, r)
                self._kv_hi[slot] = 0
        r.slot = None
        for e in list(self._inflight) + [e for e in (self._processing,) if e is not None]:
            if e[0] == "prefill":  # blank: the collector indexes tokens by row
                e[2][:] = [(s, None if x is r else x) for s, x in e[2]]
            elif e[0] == "verify":
                e[2][:] = [(s, x) for s, x in e[2] if x is not r]
            else:
                if e[0] == "step":
                    e[2][:] = [f for f in e[2] if f[2] is not r]
                snapshot = e[4] if e[0] == "step" else e[2]
                for i, x in enumerate(snapshot):
                    if x is r:
                        snapshot[i] = None
        if r in self._prefilling:
            self._prefilling.remove(r)
        # the goodput ledger's replay marker (JAX llm.py:4242-4251): what the
        # continuation re-prefills below it was computed once already — the
        # chunks dispatched if nothing streamed yet, else the whole grown
        # prompt (the streamed tokens re-enter as prompt rows)
        replay_to = r.prefill_pos
        if r.history:
            r.prompt_tokens = list(r.prompt_tokens) + r.history
            r.history = []
            replay_to = len(r.prompt_tokens)
        r._replay_pos = max(r._replay_pos, replay_to)
        r.prefill_pos = r._rows_hi = 0
        r.prefill_done = False
        r._spec_pending = []
        r._spec_inflight = 0
        r.preempted += 1
        r.submitted_at = time.perf_counter()  # a fresh queue wait
        self._load_tokens -= r._load_acct
        r._load_acct = len(r.prompt_tokens) + max(0, r.max_new_tokens - r.emitted)
        self._load_tokens += r._load_acct
        self._waiting.append(r)
        if self.ledger is not None:
            self.ledger.touch(r.client)
        self.preemptions += 1

    # -- paged-pool housekeeping (scheduler thread) -------------------------
    def _kv_publish(self, slot: int, r: GenRequest, logits=None, *, session: bool = False) -> None:
        """Publish a slot's resident rows into the radix: full blocks
        shared in place, the sub-block tail copied into a radix-owned block
        (``llm.kv_seed``), ``logits`` ([1, vocab], a clone the caller made)
        kept for exact hits. ``session=True`` publishes the conversation
        (prompt + emitted tokens but the last, whose row is not written)
        and pins it to the session id. An adapted request publishes nothing:
        its rows were computed under its adapter's deltas, and sharing them
        would seed other tenants (or the base) with them (JAX llm.py:4784).
        Lock held."""
        if r._aid != 0:
            return
        tokens = r.prompt_tokens + (r.history[:-1] if session else [])
        plan = self.kv.publish_plan(slot, tokens, want_tail=True)
        if plan is None:
            return
        if plan["tail_dst"] >= 0:
            seed = self._inert_seed()
            seed[0, 0], seed[1, 0] = plan["tail_src"], plan["tail_dst"]
            self._ensure_family("llm.kv_seed")
            self._in.write_seed(seed)
            self._launch("llm.kv_seed")
        self.kv.publish_commit(
            plan, tokens, logits=logits,
            logits_nbytes=0 if logits is None else logits.numel() * logits.element_size(),
            session_id=r.session_id if session else None,
        )

    def _kv_session_flush(self) -> None:
        """Publish the session turns the collector deferred. Slot ownership
        is re-checked: a slot reassigned meanwhile skips the publish (the
        session goes cold, never corrupt)."""
        with self._work_cv:
            while self._session_pub:
                slot, r = self._session_pub.popleft()
                if self.kv.slot_owner(slot) is r and not r._session_published:
                    self._kv_publish(slot, r, session=True)
                r._session_published = True

    def _kv_sweep(self) -> None:
        """Return retired occupants' blocks to the pool; a finished session
        turn still awaiting its publish keeps them one more pass."""
        with self._work_cv:
            for i in range(self.slots):
                r = self.kv.slot_owner(i)
                if not isinstance(r, GenRequest) or r.finish_reason is None:
                    continue
                if r.session_id and not r._session_published and r.finish_reason in ("eos", "length"):
                    continue
                cur = self._slot_req[i]
                if cur is None or cur is r:
                    self.kv.release_slot(i, r)
                    self._kv_hi[i] = 0
            if self._restoring:  # drop host payloads whose copies have run
                self._restoring = [x for x in self._restoring if not x[0].query()]

    def _kv_session_spill(self) -> None:
        """Spill the coldest sessions past the device budget to host memory
        (``_kv_spill`` each)."""
        for s in self.kv.spill_candidates():
            self._kv_spill(s.id)

    def _kv_spill(self, sid: str) -> None:
        """Fetch one resident session's blocks to host memory (on the
        engine stream, complete before the payload is stored) and release
        its device blocks."""
        with self._work_cv:
            path = self.kv.session_path(sid)
            if path is None:
                return
            blocks = path["blocks"] + ([path["tail"]] if path["tail"] >= 0 else [])
            if not blocks:
                return
            k, v, sc = gather_blocks_host(self.pool.k, self.pool.v, blocks, scales=self.pool_scales)
            payload = {"tokens": path["tokens"], "k": k, "v": v, "sc": sc,
                       "n_full": len(path["blocks"]), "tail_len": path["tail_len"]}
            nbytes = sum(t.numel() * t.element_size() for t in (k, v, sc) if t is not None)
            self.kv.spill_commit(sid, payload, nbytes)

    def _session_prepare(self, sid: str) -> None:
        """A turn's session touch before its radix consult: a spilled
        conversation is restored into fresh pool blocks and re-inserted in
        the radix, so the turn block-shares its whole history. A pool too
        tight to restore forgets the session (full re-prefill, never an
        error). Lock held."""
        if self.kv.session_touch(sid) != "spilled":
            return
        payload = self.kv.restore_fetch(sid)
        if payload is None:
            return
        n = int(payload["k"].shape[1])
        ids = self.kv.alloc_restore(n)
        if ids is None:
            self.kv.session_forget(sid)
            return
        self._kv_restore_blocks(payload["k"], payload["v"], payload["sc"], ids)
        n_full = int(payload["n_full"])
        self.kv.restore_commit(
            sid, payload["tokens"], ids[:n_full], ids[n_full] if n > n_full else -1, int(payload["tail_len"])
        )

    def _kv_restore_blocks(self, k, v, sc, ids: list[int]) -> None:
        """Copy host block payloads into pool blocks ``ids``, eagerly on the
        engine stream (rare: a cold session's next turn). The pinned
        sources stay referenced until the copies' event has passed."""
        dev = self.device
        idx = torch.tensor(ids, dtype=torch.long).to(dev, non_blocking=True)
        self.pool.k.index_copy_(1, idx, k.to(dev, non_blocking=True))
        self.pool.v.index_copy_(1, idx, v.to(dev, non_blocking=True))
        if sc is not None:
            self.pool_scales.index_copy_(2, idx, sc.to(dev, non_blocking=True))
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            self._restoring.append((done, k, v, sc))

    # -- host work on the scheduler thread (the KV handoff) -----------------
    def _run_sched_work(self) -> None:
        """Run the closures other threads queued for the scheduler thread
        (JAX ``_run_sched_work``). A closure's error lands in its caller's
        box; it never ends the engine loop."""
        while self._sched_work:
            try:
                fn, box = self._sched_work.popleft()
            except IndexError:  # raced _fail_sched_work
                break
            try:
                box["result"] = fn()
            except Exception as e:  # noqa: BLE001 — the caller's error, not the engine's
                box["error"] = e
            finally:
                box["done"].set()

    def _fail_sched_work(self) -> None:
        """End every queued box with ``EngineStoppedError`` (the engine is
        dying or closing), so its caller fails at once."""
        while self._sched_work:
            try:
                _fn, box = self._sched_work.popleft()
            except IndexError:
                break
            box["error"] = EngineStoppedError("engine stopped")
            box["done"].set()

    def _run_on_scheduler(self, fn, timeout: float | None = None):
        """Run ``fn`` on the scheduler thread and return its result (JAX
        ``_run_on_scheduler``); ``TimeoutError`` past ``timeout`` (30 s)."""
        if not self.alive():
            raise EngineStoppedError("engine stopped")
        box: dict = {"done": threading.Event(), "result": None, "error": None}
        self._sched_work.append((fn, box))
        self._kick.set()
        if not self.alive():
            # raced _die/close past the check above: their one-shot drain
            # may have run before our append, so fail the box ourselves
            self._fail_sched_work()
        wait_s = timeout if timeout is not None else 30.0
        if not box["done"].wait(wait_s):
            raise TimeoutError(
                f"scheduler work timed out after {wait_s}s (engine {'alive' if self.alive() else 'dead'})"
            )
        if box["error"] is not None:
            raise box["error"]
        return box["result"]

    def kv_placement(self) -> torch.device:
        """Where this engine's pool lives: the target of a device-to-device
        KV handoff (JAX ``kv_placement``)."""
        return self.device

    def kv_handoff_export(self, prompt_tokens: list[int], *, timeout: float | None = None) -> dict | None:
        """Gather one exact published prompt's KV blocks and its stored
        last-token logits for a prefill-to-decode handoff (JAX
        ``kv_handoff_export``). Returns the payload ``kv_handoff_import``
        takes: ``k``, ``v`` [L, n, B, hkv, d] (the full blocks, then the
        tail's), ``sc`` (an int8 pool's scales [2, L, n, B, hkv], else
        None), ``n_full``, ``tail_len``, ``logits`` [1, vocab], and
        ``ready``, an event recorded on this engine's stream behind the
        gather (None off the card): a consumer on another stream waits on
        it. None when the prompt is not an exact record with logits
        (dropped, evicted, sharing off) or the pool is contiguous. The
        probe counts no hit. Runs on the scheduler thread."""
        if not self.kv.paged or self.kv.radix is None:
            return None

        def work():
            plan = self.kv.lookup_seed(list(prompt_tokens), allow_partial=False, count=False)
            if plan is None or not plan.exact or plan.logits is None:
                self.kv.release_plan(plan)
                return None
            try:
                blocks = list(plan.blocks) + ([plan.tail_src] if plan.tail_src >= 0 else [])
                if not blocks:
                    return None
                idx = torch.tensor(blocks, dtype=torch.long).to(self.device, non_blocking=True)
                payload = {
                    "tokens": list(prompt_tokens),
                    "k": self.pool.k.index_select(1, idx),
                    "v": self.pool.v.index_select(1, idx),
                    "sc": self.pool_scales.index_select(2, idx) if self.kv.int8 else None,
                    "n_full": len(plan.blocks),
                    "tail_len": int(plan.tail_len) if plan.tail_src >= 0 else 0,
                    "logits": plan.logits.clone(),
                    "ready": torch.cuda.Event() if self.device.type == "cuda" else None,
                }
                if payload["ready"] is not None:
                    payload["ready"].record()  # on the scheduler thread's current stream: the engine's
                return payload
            finally:
                self.kv.release_plan(plan)

        return self._run_on_scheduler(work, timeout)

    def kv_handoff_import(self, payload: dict, *, timeout: float | None = None) -> bool:
        """Adopt a peer's exported prompt KV (JAX ``kv_handoff_import``):
        allocate pool blocks, copy the payload in byte for byte
        (``_kv_restore_blocks``, after this engine's stream waited on the
        payload's ``ready`` event), and publish the prompt into the radix
        WITH its logits, so the next admission of that prompt is an exact
        hit that skips prefill. The payload's tensors may be this card's
        (a device copy, recorded on this engine's stream, logits too) or
        pinned host memory (referenced until the copies' event has
        passed). False when the pool cannot
        host it now (the caller submits anyway and the engine
        re-prefills) or the pool is contiguous. Runs on the scheduler
        thread."""
        if not self.kv.paged or self.kv.radix is None:
            return False

        def work():
            k, v, sc = (None if payload.get(x) is None else torch.as_tensor(payload[x]) for x in ("k", "v", "sc"))
            n = int(k.shape[1])
            ids = self.kv.alloc_restore(n)
            if ids is None:
                return False
            try:
                logits = payload.get("logits")
                logits = None if logits is None else torch.as_tensor(logits)
                if self.device.type == "cuda":
                    here = torch.cuda.current_stream(self.device)
                    ready = payload.get("ready")
                    if ready is not None:
                        here.wait_event(ready)
                    # the payload's tensors on this card were made on other
                    # streams (the exporter's, the copy stream) and the reads
                    # queued below may run long after the caller drops the
                    # payload: their memory goes back to the allocator only
                    # once this stream has read it
                    for t in (k, v, sc, logits):
                        if t is not None and t.is_cuda:
                            t.record_stream(here)
                self._kv_restore_blocks(k, v, sc, ids)
                if logits is not None:
                    # this stream's own copy: the radix keeps it for the hit
                    logits = logits.to(self.device).clone()
            except BaseException:
                self.kv.release_blocks(ids)
                raise
            n_full = int(payload["n_full"])
            self.kv.handoff_commit(
                payload["tokens"], ids[:n_full], ids[n_full] if n > n_full else -1, int(payload["tail_len"]),
                logits=logits, logits_nbytes=0 if logits is None else logits.numel() * logits.element_size(),
            )
            return True

        return self._run_on_scheduler(work, timeout)

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

    def _bucket_for(self, n: int) -> int:
        """A wave's prompt width: the smallest prefill bucket that holds n
        tokens, else max_seq_len (JAX ``_bucket_for``)."""
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.max_seq_len

    @staticmethod
    def _prefill_name(bucket: int, nb: int) -> str:
        return f"llm.prefill_b{bucket}.w{nb}"

    def _wave_width(self, n: int) -> int:
        """Step, wave or hit batch dim: next power of two, capped at
        admit_cap."""
        return min(self.admit_cap, 1 << max(0, n - 1).bit_length())

    def _wave_widths(self) -> list[int]:
        """Every width ``_wave_width`` gives: {1, 2, 4, ..., admit_cap}."""
        return sorted({self._wave_width(n) for n in range(1, self.admit_cap + 1)})

    def _step_name(self, shape: int, nb: int) -> str:
        return f"llm.step_p{shape}_d{self.decode_chunk}.w{nb}"

    @staticmethod
    def _g_name(name: str) -> str:
        """The constrained twin's family name (JAX's ``g`` suffix, before
        a step's width): ``llm.step_p16_d8.w4`` -> ``llm.step_p16_d8g.w4``,
        ``llm.decode_chunk8`` -> ``llm.decode_chunk8g``."""
        base, dot, width = name.partition(".w")
        return f"{base}g{dot}{width}"

    def _host_tables(self) -> np.ndarray:
        t = self.kv.take_tables()
        if t is not None:
            self._tables_np = t
        return self._tables_np

    def _grow(self, slot: int, r: GenRequest, hi: int) -> None:
        """Raise a slot's block watermark to ``hi`` rows (bounded by the
        request's worst case) and materialize the blocks (paged only: a
        contiguous slot holds its rows from the start)."""
        if not self.kv.paged:
            return
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
        self._fault("device_step")  # before any cursor moves
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
            # the constrained twin while any resident request has a grammar
            # (JAX llm.py:5977-5981): one family per dispatch keeps the
            # device DFA chain coherent; unconstrained lanes are untouched
            use_g = self._grammar_live()
            pack = np.zeros((nb, shape + 3), np.int32)
            meta = np.zeros((4 if use_g else 2, nb), np.int32)
            meta[0, :] = self.slots  # padding lanes: inert (their writes drop)
            if use_g:
                meta[2, :] = -1  # padding and unconstrained rows: no grammar
            finishes: list[tuple[int, int, GenRequest]] = []
            prefill_tokens = 0
            spans = [(r, r.prefill_pos, n) for r, n in rows]  # the goodput ledger's rows
            for j, (r, n) in enumerate(rows):
                pos = r.prefill_pos
                pack[j, :n] = r.prompt_tokens[pos : pos + n]
                pack[j, shape] = pos
                pack[j, shape + 1] = n
                pack[j, shape + 2] = np.float32(r.temperature).view(np.int32)
                meta[0, j] = r.slot
                done = pos + n >= len(r.prompt_tokens)
                meta[1, j] = 1 if done else 0
                if use_g and r._g_id >= 0 and r._g_state >= 0:
                    # the first token's mask and the slot's device state
                    # start at the host mirror's state (0 for a fresh
                    # request; JAX llm.py:5945-5952)
                    meta[2, j], meta[3, j] = r._g_id, r._g_state
                r.prefill_pos = pos + n
                r._rows_hi = max(r._rows_hi, pos + n)
                self._load_credit(r, n)
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
            if use_g:
                name = self._g_name(name)
            self._ensure_family(name)
            self._stage(use_g, self._host_tables(), live, meta, pack)
            t0 = time.perf_counter()
            out = self._launch(name)
            toks, logits = out if self._keep_logits else (out, None)
            # after the rows loop: rows finishing this step decode in it
            snapshot = [r if (r is not None and r.prefill_done) else None for r in self._slot_req]
            work = prefill_tokens + K * sum(r is not None for r in snapshot)
            fetch = _Fetch(toks, work, t0, gp=("step", shape, nb, prefill_tokens, spans))
            self._inflight.append(("step", fetch, finishes, nb, snapshot, K))
            self.steps += 1
            self.step_tokens += work
            self.prefill_tokens += prefill_tokens
            self.chunks += 1
            if logits is not None:
                # store each finished prompt: its logits row (and on the
                # contiguous layouts its slot rows) cloned on the engine
                # stream before the next replay overwrites the graph's
                # output (JAX llm.py:6058-6077). The pool publishes into the
                # radix; the contiguous layouts keep the whole ring when
                # rolling, else the rows the prompt wrote. Adapted rows are
                # never stored (_kv_publish skips them too)
                for j, slot, r in finishes:
                    if self.kv.paged:
                        self._kv_publish(slot, r, logits[j : j + 1].clone())
                    elif r._aid == 0:
                        keep = self.kv.capacity if self.kv.rolling else min(r._rows_hi, self.kv.capacity)
                        self.kv.prefix.put(
                            self.kv.prefix.key_for(r.prompt_tokens), self.cache.k[:, slot : slot + 1, :keep],
                            self.cache.v[:, slot : slot + 1, :keep], len(r.prompt_tokens), logits[j : j + 1],
                        )
            self._work_cv.notify()
            return True

    def _dispatch_chunk(self, needed: int) -> int:
        """One pure decode chunk for the decoding slots: the short chunk
        only when even it covers the whole remaining demand. Returns the
        chunk's length."""
        k = self._chunk_short if needed <= self._chunk_short else self.decode_chunk
        self._fault("device_step")
        with self._work_cv:
            snapshot = [r if (r is not None and r.prefill_done) else None for r in self._slot_req]
            steps = self._inflight_steps()
            live = np.zeros((self.slots,), bool)
            for i, r in enumerate(snapshot):
                if r is None or r.emitted + steps.get(i, 0) >= r.max_new_tokens:
                    continue  # satisfied lane: must not advance past its blocks
                live[i] = True
                self._grow(i, r, self._kv_hi[i] + k)
            use_g = self._grammar_live()  # JAX llm.py:5782-5786
            name = f"llm.decode_chunk{k}" + ("g" if use_g else "")
            self._ensure_family(name)
            self._stage(use_g, self._host_tables(), live)
            t0 = time.perf_counter()
            fetch = _Fetch(self._launch(name), k * sum(r is not None for r in snapshot), t0)
            self._inflight.append(("chunk", fetch, snapshot, k))
            self.chunks += 1
            self._work_cv.notify()
            return k

    def _spec_drafts(self, r: GenRequest, kcap: int) -> tuple[list[int], list[int]]:
        """(draft, predicted emitted span) for one decoding slot (JAX
        ``_spec_drafts``): the draft length follows the request's
        acceptance EMA (``spec.draft_len``: a backed-off request runs a
        plain lane, with a 1-token probe every SPEC_PROBE_EVERY), capped at
        what the request can still emit and at ``kcap``. ONE drafter call
        for k + 1 tokens over the OPTIMISTIC stream (prompt + history + the
        predicted spans of verifies in flight): the first k are the draft,
        the overhang predicts the bonus token. A misprediction only
        mis-aims later drafts (they are rejected), never the emitted
        stream. A constrained request's draft goes through its grammar
        (``_g_draft``). Lock held."""
        kmax = min(self.spec_draft, r.max_new_tokens - r.emitted - len(r._spec_pending) - 1, kcap)
        k = draft_len(r._spec_ema, kmax, r._spec_plain)
        stream = r.prompt_tokens + r.history + r._spec_pending
        d_full = self.drafter.draft(stream, k + 1) if k > 0 else []
        d = d_full[:k]
        bonus = d_full[k : k + 1] or d[-1:]
        if r.grammar is not None and k > 0:
            d, bonus = self._g_draft(r, d, d_full, k)
        if not d:
            r._spec_plain += 1
            return [], [stream[-1]]
        return d, d + bonus

    @staticmethod
    def _g_draft(r: GenRequest, d: list[int], d_full: list[int], k: int) -> tuple[list[int], list[int]]:
        """A constrained request's (draft, bonus prediction) on its host
        DFA mirror advanced over the spans in flight (JAX llm.py:6149-6199):
        FILTER the draft at its first token the grammar refuses (a certain
        rejection), FAST-FORWARD it through runs where the grammar admits
        exactly one token (a certain acceptance, even where the drafter
        proposed nothing), and aim the bonus at a forced token when the
        state after the draft admits only one."""
        g = r.grammar
        st = g.advance_all(r._g_state, r._spec_pending)
        if st < 0:
            return [], []
        d = g.filter_draft(st, d)
        s = g.advance_all(st, d)
        while len(d) < k and s >= 0:
            forced = np.flatnonzero(g.allowed(s))
            if len(forced) != 1:
                break
            d.append(int(forced[0]))
            s = g.advance(s, int(forced[0]))
        g_bonus: list[int] = []
        if d and s >= 0:
            forced = np.flatnonzero(g.allowed(s))
            if len(forced) == 1:
                g_bonus = [int(forced[0])]
        return d, g_bonus or ((d_full[k : k + 1] if len(d) == k else d[-1:]) or d[-1:])

    def _dispatch_verify(self) -> bool:
        """One verify program (JAX ``_dispatch_verify``, paged and
        unconstrained): every decoding slot whose in-flight coverage is
        verify-only gets its draft packed into one all-slot
        ``llm.step_v{W}``; a lane whose drafter proposed nothing rides as
        a draft-0 plain lane, so speculation never splits the batch.
        Verifies pipeline to the lookahead depth: the program chains tail
        and length from device state, so a verify dispatched before its
        predecessor's fetch is an exact continuation; only its drafts
        (aimed by the optimistic stream) can go stale. Selected lanes
        charge W tokens each against ``step_token_budget`` (floored at
        one lane); the scan starts at ``_spec_rr``, where the last
        budget-cut scan stopped, so no slot starves.

        Each lane's rows stay inside the blocks its request reserved: the
        device length is at most prompt + history - 1 (the tail token is
        not written yet) plus the rows of the lane's verifies in flight,
        and the draft is cut so that this verify's rows fit under
        ``_kv_limit`` (a row past a table's materialized entries would
        land in a stale block). With sharing on they land at or above the
        length, in the slot's PRIVATE blocks (published full blocks lie
        below every cursor).

        Returns False when no lane was eligible or nothing was drafted
        anywhere (plain chunks then do better)."""
        Kd = self.spec_draft
        W = Kd + 1
        self._fault("device_step")
        with self._work_cv:
            steps = self._inflight_steps()
            # per slot of the current owner: verifies in flight and the
            # rows they may write
            ver_cover: dict[int, int] = {}
            fly_rows: dict[int, int] = {}
            for e in list(self._inflight) + [e for e in (self._processing,) if e is not None]:
                if e[0] != "verify":
                    continue
                for slot, r in e[2]:
                    if r is self._slot_req[slot]:
                        ver_cover[slot] = ver_cover.get(slot, 0) + 1
                        fly_rows[slot] = fly_rows.get(slot, 0) + e[3]["n_draft"][slot] + 1
            budget = self.step_token_budget or self.slots * W
            pack = np.zeros((self.slots, Kd + 2), np.int32)
            sel: list[tuple[int, GenRequest]] = []
            n_draft: dict[int, int] = {}
            pred: dict[int, list[int]] = {}
            rows: dict[int, int] = {}
            start = self._spec_rr % self.slots
            cut = None
            for slot in [*range(start, self.slots), *range(start)]:
                r = self._slot_req[slot]
                if (
                    r is None or not r.prefill_done or r.cancelled or r.finish_reason is not None
                    or steps.get(slot, 0) != ver_cover.get(slot, 0)
                    or r.emitted + len(r._spec_pending) >= r.max_new_tokens
                ):
                    continue
                # (history: the tokens emitted since the prompt last
                # absorbed them, at a preemption)
                dev_hi = len(r.prompt_tokens) + len(r.history) - 1 + fly_rows.get(slot, 0)
                room = (r._kv_limit or self.kv.capacity) - dev_hi
                if room < 1:
                    continue  # its verifies in flight may fill the reservation
                if sel and (len(sel) + 1) * W > budget:
                    cut = slot
                    break
                d, p = self._spec_drafts(r, room - 1)
                pack[slot, : len(d)] = d
                pack[slot, Kd] = len(d)
                pack[slot, Kd + 1] = 1
                sel.append((slot, r))
                n_draft[slot], pred[slot], rows[slot] = len(d), p, dev_hi + len(d) + 1
            proposed = sum(n_draft.values())
            if not proposed:
                return False
            if cut is not None:
                self._spec_rr = cut
            for slot, r in sel:
                r._spec_pending = r._spec_pending + pred[slot]
                r._spec_inflight += 1
                self.spec_plain += not n_draft[slot]
                self._grow(slot, r, rows[slot])
            # the constrained split of the acceptance counters (JAX
            # llm.py:6297-6304), and the constrained twin while a grammar
            # is resident
            gset = {slot for slot, r in sel if r.grammar is not None}
            use_g = self._grammar_live()
            name = f"llm.step_v{W}" + ("g" if use_g else "")
            self._ensure_family(name)
            self._stage(use_g, self._host_tables(), np.zeros((self.slots,), bool), verify=pack)
            t0 = time.perf_counter()
            fetch = _Fetch(self._launch(name), t0=t0)
            self._inflight.append(
                ("verify", fetch, sel, {"W": W, "n_draft": n_draft, "pred": pred, "gset": gset})
            )
            self.spec_steps += 1
            self.spec_proposed += proposed
            self.spec_proposed_c += sum(n_draft[slot] for slot in gset)
            self._work_cv.notify()
            return True

    def _emit_to(self, r: GenRequest, slot: int, toks: list[int], now: float) -> None:
        """Append a request's next tokens, honoring max_new/eos/cancel.
        Tokens after a finish are dropped; the -1 sentinel reaches here
        only with ``numeric_check`` off (``_numeric_check_fetch``), and
        streams as it is, as in the JAX engine. Lock held."""
        if r.finish_reason is not None:
            return
        if self._died:
            # a dead engine never emits: its requests are rescued (under
            # this lock) or ended, and a late emission would race the
            # continuation's stream on another replica
            return
        finish = None
        if r.cancelled:
            toks, finish = [], r.cancel_reason
        toks = toks[: r.max_new_tokens - r.emitted]
        if r.eos_token >= 0 and r.eos_token in toks:
            toks = toks[: toks.index(r.eos_token) + 1]
            finish = "eos"
        if toks:
            if r.emitted == 0:
                r.first_token_at = now
            r.out.put(toks)
            r.emitted += len(toks)
            r.history.extend(toks)
            if r.grammar is not None:
                # the host DFA mirror (JAX llm.py:5714-5721)
                r._g_state = r.grammar.advance_all(r._g_state, toks)
            self._load_credit(r, len(toks))
            if self.ledger is not None:
                self.ledger.charge(r.client, len(toks))
        if finish is None and r.emitted >= r.max_new_tokens:
            finish = "length"
        if finish is not None:
            self._finish(r, finish)

    # -- collector --------------------------------------------------------
    def _collect_loop(self) -> None:
        """The collector thread (JAX ``_collect_loop``): each fetch inside
        the fetch heartbeat (the ``step_latency`` seam too). A fetch that
        raises loses its entry's tokens (``_close_unreachable``);
        ``_FETCH_FAIL_LIMIT`` in a row end in ``_die``."""
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
                        if entry[0] != "prefill":  # it carries a decode part
                            self._jumped = False
                    self._processing = entry
                try:
                    with self._hb_fetch.beat(f"fetch:{entry[0]}"):
                        self._fault_latency()
                        self._process_entry(entry)
                    self._fetch_fail_streak = 0
                except Exception as e:  # noqa: BLE001
                    if self.logger is not None:
                        self.logger.error(f"LLM engine fetch failed: {e!r}")
                    self._fetch_fail_streak += 1
                    if self._fetch_fail_streak >= self._FETCH_FAIL_LIMIT:
                        self._die(f"collector failed {self._fetch_fail_streak} fetches in a row: {type(e).__name__}: {e}")
                        return
                    self._close_unreachable(entry)
                finally:
                    with self._lock:
                        if self._processing is entry:
                            self._processing = None
                self._flush_wide_events()
                self._kick.set()
        finally:
            if not self._stop:
                self._die("collector thread exited unexpectedly")

    @staticmethod
    def _jump_safe(entry: tuple) -> bool:
        """May the collector serve this entry ahead of older ones? A hit
        group always (it carries only fresh requests' first tokens); a
        step only with finishing rows whose decode part serves no one
        else: an active request's earlier tokens may sit in the entries it
        would pass, and a finishing row is in no older entry."""
        if entry[0] == "prefill":
            return True
        if entry[0] != "step" or not entry[2]:
            return False
        fin = {r for _j, _s, r in entry[2]}
        return all(r is None or r in fin for r in entry[4])

    @staticmethod
    def _entry_requests(entry: tuple) -> list[GenRequest]:
        if entry[0] in ("prefill", "verify"):
            return [r for _s, r in entry[2] if r is not None]
        snapshot = entry[4] if entry[0] == "step" else entry[2]
        out = [r for r in snapshot if r is not None]
        if entry[0] == "step":
            out += [r for _j, _s, r in entry[2]]
        return out

    def _process_entry(self, entry: tuple) -> None:
        """Wait for one program's tokens (outside the lock: the card runs
        the next program meanwhile) and emit them; the entry leaves
        ``_processing`` in the same lock acquisition as the emits."""
        fetch = entry[1]
        toks = fetch.wait()
        # the numerical watchdog, outside the lock (_die takes it) and
        # before any emission, on the lanes of live requests
        if entry[0] == "prefill":
            toks, tripped = self._numeric_check_fetch(
                toks, [j for j, (_s, r) in enumerate(entry[2]) if r is not None], "prefill first token"
            )
        elif entry[0] == "verify":
            S, W = self.slots, entry[3]["W"]
            ys, tripped = self._numeric_check_fetch(
                toks[: S * W].reshape(S, W).T, [slot for slot, _r in entry[2]], "spec verify"
            )
            toks = np.concatenate([ys.T.reshape(-1), toks[S * W :]])
        else:
            tripped = False
            snapshot = entry[4] if entry[0] == "step" else entry[2]
            if entry[0] == "step" and entry[2]:
                nb = entry[3]
                first, tripped = self._numeric_check_fetch(toks[:nb], [j for j, _s, _r in entry[2]], "step first token")
                toks = np.concatenate([first, toks[nb:]])
            if not tripped:
                off = entry[3] if entry[0] == "step" else 0
                k = entry[5] if entry[0] == "step" else entry[3]
                cols, tripped = self._numeric_check_fetch(
                    toks[off:].reshape(k, self.slots), [s for s, r in enumerate(snapshot) if r is not None],
                    "step decode" if entry[0] == "step" else "decode chunk",
                )
                toks = np.concatenate([toks[:off], cols.reshape(-1)])
        if tripped:
            return
        now = time.perf_counter()
        if entry[0] == "verify":
            self._process_verify_entry(entry, toks, now)
            return
        if self.goodput is not None:
            self._gp_observe(entry, now)
        if self.anomaly is not None and entry[0] == "step":
            self.anomaly.observe("step", (now - fetch.t0) * 1e3)  # JAX llm.py:6594
        self._observe_tput(fetch.work, now - fetch.t0)
        with self._lock:
            if entry[0] == "prefill":
                for j, (slot, r) in enumerate(entry[2]):
                    if r is not None:  # None: preempted (the row is kept)
                        self._emit_to(r, slot, [int(toks[j])], now)
                self._processing = None
                return
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

    def _process_verify_entry(self, entry: tuple, toks: np.ndarray, now: float) -> None:
        """Emit one verify's tokens (JAX ``_process_verify_entry``, its
        emit core): per selected slot, the accepted draft tokens plus the
        bonus token, ``ys[slot, :acc + 1]``, as ONE push through
        ``_emit_to`` (max_new, eos and cancel truncation; a retired
        request's tokens are dropped). Updates the acceptance EMA that
        sizes the next draft and reconciles the optimistic stream: an
        exact prediction pops its span, any misprediction clears it (later
        verifies in flight still emit valid tokens; their drafts were only
        mis-aimed)."""
        _, fetch, sel, info = entry
        S, W = self.slots, info["W"]
        ys, acc = toks[: S * W].reshape(S, W), toks[S * W :]
        if self.goodput is not None:
            self._gp_observe(entry, now, acc)
        if self.anomaly is not None:  # JAX llm.py:6750-6757
            self.anomaly.observe("step", (now - fetch.t0) * 1e3)
            # this verify's acceptance over the drafts it could accept
            self.anomaly.observe("spec_accept", sum(int(acc[slot]) for slot, _r in sel) / max(1, len(sel) * (W - 1)))
        with self._lock:
            self._observe_tput(sum(int(acc[slot]) + 1 for slot, _r in sel), now - fetch.t0)
            for slot, r in sel:
                a = int(acc[slot])
                out = ys[slot, : a + 1].tolist()
                self.spec_accepted += a
                if slot in info["gset"]:
                    self.spec_accepted_c += a
                nd = info["n_draft"][slot]
                if nd:
                    r._spec_ema = (1 - SPEC_EMA_ALPHA) * r._spec_ema + SPEC_EMA_ALPHA * (a / nd)
                    r._spec_plain = 0
                p = info["pred"][slot]
                if out == p and r._spec_pending[: len(p)] == p:
                    r._spec_pending = r._spec_pending[len(p) :]
                else:
                    r._spec_pending = []
                r._spec_inflight = max(0, r._spec_inflight - 1)
                self._emit_to(r, slot, out, now)
            self._processing = None

    def _spec_summary(self) -> dict:
        """Speculation counters (JAX ``_spec_summary``'s keys), split
        between constrained and unconstrained lanes."""

        def rate(acc: int, prop: int):
            return round(acc / prop, 3) if prop else None

        prop_u = self.spec_proposed - self.spec_proposed_c
        acc_u = self.spec_accepted - self.spec_accepted_c
        return {
            "enabled": self.speculative, "draft": self.spec_draft, "steps": self.spec_steps,
            "proposed": self.spec_proposed, "accepted": self.spec_accepted, "plain_lanes": self.spec_plain,
            "accept_rate": rate(self.spec_accepted, self.spec_proposed),
            "constrained": {"proposed": self.spec_proposed_c, "accepted": self.spec_accepted_c,
                            "accept_rate": rate(self.spec_accepted_c, self.spec_proposed_c)},
            "unconstrained": {"proposed": prop_u, "accepted": acc_u, "accept_rate": rate(acc_u, prop_u)},
        }

    # -- grammar-constrained decoding ---------------------------------------
    def _constrained_summary(self) -> dict:
        """JAX ``_constrained_summary``."""
        return {
            "enabled": self.constrained,
            "requests": self.constrained_requests,
            "grammars_resident": sum(1 for g in self._grammars if g is not None),
            "grammar_cap": self._g_cap,
            "states": [g.n_states if g is not None else 0 for g in self._grammars],
        }

    def _register_grammar(self, g) -> int:
        """The resident-grammar table slot for one TokenGrammar (JAX
        ``_register_grammar``): a repeated grammar dedups by key; a full
        table evicts a zero-ref entry; a table whose every slot holds live
        requests refuses the submit (``EngineOverloaded``: capacity, not a
        client error). The device rows follow at the scheduler's next pass
        (``_g_sync``). Lock held."""
        vocab = getattr(g, "vocab_size", None)
        if vocab != self.cfg.vocab_size:
            raise ValueError(
                f"grammar compiled for vocab {vocab}, model vocab is {self.cfg.vocab_size} — "
                "compile against this model's tokenizer"
            )
        for i, og in enumerate(self._grammars):
            if og is not None and og.key == g.key:
                return i
        gid = None
        if len(self._grammars) < self._g_cap:
            self._grammars.append(None)
            self._g_refs.append(0)
            gid = len(self._grammars) - 1
        else:
            gid = next((i for i, n in enumerate(self._g_refs) if n == 0), None)
        if gid is None:
            raise EngineOverloaded(
                f"all {self._g_cap} resident grammar slots hold live requests "
                "(raise TPU_LLM_CONSTRAINED_GRAMMARS)",
                retry_after=1.0,
            )
        self._grammars[gid] = g
        self._g_refs[gid] = 0
        self._g_dirty.add(gid)
        return gid

    def _g_padded(self) -> tuple[int, int]:
        """The device table's (G, Smax): the resident grammars' count and
        largest state count padded to powers of two, Smax at least 32 (JAX
        ``_rebuild_grammar_table``), never below the current table's (the
        captured families keep reading it while it is big enough; padding
        rows admit nothing and no live lane reaches them). Lock held."""
        G = 1 << max(0, len(self._grammars) - 1).bit_length()
        smax = max(g.n_states for g in self._grammars if g is not None)
        S = max(32, 1 << max(0, smax - 1).bit_length())
        if self._gtab is not None:
            G, S = max(G, self._gtab.shape[0]), max(S, self._gtab.shape[1])
        return G, S

    def _g_sync(self) -> None:
        """Write the grammars registered since the last pass into the device
        table (scheduler thread, on the engine stream, before the pass's
        dispatches). While the padded shape holds, a grammar's rows are
        written in place, ordered after the programs in flight. When it
        grows, the pipeline drains first if constrained graphs exist (they
        read the old table's address): then a new table is made with every
        grammar, and those families are dropped (``_g_prepare`` captures
        them again)."""
        drained = False
        while True:
            with self._lock:
                if not self._g_dirty:
                    return
                G, S = self._g_padded()
                grow = self._gtab is None or (G, S) != tuple(self._gtab.shape[:2])
                if not grow or drained or not any(n in self.families for n in self._programs_g):
                    dirty, self._g_dirty = self._g_dirty, set()
                    if grow:
                        for name in self._programs_g:
                            self.families.pop(name, None)
                        self._gtab = torch.full(
                            (G, S, self.cfg.vocab_size), -1, dtype=torch.int32, device=self.device
                        )
                        dirty = {i for i, g in enumerate(self._grammars) if g is not None}
                    for gid in sorted(dirty):
                        self._g_write(gid)
                    return
            self._drain()  # outside the lock; then look again
            drained = True

    def _g_write(self, gid: int) -> None:
        """Copy one grammar's rows into the device table, padding states
        admitting nothing; from pinned memory kept until its copy has run
        on CUDA. Lock held."""
        table = self._grammars[gid].table
        n = table.shape[0]
        rows = torch.from_numpy(table)
        if self.device.type == "cuda":
            self._g_uploads = [u for u in self._g_uploads if not u[0].query()]
            rows = rows.pin_memory()
            self._gtab[gid, :n].copy_(rows, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._g_uploads.append((done, rows))
        else:
            self._gtab[gid, :n].copy_(rows)
        self._gtab[gid, n:].fill_(-1)

    def _drain(self) -> None:
        """Wait until no program is in flight (scheduler thread: nothing is
        dispatched meanwhile)."""
        with self._work_cv:
            while (self._inflight or self._processing is not None) and not self._stop:
                self._work_cv.wait(timeout=0.005)

    def _g_prepare(self) -> None:
        """Before a pass's dispatches (JAX ``_ensure_c_ops``, lazy by
        design): sync the device table, and on CUDA, while a constrained
        request is resident, capture the constrained families not yet
        captured. No family is captured at warmup, so an engine that never
        sees a grammar captures nothing more; the capture (eager warm-up
        runs on inert inputs, then the graph) waits for the pipeline to
        drain. Records the first capture's seconds and memory."""
        self._g_sync()
        if self.device.type != "cuda":
            return
        with self._lock:
            missing = [n for n in self._programs_g if n not in self.families] if self._grammar_live() else []
        if not missing:
            return
        self._drain()
        t0 = time.perf_counter()
        torch.cuda.empty_cache()  # as each capture does (see _warm)
        before = torch.cuda.memory_reserved(self.device)
        with self._capture_lock:
            for name in missing:
                self._capture(name)
        torch.cuda.synchronize(self.device)
        if self.g_capture_s is None:
            self.g_capture_s = time.perf_counter() - t0
            self.g_reserved = (before, torch.cuda.memory_reserved(self.device))
        self.g_captures += 1

    def _grammar_live(self) -> bool:
        """Any resident request constrained? True routes EVERY dispatch
        through the constrained families (JAX ``_grammar_live``). Lock
        held."""
        return any(r is not None and r.grammar is not None for r in self._slot_req) or any(
            r.grammar is not None for r in self._prefilling
        )

    def _stage(self, use_g: bool, *args, **kw) -> None:
        """Stage one dispatch's inputs (``_Inputs.write``), with the
        per-slot grammar ids when a constrained program reads them and the
        per-slot adapter ids on a LoRA engine."""
        if use_g:
            kw["gids"] = self._gids_np()
        if self.lora_slots:
            kw["aids"] = self._aids_np()
        self._in.write(*args, **kw)

    def _aids_np(self) -> np.ndarray:
        """Per-slot adapter gids for one dispatch: each occupant's ``_aid``,
        0 (the base) for an empty slot. Staged with every dispatch, so a
        program in flight keeps the ids of its own dispatch. Lock held."""
        aids = np.zeros((self.slots,), np.int32)
        for i, r in enumerate(self._slot_req):
            if r is not None:
                aids[i] = r._aid
        return aids

    # -- multi-tenant LoRA (JAX llm.py:3284-3420) ----------------------------
    def _require_lora(self) -> None:
        if not self.lora_slots:
            raise ValueError(
                "engine has no adapter pool (lora_slots=0; set "
                "TPU_LLM_LORA_SLOTS or pass lora_slots=)"
            )

    def _lora_release(self, r: GenRequest) -> None:
        """Drop ``r``'s reference to its adapter's gid, once. Lock held."""
        if r._aid:
            self._lora_pool.release(r._aid)
            r._aid = 0

    def _lora_rows(self, canon: dict) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """(device table, host rows) for every table of one adapter, padded
        to the pool's rank: [L, d_in, r_max] for A, [L, r_max, d_out] for
        B, zeros for the targets the adapter leaves out (so nothing of a
        gid's previous tenant survives). On CUDA the host rows are the
        engine's pinned buffers, made at the first load and reused once
        the last load's copies have run. Loads hold the capture lock, one
        at a time."""
        cuda = self.device.type == "cuda"
        layers = self.params["layers"]
        if cuda and self._lora_host is None:
            self._lora_host = {
                k: torch.empty((t.shape[0],) + tuple(t.shape[2:]), dtype=torch.float32, pin_memory=True)
                for k, t in layers.items() if k.startswith("lora_")
            }
        if self._lora_done is not None:
            self._lora_done.synchronize()
        out = []
        for name in target_dims(self.cfg):
            pair = canon.get(name)
            for i, key in enumerate((f"lora_{name}_a", f"lora_{name}_b")):
                tab = layers[key]
                rows = self._lora_host[key] if cuda else torch.empty((tab.shape[0],) + tuple(tab.shape[2:]))
                rows.zero_()
                if pair is not None:
                    r = pair[0].shape[2]
                    (rows[:, :, :r] if i == 0 else rows[:, :r]).copy_(torch.from_numpy(pair[i]))
                out.append((tab, rows))
        return out

    def _lora_stage(self, gid: int, rows: list[tuple[torch.Tensor, torch.Tensor]]) -> None:
        """Write one adapter's rows into table row ``gid`` IN PLACE (JAX
        ``_lora_stage`` swaps the params dict; the captured programs here
        hold the tables' addresses): one copy per layer and table, each into
        a contiguous [d_in, r] or [r, d_out] block, enqueued on the engine
        stream. Called under the lock that binds the gid, so every dispatch
        that can name it is enqueued after these copies, and every program
        in flight that still names the gid for an earlier tenant runs
        before them. No device memory is allocated."""
        cuda = self.device.type == "cuda"
        with torch.cuda.stream(self._stream) if cuda else contextlib.nullcontext():
            for tab, src in rows:
                for layer in range(tab.shape[0]):
                    tab[layer, gid].copy_(src[layer], non_blocking=cuda)
            if cuda:
                self._lora_done = torch.cuda.Event()
                self._lora_done.record()

    def load_adapter(
        self, name: str, adapter: dict, *, version: str = "v1",
        alpha: float | None = None, fair_weight: float | None = None,
    ) -> int:
        """Validate ``adapter`` against the base config (``lora``:
        {target: {"a", "b"}} host arrays), bind ``name`` to a pool gid
        (LRU-evicting an idle resident when full; ``AdapterPoolFull`` when
        every gid is busy) and write its rows into the device tables in
        place. Callable while serving: nothing is captured and no device
        memory is allocated. Returns the gid. ``fair_weight`` sets the
        FairLedger weight of the adapter's pseudo-client
        (``adapter:<name>``)."""
        self._require_lora()
        canon = validate_adapter(self.cfg, adapter, rank_max=self.lora_rank, alpha=alpha)
        rank = max((a.shape[2] for a, _ in canon.values()), default=0)
        with self._capture_lock:
            rows = self._lora_rows(canon)
            with self._lock:
                gid = self._lora_pool.allocate(name, version=version, rank=rank)
                try:
                    self._lora_stage(gid, rows)
                except BaseException:
                    self._lora_pool.remove(name)
                    raise
        if fair_weight is not None and self.ledger is not None:
            self.ledger.set_weight(f"adapter:{name}", fair_weight)
        self._adapters_host[name] = {"adapter": adapter, "version": str(version), "alpha": alpha,
                                     "fair_weight": fair_weight}
        return gid

    def publish_adapter(self, staging: str, name: str) -> int | None:
        """Atomically repoint ``name`` at the gid staged under ``staging``
        (the hot-load commit). Requests in flight keep decoding on the OLD
        gid until they drain (a zombie); new submits resolve to the new
        one. Returns the previous gid, or None for a first load."""
        self._require_lora()
        with self._lock:
            prev = self._lora_pool.publish(staging, name)
        rec = self._adapters_host.pop(staging, None)
        if rec is not None:
            self._adapters_host[name] = rec
        return prev

    def evict_adapter(self, name: str) -> int:
        """Unbind ``name``. Its gid frees at once when idle, else drains as
        a zombie while its requests finish; the rows are not zeroed (no
        lane points at them; the next load overwrites them whole)."""
        self._require_lora()
        self._adapters_host.pop(name, None)
        with self._lock:
            return self._lora_pool.remove(name)

    def adapters(self) -> dict:
        """Pool snapshot: resident adapters (gid / version / rank / refs),
        zombie gids, lifetime evictions and swaps; empty-shaped without a
        pool."""
        if not self.lora_slots:
            return {"slots": 0, "resident": {}, "zombies": [], "evictions": 0, "swaps": 0}
        with self._lock:
            return self._lora_pool.snapshot()

    def _gids_np(self) -> np.ndarray:
        """Per-slot grammar ids for one dispatch, -1 for an unconstrained
        lane (JAX ``_gids_np``). Lock held."""
        gids = np.full((self.slots,), -1, np.int32)
        for i, r in enumerate(self._slot_req):
            if r is not None and r.grammar is not None and r._g_id >= 0:
                gids[i] = r._g_id
        return gids

    # -- device programs ------------------------------------------------------
    def _launch(self, name: str) -> torch.Tensor:
        """Run program family ``name`` on the staged inputs: eagerly on the
        CPU, as one replay of its captured graph on CUDA, inside the
        dispatch heartbeat. Returns its output (a replay's is the graph's
        static buffer). A stopped engine launches nothing (its memory may
        be on its way out): it raises ``EngineStoppedError``. A launch
        ends the scheduler's failure streak."""
        if self._stop:
            raise EngineStoppedError(f"engine stopped ({self.died_reason or 'closed'})")
        with self._hb_dispatch.beat(f"dispatch:{name}"):
            if self.device.type == "cpu":
                out = self._program(name)[0]()
            else:
                fam = self.families[name]
                fam.graph.replay()
                add_launches(fam.launches)
                out = fam.out
        self._sched_fail_streak = 0
        return out

    def _program(self, name: str) -> tuple:
        """(eager program, kind, arg) of family ``name``, constrained or not."""
        return self._programs[name] if name in self._programs else self._programs_g[name]

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
            if name not in self._lazy:
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
        raises: nothing falls back to eager ops. A constrained family's
        inputs also name no grammar (gids and meta rows -1), a LoRA
        engine's no adapter (aids 0). A contiguous decode advances its
        active slots with no live mask, so the lengths are restored too:
        the merge rows the warm-up runs wrote sit at or above each length
        (outside every window on a ring), as the next real merge's do. A
        contiguous wave's prefill inserts no rows while ``_warming``; its
        graph inserts every lane, as each lane of a served wave names a
        slot."""
        fn, kind, arg = self._program(name)
        g = name in self._programs_g
        gids = np.full((self.slots,), -1, np.int32) if g else None
        aids = np.zeros((self.slots,), np.int32) if self.lora_slots else None
        with torch.no_grad(), torch.cuda.stream(self._stream):
            live = np.zeros((self.slots,), bool)
            if kind == "chunk":
                self._in.write(self._tables_np, live, gids=gids, aids=aids)
            elif kind == "step":
                shape, nb = arg
                meta = np.zeros((4 if g else 2, nb), np.int32)
                meta[0, :] = self.slots
                meta[2:] = -1
                self._in.write(
                    self._tables_np, live, meta, np.zeros((nb, shape + 3), np.int32), gids=gids, aids=aids
                )
            elif kind == "prefill":  # one-token pad rows into no slot
                bucket, nb = arg
                meta = np.zeros((2, nb), np.int32)
                meta[0, :] = self.slots
                pack = np.zeros((nb, bucket + 3), np.int32)
                pack[:, bucket + 1] = 1
                self._in.write(self._tables_np, live, meta, pack)
            elif kind == "verify":  # no lane selected
                self._in.write(
                    self._tables_np, live, verify=np.zeros((self.slots, arg + 1), np.int32), gids=gids, aids=aids
                )
            else:
                self._in.write_seed(self._inert_seed())
            tail, length = self._tail.clone(), self.cache.length.clone()
            self._warming = True
            try:
                for _ in range(_WARM_RUNS):
                    fn()
            finally:
                self._warming = False
            self._tail.copy_(tail)
            self.cache.length.copy_(length)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self._gen)  # each replay draws fresh uniforms
            with capture_launches() as tally, torch.cuda.graph(
                graph, pool=self._graph_pool, stream=self._stream, capture_error_mode="thread_local"
            ):
                out = fn()
        self.families[name] = _Family(graph, out, dict(tally))

    def _step_program(self, shape: int, nb: int, g: bool = False):
        """The unified step (JAX ``llm.step_p{shape}_d{K}``) of ``nb`` rows
        on the staged inputs. Updates the pool (and its int8 scales),
        lengths, tail, active and temps IN PLACE; returns first tokens [nb]
        then decode tokens [K, slots], flat — and, when sharing is on, the
        rows' last-token logits [nb, vocab] beside them (the JAX
        ``keep_logits``). An int8 pool's packed slot views are dequantized
        in the model dtype; the chunk rows are quantized again at the
        scatter back.

        ``g=True`` is the constrained twin (JAX ``_make_paged_step_op_c``):
        meta rows 2-3 carry each row's grammar id and start state; a
        finishing row's first token is masked there and seeds its slot's
        DFA state, and the decode part samples through ``_g_sample`` from
        the slot states, which advance in place. The kept logits stay the
        raw ones.

        On a LoRA engine every prefill row and decode lane adds its
        adapter's delta, selected by the staged per-slot ids.

        On a contiguous engine (JAX ``_make_step_op``) the packed rows'
        slots are gathered from the slab or ring, the append runs with
        ``ring=`` and only the appended rows go back (``_put_appended``);
        the decode part is ``decode_chunk``."""
        dev, cfg, slots, sc = self.device, self.cfg, self.slots, self.pool_scales
        cap = self.kv.capacity
        pack_t, meta_t = self._in.pack(shape, nb), self._in.meta(nb, 4 if g else 2)
        tokens = pack_t[:, :shape]
        cursors = pack_t[:, shape].contiguous()
        n_new = pack_t[:, shape + 1].contiguous()
        req_temps = pack_t[:, shape + 2].contiguous().view(torch.float32)
        slot_idx, finish = meta_t[0], meta_t[1]
        row_slot = slot_idx.clamp(0, slots - 1).long()  # padding lanes (slot_idx = slots) clamp
        # each packed row's adapter: its slot's staged id (JAX llm.py:1417)
        aids = self._in.aids()[row_slot] if self.lora_slots else None
        if self.kv.paged:
            tsub = self._in.tables()[row_slot]
            sub = gather_slots(
                self.pool.k, self.pool.v, tsub, cursors,
                scales=None if sc is None else (sc[0], sc[1]), dtype=cfg.dtype,
            )
            logits, sub2 = prefill_append(self.params, cfg, tokens, sub, cursors, n_new, aids=aids)
            ar = torch.arange(shape, device=dev)[None, :]
            pos_a = cursors[:, None].long() + ar
            valid_a = (ar < n_new[:, None]) & (pos_a < cap)
            scatter_rows(
                self.pool.k, self.pool.v, tsub,
                _rows_at(sub2.k, pos_a), _rows_at(sub2.v, pos_a), pos_a, valid_a, scales=sc,
            )
        else:
            ring, c = self.kv.ring, self.cache
            sub = KVCache(k=c.k[:, row_slot], v=c.v[:, row_slot], length=cursors)
            logits, sub2 = prefill_append(self.params, cfg, tokens, sub, cursors, n_new, aids=aids, ring=ring)
            _put_appended(c.k, sub2.k, slot_idx, cursors, n_new, shape, ring)
            _put_appended(c.v, sub2.v, slot_idx, cursors, n_new, shape, ring)
        _scatter_slots(self.cache.length, slot_idx, cursors + n_new)
        if g:
            rows_g, on_r = _g_rows(self._gtab, meta_t[2], meta_t[3])
            on_r = on_r & (finish == 1)
            first = finite_guard(logits, _sample_raw(_g_mask(logits, rows_g, on_r), req_temps, self._gen))
            st1 = rows_g.gather(1, first.clamp(min=0).long()[:, None])[:, 0]
        else:
            first = self._sample(logits, req_temps, self._gen)
        fin_slot = torch.where(finish == 1, slot_idx, slots)
        # a mid-prefill row clears its slot's active flag, which may still
        # be set by the slot's previous occupant: on a ring the decode
        # merge would otherwise advance the length between two appends
        # and wrap over this prompt's in-window rows (JAX llm.py:1445)
        mid_slot = torch.where(finish == 1, slots, slot_idx)
        _scatter_slots(self._active, mid_slot, False)
        _scatter_slots(self._tail, fin_slot, first)
        _scatter_slots(self._active, fin_slot, True)
        _scatter_slots(self._temps, fin_slot, req_temps)
        if g:
            _scatter_slots(self._gstate, fin_slot, torch.where(on_r, st1, 0))
        toks = self._decode_chunk(self.decode_chunk, g)
        out = torch.cat([first, toks.reshape(-1)])
        return (out, logits) if self._keep_logits else out

    def _prefill_program(self, bucket: int, nb: int):
        """``llm.prefill`` fused with JAX's ``llm.insert_many`` and
        ``llm.admit_update``: one wave of ``nb`` right-padded prompts of
        width ``bucket`` on the staged inputs (pack [nb, bucket + 3]:
        tokens | 0 | length | temperature bits; meta [2, nb]: slot | row,
        pad lanes repeating lane 0, or every lane's slot out of range for
        an inert capture). Runs ``prefill`` (flash in its full-prompt
        mode), ring-packs the rows on the ring (``pack_prefill``), writes
        each row's prompt into its slot (the pool: through the slot's table,
        quantized for an int8 pool, rows past the length dropped; the slab
        or ring: its first ``bucket`` or ring rows), sets the lengths,
        samples the first tokens and makes them the slots' tails, active,
        at the rows' temperatures, IN PLACE. Returns (first tokens [nb],
        last-token logits [nb, vocab] or None without a prefix index, the
        wave's (k, v) rows [L, nb, W, hkv, hd] on the contiguous layouts
        with a prefix cache, else None).

        The prefill's cache is built bucket-wide and its rows go straight
        into the slots, so the capacity-wide scratch JAX's separate insert
        program takes never exists on the pool and the slab."""
        cfg, slots = self.cfg, self.slots
        pack_t, meta_t = self._in.pack(bucket, nb), self._in.meta(nb)
        lengths = pack_t[:, bucket + 1].contiguous()
        temps = pack_t[:, bucket + 2].contiguous().view(torch.float32)
        slot_idx, rows = meta_t[0], meta_t[1].long().clamp(0, nb - 1)
        logits, new = prefill(self.params, cfg, pack_t[:, :bucket], lengths, bucket)
        new = self.kv.pack_prefill(new)
        nk, nv, lens = new.k[:, rows], new.v[:, rows], lengths[rows]
        W = nk.shape[2]
        if self.kv.paged:
            pos = torch.arange(W, device=self.device)[None, :].expand(nb, W)
            valid = (pos < lens.clamp(max=self.kv.capacity)[:, None]) & (slot_idx < slots)[:, None]
            tsub = self._in.tables()[slot_idx.clamp(0, slots - 1).long()]
            scatter_rows(self.pool.k, self.pool.v, tsub, nk, nv, pos, valid, scales=self.pool_scales)
        elif not self._warming:  # an inert capture's warm-up runs name no slot
            _insert_slots(self.cache.k, nk, slot_idx)
            _insert_slots(self.cache.v, nv, slot_idx)
        _scatter_slots(self.cache.length, slot_idx, lens)
        first = self._sample(logits, temps, self._gen)
        _scatter_slots(self._tail, slot_idx, first[rows])
        _scatter_slots(self._active, slot_idx, True)
        _scatter_slots(self._temps, slot_idx, temps[rows])
        return first, (logits if self._keep_logits else None), ((new.k, new.v) if self.kv.prefix is not None else None)

    def _decode_chunk(self, k: int, g: bool) -> torch.Tensor:
        """``k`` fused decode steps for the live active slots from the
        device tail (the decode part of a step, and the chunk program):
        returns tokens [k, slots] and advances the tail — and with ``g``
        the slots' DFA states, sampling through ``_g_sample`` with the
        staged grammar ids — in place. A contiguous engine decodes every
        active slot (no live mask: JAX llm.py:1753) through
        ``decode_chunk``."""
        sample_fn, state = self._sample, None
        if g:
            gtab, gids = self._gtab, self._in.gids()
            sample_fn, state = (lambda lg, tp, gen, st: _g_sample(lg, tp, gen, gtab, gids, st)), self._gstate
        aids = self._in.aids() if self.lora_slots else None
        if self.kv.paged:
            out = decode_chunk_paged(
                self.params, self.cfg, self._tail, self.pool, self._in.tables(),
                self._active & self._in.live(), self._temps, self._gen, n_steps=k,
                sample_fn=sample_fn, block=self.kv.block, scales=self.pool_scales, sample_state=state, aids=aids,
            )
        else:
            out = decode_chunk(
                self.params, self.cfg, self._tail, self.cache, self._active, self._temps, self._gen,
                n_steps=k, sample_fn=sample_fn, ring=self.kv.ring, sample_state=state, aids=aids,
            )
        self._tail.copy_(out[1])  # the next program reads it at the same address
        if g:
            self._gstate.copy_(out[3])
        return out[0]

    def _chunk_program(self, k: int, g: bool = False) -> torch.Tensor:
        """The pure decode chunk (JAX ``llm.decode_chunk{K}``, or with
        ``g`` its constrained twin ``llm.decode_chunk{K}g``) on the staged
        inputs: returns tokens [k, slots], flat; the pool, lengths and tail
        (and the DFA states) advance in place."""
        return self._decode_chunk(k, g).reshape(-1)

    def _seed_program(self) -> torch.Tensor:
        """``llm.kv_seed`` on the staged seed inputs: block-copy srcs ->
        dsts (an exact hit's or a publish's sub-block tail, with an int8
        pool's scales; lanes with dst out of range write nothing) and set
        the lengths of slots slot_idx to lens (out-of-range slots
        untouched). Returns the lengths."""
        seed = self._in.seed()
        copy_blocks(self.pool.k, self.pool.v, seed[0], seed[1], scales=self.pool_scales)
        _scatter_slots(self.pool.length, seed[2], seed[3])
        return self.pool.length.clone()

    def _hit_program(self, nb: int) -> torch.Tensor:
        """``llm.hit_first`` fused with ``llm.admit_update`` for ``nb`` exact
        hits: sample each first token from the staged stored logits at the
        request's temperature (greedy reproduces the uncached stream), then
        write it as the slot's chain tail and activate the slot with its
        temperature. Hit meta rows: slot (out of range: padding) | row |
        temperature bits. Returns the first tokens [nb]."""
        meta = self._in.seed()[4:]
        slot_idx, rows = meta[0, :nb], meta[1, :nb]
        req_temps = meta[2, :nb].contiguous().view(torch.float32)
        first = self._sample(self._hit_logits[:nb], req_temps, self._gen)
        _scatter_slots(self._tail, slot_idx, first[rows.long().clamp(0, nb - 1)])
        _scatter_slots(self._active, slot_idx, True)
        _scatter_slots(self._temps, slot_idx, req_temps)
        return first

    def _verify_program(self, g: bool = False) -> torch.Tensor:
        """``llm.step_v{W}`` (JAX ``_verify_paged``) on the staged verify
        pack: each selected slot appends its tail token and draft (n_draft
        + 1 rows) through ``verify_chunk`` on the dense all-slot view (an
        int8 pool dequantized in the model dtype), the rows go back
        through the tables (quantized again for an int8 pool), every
        position is sampled, the longest prefix agreeing with the draft is
        accepted ON DEVICE, and the slot's length and tail advance to the
        accepted state IN PLACE. Rejected rows stay above the length,
        masked until the next append overwrites them. Returns ys [slots,
        W] then acc [slots], flat int32.

        ``g=True`` is ``llm.step_v{W}g`` (JAX ``_make_paged_verify_op_c``):
        position i is masked at the DFA state after the first i draft
        tokens, and a selected slot's state advances to the accepted
        state plus the bonus token.

        A contiguous engine (JAX ``_verify``) appends on its slab or ring
        in place (``ring=``): the rejected rows stay above the length, on a
        ring one lap behind their position and outside every window
        (``chunk_prefill_attention``'s rollback contract)."""
        Kd, cfg, sc = self.spec_draft, self.cfg, self.pool_scales
        vp, length = self._in.verify(), self.cache.length
        drafts, n_draft, sel = vp[:, :Kd], vp[:, Kd], vp[:, Kd + 1] == 1
        n_in = torch.where(sel, n_draft + 1, 0)
        toks = torch.cat([self._tail[:, None], drafts], dim=1)
        aids = self._in.aids() if self.lora_slots else None
        j = torch.arange(Kd + 1, device=self.device)[None, :]
        if self.kv.paged:
            tables = self._in.tables()
            dense = gather_slots(
                self.pool.k, self.pool.v, tables, length,
                scales=None if sc is None else (sc[0], sc[1]), dtype=cfg.dtype,
            )
            logits, nd = verify_chunk(self.params, cfg, toks, dense, length, n_in, aids=aids)
            pos = length[:, None].long() + j
            valid = (j < n_in[:, None]) & (pos < self.kv.capacity)
            scatter_rows(
                self.pool.k, self.pool.v, tables, _rows_at(nd.k, pos), _rows_at(nd.v, pos), pos, valid, scales=sc,
            )
        else:
            logits, _ = verify_chunk(self.params, cfg, toks, self.cache, length, n_in, aids=aids, ring=self.kv.ring)
        if g:
            gtab, gids = self._gtab, self._in.gids()
            st, states, ys_list = self._gstate, [self._gstate], []
            for i in range(Kd + 1):
                rows, on = _g_rows(gtab, gids, st)
                ys_list.append(finite_guard(
                    logits[:, i], _sample_raw(_g_mask(logits[:, i], rows, on), self._temps, self._gen)
                ))
                if i < Kd:
                    st = torch.where(on, rows.gather(1, drafts[:, i].clamp(min=0).long()[:, None])[:, 0], st)
                    states.append(st)
            ys = torch.stack(ys_list, dim=1)
        else:
            ys = torch.stack([self._sample(logits[:, i], self._temps, self._gen) for i in range(Kd + 1)], dim=1)
        agree = (ys[:, :Kd] == drafts) & (j[:, :Kd] < n_draft[:, None])
        acc = torch.cumprod(agree.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
        bonus = ys.gather(1, acc[:, None].long())[:, 0]
        if g:
            st_acc = torch.stack(states, dim=1).gather(1, acc[:, None].long())[:, 0]
            rows_a, on_a = _g_rows(gtab, gids, st_acc)
            nxt = rows_a.gather(1, bonus.clamp(min=0).long()[:, None])[:, 0]
            self._gstate.copy_(torch.where(sel & on_a, nxt, self._gstate))
        length.copy_(torch.where(sel, length + acc + 1, length))
        self._tail.copy_(torch.where(sel, bonus, self._tail))
        return torch.cat([ys.reshape(-1), acc])


def _own_copy(tree, device: torch.device):
    """A copy of a params tree on ``device`` that shares no storage with
    ``tree`` (a replica must never read another replica's tensors)."""
    if isinstance(tree, dict):
        return {k: _own_copy(v, device) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.q.to(device, copy=True), tree.s.to(device, copy=True))
    return torch.as_tensor(tree).to(device, copy=True)


class ReplicatedLLMEngine:
    """N ``LLMEngine`` replicas behind a per-request router (JAX
    ``ReplicatedLLMEngine``, llm.py:7336-8624, without meshes): each
    replica holds its own weight copy, KV and threads.

    Routing: "least_loaded" by queued tokens (``load_tokens``, then
    ``load``), or "round_robin"; a session's next turn prefers the replica
    that holds it. One ``FairLedger`` serves every replica;
    ``fleet_max_queue_tokens`` (``TPU_LLM_FLEET_MAX_QUEUE_TOKENS``, 0 off)
    refuses a submit past the summed queued tokens (batch class at
    ``TPU_LLM_FLEET_BATCH_FACTOR`` of it) with a Retry-After; router
    retries draw from a ``RetryBudget`` (``TPU_LLM_RETRY_BUDGET_PER_S``,
    ``_BURST``). A dying replica's recoverable requests fail over to a
    live one (``_failover``): each continuation's prompt takes the tokens
    already streamed, so a greedy stream resumes token for token; up to
    ``failover_retries`` (``TPU_LLM_FAILOVER_RETRIES``, 2) times, and a
    request in flight across ``poison_deaths`` (``TPU_LLM_POISON_DEATHS``,
    2; 0 off) deaths ends "poison". ``supervise`` rebuilds dead replicas
    (``resilience.ReplicaSupervisor``) behind the canary gate
    (``TPU_LLM_CANARY``, on), billing each death to the device ledger.

    Placement: one replica per entry of ``devices`` (default: ``replicas``
    of the engine's device, ``cuda`` unless ``device="cpu"`` is passed).
    Unlike the JAX fleet, ``devices`` may repeat a device: each replica
    has a home SEAT (device key, ordinal), occupancy is counted per seat,
    and the health unit stays the device, so a quarantined card parks
    every dead slot on it while its live replicas serve on. On distinct
    devices the policy is the JAX fleet's: a rebuild lands home, else on
    an alternate device, else parks.

    Versions (JAX llm.py:7416-7436, :7818-7923): the fleet retains ``(cfg,
    params)`` per model version (``_versions``; ``version`` is the active
    one), each slot's version (``_slot_versions``, mixed only mid-rollout),
    and a ring of the last 8 accepted prompts (``_shadow_ring``, the
    shadow replay's source). ``deploy`` stages a version and starts a
    ``resilience.rollout.RolloutController``, which holds the slots it
    drains and rebuilds (``_rollout_hold``; the supervisor leaves them
    alone). A continuation that has streamed tokens fails over only to a
    replica of its version."""

    def __init__(
        self,
        cfg,
        params,
        *,
        replicas: int | None = None,
        devices: list | None = None,
        router: str = "least_loaded",
        logger=None,
        supervise: bool = True,
        version: str = "v1",
        failover_retries: int | None = None,
        fleet_max_queue_tokens: int | None = None,
        retry_budget_per_s: float | None = None,
        retry_budget_burst: float | None = None,
        poison_deaths: int | None = None,
        canary: bool | None = None,
        health_ledger: DeviceHealthLedger | None = None,
        **engine_kw,
    ):
        if "meshes" in engine_kw:
            raise NotImplementedError("ReplicatedLLMEngine: meshes (tensor-parallel replicas) are not ported")
        if router not in ("least_loaded", "round_robin"):
            raise ValueError(f"unknown router {router!r}")
        env = os.environ.get
        self.router = router
        self._rr = itertools.count()
        dev = engine_kw.pop("device", None)
        if devices is None:
            devices = [resolve_device(dev)] * (replicas or 1)
        else:
            devices = [resolve_device(d) for d in devices]
            if replicas is not None and len(devices) < replicas:
                raise ValueError(f"need {replicas} devices for {replicas} replicas, have {len(devices)}")
        if not devices:
            raise ValueError("no replicas configured")
        self.logger = logger
        self.label = engine_kw.pop("kv_label", "llm")
        engine_kw.pop("version", None)
        self.version = str(version)
        # the versions registry: the rebuilds' source per version (each
        # replica copies its params); what each slot serves now; the slots
        # the rollout controller owns; the active or last rollout
        self._versions: dict[str, tuple] = {self.version: (cfg, params)}
        self._slot_versions = [self.version] * len(devices)
        self._rollout_hold: set[int] = set()
        self._rollout = None
        self._rollout_lock = threading.Lock()
        self._shadow_ring: deque = deque(maxlen=8)
        self._specs = [{"device": d} for d in devices]
        self._device_keys = [device_key(d) for d in devices]  # home devices
        self._current_keys = list(self._device_keys)  # where each slot runs now
        seen: dict[str, int] = {}
        self._seats = []  # home seats: (device key, ordinal among the slots on it)
        for k in self._device_keys:
            self._seats.append((k, seen.get(k, 0)))
            seen[k] = seen.get(k, 0) + 1
        self._home_count = seen
        self._current_seats = list(self._seats)
        # every device a rebuild may use: the platform's devices
        if devices[0].type == "cuda":
            pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            pool = [torch.device("cpu")]
        self._device_pool = [({"device": d}, device_key(d)) for d in pool]
        self._session_affinity: OrderedDict[str, int] = OrderedDict()
        self._session_affinity_cap = 65536
        if failover_retries is None:
            failover_retries = int(env("TPU_LLM_FAILOVER_RETRIES", "2"))
        self.failover_retries = max(0, failover_retries)
        self.failovers = 0
        self.failover_errors = 0
        self._draining = False
        # one fair ledger for every replica (and every rebuild)
        fq = engine_kw.get("fair_queuing")
        if fq is None:
            fq = env("TPU_LLM_FAIR", "1") != "0"
        if fq:
            weights = engine_kw.pop("fair_weights", None)
            if engine_kw.get("fair_ledger") is None:
                engine_kw["fair_ledger"] = FairLedger(weights)
            elif weights:
                for c, w in weights.items():
                    engine_kw["fair_ledger"].set_weight(c, w)
        self.ledger = engine_kw.get("fair_ledger")
        # ONE usage meter for every replica and rebuild (JAX
        # llm.py:7478-7495): a tenant's window and its quota are fleet
        # totals, whichever replica admitted its requests
        gp_on, win = goodput_knobs(engine_kw.get("goodput"), engine_kw.get("usage_window_s"))
        if gp_on and engine_kw.get("usage_meter") is None:
            engine_kw["usage_meter"] = UsageMeter(window_s=win)
        self.usage = engine_kw.get("usage_meter")
        if fleet_max_queue_tokens is None:
            fleet_max_queue_tokens = int(env("TPU_LLM_FLEET_MAX_QUEUE_TOKENS", "0") or 0)
        self.fleet_max_queue_tokens = max(0, int(fleet_max_queue_tokens))
        self.fleet_batch_factor = min(1.0, max(0.0, float(env("TPU_LLM_FLEET_BATCH_FACTOR", "0.8") or 0.8)))
        self.fleet_rejected = 0
        if retry_budget_per_s is None:
            retry_budget_per_s = float(env("TPU_LLM_RETRY_BUDGET_PER_S", "1.0") or 0.0)
        if retry_budget_burst is None:
            retry_budget_burst = float(env("TPU_LLM_RETRY_BUDGET_BURST", "10") or 0.0)
        self.retry_budget = RetryBudget(retry_budget_per_s, retry_budget_burst)
        self.retry_budget_exhausted = 0
        self.health = health_ledger if health_ledger is not None else DeviceHealthLedger(logger=logger)
        if poison_deaths is None:
            poison_deaths = int(env("TPU_LLM_POISON_DEATHS", "2") or 0)
        self.poison_deaths = max(0, int(poison_deaths))
        self.poisoned = 0
        if canary is None:
            canary = env("TPU_LLM_CANARY", "1") != "0"
        self._canary_enabled = bool(canary)
        self._canary_ref: dict[str, list[int]] = {}  # a healthy replica's probe tokens, per version
        self._adapters_host: dict[str, dict] = {}  # re-staged on every rebuild
        self._engine_kw = engine_kw
        # one at a time: on one card a capture syncs the device, and the
        # first build's failure must close what came up
        self.engines: list[LLMEngine] = []
        try:
            for i in range(len(devices)):
                self.engines.append(self._build_replica(i))
        except BaseException:
            for e in self.engines:
                e.close()
            raise
        # a quarantine dumps a bundle from a live replica: the dying
        # replica's own _die bundle holds its corpse, this one the fleet
        # around it (JAX llm.py:7597-7602)
        self.health.on_quarantine = lambda device, why: self.incident(
            "quarantine", reason=f"device {device} quarantined ({why})"
        )
        self.supervisor: ReplicaSupervisor | None = None
        if supervise:
            self.supervisor = ReplicaSupervisor(
                self, interval_s=float(env("TPU_LLM_SUPERVISOR_INTERVAL_S", "0.5")),
                backoff_s=float(env("TPU_LLM_RESTART_BACKOFF_S", "1.0")),
                backoff_max_s=float(env("TPU_LLM_RESTART_BACKOFF_MAX_S", "30")),
            )

    @property
    def cfg(self):
        """The active version's config."""
        return self._versions[self.version][0]

    @property
    def params(self):
        """The active version's retained params."""
        return self._versions[self.version][1]

    # -- replicas: build, place, gate ---------------------------------------
    def _build_replica(self, i: int, spec: dict | None = None, version: str | None = None) -> LLMEngine:
        """Build (and warm) slot ``i`` on its home seat or on ``spec``'s
        (the supervisor's placement) from ``_versions[version]`` (default:
        the slot's recorded version; the rollout controller passes the
        staged or the retained old one), with its own weight copy, the
        failover hook, and the fleet's adapters re-staged. The
        ``device_sick`` seam refuses a build on a matching device key."""
        version = self._slot_versions[i] if version is None else version
        cfg, params = self._versions[version]
        spec = dict(self._specs[i]) if spec is None else dict(spec)
        spec.pop("seat", None)
        key = spec_device_key(spec)
        inj = self._engine_kw.get("fault_injector") or default_injector()
        if inj.take("device_sick", key) is not None:
            if self.logger is not None:
                self.logger.warn(f"fault injection: device_sick fired on {key}")
            raise InjectedFault(f"device_sick: build refused on {key}")
        dev = resolve_device(spec["device"])
        eng = LLMEngine(
            cfg, _own_copy(params, dev), logger=self.logger, kv_label=f"{self.label}/r{i}", version=version,
            device=dev, **self._engine_kw,
        )
        eng.failover_hook = self._failover
        if eng.lora_slots:
            for name, rec in list(self._adapters_host.items()):
                try:
                    eng.load_adapter(name, rec["adapter"], version=rec["version"], alpha=rec["alpha"],
                                     fair_weight=rec["fair_weight"])
                except Exception as ex:  # noqa: BLE001
                    if self.logger is not None:
                        self.logger.warn(f"adapter {name!r} re-stage failed on rebuilt replica: {ex}")
        return eng

    def _spec_for_rebuild(self, i: int) -> tuple[dict, str] | None:
        """Placement for rebuilding slot ``i`` (JAX ``_spec_for_rebuild``,
        by seat): its home seat when the home device is usable (healthy,
        or on probation behind the canary) and no other live replica sits
        there; else the first free seat of another usable device; None
        (park) when there is none."""
        hkey, hseat = self._device_keys[i], self._seats[i]
        used = {self._current_seats[j] for j, e in enumerate(self.engines) if j != i and e.alive()}
        if self.health.usable(hkey) and hseat not in used:
            return dict(self._specs[i], seat=hseat), hkey
        for spec, k in self._device_pool:
            if k == hkey or not self.health.usable(k):
                continue
            for n in range(max(1, self._home_count.get(k, 0))):
                if (k, n) not in used:
                    return dict(spec, seat=(k, n)), k
        return None

    def _settle(self, i: int, replacement: LLMEngine, spec: dict, key: str) -> None:
        """Route to a gated replacement in slot ``i`` (the supervisor's swap)."""
        self.engines[i] = replacement  # one item assignment: routers see the old or the new
        self._current_keys[i] = key
        self._current_seats[i] = spec.get("seat", (key, 0))

    def _canary_check(self, replacement: LLMEngine) -> tuple[bool, str]:
        """The canary gate: the fixed greedy probe, token-compared with a
        healthy same-version replica's (cached per version), else judged
        complete and in-vocabulary; a candidate's own passing tokens seed
        the reference only when no same-version peer exists."""
        if not self._canary_enabled:
            return True, "disabled"
        v = replacement.version
        ref = self._canary_ref.get(v)
        has_peer = False
        if ref is None:
            for e in self.engines:
                if e is replacement or not e.accepting() or e.version != v:
                    continue
                has_peer = True
                try:
                    ref = e.generate(list(CANARY_PROMPT), max_new_tokens=CANARY_MAX_NEW, temperature=0.0, eos_token=-1,
                                     probe=True)
                    if len(ref) == CANARY_MAX_NEW:
                        self._canary_ref[v] = ref
                        break
                    ref = None
                except Exception:  # noqa: BLE001 — a sick reference is no reference
                    ref = None
        ok, detail, toks = canary_check(replacement, ref)
        if ok and ref is None and not has_peer:
            self._canary_ref[v] = toks
        return ok, detail

    # -- the model lifecycle (resilience.rollout) -------------------------------
    def deploy(self, cfg=None, params=None, *, version: str | None = None, bake_s: float | None = None,
               shadow_probes: int | None = None, drain_timeout_s: float | None = None) -> dict:
        """Stage a new model version and shift the fleet onto it with zero
        downtime (JAX ``deploy``): the ``RolloutController`` drains one
        replica at a time, rebuilds it on the new weights, gates it (canary
        and shadow replay), routes it, and watches a bake window; any
        regression rolls every upgraded slot back. ``params`` are validated
        against ``cfg`` (default: the active config) before anything
        changes. Returns the rollout's snapshot at once."""
        from .models.checkpoint import validate_params
        from .resilience.rollout import RolloutController, RolloutError, RolloutInProgress

        if params is None:
            raise RolloutError("deploy() needs params (the new weights)")
        cfg = self.cfg if cfg is None else cfg
        validate_params(params, cfg)  # the typed 4xx before anything moves
        with self._rollout_lock:
            if self._rollout is not None and self._rollout.active():
                raise RolloutInProgress(
                    f"rollout to {self._rollout.to_version!r} already in progress (state {self._rollout.state})"
                )
            if self._draining:
                raise EngineDraining("fleet draining; refusing rollout")
            if version is None:
                version = self._derive_version()
            if version in self._versions:
                raise RolloutError(f"model version {version!r} already exists (known: {sorted(self._versions)})")
            self._versions[version] = (cfg, params)
            ctl = RolloutController(self, version, bake_s=bake_s, shadow_probes=shadow_probes,
                                    drain_timeout_s=drain_timeout_s)
            self._rollout = ctl
            ctl.start()
        return ctl.snapshot()

    def _derive_version(self) -> str:
        """The next free label of the v<N> sequence."""
        nums = [int(m.group(1)) for v in self._versions for m in [re.match(r"^v(\d+)$", v)] if m]
        n = (max(nums) + 1) if nums else (len(self._versions) + 1)
        while f"v{n}" in self._versions:
            n += 1
        return f"v{n}"

    def version_counts(self) -> dict[str, int]:
        """Live replicas per model version (mixed only mid-rollout). (JAX's
        ``app_llm_model_version_info`` gauge reads it: ROADMAP ID 10.)"""
        counts: dict[str, int] = {}
        for e in self.engines:
            if e.alive():
                counts[e.version] = counts.get(e.version, 0) + 1
        return counts

    def rollout_state(self) -> dict | None:
        """The active (or last) rollout's snapshot; None before any deploy."""
        ctl = self._rollout
        return None if ctl is None else ctl.snapshot()

    # -- adapters (fan-out) ----------------------------------------------------
    def load_adapter(self, name: str, adapter: dict, *, version: str = "v1", alpha: float | None = None,
                     fair_weight: float | None = None) -> int:
        """Load ``adapter`` on every live replica and keep it for rebuilds;
        returns the replicas that took it (raises when none did)."""
        errs: list[Exception] = []
        done = 0
        for e in self.engines:
            if not e.alive():
                continue
            try:
                e.load_adapter(name, adapter, version=version, alpha=alpha, fair_weight=fair_weight)
                done += 1
            except Exception as ex:  # noqa: BLE001
                errs.append(ex)
        if not done:
            raise errs[0] if errs else EngineStoppedError("all replicas dead")
        self._adapters_host[name] = {"adapter": adapter, "version": str(version), "alpha": alpha,
                                     "fair_weight": fair_weight}
        return done

    def publish_adapter(self, staging: str, name: str) -> int:
        """Commit a staged hot-load on every live replica; returns how many."""
        done = 0
        for e in self.engines:
            if not e.alive():
                continue
            try:
                e.publish_adapter(staging, name)
                done += 1
            except Exception:  # noqa: BLE001 — a replica without the staging name
                pass
        rec = self._adapters_host.pop(staging, None)
        if rec is not None:
            self._adapters_host[name] = rec
        return done

    def evict_adapter(self, name: str) -> int:
        """Retire ``name`` on every live replica; returns how many held it."""
        self._adapters_host.pop(name, None)
        done = 0
        for e in self.engines:
            if not e.alive():
                continue
            try:
                e.evict_adapter(name)
                done += 1
            except KeyError:
                pass
        return done

    def adapters(self) -> dict:
        """The first live replica's pool snapshot plus the fleet's names."""
        lead = next((e for e in self.engines if e.alive()), None)
        snap = lead.adapters() if lead is not None else {
            "slots": 0, "resident": {}, "zombies": [], "evictions": 0, "swaps": 0,
        }
        return {**snap, "registered": sorted(self._adapters_host)}

    # -- routing ---------------------------------------------------------------
    def _pick(self, exclude=frozenset(), version: str | None = None) -> LLMEngine:
        """A replica that accepts work (alive, not draining), not in
        ``exclude``, of ``version`` when given."""
        live = [
            e for e in self.engines
            if e.accepting() and id(e) not in exclude and (version is None or e.version == version)
        ]
        if not live:
            if any(e.alive() for e in self.engines if version is None or e.version == version):
                raise EngineDraining("all replicas draining")
            raise EngineStoppedError(
                "all replicas dead" if version is None else f"no live replica serves model version {version!r}"
            )
        if self.router == "round_robin" or len(live) == 1:
            return live[next(self._rr) % len(live)]
        return min(live, key=lambda e: (e.load_tokens(), e.load()))

    def submit(self, req: GenRequest) -> GenRequest:
        """Route ``req`` (JAX ``ReplicatedLLMEngine.submit``): the fleet's
        queued-token cap (``EngineOverloaded``), a fast 404 for an adapter
        no replica holds, session affinity, then the pick; a replica that
        stopped or began draining between the pick and its submit is
        retried elsewhere (``EngineStoppedError``, ``EngineDraining``,
        ``UnknownAdapterError`` are retryable; ``EngineOverloaded`` is not),
        each retry drawing from the retry budget."""
        if self.fleet_max_queue_tokens > 0:
            queued = sum(e.load_tokens() for e in self.engines if e.accepting())
            cap = self.fleet_max_queue_tokens
            if req.priority == "batch":
                cap = int(cap * self.fleet_batch_factor)
            if queued >= cap:
                self.fleet_rejected += 1
                raise EngineOverloaded(
                    f"fleet queue full ({queued} >= {cap} queued tokens"
                    + (" at batch-class headroom)" if cap < self.fleet_max_queue_tokens else ")"),
                    retry_after=self._fleet_retry_after(queued),
                )
        if req.adapter and req.adapter not in self._adapters_host:
            if not any(req.adapter in e.adapters()["resident"] for e in self.engines if e.alive()):
                raise UnknownAdapterError(req.adapter, self._adapters_host)
        prefer = None
        sid = req.session_id
        if sid:
            eid = self._session_affinity.get(sid)
            if eid is not None:
                prefer = next((e for e in self.engines if id(e) == eid), None)
                if prefer is not None and not prefer.accepting():
                    prefer = None
        tried: set[int] = set()
        first_err: Exception | None = None
        for attempt in range(2 * len(self.engines) + 2):
            if attempt > 0 and not self.retry_budget.take():
                self.retry_budget_exhausted += 1
                raise first_err
            eng = prefer if prefer is not None and id(prefer) not in tried else self._pick(exclude=tried)
            try:
                out = eng.submit(req)
            except (EngineStoppedError, EngineDraining, UnknownAdapterError) as e:
                first_err = first_err or e
                tried.add(id(eng))
                continue
            if sid:
                self._session_affinity.pop(sid, None)
                self._session_affinity[sid] = id(eng)
                while len(self._session_affinity) > self._session_affinity_cap:
                    self._session_affinity.popitem(last=False)
            # the shadow replay's source: a prefix of each accepted prompt
            self._shadow_ring.append(tuple(req.prompt_tokens[:32]))
            return out
        raise first_err or EngineStoppedError("all replicas dead")

    def _fleet_retry_after(self, queued_tokens: int) -> float:
        """The backlog past the cap at the fleet's pooled throughput (1 s
        without a measurement)."""
        tput = self.throughput_tok_s()
        if tput is None:
            return 1.0
        excess = max(0, queued_tokens - self.fleet_max_queue_tokens)
        return max(0.5, excess / tput) if excess else 1.0

    # -- in-flight failover ------------------------------------------------------
    def _failover(self, reqs: list[GenRequest]) -> None:
        """A dying replica's rescued requests (JAX ``_failover``): each
        re-dispatched to a live replica as a continuation whose prompt
        holds the tokens already streamed, so the consumer's stream
        resumes where it stood. A request in flight for ``poison_deaths``
        deaths ends "poison"; one whose retries or budget are spent, or
        that finds no live replica (of its version, once it has streamed),
        ends "error". An overloaded survivor is waited for, up to 5 s for
        the whole batch."""
        batch_deadline = time.perf_counter() + 5.0
        for r in reqs:
            if self.poison_deaths and r.deaths >= self.poison_deaths:
                self.poisoned += 1
                if self.logger is not None:
                    self.logger.error(f"poison quarantine: request {r.id} implicated in {r.deaths} replica deaths; "
                                      "failover refused")
                r.finish_reason = "poison"
                r.out.put(None)
                continue
            r.retries += 1
            placed = False
            budget_ok = True
            if r.retries <= self.failover_retries:
                budget_ok = self.retry_budget.take()
                if not budget_ok:
                    self.retry_budget_exhausted += 1
            if budget_ok and r.retries <= self.failover_retries:
                replay_to = r.prefill_pos
                if r.history:
                    r.prompt_tokens = list(r.prompt_tokens) + r.history
                    r.history = []
                    replay_to = len(r.prompt_tokens)
                r._replay_pos = max(r._replay_pos, replay_to)
                # the engine-owned state starts over; the stream carries on
                r.finish_reason = None
                r.prefill_pos = r._rows_hi = 0
                r.prefill_done = False
                r.slot = None
                r._load_acct = 0
                r._kv_limit = r._kv_resv = 0
                r._kv_plan = r._prefix_entry = None
                r._g_id = -1
                r._aid = 0
                pin = r.engine_version if r.emitted > 0 else None
                tried: set[int] = set()
                first_try = True
                while first_try or time.perf_counter() < batch_deadline:
                    first_try = False
                    try:
                        eng = self._pick(exclude=tried, version=pin)
                    except (EngineStoppedError, EngineDraining):
                        break
                    try:
                        eng.submit(r)
                        placed = True
                        break
                    except (EngineStoppedError, EngineDraining):
                        tried.add(id(eng))
                    except EngineOverloaded:
                        time.sleep(0.05)
                    except ValueError:
                        break  # the continuation no longer fits the cache
            if placed:
                self.failovers += 1
                if self.logger is not None:
                    self.logger.warn(f"failover: request {r.id} re-dispatched (retry {r.retries}/{self.failover_retries})")
            else:
                self.failover_errors += 1
                r.error = "failover found no live replica (or its retries were spent)"
                r.finish_reason = "error"
                r.out.put(None)

    # -- the engine's surface ------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.engines[0].device

    def generate(self, prompt_tokens: list[int], **kw) -> list[int]:
        return self.submit(GenRequest(prompt_tokens, **kw)).tokens()

    def load(self) -> int:
        return sum(e.load() for e in self.engines)

    def load_tokens(self) -> int:
        return sum(e.load_tokens() for e in self.engines)

    def throughput_tok_s(self) -> float | None:
        """Pooled measured throughput of the live replicas."""
        tput = sum(e.throughput_tok_s() or 0.0 for e in self.engines if e.alive())
        return tput if tput > 1e-9 else None

    def predicted_wait_s(self) -> float | None:
        tput = self.throughput_tok_s()
        return None if tput is None else self.load_tokens() / tput

    def stats(self) -> dict:
        per = [e.stats() for e in self.engines]
        sup = self.supervisor
        return {
            "replicas": len(per),
            "replicas_alive": sum(e.alive() for e in self.engines),
            "router": self.router,
            "draining": self._draining,
            "version": self.version,
            "versions": self.version_counts(),
            "rollout": self.rollout_state(),
            "failovers": self.failovers,
            "failover_errors": self.failover_errors,
            "restarts": sup.restarts if sup else 0,
            "poisoned": self.poisoned,
            "devices_quarantined": self.health.quarantined_count(),
            "replicas_parked": sup.parked_count() if sup else 0,
            "replicas_failed": sup.failed_count() if sup else 0,
            "preemptions": sum(s["preemptions"] for s in per),
            "sheds_predicted": sum(s["sheds_predicted"] for s in per),
            "disconnect_cancels": sum(s["disconnect_cancels"] for s in per),
            "fleet_rejected": self.fleet_rejected,
            "fleet_max_queue_tokens": self.fleet_max_queue_tokens,
            "retry_budget_remaining": round(self.retry_budget.remaining(), 2),
            "retry_budget_exhausted": self.retry_budget_exhausted,
            "fairness": self.ledger.snapshot() if self.ledger is not None else None,
            "goodput": self._merged_goodput(),
            "quota_sheds": sum(e.quota_sheds for e in self.engines),
            "adapters": self.adapters(),
            "slots": sum(s["slots"] for s in per),
            "active": sum(s["active"] for s in per),
            "waiting": sum(s["waiting"] for s in per),
            "max_seq_len": per[0]["max_seq_len"],
            "decode_chunk": per[0]["decode_chunk"],
            "load_tokens": self.load_tokens(),
            "per_replica": per,
        }

    def debug_state(self) -> dict:
        return {
            "router": self.router,
            "replicas": len(self.engines),
            "replicas_alive": sum(e.alive() for e in self.engines),
            "draining": self._draining,
            "version": self.version,
            "versions_retained": sorted(self._versions),
            "slot_versions": list(self._slot_versions),
            "rollout": self.rollout_state(),
            "failovers": self.failovers,
            "failover_errors": self.failover_errors,
            "failover_retries": self.failover_retries,
            "fleet_rejected": self.fleet_rejected,
            "fleet_max_queue_tokens": self.fleet_max_queue_tokens,
            "retry_budget": {
                "remaining": round(self.retry_budget.remaining(), 2), "rate_per_s": self.retry_budget.rate,
                "burst": self.retry_budget.burst, "exhausted": self.retry_budget_exhausted,
            },
            "fairness": self.ledger.snapshot() if self.ledger is not None else None,
            "supervisor": self.supervisor.snapshot() if self.supervisor is not None else None,
            "health": self.health.snapshot(),
            "devices": {"home": list(self._device_keys), "current": list(self._current_keys),
                        "seats": [list(s) for s in self._current_seats]},
            "poison_deaths": self.poison_deaths,
            "poisoned": self.poisoned,
            "canary": self._canary_enabled,
            "goodput": self._merged_goodput(),
            "usage": self.usage.snapshot() if self.usage is not None else None,
            "per_replica": [e.debug_state() for e in self.engines],
        }

    # -- chip-time accounting and the flight recorder (JAX llm.py:8489-8580) --
    def _merged_goodput(self) -> dict | None:
        """The replicas' ledgers pooled: sums add, the ratio is recomputed
        from the pooled sums (never an average of ratios)."""
        snaps = [e.goodput.snapshot() for e in self.engines if e.goodput is not None]
        return pool_goodput(snaps) if snaps else None

    def usage_state(self) -> dict:
        """``LLMEngine.usage_state``'s shape for the fleet: the meter is
        shared, so each tenant's window is the fleet's total already."""
        usage = self.usage.snapshot() if self.usage is not None else {"window_s": None, "tenants": {}}
        lead = self.engines[0] if self.engines else None
        return {
            "replicas": len(self.engines),
            "goodput": self._merged_goodput(),
            "quota": lead.quota.snapshot() if lead is not None and lead.quota is not None else None,
            "quota_sheds": sum(e.quota_sheds for e in self.engines),
            **usage,
        }

    def set_tenant_quota(self, tenant: str, tok_s: float | None) -> None:
        """A fleet-total quota (every replica's gate reads the shared
        meter), kept in the rebuild kwargs so a rebuilt replica enforces it
        too."""
        q = self._engine_kw.setdefault("quotas", {})
        if tok_s is None or tok_s <= 0:
            q.pop(tenant, None)
        else:
            q[tenant] = float(tok_s)
        for e in self.engines:
            e.set_tenant_quota(tenant, tok_s)

    def incident(self, trigger: str, *, reason: str = "") -> str | None:
        """One bundle from the first live replica: fleet-level triggers
        (quarantine, rollback) need a witness that still holds state."""
        for e in self.engines:
            if e.alive():
                return e._incident(trigger, reason=reason)
        return None

    def replay(self, record_or_id, *, timeout: float = 120.0) -> dict:
        """Find the record on any replica (a dead one keeps its ring) and
        re-execute it on a live replica of the record's version."""
        from .flightrec import find_record, replay_record

        rec = record_or_id
        if not isinstance(rec, dict):
            rec, _owner = find_record(self, int(record_or_id))
            if rec is None:
                return {"id": record_or_id, "error": "no flight record with that id on any replica"}
        want = rec.get("model_version")
        for e in self.engines:
            if e.alive() and (not want or e.version == want):
                return replay_record(e, rec, timeout=timeout)
        return {"id": rec.get("id"), "error": f"no live replica serves version {want!r} for replay"}

    def drain(self) -> None:
        """Fleet drain: no rebuild from now on, admission closed on every
        live replica, the work in flight finishes."""
        self._draining = True
        for e in self.engines:
            if e.alive():
                e.drain()

    def drained(self) -> bool:
        # aliveness first: a watchdog-killed replica's lock may be wedged
        return all(not e.alive() or e.drained() for e in self.engines)

    def close(self) -> None:
        self._draining = True  # a rebuild racing the close must not be routed
        if self._rollout is not None:
            # a mid-shift controller stops BEFORE the engines close: it
            # would otherwise rebuild replicas into a closed fleet
            self._rollout.close()
        if self.supervisor is not None:
            self.supervisor.close()
        for e in self.engines:
            e.close()
