"""Disaggregated prefill/decode serving (counterpart of gofr_tpu/llm_disagg.py,
copied: the port imports nothing of the JAX package).

One colocated engine interleaves prefill chunks with decode chunks, so a
burst of long prompts steals decode steps from every stream.
:class:`DisaggregatedLLMEngine` splits a replicated fleet into two role
pools instead:

- **prefill pool** — replicas that run chunked prefill only: every request
  enters as an internal ``max_new_tokens=1`` probe whose prompt KV the
  engine publishes into its radix tree, with the last-token logits.
- **KV handoff** — the published blocks are gathered on the prefill
  replica's stream (``LLMEngine.kv_handoff_export``, which records an
  event behind the gather) and moved to a decode replica: a device copy
  onto the decode engine's ``kv_placement()`` on a copy stream that waits
  on that event (``TPU_LLM_KV_HANDOFF_D2D=1``, the default; on one card a
  device-to-device copy, never a trip through the host), or pinned host
  staging (``TPU_LLM_KV_HANDOFF_D2D=0``, the byte-identity oracle, not a
  fallback: a failed device copy is a counted miss). The decode engine
  scatters them in on its own stream (``kv_handoff_import``) as an exact
  radix record WITH the logits.
- **decode pool** — the caller's request then admits on that decode replica
  as an exact prefix hit: no prefill runs, the first token is sampled from
  the handed-over logits, and decode reads the transferred blocks. Greedy
  streams equal the colocated engine's: the exact-hit path is held equal
  to the uncached one, and the handoff moves bytes.

Routing is by role: prefill replicas by queued prompt tokens, decode
replicas by resident slots. Every failure degrades to a colocated submit:
a dead decode pool re-prefills on a live prefill replica, a missing
publish or a full pool costs a re-prefill on the decode side.

The JAX engine's ``app_llm_kv_handoff*`` and ``app_llm_collective_seconds``
series and its ``llm.disagg`` / ``disagg.*`` spans come with the port's
metrics and tracing (ROADMAP ID 10); the counters they read are here.
Tensor-parallel role pools (``meshes=``) wait for ROADMAP ID 11.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import torch

from . import resolve_device
from .llm import EngineDraining, EngineOverloaded, EngineStoppedError, GenRequest, ReplicatedLLMEngine
from .resilience import FairLedger

__all__ = ["DisaggregatedLLMEngine"]

_HANDOFF_TENSORS = ("k", "v", "sc", "logits")


def _summary(values) -> dict:
    """{count, p50, p99, max} of a sample (exact order statistics)."""
    xs = sorted(values)
    if not xs:
        return {"count": 0, "p50": 0.0, "p99": 0.0, "max": 0.0}
    return {"count": len(xs), "p50": xs[len(xs) // 2], "p99": xs[min(len(xs) - 1, int(0.99 * len(xs)))],
            "max": xs[-1]}


class DisaggregatedLLMEngine:
    """Prefill-role and decode-role replica pools behind one
    ``LLMEngine``-shaped surface (submit, generate, stats, drain, close).
    ``replicas`` (default 2; or one entry of ``devices`` each, which may
    repeat a device) are split: the first ``prefill_replicas``
    (``TPU_LLM_DISAGG_PREFILL_REPLICAS``, 1) form the prefill pool, the
    rest decode. Each pool is a full ``ReplicatedLLMEngine`` (supervision,
    rebuilds, canary, in-pool failover), and both share ONE fairness
    ledger. ``handoff_timeout_s`` (``TPU_LLM_KV_HANDOFF_TIMEOUT_S``, 10)
    bounds each export and import; ``handoff_d2d``
    (``TPU_LLM_KV_HANDOFF_D2D``, on unless "0") picks the device copy or
    host staging. The handoff needs the paged pool's radix tree, so
    ``prefix_cache_mb`` is forced to 64 when neither it nor ``session_mb``
    asks for a budget."""

    def __init__(
        self,
        cfg,
        params,
        *,
        prefill_replicas: int | None = None,
        replicas: int | None = None,
        devices: list | None = None,
        meshes: list | None = None,
        handoff_timeout_s: float | None = None,
        handoff_d2d: bool | None = None,
        handoff_workers: int = 32,
        logger=None,
        supervise: bool = True,
        version: str = "v1",
        **engine_kw,
    ):
        if engine_kw.get("kv_paged") is False:
            raise ValueError(
                "disaggregated serving requires the paged KV pool (kv_paged=False / TPU_LLM_KV_PAGED=0 cannot "
                "hand off blocks)"
            )
        if "mesh" in engine_kw or "param_specs" in engine_kw:
            # one whole-slice mesh forwarded to every replica would put
            # both role pools on the same chips
            raise ValueError(
                "disaggregated serving takes meshes=[(mesh, specs), ...] (one disjoint submesh per replica), not "
                "a single mesh/param_specs pair shared by every replica"
            )
        if meshes is not None:
            raise NotImplementedError("DisaggregatedLLMEngine: meshes (tensor-parallel role pools) are not ported")
        # the handoff rides the radix tree: a retention budget when neither
        # the prefix cache nor the session tier asked for one
        if float(engine_kw.get("prefix_cache_mb") or 0.0) <= 0 and float(engine_kw.get("session_mb") or 0.0) <= 0:
            engine_kw["prefix_cache_mb"] = 64.0
        env = os.environ.get
        if prefill_replicas is None:
            prefill_replicas = int(env("TPU_LLM_DISAGG_PREFILL_REPLICAS", "1") or 1)
        if handoff_timeout_s is None:
            handoff_timeout_s = float(env("TPU_LLM_KV_HANDOFF_TIMEOUT_S", "10") or 10.0)
        if handoff_d2d is None:
            handoff_d2d = env("TPU_LLM_KV_HANDOFF_D2D", "1") != "0"
        self.handoff_timeout_s = max(0.1, float(handoff_timeout_s))
        self.handoff_d2d = bool(handoff_d2d)
        self.logger = logger
        self.label = engine_kw.pop("kv_label", "llm")
        self.version = str(version)
        dev = engine_kw.pop("device", None)
        if devices is None:
            devices = [resolve_device(dev)] * max(2, int(replicas or 2))
        else:
            devices = [resolve_device(d) for d in devices]
        P = int(prefill_replicas)
        if not 0 < P < len(devices):
            raise ValueError(f"prefill_replicas={P} must leave both pools non-empty over {len(devices)} devices")
        self.prefill_replicas = P
        # ONE fairness ledger across both pools: least-served ordering holds
        # whichever role a request's work lands on
        fq = engine_kw.get("fair_queuing")
        if fq is None:
            fq = env("TPU_LLM_FAIR", "1") != "0"
        if fq and engine_kw.get("fair_ledger") is None:
            engine_kw["fair_ledger"] = FairLedger(engine_kw.pop("fair_weights", None))
        self._stop = False
        self._draining = False
        self.submitted = 0
        self.handoffs_ok = 0  # decode admitted on transferred blocks
        self.handoffs_miss = 0  # no handoff: the decode side re-prefilled
        self.fallbacks = 0  # whole requests served colocated (a pool down)
        self.handoff_bytes = 0  # K/V bytes moved by the handoffs that were ok
        self._handoff_window: deque = deque(maxlen=512)  # submit -> decode-admit seconds of each ok
        self._copy_streams: dict = {}  # target device -> the d2d copies' stream
        if logger is not None:
            logger.info(
                f"disaggregated LLM serving: {P} prefill + {len(devices) - P} decode replicas, handoff "
                f"{'d2d' if self.handoff_d2d else 'host-staged'}, timeout {self.handoff_timeout_s:.1f}s"
            )
        self.prefill = ReplicatedLLMEngine(
            cfg, params, devices=devices[:P], logger=logger, supervise=supervise, version=version,
            kv_label=f"{self.label}/prefill", role="prefill", **engine_kw,
        )
        try:
            self.decode = ReplicatedLLMEngine(
                cfg, params, devices=devices[P:], logger=logger, supervise=supervise, version=version,
                kv_label=f"{self.label}/decode", role="decode", **engine_kw,
            )
        except BaseException:
            self.prefill.close()
            raise
        self._pool = ThreadPoolExecutor(max_workers=max(1, int(handoff_workers)),
                                        thread_name_prefix="llm-disagg-handoff")
        self._lock = threading.Lock()

    # -- role-specific routing ---------------------------------------------
    def _pick_prefill(self, exclude=frozenset()):
        """Least queued prompt tokens: the prefill pool runs only the
        one-token probes, so its ``load_tokens`` is its queued prompts."""
        live = [e for e in self.prefill.engines if e.accepting() and id(e) not in exclude]
        if not live:
            return None
        return min(live, key=lambda e: (e.load_tokens(), e.load()))

    def _pick_decode(self, exclude=frozenset()):
        """Fewest resident slots; queue depth and queued tokens break ties."""
        live = [e for e in self.decode.engines if e.accepting() and id(e) not in exclude]
        if not live:
            return None
        return min(live, key=lambda e: (e.resident_slots(), e.load(), e.load_tokens()))

    # -- the LLMEngine surface -------------------------------------------------
    def submit(self, req: GenRequest) -> GenRequest:
        """Admit the internal probe on a prefill replica now (so overload
        and validation errors reach the caller, as a colocated submit's
        do), then hand the rest to a handoff worker (``_serve``). A session
        turn goes to the decode pool, which keeps the conversation's KV."""
        if self._stop:
            raise EngineStoppedError("engine stopped")
        if self._draining:
            raise EngineDraining("engine draining (rolling deploy)")
        with self._lock:
            self.submitted += 1
        if req.session_id:
            return self.decode.submit(req)
        peng = self._pick_prefill()
        if peng is None:
            # the prefill pool is down: colocated on the decode pool
            with self._lock:
                self.fallbacks += 1
            return self.decode.submit(req)
        # JAX opens an llm.disagg span here (ROADMAP ID 10)
        preq = GenRequest(list(req.prompt_tokens), max_new_tokens=1, temperature=0.0, eos_token=-1,
                          priority=req.priority, client=req.client, deadline=req.deadline)
        tried: set[int] = set()
        while True:
            try:
                peng.submit(preq)
                break
            except (EngineStoppedError, EngineDraining):
                tried.add(id(peng))
                peng = self._pick_prefill(exclude=tried)
                if peng is None:
                    with self._lock:
                        self.fallbacks += 1
                    return self.decode.submit(req)
        self._pool.submit(self._serve, req, peng, preq, time.perf_counter())
        return req

    def _serve(self, req: GenRequest, peng, preq: GenRequest, t0: float) -> None:
        """Handoff worker: wait out the probe, move the prompt's KV to a
        decode replica, then hand the caller's request to it (an exact
        radix hit). Every failure falls back to a colocated submit; the
        stream errors only when no live replica exists anywhere."""
        try:
            try:
                preq.tokens(timeout=max(60.0, self.handoff_timeout_s))
                prefilled = preq.finish_reason in ("eos", "length")
            except Exception:  # noqa: BLE001 — the probe died with its replica
                prefilled = False
            payload = None
            if prefilled and peng.alive():
                try:
                    payload = peng.kv_handoff_export(req.prompt_tokens, timeout=self.handoff_timeout_s)
                except Exception as e:  # noqa: BLE001 — the export is best-effort
                    if self.logger is not None:
                        self.logger.warn(f"kv handoff export failed: {e!r}")
                    payload = None
            nbytes = 0 if payload is None else sum(
                payload[x].numel() * payload[x].element_size() for x in ("k", "v")
            )
            deng = self._pick_decode()
            imported = False
            if deng is not None and payload is not None:
                try:
                    imported = deng.kv_handoff_import(self._transfer(payload, deng), timeout=self.handoff_timeout_s)
                except Exception as e:  # noqa: BLE001 — the import is best-effort
                    if self.logger is not None:
                        self.logger.warn(f"kv handoff import failed: {e!r}")
                    imported = False
            placed_on = self._submit_decode(req, deng)
            # "ok" only when the replica holding the blocks took the request
            with self._lock:
                if imported and placed_on is deng:
                    self.handoffs_ok += 1
                    self.handoff_bytes += nbytes
                    self._handoff_window.append(time.perf_counter() - t0)
                else:
                    self.handoffs_miss += 1
        except BaseException as e:  # noqa: BLE001 — the stream must end
            if self.logger is not None:
                self.logger.error(f"disaggregated serve failed: {e!r}")
            if req.finish_reason is None:
                req.finish_reason = "error"
                req.error = f"disaggregated serve failed: {e!r}"
                req.out.put(None)

    def _submit_decode(self, req: GenRequest, deng):
        """Place the caller's request: the import's target first, then the
        rest of the decode pool, then the prefill pool (a colocated
        re-prefill, counted as a fallback). An overloaded replica is waited
        out inside a bounded window. Returns the engine that took it, or
        None when the stream was ended "error"."""
        deadline = time.perf_counter() + max(5.0, self.handoff_timeout_s)
        tried: set[int] = set()
        fell_back = False
        while True:
            eng = deng if (deng is not None and id(deng) not in tried) else None
            if eng is None:
                eng = self._pick_decode(exclude=tried)
            if eng is None:
                eng = self._pick_prefill(exclude=tried)
                if eng is None:
                    if req.finish_reason is None:
                        req.finish_reason = "error"
                        req.error = "no live replica in either pool"
                        req.out.put(None)
                    return None
                if not fell_back:
                    fell_back = True
                    with self._lock:
                        self.fallbacks += 1
            try:
                eng.submit(req)
                return eng
            except (EngineStoppedError, EngineDraining):
                tried.add(id(eng))
            except EngineOverloaded:
                if time.perf_counter() >= deadline:
                    if req.finish_reason is None:
                        req.finish_reason = "error"
                        req.error = "decode pool overloaded past the handoff window"
                        req.out.put(None)
                    return None
                time.sleep(0.05)

    def _copy_stream(self, device: torch.device):
        s = self._copy_streams.get(device)
        if s is None:
            s = self._copy_streams[device] = torch.cuda.Stream(device)
        return s

    def _transfer(self, payload: dict, deng) -> dict:
        """Move an export payload to the decode engine's placement. d2d: a
        device copy on this engine's copy stream after the gather's event,
        with a new event behind it for the import to wait on; the sources
        are recorded on the copy stream, so the prefill engine's allocator
        cannot hand their memory out before the copy has read it (and the
        import records the copies on the decode engine's stream in turn).
        Host-staged: pinned host copies once the gather's event has passed
        (the import copies them in on its own stream)."""
        ready = payload.get("ready")
        src = {x: payload.get(x) for x in _HANDOFF_TENSORS}
        if not self.handoff_d2d:
            if ready is not None:
                ready.synchronize()

            def host(a):
                if a.device.type == "cpu":
                    return a.clone()
                out = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                out.copy_(a)
                return out

            return dict(payload, ready=None, **{x: None if a is None else host(a) for x, a in src.items()})
        target = deng.kv_placement()
        if target.type != "cuda":
            return dict(payload, **{x: None if a is None else a.to(target, copy=True) for x, a in src.items()})
        stream = self._copy_stream(target)
        if ready is not None:
            stream.wait_event(ready)
        with torch.cuda.stream(stream):
            out = {x: None if a is None else a.to(target, non_blocking=True, copy=True) for x, a in src.items()}
        for a in src.values():
            if a is not None:
                a.record_stream(stream)
        done = torch.cuda.Event()
        done.record(stream)
        return dict(payload, ready=done, **out)

    def generate(self, prompt_tokens: list[int], **kw) -> list[int]:
        return self.submit(GenRequest(prompt_tokens, **kw)).tokens()

    def deploy(self, *a, **kw):
        """Weight rollouts are not wired for disaggregated fleets: refuse
        loudly, so ``ModelHandle.deploy`` cannot fall through to the
        bare-engine swap and replace both pools with one engine."""
        from .resilience.rollout import RolloutError

        raise RolloutError(
            "weight rollouts are not supported for disaggregated prefill/decode fleets yet; drain and replace "
            "the process instead"
        )

    # -- aggregate views -------------------------------------------------------
    @property
    def engines(self):
        return list(self.prefill.engines) + list(self.decode.engines)

    @property
    def device(self) -> torch.device:
        return self.prefill.device

    @property
    def cfg(self):
        return self.prefill.cfg

    def load(self) -> int:
        return self.prefill.load() + self.decode.load()

    def load_tokens(self) -> int:
        return self.prefill.load_tokens() + self.decode.load_tokens()

    def throughput_tok_s(self) -> float | None:
        """Pooled measured throughput of both role pools."""
        tput = sum(v for v in (self.prefill.throughput_tok_s(), self.decode.throughput_tok_s()) if v)
        return tput if tput > 1e-9 else None

    def predicted_wait_s(self) -> float | None:
        tput = self.throughput_tok_s()
        return None if tput is None else self.load_tokens() / tput

    def _handoff_view(self) -> dict:
        return {
            "ok": self.handoffs_ok, "miss": self.handoffs_miss, "fallbacks": self.fallbacks,
            "d2d": self.handoff_d2d, "timeout_s": self.handoff_timeout_s, "bytes": self.handoff_bytes,
            "latency": _summary(list(self._handoff_window)),
        }

    def stats(self) -> dict:
        pre = self.prefill.stats()
        dec = self.decode.stats()
        return {
            "disaggregated": True,
            "version": self.version,
            "draining": self._draining,
            "submitted": self.submitted,
            "prefill_replicas": pre["replicas"],
            "decode_replicas": dec["replicas"],
            "replicas": pre["replicas"] + dec["replicas"],
            "replicas_alive": pre["replicas_alive"] + dec["replicas_alive"],
            "slots": pre["slots"] + dec["slots"],
            "active": pre["active"] + dec["active"],
            "waiting": pre["waiting"] + dec["waiting"],
            "handoff": self._handoff_view(),
            "prefill": pre,
            "decode": dec,
        }

    def debug_state(self) -> dict:
        return {
            "disaggregated": True,
            "draining": self._draining,
            "handoff": self._handoff_view(),
            "prefill": self.prefill.debug_state(),
            "decode": self.decode.debug_state(),
        }

    # -- lifecycle ---------------------------------------------------------------
    def drain(self) -> None:
        self._draining = True
        self.prefill.drain()
        self.decode.drain()

    def drained(self) -> bool:
        return self.prefill.drained() and self.decode.drained()

    def close(self) -> None:
        self._stop = True
        self._draining = True
        # stop taking handoff work; workers in flight fail fast on the closing pools
        self._pool.shutdown(wait=False)
        self.prefill.close()
        self.decode.close()
