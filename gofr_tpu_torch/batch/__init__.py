"""Offline batch inference over pub/sub: the asynchronous job tier
(counterpart of gofr_tpu/batch/__init__.py).

Fire-and-forget generation jobs drained from a pub/sub topic into the
engine's ``batch`` priority class, with results published to a reply
topic or POSTed to a webhook, and recurring jobs from the framework's
cron.

Durability (at least once in, exactly once out): a job message is
committed only after its result is published, so a crash or an engine
death mid-decode leaves it uncommitted and the broker redelivers it; an
idempotence ledger keyed on the job id commits and skips a redelivery
whose result already went out, so every job yields exactly one result.

Overload: jobs submit at ``priority="batch"``, so brownout clamps them and
interactive pressure preempts them first; an ``EngineOverloaded`` shed
(429 with Retry-After), a drain or a stopped engine pauses the pull loop
for the advertised backoff and puts the job back without consuming an
attempt. MEMORY pops on delivery (commit is a no-op) and a KAFKA or MQTT
consumer moves past a record it handed out, so there a failed job is
republished with its attempt count and the original committed; FILE
redelivers the uncommitted record itself. A job past ``max_attempts``
goes to ``<topic>.dlq`` with its error.

Wire format, one JSON object a message::

    {"id": "job_1", "tokens": [1,2,3], "max_new_tokens": 32,
     "temperature": 0.0, "schema": {...}, "reply_topic": "...",
     "webhook": "http://...", "client": "tenant-a", "model": "gemma"}

``prompt`` (text) may replace ``tokens`` when the worker has a tokenizer;
``schema`` compiles (``structured.grammar_cache``) to a grammar-constrained
generation. A result mirrors the id and carries the tokens (and text),
the finish reason and the count. ``attach_batch_worker`` adds ``POST
/v1/batches`` (submit over the same topic) and ``GET /v1/batches/{id}``
(poll the ledger).
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
import uuid
from typing import Any

__all__ = [
    "BatchJob",
    "BatchStore",
    "BatchWorker",
    "attach_batch_worker",
]

_TERMINAL_OK = ("eos", "length")


class BatchJob:
    """One parsed generation job. Malformed payloads raise ValueError —
    they go straight to the DLQ (redelivering a parse error forever
    would wedge the topic)."""

    def __init__(self, data: dict):
        if not isinstance(data, dict):
            raise ValueError("job payload must be a JSON object")
        self.id = str(data.get("id") or f"job_{uuid.uuid4().hex[:12]}")
        self.model = data.get("model") or ""
        self.tokens = data.get("tokens")
        self.prompt = data.get("prompt")
        if self.tokens is None and self.prompt is None:
            raise ValueError("job needs 'tokens' or 'prompt'")
        if self.tokens is not None and (
            not isinstance(self.tokens, list)
            or not all(isinstance(t, int) for t in self.tokens)
        ):
            raise ValueError("'tokens' must be a list of ints")
        self.max_new_tokens = int(data.get("max_new_tokens", 32))
        self.temperature = float(data.get("temperature", 0.0))
        self.schema = data.get("schema")
        self.reply_topic = data.get("reply_topic") or ""
        self.webhook = data.get("webhook") or ""
        self.client = str(data.get("client") or "")
        self.session = str(data.get("session") or "")
        self.attempt = int(data.get("_attempt", 0))
        # W3C trace context injected at publish (submit edge / cron tick):
        # the worker resumes it, so the async hop does not shatter the
        # submitter's journey. Rides `raw`, so requeues and DLQ re-walks
        # keep carrying it.
        self.traceparent = str(data.get("traceparent") or "") or None
        self.raw = dict(data)

    @classmethod
    def from_payload(cls, payload: bytes) -> "BatchJob":
        return cls(json.loads(payload))


class BatchStore:
    """Bounded in-memory job ledger: idempotence for redeliveries plus
    the /v1/batches poll surface. Oldest finished entries evict first;
    in-flight/pending entries are never evicted (they gate dedup)."""

    def __init__(self, cap: int = 4096):
        self.cap = cap
        self._lock = threading.Lock()
        self._jobs: dict[str, dict] = {}
        self._batches: dict[str, list[str]] = {}

    def register(self, job_id: str, batch_id: str | None = None) -> None:
        with self._lock:
            self._jobs.setdefault(job_id, {
                "id": job_id, "status": "queued", "attempts": 0,
                "result": None, "error": None,
            })
            if batch_id is not None:
                self._batches.setdefault(batch_id, []).append(job_id)
            self._evict_locked()

    def state(self, job_id: str) -> dict | None:
        with self._lock:
            st = self._jobs.get(job_id)
            return dict(st) if st is not None else None

    def begin(self, job_id: str) -> tuple[bool, int]:
        """Claim a job for processing. Returns (claimed, attempt#):
        claimed=False when it is already running or already done — the
        redelivery/duplicate-pull guard."""
        with self._lock:
            st = self._jobs.setdefault(job_id, {
                "id": job_id, "status": "queued", "attempts": 0,
                "result": None, "error": None,
            })
            if st["status"] in ("running", "ok"):
                return False, st["attempts"]
            st["status"] = "running"
            st["attempts"] += 1
            return True, st["attempts"]

    def unclaim(self, job_id: str, error: str | None = None) -> None:
        """Give a claim back WITHOUT consuming the attempt: the
        pressure path (engine shed / drain / fleet-restart window)
        requeues the job, and billing those cycles against max_attempts
        would dead-letter a healthy job during one rebuild window."""
        with self._lock:
            st = self._jobs.get(job_id)
            if st is None:
                return
            st["status"] = "queued"
            st["attempts"] = max(0, st["attempts"] - 1)
            st["error"] = error

    def finish(self, job_id: str, *, ok: bool, result: dict | None = None,
               error: str | None = None, final: bool = False) -> None:
        with self._lock:
            st = self._jobs.get(job_id)
            if st is None:
                return
            st["status"] = "ok" if ok else ("dlq" if final else "queued")
            st["result"] = result
            st["error"] = error
            self._evict_locked()

    def batch_view(self, batch_id: str) -> dict | None:
        with self._lock:
            ids = self._batches.get(batch_id)
            if ids is None:
                return None
            jobs = {j: dict(self._jobs.get(j) or {"status": "expired"}) for j in ids}
        counts: dict[str, int] = {}
        for st in jobs.values():
            counts[st.get("status", "expired")] = (
                counts.get(st.get("status", "expired"), 0) + 1
            )
        done = counts.get("ok", 0) + counts.get("dlq", 0)
        return {
            "id": batch_id,
            "object": "batch",
            "status": "completed" if done == len(jobs) else (
                "in_progress" if counts.get("running") else "queued"
            ),
            "counts": counts,
            "jobs": jobs,
        }

    def _evict_locked(self) -> None:
        # finished first, then never-claimed queued entries (a flood of
        # POST /v1/batches registrations must not grow without bound);
        # running entries are never evicted — they gate redelivery dedup
        if len(self._jobs) > self.cap:
            for status_class in (("ok", "dlq"), ("queued",)):
                for jid in list(self._jobs):
                    if self._jobs[jid]["status"] in status_class:
                        del self._jobs[jid]
                    if len(self._jobs) <= self.cap:
                        break
                if len(self._jobs) <= self.cap:
                    break
        while len(self._batches) > self.cap:
            self._batches.pop(next(iter(self._batches)))


class BatchWorker:
    """Drains one pub/sub topic of generation jobs into an LLM engine's
    batch priority class with bounded in-flight concurrency (the engine is
    ``container.tpu().llm(model)``: the port's ``LLMEngine`` or a replica
    fleet).

    ``run()`` is an asyncio coroutine the app schedules at serve()
    (attach_batch_worker wires it); generation itself runs on executor
    threads — the engine's blocking stream consumption must not park the
    event loop."""

    def __init__(
        self,
        container,
        topic: str,
        *,
        model: str = "",
        reply_topic: str = "",
        concurrency: int = 4,
        max_attempts: int = 3,
        tokenizer: Any = None,
        poll_timeout: float = 0.5,
        store: BatchStore | None = None,
        webhook_timeout: float = 10.0,
    ):
        self.container = container
        self.topic = topic
        self.model = model
        self.reply_topic = reply_topic or f"{topic}.results"
        self.dlq_topic = f"{topic}.dlq"
        self.concurrency = max(1, int(concurrency))
        self.max_attempts = max(1, int(max_attempts))
        self.tokenizer = tokenizer
        self.poll_timeout = poll_timeout
        self.webhook_timeout = webhook_timeout
        self.store = store if store is not None else BatchStore()
        self.logger = container.logger
        self.metrics = container.metrics_manager
        self.tracer = getattr(container, "tracer", None)
        self._grammar_vocab = None  # lazy (tokenizer -> byte vocab)
        self._inflight: set[str] = set()
        self._lock = threading.Lock()
        self._pause_until = 0.0  # engine-shed pull backoff (monotonic)
        self._stopped = False
        self.jobs_ok = 0
        self.jobs_error = 0
        self.jobs_requeued = 0
        self.jobs_dlq = 0
        self.jobs_deduped = 0
        if self.metrics is not None:
            if not self.metrics.has("app_llm_batch_jobs_total"):
                self.metrics.new_counter(
                    "app_llm_batch_jobs_total",
                    "offline batch generation jobs by outcome "
                    "(ok|error|requeued|dlq|dedup)",
                )
            if not self.metrics.has("app_llm_batch_queue_depth"):
                self.metrics.new_gauge(
                    "app_llm_batch_queue_depth",
                    "batch jobs pulled and not yet finished (in-flight "
                    "against the engine; zeroed at worker close)",
                )

    # -- engine resolution + job execution --------------------------------

    def _engine(self, job: BatchJob):
        name = job.model or self.model
        if not name:
            raise ValueError("job names no model and worker has no default")
        return self.container.tpu().llm(name)

    def _grammar_for(self, job: BatchJob):
        if job.schema is None:
            return None
        if self.tokenizer is None:
            raise ValueError(
                "schema-constrained job needs a worker tokenizer "
                "(attach_batch_worker(tokenizer=...))"
            )
        from ..structured import grammar_cache, vocab_from_tokenizer

        if self._grammar_vocab is None:
            self._grammar_vocab = vocab_from_tokenizer(self.tokenizer)
        eos = getattr(self.tokenizer, "eos_id", None)
        if eos is None:
            raise ValueError("tokenizer has no eos_id; cannot close a grammar")
        return grammar_cache.get(job.schema, self._grammar_vocab, int(eos))

    def _run_job(self, job: BatchJob) -> dict:
        """Blocking generation (executor thread). Raises EngineOverloaded
        through — the caller turns it into pull backoff, not a failure."""
        from ..llm import GenRequest

        handle = self._engine(job)
        grammar = self._grammar_for(job)
        if job.tokens is not None:
            toks = list(job.tokens)
            eos = -1 if grammar is None else grammar.eos_id
        else:
            if self.tokenizer is None:
                raise ValueError(
                    "text job needs a worker tokenizer "
                    "(attach_batch_worker(tokenizer=...))"
                )
            toks = self.tokenizer.encode(job.prompt)
            eos = self.tokenizer.eos_id if self.tokenizer.eos_id is not None else -1
        # Resume the submitter's trace across the pub/sub hop: the batch.job
        # span parents to the traceparent the publish edge injected (or a
        # cron tick's), so the journey survives the async boundary — and the
        # engine's llm.request span nests under it via req.traceparent.
        tp = job.traceparent
        jspan = None
        if self.tracer is not None:
            from ..tracing import parse_traceparent

            jspan = self.tracer.start_detached_span(
                "batch.job",
                parent=parse_traceparent(tp) if tp else None,
                attributes={
                    "batch.job_id": job.id,
                    "batch.topic": self.topic,
                    "batch.attempt": job.attempt,
                },
            )
            tp = jspan.traceparent
        try:
            req = handle.submit(GenRequest(
                toks,
                max_new_tokens=job.max_new_tokens,
                temperature=job.temperature,
                eos_token=eos,
                priority="batch",  # the overload ladder's pressure reservoir
                client=job.client,
                session_id=job.session,
                grammar=grammar,
                traceparent=tp,
            ))
            out = req.tokens(timeout=300.0)
        except BaseException as e:
            if jspan is not None:
                jspan.set_attribute("error", repr(e))
                jspan.set_status("ERROR")
                jspan.end()
            raise
        if jspan is not None:
            jspan.set_attribute("batch.finish_reason", req.finish_reason or "")
            if req.finish_reason not in _TERMINAL_OK:
                jspan.set_status("ERROR")
            jspan.end()
        if req.finish_reason not in _TERMINAL_OK:
            raise RuntimeError(
                f"generation finished {req.finish_reason!r}"
            )
        result = {
            "id": job.id,
            "object": "batch.result",
            "status": "ok",
            "model": job.model or self.model,
            "tokens": out,
            "finish_reason": req.finish_reason,
            "n_tokens": len(out),
        }
        if self.tokenizer is not None:
            try:
                result["text"] = self.tokenizer.decode(out)
            except Exception:  # noqa: BLE001 — ids are the contract, text is a courtesy
                pass
        return result

    # -- result publication (the ack gate) --------------------------------

    def _publish_result(self, job: BatchJob, result: dict) -> None:
        """Durably publish BEFORE ack: webhook when the job names one,
        else the reply topic. Raising here leaves the job uncommitted —
        redelivery retries the publish, and the idempotence ledger keeps
        the engine work from running twice."""
        payload = json.dumps(result).encode()
        if job.webhook:
            self._post_webhook(job.webhook, payload)
            return
        pubsub = self.container.pubsub
        pubsub.publish_sync(job.reply_topic or self.reply_topic, payload)
        # a batching producer (KAFKA) only buffers in publish_sync: drain it
        # so the result is on the broker before the job's commit. JAX's
        # worker commits with the result still in the buffer, where a crash
        # loses both (ROADMAP queue 3 item 46)
        flush = getattr(pubsub, "flush", None)
        if flush is not None:
            flush()

    def _post_webhook(self, url: str, payload: bytes) -> None:
        import urllib.request

        req = urllib.request.Request(
            url, data=payload,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.webhook_timeout) as resp:
            if resp.status >= 300:
                raise RuntimeError(f"webhook {url} answered {resp.status}")

    # -- the drain loop ----------------------------------------------------

    def _count(self, outcome: str) -> None:
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_llm_batch_jobs_total", topic=self.topic, outcome=outcome
            )

    def _depth(self) -> None:
        if self.metrics is not None:
            self.metrics.set_gauge(
                "app_llm_batch_queue_depth", float(len(self._inflight)),
                topic=self.topic,
            )

    async def run(self) -> None:
        """The subscriber loop: pull -> claim -> process (bounded
        concurrency) -> publish -> ack. Cancellation (app shutdown) exits
        cleanly and zeros the depth gauge."""
        pubsub = self.container.pubsub
        if pubsub is None:
            if self.logger is not None:
                self.logger.error(
                    "batch worker: no pub/sub backend (set PUBSUB_BACKEND)"
                )
            return
        # a fresh serve() re-invokes run(): only close() stops the worker
        # for good, a cancelled previous loop must not latch _stopped
        self._stopped = False
        sem = asyncio.Semaphore(self.concurrency)
        loop = asyncio.get_running_loop()
        tasks: set[asyncio.Task] = set()
        try:
            while not self._stopped:
                now = time.monotonic()
                if now < self._pause_until:
                    # engine shed us (429 + Retry-After): the batch tier
                    # obeys the price instead of re-offering the load
                    await asyncio.sleep(min(self._pause_until - now, 1.0))
                    continue
                await sem.acquire()
                sem.release()
                try:
                    msg = await pubsub.subscribe(self.topic, self.poll_timeout)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — broker hiccup
                    if self.logger is not None:
                        self.logger.error(f"batch subscribe error: {e!r}")
                    await asyncio.sleep(1.0)
                    continue
                if msg is None:
                    continue
                try:
                    job = BatchJob.from_payload(msg.value)
                except (ValueError, json.JSONDecodeError) as e:
                    err = str(e)
                    await loop.run_in_executor(
                        None,
                        lambda m=msg, s=err: (
                            self._to_dlq_raw(m.value, s), m.commit()
                        ),
                    )
                    self._count("dlq")
                    continue
                # classify under the lock, ACT after releasing it — an
                # await (or a blocking commit) while holding a lock the
                # _process finally-block also takes on this event loop
                # would deadlock the whole worker
                with self._lock:
                    st = self.store.state(job.id)
                    dup_running = job.id in self._inflight or (
                        st is not None and st["status"] == "running"
                    )
                    already_ok = (
                        not dup_running
                        and st is not None and st["status"] == "ok"
                    )
                    if not dup_running and not already_ok:
                        self._inflight.add(job.id)
                        self._depth()
                if dup_running:
                    # concurrent duplicate delivery: where the backend
                    # serves uncommitted records again (FILE), leave it
                    # uncommitted and let the claimed owner ack it; where
                    # it does not (KAFKA, MQTT), ack the copy, or it would
                    # hold the commit position below it for good
                    if not self._redelivered(msg):
                        await loop.run_in_executor(None, msg.commit)
                    await asyncio.sleep(0.05)
                    continue
                if already_ok:
                    # idempotence ledger: result already published —
                    # ack the redelivery, do NOT regenerate
                    await loop.run_in_executor(None, msg.commit)
                    self.jobs_deduped += 1
                    self._count("dedup")
                    continue
                await sem.acquire()
                t = loop.create_task(self._process(sem, msg, job))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        finally:
            self._stopped = True
            for t in tasks:
                t.cancel()
            if self.metrics is not None:
                self.metrics.set_gauge(
                    "app_llm_batch_queue_depth", 0.0, topic=self.topic
                )

    async def _process(self, sem: asyncio.Semaphore, msg, job: BatchJob) -> None:
        from ..llm import EngineDraining, EngineOverloaded, EngineStoppedError

        loop = asyncio.get_running_loop()
        try:
            claimed, attempt = self.store.begin(job.id)
            if not claimed:
                # finished between pull and claim: ack if published
                st = self.store.state(job.id)
                if st is not None and st["status"] == "ok":
                    await loop.run_in_executor(None, msg.commit)
                    self.jobs_deduped += 1
                    self._count("dedup")
                return
            try:
                result = await loop.run_in_executor(None, self._run_job, job)
            except (EngineOverloaded, EngineDraining, EngineStoppedError) as e:
                # overload shed, rolling deploy, or a fleet mid-restart
                # (replica kill -> supervisor rebuild window): back the
                # PULL RATE off — Retry-After when the engine priced one,
                # a short probe interval otherwise — and put the job back
                # (no commit / republish). This is pressure, not failure:
                # it does not consume an attempt.
                retry = float(getattr(e, "retry_after", None) or 1.0)
                self._pause_until = max(
                    self._pause_until, time.monotonic() + retry
                )
                # unclaim, not finish: begin() billed an attempt at claim
                # time, and pressure cycles must not consume the budget
                self.store.unclaim(job.id, error=str(e))
                await loop.run_in_executor(
                    None, self._requeue, msg, job, False
                )
                self.jobs_requeued += 1
                self._count("requeued")
                return
            except asyncio.CancelledError:
                self.store.finish(job.id, ok=False, error="worker stopped")
                raise
            except Exception as e:  # noqa: BLE001 — job failure path
                # _fail commits / republishes (broker I/O): off the loop
                await loop.run_in_executor(
                    None, self._fail, msg, job, attempt, str(e)
                )
                return
            try:
                await loop.run_in_executor(
                    None, self._publish_result, job, result
                )
            except Exception as e:  # noqa: BLE001 — publish failure = retry
                await loop.run_in_executor(
                    None, self._fail, msg, job, attempt,
                    f"result publish failed: {e!r}",
                )
                return
            # ack only now: result is durably out. The commit is broker
            # I/O (offset write / Kafka round trip) — executor, so a slow
            # broker never parks the serving app's event loop
            self.store.finish(job.id, ok=True, result=result)
            await loop.run_in_executor(None, msg.commit)
            self.jobs_ok += 1
            self._count("ok")
        finally:
            with self._lock:
                self._inflight.discard(job.id)
                self._depth()
            sem.release()

    def _fail(self, msg, job: BatchJob, attempt: int, error: str) -> None:
        self.jobs_error += 1
        self._count("error")
        if self.logger is not None:
            self.logger.error(
                f"batch job {job.id} attempt {attempt} failed: {error}"
            )
        # retry backoff rides the pull-pause: an immediate re-pull of the
        # same (or next) record during a transient outage is a retry
        # storm that burns the whole attempt budget inside one failure
        # window (a replica-rebuild takes seconds; 20 instant retries
        # take milliseconds)
        self._pause_until = max(
            self._pause_until,
            time.monotonic() + min(0.5 * attempt, 10.0),
        )
        if attempt >= self.max_attempts:
            self._to_dlq_raw(
                json.dumps({**job.raw, "_error": error}).encode(), error
            )
            self.store.finish(job.id, ok=False, error=error, final=True)
            msg.commit()  # poisoned job must not wedge the topic
            self.jobs_dlq += 1
            self._count("dlq")
            return
        self.store.finish(job.id, ok=False, error=error)
        self._requeue(msg, job, True)

    def _redelivered(self, msg) -> bool:
        """Whether the backend serves ``msg`` again while it stays
        uncommitted: FILE re-reads its committed offset and Google's
        service redelivers after the ack deadline; MEMORY pops on delivery,
        and a KAFKA or MQTT consumer has moved past the record and sees it
        again only after a restart (``redelivers_uncommitted``)."""
        if getattr(msg, "_committer", None) is None:
            return False
        return getattr(self.container.pubsub, "redelivers_uncommitted", True)

    def _requeue(self, msg, job: BatchJob, consume_attempt: bool) -> None:
        """Give the job back to the broker. A backend that serves the
        uncommitted record again does so by itself; for the others the
        payload is republished (attempt count rides the payload there —
        the store's count is per-process) and then the original committed:
        a KAFKA or MQTT consumer never serves it again in this process, so
        JAX's worker, which republishes on MEMORY alone, loses a shed job
        there (ROADMAP queue 3 item 44). The in-flight mark goes first: a
        pull already waiting in ``subscribe`` can take the republished
        payload before ``_process`` returns, and a mark still held would
        drop it as a concurrent duplicate (ROADMAP queue 3 item 42). A
        batching producer (KAFKA) is drained before the commit, as in
        ``_publish_result``: committed with the copy still in its buffer,
        the job is lost to a crash (ROADMAP queue 3 item 50)."""
        with self._lock:
            self._inflight.discard(job.id)
            self._depth()
        if not self._redelivered(msg):
            payload = dict(job.raw)
            if consume_attempt:
                payload["_attempt"] = job.attempt + 1
            pubsub = self.container.pubsub
            pubsub.publish_sync(self.topic, json.dumps(payload).encode())
            flush = getattr(pubsub, "flush", None)
            if flush is not None:
                flush()
            msg.commit()

    def _to_dlq_raw(self, payload: bytes, error: str) -> None:
        try:
            self.container.pubsub.publish_sync(self.dlq_topic, payload)
        except Exception as e:  # noqa: BLE001 — DLQ publish is best-effort
            if self.logger is not None:
                self.logger.error(f"batch DLQ publish failed: {e!r}")

    def close(self) -> None:
        self._stopped = True
        if self.metrics is not None:
            self.metrics.set_gauge(
                "app_llm_batch_queue_depth", 0.0, topic=self.topic
            )

    def stats(self) -> dict:
        return {
            "topic": self.topic,
            "reply_topic": self.reply_topic,
            "concurrency": self.concurrency,
            "inflight": len(self._inflight),
            "ok": self.jobs_ok,
            "error": self.jobs_error,
            "requeued": self.jobs_requeued,
            "dlq": self.jobs_dlq,
            "deduped": self.jobs_deduped,
            "paused_s": max(0.0, self._pause_until - time.monotonic()),
        }


# ---------------------------------------------------------------------------
# app wiring: routes + background task + cron
# ---------------------------------------------------------------------------

def attach_batch_worker(
    app,
    topic: str,
    *,
    model: str = "",
    cron_jobs: list[tuple[str, str, dict]] | None = None,
    **worker_kw,
) -> BatchWorker:
    """Wire a BatchWorker into an App:

    - the drain loop runs as an app background task (starts at serve(),
      cancelled at shutdown),
    - ``POST /v1/batches`` submits jobs over the same topic (one body =
      one batch of jobs) and ``GET /v1/batches/{id}`` polls the ledger,
    - each ``(schedule, name, job_template)`` in ``cron_jobs`` publishes
      a fresh job on the framework cron (recurring evaluations, nightly
      summarization sweeps — the GoFr AddCronJob surface feeding the
      same durable queue).

    Unset worker kwargs default from app config: TPU_LLM_BATCH_CONCURRENCY,
    TPU_LLM_BATCH_MAX_ATTEMPTS, TPU_LLM_BATCH_REPLY_TOPIC.
    """
    cfg = app.config
    worker_kw.setdefault(
        "concurrency", cfg.get_int("TPU_LLM_BATCH_CONCURRENCY", 4)
    )
    worker_kw.setdefault(
        "max_attempts", cfg.get_int("TPU_LLM_BATCH_MAX_ATTEMPTS", 3)
    )
    worker_kw.setdefault(
        "reply_topic", cfg.get_or_default("TPU_LLM_BATCH_REPLY_TOPIC", "")
    )
    worker = BatchWorker(app.container, topic, model=model, **worker_kw)
    app.add_background_task(worker.run)

    def submit_batch(ctx):
        if app.container.pubsub is None:
            from ..http.errors import ErrorServiceUnavailable

            raise ErrorServiceUnavailable("no pub/sub backend configured")
        body = ctx.bind()
        jobs = body.get("jobs")
        if not isinstance(jobs, list) or not jobs:
            from ..http.errors import ErrorInvalidParam

            raise ErrorInvalidParam("jobs")
        batch_id = f"batch_{uuid.uuid4().hex[:12]}"
        # Inject the caller's trace context into every envelope: the worker
        # resumes it, so a /v1/batches submit and its eventual generation
        # stitch into one journey even across the durable queue.
        from ..tracing import current_span

        cs = current_span()
        tp = cs.traceparent if cs is not None and cs.end_ns == 0 else None
        ids = []
        for data in jobs:
            try:
                job = BatchJob(dict(data))
            except (ValueError, TypeError) as e:
                from ..http.errors import HTTPError

                err = HTTPError(f"invalid job: {e}")
                err.status_code = 400
                raise err from e
            worker.store.register(job.id, batch_id)
            env = job.raw | {"id": job.id}
            if tp and not env.get("traceparent"):
                env["traceparent"] = tp
            app.container.pubsub.publish_sync(
                topic, json.dumps(env).encode()
            )
            ids.append(job.id)
        from ..http.responder import Response, to_json_bytes

        return Response(200, [("Content-Type", "application/json")], to_json_bytes({
            "id": batch_id,
            "object": "batch",
            "status": "queued",
            "jobs": ids,
            "poll": f"/v1/batches/{batch_id}",
        }))

    def poll_batch(ctx):
        view = worker.store.batch_view(ctx.path_param("id"))
        if view is None:
            from ..http.errors import ErrorEntityNotFound

            raise ErrorEntityNotFound("batch", ctx.path_param("id"))
        from ..http.responder import Response, to_json_bytes

        # raw body (no {"data": ...} envelope): /v1/* speaks the
        # OpenAI-style dialect end-to-end
        return Response(
            200, [("Content-Type", "application/json")], to_json_bytes(view)
        )

    def worker_stats(_ctx):
        return worker.stats()

    app.post("/v1/batches", submit_batch)
    app.get("/v1/batches/{id}", poll_batch)
    app.get("/v1/batches-stats", worker_stats)

    counter = {"n": 0}
    for schedule, name, template in cron_jobs or []:
        def make_job(template=template, name=name):
            def publish_job(_ctx):
                counter["n"] += 1
                payload = dict(template)
                payload.setdefault("id", f"{name}_{counter['n']}")
                # A cron-published job's journey starts at the cron tick:
                # mint a root span here and inject its traceparent so the
                # worker's batch.job span parents to the tick, not nothing.
                tracer = getattr(app, "tracer", None)
                if tracer is not None and not payload.get("traceparent"):
                    tick = tracer.start_detached_span(
                        "batch.cron_tick",
                        attributes={"cron.job": name, "batch.topic": topic},
                    )
                    payload["traceparent"] = tick.traceparent
                    tick.end()
                app.container.pubsub.publish_sync(
                    topic, json.dumps(payload).encode()
                )
            return publish_job

        app.add_cron_job(schedule, name, make_job())
    return worker
