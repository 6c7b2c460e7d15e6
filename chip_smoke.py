"""GPU smoke run of the PyTorch/CUDA port (gofr_tpu_torch) on one card.

    python3 chip_smoke.py [--parent TREE] [--only observe|families|moe|contiguous|wave|knobs|mnist|fleet|rollout|disagg|gateway|edge|batch|router|train]
    python3 chip_smoke.py --engine-process --port P --metrics-port M [--log-dir DIR]

The second form is one engine process of the router phase (22), which the
front router launches.

GOFR_BLACKBOX_DIR is set to a fresh temporary directory (removed at the
end) and GOFR_BLACKBOX_INTERVAL_S to 1 before anything is built, so every
engine writes its incident bundles there; the goodput ledger, the flight
recorder and the anomaly detectors are on by default in every engine.

Phases, each raising on failure:

1. device — require CUDA, print the card's name and power limit, turn TF32
   off for float32 products;
2. build — compile the HTTP wire codec every App serves through
   (gofr_tpu_torch/native/httpcore.cc, g++; a failed build fails the
   script) and the CUDA kernels from gofr_tpu_torch/csrc (one nvcc per
   source, in parallel) into build/kernels; print each kernel's registers
   and spill bytes (a bf16 flash kernel or a paged-decode kernel that
   spills fails), the count of tensor-core (HMMA) instructions per kernel
   in the flash library's SASS (a bf16 flash kernel without any fails),
   and the paged-decode launch plan at the serving shape (cluster splits,
   shared memory per CTA; an unsplit launch fails);
3. kernels — hold each kernel (flash attention, paged decode over bf16/f32
   pools, paged decode over int8 pools) against its plain PyTorch version
   at the serving path's Gemma-2B shapes, with bfloat16 and float32
   queries, and time the kernel two ways (20 launches back to back from
   Python with CUDA events, which includes the wrapper's host path, and
   the same launches under torch.profiler, the kernel's own device time),
   the plain version, one PyTorch library call where one computes the
   same function, and the card's bound for the same work. With --parent,
   another checkout's paged-decode kernels (e.g. the parent commit
   unpacked by git archive) are built and timed on the same inputs, in
   turns with this tree's. Then the same for the families of phase 12 at
   their head shapes (flash q_offsets and paged decode for Llama-3-8B,
   Mistral-7B, Qwen2-7B and Gemma-7B, int8 paged decode for Llama-3-8B,
   Mistral's window at ~4,200 tokens), with each model's paged-decode
   launch plan; timed here, before any engine has run (afterwards the
   profiler kept only a few of a timing's kernel records at some shapes).
   Flash in its full-prompt mode (kernel row 2, the wave's prefill) is
   held and timed apart at the wave's served shapes: full waves of the
   128 and 512 buckets at Gemma-2B's heads, one Mistral-7B prompt at the
   8,192 bucket with its 4096 band (counted in flash_attention_prompt);
4. engine — the port's LLMEngine at its defaults over Gemma-2B (full
   width and depth, random weights from a seeded generator): lookahead
   3 and every program family captured as a CUDA graph at construction.
   Prints the families, warmup_s and torch.cuda.memory_reserved before
   and after the capture; holds every family's replay against its eager
   program on a cloned random state at temperature 0 (tokens, pool bytes,
   lengths, tail, active mask and temperatures bitwise equal; launches per
   replay equal to the captured count) and checks that two replays at a
   high temperature draw differently. Then serves a burst of concurrent
   requests three times at lookahead 3 and once at lookahead 1, checks
   every stream and every served token against greedy decoding by the
   plain full-prompt forward, prints the median and spread of tok/s and
   TTFT, checks that both kernels launched in every burst, and profiles
   one more burst (idle share; whether the profiler names the kernels
   inside graph replays). The engine writes a metrics manager;
4b. observe — chip-time accounting and the flight recorder on the engine
   phase's engine (``--only observe``: its own engine at OBSERVE_LAYERS of
   18 layers, full width): the burst under two tenants, with attributed +
   idle equal to the ledger's wall within 1% (lifetime and over the
   burst), the tenants' chip time equal to the attributed total and each
   tenant's to its requests' ``_chip``, and the host time of the ledger's
   seams and the finish path; the ledger's busy time beside
   torch.profiler's device-busy time over one profiled burst (report); a
   probe billed wholly to probe; a quota of a quarter of "acme"'s metered
   rate shedding its next submit with the gate's priced Retry-After, a
   probe from it admitted, the same shed over HTTP as a 429 with
   Retry-After, admitted again once cleared, GET
   /.well-known/debug/usage; every burst request's flight record final
   with its stream, eng.replay of all 8 and POST
   /.well-known/debug/replay of one, each token-identical or leaving the
   record at a near-tie; a bundle taken with a burst in flight (its files,
   in-flight records, HBM in use above the weights; its ms and the
   burst's tok/s beside an unbundled burst); an anomaly (every fetch held
   past the factor times the step baseline: app_llm_anomaly{signal="step"}
   1, one step bundle, cleared by normal steps); the exposition's goodput,
   quota-shed and bundle series non-zero. Then device observability, with
   a tracer (the app's), an SLO tracker and the HBM sampler attached to
   the engine as the runtime attaches them: the burst traced (one
   llm.request span a request, its queue_wait / prefill / decode / emit
   children inside it; app_llm_ttft_seconds counts the burst); a 1 ms
   TTFT target trips the fast burn once (one slo_fast_burn bundle), a 60 s
   one nothing; the MFU and roofline windows per phase (each in (0, 1],
   decode's ratio under 1); the capture registry (one row per captured
   family, its arg_shapes read off the family's name, their seconds
   within warmup_s, and over one burst its hits equal to the replays
   counted on each CUDA graph); one HBM sweep equal to
   memory_reserved and mem_get_info at the same moment; over HTTP a
   traceparent's round trip, /debug/traces, /debug/compiles and
   /debug/engine?serving=1; a 2 s profile capture during a live burst
   (trace.json names the flash and paged-decode kernels; the streams
   against the uncaptured burst's, equal or at near-ties); and the main
   burst three times with the tracer, SLO and a sampler of its own on and
   three times with all three off (tok/s each);
5. overload — overload control on the engine phase's engine (preemption
   and the fair-queuing ledger toggled at runtime, no second warmup): a
   batch job (the burst's prompts five times, longest first, 256 new
   tokens) holding every slot with a backlog, and 4 interactive requests
   arriving once its first wave has 8 tokens out each, with preemption on
   and then off (interactive TTFT, preemptions: at least 1 on, 0 off, the
   batch job's wall); a heavy client's flood of 96 requests and a light
   client's 8, with the ledger and without (light TTFT and finishing
   positions); the predicted wait at each submit over the measured queue
   wait; a max_queue reject and a predicted-wait shed (each a finite
   retry_after, the accepted requests served). Every token of the
   preempted, interactive and light streams through the replay gate; no
   family captured in the phase, nothing held once idle, both kernels
   launched;
5b. batch — the job tier on the engine phase's engine (``--only batch``:
   an engine of its own at the same defaults): the burst alone (the direct
   streams, TTFT without a backlog), then 16 jobs (the burst's prompts
   twice, 32 new tokens) published on a FILE pub/sub topic in a temporary
   directory and drained by gofr_tpu_torch.batch's BatchWorker at
   concurrency 4 while the burst runs again as interactive traffic (TTFT
   with the backlog). One result per job on the reply topic, each job's
   tokens equal to the direct stream of its prompt or leaving it at a
   near-tie (the interactive streams too), 16 requests in the engine's
   batch class, a job published twice deduplicated (one result), both
   kernels launched ("batch_launches");
5c. batch kafka — the same 16 jobs on the same engine over KAFKA: the
   port's FakeKafkaBroker on 127.0.0.1 (an ephemeral port; SASL
   SCRAM-SHA-256 as its one user; topics of 2 partitions) and a
   BatchWorker over the KafkaPubSub that new_pubsub("KAFKA", ...) builds,
   at concurrency 4 beside the interactive burst (TTFT with and without
   the backlog, jobs/s). The results are read back from the broker
   through a fresh consumer (exactly one per job), the job topic's
   offsets are committed to its end in both partitions (a new consumer of
   the worker's group gets no record), 16 requests in the batch class, the
   gates of 5b, a job published twice deduplicated, both kernels launched
   ("batch_kafka_launches");
5d. pubsub — the broker examples, host-light: kafka_batch_inference over
   KAFKA (SCRAM) with its MLP 16 -> 32 -> 4 on the card, 6 microbatches
   of 4 rows over HTTP /enqueue, every prediction equal to the argmax of
   the registered model run directly on the same rows; using_publisher to
   using_subscriber over KAFKA and over MQTT (QoS 1, the port's
   FakeMQTTBroker), 8 orders each seen once. Google Pub/Sub is not driven
   here: the card's machine has no grpcio (the CPU tests hold it).
   ``phase seconds`` shows 5c as "batch kafka" and 5d as "pubsub";
6. int8 engine — the same through LLMEngine(kv_int8=True, quantize=True)
   on the same weights' first CUT_LAYERS layers: int8 weights and an int8 KV pool read by the
   int8 paged-decode kernel; every served token checked against the
   plain forward on the same int8 weights, under a gap constant set from
   this path's measured logit drift;
7. lora — multi-tenant LoRA at the same full width: the engine at its
   defaults plus lora_slots=4, lora_rank=8 (the engine phase's families,
   no more); four seeded adapters (A rank 8 and B rank 4 on all six
   targets, C rank 8 on attention only, F rank 4, left idle) loaded after warmup
   (table bytes, load ms; families, memory_reserved and every table's
   address unchanged); every family's replay bitwise its eager program
   with mixed adapter ids live; the burst with its lanes cycling base / A /
   B / C three times at lookahead 3 and once at 1; every token through
   the replay gate, base lanes against the plain forward and adapted
   lanes against the plain forward with their adapter's delta, A's also
   against merge_adapter's weights; adapted tokens that leave the base's
   argmax counted (A and B must move some); nothing held once idle,
   no prefix hit.
   The device ms of llm.decode_chunk8 and the widest step against the
   engine phase's, and the delta's two forms (served: each table read
   once; the JAX form: per-row gathered copies). Then a hot-load mid-burst:
   a new version of A loaded into the full pool (the idle F evicted) and
   published while A's requests are in flight: those finish on the old
   gid (gated against the old A), two later ones get the new version
   (gated against it), nothing captured, memory_reserved unchanged. Then
   register_adapter(quota=1.0) through a ModelHandle over this engine: the
   adapter's tenant is shed with the priced Retry-After once its window
   passes the quota. Then
   kv_int8=True, quantize=True with the pool: 4 requests of 16 tokens, 2
   under A, through the int8 gate. Flash and both paged kernels must
   launch ("lora_launches");
8. edge — the port's HTTP server (gofr_tpu_torch.serve) on an ephemeral
   port, reached at 127.0.0.1, a bf16 engine at its defaults (graphs,
   lookahead 3) over the same weights, its warmup printed: the burst as
   concurrent POST /generate requests over real sockets (every token
   through the same replay gate as the engine phase), one OpenAI chat
   completion plain and then as SSE (the deltas must join to the plain
   content), and a client that hangs up after the first SSE chunk (the
   KV pool must show 0 blocks in use within 3 s); both kernels must
   launch during the phase. The App serves through NativeHTTPServer (the
   C++ codec), its default. Last, the app shuts down with an idle
   keep-alive connection open: its server must close within 5 s. Prints
   an "edge" line: tok/s and the client's time to first byte beside the
   engine phase's numbers, the shutdown's seconds;
8a. native — on the edge app and its engine: the codec loaded, an App
   under GOFR_HTTP_NATIVE=0 builds AsyncHTTPServer, and that server over
   the edge app's router listens beside the native one; the burst served
   directly by the engine, then through native, asyncio, asyncio, native:
   every stream equal to the direct one or leaving it only at a near-tie
   (counted); a mid-SSE hang-up retired on the asyncio server too; the
   asyncio server closes within 5 s with an idle keep-alive connection.
   Prints a "native" line: each server's tok/s;
8b. gateway — while the edge phase's app still serves (``--only
   gateway`` or ``--only edge``: its own edge app at full depth first,
   with all of 8a-8d), a plain ``new()``
   App in the same process in front of it (``build_gateway``: basic
   auth, the model app as service ``gemma`` behind a circuit breaker,
   and a service ``down`` on a port nothing listens on; ephemeral HTTP
   and metrics ports). Checks: no credentials or a wrong password answer
   401, health needs none; the burst as concurrent authenticated POST
   /ask/gemma, forwarded through the async client (every token through
   the replay gate, each stream the edge burst's for the same prompt or
   leaving it only at a near-tie, both kernels launched during it); the
   chat request streamed through astream joins to the plain answer;
   /ask/down answers 503 twice, then 503 from the open breaker at once
   while /ask/gemma serves; both apps' metrics servers, scraped over
   HTTP, count the forwarded requests; new_cmd()'s ``replay -id`` of a
   burst record reports token-identical (or a near-tie divergence) and
   ``replay -bundle`` lists a bundle's records. Prints a "gateway" line:
   tok/s and time to first byte through the gateway and direct, the
   breaker's time to open, the launches;
8c. prefork — host processes: a CPU-only App with HTTP_WORKERS=3 answers
   from more than one pid within 15 s and SIGTERM reaps every worker; a
   model app (serve's app over a tiny engine on the card) with
   HTTP_WORKERS=3 logs the refusal (torch is imported), answers from one
   pid and serves a generate. Prints a "prefork" line: the pids;
8d. datasources — host only: the using-migrations (with Redis beside its
   sqlite file), using-add-rest-handlers and http-server-using-redis
   examples over sqlite files and the port's MiniRedis: the migration
   applied once and a no-op second start, health with sql and redis UP,
   app_sql_stats and app_redis_stats on /metrics, a CRUD round trip,
   Redis set, get and pipeline. Prints a "datasources" line;
9. prefix — the prefix cache and the session tier at the same full
   width and CUT_LAYERS of 18 layers: LLMEngine(prefix_cache_mb=64, session_mb=64, host_cache_mb=256),
   its 15 families (kv_seed and the hit programs too) held bitwise
   against their eager programs; a chat service's traffic on one seeded
   320-token system prompt S: burst A (S + 8 suffixes of 16-64 tokens:
   8 misses), B (S + 8 new suffixes: 8 block-partial hits), C (B's
   prompts again: 8 exact hits, no unified step), then 4 conversations
   (turn 1, publish, all 4 spilled to host memory, turn 2 restores).
   Exact counters, no leaked pin once idle, every token through the
   replay gate, both kernels launched in the phase; prints tok/s, TTFT,
   unified steps, prompt tokens packed and blocks shared per burst, and
   the spill and restore times;
10. prefix int8 — four requests through a partial/exact pair on an int8
   KV pool (CUT_LAYERS of 18 layers) (tail copies move the f32 scales; the int8 kernel decodes
   over shared blocks);
11. spec — speculative decoding at the same full width:
   LLMEngine(speculative=True, spec_draft=4), its 11 families (the verify
   program llm.step_v5 too) held bitwise against their eager programs;
   extraction traffic (8 seeded passages of 32-240 tokens, each followed
   by its first 16 tokens again, 64 new tokens, all at once) served with
   the n-gram drafter (a), an oracle drafter proposing (a)'s tokens (b),
   an adversary proposing them + 1 (c), and on a spec-off engine (d).
   Every token through the replay gate, (a)-(c) leaving (d)'s streams
   only at near-ties, (b) accepting >= 90%, (c) none and backing off to
   plain chunks, the flash kernel once per layer in every verify; prints
   tok/s, TTFT, verifies, plain chunks, unified steps, acceptance and
   tokens per verify lane per burst. Then spec int8 (kv_int8=True, 4
   requests, the oracle drafter);
12. structured — grammar-constrained decoding at the same full width: a
   JSON schema (string, integer, enum and bounded-array fields) and a
   regex compiled against the ByteTokenizer's 256,000-id vocabulary
   (compile ms, states, table bytes); the engine at its defaults (no
   constrained family at warmup) serves 8 seeded prompts with no grammar,
   then with 4 of them constrained (the first constrained request
   captures the constrained families: seconds and memory printed), again
   (timed), and at temperature 0.9. Gates: every constrained output ends
   on eos and is valid; every constrained token is the argmax of the
   plain forward over the tokens its grammar admits (near-ties exempt);
   the unconstrained streams equal the grammar-free run's; every
   constrained family's replay is bitwise its eager program; no block or
   grammar reference held once idle. Prints tok/s and TTFT against the
   grammar-free burst and the device time of llm.decode_chunk8g beside
   llm.decode_chunk8. Then a speculating engine on the greedy burst (the
   spec-off tokens, near-ties exempt; constrained and unconstrained
   acceptance) and an int8 KV engine with 2 constrained requests;
13. families — the JAX package's other dense presets at their published
   widths and 4 of their published layers (of 32 or 28; half their
   depths until the knobs and mnist phases needed the time, a quarter
   until the fleet phase did),
   random weights from the seed (untied heads where
   the family publishes one), one model at a time, each freed before the
   next: Llama-3-8B, Mistral-7B, Qwen2-7B (q/k/v bias, a GQA group of 7)
   and Gemma-7B (16 KV heads at head_dim 256). For each: an engine at the
   defaults (warmup, every family's replay bitwise its
   eager program), the burst once at lookahead 3, every token through
   the replay gate, its logit drift. Llama-3-8B also with
   kv_int8=True, quantize=True (the int8 gate). Mistral-7B also its
   window at full width on the paged pool (kv_paged=True): an engine of 4
   slots at max_seq_len 4608 serving 4 prompts of 4,160-4,400 tokens (every decode band starting
   above 0, read back from the pool's lengths). Then a 2-layer
   Llama-3-8B-shaped bf16 HF checkpoint (two shards and an index, ~3 GB)
   written to a temporary directory by this script, loaded into cuda by
   load_llama_checkpoint, every leaf held bitwise against its source,
   and the directory removed. Both kernels (and the int8 one for the
   int8 engine) must launch in every model's burst;
14. moe — mixture-of-experts serving at Mixtral-8x7B's widths
   (mistralai/Mixtral-8x7B-v0.1: d 4096, 32/8 heads at head_dim 128,
   8 experts of d_ff 14,336, top 2, vocab 32,000, rope theta 1e6, no
   window) at 4 of its 32 layers (the bf16 weights of all 32 do not fit
   the card; 16 until the knobs and mnist phases needed the time, 8
   until the fleet phase did), under the JAX package's routing (top-2 of a full softmax
   not renormalised, capacity factor 1.25), random bf16 weights from the
   seed, untied head; the config's fields checked against constants
   here. An engine at the defaults: its families held bitwise against
   their eager programs, the burst three times at lookahead 3 and once
   at 1 (the card's busy and idle time from CUDA events around every
   replay), the device ms of llm.decode_chunk8 and the widest step; flash
   and the bf16 paged kernel must launch in every burst. A gate engine on the same weights at capacity 4.0 (C = T:
   nothing drops, so the plain forward of one prompt routes as the
   served programs do): one burst, every token through the replay gate,
   recording the rows entering every layer's MoE FFN. On those rows: the
   share of (row, slot) pairs past capacity 1.25 at decode T = 32 and
   prefill T = 256 in every layer, and at layer 0 the served moe_ffn
   (moe_mlp, the programs' call) against its plain form (2e-2), its time
   against the plain form's and the bound. Then the tree quantized (matrix by matrix) and the bf16
   one freed, and an int8 engine (quantize, kv_int8) at capacity 4.0,
   its families captured by a first pass of the 4 requests of 16 tokens,
   the second pass timed and through the int8 gate, the int8 paged
   kernel launched, one layer's dequantization of its int8 stacks timed;
15. contiguous — the contiguous KV layouts. The dense slab: Gemma-2B at
   the engine phase's defaults plus kv_paged=False (layout, capacity 512
   and slot bytes from the CacheManager; warmup, families and memory;
   every family's replay bitwise its eager program), the burst once at
   lookahead 3 and once at 1 (busy and idle share from CUDA events around
   every replay), every token through the replay gate; flash must launch
   and no paged kernel.
   The rolling ring: Mistral-7B at full width and 4 of its 32 layers
   (16 until the knobs and mnist phases needed the time, 8 until the
   fleet phase did; bf16, seeded
   random weights, untied head), kv_paged left at its
   default, 8 slots at max_seq_len 32,768, speculative=True: the ring of
   4,160 rows a slot (the 32-layer deployment's bytes beside what the
   paged pool would take at these settings and at 32 slots, computed,
   not allocated), every family's replay bitwise (llm.step_v5 too), 4
   prompts of 4,300-6,000 tokens x 64 new tokens (every ring wraps
   during prefill; the lengths read back past the capacity), the device
   ms of llm.decode_chunk8 and the widest step, the burst's busy and
   idle time from CUDA events around every replay, the plain decode
   attention's time at the chunk's shapes and its share of the chunk and
   of the burst, every token through the replay gate against the plain
   forward with the window mask; no kernel launches on the ring (its
   attention is plain, as the JAX reference's einsums are);
16. wave — the monolithic wave scheduler (step_token_budget=0) and the
   whole-row prefix cache of the contiguous layouts, after the structured
   phase: Gemma-2B (CUT_LAYERS of 18 layers) at the defaults plus
   step_token_budget=0 (the pool
   under "auto"; warmup of every llm.prefill_b{bucket}.w{nb} graph, each
   the prefill fused with the insert and the first tokens; every family
   bitwise its eager program, the lazy max_seq_len bucket's too), the
   burst at lookahead 3 and 1 (waves by width, busy and idle time from
   CUDA events), every token through the replay gate; flash launches in
   its full-prompt mode only (no unified step) and the paged kernel; an
   int8 burst (kv_int8, quantize) through the int8 gate and the int8
   kernel. Then the slab, chunked, with prefix_cache_mb=256: the burst as
   8 misses, again as 8 exact hits (no unified step, the misses' tokens),
   a 256-token prefix alone and 8 prompts extending it (8 partial hits),
   TTFT per round. Mistral-7B's ring (full width, 8 of 32 layers, 2
   slots, max_seq_len 32,768, prefix_cache_mb=1024, chunked): a
   6,000-token prompt as a miss, then as an exact hit (TTFT of each, the
   entry's bytes, the same tokens). Mistral-7B at 4 layers, 2 slots,
   max_seq_len 8,192, step_token_budget=0: prompts of 4,300 and 6,000
   tokens in a wave at the 8,192 bucket (flash over the 4096 band, then
   ring_pack; lengths past the ring's 4,104 rows), every token through
   the replay gate with the window mask ("wave_launches");
17. knobs — the engine's shape knobs on Gemma-2B at full width and
   KNOB_LAYERS of its 18 layers (bf16, the same weights' first ones; all
   18 until the fleet phase needed the time): a wide deployment (decode_chunk=16,
   prefill_chunk=128, step_token_budget=512, kv_block=32) and a narrow
   one (decode_chunk=4, prefill_chunk=32, step_token_budget=128,
   kv_block=8, kv_int8=True: the int8 paged kernel at 8-row blocks), then
   the wave (step_token_budget=0) at decode_chunk=16, kv_block=32. Each:
   its geometry (chunk shapes, short chunk, block, table width, capacity,
   append slack, block bytes) against the knobs' JAX meanings, the
   paged-decode launch plan, warmup (families, warmup_s, memory), every
   family's replay bitwise its eager program (the lazy ones too), the
   burst once at lookahead 3 with the kernels' launches by shape (summing
   to the counters), every token through the replay gate (the int8 gap
   on the int8 pool, at most 1 in 8); flash (in its full-prompt mode only
   on the wave) and the pool's paged kernel must launch ("knobs_launches").
   The kernels phase holds and times rows 3-4 at 8- and 32-row blocks
   (Gemma-2B's and Llama-3-8B's heads) and row 1 at chunk widths 32, 128
   and 256 and the verify width 33;
18. fleet — the replica fleet and its recovery, after the knobs phase:
   gofr_tpu_torch.serve's app with LLM_REPLICAS=2 (GPURuntime.register_llm
   builds a ReplicatedLLMEngine: two Gemma-2B replicas, FLEET_LAYERS of
   its 18 layers (the first ones of the shared weights), at the
   engine defaults, each with its own weight copy and graphs, on the one card)
   and TPU_LLM_STEP_WATCHDOG_S=3; each replica's warmup and the memory
   after the build. The burst through the fleet (tok/s beside the engine
   phase's, every token through the replay gate; "fleet_launches"). Then
   4 streams of 96 tokens pinned to r0 (their unfaulted streams served
   first), replica_kill once each has a token: every
   stream fails over to r1 and must equal the unfaulted burst's or leave
   it only at a near-tie, and pass the gate; the supervisor rebuilds r0
   behind the canary while r1 serves up to 3 bursts (each gated), and r0 then
   takes traffic again. Then a hung fetch on r1 (step_latency past the
   watchdog) and non-finite logits on r0 (nan_logits): the same failover
   and rebuild, each death's reason checked; memory_reserved after each
   death and rebuild within one replica's footprint of the first build.
   Over HTTP: a 96-token /generate whose replica is killed mid-stream
   answers 201 with the unfaulted tokens (or a near-tie divergence), the
   card then refuses the rebuild (device_sick) until the slot parks and
   health reads "degraded"; POST /.well-known/debug/drain turns health to
   503, liveness stays 200, and the server closes. The burst's two
   tenants are billed by the meter both replicas share (each tenant's
   requests' _chip); each injected death writes one bundle of its class
   (engine_death, watchdog, numerical) holding the pinned requests'
   in-flight records, the hung fetch's while the fetch still hangs, within
   2 s plus its writes; the quarantine writes a quarantine bundle; GET
   /.well-known/debug/blackbox lists them newest first and GET
   /.well-known/debug/usage pools both replicas;
19. rollout — zero-downtime rollouts, on a fresh fleet (its own device
   ledger): gofr_tpu_torch.serve's app with LLM_REPLICAS=2 over a
   Gemma-2B cut to ROLLOUT_LAYERS of its 18 layers (full width), v1
   weights from the seed. The v1 burst's streams (gated against the plain
   v1 forward); a v2 checkpoint (other seeded weights) written in the HF
   Gemma layout under build/; with the 8-request burst in flight and a
   client sending bursts, POST /.well-known/debug/rollout: every
   in-flight stream finishes on v1, equal to its unfaulted stream or
   leaving it at a near-tie; GET reaches "completed" with versions
   {"v2": 2}; no client request fails or ends short, and ROLLOUT_GATED
   streams of each version pass the gate against its plain forward; the v2 burst passes the
   gate against the plain v2 forward ("rollout_launches": from the v1
   burst to the v2 burst). A redeploy with rollout_canary_fail armed
   ends "rolled_back", fully on v2, with no failed request and one
   rollback bundle;
   memory_reserved after each within one replica's footprint of the
   level before the deploy. (The bare engine's blue-green swap is held by
   the CPU tests only, for the script's time.) Both versions have an
   untied random head: a tied random model repeats its input token under
   any seed;
20. disagg — register_llm(disagg=True, replicas=2): a prefill replica
   and a decode replica of Gemma-2B (DISAGG_LAYERS of 18 layers, full
   width, an untied random head) on the one card. The main burst
   (handed off device to device) against the colocated engine's streams
   (equal, or leaving them at a near-tie; every token gated), 8 handoffs
   ok, no miss, no fallback; the launches per pool from each engine's own
   replays by family, summing to the counters ("disagg_launches"): the
   decode pool launches no flash kernel; the K/V bytes moved and the
   submit-to-decode-admit wall per request. The burst again
   host-staged (TPU_LLM_KV_HANDOFF_D2D=0): each import's blocks and
   logits, read back from the decode pool, byte-identical to the d2d
   import's. Then the 8 handoffs again on 4 threads while the decode
   engine's stream runs HANDOFF_DELAY_CYCLES behind (every import
   returns, and its payload is dropped, before that stream reads it):
   each decode-pool record's logits byte-identical to the prefill
   pool's record of the same prompt. Then the decode replica killed as a
   burst starts: every stream ends right through the colocated fallback
   (fallbacks > 0);
21. mnist — the plain-model path: gofr_tpu_torch.serve_mnist's app over
   the MLP at its published widths (784 -> (512, 256) -> 10, bf16, random
   weights from the seed), registered through GPURuntime.register_model
   (warmed at every power-of-two bucket to 64); 2,000 single-example
   requests from 64 concurrent clients through infer_async, then 200
   over HTTP POST /infer; requests/s, p50/p99 latency, the batcher's
   waves by width, every answer against the float32 plain forward of
   its image (MNIST_ATOL), GET /model listing the model. No kernel of the
   port runs here: the MLP's products are cuBLAS calls, as JAX's are XLA
   dots outside any Pallas kernel;
22. router — the scale-out tier, after mnist: ``python -m gofr_tpu_torch.router``
   as a process of its own (TPU_ROUTER_ENGINE_CMD: this script's
   --engine-process, which serves Gemma-2B's seeded weights at
   ROUTER_LAYERS of 18 layers, full width, through serve's app at the
   engine defaults; 2 to 3 replicas; backlog scale-ups off), driven over
   sockets by this process. The router process maps no CUDA library
   (/proc/<pid>/maps) and is absent from nvidia-smi's compute apps while
   each engine process maps it (and is listed, where nvidia-smi shows this
   machine's pids); the burst through the router and direct to one engine
   (tok/s, first-byte p50; every routed token through the replay gate,
   routed streams equal to the direct ones or leaving them at near-ties,
   both kernels launched in the engine processes); 4 conversations of 3
   turns with X-GoFr-Session, each on one engine, both engines used; a
   SIGKILL of one engine process under 8 SSE chat streams (completed and
   truncated streams, seconds until the fleet marks it down, the next
   burst with 0 failed requests, the replacement's seconds to accepting,
   the dead engine's sessions rehomed); replica_kill armed in a live
   engine process (its engine dies, the process stays up, the next burst
   0 failed); a drain POSTed to one engine with 4 SSE streams on it (all
   4 complete, the process exits and leaves nvidia-smi, the minimum
   restored); the router's SIGTERM reaping every engine process. Launches
   of every kernel summed over the engine processes ("router_launches";
   the counters of the killed and the drained process after their last
   reading die with them);
23. train — training on the card, last (``--only train``), with weights
   of its own: "train gemma" (Gemma-2B, 18 layers, bf16, b 4 s 512;
   batches from a seeded Zipf-like corpus of vocab 256,000 written by
   encode_corpus and read through TokenDataset and device_prefetch;
   make_train_step's AdamW; 2 warm-up and 8 timed steps, then one more
   under the profiler: step ms median/min/max, trained tokens/s, peak
   memory, MFU as 6 N T over the step and the bf16 peak, the first and last
   loss, which must be finite and fall), "train grad" (Gemma-2B's widths at
   2 layers: the loss and every parameter's gradient through the kernel
   against attention through flash_attention_plain under autograd, loss
   within 2e-2, each leaf's relative Frobenius error under 2e-2; the
   autograd op alone at q [4, 512, 8, 256] against the plain version's
   autograd), "train attn" (the forward kernel and the plain backward at
   that shape by CUDA events and the profiler, their bounds and their
   share of a Gemma step), "train moe" (moe_lm_loss at Mixtral-8x7B's
   widths, 2 of 32 layers, b 2 s 512, 8 steps: losses finite and falling,
   step ms, peak memory), "train example" (the train-lm example's encode,
   train -steps=8 and again from the same -ckpt: global step 16, the
   iterator resumed at 8 batches, the checkpoint read back byte for byte)
   and "train data" (whether _gofr_torch_data loaded, batches/s native
   against numpy). Every forward's flash launches are counted
   ("train_launches": 18 a Gemma step, 2 in the grad check, 2 a MoE step,
   2 an example step; flash_attention's there is its q_offsets mode
   alone, 0);
24. report — a "kernels" JSON line (launches on the engine phase's main
   path, in the prefix phases as "prefix_launches", in the spec phases as
   "spec_launches", in the structured phase as "structured_launches", in
   the overload phase as "overload_launches", in the lora phase as
   "lora_launches" and in the families phase's
   first burst of each engine as "families_launches", in the moe phase's
   first burst and its int8 run as "moe_launches", in the contiguous
   phase's bursts as "contiguous_launches", in the wave phase's as
   "wave_launches", in the knobs phase's as "knobs_launches", in the
   fleet phase's unfaulted burst as "fleet_launches", in the rollout
   phase as "rollout_launches", in the disagg phase's main burst by pool as
   "disagg_launches", in the batch part as "batch_launches", in its
   Kafka run as "batch_kafka_launches", summed
   over the router phase's engine processes as "router_launches" and in
   the train phase as "train_launches";
   flash_attention_prompt is the flash kernel's
   full-prompt mode, row 2, whose main path is the wave's burst), then
   the last line {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package. Exits non-zero,
printing no result, when no GPU is visible.
"""

from __future__ import annotations

import argparse
import ast
import asyncio
import base64
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import gc
import http.client
import importlib
import io
import json
import math
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from gofr_tpu_torch import llm as TL
from gofr_tpu_torch.kvcache import CacheManager, gather_slots, quantize_rows, scatter_rows
from gofr_tpu_torch.llm import GenRequest, LLMEngine
from gofr_tpu_torch.lora import init_adapter, merge_adapter, target_dims, validate_adapter, zero_tables
from gofr_tpu_torch.models import (
    KVCache,
    QTensor,
    TransformerConfig,
    decode_chunk_paged,
    init_params,
    prefill_append,
    qmm,
    quantize_params,
    transformer_forward,
)
from gofr_tpu_torch.models import moe as TM
from gofr_tpu_torch.models import transformer as T
from gofr_tpu_torch.models.checkpoint import _flatten, load_llama_checkpoint, validate_params
from gofr_tpu_torch.models.tokenizer import ByteTokenizer
from gofr_tpu_torch.ops import _build
from gofr_tpu_torch.ops import attention as A
from gofr_tpu_torch.profiling.mfu import card_peaks
from gofr_tpu_torch.structured import compile_json_schema, compile_regex, vocab_from_tokenizer

SEED = 0  # inputs, weights and prompts are all made from it
CUT_LAYERS = 9  # the int8, prefix, spec, structured and wave (Gemma) phases' depth (of Gemma-2B's 18, full width)

# Tolerances (kernel vs its plain version on the same inputs).
# float32: both sides accumulate in f32 and differ only in summation order.
F32_ATOL = 1e-4
# bfloat16 output: rounded to an 8-bit mantissa, so 1 ulp is ~0.4-0.8%.
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2
# paged partials m and l are f32 in both dtypes: summation order only.
ML_RTOL = 1e-4
# A served token must equal the argmax of the plain forward's logits
# unless the plain top-2 gap is below this: the served path runs the
# sequence in bf16 through other chunkings and kernels, and bf16 rounding
# across 18 layers moves logits by a few hundredths (measured: see the
# "logit drift" line this script prints).
TOKEN_GAP = 0.25
# The int8 engine's tokens are checked against the plain forward on the
# same int8 weights (W8A8 products, unquantized K/V, no kernels); the
# served path adds the int8 KV round trip and weight-only decode products.
# INT8_TOKEN_GAP is at least twice that path's measured logit drift (the
# "int8 logit drift" line: 0.3555 on an H100 80GB HBM3 at 700 W), and at
# most 1 token in 8 may need it.
INT8_TOKEN_GAP = 1.0

# The card's published dense peaks (memory bytes/s, bf16 tensor-core FLOP/s,
# f32 FLOP/s) come from the port's one table, profiling.mfu (card_peaks):
# the kernel bounds here and the engine's MFU read the same figures.


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str | None, iters: int = 20) -> float:
    """Device time of one launch of the kernel whose name contains
    ``kernel``: the same launches as time_ms, run under torch.profiler, and
    the kernel's self device time over its launch count. No host time is
    in it, where time_ms of a short kernel is paced by the host. With
    ``kernel`` None: the device time of every kernel one fn() launches.
    A trace that lost the kernel's records (the profiler has returned
    none for a whole window on the card) is taken again, up to 3 times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and (kernel is None or kernel in e.key)]
        if kernel is None:
            return sum(e.self_device_time_total for e in ev) / iters / 1e3
        count = sum(e.count for e in ev)
        if count == iters:
            return sum(e.self_device_time_total for e in ev) / count / 1e3
        print(f"device_ms: profiler trace {attempt + 1} saw {count} launches of {kernel!r}, expected {iters}")
    raise AssertionError(f"profiler saw {count} launches of {kernel!r}, expected {iters}, in 3 traces")


def _zero_launches(names) -> None:
    """Set the launch counters of kernels ``names`` to 0."""
    for name in names:
        fn, attr = A._counter(name)
        setattr(fn, attr, 0)


def _launches(names) -> dict:
    """{kernel name: launches counted since its last zeroing}."""
    return {name: getattr(*A._counter(name)) for name in names}


def phase_device() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    key, peaks = card_peaks(name)
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; peaks from data sheet row {key!r}: "
          f"{peaks[0] / 1e12} TB/s, {peaks[1] / 1e12} TFLOP/s bf16, {peaks[2] / 1e12} TFLOP/s f32")
    return {"smi": smi, "name": name, "peaks": peaks}


def phase_build() -> None:
    t0 = time.perf_counter()
    # the HTTP wire codec every App serves through (host C++, g++), built
    # here once for the script and its engine processes: a build that
    # fails on this machine fails the script instead of falling back
    from gofr_tpu_torch.native import build_error, load_http_codec

    codec = load_http_codec()
    if codec is None:
        raise AssertionError(f"the native HTTP codec did not build: {build_error()}")
    print(f"build http codec: {time.perf_counter() - t0:.2f}s ({codec.__file__})")
    report = _build.build()
    spills = []
    for name, r in report.items():
        print(f"build {name}: {r['seconds']:.2f}s cached={r['cached']}")
        for kern, p in _build.ptxas_kernels(r["ptxas"]).items():
            print(f"  ptxas {kern}: {p['registers']} registers, {p['spill_bytes']} spill bytes")
            if ("flash_mma_kernel" in kern or "paged_decode_kernel" in kern) and p["spill_bytes"]:
                spills.append(f"{kern} spills {p['spill_bytes']} bytes")
    print(f"build total {time.perf_counter() - t0:.2f}s")
    if spills:
        raise AssertionError("; ".join(spills))
    # the bf16 flash kernels must run on the tensor cores
    hmma = _build.sass_hmma(_build.library_path("flash_attention"))
    print("sass HMMA per kernel in the flash library: " + ", ".join(f"{k} {n}" for k, n in sorted(hmma.items())))
    mma = {k: n for k, n in hmma.items() if "flash_mma_kernel" in k}
    if not mma or not all(mma.values()):
        raise AssertionError(f"bf16 flash kernels without tensor-core instructions: {hmma}")
    # the paged kernels at the serving shape (32 slots, Gemma-2B's group of
    # 8 on one KV head, head_dim 256, 16-row blocks, 32 table slots): the
    # registers of its instantiations (D = 256, group 8) and the launch plan
    for r in report.values():
        for kern, p in _build.ptxas_kernels(r["ptxas"]).items():
            if "paged_decode_kernel" in kern and "Li256ELi8E" in kern:
                print(f"paged_decode_kernel at the serving shape: {kern}: {p['registers']} registers, "
                      f"{p['spill_bytes']} spill bytes")
    for pool in (torch.bfloat16, torch.int8):
        splits, smem = A.paged_decode_plan(pool, 32, 8, 1, 256, 16, 32)
        print(f"paged_decode plan, {str(pool)[6:]} pools at the serving shape: {splits} splits "
              f"({32 * splits} CTAs in clusters of {splits}), {smem} bytes of dynamic shared memory per CTA")
        if splits <= 1:
            raise AssertionError(f"paged decode at 32 slots is not split: {splits}")


def _flash_work(q, k, off, causal, window):
    """(bytes, flops, valid pairs) the flash function needs on these inputs."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    qpos = (off.long()[:, None] if off is not None else torch.zeros((b, 1), dtype=torch.long, device=q.device)) \
        + torch.arange(sq, device=q.device)[None, :]
    kpos = torch.arange(sk, device=q.device)[None, None, :]
    mask = torch.ones((b, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos[:, :, None]
    if window > 0:
        mask &= kpos > qpos[:, :, None] - window
    pairs = int(mask.sum()) * hq
    # K and V rows: only those some query of the batch attends to
    kv_rows = int(mask.any(dim=1).sum())
    nbytes = 2 * q.numel() * q.element_size() + 2 * kv_rows * k.shape[2] * d * k.element_size()
    nbytes += 0 if off is None else off.numel() * 4
    return nbytes, 4 * d * pairs, mask


def _bound(nbytes, flops, dtype, peaks):
    bw, bf16, f32 = peaks
    t_mem = nbytes / bw
    t_ops = flops / (bf16 if dtype == torch.bfloat16 else f32)
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def build_parent(tree: str) -> dict:
    """The paged-decode entry points of another checkout (``tree``, e.g. the
    parent commit unpacked by git archive), built from its own sources with
    this build's nvcc flags. The C interface is the same, so both trees'
    kernels take the same arguments."""
    src = Path(tree) / "gofr_tpu_torch" / "csrc" / "paged_decode.cu"
    out = _build.BUILD_DIR / "parent_paged_decode.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)], check=True, capture_output=True)
    print(f"build parent paged_decode from {src}: {time.perf_counter() - t0:.2f}s")
    lib = ctypes.CDLL(str(out))
    fns = {}
    for name in ("paged_decode", "paged_decode_int8"):
        _src, symbol, argtypes = _build.KERNELS[name]
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def _time_parent(fn, t: dict, kernel, args, scales: dict) -> None:
    """Time the parent tree's paged kernel on the same inputs, device-only
    and back to back, in turns with this tree's (parent, this, parent):
    adds parent_device_ms (both parent readings), device_ms_again and
    parent_ms to the timing row ``t``; checks the parent's partials
    against this tree's kernel."""
    q, kp, vp, tables, lo, hi = args
    b, hq, d = q.shape
    NB, B, hkv, _ = kp.shape

    def call():
        o = torch.empty((b, hq, d), dtype=torch.float32, device="cuda")
        m = torch.empty((b, hq), dtype=torch.float32, device="cuda")
        l = torch.empty((b, hq), dtype=torch.float32, device="cuda")
        head = (q, kp, vp) + ((scales["k_scales"], scales["v_scales"]) if scales else ()) + (tables, lo, hi)
        err = fn(*map(A._ptr, head), A._ptr(o), A._ptr(m), A._ptr(l), A._DTYPE_CODES[q.dtype], b, hq, hkv, d,
                 NB, B, tables.shape[1], 1 / 16, 0.0, A._stream(q.device))
        if err:
            raise RuntimeError(f"parent paged kernel launch failed: CUDA error {err}")
        return o, m, l

    for a, w in zip(call(), kernel()):
        torch.cuda.synchronize()
        if not torch.allclose(a, w, rtol=ML_RTOL, atol=F32_ATOL):
            raise AssertionError("parent and this tree's paged kernels disagree")
    first = device_ms(call, "paged_decode_kernel")
    t["device_ms_again"] = device_ms(kernel, "paged_decode_kernel")
    t["parent_device_ms"] = [first, device_ms(call, "paged_decode_kernel")]
    t["parent_ms"] = time_ms(call)
    print(f"  parent tree's kernel, same inputs, in turns: device {t['parent_device_ms'][0]:.4f} / "
          f"{t['parent_device_ms'][1]:.4f} ms (this tree's again {t['device_ms_again']:.4f} ms), "
          f"back to back {t['parent_ms']:.4f} ms; ratio {t['device_ms'] / min(t['parent_device_ms']):.3f}")


# kernel row 2 (flash in its full-prompt mode) at the wave's served shapes:
# (key, b, s, hq, hkv, d, window) — full waves of Gemma-2B's 128 and 512
# buckets, and one Mistral-7B prompt at the 8,192 bucket with its 4096 band
PROMPT_FLASH_CASES = (
    ("wave b128 w8", 8, 128, 8, 1, 256, 0),
    ("wave b512 w8", 8, 512, 8, 1, 256, 0),
    ("mistral band b8192", 1, 8192, 32, 8, 128, 4096),
)


def _prompt_flash_cases(rnd, peaks, timings: dict) -> float:
    """Flash in its full-prompt mode (null offsets, causal, the window as
    the band) at PROMPT_FLASH_CASES, bf16: held against its plain version
    (BF16_ATOL/RTOL), then timed as the other rows are (CUDA events over 20
    launches from Python, the kernel's device time under torch.profiler,
    the plain version, SDPA on the same inputs: is_causal, or the band as a
    boolean mask, and the bytes/operations bound for the pairs the band
    keeps). The launches must count in flash_attention_prompt. Returns the
    largest absolute error."""
    worst = 0.0
    for key, b, sq, hq, hkv, d, window in PROMPT_FLASH_CASES:
        q = rnd(b, sq, hq, d, dtype=torch.bfloat16)
        k = rnd(b, sq, hkv, d, dtype=torch.bfloat16)
        v = rnd(b, sq, hkv, d, dtype=torch.bfloat16)
        before = A.flash_attention.launches_prompt
        got = A.flash_attention(q, k, v, window=window)
        if A.flash_attention.launches_prompt != before + 1:
            raise AssertionError(f"flash_attention {key}: the full-prompt launch was not counted")
        want = A.flash_attention_plain(q, k, v, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), atol=BF16_ATOL, rtol=BF16_RTOL)
        print(f"flash_attention prompt mode {key:20s} q {list(q.shape)} max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention (full-prompt mode) disagrees with its plain version: {key}")
        worst = max(worst, err)
        del got, want
        nbytes, flops, mask = _flash_work(q, k, None, True, window)
        bound_ms, bound_by = _bound(nbytes, flops, torch.bfloat16, peaks)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        band = mask[:1, None] if window else None  # [1, 1, sq, sk], True = attend

        def library():
            if band is None:
                return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=d ** -0.5,
                                                                        enable_gqa=True)
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, scale=d ** -0.5,
                                                                    enable_gqa=True)

        t = {
            "ms": time_ms(lambda: A.flash_attention(q, k, v, window=window)),
            "device_ms": device_ms(lambda: A.flash_attention(q, k, v, window=window), "flash_mma_kernel"),
            "plain_ms": time_ms(lambda: A.flash_attention_plain(q, k, v, window=window), iters=3, warmup=1),
            "library_ms": time_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        timings[f"flash_attention prompt {key}"] = t
        print(f"timing flash_attention prompt mode {key} q {list(q.shape)} k/v {list(k.shape)} window {window}: kernel "
              f"{t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, sdpa "
              f"{t['library_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
        del q, k, v, mask, band
        torch.cuda.empty_cache()
    return worst


def phase_kernels(dev: dict, seed: int, parent: dict | None = None) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    peaks = dev["peaks"]
    errs = {"flash_attention": 0.0, "paged_decode_partials": 0.0}
    timings = {}

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    # -- kernel 1: flash_attention (Gemma-2B: 8 q heads, 1 kv head, hd 256)
    cap = 512
    # the verify program's attention (llm.step_v5): 32 slots, W = 5 queries
    # each at a decode-time cursor
    verify_offs = [(37 * i) % 500 + 2 for i in range(32)]
    # the shape knobs' widths: prefill chunks of 32, 128 and 256 rows, and
    # the verify of decode_chunk=16's draft cap (32 + 1)
    verify33_offs = [(37 * i) % 470 + 2 for i in range(32)]
    knob_offs = {32: [0, 37, 32, 200, 300, 480, 448, 5], 128: [0, 37, 128, 200, 300, 384, 256, 1],
                 256: [0, 37, 128, 200, 256, 100, 64, 1]}
    flash_cases = [
        # (name, nb, c, offsets or None, causal, window, cap)
        ("offsets c16", 8, 16, [0, 37, 16, 200, 300, 480, 496, 5], True, 0, 0.0),
        ("offsets c64", 8, 64, [0, 37, 64, 100, 255, 400, 448, 1], True, 0, 0.0),
        ("full causal S512", 2, 512, None, True, 0, 0.0),
        ("full non-causal S512", 2, 512, None, False, 0, 0.0),
        ("window 100 offsets c64", 8, 64, [0, 37, 64, 100, 255, 400, 448, 1], True, 100, 0.0),
        ("window 128 full S512", 2, 512, None, True, 128, 0.0),
        ("logit cap 50 offsets c16", 8, 16, [0, 37, 16, 200, 300, 480, 496, 5], True, 0, 50.0),
        ("offsets c12 (not 8-aligned)", 8, 12, [0, 37, 16, 200, 300, 480, 500, 5], True, 0, 0.0),
        ("verify c5, 32 slots", 32, 5, verify_offs, True, 0, 0.0),
        *((f"offsets c{c} (prefill_chunk)", 8, c, offs, True, 0, 0.0) for c, offs in knob_offs.items()),
        ("verify c33, 32 slots (decode_chunk 16)", 32, 33, verify33_offs, True, 0, 0.0),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for name, nb, c, offs, causal, window, lcap in flash_cases:
            q = rnd(nb, c, 8, 256, dtype=dtype)
            k = rnd(nb, cap, 1, 256, dtype=dtype)
            v = rnd(nb, cap, 1, 256, dtype=dtype)
            off = None if offs is None else torch.tensor(offs, dtype=torch.int32, device="cuda")
            kw = dict(causal=causal, window=window, logit_cap=lcap, q_offsets=off)
            got = A.flash_attention(q, k, v, **kw)
            want = A.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                ok = err <= F32_ATOL
            else:
                ok = torch.allclose(got.float(), want.float(), atol=BF16_ATOL, rtol=BF16_RTOL)
            print(f"flash_attention {str(dtype)[6:]:8s} {name:40s} max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention disagrees with its plain version: {name} {dtype}")
            errs["flash_attention"] = max(errs["flash_attention"], err)

    # timing at the serving step's shapes and the verify's (bf16)
    for key, nb, c, offs in (
        ("c16", 8, 16, [0, 37, 16, 200, 300, 480, 496, 5]),
        ("c64", 8, 64, [0, 37, 64, 100, 255, 400, 448, 1]),
        ("verify c5", 32, 5, verify_offs),
        *((f"c{c}", 8, c, offs) for c, offs in knob_offs.items()),
        ("verify c33", 32, 33, verify33_offs),
    ):
        q = rnd(nb, c, 8, 256, dtype=torch.bfloat16)
        k = rnd(nb, cap, 1, 256, dtype=torch.bfloat16)
        v = rnd(nb, cap, 1, 256, dtype=torch.bfloat16)
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        nbytes, flops, mask = _flash_work(q, k, off, True, 0)
        bound_ms, bound_by = _bound(nbytes, flops, torch.bfloat16, peaks)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        amask = mask[:, None]  # [b, 1, sq, sk], True = attend

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=amask, scale=1 / 16, enable_gqa=True
            )

        t = {
            "ms": time_ms(lambda: A.flash_attention(q, k, v, q_offsets=off)),
            "device_ms": device_ms(lambda: A.flash_attention(q, k, v, q_offsets=off), "flash_mma_kernel"),
            "plain_ms": time_ms(lambda: A.flash_attention_plain(q, k, v, q_offsets=off)),
            "library_ms": time_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        timings[f"flash_attention {key}"] = t
        print(f"timing flash_attention {key} q {list(q.shape)}: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), "
              f"plain {t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")

    # full-prompt mode (kernel row 2: the wave scheduler's monolithic
    # prefill, not on the chunked main path): one 512-token prompt
    q = rnd(1, 512, 8, 256, dtype=torch.bfloat16)
    k = rnd(1, 512, 1, 256, dtype=torch.bfloat16)
    v = rnd(1, 512, 1, 256, dtype=torch.bfloat16)
    nbytes, flops, _mask = _flash_work(q, k, None, True, 0)
    bound_ms, bound_by = _bound(nbytes, flops, torch.bfloat16, peaks)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    t = {
        "ms": time_ms(lambda: A.flash_attention(q, k, v)),
        "device_ms": device_ms(lambda: A.flash_attention(q, k, v), "flash_mma_kernel"),
        "plain_ms": time_ms(lambda: A.flash_attention_plain(q, k, v)),
        "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=1 / 16, enable_gqa=True)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    timings["flash_attention full S512"] = t
    print(f"timing flash_attention full causal S=512: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), "
          f"plain {t['plain_ms']:.4f} ms, "
          f"sdpa {t['library_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    errs["flash_attention_prompt"] = _prompt_flash_cases(rnd, peaks, timings)

    # -- kernel 2: paged_decode_partials (32 slots, 1024 blocks of 16 rows)
    NB, B, MB, nb = 1024, 16, 32, 32
    lengths = [0, 1, 16, 511, 17, 33, 64, 100] + [(37 * i) % 500 + 2 for i in range(24)]
    for dtype in (torch.bfloat16, torch.float32):
        q = rnd(nb, 8, 256, dtype=dtype)
        kp = rnd(NB, B, 1, 256, dtype=dtype)
        vp = rnd(NB, B, 1, 256, dtype=dtype)
        tables = torch.randperm(NB, generator=g, device="cuda")[: nb * MB].reshape(nb, MB).to(torch.int32)
        hi = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        for name, lo, lcap in (
            ("full band", torch.zeros_like(hi), 0.0),
            ("window band lo>0", torch.clamp(hi - 40, min=0).to(torch.int32), 0.0),
            ("logit cap 30", torch.zeros_like(hi), 30.0),
        ):
            kw = dict(scale=1 / 16, logit_cap=lcap)
            o1, m1, l1 = A.paged_decode_partials(q, kp, vp, tables, lo, hi, **kw)
            o2, m2, l2 = A.paged_decode_partials_plain(q, kp, vp, tables, lo, hi, **kw)
            torch.cuda.synchronize()
            err = (o1 - o2).abs().max().item()
            ok = (
                err <= F32_ATOL
                and torch.allclose(m1, m2, rtol=ML_RTOL, atol=0.0)
                and torch.allclose(l1, l2, rtol=ML_RTOL, atol=0.0)
            )
            print(f"paged_decode_partials {str(dtype)[6:]:8s} {name:18s} o max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"paged_decode_partials disagrees with its plain version: {name} {dtype}")
            errs["paged_decode_partials"] = max(errs["paged_decode_partials"], err)

    q = rnd(nb, 8, 256, dtype=torch.bfloat16)
    kp = rnd(NB, B, 1, 256, dtype=torch.bfloat16)
    vp = rnd(NB, B, 1, 256, dtype=torch.bfloat16)
    tables = torch.randperm(NB, generator=g, device="cuda")[: nb * MB].reshape(nb, MB).to(torch.int32)
    hi = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    lo = torch.zeros_like(hi)
    rows = int(hi.sum())
    # band rows of K and V, the table entries that name their blocks, lo and
    # hi, and the f32 outputs o, m, l
    table_entries = int(((hi + B - 1) // B).sum())
    nbytes = q.numel() * 2 + 2 * rows * 256 * 2 + table_entries * 4 + 2 * nb * 4 + (nb * 8 * 256 + 2 * nb * 8) * 4
    bound_ms, bound_by = _bound(nbytes, 4 * 256 * 8 * rows, torch.bfloat16, peaks)
    def kernel():
        return A.paged_decode_partials(q, kp, vp, tables, lo, hi, scale=1 / 16)

    t = {
        "ms": time_ms(kernel),
        "device_ms": device_ms(kernel, "paged_decode_kernel"),
        "plain_ms": time_ms(lambda: A.paged_decode_partials_plain(q, kp, vp, tables, lo, hi, scale=1 / 16)),
        "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    timings["paged_decode_partials"] = t
    print(f"timing paged_decode_partials: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), "
          f"plain {t['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), {rows} band rows")
    if parent:
        _time_parent(parent["paged_decode"], t, kernel, (q, kp, vp, tables, lo, hi), {})
    # what a launch costs with no row to read, and per table slot: every
    # sequence's band k shares of 16-row slots long (8 splits at this shape)
    splits = A.paged_decode_plan(torch.bfloat16, nb, 8, 1, 256, B, MB)[0]
    by_slots = {}
    for k in (0, 1, 2, 4):
        hi_k = torch.full((nb,), k * splits * B, dtype=torch.int32, device="cuda")
        by_slots[k] = device_ms(lambda: A.paged_decode_partials(q, kp, vp, tables, lo, hi_k, scale=1 / 16),
                                "paged_decode_kernel")
    t["device_ms_by_slots_per_cta"] = by_slots
    print("paged_decode_partials device ms by table slots per CTA (every band the same length): "
          + ", ".join(f"{k}: {v:.4f}" for k, v in by_slots.items()))

    # -- kernel 3: paged_decode_partials over int8 pools (same shapes; rows
    # made by the port's own quantize_rows). Both sides dequantize in f32,
    # so o differs only by summation order: F32_ATOL, m and l ML_RTOL.
    errs["paged_decode_partials_int8"] = 0.0
    kq, ks = quantize_rows(rnd(NB, B, 1, 256, dtype=torch.float32))
    vq, vs = quantize_rows(rnd(NB, B, 1, 256, dtype=torch.float32))
    for dtype in (torch.bfloat16, torch.float32):
        q = rnd(nb, 8, 256, dtype=dtype)
        tables = torch.randperm(NB, generator=g, device="cuda")[: nb * MB].reshape(nb, MB).to(torch.int32)
        hi = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        for name, lo, lcap in (
            ("full band", torch.zeros_like(hi), 0.0),
            ("window band lo>0", torch.clamp(hi - 40, min=0).to(torch.int32), 0.0),
            ("logit cap 30", torch.zeros_like(hi), 30.0),
        ):
            kw = dict(scale=1 / 16, logit_cap=lcap, k_scales=ks, v_scales=vs)
            o1, m1, l1 = A.paged_decode_partials(q, kq, vq, tables, lo, hi, **kw)
            o2, m2, l2 = A.paged_decode_partials_plain(q, kq, vq, tables, lo, hi, **kw)
            torch.cuda.synchronize()
            err = (o1 - o2).abs().max().item()
            ok = (
                err <= F32_ATOL
                and torch.allclose(m1, m2, rtol=ML_RTOL, atol=0.0)
                and torch.allclose(l1, l2, rtol=ML_RTOL, atol=0.0)
            )
            print(f"paged_decode_partials int8 q {str(dtype)[6:]:8s} {name:18s} o max_abs_err {err:.3e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"int8 paged_decode_partials disagrees with its plain version: {name} {dtype}")
            errs["paged_decode_partials_int8"] = max(errs["paged_decode_partials_int8"], err)

    q = rnd(nb, 8, 256, dtype=torch.bfloat16)
    tables = torch.randperm(NB, generator=g, device="cuda")[: nb * MB].reshape(nb, MB).to(torch.int32)
    hi = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    lo = torch.zeros_like(hi)
    rows = int(hi.sum())
    table_entries = int(((hi + B - 1) // B).sum())
    # band rows of K and V (1 byte per element) and their f32 scales (one
    # per row per tensor), the table entries that name their blocks, lo and
    # hi, and the f32 outputs o, m, l. The dots run on dequantized f32
    # values, so the operations count against the f32 peak.
    nbytes = (q.numel() * 2 + 2 * rows * 256 + 2 * rows * 4 + table_entries * 4 + 2 * nb * 4
              + (nb * 8 * 256 + 2 * nb * 8) * 4)
    bound_ms, bound_by = _bound(nbytes, 4 * 256 * 8 * rows, torch.float32, peaks)
    kw = dict(scale=1 / 16, k_scales=ks, v_scales=vs)
    def kernel_int8():
        return A.paged_decode_partials(q, kq, vq, tables, lo, hi, **kw)

    t = {
        "ms": time_ms(kernel_int8),
        "device_ms": device_ms(kernel_int8, "paged_decode_kernel"),
        "plain_ms": time_ms(lambda: A.paged_decode_partials_plain(q, kq, vq, tables, lo, hi, **kw)),
        "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    timings["paged_decode_partials_int8"] = t
    print(f"timing paged_decode_partials int8: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), "
          f"plain {t['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), {rows} band rows")
    if parent:
        _time_parent(parent["paged_decode_int8"], t, kernel_int8, (q, kq, vq, tables, lo, hi),
                     dict(k_scales=ks, v_scales=vs))
    _paged_block_cases(rnd, g, peaks, lengths, errs, timings)
    return {"errs": errs, "timings": timings}


# Rows 3-4 at the shape knobs' KV blocks: (model, hq, hkv, head_dim) at
# 32 sequences, max_seq_len 512 (table width 512 / B), the same 6002 band
# rows as the B = 16 case
PAGED_BLOCKS = (8, 32)
PAGED_BLOCK_HEADS = (("gemma_2b", 8, 1, 256), ("llama3_8b", 32, 8, 128))


def _paged_block_cases(rnd, g, peaks, lengths, errs: dict, timings: dict) -> None:
    """Both paged-decode entry points at B = 8 and 32 rows a block: the
    launch plan (splits, shared memory per CTA) printed; f32, bf16 and
    int8 pools held against the plain version on full bands, bands with
    lo > 0 and a logit cap (o to F32_ATOL, m and l to ML_RTOL, as at
    B = 16); bf16 and int8 pools timed at the 6002 band rows (CUDA
    events, device time, plain version, bound; no library call)."""
    nb = len(lengths)
    hi = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    rows = int(hi.sum())
    for model, hq, hkv, d in PAGED_BLOCK_HEADS:
        for B in PAGED_BLOCKS:
            MB = 512 // B
            NB = nb * MB
            for pool in (torch.bfloat16, torch.int8):
                splits, smem = A.paged_decode_plan(pool, nb, hq, hkv, d, B, MB)
                print(f"paged_decode plan {model} B{B}, {str(pool)[6:]} pools [{NB}, {B}, {hkv}, {d}], tables "
                      f"[{nb}, {MB}]: {splits} splits, {smem} bytes of dynamic shared memory per CTA")
            tables = torch.randperm(NB, generator=g, device="cuda")[: nb * MB].reshape(nb, MB).to(torch.int32)
            kq, ks = quantize_rows(rnd(NB, B, hkv, d, dtype=torch.float32))
            vq, vs = quantize_rows(rnd(NB, B, hkv, d, dtype=torch.float32))
            pools = {"f32": (rnd(NB, B, hkv, d, dtype=torch.float32), rnd(NB, B, hkv, d, dtype=torch.float32), {}),
                     "bf16": (rnd(NB, B, hkv, d, dtype=torch.bfloat16), rnd(NB, B, hkv, d, dtype=torch.bfloat16), {}),
                     "int8": (kq, vq, dict(k_scales=ks, v_scales=vs))}
            scale = d ** -0.5
            for pool, (kp, vp, sc) in pools.items():
                name = "paged_decode_partials_int8" if pool == "int8" else "paged_decode_partials"
                q = rnd(nb, hq, d, dtype=torch.float32 if pool == "f32" else torch.bfloat16)
                for band, lo, lcap in (
                    ("full band", torch.zeros_like(hi), 0.0),
                    ("window band lo>0", torch.clamp(hi - 40, min=0).to(torch.int32), 0.0),
                    ("logit cap 30", torch.zeros_like(hi), 30.0),
                ):
                    before = _launches((name,))[name]
                    o1, m1, l1 = A.paged_decode_partials(q, kp, vp, tables, lo, hi, scale=scale, logit_cap=lcap, **sc)
                    o2, m2, l2 = A.paged_decode_partials_plain(q, kp, vp, tables, lo, hi, scale=scale,
                                                               logit_cap=lcap, **sc)
                    torch.cuda.synchronize()
                    err = (o1 - o2).abs().max().item()
                    ok = (_launches((name,))[name] == before + 1 and err <= F32_ATOL
                          and torch.allclose(m1, m2, rtol=ML_RTOL, atol=1e-5)
                          and torch.allclose(l1, l2, rtol=ML_RTOL, atol=1e-5))
                    print(f"{name} {model} B{B} {pool:4s} pools {band:16s} o max_abs_err {err:.3e} "
                          f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{name} at B={B} ({model}, {pool}, {band}) disagrees with its plain "
                                             f"version or was not launched")
                    errs[name] = max(errs[name], err)
                if pool == "f32":
                    continue
                lo = torch.zeros_like(hi)
                table_entries = int(((hi + B - 1) // B).sum())
                kv_bytes = 2 * rows * hkv * d * kp.element_size() + (2 * rows * hkv * 4 if sc else 0)
                nbytes = (q.numel() * 2 + kv_bytes + table_entries * 4 + 2 * nb * 4 + (nb * hq * d + 2 * nb * hq) * 4)
                bound_ms, bound_by = _bound(nbytes, 4 * d * hq * rows, torch.float32 if sc else torch.bfloat16, peaks)

                def kernel():
                    return A.paged_decode_partials(q, kp, vp, tables, lo, hi, scale=scale, **sc)

                t = {
                    "ms": time_ms(kernel),
                    "device_ms": device_ms(kernel, "paged_decode_kernel"),
                    "plain_ms": time_ms(lambda: A.paged_decode_partials_plain(q, kp, vp, tables, lo, hi, scale=scale,
                                                                              **sc)),
                    "library_ms": None,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                }
                timings[f"{name} {model} B{B}"] = t
                print(f"timing {name} {model} B{B}: q {list(q.shape)}, pools {list(kp.shape)}, tables [{nb}, {MB}]: "
                      f"kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
                      f"bound {bound_ms:.5f} ms ({bound_by}), {rows} band rows")
            del pools, kq, vq, ks, vs
            torch.cuda.empty_cache()


def _engine_state(eng) -> dict:
    """Every tensor the engine's programs write: the K/V rows of the pool
    (and an int8 pool's scales) or of the contiguous slab or ring,
    lengths, tail, active mask and temperatures."""
    state = {"k": eng.cache.k, "v": eng.cache.v, "length": eng.cache.length, "tail": eng._tail,
             "active": eng._active, "temps": eng._temps, "gstate": eng._gstate}
    if eng.pool_scales is not None:
        state["scales"] = eng.pool_scales
    return state


def _snapshot(eng) -> dict:
    return {k: v.clone() for k, v in _engine_state(eng).items()}


def _restore(eng, snap: dict) -> None:
    for k, v in _engine_state(eng).items():
        v.copy_(snap[k])


def _bytes_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality, compared 256 MiB at a time (a Gemma-7B pool is
    3.75 GB a tensor: one comparison would allocate as much again)."""
    a, b = a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)
    step = 1 << 28
    return a.numel() == b.numel() and all(torch.equal(a[i : i + step], b[i : i + step])
                                          for i in range(0, a.numel(), step))


def _family_inputs(eng, name: str, g: torch.Generator, temperature: float):
    """Random live state for family ``name`` (written into the engine) and
    a function that stages the inputs of one dispatch. Step and chunk:
    every slot active and live on private blocks with room for the step,
    prefill rows (the last lane padding when the width allows) at their
    slots' lengths, alternate rows finishing their prompt. kv_seed: block
    copies between distinct random blocks and length writes to distinct
    slots, two lanes padding. Hit: random staged logits, first tokens for
    distinct slots, the last lane padding when the width allows. Verify:
    every slot active on private blocks, all but the last selected, with
    random drafts of lengths 0..Kd. A constrained family (``...g``) also
    gets random grammar ids (a resident grammar or -1) and DFA states
    below each grammar's terminal row, the step's rows the ids and states
    of their slots; it needs a resident grammar. A LoRA engine's slots get
    random adapter ids in [0, lora_slots] (mixed ids live). A contiguous
    engine has no tables; on a ring the lengths run past the capacity
    (absolute, up to max_seq_len), so the rows wrap."""
    cfg, slots, K = eng.cfg, eng.slots, eng.decode_chunk
    cap, MB = eng.kv.capacity, eng.kv.table_width
    dev = eng.device
    if eng.pool_scales is None:
        for t in (eng.cache.k, eng.cache.v):
            for layer in t:  # a layer at a time: a float32 draw of a whole ring would double it
                layer.copy_(torch.randn(layer.shape, generator=g, device=dev).to(t.dtype))
    else:
        for t in (eng.pool.k, eng.pool.v):
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, device=dev, dtype=torch.int8))
        eng.pool_scales.copy_(torch.rand(eng.pool_scales.shape, generator=g, device=dev) * 0.02 + 1e-3)
    _fn, kind, arg = eng._program(name)
    gids = None
    if name in eng._programs_g:
        resident = [i for i, gr in enumerate(eng._grammars) if gr is not None]
        pick = torch.randint(0, len(resident) + 1, (slots,), generator=g, device=dev).cpu().tolist()
        gids = np.array([resident[p] if p < len(resident) else -1 for p in pick], np.int32)
        states = [int(torch.randint(0, max(1, eng._grammars[i].n_states - 1), (1,), generator=g, device=dev))
                  if i >= 0 else 0 for i in gids]
        eng._gstate.copy_(torch.tensor(states, dtype=torch.int32, device=dev))
    aids = None
    if eng.lora_slots:
        aids = torch.randint(0, eng.lora_slots + 1, (slots,), generator=g, device=dev, dtype=torch.int32).cpu().numpy()
    shape = arg[0] if kind == "step" else 0
    top = eng.max_seq_len if eng.kv.rolling else cap
    lengths = torch.randint(1, top - shape - 2 * K, (slots,), generator=g, device=dev, dtype=torch.int32)
    eng.cache.length.copy_(lengths)
    eng._tail.copy_(torch.randint(0, cfg.vocab_size, (slots,), generator=g, device=dev, dtype=torch.int32))
    eng._active.fill_(True)
    eng._temps.fill_(temperature)
    M = eng.admit_cap
    if kind in ("seed", "hit"):
        NB = eng.kv.pool.n_blocks if eng.kv.paged else 2 * M
        seed = eng._inert_seed()
        perm_b = torch.randperm(NB, generator=g, device=dev).cpu().numpy()
        perm_s = torch.randperm(slots, generator=g, device=dev).cpu().numpy()
        if kind == "seed":
            seed[0] = perm_b[:M]
            seed[1, : M - 2] = perm_b[M : 2 * M - 2]
            seed[2, : M - 2] = perm_s[: M - 2]
            seed[3] = torch.randint(1, cap, (M,), generator=g, device=dev).cpu().numpy()
        else:
            nb = arg
            eng._active.fill_(False)  # the program's writes must show
            eng._temps.fill_(0.5)
            eng._hit_logits.copy_(torch.randn(eng._hit_logits.shape, generator=g, device=dev) * 4)
            rows = nb - 1 if nb > 1 else 1
            seed[4, :rows] = perm_s[:rows]
            seed[5, :rows] = np.arange(rows)
            seed[6, :rows] = np.float32(temperature).view(np.int32)
        return lambda: eng._in.write_seed(seed)
    tables = (
        torch.randperm(eng.kv.pool.n_blocks, generator=g, device=dev)[: slots * MB].reshape(slots, MB).int().cpu().numpy()
        if eng.kv.paged else np.zeros((slots, 0), np.int32)
    )
    live = np.ones((slots,), bool)
    if kind == "chunk":
        return lambda: eng._in.write(tables, live, gids=gids, aids=aids)
    if kind == "prefill":
        bucket, nb = arg
        rows = nb - 1 if nb > 1 else 1
        eng._active.fill_(False)  # the program's writes must show
        perm_s = torch.randperm(slots, generator=g, device=dev).cpu().numpy()
        lens = torch.randint(1, bucket + 1, (rows,), generator=g, device=dev).cpu().numpy()
        toks = torch.randint(1, cfg.vocab_size, (nb, bucket), generator=g, device=dev).cpu().numpy()
        pack = np.zeros((nb, bucket + 3), np.int32)
        pack[:, bucket + 1] = 1
        meta = np.zeros((2, nb), np.int32)
        for j in range(rows):
            pack[j, : lens[j]] = toks[j, : lens[j]]
            pack[j, bucket + 1] = lens[j]
            pack[j, bucket + 2] = np.float32(temperature).view(np.int32)
            meta[0, j], meta[1, j] = perm_s[j], j
        meta[:, rows:] = meta[:, :1]  # pad lanes repeat lane 0, as a wave's do
        return lambda: eng._in.write(tables, np.zeros((slots,), bool), meta, pack)
    if kind == "verify":
        Kd = arg - 1
        vpack = np.zeros((slots, Kd + 2), np.int32)
        vpack[:, :Kd] = torch.randint(1, cfg.vocab_size, (slots, Kd), generator=g, device=dev).cpu().numpy()
        vpack[:, Kd] = np.arange(slots) % (Kd + 1)
        vpack[: slots - 1, Kd + 1] = 1
        return lambda: eng._in.write(tables, live, verify=vpack, gids=gids, aids=aids)
    nb = arg[1]
    rows = nb - 1 if nb > 1 else 1
    lens = lengths.cpu().numpy()
    pack = np.zeros((nb, shape + 3), np.int32)
    meta = np.zeros((2 if gids is None else 4, nb), np.int32)
    meta[0, :] = slots
    meta[2:] = -1
    toks = torch.randint(1, cfg.vocab_size, (nb, shape), generator=g, device=dev).cpu().numpy()
    for j in range(rows):
        n = shape - j
        pack[j, :n] = toks[j, :n]
        pack[j, shape], pack[j, shape + 1] = lens[j], n
        pack[j, shape + 2] = np.float32(temperature).view(np.int32)
        meta[0, j], meta[1, j] = j, j % 2
        if gids is not None:
            meta[2, j], meta[3, j] = gids[j], 0 if gids[j] < 0 else states[j]
    return lambda: eng._in.write(tables, live, meta, pack, gids=gids, aids=aids)


def _outputs(out) -> tuple:
    """A program's output(s) as a flat tuple of clones: a step of a sharing
    engine returns (tokens, logits), a wave's prefill (tokens, logits or
    None, (k, v) rows or None)."""
    if isinstance(out, (tuple, list)):
        return tuple(t for x in out for t in _outputs(x))
    return () if out is None else (out.clone(),)


def check_family(eng, name: str, seed: int, temperature: float = 0.0, replays: int = 1) -> dict:
    """Family ``name`` of a CUDA engine (captured at its warmup, or here)
    against its eager program on a random live state: one eager call, then
    ``replays`` replays, each from the same cloned state on identical
    inputs. Returns whether the first replay's outputs (tokens, and a
    sharing step's logits) and its pool bytes, lengths, tail, active mask
    and temperatures are bitwise the eager call's (the test at temperature
    0; above it the draws differ by design), whether the first two
    replays' tokens differ (fresh draws), and the kernel launches the
    replays counted beside the family's captured count. Runs with the
    engine idle, holding its lock, and puts its state back."""
    g = torch.Generator(device=eng.device).manual_seed(seed)
    with eng._lock, torch.no_grad(), torch.cuda.stream(eng._stream):
        eng._ensure_family(name)
        fam = eng.families[name]
        orig = _snapshot(eng)
        stage = _family_inputs(eng, name, g, temperature)
        s0 = _snapshot(eng)
        stage()
        eager = _outputs(eng._program(name)[0]())
        s_eager = _snapshot(eng)
        before = {k: getattr(*A._counter(k)) for k in fam.launches}
        draws, s_replay = [], None
        for _ in range(replays):
            _restore(eng, s0)
            stage()
            draws.append(_outputs(eng._launch(name)))
            if s_replay is None:
                s_replay = _snapshot(eng)
        eng._stream.synchronize()
        state_equal = {k: _bytes_equal(s_eager[k], s_replay[k]) for k in s0}
        state_equal["outputs"] = all(_bytes_equal(a, b) for a, b in zip(eager, draws[0]))
        out = {
            "eager_equal": all(state_equal.values()),
            "state_equal": state_equal,
            "draws_differ": len(draws) > 1 and not torch.equal(draws[0][0], draws[1][0]),
            "launches": {k: getattr(*A._counter(k)) - before[k] for k in fam.launches},
            "captured": dict(fam.launches),
        }
        _restore(eng, orig)
        eng._stream.synchronize()
    return out


def program_ms(eng, name: str, seed: int, iters: int = 10) -> float:
    """Mean device time of one replay of family ``name`` (CUDA events
    around each replay alone), each from the same random live state and
    inputs as check_family's; the engine idle, its state put back."""
    g = torch.Generator(device=eng.device).manual_seed(seed)
    times = []
    with eng._lock, torch.no_grad(), torch.cuda.stream(eng._stream):
        eng._ensure_family(name)
        orig = _snapshot(eng)
        stage = _family_inputs(eng, name, g, 0.0)
        s0 = _snapshot(eng)
        for _ in range(iters + 1):
            _restore(eng, s0)
            stage()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            eng._launch(name)
            end.record()
            times.append((start, end))
        eng._stream.synchronize()
        _restore(eng, orig)
        eng._stream.synchronize()
    return sum(a.elapsed_time(b) for a, b in times[1:]) / iters


def _serve(eng, prompts, new_tokens, adapters=None, clients=None):
    """Submit every prompt from its own client thread at once (prompt i
    under LoRA adapter ``adapters[i]`` when given, "" the base, as client
    ``clients[i]`` when given); returns ({i: tokens}, {i: request}, wall
    seconds)."""
    results: dict[int, list[int]] = {}
    reqs: dict[int, GenRequest] = {}
    errors: list[BaseException] = []

    def client(i):
        try:
            r = eng.submit(GenRequest(prompts[i], max_new_tokens=new_tokens,
                                      adapter=adapters[i] if adapters else "",
                                      client=clients[i] if clients else ""))
            reqs[i] = r
            results[i] = r.tokens(timeout=600)
        except BaseException as e:  # surfaced below, after every client joined
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads):
        raise TimeoutError("engine clients did not finish")
    return results, reqs, wall


def _profile(fn, label: str = "") -> dict:
    """Run fn under torch.profiler and print the device's busy and idle
    share and the kernels that took the most device time. Returns the
    idle share and {group: (device ms, launches)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    groups: dict[str, list] = {}
    for e in kern:
        name = e.key
        group = (
            "paged_decode_kernel" if "paged_decode_kernel" in name
            else "flash kernels" if "flash_" in name and "_kernel" in name
            else "matmul" if any(t in name.lower() for t in ("gemm", "gemv", "xmma", "cutlass", "nvjet"))
            else "other"
        )
        g = groups.setdefault(group, [0.0, 0])
        g[0] += e.self_device_time_total
        g[1] += e.count
    idle = 1 - busy_us / wall_us
    print(f"{label}profile (engine traffic again, under the profiler): wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), idle {100 * idle:.1f}%")
    for group, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"{label}profile group {group:20s} {us / 1e3:9.2f} ms device  {n:7d} launches  "
              f"{100 * us / max(busy_us, 1e-9):5.1f}% of busy")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"{label}profile kernel {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x {e.key[:90]}")
    named = "paged_decode_kernel" in groups and "flash kernels" in groups
    print(f"{label}profile: the profiler {'names' if named else 'does NOT name'} the hand-written kernels "
          f"inside CUDA graph replays (groups seen: {sorted(groups)})")
    return {"idle": idle, "wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "groups": {k: (v[0] / 1e3, v[1]) for k, v in groups.items()}}


def gemma_weights(seed: int) -> tuple[TransformerConfig, dict]:
    """Gemma-2B's random bf16 weights, made once from ``seed`` and shared by
    the engine, int8 and edge phases."""
    cfg = TransformerConfig.gemma_2b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    n_params = sum(w.numel() for w in [params["embed"], params["final_norm"], *params["layers"].values()])
    print(f"gemma_2b random weights: {n_params / 1e9:.3f} B params bf16 in {time.perf_counter() - t0:.1f}s")
    return cfg, params


def _first_layers(cfg, params: dict, n: int) -> tuple[TransformerConfig, dict]:
    """The model cut to its first ``n`` layers at full width: views of the
    stacked layer tensors, no copy (a phase's depth cut for the script's
    time)."""
    return dataclasses.replace(cfg, n_layers=n), {**params, "layers": {k: v[:n] for k, v in params["layers"].items()}}


def _replay_gate(params, cfg, prompts, results, gap: float, label: str = "", verbose: bool = True,
                 stats: dict | None = None, aid: int | None = None) -> tuple[int, int]:
    """Every served token against greedy decoding by the plain full-prompt
    forward on ``params`` (no kernels), teacher-forced on the served
    stream: token j must be the plain argmax after prompt + served[:j],
    unless the plain top-2 gap is below ``gap``. Raises on a token that
    fails; returns (tokens matched, tokens exempt). With ``stats``, adds
    the count of served positions whose plain top-2 gap is below
    TOKEN_GAP ("near") and the gap of every exempt token ("exempt_gaps").
    ``aid``: the forward adds the delta of LoRA gid ``aid`` of ``params``'
    tables."""
    checked = exempt = 0
    aids = None if aid is None else torch.tensor([aid], device="cuda")
    for i, p in enumerate(prompts):
        seq = p + results[i][:-1]
        logits = transformer_forward(
            params, cfg, torch.tensor([seq], device="cuda"), torch.arange(len(seq), device="cuda")[None, :],
            aids=aids,
        )[0, len(p) - 1 :]  # [new_tokens, vocab]
        top2 = torch.topk(logits, 2, dim=-1)
        gaps = (top2.values[:, 0] - top2.values[:, 1]).tolist()
        want = top2.indices[:, 0].tolist()
        n_match = n_exempt = 0
        for j, served in enumerate(results[i]):
            if stats is not None:
                stats["near"] = stats.get("near", 0) + (gaps[j] < TOKEN_GAP)
            if served == want[j]:
                n_match += 1
            elif gaps[j] < gap:
                n_exempt += 1
                if stats is not None:
                    stats.setdefault("exempt_gaps", []).append(gaps[j])
            else:
                raise AssertionError(
                    f"{label}request {i} (prompt {len(p)}): token {j} served {served} != plain argmax "
                    f"{want[j]}, gap {gaps[j]:.4f}"
                )
        checked += n_match
        exempt += n_exempt
        if verbose:
            print(f"{label}stream prompt {len(p):3d}: {n_match} of {len(results[i])} tokens equal the plain greedy "
                  f"argmax, {n_exempt} differ within tolerance (top-2 gap < {gap}); smallest gap {min(gaps):.4f}")
        del logits
    return checked, exempt


def _warm_report(label: str, eng) -> dict:
    """Print an engine's captured graph families, warmup_s and the memory
    the capture reserved; fail unless every family was captured."""
    before, after = eng.warmup_reserved
    names = list(eng.families)
    print(f"{label}warmup: {len(names)} CUDA graphs captured in {eng.warmup_s:.3f} s (warmup_s): "
          f"{', '.join(names)}; torch.cuda.memory_reserved {before} -> {after} bytes (+{after - before})")
    if sorted(names) != sorted(set(eng._programs) - eng._lazy) or eng.stats()["warmup_s"] != eng.warmup_s:
        raise AssertionError(f"{label}warmup captured {names}, programs {list(eng._programs)}")
    return {"families": names, "warmup_s": eng.warmup_s, "reserved_before": before, "reserved_after": after}


def _check_families(label: str, eng, seed: int, extra=()) -> None:
    """Every captured family (and the lazy ones named in ``extra``, which
    this captures) against its eager program (check_family), at
    temperature 0; then two replays each of the 8-step chunk, the widest
    step or wave prefill (and the widest hit program of an engine with a
    prefix index) at a high temperature, which must draw differently (and
    the verify's of a speculating engine). On the paged pool step and
    chunk families hold the paged-decode kernel, and steps and the verify
    the flash kernel in its q_offsets mode; a wave's prefill holds flash in
    its full-prompt mode on every layout; kv_seed and the hit programs hold
    no kernel. A contiguous engine's programs hold no paged kernel, and on
    a ring no q_offsets flash either (plain attention, as in JAX)."""
    for i, name in enumerate(list(eng.families) + [n for n in extra if n not in eng.families]):
        r = check_family(eng, name, seed + i)
        kind = eng._program(name)[1]
        print(f"{label}replay vs eager {name}: outputs and state bitwise "
              f"{'equal' if r['eager_equal'] else 'DIFFERENT ' + str(r['state_equal'])}; launches per replay "
              f"{r['launches']} (captured {r['captured']})")
        if not r["eager_equal"]:
            raise AssertionError(f"{label}{name}: replay differs from the eager program: {r['state_equal']}")
        paged = "paged_decode_partials_int8" if eng.pool_scales is not None else "paged_decode_partials"
        if r["launches"] != r["captured"] or bool(r["captured"].get(paged)) != (
            eng.kv.paged and kind in ("step", "chunk")
        ):
            raise AssertionError(f"{label}{name}: launches {r['launches']}, captured {r['captured']}")
        flash = kind == "prefill" or (kind in ("step", "verify") and not eng.kv.rolling)
        prompt = r["captured"].get("flash_attention", 0) if kind == "prefill" else 0
        if bool(r["captured"].get("flash_attention")) != flash or r["captured"].get("flash_attention_prompt", 0) != prompt:
            raise AssertionError(f"{label}{name} ({kind}): flash launches {r['captured']}")
    widest = (eng._step_name(eng.chunk_shapes[-1], eng.admit_cap) if eng.chunked
              else eng._prefill_name(eng.prefill_buckets[-1], eng.admit_cap))
    sampled = [f"llm.decode_chunk{eng.decode_chunk}", widest]
    if eng._keep_logits:
        sampled.append(f"llm.hit_first.w{eng.admit_cap}")
    if eng.speculative:
        sampled.append(f"llm.step_v{eng.spec_draft + 1}")
    for name in sampled:
        r = check_family(eng, name, seed + 100, temperature=1000.0, replays=2)
        print(f"{label}sampled replays {name} at temperature 1000: two replays from one state "
              f"{'draw different tokens' if r['draws_differ'] else 'REPEAT THEIR DRAWS'}; launches {r['launches']}")
        if not r["draws_differ"] or r["launches"] != {k: 2 * n for k, n in r["captured"].items()}:
            raise AssertionError(f"{label}{name}: sampled replays {r}")


def _chunked_drift(params, cfg, prompt, capacity: int) -> float:
    """The largest |served - plain| last-position logit: ``prompt`` prefilled
    in 64-token chunks through prefill_append (the flash kernel) against
    the plain full-prompt forward."""
    k0 = torch.zeros((cfg.n_layers, 1, capacity, cfg.n_kv_heads, cfg.head_dim), dtype=cfg.dtype, device="cuda")
    view = KVCache(k=k0, v=k0.clone(), length=torch.zeros(1, dtype=torch.int32, device="cuda"))
    cur = 0
    for c0 in range(0, len(prompt), 64):
        chunk = prompt[c0 : c0 + 64]
        toks = torch.zeros((1, 64), dtype=torch.long, device="cuda")
        toks[0, : len(chunk)] = torch.tensor(chunk, device="cuda")
        logits_c, view = prefill_append(
            params, cfg, toks, view,
            torch.tensor([cur], dtype=torch.int32, device="cuda"),
            torch.tensor([len(chunk)], dtype=torch.int32, device="cuda"),
        )
        cur += len(chunk)
    plain = transformer_forward(
        params, cfg, torch.tensor([prompt], device="cuda"), torch.arange(len(prompt), device="cuda")[None, :],
        unembed_positions=torch.tensor([len(prompt) - 1], device="cuda"),
    )[0, 0]
    return float((logits_c[0] - plain).abs().max())


def _bursts(label: str, eng, prompts, new_tokens: int, counters: tuple, lookaheads=None,
            adapters=None) -> list[dict]:
    """The burst three times at the engine's lookahead, then once at
    lookahead 1 on the same engine (the scheduler reads ``lookahead`` on
    every pass), or once at each of ``lookaheads``, each with the kernel
    counters zeroed just before it. Prints each, then (for the default
    four) the median and spread of tok/s and TTFT."""
    runs = []
    depth = eng.lookahead
    for la in lookaheads or (depth, depth, depth, 1):
        eng.lookahead = la
        _zero_launches(counters)
        st0 = eng.stats()
        results, reqs, wall = _serve(eng, prompts, new_tokens, adapters)
        st = eng.stats()
        launches = _launches(counters)
        ttfts = sorted(reqs[i].first_token_at - reqs[i].submitted_at for i in reqs)
        total = sum(len(t) for t in results.values())
        run = {"lookahead": la, "results": results, "wall_s": wall, "tokens": total, "tok_s": total / wall,
               "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1], "launches": launches,
               "chunks": st["chunks"] - st0["chunks"], "steps": st["steps"] - st0["steps"]}
        run["reqs"] = reqs
        runs.append(run)
        print(f"{label}burst {len(runs)} at lookahead {la}: {total} tokens in {wall:.3f}s = {run['tok_s']:.1f} tok/s; "
              f"ttft p50 {run['ttft_p50_s']:.3f}s max {run['ttft_max_s']:.3f}s; {run['chunks']} programs "
              f"({run['steps']} unified steps); "
              f"launches {launches}")
    eng.lookahead = depth
    for key in ("tok_s", "ttft_p50_s", "ttft_max_s") if lookaheads is None else ():
        vals = [r[key] for r in runs[:3]]
        print(f"{label}bursts at lookahead {depth}, {key}: median {statistics.median(vals):.4f}, "
              f"min {min(vals):.4f}, max {max(vals):.4f}, spread {max(vals) - min(vals):.4f}; "
              f"at lookahead 1: {runs[3][key]:.4f}")
    for r in runs:
        toks = r["results"]
        if len(toks) != len(prompts) or any(
            len(t) != new_tokens or any(x < 0 or x >= eng.cfg.vocab_size for x in t) for t in toks.values()
        ):
            raise AssertionError(f"{label}burst at lookahead {r['lookahead']}: bad streams {toks}")
    return runs


def _burst_prompts(cfg, seed: int) -> tuple[list, list]:
    rng = np.random.default_rng(seed)
    plens = [5, 16, 17, 63, 64, 65, 200, 440]
    return plens, [rng.integers(1, cfg.vocab_size, n).tolist() for n in plens]


def phase_engine(dev: dict, seed: int, cfg: TransformerConfig, params: dict) -> tuple[dict, LLMEngine]:
    """The engine phase; returns its readings and the engine, still open,
    for the overload phase (which closes it)."""
    from gofr_tpu_torch.metrics import Manager

    # defaults: 32 slots, 512, {16, 64}, 256, K=8, B=16, lookahead 3, graphs;
    # the goodput ledger, the flight recorder and the anomaly detectors on,
    # writing a metrics manager as under the runtime
    eng = LLMEngine(cfg, params, seed=seed, metrics=Manager())
    try:
        warm = _warm_report("", eng)
        _check_families("", eng, seed)
        # warm-up request: allocator pools and the collector, outside the timed runs
        eng.generate([1, 2, 3], max_new_tokens=4)
        plens, prompts = _burst_prompts(cfg, seed)
        new_tokens = 32
        runs = _bursts("", eng, prompts, new_tokens, ("flash_attention", "paged_decode_partials"))
        stats = eng.stats()
        # device ms of the chunk and the widest step (the lora phase's
        # engine runs the same programs with the adapter deltas)
        step = eng._step_name(eng.chunk_shapes[-1], eng.admit_cap)
        prog = {name: program_ms(eng, name, seed) for name in ("llm.decode_chunk8", step)}
        print("program device ms (one replay): " + ", ".join(f"{k} {v:.3f}" for k, v in prog.items()))
        # the same traffic once more under torch.profiler: where the device
        # time goes (the profiler slows the host, so this pass is not timed),
        # and the goodput ledger's busy time over the same burst
        busy0 = eng.goodput.snapshot()["attributed_s"]
        prof = _profile(lambda: (_serve(eng, prompts, new_tokens), _quiet(eng)))
        prof["ledger_busy_ms"] = (eng.goodput.snapshot()["attributed_s"] - busy0) * 1e3
    except BaseException:
        eng.close()
        raise

    # every served token of every burst against greedy decoding by the
    # plain full-prompt forward. The first token comes from prefill (flash
    # kernel), the rest from the decode chunks (paged kernel, partials
    # merge, chunk-end scatter through the tables).
    checked = exempt = 0
    for i, r in enumerate(runs):
        c, e = _replay_gate(params, cfg, prompts, r["results"], TOKEN_GAP,
                            label=f"burst {i + 1} (lookahead {r['lookahead']}) ", verbose=i == 0)
        print(f"burst {i + 1} (lookahead {r['lookahead']}): {c} tokens equal the plain greedy argmax, {e} exempt")
        checked, exempt = checked + c, exempt + e

    # logit drift between the served path (64-token chunks through the
    # flash kernel) and the plain forward, on one prompt
    p = prompts[6]
    drift = _chunked_drift(params, cfg, p, eng.kv.capacity)
    print(f"logit drift, served chunked path vs plain forward (prompt {len(p)}): max_abs {drift:.4f}")
    if not math.isfinite(drift) or drift >= TOKEN_GAP:
        raise AssertionError(f"served-path logits drift {drift} >= {TOKEN_GAP}")

    launches = runs[0]["launches"]
    for r in runs:
        for name, n in r["launches"].items():
            if n <= 0:
                raise AssertionError(f"{name} was not launched in a burst at lookahead {r['lookahead']}")
    first = runs[0]
    out = {
        "requests": len(first["results"]), "tokens": first["tokens"], "wall_s": first["wall_s"],
        "tok_s": statistics.median(r["tok_s"] for r in runs[:3]),
        "ttft_p50_s": statistics.median(r["ttft_p50_s"] for r in runs[:3]),
        "ttft_max_s": statistics.median(r["ttft_max_s"] for r in runs[:3]),
        "launches": launches, "steps": stats["steps"], "tokens_matched": checked, "tokens_exempt": exempt,
        "warmup": warm, "profile": prof, "program_ms": prog,
        "runs": [{k: v for k, v in r.items() if k not in ("results", "reqs")} for r in runs],
    }
    print(
        f"engine gemma_2b on {dev['smi']}: {out['requests']} requests x 32 tokens, 3 bursts at lookahead 3: "
        f"median {out['tok_s']:.1f} tok/s; ttft p50 {out['ttft_p50_s']:.3f}s max {out['ttft_max_s']:.3f}s "
        f"(medians); lookahead 1: {runs[3]['tok_s']:.1f} tok/s; idle {100 * prof['idle']:.1f}% of a profiled "
        f"burst (until no program is in flight); launches in burst 1 {launches}"
    )
    return out, eng


OBSERVE_LAYERS = 6  # --only observe: Gemma-2B's first 6 of 18 layers, full width
OBSERVE_TENANTS = ("acme", "globex")  # the conservation burst's clients, alternating


def _metric_lines(text: str, name: str) -> dict:
    """{label string: value} of one series in a Prometheus exposition."""
    out = {}
    for line in text.splitlines():
        m = re.match(rf"^{name}(\{{.*\}})? (\S+)$", line)  # a label value may hold braces: /ask/{{svc}}
        if m:
            out[m.group(1) or ""] = float(m.group(2))
    return out


def _bundle(path: str | None, label: str) -> dict:
    """A bundle directory's manifest and flight records; fails unless the
    path exists and the manifest, written last, is there."""
    if path is None or not os.path.isdir(path):
        raise AssertionError(f"{label}no bundle directory ({path!r})")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "flight_records.json")) as f:
        records = json.load(f)
    return {"manifest": manifest, "records": records, "files": sorted(os.listdir(path))}


def _watch_incidents(eng) -> list:
    """Record every bundle ``eng`` dumps from now on: its trigger, path,
    seconds (the whole capture, and the dump's writes alone) and whether a
    fetch was still in flight when the capture returned."""
    seen: list = []
    incident, dump = eng._incident, eng.blackbox.dump
    writes: list = []

    def timed_dump(*a, **kw):
        t0 = time.perf_counter()
        try:
            return dump(*a, **kw)
        finally:
            writes.append(time.perf_counter() - t0)

    def timed_incident(trigger, **kw):
        t0 = time.perf_counter()
        path = incident(trigger, **kw)
        seen.append({"trigger": trigger, "path": path, "s": time.perf_counter() - t0,
                     "dump_s": writes[-1] if writes else 0.0,
                     "fetch_in_flight": eng._hb_fetch.stalled()[0] is not None})
        return path

    eng._incident = timed_incident
    eng.blackbox.dump = timed_dump
    return seen


def _quiet(*engines) -> None:
    """Wait until no program is in flight on ``engines``: a chunk fetched
    after its lanes' streams ended still bills them its padding."""
    _wait_until(lambda: all(not e._inflight and e._processing is None for e in engines), 120,
                "no program in flight")


def _gp_delta(g0: dict, g1: dict) -> dict:
    return {k: g1[k] - g0[k] for k in ("wall_s", "attributed_s", "idle_s")}


def _chip_sum(reqs) -> float:
    return sum(sum(r._chip.values()) for r in reqs)


def phase_observe(dev: dict, seed: int, cfg: TransformerConfig, params: dict, eng=None, main=None) -> dict:
    """Chip-time accounting and the flight recorder on the engine phase's
    engine (or, alone, an engine of OBSERVE_LAYERS at full width): see the
    module docstring. Returns its readings and launches."""
    own = eng is None
    if own:
        from gofr_tpu_torch.metrics import Manager

        cfg, params = _first_layers(cfg, params, OBSERVE_LAYERS)
        eng = LLMEngine(cfg, params, seed=seed, metrics=Manager())
        _warm_report("observe ", eng)
        eng.generate([1, 2, 3], max_new_tokens=4)
    try:
        return _observe(dev, seed, cfg, params, eng, main)
    finally:
        if own:
            eng.close()


def _observe(dev: dict, seed: int, cfg, params, eng, main) -> dict:
    from gofr_tpu_torch.app import new as new_app
    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.handler import llm_request_kwargs
    from gofr_tpu_torch.resilience import default_injector
    from gofr_tpu_torch.resilience.rollout import ModelHandle

    if not eng.blackbox.enabled() or eng.goodput is None or eng.anomaly is None or eng.metrics is None:
        raise AssertionError("observe: the engine's ledger, recorder, detectors and metrics must all be on")
    _zero_launches(KERNEL_COUNTERS)
    plens, prompts = _burst_prompts(cfg, seed)
    new_tokens = 32
    clients = [OBSERVE_TENANTS[i % 2] for i in range(len(prompts))]
    out: dict = {}
    laps: dict = {}
    t_lap = [time.perf_counter()]

    def lap(name):  # the phase's seconds by step
        t = time.perf_counter()
        laps[name] = round(t - t_lap[0], 2)
        t_lap[0] = t

    # 1. conservation on the burst, with the collector's accounting time
    # (the ledger's seams and the finish path) measured
    cost = {"observe": [0.0, 0], "finish": [0.0, 0]}
    seams = {"observe": eng._gp_observe, "finish": eng._observe_finish}

    def timed(key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return seams[key](*a, **kw)
            finally:
                cost[key][0] += time.perf_counter() - t0
                cost[key][1] += 1
        return call

    g0, u0 = eng.goodput.snapshot(), eng.usage.snapshot()["tenants"]
    eng._gp_observe, eng._observe_finish = timed("observe"), timed("finish")
    try:
        results, reqs, wall = _serve(eng, prompts, new_tokens, clients=clients)
        _quiet(eng)
    finally:
        del eng._gp_observe, eng._observe_finish
    g1, u1 = eng.goodput.snapshot(), eng.usage.snapshot()["tenants"]
    d = _gp_delta(g0, g1)
    ident = abs(g1["attributed_s"] + g1["idle_s"] - g1["wall_s"])
    if ident > 0.01 * g1["wall_s"] or abs(d["attributed_s"] + d["idle_s"] - d["wall_s"]) > 0.01 * d["wall_s"]:
        raise AssertionError(f"observe: attributed + idle != wall: lifetime {g1}, burst {d}")
    if d["attributed_s"] > 1.01 * wall:  # (its idle includes the gap since the traffic before)
        raise AssertionError(f"observe: the ledger's busy {d['attributed_s']:.4f}s is longer than the burst {wall:.4f}s")
    tenants_total = sum(sum(t["cum_chip_s"].values()) for t in u1.values())
    if abs(tenants_total - g1["attributed_s"]) > 0.01 * g1["attributed_s"]:
        raise AssertionError(f"observe: tenants' chip {tenants_total} != attributed {g1['attributed_s']}")
    per_tenant = {}
    for t in OBSERVE_TENANTS:
        billed = sum(u1[t]["cum_chip_s"].values()) - sum(u0.get(t, {}).get("cum_chip_s", {}).values())
        got = _chip_sum(r for i, r in reqs.items() if clients[i] == t)
        if abs(got - billed) > 1e-5 + 1e-3 * billed:
            raise AssertionError(f"observe: {t}'s requests hold {got} chip-s, the meter billed {billed}")
        per_tenant[t] = billed
    c, e = _replay_gate(params, cfg, prompts, results, TOKEN_GAP, label="observe ", verbose=False)
    total = sum(len(t) for t in results.values())
    print(f"observe conservation on {dev['smi']}: burst {total / wall:.1f} tok/s in {wall:.4f}s; ledger over the "
          f"burst wall {d['wall_s']:.4f}s = attributed {d['attributed_s']:.4f} + idle {d['idle_s']:.4f} (the idle "
          f"from the traffic before on); busy {100 * d['attributed_s'] / wall:.1f}% of the burst's clock; lifetime "
          f"|attributed + idle - wall| "
          f"{ident:.2e}s of {g1['wall_s']:.3f}s; tenants' chip {tenants_total:.6f} = attributed "
          f"{g1['attributed_s']:.6f}; per tenant {per_tenant} = their requests' _chip; by class "
          f"{ {k: round(v - g0['by_class'][k], 6) for k, v in g1['by_class'].items()} }; goodput ratio "
          f"{g1['goodput_ratio']}; gate {c} matched, {e} exempt")
    print(f"observe collector cost: goodput seams {cost['observe'][1]} calls {1e3 * cost['observe'][0]:.3f} ms "
          f"({1e6 * cost['observe'][0] / max(1, cost['observe'][1]):.1f} us each), finish path {cost['finish'][1]} "
          f"calls {1e3 * cost['finish'][0]:.3f} ms, together {100 * (cost['observe'][0] + cost['finish'][0]) / wall:.3f}% "
          f"of the burst's wall")
    out.update(conservation=d, burst_wall_s=wall, tenants=per_tenant, cost_ms={k: 1e3 * v[0] for k, v in cost.items()})
    lap("conservation")
    if main is not None:
        runs = main["runs"]
        print(f"observe main path with the ledger, the recorder and the detectors on ({dev['smi']}): "
              f"{main['tok_s']:.1f} tok/s median at lookahead 3 (bursts {[round(r['tok_s'], 1) for r in runs[:3]]}), "
              f"{runs[3]['tok_s']:.1f} at lookahead 1, ttft p50 {main['ttft_p50_s']:.3f}s")

    # 2. the ledger's busy time beside the profiler's device-busy time, over
    # the engine phase's profiled burst (or one of this phase's own)
    prof = main["profile"] if main is not None else None
    if prof is None:
        busy0 = eng.goodput.snapshot()["attributed_s"]
        prof = _profile(lambda: (_serve(eng, prompts, new_tokens), _quiet(eng)), label="observe ")
        prof["ledger_busy_ms"] = (eng.goodput.snapshot()["attributed_s"] - busy0) * 1e3
    out["ledger_vs_profiler"] = prof["ledger_busy_ms"] / max(prof["busy_ms"], 1e-9)
    print(f"observe ledger vs profiler{' (the engine phase profiled burst)' if main is not None else ''}: ledger busy "
          f"{prof['ledger_busy_ms']:.1f} ms (host dispatch->fetch windows), profiler device busy {prof['busy_ms']:.1f} "
          f"ms of {prof['wall_ms']:.1f} ms: the ledger reads {out['ledger_vs_profiler']:.2f}x the device time")
    lap("profiler")

    # 3. a probe is billed to probe alone, and meters no tokens
    r = eng.submit(GenRequest(prompts[0], max_new_tokens=8, probe=True, client="probe-check"))
    r.tokens(timeout=600)
    if set(r._chip) != {"probe"} or r._chip["probe"] <= 0 or eng.usage.window("probe-check")[1] != 0:
        raise AssertionError(f"observe: probe billed {r._chip}, metered {eng.usage.window('probe-check')}")
    print(f"observe probe: {r._chip['probe'] * 1e3:.3f} ms chip, all probe; 0 tokens metered")
    lap("probe")

    # 4. the quota: a quarter of acme's metered rate sheds its next submit
    app = new_app(new_mock_config({"HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "600", "LOG_LEVEL": "WARN"}))
    rt = app.container.tpu()
    rt._llms["gemma"] = ModelHandle("gemma", eng)

    def generate(ctx):
        body = ctx.bind()
        return {"tokens": ctx.tpu().llm("gemma").generate(
            list(body["tokens"]), max_new_tokens=int(body.get("max_new_tokens", 16)), **llm_request_kwargs(ctx))}

    app.post("/generate", generate)
    thread = app.run_in_background()
    port = app.http_server.port
    try:
        rate = eng.usage.tok_rate("acme")
        quota = rate / 4
        eng.set_tenant_quota("acme", quota)
        p0 = eng.quota.check("acme")
        try:
            eng.submit(GenRequest(prompts[1], max_new_tokens=8, client="acme"))
            raise AssertionError("observe: acme's submit was admitted past its quota")
        except TL.EngineOverloaded as ex:
            shed = ex.retry_after
        p1 = eng.quota.check("acme")
        if p0 is None or p1 is None or not min(p0, p1) - 1e-9 <= shed <= max(p0, p1) + 1e-9:
            raise AssertionError(f"observe: shed with retry_after {shed}, the gate prices {p0} .. {p1}")
        probe = eng.submit(GenRequest(prompts[1], max_new_tokens=8, client="acme", probe=True)).tokens(timeout=600)
        p2 = eng.quota.check("acme")
        status, raw, _, _, hdrs = _http(port, "POST", "/generate", {"tokens": prompts[1], "max_new_tokens": 8},
                                        headers={"X-GoFr-Client": "acme"})
        p3 = eng.quota.check("acme")
        retry_hdr = hdrs.get("Retry-After")
        if status != 429 or retry_hdr is None or int(retry_hdr) not in {max(1, math.ceil(p)) for p in (p2, p3)}:
            raise AssertionError(f"observe: HTTP over quota {status} Retry-After {retry_hdr}: {raw[:200]!r}")
        eng.set_tenant_quota("acme", None)
        status, raw, _, _, _ = _http(port, "POST", "/generate", {"tokens": prompts[1], "max_new_tokens": 8},
                                      headers={"X-GoFr-Client": "acme"})
        if status != 201 or len(json.loads(raw)["data"]["tokens"]) != 8:
            raise AssertionError(f"observe: acme after clearing its quota: {status} {raw[:200]!r}")
        status, raw, _, _, _ = _http(port, "GET", "/.well-known/debug/usage")
        usage = json.loads(raw)["data"]["models"]["gemma"] if status == 200 else None
        if usage is None or "acme" not in usage["tenants"] or usage["window_s"] is None or usage["quota_sheds"] < 2:
            raise AssertionError(f"observe: GET /.well-known/debug/usage {status} {raw[:300]!r}")
        print(f"observe quota: acme metered {rate:.1f} tok/s, quota {quota:.1f}: submit shed with retry_after "
              f"{shed:.3f}s (the gate's price {p0:.3f}..{p1:.3f}); a probe from acme admitted ({len(probe)} tokens); "
              f"over HTTP 429 with Retry-After {retry_hdr}; cleared: 201; debug/usage acme {usage['tenants']['acme']}, "
              f"window {usage['window_s']} s, sheds {usage['quota_sheds']}")
        out["quota"] = {"rate": rate, "quota": quota, "retry_after": shed, "retry_header": int(retry_hdr)}
        lap("quota")

        # 5. flight records and replay: every burst record final with its
        # stream; each replay token-identical or leaving at a near-tie
        match, replays = 0, {}
        for i, r in reqs.items():
            rec = eng.flightrec.get(r.id)
            if rec is None or not rec["final"] or rec["emitted_token_ids"] != results[i] or not rec["chip_ms"]:
                raise AssertionError(f"observe: request {i}'s record {rec and {k: rec[k] for k in ('final', 'finish_reason')}}")
            rp = eng.replay(r.id, timeout=600)
            if "error" in rp or rp["replayed_len"] != len(results[i]):
                raise AssertionError(f"observe: replay of request {i}: {rp}")
            replays[i] = rp["replayed_token_ids"]
            match += rp["match"]
        differ = _divergence_at_near_ties(params, cfg, prompts, replays, results, TOKEN_GAP, "observe replay ")
        status, raw, _, _, _ = _http(port, "POST", "/.well-known/debug/replay", {"id": reqs[0].id, "model": "gemma"})
        rp = json.loads(raw)["data"]["replay"] if status == 201 else None
        if rp is None or rp["replayed_len"] != len(results[0]):
            raise AssertionError(f"observe: POST /.well-known/debug/replay {status} {raw[:300]!r}")
        if not rp["match"]:
            _divergence_at_near_ties(params, cfg, prompts[:1], {0: rp["replayed_token_ids"]}, {0: results[0]},
                                     TOKEN_GAP, "observe http replay ")
        print(f"observe replay: {match} of {len(reqs)} replays token-identical, {differ} leave the recorded stream "
              f"at a near-tie; POST /.well-known/debug/replay from loopback: match {rp['match']} "
              f"({rp['replay_ms']} ms)")
        out["replays"] = {"match": match, "differ": differ, "http_match": rp["match"]}
        lap("replay")
    finally:
        rt._llms.pop("gemma", None)  # the app's shutdown must not close the engine
        eng.set_tenant_quota("acme", None)
        app.shutdown()
        thread.join(timeout=60)

    # 6. a bundle under load, beside an unbundled burst
    res0, _r, w0 = _serve(eng, prompts, new_tokens)
    box: dict = {}
    th = threading.Thread(target=lambda: box.update(run=_serve(eng, prompts, new_tokens)))
    th.start()
    _wait_until(lambda: any(r is not None and r.emitted > 0 for r in list(eng._slot_req)), 120,
                "observe: a burst's first tokens")
    t0 = time.perf_counter()
    path = eng._incident("manual_check", reason="chip_smoke: a bundle under load")
    dump_ms = (time.perf_counter() - t0) * 1e3
    th.join(timeout=900)
    res1, _r, w1 = box["run"]
    b = _bundle(path, "observe ")
    with open(os.path.join(path, "hbm.json")) as f:
        hbm = json.load(f)
    weights = _tensor_bytes(eng.params)
    inflight = [rec for rec in b["records"] if not rec["final"]]
    need = {"manifest.json", "debug_state.json", "hbm.json", "config.json", "wide_events.json", "flight_records.json"}
    if not need <= set(b["files"]) or not inflight or not hbm[0]["bytes_in_use"] or hbm[0]["bytes_in_use"] <= weights:
        raise AssertionError(f"observe: bundle {b['files']}, {len(inflight)} in-flight records, hbm {hbm}")
    tok0, tok1 = sum(map(len, res0.values())) / w0, sum(map(len, res1.values())) / w1
    print(f"observe bundle under load: {path} ({', '.join(b['files'])}) in {dump_ms:.1f} ms; {len(inflight)} "
          f"in-flight and {len(b['records']) - len(inflight)} final records; hbm in use {hbm[0]['bytes_in_use']} "
          f"bytes (weights {weights}), peak {hbm[0]['peak_bytes_in_use']}, limit {hbm[0]['bytes_limit']}; burst "
          f"{tok1:.1f} tok/s with the bundle beside {tok0:.1f} without")
    out["bundle"] = {"ms": dump_ms, "tok_s": tok1, "tok_s_unbundled": tok0, "inflight": len(inflight)}
    lap("bundle")

    # 7. an anomaly: step walls held past factor x the baseline for more
    # than the sustain count flag it, one bundle lands, normal steps clear it
    an = eng.anomaly
    for _ in range(12):  # the baseline (an engine of this phase's own has few steps yet)
        if an.snapshot()["step"]["baseline_samples"] >= an.min_samples:
            break
        _serve(eng, prompts, new_tokens)
    snap = an.snapshot()["step"]
    if snap["baseline_samples"] < an.min_samples or snap["flagged"]:
        raise AssertionError(f"observe: no clean step baseline: {snap}")
    delay = max(0.05, (an.factor + 0.5) * snap["baseline_mean"] / 1e3)
    watch = _watch_incidents(eng)
    inj = default_injector()
    box = {}
    th = threading.Thread(target=lambda: box.update(run=_serve(eng, prompts, new_tokens)))
    inj.arm("step_latency", count=-1, label=eng.label, delay=delay)
    try:
        th.start()
        _wait_for(lambda: "step" in an.flagged() or not th.is_alive(), 600)
        flagged = "step" in an.flagged()
    finally:
        inj.disarm("step_latency")
        th.join(timeout=900)
    del eng._incident, eng.blackbox.dump
    text = eng.metrics.render_prometheus()
    gauge = _metric_lines(text, "app_llm_anomaly")
    step_on = [v for k, v in gauge.items() if 'signal="step"' in k]
    bundles = [_bundle(w["path"], "observe anomaly ")["manifest"] for w in watch
               if w["trigger"] == "anomaly" and w["path"] is not None]
    steps = [m for m in bundles if m["reason"].startswith("step sustained deviant")]
    if not flagged or step_on != [1.0] or len(steps) != 1:
        raise AssertionError(f"observe anomaly: flagged {an.flagged()}, gauge {gauge}, bundles {watch}")
    for _ in range(3):  # normal steps clear the flag
        _serve(eng, prompts, new_tokens)
        if "step" not in an.flagged():
            break
    gauge = _metric_lines(eng.metrics.render_prometheus(), "app_llm_anomaly")
    if "step" in an.flagged() or [v for k, v in gauge.items() if 'signal="step"' in k] != [0.0]:
        raise AssertionError(f"observe anomaly: not cleared: {an.flagged()} {gauge}")
    print(f"observe anomaly: step baseline {snap['baseline_mean']:.2f} ms over {snap['baseline_samples']} steps; "
          f"every fetch held {delay * 1e3:.0f} ms: flagged (factor {an.factor}, sustain {an.sustain}), "
          f"app_llm_anomaly{{signal=\"step\"}} 1; bundles {[(w['trigger'], round(w['s'] * 1e3, 1)) for w in watch]}; "
          f"the step's: {steps[0]['reason']!r}; cleared after normal steps (gauge 0)")
    out["anomaly"] = {"delay_ms": delay * 1e3, "baseline_ms": snap["baseline_mean"],
                      "bundles": [w["trigger"] for w in watch]}
    lap("anomaly")

    # 8. the exposition
    text = eng.metrics.render_prometheus()
    for name in ("app_llm_goodput_seconds_total", "app_llm_goodput_ratio", "app_llm_quota_sheds_total",
                 "app_blackbox_bundles_total"):
        if not any(v > 0 for v in _metric_lines(text, name).values()):
            raise AssertionError(f"observe: {name} has no non-zero series")
    print("observe exposition: " + "; ".join(
        f"{k}{lab} {v:g}" for k in ("app_llm_goodput_ratio", "app_llm_quota_sheds_total", "app_blackbox_bundles_total")
        for lab, v in _metric_lines(text, k).items()))
    lap("exposition")

    # 9-15. device observability: spans, SLO, MFU, the capture registry,
    # HBM telemetry, profile capture and the cost of observing
    out["device"] = _observe_device(dev, seed, cfg, params, eng, prompts, new_tokens, lap)
    out["launches"] = _launches(KERNEL_COUNTERS)
    if any(out["launches"][name] <= 0 for name in ("flash_attention", "paged_decode_partials")):
        raise AssertionError(f"observe launches {out['launches']}")
    print(f"observe launches over the phase: {out['launches']}; seconds by step {laps}")
    return out


OBSERVE_PROFILE_NEW = 128  # the profiled burst's answers: it outlasts the 2 s capture window


_FAMILY_SIGS = (  # a family's name -> its (kind, width) as the registry records them
    (r"llm\.step_p(\d+)_d\d+g?\.w(\d+)", "step"),
    (r"llm\.prefill_b(\d+)\.w(\d+)", "prefill"),
    (r"llm\.decode_chunk(\d+)g?", "chunk"),
    (r"llm\.hit_first\.w(\d+)", "hit"),
    (r"llm\.step_v(\d+)g?", "verify"),
    (r"llm\.kv_seed", "seed"),
)


def _family_sig(name: str) -> tuple[str, str] | None:
    """The registry's arg_shapes for family ``name``, read off the name."""
    for pattern, kind in _FAMILY_SIGS:
        hit = re.fullmatch(pattern, name)
        if hit:
            nums = tuple(int(g) for g in hit.groups())
            return kind, str(nums if len(nums) > 1 else nums[0] if nums else None)
    return None


def _span_check(ring, reqs, label: str) -> int:
    """Every request's trace holds one llm.request span whose children lie
    inside it (1 ms of clock anchoring slack); returns the spans."""
    n = 0
    for i, r in reqs.items():
        spans = ring.query(r.span.trace_id)
        roots = [s for s in spans if s["name"] == "llm.request"]
        kids = [s for s in spans if s["parent_id"] == r.span.span_id]
        if len(roots) != 1 or not kids or {"llm.queue_wait", "llm.prefill", "llm.decode"} - {s["name"] for s in kids}:
            raise AssertionError(f"{label}request {i}: spans {[(s['name'], s['parent_id']) for s in spans]}")
        root = roots[0]
        for s in kids:
            if not root["start_ns"] - 1_000_000 <= s["start_ns"] <= s["end_ns"] <= root["end_ns"] + 1_000_000:
                raise AssertionError(f"{label}request {i}: {s['name']} outside llm.request")
        n += len(spans)
    return n


def _observe_device(dev: dict, seed: int, cfg, params, eng, prompts, new_tokens: int, lap) -> dict:
    """Device observability on the observe phase's engine: a tracer, an SLO
    tracker and the HBM sampler attached to it as the runtime attaches
    them; see the module docstring."""
    from gofr_tpu_torch.app import new as new_app
    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.datasource.gpu.telemetry import GPUTelemetry
    from gofr_tpu_torch.handler import llm_request_kwargs
    from gofr_tpu_torch.metrics.slo import SLOPolicy, SLOTracker
    from gofr_tpu_torch.profiling import default_registry
    from gofr_tpu_torch.resilience.rollout import ModelHandle

    out: dict = {}
    m = eng.metrics
    app = new_app(new_mock_config({"HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "600", "LOG_LEVEL": "WARN",
                                   "TRACE_RING_SPANS": "262144"}))
    tracer = app.tracer

    def slo(ttft_ms):
        t = SLOTracker(SLOPolicy(ttft_ms=ttft_ms), m, eng.label)
        t.on_fast_burn = lambda: eng._incident("slo_fast_burn", reason=f"error-budget fast burn tripped on {eng.label}")
        return t

    def ttft_count():
        return sum(v for k, v in _metric_lines(m.render_prometheus(), "app_llm_ttft_seconds_count").items())

    # the main burst with tracing and the SLO on; the MFU windows read this
    # phase's bursts only (the anomaly step above held every fetch)
    for w in (*eng._mfu_windows.values(), *eng._roofline_windows.values(), eng._tok_chip_window):
        w.clear()
    eng.tracer, eng.slo = tracer, slo(60_000.0)
    telemetry = GPUTelemetry(m, [eng.device], interval_s=10.0)
    n0 = ttft_count()
    results, reqs, wall = _serve(eng, prompts, new_tokens)
    _quiet(eng)
    nspans = _span_check(tracer.ring, reqs, "observe trace ")
    dn = ttft_count() - n0
    snap = eng.slo.snapshot()
    if dn != len(prompts) or snap["total"] != len(prompts) or snap["fast_burn"] or snap["good"] != len(prompts):
        raise AssertionError(f"observe trace: ttft count +{dn}, slo {snap}")
    c, e = _replay_gate(params, cfg, prompts, results, TOKEN_GAP, label="observe traced ", verbose=False)
    print(f"observe trace on {dev['smi']}: {len(reqs)} requests, one llm.request each with queue_wait/prefill/"
          f"decode/emit children inside it ({nspans} spans); app_llm_ttft_seconds count +{dn}; SLO ttft 60 s: "
          f"{snap['good']}/{snap['total']} good, burn {snap['burn_rates']}, fast burn {snap['fast_burn']}; "
          f"burst {sum(map(len, results.values())) / wall:.1f} tok/s; gate {c} matched, {e} exempt")
    lap("trace")

    # 1 ms TTFT: every request violates, the fast burn trips once, one bundle
    watch = _watch_incidents(eng)
    eng.slo = slo(1.0)
    for _ in range(2):  # 16 judged requests: past the 10 the short window needs
        _serve(eng, prompts, new_tokens)
    _quiet(eng)
    del eng._incident, eng.blackbox.dump
    snap = eng.slo.snapshot()
    burns = [w for w in watch if w["trigger"] == "slo_fast_burn"]
    if not snap["fast_burn"] or snap["good"] != 0 or len(burns) != 1 or burns[0]["path"] is None:
        raise AssertionError(f"observe slo 1 ms: {snap}, incidents {watch}")
    b = _bundle(burns[0]["path"], "observe slo ")
    fast = _metric_lines(m.render_prometheus(), "app_llm_slo_fast_burn")
    if b["manifest"]["trigger"] != "slo_fast_burn" or fast.get(f'{{model="{eng.label}"}}') != 1.0:
        raise AssertionError(f"observe slo: bundle {b['manifest']}, gauge {fast}")
    eng.slo.zero_gauges()
    eng.slo = slo(60_000.0)
    print(f"observe slo: ttft target 1 ms: {snap['total']} judged, {snap['good']} good, burn {snap['burn_rates']}, "
          f"fast burn tripped once: one slo_fast_burn bundle ({', '.join(b['files'])}, "
          f"{burns[0]['s'] * 1e3:.1f} ms); target 60 s: {eng.slo.snapshot()['fast_burn']}")
    out["slo"] = {"burn": snap["burn_rates"], "bundles": len(burns)}
    lap("slo")

    # MFU and the roofline, per phase, over everything this engine served
    mfu = eng.stats()["mfu"]
    pre, dec = mfu["prefill"], mfu["decode"]
    rpre, rdec = mfu["roofline"]["prefill"], mfu["roofline"]["decode"]
    if not (0 < pre["p50"] <= 1 and 0 < dec["p50"] <= 1 and 0 < rdec["p50"] < 1 and dec["max"] <= 1):
        raise AssertionError(f"observe mfu: {mfu}")
    print(f"observe mfu on {dev['smi']} (peaks {mfu['peak_flops_per_chip'] / 1e12:g} TFLOP/s bf16, "
          f"{mfu['hbm_bw_per_chip'] / 1e12:g} TB/s): prefill p50 {pre['p50']:.4f} max {pre['max']:.4f} "
          f"({pre['count']} steps), decode p50 {dec['p50']:.4f} max {dec['max']:.4f} ({dec['count']} programs); "
          f"roofline ratio prefill p50 {rpre['p50']:.3f}, decode p50 {rdec['p50']:.4f} ({mfu['roofline']['bound']}-"
          f"bound); tokens/s/chip p50 {mfu['tokens_per_second_per_chip']['p50']:.1f}")
    out["mfu"] = {"prefill_p50": pre["p50"], "decode_p50": dec["p50"], "roofline_prefill_p50": rpre["p50"],
                  "roofline_decode_p50": rdec["p50"]}
    lap("mfu")

    # the capture registry: one row per captured family, seconds within warmup
    rows = default_registry().snapshot(model=eng.label)
    progs = {p["program"]: p for p in rows["programs"]}
    cap_s = sum(p["compile_s"] for p in progs.values() if p["measured"] == "capture")
    warm = rows["warmup"].get(eng.label, {})
    if set(progs) != set(eng.families) or warm.get("programs") != len(eng.families) or cap_s > eng.warmup_s:
        raise AssertionError(f"observe compiles: {sorted(progs)} vs families {sorted(eng.families)}, warmup {warm}, "
                             f"capture {cap_s} > warmup_s {eng.warmup_s}")
    bad = [p for p in progs.values()
           if p["compiles"] != 1 or p["measured"] != "capture" or p["backend"] != "cuda"
           or tuple(p["arg_shapes"]) != _family_sig(p["program"])]
    if bad:
        raise AssertionError(f"observe compiles: rows unlike their families: {bad}")
    # the registry's hits over one burst against the graphs' own replays,
    # counted on each CUDAGraph by a wrapper outside the engine
    hits0 = {p: e["hits"] for p, e in progs.items()}
    replays: dict = {}

    def counted(name, replay):
        def run(*a, **k):
            replays[name] = replays.get(name, 0) + 1
            return replay(*a, **k)
        return run

    for name, fam in eng.families.items():
        fam.graph.replay = counted(name, fam.graph.replay)
    try:
        _serve(eng, prompts, new_tokens)
        _quiet(eng)
    finally:
        for fam in eng.families.values():
            del fam.graph.replay  # the class's method again
    hits = {p["program"]: p["hits"] - hits0[p["program"]]
            for p in default_registry().snapshot(model=eng.label)["programs"]}
    hits = {k: v for k, v in hits.items() if v}
    if not replays or hits != replays:
        raise AssertionError(f"observe compiles: registry hits over a burst {hits} != graph replays {replays}")
    slowest = sorted(progs.values(), key=lambda p: -p["compile_s"])[:3]
    print(f"observe compiles: {len(progs)} captured families (= the engine's {len(eng.families)} graphs), one "
          f"capture each, arg_shapes = each family's (kind, width); capture seconds sum {cap_s:.3f} <= warmup_s "
          f"{eng.warmup_s:.3f}; over one burst the registry's hits equal the graphs' own replays "
          f"({sum(replays.values())} in {len(replays)} families); slowest "
          f"{[(p['program'], round(p['compile_s'], 3)) for p in slowest]}")
    out["compiles"] = {"families": len(progs), "capture_s": cap_s, "warmup_s": eng.warmup_s,
                       "by_family": {k: round(p["compile_s"], 4) for k, p in progs.items()}}
    lap("compiles")

    # HBM telemetry: one sweep against the allocator and the CUDA runtime, now
    torch.cuda.synchronize()
    telemetry.sample_once()
    reserved, (free, total) = torch.cuda.memory_reserved(eng.device), torch.cuda.mem_get_info(eng.device)
    # the gauges' own values (the exposition prints 6 significant digits)
    hbm = {labels["kind"]: v for _n, labels, v in m._instruments["app_tpu_hbm_bytes"].collect()}
    in_use, limit = hbm.get("in_use"), hbm.get("limit")
    if in_use != reserved or limit != total:
        raise AssertionError(f"observe hbm: gauges {hbm}, memory_reserved {reserved}, mem_get_info {free, total}")
    util = next(v for _n, _l, v in m._instruments["app_tpu_hbm_utilization"].collect())
    print(f"observe hbm on {dev['smi']}: app_tpu_hbm_bytes in_use {int(in_use)} = memory_reserved, limit "
          f"{int(limit)} = mem_get_info total (free {free}); utilization {util:.4f}")
    out["hbm"] = {"in_use": in_use, "limit": limit, "utilization": util}
    telemetry.close()
    lap("hbm")

    # over HTTP: a traceparent's round trip, the trace and compiles routes,
    # and a 2 s profile capture while a long burst is live
    rt = app.container.tpu()
    rt._llms["gemma"] = ModelHandle("gemma", eng)

    def generate(ctx):
        body = ctx.bind()
        return {"tokens": ctx.tpu().llm("gemma").generate(
            list(body["tokens"]), max_new_tokens=int(body.get("max_new_tokens", 16)), **llm_request_kwargs(ctx))}

    app.post("/generate", generate)
    thread = app.run_in_background()
    port = app.http_server.port
    try:
        tid, sid = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
        status, raw, _, _, hdrs = _http(port, "POST", "/generate", {"tokens": prompts[0], "max_new_tokens": 8},
                                        headers={"traceparent": f"00-{tid}-{sid}-01"})
        spans = {s["span_id"]: s for s in tracer.ring.query(tid)}
        req_span = next((s for s in spans.values() if s["name"] == "llm.request"), None)
        http_span = spans.get(req_span["parent_id"]) if req_span else None
        if status != 201 or hdrs.get("X-Correlation-ID") != tid or http_span is None or http_span["parent_id"] != sid:
            raise AssertionError(f"observe traceparent: {status} {hdrs} {list(spans.values())}")
        status, raw, _, _, _ = _http(port, "GET", f"/.well-known/debug/traces?trace_id={tid}")
        tree = json.loads(raw)["data"] if status == 200 else {}
        names = sorted(s["name"] for s in tree.get("spans", []))
        if tree.get("span_count") != len(spans) or "llm.request" not in names or "POST /generate" not in names:
            raise AssertionError(f"observe debug/traces: {status} {raw[:300]!r}")
        status, raw, _, _, _ = _http(port, "GET", "/.well-known/debug/compiles")
        listed = [p for p in json.loads(raw)["data"]["programs"] if p["model"] == eng.label] if status == 200 else []
        if {p["program"] for p in listed} != set(eng.families):
            raise AssertionError(f"observe debug/compiles: {status} {sorted(p['program'] for p in listed)}")
        status, raw, _, _, _ = _http(port, "GET", "/.well-known/debug/engine?serving=1")
        serving = json.loads(raw)["data"]["serving"] if status == 200 else None
        if serving is None or "gemma" not in serving["models"]:
            raise AssertionError(f"observe debug/engine?serving=1: {status} {raw[:300]!r}")
        print(f"observe traceparent: POST /generate under {tid}/{sid}: llm.request's parent is the HTTP span "
              f"'{http_span['name']}', whose parent is the caller's span; X-Correlation-ID returned; GET "
              f"debug/traces?trace_id= {tree['span_count']} spans ({', '.join(names)}); GET debug/compiles lists "
              f"the {len(listed)} families; debug/engine?serving=1 {serving['models']['gemma']}")
        lap("http")

        # the same long burst without, then with, a capture in its middle
        base, _r, wb = _serve(eng, prompts, OBSERVE_PROFILE_NEW)
        box: dict = {}
        th = threading.Thread(target=lambda: box.update(run=_serve(eng, prompts, OBSERVE_PROFILE_NEW)))
        th.start()
        _wait_until(lambda: any(r is not None and r.emitted > 0 for r in list(eng._slot_req)), 120,
                    "observe: the profiled burst's first tokens")
        t0 = time.perf_counter()
        status, raw, _, _, _ = _http(port, "POST", "/.well-known/debug/profile?seconds=2&download=0")
        route_s = time.perf_counter() - t0
        th.join(timeout=900)
        got, _r, wp = box["run"]
        res = json.loads(raw)["data"] if status == 201 else None
        if res is None or res["mode"] != "torch" or "trace.json" not in res["files"]:
            raise AssertionError(f"observe profile: {status} {raw[:400]!r}")
        with open(os.path.join(res["dir"], "trace.json")) as f:
            kernels = {ev.get("name", "") for ev in json.load(f).get("traceEvents", []) if ev.get("cat") == "kernel"}
        with open(os.path.join(res["dir"], "stages.json")) as f:
            stages = json.load(f)
        flash = sorted(k for k in kernels if "flash_" in k and "_kernel" in k)
        paged = sorted(k for k in kernels if "paged_decode_kernel" in k)
        if not paged or not flash:
            raise AssertionError(
                f"observe profile: the trace names {len(kernels)} kernels, flash {flash}, paged {paged}")
        differ = _divergence_at_near_ties(params, cfg, prompts, got, base, TOKEN_GAP, "observe profiled ")
        same = sum(got[i] == base[i] for i in base)
        print(f"observe profile: POST debug/profile?seconds=2 during a live {len(prompts)} x {OBSERVE_PROFILE_NEW} "
              f"burst returned in {route_s:.2f} s (route budget {max(60.0, app.request_timeout):.0f} s; window {res['seconds']} s, stages {stages}); "
              f"{len(kernels)} kernel names in trace.json, flash {flash[:2]}, paged {paged[:2]}; streams: {same} of "
              f"{len(base)} identical to the uncaptured burst, {differ} leave it at a near-tie; burst "
              f"{sum(map(len, got.values())) / wp:.1f} tok/s with the capture, {sum(map(len, base.values())) / wb:.1f} "
              f"without")
        out["profile"] = {"route_s": route_s, "window_s": res["seconds"], "stages": stages, "kernels": len(kernels),
                          "same": same, "near_tie": differ}
        lap("profile")
    finally:
        rt._llms.pop("gemma", None)  # the app's shutdown must not close the engine
        app.shutdown()
        thread.join(timeout=60)

    # the cost of observing: the main burst at lookahead 3, alternately with
    # the tracer, the SLO tracker and an HBM sampler (the runtime's default
    # 10 s interval: a sweep as it starts) on, and with all three off; the
    # app's own sampler stopped with its runtime above
    sampler = getattr(rt.telemetry, "_thread", None)
    if sampler is not None and sampler.is_alive():
        raise AssertionError("observe cost: the app runtime's HBM sampler still runs")
    rates: dict = {"on": [], "off": []}
    for mode in ("on", "off") * 3:
        sampler = None
        if mode == "on":
            eng.tracer, eng.slo = tracer, slo(60_000.0)
            sampler = GPUTelemetry(m, [eng.device], interval_s=10.0)
        else:
            eng.tracer = eng.slo = None
        try:
            res_b, _r, w = _serve(eng, prompts, new_tokens)
            _quiet(eng)
        finally:
            if sampler is not None:
                sampler.close()
        rates[mode].append(sum(map(len, res_b.values())) / w)
    eng.tracer = eng.slo = None
    on, off = statistics.median(rates["on"]), statistics.median(rates["off"])
    print(f"observe cost on {dev['smi']}: main burst at lookahead 3 with tracer + SLO + HBM sampler on "
          f"{[round(x, 1) for x in rates['on']]} tok/s (median {on:.1f}), off {[round(x, 1) for x in rates['off']]} "
          f"(median {off:.1f}): {100 * (off - on) / off:+.2f}% of the off median")
    out["cost"] = {"on": rates["on"], "off": rates["off"]}
    lap("cost")
    return out


OVERLOAD_BATCH_NEW = 256  # a batch job's answers: long enough that no slot is near its end (virtually free) at the arrivals
OVERLOAD_INTER = (24, 48, 96, 160)  # interactive prompts arriving under full batch occupancy
OVERLOAD_INTER_NEW = 32
FLOOD_HEAVY, FLOOD_LIGHT, FLOOD_NEW = 96, 8, 32


def _consume(reqs) -> callable:
    """One consumer thread per request; returns join(), which gives
    ({i: tokens}, {i: perf_counter when the stream ended})."""
    toks: dict[int, list[int]] = {}
    ends: dict[int, float] = {}
    errors: list[BaseException] = []

    def read(i, r):
        try:
            toks[i] = r.tokens(timeout=600)
            ends[i] = time.perf_counter()
        except BaseException as e:  # surfaced by join()
            errors.append(e)

    threads = [threading.Thread(target=read, args=(i, r)) for i, r in enumerate(reqs)]
    for th in threads:
        th.start()

    def join():
        for th in threads:
            th.join(timeout=600)
        if errors:
            raise errors[0]
        if any(th.is_alive() for th in threads):
            raise TimeoutError("overload consumers did not finish")
        return toks, ends

    return join


def _wait_until(pred, seconds: float, what: str, every: float = 0.005):
    """``_wait_for`` that raises, naming ``what``, when ``pred()`` stayed false."""
    got = _wait_for(pred, seconds, every)
    if not got:
        raise TimeoutError(f"timed out waiting for {what}")
    return got


def _overload_preempt_run(eng, label: str, batch_prompts, inter_prompts) -> dict:
    """A batch job (priority batch, client "batch-job") holding every slot,
    with a backlog, then 4 interactive requests arriving once each request
    of the first wave has 8 tokens out (or has ended): their TTFT, the
    preemptions, the batch job's wall time."""
    p0 = eng.preemptions
    t0 = time.perf_counter()
    batch = [eng.submit(GenRequest(p, max_new_tokens=OVERLOAD_BATCH_NEW, priority="batch", client="batch-job"))
             for p in batch_prompts]
    join_b = _consume(batch)
    wave = batch[: eng.slots]
    _wait_until(lambda: all(r.emitted >= 8 or r.finish_reason is not None for r in wave), 300,
                "the batch job's first wave to stream 8 tokens")
    inter = [eng.submit(GenRequest(p, max_new_tokens=OVERLOAD_INTER_NEW, client="web")) for p in inter_prompts]
    itoks, _ = _consume(inter)()
    btoks, bends = join_b()
    for i, r in enumerate(batch):
        if r.finish_reason != "length" or len(btoks[i]) != r.max_new_tokens:
            raise AssertionError(f"{label}batch request {i}: {r.finish_reason}, {len(btoks[i])} tokens")
    if any(len(t) != OVERLOAD_INTER_NEW for t in itoks.values()):
        raise AssertionError(f"{label}interactive streams {itoks}")
    ttfts = sorted(r.first_token_at - r.submitted_at for r in inter)
    run = {
        "preemptions": eng.preemptions - p0, "preempted": [i for i, r in enumerate(batch) if r.preempted],
        "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1], "ttfts": ttfts,
        "batch_wall_s": max(bends.values()) - t0, "batch": btoks, "inter": itoks,
    }
    print(f"{label}preemption {'on' if eng.preemption else 'off'}: {len(batch)} batch requests x "
          f"{OVERLOAD_BATCH_NEW} new tokens, 4 interactive x {OVERLOAD_INTER_NEW} arriving at full batch occupancy: "
          f"interactive ttft p50 {run['ttft_p50_s']:.4f}s max {run['ttft_max_s']:.4f}s; preemptions "
          f"{run['preemptions']} (requests {run['preempted']}); batch job wall {run['batch_wall_s']:.3f}s")
    return run


def _overload_flood(eng, label: str, heavy_prompts, light_prompts) -> dict:
    """A heavy client's flood (FLOOD_HEAVY requests); once its first wave
    decodes, a light client's FLOOD_LIGHT requests. Light TTFT and
    finishing positions; each request's predicted wait at submit beside
    its measured queue wait (admitted_at - submitted_at)."""
    preds, reqs = [], []
    for p in heavy_prompts:
        preds.append(eng.predicted_wait_s())
        reqs.append(eng.submit(GenRequest(p, max_new_tokens=FLOOD_NEW, client="heavy")))
    join_h = _consume(reqs)
    _wait_until(lambda: sum(r.emitted > 0 for r in reqs) >= eng.slots, 300, "the heavy flood's first wave")
    light = []
    for p in light_prompts:
        preds.append(eng.predicted_wait_s())
        light.append(eng.submit(GenRequest(p, max_new_tokens=FLOOD_NEW, client="light")))
    ltoks, lends = _consume(light)()
    htoks, hends = join_h()
    if any(len(t) != FLOOD_NEW for t in [*htoks.values(), *ltoks.values()]):
        raise AssertionError(f"{label}flood streams of the wrong length")
    allr = reqs + light
    ends = [hends[i] for i in range(len(reqs))] + [lends[i] for i in range(len(light))]
    order = sorted(range(len(allr)), key=lambda i: ends[i])
    positions = sorted(order.index(len(reqs) + j) + 1 for j in range(len(light)))
    ttfts = sorted(r.first_token_at - r.submitted_at for r in light)
    waits = [r.admitted_at - r.submitted_at for r in allr]
    ratios = sorted(p / w for p, w in zip(preds, waits) if p is not None and w >= 1e-3)
    run = {"light_ttft_p50_s": ttfts[len(ttfts) // 2], "light_ttft_max_s": ttfts[-1],
           "light_positions": positions, "waits": waits, "preds": preds, "ratios": ratios,
           "light": ltoks, "light_prompts": light_prompts}
    print(f"{label}ledger {'on' if eng.ledger is not None else 'off'}: {len(reqs)} heavy + {len(light)} light "
          f"requests x {FLOOD_NEW} new tokens: light ttft p50 {run['light_ttft_p50_s']:.4f}s max "
          f"{run['light_ttft_max_s']:.4f}s; light finishing positions {positions} of {len(allr)}; "
          f"measured queue wait median {statistics.median(waits):.4f}s max {max(waits):.4f}s")
    return run


def phase_overload(dev: dict, seed: int, cfg: TransformerConfig, params: dict, eng) -> dict:
    """Overload control on the engine phase's bf16 engine (its defaults: 32
    slots, lookahead 3, graphs at warmup; preemption and the ledger toggled
    at runtime, no second warmup). Preemption on, then off: a batch job
    holding every slot and 4 interactive arrivals (interactive TTFT, the
    preemptions, the batch wall; every token of the preempted and the
    interactive streams through the replay gate). Fair share with the
    ledger, then without: a heavy flood and a light client. The predicted
    wait at each submit over the measured queue wait. Then a max_queue
    reject and a predicted-wait shed, each with a finite Retry-After, the
    requests they accepted served. No family is captured in the phase;
    nothing is held once idle."""
    # every kernel is counted, though the bf16 engine runs neither the int8
    # kernel nor flash's full-prompt mode: their overload_launches are then
    # 0s this phase measured
    path = ("flash_attention", "paged_decode_partials")
    names = KERNEL_COUNTERS
    fams, captures = sorted(eng.families), eng.g_captures
    ledger = eng.ledger
    rng = np.random.default_rng(seed + 11)
    _plens, burst = _burst_prompts(cfg, seed)
    # longest first: the long prompts' prefill runs while short ones would
    # otherwise have ended; a backlog of one more set keeps every slot busy
    batch_prompts = sorted(burst * 5, key=len, reverse=True)
    inter_prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in OVERLOAD_INTER]
    heavy = [rng.integers(1, cfg.vocab_size, int(n)).tolist() for n in rng.integers(16, 65, FLOOD_HEAVY)]
    light = [rng.integers(1, cfg.vocab_size, int(n)).tolist() for n in rng.integers(16, 65, FLOOD_LIGHT)]
    _zero_launches(names)
    try:
        runs = {}
        for on in (True, False):
            eng.preemption = on
            runs[on] = _overload_preempt_run(eng, "overload ", batch_prompts, inter_prompts)
            _idle(eng, "overload ")
        if runs[True]["preemptions"] < 1 or runs[False]["preemptions"] != 0:
            raise AssertionError(f"overload: preemptions {runs[True]['preemptions']} with preemption on, "
                                 f"{runs[False]['preemptions']} off")
        floods = {}
        for led in (ledger, None):
            eng.ledger = led
            floods[led is not None] = _overload_flood(eng, "overload ", heavy, light)
            _idle(eng, "overload ")
        eng.ledger = ledger
        ratios = floods[True]["ratios"] + floods[False]["ratios"]
        n_pred = sum(p is not None for f in floods.values() for p in f["preds"])
        preds = [p for f in floods.values() for p in f["preds"] if p is not None]
        waits = [w for f in floods.values() for w in f["waits"]]
        print(f"overload predicted wait at submit over measured queue wait, {len(ratios)} flood requests that "
              f"waited >= 1 ms ({n_pred} with a prediction): median {statistics.median(ratios):.3f}, "
              f"min {min(ratios):.3f}, max {max(ratios):.3f}; predicted median {statistics.median(preds):.4f}s, "
              f"measured median {statistics.median(waits):.4f}s; throughput EMA {eng.throughput_tok_s():.1f} tok/s")
        # the queue-full reject: the 9th request while 8 wait
        eng.max_queue = 8
        eng._drain_submits = lambda: None  # they stay queued until the reject
        accepted = []
        try:
            for p in light + heavy[:1]:
                accepted.append(eng.submit(GenRequest(p, max_new_tokens=8, client="q")))
            raise AssertionError("overload: max_queue=8 accepted a 9th waiting request")
        except TL.EngineOverloaded as e:
            full = (len(accepted), e.retry_after)
        finally:
            del eng._drain_submits
            eng.max_queue = None
            eng._kick.set()
        # the predicted-wait shed, from an idle engine, below the flood's
        # measured wait
        for r in accepted:
            if len(r.tokens(timeout=600)) != r.max_new_tokens:
                raise AssertionError("overload: a request max_queue accepted was not served whole")
        _idle(eng, "overload ")
        threshold = max(0.05, 0.5 * statistics.median(floods[True]["waits"]))
        eng.overload.shed_wait_s = threshold
        shed, accepted = None, []
        try:
            for p in heavy:
                try:
                    accepted.append(eng.submit(GenRequest(p, max_new_tokens=FLOOD_NEW, client="heavy")))
                except TL.EngineOverloaded as e:
                    shed = (len(accepted), e.retry_after, eng.predicted_wait_s())
                    break
        finally:
            eng.overload.shed_wait_s = 0.0
        for r in accepted:
            if len(r.tokens(timeout=600)) != r.max_new_tokens:
                raise AssertionError("overload: a request the predicted-wait gate accepted was not served whole")
        if shed is None:
            raise AssertionError(f"overload: no predicted-wait shed at {threshold:.3f}s over {len(heavy)} submits")
        for what, ra in (("max_queue", full[1]), ("predicted wait", shed[1])):
            if ra is None or not math.isfinite(ra) or ra <= 0:
                raise AssertionError(f"overload: the {what} reject carries retry_after {ra}")
        print(f"overload shed: max_queue=8 refused the {full[0] + 1}th waiting request, retry_after {full[1]:.3f}s; "
              f"shed_predicted_wait_s={threshold:.4f} refused after {shed[0]} accepted submits, predicted wait "
              f"{shed[2]:.3f}s, retry_after {shed[1]:.3f}s; the accepted requests served; stats "
              f"rejected {eng.rejected}, sheds_predicted {eng.sheds_predicted}")
        _idle(eng, "overload ")
        launches = _launches(names)
    finally:
        eng.preemption, eng.ledger, eng.max_queue, eng.overload.shed_wait_s = True, ledger, None, 0.0
    if sorted(eng.families) != fams or eng.g_captures != captures:
        raise AssertionError(f"overload: families captured in the phase: {sorted(set(eng.families) - set(fams))}")
    if any(launches[n] <= 0 for n in path):
        raise AssertionError(f"overload: a kernel was not launched in the phase: {launches}")
    # every token of the preempted batch streams and of the interactive and
    # light requests against the plain forward
    on = runs[True]
    pre = on["preempted"]
    checked = exempt = 0
    for label, prompts, toks in (
        ("overload preempted ", [batch_prompts[i] for i in pre], {k: on["batch"][i] for k, i in enumerate(pre)}),
        ("overload interactive ", inter_prompts, on["inter"]),
        ("overload light ", light, floods[True]["light"]),
    ):
        c, e = _replay_gate(params, cfg, prompts, toks, TOKEN_GAP, label=label, verbose=False)
        checked, exempt = checked + c, exempt + e
    off = runs[False]
    out = {
        "preempt_on": {k: on[k] for k in ("preemptions", "ttft_p50_s", "ttft_max_s", "batch_wall_s")},
        "preempt_off": {k: off[k] for k in ("preemptions", "ttft_p50_s", "ttft_max_s", "batch_wall_s")},
        "light_on": {k: floods[True][k] for k in ("light_ttft_p50_s", "light_ttft_max_s", "light_positions")},
        "light_off": {k: floods[False][k] for k in ("light_ttft_p50_s", "light_ttft_max_s", "light_positions")},
        "pred_over_measured": (statistics.median(ratios), min(ratios), max(ratios)),
        "launches": launches, "tokens_matched": checked, "tokens_exempt": exempt,
    }
    print(f"overload gemma_2b on {dev['smi']}: interactive ttft p50/max preemption on {on['ttft_p50_s']:.4f}/"
          f"{on['ttft_max_s']:.4f}s ({on['preemptions']} preemptions), off {off['ttft_p50_s']:.4f}/"
          f"{off['ttft_max_s']:.4f}s; batch wall on {on['batch_wall_s']:.3f}s off {off['batch_wall_s']:.3f}s; "
          f"light ttft p50/max ledger on {floods[True]['light_ttft_p50_s']:.4f}/{floods[True]['light_ttft_max_s']:.4f}s "
          f"positions {floods[True]['light_positions']}, off {floods[False]['light_ttft_p50_s']:.4f}/"
          f"{floods[False]['light_ttft_max_s']:.4f}s positions {floods[False]['light_positions']}; predicted/measured "
          f"wait median {out['pred_over_measured'][0]:.3f}; {checked} tokens matched, {exempt} exempt; "
          f"launches in the phase {launches}")
    return out


def _tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, QTensor):
        return _tensor_bytes(tree.q) + _tensor_bytes(tree.s)
    return tree.numel() * tree.element_size()


def _int8_path_drift(cfg, qparams, prompt, capacity, block, steps=8):
    """Logit drift of the int8 serving path against the plain forward on
    the same int8 weights: the prompt is prefilled in 64-token chunks
    through an int8 pool of ``block``-row blocks (each chunk's view gathered and dequantized, its
    rows quantized again at the scatter, as the engine's unified step
    does), then ``steps`` greedy decode steps run through the int8 kernel.
    Returns the largest |served - plain| logit over the prefill's last
    position and every decode step."""
    L, MB = cfg.n_layers, capacity // block
    shape = (L, MB, block, cfg.n_kv_heads, cfg.head_dim)
    pool = KVCache(
        k=torch.zeros(shape, dtype=torch.int8, device="cuda"),
        v=torch.zeros(shape, dtype=torch.int8, device="cuda"),
        length=torch.zeros(1, dtype=torch.int32, device="cuda"),
    )
    scales = torch.zeros((2,) + shape[:-1], dtype=torch.float32, device="cuda")
    tables = torch.arange(MB, dtype=torch.int32, device="cuda")[None]
    cur = 0
    for c0 in range(0, len(prompt), 64):
        chunk = prompt[c0 : c0 + 64]
        toks = torch.zeros((1, 64), dtype=torch.long, device="cuda")
        toks[0, : len(chunk)] = torch.tensor(chunk, device="cuda")
        cursors = torch.tensor([cur], dtype=torch.int32, device="cuda")
        view = gather_slots(pool.k, pool.v, tables, cursors, scales=(scales[0], scales[1]), dtype=cfg.dtype)
        logits_c, view = prefill_append(
            qparams, cfg, toks, view, cursors, torch.tensor([len(chunk)], dtype=torch.int32, device="cuda")
        )
        pos = torch.arange(cur, cur + len(chunk), device="cuda")[None]
        scatter_rows(
            pool.k, pool.v, tables, view.k[:, :, cur : cur + len(chunk)], view.v[:, :, cur : cur + len(chunk)],
            pos, torch.ones_like(pos, dtype=torch.bool), scales=scales,
        )
        cur += len(chunk)
    pool.length.fill_(cur)
    served = [logits_c[0]]

    def capture(logits, temps, gen):
        served.append(logits[0].clone())
        return logits.argmax(dim=-1).to(torch.int32)

    first = logits_c.argmax(dim=-1).to(torch.int32)
    toks, _last, _ = decode_chunk_paged(
        qparams, cfg, first, pool, tables, torch.ones(1, dtype=torch.bool, device="cuda"),
        torch.zeros(1, device="cuda"), None, n_steps=steps, sample_fn=capture, block=block, scales=scales,
    )
    seq = prompt + [int(first[0])] + toks[:-1, 0].tolist()
    plain = transformer_forward(
        qparams, cfg, torch.tensor([seq], device="cuda"), torch.arange(len(seq), device="cuda")[None, :]
    )[0, len(prompt) - 1 :]
    return max(float((s - p).abs().max()) for s, p in zip(served, plain))


def phase_engine_int8(dev: dict, seed: int, cfg: TransformerConfig, params: dict) -> dict:
    """The engine bursts with int8 weights (the bf16 phase's, quantized at
    construction) and an int8 KV pool, at CUT_LAYERS of Gemma-2B's 18
    layers."""
    cfg, params = _first_layers(cfg, params, CUT_LAYERS)
    bf16_bytes = _tensor_bytes(params)
    eng = LLMEngine(cfg, params, seed=seed, kv_int8=True, quantize=True)
    qparams = eng.params
    weight_bytes = _tensor_bytes(qparams)
    pool_bytes = _tensor_bytes({"k": eng.pool.k, "v": eng.pool.v, "scales": eng.pool_scales})
    print(f"int8 engine: weights {weight_bytes} bytes (bf16 {bf16_bytes}); KV pool {pool_bytes} bytes "
          f"(int8 rows + f32 scales, {eng.kv.pool.n_blocks} blocks of {eng.kv.block_bytes} bytes)")
    counters = KERNEL_COUNTERS
    try:
        warm = _warm_report("int8 ", eng)
        _check_families("int8 ", eng, seed)
        eng.generate([1, 2, 3], max_new_tokens=4)  # warm-up, outside the timed runs
        plens, prompts = _burst_prompts(cfg, seed)
        new_tokens = 32
        runs = _bursts("int8 ", eng, prompts, new_tokens, counters)
        stats = eng.stats()
        prof = _profile(lambda: _serve(eng, prompts, new_tokens), label="int8 ")
    finally:
        eng.close()
    for r in runs:
        launches = r["launches"]
        print(f"int8 burst at lookahead {r['lookahead']}: launches {launches} over {r['chunks']} programs "
              f"({launches['paged_decode_partials_int8'] / max(r['chunks'], 1):.1f} int8 launches per program; "
              f"{cfg.n_layers * 8} per 8-step chunk)")
        if launches["paged_decode_partials_int8"] <= 0 or launches["paged_decode_partials_int8"] % cfg.n_layers:
            raise AssertionError(f"int8 kernel launches {launches['paged_decode_partials_int8']}: not whole decode steps")
        if launches["paged_decode_partials"] or launches["flash_attention"] <= 0:
            raise AssertionError(f"int8 engine launched the wrong kernels: {launches}")
    if not stats["quantized"] or not stats["kvcache"]["int8"]:
        raise AssertionError(f"int8 engine stats: {stats}")

    drift = _int8_path_drift(cfg, qparams, prompts[6], eng.kv.capacity, eng.kv.block)
    print(f"int8 logit drift, served int8 path (int8 KV round trip between chunks, int8 kernel decode, "
          f"weight-only decode products) vs plain forward on the int8 weights (prompt {len(prompts[6])}, "
          f"prefill + 8 decode steps): max_abs {drift:.4f} on {dev['smi']}; gap constant {INT8_TOKEN_GAP}")
    if not math.isfinite(drift) or 2 * drift > INT8_TOKEN_GAP:
        raise AssertionError(f"int8 path logit drift {drift}: INT8_TOKEN_GAP {INT8_TOKEN_GAP} is under twice it")

    # every served token of every burst against the plain forward on the
    # same int8 weights, teacher-forced on the served stream
    checked = exempt = 0
    for i, r in enumerate(runs):
        c, e = _replay_gate(qparams, cfg, prompts, r["results"], INT8_TOKEN_GAP,
                            label=f"int8 burst {i + 1} (lookahead {r['lookahead']}) ", verbose=i == 0)
        print(f"int8 burst {i + 1} (lookahead {r['lookahead']}): {c} tokens equal the plain greedy argmax, "
              f"{e} exempt")
        if 8 * e > r["tokens"]:
            raise AssertionError(f"int8 engine: {e} of {r['tokens']} tokens needed the gap exemption (> 1 in 8)")
        checked, exempt = checked + c, exempt + e

    # eager weight-only products dequantize the int8 weight per call: its
    # cost at the decode shape (32 rows), on the widest layer weight and
    # the unembed, against the same product on a bf16 copy made once
    x = torch.randn((32, cfg.d_model), device="cuda").to(cfg.dtype)
    wg = qparams["layers"]["w_gate"]
    w = QTensor(wg.q[0], wg.s[0])
    w_bf16 = w.q.to(cfg.dtype) * w.s
    emb = qparams["embed"]
    emb_bf16 = emb.q.to(cfg.dtype) * emb.s
    x3 = x[:, None]
    cost = {
        "qmm_w_gate_ms": time_ms(lambda: qmm(x, w)),
        "bf16_w_gate_ms": time_ms(lambda: x @ w_bf16),
        "unembed_int8_ms": time_ms(lambda: T._unembed(qparams, cfg, x3)),
        "unembed_bf16_ms": time_ms(lambda: T._unembed({"embed": emb_bf16}, cfg, x3)),
    }
    print(f"qmm cost at 32 rows: w_gate {list(w.q.shape)} int8 {cost['qmm_w_gate_ms']:.4f} ms vs a "
          f"{str(cfg.dtype)[6:]} copy {cost['bf16_w_gate_ms']:.4f} ms; unembed {list(emb.q.shape)} int8 "
          f"{cost['unembed_int8_ms']:.4f} ms vs a {str(cfg.dtype)[6:]} copy {cost['unembed_bf16_ms']:.4f} ms")

    first = runs[0]
    out = {
        "requests": len(first["results"]), "tokens": first["tokens"], "wall_s": first["wall_s"],
        "tok_s": statistics.median(r["tok_s"] for r in runs[:3]),
        "ttft_p50_s": statistics.median(r["ttft_p50_s"] for r in runs[:3]),
        "ttft_max_s": statistics.median(r["ttft_max_s"] for r in runs[:3]),
        "launches": first["launches"], "tokens_matched": checked, "tokens_exempt": exempt, "drift": drift,
        "weight_bytes": weight_bytes, "pool_bytes": pool_bytes, "warmup": warm, "profile": prof, **cost,
    }
    print(
        f"int8 engine gemma_2b (kv_int8, quantize) on {dev['smi']}: 3 bursts at lookahead 3: median "
        f"{out['tok_s']:.1f} tok/s; ttft p50 {out['ttft_p50_s']:.3f}s max {out['ttft_max_s']:.3f}s (medians); "
        f"lookahead 1: {runs[3]['tok_s']:.1f} tok/s; idle {100 * prof['idle']:.1f}%; {checked} tokens matched, "
        f"{exempt} exempt; launches in burst 1 {first['launches']}"
    )
    return out


# The lora phase: a pool of 4 adapters of rank up to 8 over the engine's
# defaults. The random tied Gemma-2B predicts with top-2 gaps of 4.6-9
# logits: adapters at scale 0.5 moved no greedy token off the base's, and
# at 1.25-2.0 (each delta up to ~4x a base projection's output) the served
# path's logits drifted 0.37-1.43 from the plain forward's, past the
# gate's 0.25; at 1.0, 0.17-0.20 (on an H100; PERF.md). The phase
# checks that the adapters on all six targets move tokens (a gate that
# adapted and base streams pass alike would not tell them apart); the
# attention-only one moved none at 1.0 and drifted past the gate at 1.5,
# so its count is printed, not required
LORA_SLOTS, LORA_RANK, LORA_SCALE = 4, 8, 1.0
LORA_LANES = ("", "A", "B", "C") * 2  # the burst's lanes: base / A / B / C
LORA_HOT_A_NEW = 192  # new tokens of A's lanes in the hot-load burst


def _adapter_params(params: dict, cfg, adapter: dict, rank: int = LORA_RANK) -> dict:
    """``params`` plus LoRA tables of one gid (1) holding ``adapter``: the
    plain forward with aids [1] adds exactly its delta (the gate's
    reference, independent of the engine's tables)."""
    tabs = zero_tables(cfg, 1, rank, "cuda")
    for name, (a, b) in validate_adapter(cfg, adapter, rank_max=rank).items():
        tabs[f"lora_{name}_a"][:, 1, :, : a.shape[2]] = torch.from_numpy(a).cuda()
        tabs[f"lora_{name}_b"][:, 1, : a.shape[2], :] = torch.from_numpy(b).cuda()
    return {**params, "layers": {**params["layers"], **tabs}}


def _lora_delta_gather(h, lp, name, aids):
    """The JAX form of the delta (gofr_tpu/models/transformer.py:296-313):
    each row's (A, B) pair gathered into [rows, d_in, r] and [rows, r,
    d_out] float32 copies, then two batched products."""
    ag = lp["lora_" + name + "_a"][aids.long()]
    bg = lp["lora_" + name + "_b"][aids.long()]
    return torch.bmm(torch.bmm(h.float(), ag), bg)


def _delta_forms(eng, cfg, seed: int) -> dict:
    """The device time of every layer's six deltas (one decode step of 32
    rows; one prefill chunk of 8 x 64 rows) in the served form (the G
    tables side by side, each read once) and in the JAX form (per-row
    gathered copies, batched products), on the engine's tables with mixed
    ids, and the bytes each moves."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    layers = [T._layer(eng.params, i) for i in range(cfg.n_layers)]
    dims = target_dims(cfg)
    G, r, L = eng.lora_slots + 1, eng.lora_rank, cfg.n_layers
    io = sum(d_in + d_out for d_in, d_out in dims.values())
    out = {}
    for label, rows, s in (("decode step", 32, 1), ("prefill chunk", 8, 64)):
        aids = torch.randint(0, G, (rows,), generator=g, device="cuda")
        sel = T.lora_select(eng.params, aids)
        hs = {n: torch.randn((rows, s, d), generator=g, device="cuda").to(cfg.dtype) for n, (d, _) in dims.items()}
        err = max(float((T._lora_delta(hs[n], layers[0], n, sel) - _lora_delta_gather(hs[n], layers[0], n, aids))
                        .abs().max()) for n in dims)
        served = device_ms(lambda: [T._lora_delta(hs[n], lp, n, sel) for lp in layers for n in dims], None, iters=5)
        jax_form = device_ms(lambda: [_lora_delta_gather(hs[n], lp, n, aids) for lp in layers for n in dims], None,
                             iters=5)
        # table bytes read once; the JAX form writes and reads a copy of each
        # row's pair besides
        served_bytes = L * G * io * r * 4
        jax_bytes = L * rows * io * r * 4 * 3
        out[label] = {"served_ms": served, "jax_form_ms": jax_form, "max_abs_err": err,
                      "served_bytes": served_bytes, "jax_form_bytes": jax_bytes}
        print(f"lora delta form, {label} ({rows} x {s} rows, {L} layers x {len(dims)} targets, G {G}, rank {r}): "
              f"served (the G tables side by side) {served:.4f} ms device, {served_bytes} table bytes; JAX form "
              f"(per-row gathered copies) {jax_form:.4f} ms device, ~{jax_bytes} bytes; the two agree to "
              f"{err:.2e}")
        if not math.isfinite(err) or err > 1e-3:
            raise AssertionError(f"lora delta forms disagree: {err}")
    return out


def _lora_idle(eng, label: str) -> None:
    """Idle (``_idle``: every block in use held by the radix) with no
    adapter reference held and no zombie gid."""
    _idle(eng, label)
    snap = eng.adapters()
    if any(e["refs"] for e in snap["resident"].values()) or snap["zombies"]:
        raise AssertionError(f"{label}adapter references held once idle: {snap}")


def _lora_gate(label: str, params, cfg, prompts, results: dict, lanes, ads: dict, gap: float) -> tuple[int, int]:
    """Every served token of ``results`` through the replay gate: base lanes
    against the plain forward without an adapter, each adapted lane against
    the plain forward with its adapter's delta (``ads[name]``)."""
    checked = exempt = 0
    for name in sorted(set(lanes)):
        idx = [i for i in results if lanes[i] == name]
        ref = params if not name else _adapter_params(params, cfg, ads[name])
        c, e = _replay_gate(ref, cfg, [prompts[i] for i in idx], {j: results[i] for j, i in enumerate(idx)}, gap,
                            label=f"{label}lane {name or 'base'} ", verbose=False, aid=1 if name else None)
        checked, exempt = checked + c, exempt + e
        del ref
    return checked, exempt


def _lora_hot_load(eng, prompts, ads: dict) -> dict:
    """The burst again (64 new tokens, A's lanes LORA_HOT_A_NEW), and while A's lanes are in flight
    (each has its first token out): a new version of A ("A@v2") loaded into the full
    pool, which evicts the idle adapter F, and published over the busy
    name A. A's requests in flight keep their old gid (a zombie until they
    drain); two requests submitted after the publish get the new one.
    Nothing is captured and memory_reserved does not move."""
    torch.cuda.synchronize()
    fam0, res0 = dict(eng.families), torch.cuda.memory_reserved()
    # A's lanes decode LORA_HOT_A_NEW tokens, so they are still in flight
    # after the load: with 64, a lane whose first token came last could
    # finish while the load waited for the engine lock (~330 ms)
    reqs = [eng.submit(GenRequest(p, max_new_tokens=LORA_HOT_A_NEW if a == "A" else 64, adapter=a))
            for p, a in zip(prompts, LORA_LANES)]
    join = _consume(reqs)
    a_lanes = [i for i, a in enumerate(LORA_LANES) if a == "A"]
    _wait_until(lambda: all(reqs[i].emitted for i in a_lanes), 120, "A's first tokens")
    old = eng.adapters()["resident"]["A"]["gid"]
    t0 = time.perf_counter()
    gid = eng.load_adapter("A@v2", ads["A2"], version="v2")
    t1 = time.perf_counter()
    prev = eng.publish_adapter("A@v2", "A")
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - t0) * 1e3
    snap = eng.adapters()
    held = [reqs[i]._aid for i in a_lanes]  # a retired request's goes back to 0
    late = [eng.submit(GenRequest(prompts[i], max_new_tokens=32, adapter="A")) for i in (0, 5)]
    late_aids = [r._aid for r in late]
    in_flight = sum(reqs[i].finish_reason is None for i in a_lanes)
    toks, _ends = join()
    late_toks = [r.tokens(timeout=600) for r in late]
    torch.cuda.synchronize()
    print(f"lora hot-load mid-burst: A@v2 loaded ({(t1 - t0) * 1e3:.1f} ms) and published "
          f"({(t2 - t1) * 1e3:.1f} ms), {swap_ms:.1f} ms to the copies' end, while {in_flight} of "
          f"{len(a_lanes)} A requests were in flight; gid {old} -> {gid}; zombies {snap['zombies']}; evictions "
          f"{snap['evictions']} (resident {sorted(snap['resident'])}); families {len(fam0)} -> {len(eng.families)}; "
          f"memory_reserved {res0} -> {torch.cuda.memory_reserved()}")
    if prev != old or snap["zombies"] != [old] or "F" in snap["resident"] or snap["evictions"] != 1:
        raise AssertionError(f"lora hot-load: old gid {old}, publish returned {prev}, pool {snap}")
    if any(a not in (old, 0) for a in held) or old not in held or any(a != gid for a in late_aids):
        raise AssertionError("lora hot-load: a request in flight moved to the new gid, or a late one did not")
    if eng.families != fam0 or torch.cuda.memory_reserved() != res0:
        raise AssertionError("lora hot-load captured a program or reserved memory")
    return {"results": toks, "late": late_toks, "swap_ms": swap_ms, "in_flight": in_flight, "old_gid": old,
            "new_gid": gid}


def _lora_int8(dev: dict, seed: int, cfg, params: dict, adapter: dict) -> dict:
    """kv_int8=True, quantize=True with the pool: 4 requests of 16 new
    tokens, two under adapter A, every token through the int8 gate (the
    plain forward on the same int8 weights, with A's delta on its lanes)."""
    counters = KERNEL_COUNTERS
    eng = LLMEngine(cfg, params, seed=seed, kv_int8=True, quantize=True, lora_slots=LORA_SLOTS, lora_rank=LORA_RANK)
    try:
        _warm_report("lora int8 ", eng)
        eng.load_adapter("A", adapter)
        eng.generate([1, 2, 3], max_new_tokens=4)
        _plens, prompts = _burst_prompts(cfg, seed)
        prompts, lanes = prompts[:4], ("", "A", "", "A")
        _zero_launches(counters)
        results, _reqs, wall = _serve(eng, prompts, 16, lanes)
        launches = _launches(counters)
        _lora_idle(eng, "lora int8 ")
        qparams = {**eng.params, "layers": {k: v for k, v in eng.params["layers"].items() if not k.startswith("lora_")}}
    finally:
        eng.close()
    checked, exempt = _lora_gate("lora int8 ", qparams, cfg, prompts, results, lanes, {"A": adapter}, INT8_TOKEN_GAP)
    total = sum(len(t) for t in results.values())
    print(f"lora int8 (kv_int8, quantize, adapter A on 2 of 4 lanes) on {dev['smi']}: {total} tokens in "
          f"{wall:.3f}s = {total / wall:.1f} tok/s; {checked} tokens equal the plain greedy argmax, {exempt} exempt "
          f"(gap {INT8_TOKEN_GAP}); launches {launches}")
    if 8 * exempt > total:
        raise AssertionError(f"lora int8: {exempt} of {total} tokens needed the gap exemption (> 1 in 8)")
    if launches["paged_decode_partials_int8"] <= 0 or launches["paged_decode_partials"] or \
            launches["flash_attention"] <= 0:
        raise AssertionError(f"lora int8 engine launched the wrong kernels: {launches}")
    return {"launches": launches, "tokens": total, "tok_s": total / wall, "matched": checked, "exempt": exempt}


def _lora_quota(eng, prompts, adapter: dict) -> dict:
    """``register_adapter(quota=1.0)`` through a ModelHandle over the lora
    engine: the adapter's first request (208 tokens, past 60 s x 1 tok/s)
    is served, its next is shed with the gate's priced Retry-After."""
    from gofr_tpu_torch.resilience.rollout import ModelHandle

    ModelHandle("lora", eng).register_adapter("acme-ft", adapter, quota=1.0)
    first = eng.generate(prompts[6], max_new_tokens=8, adapter="acme-ft")
    _quiet(eng)
    try:
        eng.submit(GenRequest(prompts[6], max_new_tokens=8, adapter="acme-ft"))
        raise AssertionError("lora: adapter:acme-ft admitted past its quota")
    except TL.EngineOverloaded as ex:
        shed = ex.retry_after
    price = eng.quota.check("adapter:acme-ft")
    if price is None or abs(shed - price) > 1.0:
        raise AssertionError(f"lora: adapter quota shed {shed}, price {price}")
    eng.set_tenant_quota("adapter:acme-ft", None)
    print(f"lora adapter quota: register_adapter('acme-ft', quota=1.0): the first request served {len(first)} "
          f"tokens, the next shed with retry_after {shed:.2f}s (the gate prices {price:.2f}s); tenant window "
          f"{eng.usage.snapshot()['tenants']['adapter:acme-ft']}")
    return {"retry_after": shed, "price": price}


def phase_lora(dev: dict, seed: int, cfg: TransformerConfig, params: dict, main: dict) -> dict:
    """The lora phase (see the module docstring): returns its readings and
    the kernel launches of its first burst (flash, bf16 paged) and of its
    int8 run (int8 paged)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    attn = ("wq", "wkv", "wo")
    ads = {"A": init_adapter(g, cfg, 8, scale=LORA_SCALE), "B": init_adapter(g, cfg, 4, scale=LORA_SCALE),
           "C": init_adapter(g, cfg, 8, scale=LORA_SCALE, targets=attn),
           "F": init_adapter(g, cfg, 4, scale=LORA_SCALE), "A2": init_adapter(g, cfg, 8, scale=LORA_SCALE)}
    # adapters arrive from host memory (a checkpoint), as load_adapter takes them
    ads = {k: {t: {"a": p["a"].cpu().numpy(), "b": p["b"].cpu().numpy()} for t, p in ad.items()}
           for k, ad in ads.items()}
    counters = KERNEL_COUNTERS
    gid_bytes = cfg.n_layers * sum(d_in + d_out for d_in, d_out in target_dims(cfg).values()) * LORA_RANK * 4
    eng = LLMEngine(cfg, params, seed=seed, lora_slots=LORA_SLOTS, lora_rank=LORA_RANK)
    try:
        warm = _warm_report("lora ", eng)
        if sorted(warm["families"]) != sorted(main["warmup"]["families"]):
            raise AssertionError(f"lora engine families {warm['families']} != {main['warmup']['families']}")
        torch.cuda.synchronize()
        fam0, res0 = dict(eng.families), torch.cuda.memory_reserved()
        ptr0 = {k: v.data_ptr() for k, v in eng.params["layers"].items() if k.startswith("lora_")}
        load_ms = {}
        for name in ("A", "B", "C", "F"):
            t0 = time.perf_counter()
            eng.load_adapter(name, ads[name])
            torch.cuda.synchronize()
            load_ms[name] = (time.perf_counter() - t0) * 1e3
        res1 = torch.cuda.memory_reserved()
        print(f"lora tables: {gid_bytes} bytes a gid (f32, rank {LORA_RANK}, {cfg.n_layers} layers x "
              f"{len(target_dims(cfg))} targets), {LORA_SLOTS + 1} gids on the card; load_adapter after warmup, ms: "
              + ", ".join(f"{k} {v:.1f}" for k, v in load_ms.items())
              + f"; families {len(fam0)} -> {len(eng.families)}; memory_reserved {res0} -> {res1}")
        if eng.families != fam0 or res1 != res0 or \
                ptr0 != {k: v.data_ptr() for k, v in eng.params["layers"].items() if k.startswith("lora_")}:
            raise AssertionError("lora: a load after warmup captured, reserved memory or moved a table")
        _check_families("lora ", eng, seed)  # mixed adapter ids live, on loaded tables
        eng.generate([1, 2, 3], max_new_tokens=4)
        _plens, prompts = _burst_prompts(cfg, seed)
        runs = _bursts("lora ", eng, prompts, 32, counters, adapters=LORA_LANES)
        _lora_idle(eng, "lora ")
        step = eng._step_name(eng.chunk_shapes[-1], eng.admit_cap)
        prog = {name: program_ms(eng, name, seed) for name in ("llm.decode_chunk8", step)}
        for name, ms in prog.items():
            base_ms = main["program_ms"][name]
            print(f"lora program {name}: {ms:.3f} ms device with adapters (mixed ids) vs {base_ms:.3f} ms without "
                  f"(the engine phase's engine); the deltas take {100 * (ms - base_ms) / ms:.1f}% on {dev['smi']}")
        forms = _delta_forms(eng, cfg, seed)
        hot = _lora_hot_load(eng, prompts, ads)
        _lora_idle(eng, "lora hot-load ")
        quota = _lora_quota(eng, prompts, ads["F"])
        _lora_idle(eng, "lora quota ")
    finally:
        eng.close()

    checked = exempt = 0
    for i, r in enumerate(runs):
        c, e = _lora_gate(f"lora burst {i + 1} ", params, cfg, prompts, r["results"], LORA_LANES, ads, TOKEN_GAP)
        print(f"lora burst {i + 1} (lookahead {r['lookahead']}): {c} tokens equal the plain greedy argmax of "
              f"their lane (base, or base + the lane's adapter), {e} exempt")
        if any(q.prefix_hit for q in r["reqs"].values()):
            raise AssertionError("lora: a request took a prefix hit")
        checked, exempt = checked + c, exempt + e
    first = runs[0]
    moved = _lora_moved(params, cfg, prompts, first["results"])
    # adapter A against the merged weights W + A B (computed in f32, rounded
    # to the weights' dtype) under the same gap rule
    a_lanes = [i for i, a in enumerate(LORA_LANES) if a == "A"]
    merged = merge_adapter(params, cfg, ads["A"])
    mc, me = _replay_gate(merged, cfg, [prompts[i] for i in a_lanes],
                          {j: first["results"][i] for j, i in enumerate(a_lanes)}, TOKEN_GAP,
                          label="lora merged A ", verbose=False)
    del merged
    print(f"lora adapter A against merge_adapter's weights (burst 1): {mc} tokens equal, {me} exempt")
    # the hot-load burst: A's requests in flight against the old A, the
    # requests after the publish against the new version, the rest as above
    hc, he = _lora_gate("lora hot-load ", params, cfg, prompts, hot["results"], LORA_LANES, ads, TOKEN_GAP)
    lc, le = _lora_gate("lora hot-load late ", params, cfg, [prompts[0], prompts[5]],
                        dict(enumerate(hot["late"])), ("A2", "A2"), ads, TOKEN_GAP)
    print(f"lora hot-load: {hc} tokens of the burst (A's in flight against the old A) and {lc} of the 2 later "
          f"requests (against A@v2) equal their plain greedy argmax; {he + le} exempt")
    int8 = _lora_int8(dev, seed, cfg, params, ads["A"])

    tok_s = statistics.median(r["tok_s"] for r in runs[:3])
    ttft = statistics.median(r["ttft_p50_s"] for r in runs[:3])
    print(f"lora engine gemma_2b (lora_slots {LORA_SLOTS}, rank {LORA_RANK}; lanes base/A/B/C) on {dev['smi']}: "
          f"3 bursts at lookahead 3: median {tok_s:.1f} tok/s (engine phase {main['tok_s']:.1f}); ttft p50 "
          f"{ttft:.3f}s (engine phase {main['ttft_p50_s']:.3f}s); lookahead 1: {runs[3]['tok_s']:.1f} tok/s; "
          f"{checked} tokens matched, {exempt} exempt; adapted tokens off the base's argmax {moved}")
    launches = {**first["launches"], "paged_decode_partials_int8": int8["launches"]["paged_decode_partials_int8"]}
    if any(launches[n] <= 0 for n in ("flash_attention", "paged_decode_partials", "paged_decode_partials_int8")) or \
            first["launches"]["paged_decode_partials_int8"]:
        raise AssertionError(f"lora launches {launches} (burst 1 {first['launches']})")
    return {"launches": launches, "tok_s": tok_s, "ttft_p50_s": ttft, "lookahead1_tok_s": runs[3]["tok_s"],
            "load_ms": load_ms, "gid_bytes": gid_bytes, "program_ms": prog, "delta_forms": forms,
            "matched": checked, "exempt": exempt, "moved": moved, "merged": (mc, me), "int8": int8,
            "hot": {k: v for k, v in hot.items() if k not in ("results", "late")}, "quota": quota}


def _lora_moved(params, cfg, prompts, results: dict) -> dict:
    """Per adapter: the served tokens of its lanes that are not the base
    model's greedy argmax (teacher-forced, no adapter). Raises when the
    lanes of an adapter on all six targets (A, B) never leave the base's
    argmax: the gate could not tell them from base lanes."""
    moved: dict[str, int] = {}
    for i, name in enumerate(LORA_LANES):
        if not name:
            continue
        seq = prompts[i] + results[i][:-1]
        logits = transformer_forward(
            params, cfg, torch.tensor([seq], device="cuda"), torch.arange(len(seq), device="cuda")[None, :]
        )[0, len(prompts[i]) - 1 :]
        moved[name] = moved.get(name, 0) + sum(int(a) != b for a, b in zip(logits.argmax(-1).tolist(), results[i]))
    if not (moved["A"] and moved["B"]):
        raise AssertionError(f"lora: an adapter's lanes served the base's argmax at every position: {moved}")
    return moved


# The prefix phase's traffic: a chat service whose requests share one
# seeded system prompt of 320 tokens (20 blocks), with user suffixes of
# these lengths, 32 new tokens each, 8 at a time.
PREFIX_SYSTEM = 320
PREFIX_SUFFIXES = (16, 23, 31, 40, 47, 55, 60, 64)
SESSION_SUFFIXES = (16, 24, 32, 40)


def _submit_together(eng, reqs) -> None:
    """Submit every request before the scheduler drains its queue, so one
    admission pass sees them all."""
    eng._drain_submits = lambda: None
    try:
        for r in reqs:
            eng.submit(r)
    finally:
        del eng._drain_submits
    eng._kick.set()


def _idle(eng, label: str, timeout: float = 60.0) -> dict:
    """Wait until no request holds a slot, nothing is in flight and no
    session turn awaits its publish; then every block in use must be one
    the radix (and through it the sessions) holds: a leaked pin or
    promise fails. Returns the KV stats."""
    t0 = time.perf_counter()
    while True:
        with eng._lock:
            busy = eng._inflight or eng._processing is not None or eng._session_pub or any(eng._slot_req)
            st = eng.stats()["kvcache"]
            held = eng.kv.held_blocks()
        if not busy and st["reserved"] == 0 and st["blocks_in_use"] == held:
            return st
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{label}not idle, or a pin leaked: blocks_in_use {st['blocks_in_use']}, "
                                 f"held by the radix {held}, reserved {st['reserved']}")
        time.sleep(0.005)


def _prefix_burst(eng, label: str, prompts, new_tokens: int, session_ids=None) -> dict:
    """Serve ``prompts`` submitted together; wall time to the last stream's
    end, TTFT from each request's own timestamps, the unified steps and
    prompt tokens packed, the radix counters' change, and the most blocks
    shared at once (sampled every 2 ms)."""
    st0 = eng.stats()
    reqs = [GenRequest(p, max_new_tokens=new_tokens, session_id=session_ids[i] if session_ids else "")
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    _submit_together(eng, reqs)
    shared = 0
    while any(r.finish_reason is None for r in reqs):
        shared = max(shared, eng.stats()["kvcache"]["blocks_shared"])
        if time.perf_counter() - t0 > 600:
            raise TimeoutError(f"{label}burst did not finish")
        time.sleep(0.002)
    wall = time.perf_counter() - t0
    results = {i: r.tokens(timeout=60) for i, r in enumerate(reqs)}
    st = eng.stats()
    if any(len(t) != new_tokens or any(x < 0 or x >= eng.cfg.vocab_size for x in t) for t in results.values()):
        raise AssertionError(f"{label}bad streams {results}")
    ttfts = sorted(r.first_token_at - r.submitted_at for r in reqs)
    p0, p1 = st0["kvcache"]["prefix"], st["kvcache"]["prefix"]
    total = sum(len(t) for t in results.values())
    run = {
        "results": results, "wall_s": wall, "tokens": total, "tok_s": total / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1], "ttfts": ttfts,
        "steps": st["steps"] - st0["steps"], "prefill_tokens": st["prefill_tokens"] - st0["prefill_tokens"],
        "blocks_shared_max": shared, **{k: p1[k] - p0[k] for k in ("hits", "partial_hits", "misses")},
    }
    print(f"{label}: {len(prompts)} requests, {total} tokens in {wall:.3f}s = {run['tok_s']:.1f} tok/s; ttft p50 "
          f"{run['ttft_p50_s']:.4f}s max {run['ttft_max_s']:.4f}s; {run['steps']} unified steps, "
          f"{run['prefill_tokens']} prompt tokens packed; radix hits {run['hits']} partial {run['partial_hits']} "
          f"misses {run['misses']}; blocks_shared up to {shared}")
    return run


def _prefix_engine_checks(label: str, eng, seed: int) -> tuple[dict, dict]:
    """Warmup report, the pool's size against the unshared pool, and every
    family (kv_seed and the hit programs included) against its eager
    program."""
    warm = _warm_report(label, eng)
    kv = eng.stats()["kvcache"]
    unshared = eng.slots * eng.kv.table_width
    print(f"{label}pool: {kv['pool_blocks']} blocks of {kv['block_bytes']} bytes ({unshared} for the slots + "
          f"{kv['pool_blocks'] - unshared} for the retention and session budgets); radix capacity "
          f"{kv['prefix']['capacity_bytes']} bytes; sessions {kv['sessions'] and kv['sessions']['device_budget_bytes']}")
    _check_families(label, eng, seed)
    return warm, kv


def phase_prefix(dev: dict, seed: int, cfg: TransformerConfig, params: dict) -> dict:
    """The prefix cache and the session tier at Gemma-2B's full width: the
    engine at its defaults with prefix_cache_mb=64, session_mb=64,
    host_cache_mb=256. Burst A (S + 8 suffixes: 8 misses, S published),
    burst B (S + 8 new suffixes: 8 block-partial hits sharing 320 tokens),
    burst C (B's prompts again: 8 exact hits, no unified step), then 4
    conversations: turn 1, publish, a forced spill of all 4 to host
    memory, and turn 2 (turn 1 + its 32 tokens + 16 new ones: 4
    restores). Every served token through the replay gate; both kernels
    must launch in the phase's replays; no pin may leak. At CUT_LAYERS of
    Gemma-2B's 18 layers."""
    cfg, params = _first_layers(cfg, params, CUT_LAYERS)
    rng = np.random.default_rng(seed + 8)

    def toks(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    system = toks(PREFIX_SYSTEM)
    a_prompts = [system + toks(n) for n in PREFIX_SUFFIXES]
    b_prompts = [system + toks(n) for n in PREFIX_SUFFIXES]
    turn1 = [system + toks(n) for n in SESSION_SUFFIXES]
    turn2_new = [toks(16) for _ in SESSION_SUFFIXES]
    sids = [f"conv-{i}" for i in range(len(SESSION_SUFFIXES))]
    new_tokens = 32
    counters = KERNEL_COUNTERS
    eng = LLMEngine(cfg, params, seed=seed, prefix_cache_mb=64, session_mb=64, host_cache_mb=256)
    times = {"spill": [], "restore": []}
    spill, restore = eng._kv_spill, eng._kv_restore_blocks

    def timed_spill(sid):
        t0 = time.perf_counter()
        spill(sid)  # gathers on the engine stream and waits for the copies
        times["spill"].append(time.perf_counter() - t0)

    def timed_restore(*a):
        t0 = time.perf_counter()
        restore(*a)
        eng._stream.synchronize()  # measurement only: the engine does not wait
        times["restore"].append(time.perf_counter() - t0)

    eng._kv_spill, eng._kv_restore_blocks = timed_spill, timed_restore
    try:
        warm, kv0 = _prefix_engine_checks("prefix ", eng, seed)
        eng.generate([1, 2, 3], max_new_tokens=4)  # warm-up, outside the timed runs
        _idle(eng, "prefix warm-up ")
        _zero_launches(counters)
        runs = {}
        for key, prompts in (("A", a_prompts), ("B", b_prompts), ("C", b_prompts)):
            runs[key] = _prefix_burst(eng, f"prefix burst {key}", prompts, new_tokens)
            kv = _idle(eng, f"prefix burst {key} ")
            print(f"prefix burst {key} idle: blocks_in_use {kv['blocks_in_use']} = blocks the radix holds "
                  f"{eng.kv.held_blocks()}; radix {kv['prefix']}")
        ses0 = eng.stats()["kvcache"]["sessions"]
        runs["turn1"] = _prefix_burst(eng, "sessions turn 1", turn1, new_tokens, sids)
        if not _wait_for(lambda: eng.kv.sessions.stats()["publishes"] == ses0["publishes"] + 4, 30):
            raise AssertionError(f"session turn 1 not published: {eng.kv.sessions.stats()}")
        _idle(eng, "sessions turn 1 ")
        eng.kv.sessions.device_budget = 1  # force the spill, as tests/test_sessions.py does
        eng._kick.set()
        if not _wait_for(lambda: eng.kv.sessions.stats()["spilled"] == 4, 30):
            raise AssertionError(f"sessions not spilled: {eng.kv.sessions.stats()}")
        spilled = eng.kv.sessions.stats()["offload"]
        eng.kv.sessions.device_budget = 64 << 20
        turn2 = [turn1[i] + runs["turn1"]["results"][i] + turn2_new[i] for i in range(len(turn1))]
        runs["turn2"] = _prefix_burst(eng, "sessions turn 2", turn2, new_tokens, sids)
        if not _wait_for(lambda: eng.kv.sessions.stats()["publishes"] == ses0["publishes"] + 12, 30):
            raise AssertionError(f"session turn 2 not published: {eng.kv.sessions.stats()}")
        kv = _idle(eng, "sessions turn 2 ")
        launches = _launches(counters)
        ses = kv["sessions"]
    finally:
        eng.close()

    want = {"A": (0, 0, 8), "B": (0, 8, 0), "C": (8, 0, 0)}
    for key, (h, ph, m) in want.items():
        r = runs[key]
        if (r["hits"], r["partial_hits"], r["misses"]) != (h, ph, m):
            raise AssertionError(f"prefix burst {key}: hits/partial/misses {r['hits'], r['partial_hits'], r['misses']}"
                                 f", expected {(h, ph, m)}")
    if runs["B"]["prefill_tokens"] != sum(PREFIX_SUFFIXES) or runs["C"]["steps"] or runs["C"]["prefill_tokens"]:
        raise AssertionError(f"prefill work: B packed {runs['B']['prefill_tokens']} prompt tokens (expected "
                             f"{sum(PREFIX_SUFFIXES)}), C ran {runs['C']['steps']} unified steps")
    restores = ses["offload"]["restores"] - ses0["offload"]["restores"]
    if restores != 4 or runs["turn2"]["partial_hits"] < 4 or spilled["spills"] - ses0["offload"]["spills"] != 4:
        raise AssertionError(f"sessions: restores {restores}, turn 2 partial hits {runs['turn2']['partial_hits']}, "
                             f"offload {spilled}")
    for name in ("flash_attention", "paged_decode_partials"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched in the prefix phase: {launches}")
    same = sum(x == y for i in runs["B"]["results"] for x, y in zip(runs["B"]["results"][i], runs["C"]["results"][i]))
    print(f"prefix burst C (exact hits) vs burst B (the same prompts as partial hits): {same} of "
          f"{runs['B']['tokens']} tokens equal")

    checked = exempt = 0
    for key, prompts in (("A", a_prompts), ("B", b_prompts), ("C", b_prompts), ("turn1", turn1), ("turn2", turn2)):
        c, e = _replay_gate(params, cfg, prompts, runs[key]["results"], TOKEN_GAP, label=f"prefix {key} ",
                            verbose=False)
        print(f"prefix {key}: {c} tokens equal the plain greedy argmax, {e} exempt (top-2 gap < {TOKEN_GAP})")
        checked, exempt = checked + c, exempt + e
    spill_ms = [1e3 * t for t in times["spill"]]
    restore_ms = [1e3 * t for t in times["restore"]]
    spilled_bytes = spilled["spilled_bytes"]
    before, after = eng.warmup_reserved
    out = {
        "runs": {k: {x: v for x, v in r.items() if x != "results"} for k, r in runs.items()},
        "launches": launches, "tokens_matched": checked, "tokens_exempt": exempt, "c_equal_b": same,
        "spilled_bytes": spilled_bytes, "spill_ms": spill_ms, "restore_ms": restore_ms,
        "warmup": warm, "pool_blocks": kv0["pool_blocks"], "reserved_growth": after - before,
    }
    print(f"prefix sessions: 4 spilled, {spilled_bytes} bytes to host, spill ms per session "
          f"{', '.join(f'{t:.2f}' for t in spill_ms)}; restore ms per session "
          f"{', '.join(f'{t:.2f}' for t in restore_ms)}; turn-2 ttft p50 {runs['turn2']['ttft_p50_s']:.4f}s "
          f"(turn 1 {runs['turn1']['ttft_p50_s']:.4f}s)")
    print(f"prefix engine gemma_2b on {dev['smi']}: warmup_s {warm['warmup_s']:.3f} for {len(warm['families'])} "
          f"families; memory_reserved growth {after - before} bytes; bursts A/B/C tok/s "
          f"{runs['A']['tok_s']:.1f}/{runs['B']['tok_s']:.1f}/{runs['C']['tok_s']:.1f}, ttft p50 "
          f"{runs['A']['ttft_p50_s']:.4f}/{runs['B']['ttft_p50_s']:.4f}/{runs['C']['ttft_p50_s']:.4f}s, unified steps "
          f"{runs['A']['steps']}/{runs['B']['steps']}/{runs['C']['steps']}, prompt tokens packed "
          f"{runs['A']['prefill_tokens']}/{runs['B']['prefill_tokens']}/{runs['C']['prefill_tokens']}; "
          f"{checked} tokens matched, {exempt} exempt; phase launches {launches}")
    return out


def phase_prefix_int8(dev: dict, seed: int, cfg: TransformerConfig, params: dict) -> dict:
    """Four requests through a partial/exact pair on an int8 KV pool
    (kv_int8=True, prefix_cache_mb=64): the exact hits' tail copies move
    the int8 rows with their f32 scales, and the int8 paged kernel decodes
    over shared blocks. Tokens through the replay gate with the int8
    phase's gap (at most 1 in 8 exempt). At CUT_LAYERS of Gemma-2B's 18
    layers."""
    cfg, params = _first_layers(cfg, params, CUT_LAYERS)
    rng = np.random.default_rng(seed + 9)
    system = rng.integers(1, cfg.vocab_size, PREFIX_SYSTEM).tolist()
    prompts = [system + rng.integers(1, cfg.vocab_size, n).tolist() for n in PREFIX_SUFFIXES[1::2]]
    eng = LLMEngine(cfg, params, seed=seed, kv_int8=True, prefix_cache_mb=64)
    try:
        warm, _kv = _prefix_engine_checks("prefix int8 ", eng, seed)
        eng.generate(system, max_new_tokens=4)  # publishes S
        _idle(eng, "prefix int8 warm-up ")
        _zero_launches(("paged_decode_partials_int8",))
        runs = {key: _prefix_burst(eng, f"prefix int8 burst {key}", prompts, 32) for key in ("B", "C")}
        _idle(eng, "prefix int8 ")
        launches = _launches(("paged_decode_partials_int8",))["paged_decode_partials_int8"]
    finally:
        eng.close()
    if (runs["B"]["partial_hits"], runs["C"]["hits"], runs["C"]["steps"]) != (4, 4, 0) or launches <= 0:
        raise AssertionError(f"prefix int8: {runs['B']['partial_hits']} partial, {runs['C']['hits']} exact hits, "
                             f"{runs['C']['steps']} steps in C; {launches} int8 kernel launches")
    exempt = 0
    for key in ("B", "C"):
        c, e = _replay_gate(params, cfg, prompts, runs[key]["results"], INT8_TOKEN_GAP, label=f"prefix int8 {key} ",
                            verbose=False)
        print(f"prefix int8 {key}: {c} tokens equal the plain greedy argmax, {e} exempt (gap < {INT8_TOKEN_GAP})")
        if 8 * e > runs[key]["tokens"]:
            raise AssertionError(f"prefix int8 {key}: {e} of {runs[key]['tokens']} tokens needed the exemption")
        exempt += e
    return {"launches": launches, "warmup": warm, "exempt": exempt,
            "runs": {k: {x: v for x, v in r.items() if x != "results"} for k, r in runs.items()}}


# The spec phase's traffic: extraction-style requests whose output copies
# their input, the case the n-gram drafter exists for. Each prompt is a
# seeded passage of one of these lengths followed by the passage's first
# 16 tokens again, so the drafter finds its trailing n-gram; 64 new tokens.
SPEC_PASSAGES = (32, 48, 64, 96, 128, 160, 200, 240)
SPEC_NEW_TOKENS = 64


class _StreamDrafter:
    """Proposes, for each prompt, the continuation a served burst gave it
    (an oracle), each token shifted by ``shift`` mod the vocabulary (shift
    1: an adversary whose every draft is rejected)."""

    def __init__(self, prompts, served, vocab: int, shift: int = 0):
        self.by_head = {tuple(p[:8]): (len(p), served[i]) for i, p in enumerate(prompts)}
        self.vocab, self.shift = vocab, shift

    def draft(self, tokens: list[int], k: int) -> list[int]:
        plen, served = self.by_head[tuple(tokens[:8])]
        pos = len(tokens) - plen
        return [(t + self.shift) % self.vocab for t in served[pos : pos + k]] if k > 0 else []


def _spec_burst(eng, label: str, prompts, counters: tuple) -> dict:
    """One burst of the spec phase (every prompt from its own client at
    once), with the kernel counters zeroed just before it: tok/s, TTFT,
    verify programs, plain chunks, unified steps, proposals, acceptance,
    tokens per verify lane and launches."""
    lanes = [0, 0]  # verify lanes processed, tokens they carried
    process = eng._process_verify_entry

    def count(entry, toks, now):
        S, W = eng.slots, entry[3]["W"]
        lanes[0] += len(entry[2])
        lanes[1] += sum(int(toks[S * W + slot]) + 1 for slot, _r in entry[2])
        return process(entry, toks, now)

    eng._process_verify_entry = count
    _zero_launches(counters)
    st0 = eng.stats()
    try:
        results, reqs, wall = _serve(eng, prompts, SPEC_NEW_TOKENS)
    finally:
        del eng._process_verify_entry
    st = eng.stats()
    sp0, sp = st0["spec"], st["spec"]
    ttfts = sorted(reqs[i].first_token_at - reqs[i].submitted_at for i in reqs)
    total = sum(len(t) for t in results.values())
    run = {
        "results": results, "wall_s": wall, "tokens": total, "tok_s": total / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1],
        "verifies": sp["steps"] - sp0["steps"], "steps": st["steps"] - st0["steps"],
        "plain_chunks": (st["chunks"] - st0["chunks"]) - (st["steps"] - st0["steps"]),
        "proposed": sp["proposed"] - sp0["proposed"], "accepted": sp["accepted"] - sp0["accepted"],
        "lanes": lanes[0], "tokens_per_lane": lanes[1] / lanes[0] if lanes[0] else None,
        "launches": _launches(counters),
    }
    run["accept_rate"] = run["accepted"] / run["proposed"] if run["proposed"] else None
    if any(len(t) != SPEC_NEW_TOKENS or any(x < 0 or x >= eng.cfg.vocab_size for x in t) for t in results.values()):
        raise AssertionError(f"{label}bad streams {results}")
    rate = "n/a" if run["accept_rate"] is None else f"{run['accept_rate']:.3f}"
    per_lane = "n/a" if run["tokens_per_lane"] is None else f"{run['tokens_per_lane']:.3f}"
    print(f"{label}: {total} tokens in {wall:.3f}s = {run['tok_s']:.1f} tok/s; ttft p50 {run['ttft_p50_s']:.4f}s max "
          f"{run['ttft_max_s']:.4f}s; {run['verifies']} verify programs ({run['lanes']} lanes), "
          f"{run['plain_chunks']} plain chunks, {run['steps']} unified steps; proposed {run['proposed']}, accepted "
          f"{run['accepted']} (rate {rate}); {per_lane} tokens per verify lane; launches {run['launches']}")
    return run


def _divergence_at_near_ties(params, cfg, prompts, got, want, gap: float, label: str, grammars=None) -> int:
    """Where a stream of ``got`` leaves the one ``want`` served for the same
    prompt, it must do so at a near-tie: the plain forward's top-2 gap
    after the common prefix below ``gap`` (the replay gate's exemption),
    among the tokens its grammar admits there when ``grammars[i]`` is one.
    Returns the streams that differ."""
    differ = 0
    for i, p in enumerate(prompts):
        j = next((j for j, (x, y) in enumerate(zip(got[i], want[i])) if x != y), None)
        if j is None:
            continue
        differ += 1
        seq = p + want[i][:j]
        logits = transformer_forward(
            params, cfg, torch.tensor([seq], device="cuda"), torch.arange(len(seq), device="cuda")[None, :],
            unembed_positions=torch.tensor([len(seq) - 1], device="cuda"),
        )[0, 0]
        gr = grammars[i] if grammars else None
        if gr is not None:
            allowed = torch.from_numpy(gr.allowed(gr.advance_all(gr.start, want[i][:j]))).to("cuda")
            logits = logits.masked_fill(~allowed, float("-inf"))
        top2 = torch.topk(logits, 2).values
        g = float(top2[0] - top2[1])
        print(f"{label}request {i} (prompt {len(p)}) leaves the stream it is held against at token {j}: "
              f"top-2 gap {g:.4f}")
        if g >= gap:
            raise AssertionError(f"{label}request {i} differs from its reference at token {j}, gap {g:.4f} >= {gap}")
    return differ


def phase_spec(dev: dict, seed: int, cfg: TransformerConfig, params: dict) -> dict:
    """Speculative decoding at Gemma-2B's full width: the engine at its
    defaults with speculative=True, spec_draft=4 (11 families: the default 10
    and llm.step_v5, each held bitwise against its eager program), serving
    SPEC_PASSAGES' extraction prompts four times: (a) the n-gram drafter,
    (b) an oracle proposing (a)'s tokens, (c) an adversary proposing them
    + 1 (every draft rejected: the engine backs off to plain chunks), and
    (d) a spec-off engine of the same config, built after the spec engine
    is closed. Gates: every token through the replay gate; (a)-(c) leave
    (d)'s streams only at near-ties; (b) accepts >= 90% of its proposals;
    (c) accepts none and runs plain chunks; the flash kernel launches once
    per layer in every verify and unified step; no block in use once
    idle. Then ``spec int8``: 4 requests with the oracle on kv_int8=True.
    At CUT_LAYERS of Gemma-2B's 18 layers."""
    cfg, params = _first_layers(cfg, params, CUT_LAYERS)
    rng = np.random.default_rng(seed + 10)
    passages = [rng.integers(1, cfg.vocab_size, n).tolist() for n in SPEC_PASSAGES]
    prompts = [p + p[:16] for p in passages]
    counters = KERNEL_COUNTERS
    eng = LLMEngine(cfg, params, seed=seed, speculative=True, spec_draft=4)
    try:
        warm = _warm_report("spec ", eng)
        if "llm.step_v5" not in eng._programs or len(eng._programs) != 11:
            raise AssertionError(f"spec engine families {list(eng._programs)}")
        _check_families("spec ", eng, seed)
        prog_ms = {name: program_ms(eng, name, seed) for name in ("llm.step_v5", "llm.decode_chunk8")}
        print(f"spec program device time, one replay on a random state of all 32 slots (CUDA events, mean of 10): "
              f"llm.step_v5 {prog_ms['llm.step_v5']:.3f} ms, llm.decode_chunk8 {prog_ms['llm.decode_chunk8']:.3f} ms "
              f"({prog_ms['llm.decode_chunk8'] / 8:.3f} ms a decode step)")
        eng.generate([1, 2, 3], max_new_tokens=4)  # warm-up, outside the timed runs
        runs = {"a": _spec_burst(eng, "spec burst a (n-gram drafter)", prompts, counters)}
        served = runs["a"]["results"]
        eng.drafter = _StreamDrafter(prompts, served, cfg.vocab_size)
        runs["b"] = _spec_burst(eng, "spec burst b (oracle drafter)", prompts, counters)
        eng.drafter = _StreamDrafter(prompts, served, cfg.vocab_size, shift=1)
        runs["c"] = _spec_burst(eng, "spec burst c (adversarial drafter)", prompts, counters)
        idle = _idle(eng, "spec ")
    finally:
        eng.close()
    torch.cuda.empty_cache()
    off = LLMEngine(cfg, params, seed=seed)
    try:
        _warm_report("spec-off ", off)
        off.generate([1, 2, 3], max_new_tokens=4)
        runs["d"] = _spec_burst(off, "spec burst d (spec off)", prompts, counters)
    finally:
        off.close()
    if idle["blocks_in_use"]:
        raise AssertionError(f"spec engine idle with {idle['blocks_in_use']} blocks in use")

    want = runs["d"]["results"]
    checked = exempt = 0
    for key, r in runs.items():
        c, e = _replay_gate(params, cfg, prompts, r["results"], TOKEN_GAP, label=f"spec {key} ", verbose=False)
        differ = 0 if key == "d" else _divergence_at_near_ties(params, cfg, prompts, r["results"], want, TOKEN_GAP,
                                                                 f"spec {key} ")
        same = sum(x == y for i in want for x, y in zip(r["results"][i], want[i]))
        print(f"spec {key}: {c} tokens equal the plain greedy argmax, {e} exempt (top-2 gap < {TOKEN_GAP}); "
              f"{same} of {r['tokens']} tokens equal burst d's, {differ} streams differ")
        checked, exempt = checked + c, exempt + e
        n_flash = cfg.n_layers * (r["verifies"] + r["steps"])
        if r["launches"]["flash_attention"] != n_flash:
            raise AssertionError(f"spec {key}: {r['launches']['flash_attention']} flash launches, expected {n_flash} "
                                 f"(one per layer in {r['verifies']} verifies and {r['steps']} unified steps)")
    b, c = runs["b"], runs["c"]
    if not b["proposed"] or b["accepted"] < 0.9 * b["proposed"]:
        raise AssertionError(f"oracle burst accepted {b['accepted']} of {b['proposed']} proposals (< 90%)")
    if c["accepted"] or not c["proposed"] or c["plain_chunks"] <= 0:
        raise AssertionError(f"adversarial burst: accepted {c['accepted']} of {c['proposed']}, "
                             f"{c['plain_chunks']} plain chunks")
    if not runs["a"]["verifies"] or runs["d"]["verifies"]:
        raise AssertionError(f"verifies: burst a {runs['a']['verifies']}, spec-off burst d {runs['d']['verifies']}")
    for r in (runs["a"], b):
        if r["launches"]["flash_attention"] <= 0 or r["launches"]["paged_decode_partials"] <= 0:
            raise AssertionError(f"spec burst launches {r['launches']}")

    # spec int8: 4 requests, the oracle from burst d, an int8 KV pool
    p8 = prompts[::2]
    eng8 = LLMEngine(cfg, params, seed=seed, speculative=True, spec_draft=4, kv_int8=True)
    try:
        _warm_report("spec int8 ", eng8)
        # the int8 and prefix int8 phases held the step and chunk families
        # on int8 pools; here the verify
        r = check_family(eng8, "llm.step_v5", seed)
        print(f"spec int8 replay vs eager llm.step_v5: outputs and state bitwise "
              f"{'equal' if r['eager_equal'] else 'DIFFERENT ' + str(r['state_equal'])}; launches per replay "
              f"{r['launches']} (captured {r['captured']})")
        if not r["eager_equal"] or r["launches"] != r["captured"] or not r["captured"].get("flash_attention"):
            raise AssertionError(f"spec int8 llm.step_v5: {r}")
        eng8.generate([1, 2, 3], max_new_tokens=4)
        eng8.drafter = _StreamDrafter(p8, [want[i] for i in range(0, len(prompts), 2)], cfg.vocab_size)
        r8 = _spec_burst(eng8, "spec int8 burst (oracle drafter)", p8, counters)
        _idle(eng8, "spec int8 ")
    finally:
        eng8.close()
    c8, e8 = _replay_gate(params, cfg, p8, r8["results"], INT8_TOKEN_GAP, label="spec int8 ", verbose=False)
    print(f"spec int8: {c8} tokens equal the plain greedy argmax, {e8} exempt (gap < {INT8_TOKEN_GAP})")
    if 8 * e8 > r8["tokens"]:
        raise AssertionError(f"spec int8: {e8} of {r8['tokens']} tokens needed the exemption (> 1 in 8)")
    if r8["launches"]["paged_decode_partials_int8"] <= 0 or r8["launches"]["paged_decode_partials"] or not r8["verifies"]:
        raise AssertionError(f"spec int8: launches {r8['launches']}, {r8['verifies']} verifies")

    launches = {name: sum(r["launches"][name] for k, r in runs.items() if k != "d") for name in counters}
    launches["paged_decode_partials_int8"] = r8["launches"]["paged_decode_partials_int8"]
    before, after = warm["reserved_before"], warm["reserved_after"]
    print(f"spec engine gemma_2b on {dev['smi']}: warmup_s {warm['warmup_s']:.3f} for {len(warm['families'])} "
          f"families; memory_reserved growth {after - before} bytes; bursts a/b/c/d tok/s "
          + "/".join(f"{runs[k]['tok_s']:.1f}" for k in "abcd") + "; ttft p50 "
          + "/".join(f"{runs[k]['ttft_p50_s']:.4f}" for k in "abcd") + "s; accept rate a/b/c "
          + "/".join("n/a" if runs[k]["accept_rate"] is None else f"{runs[k]['accept_rate']:.3f}" for k in "abc")
          + f"; {checked} tokens matched, {exempt} exempt; spec launches {launches}")
    return {"runs": {k: {x: v for x, v in r.items() if x != "results"} for k, r in runs.items()},
            "int8": {x: v for x, v in r8.items() if x != "results"}, "launches": launches, "warmup": warm,
            "program_ms": prog_ms,
            "tokens_matched": checked, "tokens_exempt": exempt}


# The structured phase's traffic: an API whose clients ask for JSON under
# a schema (string, integer, enum and bounded-array fields) or for an id
# matching a regex, beside clients asking for free text. Eight seeded
# prompts of these lengths, all at once: even indices constrained
# (schema, regex, schema, regex), odd ones not. STRUCT_NEW_TOKENS covers
# the schema's longest document (127 bytes, each one token of the byte
# vocabulary) and its eos, so every constrained request can close.
STRUCT_SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "maxLength": 8},
        "age": {"type": "integer"},
        "color": {"enum": ["red", "green", "blue"]},
        "tags": {"type": "array", "items": {"enum": ["x", "y", "z"]}, "maxItems": 3},
    },
}
STRUCT_REGEX = r"[A-Z][a-z]{2,9}-\d{3}"
STRUCT_PROMPTS = (24, 40, 56, 72, 88, 104, 120, 136)
STRUCT_NEW_TOKENS = 128


def _schema_valid(obj, schema: dict) -> bool:
    """``obj`` under the subset of JSON schema STRUCT_SCHEMA uses (the
    card's machine has no jsonschema package): object with every property
    (none required means all, as the compiler emits them), string with
    maxLength, integer, enum, array with items and maxItems."""
    if "enum" in schema:
        return obj in schema["enum"]
    t = schema["type"]
    if t == "object":
        props = schema["properties"]
        return isinstance(obj, dict) and set(obj) == set(props) and all(
            _schema_valid(obj[k], s) for k, s in props.items())
    if t == "array":
        return isinstance(obj, list) and len(obj) <= schema.get("maxItems", len(obj)) and all(
            _schema_valid(x, schema["items"]) for x in obj)
    if t == "string":
        return isinstance(obj, str) and len(obj) <= schema.get("maxLength", len(obj))
    if t == "integer":
        return isinstance(obj, int) and not isinstance(obj, bool)
    raise ValueError(f"schema type {t!r} outside the checked subset")


def _struct_valid(kind: str, text: str) -> bool:
    if kind == "regex":
        return re.fullmatch(STRUCT_REGEX, text) is not None
    try:
        return _schema_valid(json.loads(text), STRUCT_SCHEMA)
    except ValueError:
        return False


def _struct_burst(eng, label: str, prompts, grammars, counters: tuple, temperature: float = 0.0) -> dict:
    """Serve ``prompts`` submitted together (``grammars[i]`` None: free
    text) with the kernel counters zeroed just before: wall time to the
    last stream's end, tok/s, TTFT from each request's own timestamps,
    programs and launches."""
    _zero_launches(counters)
    st0 = eng.stats()
    reqs = [GenRequest(p, max_new_tokens=STRUCT_NEW_TOKENS, temperature=temperature, grammar=g)
            for p, g in zip(prompts, grammars)]
    t0 = time.perf_counter()
    _submit_together(eng, reqs)
    results = {i: r.tokens(timeout=600) for i, r in enumerate(reqs)}
    wall = time.perf_counter() - t0
    st = eng.stats()
    ttfts = sorted(r.first_token_at - r.submitted_at for r in reqs)
    total = sum(len(t) for t in results.values())
    run = {
        "results": results, "reqs": reqs, "wall_s": wall, "tokens": total, "tok_s": total / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1],
        "programs": st["chunks"] - st0["chunks"], "steps": st["steps"] - st0["steps"],
        "launches": _launches(counters),
    }
    print(f"{label}: {len(prompts)} requests ({sum(g is not None for g in grammars)} constrained) at temperature "
          f"{temperature}, {total} tokens in {wall:.3f}s = {run['tok_s']:.1f} tok/s; ttft p50 "
          f"{run['ttft_p50_s']:.4f}s max {run['ttft_max_s']:.4f}s; {run['programs']} programs ({run['steps']} "
          f"unified steps); launches {run['launches']}")
    return run


def _struct_outputs(label: str, run: dict, kinds, tok) -> None:
    """Gate (a): every constrained stream ends on eos and its text is valid
    under its schema or regex."""
    for i, kind in enumerate(kinds):
        if kind is None:
            continue
        r, toks = run["reqs"][i], run["results"][i]
        text = tok.decode(toks)
        if r.finish_reason != "eos" or toks[-1] != tok.eos_id or not _struct_valid(kind, text):
            raise AssertionError(f"{label}request {i} ({kind}): finish {r.finish_reason}, text {text!r}")
        print(f"{label}request {i} ({kind}, {len(toks)} tokens): {text!r}")


def _masked_replay_gate(params, cfg, prompts, results, grammars, gap: float, label: str) -> tuple[int, int]:
    """Gate (b): every constrained token against the argmax, over the
    tokens its grammar admits at its DFA state, of the plain full-prompt
    forward on ``params`` (no kernels), teacher-forced on the served
    stream, unless the top-2 gap among the admitted tokens is below
    ``gap``. Returns (tokens matched, tokens exempt)."""
    checked = exempt = 0
    for i, (p, g) in enumerate(zip(prompts, grammars)):
        if g is None:
            continue
        toks = results[i]
        seq = p + toks[:-1]
        logits = transformer_forward(
            params, cfg, torch.tensor([seq], device="cuda"), torch.arange(len(seq), device="cuda")[None, :]
        )[0, len(p) - 1 :]
        s = g.start
        for j, t in enumerate(toks):
            allowed = torch.from_numpy(g.allowed(s)).to("cuda")
            top = torch.topk(logits[j].masked_fill(~allowed, float("-inf")), 2)
            want, gap_j = int(top.indices[0]), float(top.values[0] - top.values[1])
            if t == want:
                checked += 1
            elif gap_j < gap:
                exempt += 1
            else:
                raise AssertionError(f"{label}request {i}: token {j} served {t} != masked plain argmax {want}, "
                                     f"admitted top-2 gap {gap_j:.4f}")
            s = g.advance(s, t)
        del logits
    return checked, exempt


def phase_structured(dev: dict, seed: int, cfg: TransformerConfig, params: dict) -> dict:
    """Grammar-constrained decoding at Gemma-2B's full width: STRUCT_SCHEMA
    and STRUCT_REGEX compiled against the ByteTokenizer's 256,000-id
    vocabulary (compile ms, states, table bytes), then the engine at its
    defaults (constrained decoding on, no constrained family captured at
    warmup): the 8 prompts with no grammar (the reference), the burst with
    4 constrained (its first constrained request captures the constrained
    families), the burst again (timed), and at temperature 0.9. Gates:
    (a) every constrained output ends on eos and is valid; (b) every
    constrained token is the masked argmax of the plain forward,
    teacher-forced (near-ties exempt); (c) the unconstrained streams equal
    the grammar-free run's; (d) every constrained family's replay is
    bitwise its eager program on a cloned random state with grammar ids
    and DFA states set; (e) once idle, no block in use and no grammar
    reference held. Then a speculating engine on the greedy burst (its
    tokens those of the spec-off engine, near-ties exempt) and an int8 KV
    engine with 2 constrained requests. At CUT_LAYERS of Gemma-2B's 18
    layers."""
    cfg, params = _first_layers(cfg, params, CUT_LAYERS)
    tok = ByteTokenizer(cfg.vocab_size)
    vocab = vocab_from_tokenizer(tok)
    t0 = time.perf_counter()
    g_schema = compile_json_schema(STRUCT_SCHEMA, vocab, tok.eos_id)
    t1 = time.perf_counter()
    g_regex = compile_regex(STRUCT_REGEX, vocab, tok.eos_id)
    t2 = time.perf_counter()
    compile_ms = {"schema": (t1 - t0) * 1e3, "regex": (t2 - t1) * 1e3}
    for kind, g in (("schema", g_schema), ("regex", g_regex)):
        print(f"structured grammar {kind}: {g.n_states} states over {g.vocab_size} tokens, table "
              f"{g.table.nbytes} bytes, compiled in {compile_ms[kind]:.1f} ms (host, one CPU core)")
    rng = np.random.default_rng(seed + 20)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in STRUCT_PROMPTS]
    kinds = ["schema" if i % 4 == 0 else "regex" if i % 4 == 2 else None for i in range(len(prompts))]
    grammars = [g_schema if k == "schema" else g_regex if k == "regex" else None for k in kinds]
    plain = [None] * len(prompts)
    counters = KERNEL_COUNTERS
    launches = dict.fromkeys(counters, 0)

    def tally(run):
        for k, n in run["launches"].items():
            launches[k] += n

    eng = LLMEngine(cfg, params, seed=seed)
    try:
        warm = _warm_report("structured ", eng)
        if any(n in eng.families for n in eng._programs_g) or eng.g_captures:
            raise AssertionError(f"structured: a constrained family was captured at warmup: {list(eng.families)}")
        eng.generate([1, 2, 3], max_new_tokens=4)
        ref = _struct_burst(eng, "structured burst N (no grammar)", prompts, plain, counters)
        if eng._gtab is not None or eng.g_captures:
            raise AssertionError("structured: an engine that saw no grammar made a grammar table or captured")
        tally(ref)
        first = _struct_burst(eng, "structured burst C1 (4 constrained; first use captures)", prompts, grammars,
                              counters)
        tally(first)
        before, after = eng.g_reserved
        print(f"structured capture: {len(eng._programs_g)} constrained families captured at the first constrained "
              f"request in {eng.g_capture_s:.3f} s; memory_reserved {before} -> {after} bytes (+{after - before}); "
              f"table {tuple(eng._gtab.shape)} int32 = {eng._gtab.numel() * 4} bytes; captures {eng.g_captures}")
        run = _struct_burst(eng, "structured burst C2 (4 constrained)", prompts, grammars, counters)
        tally(run)
        if run["results"] != first["results"]:
            raise AssertionError("structured: the greedy burst served other tokens the second time")
        for label, r in (("structured C1 ", first), ("structured C2 ", run)):
            _struct_outputs(label, r, kinds, tok)
        checked, exempt = _masked_replay_gate(params, cfg, prompts, run["results"], grammars, TOKEN_GAP,
                                              "structured ")
        for i, k in enumerate(kinds):
            if k is None and run["results"][i] != ref["results"][i]:
                raise AssertionError(f"structured: unconstrained request {i} differs from the grammar-free run")
        print(f"structured gates: (a) 4 constrained outputs valid in C1 and C2; (b) {checked} constrained tokens "
              f"equal the masked plain argmax, {exempt} exempt (admitted top-2 gap < {TOKEN_GAP}); (c) the 4 "
              f"unconstrained streams equal the grammar-free run's")
        for i, name in enumerate(eng._programs_g):
            r = check_family(eng, name, seed + 200 + i)
            kind = eng._program(name)[1]
            print(f"structured replay vs eager {name}: outputs and state bitwise "
                  f"{'equal' if r['eager_equal'] else 'DIFFERENT ' + str(r['state_equal'])}; launches per "
                  f"replay {r['launches']} (captured {r['captured']})")
            if not r["eager_equal"] or r["launches"] != r["captured"]:
                raise AssertionError(f"structured {name}: {r}")
            if bool(r["captured"].get("paged_decode_partials")) != (kind in ("step", "chunk")) or bool(
                    r["captured"].get("flash_attention")) != (kind in ("step", "verify")):
                raise AssertionError(f"structured {name} ({kind}): launches {r['captured']}")
        # the two chunks in turns (plain, constrained, constrained, plain)
        order = ("llm.decode_chunk8", "llm.decode_chunk8g", "llm.decode_chunk8g", "llm.decode_chunk8")
        reads = [(name, program_ms(eng, name, seed)) for name in order]
        prog_ms = {name: statistics.mean(t for n, t in reads if n == name) for name in order[:2]}
        print(f"structured program device time, one replay on a random state of all 32 slots (CUDA events, mean "
              f"of 10, two runs each in turns): llm.decode_chunk8g {prog_ms['llm.decode_chunk8g']:.3f} ms, "
              f"llm.decode_chunk8 {prog_ms['llm.decode_chunk8']:.3f} ms (runs {[round(t, 3) for _n, t in reads]}; "
              f"difference {prog_ms['llm.decode_chunk8g'] - prog_ms['llm.decode_chunk8']:.3f} ms a chunk)")
        # one sampling site alone, every lane constrained: the mask and
        # advance's device time beside the plain sampler's, and the bound
        # of its added work (the logits and the gathered table rows read)
        V, S = cfg.vocab_size, eng.slots
        gen = torch.Generator(device="cuda").manual_seed(seed)
        lg = torch.randn((S, V), generator=gen, device="cuda") * 4
        temps = torch.zeros((S,), device="cuda")
        gids = torch.zeros((S,), dtype=torch.int32, device="cuda")
        gst = torch.randint(0, g_schema.n_states - 1, (S,), generator=gen, device="cuda", dtype=torch.int32)
        site = {"plain": device_ms(lambda: LLMEngine._sample(lg, temps, gen), None),
                "masked": device_ms(lambda: TL._g_sample(lg, temps, gen, eng._gtab, gids, gst), None)}
        site["mask_bound"] = 2 * S * V * 4 / dev["peaks"][0] * 1e3
        print(f"structured sampling site [{S}, {V}] (torch.profiler, device time of every kernel, mean of 20): "
              f"plain {site['plain']:.4f} ms, masked {site['masked']:.4f} ms (mask and advance "
              f"{site['masked'] - site['plain']:.4f} ms a site, {8 * (site['masked'] - site['plain']):.4f} ms for "
              f"the 8 sites of a chunk; bound of the added reads {site['mask_bound']:.4f} ms, bytes)")
        sampled = _struct_burst(eng, "structured burst S (temperature 0.9)", prompts, grammars, counters, 0.9)
        tally(sampled)
        _struct_outputs("structured S ", sampled, kinds, tok)
        idle = _idle(eng, "structured ")
        if idle["blocks_in_use"] or any(eng._g_refs):
            raise AssertionError(f"structured: idle with {idle['blocks_in_use']} blocks, grammar refs {eng._g_refs}")
        print(f"structured gate (e): idle with 0 blocks in use, grammar refs {eng._g_refs}; "
              f"stats {eng.stats()['constrained']}")
        capture = {"s": eng.g_capture_s, "reserved_before": before, "reserved_after": after}
    finally:
        eng.close()
    torch.cuda.empty_cache()

    def warm_constrained(e) -> float:
        """A constrained warm-up request outside the timed burst: its
        engine captures the constrained families there. Returns the
        capture's seconds."""
        e.generate([1, 2, 3], max_new_tokens=4)
        warm = [GenRequest([1, 2, 3], max_new_tokens=STRUCT_NEW_TOKENS, grammar=g) for g in (g_schema, g_regex)]
        _submit_together(e, warm)  # both grammars in one table sync: one capture
        for r in warm:
            r.tokens(timeout=600)
        if e.g_captures != 1:
            raise AssertionError(f"structured warm-up captured the constrained families {e.g_captures} times")
        return e.g_capture_s

    spec = LLMEngine(cfg, params, seed=seed, speculative=True, spec_draft=4)
    try:
        spec_capture = warm_constrained(spec)
        sp0 = spec.stats()["spec"]
        sr = _struct_burst(spec, "structured spec burst (greedy)", prompts, grammars, counters)
        tally(sr)
        sp1 = spec.stats()["spec"]
        sp = {"steps": sp1["steps"] - sp0["steps"]}
        for split in ("constrained", "unconstrained"):
            prop, acc = (sp1[split][x] - sp0[split][x] for x in ("proposed", "accepted"))
            sp[split] = {"proposed": prop, "accepted": acc, "accept_rate": round(acc / prop, 3) if prop else None}
        _idle(spec, "structured spec ")
    finally:
        spec.close()
    _struct_outputs("structured spec ", sr, kinds, tok)
    differ = _divergence_at_near_ties(params, cfg, prompts, sr["results"], run["results"], TOKEN_GAP,
                                      "structured spec ", grammars)
    rates = {k: sp[k]["accept_rate"] for k in ("constrained", "unconstrained")}
    print(f"structured spec: {len(spec._programs_g)} constrained families captured in {spec_capture:.3f} s at "
          f"the warm-up request; {sp['steps']} verifies; constrained proposed {sp['constrained']['proposed']} accepted "
          f"{sp['constrained']['accepted']} (rate {rates['constrained']}); unconstrained proposed "
          f"{sp['unconstrained']['proposed']} accepted {sp['unconstrained']['accepted']} (rate "
          f"{rates['unconstrained']}); {differ} streams differ from spec off")
    if not sp["steps"] or not sp["constrained"]["proposed"]:
        raise AssertionError(f"structured spec: no constrained verify ran: {sp}")
    torch.cuda.empty_cache()

    p8, g8, k8 = prompts[:4:2], grammars[:4:2], kinds[:4:2]
    eng8 = LLMEngine(cfg, params, seed=seed, kv_int8=True)
    try:
        int8_capture = warm_constrained(eng8)
        r8 = _struct_burst(eng8, "structured int8 burst (kv_int8, 2 constrained)", p8, g8, counters)
        tally(r8)
        _idle(eng8, "structured int8 ")
    finally:
        eng8.close()
    _struct_outputs("structured int8 ", r8, k8, tok)
    c8, e8 = _masked_replay_gate(params, cfg, p8, r8["results"], g8, INT8_TOKEN_GAP, "structured int8 ")
    print(f"structured int8: {c8} constrained tokens equal the masked plain argmax, {e8} exempt "
          f"(gap < {INT8_TOKEN_GAP}); constrained families captured in {int8_capture:.3f} s at the warm-up request")
    if 8 * e8 > r8["tokens"] or not r8["launches"]["paged_decode_partials_int8"] or r8["launches"][
            "paged_decode_partials"]:
        raise AssertionError(f"structured int8: {e8} of {r8['tokens']} exempt; launches {r8['launches']}")
    for name in ("flash_attention", "paged_decode_partials"):
        if not run["launches"][name]:
            raise AssertionError(f"structured: {name} was not launched in the constrained burst: {run['launches']}")
    print(f"structured engine gemma_2b on {dev['smi']}: greedy burst {run['tok_s']:.1f} tok/s constrained "
          f"(C2) against {ref['tok_s']:.1f} tok/s with no grammar; ttft p50 {run['ttft_p50_s']:.4f}s max "
          f"{run['ttft_max_s']:.4f}s (no grammar {ref['ttft_p50_s']:.4f}s / {ref['ttft_max_s']:.4f}s); C1 with "
          f"the capture {first['tok_s']:.1f} tok/s, ttft max {first['ttft_max_s']:.4f}s; capture "
          f"{capture['s']:.3f} s, +{capture['reserved_after'] - capture['reserved_before']} bytes; "
          f"phase launches {launches}")
    strip = lambda r: {k: v for k, v in r.items() if k not in ("results", "reqs")}  # noqa: E731
    return {"launches": launches, "compile_ms": compile_ms, "capture": capture, "program_ms": prog_ms, "site": site,
            "warmup": warm, "runs": {"N": strip(ref), "C1": strip(first), "C2": strip(run), "S": strip(sampled),
                                     "spec": strip(sr), "int8": strip(r8)},
            "spec": sp, "tokens_matched": checked, "tokens_exempt": exempt}


def _wait_for(pred, seconds: float, every: float = 0.005):
    """The first truthy value of ``pred()`` within ``seconds``, polled every
    ``every`` seconds; None when there was none."""
    t0 = time.perf_counter()
    while not (got := pred()):
        if time.perf_counter() - t0 > seconds:
            return None
        time.sleep(every)
    return got


def _http(port: int, method: str, path: str, body=None, headers=None, timeout: float = 600.0):
    """One request on its own connection, with ``headers`` added -> (status,
    body bytes, seconds to the response's first byte, seconds to its last,
    response headers)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        t_first = time.perf_counter() - t0
        raw = resp.read()
        return resp.status, raw, t_first, time.perf_counter() - t0, dict(resp.getheaders())
    finally:
        conn.close()


def _sse_events(raw: bytes) -> list:
    events = [ln[len("data: "):] for ln in raw.decode().split("\n") if ln.startswith("data: ")]
    if not events or events[-1] != "[DONE]":
        raise AssertionError(f"SSE stream does not end with [DONE]: {events[-2:]}")
    return [json.loads(e) for e in events[:-1]]


GATEWAY_USER, GATEWAY_PASSWORD = "smoke", "gateway-secret"
_JSON = {"Content-Type": "application/json"}


def free_port() -> int:
    """A loopback port nothing listens on (bound once, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def basic_auth(user: str = GATEWAY_USER, password: str = GATEWAY_PASSWORD) -> dict:
    return {"Authorization": "Basic " + base64.b64encode(f"{user}:{password}".encode()).decode()}


def build_gateway(model_url: str, down_url: str, package: str = "gofr_tpu_torch"):
    """The gateway in front of a model app: a plain ``new()`` App on
    ephemeral HTTP and metrics ports (REQUEST_TIMEOUT 600) with basic auth
    (GATEWAY_USER / GATEWAY_PASSWORD) and two outbound services: ``gemma``
    at ``model_url`` (breaker threshold 3, interval 1 s, health at
    .well-known/alive) and ``down`` at ``down_url`` (threshold 2, 1 s).
    ``POST /ask/{svc}`` forwards its body to the service's ``/generate``
    through the async client; ``POST /ask/{svc}/stream`` proxies the
    OpenAI chat route through ``astream``, chunk by chunk. An open breaker
    or an unreachable service answers 503; any upstream answer passes
    through with its status and body. ``package`` is the framework the
    gateway is built from: the port by default (the CPU tests build the
    same gateway over the JAX package too). Returns the App, not started."""
    mod = lambda name: importlib.import_module(f"{package}.{name}")  # noqa: E731
    app_mod, config, errors, responder, service = (
        mod(n) for n in ("app", "config", "http.errors", "http.responder", "service"))
    app = app_mod.new(config=config.new_mock_config({
        "APP_NAME": "gateway", "HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "600", "LOG_LEVEL": "ERROR",
    }))
    app.enable_basic_auth(GATEWAY_USER, GATEWAY_PASSWORD)
    app.add_http_service("gemma", model_url, service.CircuitBreaker(threshold=3, interval=1.0),
                         service.HealthConfig(".well-known/alive"))
    app.add_http_service("down", down_url, service.CircuitBreaker(threshold=2, interval=1.0))

    def upstream(ctx):
        name = ctx.path_param("svc")
        svc = ctx.get_http_service(name)
        if svc is None:
            raise errors.ErrorEntityNotFound("service", name)
        return name, svc

    async def ask(ctx):
        name, svc = upstream(ctx)
        try:
            resp = await svc.apost("generate", body=ctx.request.body, headers=_JSON, timeout=600.0)
        except service.CircuitOpenError as e:
            raise errors.ErrorServiceUnavailable(str(e)) from None
        except OSError:
            raise errors.ErrorServiceUnavailable(f"service {name} unreachable") from None
        ctype = {k.lower(): v for k, v in resp.headers.items()}.get("content-type", "application/json")
        return responder.Response(resp.status_code, [("Content-Type", ctype)], resp.body)

    async def ask_stream(ctx):
        name, svc = upstream(ctx)
        try:
            st = await svc.astream("POST", "v1/chat/completions", body=ctx.request.body, headers=_JSON,
                                   timeout=600.0, metric_path="v1/chat/completions")
        except service.CircuitOpenError as e:
            raise errors.ErrorServiceUnavailable(str(e)) from None
        except (OSError, EOFError):
            raise errors.ErrorServiceUnavailable(f"service {name} unreachable") from None
        ctype = st.headers.get("content-type", "application/json")
        if st.status_code != 200 or not st.streamed:
            return responder.Response(st.status_code, [("Content-Type", ctype)], await st.aread())
        return responder.StreamingResponse(st.aiter_raw(), ctype)

    app.post("/ask/{svc}", ask)
    app.post("/ask/{svc}/stream", ask_stream)
    return app


def phase_edge(dev: dict, seed: int, cfg: TransformerConfig, params: dict, engine_out: dict | None,
               gateway: bool = True) -> dict:
    """The port's HTTP server (gofr_tpu_torch.serve) on an ephemeral port,
    serving Gemma-2B through a bf16 engine at its defaults over the same
    weights, driven over real sockets: the burst as concurrent POST
    /generate requests (every token through the replay gate), one OpenAI
    chat request plain and then SSE, and a client that hangs up mid-stream
    (its blocks must be free within 3 s). The App's default server is the
    native-codec one, so all of that runs through it; the native part
    (``_native_part``) then holds it against the asyncio server. With
    ``gateway``, the gateway part (``_gateway``) runs against this app
    while it still serves; then the host-only prefork and datasources
    parts (``_prefork_part``, ``_datasources_part``). Last, the app shuts
    down with an idle keep-alive connection open: its server must close
    within 5 s."""
    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.serve import build_app

    app = build_app(new_mock_config({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "GEMMA_PRESET": "2b", "LLM_SLOTS": "32", "LLM_MAX_SEQ": "512",
        "REQUEST_TIMEOUT": "600", "LOG_LEVEL": "WARN",
    }), params=params)
    thread = app.run_in_background()
    port = app.http_server.port
    eng = app.container.tpu().llm("gemma")
    warm = _warm_report("edge ", eng)
    A.flash_attention.launches = 0
    A.paged_decode_partials.launches = 0
    idle = None  # a keep-alive connection left idle for the shutdown
    try:
        status, raw, _, _, _ = _http(port, "POST", "/generate", {"tokens": [1, 2, 3], "max_new_tokens": 4})
        if status != 201 or len(json.loads(raw)["data"]["tokens"]) != 4:  # warm-up, outside the timed run
            raise AssertionError(f"warm-up /generate: {status} {raw[:200]!r}")

        # 1. the burst as concurrent POST /generate requests
        rng = np.random.default_rng(seed)
        plens = [5, 16, 17, 63, 64, 65, 200, 440]
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in plens]
        new_tokens = 32
        burst_launches0 = (A.flash_attention.launches, A.paged_decode_partials.launches)
        burst = _http_burst(port, prompts, new_tokens)
        burst_launches = {
            "flash_attention": A.flash_attention.launches - burst_launches0[0],
            "paged_decode_partials": A.paged_decode_partials.launches - burst_launches0[1],
        }
        results, wall, first = burst["results"], burst["wall_s"], burst["first_s"]
        for i, toks in results.items():
            if any(t < 0 or t >= cfg.vocab_size for t in toks):
                raise AssertionError(f"edge request {i} (prompt {plens[i]}): token out of range {toks}")
        total = sum(len(t) for t in results.values())
        checked, exempt = _replay_gate(params, cfg, prompts, results, TOKEN_GAP, label="edge ")

        # 2. one OpenAI chat request, plain and then SSE, each alone
        chat = {"model": "gemma", "messages": [{"role": "user", "content": "Say hello to the H100."}],
                "max_tokens": 24}
        status, raw, _, _, _ = _http(port, "POST", "/v1/chat/completions", chat)
        if status != 200:
            raise AssertionError(f"chat completion: {status} {raw[:300]!r}")
        plain = json.loads(raw)
        finish = plain["choices"][0]["finish_reason"]
        if not 0 < plain["usage"]["completion_tokens"] <= 24 or finish not in ("length", "stop"):
            raise AssertionError(f"chat completion: {plain}")
        status, raw, sse_first, _, _ = _http(port, "POST", "/v1/chat/completions", {**chat, "stream": True})
        if status != 200:
            raise AssertionError(f"chat SSE: {status} {raw[:300]!r}")
        events = _sse_events(raw)
        joined = "".join(e["choices"][0]["delta"].get("content", "") for e in events)
        content = plain["choices"][0]["message"]["content"]
        if joined != content or events[-1]["choices"][0]["finish_reason"] != finish:
            raise AssertionError(f"SSE deltas {joined!r} / {events[-1]} differ from the plain answer {content!r}")

        # 3. a client that hangs up after the first SSE chunk
        freed_s = _sse_cut(port, eng, chat)
        launches = {"flash_attention": A.flash_attention.launches,
                    "paged_decode_partials": A.paged_decode_partials.launches}
        native = _native_part(dev, app, eng, cfg, params, prompts, burst, new_tokens, chat)
        gw = None
        if gateway:
            gw = _gateway(dev, app, cfg, params, prompts, results, new_tokens, chat, content,
                          {"tok_s": total / wall, "ttft_p50_s": first[len(first) // 2], "sse_first_byte_s": sse_first})
        prefork = _prefork_part(dev)
        datasources = _datasources_part(dev)
        idle = _idle_keepalive(port)
    finally:
        t_down = time.perf_counter()
        app.shutdown()
        _wait_for(lambda: app.http_server._server is None, 60.0, every=0.01)
        closed_s = time.perf_counter() - t_down
        thread.join(timeout=60)
        stopped_s = time.perf_counter() - t_down
    if thread.is_alive():
        raise AssertionError("edge server did not stop")
    _closed_by_server(idle, "edge native server")
    if closed_s >= 5.0:
        raise AssertionError(f"the native server took {closed_s:.3f}s to close with an idle keep-alive connection")
    for name, n in launches.items():
        if n <= 0 or burst_launches[name] <= 0:
            raise AssertionError(f"{name} was not launched while the edge served: {launches}, burst {burst_launches}")

    out = {
        "requests": len(results), "tokens": total, "wall_s": wall, "tok_s": total / wall,
        "ttft_p50_s": first[len(first) // 2], "ttft_max_s": first[-1], "sse_first_byte_s": sse_first,
        "disconnect_freed_s": freed_s, "tokens_matched": checked, "tokens_exempt": exempt,
        "launches": launches, "burst_launches": burst_launches, "warmup": warm, "gateway": gw, "native": native,
        "prefork": prefork, "datasources": datasources, "shutdown_closed_s": closed_s, "shutdown_s": stopped_s,
    }
    engine_note = "" if engine_out is None else (
        f"; engine phase in-process {engine_out['tok_s']:.1f} tok/s, ttft p50 {engine_out['ttft_p50_s']:.3f}s max "
        f"{engine_out['ttft_max_s']:.3f}s")
    print(
        f"edge gemma_2b over HTTP on {dev['smi']}: {out['requests']} concurrent POST /generate, {total} tokens "
        f"in {wall:.3f}s = {out['tok_s']:.1f} tok/s; client ttft (first response byte, which carries the whole "
        f"answer) p50 {out['ttft_p50_s']:.3f}s max {out['ttft_max_s']:.3f}s{engine_note}; {checked} tokens "
        f"matched, {exempt} exempt; SSE first byte {sse_first:.3f}s; disconnect freed in {freed_s:.3f}s; "
        f"burst launches {burst_launches}, phase {launches}; shut down with an idle keep-alive connection open: "
        f"server closed in {closed_s:.3f}s, app stopped (engine closed) in {stopped_s:.3f}s"
    )
    return out


def _sse_cut(port: int, eng, chat: dict) -> float:
    """A client that hangs up after the first SSE chunk of a 400-token chat
    stream: its request must be retired (one more disconnect, no blocks in
    use) within 3 s. Returns the seconds that took."""
    disconnects0 = eng.stats()["disconnect_cancels"]
    body = json.dumps({**chat, "max_tokens": 400, "stream": True}).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=120) as sock:
        sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: smoke\r\n"
                     b"Content-Type: application/json\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        got = b""
        while b"data: " not in got:
            chunk = sock.recv(4096)
            if not chunk:
                raise AssertionError("server closed the SSE stream before its first chunk")
            got += chunk
    t_gone = time.perf_counter()
    while time.perf_counter() - t_gone < 3.0:
        st = eng.stats()
        if st["kvcache"]["blocks_in_use"] == 0 and st["disconnect_cancels"] == disconnects0 + 1:
            break
        time.sleep(0.01)
    freed_s = time.perf_counter() - t_gone
    st = eng.stats()
    if st["kvcache"]["blocks_in_use"] or st["disconnect_cancels"] != disconnects0 + 1:
        raise AssertionError(f"disconnected stream not retired within 3 s: {st}")
    return freed_s


def _idle_keepalive(port: int) -> socket.socket:
    """A connection that has had one answer and stays open, idle (a
    pooled keep-alive socket, as a front router holds)."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    sock.sendall(b"GET /.well-known/alive HTTP/1.1\r\nHost: smoke\r\n\r\n")
    got = b""
    while b"\r\n\r\n" not in got:
        chunk = sock.recv(4096)
        if not chunk:
            raise AssertionError("the keep-alive probe's connection closed before its answer")
        got += chunk
    if not got.startswith(b"HTTP/1.1 200"):
        raise AssertionError(f"keep-alive probe: {got[:200]!r}")
    return sock


def _closed_by_server(sock: socket.socket | None, label: str) -> None:
    """The idle connection was closed by the server's shutdown."""
    if sock is None:
        return
    try:
        sock.settimeout(5.0)
        rest = sock.recv(4096)
    finally:
        sock.close()
    if rest:
        raise AssertionError(f"{label}: the idle connection received {rest[:100]!r} instead of its close")


def _http_burst(port: int, prompts, new_tokens: int) -> dict:
    """The burst as concurrent POST /generate requests, one connection
    each: {"results": {i: tokens}, "wall_s", "first_s": each client's
    seconds to its first response byte, sorted}."""
    answers: dict = {}
    errors: list = []

    def client(i):
        try:
            answers[i] = _http(port, "POST", "/generate", {"tokens": prompts[i], "max_new_tokens": new_tokens})
        except BaseException as e:  # surfaced below, after every client joined
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if len(answers) != len(prompts):
        raise TimeoutError(f"{len(answers)} of {len(prompts)} HTTP clients finished")
    results = {}
    for i, (status, raw, _, _, _) in sorted(answers.items()):
        toks = json.loads(raw)["data"]["tokens"] if status == 201 else None
        if toks is None or len(toks) != new_tokens:
            raise AssertionError(f"burst request {i} on :{port}: {status} {raw[:200]!r}")
        results[i] = toks
    return {"results": results, "wall_s": wall, "first_s": sorted(a[2] for a in answers.values())}


def _native_part(dev: dict, app, eng, cfg, params, prompts, native_run: dict, new_tokens: int, chat: dict) -> dict:
    """The native part, on the edge phase's app and engine: (1) the app
    serves through NativeHTTPServer and the codec loaded, and an App
    configured with GOFR_HTTP_NATIVE=0 builds AsyncHTTPServer; (2) that
    asyncio server, over the edge app's own router on its own loop,
    listens beside the native one; (3) the burst served directly by the
    engine (in-process clients), then through the servers in the order
    native (the edge phase's burst), asyncio, asyncio, native: every
    stream of every burst equal to the direct one token for token, or
    leaving it only at a near-tie (the gateway's rule; counted); (4) a
    client that hangs up mid-SSE on the asyncio server is retired as on the
    native one; (5) the asyncio server shuts down with an idle keep-alive
    connection open, in under 5 s."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.http.nativeserver import NativeHTTPServer
    from gofr_tpu_torch.http.server import AsyncHTTPServer
    from gofr_tpu_torch.native import load_http_codec

    t_part = time.perf_counter()
    codec = load_http_codec()
    if type(app.http_server) is not NativeHTTPServer or codec is None:
        raise AssertionError(f"the edge app serves through {type(app.http_server).__name__}, codec {codec}")
    probe = App(new_mock_config({"HTTP_PORT": "0", "METRICS_PORT": "0", "GOFR_HTTP_NATIVE": "0", "LOG_LEVEL": "ERROR"}))
    probe.container.close()
    if type(probe.http_server) is not AsyncHTTPServer:
        raise AssertionError(f"GOFR_HTTP_NATIVE=0 built {type(probe.http_server).__name__}")
    alt = AsyncHTTPServer(app.router.dispatch, 0, host="127.0.0.1", logger=app.logger)
    asyncio.run_coroutine_threadsafe(alt.start(), app._loop).result(30)
    ports = {"native": app.http_server.port, "asyncio": alt.port}
    try:
        direct, _reqs, direct_wall = _serve(eng, prompts, new_tokens)
        runs = {"native": [native_run], "asyncio": []}
        for name in ("asyncio", "asyncio", "native"):
            runs[name].append(_http_burst(ports[name], prompts, new_tokens))
        tok_s, differ = {}, {}
        for name, rs in runs.items():
            tok_s[name] = [sum(map(len, r["results"].values())) / r["wall_s"] for r in rs]
            differ[name] = [_divergence_at_near_ties(params, cfg, prompts, r["results"], direct, TOKEN_GAP,
                                                     f"native part {name} ") for r in rs]
        sse_freed_s = _sse_cut(alt.port, eng, chat)
        idle = _idle_keepalive(alt.port)
        t0 = time.perf_counter()
        asyncio.run_coroutine_threadsafe(alt.shutdown(), app._loop).result(30)
        alt_closed_s = time.perf_counter() - t0
        _closed_by_server(idle, "asyncio server")
    finally:
        if alt._server is not None:
            asyncio.run_coroutine_threadsafe(alt.shutdown(), app._loop).result(30)
    if alt_closed_s >= 5.0:
        raise AssertionError(f"the asyncio server took {alt_closed_s:.3f}s to close with an idle connection")
    total = sum(map(len, direct.values()))
    out = {"direct_tok_s": total / direct_wall, "tok_s": tok_s, "streams_differ": differ,
           "asyncio_sse_freed_s": sse_freed_s, "asyncio_closed_s": alt_closed_s,
           "codec": os.path.basename(codec.__file__), "seconds": time.perf_counter() - t_part}
    fmt = lambda xs: ", ".join(f"{x:.1f}" for x in xs)  # noqa: E731
    print(
        f"native gemma_2b on {dev['smi']}: the edge app on NativeHTTPServer ({out['codec']}); the burst of "
        f"{len(prompts)} concurrent POST /generate ({total} tokens) native {fmt(tok_s['native'])} tok/s (runs 1 and 4) "
        f"against asyncio {fmt(tok_s['asyncio'])} tok/s (runs 2 and 3), {out['direct_tok_s']:.1f} tok/s direct "
        f"in-process; streams leaving the direct ones at near-ties: native {differ['native']}, asyncio "
        f"{differ['asyncio']} (of {len(prompts)} each); asyncio SSE disconnect freed in {sse_freed_s:.3f}s; the "
        f"asyncio server closed in {alt_closed_s:.3f}s with an idle keep-alive connection; part {out['seconds']:.1f}s"
    )
    return out


PREFORK_WORKERS = 3
_PREFORK_CPU_APP = (
    "import os, sys\n"
    "from gofr_tpu_torch.app import App\n"
    "from gofr_tpu_torch.config import new_mock_config\n"
    "app = App(config=new_mock_config({{'APP_NAME': 'prefork', 'HTTP_PORT': '{port}', 'METRICS_PORT': '{mport}', "
    "'LOG_LEVEL': 'INFO', 'HTTP_WORKERS': '{workers}'}}))\n"
    "app.get('/pid', lambda ctx: {{'pid': os.getpid(), 'torch': 'torch' in sys.modules}})\n"
    "app.run()\n"
)
_PREFORK_MODEL_APP = (
    "import os, sys\n"
    "from gofr_tpu_torch.config import new_mock_config\n"
    "from gofr_tpu_torch.serve import build_app\n"
    "app = build_app(new_mock_config({{'APP_NAME': 'prefork-model', 'HTTP_PORT': '{port}', 'METRICS_PORT': '{mport}', "
    "'LOG_LEVEL': 'INFO', 'HTTP_WORKERS': '{workers}', 'GEMMA_PRESET': 'tiny', 'LLM_SLOTS': '2', "
    "'LLM_MAX_SEQ': '128'}}))\n"
    "app.get('/pid', lambda ctx: {{'pid': os.getpid(), 'torch': 'torch' in sys.modules}})\n"
    "app.run()\n"
)


def _prefork_run(template: str, log_path: str, want_pids: int, seconds: float, generate: bool) -> dict:
    """One app of ``template`` with HTTP_WORKERS=PREFORK_WORKERS in a
    process of its own (its log in ``log_path``): the pids that answer GET
    /pid on fresh connections (until ``want_pids`` answer, within
    ``seconds`` of the launch; then 20 more answers), with ``generate`` one
    POST /generate, then SIGTERM; every pid must be gone within 30 s."""
    port, mport = free_port(), free_port()
    root = str(Path(__file__).resolve().parent)
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", template.format(port=port, mport=mport, workers=PREFORK_WORKERS)],
                                cwd=root, env={**os.environ, "PYTHONPATH": root}, stdout=log, stderr=subprocess.STDOUT)
    t0 = time.perf_counter()
    pids: set = set()
    torch_seen: set = set()
    t_first = t_want = None
    try:
        while time.perf_counter() - t0 < seconds and len(pids) < want_pids:
            if proc.poll() is not None:
                raise AssertionError(f"prefork app exited with {proc.returncode}")
            try:
                got = _get_json(port, "/pid")
            except (OSError, AssertionError):
                time.sleep(0.1)
                continue
            t_first = t_first or time.perf_counter() - t0
            pids.add(got["pid"])
            torch_seen.add(got["torch"])
        t_want = time.perf_counter() - t0
        for _ in range(20):
            got = _get_json(port, "/pid")
            pids.add(got["pid"])
            torch_seen.add(got["torch"])
        gen = None
        if generate:
            status, raw, _, _, _ = _http(port, "POST", "/generate", {"tokens": [1, 2, 3], "max_new_tokens": 4},
                                         timeout=60)
            gen = (status, len(json.loads(raw)["data"]["tokens"]) if status == 201 else raw[:200])
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
            raise AssertionError("the prefork app did not exit within 30 s of SIGTERM") from None
    time.sleep(0.2)
    left = sorted(p for p in pids if _running(p))
    with open(log_path) as f:
        lines = [json.loads(ln) for ln in f if ln.startswith("{")]
    msgs = [ln["message"] for ln in lines if isinstance(ln.get("message"), str)]
    return {"pids": sorted(pids), "parent": proc.pid, "torch": sorted(torch_seen), "first_answer_s": t_first,
            "answered_s": t_want, "generate": gen, "left": left, "rc": proc.returncode,
            "forked": any(m.startswith("HTTP multi-worker") for m in msgs),
            "refused": [m for m in msgs if m.startswith("HTTP_WORKERS>1 ignored")]}


def _prefork_part(dev: dict) -> dict:
    """The prefork part (host processes; tests/test_torch_prefork.py on
    the card's machine): (1) a CPU-only App with HTTP_WORKERS=3 (no torch
    imported) answers from more than one pid within 15 s, and SIGTERM
    reaps every worker; (2) a model app (serve's app over a tiny engine on
    the card, torch imported) with HTTP_WORKERS=3 logs the refusal,
    answers from its one pid and serves a generate."""
    t_part = time.perf_counter()
    logs = tempfile.mkdtemp(prefix="gofr-prefork-")
    try:
        cpu = _prefork_run(_PREFORK_CPU_APP, os.path.join(logs, "cpu.log"), 2, 15.0, generate=False)
        if len(cpu["pids"]) < 2 or cpu["answered_s"] >= 15.0 or cpu["torch"] != [False] or not cpu["forked"]:
            raise AssertionError(f"prefork cpu app: {cpu}")
        if cpu["left"]:
            raise AssertionError(f"prefork cpu app: workers {cpu['left']} outlived SIGTERM")
        model = _prefork_run(_PREFORK_MODEL_APP, os.path.join(logs, "model.log"), 1, 240.0, generate=True)
        refusal = ("HTTP_WORKERS>1 ignored: torch already imported and device state does not survive fork — "
                   "use engine replicas to scale")
        if model["pids"] != [model["parent"]] or model["refused"] != [refusal] or model["forked"] \
                or model["torch"] != [True] or model["generate"] != (201, 4) or model["left"]:
            raise AssertionError(f"prefork model app: {model}")
    except BaseException:
        for name in sorted(os.listdir(logs)):
            with open(os.path.join(logs, name)) as f:
                print(f"--- prefork log {name} ---\n{f.read()[-4000:]}")
        raise
    finally:
        shutil.rmtree(logs, ignore_errors=True)
    out = {"cpu": cpu, "model": model, "seconds": time.perf_counter() - t_part}
    print(
        f"prefork on {dev['smi']}: a CPU-only App with HTTP_WORKERS={PREFORK_WORKERS} answered from pids "
        f"{cpu['pids']} (parent {cpu['parent']}), two within {cpu['answered_s']:.2f}s of its launch, every worker gone "
        f"after SIGTERM (exit {cpu['rc']}); the model app (tiny engine on the card) refused ({model['refused'][0]!r}), "
        f"answered from pid {model['pids']} only, first answer {model['first_answer_s']:.2f}s after its launch, "
        f"generate {model['generate']}; part {out['seconds']:.1f}s"
    )
    return out


def _datasources_part(dev: dict) -> dict:
    """The datasources part (host only), the port's three examples over
    sqlite files and the port's MiniRedis: (1) using-migrations, with Redis
    configured beside its database: the migration applied once (recorded
    in the gofr_migrations table and hash), its routes, /.well-known/health
    with sql and redis UP, and /metrics carrying app_sql_stats and
    app_redis_stats; a second start over the same file runs nothing; (2)
    using-add-rest-handlers: a CRUD round trip; (3)
    http-server-using-redis: set, get, a missing key and the pipeline."""
    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.examples import http_server_using_redis, using_add_rest_handlers, using_migrations
    from gofr_tpu_torch.testutil import MiniRedis

    t_part = time.perf_counter()
    mini = MiniRedis().start()
    tmp = tempfile.mkdtemp(prefix="gofr-ds-")
    base = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR"}
    redis_cfg = {"REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(mini.port)}

    def serving(mod, extra):
        app = mod.build_app(new_mock_config({**mod.DEFAULTS, **base, **extra}))
        return app, app.run_in_background()

    def call(app, method, path, body=None):
        status, raw, _, _, _ = _http(app.http_server.port, method, path, body, timeout=30)
        return status, json.loads(raw) if raw else None

    def expect(got, status, data=...):
        if got[0] != status or (data is not ... and (got[1] or {}).get("data") != data):
            raise AssertionError(f"datasources part: {got} where {status} {data!r} was expected")

    def stop(app, thread):
        app.shutdown()
        thread.join(timeout=30)

    checks = 0
    try:
        # 1. using-migrations, Redis beside the database
        mig_cfg = {**redis_cfg, "DB_NAME": os.path.join(tmp, "employee.db")}
        app, th = serving(using_migrations, mig_cfg)
        try:
            rows = app.container.sql.query("SELECT version, method FROM gofr_migrations")
            hashed = app.container.redis.execute_sync("HGETALL", "gofr_migrations")
            if rows != [{"version": 1708322067, "method": "UP"}] or hashed[:1] != [b"1708322067"]:
                raise AssertionError(f"migration records: table {rows}, hash {hashed}")
            expect(call(app, "GET", "/employee?name=Umang"), 200, {"id": 1, "name": "Umang", "gender": "M",
                                                                   "contact_number": "0987654321", "dob": None})
            emp = {"id": 2, "name": "Ada", "gender": "F", "contact_number": "123", "dob": "1815-12-10"}
            expect(call(app, "POST", "/employee", emp), 201, "successfully posted entity")
            expect(call(app, "GET", "/employee?name=Ada"), 200, emp)
            expect(call(app, "GET", "/employee"), 400)
            status, health = call(app, "GET", "/.well-known/health")
            ups = {k: health["data"][k]["status"] for k in ("sql", "redis")}
            if status != 200 or ups != {"sql": "UP", "redis": "UP"}:
                raise AssertionError(f"health: {status} {health}")
            series = {name: _series(app.metrics_server.port, name) for name in ("app_sql_stats_count",
                                                                                "app_redis_stats_count")}
            if not all(sum(v.values()) > 0 for v in series.values()):
                raise AssertionError(f"/metrics: {series}")
            checks += 7
        finally:
            stop(app, th)
        again = using_migrations.build_app(new_mock_config({**using_migrations.DEFAULTS, **base, **mig_cfg}))
        try:  # a re-run: the recorded version is skipped (a second insert of employee 1 would raise)
            rows = again.container.sql.query("SELECT version FROM gofr_migrations")
            people = again.container.sql.query("SELECT id FROM employee ORDER BY id")
            if rows != [{"version": 1708322067}] or people != [{"id": 1}, {"id": 2}]:
                raise AssertionError(f"migration re-run: {rows} {people}")
            checks += 1
        finally:
            again.container.close()

        # 2. using-add-rest-handlers: a CRUD round trip
        app, th = serving(using_add_rest_handlers, {"DB_NAME": os.path.join(tmp, "users.db")})
        try:
            user = {"id": 1, "name": "ada", "age": 36, "is_employed": True}
            expect(call(app, "GET", "/user"), 200, "user GetAll called")
            expect(call(app, "POST", "/user", user), 201, "User successfully created with id: 1")
            expect(call(app, "GET", "/user/1"), 200, {**user, "is_employed": 1})
            expect(call(app, "PUT", "/user/1", {"age": 37}), 200, "User successfully updated with id: 1")
            expect(call(app, "GET", "/user/1"), 200, {**user, "age": 37, "is_employed": 1})
            expect(call(app, "DELETE", "/user/1"), 204)
            expect(call(app, "GET", "/user/1"), 404)
            checks += 7
        finally:
            stop(app, th)

        # 3. http-server-using-redis
        app, th = serving(http_server_using_redis, redis_cfg)
        try:
            expect(call(app, "POST", "/redis", {"greeting": "hello", "card": "h100"}), 201, "Successful")
            expect(call(app, "GET", "/redis/greeting"), 200, {"greeting": "hello"})
            expect(call(app, "GET", "/redis/card"), 200, {"card": "h100"})
            expect(call(app, "GET", "/redis/absent-key"), 404)
            expect(call(app, "GET", "/redis-pipeline"), 200, {"values": ["one", "two"]})
            ttl = app.container.redis.execute_sync("TTL", "greeting")
            if not 0 < ttl <= 300:
                raise AssertionError(f"redis expiry: TTL {ttl}")
            checks += 6
        finally:
            stop(app, th)
    finally:
        mini.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"checks": checks, "seconds": time.perf_counter() - t_part}
    print(f"datasources on {dev['smi']}: the using-migrations, using-add-rest-handlers and http-server-using-redis "
          f"examples over sqlite files and MiniRedis, {checks} checks passed (migration once and a no-op re-run, "
          f"health sql and redis UP, app_sql_stats and app_redis_stats scraped, a CRUD round trip, Redis set, get "
          f"and pipeline); part {out['seconds']:.1f}s")
    return out


def _series(port: int, name: str) -> dict:
    """One series of an app's metrics server, scraped over HTTP."""
    status, raw, _, _, _ = _http(port, "GET", "/metrics", timeout=30)
    if status != 200:
        raise AssertionError(f"scrape of :{port}/metrics: {status}")
    return _metric_lines(raw.decode(), name)


def _cli(app, argv: list) -> tuple[int, str]:
    """Run a CMDApp with ``argv``; -> (exit code, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = app.run(argv)
    return rc, buf.getvalue()


def _gateway(dev: dict, model_app, cfg, params, prompts, direct: dict, new_tokens: int, chat: dict, content: str,
             direct_stats: dict) -> dict:
    """The gateway part: ``build_gateway`` in front of the edge phase's
    model app (Gemma-2B, full width and depth), in the same process.
    Checks, each raising: (1) auth: no credentials and a wrong password
    answer 401 with the framework's body, health needs none; (2) the burst
    as concurrent authenticated POST /ask/gemma: 201, every token through
    the replay gate, each stream equal to the direct /generate stream of
    the same prompt or leaving it only at a near-tie, both kernels
    launched during the burst; (3) the chat request streamed through POST
    /ask/gemma/stream joins to the plain answer's content; (4) /ask/down
    answers 503 twice (unreachable), then 503 CircuitOpenError at once,
    while /ask/gemma keeps serving; (5) both apps' metrics servers,
    scraped over HTTP, count the forwarded requests (the gateway's
    app_http_service_response, the model app's app_http_response by
    template); (6) ``new_cmd()``'s ``replay -id`` of a burst record
    reports token-identical (or a divergence at a near-tie) and ``replay
    -bundle`` lists a bundle's records."""
    from gofr_tpu_torch import new_cmd
    from gofr_tpu_torch.config import new_mock_config

    t_part = time.perf_counter()
    eng = model_app.container.tpu().llm("gemma")
    mport, mmetrics = model_app.http_server.port, model_app.metrics_server.port
    gw = build_gateway(f"http://127.0.0.1:{mport}", f"http://127.0.0.1:{free_port()}")
    thread = gw.run_in_background()
    port, gmetrics = gw.http_server.port, gw.metrics_server.port
    auth = basic_auth()
    small = {"tokens": prompts[0], "max_new_tokens": 8}
    forwarded = 0
    try:
        # 1. auth
        unauthorized = b'{"error":{"message":"Unauthorized"}}'
        for hdrs in ({}, basic_auth(password="wrong")):
            status, raw, _, _, _ = _http(port, "POST", "/ask/gemma", small, hdrs)
            if status != 401 or raw != unauthorized:
                raise AssertionError(f"gateway auth {sorted(hdrs)}: {status} {raw[:200]!r}")
        status, raw, _, _, _ = _http(port, "GET", "/.well-known/health")
        health = json.loads(raw)["data"] if status == 200 else {}
        if health.get("gemma", {}).get("status") != "UP" or health.get("down", {}).get("status") != "DOWN":
            raise AssertionError(f"gateway health without credentials: {status} {raw[:300]!r}")

        # 2. the burst through the gateway
        series = 'app_http_response_count'
        model0 = _series(mmetrics, series).get('{method="POST",path="/generate",status="201"}', 0.0)
        answers: dict = {}
        errors: list = []

        def client(i):
            try:
                answers[i] = _http(port, "POST", "/ask/gemma", {"tokens": prompts[i], "max_new_tokens": new_tokens},
                                   auth)
            except BaseException as e:  # surfaced below, after every client joined
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        l0 = (A.flash_attention.launches, A.paged_decode_partials.launches)
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = {"flash_attention": A.flash_attention.launches - l0[0],
                    "paged_decode_partials": A.paged_decode_partials.launches - l0[1]}
        if errors:
            raise errors[0]
        if len(answers) != len(prompts):
            raise TimeoutError(f"{len(answers)} of {len(prompts)} gateway clients finished")
        results = {}
        for i, (status, raw, _, _, _) in sorted(answers.items()):
            toks = json.loads(raw)["data"]["tokens"] if status == 201 else None
            if toks is None or len(toks) != new_tokens:
                raise AssertionError(f"gateway request {i} (prompt {len(prompts[i])}): {status} {raw[:200]!r}")
            results[i] = toks
        forwarded += len(results)
        checked, exempt = _replay_gate(params, cfg, prompts, results, TOKEN_GAP, label="gateway ", verbose=False)
        differ = _divergence_at_near_ties(params, cfg, prompts, results, direct, TOKEN_GAP, "gateway ")
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{name} was not launched during the gateway's burst: {launches}")
        total = sum(len(t) for t in results.values())
        first = sorted(a[2] for a in answers.values())

        # 3. the chat request streamed through the gateway
        status, raw, gw_first, _, _ = _http(port, "POST", "/ask/gemma/stream", {**chat, "stream": True}, auth)
        if status != 200:
            raise AssertionError(f"gateway SSE: {status} {raw[:300]!r}")
        joined = "".join(e["choices"][0]["delta"].get("content", "") for e in _sse_events(raw))
        if joined != content:
            raise AssertionError(f"gateway SSE deltas {joined!r} differ from the plain answer {content!r}")

        # 4. the breaker of the service nothing listens on
        t0 = time.perf_counter()
        downs = [_http(port, "POST", "/ask/down", small, auth) for _ in range(3)]
        open_s = time.perf_counter() - t0
        msgs = [json.loads(d[1])["error"]["message"] if d[0] == 503 else f"status {d[0]}" for d in downs]
        if (msgs[:2] != ["service down unreachable"] * 2 or not msgs[2].startswith("circuit breaker open for")
                or open_s > 5.0):
            raise AssertionError(f"gateway breaker: {msgs} in {open_s:.3f}s")
        status, raw, _, _, _ = _http(port, "POST", "/ask/gemma", small, auth)
        if status != 201 or len(json.loads(raw)["data"]["tokens"]) != 8:
            raise AssertionError(f"gemma while down's breaker is open: {status} {raw[:200]!r}")
        forwarded += 1

        # 5. both metrics servers, over HTTP
        svc_count = _series(gmetrics, "app_http_service_response_count")
        fwd = svc_count.get('{method="POST",path="generate",status="201"}', 0.0)
        model1 = _series(mmetrics, series).get('{method="POST",path="/generate",status="201"}', 0.0)
        refused = _series(gmetrics, series).get('{method="POST",path="/ask/{svc}",status="401"}', 0.0)
        if fwd != forwarded or model1 - model0 != forwarded or refused != 2:
            raise AssertionError(f"gateway metrics: service {fwd}, model app {model1 - model0}, 401s {refused}; "
                                 f"forwarded {forwarded}")

        # 6. the CLI: replay a burst record, list a bundle
        cli = new_cmd(config=new_mock_config({"LOG_LEVEL": "ERROR"}))
        rec = next((r for r in eng.flightrec.records(final=True) if r.get("prompt_token_ids") == prompts[3]), None)
        if rec is None:
            raise AssertionError("gateway: no final flight record of the burst")
        rc, said = _cli(cli, ["replay", f"-id={rec['id']}", f"-url=http://127.0.0.1:{mport}", "-model=gemma"])
        m = re.search(r"DIVERGED at token index (\d+)", said)
        if rc != 0 or ("token-identical" not in said and m is None):
            raise AssertionError(f"gateway CLI replay: exit {rc}: {said!r}")
        if m is not None:  # a divergence must sit at a near-tie of the recorded stream
            k = int(m.group(1))
            emitted = list(rec["emitted_token_ids"])
            _divergence_at_near_ties(params, cfg, [list(rec["prompt_token_ids"])], [emitted[:k] + [-1]], [emitted],
                                     TOKEN_GAP, "gateway replay ")
        path = eng._incident("manual_check", reason="gateway: a bundle for the CLI")
        if path is None:
            raise AssertionError("gateway: no bundle written")
        rc, listed = _cli(cli, ["replay", f"-bundle={path}"])
        n_records = _bundle(path, "gateway ")["manifest"]["flight_records"]
        if rc != 0 or not listed.startswith(f"{n_records} flight record(s) in {path}:") or n_records < 1 \
                or len(listed.strip().splitlines()) != n_records + 1:
            raise AssertionError(f"gateway CLI bundle listing: exit {rc}: {listed[:300]!r}")
    finally:
        gw.shutdown()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("gateway did not stop")
    out = {
        "requests": len(results), "tokens": total, "wall_s": wall, "tok_s": total / wall,
        "ttft_p50_s": first[len(first) // 2], "ttft_max_s": first[-1], "sse_first_byte_s": gw_first,
        "direct_tok_s": direct_stats["tok_s"], "direct_ttft_p50_s": direct_stats["ttft_p50_s"],
        "direct_sse_first_byte_s": direct_stats["sse_first_byte_s"], "breaker_open_s": open_s,
        "streams_differ": differ, "tokens_matched": checked, "tokens_exempt": exempt, "launches": launches,
        "forwarded": forwarded, "replay": said.strip(), "bundle_records": n_records,
        "seconds": time.perf_counter() - t_part,
    }
    print(
        f"gateway gemma_2b on {dev['smi']}: {out['requests']} concurrent authenticated POST /ask/gemma through the "
        f"gateway's async client, {total} tokens in {wall:.3f}s = {out['tok_s']:.1f} tok/s against "
        f"{out['direct_tok_s']:.1f} tok/s direct; client ttft (first response byte) p50 {out['ttft_p50_s']:.3f}s "
        f"against {out['direct_ttft_p50_s']:.3f}s direct; SSE first byte {gw_first:.3f}s through the gateway, "
        f"{out['direct_sse_first_byte_s']:.3f}s direct; {checked} tokens matched, {exempt} exempt, {differ} streams "
        f"leave the direct ones at near-ties; breaker open after 2 failures in {open_s:.3f}s; forwarded "
        f"{forwarded}; burst launches {launches}; CLI: {out['replay']}; bundle of {n_records} records listed; "
        f"part {out['seconds']:.1f}s"
    )
    return out


# The families phase: the JAX package's other dense presets at their
# published widths and 4 of their published layers (half their depths
# until the knobs and mnist phases took their time, a quarter until the
# fleet phase took its; the moe phase's came out of this phase's before), random weights from the seed (the untied
# families with a random lm_head, as they are published), one model at a
# time on the card.
FAMILY_MODELS = ("llama3_8b", "mistral_7b", "qwen2_7b", "gemma_7b")
FAMILY_LAYERS = {"llama3_8b": 4, "mistral_7b": 4, "qwen2_7b": 4, "gemma_7b": 4}
FAMILY_UNTIED = ("llama3_8b", "mistral_7b", "qwen2_7b")
WINDOW_SLOTS, WINDOW_SEQ, WINDOW_NEW = 4, 4608, 64  # Mistral's windowed engine
WINDOW_PROMPTS = (4160, 4240, 4320, 4400)  # every decode band starts above 0
KERNEL_COUNTERS = ("flash_attention", "flash_attention_prompt", "paged_decode_partials", "paged_decode_partials_int8")


def family_weights(name: str, seed: int) -> tuple[TransformerConfig, dict]:
    cfg = dataclasses.replace(getattr(TransformerConfig, name)(), n_layers=FAMILY_LAYERS[name])
    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(cfg, g, "cuda")
    if name in FAMILY_UNTIED:
        head = torch.randn((cfg.vocab_size, cfg.d_model), generator=g, device="cuda") / math.sqrt(cfg.d_model)
        params["unembed"] = head.to(cfg.dtype)
        del head
    torch.cuda.synchronize()
    nbytes = _tensor_bytes(params)
    print(f"families {name} ({cfg.n_layers} layers): {nbytes / 2e9:.3f} B params bf16 ({nbytes} bytes, "
          f"{'untied' if 'unembed' in params else 'tied'}) in {time.perf_counter() - t0:.1f}s")
    return cfg, params


def _family_kernels(dev: dict, name: str, cfg: TransformerConfig, seed: int) -> None:
    """Each kernel of the path against its plain version at this model's
    (hq, hkv, hd), then timed as the kernels phase times it: flash
    q_offsets at q [8, 64, hq, hd] against k/v [8, 512, hkv, hd]; paged
    decode at q [32, hq, hd] through [32, 32] tables over 1024 16-row
    blocks (over int8 pools too for llama3_8b); for mistral_7b also its
    window at full width: a 64-query chunk at offsets ~4,200 against
    [4, 4608] keys, and the band [hi - 4096, hi) through [4, 288] tables.
    Prints each row; raises on a disagreement."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    peaks = dev["peaks"]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = hd ** -0.5

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def flash_case(label, b, c, sk, offs, window):
        q, k, v = rnd(b, c, hq, hd), rnd(b, sk, hkv, hd), rnd(b, sk, hkv, hd)
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        kw = dict(q_offsets=off, window=window)
        got = A.flash_attention(q, k, v, **kw)
        want = A.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), atol=BF16_ATOL, rtol=BF16_RTOL):
            raise AssertionError(f"families {label}: flash_attention disagrees with its plain version ({err:.3e})")
        nbytes, flops, mask = _flash_work(q, k, off, True, window)
        bound_ms, bound_by = _bound(nbytes, flops, torch.bfloat16, peaks)
        qt, kt, vt, amask = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask[:, None]
        t = {
            "ms": time_ms(lambda: A.flash_attention(q, k, v, **kw)),
            "device_ms": device_ms(lambda: A.flash_attention(q, k, v, **kw), "flash_mma_kernel"),
            "plain_ms": time_ms(lambda: A.flash_attention_plain(q, k, v, **kw)),
            "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=amask, scale=scale, enable_gqa=True)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print(f"families timing {label} q {list(q.shape)} k/v {list(k.shape)}: max_abs_err {err:.3e} ok; kernel "
              f"{t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, sdpa "
              f"{t['library_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")

    def paged_case(label, b, MB, lengths, band, int8=False):
        NB, B = b * MB, 16
        q = rnd(b, hq, hd)
        if int8:
            kp, ks = quantize_rows(rnd(NB, B, hkv, hd, dtype=torch.float32))
            vp, vs = quantize_rows(rnd(NB, B, hkv, hd, dtype=torch.float32))
            sc = dict(k_scales=ks, v_scales=vs)
        else:
            kp, vp, sc = rnd(NB, B, hkv, hd), rnd(NB, B, hkv, hd), {}
        tables = torch.randperm(NB, generator=g, device="cuda")[: b * MB].reshape(b, MB).to(torch.int32)
        hi = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        lo = torch.clamp(hi - band, min=0).to(torch.int32) if band else torch.zeros_like(hi)
        kw = dict(scale=scale, **sc)
        o1, m1, l1 = A.paged_decode_partials(q, kp, vp, tables, lo, hi, **kw)
        o2, m2, l2 = A.paged_decode_partials_plain(q, kp, vp, tables, lo, hi, **kw)
        torch.cuda.synchronize()
        err = (o1 - o2).abs().max().item()
        if not (err <= F32_ATOL and torch.allclose(m1, m2, rtol=ML_RTOL, atol=0.0)
                and torch.allclose(l1, l2, rtol=ML_RTOL, atol=0.0)):
            raise AssertionError(f"families {label}: paged_decode_partials disagrees with its plain version ({err:.3e})")
        rows_n = int((hi - lo).sum())
        slots = int(((hi + B - 1) // B - lo // B).clamp(min=0).sum())
        elem = 1 if int8 else 2
        nbytes = (q.numel() * 2 + 2 * rows_n * hkv * hd * elem + (2 * rows_n * hkv * 4 if int8 else 0)
                  + slots * 4 + 2 * b * 4 + (b * hq * hd + 2 * b * hq) * 4)
        bound_ms, bound_by = _bound(nbytes, 4 * hd * hq * rows_n, torch.float32 if int8 else torch.bfloat16, peaks)
        t = {
            "ms": time_ms(lambda: A.paged_decode_partials(q, kp, vp, tables, lo, hi, **kw)),
            "device_ms": device_ms(lambda: A.paged_decode_partials(q, kp, vp, tables, lo, hi, **kw),
                                   "paged_decode_kernel"),
            "plain_ms": time_ms(lambda: A.paged_decode_partials_plain(q, kp, vp, tables, lo, hi, **kw)),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print(f"families timing {label} q {list(q.shape)} pools {list(kp.shape)} {str(kp.dtype)[6:]} tables "
              f"{list(tables.shape)}, {rows_n} band rows: o max_abs_err {err:.3e} ok; kernel {t['ms']:.4f} ms "
              f"(device {t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")

    for pool in (torch.bfloat16, torch.int8):
        splits, smem = A.paged_decode_plan(pool, 32, hq, hkv, hd, 16, 32)
        print(f"families {name}: paged_decode plan, {str(pool)[6:]} pools, 32 slots, {hq}/{hkv} heads (group "
              f"{hq // hkv}), head_dim {hd}: {splits} splits ({32 * hkv * splits} CTAs), {smem} bytes of shared "
              f"memory per CTA")
    lengths = [0, 1, 16, 511, 17, 33, 64, 100] + [(37 * i) % 500 + 2 for i in range(24)]
    flash_case(f"{name} flash c64", 8, 64, 512, [0, 37, 64, 100, 255, 400, 448, 1], 0)
    paged_case(f"{name} paged", 32, 32, lengths, 0)
    if name == "llama3_8b":
        paged_case(f"{name} paged int8", 32, 32, lengths, 0, int8=True)
    if cfg.sliding_window:
        w = cfg.sliding_window
        flash_case(f"{name} flash window", 4, 64, WINDOW_SEQ, [4100, 4200, 4300, 4500], w)
        paged_case(f"{name} paged window", 4, WINDOW_SEQ // 16, [4200, 4400, 4500, 4608], w)


def _family_engine(dev: dict, label: str, cfg, params, seed: int, lookaheads, gap: float, **kw) -> dict:
    """One engine over a family's weights at the engine defaults (plus
    ``kw``): its warmup and families checked, the burst at each of
    ``lookaheads``, every token through the replay gate
    (against the engine's own params: int8 when it quantized them; at most
    1 in 8 exempt at the int8 gap)."""
    clock = {}
    t0 = time.perf_counter()
    eng = LLMEngine(cfg, params, seed=seed, **kw)
    try:
        warm = _warm_report(f"{label} ", eng)
        clock["engine"] = time.perf_counter() - t0
        _check_families(f"{label} ", eng, seed)
        clock["families"] = time.perf_counter() - t0 - sum(clock.values())
        eng.generate([1, 2, 3], max_new_tokens=4)
        _plens, prompts = _burst_prompts(cfg, seed)
        runs = _bursts(f"{label} ", eng, prompts, 32, KERNEL_COUNTERS, lookaheads)
        clock["bursts"] = time.perf_counter() - t0 - sum(clock.values())
        gate_params = eng.params
        drift = (_int8_path_drift(cfg, gate_params, prompts[6], eng.kv.capacity, eng.kv.block) if eng.pool_scales is not None
                 else _chunked_drift(gate_params, cfg, prompts[6], eng.kv.capacity))
    finally:
        eng.close()
        del eng
        gc.collect()
    checked = exempt = 0
    stats: dict = {}
    for i, r in enumerate(runs):
        st: dict = {}
        c, e = _replay_gate(gate_params, cfg, prompts, r["results"], gap,
                            label=f"{label} burst {i + 1} (lookahead {r['lookahead']}) ", verbose=False, stats=st)
        # at the int8 gap, at most 1 token in 8 may need more than the bf16
        # gap: positions whose plain top-2 gap is below TOKEN_GAP are exempt
        # at the bf16 gate already, and an untied random model has many
        wide = sum(x >= TOKEN_GAP for x in st.get("exempt_gaps", []))
        if gap == INT8_TOKEN_GAP and 8 * wide > r["tokens"]:
            raise AssertionError(f"{label}: {wide} of {r['tokens']} tokens needed the int8 gap exemption (> 1 in 8)")
        checked, exempt = checked + c, exempt + e
        stats["near"] = stats.get("near", 0) + st.get("near", 0)
        stats["wide"] = stats.get("wide", 0) + wide
    del gate_params
    clock["gate"] = time.perf_counter() - t0 - sum(clock.values())
    first = runs[0]
    out = {
        "tok_s": [r["tok_s"] for r in runs], "ttft_p50_s": [r["ttft_p50_s"] for r in runs],
        "ttft_max_s": [r["ttft_max_s"] for r in runs], "programs": [r["chunks"] for r in runs],
        "steps": [r["steps"] for r in runs], "launches": first["launches"], "warmup_s": warm["warmup_s"],
        "reserved_growth": warm["reserved_after"] - warm["reserved_before"], "tokens_matched": checked, "tokens_exempt": exempt, "drift": drift,
        "near_ties": stats["near"], "exempt_past_bf16_gap": stats["wide"], "seconds": clock,
    }
    print(f"families {label} on {dev['smi']}: tok/s {', '.join(f'{x:.1f}' for x in out['tok_s'])} (lookahead "
          f"{', '.join(str(r['lookahead']) for r in runs)}); ttft p50 {first['ttft_p50_s']:.3f}s max "
          f"{first['ttft_max_s']:.3f}s; programs {out['programs']} (unified steps {out['steps']}); warmup_s "
          f"{warm['warmup_s']:.3f}; memory_reserved +{out['reserved_growth']}; "
          f"logit drift {drift:.4f}; {checked} tokens matched, {exempt} exempt (gap {gap}; {stats['wide']} with "
          f"a gap >= {TOKEN_GAP}; {stats['near']} of {checked + exempt} positions have a plain top-2 gap < "
          f"{TOKEN_GAP}); launches in burst 1 {first['launches']}; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in clock.items()))
    return out


def _family_window(dev: dict, cfg, params, seed: int) -> dict:
    """Mistral-7B's window at full width: an engine of 4 slots at
    max_seq_len 4608 serves 4 prompts of 4,160-4,400 tokens, 64 new tokens
    each, so every prefill chunk past position 4096 cuts its keys by the
    window and every decode band starts above 0 (read back from the
    pool's lengths); every token through the replay gate against the
    plain forward with the window mask."""
    label = "mistral_7b window"
    w = cfg.sliding_window
    t0 = time.perf_counter()
    # the paged pool: "auto" would give this windowed model the ring
    # (4096 + 64 < 4608), which the contiguous phase drives
    eng = LLMEngine(cfg, params, seed=seed, slots=WINDOW_SLOTS, max_seq_len=WINDOW_SEQ, kv_paged=True)
    try:
        warm = _warm_report(f"{label} ", eng)
        _check_families(f"{label} ", eng, seed)
        rng = np.random.default_rng(seed + 7)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in WINDOW_PROMPTS]
        torch.cuda.reset_peak_memory_stats()
        _zero_launches(KERNEL_COUNTERS)
        st0 = eng.stats()
        results, reqs, wall = _serve(eng, prompts, WINDOW_NEW)
        launches = _launches(KERNEL_COUNTERS)
        st = eng.stats()
        lengths = eng.pool.length.cpu().tolist()
        peak = torch.cuda.max_memory_reserved()
    finally:
        eng.close()
        del eng
        gc.collect()
    ends = sorted(len(p) + WINDOW_NEW for p in prompts)
    served = sorted(x for x in lengths if x > 0)
    # the last decode step of a request reads the band [hi - w + 1, hi) with
    # hi its final length minus one: above 0 when the length passes w
    if served != ends or min(served) <= w:
        raise AssertionError(f"{label}: pool lengths {lengths}, expected {ends} past the window {w}")
    t_served = time.perf_counter() - t0
    checked, exempt = _replay_gate(params, cfg, prompts, results, TOKEN_GAP, label=f"{label} ", verbose=False)
    t_gate = time.perf_counter() - t0 - t_served
    ttfts = sorted(reqs[i].first_token_at - reqs[i].submitted_at for i in reqs)
    total = sum(len(t) for t in results.values())
    out = {"tok_s": total / wall, "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1],
           "steps": st["steps"] - st0["steps"], "programs": st["chunks"] - st0["chunks"], "launches": launches,
           "warmup_s": warm["warmup_s"], "reserved_growth": warm["reserved_after"] - warm["reserved_before"],
           "peak_reserved": peak, "min_lo": min(served) - w, "tokens_matched": checked, "tokens_exempt": exempt}
    print(f"families {label} on {dev['smi']}: {len(prompts)} prompts of {list(WINDOW_PROMPTS)} tokens x "
          f"{WINDOW_NEW}: {out['tok_s']:.1f} tok/s, ttft p50 {out['ttft_p50_s']:.3f}s max {out['ttft_max_s']:.3f}s; "
          f"{out['programs']} programs ({out['steps']} unified steps); final lengths {lengths}: the last decode "
          f"bands start at {min(served) - w} or later (> 0); warmup_s {warm['warmup_s']:.3f}; memory_reserved "
          f"+{out['reserved_growth']} at warmup, peak {peak} in the burst; {checked} tokens matched, {exempt} "
          f"exempt; launches {launches}; seconds: engine and burst {t_served:.1f}, gate {t_gate:.1f}")
    return out


def _write_safetensors(path: str, tensors: dict) -> None:
    """The safetensors format, written here: an 8-byte little-endian header
    length, the JSON header (padded to 8 bytes), the raw tensor bytes."""
    names = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            f.write(memoryview(t.contiguous().cpu().view(torch.uint8).numpy().reshape(-1)))


def _checkpoint_round_trip(dev: dict, seed: int) -> dict:
    """A 2-layer Llama-3-8B-shaped HF checkpoint in bf16 (untied lm_head;
    two shards and model.safetensors.index.json; ~3 GB) written to a
    temporary directory, loaded with load_llama_checkpoint into cuda, every
    leaf held bitwise against its source tensor; the directory deleted."""
    cfg = dataclasses.replace(TransformerConfig.llama3_8b(), n_layers=2)
    d, hd, hq, hkv, ff, V = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.02).to(torch.bfloat16)

    src = {"model.embed_tokens.weight": r(V, d)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        src.update({
            p + "self_attn.q_proj.weight": r(hq * hd, d), p + "self_attn.k_proj.weight": r(hkv * hd, d),
            p + "self_attn.v_proj.weight": r(hkv * hd, d), p + "self_attn.o_proj.weight": r(d, hq * hd),
            p + "mlp.gate_proj.weight": r(ff, d), p + "mlp.up_proj.weight": r(ff, d),
            p + "mlp.down_proj.weight": r(d, ff),
            p + "input_layernorm.weight": 1 + r(d), p + "post_attention_layernorm.weight": 1 + r(d),
        })
    src["model.norm.weight"] = 1 + r(d)
    src["lm_head.weight"] = r(V, d)
    total = sum(t.numel() * t.element_size() for t in src.values())
    names = list(src)
    shards = {"model-00001-of-00002.safetensors": names[: len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2 :]}
    tmp = tempfile.mkdtemp(prefix="gofr_ckpt_")
    try:
        t0 = time.perf_counter()
        for fname, keys in shards.items():
            _write_safetensors(os.path.join(tmp, fname), {k: src[k] for k in keys})
        with open(os.path.join(tmp, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": {k: fn for fn, ks in shards.items() for k in ks}}, f)
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = load_llama_checkpoint(tmp, cfg, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    validate_params(params, cfg)

    def bits(t):
        return t.contiguous().view(torch.int16)

    def norm(t):  # HF's scale minus 1, rounded to bf16 as the loader stores it
        return (t.float() - 1.0).to(torch.bfloat16)

    want = {"embed": src["model.embed_tokens.weight"], "unembed": src["lm_head.weight"],
            "final_norm": norm(src["model.norm.weight"])}
    lay = params["layers"]
    got = {"embed": params["embed"], "unembed": params["unembed"], "final_norm": params["final_norm"]}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        for leaf, hf in (("wq", "self_attn.q_proj"), ("wo", "self_attn.o_proj"), ("w_gate", "mlp.gate_proj"),
                         ("w_up", "mlp.up_proj"), ("w_down", "mlp.down_proj")):
            got[f"{leaf}[{i}]"], want[f"{leaf}[{i}]"] = lay[leaf][i], src[p + hf + ".weight"].T
        kv = lay["wkv"][i].view(d, hkv, 2, hd)
        for j, hf in enumerate(("self_attn.k_proj", "self_attn.v_proj")):
            got[f"wkv[{i}][{hf}]"] = kv[:, :, j]
            want[f"wkv[{i}][{hf}]"] = src[p + hf + ".weight"].T.reshape(d, hkv, hd)
        for leaf, hf in (("attn_norm", "input_layernorm"), ("mlp_norm", "post_attention_layernorm")):
            got[f"{leaf}[{i}]"], want[f"{leaf}[{i}]"] = lay[leaf][i], norm(src[p + hf + ".weight"])
    bad = [k for k in want if got[k].dtype != torch.bfloat16 or not torch.equal(bits(got[k]), bits(want[k]))]
    if bad:
        raise AssertionError(f"checkpoint round trip: leaves differ from their source: {bad}")
    print(f"families checkpoint: 2-layer llama3_8b-shaped bf16 HF checkpoint, {len(src)} tensors in 2 shards + "
          f"index, {total} bytes: written in {write_s:.2f}s, loaded into cuda in {load_s:.3f}s "
          f"({total / load_s / 1e9:.2f} GB/s); {len(want)} leaves bitwise equal to their sources; directory removed")
    return {"bytes": total, "load_s": load_s, "gb_s": total / load_s / 1e9, "leaves": len(want)}


def phase_families(dev: dict, seed: int) -> dict:
    """The families phase (see the module docstring): for each model its
    engines; weights, engines and graphs freed before the next model (the
    kernels at its shapes ran in the kernels phase). Returns each engine
    run's readings and its kernel launches by run label."""
    out = {"runs": {}, "launches": {}}
    for name in FAMILY_MODELS:
        t0 = time.perf_counter()
        cfg, params = family_weights(name, seed)
        out["runs"][name] = _family_engine(dev, name, cfg, params, seed, (3,), TOKEN_GAP)
        if name == "llama3_8b":
            out["runs"][f"{name} int8"] = _family_engine(
                dev, f"{name} int8", cfg, params, seed, (3,), INT8_TOKEN_GAP, kv_int8=True, quantize=True,
            )
        if cfg.sliding_window:
            out["runs"]["mistral_7b window"] = _family_window(dev, cfg, params, seed)
        del params
        gc.collect()  # a closed engine sits in reference cycles until collected
        torch.cuda.empty_cache()
        print(f"families {name}: {time.perf_counter() - t0:.1f}s; memory_reserved {torch.cuda.memory_reserved()} "
              f"after freeing it")
    for label, run in out["runs"].items():
        n = run["launches"]
        int8 = label.endswith("int8")
        out["launches"][label] = n
        if n["flash_attention"] <= 0 or (n["paged_decode_partials_int8"] if int8 else n["paged_decode_partials"]) <= 0 \
                or (n["paged_decode_partials"] if int8 else n["paged_decode_partials_int8"]):
            raise AssertionError(f"families {label}: kernel launches {n}")
    out["checkpoint"] = _checkpoint_round_trip(dev, seed)
    return out


# The moe phase: Mixtral-8x7B's widths (mistralai/Mixtral-8x7B-v0.1's
# config.json: 8 local experts, 2 per token, rope theta 1e6, no sliding
# window; Mistral-7B's attention and a 14,336-wide expert MLP) at 4 of
# its 32 layers: the bf16 weights of all 32 (~93 GB) do not fit the
# card's 80 GB, 16 (~47 GB) ran until the knobs and mnist phases took
# their time, and 8 until the fleet phase took its. The routing is the JAX package's (top-2 of a full softmax,
# not renormalised; capacity factor 1.25, drops past it), not Mixtral's.
MOE_LAYERS = 4
MOE_FIELDS = {
    "vocab_size": 32_000, "d_model": 4096, "n_layers": MOE_LAYERS, "n_heads": 32, "n_kv_heads": 8,
    "head_dim": 128, "d_ff": 14_336, "rope_theta": 1e6, "norm_eps": 1e-5, "act": "silu",
    "scale_embed": False, "sliding_window": 0, "qkv_bias": False, "n_experts": 8, "moe_top_k": 2,
    "moe_capacity": 1.25, "dtype": torch.bfloat16,
}
# The plain forward of one prompt routes other rows than the served
# programs, so at a capacity that drops it drops other pairs: the replay
# gate runs on an engine at n_experts / moe_top_k, where C = T and nothing
# drops in either
MOE_GATE_CAPACITY = 4.0
MOE_INT8_REQUESTS, MOE_INT8_NEW = 4, 16


def moe_config() -> TransformerConfig:
    return dataclasses.replace(TransformerConfig.mistral_7b(), sliding_window=0, rope_theta=1e6, n_experts=8,
                               moe_top_k=2, n_layers=MOE_LAYERS)


def moe_weights(seed: int) -> tuple[TransformerConfig, dict]:
    """The config, checked field by field against MOE_FIELDS, and its
    random bf16 weights with an untied head, drawn from ``seed`` on the
    card."""
    cfg = moe_config()
    got = {f: getattr(cfg, f) for f in MOE_FIELDS}
    if got != MOE_FIELDS:
        raise AssertionError(f"moe config {got} != {MOE_FIELDS}")
    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(cfg, g, "cuda")
    head = torch.randn((cfg.vocab_size, cfg.d_model), generator=g, device="cuda") / math.sqrt(cfg.d_model)
    params["unembed"] = head.to(cfg.dtype)
    del head
    torch.cuda.synchronize()
    lay = params["layers"]
    n = sum(t.numel() for t in (params["embed"], params["unembed"], params["final_norm"], *lay.values()))
    experts = sum(lay[k].numel() for k in ("w_gate", "w_up", "w_down"))
    nbytes = _tensor_bytes(params)
    print(f"moe weights: Mixtral-8x7B widths at {cfg.n_layers} of 32 layers ({cfg.n_experts} experts, top "
          f"{cfg.moe_top_k}, capacity {cfg.moe_capacity}): {n / 1e9:.3f} B params ({experts / 1e9:.3f} B in "
          f"expert stacks), {nbytes} bytes bf16, drawn in {time.perf_counter() - t0:.1f}s; config fields "
          f"equal the script's constants")
    return cfg, params


def _moe_gate(params, cfg, prompts, results, gap: float, label: str) -> tuple[int, int, int, list]:
    """_replay_gate, recording the rows that enter each layer's MoE FFN in
    the plain forwards (the served streams' own hidden states). Returns
    (matched, exempt, exempt with a gap >= TOKEN_GAP, [layer][stream] rows)."""
    rec = []
    served = T.moe_mlp

    def recording(x, *a, **kw):
        rec.append(x)
        return served(x, *a, **kw)

    st: dict = {}
    T.moe_mlp = recording
    try:
        c, e = _replay_gate(params, cfg, prompts, results, gap, label=label, verbose=False, stats=st)
    finally:
        T.moe_mlp = served
    L = cfg.n_layers
    rows = [[rec[i * L + layer] for i in range(len(prompts))] for layer in range(L)]
    return c, e, sum(x >= TOKEN_GAP for x in st.get("exempt_gaps", [])), rows


def _moe_ffn_cases(dev: dict, cfg, params, rows, prompts) -> dict:
    """The MoE FFN alone at decode T = 32 (4 served positions of each of
    the 8 streams) and prefill T = 256 (the first 256 rows of the 440-token
    prompt): the share of (row, slot) pairs past capacity at every layer,
    and at layer 0 the served form against the plain form (2e-2), its time
    from Python (CUDA events) and on the device (profiler, every kernel of
    one call), the plain form's time, and the bound: the touched experts'
    bytes read once, the rows and router read, y written, against the kept
    pairs' products."""
    E, k, d, ff = cfg.n_experts, cfg.moe_top_k, cfg.d_model, cfg.d_ff
    lay = params["layers"]
    picks = {
        "decode T=32": lambda layer: torch.stack([rows[layer][i][len(p) + j] for i, p in enumerate(prompts)
                                                  for j in (0, 8, 16, 24)]),
        "prefill T=256": lambda layer: rows[layer][7][:256],
    }
    out = {}
    for label, pick in picks.items():
        shares = []
        for layer in range(cfg.n_layers):
            keep = TM.moe_route(pick(layer), lay["w_router"][layer], E, k, cfg.moe_capacity)[4]
            shares.append(float((~keep).float().mean()))
        x = pick(0).contiguous()
        lp = T._layer(params, 0)
        args = (x, lp["w_router"], lp["w_gate"], lp["w_up"], lp["w_down"])
        kw = dict(n_experts=E, top_k=k, capacity_factor=cfg.moe_capacity, act=cfg.act)
        got = TM.moe_mlp(*args, **kw)
        want, _ = TM.moe_ffn_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if got.shape != x.shape or not torch.isfinite(got).all() or not torch.allclose(
                got.float(), want.float(), atol=BF16_ATOL, rtol=BF16_RTOL):
            raise AssertionError(f"moe ffn {label}: served form disagrees with the plain form ({err:.3e})")
        _p, _tp, top_e, _sp, keep, C = TM.moe_route(x, lp["w_router"], E, k, cfg.moe_capacity)
        touched = int(torch.unique(top_e[keep]).numel())
        nbytes = touched * 3 * d * ff * 2 + 2 * x.numel() * 2 + d * E * 2
        flops = 2 * int(keep.sum()) * 3 * d * ff + 2 * x.shape[0] * d * E
        bound_ms, bound_by = _bound(nbytes, flops, torch.bfloat16, dev["peaks"])
        t = {"ms": time_ms(lambda: TM.moe_mlp(*args, **kw)), "device_ms": device_ms(lambda: TM.moe_mlp(*args, **kw),
             None, iters=10), "plain_ms": time_ms(lambda: TM.moe_ffn_plain(*args, **kw), iters=5, warmup=1),
             "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err, "capacity": C,
             "experts_touched": touched, "drop_share_mean": statistics.mean(shares),
             "drop_share_max": max(shares), "drop_share_layer0": shares[0]}
        out[label] = t
        print(f"moe ffn {label} layer 0 on {dev['smi']}: served {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), "
              f"plain (f32 copies of the stacks) {t['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"{touched} experts touched, C {C}); served vs plain max_abs_err {err:.3e} ok; pairs past capacity "
              f"{100 * shares[0]:.2f}% at layer 0, mean {100 * t['drop_share_mean']:.2f}% max "
              f"{100 * t['drop_share_max']:.2f}% over {cfg.n_layers} layers")
    return out


def phase_moe(dev: dict, seed: int) -> dict:
    """The moe phase (see the module docstring). Returns its readings and
    the kernel launches of the default engine's first burst ("engine") and
    of the int8 run ("int8")."""
    clock: dict = {}
    t0 = time.perf_counter()

    def tick(name):
        clock[name] = time.perf_counter() - t0 - sum(clock.values())

    cfg, params = moe_weights(seed)
    tick("weights")
    out: dict = {"launches": {}}
    plens, prompts = _burst_prompts(cfg, seed)
    eng = LLMEngine(cfg, params, seed=seed)  # the defaults, capacity 1.25
    try:
        warm = _warm_report("moe ", eng)
        tick("engine")
        _check_families("moe ", eng, seed)
        tick("families")
        eng.generate([1, 2, 3], max_new_tokens=4)
        # the bursts' busy time from CUDA events around every replay, in
        # place of a profiled extra burst (PR 15: 40-48 s of the script,
        # most of it reading the records back)
        with _replay_clock(eng) as replays:
            runs = _bursts("moe ", eng, prompts, 32, KERNEL_COUNTERS)
        torch.cuda.synchronize()
        busy_ms = sum(s.elapsed_time(e) for _k, s, e in replays)
        prof = {"idle": 1 - busy_ms / (1e3 * sum(r["wall_s"] for r in runs))}
        tick("bursts")
        step = eng._step_name(eng.chunk_shapes[-1], eng.admit_cap)
        prog = {name: program_ms(eng, name, seed) for name in ("llm.decode_chunk8", step)}
        print("moe program device ms (one replay): " + ", ".join(f"{k} {v:.3f}" for k, v in prog.items()))
    finally:
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    for r in runs:
        n = r["launches"]
        if n["flash_attention"] <= 0 or n["paged_decode_partials"] <= 0 or n["paged_decode_partials_int8"]:
            raise AssertionError(f"moe burst at lookahead {r['lookahead']}: kernel launches {n}")
    out["launches"]["engine"] = runs[0]["launches"]

    # the gate engine: the same weights at capacity 4.0, every token of one
    # burst through the replay gate
    cfg4 = dataclasses.replace(cfg, moe_capacity=MOE_GATE_CAPACITY)
    eng = LLMEngine(cfg4, params, seed=seed)
    try:
        warm4 = _warm_report("moe gate ", eng)
        eng.generate([1, 2, 3], max_new_tokens=4)
        (gate_run,) = _bursts("moe gate ", eng, prompts, 32, KERNEL_COUNTERS, lookaheads=(3,))
    finally:
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    tick("gate engine")
    checked, exempt, wide, rows = _moe_gate(params, cfg4, prompts, gate_run["results"], TOKEN_GAP, "moe gate ")
    tick("gate")
    ffn = _moe_ffn_cases(dev, cfg, params, rows, prompts)
    del rows
    tick("ffn")

    # int8: the bf16 tree quantized (matrix by matrix), then freed
    qparams = quantize_params(params, cfg.dtype)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    qbytes = _tensor_bytes(qparams)
    tick("quantize")
    # no warmup (capturing all 10 families took 31 s): the first pass
    # captures the families these requests dispatch, the second is timed
    eng = LLMEngine(cfg4, qparams, seed=seed, quantize=True, kv_int8=True, warmup=False)
    try:
        eng.generate([1, 2, 3], max_new_tokens=4)
        capture8, run8 = _bursts("moe int8 ", eng, prompts[:MOE_INT8_REQUESTS], MOE_INT8_NEW, KERNEL_COUNTERS,
                                 lookaheads=(3, 3))
        families8 = sorted(eng.families)
    finally:
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    c8, e8, wide8, _rows8 = _moe_gate(qparams, cfg4, prompts[:MOE_INT8_REQUESTS], run8["results"],
                                      INT8_TOKEN_GAP, "moe int8 gate ")
    del _rows8
    if 8 * wide8 > run8["tokens"]:
        raise AssertionError(f"moe int8: {wide8} of {run8['tokens']} tokens needed the int8 gap exemption (> 1 in 8)")
    n8 = run8["launches"]
    if n8["flash_attention"] <= 0 or n8["paged_decode_partials_int8"] <= 0 or n8["paged_decode_partials"]:
        raise AssertionError(f"moe int8: kernel launches {n8}")
    out["launches"]["int8"] = n8
    qlp = T._layer(qparams, 0)
    stacks = [qlp[k] for k in ("w_gate", "w_up", "w_down")]
    x8 = torch.randn((32, cfg.d_model), generator=torch.Generator(device="cuda").manual_seed(seed),
                     device="cuda").to(cfg.dtype)
    deq_ms = time_ms(lambda: [TM._deq(w, cfg.dtype) for w in stacks], iters=10)
    ffn8_ms = time_ms(lambda: TM.moe_mlp(x8, qlp["w_router"], *stacks, n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                                         capacity_factor=cfg.moe_capacity, act=cfg.act), iters=10)
    del qparams, qlp, stacks
    gc.collect()
    torch.cuda.empty_cache()
    tick("int8")

    first = runs[0]
    out.update({
        "tok_s": [r["tok_s"] for r in runs], "ttft_p50_s": [r["ttft_p50_s"] for r in runs],
        "ttft_max_s": [r["ttft_max_s"] for r in runs], "programs": [r["chunks"] for r in runs],
        "steps": [r["steps"] for r in runs], "warmup_s": warm["warmup_s"],
        "reserved_growth": warm["reserved_after"] - warm["reserved_before"], "idle": prof["idle"],
        "program_ms": prog, "gate_tok_s": gate_run["tok_s"], "gate_warmup_s": warm4["warmup_s"],
        "tokens_matched": checked, "tokens_exempt": exempt, "ffn": ffn, "int8_bytes": qbytes,
        "int8_tok_s": run8["tok_s"], "int8_capture_pass_s": capture8["wall_s"], "int8_matched": c8,
        "int8_exempt": e8,
        "dequant_ms": deq_ms, "int8_ffn_ms": ffn8_ms, "seconds": clock,
    })
    print(f"moe int8 on {dev['smi']}: weights {qbytes} bytes; {MOE_INT8_REQUESTS} requests x {MOE_INT8_NEW} tokens "
          f"{run8['tok_s']:.1f} tok/s (capacity {MOE_GATE_CAPACITY}; the first pass, capturing {len(families8)} "
          f"families {families8}, {capture8['wall_s']:.1f}s); {c8} tokens matched, {e8} exempt (gap "
          f"{INT8_TOKEN_GAP}; {wide8} with a gap >= {TOKEN_GAP}); layer 0 dequant of the three stacks "
          f"{deq_ms:.4f} ms, int8 ffn at T=32 {ffn8_ms:.4f} ms; launches {n8}")
    med = statistics.median
    print(f"moe mixtral_8x7b_l{MOE_LAYERS} on {dev['smi']}: tok/s {', '.join(f'{x:.1f}' for x in out['tok_s'])} (lookahead "
          f"3, 3, 3, 1; median {med(out['tok_s'][:3]):.1f}); ttft p50 {med(out['ttft_p50_s'][:3]):.3f}s max "
          f"{med(out['ttft_max_s'][:3]):.3f}s (medians); programs {out['programs']} (unified steps {out['steps']}); "
          f"warmup_s {warm['warmup_s']:.3f}; memory_reserved +{out['reserved_growth']}; idle "
          f"{100 * prof['idle']:.1f}% of the bursts (CUDA events around every replay); llm.decode_chunk8 {prog['llm.decode_chunk8']:.3f} ms, {step} "
          f"{prog[step]:.3f} ms device; gate engine (capacity {MOE_GATE_CAPACITY}) {gate_run['tok_s']:.1f} tok/s, "
          f"{checked} tokens matched, {exempt} exempt (gap {TOKEN_GAP}); launches in burst 1 {first['launches']}; "
          f"seconds " + ", ".join(f"{k} {v:.1f}" for k, v in clock.items()))
    return out


# The contiguous phase: the JAX package's two contiguous KV layouts. The
# dense slab at Gemma-2B's defaults (kv_paged=False), and the rolling ring
# that kv_paged="auto" gives a windowed model: Mistral-7B
# (mistralai/Mistral-7B-v0.1's config.json: max_position_embeddings
# 32,768, sliding_window 4096) at full width, 8 slots at max_seq_len
# 32,768, a ring of 4096 + 64 rows a slot. Prompts of 4,300-6,000 tokens
# wrap every ring during prefill. The ring runs 4 of the 32 layers (16
# until the knobs phase, 8 until the fleet phase): its plain decode
# attention upcasts every ring row to float32 in every step, so on an H100
# 80GB HBM3 at 700 W a program took ~0.36 s at 32 layers and one burst
# over half a minute (PERF.md, the contiguous layouts); the time limit
# took the cuts.
RING_SLOTS, RING_SEQ, RING_NEW, RING_LAYERS = 8, 32768, 64, 4
RING_PROMPTS = (4300, 4900, 5500, 6000)


def _contiguous_launches(label: str, launches: dict, flash: bool) -> None:
    """A contiguous engine launches no paged kernel; flash on the slab
    (every unified step) and not on the ring (plain masks, as in JAX)."""
    if launches["paged_decode_partials"] or launches["paged_decode_partials_int8"] or (
        (launches["flash_attention"] > 0) != flash
    ):
        raise AssertionError(f"{label}kernel launches {launches}")


def _pool_bytes(kv) -> int:
    """Bytes a paged CacheManager's pool would take (its blocks x block
    bytes): host bookkeeping, nothing allocated on the card."""
    return kv.pool.n_blocks * kv.block_bytes


def _decode_attention_ms(eng, seed: int, iters: int = 20) -> float:
    """Device ms of the plain contiguous decode attention of ONE layer at
    one step of the engine's decode chunk (q [slots, 1, hq, hd] against
    the cache's [slots, capacity, hkv, hd] and an 8-row buffer, the
    engine's ring and window), captured as a CUDA graph, as the chunk
    runs it, and replayed ``iters`` times between CUDA events (timed
    eagerly it also paid the caching allocator: on an H100 80GB HBM3 at
    700 W, 1.2-2.0 ms against a 150 ms chunk of 128 such calls, PERF.md)."""
    cfg, S, C, K = eng.cfg, eng.slots, eng.kv.capacity, eng.decode_chunk
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((S, 1, cfg.n_heads, cfg.head_dim), generator=g, device="cuda").to(cfg.dtype)
    kb = torch.randn((S, K, cfg.n_kv_heads, cfg.head_dim), generator=g, device="cuda").to(cfg.dtype)
    lengths = torch.randint(C, eng.max_seq_len - 2 * K, (S,), generator=g, device="cuda", dtype=torch.int32)
    k, v = eng.cache.k[0], eng.cache.v[0]

    def call():
        return A.chunk_decode_attention(q, k, v, kb, kb, lengths, K - 1, logit_cap=cfg.attn_logit_cap,
                                        window=cfg.sliding_window, ring=eng.kv.ring)

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def _replay_clock(eng):
    """Time every program replay the engine dispatches meanwhile: CUDA
    events around each on the engine stream (one stream: the replays run
    one after another, so their sum is the card's busy time), with the
    decode steps each carries (a unified step and llm.decode_chunk{K} K,
    the short chunk K // 4, a verify none). Yields [(steps, start, end)];
    read the events after a synchronize. A profile of a whole ring burst
    (millions of kernel records) took minutes to read back."""
    steps_of = {f"llm.decode_chunk{eng._chunk_short}": eng._chunk_short, f"llm.step_v{eng.spec_draft + 1}": 0}
    replays = []
    launch = eng._launch

    def timed(name):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(name)
        end.record()
        replays.append((steps_of.get(name, eng.decode_chunk), start, end))
        return out

    outer = eng.__dict__.get("_launch")  # another wrapper's, when nested
    eng._launch = timed
    try:
        yield replays
    finally:
        if outer is None:
            del eng._launch  # the method again
        else:
            eng._launch = outer


def _clocked_bursts(label: str, eng, prompts, new_tokens: int, lookaheads) -> list[dict]:
    """``_bursts`` once at each of ``lookaheads``, each run with its busy
    ms, idle share (1 - busy / wall) and decode steps from
    ``_replay_clock``."""
    runs = []
    for la in lookaheads:
        with _replay_clock(eng) as replays:
            (run,) = _bursts(label, eng, prompts, new_tokens, KERNEL_COUNTERS, lookaheads=(la,))
        torch.cuda.synchronize()
        run["busy_ms"] = sum(s.elapsed_time(e) for _k, s, e in replays)
        run["idle"] = 1 - run["busy_ms"] / (1e3 * run["wall_s"])
        run["decode_steps"] = sum(k for k, _s, _e in replays)
        runs.append(run)
    return runs


def _contiguous_dense(dev: dict, seed: int) -> dict:
    """Gemma-2B on the dense slab (see the module docstring)."""
    label = "contiguous dense "
    cfg, params = gemma_weights(seed)
    eng = LLMEngine(cfg, params, seed=seed, kv_paged=False)
    try:
        kv = eng.stats()["kvcache"]
        print(f"{label}kvcache {kv}")
        if (kv["layout"], kv["capacity"], kv["slot_bytes"]) != ("dense", 512, 301_989_888) or eng.pool is not None:
            raise AssertionError(f"{label}layout {kv}")
        warm = _warm_report(label, eng)
        _check_families(label, eng, seed)
        eng.generate([1, 2, 3], max_new_tokens=4)
        _plens, prompts = _burst_prompts(cfg, seed)
        runs = _clocked_bursts(label, eng, prompts, 32, (3, 1))
    finally:
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    checked = exempt = 0
    for i, r in enumerate(runs):
        _contiguous_launches(f"{label}burst {i + 1} ", r["launches"], flash=True)
        c, e = _replay_gate(params, cfg, prompts, r["results"], TOKEN_GAP,
                            label=f"{label}burst {i + 1} (lookahead {r['lookahead']}) ", verbose=False)
        checked, exempt = checked + c, exempt + e
    del params
    out = {"tok_s": [r["tok_s"] for r in runs], "ttft_p50_s": [r["ttft_p50_s"] for r in runs],
           "ttft_max_s": [r["ttft_max_s"] for r in runs], "programs": [r["chunks"] for r in runs],
           "steps": [r["steps"] for r in runs], "launches": runs[0]["launches"], "warmup_s": warm["warmup_s"],
           "reserved_growth": warm["reserved_after"] - warm["reserved_before"], "idle": [r["idle"] for r in runs],
           "busy_ms": [r["busy_ms"] for r in runs], "tokens_matched": checked, "tokens_exempt": exempt}
    print(f"contiguous dense gemma_2b on {dev['smi']}: tok/s {out['tok_s'][0]:.1f} at lookahead 3, "
          f"{out['tok_s'][1]:.1f} at 1; ttft p50 {out['ttft_p50_s'][0]:.3f}s max {out['ttft_max_s'][0]:.3f}s; "
          f"programs {out['programs']} (unified steps {out['steps']}); busy {out['busy_ms'][0]:.1f} ms of "
          f"{1e3 * runs[0]['wall_s']:.1f} ms wall, idle {100 * out['idle'][0]:.1f}% at lookahead 3 "
          f"({100 * out['idle'][1]:.1f}% at 1; CUDA events around every replay); warmup_s {warm['warmup_s']:.3f}, "
          f"memory_reserved +{out['reserved_growth']}; "
          f"{checked} tokens matched, {exempt} exempt (gap {TOKEN_GAP}); launches {out['launches']}")
    return out


def ring_weights(seed: int) -> tuple[TransformerConfig, dict]:
    """Mistral-7B at full width and RING_LAYERS layers, random bf16
    weights from the seed, with a random untied head."""
    cfg = dataclasses.replace(TransformerConfig.mistral_7b(), n_layers=RING_LAYERS)
    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(cfg, g, "cuda")
    head = torch.randn((cfg.vocab_size, cfg.d_model), generator=g, device="cuda") / math.sqrt(cfg.d_model)
    params["unembed"] = head.to(cfg.dtype)
    del head
    torch.cuda.synchronize()
    print(f"contiguous ring mistral_7b ({cfg.n_layers} of 32 layers): {_tensor_bytes(params)} bytes of bf16 "
          f"weights in {time.perf_counter() - t0:.1f}s", flush=True)
    return cfg, params


def _contiguous_ring(dev: dict, seed: int) -> dict:
    """Mistral-7B on its rolling ring (see the module docstring). The
    burst's device busy time is the sum of CUDA-event times around every
    program replay it dispatched (one stream: they run one after
    another), its idle share 1 - busy / wall; the plain decode
    attention's share of the burst is its time a layer a step at the
    chunk's shapes (a graph replay between CUDA events), times the
    burst's layer-steps, over that busy time."""
    label = "contiguous ring "
    clock: dict = {}
    t0 = time.perf_counter()

    def tick(name):
        clock[name] = time.perf_counter() - t0 - sum(clock.values())
        print(f"{label}{name} done in {clock[name]:.1f}s", flush=True)

    # the deployment's sizes at all 32 layers, from the CacheManager
    # arithmetic (host bookkeeping, nothing allocated), at the engine's
    # default decode chunk and KV block
    full = TransformerConfig.mistral_7b()
    kv32 = CacheManager(full, RING_SLOTS, RING_SEQ, TL.DECODE_CHUNK, append_widths=(16, 64, 5), paged="auto")
    planned, planned32 = (_pool_bytes(CacheManager(full, n, RING_SEQ, TL.DECODE_CHUNK, block=TL.KV_BLOCK))
                          for n in (RING_SLOTS, 32))
    print(f"{label}at 32 layers: {kv32.stats()}; the paged pool would take {planned} bytes ({RING_SLOTS} slots x "
          f"{RING_SEQ // TL.KV_BLOCK} blocks), {planned32} at 32 slots")
    if (kv32.rolling, kv32.capacity, kv32.slot_bytes, planned, planned32) != (
        True, 4160, 4_362_076_160, 34_359_738_368, 137_438_953_472
    ):
        raise AssertionError(f"{label}sizes {kv32.stats()}, planned pool {planned} / {planned32}")
    cfg, params = ring_weights(seed)
    tick("weights")
    eng = LLMEngine(cfg, params, seed=seed, slots=RING_SLOTS, max_seq_len=RING_SEQ, speculative=True)
    try:
        kv = eng.stats()["kvcache"]
        ring_bytes = _tensor_bytes({"k": eng.cache.k, "v": eng.cache.v})
        print(f"{label}kvcache {kv}; ring tensors {ring_bytes} bytes")
        if (kv["layout"], kv["capacity"], ring_bytes) != ("rolling", 4160, kv["slot_bytes"]) or eng.pool is not None:
            raise AssertionError(f"{label}layout {kv}, ring tensors {ring_bytes} bytes")
        warm = _warm_report(label, eng)
        tick("engine")
        _check_families(label, eng, seed)
        tick("families")
        rng = np.random.default_rng(seed + 15)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in RING_PROMPTS]
        (run,) = _clocked_bursts(label, eng, prompts, RING_NEW, (3,))
        lengths = eng.cache.length.cpu().tolist()
        verifies = eng.stats()["spec"]["steps"]
        tick("burst")
        step = eng._step_name(eng.chunk_shapes[-1], eng.admit_cap)
        prog = {name: program_ms(eng, name, seed) for name in ("llm.decode_chunk8", step)}
        attn = _decode_attention_ms(eng, seed)
        tick("programs")
    finally:
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    _contiguous_launches(label, run["launches"], flash=False)
    # a slot's length is absolute: past the ring's 4160 rows, and at least
    # its prompt + the tokens it decoded (a retired slot keeps advancing,
    # as in JAX, until its next prompt)
    short = {i: lengths[r.slot] for i, r in run["reqs"].items() if lengths[r.slot] < len(prompts[i]) + RING_NEW - 1}
    if short or min(lengths[r.slot] for r in run["reqs"].values()) <= 4160:
        raise AssertionError(f"{label}lengths {lengths}: {short} short of prompt + {RING_NEW - 1}, or within 4160")
    checked, exempt = _replay_gate(params, cfg, prompts, run["results"], TOKEN_GAP, label=label, verbose=False)
    tick("gate")
    del params
    busy_ms, idle = run["busy_ms"], run["idle"]
    out = {"tok_s": run["tok_s"], "ttft_p50_s": run["ttft_p50_s"], "ttft_max_s": run["ttft_max_s"],
           "programs": run["chunks"], "steps": run["steps"], "verifies": verifies, "launches": run["launches"],
           "lengths": lengths, "warmup_s": warm["warmup_s"],
           "reserved_growth": warm["reserved_after"] - warm["reserved_before"], "program_ms": prog,
           "busy_ms": busy_ms, "idle": idle, "decode_attention_layer_ms": attn,
           "decode_attention_chunk_share": attn * cfg.n_layers * 8 / prog["llm.decode_chunk8"],
           "decode_attention_burst_share": attn * cfg.n_layers * run["decode_steps"] / busy_ms,
           "tokens_matched": checked, "tokens_exempt": exempt, "seconds": clock}
    print(f"contiguous ring mistral_7b ({cfg.n_layers} of 32 layers) on {dev['smi']}: {len(prompts)} prompts of "
          f"{list(RING_PROMPTS)} tokens x {RING_NEW}: {out['tok_s']:.1f} tok/s, ttft p50 {out['ttft_p50_s']:.3f}s max "
          f"{out['ttft_max_s']:.3f}s; {out['programs']} programs ({out['steps']} unified steps, "
          f"{run['decode_steps']} decode steps), {verifies} verifies; final lengths {lengths} (ring "
          f"4160); device ms llm.decode_chunk8 {prog['llm.decode_chunk8']:.3f}, {step} {prog[step]:.3f}; busy "
          f"{busy_ms:.1f} ms of {1e3 * run['wall_s']:.1f} ms wall (idle {100 * idle:.1f}%, CUDA events around "
          f"every replay); plain decode attention {attn:.4f} ms a layer a step: "
          f"{100 * out['decode_attention_chunk_share']:.1f}% of llm.decode_chunk8, "
          f"{100 * out['decode_attention_burst_share']:.1f}% of the burst's busy time; warmup_s "
          f"{warm['warmup_s']:.3f}, memory_reserved +{out['reserved_growth']}; {checked} tokens matched, {exempt} "
          f"exempt; launches {run['launches']}; seconds " + ", ".join(f"{k} {v:.1f}" for k, v in clock.items()))
    return out


def phase_contiguous(dev: dict, seed: int) -> dict:
    """The contiguous phase (see the module docstring). Returns each run's
    readings and its kernel launches by label."""
    out = {"dense": _contiguous_dense(dev, seed), "ring": _contiguous_ring(dev, seed)}
    out["launches"] = {label: run["launches"] for label, run in out.items()}
    return out

# -- the wave scheduler and the whole-row prefix cache -------------------------

WAVE_PREFIX_MB = 256  # the slab's PrefixCache budget
WAVE_SHARED = 256  # the shared prefix of the slab's partial-hit round
WAVE_HIT_LAYERS, WAVE_HIT_SLOTS, WAVE_HIT_SEQ, WAVE_HIT_MB, WAVE_HIT_PROMPT = 8, 2, 32768, 1024, 6000
WAVE_RING_LAYERS, WAVE_RING_SLOTS, WAVE_RING_SEQ, WAVE_RING_PROMPTS, WAVE_RING_NEW = 4, 2, 8192, (4300, 6000), 64


def _wave_launches(label: str, launches: dict, paged: str | None) -> None:
    """A wave engine's burst: flash in its full-prompt mode (the prefill),
    never in its q_offsets mode (no unified step, no verify), and the
    paged kernel ``paged`` (None: no paged kernel, the contiguous
    layouts)."""
    offsets = launches["flash_attention"] - launches["flash_attention_prompt"]
    ok = launches["flash_attention_prompt"] > 0 and offsets == 0
    for name in ("paged_decode_partials", "paged_decode_partials_int8"):
        ok = ok and (launches[name] > 0) == (name == paged)
    if not ok:
        raise AssertionError(f"{label}kernel launches {launches}")


def _wave_stats(eng, st0: dict | None = None) -> dict:
    st = eng.stats()
    waves = dict(st["prefill_waves"])
    if st0 is not None:
        waves = {w: n - st0["prefill_waves"].get(w, 0) for w, n in waves.items() if n - st0["prefill_waves"].get(w, 0)}
    return {"waves": waves, "wave_reqs": st["wave_reqs"] - (st0["wave_reqs"] if st0 else 0)}


def _wave_gemma(dev: dict, seed: int, cfg, params) -> dict:
    """Gemma-2B at the engine defaults plus step_token_budget=0 (the pool,
    under "auto"): warmup, every family bitwise (the lazy max_seq_len
    bucket's too), the burst at lookahead 3 and 1 with its waves, every
    token through the replay gate; then an int8 engine's burst."""
    label = "wave "
    eng = LLMEngine(cfg, params, seed=seed, step_token_budget=0)
    try:
        st = eng.stats()
        print(f"{label}scheduler {st['scheduler']}, step_token_budget {st['step_token_budget']}, layout "
              f"{st['kvcache']['layout']}, admit_cap {eng.admit_cap}, buckets {eng.prefill_buckets} + lazy "
              f"{eng.max_seq_len}")
        if st["scheduler"] != "wave" or not eng.kv.paged or any(n.startswith("llm.step_p") for n in eng._programs):
            raise AssertionError(f"{label}not a paged wave engine: {st['scheduler']}, {list(eng._programs)}")
        warm = _warm_report(label, eng)
        _check_families(label, eng, seed, extra=sorted(eng._lazy))
        eng.generate([1, 2, 3], max_new_tokens=4)
        _plens, prompts = _burst_prompts(cfg, seed)
        runs = []
        for la in (3, 1):
            st0 = eng.stats()
            (run,) = _clocked_bursts(label, eng, prompts, 32, (la,))
            run.update(_wave_stats(eng, st0))
            print(f"{label}burst at lookahead {la}: waves by width {run['waves']}, {run['wave_reqs']} requests "
                  f"in waves, busy {run['busy_ms']:.1f} ms, idle {100 * run['idle']:.1f}% (CUDA events)")
            runs.append(run)
    finally:
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    checked = exempt = 0
    for i, r in enumerate(runs):
        _wave_launches(f"{label}burst {i + 1} ", r["launches"], "paged_decode_partials")
        c, e = _replay_gate(params, cfg, prompts, r["results"], TOKEN_GAP,
                            label=f"{label}burst {i + 1} (lookahead {r['lookahead']}) ", verbose=i == 0)
        checked, exempt = checked + c, exempt + e
    # int8 weights and KV under the wave: the insert quantizes each row; its
    # families are captured at their first dispatch (warmup=False)
    qparams = quantize_params(params, cfg.dtype)
    eng = LLMEngine(cfg, qparams, seed=seed, step_token_budget=0, kv_int8=True, quantize=True, warmup=False)
    try:
        eng.generate([1, 2, 3], max_new_tokens=4)
        (run8,) = _bursts(f"{label}int8 ", eng, prompts, 32, KERNEL_COUNTERS, lookaheads=(3,))
        run8.update(_wave_stats(eng))
    finally:
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    _wave_launches(f"{label}int8 ", run8["launches"], "paged_decode_partials_int8")
    c8, e8 = _replay_gate(qparams, cfg, prompts, run8["results"], INT8_TOKEN_GAP, label=f"{label}int8 ",
                          verbose=False)
    if 8 * e8 > run8["tokens"]:
        raise AssertionError(f"{label}int8: {e8} of {run8['tokens']} tokens needed the int8 gap")
    del qparams
    out = {"tok_s": [r["tok_s"] for r in runs], "ttft_p50_s": [r["ttft_p50_s"] for r in runs],
           "ttft_max_s": [r["ttft_max_s"] for r in runs], "waves": [r["waves"] for r in runs],
           "programs": [r["chunks"] for r in runs], "busy_ms": [r["busy_ms"] for r in runs],
           "idle": [r["idle"] for r in runs], "launches": runs[0]["launches"], "warmup_s": warm["warmup_s"],
           "reserved_growth": warm["reserved_after"] - warm["reserved_before"], "tokens_matched": checked,
           "tokens_exempt": exempt, "int8": {"tok_s": run8["tok_s"], "ttft_p50_s": run8["ttft_p50_s"],
                                              "launches": run8["launches"], "waves": run8["waves"],
                                              "matched": c8, "exempt": e8}}
    print(f"wave gemma_2b on {dev['smi']}: tok/s {out['tok_s'][0]:.1f} at lookahead 3, {out['tok_s'][1]:.1f} at 1; "
          f"ttft p50 {out['ttft_p50_s'][0]:.3f}s max {out['ttft_max_s'][0]:.3f}s (lookahead 1: "
          f"{out['ttft_p50_s'][1]:.3f}s / {out['ttft_max_s'][1]:.3f}s); waves {out['waves'][0]}; programs "
          f"{out['programs']}; busy {out['busy_ms'][0]:.1f} ms, idle {100 * out['idle'][0]:.1f}%; warmup_s "
          f"{warm['warmup_s']:.3f}, memory_reserved +{out['reserved_growth']}; {checked} tokens matched, {exempt} "
          f"exempt; launches {out['launches']}; int8: {run8['tok_s']:.1f} tok/s, ttft p50 {run8['ttft_p50_s']:.3f}s, "
          f"{c8} matched, {e8} exempt, launches {run8['launches']}")
    return out


def _timed_serve(eng, prompts, new_tokens: int) -> dict:
    """``_serve`` plus the TTFT of each request and the wave/step counts."""
    st0 = eng.stats()
    results, reqs, wall = _serve(eng, prompts, new_tokens)
    st = eng.stats()
    ttfts = sorted(r.first_token_at - r.submitted_at for r in reqs.values())
    admits = sorted(r.admitted_at - r.submitted_at for r in reqs.values())
    total = sum(len(t) for t in results.values())
    return {"results": results, "reqs": reqs, "wall_s": wall, "tok_s": total / wall,
            "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1], "steps": st["steps"] - st0["steps"],
            "admit_p50_s": admits[len(admits) // 2]}


def _wave_slab_prefix(dev: dict, seed: int, cfg, params) -> dict:
    """The whole-row prefix cache on the dense slab, chunked: the burst as
    misses, again as exact hits (the miss round's tokens), then the shared
    prefix alone and 8 prompts that extend it (partial hits)."""
    label = "wave slab prefix "
    eng = LLMEngine(cfg, params, seed=seed, kv_paged=False, prefix_cache_mb=WAVE_PREFIX_MB)
    rounds = {}
    try:
        kv = eng.stats()["kvcache"]
        if (kv["layout"], kv["prefix"]["capacity_bytes"]) != ("dense", WAVE_PREFIX_MB << 20):
            raise AssertionError(f"{label}kvcache {kv}")
        warm = _warm_report(label, eng)
        _check_families(label, eng, seed)
        eng.generate([1, 2, 3], max_new_tokens=4)  # warm-up, outside the rounds
        _plens, prompts = _burst_prompts(cfg, seed)
        rng = np.random.default_rng(seed + 16)
        shared = rng.integers(1, cfg.vocab_size, WAVE_SHARED).tolist()
        tails = [shared + rng.integers(1, cfg.vocab_size, 16 + 6 * i).tolist() for i in range(8)]
        for name, batch in (("miss", prompts), ("exact", prompts), ("shared", [shared]), ("partial", tails)):
            st0 = eng.stats()["kvcache"]["prefix"]
            _zero_launches(KERNEL_COUNTERS)
            run = _timed_serve(eng, batch, 32)
            run["launches"] = _launches(KERNEL_COUNTERS)
            st = eng.stats()["kvcache"]["prefix"]
            run["prefix"] = {k: st[k] - st0[k] for k in ("hits", "partial_hits", "misses", "stores")}
            rounds[name] = run
            print(f"{label}round {name}: {len(batch)} requests, {run['tok_s']:.1f} tok/s, ttft p50 "
                  f"{run['ttft_p50_s']:.3f}s max {run['ttft_max_s']:.3f}s (admitted after {run['admit_p50_s']:.3f}s "
                  f"p50), {run['steps']} unified steps, prefix "
                  f"{run['prefix']}, resident {st['resident_bytes']} bytes in {st['entries']} entries; launches "
                  f"{run['launches']}")
        pinned = eng.kv.prefix.pinned()
    finally:
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    # a partial hit counts its whole-prompt probe's miss too (JAX lookup_longest)
    want = {"miss": (0, 0, 8), "exact": (8, 0, 0), "shared": (0, 0, 1), "partial": (0, 8, 8)}
    got = {n: (r["prefix"]["hits"], r["prefix"]["partial_hits"], r["prefix"]["misses"]) for n, r in rounds.items()}
    if got != want or pinned or rounds["exact"]["steps"]:
        raise AssertionError(f"{label}(hits, partials, misses) {got}, want {want}; pinned {pinned}; exact round "
                             f"steps {rounds['exact']['steps']}")
    if rounds["exact"]["results"] != rounds["miss"]["results"]:
        raise AssertionError(f"{label}exact hits served other tokens than the misses")
    checked = exempt = 0
    for name, batch in (("miss", prompts), ("partial", tails)):
        c, e = _replay_gate(params, cfg, batch, rounds[name]["results"], TOKEN_GAP, label=f"{label}{name} ",
                            verbose=False)
        checked, exempt = checked + c, exempt + e
    out = {name: {k: r[k] for k in ("tok_s", "ttft_p50_s", "ttft_max_s", "steps", "prefix", "launches")}
           for name, r in rounds.items()}
    out.update(warmup_s=warm["warmup_s"], tokens_matched=checked, tokens_exempt=exempt)
    print(f"wave slab prefix gemma_2b on {dev['smi']}: ttft p50 miss {out['miss']['ttft_p50_s']:.3f}s, exact "
          f"{out['exact']['ttft_p50_s']:.3f}s, partial {out['partial']['ttft_p50_s']:.3f}s; exact tokens equal the "
          f"misses'; {checked} tokens matched, {exempt} exempt")
    return out


def mistral_weights(seed: int, layers: int, label: str) -> tuple[TransformerConfig, dict]:
    """Mistral-7B at full width and ``layers`` layers, random bf16 weights
    from the seed, with a random untied head."""
    cfg = dataclasses.replace(TransformerConfig.mistral_7b(), n_layers=layers)
    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(cfg, g, "cuda")
    head = torch.randn((cfg.vocab_size, cfg.d_model), generator=g, device="cuda") / math.sqrt(cfg.d_model)
    params["unembed"] = head.to(cfg.dtype)
    del head
    torch.cuda.synchronize()
    print(f"{label}mistral_7b ({cfg.n_layers} of 32 layers): {_tensor_bytes(params)} bytes of bf16 weights in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return cfg, params


def _wave_ring_hit(dev: dict, seed: int) -> dict:
    """Mistral-7B's ring with the whole-row prefix cache, chunked: one long
    prompt as a miss, then again as an exact hit (the whole ring stored)."""
    label = "wave ring hit "
    cfg, params = mistral_weights(seed, WAVE_HIT_LAYERS, label)
    eng = LLMEngine(cfg, params, seed=seed, slots=WAVE_HIT_SLOTS, max_seq_len=WAVE_HIT_SEQ, prefix_cache_mb=WAVE_HIT_MB)
    try:
        kv = eng.stats()["kvcache"]
        print(f"{label}kvcache {kv}")
        if (kv["layout"], kv["capacity"]) != ("rolling", 4160) or kv["prefix"] is None:
            raise AssertionError(f"{label}kvcache {kv}")
        warm = _warm_report(label, eng)
        _check_families(label, eng, seed)
        eng.generate([1, 2, 3], max_new_tokens=4)  # warm-up, outside the timed pair
        prompt = np.random.default_rng(seed + 17).integers(1, cfg.vocab_size, WAVE_HIT_PROMPT).tolist()
        runs = {}
        for name in ("miss", "exact"):
            _zero_launches(KERNEL_COUNTERS)
            runs[name] = _timed_serve(eng, [prompt], 32)
            runs[name]["launches"] = _launches(KERNEL_COUNTERS)
            print(f"{label}{name}: ttft {runs[name]['ttft_p50_s']:.3f}s (admitted after "
                  f"{runs[name]['admit_p50_s']:.3f}s), {runs[name]['steps']} unified steps, "
                  f"launches {runs[name]['launches']}")
        pre = eng.stats()["kvcache"]["prefix"]
        entry = eng.kv.prefix._entries[eng.kv.prefix.key_for(prompt)]
        entry_bytes, entry_rows = entry.nbytes, entry.k.shape[2]
    finally:
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    want_bytes = 2 * cfg.n_layers * 4160 * cfg.n_kv_heads * cfg.head_dim * 2 + 4 * cfg.vocab_size
    if (pre["hits"], pre["misses"], entry_rows, entry_bytes) != (1, 2, 4160, want_bytes) or runs["exact"]["steps"]:
        raise AssertionError(f"{label}prefix {pre}, entry {entry_rows} rows {entry_bytes} bytes, exact steps "
                             f"{runs['exact']['steps']}")
    if runs["exact"]["results"] != runs["miss"]["results"]:
        raise AssertionError(f"{label}the exact hit served other tokens than the miss")
    checked, exempt = _replay_gate(params, cfg, [prompt], runs["miss"]["results"], TOKEN_GAP, label=label,
                                   verbose=False)
    del params
    out = {"ttft_miss_s": runs["miss"]["ttft_p50_s"], "ttft_exact_s": runs["exact"]["ttft_p50_s"],
           "entry_bytes": entry_bytes, "steps_miss": runs["miss"]["steps"], "warmup_s": warm["warmup_s"],
           "launches": runs["miss"]["launches"], "tokens_matched": checked, "tokens_exempt": exempt}
    print(f"wave ring hit mistral_7b ({cfg.n_layers} of 32 layers) on {dev['smi']}: a {WAVE_HIT_PROMPT}-token prompt, "
          f"ttft miss {out['ttft_miss_s']:.3f}s ({out['steps_miss']} unified steps), exact hit "
          f"{out['ttft_exact_s']:.3f}s, same tokens; entry {entry_bytes} bytes ({entry_rows} ring rows); {checked} "
          f"tokens matched, {exempt} exempt")
    return out


def _wave_ring(dev: dict, seed: int) -> dict:
    """Mistral-7B's ring under the wave: two long prompts in one wave at the
    8,192 bucket (full-prompt flash over the 4096 band, then ring_pack)."""
    label = "wave ring "
    cfg, params = mistral_weights(seed, WAVE_RING_LAYERS, label)
    eng = LLMEngine(cfg, params, seed=seed, slots=WAVE_RING_SLOTS, max_seq_len=WAVE_RING_SEQ, step_token_budget=0)
    try:
        kv = eng.stats()["kvcache"]
        print(f"{label}kvcache {kv}")
        if (kv["layout"], kv["capacity"]) != ("rolling", 4104):
            raise AssertionError(f"{label}kvcache {kv}")
        warm = _warm_report(label, eng)
        _check_families(label, eng, seed, extra=sorted(eng._lazy))
        rng = np.random.default_rng(seed + 18)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in WAVE_RING_PROMPTS]
        st0 = eng.stats()
        (run,) = _clocked_bursts(label, eng, prompts, WAVE_RING_NEW, (3,))
        run.update(_wave_stats(eng, st0))
        lengths = eng.cache.length.cpu().tolist()
    finally:
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    _wave_launches(label, run["launches"], None)
    if run["wave_reqs"] != 2 or min(lengths) <= 4104:
        raise AssertionError(f"{label}waves {run['waves']}, lengths {lengths}")
    checked, exempt = _replay_gate(params, cfg, prompts, run["results"], TOKEN_GAP, label=label, verbose=False)
    del params
    out = {"tok_s": run["tok_s"], "ttft_p50_s": run["ttft_p50_s"], "ttft_max_s": run["ttft_max_s"],
           "waves": run["waves"], "lengths": lengths, "busy_ms": run["busy_ms"], "idle": run["idle"],
           "warmup_s": warm["warmup_s"], "launches": run["launches"], "tokens_matched": checked,
           "tokens_exempt": exempt}
    print(f"wave ring mistral_7b ({cfg.n_layers} of 32 layers) on {dev['smi']}: prompts {list(WAVE_RING_PROMPTS)} x "
          f"{WAVE_RING_NEW} in waves {run['waves']}: {run['tok_s']:.1f} tok/s, ttft p50 {run['ttft_p50_s']:.3f}s max "
          f"{run['ttft_max_s']:.3f}s; lengths {lengths} (ring 4104); busy {run['busy_ms']:.1f} ms, idle "
          f"{100 * run['idle']:.1f}%; {checked} tokens matched, {exempt} exempt; launches {run['launches']}")
    return out


def phase_wave(dev: dict, seed: int, cfg=None, params=None) -> dict:
    """The wave phase (see the module docstring). Returns each run's
    readings and its kernel launches by label."""
    if params is None:
        cfg, params = gemma_weights(seed)
    cfg, params = _first_layers(cfg, params, CUT_LAYERS)
    clock: dict = {}
    out = {}
    for name, fn, args in (("gemma", _wave_gemma, (cfg, params)), ("slab prefix", _wave_slab_prefix, (cfg, params)),
                           ("ring hit", _wave_ring_hit, ()), ("ring", _wave_ring, ())):
        t0 = time.perf_counter()
        out[name] = fn(dev, seed, *args)
        clock[name] = time.perf_counter() - t0
    print("wave seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in clock.items()))
    out["launches"] = {
        "gemma": out["gemma"]["launches"], "gemma int8": out["gemma"]["int8"]["launches"],
        "slab prefix": out["slab prefix"]["miss"]["launches"], "ring hit": out["ring hit"]["launches"],
        "ring": out["ring"]["launches"],
    }
    return out


# The shape knobs' two deployments (JAX LLMEngine kwargs / TPU_LLM_* knobs)
KNOB_ENGINES = (
    ("wide", dict(decode_chunk=16, prefill_chunk=128, step_token_budget=512, kv_block=32)),
    ("narrow", dict(decode_chunk=4, prefill_chunk=32, step_token_budget=128, kv_block=8, kv_int8=True)),
)
KNOB_WAVE = dict(decode_chunk=16, step_token_budget=0, kv_block=32)


@contextlib.contextmanager
def _replay_names(eng):
    """Count the engine's program replays by family name meanwhile."""
    counts: dict[str, int] = {}
    launch = eng._launch

    def counted(name):
        counts[name] = counts.get(name, 0) + 1
        return launch(name)

    outer = eng.__dict__.get("_launch")  # another wrapper's, when nested
    eng._launch = counted
    try:
        yield counts
    finally:
        if outer is None:
            del eng._launch  # the method again
        else:
            eng._launch = outer


def _launches_by_shape(eng, counts: dict) -> dict:
    """{"kernel q/pool shape (family kind)": launches} from replays by family
    and each family's captured launches: a step's flash is q [nb, S, hq,
    d] on its packed rows' slot views, a verify's q [slots, W, hq, d], a
    wave prefill's q [nb, bucket, hq, d] (full-prompt mode); the paged
    kernel reads q [slots, hq, d] from [NB, B, hkv, d] pools in every step
    and chunk."""
    cfg, out = eng.cfg, {}
    for name, n in sorted(counts.items()):
        kind, arg = eng._program(name)[1:]
        for kern, per in eng.families[name].launches.items():
            if kern.startswith("paged"):
                key = (f"{kern} q [{eng.slots}, {cfg.n_heads}, {cfg.head_dim}] pools [{eng.kv.pool.n_blocks}, "
                       f"{eng.kv.block}, {cfg.n_kv_heads}, {cfg.head_dim}] ({kind})")
            elif kern == "flash_attention_prompt":
                continue  # the prefill's flash_attention key below counts them
            else:
                (c, nb) = (arg, eng.slots) if kind == "verify" else arg
                mode = " prompt" if kind == "prefill" else ""
                key = f"{kern}{mode} q [{nb}, {c}, {cfg.n_heads}, {cfg.head_dim}] ({kind})"
            out[key] = out.get(key, 0) + n * per
    return out


def _knob_engine(dev: dict, seed: int, cfg, params, label: str, kw: dict, prompts) -> dict:
    """One shape-knob deployment of Gemma-2B: its geometry and launch plan
    printed beside the JAX meaning of each knob, warmup (every family
    captured), every family's replay bitwise its eager program (the lazy
    ones too), one burst at lookahead 3 with its launches by shape, every
    served token through the replay gate (TOKEN_GAP bf16, INT8_TOKEN_GAP on
    an int8 pool, at most 1 token in 8)."""
    eng = LLMEngine(cfg, params, seed=seed, **kw)
    try:
        st, kv = eng.stats(), eng.kv
        K, P = kw["decode_chunk"], kw.get("prefill_chunk", TL.PREFILL_CHUNK)
        want = {"decode_chunk": K, "chunk_short": max(1, K // 4), "chunk_shapes": tuple(sorted(
                    {min(b, P) for b in eng.prefill_buckets})) if eng.chunked else eng.chunk_shapes,
                "block": kw["kv_block"], "table_width": -(-eng.max_seq_len // kw["kv_block"]),
                "budget": kw["step_token_budget"]}
        got = {"decode_chunk": eng.decode_chunk, "chunk_short": eng._chunk_short, "chunk_shapes": eng.chunk_shapes,
               "block": kv.block, "table_width": kv.table_width, "budget": eng.step_token_budget}
        pool_dtype = torch.int8 if kv.int8 else cfg.dtype
        splits, smem = A.paged_decode_plan(pool_dtype, eng.slots, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                           kv.block, kv.table_width)
        print(f"{label}knobs {kw}: scheduler {st['scheduler']}, chunk shapes {eng.chunk_shapes}, short chunk "
              f"{eng._chunk_short}, KV {kv.stats()['layout']} block {kv.block} x {kv.pool.n_blocks} blocks (table "
              f"width {kv.table_width}, capacity {kv.capacity}, append slack {kv.append_slack}, {kv.block_bytes} "
              f"bytes a block, int8 {kv.int8}); paged-decode plan {splits} splits, {smem} bytes of shared memory "
              f"per CTA; programs {sorted(eng._programs)}")
        if got != want:
            raise AssertionError(f"{label}engine shapes {got}, expected {want}")
        warm = _warm_report(label, eng)
        _check_families(label, eng, seed, extra=sorted(eng._lazy))
        eng.generate([1, 2, 3], max_new_tokens=4)
        with _replay_names(eng) as counts:
            if eng.chunked:
                (run,) = _bursts(label, eng, prompts, 32, KERNEL_COUNTERS, lookaheads=(3,))
            else:
                st0 = eng.stats()
                (run,) = _clocked_bursts(label, eng, prompts, 32, (3,))
                run.update(_wave_stats(eng, st0))
        by_shape = _launches_by_shape(eng, counts)
    finally:
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    print(f"{label}replays by family {counts}; launches by shape {by_shape}")
    for kern in ("flash_attention", "paged_decode_partials", "paged_decode_partials_int8"):
        if sum(n for k, n in by_shape.items() if k.split(" ")[0] == kern) != run["launches"][kern]:
            raise AssertionError(f"{label}{kern}: launches by shape {by_shape} do not sum to {run['launches']}")
    paged = "paged_decode_partials_int8" if kw.get("kv_int8") else "paged_decode_partials"
    if kw["step_token_budget"]:
        if run["launches"]["flash_attention"] <= 0 or run["launches"][paged] <= 0 or run["launches"][
                "flash_attention_prompt"]:
            raise AssertionError(f"{label}kernel launches {run['launches']}")
    else:
        _wave_launches(label, run["launches"], paged)
    gap = INT8_TOKEN_GAP if kw.get("kv_int8") else TOKEN_GAP
    c, e = _replay_gate(params, cfg, prompts, run["results"], gap, label=label, verbose=False)
    if kw.get("kv_int8") and 8 * e > run["tokens"]:
        raise AssertionError(f"{label}{e} of {run['tokens']} tokens needed the int8 gap")
    out = {"tok_s": run["tok_s"], "ttft_p50_s": run["ttft_p50_s"], "ttft_max_s": run["ttft_max_s"],
           "programs": run["chunks"], "steps": run["steps"], "families": len(warm["families"]),
           "warmup_s": warm["warmup_s"], "reserved_growth": warm["reserved_after"] - warm["reserved_before"],
           "launches": run["launches"], "by_shape": by_shape, "matched": c, "exempt": e, "splits": splits,
           "smem": smem, "waves": run.get("waves"), "idle": run.get("idle")}
    waves = "" if out["waves"] is None else f", waves {out['waves']}, idle {100 * out['idle']:.1f}%"
    print(f"{label}gemma_2b on {dev['smi']}: {out['tok_s']:.1f} tok/s at lookahead 3; ttft p50 "
          f"{out['ttft_p50_s']:.3f}s max {out['ttft_max_s']:.3f}s; {out['programs']} programs ({out['steps']} unified "
          f"steps{waves}); "
          f"{out['families']} families captured in {out['warmup_s']:.3f} s (warmup_s), memory_reserved "
          f"+{out['reserved_growth']}; {c} tokens matched, {e} exempt (gap {gap}); launches {run['launches']}")
    return out


KNOB_LAYERS = 4  # of Gemma-2B's 18 (18, then 9, then 6 as later phases took the script's time)


def phase_knobs(dev: dict, seed: int, cfg=None, params=None) -> dict:
    """The engine's shape knobs on Gemma-2B at full width and half its
    depth (see the module docstring): the first KNOB_LAYERS layers of the
    same weights, views of them. Returns each engine's readings and its
    kernel launches by label."""
    if params is None:
        cfg, params = gemma_weights(seed)
    cfg = dataclasses.replace(cfg, n_layers=KNOB_LAYERS)
    params = {**params, "layers": {k: v[:KNOB_LAYERS] for k, v in params["layers"].items()}}
    _plens, prompts = _burst_prompts(cfg, seed)
    out, clock = {}, {}
    for name, kw in KNOB_ENGINES + (("wave b32", KNOB_WAVE),):
        t0 = time.perf_counter()
        out[name] = _knob_engine(dev, seed, cfg, params, f"knobs {name} ", kw, prompts)
        clock[name] = time.perf_counter() - t0
    print("knobs seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in clock.items()))
    out["launches"] = {name: out[name]["launches"] for name in list(out)}
    return out


MNIST_REQUESTS, MNIST_CLIENTS, MNIST_HTTP = 2000, 64, 200
MNIST_ATOL = 0.1  # bf16 weights and activations against the f32 plain forward (three layers)


def phase_mnist(dev: dict, seed: int) -> dict:
    """The plain-model path (see the module docstring): the MNIST app over
    the MLP at its published widths (784 -> 512 -> 256 -> 10, bf16, random
    weights from the seed), 2,000 single-example requests from 64
    concurrent clients through infer_async, then 200 over HTTP POST
    /infer; requests/s, p50/p99 latency, the waves by width, and every
    answer against the float32 plain forward of its own image."""
    from gofr_tpu_torch import serve_mnist
    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.models.mlp import MLPConfig, mlp_forward, mlp_init

    label = "mnist "
    cfg = MLPConfig()
    params = mlp_init(torch.Generator().manual_seed(seed), cfg, "cuda")
    images = np.random.default_rng(seed).standard_normal((MNIST_REQUESTS, cfg.in_dim)).astype(np.float32)
    with torch.inference_mode():
        plain = mlp_forward({k: v.float() for k, v in params.items()}, torch.from_numpy(images).cuda()).cpu().numpy()
    t0 = time.perf_counter()
    app = serve_mnist.build_app(new_mock_config({"HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "30", "LOG_LEVEL": "ERROR"}),
                                params=params)
    register_s = time.perf_counter() - t0
    th = app.run_in_background()
    rt = app.container.tpu()
    batcher = rt.model(serve_mnist.MODEL).batcher
    try:
        outs: list = [None] * MNIST_REQUESTS
        lat: list[float] = []

        async def client(idx):
            for i in idx:
                t = time.perf_counter()
                outs[i] = await rt.infer_async(serve_mnist.MODEL, images[i])
                lat.append(time.perf_counter() - t)

        async def burst():
            await asyncio.gather(*(client(range(c, MNIST_REQUESTS, MNIST_CLIENTS)) for c in range(MNIST_CLIENTS)))

        batcher.widths.clear()
        t0 = time.perf_counter()
        asyncio.run(burst())
        wall = time.perf_counter() - t0
        widths = dict(sorted(batcher.widths.items()))
        got = np.stack(outs)
        err = float(np.abs(got - plain).max())
        lat.sort()
        run = {"requests_s": MNIST_REQUESTS / wall, "p50_ms": 1e3 * lat[len(lat) // 2],
               "p99_ms": 1e3 * lat[int(0.99 * len(lat))], "widths": widths, "max_abs_err": err}
        print(f"{label}infer_async: {MNIST_REQUESTS} requests from {MNIST_CLIENTS} clients in {wall:.3f}s = "
              f"{run['requests_s']:.1f} requests/s; latency p50 {run['p50_ms']:.3f} ms p99 {run['p99_ms']:.3f} ms; "
              f"waves by requests {widths}; max_abs_err vs the f32 plain forward {err:.4e}")
        if got.shape != (MNIST_REQUESTS, cfg.out_dim) or not np.isfinite(got).all() or err > MNIST_ATOL:
            raise AssertionError(f"{label}outputs {got.shape}, max_abs_err {err}")
        if sum(n * k for n, k in widths.items()) != MNIST_REQUESTS or max(widths) > batcher.max_batch:
            raise AssertionError(f"{label}waves {widths}")
        # over HTTP: the example's route and envelope
        port = app.http_server.port
        http_lat: list[float] = []
        answers: dict[int, dict] = {}

        def post(i):
            status, raw, _first, seconds, _ = _http(port, "POST", "/infer", {"image": images[i].tolist()}, timeout=60)
            http_lat.append(seconds)
            if status != 201:
                raise AssertionError(f"{label}POST /infer answered {status}: {raw[:200]}")
            answers[i] = json.loads(raw)["data"]

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(MNIST_CLIENTS) as ex:
            list(ex.map(post, range(MNIST_HTTP)))
        http_wall = time.perf_counter() - t0
        http_lat.sort()
        http_err = max(float(np.abs(np.asarray(answers[i]["logits"]) - plain[i]).max()) for i in answers)
        agree = sum(answers[i]["digit"] == int(np.argmax(plain[i])) for i in answers)
        status, raw, _first, _s, _ = _http(port, "GET", "/model")
        info = json.loads(raw)
        models = info["data"]["details"]["models"] if status == 200 else {}
        run["http"] = {"requests_s": MNIST_HTTP / http_wall, "p50_ms": 1e3 * http_lat[len(http_lat) // 2],
                       "p99_ms": 1e3 * http_lat[int(0.99 * len(http_lat))], "max_abs_err": http_err,
                       "digits_agree": agree}
        print(f"{label}HTTP POST /infer: {MNIST_HTTP} requests from {MNIST_CLIENTS} clients in {http_wall:.3f}s = "
              f"{run['http']['requests_s']:.1f} requests/s; latency p50 {run['http']['p50_ms']:.3f} ms p99 "
              f"{run['http']['p99_ms']:.3f} ms; max_abs_err {http_err:.4e}; digits equal to the f32 plain argmax "
              f"{agree} of {MNIST_HTTP}; GET /model {status} {models}")
        if http_err > MNIST_ATOL or serve_mnist.MODEL not in models:
            raise AssertionError(f"{label}HTTP answers: max_abs_err {http_err}, /model {status} {info}")
    finally:
        app.shutdown()
        th.join(timeout=30)
    if th.is_alive():
        raise AssertionError(f"{label}the app did not stop")
    print(f"mnist mlp on {dev['smi']}: registered and warmed (buckets 1-64) in {register_s:.3f}s; "
          f"{run['requests_s']:.1f} requests/s, p50 {run['p50_ms']:.3f} ms, p99 {run['p99_ms']:.3f} ms through "
          f"infer_async; HTTP {run['http']['requests_s']:.1f} requests/s, p50 {run['http']['p50_ms']:.3f} ms")
    return run


FLEET_WATCHDOG_S = 3.0  # the fleet's step watchdog: far above a step's ~0.1 s, under the phase's budget
FLEET_PINNED = 4  # requests pinned to the replica that is killed
FLEET_PINNED_NEW = 96  # their new tokens: every stream is mid-decode at the fault
FLEET_LAYERS = 4  # of Gemma-2B's 18 (full width), for the script's time (6 until the broker parts)
FLEET_REBUILD_BURSTS = 3  # survivor bursts served while a replica is rebuilt
FLEET_TENANTS = ("fleet-a", "fleet-b")  # the fleet burst's clients, alternating


def _fleet_memory(label: str) -> int:
    """memory_reserved once collected (a dead replica's tensors go with its
    engine object) and the allocator's cache emptied."""
    gc.collect()
    torch.cuda.empty_cache()
    m = torch.cuda.memory_reserved()
    print(f"fleet memory {label}: torch.cuda.memory_reserved {m} bytes")
    return m


def _fleet_pinned(eng, prompts, new_tokens: int, arm, want: dict, params, cfg, label: str, trigger: str) -> dict:
    """Submit ``prompts`` to replica ``eng`` directly, ``arm()`` once each
    has its first token, and collect the streams, which fail over: each
    must equal the unfaulted stream ``want[i]`` or leave it only at a near
    tie, and pass the replay gate. The death must write one bundle of class
    ``trigger`` holding every pinned request's in-flight record. Returns
    the readings."""
    reqs = [eng.submit(GenRequest(p, max_new_tokens=new_tokens)) for p in prompts]
    _wait_until(lambda: all(r.emitted > 0 for r in reqs), 120, f"{label}first tokens")
    watch = _watch_incidents(eng)
    t0 = time.perf_counter()
    arm()
    _wait_until(lambda: not eng.alive(), 60, f"{label}the replica's death")
    t_dead = time.perf_counter() - t0
    got = {i: r.tokens(timeout=600) for i, r in enumerate(reqs)}
    t_done = time.perf_counter() - t0
    bad = [i for i, r in enumerate(reqs) if r.finish_reason != "length" or len(got[i]) != new_tokens]
    if bad:
        raise AssertionError(f"{label}streams {bad} did not finish: {[reqs[i].finish_reason for i in bad]}")
    if not all(r.deaths == 1 and r.retries == 1 for r in reqs):
        raise AssertionError(f"{label}deaths/retries {[(r.deaths, r.retries) for r in reqs]}")
    equal = sum(got[i] == want[i] for i in got)
    differ = _divergence_at_near_ties(params, cfg, prompts, got, want, TOKEN_GAP, label)
    checked, exempt = _replay_gate(params, cfg, prompts, got, TOKEN_GAP, label=label, verbose=False)
    if len(watch) != 1 or watch[0]["trigger"] != trigger:
        raise AssertionError(f"{label}bundles {watch}, want one {trigger!r}")
    b = _bundle(watch[0]["path"], label)
    inflight = {rec["id"] for rec in b["records"] if not rec["final"]}
    if b["manifest"]["trigger"] != trigger or not {r.id for r in reqs} <= inflight:
        raise AssertionError(f"{label}bundle {b['manifest']}, in-flight records {sorted(inflight)}")
    print(f"{label}{eng.label} died ({eng.died_reason}) {t_dead:.3f}s after the arm; {len(reqs)} streams failed over "
          f"and ended {t_done:.3f}s after it; {equal} of {len(reqs)} equal the unfaulted streams, {differ} leave "
          f"them at a near-tie; replay gate {checked} matched, {exempt} exempt; bundle {trigger} "
          f"{os.path.basename(watch[0]['path'])} in {1e3 * watch[0]['s']:.1f} ms (writes {1e3 * watch[0]['dump_s']:.1f} "
          f"ms), a fetch still in flight: {watch[0]['fetch_in_flight']}, {len(inflight)} in-flight records")
    return {"died_reason": eng.died_reason, "death_s": t_dead, "done_s": t_done, "equal": equal, "differ": differ,
            "matched": checked, "exempt": exempt, "bundle": watch[0]}


def _fleet_rebuilt(rep, i: int, corpse, label: str, busy=None) -> dict:
    """Wait for the supervisor to route a rebuilt slot ``i`` and report it.
    With ``busy``, the survivors serve (``busy()``) until then, at least
    once, and on the card at least one such burst must end while the
    rebuild (a capture beside the survivor's replays) is still under way."""
    served = overlapped = 0
    t0 = time.perf_counter()

    def rebuilt() -> bool:
        return rep.engines[i] is not corpse and rep.engines[i].alive()

    while not rebuilt() or (busy is not None and not served):
        if time.perf_counter() - t0 > 180:
            raise TimeoutError(f"{label}no rebuild of replica {i} in 180 s")
        if busy is None or served >= FLEET_REBUILD_BURSTS:
            time.sleep(0.05)  # a capture beside live bursts takes ~2x longer (PERF.md)
            continue
        busy()
        served += 1
        overlapped += not rebuilt()
    if busy is not None and not overlapped and rep.device.type == "cuda":
        raise AssertionError(f"{label}no survivor burst ended while replica {i} was rebuilt")
    sup = rep.supervisor
    print(f"{label}replica {i} rebuilt and routed back by the supervisor in {sup.rebuild_s[-1]:.3f} s "
          f"(build + warmup + canary; restarts {sup.restarts}, canary rejects {sup.canary_rejects}); "
          f"its warmup_s {rep.engines[i].warmup_s}; {served} survivor burst(s), {overlapped} ended during the rebuild")
    return {"rebuild_s": sup.rebuild_s[-1], "warmup_s": rep.engines[i].warmup_s, "bursts_during": overlapped}


def phase_fleet(dev: dict, seed: int, cfg=None, params=None, main: dict | None = None) -> dict:
    """The replica fleet and its recovery (see the module docstring).
    Returns its readings and the launches of its unfaulted burst."""
    if params is None:
        cfg, params = gemma_weights(seed)
    cfg, params = _first_layers(cfg, params, FLEET_LAYERS)
    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.resilience import default_injector, device_key
    from gofr_tpu_torch.serve import build_app

    inj = default_injector()
    # a fast supervisor; the device ledger quarantines the card at the
    # phase's fifth failure (four injected deaths, then a refused rebuild),
    # not at its third death: one card hosts every replica here
    knobs = {"TPU_LLM_SUPERVISOR_INTERVAL_S": "0.05", "TPU_LLM_RESTART_BACKOFF_S": "0.1",
             "TPU_LLM_DEVICE_QUARANTINE_FAILURES": "5"}
    env0 = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    out: dict = {}
    mem0 = _fleet_memory("before the fleet")
    app = build_app(new_mock_config({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "GEMMA_PRESET": "2b", "LLM_SLOTS": "32", "LLM_MAX_SEQ": "512", "LLM_REPLICAS": "2",
        "TPU_LLM_STEP_WATCHDOG_S": str(FLEET_WATCHDOG_S), "REQUEST_TIMEOUT": "600", "LOG_LEVEL": "WARN",
    }), params=params)
    thread = app.run_in_background()
    port = app.http_server.port
    try:
        rep = app.container.tpu().llm("gemma")  # the model's handle: the fleet's surface passes through
        if type(rep.engine).__name__ != "ReplicatedLLMEngine" or len(rep.engines) != 2:
            raise AssertionError(f"register_llm(replicas=2) built {type(rep.engine).__name__}")
        out["warmup"] = [_warm_report(f"fleet r{i} ", e) for i, e in enumerate(rep.engines)]
        mem1 = _fleet_memory("after building 2 replicas")
        lead = rep.engines[0]
        graphs = lead.warmup_reserved[1] - lead.warmup_reserved[0]
        footprint = _tensor_bytes(lead.params) + _pool_bytes(lead.kv) + graphs
        print(f"fleet: one replica's footprint {footprint} bytes (weights copy {_tensor_bytes(lead.params)}, KV pool "
              f"{_pool_bytes(lead.kv)}, graphs {graphs}); the build added {mem1 - mem0}")
        del lead
        rep.generate([1, 2, 3], max_new_tokens=4)  # warm-up request, outside the timed run
        plens, prompts = _burst_prompts(cfg, seed)
        new_tokens = 32

        # 1. the main burst through the fleet, every token through the gate;
        # two tenants, billed by the meter the replicas share
        _zero_launches(KERNEL_COUNTERS)
        tenants = [FLEET_TENANTS[i % 2] for i in range(len(prompts))]
        want, reqs, wall = _serve(rep, prompts, new_tokens, clients=tenants)
        out["launches"] = _launches(KERNEL_COUNTERS)
        _quiet(*rep.engines)
        billed = {t: sum(rep.usage.snapshot()["tenants"][t]["cum_chip_s"].values()) for t in FLEET_TENANTS}
        served_by = {t: {e.label for e in rep.engines for rec in e.flightrec.records() if rec["client"] == t}
                     for t in FLEET_TENANTS}
        for t in FLEET_TENANTS:
            got = _chip_sum(r for r in reqs.values() if r.client == t)
            if abs(got - billed[t]) > 1e-5 + 1e-3 * billed[t]:
                raise AssertionError(f"fleet: {t}'s requests hold {got} chip-s, the shared meter billed {billed[t]}")
        if len(set().union(*served_by.values())) != 2:
            raise AssertionError(f"fleet: the burst reached {served_by}")
        if any(out["launches"][k] <= 0 for k in ("flash_attention", "paged_decode_partials")):
            raise AssertionError(f"fleet burst launches {out['launches']}")
        total = sum(len(t) for t in want.values())
        ttfts = sorted(r.first_token_at - r.submitted_at for r in reqs.values())
        checked, exempt = _replay_gate(params, cfg, prompts, want, TOKEN_GAP, label="fleet ", verbose=False)
        out["tok_s"] = total / wall
        print(f"fleet burst on {dev['smi']}: 2 replicas, {total} tokens in {wall:.3f}s = {out['tok_s']:.1f} tok/s "
              f"(one 18-layer engine, engine phase: {main['tok_s'] if main else float('nan'):.1f}); ttft p50 {ttfts[len(ttfts) // 2]:.3f}s; "
              f"requests per replica {[e.submitted for e in rep.engines]}; replay gate {checked} matched, "
              f"{exempt} exempt; launches {out['launches']}; the shared meter billed {billed} chip-s, each "
              f"tenant's requests' _chip summed, served by {served_by}")

        # 2. replica_kill mid-decode on r0 under 4 pinned streams; the
        # supervisor rebuilds r0 behind the canary while r1 serves bursts
        sub = prompts[:FLEET_PINNED]
        long_want, _r, _w = _serve(rep, sub, FLEET_PINNED_NEW)  # their unfaulted streams
        corpse = rep.engines[0]
        out["kill"] = _fleet_pinned(corpse, sub, FLEET_PINNED_NEW, lambda: inj.arm("replica_kill", label="/r0"),
                                    long_want, params, cfg, "fleet kill ", "engine_death")
        if rep.failovers < FLEET_PINNED:
            raise AssertionError(f"fleet: {rep.failovers} failovers")

        def busy():
            res, _r, w = _serve(rep, prompts, new_tokens)
            c, e = _replay_gate(params, cfg, prompts, res, TOKEN_GAP, label="fleet survivor ", verbose=False)
            print(f"fleet survivor burst during the rebuild: {sum(map(len, res.values())) / w:.1f} tok/s, "
                  f"gate {c} matched, {e} exempt")
            return c

        out["kill"].update(_fleet_rebuilt(rep, 0, corpse, "fleet kill ", busy=busy))
        del corpse
        out["mem_after"] = [_fleet_memory("after death 1 and its rebuild")]
        before = rep.engines[0].submitted
        res, _r, _w = _serve(rep, prompts[:4], new_tokens)
        _replay_gate(params, cfg, prompts[:4], res, TOKEN_GAP, label="fleet back ", verbose=False)
        if rep.engines[0].submitted <= before:
            raise AssertionError("fleet: the rebuilt r0 took no traffic")
        print(f"fleet: the rebuilt r0 took {rep.engines[0].submitted - before} of 4 requests")

        # 3. a hung fetch on r1 past the step watchdog
        corpse = rep.engines[1]
        out["watchdog"] = _fleet_pinned(
            corpse, sub[:2], FLEET_PINNED_NEW,
            lambda: inj.arm("step_latency", label="/r1", delay=FLEET_WATCHDOG_S + 2.0),
            long_want, params, cfg, "fleet watchdog ", "watchdog",
        )
        if not out["watchdog"]["died_reason"].startswith("step watchdog"):
            raise AssertionError(f"fleet watchdog: {out['watchdog']['died_reason']}")
        wb = out["watchdog"]["bundle"]  # taken beside the hung fetch, never behind it
        if not wb["fetch_in_flight"] or wb["s"] > 2.0 + wb["dump_s"]:
            raise AssertionError(f"fleet watchdog: the bundle took {wb['s']:.3f}s, fetch in flight {wb['fetch_in_flight']}")
        out["watchdog"].update(_fleet_rebuilt(rep, 1, corpse, "fleet watchdog "))
        del corpse
        out["mem_after"].append(_fleet_memory("after death 2 and its rebuild"))

        # 4. non-finite logits on r0: the numerical watchdog
        corpse = rep.engines[0]
        out["numerical"] = _fleet_pinned(
            corpse, sub[:2], FLEET_PINNED_NEW, lambda: inj.arm("nan_logits", label="/r0"),
            long_want, params, cfg, "fleet numerical ", "numerical",
        )
        if not out["numerical"]["died_reason"].startswith("numerical watchdog: non-finite logits"):
            raise AssertionError(f"fleet numerical: {out['numerical']['died_reason']}")
        out["numerical"].update(_fleet_rebuilt(rep, 0, corpse, "fleet numerical "))
        del corpse
        out["mem_after"].append(_fleet_memory("after death 3 and its rebuild"))
        for m in out["mem_after"]:
            if m - mem1 > footprint:
                raise AssertionError(f"fleet: memory_reserved {m} grew past one replica ({footprint}) over {mem1}")

        # 5. over HTTP: a long /generate whose replica is killed mid-stream;
        # the card then refuses its rebuild (device_sick), so the slot parks
        long_prompt, long_new = prompts[6], 96  # 200 + 96 tokens: inside max_seq_len 512 with the decode room
        ref = rep.generate(long_prompt, max_new_tokens=long_new)
        answer: dict = {}
        th = threading.Thread(target=lambda: answer.update(
            r=_http(port, "POST", "/generate", {"tokens": long_prompt, "max_new_tokens": long_new})))
        th.start()

        def serving():
            for e in rep.engines:
                if any(r is not None and r.emitted > 0 for r in list(e._slot_req)):
                    return e
            return None

        _wait_until(lambda: serving() is not None, 120, "fleet http: the long request's first tokens")
        victim = serving()
        card = device_key(rep.device)
        inj.arm("device_sick", label=card, count=-1)
        inj.arm("replica_kill", label=victim.label[-3:])
        th.join(timeout=600)
        status, raw, _, _, _ = answer["r"]
        toks = json.loads(raw)["data"]["tokens"] if status == 201 else None
        if toks is None or len(toks) != long_new:
            raise AssertionError(f"fleet http: {status} {raw[:200]!r}")
        differ = _divergence_at_near_ties(params, cfg, [long_prompt], {0: toks}, {0: ref}, TOKEN_GAP, "fleet http ")
        _replay_gate(params, cfg, [long_prompt], {0: toks}, TOKEN_GAP, label="fleet http ", verbose=False)
        print(f"fleet http: {victim.label} died ({victim.died_reason}) under a {long_new}-token /generate: 201 with "
              f"{long_new} tokens, {'equal to' if toks == ref else 'leaving at a near-tie'} the unfaulted stream "
              f"({differ} differ)")
        out["http_equal"] = toks == ref
        del victim
        _wait_until(lambda: rep.supervisor.parked_count() == 1, 120, "fleet http: the parked slot")
        status, raw, _, _, _ = _http(port, "GET", "/.well-known/health")
        health = json.loads(raw)["data"]["status"] if status == 200 else None
        if health != "degraded":
            raise AssertionError(f"fleet health with a parked slot: {status} {raw[:200]!r}")
        print(f"fleet: device_sick refused {rep.supervisor.restart_failures} rebuild(s); {card} "
              f"{rep.health.state(card)}; slot parked; health {health}")

        # the bundles over HTTP, newest first: every death's class and the
        # quarantine's; the usage view pools both replicas
        status, raw, _, _, _ = _http(port, "GET", "/.well-known/debug/blackbox")
        listing = json.loads(raw)["data"]["bundles"] if status == 200 else None
        triggers = [m["trigger"] for m in listing or []]
        ts = [m["ts"] for m in listing or []]
        if not {"engine_death", "watchdog", "numerical", "quarantine"} <= set(triggers) or ts != sorted(ts, reverse=True):
            raise AssertionError(f"fleet: GET /.well-known/debug/blackbox {status}: {triggers}")
        q = next(m for m in listing if m["trigger"] == "quarantine")
        status, raw, _, _, _ = _http(port, "GET", "/.well-known/debug/usage")
        view = json.loads(raw)["data"]["models"]["gemma"] if status == 200 else None
        pooled = view and view["goodput"]
        if (view is None or view["replicas"] != 2 or abs(pooled["attributed_s"] + pooled["idle_s"] - pooled["wall_s"])
                > 0.01 * pooled["wall_s"] or any(abs(sum(view["tenants"][t]["cum_chip_s"].values()) - billed[t])
                                                 > 1e-5 + 1e-3 * billed[t] for t in FLEET_TENANTS)):
            raise AssertionError(f"fleet: GET /.well-known/debug/usage {status}: {raw[:400]!r}")
        print(f"fleet blackbox: {len(listing)} bundles newest first, triggers {triggers}; quarantine: "
              f"{q['reason']!r}; debug/usage: 2 replicas pooled, wall {pooled['wall_s']} s = attributed "
              f"{pooled['attributed_s']} + idle {pooled['idle_s']}, ratio {pooled['goodput_ratio']}; tenants "
              f"{ {t: view['tenants'][t]['cum_chip_s'] for t in FLEET_TENANTS} }")
        out["bundles"] = triggers

        # 6. the drain: health 503, liveness 200, the server closes
        status, raw, _, _, _ = _http(port, "POST", "/.well-known/debug/drain", {})
        if status != 201 or not json.loads(raw)["data"]["draining"]:
            raise AssertionError(f"fleet drain: {status} {raw[:200]!r}")
        t0 = time.perf_counter()
        h503 = _http(port, "GET", "/.well-known/health")[0]
        alive = _http(port, "GET", "/.well-known/alive")[0]
        thread.join(timeout=120)
        if h503 != 503 or alive != 200 or thread.is_alive():
            raise AssertionError(f"fleet drain: health {h503}, alive {alive}, server running {thread.is_alive()}")
        print(f"fleet drain: health 503, liveness 200, server closed {time.perf_counter() - t0:.3f}s after the drain; "
              f"failovers {rep.failovers}, failover errors {rep.failover_errors}, restarts {rep.supervisor.restarts}")
        out["failovers"] = rep.failovers
    finally:
        inj.disarm()
        app.shutdown()
        thread.join(timeout=120)
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["mem_closed"] = _fleet_memory("after the fleet closed")
    return out


ROLLOUT_LAYERS = 4  # of Gemma-2B's 18, full width: the rollout phase builds 6 engines
DISAGG_LAYERS = 4  # and the disagg phase 3
ROLLOUT_BAKE_S = 2.0
HANDOFF_DELAY_CYCLES = 1_500_000_000  # the decode stream's head start in the disagg phase: ~0.8 s of SM clock
ROLLOUT_TRAFFIC_NEW = 16  # new tokens of each request the clients send through a shift
ROLLOUT_GATED = 24  # client streams per version through the replay gate (evenly spaced; all are checked whole)


def _rollout_weights(cfg, seed: int) -> dict:
    """Random weights with an untied random head: a tied random model
    answers its input token again under any seed, so two versions would
    serve the same streams. The head's std 1 / sqrt(d) keeps logits near
    std 1, where one bf16 step is 1/32 or finer: at std 1 (the CPU tests'
    tiny head) Gemma's width puts them in the hundreds (a step of 1.0), at
    4 / sqrt(d) near 16-32 (a step of 0.125), and bf16 rounding across the
    served path's chunkings then moves a top-2 gap past the replay gate's
    0.25."""
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    head = torch.randn(cfg.vocab_size, cfg.d_model, generator=g, device="cuda") / math.sqrt(cfg.d_model)
    params["unembed"] = head.to(cfg.dtype)
    return params


def _hf_llama_tensors(params: dict, cfg) -> dict:
    """The port's tree in the HF layout the Llama mapper reads (the inverse
    of ``llama_params_from_hf``, which also takes an untied
    ``lm_head.weight``): linear weights as [out, in], K and V split out of
    ``wkv``, norms stored as HF's scale (ours + 1, float32: exact for the
    zero norms of ``init_params``)."""
    d, hd, hkv, lay = cfg.d_model, cfg.head_dim, cfg.n_kv_heads, params["layers"]
    t = {"model.embed_tokens.weight": params["embed"], "lm_head.weight": params["unembed"],
         "model.norm.weight": params["final_norm"].float() + 1.0}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        for leaf, hf in (("wq", "self_attn.q_proj"), ("wo", "self_attn.o_proj"), ("w_gate", "mlp.gate_proj"),
                         ("w_up", "mlp.up_proj"), ("w_down", "mlp.down_proj")):
            t[p + hf + ".weight"] = lay[leaf][i].T
        kv = lay["wkv"][i].view(d, hkv, 2, hd)
        for j, hf in enumerate(("self_attn.k_proj", "self_attn.v_proj")):
            t[p + hf + ".weight"] = kv[:, :, j].reshape(d, hkv * hd).T
        t[p + "input_layernorm.weight"] = lay["attn_norm"][i].float() + 1.0
        t[p + "post_attention_layernorm.weight"] = lay["mlp_norm"][i].float() + 1.0
    return t


def _rollout_clients(handle, prompts, stop: threading.Event) -> tuple[threading.Thread, dict]:
    """A client serving ``prompts`` as bursts of ROLLOUT_TRAFFIC_NEW tokens
    until ``stop``: it counts bursts and failed requests (an exception, or
    a stream cut short), keeps each stream under the version of the
    replica that served it, and the highest memory_reserved it saw."""
    log: dict = {"bursts": 0, "failed": [], "streams": {}, "peak": torch.cuda.memory_reserved()}

    def run():
        while not stop.is_set():
            try:
                res, reqs, _w = _serve(handle, prompts, ROLLOUT_TRAFFIC_NEW)
            except BaseException as e:  # a failed request: the phase fails on it below
                log["failed"].append(repr(e))
                continue
            for i, r in reqs.items():
                if r.finish_reason != "length" or len(res[i]) != ROLLOUT_TRAFFIC_NEW:
                    log["failed"].append(f"request {i}: {r.finish_reason}, {len(res[i])} tokens")
                log["streams"].setdefault(r.engine_version, []).append((i, res[i]))
            log["bursts"] += 1
            log["peak"] = max(log["peak"], torch.cuda.memory_reserved())

    th = threading.Thread(target=run, name="rollout-clients", daemon=True)
    th.start()
    return th, log


def _rollout_clients_end(th, stop, log: dict, weights: dict, cfg, prompts, label: str) -> None:
    """Stop the clients; no request may have failed, and ROLLOUT_GATED
    streams of each version, spread over the run, must pass the replay
    gate against that version's plain forward."""
    stop.set()
    th.join(timeout=600)
    if log["failed"]:
        raise AssertionError(f"{label}failed requests: {log['failed'][:5]}")
    gated = {}
    for v, streams in sorted(log["streams"].items()):
        pick = streams[:: max(1, -(-len(streams) // ROLLOUT_GATED))]
        c, e = _replay_gate(weights[v], cfg, [prompts[i] for i, _t in pick],
                            {j: t for j, (_i, t) in enumerate(pick)}, TOKEN_GAP, label=f"{label}{v} ", verbose=False)
        gated[v] = (len(streams), len(pick), c, e)
    print(f"{label}clients: {log['bursts']} bursts of {len(prompts)} requests, 0 failed; by version (requests, "
          f"gated, tokens matched, exempt) {gated}; peak memory_reserved {log['peak']} bytes")


def _rollout_wait(port: int, label: str, seconds: float = 600.0) -> dict:
    """GET /.well-known/debug/rollout until the model's rollout is terminal."""
    t0 = time.perf_counter()
    while True:
        status, raw, _, _, _ = _http(port, "GET", "/.well-known/debug/rollout")
        if status != 200:
            raise AssertionError(f"{label}GET rollout: {status} {raw[:200]!r}")
        view = json.loads(raw)["data"]["models"]["gemma"]
        if view["rollout"] is not None and view["rollout"]["state"] not in ("idle", "shifting", "baking",
                                                                            "rolling_back"):
            return view
        if time.perf_counter() - t0 > seconds:
            raise TimeoutError(f"{label}rollout not terminal in {seconds} s: {view['rollout']}")
        time.sleep(0.2)


def phase_rollout(dev: dict, seed: int) -> dict:
    """Zero-downtime rollouts (see the module docstring). Returns its
    readings and the launches from the v1 burst to the v2 burst."""
    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.resilience import default_injector
    from gofr_tpu_torch.serve import build_app

    cfg = dataclasses.replace(TransformerConfig.gemma_2b(), n_layers=ROLLOUT_LAYERS)
    weights = {v: _rollout_weights(cfg, seed + k) for v, k in (("v1", 101), ("v2", 103))}
    torch.cuda.synchronize()
    inj = default_injector()
    ckdir = Path("build") / "rollout_ckpt"
    out: dict = {}
    mem0 = _fleet_memory("before the rollout fleet")
    app = build_app(new_mock_config({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "GEMMA_PRESET": "2b", "LLM_SLOTS": "32", "LLM_MAX_SEQ": "512", "LLM_REPLICAS": "2",
        "REQUEST_TIMEOUT": "600", "LOG_LEVEL": "WARN",
    }), params=weights["v1"])
    thread = app.run_in_background()
    port = app.http_server.port
    try:
        h = app.container.tpu().llm("gemma")
        rep = h.engine
        if type(h).__name__ != "ModelHandle" or type(rep).__name__ != "ReplicatedLLMEngine" or len(rep.engines) != 2:
            raise AssertionError(f"rollout: register_llm built {type(h).__name__} over {type(rep).__name__}")
        mem1 = _fleet_memory(f"rollout: 2 replicas of a {ROLLOUT_LAYERS}-layer Gemma-2B built (a fresh device "
                             f"ledger: {rep.health.quarantines} quarantines)")
        lead = rep.engines[0]
        footprint = _tensor_bytes(lead.params) + _pool_bytes(lead.kv) + (lead.warmup_reserved[1] - lead.warmup_reserved[0])
        print(f"rollout: one replica's footprint {footprint} bytes (weights {_tensor_bytes(lead.params)}); the "
              f"build added {mem1 - mem0}; warmup_s {[e.warmup_s for e in rep.engines]}")
        del lead
        h.generate([1, 2, 3], max_new_tokens=4)
        _plens, prompts = _burst_prompts(cfg, seed)
        new_tokens = 32

        # 1. the v1 burst: the unfaulted streams the in-flight ones are held to
        _zero_launches(KERNEL_COUNTERS)
        want, _r, wall = _serve(h, prompts, new_tokens)
        c, e = _replay_gate(weights["v1"], cfg, prompts, want, TOKEN_GAP, label="rollout v1 ", verbose=False)
        print(f"rollout v1 burst: {sum(map(len, want.values())) / wall:.1f} tok/s, gate {c} matched, {e} exempt")

        # 2. the v2 checkpoint, written in the HF layout (Llama naming: it
        # carries the untied head)
        ckdir.mkdir(parents=True, exist_ok=True)
        ckpt = ckdir / "model.safetensors"
        t0 = time.perf_counter()
        _write_safetensors(str(ckpt), _hf_llama_tensors(weights["v2"], cfg))
        print(f"rollout: v2 checkpoint {ckpt.stat().st_size} bytes written in {time.perf_counter() - t0:.2f}s")
        # the written tree leaves the card: the fleet serves what the POST loads
        written = {k: ({n: x.cpu() for n, x in v.items()} if isinstance(v, dict) else v.cpu())
                   for k, v in weights.pop("v2").items()}

        # 3. the POST with 8 v1 streams in flight and clients sending traffic
        reqs = [h.submit(GenRequest(p, max_new_tokens=new_tokens)) for p in prompts]
        join = _consume(reqs)
        _wait_until(lambda: all(r.emitted > 0 for r in reqs), 120, "rollout: the burst's first tokens")
        stop = threading.Event()
        clients, log = _rollout_clients(h, prompts[:4], stop)
        mem_pre = _fleet_memory("rollout: before the deploy (v1 retained; 8 streams in flight)")
        t0 = time.perf_counter()
        status, raw, _, post_s, _ = _http(port, "POST", "/.well-known/debug/rollout", {
            "model": "gemma", "checkpoint": str(ckpt), "family": "llama", "bake_s": ROLLOUT_BAKE_S})
        if status != 201 or json.loads(raw)["data"]["rollout"]["to_version"] != "v2":
            raise AssertionError(f"rollout POST: {status} {raw[:300]!r}")
        got, _ends = join()
        late = [i for i, r in enumerate(reqs) if r.finish_reason != "length" or r.engine_version != "v1"]
        if late:
            raise AssertionError(f"rollout: in-flight streams {late} did not finish on v1")
        equal = sum(got[i] == want[i] for i in got)
        differ = _divergence_at_near_ties(weights["v1"], cfg, prompts, got, want, TOKEN_GAP, "rollout in-flight ")
        c_in, e_in = _replay_gate(weights["v1"], cfg, prompts, got, TOKEN_GAP, label="rollout in-flight ",
                                  verbose=False)
        view = _rollout_wait(port, "rollout ")
        shift_s = time.perf_counter() - t0
        loaded = rep._versions["v2"][1]  # what the POST loaded, and v2's replicas copied
        flat = lambda t: [t["embed"], t["unembed"], t["final_norm"], *(t["layers"][k] for k in sorted(t["layers"]))]  # noqa: E731
        bitwise = all(torch.equal(a.cpu(), b) for a, b in zip(flat(loaded), flat(written)))
        del written
        weights["v2"] = loaded
        _rollout_clients_end(clients, stop, log, weights, cfg, prompts[:4], "rollout shift ")
        # the fleet dropped v1 at the commit; so does the phase (v1 is made
        # again from its seed for the swap below)
        v1_gate = weights.pop("v1")
        snap = view["rollout"]
        if snap["state"] != "completed" or view["versions"] != {"v2": 2} or rep.version_counts() != {"v2": 2}:
            raise AssertionError(f"rollout: {snap['state']} {view['versions']} {snap['history']}")
        print(f"rollout: POST answered 201 in {post_s:.3f}s; {len(reqs)} v1 streams in flight at the POST finished on "
              f"v1, {equal} equal to the unfaulted v1 burst, {differ} leave it at a near-tie (gate {c_in} matched, "
              f"{e_in} exempt); GET reached {snap['state']} {shift_s:.1f}s after the POST (bake {ROLLOUT_BAKE_S}s), "
              f"versions {view['versions']}, retained {sorted(rep._versions)}; the loaded tree bitwise the written "
              f"one: {bitwise}; history {snap['history']}")
        del v1_gate
        mem_done = _fleet_memory("after the completed rollout")

        # 4. v2 serves: every token against the plain v2 forward
        v2_res, _r, wall = _serve(h, prompts, new_tokens)
        out["launches"] = _launches(KERNEL_COUNTERS)
        c, e = _replay_gate(weights["v2"], cfg, prompts, v2_res, TOKEN_GAP, label="rollout v2 ", verbose=False)
        moved = sum(v2_res[i] != want[i] for i in v2_res)
        print(f"rollout v2 burst: {sum(map(len, v2_res.values())) / wall:.1f} tok/s, gate {c} matched, {e} exempt; "
              f"{moved} of {len(prompts)} streams differ from v1's; launches since the v1 burst {out['launches']}")
        if moved == 0:
            raise AssertionError("rollout: v2 serves v1's streams")

        # 5. a redeploy whose canary fails: rolled back, fully on v2
        stop = threading.Event()
        clients, log = _rollout_clients(h, prompts[:4], stop)
        mem_pre2 = _fleet_memory("rollout: before the redeploy")
        inj.arm("rollout_canary_fail", count=1)
        t_arm = time.time()
        t0 = time.perf_counter()
        status, raw, _, _, _ = _http(port, "POST", "/.well-known/debug/rollout", {
            "model": "gemma", "checkpoint": str(ckpt), "family": "llama", "version": "v3", "bake_s": 0.5})
        if status != 201:
            raise AssertionError(f"rollout canary POST: {status} {raw[:300]!r}")
        view = _rollout_wait(port, "rollout canary ")
        back_s = time.perf_counter() - t0
        _rollout_clients_end(clients, stop, log, weights, cfg, prompts[:4], "rollout canary ")
        snap = view["rollout"]
        if (snap["state"], view["versions"], sorted(rep._versions), snap["canary_fails"]) != (
                "rolled_back", {"v2": 2}, ["v2"], 1):
            raise AssertionError(f"rollout canary: {snap['state']} {view['versions']} {snap['history']}")
        status, raw, _, _, _ = _http(port, "GET", "/.well-known/debug/blackbox")
        rb = [m for m in json.loads(raw)["data"]["bundles"] if m["trigger"] == "rollback" and m["ts"] >= t_arm]
        if status != 200 or len(rb) != 1:
            raise AssertionError(f"rollout canary: rollback bundles {rb} ({status})")
        print(f"rollout canary: {snap['state']} {back_s:.1f}s after the POST; error {snap['error']!r}; versions "
              f"{view['versions']}, retained {sorted(rep._versions)}; history {snap['history']}; one rollback bundle "
              f"{rb[0]['bundle']} ({rb[0]['reason']!r}), {rb[0]['ts'] - t_arm:.2f}s after the arm")
        mem_back = _fleet_memory("after the rollback")
        for label, m, m0 in (("completed", mem_done, mem_pre), ("rolled back", mem_back, mem_pre2)):
            if m - m0 > footprint:
                raise AssertionError(f"rollout: memory_reserved {m} after the {label} rollout is past one replica "
                                     f"({footprint}) over {m0} before the deploy")

        out.update({"shift_s": shift_s, "rollback_s": back_s, "in_flight_equal": equal, "footprint": footprint,
                    "mem": {"pre": mem_pre, "completed": mem_done, "pre_redeploy": mem_pre2, "rolled_back": mem_back}})
    finally:
        inj.disarm()
        app.shutdown()
        thread.join(timeout=120)
        shutil.rmtree(ckdir, ignore_errors=True)
    h = rep = weights = None  # the closed fleet's tensors go with it
    out["mem_closed"] = _fleet_memory("after the rollout fleet closed")
    return out


def _pool_launches(eng, counts: dict) -> dict:
    """{kernel: launches} of an engine's replays by family (``_replay_names``)."""
    out: dict = {}
    for name, n in counts.items():
        for kern, per in eng.families[name].launches.items():
            out[kern] = out.get(kern, 0) + n * per
    return out


def phase_disagg(dev: dict, seed: int) -> dict:
    """Disaggregated prefill/decode serving (see the module docstring).
    Returns its readings and the main burst's launches per pool."""
    cfg = dataclasses.replace(TransformerConfig.gemma_2b(), n_layers=DISAGG_LAYERS)
    params = _rollout_weights(cfg, seed + 105)  # untied: the streams are not the prompt's last token again
    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.datasource.gpu import GPURuntime
    from gofr_tpu_torch.resilience import default_injector

    _plens, prompts = _burst_prompts(cfg, seed)
    new_tokens = 32
    out: dict = {}
    mem0 = _fleet_memory("before the disaggregated fleet")
    ctrl = LLMEngine(cfg, params)
    try:
        ctrl.generate([1, 2, 3], max_new_tokens=4)
        want, _r, wall = _serve(ctrl, prompts, new_tokens)
    finally:
        ctrl.close()
    del ctrl
    print(f"disagg: the colocated engine's burst {sum(map(len, want.values())) / wall:.1f} tok/s (the reference)")
    rt = GPURuntime(new_mock_config({}))
    inj = default_injector()
    try:
        h = rt.register_llm("disagg", cfg, params, disagg=True, replicas=2, supervise=False)
        eng = h.engine
        peng, deng = eng.prefill.engines[0], eng.decode.engines[0]
        for e in (peng, deng):
            _warm_report(f"disagg {e.role} ", e)
        mem1 = _fleet_memory("disagg: 1 prefill + 1 decode replica built")
        print(f"disagg: the build added {mem1 - mem0}; handoff d2d {eng.handoff_d2d}, timeout {eng.handoff_timeout_s}s")
        h.generate([1, 2, 3], max_new_tokens=4)
        wrote: dict = {}
        commit = deng.kv.handoff_commit

        def spy(tokens, blocks, tail_block, tail_len, *, logits=None, logits_nbytes=0):
            # the blocks this import just wrote, read back on the decode stream
            idx = torch.tensor(blocks + ([tail_block] if tail_block >= 0 else []), device="cuda")
            wrote.setdefault(tuple(tokens), []).append(
                (deng.pool.k.index_select(1, idx).clone(), deng.pool.v.index_select(1, idx).clone(), logits.clone()))
            return commit(tokens, blocks, tail_block, tail_len, logits=logits, logits_nbytes=logits_nbytes)

        deng.kv.handoff_commit = spy

        # 1. the main burst, handed off device to device
        ok0, n0 = eng.handoffs_ok, len(eng._handoff_window)
        _zero_launches(KERNEL_COUNTERS)
        with _replay_names(peng) as pc, _replay_names(deng) as dc:
            got, _reqs, wall = _serve(h, prompts, new_tokens)
        total = _launches(KERNEL_COUNTERS)
        pools = {"prefill": _pool_launches(peng, pc), "decode": _pool_launches(deng, dc)}
        out["launches"] = {k: {p: pools[p].get(k, 0) for p in pools} for k in KERNEL_COUNTERS}
        if any(total[k] != pools["prefill"].get(k, 0) + pools["decode"].get(k, 0) for k in KERNEL_COUNTERS):
            raise AssertionError(f"disagg: launches {total} are not the pools' {pools}")
        st = h.stats()["handoff"]
        if (eng.handoffs_ok - ok0, st["miss"], st["fallbacks"]) != (len(prompts), 0, 0):
            raise AssertionError(f"disagg: handoffs {st}")
        if pools["decode"].get("flash_attention", 0) or not pools["decode"].get("paged_decode_partials", 0):
            raise AssertionError(f"disagg: the decode pool's launches {pools['decode']}")
        equal = sum(got[i] == want[i] for i in got)
        differ = _divergence_at_near_ties(params, cfg, prompts, got, want, TOKEN_GAP, "disagg ")
        c, e = _replay_gate(params, cfg, prompts, got, TOKEN_GAP, label="disagg ", verbose=False)
        walls = list(eng._handoff_window)[n0:]
        print(f"disagg burst on {dev['smi']}: {sum(map(len, got.values())) / wall:.1f} tok/s; handoffs ok "
              f"{eng.handoffs_ok - ok0}, miss {st['miss']}, fallbacks {st['fallbacks']}; {equal} of {len(prompts)} "
              f"streams equal the colocated engine's, {differ} leave them at a near-tie; gate {c} matched, {e} exempt")
        print(f"disagg launches by pool {pools} (all {total}); decode-pool replays {dict(dc)}; prefill-pool replays "
              f"{dict(pc)}")
        print(f"disagg handoff: {eng.handoff_bytes} K/V bytes moved in all; submit-to-decode-admit per request (s) "
              f"{[round(x, 4) for x in walls]}")

        # 2. the same burst host-staged: the imported blocks byte for byte
        eng.handoff_d2d = False
        got2, _r, wall2 = _serve(h, prompts, new_tokens)
        if eng.handoffs_ok - ok0 != 2 * len(prompts):
            raise AssertionError(f"disagg host-staged: handoffs {h.stats()['handoff']}")
        same = 0
        for p in prompts:
            rows = wrote.get(tuple(p), [])
            if len(rows) < 2:
                raise AssertionError(f"disagg: prompt of {len(p)} imported {len(rows)} times")
            a, b = rows[-2], rows[-1]
            if not all(torch.equal(x.view(torch.uint8), y.view(torch.uint8)) for x, y in zip(a, b)):
                raise AssertionError(f"disagg: the host-staged import of a {len(p)}-token prompt differs from d2d")
            same += sum(x.numel() * x.element_size() for x in a)
        differ2 = _divergence_at_near_ties(params, cfg, prompts, got2, got, TOKEN_GAP, "disagg host-staged ")
        print(f"disagg host-staged: {sum(map(len, got2.values())) / wall2:.1f} tok/s; the {len(prompts)} imports "
              f"byte-identical to the d2d ones ({same} bytes of K, V and logits); {differ2} streams differ from d2d")
        eng.handoff_d2d = True
        deng.kv.handoff_commit = commit

        # 3. concurrent handoffs while the decode stream runs behind: every
        # import returns, and its payload is dropped, before that stream
        # reads what the import queued on it, so a payload's memory the
        # allocator handed out again would carry another prompt's bytes
        def record_logits(e, p):  # the exact record's row, read on the engine's stream into host memory
            def work():
                plan = e.kv.lookup_seed(list(p), allow_partial=False, count=False)
                try:
                    exact = plan is not None and plan.exact and plan.logits is not None
                    return plan.logits.cpu().view(torch.uint8) if exact else None
                finally:
                    e.kv.release_plan(plan)

            return e._run_on_scheduler(work)

        def handoff(p):
            payload = peng.kv_handoff_export(p)
            return payload is not None and deng.kv_handoff_import(eng._transfer(payload, deng))

        def delay():  # on the decode engine's stream, ahead of the imports
            torch.cuda._sleep(HANDOFF_DELAY_CYCLES)
            behind = torch.cuda.Event()
            behind.record()
            return behind

        def evict_decode():
            with deng.kv._lock:
                return deng.kv.radix.evict_for(deng.kv.pool.n_blocks)

        deng._run_on_scheduler(evict_decode)
        t0 = time.perf_counter()
        behind = deng._run_on_scheduler(delay)
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            oks = list(ex.map(handoff, prompts))
        ahead_s = time.perf_counter() - t0
        lagged = not behind.query()  # the imports all returned with the decode stream still asleep
        torch.cuda.synchronize()
        rows = {e.role: [record_logits(e, p) for p in prompts] for e in (peng, deng)}

        def same(a, b):
            return a is not None and b is not None and torch.equal(a, b)

        wrong = {i: [j for j, b in enumerate(rows["prefill"]) if same(a, b)]  # whose logits it holds instead
                 for i, a in enumerate(rows["decode"]) if not same(a, rows["prefill"][i])}
        if not all(oks) or not lagged or wrong:
            raise AssertionError(f"disagg concurrent: imports {oks}, decode stream still behind {lagged}; records "
                                 f"wrong {{prompt: the prompts whose prefill-pool logits it holds}} {wrong}")
        print(f"disagg concurrent: {len(prompts)} handoffs on 4 threads returned in {ahead_s:.3f} s with the decode "
              f"stream still behind ({HANDOFF_DELAY_CYCLES} cycles); every decode-pool record's logits "
              f"byte-identical to its prompt's prefill-pool record")

        # 4. the decode replica killed as a burst starts: every stream falls
        # back to the prefill pool, colocated
        def evict_all():  # the prefill pool's records go: its probes prefill again
            with peng.kv._lock:
                return peng.kv.radix.evict_for(peng.kv.pool.n_blocks)

        peng._run_on_scheduler(evict_all)
        fb0, dsub = eng.fallbacks, deng.submitted
        reqs = [h.submit(GenRequest(p, max_new_tokens=new_tokens)) for p in prompts]
        inj.arm("replica_kill", label="/decode/r0")
        join = _consume(reqs)
        _wait_until(lambda: not deng.alive(), 60, "disagg: the decode replica's death")
        got3, _ends = join()
        bad = [i for i, r in enumerate(reqs) if r.finish_reason != "length" or len(got3[i]) != new_tokens]
        if bad or eng.fallbacks <= fb0:
            raise AssertionError(f"disagg kill: streams {bad} cut, fallbacks {eng.fallbacks - fb0}")
        differ3 = _divergence_at_near_ties(params, cfg, prompts, got3, want, TOKEN_GAP, "disagg kill ")
        c, e = _replay_gate(params, cfg, prompts, got3, TOKEN_GAP, label="disagg kill ", verbose=False)
        print(f"disagg kill: {deng.label} died ({deng.died_reason}); {len(prompts)} streams ended right, fallbacks "
              f"{eng.fallbacks - fb0}, decode admissions meanwhile {deng.submitted - dsub}; {differ3} leave the "
              f"colocated streams at a near-tie; gate {c} matched, {e} exempt")
        out.update({"equal": equal, "bytes": eng.handoff_bytes, "handoff_s": walls})
    finally:
        inj.disarm()
        rt.close()
    h = eng = peng = deng = params = None  # the closed pools' tensors go with them
    out["mem_closed"] = _fleet_memory("after the disaggregated fleet closed")
    return out


ROUTER_LAYERS = 4  # the engine processes' depth, of Gemma-2B's 18 (full width): 18 ran the whole script past 1,000 s, 6 past 1,100 s
ROUTER_NEW = 32  # new tokens of the burst's requests
ROUTER_STREAM_NEW = 96  # max_tokens of the SSE streams the kill and the drain cut into
ROUTER_CHECKED = ("flash_attention", "paged_decode_partials")  # rows 1 and 3: the engine processes' path
ROUTER_WAIT_S = 300.0  # ceiling on an engine process's start (weights, warmup) and on each wait below


def engine_process(args) -> int:
    """``--engine-process``: one engine process behind the front router.
    Gemma-2B's seeded weights (ROUTER_LAYERS of its layers, full width)
    served by gofr_tpu_torch.serve's app at the engine defaults (32 slots,
    max_seq_len 512, graphs, lookahead 3) on ``--port``, plus the script's
    own hooks: an X-Engine-Id header on every response, ``GET
    /smoke/state`` (pid, the launch counters of rows 1 and 3, read and
    zeroed with ``?zero=1``, the engine's death reason, memory) and ``POST
    /smoke/arm`` (arms ``replica_kill`` in this process). The kernels load
    from the libraries the parent script built (build/kernels); nothing
    builds here. Logs go to ``--log-dir``/engine-<port>.log."""
    from gofr_tpu_torch.config import new_mock_config
    from gofr_tpu_torch.resilience import default_injector
    from gofr_tpu_torch.serve import build_app

    if args.log_dir:
        fd = os.open(os.path.join(args.log_dir, f"engine-{args.port}.log"), os.O_WRONLY | os.O_CREAT | os.O_APPEND)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
    cfg, params = _first_layers(*gemma_weights(SEED), ROUTER_LAYERS)
    app = build_app(new_mock_config({
        "HTTP_PORT": str(args.port), "METRICS_PORT": str(args.metrics_port), "GEMMA_PRESET": "2b",
        "LLM_SLOTS": "32", "LLM_MAX_SEQ": "512", "REQUEST_TIMEOUT": "600", "LOG_LEVEL": "WARN",
        "GOFR_DRAIN_DEADLINE_S": "120",
    }), params=params)
    del params
    eid = f"engine-{args.port}"

    def engine_id(next_handler):
        async def h(req):
            resp = await next_handler(req)
            resp.headers.append(("X-Engine-Id", eid))
            return resp

        return h

    def state(ctx):
        eng = ctx.tpu().llm("gemma")
        out = {"engine_id": eid, "pid": os.getpid(), "launches": _launches(KERNEL_COUNTERS),
               "died_reason": eng.died_reason, "memory_reserved": torch.cuda.memory_reserved()}
        if ctx.param("zero") == "1":
            _zero_launches(KERNEL_COUNTERS)
        return out

    def arm(_ctx):
        default_injector().arm("replica_kill", count=1)
        return {"armed": "replica_kill"}

    app.use_middleware(engine_id)
    app.get("/smoke/state", state)
    app.post("/smoke/arm", arm)
    print(f"engine process {eid} pid {os.getpid()}: serving on :{args.port}", flush=True)
    app.run()
    return 0


def _gpu_apps() -> dict:
    """{pid: used MiB} of the card's compute processes (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    apps = {}
    for ln in out.strip().splitlines():
        pid, mem = (x.strip() for x in ln.split(","))
        apps[int(pid)] = float(mem)
    return apps


def _gpu_used_mib() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def _maps_cuda(pid: int) -> bool:
    """Whether process ``pid`` has the CUDA driver library mapped (a CUDA
    context needs it)."""
    with open(f"/proc/{pid}/maps") as f:
        return "libcuda.so" in f.read()


def _running(pid: int) -> bool:
    """Alive and not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def _get_json(port: int, path: str, method: str = "GET", body=None, headers=None) -> dict:
    status, raw, _, _, _ = _http(port, method, path, body, headers, timeout=60)
    if status >= 300:
        raise AssertionError(f"{method} :{port}{path}: {status} {raw[:300]!r}")
    data = json.loads(raw)
    return data.get("data", data)


def _fleet(port: int) -> list:
    return _get_json(port, "/.well-known/router")["fleet"]["backends"]


def _accepting(port: int) -> list:
    return sorted(b["address"] for b in _fleet(port) if b["accepting"])


def _port_of(address: str) -> int:
    return int(address.rsplit(":", 1)[1])


def _generate_burst(port: int, prompts, new_tokens: int, headers=None) -> dict:
    """Every prompt as a concurrent POST /generate on ``port`` -> {"results",
    "engines", "first", "wall_s", "failed"}; a failed request is counted,
    not raised."""
    answers: dict[int, tuple] = {}
    errors: dict[int, str] = {}

    def client(i):
        try:
            answers[i] = _http(port, "POST", "/generate", {"tokens": prompts[i], "max_new_tokens": new_tokens},
                               headers)
        except BaseException as e:  # noqa: BLE001 — a failed request, counted below
            errors[i] = repr(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    results, engines, first = {}, {}, []
    for i, (status, raw, t_first, _, hdrs) in answers.items():
        toks = json.loads(raw)["data"]["tokens"] if status == 201 else None
        if toks is None or len(toks) != new_tokens:
            errors[i] = f"{status} {raw[:200]!r}"
            continue
        results[i] = toks
        engines[i] = hdrs.get("X-Engine-Id")
        first.append(t_first)
    first.sort()
    return {"results": results, "engines": engines, "first": first, "wall_s": wall, "failed": errors,
            "tokens": sum(len(t) for t in results.values())}


def _sse_stream(port: int, body: dict, headers: dict, out: dict, started: threading.Event | None = None) -> None:
    """One SSE chat completion on its own connection; fills ``out`` with the
    status, the engine, first-byte seconds, the events' text and whether
    the stream ended with [DONE] (a cut stream: complete False)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    raw = b""
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/chat/completions", body=json.dumps({**body, "stream": True}).encode(),
                     headers={"Content-Type": "application/json", **headers})
        resp = conn.getresponse()
        out["status"], out["engine"] = resp.status, resp.getheader("X-Engine-Id")
        raw = resp.read1(65536)
        out["first_s"] = time.perf_counter() - t0
        if started is not None:
            started.set()
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            raw += chunk
    except (http.client.HTTPException, OSError) as e:
        out["error"] = repr(e)
    finally:
        conn.close()
        if started is not None:
            started.set()
    out["complete"] = raw.rstrip().endswith(b"data: [DONE]")
    out["raw"] = raw


def _sse_burst(port: int, n: int, sessions=None):
    """``n`` SSE streams through the router, one thread each -> (threads,
    outs, the events set once each stream has its first bytes)."""
    outs = [{} for _ in range(n)]
    started = [threading.Event() for _ in range(n)]
    threads = []
    for i in range(n):
        body = {"model": "gemma", "messages": [{"role": "user", "content": f"Stream {i}: count to ninety."}],
                "max_tokens": ROUTER_STREAM_NEW}
        headers = {"X-GoFr-Session": sessions[i]} if sessions else {}
        th = threading.Thread(target=_sse_stream, args=(port, body, headers, outs[i], started[i]))
        th.start()
        threads.append(th)
    return threads, outs, started


def _sessions_owned_by(members, owner: str, n: int, prefix: str) -> list:
    """``n`` session ids whose rendezvous owner among ``members`` is ``owner``."""
    from gofr_tpu_torch.router.ring import HashRing

    ring, out, i = HashRing(members), [], 0
    while len(out) < n:
        sid = f"{prefix}-{i}"
        if ring.owner(sid) == owner:
            out.append(sid)
        i += 1
    return out


def phase_router(dev: dict, seed: int) -> dict:
    """The scale-out tier: ``python -m gofr_tpu_torch.router`` as a process
    of its own, autoscaling engine processes of this script
    (``--engine-process``) between 2 and 3, driven over sockets by this
    process (see the module docstring). Returns its readings and the
    launches of rows 1 and 3 summed over the engine processes."""
    cfg, params = _first_layers(*gemma_weights(seed), ROUTER_LAYERS)
    _plens, prompts = _burst_prompts(cfg, seed)
    logs = tempfile.mkdtemp(prefix="gofr-router-")
    port = free_port()
    engine_cmd = (f"{sys.executable} {Path(__file__).resolve()} --engine-process --port {{port}} "
                  f"--metrics-port {{metrics_port}} --log-dir {logs}")
    env = {**os.environ, "HTTP_PORT": str(port), "METRICS_PORT": str(free_port()), "LOG_LEVEL": "WARN",
           "APP_NAME": "front-router", "REQUEST_TIMEOUT": "600", "TPU_ROUTER_ENGINE_CMD": engine_cmd,
           "TPU_ROUTER_MIN_REPLICAS": "2", "TPU_ROUTER_MAX_REPLICAS": "3", "TPU_ROUTER_POLL_INTERVAL_S": "0.25",
           "TPU_ROUTER_UPSTREAM_TIMEOUT_S": "600", "TPU_ROUTER_PROXY_TIMEOUT_S": "600",
           # no backlog scale-up during the script's bursts: only the minimum launches
           "TPU_ROUTER_SCALE_UP_WAIT_S": "60"}
    router_log = open(os.path.join(logs, "router.log"), "w")
    t_start = time.perf_counter()
    router = subprocess.Popen([sys.executable, "-m", "gofr_tpu_torch.router"], env=env,
                              cwd=Path(TL.__file__).resolve().parents[1], stdout=router_log, stderr=subprocess.STDOUT)
    pids: dict[str, int] = {}  # engine address -> pid
    launches = {k: 0 for k in KERNEL_COUNTERS}
    out: dict = {}

    def state(address, zero=False):
        st = _get_json(_port_of(address), "/smoke/state" + ("?zero=1" if zero else ""))
        pids[address] = st["pid"]
        if zero:
            for k in KERNEL_COUNTERS:
                launches[k] += st["launches"][k]
        return st

    try:
        # 1. two engine processes, each on the card; the router holds no CUDA context
        def two_up():
            if router.poll() is not None:
                raise AssertionError(f"the router process exited {router.returncode}")
            return _http_ok(port) and len(_accepting(port)) == 2

        _wait_until(two_up, ROUTER_WAIT_S, "router: two accepting engine processes", every=0.25)
        out["start_s"] = time.perf_counter() - t_start
        a_addr, b_addr = _accepting(port)
        for addr in (a_addr, b_addr):
            state(addr, zero=True)
        apps = _gpu_apps()
        mem = {addr: apps.get(pids[addr]) for addr in (a_addr, b_addr)}
        print(f"router: nvidia-smi compute apps {apps}; router pid {router.pid}, engine pids "
              f"{ {a: pids[a] for a in (a_addr, b_addr)} }")
        if _maps_cuda(router.pid) or router.pid in apps:
            raise AssertionError(f"the router process {router.pid} holds a CUDA context")
        for addr in (a_addr, b_addr):
            if not _maps_cuda(pids[addr]):
                raise AssertionError(f"engine process {pids[addr]} has no CUDA context")
        pid_visible = any(pids[a] in apps for a in (a_addr, b_addr))
        if pid_visible and not all(pids[a] in apps for a in (a_addr, b_addr)):
            raise AssertionError(f"an engine pid is missing from nvidia-smi: {apps}")
        out["engine_reserved"] = [state(a)["memory_reserved"] for a in (a_addr, b_addr)]
        print(f"router: 2 engine processes accepting {out['start_s']:.1f}s after the router started; each on the "
              f"card ({'MiB by nvidia-smi ' + str(mem) if pid_visible else 'nvidia-smi shows other pids: ' + str(apps)}"
              f"; memory_reserved {out['engine_reserved']}); the router process maps no libcuda")
        out["engine_mib"] = mem

        # 2. the burst through the router, and direct to one engine
        for addr in (a_addr, b_addr):  # warm-up, outside the timed runs
            _generate_burst(_port_of(addr), [[1, 2, 3]], 4)
        for addr in (a_addr, b_addr):
            state(addr, zero=True)
        routed = _generate_burst(port, prompts, ROUTER_NEW)
        burst = {k: 0 for k in KERNEL_COUNTERS}
        for addr in (a_addr, b_addr):
            for k, v in state(addr)["launches"].items():
                burst[k] += v
            state(addr, zero=True)
        direct = _generate_burst(_port_of(a_addr), prompts, ROUTER_NEW)
        for b in (routed, direct):
            if b["failed"]:
                raise AssertionError(f"router burst: failed requests {b['failed']}")
        if any(burst[k] <= 0 for k in ROUTER_CHECKED):
            raise AssertionError(f"a kernel did not launch in the engine processes during the routed burst: {burst}")
        checked, exempt = _replay_gate(params, cfg, prompts, routed["results"], TOKEN_GAP, label="router ",
                                       verbose=False)
        differ = _divergence_at_near_ties(params, cfg, prompts, routed["results"], direct["results"], TOKEN_GAP,
                                          "router vs direct ")
        for key, b in (("routed", routed), ("direct", direct)):
            out[key] = {"tok_s": b["tokens"] / b["wall_s"], "first_p50_s": b["first"][len(b["first"]) // 2],
                        "engines": sorted(set(b["engines"].values()))}
        print(f"router burst on {dev['smi']}: {len(prompts)} x {ROUTER_NEW} tokens routed "
              f"{out['routed']['tok_s']:.1f} tok/s, first byte p50 {out['routed']['first_p50_s']:.3f}s over "
              f"{out['routed']['engines']}; direct to one engine {out['direct']['tok_s']:.1f} tok/s, first byte p50 "
              f"{out['direct']['first_p50_s']:.3f}s; {checked} routed tokens at the plain argmax, {exempt} exempt; "
              f"{differ} routed streams leave the direct ones (each at a near-tie); launches in the engine "
              f"processes {burst}")
        out["burst_launches"] = burst

        # 3. sessions: 4 conversations of 3 turns, two owned by each engine
        convs = (_sessions_owned_by([a_addr, b_addr], a_addr, 2, "conv")
                 + _sessions_owned_by([a_addr, b_addr], b_addr, 2, "conv"))
        history = {sid: list(prompts[i]) for i, sid in enumerate(convs)}
        homes: dict[str, str] = {}
        for turn in range(3):
            for sid in convs:
                st, raw, _, _, hdrs = _http(port, "POST", "/generate",
                                            {"tokens": history[sid], "max_new_tokens": 16}, {"X-GoFr-Session": sid})
                if st != 201:
                    raise AssertionError(f"session {sid} turn {turn}: {st} {raw[:200]!r}")
                if homes.setdefault(sid, hdrs["X-Engine-Id"]) != hdrs["X-Engine-Id"]:
                    raise AssertionError(f"session {sid} turn {turn} left {homes[sid]} for {hdrs['X-Engine-Id']}")
                history[sid] += json.loads(raw)["data"]["tokens"] + [7, 8, 9]
        if len(set(homes.values())) != 2:
            raise AssertionError(f"the sessions used one engine: {homes}")
        print(f"router sessions: 4 conversations x 3 turns, each on one engine: {homes}")

        # 4. SIGKILL one engine process under a streamed burst of 8
        for addr in (a_addr, b_addr):
            state(addr, zero=True)
        threads, outs, started = _sse_burst(port, 8)
        for ev in started:
            ev.wait(timeout=300)
        victim_eid = next(o["engine"] for o in outs if o.get("engine"))
        victim = next(a for a in (a_addr, b_addr) if f"engine-{_port_of(a)}" == victim_eid)
        survivor = b_addr if victim == a_addr else a_addr
        on_victim = sum(o.get("engine") == victim_eid for o in outs)
        t_kill = time.perf_counter()
        os.kill(pids[victim], 9)
        _wait_until(lambda: victim not in _accepting(port), 60, "the killed process marked down", every=0.01)
        down_s = time.perf_counter() - t_kill
        for th in threads:
            th.join(timeout=600)
        completed = sum(o.get("complete", False) for o in outs)
        cut = [o.get("engine") for o in outs if not o.get("complete", False)]
        after = _generate_burst(port, prompts, ROUTER_NEW)
        if after["failed"]:
            raise AssertionError(f"router: the burst after the kill failed requests {after['failed']}")
        _replay_gate(params, cfg, prompts, after["results"], TOKEN_GAP, label="router after kill ", verbose=False)
        replacement = _wait_until(lambda: [a for a in _accepting(port) if a not in (a_addr, b_addr)], ROUTER_WAIT_S,
                                  "a replacement engine process accepting", every=0.1)[0]
        replace_s = time.perf_counter() - t_kill
        state(replacement, zero=True)
        rehomed = {}
        for sid in convs:
            if homes[sid] != victim_eid:
                continue
            st, raw, _, _, hdrs = _http(port, "POST", "/generate", {"tokens": history[sid], "max_new_tokens": 16},
                                        {"X-GoFr-Session": sid})
            if st != 201 or hdrs["X-Engine-Id"] == victim_eid:
                raise AssertionError(f"session {sid} of the killed engine: {st} on {hdrs.get('X-Engine-Id')}")
            rehomed[sid] = hdrs["X-Engine-Id"]
        if any(e != victim_eid for e in cut) or completed + len(cut) != 8:
            raise AssertionError(f"router kill: cut streams {cut} not all on the killed {victim_eid}")
        out["kill"] = {"streams_on_victim": on_victim, "completed": completed, "truncated": len(cut),
                       "marked_down_s": down_s, "failed_after": len(after["failed"]), "replacement_s": replace_s,
                       "rehomed": rehomed}
        print(f"router kill: SIGKILL of {victim_eid} with {on_victim} of 8 SSE streams on it: {completed} completed, "
              f"{len(cut)} truncated; marked down in {down_s:.3f}s; the next burst of 8: 0 failed "
              f"({after['tokens']} tokens); replacement {replacement} accepting {replace_s:.1f}s after the kill; "
              f"the killed engine's sessions rehomed to {rehomed}")

        # 5. an engine death in a live process (replica_kill): the process stays up
        _get_json(_port_of(survivor), "/smoke/arm", "POST", {})
        st, raw, _, _, _ = _http(_port_of(survivor), "POST", "/generate", {"tokens": [1, 2, 3], "max_new_tokens": 8})
        dead = _wait_until(lambda: state(survivor)["died_reason"], 60, "the armed engine's death", every=0.05)
        retries0 = _get_json(port, "/.well-known/router")["retries"]
        after_death = _generate_burst(port, prompts, ROUTER_NEW)
        if after_death["failed"]:
            raise AssertionError(f"router: the burst after replica_kill failed {after_death['failed']}")
        _replay_gate(params, cfg, prompts, after_death["results"], TOKEN_GAP, label="router after replica_kill ",
                     verbose=False)
        retries = _get_json(port, "/.well-known/router")["retries"] - retries0
        if not _running(pids[survivor]):
            raise AssertionError("the replica_kill process exited")
        out["replica_kill"] = {"trigger_status": st, "died_reason": dead, "failed_after": 0, "retries": retries,
                               "engines": sorted(set(after_death["engines"].values()))}
        print(f"router replica_kill: engine-{_port_of(survivor)}'s engine died ({dead!r}; the triggering request "
              f"answered {st}), its process stays up; the next burst of 8 through the router: 0 failed, "
              f"{retries} re-dispatches, served by {out['replica_kill']['engines']}")

        # 6. drain the replacement with 4 SSE streams in flight on it (its
        # counters are read first: they leave with the process)
        members = _get_json(port, "/.well-known/router")["fleet"]["ring"]
        drained_pid = pids[replacement]
        state(replacement, zero=True)
        apps0, used0 = _gpu_apps(), _gpu_used_mib()
        threads, outs, started = _sse_burst(port, 4, _sessions_owned_by(members, replacement, 4, "drain"))
        for ev in started:
            ev.wait(timeout=300)
        if any(o.get("engine") != f"engine-{_port_of(replacement)}" for o in outs):
            raise AssertionError(f"drain streams not on {replacement}: {[o.get('engine') for o in outs]}")
        t_drain = time.perf_counter()
        _get_json(_port_of(replacement), "/.well-known/debug/drain", "POST", {})
        for th in threads:
            th.join(timeout=600)
        if not all(o.get("complete") for o in outs):
            raise AssertionError(f"drain: streams cut {[o.get('error') for o in outs]}")
        streams_s = time.perf_counter() - t_drain
        _wait_until(lambda: not _running(drained_pid), 180, "the drained process's exit", every=0.05)
        exit_s = time.perf_counter() - t_drain
        _wait_until(lambda: all(replacement != b["address"] for b in _fleet(port)), 60, "the drained process reaped",
                    every=0.05)
        apps1, used1 = _gpu_apps(), _gpu_used_mib()
        if pid_visible and (drained_pid not in apps0 or drained_pid in apps1):
            raise AssertionError(f"the drained process {drained_pid} in nvidia-smi: before {apps0}, after {apps1}")
        if used1 >= used0:
            raise AssertionError(f"the card's memory did not drop when the drained process exited: {used0} -> {used1}")
        restored = _wait_until(lambda: len(_accepting(port)) >= 2 and _accepting(port), ROUTER_WAIT_S,
                               "the minimum restored", every=0.1)
        restore_s = time.perf_counter() - t_drain
        for b in _fleet(port):
            state(b["address"], zero=True)
        out["drain"] = {"streams": 4, "completed": 4, "streams_s": streams_s, "exit_s": exit_s,
                        "apps_before": apps0, "apps_after": apps1, "used_mib": (used0, used1),
                        "restored_s": restore_s}
        print(f"router drain of {replacement} with 4 SSE streams on it: 4 of 4 completed {streams_s:.2f}s after the "
              f"drain POST; the process exited at {exit_s:.2f}s; nvidia-smi compute apps {apps0} -> {apps1} (card "
              f"memory {used0:.0f} -> {used1:.0f} MiB, the next engine starting meanwhile); the minimum restored at "
              f"{restore_s:.1f}s: {restored}")
    finally:
        t_stop = time.perf_counter()
        router.terminate()  # SIGTERM: the router's drain, then its close reaps every managed process
        try:
            router.wait(timeout=120)
        except subprocess.TimeoutExpired:
            router.kill()
            router.wait(timeout=30)
        router_log.close()
        left = [p for p in pids.values() if _running(p)]
        for p in left:
            os.kill(p, 9)
        if sys.exc_info()[0] is not None:
            for name in sorted(os.listdir(logs)):
                with open(os.path.join(logs, name), errors="replace") as f:
                    tail = f.read()[-3000:]
                print(f"--- {name} (last 3000 chars) ---\n{tail}")
        shutil.rmtree(logs, ignore_errors=True)
    if left:
        raise AssertionError(f"the router's shutdown left engine processes {left}")
    out["shutdown_s"] = time.perf_counter() - t_stop
    out["launches"] = launches
    print(f"router shutdown: the router exited in {out['shutdown_s']:.1f}s and reaped every engine process "
          f"({len(pids)} launched); launches summed over the engine processes {launches}")
    return out


def _http_ok(port: int) -> bool:
    try:
        return _http(port, "GET", "/.well-known/alive", timeout=2)[0] == 200
    except OSError:
        return False


BATCH_JOBS = 16  # jobs of the batch part: the burst's prompts twice
BATCH_CONCURRENCY = 4


def phase_batch(dev: dict, seed: int, cfg: TransformerConfig, params: dict, eng) -> dict:
    """The job tier on ``eng`` in this process: a gofr_tpu_torch.batch
    BatchWorker draining a FILE pub/sub topic in a temporary directory (see
    the module docstring). Returns its readings and the launches of the
    part."""
    from types import SimpleNamespace

    from gofr_tpu_torch.batch import BatchWorker
    from gofr_tpu_torch.datasource.pubsub import FilePubSub

    _plens, prompts = _burst_prompts(cfg, seed)
    # the interactive burst alone: the direct streams and the TTFT without a backlog
    alone, reqs, _ = _serve(eng, prompts, ROUTER_NEW)
    ttft_alone = sorted(r.first_token_at - r.submitted_at for r in reqs.values())
    box = tempfile.mkdtemp(prefix="gofr-batch-")
    ps = FilePubSub(box)
    classes: dict[str, int] = {}
    submit = eng.submit

    def counting(req):  # the priority class of every request the engine takes
        classes[req.priority] = classes.get(req.priority, 0) + 1
        return submit(req)

    eng.submit = counting
    container = SimpleNamespace(pubsub=ps, logger=None, metrics_manager=eng.metrics, tracer=None,
                                tpu=lambda: SimpleNamespace(llm=lambda _name: eng))
    worker = BatchWorker(container, "jobs", model="gemma", concurrency=BATCH_CONCURRENCY, poll_timeout=0.1)
    loop = asyncio.new_event_loop()
    runner = threading.Thread(target=lambda: loop.run_until_complete(worker.run()), daemon=True)
    try:
        _zero_launches(KERNEL_COUNTERS)
        t0 = time.perf_counter()
        for i in range(BATCH_JOBS):
            ps.publish_sync("jobs", json.dumps({"id": f"job-{i}", "tokens": prompts[i % len(prompts)],
                                                "max_new_tokens": ROUTER_NEW}))
        runner.start()
        _wait_until(lambda: worker.stats()["inflight"] or worker.jobs_ok, 60, "batch: the worker's first job",
                    every=0.002)
        with_backlog, reqs_b, _ = _serve(eng, prompts, ROUTER_NEW)
        ttft_backlog = sorted(r.first_token_at - r.submitted_at for r in reqs_b.values())
        _wait_until(lambda: worker.jobs_ok == BATCH_JOBS, 600, "every batch job's result", every=0.02)
        jobs_s = time.perf_counter() - t0
        launches = _launches(KERNEL_COUNTERS)
        ps.publish_sync("jobs", json.dumps({"id": "job-0", "tokens": prompts[0], "max_new_tokens": ROUTER_NEW}))
        _wait_until(lambda: worker.jobs_deduped == 1, 60, "the duplicate job's dedup", every=0.02)
        time.sleep(0.3)  # a second result, were there one, would be published by now
    finally:
        worker.close()
        runner.join(timeout=30)
        loop.close()
        eng.submit = submit
    with open(os.path.join(box, "jobs.results.jsonl")) as f:
        results = [json.loads(json.loads(ln)["value"]) for ln in f if ln.strip()]
    shutil.rmtree(box, ignore_errors=True)
    ids = sorted(r["id"] for r in results)
    if ids != sorted(f"job-{i}" for i in range(BATCH_JOBS)):
        raise AssertionError(f"batch: results {ids} are not one per job")
    if classes.get("batch") != BATCH_JOBS or worker.jobs_ok != BATCH_JOBS or worker.jobs_error:
        raise AssertionError(f"batch: engine classes {classes}, worker {worker.stats()}")
    got = {int(r["id"].split("-")[1]): r["tokens"] for r in results}
    job_prompts = [prompts[i % len(prompts)] for i in range(BATCH_JOBS)]
    want = {i: alone[i % len(prompts)] for i in range(BATCH_JOBS)}
    differ = _divergence_at_near_ties(params, cfg, job_prompts, got, want, TOKEN_GAP, "batch job ")
    differ_i = _divergence_at_near_ties(params, cfg, prompts, with_backlog, alone, TOKEN_GAP, "batch interactive ")
    for name in ROUTER_CHECKED:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched in the batch part: {launches}")
    out = {"jobs": BATCH_JOBS, "results": len(results), "jobs_s": jobs_s, "classes": classes,
           "ttft_p50_alone_s": ttft_alone[len(ttft_alone) // 2],
           "ttft_p50_backlog_s": ttft_backlog[len(ttft_backlog) // 2], "differ": differ,
           "interactive_differ": differ_i, "deduped": worker.jobs_deduped, "launches": launches}
    print(f"batch on {dev['smi']}: {BATCH_JOBS} jobs x {ROUTER_NEW} tokens over FILE pub/sub at concurrency "
          f"{BATCH_CONCURRENCY}, one result each, in {jobs_s:.2f}s beside an interactive burst of 8; engine classes "
          f"{classes}; {differ} job streams leave the direct ones (each at a near-tie), {differ_i} interactive; "
          f"interactive ttft p50 {out['ttft_p50_backlog_s']:.3f}s with the backlog, {out['ttft_p50_alone_s']:.3f}s "
          f"without; the job published twice: {worker.jobs_deduped} dedup, one result; launches {launches}")
    # the same jobs over KAFKA on the same engine, then the broker examples
    for key, run in (("kafka", lambda: phase_batch_kafka(dev, seed, cfg, params, eng)),
                     ("pubsub", lambda: phase_pubsub(dev, seed))):
        t0 = time.perf_counter()
        out[key] = run()
        out[key]["seconds"] = time.perf_counter() - t0
    return out


BATCH_KAFKA_MECH = "SCRAM-SHA-256"  # the Kafka run's SASL mechanism
BATCH_KAFKA_PARTITIONS = 2
BATCH_KAFKA_USER = ("batch", "batch-secret")  # the fake broker's one user
PUBSUB_ORDERS = 8  # orders from using_publisher to using_subscriber, per broker
PUBSUB_MICROBATCHES = 6  # kafka_batch_inference's messages, of 4 rows each


def _kafka_keys(broker, **over) -> dict:
    """The port's Kafka keys for a client of ``broker``: SCRAM as the one
    user, two partitions a topic, a 5 ms producer flush."""
    return {"PUBSUB_BACKEND": "KAFKA", "PUBSUB_BROKER": broker.address, "KAFKA_SASL_MECHANISM": BATCH_KAFKA_MECH,
            "KAFKA_SASL_USERNAME": BATCH_KAFKA_USER[0], "KAFKA_SASL_PASSWORD": BATCH_KAFKA_USER[1],
            "KAFKA_PARTITIONS": str(BATCH_KAFKA_PARTITIONS), "KAFKA_BATCH_TIMEOUT": "5", **over}


def _kafka_client(broker, group: str):
    """A KafkaPubSub of ``group`` on ``broker``, as ``PUBSUB_BACKEND=KAFKA``
    builds it."""
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.datasource.pubsub import new_pubsub

    return new_pubsub("KAFKA", MapConfig(_kafka_keys(broker, KAFKA_CONSUMER_GROUP=group)))


def _kafka_read(broker, topic: str, group: str) -> list:
    """Every record of ``topic`` that a fresh consumer of ``group`` is
    served (each committed): it pulls until a pull finds nothing for a
    second."""
    reader = _kafka_client(broker, group)
    out = []
    try:
        while (m := reader.subscribe_sync(topic, 1.0)) is not None:
            out.append(m.value)
            m.commit()
        return out
    finally:
        reader.close()


def phase_batch_kafka(dev: dict, seed: int, cfg: TransformerConfig, params: dict, eng) -> dict:
    """The FILE run's jobs over KAFKA on ``eng``: the port's FakeKafkaBroker
    on 127.0.0.1 (SCRAM-SHA-256, two partitions), a BatchWorker over the
    KafkaPubSub that ``new_pubsub("KAFKA", ...)`` builds, the 16 jobs beside
    the interactive burst. The results and the committed offsets are read
    back from the broker through fresh consumers (see the module
    docstring). Returns its readings and the launches of the run."""
    from types import SimpleNamespace

    from gofr_tpu_torch.batch import BatchWorker
    from gofr_tpu_torch.testutil.fakekafka import FakeKafkaBroker

    _plens, prompts = _burst_prompts(cfg, seed)
    alone, reqs, _ = _serve(eng, prompts, ROUTER_NEW)
    ttft_alone = sorted(r.first_token_at - r.submitted_at for r in reqs.values())
    broker = FakeKafkaBroker(users=dict([BATCH_KAFKA_USER]))
    group = "batch-workers"
    try:
        ps = _kafka_client(broker, group)
        classes: dict[str, int] = {}
        submit = eng.submit

        def counting(req):
            classes[req.priority] = classes.get(req.priority, 0) + 1
            return submit(req)

        eng.submit = counting
        container = SimpleNamespace(pubsub=ps, logger=None, metrics_manager=eng.metrics, tracer=None,
                                    tpu=lambda: SimpleNamespace(llm=lambda _name: eng))
        worker = BatchWorker(container, "jobs", model="gemma", concurrency=BATCH_CONCURRENCY, poll_timeout=0.1)
        loop = asyncio.new_event_loop()
        runner = threading.Thread(target=lambda: loop.run_until_complete(worker.run()), daemon=True)
        try:
            ps.create_topic("jobs")
            _zero_launches(KERNEL_COUNTERS)
            t0 = time.perf_counter()
            for i in range(BATCH_JOBS):
                ps.publish_sync("jobs", json.dumps({"id": f"job-{i}", "tokens": prompts[i % len(prompts)],
                                                    "max_new_tokens": ROUTER_NEW}))
            ps.flush()
            runner.start()
            _wait_until(lambda: worker.stats()["inflight"] or worker.jobs_ok, 60,
                        "batch kafka: the worker's first job", every=0.002)
            with_backlog, reqs_b, _ = _serve(eng, prompts, ROUTER_NEW)
            ttft_backlog = sorted(r.first_token_at - r.submitted_at for r in reqs_b.values())
            _wait_until(lambda: worker.jobs_ok == BATCH_JOBS, 600, "every Kafka batch job's result", every=0.02)
            jobs_s = time.perf_counter() - t0
            launches = _launches(KERNEL_COUNTERS)
            ps.publish_sync("jobs", json.dumps({"id": "job-0", "tokens": prompts[0], "max_new_tokens": ROUTER_NEW}))
            ps.flush()
            _wait_until(lambda: worker.jobs_deduped == 1, 60, "the duplicate Kafka job's dedup", every=0.02)
            time.sleep(0.3)  # a second result, were there one, would be published by now
        finally:
            worker.close()
            runner.join(timeout=30)
            loop.close()
            eng.submit = submit
            ps.close()
        raw = _kafka_read(broker, "jobs.results", "result-reader")
        left = _kafka_read(broker, "jobs", group)  # the worker's group: every record committed
        committed = [broker.committed(group, "jobs", p) for p in range(BATCH_KAFKA_PARTITIONS)]
        ends = [len(broker.records("jobs", p)) for p in range(BATCH_KAFKA_PARTITIONS)]
    finally:
        broker.close()
    results = [json.loads(v) for v in raw]
    ids = sorted(r["id"] for r in results)
    if ids != sorted(f"job-{i}" for i in range(BATCH_JOBS)):
        raise AssertionError(f"batch kafka: results {ids} are not one per job")
    if left or committed != ends or min(ends) <= 0:
        raise AssertionError(f"batch kafka: committed {committed} of {ends} records a partition; "
                             f"a new consumer of the group got {len(left)}")
    if classes.get("batch") != BATCH_JOBS or worker.jobs_ok != BATCH_JOBS or worker.jobs_error:
        raise AssertionError(f"batch kafka: engine classes {classes}, worker {worker.stats()}")
    if worker.jobs_deduped != 1:
        raise AssertionError(f"batch kafka: {worker.jobs_deduped} dedups of the job published twice")
    got = {int(r["id"].split("-")[1]): r["tokens"] for r in results}
    job_prompts = [prompts[i % len(prompts)] for i in range(BATCH_JOBS)]
    want = {i: alone[i % len(prompts)] for i in range(BATCH_JOBS)}
    differ = _divergence_at_near_ties(params, cfg, job_prompts, got, want, TOKEN_GAP, "batch kafka job ")
    differ_i = _divergence_at_near_ties(params, cfg, prompts, with_backlog, alone, TOKEN_GAP,
                                        "batch kafka interactive ")
    for name in ROUTER_CHECKED:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched in the Kafka batch run: {launches}")
    out = {"jobs": BATCH_JOBS, "results": len(results), "jobs_s": jobs_s, "jobs_per_s": BATCH_JOBS / jobs_s,
           "classes": classes, "mechanism": BATCH_KAFKA_MECH, "committed": committed,
           "ttft_p50_alone_s": ttft_alone[len(ttft_alone) // 2],
           "ttft_p50_backlog_s": ttft_backlog[len(ttft_backlog) // 2], "differ": differ,
           "interactive_differ": differ_i, "deduped": worker.jobs_deduped, "launches": launches}
    print(f"batch kafka on {dev['smi']}: {BATCH_JOBS} jobs x {ROUTER_NEW} tokens over KAFKA "
          f"({BATCH_KAFKA_MECH}, {BATCH_KAFKA_PARTITIONS} partitions, the port's fake broker) at concurrency "
          f"{BATCH_CONCURRENCY}, one result each read back from the broker, in {jobs_s:.2f}s "
          f"({out['jobs_per_s']:.3f} jobs/s) beside an interactive burst of 8; committed {committed} of {ends} "
          f"records a partition, none left for the group; engine classes {classes}; {differ} job streams leave "
          f"the direct ones (each at a near-tie), {differ_i} interactive; interactive ttft p50 "
          f"{out['ttft_p50_backlog_s']:.3f}s with the backlog, {out['ttft_p50_alone_s']:.3f}s without; the job "
          f"published twice: {worker.jobs_deduped} dedup; launches {launches}")
    return out


def _example_app(module, **over):
    """A port example's app on ephemeral ports, serving, over ``over``."""
    from gofr_tpu_torch.config import MapConfig

    app = module.build_app(MapConfig({**module.DEFAULTS, "HTTP_PORT": "0", "METRICS_PORT": "0",
                                      "LOG_LEVEL": "ERROR", **over}))
    return app, app.run_in_background()


def _stop_apps(apps, seconds: dict, key: str) -> None:
    """Shut the apps down and join their threads; the wall time goes to
    ``seconds[key]``, and an app whose thread outlives its 10 s join is
    counted under ``seconds["still running"]``."""
    t0 = time.perf_counter()
    for app, th in apps:
        app.shutdown()
        th.join(timeout=10)
        seconds["still running"] = seconds.get("still running", 0) + th.is_alive()
    seconds[key] = time.perf_counter() - t0


def phase_pubsub(dev: dict, seed: int) -> dict:
    """The broker examples on the card's machine (see the module docstring):
    kafka_batch_inference over KAFKA with its MLP on the card, and
    using_publisher to using_subscriber over KAFKA and over MQTT (QoS 1)."""
    from gofr_tpu_torch.examples import kafka_batch_inference, using_publisher, using_subscriber
    from gofr_tpu_torch.testutil.fakekafka import FakeKafkaBroker
    from gofr_tpu_torch.testutil.fakemqtt import FakeMQTTBroker

    out: dict = {}
    steps: dict = {}  # seconds of the apps' start and stop
    # kafka_batch_inference: rows through the batcher on the card, predictions over the broker
    broker = FakeKafkaBroker(users=dict([BATCH_KAFKA_USER]))
    apps = []
    try:
        kafka_batch_inference.RESULTS.clear()
        t0 = time.perf_counter()
        apps.append(_example_app(kafka_batch_inference, **_kafka_keys(broker, KAFKA_CONSUMER_GROUP="kbi")))
        steps["inference up"] = time.perf_counter() - t0
        app = apps[0][0]
        rt = app.container.tpu()
        if rt.device.type != "cuda" or rt.model("mnist").params["w0"].device.type != "cuda":
            raise AssertionError(f"kafka_batch_inference: the model is on {rt.device}, not the card")
        rng = np.random.default_rng(seed)
        want = {}
        t0 = time.perf_counter()
        for i in range(PUBSUB_MICROBATCHES):
            xs = rng.normal(size=(4, 16)).astype(np.float32)
            status = _http(app.http_server.port, "POST", "/enqueue", {"id": f"mb-{i}", "xs": xs.tolist()})[0]
            if status != 201:
                raise AssertionError(f"kafka_batch_inference: /enqueue answered {status}")
            want[f"mb-{i}"] = np.argmax(np.asarray(rt.infer("mnist", xs)), axis=-1).tolist()
        _wait_until(lambda: len(kafka_batch_inference.RESULTS) == PUBSUB_MICROBATCHES, 60,
                    "kafka_batch_inference's predictions", every=0.01)
        out["inference_s"] = time.perf_counter() - t0
        got = json.loads(_http(app.http_server.port, "GET", "/results")[1])["data"]
        if got != want:
            raise AssertionError(f"kafka_batch_inference: predictions {got} are not the direct model's {want}")
    finally:
        _stop_apps(apps, steps, "inference down")
        broker.close()
    # using_publisher -> using_subscriber, each order seen once
    for backend in ("KAFKA", "MQTT"):
        broker = FakeKafkaBroker(users=dict([BATCH_KAFKA_USER])) if backend == "KAFKA" else FakeMQTTBroker()
        env = (_kafka_keys(broker) if backend == "KAFKA" else
               {"PUBSUB_BACKEND": "MQTT", "MQTT_HOST": broker.host, "MQTT_PORT": str(broker.port), "MQTT_QOS": "1"})
        apps = []
        try:
            using_subscriber.RECEIVED.clear()
            t0 = time.perf_counter()
            apps.append(_example_app(using_subscriber, **env, MQTT_CLIENT_ID="subscriber"))
            apps.append(_example_app(using_publisher, **env, MQTT_CLIENT_ID="publisher"))
            steps[f"{backend.lower()} up"] = time.perf_counter() - t0
            if backend == "MQTT":
                _wait_until(lambda: any(s.subs for s in broker._sessions), 30, "using_subscriber's subscription")
            orders = [{"id": i, "qty": 3 * i} for i in range(PUBSUB_ORDERS)]
            t0 = time.perf_counter()
            for o in orders:
                status = _http(apps[1][0].http_server.port, "POST", "/publish-order", o)[0]
                if status != 201:
                    raise AssertionError(f"using_publisher over {backend}: /publish-order answered {status}")
            _wait_until(lambda: len(using_subscriber.RECEIVED) >= PUBSUB_ORDERS, 60,
                        f"every order over {backend}", every=0.01)
            out[f"orders_{backend.lower()}_s"] = time.perf_counter() - t0
            time.sleep(0.3)  # a duplicate, were there one, would be here by now
            seen = sorted(using_subscriber.RECEIVED, key=lambda o: o["id"])
            if seen != orders:
                raise AssertionError(f"using_subscriber over {backend} saw {seen}, not each order once")
        finally:
            _stop_apps(apps, steps, f"{backend.lower()} down")
            broker.close()
    out["steps"] = steps
    print(f"pubsub on {dev['smi']}: kafka_batch_inference over KAFKA ({BATCH_KAFKA_MECH}) with its MLP on the "
          f"card, {PUBSUB_MICROBATCHES} microbatches of 4 rows, every prediction the direct model's, in "
          f"{out['inference_s']:.3f}s; using_publisher -> using_subscriber, {PUBSUB_ORDERS} orders each seen once, "
          f"over KAFKA in {out['orders_kafka_s']:.3f}s and over MQTT (QoS 1) in {out['orders_mqtt_s']:.3f}s; "
          f"Google Pub/Sub not driven (no grpcio here); apps' start and stop s "
          f"{ {k: round(v, 3) for k, v in steps.items()} }")
    return out


TRAIN_BATCH, TRAIN_SEQ = 4, 512  # Gemma-2B's steps: 2,048 tokens a step
TRAIN_WARMUP, TRAIN_TIMED = 2, 8  # steps before the timed ones, and the timed ones
TRAIN_CORPUS = 1 << 20  # tokens of the seeded corpus the Gemma steps read
TRAIN_GRAD_LAYERS = 2  # of Gemma-2B's 18 (full width) in the gradient check
# the kernel path against the plain attention under autograd, both bf16:
# they differ by the kernel's rounding of each layer's attention output
# (the loss to within this, each leaf's gradient to this relative
# Frobenius error)
TRAIN_LOSS_ATOL = 2e-2
TRAIN_GRAD_RTOL = 2e-2
TRAIN_MOE_LAYERS = 2  # of Mixtral-8x7B's 32 (full width)
TRAIN_MOE_BATCH = 2
TRAIN_MOE_STEPS = 8  # the first 2 untimed
TRAIN_DATA_GATHERS = 5000  # batches gathered per path in the data part
TRAIN_KERNELS = ("flash_attention", "flash_attention_prompt", "paged_decode_partials", "paged_decode_partials_int8")


def _train_counted(counts: dict) -> dict:
    """The launches since the counters were zeroed, added to ``counts``:
    ``flash_attention`` counts its q_offsets mode alone (its counter less
    the full-prompt mode's), so each kernel row is counted once."""
    got = _launches(TRAIN_KERNELS)
    got["flash_attention"] -= got["flash_attention_prompt"]
    for name, n in got.items():
        counts[name] = counts.get(name, 0) + n
    return got


def _zipf_tokens(rng, n: int, vocab: int) -> np.ndarray:
    """Zipf-like token ids in [0, vocab): something a few steps can learn."""
    return np.minimum(rng.zipf(1.1, n) - 1, vocab - 1)


def _rel_fro(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def _train_gemma(dev: dict, seed: int, corpus: str, counts: dict) -> dict:
    """Gemma-2B at 18 layers, bf16: TRAIN_WARMUP + TRAIN_TIMED steps of
    make_train_step's AdamW on batches of TRAIN_BATCH x TRAIN_SEQ tokens read
    through TokenDataset and device_prefetch, then one more step under the
    profiler."""
    from gofr_tpu_torch.data import TokenDataset, device_prefetch
    from gofr_tpu_torch.parallel import make_mesh, make_train_step
    from gofr_tpu_torch.profiling import default_registry

    label = "train gemma"
    cfg = TransformerConfig.gemma_2b()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed + 27), "cuda")
    n_params = sum(t.numel() for t in [params["embed"], params["final_norm"], *params["layers"].values()])
    shard_fn, init_opt, step_fn = make_train_step(cfg, make_mesh())
    params = shard_fn(params)
    opt_state = init_opt(params)
    it = TokenDataset(corpus, seq_len=TRAIN_SEQ - 1).batches(TRAIN_BATCH, seed=seed)

    def feed():  # windows of TRAIN_SEQ tokens, every position kept
        for x in it:
            toks = np.concatenate([x["inputs"], x["targets"][:, -1:]], axis=1)
            yield {"tokens": toks, "mask": np.ones_like(toks, dtype=bool)}

    pf = device_prefetch(feed())
    losses, step_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_launches(TRAIN_KERNELS)
    try:
        for _ in range(TRAIN_WARMUP + TRAIN_TIMED):
            t0 = time.perf_counter()
            b = next(pf)
            params, opt_state, loss = step_fn(params, opt_state, b["tokens"], b["mask"])
            losses.append(float(loss))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        b = next(pf)
        prof = _profile(lambda: step_fn(params, opt_state, b["tokens"], b["mask"]), f"{label} step ")
    finally:
        pf.close()
    got = _train_counted(counts)
    want = cfg.n_layers * (TRAIN_WARMUP + TRAIN_TIMED + 1)
    timed = sorted(step_s[TRAIN_WARMUP:])
    med = statistics.median(timed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * n_params * tokens / med / dev["peaks"][1]
    rows = {e["program"]: (e["compiles"], e["hits"]) for e in default_registry().snapshot(model="train")["programs"]}
    run = {"losses": losses, "step_ms": [1e3 * s for s in step_s], "median_ms": 1e3 * med, "min_ms": 1e3 * timed[0],
           "max_ms": 1e3 * timed[-1], "tokens_s": tokens / med, "mfu": mfu, "peak_bytes": peak, "n_params": n_params,
           "base_bytes": base, "launches": got, "idle": prof["idle"], "registry": rows}
    print(f"{label} on {dev['smi']}: {cfg.n_layers} layers bf16, {n_params / 1e9:.3f} B params, b {TRAIN_BATCH} "
          f"s {TRAIN_SEQ} ({tokens} tokens a step); step ms median {run['median_ms']:.2f} min {run['min_ms']:.2f} "
          f"max {run['max_ms']:.2f} over {TRAIN_TIMED} timed steps (after {TRAIN_WARMUP}: "
          f"{', '.join(f'{1e3 * s:.1f}' for s in step_s[:TRAIN_WARMUP])}); {run['tokens_s']:.1f} trained tokens/s; "
          f"MFU {100 * mfu:.2f}% (6 N T / step / {dev['peaks'][1] / 1e12:.0f} TFLOP/s bf16); peak allocated "
          f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB before the first step); loss first {losses[0]:.4f} last {losses[-1]:.4f} "
          f"({', '.join(f'{x:.3f}' for x in losses)}); flash_attention_prompt launches {got['flash_attention_prompt']} "
          f"({TRAIN_WARMUP + TRAIN_TIMED + 1} steps, the last profiled); registry rows {rows}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses}")
    if got["flash_attention_prompt"] != want or any(got[k] for k in TRAIN_KERNELS if k != "flash_attention_prompt"):
        raise AssertionError(f"{label}: launches {got}, expected {want} of flash_attention_prompt alone")
    if rows.get("parallel.train_step") != (1, TRAIN_WARMUP + TRAIN_TIMED) or rows.get("parallel.init_opt") != (1, 0):
        raise AssertionError(f"{label}: registry rows {rows}")
    return run


def _train_grad(dev: dict, seed: int, counts: dict) -> dict:
    """Gemma-2B's widths at TRAIN_GRAD_LAYERS layers, bf16: the loss and
    every parameter's gradient through the kernel against the same model
    with its attention through flash_attention_plain under autograd; then
    the autograd op alone at the training shape against the plain
    version's autograd."""
    from gofr_tpu_torch.parallel import lm_loss, next_token_loss, value_and_grad

    label = "train grad"
    cfg = dataclasses.replace(TransformerConfig.gemma_2b(), n_layers=TRAIN_GRAD_LAYERS)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed + 28), "cuda")
    rng = np.random.default_rng(seed + 28)
    tokens = torch.from_numpy(_zipf_tokens(rng, TRAIN_BATCH * TRAIN_SEQ, cfg.vocab_size)
                              .reshape(TRAIN_BATCH, TRAIN_SEQ).astype(np.int32)).cuda()
    mask = torch.ones_like(tokens, dtype=torch.bool)
    positions = torch.arange(TRAIN_SEQ, device="cuda")[None, :].expand(TRAIN_BATCH, TRAIN_SEQ)

    def plain_loss(p, cfg, tokens, mask):
        attend = lambda q, k, v: A.flash_attention_plain(  # noqa: E731
            q, k, v, causal=True, logit_cap=cfg.attn_logit_cap, window=cfg.sliding_window)
        return next_token_loss(T.train_forward(p, cfg, tokens, positions, prefill_attn=attend), tokens, mask)

    _zero_launches(TRAIN_KERNELS)
    loss_k, grads_k = value_and_grad(lm_loss, params, cfg, tokens, mask)
    torch.cuda.synchronize()
    got = _train_counted(counts)
    loss_p, grads_p = value_and_grad(plain_loss, params, cfg, tokens, mask)
    errs = {}
    for (path, gk), gp in zip(_flatten(grads_k).items(), _flatten(grads_p).values()):
        errs[path] = _rel_fro(gk, gp)
    worst = max(errs, key=errs.get)
    dloss = abs(float(loss_k) - float(loss_p))
    del grads_k, grads_p, params
    # the op alone at row 2's training shape (not counted)
    g = torch.Generator(device="cuda").manual_seed(seed + 29)
    shape_q, shape_kv = (TRAIN_BATCH, TRAIN_SEQ, 8, 256), (TRAIN_BATCH, TRAIN_SEQ, 1, 256)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16).requires_grad_()
               for s in (shape_q, shape_kv, shape_kv))
    dout = torch.randn(shape_q, generator=g, device="cuda").to(torch.bfloat16)
    out_k = A.flash_attention_train(q, k, v, causal=True)
    dk_ = torch.autograd.grad(out_k, (q, k, v), dout)
    out_p = A.flash_attention_plain(q, k, v, causal=True)
    dp_ = torch.autograd.grad(out_p, (q, k, v), dout)
    op = {"out": float((out_k.detach().float() - out_p.detach().float()).abs().max())}
    for name, a, b in zip(("dq", "dk", "dv"), dk_, dp_):
        op[name] = float((a.float() - b.float()).abs().max())
        op[name + "_rel"] = _rel_fro(a, b)
    run = {"loss_kernel": float(loss_k), "loss_plain": float(loss_p), "dloss": dloss, "rel_fro": errs,
           "worst": worst, "op": op, "launches": got}
    print(f"{label} on {dev['smi']}: Gemma-2B widths at {TRAIN_GRAD_LAYERS} layers bf16, b {TRAIN_BATCH} s "
          f"{TRAIN_SEQ}: loss kernel {float(loss_k):.5f} plain {float(loss_p):.5f} (|diff| {dloss:.2e}, limit "
          f"{TRAIN_LOSS_ATOL}); gradient relative Frobenius error worst {worst} {errs[worst]:.3e} (limit "
          f"{TRAIN_GRAD_RTOL}), by leaf {', '.join(f'{k} {v:.2e}' for k, v in errs.items())}; the op alone at q "
          f"{list(shape_q)} k/v {list(shape_kv)}: max abs err out {op['out']:.3e} dq {op['dq']:.3e} dk "
          f"{op['dk']:.3e} dv {op['dv']:.3e} (relative Frobenius {op['dq_rel']:.2e} / {op['dk_rel']:.2e} / "
          f"{op['dv_rel']:.2e}); flash_attention_prompt launches {got['flash_attention_prompt']}")
    if dloss > TRAIN_LOSS_ATOL or errs[worst] > TRAIN_GRAD_RTOL or not math.isfinite(float(loss_k)):
        raise AssertionError(f"{label}: loss {float(loss_k)} vs {float(loss_p)}, worst {worst} {errs[worst]}")
    if max(op["dq_rel"], op["dk_rel"], op["dv_rel"]) > TRAIN_GRAD_RTOL or op["out"] > BF16_ATOL:
        raise AssertionError(f"{label}: the op alone {op}")
    if got["flash_attention_prompt"] != TRAIN_GRAD_LAYERS:
        raise AssertionError(f"{label}: launches {got}")
    return run


def _train_attn(dev: dict, seed: int, step_ms: float, layers: int) -> dict:
    """Row 2 at the training shape (q [4, 512, 8, 256], k/v [4, 512, 1, 256]
    bf16, causal): the forward kernel and flash_attention_backward, each by
    CUDA events and by the profiler's device time, their bounds, and their
    share of a Gemma step (``layers`` of each)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 30)
    shape_q, shape_kv = (TRAIN_BATCH, TRAIN_SEQ, 8, 256), (TRAIN_BATCH, TRAIN_SEQ, 1, 256)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16) for s in (shape_q, shape_kv, shape_kv))
    dout = torch.randn(shape_q, generator=g, device="cuda").to(torch.bfloat16)
    out = A.flash_attention(q, k, v, causal=True)

    def fwd():
        return A.flash_attention(q, k, v, causal=True)

    def bwd():
        return A.flash_attention_backward(q, k, v, out, dout, True)

    nbytes, flops, _mask = _flash_work(q, k, None, True, 0)
    f_bound, f_by = _bound(nbytes, flops, torch.bfloat16, dev["peaks"])
    # the backward reads q, k, v, out, dout and writes dq, dk, dv (twice
    # the forward's bytes); it recomputes the scores and forms dP, dV, dQ,
    # dK: 5 products of 2 d flops a pair, where the forward has 2
    b_bound, b_by = _bound(2 * nbytes, 2.5 * flops, torch.bfloat16, dev["peaks"])
    run = {"fwd_ms": time_ms(fwd), "fwd_device_ms": device_ms(fwd, "flash_mma_kernel"),
           "bwd_ms": time_ms(bwd, iters=10), "bwd_device_ms": device_ms(bwd, None, iters=10),
           "fwd_bound_ms": f_bound, "fwd_bound_by": f_by, "bwd_bound_ms": b_bound, "bwd_bound_by": b_by,
           "plain_ms": time_ms(lambda: A.flash_attention_plain(q, k, v, causal=True), iters=10),
           "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
               q.transpose(1, 2), k.transpose(1, 2).expand(-1, 8, -1, -1),
               v.transpose(1, 2).expand(-1, 8, -1, -1), is_causal=True))}
    per_step = layers * (run["fwd_ms"] + run["bwd_ms"])
    run["share"] = per_step / step_ms
    print(f"train attn on {dev['smi']}: q {list(shape_q)} k/v {list(shape_kv)} bf16 causal: forward kernel "
          f"{run['fwd_ms']:.4f} ms ({run['fwd_device_ms']:.4f} device ms; bound {f_bound:.5f} ms by {f_by}; plain "
          f"{run['plain_ms']:.4f} ms; SDPA {run['library_ms']:.4f} ms), backward (plain PyTorch, no kernel) {run['bwd_ms']:.4f} ms "
          f"({run['bwd_device_ms']:.4f} device ms; bound {b_bound:.5f} ms by {b_by}); {layers} layers of both "
          f"{per_step:.2f} ms = {100 * run['share']:.1f}% of the median Gemma step {step_ms:.2f} ms")
    return run


def _train_moe(dev: dict, seed: int, counts: dict) -> dict:
    """moe_lm_loss at Mixtral-8x7B's widths, TRAIN_MOE_LAYERS of 32 layers,
    bf16, b TRAIN_MOE_BATCH s TRAIN_SEQ: TRAIN_MOE_STEPS AdamW steps on
    seeded Zipf-like batches."""
    from gofr_tpu_torch.parallel import AdamW, value_and_grad

    label = "train moe"
    cfg = TM.MoEConfig(vocab_size=32_000, d_model=4096, n_layers=TRAIN_MOE_LAYERS, n_heads=32, head_dim=128,
                       d_ff=14_336, n_experts=8, top_k=2, dtype=torch.bfloat16)
    params = TM.moe_init(torch.Generator(device="cuda").manual_seed(seed + 31), cfg, "cuda")
    n_params = sum(t.numel() for t in _flatten(params).values())
    opt = AdamW(3e-4)
    state = opt.init(params)
    rng = np.random.default_rng(seed + 31)
    losses, step_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_launches(TRAIN_KERNELS)
    for _ in range(TRAIN_MOE_STEPS):
        toks = torch.from_numpy(_zipf_tokens(rng, TRAIN_MOE_BATCH * TRAIN_SEQ, cfg.vocab_size)
                                .reshape(TRAIN_MOE_BATCH, TRAIN_SEQ).astype(np.int32)).cuda()
        mask = torch.ones_like(toks, dtype=torch.bool)
        t0 = time.perf_counter()
        loss, grads = value_and_grad(TM.moe_lm_loss, params, cfg, toks, mask)
        opt.update(params, grads, state)
        del grads
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    got = _train_counted(counts)
    timed = sorted(step_s[2:])
    run = {"losses": losses, "median_ms": 1e3 * statistics.median(timed), "min_ms": 1e3 * timed[0],
           "max_ms": 1e3 * timed[-1], "peak_bytes": peak, "base_bytes": base, "n_params": n_params, "launches": got}
    print(f"{label} on {dev['smi']}: Mixtral-8x7B widths at {TRAIN_MOE_LAYERS} of 32 layers bf16, "
          f"{n_params / 1e9:.3f} B params, b {TRAIN_MOE_BATCH} s {TRAIN_SEQ}: step ms median {run['median_ms']:.2f} "
          f"min {run['min_ms']:.2f} max {run['max_ms']:.2f} (after 2: {1e3 * step_s[0]:.1f}, {1e3 * step_s[1]:.1f}); "
          f"peak allocated {peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB before the first step); loss first "
          f"{losses[0]:.4f} last {losses[-1]:.4f} ({', '.join(f'{x:.3f}' for x in losses)}); "
          f"flash_attention_prompt launches {got['flash_attention_prompt']}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses}")
    if got["flash_attention_prompt"] != TRAIN_MOE_LAYERS * TRAIN_MOE_STEPS:
        raise AssertionError(f"{label}: launches {got}")
    return run


def _train_example(dev: dict, tmp: str, counts: dict) -> dict:
    """The train-lm example in this process, on the card: encode, train
    -steps=8, train -steps=8 again from the same -ckpt; the checkpoint read
    back and written again byte for byte."""
    from gofr_tpu_torch.examples import train_lm
    from gofr_tpu_torch.models.checkpoint import load_train_state, save_train_state

    label = "train example"
    app = train_lm.build_app()
    corpus, ckpt = os.path.join(tmp, "example.tok"), os.path.join(tmp, "example-run")

    def run_cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = app.run(argv)
        out = buf.getvalue().strip().splitlines()
        if rc != 0:
            raise AssertionError(f"{label}: {argv} exited {rc}: {out[-5:]}")
        return out[-1]

    _zero_launches(TRAIN_KERNELS)
    t0 = time.perf_counter()
    wrote = run_cli(["encode", f"-out={corpus}", "-n=50000"])
    first = ast.literal_eval(run_cli(["train", f"-corpus={corpus}", "-steps=8", f"-ckpt={ckpt}"]))
    second = ast.literal_eval(run_cli(["train", f"-corpus={corpus}", "-steps=8", f"-ckpt={ckpt}"]))
    seconds = time.perf_counter() - t0
    got = _train_counted(counts)
    state = os.path.join(ckpt, train_lm.STATE_FILE)
    again = os.path.join(tmp, "again.safetensors")
    save_train_state(again, *load_train_state(state, device="cuda"))
    with open(state, "rb") as f1, open(again, "rb") as f2:
        bitwise = f1.read() == f2.read()
    run = {"first": first, "second": second, "seconds": seconds, "bitwise": bitwise, "launches": got}
    print(f"{label} on {dev['smi']}: {wrote}; train 8 steps {first}; again from the checkpoint {second}; "
          f"{seconds:.2f}s; checkpoint read back and rewritten byte for byte: {bitwise}; "
          f"flash_attention_prompt launches {got['flash_attention_prompt']}")
    if first["device"] != "cuda" or second["global_step"] != 16 or second["resumed"] != {"epoch": 0, "step": 8}:
        raise AssertionError(f"{label}: {first} then {second}")
    if not bitwise or not second["loss_last"] < first["loss_first"]:
        raise AssertionError(f"{label}: bitwise {bitwise}, losses {first} then {second}")
    if got["flash_attention_prompt"] != TransformerConfig.tiny().n_layers * 16:
        raise AssertionError(f"{label}: launches {got}")
    return run


def _train_data(dev: dict, corpus: str) -> dict:
    """The data loader's batch gather at the Gemma steps' batch: whether the
    native _gofr_torch_data loaded, and batches/s through it and through the
    numpy gather on the same window ids."""
    from gofr_tpu_torch.data import TokenDataset
    from gofr_tpu_torch.native import DATA_MODULE, build_error

    ds = TokenDataset(corpus, seq_len=TRAIN_SEQ - 1)
    ids = np.random.default_rng(0).integers(0, ds.n_windows, (TRAIN_DATA_GATHERS, TRAIN_BATCH))
    core = ds._core
    rates = {}
    outs = {}
    for name, c in (("native", core), ("numpy", None)):
        if name == "native" and c is None:
            continue
        ds._core = c
        t0 = time.perf_counter()
        for row in ids:
            ds.gather(row)
        rates[name] = TRAIN_DATA_GATHERS / (time.perf_counter() - t0)
        outs[name] = ds.gather(ids[0])
    ds._core = core
    same = "native" not in outs or np.array_equal(outs["native"], outs["numpy"])
    run = {"native_loaded": core is not None, "rates": rates, "same": same}
    print(f"train data on {dev['smi']}: {DATA_MODULE} loaded: {core is not None}"
          f"{'' if core is not None else f' (build error: {build_error(DATA_MODULE)})'}; gathered batches/s of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} uint32 tokens: " + ", ".join(f"{k} {v:.0f}" for k, v in rates.items())
          + f" ({TRAIN_DATA_GATHERS} batches each); the two gathers equal: {same}")
    if not same:
        raise AssertionError("train data: native and numpy gathers differ")
    return run


def phase_train(dev: dict, seed: int) -> dict:
    """Training on the card (see the module docstring): train gemma, train
    grad, train attn, train moe, train example and train data. Makes its
    own weights. ``launches``: the counted parts' launches by kernel
    (flash_attention's q_offsets mode alone)."""
    from gofr_tpu_torch.data import encode_corpus

    counts: dict = {}
    tmp = tempfile.mkdtemp(prefix="gofr-train-")
    try:
        corpus = encode_corpus(_zipf_tokens(np.random.default_rng(seed), TRAIN_CORPUS, 256_000),
                               os.path.join(tmp, "gemma.tok"), vocab_size=256_000)
        gemma = _train_gemma(dev, seed, corpus, counts)
        gc.collect()
        torch.cuda.empty_cache()
        grad = _train_grad(dev, seed, counts)
        gc.collect()
        torch.cuda.empty_cache()
        attn = _train_attn(dev, seed, gemma["median_ms"], TransformerConfig.gemma_2b().n_layers)
        moe = _train_moe(dev, seed, counts)
        gc.collect()
        torch.cuda.empty_cache()
        example = _train_example(dev, tmp, counts)
        data = _train_data(dev, corpus)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"train launches by kernel (flash_attention: its q_offsets mode alone): {counts}")
    return {"gemma": gemma, "grad": grad, "attn": attn, "moe": moe, "example": example, "data": data,
            "launches": counts}


def _batch_seconds(seconds: dict, bat: dict) -> None:
    """The batch phase's Kafka run and broker examples as phases of their own."""
    for part, key in (("batch kafka", "kafka"), ("pubsub", "pubsub")):
        seconds["batch"] -= bat[key]["seconds"]
        seconds[part] = bat[key]["seconds"]

def main() -> int:
    ap = argparse.ArgumentParser(description="GPU smoke run of gofr_tpu_torch on one card")
    ap.add_argument("--parent", metavar="TREE",
                    help="also build another checkout's paged-decode kernels (e.g. the parent commit from "
                         "git archive) and time them beside this tree's on the same inputs")
    ap.add_argument("--only", choices=("observe", "families", "moe", "contiguous", "wave", "knobs", "mnist", "fleet",
                                       "rollout", "disagg", "gateway", "edge", "batch", "router", "train"),
                    help="build the kernels and run this one phase, which makes its own weights (prints no "
                         "kernels line and no result)")
    ap.add_argument("--engine-process", action="store_true",
                    help="serve as one engine process of the router phase (launched by the front router)")
    ap.add_argument("--port", type=int, help="--engine-process: the HTTP port")
    ap.add_argument("--metrics-port", type=int, default=0, help="--engine-process: the metrics port")
    ap.add_argument("--log-dir", help="--engine-process: where its log goes")
    args = ap.parse_args()
    if args.engine_process:
        return engine_process(args)
    dev = phase_device()
    # every engine built from here on is armed: its deaths, quarantines,
    # rollbacks and anomalies write bundles here (one a trigger class a
    # second, not a minute, so each phase's bundles all land)
    box = tempfile.mkdtemp(prefix="gofr-blackbox-")
    os.environ["GOFR_BLACKBOX_DIR"] = box
    os.environ["GOFR_BLACKBOX_INTERVAL_S"] = "1"
    try:
        return _main(args, dev)
    finally:
        shutil.rmtree(box, ignore_errors=True)


def _bundle_counts() -> dict:
    """{trigger: bundles} in the script's black-box directory."""
    out: dict = {}
    for name in os.listdir(os.environ["GOFR_BLACKBOX_DIR"]):
        try:
            with open(os.path.join(os.environ["GOFR_BLACKBOX_DIR"], name, "manifest.json")) as f:
                trigger = json.load(f)["trigger"]
        except (OSError, ValueError, KeyError):
            continue
        out[trigger] = out.get(trigger, 0) + 1
    return out


def _edge_seconds(seconds: dict, edge: dict) -> None:
    """The edge phase's parts as phases of their own in ``phase seconds``."""
    for part in ("native", "gateway", "prefork", "datasources"):
        seconds["edge"] -= edge[part]["seconds"]
        seconds[part] = edge[part]["seconds"]


def _main(args, dev: dict) -> int:
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        gc.collect()  # a closed engine's pool, held by reference cycles until collected
        torch.cuda.empty_cache()
        return out

    timed("build", phase_build)
    if args.only:
        if args.only == "observe":
            timed("observe", phase_observe, dev, SEED, *gemma_weights(SEED))
        elif args.only == "batch":  # an engine of its own at the engine phase's defaults
            from gofr_tpu_torch.metrics import Manager

            cfg, params = gemma_weights(SEED)
            engine = LLMEngine(cfg, params, seed=SEED, metrics=Manager())
            try:
                _batch_seconds(seconds, timed("batch", phase_batch, dev, SEED, cfg, params, engine))
            finally:
                engine.close()
        elif args.only == "router":
            timed("router", phase_router, dev, SEED)
        elif args.only in ("gateway", "edge"):  # the edge phase's model app of its own, full depth, and its parts
            _edge_seconds(seconds, timed("edge", phase_edge, dev, SEED, *gemma_weights(SEED), None))
        else:
            timed(args.only, {"families": phase_families, "moe": phase_moe, "contiguous": phase_contiguous,
                              "wave": phase_wave, "knobs": phase_knobs, "mnist": phase_mnist,
                              "fleet": phase_fleet, "rollout": phase_rollout, "disagg": phase_disagg,
                              "train": phase_train}[args.only], dev, SEED)
        print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
        print(f"black-box bundles by trigger: {_bundle_counts()}")
        return 0
    kern = timed("kernels", phase_kernels, dev, SEED, build_parent(args.parent) if args.parent else None)
    # the families' shapes too, before any engine has run (after one had, the
    # profiler kept only a few of a timing's kernel records at some shapes)
    for name in FAMILY_MODELS:
        timed(f"kernels {name}", _family_kernels, dev, name, getattr(TransformerConfig, name)(), SEED)
    cfg, params = gemma_weights(SEED)
    eng, engine = timed("engine", phase_engine, dev, SEED, cfg, params)
    try:
        obs = timed("observe", phase_observe, dev, SEED, cfg, params, engine, eng)
        ovl = timed("overload", phase_overload, dev, SEED, cfg, params, engine)
        bat = timed("batch", phase_batch, dev, SEED, cfg, params, engine)
        _batch_seconds(seconds, bat)
    finally:
        engine.close()
    del engine  # its pool and graphs go at the next phase's collection
    eng8 = timed("int8", phase_engine_int8, dev, SEED, cfg, params)
    lora = timed("lora", phase_lora, dev, SEED, cfg, params, eng)
    _edge_seconds(seconds, timed("edge", phase_edge, dev, SEED, cfg, params, eng))
    pre = timed("prefix", phase_prefix, dev, SEED, cfg, params)
    pre8 = timed("prefix int8", phase_prefix_int8, dev, SEED, cfg, params)
    spec = timed("spec", phase_spec, dev, SEED, cfg, params)
    structured = timed("structured", phase_structured, dev, SEED, cfg, params)
    wave = timed("wave", phase_wave, dev, SEED, cfg, params)
    knobs = timed("knobs", phase_knobs, dev, SEED, cfg, params)
    fleet = timed("fleet", phase_fleet, dev, SEED, cfg, params, eng)
    rollout = timed("rollout", phase_rollout, dev, SEED)
    disagg = timed("disagg", phase_disagg, dev, SEED)
    del params  # Gemma-2B's weights; the families phase loads one model at a time
    families = timed("families", phase_families, dev, SEED)
    moe = timed("moe", phase_moe, dev, SEED)
    contiguous = timed("contiguous", phase_contiguous, dev, SEED)
    timed("mnist", phase_mnist, dev, SEED)
    rt = timed("router", phase_router, dev, SEED)
    train = timed("train", phase_train, dev, SEED)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    print(f"script seconds: {sum(seconds.values()):.1f}; black-box bundles by trigger: {_bundle_counts()}")
    # name -> (source, replaced Pallas kernel, timing key, engine run whose
    # launches count, prefix phases' launches). flash_attention_prompt is
    # the same kernel in its full-prompt mode (row 2), counted apart; its
    # main path is the wave's burst
    sources = {
        "flash_attention": ("gofr_tpu_torch/csrc/flash_attention.cu", "gofr_tpu/ops/attention.py:101",
                            "flash_attention c64", eng, pre["launches"]["flash_attention"]),
        "flash_attention_prompt": ("gofr_tpu_torch/csrc/flash_attention.cu",
                                   "gofr_tpu/ops/attention.py:254-282 (:309)", "flash_attention prompt wave b128 w8",
                                   wave["gemma"], pre["launches"]["flash_attention_prompt"]),
        "paged_decode_partials": ("gofr_tpu_torch/csrc/paged_decode.cu", "gofr_tpu/ops/attention.py:661",
                                  "paged_decode_partials", eng, pre["launches"]["paged_decode_partials"]),
        "paged_decode_partials_int8": ("gofr_tpu_torch/csrc/paged_decode.cu",
                                       "gofr_tpu/ops/attention.py:661 (quantized=True)",
                                       "paged_decode_partials_int8", eng8, pre8["launches"]),
    }
    kernels = []
    for name, (src, replaces, tkey, run, prefix_launches) in sources.items():
        t = kern["timings"][tkey]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": run["launches"][name], "prefix_launches": prefix_launches,
            "spec_launches": spec["launches"][name], "structured_launches": structured["launches"][name],
            "observe_launches": obs["launches"][name],
            "overload_launches": ovl["launches"][name], "lora_launches": lora["launches"][name],
            "families_launches": {label: n[name] for label, n in families["launches"].items()},
            "moe_launches": {label: n[name] for label, n in moe["launches"].items()},
            "contiguous_launches": {label: n[name] for label, n in contiguous["launches"].items()},
            "wave_launches": {label: n[name] for label, n in wave["launches"].items()},
            "knobs_launches": {label: n[name] for label, n in knobs["launches"].items()},
            "fleet_launches": fleet["launches"][name],
            "rollout_launches": rollout["launches"][name], "disagg_launches": disagg["launches"][name],
            "router_launches": rt["launches"][name], "batch_launches": bat["launches"][name],
            "batch_kafka_launches": bat["kafka"]["launches"][name], "train_launches": train["launches"][name],
            "max_abs_err": kern["errs"][name],
            "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(dev["smi"])  # name, power limit: nvidia-smi's own line
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
