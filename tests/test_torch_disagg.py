"""Disaggregated prefill/decode serving in gofr_tpu_torch (``llm_disagg``,
the engine's KV handoff, ``CacheManager.lookup_seed(count=False)`` /
``release_blocks`` / ``handoff_commit``, ``register_llm(disagg=)``)
against gofr_tpu's on the CPU, on the same tiny weights (f32, untied
random head): tokens against ``gofr_tpu.llm_disagg.DisaggregatedLLMEngine``
and the colocated port engine, the handoff payload against the JAX
engine's export, the refusals in the JAX package's words, and the
device-copy and host-staged imports byte for byte."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.llm_disagg import DisaggregatedLLMEngine as JDisagg
from gofr_tpu.metrics import new_metrics_manager
from gofr_tpu.models import generate as j_generate
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.datasource.gpu import GPURuntime
from gofr_tpu_torch.llm import EngineStoppedError, GenRequest, LLMEngine
from gofr_tpu_torch.llm_disagg import DisaggregatedLLMEngine
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.resilience.rollout import ModelHandle, RolloutError

# tests/test_sharded_serving.py's engine shape
KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8,), decode_chunk=4, prefill_chunk=4, step_token_budget=8)
PORT_KW = dict(KW, device="cpu")
JAX_KW = dict(KW, warmup=False)
MIXED = [[5, 9, 2, 7], list(range(1, 25)), [8, 8, 1], list(range(30, 50)), [3, 1, 4, 1, 5], [2] * 16]


@pytest.fixture(scope="module")
def weights():
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    # untied random head: the tied tiny model repeats its input token
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    tcfg = TT.TransformerConfig.tiny()
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _ref(weights, prompt, n: int) -> list[int]:
    jcfg, jp = weights[0], weights[1]
    out = j_generate(jp, jcfg, jnp.asarray([list(prompt)], jnp.int32), jnp.asarray([len(prompt)], jnp.int32), n)
    return [int(t) for t in np.asarray(out)[0]]


def _disagg(weights, **kw) -> DisaggregatedLLMEngine:
    return DisaggregatedLLMEngine(weights[2], weights[3], replicas=2, prefill_replicas=1, supervise=False,
                                  **{**PORT_KW, **kw})


def _wait(pred, timeout: float, what: str) -> None:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def test_export_import_round_trip_is_an_exact_hit(weights):
    """A published prompt's blocks and logits, exported by one engine and
    imported by another, make its next admission an exact hit with the
    reference's tokens; the payload holds the JAX export's values."""
    prompt = [5, 9, 2, 7, 1, 3]
    kw = dict(PORT_KW, prefix_cache_mb=8.0)
    src, dst = LLMEngine(weights[2], weights[3], kv_label="src", **kw), LLMEngine(weights[2], weights[3], **kw)
    je = JEngine(weights[0], weights[1], prefix_cache_mb=8.0, **JAX_KW)
    try:
        src.generate(list(prompt), max_new_tokens=1, eos_token=-1)
        je.generate(list(prompt), max_new_tokens=1, eos_token=-1)
        payload, jpay = src.kv_handoff_export(prompt, timeout=15), je.kv_handoff_export(prompt, timeout=15)
        assert payload is not None and jpay is not None and payload["ready"] is None
        assert (payload["n_full"], payload["tail_len"]) == (jpay["n_full"], jpay["tail_len"])
        assert payload["n_full"] * src.kv.block + payload["tail_len"] == len(prompt)
        for x in ("k", "v", "logits"):
            np.testing.assert_allclose(payload[x].numpy(), np.asarray(jpay[x]), atol=1e-5, rtol=1e-5)
        # host staging as the JAX test does it: numpy arrays
        host = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in payload.items()}
        assert dst.kv_handoff_import(host, timeout=15)
        hits0 = dst.stats()["kvcache"]["prefix"]["hits"]
        assert dst.generate(list(prompt), max_new_tokens=8) == _ref(weights, prompt, 8)
        assert dst.stats()["kvcache"]["prefix"]["hits"] == hits0 + 1  # prefill skipped
        assert dst.stats()["prefill_tokens"] == 0
    finally:
        src.close()
        dst.close()
        je.close()


def test_export_none_for_an_unpublished_prompt_and_an_unpaged_engine(weights):
    eng = LLMEngine(weights[2], weights[3], prefix_cache_mb=8.0, **PORT_KW)
    flat = LLMEngine(weights[2], weights[3], kv_paged=False, **PORT_KW)
    je = JEngine(weights[0], weights[1], prefix_cache_mb=8.0, **JAX_KW)
    try:
        assert eng.kv_handoff_export([1, 2, 3], timeout=15) is None
        assert je.kv_handoff_export([1, 2, 3], timeout=15) is None
        assert flat.kv_handoff_export([1, 2, 3]) is None
        assert not flat.kv_handoff_import({"k": np.zeros((2, 1, 16, 2, 16))})
        assert eng.kv_placement() == torch.device("cpu")
    finally:
        eng.close()
        flat.close()
        je.close()


def test_export_counts_no_hit(weights):
    """``count=False``: an export probe leaves the port's hit counters
    alone, as it leaves the JAX engine's app_kvcache_events series (JAX's
    radix stats count every lookup; the port's stand in for the series)."""
    prompt = [5, 9, 2, 7, 1, 3, 8]
    m = new_metrics_manager()
    eng = LLMEngine(weights[2], weights[3], prefix_cache_mb=8.0, **PORT_KW)
    je = JEngine(weights[0], weights[1], prefix_cache_mb=8.0, metrics=m, **JAX_KW)

    def jax_hits():
        rows = [ln for ln in m.render_prometheus().splitlines() if ln.startswith("app_kvcache_events") and
                'event="hit"' in ln]
        return sum(float(r.rsplit(" ", 1)[1]) for r in rows)

    try:
        eng.generate(list(prompt), max_new_tokens=1, eos_token=-1)
        je.generate(list(prompt), max_new_tokens=1, eos_token=-1)
        before, jbefore = eng.stats()["kvcache"]["prefix"], jax_hits()
        for _ in range(3):
            assert eng.kv_handoff_export(prompt) is not None and je.kv_handoff_export(prompt) is not None
        assert eng.stats()["kvcache"]["prefix"] == before and jax_hits() == jbefore
        plan = eng.kv.lookup_seed(prompt, allow_partial=False)  # an admission's consult counts
        eng.kv.release_plan(plan)
        assert eng.stats()["kvcache"]["prefix"]["hits"] == before["hits"] + 1
    finally:
        eng.close()
        je.close()


def test_matches_jax_and_colocated_under_mixed_load(weights):
    """Concurrent short and long prompts (several prefill chunks each)
    through a 1-prefill + 1-decode pair: tokens equal the colocated port
    engine's and the JAX disaggregated engine's, every request is handed
    off, and the decode pool admits each as an exact hit, prefilling
    nothing."""
    ctrl = LLMEngine(weights[2], weights[3], **PORT_KW)
    try:
        want = [ctrl.generate(list(p), max_new_tokens=6) for p in MIXED]
    finally:
        ctrl.close()
    jeng = JDisagg(weights[0], weights[1], replicas=2, prefill_replicas=1, supervise=False, **JAX_KW)
    try:
        jgot = [r.tokens(timeout=120) for r in [jeng.submit(_jreq(p)) for p in MIXED]]
    finally:
        jeng.close()
    eng = _disagg(weights)
    try:
        got = [r.tokens(timeout=120) for r in [eng.submit(GenRequest(list(p), max_new_tokens=6)) for p in MIXED]]
        assert got == want == jgot
        st = eng.stats()
        assert (st["handoff"]["ok"], st["handoff"]["miss"], st["handoff"]["fallbacks"]) == (len(MIXED), 0, 0)
        assert st["handoff"]["bytes"] > 0 and st["handoff"]["latency"]["count"] == len(MIXED)
        pre, dec = st["prefill"]["per_replica"][0], st["decode"]["per_replica"][0]
        assert pre["submitted"] == dec["submitted"] == len(MIXED)
        assert (pre["role"], dec["role"]) == ("prefill", "decode")
        assert dec["kvcache"]["prefix"]["hits"] == len(MIXED) and dec["prefill_tokens"] == 0
        assert pre["kvcache"]["prefix"]["hits"] == 0  # the exports counted nothing
    finally:
        eng.close()


def _jreq(p):
    from gofr_tpu.llm import GenRequest as JRequest

    return JRequest(list(p), max_new_tokens=6)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_device_copy_and_host_staged_imports_are_byte_identical(weights, pool):
    """``handoff_d2d`` on and off: the blocks each import wrote into the
    decode pool (read back right after the scatter, with an int8 pool's
    scales) and the logits are equal byte for byte, and so are the
    streams."""
    if pool == "bf16":
        cfg = dataclasses.replace(weights[2], dtype=torch.bfloat16)
        w = (weights[0], weights[1], cfg, TT.params_from_jax(jax.tree.map(np.asarray, weights[1]), cfg, device="cpu"))
        kw = {}
    else:
        w, kw = weights, {"kv_int8": True}
    prompt = list(range(1, 20))
    seen = {}
    for d2d in (True, False):
        eng = _disagg(w, handoff_d2d=d2d, **kw)
        deng = eng.decode.engines[0]
        commit = deng.kv.handoff_commit
        wrote = []

        def spy(tokens, blocks, tail_block, tail_len, *, logits=None, logits_nbytes=0, deng=deng, commit=commit,
                wrote=wrote):
            idx = torch.tensor(blocks + ([tail_block] if tail_block >= 0 else []))
            sc = deng.pool_scales.index_select(2, idx).clone() if deng.pool_scales is not None else None
            wrote.append((deng.pool.k.index_select(1, idx).clone(), deng.pool.v.index_select(1, idx).clone(), sc,
                          logits.clone()))
            return commit(tokens, blocks, tail_block, tail_len, logits=logits, logits_nbytes=logits_nbytes)

        deng.kv.handoff_commit = spy
        try:
            toks = eng.generate(list(prompt), max_new_tokens=8)
            assert eng.handoffs_ok == 1 and eng.handoff_d2d is d2d and len(wrote) == 1
            seen[d2d] = (toks, wrote[0])
        finally:
            eng.close()
    (t1, a), (t2, b) = seen[True], seen[False]
    assert t1 == t2
    assert a[0].dtype == (torch.int8 if pool == "int8" else torch.bfloat16)
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    assert (a[2] is not None) is (pool == "int8")


def test_dead_decode_pool_reprefills_on_a_live_replica(weights):
    prompt = [5, 9, 2, 7, 1, 3, 8]
    eng = _disagg(weights)
    try:
        eng.decode.engines[0]._die("injected for the handoff-failover test")
        _wait(lambda: not eng.decode.engines[0].alive(), 10, "the decode replica's death")
        assert eng.generate(list(prompt), max_new_tokens=6) == _ref(weights, prompt, 6)
        assert eng.fallbacks >= 1 and eng.handoffs_ok == 0
    finally:
        eng.close()


def test_handoff_timeout_degrades_to_reprefill(weights):
    prompt = [5, 9, 2, 7, 1]
    eng = _disagg(weights)
    try:
        peng = eng.prefill.engines[0]
        peng.kv_handoff_export = lambda *a, **k: (_ for _ in ()).throw(TimeoutError("forced (test)"))
        assert eng.generate(list(prompt), max_new_tokens=6) == _ref(weights, prompt, 6)
        assert eng.handoffs_miss == 1 and eng.handoffs_ok == 0 and eng.fallbacks == 0
        assert eng.decode.engines[0].stats()["prefill_tokens"] == len(prompt)  # the decode side re-prefilled
    finally:
        eng.close()


def test_sessions_route_to_the_decode_pool(weights):
    prompt = [5, 9, 2, 7]
    eng = _disagg(weights, session_mb=16.0)
    try:
        got = eng.submit(GenRequest(list(prompt), max_new_tokens=5, session_id="conv-1")).tokens(timeout=60)
        assert got == _ref(weights, prompt, 5)
        assert eng.decode.engines[0].submitted == 1 and eng.prefill.engines[0].submitted == 0
    finally:
        eng.close()


def test_one_fairness_ledger_across_pools(weights):
    eng = _disagg(weights)
    try:
        assert eng.prefill.ledger is not None and eng.prefill.ledger is eng.decode.ledger
        got = eng.submit(GenRequest([5, 9, 2], max_new_tokens=4, client="alice")).tokens(timeout=60)
        assert got == _ref(weights, [5, 9, 2], 4)
        assert "alice" in eng.prefill.ledger.snapshot()["counters"]
        _wait(lambda: eng.load_tokens() == 0, 10, "the load to drain to zero")
    finally:
        eng.close()


@pytest.mark.parametrize("bad", ["unpaged", "mesh"])
def test_refusals_in_the_jax_words(weights, bad):
    kw = {"kv_paged": False} if bad == "unpaged" else {"mesh": object(), "param_specs": object()}
    with pytest.raises(ValueError) as jerr:
        JDisagg(weights[0], weights[1], replicas=2, **JAX_KW, **kw)
    with pytest.raises(ValueError) as err:
        DisaggregatedLLMEngine(weights[2], weights[3], replicas=2, **PORT_KW, **kw)
    assert str(err.value) == str(jerr.value)


def test_deploy_raises_rollout_error_and_the_runtime_knobs(weights, monkeypatch):
    """``deploy`` refuses in JAX's words, also through the handle that
    ``register_llm`` returns; ``TPU_LLM_DISAGG`` and its knobs build the
    fleet; tensor-parallel pools stay refused."""
    from gofr_tpu.resilience.rollout import RolloutError as JRolloutError

    with pytest.raises(JRolloutError) as jerr:
        JDisagg.deploy(None, weights[0], weights[1])
    rt = GPURuntime(new_mock_config({"TORCH_DEVICE": "cpu", "TPU_LLM_DISAGG": "1",
                                     "TPU_LLM_DISAGG_PREFILL_REPLICAS": "1", "TPU_LLM_KV_HANDOFF_TIMEOUT_S": "3",
                                     "TPU_LLM_KV_HANDOFF_D2D": "0"}))
    try:
        h = rt.register_llm("m", weights[2], weights[3], supervise=False, **KW)
        assert isinstance(h, ModelHandle) and isinstance(h.engine, DisaggregatedLLMEngine)
        assert (h.handoff_timeout_s, h.handoff_d2d, h.prefill_replicas) == (3.0, False, 1)
        assert [e.label for e in h.engines] == ["m/prefill/r0", "m/decode/r0"]
        with pytest.raises(RolloutError) as err:
            h.deploy(weights[2], weights[3])
        assert str(err.value) == str(jerr.value) and err.value.status_code == 400
        assert h.rollout_state() is None
        assert h.generate([5, 9, 2], max_new_tokens=4) == _ref(weights, [5, 9, 2], 4)
        assert h.stats()["handoff"]["ok"] == 1
    finally:
        rt.close()
    plain = GPURuntime(new_mock_config({"TORCH_DEVICE": "cpu"}))
    try:
        with pytest.raises(ValueError, match="disaggregated fleet only"):
            plain.register_llm("m", weights[2], weights[3], prefill_replicas=1, **KW)
        with pytest.raises(NotImplementedError, match="meshes"):
            DisaggregatedLLMEngine(weights[2], weights[3], meshes=[object(), object()], **PORT_KW)
    finally:
        plain.close()


def test_scheduler_work_and_resident_slots(weights):
    """The scheduler-work queue runs a closure on the scheduler thread,
    hands its error to the caller, and fails fast once the engine closed;
    ``resident_slots`` counts occupied slots."""
    import threading

    eng = LLMEngine(weights[2], weights[3], prefix_cache_mb=8.0, **PORT_KW)
    try:
        assert eng._run_on_scheduler(lambda: threading.current_thread().name) == "llm-torch-sched"
        with pytest.raises(KeyError):
            eng._run_on_scheduler(lambda: {}["x"])
        assert eng.resident_slots() == 0 and eng.role == "" and eng.stats()["errored"] == 0
        eng._drain_submits = lambda: None  # hold requests out of the slots
        eng.submit(GenRequest([1, 2, 3], max_new_tokens=4))
        assert eng.resident_slots() == 0 and eng.load() == 1
    finally:
        eng.close()
    with pytest.raises(EngineStoppedError):
        eng._run_on_scheduler(lambda: 1)
