"""gofr_tpu_torch.llm.LLMEngine against gofr_tpu.llm.LLMEngine: greedy token
identity on the same tiny weights (CPU), with chunked-prefill rows and
decode sharing steps, plus the port's import guard."""

import ast
import pathlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch.llm import GenRequest, LLMEngine, RequestFailed, finite_guard
from gofr_tpu_torch.models import transformer as TT

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE_KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8, 16))


@pytest.fixture(scope="module")
def weights():
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    # untied random head: the tied tiny model repeats its input token
    jp = dict(jp, unembed=jax.random.normal(
        jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32
    ))
    tcfg = TT.TransformerConfig.tiny()
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def engines(weights):
    jcfg, jp, tcfg, tp = weights
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW)
    yield ref, port
    ref.close()
    port.close()


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).tolist() for n in lengths]


def test_greedy_identity_one_at_a_time(engines):
    ref, port = engines
    # straddle one block (16) and one chunk boundary (tests/test_paged_kv.py)
    for prompt in _prompts(7, (3, 17, 33)):
        want = ref.generate(prompt, max_new_tokens=8)
        assert port.generate(prompt, max_new_tokens=8) == want
        assert len(set(want)) > 1  # a real stream, not one repeated token


def test_greedy_identity_concurrent(engines):
    """More requests than slots, submitted together: prefill chunks of
    some rows share unified steps with other rows' decode chunks."""
    ref, port = engines
    prompts = _prompts(11, (3, 17, 33, 9, 40, 16))
    jreqs = [ref.submit(JRequest(p, max_new_tokens=8)) for p in prompts]
    treqs = [port.submit(GenRequest(p, max_new_tokens=8)) for p in prompts]
    for j, t in zip(jreqs, treqs):
        assert t.tokens() == j.tokens()
        assert t.finish_reason == "length"
    st = port.stats()
    assert st["kvcache"]["blocks_in_use"] == 0 and st["kvcache"]["reserved"] == 0


def test_greedy_identity_through_pure_decode_chunks(engines):
    """19 new tokens: the unified step emits 1 + 8, then a full decode
    chunk (K = 8) and a short one (K = 2) run with no prefill pending."""
    ref, port = engines
    prompts = _prompts(17, (3, 20, 9))
    jreqs = [ref.submit(JRequest(p, max_new_tokens=19)) for p in prompts]
    before = port.stats()
    treqs = [port.submit(GenRequest(p, max_new_tokens=19)) for p in prompts]
    for j, t in zip(jreqs, treqs):
        assert t.tokens() == j.tokens()
    after = port.stats()
    # every unified step counts one chunk; pure decode chunks count only there
    pure = (after["chunks"] - before["chunks"]) - (after["steps"] - before["steps"])
    assert pure >= 2


def test_eos_cut_and_cap(engines):
    ref, port = engines
    (prompt,) = _prompts(12, (10,))
    full = port.generate(prompt, max_new_tokens=8)
    r = port.submit(GenRequest(prompt, max_new_tokens=8, eos_token=full[2]))
    assert r.tokens() == full[: full.index(full[2]) + 1]
    assert r.finish_reason == "eos"
    # 40-token prompt at max_seq_len 64 leaves 64 - 40 - 2 * 8 = 8 tokens
    (long_prompt,) = _prompts(13, (40,))
    r = port.submit(GenRequest(long_prompt, max_new_tokens=30))
    assert r.capped and r.max_new_tokens == 8 and len(r.tokens()) == 8
    with pytest.raises(ValueError):
        port.submit(GenRequest(_prompts(14, (60,))[0], max_new_tokens=4))


def test_cancelled_before_admission(engines):
    _ref, port = engines
    r = GenRequest(_prompts(15, (5,))[0], max_new_tokens=8)
    r.cancel()
    assert port.submit(r).tokens() == [] and r.finish_reason == "cancelled"


def test_temperature_sampling_is_seeded(weights):
    _jcfg, _jp, tcfg, tp = weights
    (prompt,) = _prompts(16, (6,))
    outs = []
    for _ in range(2):
        with LLMEngine(tcfg, tp, device="cpu", seed=5, **ENGINE_KW) as eng:
            outs.append(eng.generate(prompt, max_new_tokens=8, temperature=0.8))
    assert outs[0] == outs[1]
    assert all(0 <= t < tcfg.vocab_size for t in outs[0])


def test_finite_guard_sentinel():
    logits = torch.zeros((3, 5))
    logits[1, 2] = float("nan")
    toks = torch.tensor([4, 4, 4], dtype=torch.int32)
    assert finite_guard(logits, toks).tolist() == [4, -1, 4]


def test_engine_without_gpu_raises(weights):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    _jcfg, _jp, tcfg, tp = weights
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(tcfg, tp, **ENGINE_KW)


def test_port_imports_nothing_of_jax():
    """gofr_tpu_torch and chip_smoke.py import neither jax nor gofr_tpu."""
    files = sorted((ROOT / "gofr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 5
    # every subpackage is walked, the copied host modules too
    for sub in ("resilience", "structured", "spec", "kvcache", "datasource/gpu", "lora", "metrics", "profiling"):
        assert any(f.parent == ROOT / "gofr_tpu_torch" / sub for f in files), sub
    assert ROOT / "gofr_tpu_torch" / "grpcx.py" in files
    # the copied accounting, recorder, observability and tracing modules too
    for name in ("metrics/__init__.py", "metrics/slo.py", "goodput.py", "flightrec.py", "tracing.py",
                 "profiling/__init__.py", "profiling/mfu.py", "profiling/capture.py", "datasource/gpu/telemetry.py"):
        assert ROOT / "gofr_tpu_torch" / name in files, name
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "gofr_tpu"):
                    bad.append(f"{f.relative_to(ROOT)}: {name}")
    assert not bad, bad


# -- retirement of cancelled and expired requests (JAX _expire_deadlines) --

def _cancel_once_emitted(eng, req_box, n):
    """Wrap ``eng._admit`` (called once per scheduler pass in both engines)
    to cancel the boxed request between two dispatches, once it has
    emitted ``n`` tokens."""
    admit = eng._admit

    def wedge(*a, **kw):
        r = req_box.get("r")
        if r is not None and not r.cancelled and r.emitted >= n:
            r.cancel()
        return admit(*a, **kw)

    eng._admit = wedge
    return admit


def _end_after_cancel(req):
    """-> (tokens, seconds from the cancel to the end of the stream). The
    clock starts at the cancel, so a first dispatch's compile is not in it."""
    t0 = time.perf_counter()
    while not req.cancelled and time.perf_counter() - t0 < 60:
        time.sleep(0.001)
    assert req.cancelled
    t0 = time.perf_counter()
    out = req.tokens(timeout=3.0)
    return out, time.perf_counter() - t0


def test_lone_cancelled_decode_is_retired(weights):
    """A lone greedy request cancelled mid-decode, with nothing else to
    dispatch, ends with "cancelled" and frees its blocks; the JAX engine
    ends the same input the same way."""
    jcfg, jp, tcfg, tp = weights
    kw = dict(slots=4, max_seq_len=256, prefill_buckets=(8, 16))
    (prompt,) = _prompts(21, (12,))
    outs = {}
    for name, eng in (
        ("jax", JEngine(jcfg, jp, warmup=False, kv_paged=True, **kw)),
        ("port", LLMEngine(tcfg, tp, device="cpu", **kw)),
    ):
        box: dict = {}
        try:
            _cancel_once_emitted(eng, box, 9)
            Req = JRequest if name == "jax" else GenRequest
            box["r"] = r = eng.submit(Req(prompt, max_new_tokens=200))
            toks, took = _end_after_cancel(r)
            assert took < 3.0 and r.finish_reason == "cancelled", (name, r.finish_reason)
            assert 9 <= len(toks) < 200
            deadline = time.perf_counter() + 3.0
            while eng.stats()["kvcache"]["blocks_in_use"] and time.perf_counter() < deadline:
                time.sleep(0.01)
            assert eng.stats()["kvcache"]["blocks_in_use"] == 0, name
            outs[name] = toks
        finally:
            eng.close()
    short, long_ = sorted(outs.values(), key=len)
    assert long_[: len(short)] == short  # greedy: the same stream, cut at the cancel


def test_deadline_retires_slotted_request(weights):
    jcfg, jp, tcfg, tp = weights
    with LLMEngine(tcfg, tp, device="cpu", slots=1, max_seq_len=512, prefill_buckets=(8,)) as eng:
        req = eng.submit(GenRequest([5, 9, 2], max_new_tokens=400))
        t0 = time.perf_counter()
        while req.emitted == 0 and time.perf_counter() - t0 < 30:
            time.sleep(0.001)
        # armed only now, once a token exists: the sweep reads the attribute
        req.deadline = time.perf_counter()
        toks = req.tokens(timeout=30)
        assert req.finish_reason == "deadline"
        assert 0 < len(toks) < 400
        assert eng.stats()["deadline_cancels"] == 1
        assert eng.stats()["kvcache"]["blocks_in_use"] == 0
        # the one slot is free again and serves the next request
        ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, slots=1, max_seq_len=64, prefill_buckets=(8,))
        try:
            want = ref.generate([1, 2], max_new_tokens=4)
        finally:
            ref.close()
        assert eng.generate([1, 2], max_new_tokens=4) == want


def test_queued_past_deadline_never_takes_a_slot(engines):
    _ref, port = engines
    before = port.stats()
    req = port.submit(GenRequest([5, 9, 2], max_new_tokens=4, deadline=time.perf_counter() - 0.01))
    assert req.tokens(timeout=10) == []
    assert req.finish_reason == "deadline" and req.slot is None
    after = port.stats()
    assert after["steps"] == before["steps"] and after["deadline_cancels"] == before["deadline_cancels"] + 1


def test_identity_fields_change_nothing(engines):
    """priority, client and session_id ride the request (the edge sets
    them); a lone request of the batch class, from a named client, is
    served the same tokens; an adapter name is refused, as by the JAX
    engine without an adapter pool."""
    ref, port = engines
    (prompt,) = _prompts(22, (9,))
    want = ref.generate(prompt, max_new_tokens=8)
    got = port.generate(prompt, max_new_tokens=8, priority="batch", client="c1", session_id="s1")
    assert got == want
    with pytest.raises(ValueError, match="adapter"):
        port.submit(GenRequest(prompt, adapter="tenant-a"))


def test_stream_close_cancels_as_disconnect(engines):
    """Closing the stream mid-way retires the request as "disconnect".
    The collector is held once the first tokens are out, so the request
    cannot end by length before the close reaches the engine (a test
    thread descheduled for a second on a loaded CPU let the engine emit
    all 39 tokens first)."""
    _ref, port = engines
    (prompt,) = _prompts(23, (9,))
    req = GenRequest(prompt, max_new_tokens=40)
    hold = threading.Event()
    process = port._process_entry

    def held(entry):
        if req.emitted:  # the first tokens are out: hold every later program
            hold.wait(timeout=30)
        process(entry)

    port._process_entry = held
    try:
        port.submit(req)
        it = req.stream(timeout=30)
        next(it)
        before = port.stats()["disconnect_cancels"]
        it.close()  # the consumer goes away mid-stream
        t0 = time.perf_counter()
        while req.finish_reason is None and time.perf_counter() - t0 < 3:
            time.sleep(0.005)
    finally:
        hold.set()
        del port._process_entry
    assert req.finish_reason == "disconnect"
    assert port.stats()["disconnect_cancels"] == before + 1


def test_astream_flattens_and_raises_on_error(engines):
    import asyncio

    ref, port = engines
    (prompt,) = _prompts(24, (7,))
    want = ref.generate(prompt, max_new_tokens=11)

    async def collect(r):
        return [t async for t in r.astream(timeout=30)]

    assert asyncio.run(collect(port.submit(GenRequest(prompt, max_new_tokens=11)))) == want
    failed = GenRequest(prompt)
    failed.error, failed.finish_reason = "boom", "error"
    failed.out.put(None)
    with pytest.raises(RequestFailed):
        asyncio.run(collect(failed))
