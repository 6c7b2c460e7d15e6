"""The port's device-observability series, windows and cost model against
the JAX package's (CPU, f32 tiny presets, greedy, lookahead 1,
``device="cpu"``).

- Series parity: ``register_llm`` on both runtimes (paged; speculative;
  grammar-constrained; LoRA; MoE; a two-replica fleet; disaggregated) and
  the same requests. The registered series, as (name, kind, label names),
  must be equal, except the names in ``NOT_PORTED`` (each beside the
  ROADMAP ID that owns it). Every histogram's count and every counter's
  value must be equal too (exact), except the counters that sum seconds
  (``SECONDS``: wall times differ between the engines) and the capture
  series, whose ``program`` label names the port's CUDA-graph families
  (``.w{width}`` suffixes) where JAX names its jitted programs: their
  totals must be equal.
- The phase windows in ``stats()`` / ``debug_state()`` and a fleet's
  pooled windows.
- The cost model: ``model_costs`` and the four FLOPs functions equal JAX's
  for every preset both packages have (exact: the same integer and float
  operations); ``device_peak_flops`` / ``device_hbm_bandwidth`` give the
  H100 row for "NVIDIA H100 80GB HBM3", JAX's placeholder for the CPU,
  and the ``TPU_PEAK_FLOPS`` / ``TPU_HBM_BW`` overrides.
- The rollout series of a failed rollout, equal to the JAX fleet's.
- The HBM sampler parks on a CPU runtime."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gofr_tpu import structured as JS
from gofr_tpu.config import new_mock_config as jax_mock_config
from gofr_tpu.datasource.tpu import TPURuntime
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import ReplicatedLLMEngine as JFleet
from gofr_tpu.lora import init_adapter as j_init_adapter
from gofr_tpu.metrics import Manager as JManager
from gofr_tpu.models import transformer as JT
from gofr_tpu.profiling import mfu as JM
from gofr_tpu.resilience import FaultInjector as JInjector
from gofr_tpu_torch import structured as TS
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.datasource.gpu import GPURuntime
from gofr_tpu_torch.datasource.gpu.telemetry import GPUTelemetry
from gofr_tpu_torch.llm import GenRequest, LLMEngine, ReplicatedLLMEngine
from gofr_tpu_torch.metrics import Manager
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.profiling import mfu as TM
from gofr_tpu_torch.resilience import FaultInjector

# Registered by only one package, each beside the ROADMAP ID that owns it.
# Empty: every series the JAX runtime and engines register is ported.
NOT_PORTED: dict[str, str] = {}
# Counters that sum wall seconds: their series must match, their values not
SECONDS = ("app_llm_goodput_seconds_total", "app_llm_tenant_chip_seconds_total")
CAPTURE = ("app_jax_compiles_total", "app_jax_trace_cache_hits_total", "app_jax_compile_seconds")
KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8, 16), lookahead=1)
VOCAB = [chr(0x20 + i).encode() if 0x20 + i < 0x7F else b"" for i in range(127)] + [b""]
EOS = 127


def _pair(cfg_name: str = "tiny", **cfg_kw):
    jcfg = getattr(JT.TransformerConfig, cfg_name)(**cfg_kw)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    tcfg = getattr(TT.TransformerConfig, cfg_name)(**cfg_kw)
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _pair()


def _series(m) -> dict:
    """name -> (kind, label names seen) of every registered instrument."""
    out = {}
    for inst in list(m._instruments.values()):
        if hasattr(inst, "collect_histogram"):
            labels = {k for key, _v in inst.collect_histogram() for k, _x in key}
        else:
            labels = {k for _n, lab, _v in inst.collect() for k in lab}
        out[inst.name] = (inst.kind, tuple(sorted(labels)))
    return {n: v for n, v in out.items() if n not in NOT_PORTED}


def _values(m) -> tuple[dict, dict]:
    """(every histogram's count and counter's value by series, the capture
    series' totals)."""
    out, capture = {}, {}
    for inst in list(m._instruments.values()):
        if inst.name in SECONDS or inst.name in NOT_PORTED:
            continue
        if hasattr(inst, "collect_histogram"):
            items = [(dict(key), cnt) for key, (_c, _s, cnt) in inst.collect_histogram()]
        elif inst.kind == "counter":
            items = [(lab, v) for _n, lab, v in inst.collect()]
        else:
            continue
        for lab, v in items:
            if inst.name in CAPTURE:
                capture[inst.name] = capture.get(inst.name, 0) + v
            else:
                out[(inst.name, tuple(sorted(lab.items())))] = v
    return out, capture


def _runtimes():
    jm, tm = JManager(), Manager()
    jrt = TPURuntime(jax_mock_config({"TPU_TELEMETRY_INTERVAL_S": "0"}), None, metrics=jm)
    trt = GPURuntime(new_mock_config({"TORCH_DEVICE": "cpu", "TPU_TELEMETRY_INTERVAL_S": "0"}), metrics=tm)
    return jm, tm, jrt, trt


def _one_at_a_time(h, R, jobs):
    return [h.submit(R(list(p), max_new_tokens=n, **kw)).tokens(timeout=120) for p, n, kw in jobs]


CASES = {
    "paged": ({}, {}),
    "spec": ({"speculative": True, "spec_draft": 4}, {}),
    "lora": ({"lora_slots": 2}, {}),
    "fleet": ({"replicas": 2}, {}),
    "disagg": ({"disagg": True, "prefix_cache_mb": 8.0}, {}),
}


@pytest.mark.parametrize("case", sorted(CASES) + ["constrained", "moe"])
def test_series_and_counts_equal_jax(case, tiny):
    if case == "constrained":
        jcfg, jp, tcfg, tp = _pair(vocab_size=128)
        ekw = {}
        grammars = (JS.compile_regex(r"[a-c]{2,5}", VOCAB, EOS), TS.compile_regex(r"[a-c]{2,5}", VOCAB, EOS))
    elif case == "moe":
        jcfg, jp, tcfg, tp = _pair("tiny_moe")
        ekw, grammars = {}, None
    else:
        jcfg, jp, tcfg, tp = tiny
        ekw, grammars = CASES[case][0], None
    jm, tm, jrt, trt = _runtimes()
    jkw = {k: v for k, v in ekw.items()}
    th = trt.register_llm("m", tcfg, tp, **ekw, **KW)
    jh = jrt.register_llm("m", jcfg, jp, warmup=False, **jkw, **KW)
    try:
        # the repeating prompt first: a fresh JAX engine verifies its drafts,
        # a later one after an idle pause keeps a plain burst (ROADMAP queue
        # 3 item 5)
        jobs = [(([5, 6, 7, 8] * 8)[:20], 12, {}), ([1, 2, 3], 9, {}), (list(range(1, 20)), 7, {})]
        if case == "lora":
            ad = jax.tree.map(np.asarray, j_init_adapter(jax.random.PRNGKey(7), jcfg, rank=4, scale=1.0))
            jh.load_adapter("a", ad)
            th.load_adapter("a", ad)
            jobs.append(([9, 8, 7], 6, {"adapter": "a"}))
        if grammars is not None:
            jobs = [([1, 2, 3], 8, {}), ([4, 5, 6], 8, {})]
            jg = [([1, 2, 3], 12, {"grammar": grammars[0]})]
            tg = [([1, 2, 3], 12, {"grammar": grammars[1]})]
            want = _one_at_a_time(jh, JRequest, jg)
            assert _one_at_a_time(th, GenRequest, tg) == want
        # JAX first: an engine that idled keeps a plain burst for its next
        # request (ROADMAP queue 3 item 5), which would skip its verifies
        want = _one_at_a_time(jh, JRequest, jobs)
        assert _one_at_a_time(th, GenRequest, jobs) == want
        time.sleep(0.3)  # the schedulers' next pass refreshes their gauges
        assert _series(tm) == _series(jm)
        (tv, tcap), (jv, jcap) = _values(tm), _values(jm)
        assert tv == jv
        if case != "disagg":  # JAX's disaggregated pools build their programs apart from the port's
            assert tcap["app_jax_compiles_total"] == jcap["app_jax_compiles_total"]
            assert tcap["app_jax_compile_seconds"] == jcap["app_jax_compile_seconds"]
    finally:
        jh.close()
        th.close()
        jrt.close()
        trt.close()


def test_phase_windows_in_stats_and_debug_state(tiny):
    _j, _jp, tcfg, tp = tiny
    eng = LLMEngine(tcfg, tp, device="cpu", **KW)
    try:
        for n in (3, 9, 17):
            eng.generate(list(range(1, n + 1)), max_new_tokens=5)
        st, ds = eng.stats(), eng.debug_state()
        assert set(st["phases"]) == {"queue_wait", "ttft", "time_per_output_token", "decode_step", "step"}
        assert st["phases"]["ttft"]["count"] == st["phases"]["queue_wait"]["count"] == 3
        assert st["phases"]["time_per_output_token"]["count"] == 3
        assert ds["phases"]["step"]["count"] == st["phases"]["step"]["count"] > 0
        mfu = st["mfu"]
        assert mfu["peak_flops_per_chip"] == JM.device_peak_flops("cpu", "cpu")
        assert mfu["decode"]["count"] > 0 and mfu["prefill"]["count"] > 0
        assert 0 < mfu["decode"]["p50"] and mfu["roofline"]["bound"] in ("memory", "compute")
        assert {p["program"] for p in ds["compiles"]} == {n for n in eng._ran}
    finally:
        eng.close()
    assert eng.debug_state()["compiles"] == []  # a closed engine lists no programs


def test_fleet_pools_windows_and_mfu(tiny):
    _j, _jp, tcfg, tp = tiny
    fleet = ReplicatedLLMEngine(tcfg, tp, replicas=2, device="cpu", supervise=False, **KW)
    try:
        for i in range(4):
            fleet.generate([3, 4, 5 + i], max_new_tokens=4)
        st = fleet.stats()
        assert st["phases"]["ttft"]["count"] == 4
        assert set(st["mfu"]) == {"chips", "peak_flops_per_chip", "hbm_bw_per_chip", "params", "flops_per_token",
                                  "prefill", "decode", "tokens_per_second_per_chip", "roofline"}
        assert st["mfu"]["chips"] == 2 and st["mfu"]["decode"]["count"] == sum(
            e.stats()["mfu"]["decode"]["count"] for e in fleet.engines)
    finally:
        fleet.close()


# every preset both packages have
PRESETS = sorted(
    n for n, v in vars(JT.TransformerConfig).items()
    if isinstance(v, (classmethod, staticmethod))
    and isinstance(vars(TT.TransformerConfig).get(n), (classmethod, staticmethod))
)


def test_presets_cover_the_families():
    assert {"tiny", "tiny_moe", "tiny_mistral", "gemma_2b", "gemma_7b", "llama3_8b", "mistral_7b"} <= set(PRESETS)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("quantized", [False, True])
def test_model_costs_and_flops_equal_jax(preset, quantized):
    jc = JM.model_costs(getattr(JT.TransformerConfig, preset)(), quantized=quantized)
    tc = TM.model_costs(getattr(TT.TransformerConfig, preset)(), quantized=quantized)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    rng = np.random.default_rng(3)
    spans = [(int(a), int(b)) for a, b in zip(rng.integers(0, 5000, 6), rng.integers(0, 300, 6))]
    lens = [int(x) for x in rng.integers(1, 9000, 5)]
    assert TM.decode_flops(tc, 37, 91_000) == JM.decode_flops(jc, 37, 91_000)
    assert TM.prefill_flops(tc, lens) == JM.prefill_flops(jc, lens)
    assert TM.chunk_prefill_flops(tc, spans) == JM.chunk_prefill_flops(jc, spans)
    assert TM.spec_verify_flops(tc, spans) == JM.spec_verify_flops(jc, spans)


def test_roofline_and_bound_equal_jax():
    for args in ((1e12, 1e9, 989e12, 3.35e12), (5.0, 0.0, 1.0, 1.0), (1e15, 1e9, 197e12, 8.2e11)):
        assert TM.roofline_ratio(*args) == JM.roofline_ratio(*args)
    for r in (0.0, -1.0, 0.3, 1.0, 7.5):
        assert TM.classify_bound(r) == JM.classify_bound(r)


def test_peaks_h100_cpu_and_overrides(monkeypatch):
    monkeypatch.delenv("TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("TPU_HBM_BW", raising=False)
    assert TM.device_peak_flops("gpu", "NVIDIA H100 80GB HBM3") == 989e12
    assert TM.device_hbm_bandwidth("gpu", "NVIDIA H100 80GB HBM3") == 3.35e12
    assert TM.card_peaks("NVIDIA H100 80GB HBM3") == ("H100 80GB HBM3", (3.35e12, 989e12, 67e12))
    with pytest.raises(RuntimeError, match="no peak figures"):
        TM.card_peaks("NVIDIA A10")
    for platform, kind in (("cpu", "cpu"), ("", ""), ("gpu", "NVIDIA A10")):
        assert TM.device_peak_flops(platform, kind) == JM.device_peak_flops(platform, kind)
        assert TM.device_hbm_bandwidth(platform, kind) == JM.device_hbm_bandwidth(platform, kind)
    monkeypatch.setenv("TPU_PEAK_FLOPS", "123e12")
    monkeypatch.setenv("TPU_HBM_BW", "2e12")
    for mod in (TM, JM):
        assert mod.device_peak_flops("gpu", "NVIDIA H100 80GB HBM3") == 123e12
        assert mod.device_hbm_bandwidth("cpu", "cpu") == 2e12


def test_failed_rollout_series_equal_jax(tiny):
    """Item 22: the rollout controller's series (started, rolled back, the
    state gauge back at 0, the fired fault) on a canary-failed rollout,
    equal to the JAX fleet's."""
    jcfg, jp, tcfg, tp = tiny
    fkw = dict(slots=2, max_seq_len=128, prefill_buckets=(8,), prefill_chunk=4, step_token_budget=4,
               decode_chunk=2, lookahead=1)
    want = {}
    for name in ("jax", "port"):
        m = JManager() if name == "jax" else Manager()
        if name == "jax":
            inj = JInjector()
            rep = JFleet(jcfg, jp, replicas=2, fault_injector=inj, supervise=False, warmup=False, metrics=m, **fkw)
            params = jp
        else:
            inj = FaultInjector()
            rep = ReplicatedLLMEngine(tcfg, tp, replicas=2, fault_injector=inj, supervise=False, device="cpu",
                                      metrics=m, **fkw)
            params = tp
        try:
            rep.generate(list(range(1, 13)), max_new_tokens=4, eos_token=-1)
            inj.arm("rollout_canary_fail", count=1)
            rep.deploy(None, params, version="v2", bake_s=0.3, drain_timeout_s=60)
            assert rep._rollout.wait(timeout=120) == "rolled_back"
            text = m.render_prometheus().splitlines()
            want[name] = sorted(ln for ln in text if ln.startswith(("app_llm_rollout", "app_llm_faults_injected",
                                                                     'app_llm_model_version_info{model="m"')))
        finally:
            rep.close()
    assert want["port"] == want["jax"]
    assert 'app_llm_rollouts_rolled_back_total{model="llm"} 1' in want["port"]


def test_hbm_sampler_parks_on_a_cpu_runtime():
    m = Manager()
    tel = GPUTelemetry(m, ["cpu"], interval_s=0.01)
    try:
        assert tel.sample_once() == 0
        t0 = time.perf_counter()
        while not tel.parked and time.perf_counter() - t0 < 10:
            time.sleep(0.01)
        assert tel.parked and m.has("app_tpu_hbm_bytes") and "app_tpu_hbm_bytes{" not in m.render_prometheus()
    finally:
        tel.close()
    rt = GPURuntime(new_mock_config({"TORCH_DEVICE": "cpu", "TPU_TELEMETRY_INTERVAL_S": "0"}), metrics=Manager())
    assert rt.telemetry is not None and rt.telemetry._thread is None  # 0 turns the sampler off
    rt.close()
