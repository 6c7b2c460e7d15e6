"""gofr_tpu_torch.metrics.slo against gofr_tpu.metrics.slo, and the SLO
engine's seams in the port's LLMEngine, fleet and runtime against the
JAX engine's (CPU, f32 tiny preset, ``device="cpu"``).

The units run on the same inputs through both modules and must agree
exactly (tolerance 0: the same float operations in the same order):
``SLOPolicy.from_config`` / ``coerce`` / ``merged``, an ``SLOTracker`` fed
the same seeded outcomes under one injected clock (burn rates,
``fast_burn``, the exposition's ``app_llm_slo_*`` lines and
``snapshot()``), and ``pool_snapshots`` over two trackers. The engine:
the env fallback builds the same policy as JAX's, the fast-burn flip
writes one ``slo_fast_burn`` bundle, close and die zero the gauges, and
a fleet pools its replicas' snapshots."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gofr_tpu.config import new_mock_config as jax_mock_config
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.metrics import Manager as JManager
from gofr_tpu.metrics import slo as JS
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.llm import GenRequest, LLMEngine, ReplicatedLLMEngine
from gofr_tpu_torch.metrics import Manager
from gofr_tpu_torch.metrics import slo as TS
from gofr_tpu_torch.models import transformer as TT

ENGINE_KW = dict(slots=4, max_seq_len=64, prefill_buckets=(8, 16))


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def weights():
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32))
    tcfg = TT.TransformerConfig.tiny()
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _slo_lines(m) -> list[str]:
    return sorted(ln for ln in m.render_prometheus().splitlines() if ln.startswith("app_llm_slo"))


@pytest.mark.parametrize("config", [
    {}, {"TPU_LLM_SLO_TTFT_MS": "250"}, {"TPU_LLM_SLO_TPOT_MS": "40", "TPU_LLM_SLO_AVAILABILITY": "0.995"},
    {"TPU_LLM_SLO_TTFT_MS": "x", "TPU_LLM_SLO_AVAILABILITY": "1.5"}, {"TPU_LLM_SLO_TTFT_MS": ""},
])
def test_policy_from_config_equals_jax(config):
    j = JS.SLOPolicy.from_config(jax_mock_config(config))
    t = TS.SLOPolicy.from_config(new_mock_config(config))
    assert t.to_dict() == j.to_dict() and t.active() == j.active() and t.budget() == j.budget()


@pytest.mark.parametrize("spec", [None, {"ttft_ms": 100}, {"tpot_ms": 5, "availability": 0.9}, {}])
def test_policy_coerce_and_merged_equal_jax(spec):
    jbase, tbase = JS.SLOPolicy(ttft_ms=200, availability=0.99), TS.SLOPolicy(ttft_ms=200, availability=0.99)
    j, t = JS.SLOPolicy.coerce(spec), TS.SLOPolicy.coerce(spec)
    assert (t is None) == (j is None)
    if t is not None:
        assert t.to_dict() == j.to_dict()
    assert tbase.merged(t).to_dict() == jbase.merged(j).to_dict()
    with pytest.raises(TypeError):
        TS.SLOPolicy.coerce("ttft=5")
    for ok, ttft, tpot in ((True, 150.0, 3.0), (True, 250.0, None), (False, None, None), (True, None, 9.0)):
        assert tbase.merged(t).violations(ok=ok, ttft_ms=ttft, tpot_ms=tpot) == jbase.merged(j).violations(
            ok=ok, ttft_ms=ttft, tpot_ms=tpot)


def test_tracker_equals_jax_under_one_clock():
    """The same seeded outcome stream, tenants and priorities, with the
    clock stepped so the 5m window ages out part of it: every burn rate,
    fast-burn verdict, exposition line and snapshot equal (exact)."""
    jclock, tclock = FakeClock(), FakeClock()
    jm, tm = JManager(), Manager()
    jpol = JS.SLOPolicy(ttft_ms=100, tpot_ms=20, availability=0.99)
    tpol = TS.SLOPolicy(ttft_ms=100, tpot_ms=20, availability=0.99)
    over_j, over_t = {"a1": JS.SLOPolicy(ttft_ms=50)}, {"a1": TS.SLOPolicy(ttft_ms=50)}
    jt = JS.SLOTracker(jpol, jm, "m", tenant_overrides=over_j, clock=jclock)
    tt = TS.SLOTracker(tpol, tm, "m", tenant_overrides=over_t, clock=tclock)
    flips = {"j": 0, "t": 0}
    jt.on_fast_burn = lambda: flips.__setitem__("j", flips["j"] + 1)
    tt.on_fast_burn = lambda: flips.__setitem__("t", flips["t"] + 1)
    rng = np.random.default_rng(5)
    for i in range(400):
        kw = dict(
            tenant=("-", "a1", "a2")[int(rng.integers(3))], priority=("interactive", "batch")[int(rng.integers(2))],
            ok=bool(rng.random() > 0.1), ttft_ms=float(rng.uniform(10, 200)),
            tpot_ms=None if rng.random() < 0.2 else float(rng.uniform(1, 40)),
        )
        assert tt.observe(**kw) == jt.observe(**kw)
        step = float(rng.uniform(0.0, 3.0))
        jclock.t += step
        tclock.t += step
        if i % 50 == 49:
            assert tt.burn_rates() == jt.burn_rates() and tt.fast_burn() == jt.fast_burn()
            assert tt.snapshot() == jt.snapshot()
    assert _slo_lines(tm) == _slo_lines(jm)
    assert flips["t"] == flips["j"] > 0
    jt.zero_gauges()
    tt.zero_gauges()
    assert _slo_lines(tm) == _slo_lines(jm) and tt.snapshot() == jt.snapshot()


def test_pool_snapshots_equal_jax():
    snaps_j, snaps_t = [], []
    for seed, av in ((1, 0.99), (2, 0.999)):
        rng = np.random.default_rng(seed)
        j = JS.SLOTracker(JS.SLOPolicy(ttft_ms=80, availability=av), None, "m", clock=FakeClock())
        t = TS.SLOTracker(TS.SLOPolicy(ttft_ms=80, availability=av), None, "m", clock=FakeClock())
        for _ in range(30):
            kw = dict(tenant="-", priority="interactive", ok=bool(rng.random() > 0.2),
                      ttft_ms=float(rng.uniform(10, 150)), tpot_ms=None)
            j.observe(**kw)
            t.observe(**kw)
        snaps_j.append(j.snapshot())
        snaps_t.append(t.snapshot())
    assert TS.pool_snapshots(snaps_t) == JS.pool_snapshots(snaps_j)
    assert TS.pool_snapshots([]) == JS.pool_snapshots([]) == {}
    assert TS.pool_snapshots([None, snaps_t[0]]) == JS.pool_snapshots([None, snaps_j[0]])


def test_engine_env_fallback_builds_jaxs_policy(weights, monkeypatch):
    jcfg, jp, tcfg, tp = weights
    monkeypatch.setenv("TPU_LLM_SLO_TTFT_MS", "120")
    monkeypatch.setenv("TPU_LLM_SLO_AVAILABILITY", "0.995")
    je = JEngine(jcfg, jp, warmup=False, **ENGINE_KW)
    te = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW)
    try:
        assert te.slo is not None and je.slo is not None
        assert te.slo.policy.to_dict() == je.slo.policy.to_dict()
        assert te.debug_state()["slo"]["policy"] == je.slo.policy.to_dict() == je.debug_state()["slo"]["policy"]
    finally:
        je.close()
        te.close()
    monkeypatch.delenv("TPU_LLM_SLO_TTFT_MS")
    monkeypatch.delenv("TPU_LLM_SLO_AVAILABILITY")
    te = LLMEngine(tcfg, tp, device="cpu", slo={"tpot_ms": 9}, slo_tenants={"a": {"ttft_ms": 3}}, **ENGINE_KW)
    try:
        assert te.slo.policy.to_dict() == {"ttft_ms": None, "tpot_ms": 9.0, "availability": None}
        assert te.slo.policy_for("a").to_dict() == {"ttft_ms": 3.0, "tpot_ms": 9.0, "availability": None}
    finally:
        te.close()
    te = LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW)
    try:
        assert te.slo is None and te.debug_state()["slo"] is None  # no target anywhere: no tracker
    finally:
        te.close()


def test_fast_burn_writes_one_bundle_and_close_zeroes(weights, tmp_path):
    """A 1 ms TTFT target makes every request a violation: the 10th trips
    the fast burn, which writes exactly one ``slo_fast_burn`` bundle (the
    flip, not every later violation); close zeroes the burn gauges."""
    _j, _jp, tcfg, tp = weights
    m = Manager()
    eng = LLMEngine(tcfg, tp, device="cpu", metrics=m, slo={"ttft_ms": 1e-6}, blackbox_dir=str(tmp_path),
                    blackbox_interval_s=0.0, **ENGINE_KW)
    try:
        for i in range(12):
            eng.generate([3, 4, 5 + i], max_new_tokens=2)
        snap = eng.slo.snapshot()
        assert snap["fast_burn"] and snap["total"] == 12 and snap["good"] == 0
        bundles = [d for d in os.listdir(tmp_path) if "slo_fast_burn" in d]
        assert len(bundles) == 1
        with open(os.path.join(tmp_path, bundles[0], "manifest.json")) as f:
            assert json.load(f)["trigger"] == "slo_fast_burn"
        assert 'app_llm_slo_fast_burn{model="llm"} 1' in m.render_prometheus()
        assert 'app_llm_slo_breaches_total{model="llm",objective="ttft"} 12' in m.render_prometheus()
    finally:
        eng.close()
    text = m.render_prometheus()
    assert 'app_llm_slo_fast_burn{model="llm"} 0' in text
    assert 'app_llm_slo_burn_rate{model="llm",window="5m"} 0' in text


def test_wide_target_trips_nothing_and_cancelled_is_not_judged(weights):
    _j, _jp, tcfg, tp = weights
    eng = LLMEngine(tcfg, tp, device="cpu", slo={"ttft_ms": 60_000}, **ENGINE_KW)
    try:
        for i in range(11):
            eng.generate([7, 8, 9 + i], max_new_tokens=3)
        r = eng.submit(GenRequest([1, 2, 3], max_new_tokens=40))
        r.cancel()
        r.tokens(timeout=60)
        snap = eng.slo.snapshot()
        assert not snap["fast_burn"] and snap["good"] == snap["total"] == 11  # the cancel is not the budget's
    finally:
        eng.close()


def test_fleet_pools_its_replicas_like_jax(weights):
    _j, _jp, tcfg, tp = weights
    fleet = ReplicatedLLMEngine(tcfg, tp, replicas=2, device="cpu", supervise=False, slo={"ttft_ms": 60_000},
                                **ENGINE_KW)
    try:
        for i in range(6):
            fleet.generate([5, 6, 7 + i], max_new_tokens=3)
        snaps = [e.slo.snapshot() for e in fleet.engines]
        pooled = fleet.debug_state()["slo"]
        assert pooled == TS.pool_snapshots(snaps) and pooled["total"] == 6 and pooled["replicas"] == 2
        assert set(pooled) == set(JS.pool_snapshots([s for s in snaps]))
        phases = fleet.stats()["phases"]
        assert phases["ttft"]["count"] == 6 and phases["queue_wait"]["count"] == 6
    finally:
        fleet.close()
